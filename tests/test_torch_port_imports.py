"""The port stands alone: it imports neither JAX nor glom_tpu, and its entry
points run on the card unless the caller names the CPU.

tests/conftest.py imports jax into every pytest process, so the runtime
check runs in a fresh subprocess.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "glom_tpu_torch").rglob("*.py")) + [
    REPO / name for name in ("chip_smoke.py", "chip_timing.py", "port_ab.py", "kernel_probe.py")
]
FORBIDDEN = ("jax", "jaxlib", "glom_tpu")


def _module_names():
    names = []
    for path in sorted((REPO / "glom_tpu_torch").rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names


def test_the_checks_cover_every_module():
    names = _module_names()
    for module in ("glom_tpu_torch.serve.early_exit", "glom_tpu_torch.serve.paged_columns",
                   "glom_tpu_torch.serve.batcher", "glom_tpu_torch.kernels.banded_consensus",
                   "glom_tpu_torch.serve.engine", "glom_tpu_torch.serve.events",
                   "glom_tpu_torch.resilience.retry", "glom_tpu_torch.telemetry.watchdog",
                   "glom_tpu_torch.resilience.ladder", "glom_tpu_torch.serve.qos",
                   "glom_tpu_torch.serve.column_cache", "glom_tpu_torch.serve.workload",
                   "glom_tpu_torch.serve.cli", "glom_tpu_torch.serve.__main__",
                   "glom_tpu_torch.serve.elastic", "glom_tpu_torch.telemetry.forecast",
                   "glom_tpu_torch.telemetry.audit", "glom_tpu_torch.telemetry.aggregate",
                   "glom_tpu_torch.telemetry.__main__", "glom_tpu_torch.resilience.faults",
                   "glom_tpu_torch.parallel", "glom_tpu_torch.parallel.mesh",
                   "glom_tpu_torch.parallel.sharding", "glom_tpu_torch.parallel.quantized",
                   "glom_tpu_torch.parallel.collectives", "glom_tpu_torch.parallel.ring",
                   "glom_tpu_torch.parallel.ulysses", "glom_tpu_torch.parallel.halo",
                   "glom_tpu_torch.parallel.manual", "glom_tpu_torch.parallel.runtime",
                   "glom_tpu_torch.parallel.serve_mesh", "glom_tpu_torch.serve.mesh_follower",
                   "glom_tpu_torch.telemetry.counters", "glom_tpu_torch.telemetry.comm_time",
                   "glom_tpu_torch.tracing.capture", "glom_tpu_torch.tracing.memory",
                   "glom_tpu_torch.tracing.nvtx", "glom_tpu_torch.resilience.coordinator",
                   "glom_tpu_torch.resilience.chaos", "glom_tpu_torch.resilience.__main__"):
        assert module in names
        path = REPO / (module.replace(".", "/") + ".py")
        if not path.exists():  # a package
            path = REPO / module.replace(".", "/") / "__init__.py"
        assert path in PORT_FILES


def test_subprocess_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_module_names() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not set(roots) & set(FORBIDDEN), f"{path}:{node.lineno} imports {roots}"


def test_glom_defaults_to_the_card(monkeypatch):
    from glom_tpu_torch import Glom, entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Glom(dim=32, levels=3, image_size=16, patch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_kernel_sources_carry_their_notes():
    import glom_tpu_torch.kernels._build as build

    assert sorted(build.SOURCES) == sorted(p.stem for p in build.CSRC.glob("*.cu"))
    for name in build.SOURCES:
        text = (build.CSRC / f"{name}.cu").read_text()
        for note in ("Replaces:", "Bound on the H100:", "Kept out of device memory:"):
            assert note in text, (name, note)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import glom_tpu_torch.kernels._build as build

    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.prebuild(["grouped_mlp"])
    assert not (tmp_path / "build").exists()
