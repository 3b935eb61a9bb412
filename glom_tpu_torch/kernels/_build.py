"""Build and load the port's CUDA kernels.

Each `glom_tpu_torch/csrc/<name>.cu` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into `build/glom_tpu_torch/<name>-<hash>.so` beside the package, keyed by a
hash of the source, the shared headers (`csrc/*.cuh`) and the flags, and
loaded with ctypes. The sources have
a plain C interface (no PyTorch headers), so a build takes seconds.
`prebuild()` starts one nvcc per source (every one in `SOURCES` by
default), all at once. ptxas' report
(registers, shared memory, spills) is kept in `<so>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "glom_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Every kernel source of the port, csrc/<name>.cu.
SOURCES = (
    "grouped_mlp", "consensus_update", "grouped_mlp_bwd", "consensus_update_bwd",
    "banded_consensus",
)

_LIBS: dict = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count(namespace: dict, *names) -> None:
    """Add one to each named launch counter in `namespace` (a kernel
    module's globals()), skipping None, under one process-wide lock: the
    batcher's engine workers launch from several threads, and a bare `+=`
    on a module global can lose an increment between them."""
    with _COUNT_LOCK:
        for name in names:
            if name is not None:
                namespace[name] += 1


class KernelError(RuntimeError):
    """A kernel failed to build or launch. Not transient: a retry would
    hide a faulty kernel, so the engine's retry policy raises it on the
    first attempt (resilience/retry.py)."""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is already built.
    Returns (process or None, temporary output, final output)."""
    src, so = _target(name)
    if so.exists():
        return None, None, so
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, so


def _finish(name: str, proc, tmp: Path, so: Path) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu:\n{out}")
    so.with_suffix(".so.log").write_text(out)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing


def prebuild(names=SOURCES) -> dict:
    """Compile every named source in parallel; returns {name: ptxas log}."""
    started = {n: _start(n) for n in names}
    for n, job in started.items():
        _finish(n, *job)
    logs = {}
    for n in names:
        log = _target(n)[1].with_suffix(".so.log")
        logs[n] = log.read_text() if log.exists() else ""
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use, with
    `signatures` ({symbol: (argtypes, restype)}) applied once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = ctypes.CDLL(str(_target(name)[1]))
            for symbol, (argtypes, restype) in signatures.items():
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = argtypes, restype
            _LIBS[name] = lib
        return lib


def check(err: int, what: str, error_string) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point;
    `error_string` is the library's cudaGetErrorString binding."""
    if err != 0:
        msg = error_string(err).decode(errors="replace")
        raise KernelError(f"{what}: CUDA error {err} at launch ({msg})")
