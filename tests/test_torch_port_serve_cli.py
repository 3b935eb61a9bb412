"""The port's serving CLI (`python -m glom_tpu_torch.serve`), in process and
in a subprocess on the CPU (`--device cpu`), on the mnist preset: glom_tpu's
flags plus `--device`, a ramp with a killed engine that fails over and
lints clean, a recorded workload replayed, the argv exit codes, the flags
it refuses with their ROADMAP items, and the refusal to run without a
card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from glom_tpu.serve import cli as jcli
from glom_tpu_torch.serve import cli
from glom_tpu_torch.telemetry import schema

REPO = Path(__file__).resolve().parent.parent
BASE = ["--preset", "mnist", "--device", "cpu", "--iters", "auto", "--buckets", "1,2,4",
        "--max-batch", "4"]


def records(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh]


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_flags_are_the_reference_flags_plus_device():
    assert _flags(cli.build_parser()) == _flags(jcli.build_parser()) | {"--device"}
    assert cli.parse_ramp("6x120,48x0") == jcli.parse_ramp("6x120,48x0")


def test_ramp_with_a_killed_engine_lints(tmp_path):
    """Two engines, engine 1 failing from its second dispatch call on: every
    request is served (failover), the stream lints, the summary conserves."""
    out = tmp_path / "serve.jsonl"
    rc = subprocess.run(
        [sys.executable, "-m", "glom_tpu_torch.serve", *BASE, "--engines", "2",
         "--kill-engine", "1:after=1", "--ramp", "4x0,6x2", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert rc.returncode == 0, rc.stderr[-2000:]
    assert schema.main([str(out)]) == 0
    recs = records(out)
    (summary,) = [r for r in recs if r.get("event") == "summary"]
    assert summary["n_requests"] == summary["n_served"] == 10
    assert summary["n_failed"] == summary["n_shed"] == 0
    assert [r["ok"] for r in recs if r.get("event") == "response"] == [True] * 10
    assert [r["phase"] for r in recs if r.get("event") == "ramp_phase"] == [0, 1]
    assert {r["name"] for r in recs if r["kind"] == "span"} >= {
        "serve_enqueue", "serve_batch", "serve_dispatch", "serve_fetch"}


def test_record_then_replay(tmp_path):
    work, out = tmp_path / "w.jsonl", tmp_path / "m.jsonl"
    assert cli.main([*BASE, "--synthetic", "4", "--streams", "2", "--record-workload",
                     str(work), "--out", str(out)]) == 0
    assert schema.main([str(work)]) == 0
    assert cli.main([*BASE, "--replay", str(work), "--replay-time-scale", "0.5",
                     "--out", str(out)]) == 0
    (replay,) = [r for r in records(out) if r.get("event") == "replay_summary"]
    assert replay["n_offered"] == replay["n_submitted"] == 4


@pytest.mark.parametrize("argv", [
    [],
    ["--synthetic", "2", "--ramp", "2x0"],
    ["--ramp", "2y0"],
    ["--synthetic", "2", "--engines", "0"],
    ["--synthetic", "2", "--kill-engine", "3:after=1"],
])
def test_argv_errors_exit_2(argv, tmp_path):
    assert cli.main([*BASE, *argv, "--out", str(tmp_path / "m.jsonl")]) == 2


@pytest.mark.parametrize("flag,item", [
    (["--elastic"], 7), (["--min-engines", "2"], 7), (["--elastic-p99-ms", "50"], 7),
    (["--elastic-settle", "1"], 7), (["--warm-pool", "1"], 7), (["--husk-max", "2"], 7),
    (["--husk-max-age", "5"], 7), (["--mesh-data", "2"], 8), (["--mesh-seq", "2"], 8),
    (["--forecast"], 9),
])
def test_unported_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        cli.main([*BASE, "--synthetic", "1", *flag])


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--preset", "mnist", "--synthetic", "1"])
