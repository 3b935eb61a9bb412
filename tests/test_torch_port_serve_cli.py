"""The port's serving CLI (`python -m glom_tpu_torch.serve`), in process and
in a subprocess on the CPU (`--device cpu`), on the mnist preset: glom_tpu's
flags plus `--device`, a ramp with a killed engine that fails over and
lints clean, a recorded workload replayed, the argv exit codes, the
elastic fleet's and the forecaster's flags, a ramp the autoscaler scales
out and back in, the serve mesh's refusal of `--elastic` with its ROADMAP
item and of a mesh with no ranks to hold it (the mesh itself runs under
gloo ranks in test_torch_port_serve_mesh), and the refusal to run without
a card."""

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
    """glom_tpu's flags, plus `--device` and the serve mesh's
    `--dist-backend` (ranks sharing one card need gloo)."""
    assert _flags(cli.build_parser()) == _flags(jcli.build_parser()) | {"--device",
                                                                        "--dist-backend"}
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


@pytest.mark.parametrize("flag,per", [
    (["--mesh-data", "2", "--buckets", "2,4", "--elastic"], 2),
    (["--mesh-seq", "2", "--elastic"], 2),
])
def test_elastic_on_a_mesh_needs_its_ranks(flag, per, tmp_path, capsys):
    """An elastic fleet on a mesh runs (test_torch_port_serve_mesh_elastic);
    one process without a process group holds none of its rank groups and
    is told how to launch."""
    out = str(tmp_path / "m.jsonl")
    assert cli.main([*BASE, "--synthetic", "1", *flag, "--out", out]) == 2
    assert f"torch.distributed.run --nproc-per-node {per}" in capsys.readouterr().err


def test_a_mesh_without_its_ranks_exits_2(tmp_path, capsys):
    """One process and no process group cannot hold a 2-rank mesh; a bucket
    the data axis does not divide is an argv error too."""
    out = str(tmp_path / "m.jsonl")
    assert cli.main([*BASE, "--synthetic", "1", "--mesh-seq", "2", "--out", out]) == 2
    assert "torch.distributed.run --nproc-per-node 2" in capsys.readouterr().err
    assert cli.main([*BASE, "--synthetic", "1", "--mesh-data", "2", "--out", out]) == 2
    assert "divisible by mesh_data=2" in capsys.readouterr().err


@pytest.mark.parametrize("flag,check", [
    (["--elastic"], {"n_spares": 0, "n_engines": 1}),
    (["--elastic", "--min-engines", "2"], {"n_engines": 2}),
    (["--elastic", "--elastic-p99-ms", "50"], {"n_engines": 1}),
    (["--elastic", "--elastic-settle", "0.2"], {"n_scale_ins": 0}),
    (["--elastic", "--warm-pool", "1"], {"warm_pool": 1, "n_spares": 1}),
    (["--elastic", "--husk-max", "2"], {"n_engines": 1}),
    (["--elastic", "--husk-max-age", "5"], {"n_engines": 1}),
    (["--forecast"], None),
])
def test_elastic_and_forecast_flags_are_accepted(flag, check, tmp_path):
    """The elastic fleet's and the forecaster's flags run: the summary
    carries the autoscaler's rollup, --forecast stamps scored forecast
    records, and the stream lints and audits clean."""
    out = tmp_path / "m.jsonl"
    assert cli.main([*BASE, "--synthetic", "2", *flag, "--out", str(out)]) == 0
    assert schema.main([str(out)]) == 0
    recs = records(out)
    (summary,) = [r for r in recs if r.get("event") == "summary"]
    if check is None:
        assert "elastic" not in summary
        assert any(r["kind"] == "forecast" and "forecast_abs_err" in r for r in recs)
    else:
        for k, v in check.items():
            assert summary["elastic"][k] == v, k
    res = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", "audit", str(out)],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_elastic_ramp_scales_out_and_in(tmp_path):
    """A 1 ms p99 rule breaches on the first resolved request: the warm
    spare is promoted; once the ramp's last request leaves the 0.5 s window
    the fleet drains back (demoting the engine into the pool). Every
    request is served and the decision chain audits clean. (The rule, not
    the queue's fill, drives the decisions, so the test holds on a loaded
    machine.)"""
    out = tmp_path / "m.jsonl"
    argv = ["--preset", "mnist", "--device", "cpu", "--iters", "12", "--buckets", "1,2,4",
            "--max-batch", "4", "--queue-depth", "512", "--elastic", "--min-engines", "1",
            "--max-engines", "2", "--warm-pool", "1", "--forecast", "--ramp", "4x20,40x0,8x20",
            "--elastic-p99-ms", "1", "--elastic-window", "0.5", "--elastic-dwell", "0.05",
            "--elastic-cooldown", "0.3", "--elastic-interval", "0.02",
            "--elastic-settle", "30", "--out", str(out)]
    assert cli.main(argv) == 0
    recs = records(out)
    (summary,) = [r for r in recs if r.get("event") == "summary"]
    el = summary["elastic"]
    assert summary["n_served"] == summary["n_requests"] == 52
    assert el["n_promotions"] == 1 and el["n_demotions"] == 1 and el["n_engines"] == 1
    assert el["n_engines_peak"] == 2
    res = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", "audit", str(out)],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.splitlines()[-1])["n_conserved"] == el["n_decisions"]


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--preset", "mnist", "--synthetic", "1"])
