"""The port's training CLI, in process on the CPU (`--device cpu`), on the
mnist preset: train with checkpoints, resume, the restart supervisor, the
flight recorder, and the flags it refuses with their ROADMAP items.
"""

import json
import os

import pytest
import torch

from glom_tpu.train import cli as jcli
from glom_tpu_torch.telemetry import schema
from glom_tpu_torch.tracing import flight
from glom_tpu_torch.train import cli

# mnist at batch 4 keeps each step in milliseconds on the CPU.
BASE = ["--preset", "mnist", "--device", "cpu", "--batch-size", "4", "--log-every", "2"]


def records(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh]


def run(tmp_path, *extra):
    return cli.main(BASE + ["--checkpoint-dir", str(tmp_path / "ckpt"),
                            "--metrics-file", str(tmp_path / "m.jsonl"), *extra])


class TestTrainAndResume:
    @pytest.fixture(scope="class")
    def trained(self, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("cli")
        assert run(tmp, "--steps", "4", "--checkpoint-every", "2") == 0
        first = records(tmp / "m.jsonl")
        return tmp, first

    def test_trains_and_checkpoints(self, trained):
        tmp, recs = trained
        steps = [r for r in recs if r["kind"] == "train_step"]
        assert [r["step"] for r in steps] == [1, 3]
        assert all(r["vjp_path"] == "scan_dense" for r in steps)
        assert all(schema.validate_record(r) == [] for r in recs)
        assert schema.main([str(tmp / "m.jsonl")]) == 0
        names = {r.get("name") for r in recs if r["kind"] == "span"}
        assert {"host_data_next", "host_step_dispatch", "host_log_fetch",
                "host_checkpoint_save", "host_checkpoint_write", "host_checkpoint_wait",
                "host_prefetch_next", "host_prefetch_stage"} <= names
        assert sorted(os.listdir(tmp / "ckpt")) == ["2", "4", "manifest_2.json",
                                                   "manifest_4.json"]

    def test_resumes(self, trained, capfd):
        tmp, first = trained
        assert run(tmp, "--steps", "6", "--checkpoint-every", "2", "--resume") == 0
        assert "resumed from step 4" in capfd.readouterr().err
        recs = records(tmp / "m.jsonl")[len(first):]
        (resume,) = [r for r in recs if r["kind"] == "recovery"]
        assert (resume["action"], resume["step"]) == ("resume-from-checkpoint", 4)
        assert [r["step"] for r in recs if r["kind"] == "train_step"] == [5]
        assert run(tmp, "--steps", "6", "--resume") == 0  # nothing left to do
        assert "nothing to do" in capfd.readouterr().err


def test_supervised_run(tmp_path):
    assert run(tmp_path, "--steps", "4", "--checkpoint-every", "2", "--supervise", "1") == 0
    assert sorted(p for p in os.listdir(tmp_path / "ckpt") if p.isdigit()) == ["2", "4"]
    with pytest.raises(SystemExit, match="checkpoint-dir"):
        cli.main(BASE + ["--steps", "1", "--supervise", "1"])


def test_flight_recorder_and_debug_nans(tmp_path):
    before = torch.is_anomaly_enabled()
    assert cli.main(BASE + ["--steps", "1", "--prefetch", "0", "--debug-nans",
                            "--flight-recorder", str(tmp_path / "fr")]) == 0
    assert torch.is_anomaly_enabled() == before
    assert flight.get_global_flight_recorder() is None
    (dump,) = os.listdir(tmp_path / "fr")
    with open(tmp_path / "fr" / dump) as fh:
        assert json.loads(fh.readline())["trigger"] == "run-end"


def test_parser_matches_glom_tpu():
    ours = {a.dest for a in cli.build_parser()._actions}
    ref = {a.dest for a in jcli.build_parser()._actions}
    assert ours - ref == {"device"} and ref <= ours


@pytest.mark.parametrize("flags, item", [
    (["--distributed"], 8),
    (["--check-parity"], 8),
    (["--zero-stage", "1"], 8),
    (["--quantized-reduce"], 8),
    (["--pod-index", "0", "--pod-count", "2", "--pod-dir", "x"], 9),
    (["--watchdog-interval", "5"], 9),
    (["--profile-dir", "x"], 9),
    (["--trace-steps", "1:2"], 9),
    (["--telemetry-level", "full"], 9),
])
def test_refused_flags(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A item {item}"):
        cli.main(BASE + ["--steps", "1", *flags])


def test_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--preset", "mnist", "--steps", "1"])
    with pytest.raises(SystemExit, match="lr-schedule"):
        cli.main(BASE + ["--steps", "1", "--warmup-steps", "2"])
