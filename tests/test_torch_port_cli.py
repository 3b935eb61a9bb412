"""The port's training CLI, in process on the CPU (`--device cpu`), on the
mnist preset: train with checkpoints, resume, the restart supervisor, the
flight recorder, the observability flags (the watchdog, the profiler
traces, telemetry "full"), and the flags it refuses with their ROADMAP
items.
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

    def test_resume_continues_the_data_stream(self, trained, tmp_path):
        """The resumed run skips the batches the checkpoint already trained
        on (glom_tpu's CLI restarts its stream), so 4 steps + a resume to 6
        end bit for bit on an uninterrupted 6-step run's state."""
        tmp, _ = trained
        assert run(tmp_path, "--steps", "6", "--checkpoint-every", "6") == 0
        assert run(tmp, "--steps", "6", "--checkpoint-every", "2", "--resume") == 0
        got, want = (torch.load(d / "ckpt" / "6" / "state.pt", weights_only=True)
                     for d in (tmp, tmp_path))
        assert all(torch.equal(got["params"][k], v) for k, v in want["params"].items())
        assert torch.equal(got["generator"], want["generator"])


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
    # the port's own flags: the device, and the distributed backend
    assert ours - ref == {"device", "dist_backend"} and ref <= ours


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
def test_refused_flags(flags, item, tmp_path):
    """No flag is refused any more: items 8 and 9 are ported. Item 8's
    (training across ranks), launched alone, each run as glom_tpu's does on
    one device -- one rank, ZeRO resolved to stage 0 and the quantized
    reduce off (dp 1), --check-parity exiting 0. Item 9's run on the CPU,
    each checked in its records: the watchdog's transition and state, the
    whole-run and the step-window traces, the per-level agreement, and the
    pod flags (two hosts, one after the other, then host 0 resuming from
    the newest step both hold, with glom_tpu's refusals of partial flags)."""
    if "--pod-index" in flags:
        pod = ["--pod-count", "2", "--pod-dir", str(tmp_path / "coord"), "--steps", "2",
               "--checkpoint-every", "1", "--prefetch", "0"]
        for host, steps in ((0, "2"), (1, "1")):
            assert cli.main(BASE + [*pod, "--pod-index", str(host), "--steps", steps,
                                    "--checkpoint-dir", str(tmp_path / f"host_{host}")]) == 0
        metrics = tmp_path / "m.jsonl"
        # host 1 is up, and has stopped, before host 0 resumes: its arrivals
        # at the resume rendezvous come from a thread standing in for it
        import threading

        from glom_tpu_torch.resilience import DirectoryTransport, PodCoordinator

        peer = PodCoordinator(DirectoryTransport(tmp_path / "coord", 1, 2), poll_s=0.01)
        t = threading.Thread(target=lambda: peer.gang_barrier(
            "reconciled", peer.launch_epoch(deadline_s=60.0), deadline_s=60.0))
        t.start()
        assert cli.main(BASE + [*pod, "--pod-index", "0", "--steps", "3", "--resume",
                                "--checkpoint-dir", str(tmp_path / "host_0"),
                                "--metrics-file", str(metrics)]) == 0
        t.join(60.0)
        recs = records(metrics)
        # host 0's step 2 is half-committed (host 1 stopped at 1): quarantined
        assert [(r["action"], r["step"]) for r in recs if r["kind"] == "recovery"] == [
            ("quarantine-half-step", 2), ("resume-from-checkpoint", 1)]
        assert [r["step"] for r in recs if r["kind"] == "train_step"] == [1, 2]
        for bad, why in (([*pod, "--pod-index", "0"], "come together"),
                         (["--pod-index", "0", "--pod-count", "2", "--pod-dir", "x"],
                          "requires --checkpoint-dir"),
                         ([*pod, "--pod-index", "0", "--checkpoint-dir", str(tmp_path / "c")],
                          "host_0"),
                         ([*pod, "--pod-index", "0", "--pod-count", "1"], "must be >= 2")):
            if why == "come together":
                bad = [a for a in bad if a not in ("--pod-dir", str(tmp_path / "coord"))]
            with pytest.raises(SystemExit, match=why):
                cli.main(BASE + bad)
        return
    metrics = tmp_path / "m.jsonl"
    if item == 9:
        from glom_tpu_torch.telemetry import watchdog

        flags = [str(tmp_path / "prof") if f == "x" else f for f in flags]
        assert cli.main(BASE + ["--steps", "3", "--log-every", "1", "--metrics-file",
                                str(metrics), "--trace-dir", str(tmp_path / "tr"), *flags]) == 0
        recs = records(metrics)
        steps = [r for r in recs if r["kind"] == "train_step"]
        assert len(steps) == 3 and all(schema.validate_record(r) == [] for r in recs)
        assert watchdog.get_global_watchdog() is None
        if "--watchdog-interval" in flags:
            events = [r for r in recs if r["kind"] == "watchdog"]
            assert [(e["prev_state"], e["backend_state"], e["backend_devices"])
                    for e in events] == [("unknown", "up", 1)]
            assert all(r["backend_state"] in ("unknown", "up") for r in steps)
        if "--profile-dir" in flags:
            assert len(os.listdir(tmp_path / "prof")) == 1
        if "--trace-steps" in flags:
            notes = [r for r in recs if r["kind"] == "note"]
            assert [(r["note"], r.get("first_step"), r.get("last_step")) for r in notes] == [
                ("xla-trace-start", 1, None), ("xla-trace-stop", None, 2)]
            assert len(os.listdir(tmp_path / "tr")) == 1
        if "--telemetry-level" in flags:
            assert all({"consensus_agreement_l0", "consensus_agreement_l1"} <= set(r)
                       and r["telemetry_level"] == "full" for r in steps)
        return
    assert cli.main(BASE + ["--steps", "2", "--metrics-file", str(metrics), *flags]) == 0
    steps = [r for r in records(metrics) if r["kind"] == "train_step"]
    assert steps and all(r["zero_stage"] == 0 and r["quantized_reduce"] is False
                         for r in steps)
    assert not torch.distributed.is_initialized()


def test_trace_flags_exclude_each_other(tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(BASE + ["--steps", "1", "--profile-dir", str(tmp_path / "p"),
                         "--trace-steps", "0:1"])
    with pytest.raises(ValueError, match="expected 'A:B'"):
        cli.main(BASE + ["--steps", "1", "--trace-steps", "a:b"])


def test_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--preset", "mnist", "--steps", "1"])
    with pytest.raises(SystemExit, match="lr-schedule"):
        cli.main(BASE + ["--steps", "1", "--warmup-steps", "2"])


def _torchrun(tmp_path, *flags):
    import subprocess
    import sys

    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "glom_tpu_torch.train.cli", "--preset", "mnist", "--device", "cpu",
         "--dist-backend", "gloo", "--batch-size", "8", "--log-every", "1", *flags],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env=env,
        capture_output=True, text=True, timeout=300)


def test_distributed_two_ranks_under_torchrun(tmp_path):
    """python -m torch.distributed.run, two gloo ranks on the CPU: ZeRO 2
    with checkpoints, a resume, rank 0's stream linted; then
    --check-parity exits 0 (glom_tpu's rule: worst relative loss deviation
    under 1e-2)."""
    metrics, ck = tmp_path / "m.jsonl", tmp_path / "ckpt"
    common = ["--distributed", "--zero-stage", "2", "--telemetry-level", "scalars",
              "--checkpoint-dir", str(ck), "--checkpoint-every", "2",
              "--metrics-file", str(metrics)]
    first = _torchrun(tmp_path, *common, "--steps", "2")
    assert first.returncode == 0, first.stderr[-3000:]
    assert "mesh (2, 1, 1) (axes data/seq/model), sp=none" in first.stderr
    second = _torchrun(tmp_path, *common, "--steps", "4", "--resume")
    assert second.returncode == 0, second.stderr[-3000:]
    assert "resumed from step 2" in second.stderr
    recs = records(metrics)
    steps = [r for r in recs if r["kind"] == "train_step"]
    assert [r["step"] for r in steps] == [0, 1, 2, 3]  # rank 0 alone writes
    assert all(r["zero_stage"] == 2 and r["comm_model_drift"] is not None for r in steps)
    assert [r["action"] for r in recs if r["kind"] == "recovery"] == ["resume-from-checkpoint"]
    assert sorted(os.listdir(ck)) == ["2", "4", "manifest_2.json", "manifest_4.json"]
    for rec in recs:
        assert schema.validate_record(rec) == [], rec
    parity = _torchrun(tmp_path, "--check-parity", "--steps", "2")
    assert parity.returncode == 0, parity.stderr[-3000:]
    assert "parity: worst relative loss deviation" in parity.stdout
