"""The port's chaos harness (`python -m glom_tpu_torch.resilience`) and the
fault injectors it and the pod coordinator ride, on the CPU.

The scenarios run the port's real CLIs as subprocesses at the mnist preset
with `--device cpu`: kill-train (SIGKILL, resume from the last committed
checkpoint), preempt-train (SIGTERM, the grace save, resume), preempt-pod
(two training CLIs as pod hosts: the barrier commits one common step, the
gang resumes from it) and kill-serve (a dead engine's tickets re-dispatched
to its sibling). Each must pass every evidence check of glom_tpu's scenario.
The injectors are held to glom_tpu's on the same schedules.
"""

import json

import pytest

from glom_tpu.resilience import FaultPlan as JFaultPlan
from glom_tpu.resilience import read_pod_commit as jread_pod_commit
from glom_tpu.resilience import chaos as jchaos
from glom_tpu.resilience import probe_flap as jprobe_flap
from glom_tpu.resilience import queue_stall as jqueue_stall
from glom_tpu.telemetry.watchdog import BackendWatchdog as JBackendWatchdog
from glom_tpu_torch.resilience import FaultPlan, chaos, probe_flap, queue_stall, read_pod_commit
from glom_tpu_torch.telemetry import schema
from glom_tpu_torch.telemetry.watchdog import BackendWatchdog

# Enough steps that a worker at the mnist preset on the CPU is still
# training when the harness's fault lands.
STEPS = 20
POD_STEPS = 40


def _drive(tmp_path, capsys, monkeypatch, *argv):
    """chaos.main in process (its workers are subprocesses, two CPU threads
    each); (exit code, the harness's stamped records, its summary)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    rc = chaos.main(["--dir", str(tmp_path), "--device", "cpu", *argv])
    out = capsys.readouterr().out
    stamped = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert all(schema.validate_record(r) == [] for r in stamped)
    summary = [r for r in stamped if r.get("event") == "chaos-summary"]
    assert len(summary) == 1, stamped  # a stamped error, not a summary, says why
    return rc, stamped, summary[0]


def _records(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.startswith("{")]


@pytest.mark.parametrize("scenario", ["kill-train", "preempt-train"])
def test_train_scenarios_recover(tmp_path, capsys, monkeypatch, scenario):
    rc, stamped, summary = _drive(tmp_path, capsys, monkeypatch, "--scenario", scenario,
                                 "--steps", str(STEPS), "--batch-size", "2")
    assert rc == 0 and summary["ok"] is True, summary
    (fault,) = [r for r in stamped if r["kind"] == "fault"]
    assert fault["fault"] == ("sigkill" if scenario == "kill-train" else "sigterm")
    recs = _records(tmp_path / "metrics.jsonl")
    (resume,) = [r for r in recs if r.get("action") == "resume-from-checkpoint"]
    assert resume["step"] == summary["resumed_from_step"] >= 2
    steps = sorted({r["step"] for r in recs if r["kind"] == "train_step"})
    allowed = {resume["step"] - 1} if scenario == "preempt-train" else set()
    assert set(range(STEPS)) - set(steps) <= allowed
    if scenario == "preempt-train":
        dumps = sorted((tmp_path / "flight").glob("flight_*.jsonl"))
        saves = [r for d in dumps for r in _records(d)
                 if r.get("action") == "preemption-checkpoint"]
        assert saves and all(r["ok"] for r in saves)
        assert {r["step"] for r in saves} == {resume["step"]}


def test_preempt_pod_commits_one_common_step_and_the_gang_resumes(tmp_path, capsys,
                                                                   monkeypatch):
    rc, stamped, summary = _drive(tmp_path, capsys, monkeypatch, "--scenario", "preempt-pod",
                                 "--steps", str(POD_STEPS), "--batch-size", "2", "--hosts", "2")
    assert rc == 0 and summary["ok"] is True, summary
    assert [r.get("wave") for r in stamped if r["kind"] == "fault"] == ["subset", "all"]
    common = summary["committed_common_step"]
    marker = read_pod_commit(tmp_path / "coord")
    assert marker == jread_pod_commit(tmp_path / "coord")
    assert marker["step"] == common == min(int(s) for s in marker["proposals"].values())
    for h in (0, 1):
        recs = _records(tmp_path / f"metrics_h{h}.jsonl")
        assert {r["step"] for r in recs if r.get("action") == "resume-from-checkpoint"} == {
            common}
        steps = {r["step"] for r in recs if r["kind"] == "train_step"}
        assert set(range(POD_STEPS)) - steps <= {common - 1}
        saves = [r for d in sorted((tmp_path / f"flight_h{h}").glob("flight_*.jsonl"))
                 for r in _records(d) if r.get("action") == "preemption-checkpoint"]
        assert any(r["ok"] and r["pod"] and r["step"] == common for r in saves)


def test_kill_serve_hands_the_dead_engines_tickets_to_its_sibling(tmp_path, capsys,
                                                                   monkeypatch):
    rc, _, summary = _drive(tmp_path, capsys, monkeypatch, "--scenario", "kill-serve",
                            "--requests", "8")
    assert rc == 0 and summary["ok"] is True and summary["n_failovers"] >= 1, summary
    s = [r for r in _records(tmp_path / "serve_metrics.jsonl") if r.get("event") == "summary"]
    assert s[-1]["n_served"] == 8 and s[-1]["n_failed"] == 0
    assert not s[-1]["engines"]["engine0"]["alive"]


def test_a_missed_kill_window_is_a_stamped_error(tmp_path, capsys, monkeypatch):
    """A worker that never commits the asked checkpoints fails the scenario
    loudly, stamped, never a raw traceback."""
    rc = chaos.main(["--dir", str(tmp_path), "--device", "cpu", "--scenario", "kill-train",
                     "--steps", "1", "--kill-after", "5", "--batch-size", "2"])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert rc == 1
    assert [r["error"] for r in out if r["kind"] == "error"] == ["worker-never-checkpointed"]


def test_parser_matches_glom_tpu():
    ours = {a.dest: a.default for a in chaos.build_parser()._actions}
    ref = {a.dest: a.default for a in jchaos.build_parser()._actions}
    assert set(ours) - set(ref) == {"device"} and ours["device"] == "cuda"
    assert {k: v for k, v in ours.items() if k != "device"} == ref
    assert (chaos.build_parser()._option_string_actions["--scenario"].choices
            == jchaos.build_parser()._option_string_actions["--scenario"].choices)


def test_workers_run_the_ports_clis_on_the_asked_device(tmp_path):
    args = chaos.build_parser().parse_args(["--dir", str(tmp_path), "--device", "cuda:1"])
    cmd = chaos._worker_cmd(args, {"ckpt": "c", "metrics": "m", "flight": "f"})
    assert cmd[2:4] == ["-m", "glom_tpu_torch.train.cli"]
    assert cmd[cmd.index("--device") + 1] == "cuda:1"
    pod = chaos._pod_worker_cmd(args, tmp_path, 1)
    assert pod[pod.index("--pod-index") + 1] == "1" and "cuda:1" in pod


# -- the injectors ------------------------------------------------------------------


def _flap(wd_cls, plan, injector, clock):
    wd = wd_cls(probe=lambda timeout: 1, flap_window_s=1e9, flap_threshold=3, heartbeat_s=0,
                clock=lambda: clock[0])
    wd.set_probe_fault(injector(plan))
    return wd


def test_probe_flap_walks_the_watchdog_as_glom_tpus_does():
    clock = [0.0]
    plan = FaultPlan(seed=0).register("watchdog-probe", at=(2, 4), fault="backend-flap")
    jplan = JFaultPlan(seed=0).register("watchdog-probe", at=(2, 4), fault="backend-flap")
    ours = _flap(BackendWatchdog, plan, probe_flap, clock)
    ref = _flap(JBackendWatchdog, jplan, jprobe_flap, clock)
    states = []
    for i in range(6):
        clock[0] = float(i)
        states.append((ours.probe_once(), ref.probe_once()))
    assert [a for a, _ in states] == [b for _, b in states] == [
        "up", "up", "down", "flapping", "down", "flapping"]
    strip = lambda evs: [{k: v for k, v in e.items() if k not in ("t", "wall_time_s")}
                         for e in evs]
    assert strip(plan.events()) == strip(jplan.events())


def test_queue_stall_sleeps_on_schedule():
    slept, jslept = [], []
    plan = FaultPlan(seed=0).register("queue-stall", at=(1, 2))
    jplan = JFaultPlan(seed=0).register("queue-stall", at=(1, 2))
    hook = queue_stall(plan, stall_s=0.25, sleep=slept.append)
    jhook = jqueue_stall(jplan, stall_s=0.25, sleep=jslept.append)
    for _ in range(4):
        hook({"bucket": 1})
        jhook({"bucket": 1})
    assert slept == jslept == [0.25, 0.25]
    assert [e["index"] for e in plan.events()] == [e["index"] for e in jplan.events()] == [1, 2]
    assert plan.events()[0]["stall_s"] == 0.25


def test_resilience_exports_match_glom_tpu():
    import glom_tpu.resilience as jres
    import glom_tpu_torch.resilience as res

    # glom_tpu's names the port exports, less its ladder's rung constants
    # (the port's ladder exports RUNGS); StoreTransport is the port's own.
    missing = set(jres.__all__) - set(res.__all__)
    assert missing == {"NORMAL", "CAPPED_ITERS", "BUCKET_CAP", "SHED"}
    assert {"StoreTransport", "probe_flap", "queue_stall", "message_loss",
            "barrier_delay"} <= set(res.__all__)
