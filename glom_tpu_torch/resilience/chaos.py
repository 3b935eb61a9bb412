"""End-to-end chaos scenarios: kill a real training worker, require the
stack to come back.

Counterpart of `glom_tpu/resilience/chaos.py`, with its scenarios, flags
and evidence checks, over the port's CLIs (`python -m
glom_tpu_torch.train.cli`, `python -m glom_tpu_torch.serve`). `--device`
(default cuda) is passed to every worker; no worker falls back to the CPU.

`python -m glom_tpu_torch.resilience --scenario kill-train --dir /tmp/chaos`
drives the full kill-and-resume loop the unit tests can only approximate:

  1. launch the REAL training CLI (train/cli.py) as a subprocess with
     per-step checkpointing, a metrics file, and a flight recorder;
  2. wait until >= --kill-after checkpoints are manifest-committed, then
     deliver the fault — SIGKILL (kill-train: the uncatchable death) or
     SIGTERM (preempt-train: the pod-preemption grace path, which must
     land a deadline-bounded checkpoint + flight dump on the way out);
  3. relaunch the same command; --resume must restore from the latest
     VALID checkpoint and run to completion;
  4. validate the evidence trail: every record schema-lints, a stamped
     "recovery" resume event exists, the train_step sequence is
     CONTINUOUS across the kill (no lost or skipped steps), and — for
     preempt-train — the SIGTERM flight dump carries the
     "preemption-checkpoint" recovery event. A SIGTERM that lands inside
     an optimizer step saves at the step's end (tracing/flight.py).

`preempt-pod` runs N training CLIs as pod hosts over a shared coordination
directory; `kill-serve`, `rejoin-serve` and `ramp-serve` drive the serve
CLI. The workers run `TRAIN_WORKER` and `SERVE_WORKER` after the
interpreter: a caller that wants to observe the workers in process (launch
counts, say) points them at its own entry before calling main().

Every decision the harness takes is itself a stamped record on stdout
(kind "fault" for the kill, "note"/"summary" around it), so a chaos run's
log lints like any other artifact of record. Exit 0 = the system
recovered and the evidence proves it.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

from glom_tpu_torch.telemetry import schema

# The worker programs, after the interpreter.
TRAIN_WORKER = ["-m", "glom_tpu_torch.train.cli"]
SERVE_WORKER = ["-m", "glom_tpu_torch.serve"]


def _emit(rec: dict, kind: str) -> dict:
    stamped = schema.stamp(rec, kind=kind)
    print(json.dumps(stamped), flush=True)
    return stamped


def _note(text: str, **extra) -> None:
    _emit({"note": text, **extra}, kind="note")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m glom_tpu_torch.resilience",
        description="Chaos scenarios: fault-inject a real run of the port's CLIs, "
        "verify recovery",
    )
    p.add_argument(
        "--scenario",
        choices=[
            "kill-train", "preempt-train", "preempt-pod",
            "kill-serve", "rejoin-serve", "ramp-serve",
        ],
        default="kill-train",
        help="kill-train = SIGKILL mid-run (uncatchable; resume must come "
        "from the last committed checkpoint); preempt-train = SIGTERM (the "
        "grace path: deadline-bounded checkpoint + flight dump, then "
        "resume); preempt-pod = SIGTERM a strict subset of an N-process "
        "pod, then all of it — every host must commit ONE common step "
        "through the two-phase save barrier inside the grace deadline "
        "(or abort loudly, both stamped), and the relaunched gang must "
        "resume from that step with a continuous per-host train_step "
        "sequence; kill-serve = permanently fail one engine of a "
        "multi-engine serve run (seeded dispatch_fault) and require its "
        "queued tickets to re-dispatch to a sibling with a reconciling "
        "evidence trail; rejoin-serve = kill engine 0 for a BOUNDED fault "
        "window, then require probation to re-admit it (stamped "
        "engine_rejoin) and the run to finish with engine 0 alive and "
        "serving again; ramp-serve = drive a traffic ramp (low -> spike "
        "-> low) through the ELASTIC micro-server and require the "
        "autoscaler to scale OUT under the spike and back IN after it, "
        "with zero failed tickets, exact request conservation across "
        "both transitions, p99 recovered after the scale-out, and the "
        "full decision->spawn->admission-open and decision->drain->"
        "device-release chains present in the JSONL evidence alone",
    )
    p.add_argument("--dir", required=True, help="scenario working directory")
    p.add_argument(
        "--device", default="cuda",
        help="torch device of every worker (default cuda; cpu runs the kernels' "
        "plain versions)",
    )
    p.add_argument("--preset", default="mnist")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument(
        "--kill-after", type=int, default=2, metavar="N",
        help="deliver the fault once N checkpoints are manifest-committed",
    )
    p.add_argument(
        "--timeout", type=float, default=600.0,
        help="per-phase deadline in seconds (a hang is a FAILURE: the whole "
        "point is that nothing in the stack may hang)",
    )
    p.add_argument(
        "--requests", type=int, default=12, metavar="N",
        help="kill-serve: synthetic requests to serve across the kill",
    )
    p.add_argument(
        "--engines", type=int, default=2, metavar="N",
        help="kill-serve: engine replicas behind the shared batcher "
        "(engine 0 is the one killed; >= 2 so a sibling exists)",
    )
    p.add_argument(
        "--ramp", default="4x100,56x0,12x250", metavar="N1xG1,...",
        help="ramp-serve: the offered-load profile (requests x gap_ms "
        "per phase; phase 1 is the spike that must force scale-out)",
    )
    p.add_argument(
        "--hosts", type=int, default=2, metavar="N",
        help="preempt-pod: real train subprocesses in the gang (>= 2; "
        "host 0 is the strict subset SIGTERM'd first)",
    )
    p.add_argument(
        "--kill-gap", type=float, default=0.5, metavar="SECONDS",
        help="preempt-pod: delay between the subset SIGTERM and the rest "
        "(the window where early-signaled hosts wait in the barrier "
        "while the others still train)",
    )
    p.add_argument(
        "--preempt-deadline", type=float, default=30.0, metavar="SECONDS",
        help="preempt-pod: the workers' SIGTERM grace budget (the barrier "
        "round must complete — or abort — inside it)",
    )
    return p


def _worker_cmd(args, paths) -> List[str]:
    return [
        sys.executable, "-u", *TRAIN_WORKER,
        "--preset", args.preset,
        "--device", args.device,
        "--steps", str(args.steps),
        "--batch-size", str(args.batch_size),
        "--data", "gaussian",
        "--log-every", "1",
        "--checkpoint-dir", str(paths["ckpt"]),
        "--checkpoint-every", "1",
        "--resume",
        "--metrics-file", str(paths["metrics"]),
        "--flight-recorder", str(paths["flight"]),
    ]


def _spawn(cmd, log_path: Path) -> subprocess.Popen:
    with open(log_path, "a") as log:
        # The child inherits a duplicate of the fd at Popen time; closing
        # the parent's handle immediately neither truncates nor races it.
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)


def _manifest_count(ckpt_dir: Path) -> int:
    return len(list(ckpt_dir.glob("manifest_*.json")))


def _wait_for_checkpoints(
    proc: subprocess.Popen, ckpt_dir: Path, n: int, deadline: float
) -> bool:
    while time.monotonic() < deadline:
        if _manifest_count(ckpt_dir) >= n:
            return True
        if proc.poll() is not None:
            return False
        time.sleep(0.2)
    return False


def _records(path: Path) -> List[dict]:
    if not path.is_file():
        return []
    with open(path) as fh:
        return [rec for _, rec in schema.iter_json_lines(fh)]


def _lint(paths: List[Path]) -> List[str]:
    errors = []
    for p in paths:
        with open(p) as fh:
            errors.extend(f"{p}: {e}" for e in schema.lint_stream(fh))
    return errors


def run_kill_serve(args) -> int:
    """The serve-side kill: engine 0 of a multi-engine micro-server run is
    permanently failed via the seeded dispatch_fault seam (the in-process
    analog of a dead replica — a real SIGKILL would take every engine in
    the process with it), and the evidence trail must prove the hand-off:

      * the run COMPLETES with rc 0 — every request served by a sibling;
      * the injected faults are stamped ("fault" events at the
        engine0-dispatch site), so recovery reconciles against ground
        truth, not luck;
      * engine_failover events re-queued the dead engine's batches and an
        engine_dead event marks it; the summary shows engine0 with zero
        completed dispatches and the siblings carrying the load;
      * ticket conservation holds across the re-dispatch: n_served ==
        n_submitted, n_failed == 0 — no ticket lost, none double-served.
    """
    workdir = Path(args.dir)
    workdir.mkdir(parents=True, exist_ok=True)
    paths = {
        "metrics": workdir / "serve_metrics.jsonl",
        "log": workdir / "serve_run.log",
    }
    if args.engines < 2:
        _emit(
            {"error": "no-sibling-engine", "value": None,
             "note": f"--engines {args.engines}: kill-serve needs a "
             "sibling for the dead engine's tickets to land on"},
            kind="error",
        )
        return 1
    paths["metrics"].unlink(missing_ok=True)
    rejoin = args.scenario == "rejoin-serve"
    cmd = [
        sys.executable, "-u", *SERVE_WORKER,
        "--preset", args.preset,
        "--device", args.device,
        "--synthetic", str(args.requests),
        "--engines", str(args.engines),
        "--dispatch-retries", "0",
        "--iters", "auto",
        "--buckets", "1,2,4",
        "--max-batch", "4",
        "--out", str(paths["metrics"]),
    ]
    if rejoin:
        # BOUNDED fault window: engine0's first 2 dispatch attempts fail
        # (exactly the batcher's default death threshold), every attempt
        # after recovers — so probation's health dispatches succeed and
        # the fast 2-probe rejoin lands early in the run. The request gap
        # paces traffic NEAR the per-dispatch service time: the live
        # sibling is busy when the next request arrives, so the revived
        # engine (the idle waiter) must pick up work — the scenario
        # stays deterministic instead of racing worker wakeup order.
        cmd += [
            "--kill-engine", "0:after=0,until=2",
            "--rejoin", "2",
            "--rejoin-interval-ms", "50",
            "--request-gap-ms", "20",
        ]
    else:
        cmd += ["--kill-engine", "0:after=0"]
    _note(f"chaos {args.scenario}: launching micro-server",
          cmd=" ".join(cmd), workdir=str(workdir))
    _emit(
        {"fault": "engine-dead", "site": "engine0-dispatch",
         "scenario": args.scenario, "engines": args.engines,
         "fault_window": [0, 2] if rejoin else [0, None]},
        kind="fault",
    )
    proc = _spawn(cmd, paths["log"])
    try:
        rc = proc.wait(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30.0)
        _emit(
            {"error": "serve-hung", "value": None,
             "note": f"serve worker exceeded {args.timeout}s — a hang IS "
             "the failure mode this harness exists to catch"},
            kind="error",
        )
        return 1
    failures: List[str] = []
    if rc != 0:
        failures.append(
            f"serve worker rc={rc} (a dead engine must not fail the run "
            f"while siblings live); see {paths['log']}"
        )
    recs = _records(paths["metrics"])
    responses = [r for r in recs if r.get("event") == "response"]
    ok = [r for r in responses if r.get("ok")]
    if len(ok) != args.requests:
        failures.append(
            f"{len(ok)}/{args.requests} requests served ok "
            f"({len(responses)} responses)"
        )
    faults = [
        r for r in recs
        if r.get("kind") == "fault" and r.get("site") == "engine0-dispatch"
    ]
    if not faults:
        failures.append("no stamped fault events at engine0-dispatch — "
                        "the injection itself left no ground truth")
    failovers = [r for r in recs if r.get("event") == "engine_failover"]
    dead = [r for r in recs if r.get("event") == "engine_dead"]
    rejoins = [r for r in recs if r.get("event") == "engine_rejoin"]
    if not failovers:
        failures.append("no engine_failover event: the dead engine's "
                        "batches were never handed to a sibling")
    if not any(r.get("engine") == "engine0" for r in dead):
        failures.append("engine0 was never marked dead")
    summaries = [r for r in recs if r.get("event") == "summary"]
    if not summaries:
        failures.append("no serve summary record")
    else:
        s = summaries[-1]
        if s.get("n_served") != args.requests or s.get("n_failed"):
            failures.append(
                "ticket conservation broken across re-dispatch: "
                f"n_served={s.get('n_served')} n_failed={s.get('n_failed')} "
                f"n_submitted={s.get('n_submitted')} "
                f"(want n_served == {args.requests}, n_failed == 0)"
            )
        eng0 = (s.get("engines") or {}).get("engine0", {})
        if rejoin:
            # The rejoin contract: probation re-admitted engine0 AND it
            # served again — recovery proven by the evidence, not luck.
            if not any(r.get("engine") == "engine0" for r in rejoins):
                failures.append(
                    "no stamped engine_rejoin event for engine0: "
                    "probation never re-admitted the recovered engine"
                )
            if not eng0.get("alive") or not eng0.get("rejoins"):
                failures.append(
                    f"engine0 state does not reconcile with a rejoin: {eng0}"
                )
            if not eng0.get("dispatches"):
                failures.append(
                    "engine0 completed no dispatches after rejoin — it "
                    f"was re-admitted but never re-served: {eng0}"
                )
        elif eng0.get("alive") or eng0.get("dispatches"):
            failures.append(
                f"engine0 state does not reconcile with the kill: {eng0}"
            )
    # TRACE-TREE checks (schema v6, telemetry/tracectx.py): the evidence
    # is no longer a bag of events — every served request must
    # reconstruct as ONE causal tree whose per-hop executed iters and
    # wall spans conserve exactly against its resolve leaf, and the
    # failover hand-off must be VISIBLE inside at least one tree (the
    # injected dead engine's requests rode failover -> sibling dispatch).
    from glom_tpu_torch.telemetry import tracectx

    traces = tracectx.list_traces(recs)
    resolved_traces = [
        t for t, info in sorted(traces.items()) if info["resolved"]
    ]
    if not resolved_traces:
        failures.append(
            "no resolved trace trees in the evidence: the v6 trace "
            "context never made it through the serve stack"
        )
    bad_conservation = []
    for t in resolved_traces:
        check = tracectx.conservation(recs, t)
        if not check["ok"]:
            bad_conservation.append(f"{t}: {check.get('why', '?')}")
    if bad_conservation:
        failures.append(
            "trace conservation broken (a hop's evidence is missing or "
            "double-counted): " + "; ".join(bad_conservation[:3])
        )
    crossed_failover = [
        t for t in resolved_traces
        if any(
            r.get("event") == "engine_failover"
            for r in tracectx.records_for(recs, t)
        )
    ]
    if failovers and not crossed_failover:
        failures.append(
            "no resolved trace tree contains the engine_failover hop — "
            "the hand-off happened but cannot be joined to any request"
        )
    failures.extend(_lint([paths["metrics"]]))
    summary = {
        "event": "chaos-summary",
        "scenario": args.scenario,
        "ok": not failures,
        "requests": args.requests,
        "n_fault_events": len(faults),
        "n_failovers": len(failovers),
        "n_rejoins": len(rejoins),
        "n_traces_resolved": len(resolved_traces),
        "n_traces_crossing_failover": len(crossed_failover),
        "failures": failures[:10],
    }
    _emit(summary, kind="summary")
    if failures:
        for f in failures:
            print(f"CHAOS FAIL: {f}", file=sys.stderr)
        return 1
    return 0


def run_ramp_serve(args) -> int:
    """The elastic-serving chaos: a real micro-server run under a
    traffic RAMP (low -> spike -> low) with the autoscaler on, proven
    from the JSONL evidence alone:

      * the spike forces at least one SCALE-OUT and the post-spike calm
        at least one SCALE-IN (the `elastic` summary nest + timeline);
      * ZERO failed tickets and EXACT conservation across both
        transitions: every submitted request resolves (or sheds with a
        stamped reason — none at this profile), n_served + n_shed +
        n_failed == n_requests with n_failed == 0;
      * the spawned engine received NO admitted work before its warmup
        precompile completed: every warmup record of the spawned engine
        precedes its admission_open, and no dispatch on it precedes
        admission_open;
      * the decision chains are COMPLETE and ordered, joined by
        decision_id: scale_out_decision -> scale_out -> admission_open,
        and scale_in_decision -> drain_begin -> drain_flush ->
        drain_migrate -> drain_release (the engine_release record is the
        device-release leaf);
      * p99 RECOVERED after the scale-out: the tail phase's p99 sits
        strictly below the spike phase's (per-request latencies keyed by
        request id — the ramp phases are id ranges);
      * every resolved trace tree still conserves exactly (the v6
        contract holds across elastic transitions), and the stream
        schema-lints clean.
    """
    workdir = Path(args.dir)
    workdir.mkdir(parents=True, exist_ok=True)
    paths = {
        "metrics": workdir / "serve_metrics.jsonl",
        "log": workdir / "serve_run.log",
    }
    paths["metrics"].unlink(missing_ok=True)
    phases = []
    for part in args.ramp.split(","):
        n_s, _, gap_s = part.partition("x")
        phases.append((int(n_s), float(gap_s)))
    total = sum(n for n, _ in phases)
    cmd = [
        sys.executable, "-u", *SERVE_WORKER,
        "--preset", args.preset,
        "--device", args.device,
        "--ramp", args.ramp,
        "--elastic",
        "--min-engines", "1",
        "--max-engines", "2",
        "--elastic-low-water", "0.5",
        "--elastic-high-water", "0.8",
        "--elastic-dwell", "0.15",
        "--elastic-cooldown", "0.5",
        "--elastic-interval", "0.05",
        "--elastic-window", "2.0",
        "--elastic-p99-ms", "150",
        "--elastic-settle", "30",
        "--iters", "auto",
        "--buckets", "1,2,4",
        "--max-batch", "4",
        "--out", str(paths["metrics"]),
    ]
    _note("chaos ramp-serve: launching elastic micro-server",
          cmd=" ".join(cmd), workdir=str(workdir), total_requests=total)
    proc = _spawn(cmd, paths["log"])
    try:
        rc = proc.wait(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30.0)
        _emit(
            {"error": "serve-hung", "value": None,
             "note": f"elastic serve worker exceeded {args.timeout}s — a "
             "hang IS the failure mode this harness exists to catch"},
            kind="error",
        )
        return 1
    failures: List[str] = []
    if rc != 0:
        failures.append(
            f"serve worker rc={rc} (an elastic ramp must serve every "
            f"ticket); see {paths['log']}"
        )
    recs = _records(paths["metrics"])

    def stream_pos(pred) -> List[int]:
        return [i for i, r in enumerate(recs) if pred(r)]

    # -- fleet transitions happened at all ---------------------------------
    outs = [r for r in recs if r.get("event") == "scale_out"]
    ins = [r for r in recs if r.get("event") == "drain_release"]
    if not outs:
        failures.append("no scale_out event: the spike never grew the fleet")
    if not ins:
        failures.append("no drain_release event: the calm never shrank it")
    # -- zero failed tickets + exact conservation --------------------------
    summaries = [r for r in recs if r.get("event") == "summary"]
    if not summaries:
        failures.append("no serve summary record")
    else:
        s = summaries[-1]
        if s.get("n_failed"):
            failures.append(f"n_failed={s.get('n_failed')} — a ticket "
                            "FAILED across an elastic transition")
        if (
            (s.get("n_served") or 0) + (s.get("n_shed") or 0)
            + (s.get("n_failed") or 0)
        ) != s.get("n_requests"):
            failures.append(
                "request conservation broken: served+shed+failed != "
                f"requests in {s}"
            )
        if s.get("n_served") != total:
            failures.append(
                f"{s.get('n_served')}/{total} requests served (this "
                "profile must shed nothing)"
            )
        el = s.get("elastic") or {}
        if not el.get("n_scale_outs") or not el.get("n_scale_ins"):
            failures.append(f"elastic summary does not show a full "
                            f"out+in cycle: {el}")
        timeline = el.get("timeline") or []
        if el.get("n_engines_peak", 0) < 2 or el.get("n_engines", 0) != 1:
            failures.append(
                f"fleet timeline does not ramp 1 -> 2 -> 1: {timeline}"
            )
    # -- decision -> spawn -> admission chain ------------------------------
    for out in outs:
        did = out.get("decision_id")
        eng = out.get("engine")
        dec = stream_pos(
            lambda r: r.get("event") == "scale_out_decision"
            and r.get("decision_id") == did
        )
        adm = stream_pos(
            lambda r: r.get("event") == "admission_open"
            and r.get("decision_id") == did
        )
        here = stream_pos(
            lambda r: r.get("event") == "scale_out"
            and r.get("decision_id") == did
        )
        if not (dec and adm and dec[0] < here[0] < adm[0]):
            failures.append(
                f"scale-out chain for decision {did} is incomplete or "
                "out of order (want decision < scale_out < admission_open)"
            )
            continue
        if not out.get("spawn_ms"):
            failures.append(f"scale_out {did} carries no spawn_ms")
        if not (out.get("signal") or {}).get("rule"):
            failures.append(f"scale_out {did} embeds no triggering signal")
        # Admission-after-precompile: every warmup of the spawned engine
        # precedes admission_open, and no dispatch on it precedes it.
        warmups = stream_pos(
            lambda r: r.get("event") == "warmup" and r.get("engine") == eng
        )
        if not warmups:
            failures.append(f"spawned engine {eng} stamped no warmup "
                            "compiles — admission opened unwarmed")
        elif max(warmups) > adm[0]:
            failures.append(
                f"engine {eng} warmup compiles continued past "
                "admission_open — precompile did not complete first"
            )
        early = stream_pos(
            lambda r: r.get("event") == "dispatch" and r.get("engine") == eng
        )
        if early and early[0] < adm[0]:
            failures.append(
                f"engine {eng} dispatched BEFORE admission_open — work "
                "was admitted before the precompile finished"
            )
    # -- decision -> drain -> release chain --------------------------------
    drain_chain = (
        "scale_in_decision", "drain_begin", "drain_flush",
        "drain_migrate", "drain_release",
    )
    for rel in ins:
        did = rel.get("decision_id")
        pos = []
        for evname in drain_chain:
            at = stream_pos(
                lambda r, e=evname: r.get("event") == e
                and r.get("decision_id") == did
            )
            if not at:
                failures.append(
                    f"drain chain for decision {did} is missing {evname}"
                )
                break
            pos.append(at[0])
        else:
            if pos != sorted(pos):
                failures.append(
                    f"drain chain for decision {did} is out of order: "
                    f"{dict(zip(drain_chain, pos))}"
                )
            # engine_release is stamped by the engine itself right at
            # the device free, which the scaler runs BETWEEN the drain
            # machine's last event and its own drain_release — so the
            # leaf must sit strictly inside that window, not merely
            # exist somewhere (a release deferred to shutdown would
            # break the decision->drain->device-release chain).
            eng = rel.get("engine")
            released = stream_pos(
                lambda r: r.get("event") == "engine_release"
                and r.get("engine") == eng
            )
            if not released:
                failures.append(
                    f"drained engine {eng} never stamped "
                    "engine_release (devices not freed)"
                )
            elif not any(pos[-2] < p < pos[-1] for p in released):
                failures.append(
                    f"engine_release for {eng} at stream position(s) "
                    f"{released} sits outside the drain_migrate.."
                    f"drain_release window ({pos[-2]}, {pos[-1]}) — "
                    "devices were not freed as part of the drain chain"
                )
    # -- p99 recovered after scale-out -------------------------------------
    lat = {
        r.get("id"): r.get("latency_ms")
        for r in recs
        if r.get("event") == "response" and r.get("ok")
        and isinstance(r.get("latency_ms"), (int, float))
    }
    spike_lo = phases[0][0]
    spike_hi = spike_lo + phases[1][0]
    spike = sorted(v for k, v in lat.items() if spike_lo <= k < spike_hi)
    # Recovery is judged on the tail's STEADY-STATE half: the first tail
    # requests are submitted while the spike backlog still drains, so
    # their latency is the spike's shadow, not the scaled fleet's.
    tail_ids = sorted(k for k in lat if k >= spike_hi)
    tail_ids = tail_ids[len(tail_ids) // 2:]
    tail = sorted(lat[k] for k in tail_ids)
    if spike and tail:
        q = lambda xs, f: xs[min(len(xs) - 1, int(f * len(xs)))]
        p99_spike, p99_tail = q(spike, 0.99), q(tail, 0.99)
        if p99_tail >= p99_spike:
            failures.append(
                f"p99 did not recover after scale-out: spike {p99_spike} "
                f"ms vs tail {p99_tail} ms"
            )
    else:
        failures.append("missing spike/tail latency evidence for the "
                        "p99-recovery check")
        p99_spike = p99_tail = None
    # Breach evidence: the scaler's in-process monitor stamped at least
    # one upper-bound breach (the spike was SEEN, not just survived)...
    breaches = [r for r in recs if r.get("kind") == "slo_breach"]
    if outs and not breaches and not any(
        (o.get("signal") or {}).get("rule") == "headroom" for o in outs
    ):
        failures.append("no slo_breach records and no headroom-signal "
                        "decision — what triggered the scale-out?")
    # -- trace conservation across the transitions -------------------------
    from glom_tpu_torch.telemetry import tracectx

    traces = tracectx.list_traces(recs)
    resolved_traces = [
        t for t, info in sorted(traces.items()) if info["resolved"]
    ]
    if len(resolved_traces) != total:
        failures.append(
            f"{len(resolved_traces)}/{total} resolved trace trees"
        )
    bad = []
    for t in resolved_traces:
        check = tracectx.conservation(recs, t)
        if not check["ok"]:
            bad.append(f"{t}: {check.get('why', '?')}")
    if bad:
        failures.append(
            "trace conservation broken across the elastic transitions: "
            + "; ".join(bad[:3])
        )
    failures.extend(_lint([paths["metrics"]]))
    summary = {
        "event": "chaos-summary",
        "scenario": args.scenario,
        "ok": not failures,
        "requests": total,
        "n_scale_outs": len(outs),
        "n_scale_ins": len(ins),
        "n_breaches": len(breaches),
        "p99_spike_ms": p99_spike,
        "p99_tail_ms": p99_tail,
        "n_traces_resolved": len(resolved_traces),
        "failures": failures[:10],
    }
    _emit(summary, kind="summary")
    if failures:
        for f in failures:
            print(f"CHAOS FAIL: {f}", file=sys.stderr)
        return 1
    return 0


def _pod_worker_cmd(args, workdir: Path, host: int) -> List[str]:
    return [
        sys.executable, "-u", *TRAIN_WORKER,
        "--preset", args.preset,
        "--device", args.device,
        "--steps", str(args.steps),
        "--batch-size", str(args.batch_size),
        "--data", "gaussian",
        "--log-every", "1",
        "--checkpoint-dir", str(workdir / "ckpt" / f"host_{host}"),
        "--checkpoint-every", "1",
        "--checkpoint-keep", "50",
        "--resume",
        "--pod-index", str(host),
        "--pod-count", str(args.hosts),
        "--pod-dir", str(workdir / "coord"),
        "--preempt-deadline", str(args.preempt_deadline),
        "--metrics-file", str(workdir / f"metrics_h{host}.jsonl"),
        "--flight-recorder", str(workdir / f"flight_h{host}"),
    ]


def run_preempt_pod(args) -> int:
    """The pod-preemption acceptance: N REAL train subprocesses under the
    coordinated save barrier. SIGTERM a STRICT SUBSET first (those hosts
    propose and wait inside the barrier while the rest keep training),
    then the rest — the round must commit ONE common step on every host
    inside the grace deadline (or abort loudly; both outcomes stamped).
    Relaunch the gang: every host must resume from exactly that step and
    the per-host train_step sequences must be continuous — all proven
    from the JSONL evidence alone."""
    if args.hosts < 2:
        _emit(
            {"error": "no-pod", "value": None,
             "note": f"--hosts {args.hosts}: preempt-pod needs >= 2 "
             "processes (one host is preempt-train)"},
            kind="error",
        )
        return 1
    workdir = Path(args.dir)
    workdir.mkdir(parents=True, exist_ok=True)
    hosts = list(range(args.hosts))
    ckpt_dirs = {h: workdir / "ckpt" / f"host_{h}" for h in hosts}
    metrics = {h: workdir / f"metrics_h{h}.jsonl" for h in hosts}
    flights = {h: workdir / f"flight_h{h}" for h in hosts}
    cmds = {h: _pod_worker_cmd(args, workdir, h) for h in hosts}
    _note(
        f"chaos preempt-pod: launching {args.hosts}-host gang",
        cmd=" ".join(cmds[0]), workdir=str(workdir),
    )

    # Phase 1: run until every host committed >= kill-after manifests,
    # SIGTERM the strict subset (host 0), then — inside the grace window,
    # while the subset waits in the barrier — the rest.
    procs = {h: _spawn(cmds[h], workdir / f"run1_h{h}.log") for h in hosts}
    deadline = time.monotonic() + args.timeout
    try:
        for h in hosts:
            if not _wait_for_checkpoints(
                procs[h], ckpt_dirs[h], args.kill_after, deadline
            ):
                _emit(
                    {"error": "worker-never-checkpointed", "value": None,
                     "note": f"host {h}: no {args.kill_after} committed "
                     f"checkpoints within {args.timeout}s "
                     f"(rc={procs[h].poll()}); see run1_h{h}.log"},
                    kind="error",
                )
                return 1
        if any(procs[h].poll() is not None for h in hosts):
            _emit(
                {"error": "kill-window-missed", "value": None,
                 "note": "a host exited before the fault landed; lower "
                 f"--kill-after (now {args.kill_after}) or raise --steps "
                 f"(now {args.steps})"},
                kind="error",
            )
            return 1
        subset = hosts[:1]  # the STRICT subset: host 0 alone
        for h in subset:
            os.kill(procs[h].pid, signal.SIGTERM)
            _emit(
                {"fault": "sigterm", "site": "pod-worker",
                 "host": h, "pid": procs[h].pid, "wave": "subset",
                 "manifests_at_kill": _manifest_count(ckpt_dirs[h]),
                 "wall_time_s": round(time.time(), 3)},
                kind="fault",
            )
        time.sleep(args.kill_gap)
        for h in hosts:
            if h in subset:
                continue
            os.kill(procs[h].pid, signal.SIGTERM)
            _emit(
                {"fault": "sigterm", "site": "pod-worker",
                 "host": h, "pid": procs[h].pid, "wave": "all",
                 "manifests_at_kill": _manifest_count(ckpt_dirs[h]),
                 "wall_time_s": round(time.time(), 3)},
                kind="fault",
            )
        rcs = {}
        for h in hosts:
            try:
                rcs[h] = procs[h].wait(timeout=min(120.0, args.timeout))
            except subprocess.TimeoutExpired:
                _emit(
                    {"error": "worker-outlived-kill", "value": None,
                     "note": f"host {h} pid {procs[h].pid} still alive "
                     "after SIGTERM + grace; hard-killing"},
                    kind="error",
                )
                return 1
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30.0)
    if any(rc == 0 for rc in rcs.values()):
        _emit(
            {"error": "kill-window-missed", "value": None,
             "note": f"a host exited 0 despite SIGTERM (rcs={rcs}); "
             "lower --kill-after or raise --steps"},
            kind="error",
        )
        return 1
    _note(f"phase 1 done: gang SIGTERM'd (rcs={rcs})")

    # The barrier's verdict: the pod commit marker is written by host 0
    # only when EVERY host acked the committed step.
    from glom_tpu_torch.resilience.coordinator import read_pod_commit

    commit = read_pod_commit(workdir / "coord")
    if commit is None:
        _emit(
            {"error": "no-pod-commit", "value": None,
             "note": "no pod_commit_<step>.json under the coordination "
             "dir: the barrier never completed (an abort should be "
             "stamped in the flight dumps — this smoke injects no "
             "faults, so a commit was required)"},
            kind="error",
        )
        return 1
    common = int(commit["step"])
    _note(f"barrier committed common step {common}",
          proposals=commit.get("proposals"))

    # Phase 2: relaunch the whole gang; every host must reconcile to the
    # common step and run to completion.
    procs2 = {h: _spawn(cmds[h], workdir / f"run2_h{h}.log") for h in hosts}
    for h in hosts:
        try:
            rc2 = procs2[h].wait(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            for p in procs2.values():
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30.0)
            _emit(
                {"error": "resume-hung", "value": None,
                 "note": f"relaunched host {h} exceeded {args.timeout}s"},
                kind="error",
            )
            return 1
        if rc2 != 0:
            _emit(
                {"error": "resume-failed", "value": None,
                 "note": f"relaunched host {h} rc={rc2}; see run2_h{h}.log"},
                kind="error",
            )
            return 1
    _note("phase 2 done: gang resumed and ran to completion")

    # Phase 3: the evidence must prove ONE common resume step and
    # per-host continuity.
    failures: List[str] = []
    dumps_all: List[Path] = []
    for h in hosts:
        recs = _records(metrics[h])
        resumes = [
            r for r in recs
            if r.get("kind") == "recovery"
            and r.get("action") == "resume-from-checkpoint"
        ]
        if not resumes:
            failures.append(f"host {h}: no stamped resume-from-checkpoint")
        else:
            got = {int(r["step"]) for r in resumes
                   if isinstance(r.get("step"), (int, float))}
            if got != {common}:
                failures.append(
                    f"host {h}: resumed from {sorted(got)}, want the "
                    f"committed common step {{{common}}}"
                )
        steps = sorted(
            {int(r["step"]) for r in recs
             if r.get("kind") == "train_step"
             and isinstance(r.get("step"), (int, float))}
        )
        want = set(range(args.steps))
        # The grace save commits PAST the last flushed record on the host
        # that WAS the min (its in-flight step's record died with the
        # process; the training is in the checkpoint) — exactly one
        # missing step, the committed step minus one, same as
        # preempt-train. Hosts past the min re-train and re-log the gap.
        missing = want - set(steps)
        if not steps or not missing <= {common - 1}:
            failures.append(
                f"host {h}: train_step sequence not continuous: got "
                f"{steps}, missing {sorted(missing)}, allowed gap "
                f"{{{common - 1}}}"
            )
        dumps = sorted(flights[h].glob("flight_*.jsonl"))
        dumps_all.extend(dumps)
        if not dumps:
            failures.append(f"host {h}: no flight dumps")
            continue
        drecs = [r for d in dumps for r in _records(d)]
        barrier = [r for r in drecs if r.get("kind") == "barrier"]
        phases = {r.get("phase") for r in barrier}
        if not {"propose", "commit", "saved", "complete"} <= phases:
            failures.append(
                f"host {h}: barrier round incomplete in the evidence "
                f"(phases {sorted(phases)})"
            )
        commits = {r.get("step") for r in barrier
                   if r.get("phase") == "commit"}
        if commits != {common}:
            failures.append(
                f"host {h}: stamped barrier commit {sorted(commits)} != "
                f"pod marker step {common}"
            )
        preempt = [
            r for r in drecs
            if r.get("kind") == "recovery"
            and r.get("action") == "preemption-checkpoint"
        ]
        if not any(r.get("ok") and r.get("pod") for r in preempt):
            failures.append(
                f"host {h}: no successful POD preemption-checkpoint "
                "recovery event in the flight dumps"
            )
    failures.extend(_lint([*metrics.values(), *dumps_all]))

    summary = {
        "event": "chaos-summary",
        "scenario": args.scenario,
        "ok": not failures,
        "hosts": args.hosts,
        "steps": args.steps,
        "committed_common_step": common,
        "proposals": commit.get("proposals"),
        "n_flight_dumps": len(dumps_all),
        "failures": failures[:10],
    }
    _emit(summary, kind="summary")
    if failures:
        for f in failures:
            print(f"CHAOS FAIL: {f}", file=sys.stderr)
        return 1
    return 0


def run_scenario(args) -> int:
    if args.scenario == "ramp-serve":
        return run_ramp_serve(args)
    if args.scenario in ("kill-serve", "rejoin-serve"):
        return run_kill_serve(args)
    if args.scenario == "preempt-pod":
        return run_preempt_pod(args)
    workdir = Path(args.dir)
    paths = {
        "ckpt": workdir / "ckpt",
        "flight": workdir / "flight",
        "metrics": workdir / "metrics.jsonl",
        "run1_log": workdir / "run1.log",
        "run2_log": workdir / "run2.log",
    }
    workdir.mkdir(parents=True, exist_ok=True)
    sig = signal.SIGKILL if args.scenario == "kill-train" else signal.SIGTERM
    cmd = _worker_cmd(args, paths)
    _note(
        f"chaos {args.scenario}: launching worker", cmd=" ".join(cmd),
        workdir=str(workdir),
    )

    # Phase 1: run until enough checkpoints committed, then kill.
    proc = _spawn(cmd, paths["run1_log"])
    deadline = time.monotonic() + args.timeout
    try:
        if not _wait_for_checkpoints(proc, paths["ckpt"], args.kill_after, deadline):
            _emit(
                {
                    "error": "worker-never-checkpointed",
                    "value": None,
                    "note": f"no {args.kill_after} committed checkpoints within "
                    f"{args.timeout}s (rc={proc.poll()}); see {paths['run1_log']}",
                },
                kind="error",
            )
            return 1
        if proc.poll() is not None:
            # The worker finished between polls before the fault could
            # land — the scenario exercised nothing. A distinct stamped
            # error (not "survived-kill"): rerun with a smaller
            # --kill-after or more --steps.
            _emit(
                {"error": "kill-window-missed", "value": None,
                 "note": f"worker exited rc={proc.returncode} before the "
                 f"kill landed; lower --kill-after (now {args.kill_after}) "
                 f"or raise --steps (now {args.steps})"},
                kind="error",
            )
            return 1
        os.kill(proc.pid, sig)
        _emit(
            {
                "fault": "sigkill" if sig == signal.SIGKILL else "sigterm",
                "site": "train-worker",
                "pid": proc.pid,
                "manifests_at_kill": _manifest_count(paths["ckpt"]),
                "wall_time_s": round(time.time(), 3),
            },
            kind="fault",
        )
        try:
            rc1 = proc.wait(timeout=min(120.0, args.timeout))
        except subprocess.TimeoutExpired:
            # A worker that outlives its kill signal (e.g. a wedged
            # SIGTERM grace save) is itself a finding — stamped, like
            # every other failure path here, never a raw traceback.
            _emit(
                {"error": "worker-outlived-kill", "value": None,
                 "note": f"worker pid {proc.pid} still alive "
                 f"{min(120.0, args.timeout)}s after {sig!s}; hard-killing"},
                kind="error",
            )
            return 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
    if rc1 == 0:
        # rc 0 after the signal means the worker was already past its
        # last unsaved work when the fault landed (the exit raced the
        # kill) — same remedy as a missed window, stamped distinctly
        # from a worker that IGNORED the signal (which cannot exit 0:
        # SIGKILL is uncatchable and the SIGTERM chain raises).
        _emit(
            {"error": "kill-window-missed", "value": None,
             "note": "worker exited 0 despite the injected kill (exit "
             "raced the signal); lower --kill-after or raise --steps"},
            kind="error",
        )
        return 1
    _note(f"phase 1 done: worker killed (rc={rc1})")

    # Phase 2: relaunch; --resume must restore and run to completion.
    proc2 = _spawn(cmd, paths["run2_log"])
    try:
        rc2 = proc2.wait(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        proc2.kill()
        proc2.wait(timeout=30.0)
        _emit(
            {"error": "resume-hung", "value": None,
             "note": f"phase-2 worker exceeded {args.timeout}s — a hang IS "
             "the failure mode this harness exists to catch"},
            kind="error",
        )
        return 1
    if rc2 != 0:
        _emit(
            {"error": "resume-failed", "value": None,
             "note": f"phase-2 worker rc={rc2}; see {paths['run2_log']}"},
            kind="error",
        )
        return 1
    _note("phase 2 done: resumed worker ran to completion")

    # Phase 3: the evidence trail must prove the recovery.
    failures: List[str] = []
    recs = _records(paths["metrics"])
    steps = sorted(
        {int(r["step"]) for r in recs
         if r.get("kind") == "train_step" and isinstance(r.get("step"), (int, float))}
    )
    resumes = [
        r for r in recs
        if r.get("kind") == "recovery"
        and r.get("action") == "resume-from-checkpoint"
    ]
    if not resumes:
        failures.append("no stamped resume-from-checkpoint recovery event")
    want = set(range(args.steps))
    missing = want - set(steps)
    # SIGKILL resume re-trains (and re-logs) everything after the last
    # committed step, so the stream must be gapless. The SIGTERM grace
    # save deliberately commits PAST the last flushed record (the
    # in-flight step's record dies with the process, its training is in
    # the checkpoint), so exactly that one step may be missing.
    allowed = set()
    if args.scenario == "preempt-train" and resumes:
        r0 = resumes[0].get("step")
        if isinstance(r0, (int, float)):
            allowed = {int(r0) - 1}
    if not steps or not missing <= allowed:
        failures.append(
            f"train_step sequence not continuous: got {steps}, want "
            f"{sorted(want)} (missing {sorted(missing)}, allowed gap "
            f"{sorted(allowed)})"
        )
    dumps = sorted(paths["flight"].glob("flight_*.jsonl"))
    if not dumps:
        failures.append(f"no flight dumps under {paths['flight']}")
    if args.scenario == "preempt-train":
        preempt = [
            r
            for d in dumps
            for r in _records(d)
            if r.get("kind") == "recovery"
            and r.get("action") == "preemption-checkpoint"
        ]
        if not any(r.get("ok") for r in preempt):
            failures.append(
                "no successful preemption-checkpoint recovery event in any "
                "flight dump (the SIGTERM grace path did not land a save)"
            )
    failures.extend(_lint([paths["metrics"], *dumps]))

    resumed_step: Optional[int] = (
        resumes[0].get("step") if resumes else None
    )
    summary = {
        "event": "chaos-summary",
        "scenario": args.scenario,
        "ok": not failures,
        "steps": args.steps,
        "resumed_from_step": resumed_step,
        "n_recovery_events": len([r for r in recs if r.get("kind") == "recovery"]),
        "n_flight_dumps": len(dumps),
        "failures": failures[:10],
    }
    _emit(summary, kind="summary")
    if failures:
        for f in failures:
            print(f"CHAOS FAIL: {f}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    return run_scenario(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
