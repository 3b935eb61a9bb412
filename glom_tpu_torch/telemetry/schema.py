"""Versioned JSONL event schema: the one record contract every sink speaks.

The port's copy of `glom_tpu/telemetry/schema.py`, unchanged in content so
that a record the port writes validates against glom_tpu's contract and
the other way round. Every record any part of the port writes (trainer
metrics, span rollups, anomaly, fault and recovery events) carries
`schema_version` and a `kind`, and validates against the field contract
below. `python -m glom_tpu_torch.telemetry FILE...` lints any log (JSON
lines mixed with shell noise are fine; noise is skipped, stamped records
must validate).

Versioning: SCHEMA_VERSION bumps on any breaking field change; readers
accept records with version <= theirs. Pure stdlib.
"""

from __future__ import annotations

import json
import sys
from typing import Iterable, List, Optional, Tuple

# v2 added the "span" kind (host-side tracing, glom_tpu/tracing/spans.py)
# and the "error" kind (UNMEASURED bench rows: value null + a machine-
# readable error string, so trajectory tooling never ingests dead zeros).
# v3 added the "serve" kind (glom_tpu/serve: inference-engine lifecycle —
# warmup compiles, batch dispatches, request responses, shed decisions).
# v4 added the "fault" kind (glom_tpu/resilience/faults.py: one INJECTED
# failure — the chaos harness's ground truth, so recovery can be verified
# against exactly what was injected) and the "recovery" kind (one recovery
# decision or action: checkpoint resume, dispatch retry, torn-checkpoint
# skip, preemption save — docs/RESILIENCE.md).
# v5 added the "barrier" kind (glom_tpu/resilience/coordinator.py: one
# phase of a pod-coordination round — a preemption save barrier's
# propose/commit/saved/complete/abort, a gang-restart rendezvous — so a
# multi-process chaos run can reconcile every host's view of the SAME
# round from the per-host evidence streams alone).
# v6 added request-scoped TRACE CONTEXT (telemetry/tracectx.py): serve
# records of request-scoped events carry trace_id/span_id/parent_span
# (batch-level records the parallel trace_ids/parent_spans lists), the
# new "resolve" serve event is the per-request conservation leaf, and
# the new "slo_breach" kind is one windowed SLO-rule violation from the
# live monitor (`python -m glom_tpu_torch.telemetry watch`,
# telemetry/aggregate.py).
# v7 is the capacity observatory (docs/OBSERVABILITY.md): the new
# "collective_time" kind is one registered collective site's measured
# wall time (telemetry/comm_time.py — site/axis/bytes/wall_ms/bytes_per_s
# plus the α-β comm_time_model fit and its drift), the new "capacity"
# kind is one engine's headroom rollup (service-rate estimate x live
# queue/continuation/affinity/page-pool occupancy — the signal
# `telemetry watch --slo headroom=X` tails and the elastic-serving
# control loop will read), and serve "dispatch" records split latency_ms
# into queue_wait/pack/h2d/device/resolve phase fields that sum to it
# bit-exactly (conservation extended by `telemetry trace`).
# v8 is elastic serving (glom_tpu/serve/elastic.py, docs/SERVING.md
# "Elastic serving"): new serve events for the autoscaler's decision and
# transition chain — "scale_out_decision"/"scale_in_decision" (the
# triggering signal window embedded), "scale_out" (+spawn_ms),
# "admission_open" (a spawned replica opens for traffic strictly after
# its warmup precompile), "spawn_rollback" (a failed scale-out rolled
# back loudly), "drain_begin"/"drain_flush"/"drain_migrate"/
# "drain_release" (the graceful scale-in state machine), "engine_add",
# "cache_migrate" (one session's paged columns moved to a sibling pool)
# — each carrying the decision_id that chains it to its decision; and
# "capacity" records now stamp `state` ("ok" | "draining" | "probation"
# | "dead") so the SLO monitor can EXCLUDE deliberately draining or
# probing engines from the headroom windowed-min.
# v9 is the workload observatory (serve/workload.py,
# telemetry/forecast.py, docs/OBSERVABILITY.md "Workload observatory"):
# the new "workload" kind is one OFFERED request — arrival time `t`
# (seconds, run-relative), shape `signature` ("bucket:CxHxW" |
# "ragged:<pages>p" | "delta:CxHxW"), and `outcome` ("served" | "shed" |
# "failed" | "unresolved" | "offered" — the last is a scenario-generated
# request not yet realized); a workload JSONL artifact replays
# deterministically (bench_serve.py --replay, python -m glom_tpu.serve
# --replay). The new "forecast" kind is one scored short-horizon
# prediction — `metric` names the forecast series ("arrival_rate_rps",
# "service_rate_rps", "spawn_lead_time"), `horizon_s` how far ahead it
# looked, and the `forecast_abs_err` KEY must be PRESENT on every
# record (null = no prediction matured yet — degenerate fits pin
# honestly like the α-β model; an ABSENT key means the emitter never
# scored itself, which is a lint failure, not a silent gap). The new
# serve event "engine_husk_retired" folds a pruned drained-husk's
# counters into the evidence stream so summary conservation still
# reconciles after retention trims the engines nest.
# v10 is the decision observatory (serve/elastic.py, telemetry/audit.py,
# docs/OBSERVABILITY.md "Decision observatory"): the new "decision" kind
# is one autoscaling decision that ACTED — `action` ("scale_out" |
# "scale_in"), `decision_id` extending the per-fleet chain
# (`prev_decision_id` links backwards; `fleet` labels the chain), and
# the `evidence` KEY must be PRESENT on every record: the full input
# bundle (headroom/dwell/breach state, the forecast window believed at
# decision time with its forecast_abs_err, the spawn-lead-time quantile,
# the measured fleet service rate) that the pure policy function
# (telemetry/audit.py policy_action) must replay to the stamped action
# bit-for-bit — `python -m glom_tpu_torch.telemetry audit` enforces it. New
# serve events "spare_spawn" / "spare_promote" / "spare_demote" stamp
# the warm-pool spare lifecycle (pre-spawned engines held outside
# admission), each promotion/demotion carrying its owning decision_id.
# v11 is multi-tenant QoS (serve/qos.py, docs/SERVING.md "SLO classes"):
# REQUEST-scoped serve events ("admit" / "shed" / "settle" / "resolve")
# and "workload" records must carry the `slo_class` KEY (null = a
# classless config — fine; ABSENT = an emit site that never threaded
# the class, a lint failure — the v6 trace-key presence precedent).
# The serve "summary" grows per-class `classes` + `class_scheduler`
# nests, "capacity" records a per-class `class_fill`, and decision
# evidence stamps `low_classes` / `class_weights` so `telemetry audit`
# can replay class-aware policy and score class-weighted regret.
SCHEMA_VERSION = 11

_NUM = (int, float)
_STR = (str,)

# kind -> {required field: allowed JSON types}. Extra fields are always
# allowed (records grow; the schema pins the load-bearing core).
KINDS = {
    # One optimizer step's metrics (trainer fit loops).
    "train_step": {"step": _NUM, "loss": _NUM},
    # One benchmark measurement (bench*.py prints these as JSON lines).
    "bench": {"metric": _STR, "value": _NUM, "unit": _STR},
    # A backend-liveness state transition (telemetry/watchdog.py).
    "watchdog": {"backend_state": _STR, "t": _NUM},
    # Something went wrong inside a run (NaN/Inf guard, skip-step, ...).
    "anomaly": {"step": _NUM, "reason": _STR},
    # End-of-run rollups (loss-curve summaries etc.).
    "summary": {},
    # Free-text context lines (e.g. bench cpu-fallback notes).
    "note": {"note": _STR},
    # A timed host-side span (glom_tpu/tracing/spans.py): dur_s is the
    # (total) seconds attributed to `name`.
    "span": {"name": _STR, "dur_s": _NUM},
    # A measurement that could NOT be taken (backend down, OOM): carries
    # `value: null` — NEVER 0.0 — plus the error string; the compare gate
    # and trajectory tooling treat these as missing, not zero.
    "error": {"error": _STR},
    # One inference-serving lifecycle event (glom_tpu/serve): `event` names
    # it — "warmup" (one AOT compile per bucket), "dispatch" (one batched
    # forward), "response" (one request served), "shed" (admission
    # rejected), "ladder" (one degradation-ladder rung transition),
    # "summary" (end-of-run rollup). Extra fields (bucket, n_valid,
    # latency_ms, iters_run, rung, queue_fill, ...) ride per event.
    "serve": {"event": _STR},
    # One INJECTED failure (glom_tpu/resilience/faults.py): `fault` names
    # the fault class ("backend-flap", "dispatch-error", "nan-storm",
    # "ckpt-write", "queue-stall", ...); `site` and `index` pin where and
    # which occurrence, so a chaos run's recovery events can be reconciled
    # one-to-one against what the harness actually injected.
    "fault": {"fault": _STR},
    # One recovery decision or action (docs/RESILIENCE.md): `action` names
    # it — "resume-from-checkpoint", "restart", "dispatch-retry",
    # "skip-torn-checkpoint", "preemption-checkpoint", "give-up",
    # "quarantine-half-step", "gang-stop". Extra fields (step, attempt,
    # backoff_s, ...) ride per action.
    "recovery": {"action": _STR},
    # One phase of a pod-coordination round (resilience/coordinator.py):
    # `phase` names it — "propose" (this host's highest dispatchable
    # step), "commit" (the round's agreed min), "saved" (this host landed
    # the committed step), "complete" (every host acked), "abort" (the
    # deadline passed or a peer aborted — NO partial pod checkpoint may
    # masquerade as complete), "arrive" (gang-restart rendezvous).
    # `round` identifies the round; host/n_hosts/step ride per phase.
    "barrier": {"phase": _STR, "round": _STR},
    # One windowed SLO-rule violation from the live monitor
    # (telemetry/aggregate.py, `python -m glom_tpu_torch.telemetry watch`):
    # `rule` names the violated rule ("p99_ms", "shed_rate", ...);
    # threshold/observed/window_s/n_samples ride per breach. The flight
    # recorder counts these toward its anomaly-storm trigger.
    "slo_breach": {"rule": _STR},
    # One registered collective site's measured wall time
    # (telemetry/comm_time.py): `site` names the record_collective-
    # registered site, `wall_ms` its measured wall clock; axis /
    # collective / wire_bytes / bytes_per_s / mode ("sampled" | "full")
    # / comm_time_model_ms / comm_time_model_drift ride per row, and the
    # `site: "comm_time_model"` row carries the fitted α-β form itself.
    "collective_time": {"site": _STR, "wall_ms": _NUM},
    # One engine's capacity/headroom rollup (serve/batcher.py,
    # docs/OBSERVABILITY.md "Capacity observatory"): `headroom` in [0, 1]
    # is 1 - the worst live occupancy across the engine's lanes (queue /
    # continuation / affinity / page pool); service_rate_rps estimates
    # the sustainable requests/s from the measured dispatch latencies.
    # `telemetry watch --slo headroom=X` breaches when it drops BELOW X
    # (the one lower-bound rule).
    "capacity": {"engine": _STR, "headroom": _NUM},
    # One OFFERED serving request (serve/workload.py WorkloadRecorder,
    # docs/OBSERVABILITY.md "Workload observatory"): `t` is the arrival
    # time in run-relative seconds, `signature` the admission shape
    # ("bucket:CxHxW" | "ragged:<pages>p" | "delta:CxHxW"), `outcome`
    # what became of it ("served" | "shed" | "failed" | "unresolved" |
    # "offered"). session / shape / seed / latency_ms / detail ride
    # per record; a stream of these IS the replayable artifact.
    "workload": {"t": _NUM, "signature": _STR, "outcome": _STR},
    # One scored short-horizon prediction (telemetry/forecast.py):
    # `metric` names the series, `horizon_s` the look-ahead. predicted /
    # realized / forecast_abs_err / lead_time_ms / trend_per_s /
    # seasonal / n_samples / reason ride per record; the
    # forecast_abs_err KEY must be present on every v9 record (null =
    # nothing matured yet; absent = the emitter never scored itself —
    # enforced by validate_record below).
    "forecast": {"metric": _STR, "horizon_s": _NUM},
    # One autoscaling decision that acted (serve/elastic.py,
    # telemetry/audit.py, docs/OBSERVABILITY.md "Decision observatory"):
    # `action` is "scale_out" | "scale_in", `decision_id` extends the
    # per-fleet chain (prev_decision_id / fleet / t ride per record),
    # and the `evidence` key — the full input bundle the pure policy
    # function replays bit-for-bit — must be present on every v10
    # record (enforced by validate_record below).
    "decision": {"action": _STR, "decision_id": _NUM},
}

# Serve events that are REQUEST-scoped and must carry trace context on
# schema-v6 records (telemetry/tracectx.py mints and reconstructs it; the
# key may be null — an explicitly UNTRACED record, ServeConfig.
# trace_requests=False — but it must be PRESENT, so an emit site that
# forgot the threading is a lint failure, not a silent gap in the tree).
TRACE_REQUIRED_EVENTS = (
    "dispatch",
    "continuation",
    "shed",
    "resolve",
    "engine_failover",
    "dispatch_error",
    "response",
)
_TRACE_KEYS = ("trace_id", "trace_ids")

# Serve events that are scoped to ONE request and must carry the SLO
# class key on schema-v11 records (serve/qos.py; null = classless config,
# absent = the emit site never threaded the class — the same
# present-but-nullable contract as the v6 trace keys above).
CLASS_REQUIRED_EVENTS = (
    "admit",
    "shed",
    "settle",
    "resolve",
)
_CLASS_KEY = "slo_class"

WATCHDOG_STATES = ("unknown", "up", "down", "flapping")


class SchemaError(ValueError):
    pass


def infer_kind(rec: dict) -> str:
    """Best-effort kind for legacy records written before stamping."""
    if "fault" in rec:
        return "fault"
    if "site" in rec and "wall_ms" in rec:
        return "collective_time"
    if "headroom" in rec and "engine" in rec:
        return "capacity"
    if "phase" in rec and "round" in rec:
        return "barrier"
    if "backend_state" in rec and ("t" in rec or "event" in rec):
        return "watchdog"
    if "name" in rec and "dur_s" in rec:
        return "span"
    if "error" in rec and not isinstance(rec.get("value"), _NUM):
        # An UNMEASURED row (value null/absent + error string) is an
        # "error" record; a MEASURED row that merely carries an error
        # context field still infers by its numeric value below.
        return "error"
    if "metric" in rec and "value" in rec:
        return "bench"
    if "reason" in rec and "step" in rec:
        return "anomaly"
    if "note" in rec:
        return "note"
    if "summary" in rec:
        return "summary"
    if "loss" in rec or "step" in rec:
        return "train_step"
    return "summary"


def stamp(rec: dict, kind: Optional[str] = None) -> dict:
    """Return a copy of `rec` carrying schema_version + kind (idempotent:
    existing stamps are preserved, so double-stamping through nested sinks
    cannot relabel a record)."""
    out = dict(rec)
    out.setdefault("schema_version", SCHEMA_VERSION)
    out.setdefault("kind", kind if kind is not None else infer_kind(rec))
    return out


def validate_record(rec: object) -> List[str]:
    """Errors for one decoded record; empty list = valid."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    errs = []
    v = rec.get("schema_version")
    if not isinstance(v, int) or isinstance(v, bool):
        errs.append(f"schema_version {v!r} is not an int")
    elif not 1 <= v <= SCHEMA_VERSION:
        errs.append(f"schema_version {v} outside 1..{SCHEMA_VERSION}")
    kind = rec.get("kind")
    if kind not in KINDS:
        errs.append(f"kind {kind!r} not one of {sorted(KINDS)}")
        return errs
    for field, types in KINDS[kind].items():
        if field not in rec:
            errs.append(f"{kind} record missing required field {field!r}")
        elif not isinstance(rec[field], types) or isinstance(rec[field], bool):
            errs.append(
                f"{kind}.{field} is {type(rec[field]).__name__}, "
                f"expected {'/'.join(t.__name__ for t in types)}"
            )
    if kind == "watchdog" and rec.get("backend_state") not in WATCHDOG_STATES:
        errs.append(
            f"watchdog.backend_state {rec.get('backend_state')!r} not one "
            f"of {WATCHDOG_STATES}"
        )
    if (
        kind == "serve"
        and isinstance(v, int)
        and v >= 6
        and rec.get("event") in TRACE_REQUIRED_EVENTS
        and not any(k in rec for k in _TRACE_KEYS)
    ):
        # v6's request-tracing contract: request-scoped serve events must
        # carry trace context (null = explicitly untraced is fine; an
        # ABSENT key means an emit site never threaded the context and
        # this record can never join its request's tree).
        errs.append(
            f"serve.{rec.get('event')} record (v{v}) carries no trace "
            f"context key ({'/'.join(_TRACE_KEYS)}) — see "
            "telemetry/tracectx.py"
        )
    if (
        isinstance(v, int)
        and v >= 11
        and (
            (kind == "serve" and rec.get("event") in CLASS_REQUIRED_EVENTS)
            or kind == "workload"
        )
        and _CLASS_KEY not in rec
    ):
        # v11's multi-tenant contract (the v6 trace-key pattern):
        # request-scoped serve events and workload records must carry
        # the slo_class KEY — null on a classless config, but never
        # silently absent, so per-tenant conservation can always be
        # reconciled (see serve/qos.py).
        what = (
            f"serve.{rec.get('event')}" if kind == "serve" else "workload"
        )
        errs.append(
            f"{what} record (v{v}) carries no {_CLASS_KEY} key — the SLO "
            "class must be stamped on every request-scoped record (null = "
            "classless; see glom_tpu/serve/qos.py)"
        )
    if (
        kind == "forecast"
        and isinstance(v, int)
        and v >= 9
        and "forecast_abs_err" not in rec
    ):
        # v9's forecast-quality contract (the trace-presence pattern):
        # every forecast record must carry its predicted-vs-realized
        # error KEY — null while no prediction has matured (degenerate
        # fits pin honestly), but never silently absent, so an emitter
        # that stopped scoring itself is a lint failure the moment it
        # writes, not a quiet gap in the gate.
        errs.append(
            f"forecast.{rec.get('metric')} record (v{v}) carries no "
            "forecast_abs_err key — predicted-vs-realized error must be "
            "stamped on every window (null = not matured; absent = "
            "unscored; see telemetry/forecast.py)"
        )
    if (
        kind == "decision"
        and isinstance(v, int)
        and v >= 10
        and "evidence" not in rec
    ):
        # v10's decision-provenance contract (the same presence pattern):
        # a decision without its inputs on the record can never be
        # audited — `telemetry audit` replays the evidence through the
        # pure policy function and demands the stamped action back.
        errs.append(
            f"decision.{rec.get('action')} record (v{v}) carries no "
            "evidence key — the input bundle must be stamped on every "
            "decision (see telemetry/audit.py)"
        )
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        errs.append(f"record is not JSON-serializable: {e}")
    return errs


def assert_valid(rec: dict) -> dict:
    errs = validate_record(rec)
    if errs:
        raise SchemaError("; ".join(errs))
    return rec


def iter_json_lines(lines: Iterable[str]) -> Iterable[Tuple[int, dict]]:
    """(lineno, record) for every line that parses as a JSON object —
    shell noise, timestamps, and tracebacks interleaved in hw-queue logs
    are skipped, not errors."""
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            yield i, rec


def lint_stream(
    lines: Iterable[str],
    *,
    require_stamp: bool = True,
    require_records: bool = True,
) -> List[str]:
    """Validate every JSON record in a log stream. require_stamp=True (the
    CI mode) also fails records that never got a schema_version — the
    whole point is that no sink writes unstamped rows anymore.
    require_records=True additionally fails a stream with NO JSON records
    at all (an empty bench log is the round-5 'empty evidence trajectory'
    regression); the queue's mixed-log sweep passes False, since probe /
    tpu_validate logs legitimately contain no JSON."""
    errors = []
    n = 0
    for lineno, rec in iter_json_lines(lines):
        n += 1
        if "schema_version" not in rec and not require_stamp:
            continue
        for e in validate_record(rec):
            errors.append(f"line {lineno}: {e}")
    if n == 0 and require_records:
        errors.append("no JSON records found")
    return errors


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m glom_tpu_torch.telemetry.schema",
        description="Lint JSONL telemetry/bench logs against the event schema",
    )
    ap.add_argument("paths", nargs="+")
    ap.add_argument(
        "--allow-unstamped", action="store_true",
        help="skip records without schema_version instead of failing them; "
        "also tolerates files with no JSON records at all (the hw-queue "
        "sweep over mixed shell logs)",
    )
    args = ap.parse_args(argv)
    rc = 0
    for path in args.paths:
        with open(path) as fh:
            errs = lint_stream(
                fh,
                require_stamp=not args.allow_unstamped,
                require_records=not args.allow_unstamped,
            )
        if errs:
            rc = 1
            for e in errs:
                print(f"{path}: {e}", file=sys.stderr)
        else:
            print(f"{path}: OK")
    return rc


if __name__ == "__main__":
    sys.exit(main())
