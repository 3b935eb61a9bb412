"""Perfetto export: span/flight JSONL -> a browsable timeline.

The port's copy of `glom_tpu/telemetry/perfetto.py`; its trace events
equal glom_tpu's on the same records.

The flight recorder answers "what were the last N events"; spans answer
"where did host time go" — but both as JSONL you read with grep. Perfetto
(ui.perfetto.dev) reads the Chrome JSON trace-event format natively, and
every stamped record this framework writes already carries enough to place
it on a timeline, so the conversion is mechanical:

  * "span" records WITH a start time (t_start from span(writer=...)) become
    complete events (ph "X": name, ts, dur) on a per-depth track — the real
    nested timeline;
  * rollup "span" records (SpanAggregator drains carry only total dur_s /
    count) become counter samples (ph "C") of seconds-per-drain per phase —
    the per-phase load curve over the run;
  * watchdog records become instant events (ph "i") named by state — an
    outage is a visible gash in the timeline; "fault" records (injected
    failures, resilience/faults.py) draw the same full-height line, so a
    chaos run shows each injection next to the recovery that answered it;
  * everything else (train_step, bench, anomaly, error, note, serve,
    recovery) becomes an instant event named by kind, args = the record.

Timestamps: records carry heterogeneous clocks (epoch `t_start` /
`wall_time_s`, run-relative `wall_time` / `t`). Each record uses its best
clock, and the whole trace is normalized to start at 0 — Perfetto needs
ORDER and DURATION, not absolute epochs. Records with no clock at all
(flight dumps from writerless sinks) fall back to their flight_seq /
line order at 1ms spacing, preserving sequence.

The module imports only the standard library and the schema, like the
linter and the compare gate, and touches no device: it must read a crashed
run's dumps.

    python -m glom_tpu_torch.telemetry perfetto FILE... [-o OUT.json]
"""

from __future__ import annotations

import json
import sys
from typing import Iterable, List, Optional

from glom_tpu_torch.telemetry import schema

_PID = 1
# Track (tid) layout: real spans nest by depth on low tids; one-off
# instants and counters get stable named tracks via process_labels;
# barrier events (pod coordination, resilience/coordinator.py) get one
# track PER HOST so a round's propose->commit->saved->complete chain
# reads as flow arrows crossing the hosts instead of a pile of instants.
_TID_SPANS = 1
_TID_EVENTS = 90
_TID_ROLLUPS = 91
# Capacity-observatory tracks: per-(site, axis) collective
# wall-time counters, per-engine headroom counters, and the dispatch
# phase split rendered as NESTED slices (one parent slice per dispatch,
# its five phases as children) so one trace reads
# queue->pack->h2d->device->resolve end to end.
_TID_COLLECTIVES = 92
_TID_CAPACITY = 93
_TID_FLEET = 94
_TID_DISPATCH = 95
_TID_PHASES = 96
# Workload-observatory tracks: the offered arrival rate
# (a trailing-window counter over "workload" records and live "admit"
# events) and the scored forecast series render as counters beside
# fleet:n_engines — load, the fleet's answer, and the forecast that
# should have anticipated it, on adjacent tracks.
_TID_FORECAST = 97
_TID_WORKLOAD = 98
_TID_BARRIER_BASE = 100
# Decision-observatory tracks: one track PER FLEET of
# "decision" instants (schema v10, serve/elastic.py), flow-arrowed to
# the scale/spare events each decision_id actuated — a decision reads
# as an arrow from the instant the policy believed its evidence to the
# spawn/drain/promotion that answered it, beside fleet:n_engines and
# the arrival-rate tracks. Allocated past the barrier range so a pod
# chaos run's host tracks never collide with the fleet tracks.
_TID_DECISION_BASE = 1000
_ARRIVAL_WINDOW_S = 1.0  # the arrival-rate counter's trailing window

# The elastic-serving transition vocabulary (serve/elastic.SCALE_EVENTS —
# mirrored literally: this module stays pure-stdlib importable and the
# serve package pulls torch).
_SCALE_EVENTS = (
    "scale_out_decision",
    "scale_out",
    "admission_open",
    "spawn_rollback",
    "scale_in_decision",
    "drain_begin",
    "drain_flush",
    "drain_migrate",
    "drain_release",
    "spare_spawn",
    "spare_promote",
    "spare_demote",
)


CLOCK_KEYS = ("t_start", "wall_time_s", "wall_time", "t")
# Above this, a clock value is an epoch (time.time()) reading; below, a
# run-relative one. One definition — the pod aggregator
# (telemetry/aggregate.py) reuses both constants for its cross-host
# clock-family reconciliation.
EPOCH_CUTOFF_S = 1e9


def timestamp_s(rec: dict, fallback: float) -> float:
    """Best available clock for one record, in (heterogeneous) seconds.
    Epoch clocks dwarf run-relative ones; normalization happens per clock
    family in to_trace_events, so mixed streams still order sensibly."""
    for key in CLOCK_KEYS:
        v = rec.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    return fallback


_timestamp_s = timestamp_s  # original private name, kept for callers


# One vocabulary for "which traces does this record belong to": the flow
# links must never diverge from the trees the trace CLI reconstructs.
from glom_tpu_torch.telemetry.tracectx import _trace_ids_of  # noqa: E402


def to_trace_events(records: Iterable[dict]) -> List[dict]:
    """Chrome trace-event dicts (ts/dur in microseconds) from stamped
    telemetry records, chronologically normalized to start at ~0.

    Two flow-event families link related instants with arrows:

      * request traces — serve records carrying v6 trace context chain
        per trace_id (ph "s" at the first sighting, "t" per hop, "f" at
        the resolve/response leaf), so selecting one dispatch in the UI
        lights up the whole request across engines and hops;
      * barrier rounds — "barrier" records land on per-host tracks
        (thread_name metadata names them) and chain per round id, so a
        pod save barrier's propose->commit->saved->complete reads as
        arrows crossing the host tracks.
    """
    raw: List[dict] = []
    flow_seen: dict = {}  # barrier/decision flow id -> "open"
    trace_flows: dict = {}  # trace_id -> [(ts, is_leaf), ...]
    barrier_tracks: dict = {}  # tid -> track label
    decision_tracks: dict = {}  # fleet -> tid
    arrival_window: List[float] = []  # trailing arrival ts (seconds)
    class_arrivals: dict = {}  # slo_class -> trailing arrival ts (v11)

    def decision_flow(rec: dict, ts: float, tid: int) -> None:
        # Chain every record carrying a decision_id on one flow id per
        # (fleet, decision): "s" at the first sighting (the decision
        # instant, when the stream carries it), "t" per actuation — the
        # barrier-flow pattern, since the chain's length isn't known
        # until the stream ends.
        did = rec.get("decision_id")
        if not isinstance(did, int) or isinstance(did, bool):
            return
        fleet = rec.get("fleet")
        fleet = fleet if isinstance(fleet, str) and fleet else "fleet0"
        fid = f"decision:{fleet}:{did}"
        raw.append(
            {
                "name": fid,
                "cat": "decision",
                "ph": "s" if fid not in flow_seen else "t",
                "id": fid,
                "pid": _PID,
                "tid": tid,
                "ts": ts,
            }
        )
        flow_seen[fid] = "open"
    for i, rec in enumerate(records):
        kind = rec.get("kind", schema.infer_kind(rec))
        fallback = i * 1e-3  # 1ms spacing keeps clockless records ordered
        ts = _timestamp_s(rec, fallback)
        if kind == "span" and "t_start" in rec:
            raw.append(
                {
                    "name": rec.get("name", "span"),
                    "ph": "X",
                    "pid": _PID,
                    "tid": _TID_SPANS + int(rec.get("depth", 0)),
                    "ts": ts,
                    "dur": float(rec.get("dur_s", 0.0)) * 1e6,
                    "args": rec,
                }
            )
        elif kind == "span":
            # Rollup form: a counter sample of seconds spent in the phase
            # since the last drain (the per-phase load curve).
            raw.append(
                {
                    "name": f"phase:{rec.get('name', 'span')}",
                    "ph": "C",
                    "pid": _PID,
                    "tid": _TID_ROLLUPS,
                    "ts": ts,
                    "args": {"dur_s": float(rec.get("dur_s", 0.0))},
                }
            )
        elif kind == "watchdog":
            raw.append(
                {
                    "name": f"backend:{rec.get('backend_state', '?')}",
                    "ph": "i",
                    "s": "g",  # global scope: draw the full-height line
                    "pid": _PID,
                    "tid": _TID_EVENTS,
                    "ts": ts,
                    "args": rec,
                }
            )
        elif kind == "fault":
            # An injected fault is a full-height line like a watchdog
            # transition: a chaos run's timeline shows each injection as a
            # gash the recovery events then answer.
            raw.append(
                {
                    "name": f"fault:{rec.get('fault', '?')}",
                    "ph": "i",
                    "s": "g",
                    "pid": _PID,
                    "tid": _TID_EVENTS,
                    "ts": ts,
                    "args": rec,
                }
            )
        elif kind == "barrier":
            # One track per host: a pod round's phases land side by side
            # instead of interleaved on the shared events track, and the
            # per-round flow arrows below make the chain's ORDER visible.
            host = rec.get("host")
            if isinstance(host, int) and not isinstance(host, bool):
                tid = _TID_BARRIER_BASE + host
                barrier_tracks[tid] = f"barrier host {host}"
            else:
                tid = _TID_EVENTS
            raw.append(
                {
                    "name": f"barrier:{rec.get('phase', '?')}",
                    "ph": "i",
                    "s": "t",
                    "pid": _PID,
                    "tid": tid,
                    "ts": ts,
                    "args": rec,
                }
            )
            rnd = rec.get("round")
            if isinstance(rnd, str):
                fid = f"barrier:{rnd}"
                raw.append(
                    {
                        "name": fid,
                        "cat": "barrier",
                        "ph": "s" if fid not in flow_seen else "t",
                        "id": fid,
                        "pid": _PID,
                        "tid": tid,
                        "ts": ts,
                    }
                )
                flow_seen[fid] = "open"
        elif kind == "collective_time":
            # One counter track per (site, axis): the per-collective
            # wall-time trend over the run — a congested link shows as
            # one site's counter climbing while its siblings hold.
            axis = rec.get("axis")
            name = f"collective:{rec.get('site', '?')}" + (
                f"@{axis}" if isinstance(axis, str) else ""
            )
            raw.append(
                {
                    "name": name,
                    "ph": "C",
                    "pid": _PID,
                    "tid": _TID_COLLECTIVES,
                    "ts": ts,
                    "args": {"wall_ms": float(rec.get("wall_ms", 0.0))},
                }
            )
        elif kind == "capacity":
            raw.append(
                {
                    "name": f"headroom:{rec.get('engine', '?')}",
                    "ph": "C",
                    "pid": _PID,
                    "tid": _TID_CAPACITY,
                    "ts": ts,
                    "args": {
                        "headroom": float(rec.get("headroom", 0.0))
                    },
                }
            )
        elif kind == "serve" and rec.get("event") in _SCALE_EVENTS:
            # Elastic fleet transitions (schema v8, serve/elastic.py):
            # each decision/transition is a full-height GLOBAL instant —
            # a scale-out reads as a line the latency recovery then
            # answers — and any record carrying n_engines samples the
            # fleet-size counter track (capacity following load, drawn).
            raw.append(
                {
                    "name": f"elastic:{rec.get('event')}",
                    "ph": "i",
                    "s": "g",
                    "pid": _PID,
                    "tid": _TID_EVENTS,
                    "ts": ts,
                    "args": rec,
                }
            )
            n = rec.get("n_engines")
            if isinstance(n, (int, float)) and not isinstance(n, bool):
                raw.append(
                    {
                        "name": "fleet:n_engines",
                        "ph": "C",
                        "pid": _PID,
                        "tid": _TID_FLEET,
                        "ts": ts,
                        "args": {"n_engines": float(n)},
                    }
                )
            decision_flow(rec, ts, _TID_EVENTS)
        elif kind == "decision":
            # One instants track PER FLEET (schema v10): the decision,
            # with its full evidence bundle in args, starts the flow its
            # actuation events extend.
            fleet = rec.get("fleet")
            fleet = (
                fleet if isinstance(fleet, str) and fleet else "fleet0"
            )
            tid = decision_tracks.setdefault(
                fleet, _TID_DECISION_BASE + len(decision_tracks)
            )
            raw.append(
                {
                    "name": f"decision:{rec.get('action', '?')}",
                    "ph": "i",
                    "s": "t",
                    "pid": _PID,
                    "tid": tid,
                    "ts": ts,
                    "args": rec,
                }
            )
            decision_flow(rec, ts, tid)
        elif kind == "forecast":
            # Forecast evidence (schema v9, telemetry/forecast.py): each
            # window samples a counter track per metric beside the fleet
            # and arrival tracks — predicted vs observed load, and the
            # scored error once the horizon matures. Null errors (the
            # window not yet matured) are honest gaps, never zeros.
            args = {}
            for key in (
                "predicted",
                "observed_rate_rps",
                "realized",
                "forecast_abs_err",
                "lead_time_ms",
            ):
                val = rec.get(key)
                if isinstance(val, (int, float)) and not isinstance(
                    val, bool
                ):
                    args[key] = float(val)
            if args:
                raw.append(
                    {
                        "name": f"forecast:{rec.get('metric', '?')}",
                        "ph": "C",
                        "pid": _PID,
                        "tid": _TID_FORECAST,
                        "ts": ts,
                        "args": args,
                    }
                )
        elif kind == "workload" or (
            kind == "serve" and rec.get("event") == "admit"
        ):
            # Offered load (schema v9, serve/workload.py): every workload
            # artifact row — and every live "admit" event — advances a
            # trailing-window arrival-rate counter. Per-arrival instants
            # would drown the events track at serving volume; the rate
            # curve is the readable form.
            arrival_window.append(ts)
            cutoff = ts - _ARRIVAL_WINDOW_S
            while arrival_window and arrival_window[0] < cutoff:
                arrival_window.pop(0)
            raw.append(
                {
                    "name": "workload:arrival_rps",
                    "ph": "C",
                    "pid": _PID,
                    "tid": _TID_WORKLOAD,
                    "ts": ts,
                    "args": {
                        "arrival_rps": round(
                            len(arrival_window) / _ARRIVAL_WINDOW_S, 3
                        )
                    },
                }
            )
            # Per-SLO-class arrival rate (schema v11, serve/qos.py): a
            # classed record ALSO advances its tenant's own counter on
            # the same track — the flash-crowd mix reads as stacked
            # curves. Classless streams (slo_class null/absent) never
            # emit these, keeping their traces byte-identical.
            cls = rec.get("slo_class")
            if isinstance(cls, str) and cls:
                win = class_arrivals.setdefault(cls, [])
                win.append(ts)
                while win and win[0] < cutoff:
                    win.pop(0)
                raw.append(
                    {
                        "name": f"workload:arrival_rps[{cls}]",
                        "ph": "C",
                        "pid": _PID,
                        "tid": _TID_WORKLOAD,
                        "ts": ts,
                        "args": {
                            "arrival_rps": round(
                                len(win) / _ARRIVAL_WINDOW_S, 3
                            )
                        },
                    }
                )
        else:
            label = {
                "train_step": f"step {rec.get('step', '?')}",
                "bench": str(rec.get("metric", "bench")),
                "anomaly": f"anomaly: {rec.get('reason', '?')}",
                "error": f"error: {rec.get('error', '?')}",
                "serve": f"serve:{rec.get('event', '?')}",
                "recovery": f"recovery:{rec.get('action', '?')}",
            }.get(kind, kind)
            if (
                kind == "serve"
                and rec.get("event") == "dispatch"
                and isinstance(rec.get("latency_ms"), (int, float))
                and isinstance(rec.get("device_ms"), (int, float))
            ):
                # The dispatch phase split as NESTED slices: the record's
                # clock reads at stamp time (after the dispatch), so the
                # parent slice starts latency_ms earlier and the five
                # phases lay out consecutively under it — one trace shows
                # where each dispatch's wall went, next to the request
                # flow arrows.
                lat_s = float(rec["latency_ms"]) / 1e3
                t_start = ts - lat_s
                raw.append(
                    {
                        "name": f"dispatch:{rec.get('engine', '?')}",
                        "ph": "X",
                        "pid": _PID,
                        "tid": _TID_DISPATCH,
                        "ts": t_start,
                        "dur": lat_s * 1e6,
                        "args": rec,
                    }
                )
                cursor = t_start
                for phase in (
                    "queue_wait_ms", "pack_ms", "h2d_ms", "device_ms",
                    "resolve_ms",
                ):
                    v = rec.get(phase)
                    if not isinstance(v, (int, float)):
                        continue
                    raw.append(
                        {
                            "name": phase[: -len("_ms")],
                            "ph": "X",
                            "pid": _PID,
                            "tid": _TID_PHASES,
                            "ts": cursor,
                            "dur": float(v) * 1e3,  # ms -> us
                            "args": {phase: v},
                        }
                    )
                    cursor += float(v) / 1e3
            raw.append(
                {
                    "name": label,
                    "ph": "i",
                    "s": "t",
                    "pid": _PID,
                    "tid": _TID_EVENTS,
                    "ts": ts,
                    "args": rec,
                }
            )
            if kind in ("serve", "recovery", "span"):
                # Collect this record into each request trace it belongs
                # to (schema v6 trace context); phases are assigned after
                # the walk, in TIMESTAMP order — the batcher emits a
                # hop's resolve leaf BEFORE the hop's dispatch record, so
                # assigning phases in stream order would start the flow
                # at the leaf (never closing it) or close it early and
                # drop the final hop.
                leaf = rec.get("event") in ("resolve", "response")
                for trace_id in _trace_ids_of(rec):
                    trace_flows.setdefault(trace_id, []).append((ts, leaf))
    # Flow-link each trace's records in CAUSAL order — hop records
    # (dispatch/continuation/...) by timestamp, then the leaves
    # (resolve/response): one "s" at the first hop, "t" per further hop,
    # one "f" at the first leaf. Neither stream order nor pure ts order
    # is causal here: the batcher stamps a hop's resolve leaf BEFORE the
    # hop's own dispatch record (and the dispatch record's clock reads
    # LATER), so either walk would start the flow at the leaf, or close
    # it early and skip the final hop. Records after the finish are not
    # flow-linked (a second leaf, e.g. the CLI response after the
    # batcher's resolve, would close an already-terminated flow, which
    # the importer drops); flow ts is clamped monotone so the closing
    # arrow never points backward across the ms-scale stamp skew.
    for trace_id, cands in trace_flows.items():
        cands.sort(key=lambda c: (c[1], c[0]))
        prev_ts = None
        for i, (cts, leaf) in enumerate(cands):
            ph = "s" if i == 0 else ("f" if leaf else "t")
            if prev_ts is not None:
                cts = max(cts, prev_ts)
            prev_ts = cts
            raw.append(
                {
                    "name": f"trace:{trace_id[:8]}",
                    "cat": "trace",
                    "ph": ph,
                    **({"bp": "e"} if ph == "f" else {}),
                    "id": f"trace:{trace_id}",
                    "pid": _PID,
                    "tid": _TID_EVENTS,
                    "ts": cts,
                }
            )
            if ph == "f":
                break
    if not raw:
        return []
    # Normalize per clock family: epoch-clock events (> EPOCH_CUTOFF_S)
    # and run-relative ones each shift to their own zero, so a stream
    # mixing both still renders compactly instead of 50 years wide. Flow
    # events copied their anchor instant's ts, so they stay in family.
    epochs = [e["ts"] for e in raw if e["ts"] > EPOCH_CUTOFF_S]
    relatives = [e["ts"] for e in raw if e["ts"] <= EPOCH_CUTOFF_S]
    e0 = min(epochs) if epochs else 0.0
    r0 = min(relatives) if relatives else 0.0
    for e in raw:
        base = e0 if e["ts"] > EPOCH_CUTOFF_S else r0
        e["ts"] = round((e["ts"] - base) * 1e6, 3)
        if "dur" in e:
            e["dur"] = round(e["dur"], 3)
    raw.sort(key=lambda e: e["ts"])
    # Name the workload-observatory tracks when they carry samples.
    named_tids = {e["tid"] for e in raw}
    for tid, label in (
        (_TID_FORECAST, "forecast"),
        (_TID_WORKLOAD, "workload arrivals"),
    ):
        if tid in named_tids:
            raw.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": _PID,
                    "tid": tid,
                    "args": {"name": label},
                }
            )
    # Name the per-fleet decision tracks (metadata events; ts-less).
    for fleet, tid in sorted(decision_tracks.items()):
        raw.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": _PID,
                "tid": tid,
                "args": {"name": f"decisions {fleet}"},
            }
        )
    # Name the per-host barrier tracks (metadata events; ts-less).
    for tid, label in sorted(barrier_tracks.items()):
        raw.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": _PID,
                "tid": tid,
                "args": {"name": label},
            }
        )
    return raw


def convert_lines(lines: Iterable[str]) -> dict:
    """One JSONL stream -> the Chrome/Perfetto trace object."""
    records = [rec for _, rec in schema.iter_json_lines(lines)]
    return {
        "traceEvents": to_trace_events(records),
        "displayTimeUnit": "ms",
        "metadata": {"source": "glom_tpu_torch.telemetry.perfetto"},
    }


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m glom_tpu_torch.telemetry perfetto",
        description="Convert span/flight/telemetry JSONL to a Perfetto-"
        "loadable JSON trace (open at ui.perfetto.dev)",
    )
    ap.add_argument("paths", nargs="+", help="JSONL logs / flight dumps")
    ap.add_argument(
        "-o", "--out", default=None,
        help="output path (default: <first input>.perfetto.json); all "
        "inputs merge into one trace",
    )
    args = ap.parse_args(argv)

    records = []
    for path in args.paths:
        with open(path) as fh:
            records.extend(rec for _, rec in schema.iter_json_lines(fh))
    if not records:
        print(f"no JSON records in {args.paths}", file=sys.stderr)
        return 1
    trace = {
        "traceEvents": to_trace_events(records),
        "displayTimeUnit": "ms",
        "metadata": {"source": "glom_tpu_torch.telemetry.perfetto",
                     "inputs": args.paths},
    }
    out = args.out if args.out else args.paths[0] + ".perfetto.json"
    with open(out, "w") as fh:
        json.dump(trace, fh)
    print(f"{out}: {len(trace['traceEvents'])} events")
    return 0


if __name__ == "__main__":
    sys.exit(main())
