"""Request-scoped trace context, and the trace CLI that rebuilds a tree.

The port's copy of `glom_tpu/telemetry/tracectx.py`. A serving dispatch
opens `dispatch_scope(...)`; every recovery or span record emitted from
under it inherits the trace fields (`current_fields()` merges them at the
stamp sites: resilience/faults.emit_recovery, tracing/spans.span).

    python -m glom_tpu_torch.telemetry trace FILE... --trace-id X

prints one request's causal tree and checks that its per-hop executed
work sums to the totals the request resolved with (exit 1 when it does
not). Pure stdlib.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, List, Optional

# The trace-context vocabulary (schema v6). Per-request records carry the
# singular keys; batch-level records (a dispatch serves many traces) carry
# the parallel plural lists, row-aligned with the batch. The set of serve
# events REQUIRED to carry them is schema.TRACE_REQUIRED_EVENTS — the
# schema registry owns the contract, this module owns the mechanics.
TRACE_FIELDS = ("trace_id", "span_id", "parent_span")
TRACE_BATCH_FIELDS = ("trace_ids", "span_id", "parent_spans")

# The serve latency decomposition (schema v7, docs/OBSERVABILITY.md
# "Capacity observatory"): every dispatch record splits latency_ms into
# these phase fields, IN THIS ORDER — the batcher defines latency_ms as
# their left-to-right float sum, so the conservation check below is
# bit-exact, not approximate. Null values mean ServeConfig.phase_split
# was off (the keys are still present, like the trace-context contract).
PHASE_KEYS = (
    "queue_wait_ms", "pack_ms", "h2d_ms", "device_ms", "resolve_ms"
)


def new_id(nbytes: int = 8) -> str:
    """A fresh random hex id (16 hex chars by default — trace and span
    ids share the format; collision across one deployment's traces is
    negligible at 64 bits)."""
    return os.urandom(nbytes).hex()


new_trace_id = new_id
new_span_id = new_id


# -- thread-local dispatch scope --------------------------------------------

_local = threading.local()


class dispatch_scope:
    """Context manager marking THIS thread as executing one dispatch.

    Every record stamped from inside (retry recovery events, cache
    evictions, a lazy mid-traffic warmup compile, host spans with a
    writer) inherits the scope's trace fields via `current_fields()` —
    the in-process analog of trace-context propagation, with no
    signature changes through the engine/retry/cache layers."""

    def __init__(self, span_id, trace_ids, parent_spans=None):
        self._fields = {"span_id": span_id, "trace_ids": trace_ids}
        if parent_spans is not None:
            self._fields["parent_spans"] = parent_spans

    def __enter__(self):
        stack = getattr(_local, "scopes", None)
        if stack is None:
            stack = _local.scopes = []
        stack.append(self._fields)
        return self

    def __exit__(self, *exc):
        _local.scopes.pop()


def current_fields() -> dict:
    """The innermost open dispatch scope's trace fields on this thread
    ({} outside any scope). Stamp sites merge these with setdefault, so
    explicitly-carried fields always win."""
    stack = getattr(_local, "scopes", None)
    if not stack:
        return {}
    return dict(stack[-1])


# -- tree reconstruction ----------------------------------------------------


def _trace_ids_of(rec: dict) -> List[str]:
    """Every trace id one record belongs to (singular or batch form)."""
    out = []
    t = rec.get("trace_id")
    if isinstance(t, str):
        out.append(t)
    ts = rec.get("trace_ids")
    if isinstance(ts, (list, tuple)):
        out.extend(x for x in ts if isinstance(x, str))
    return out


def records_for(records: Iterable[dict], trace_id: str) -> List[dict]:
    """The subset of `records` belonging to one trace, in stream order."""
    return [r for r in records if trace_id in _trace_ids_of(r)]


def _parent_for(rec: dict, trace_id: str) -> Optional[str]:
    """This record's parent span AS SEEN BY one trace: the singular
    `parent_span`, or the row-aligned entry of `parent_spans`."""
    p = rec.get("parent_span")
    if isinstance(p, str):
        return p
    parents = rec.get("parent_spans")
    traces = rec.get("trace_ids")
    if isinstance(parents, (list, tuple)) and isinstance(traces, (list, tuple)):
        for t, pp in zip(traces, parents):
            if t == trace_id and isinstance(pp, str):
                return pp
    return None


def list_traces(records: Iterable[dict]) -> Dict[str, dict]:
    """trace_id -> {n_records, n_hops, resolved, iters_total} for every
    trace seen in the stream (the `trace` subcommand's no-id listing)."""
    out: Dict[str, dict] = {}
    for rec in records:
        for t in _trace_ids_of(rec):
            slot = out.setdefault(
                t,
                {"n_records": 0, "n_hops": 0, "resolved": False,
                 "iters_total": None},
            )
            slot["n_records"] += 1
            if rec.get("event") == "dispatch":
                slot["n_hops"] += 1
            if rec.get("event") == "resolve":
                slot["resolved"] = True
                slot["iters_total"] = rec.get("iters_total")
    return out


def build_tree(records: Iterable[dict], trace_id: str) -> dict:
    """One trace's causal tree.

    Nodes are SPANS: records sharing a span_id (a dispatch plus the retry
    / cache / warmup events stamped under its scope) collapse into one
    node carrying them all; edges follow each record's parent span as
    seen by this trace. Parents that no record owns roll up to the
    synthesized root (the submit span the batcher minted — submit itself
    emits no record on the happy path). Returns
    {"trace_id", "root": node} with node = {"span_id", "records",
    "children": [node...]}."""
    mine = records_for(records, trace_id)
    nodes: Dict[str, dict] = {}
    order: List[str] = []
    parent_of: Dict[str, Optional[str]] = {}
    for rec in mine:
        span = rec.get("span_id")
        if not isinstance(span, str):
            # A trace-stamped record with no span of its own (e.g. a
            # legacy sink): attach it to the root.
            span = f"<anonymous:{len(nodes)}>"
        node = nodes.get(span)
        if node is None:
            node = nodes[span] = {
                "span_id": span, "records": [], "children": [],
            }
            order.append(span)
        node["records"].append(rec)
        if span not in parent_of:
            parent_of[span] = _parent_for(rec, trace_id)
    root = {"span_id": None, "records": [], "children": []}
    for span in order:
        parent = parent_of.get(span)
        if parent is not None and parent in nodes:
            nodes[parent]["children"].append(nodes[span])
        else:
            if root["span_id"] is None and parent is not None:
                root["span_id"] = parent  # the minted submit span
            root["children"].append(nodes[span])
    return {"trace_id": trace_id, "root": root}


def conservation(records: Iterable[dict], trace_id: str) -> dict:
    """The trace-parity check: per-request executed work must CONSERVE
    across hops. Sums `iters_run` and `latency_ms` over the trace's
    dispatch hops and compares them against the stamped "resolve" leaf's
    `iters_total` / `dispatch_ms_total` (what the ticket resolved with).
    ok=True requires a resolve record and EXACT equality — a missing hop
    or a double-counted one cannot conserve."""
    mine = records_for(records, trace_id)
    hops = [r for r in mine if r.get("event") == "dispatch"]
    resolves = [r for r in mine if r.get("event") == "resolve"]
    hop_iters = sum(
        r["iters_run"] for r in hops
        if isinstance(r.get("iters_run"), (int, float))
    )
    hop_ms = sum(
        r["latency_ms"] for r in hops
        if isinstance(r.get("latency_ms"), (int, float))
    )
    out = {
        "trace_id": trace_id,
        "n_hops": len(hops),
        "hop_iters": hop_iters,
        "hop_dispatch_ms": hop_ms,
        "resolved": bool(resolves),
        "ok": False,
    }
    if not resolves:
        out["why"] = "no resolve record (request never resolved, or its leaf is missing from the stream)"
        return out
    leaf = resolves[-1]
    out["iters_total"] = leaf.get("iters_total")
    out["dispatch_ms_total"] = leaf.get("dispatch_ms_total")
    iters_ok = leaf.get("iters_total") == hop_iters
    # Wall spans: the resolve leaf accumulated the SAME rounded per-hop
    # latency_ms values the dispatch records carry, in the same order —
    # equality here is exact, not approximate.
    ms_ok = leaf.get("dispatch_ms_total") == hop_ms
    # The v7 phase extension: each hop's phase fields must sum (left to
    # right, PHASE_KEYS order — the exact float addition the batcher
    # performed to DEFINE latency_ms) back to that hop's latency_ms, and
    # the per-phase accumulations across hops must equal the resolve
    # leaf's phase_ms_total bit for bit. Hops stamped with null phases
    # (phase_split off) are exempt — the keys' PRESENCE is the schema's
    # job, conservation only binds measured values.
    phase_ok = True
    phase_why = None
    phase_totals: Dict[str, float] = {}
    any_phases = False
    for r in hops:
        vals = [r.get(k) for k in PHASE_KEYS]
        if not all(isinstance(v, (int, float)) for v in vals):
            continue
        any_phases = True
        s = 0.0
        for k, v in zip(PHASE_KEYS, vals):
            s = s + v
            phase_totals[k] = phase_totals.get(k, 0.0) + v
        if s != r.get("latency_ms"):
            phase_ok = False
            phase_why = (
                f"hop phase split does not conserve: phases sum {s}, "
                f"dispatch record says latency_ms={r.get('latency_ms')}"
            )
            break
    leaf_phases = leaf.get("phase_ms_total")
    if phase_ok and any_phases and isinstance(leaf_phases, dict):
        for k in PHASE_KEYS:
            if leaf_phases.get(k) != phase_totals.get(k, 0.0):
                phase_ok = False
                phase_why = (
                    f"phase {k} does not conserve across hops: hops sum "
                    f"{phase_totals.get(k, 0.0)}, resolve leaf says "
                    f"{leaf_phases.get(k)}"
                )
                break
    if any_phases:
        out["phase_ms_total"] = phase_totals
    out["ok"] = iters_ok and ms_ok and phase_ok
    if not iters_ok:
        out["why"] = (
            f"iters do not conserve: hops sum {hop_iters}, resolve leaf "
            f"says {leaf.get('iters_total')}"
        )
    elif not ms_ok:
        out["why"] = (
            f"wall spans do not conserve: hops sum {hop_ms}, resolve "
            f"leaf says {leaf.get('dispatch_ms_total')}"
        )
    elif not phase_ok:
        out["why"] = phase_why
    return out


def _node_label(node: dict) -> str:
    recs = node["records"]
    if not recs:
        return "(submit)"
    head = recs[0]
    event = head.get("event") or head.get("kind") or "?"
    bits = [str(event)]
    if head.get("engine"):
        bits.append(str(head["engine"]))
    if isinstance(head.get("iters_run"), (int, float)):
        bits.append(f"iters={head['iters_run']}")
    if isinstance(head.get("iters_total"), (int, float)):
        bits.append(f"iters_total={head['iters_total']}")
    if isinstance(head.get("latency_ms"), (int, float)):
        bits.append(f"{head['latency_ms']}ms")
    if len(recs) > 1:
        bits.append(f"+{len(recs) - 1} attached")
    return " ".join(bits)


def render_tree(tree: dict) -> List[str]:
    """Human-readable indented lines for one trace tree."""
    lines = [f"trace {tree['trace_id']}"]

    def walk(node, depth):
        lines.append("  " * depth + "- " + _node_label(node))
        for child in node["children"]:
            walk(child, depth + 1)

    for child in tree["root"]["children"]:
        walk(child, 1)
    return lines


# -- CLI --------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json
    import sys

    from glom_tpu_torch.telemetry import schema

    ap = argparse.ArgumentParser(
        prog="python -m glom_tpu_torch.telemetry trace",
        description="Reconstruct one request's causal tree from stamped "
        "JSONL and verify per-hop executed-work conservation "
        "(docs/OBSERVABILITY.md, Request tracing)",
    )
    ap.add_argument("paths", nargs="+", help="JSONL logs / flight dumps")
    ap.add_argument(
        "--trace-id", default=None,
        help="the trace to reconstruct; omit to list every trace seen",
    )
    args = ap.parse_args(argv)
    records: List[dict] = []
    for path in args.paths:
        with open(path) as fh:
            records.extend(rec for _, rec in schema.iter_json_lines(fh))
    if args.trace_id is None:
        traces = list_traces(records)
        if not traces:
            print("no trace-stamped records found", file=sys.stderr)
            return 1
        for t, info in sorted(traces.items()):
            status = "resolved" if info["resolved"] else "OPEN"
            print(
                f"{t}  {info['n_hops']} hops  {info['n_records']} records"
                f"  {status}"
                + (
                    f"  iters_total={info['iters_total']}"
                    if info["iters_total"] is not None
                    else ""
                )
            )
        return 0
    tree = build_tree(records, args.trace_id)
    if not tree["root"]["children"]:
        print(f"no records for trace {args.trace_id}", file=sys.stderr)
        return 1
    for line in render_tree(tree):
        print(line)
    check = conservation(records, args.trace_id)
    print(json.dumps(schema.stamp(dict(check, summary=True), kind="summary")))
    if not check["ok"]:
        print(
            f"CONSERVATION FAILED: {check.get('why', '?')}", file=sys.stderr
        )
        return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
