"""schema-emit: every stamped record speaks the registered schema.

The telemetry contract (telemetry/schema.py) is only as strong as its
call sites: a sink that stamps a kind the registry doesn't know produces
rows the linter rejects AFTER the run already happened — this checker
rejects them at review time. Rules, over calls to the stamping/emitting
family (sinks.emit, schema.stamp, serve.events.emit_serve/stamp_serve,
the private _emit helpers, and MetricsWriter-style .write with a literal
record):

  * a literal `kind` must exist in schema.KINDS (loaded from the real
    registry — import first, AST fallback over the scanned tree so the
    pass also works where the package isn't importable);
  * the UNMEASURED discipline: a record literal carrying an `error` key
    must carry `value: None` — NEVER 0 / 0.0 (a dead zero reads as a
    measurement in every trajectory that ingests it);
  * `kind="error"` with a record literal requires the `error` field the
    schema demands.

Non-literal kinds and records built away from the call site are skipped,
not guessed at — the runtime linter still owns those.
"""

from __future__ import annotations

import ast
from functools import lru_cache
from typing import List, Optional, Set

from glom_tpu_torch.analysis.astutil import call_name, qualname_at
from glom_tpu_torch.analysis.core import Checker, Context, Finding, SourceModule

# emit-family leaf name -> positional index of the `kind` argument
KIND_POSITION = {
    "emit": 1,
    "stamp": 1,
    "_emit": 1,
    "stamp_serve": 1,
    "emit_serve": 2,
}
# leaf name -> positional index of the record-dict argument
RECORD_POSITION = {
    "emit": 0,
    "stamp": 0,
    "_emit": 0,
    "stamp_serve": 0,
    "emit_serve": 1,
    "write": 0,
}

# Frozen fallback if neither the import nor the AST scan can find the
# registry (running the pass over a partial checkout): the v4 kinds.
_FALLBACK_KINDS = {
    "train_step", "bench", "watchdog", "anomaly", "summary", "note",
    "span", "error", "serve", "fault", "recovery",
}

# Serve events that are REQUEST-scoped and must stamp trace context on
# every v6 record (the schema registry owns the real list; this frozen
# fallback mirrors it for partial checkouts).
_FALLBACK_TRACE_EVENTS = (
    "dispatch", "continuation", "shed", "resolve", "engine_failover",
    "dispatch_error", "response",
)
_TRACE_KEYS = ("trace_id", "trace_ids")

# Serve events that are TENANT-scoped and must stamp the SLO class on
# every v11 record (null = classless is fine, absent is not — the same
# presence discipline as the trace keys).
_FALLBACK_CLASS_EVENTS = ("admit", "shed", "settle", "resolve")
_CLASS_KEY = "slo_class"


@lru_cache(maxsize=1)
def _load_trace_events() -> tuple:
    try:
        from glom_tpu_torch.telemetry.schema import TRACE_REQUIRED_EVENTS

        return tuple(TRACE_REQUIRED_EVENTS)
    except Exception:
        return _FALLBACK_TRACE_EVENTS


@lru_cache(maxsize=1)
def _load_class_events() -> tuple:
    try:
        from glom_tpu_torch.telemetry.schema import CLASS_REQUIRED_EVENTS

        return tuple(CLASS_REQUIRED_EVENTS)
    except Exception:
        return _FALLBACK_CLASS_EVENTS


def _load_kinds(ctx: Context) -> Set[str]:
    if ctx.kinds is not None:
        return ctx.kinds
    kinds: Optional[Set[str]] = None
    try:
        from glom_tpu_torch.telemetry.schema import KINDS

        kinds = set(KINDS)
    except Exception:
        kinds = None
    if kinds is None:
        for mod in ctx.modules:
            if not mod.relpath.endswith("telemetry/schema.py"):
                continue
            for node in mod.tree.body:
                if (
                    isinstance(node, ast.Assign)
                    and any(
                        isinstance(t, ast.Name) and t.id == "KINDS"
                        for t in node.targets
                    )
                    and isinstance(node.value, ast.Dict)
                ):
                    kinds = {
                        k.value
                        for k in node.value.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)
                    }
    ctx.kinds = kinds if kinds else set(_FALLBACK_KINDS)
    return ctx.kinds


class SchemaEmit(Checker):
    name = "schema-emit"
    description = (
        "emit/stamp sites use registered kinds; UNMEASURED is null, not 0.0"
    )

    def check(self, module: SourceModule, ctx: Context) -> List[Finding]:
        kinds = _load_kinds(ctx)
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node) or ""
            leaf = name.split(".")[-1]
            if leaf not in RECORD_POSITION:
                continue
            symbol = qualname_at(module.parents, module.index, node)
            kind = self._kind_of(node, leaf)
            record = self._record_of(node, leaf)
            if leaf == "write" and (
                record is None or not self._has_key(record, "kind")
            ):
                # .write() matches broadly (files, sockets); only literal
                # records that stamp their own kind are in scope.
                continue

            def add(anchor, message, key):
                findings.append(
                    Finding(
                        checker=self.name,
                        path=module.relpath,
                        line=anchor.lineno,
                        col=anchor.col_offset,
                        message=message,
                        symbol=symbol,
                        key=key,
                    )
                )

            kind_value = None
            if kind is not None:
                kind_value = (
                    kind.value
                    if isinstance(kind, ast.Constant)
                    and isinstance(kind.value, str)
                    else None
                )
                if kind_value is not None and kind_value not in kinds:
                    add(
                        kind,
                        f"kind {kind_value!r} is not in the schema registry "
                        f"{sorted(kinds)} — the runtime linter will reject "
                        "every record this site writes",
                        "unknown-kind",
                    )
            if record is not None:
                # records may stamp kind inside the literal
                if kind_value is None:
                    inline = self._value_of(record, "kind")
                    if (
                        isinstance(inline, ast.Constant)
                        and isinstance(inline.value, str)
                    ):
                        kind_value = inline.value
                        if kind_value not in kinds:
                            add(
                                inline,
                                f"kind {kind_value!r} is not in the schema "
                                f"registry {sorted(kinds)}",
                                "unknown-kind",
                            )
                ev = self._value_of(record, "event")
                if (
                    kind_value in (None, "serve")
                    and isinstance(ev, ast.Constant)
                    and ev.value in _load_trace_events()
                    and not any(k is None for k in record.keys)  # **splat
                    and not any(
                        self._has_key(record, k) for k in _TRACE_KEYS
                    )
                ):
                    # The schema-v6 request-tracing contract, enforced at
                    # the emit site: a request-scoped serve event literal
                    # that stamps neither trace key (nor merges one in via
                    # a **splat) writes records that can never join their
                    # request's causal tree — the runtime linter will
                    # reject every one of them.
                    add(
                        ev,
                        f"serve event {ev.value!r} record stamps no trace "
                        f"context ({'/'.join(_TRACE_KEYS)}) — schema v6 "
                        "requires request-scoped serve records to carry "
                        "it (telemetry/tracectx.py; null = explicitly "
                        "untraced is fine, absent is not)",
                        "trace-context",
                    )
                if (
                    kind_value in (None, "serve")
                    and isinstance(ev, ast.Constant)
                    and ev.value in _load_class_events()
                    and not any(k is None for k in record.keys)  # **splat
                    and not self._has_key(record, _CLASS_KEY)
                ):
                    # The schema-v11 QoS contract, same discipline as the
                    # trace keys: a tenant-scoped serve event literal that
                    # stamps no slo_class (nor merges one via **splat)
                    # writes records no per-class rollup, weighted-regret
                    # audit, or class-scoped SLO rule can ever attribute.
                    add(
                        ev,
                        f"serve event {ev.value!r} record stamps no "
                        f"{_CLASS_KEY} — schema v11 requires tenant-scoped "
                        "serve records to carry it (serve/qos.py; null = "
                        "classless is fine, absent is not)",
                        "class-context",
                    )
                if self._has_key(record, "error"):
                    value = self._value_of(record, "value")
                    if (
                        isinstance(value, ast.Constant)
                        and isinstance(value.value, (int, float))
                        and not isinstance(value.value, bool)
                    ):
                        add(
                            value,
                            "UNMEASURED record (carries 'error') stamps "
                            f"value {value.value!r} — must be None: dead "
                            "zeros poison the bench trajectory and the "
                            "compare gate",
                            "unmeasured-zero",
                        )
                elif kind_value == "error":
                    add(
                        record,
                        "kind='error' record literal has no 'error' field "
                        "— the schema requires the machine-readable cause",
                        "error-missing-field",
                    )
        return findings

    @staticmethod
    def _kind_of(call: ast.Call, leaf: str) -> Optional[ast.AST]:
        for kw in call.keywords:
            if kw.arg == "kind":
                return kw.value
        idx = KIND_POSITION.get(leaf)
        if idx is not None and len(call.args) > idx:
            return call.args[idx]
        return None

    @staticmethod
    def _record_of(call: ast.Call, leaf: str) -> Optional[ast.Dict]:
        idx = RECORD_POSITION[leaf]
        node = call.args[idx] if len(call.args) > idx else None
        for kw in call.keywords:
            if kw.arg in ("rec", "record", "metrics"):
                node = kw.value
        return node if isinstance(node, ast.Dict) else None

    @staticmethod
    def _has_key(d: ast.Dict, key: str) -> bool:
        return any(
            isinstance(k, ast.Constant) and k.value == key for k in d.keys
        )

    @staticmethod
    def _value_of(d: ast.Dict, key: str) -> Optional[ast.AST]:
        for k, v in zip(d.keys, d.values):
            if isinstance(k, ast.Constant) and k.value == key:
                return v
        return None
