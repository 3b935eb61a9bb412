"""Host-side software spans: where the wall time went.

The port's copy of `glom_tpu/tracing/spans.py`. A `span()` context manager
times a named block with `time.perf_counter`, tracks nesting on a
thread-local stack, and emits versioned "span" JSONL events into the same
stream every other telemetry record rides.

Naming: the update step's phases are PHASES (bottom_up / top_down /
consensus / mean_update); host phases the fit loop times are prefixed
`host_` (host_data_next, host_step_dispatch, host_log_fetch).
`span(..., annotate=True)` also opens `torch.profiler.record_function`, so
a running `torch.profiler` trace shows the block under the same name.

Cost: a bare span (aggregator only, no writer) is two perf_counter calls
plus dict arithmetic. The fit loop therefore aggregates per name between
logging steps (SpanAggregator) and emits one rollup span event per phase
per logging record instead of two JSONL lines per step.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional

# The update step's phase vocabulary (models/core.py:update_step): span
# names for its phases come from here, as glom_tpu's do.
PHASES = ("bottom_up", "top_down", "consensus", "mean_update")

_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def current_span() -> Optional[str]:
    """Name of the innermost open span on this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


class SpanAggregator:
    """Per-name rollup of closed spans (count / total / max), drained into
    stamped "span" records at each logging boundary — the <1%-overhead form
    of per-step span events. Thread-safe: the prefetch thread's spans can
    land in the same aggregator as the fit loop's."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict = {}  # name -> [count, total_s, max_s]

    def observe(self, name: str, dur_s: float) -> None:
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                self._stats[name] = [1, dur_s, dur_s]
            else:
                st[0] += 1
                st[1] += dur_s
                if dur_s > st[2]:
                    st[2] = dur_s

    def records(self, *, reset: bool = True, extra: Optional[dict] = None):
        """One stamped span record per name seen since the last drain:
        dur_s is the TOTAL seconds in that phase (the attribution number);
        count/mean_ms/max_ms unpack it."""
        from glom_tpu_torch.telemetry import schema

        with self._lock:
            stats = self._stats
            if reset:
                self._stats = {}
            else:
                stats = dict(stats)
        out = []
        for name in sorted(stats):
            count, total, mx = stats[name]
            rec = {
                "name": name,
                "dur_s": round(total, 6),
                "count": count,
                "mean_ms": round(1e3 * total / count, 4),
                "max_ms": round(1e3 * mx, 4),
            }
            if extra:
                rec.update(extra)
            out.append(schema.stamp(rec, kind="span"))
        return out


@contextmanager
def span(
    name: str,
    *,
    writer=None,
    aggregator: Optional[SpanAggregator] = None,
    annotate: bool = False,
    **fields,
):
    """Time the enclosed block as a named span.

    `writer` (anything with .write(dict), e.g. MetricsWriter) receives one
    stamped "span" event per close — start wall time, duration, nesting
    depth, and the enclosing span's name. `aggregator` rolls the duration
    into a SpanAggregator instead (the cheap fit-loop form; both may be
    given). `annotate=True` additionally opens
    torch.profiler.record_function(name), so a running profiler trace
    shows the block under the same name. Extra keyword `fields` ride the
    emitted event."""
    ann = None
    if annotate:
        import torch

        ann = torch.profiler.record_function(name)
        ann.__enter__()
    stack = _stack()
    parent = stack[-1] if stack else None
    stack.append(name)
    t_wall = time.time()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        if ann is not None:
            ann.__exit__(None, None, None)
        stack.pop()
        if aggregator is not None:
            aggregator.observe(name, dur)
        if writer is not None:
            from glom_tpu_torch.telemetry import schema, tracectx

            rec = {
                "name": name,
                "dur_s": round(dur, 6),
                "t_start": round(t_wall, 3),
                "depth": len(stack),
            }
            if parent is not None:
                rec["parent"] = parent
            rec.update(fields)
            # A span closed under a serve dispatch scope carries that
            # dispatch's trace context — host time joins the request's
            # causal tree like every other stamped record.
            if not any(k in rec for k in ("trace_id", "trace_ids")):
                rec.update(tracectx.current_fields())
            writer.write(schema.stamp(rec, kind="span"))


def spanned(name: str, **span_kw):
    """Decorator form: time every call of `fn` as a span."""

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name, **span_kw):
                return fn(*args, **kwargs)

        return wrapper

    return deco
