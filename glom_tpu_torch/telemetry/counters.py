"""Measured collective counters: the counting half of glom_tpu's
`telemetry/counters.py`.

`utils/metrics.comm_volume_model` PRICES the gradient/update wire schedule
from top-level aggregates (G, P, dp, stage). This module MEASURES it: the
named collective sites in `parallel/manual.py` (the seq all-reduce, the
ZeRO reduce-scatter / mean fallback, the param all-gather, the TP FFW
all-reduce, levels TP's group all-gather in both directions) report their
per-replica ring wire bytes from the actual tensors at each call, so
aggregation decisions the model cannot see show up as measured-vs-modeled
drift (`comm_model_drift`). The serve mesh's sites (`parallel/serve_mesh.py`: the quorum and witness all-reduces, the
page gathers) are counted over a signature's first dispatch onto the
engine's stats record; its `iters="auto"` loop runs in Python, so its
sites are priced once before the loop under `scaled(T)`, the budget, and
the loop's executions run `paused`: glom_tpu's while-loop convention.

glom_tpu records over one abstract trace of the step. The port counts the
calls of one real step inside a `recording(...)` context (the distributed
trainer's first step) and stamps those totals from then on: collective
shapes do not change between steps. Counters record only inside that
context, so every other step costs nothing.

Wire formulas (ring algorithms, matching comm_volume_model's pricing):
  all-reduce        2*(k-1)/k * B      B = local payload bytes
  reduce-scatter    (k-1)/k   * B
  mean fallback     2*(k-1)/k * B      (replicated leaf: full all-reduce)
  all-gather        (k-1)     * B_sh   B_sh = per-shard bytes
Quantized-reduce arms price the reduce payload at the int8 + scales wire
size (`quantized_wire_bytes`); the gather stays f32.

Not ported (ROADMAP queue A item 9): the per-collective wall-time half
(`resolve_collective_timing` modes other than "off", `comm_time.py`'s
sampler and the full-mode brackets). `timed_collective` here only counts.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import List

TIMING_MODES = ("off", "sampled", "full")


class CollectiveCounters:
    """Accumulated per-replica per-step wire bytes by collective kind, and
    one entry per named site: {site, axis, collective, wire_bytes (per
    call), calls, shape, dtype, dim}."""

    def __init__(self):
        self.reduce_bytes = 0  # all-reduce + reduce-scatter + mean (gradient path)
        self.gather_bytes = 0  # all-gather (param path)
        self.n_reduce = 0
        self.n_gather = 0
        self.sites: List[dict] = []

    def record(self, kind: str, wire_bytes: int) -> None:
        if kind == "gather":
            self.gather_bytes += int(wire_bytes)
            self.n_gather += 1
        else:
            self.reduce_bytes += int(wire_bytes)
            self.n_reduce += 1

    def record_site(self, *, site: str, axis: str, collective: str, wire_bytes: int,
                    calls: int, shape, dtype, dim: int) -> None:
        """One named-site call (the same (site, shape) again accumulates
        calls rather than duplicating)."""
        for s in self.sites:
            if s["site"] == site and s["shape"] == tuple(shape):
                s["calls"] += calls
                return
        self.sites.append({
            "site": site, "axis": axis, "collective": collective,
            "wire_bytes": int(wire_bytes), "calls": int(calls),
            "shape": tuple(int(d) for d in shape), "dtype": str(dtype), "dim": int(dim),
        })

    def totals(self) -> dict:
        """The stamped record fields (measured counterpart of
        comm_volume_model's comm_*_bytes_per_step keys)."""
        return {
            "comm_measured_reduce_bytes_per_step": self.reduce_bytes,
            "comm_measured_gather_bytes_per_step": self.gather_bytes,
            "comm_measured_bytes_per_step": self.reduce_bytes + self.gather_bytes,
            "comm_measured_collective_count": self.n_reduce + self.n_gather,
        }


_local = threading.local()


def _stack() -> List[CollectiveCounters]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


@contextmanager
def recording(counters: CollectiveCounters):
    """Activate `counters` for collectives called on THIS thread."""
    _stack().append(counters)
    try:
        yield counters
    finally:
        _stack().pop()


def active() -> List[CollectiveCounters]:
    """The counters recording on this thread (a copy of the stack): what a
    differentiable collective keeps at its forward for its backward."""
    return list(_stack())


@contextmanager
def recording_all(stack: List[CollectiveCounters]):
    """Activate every counter of `stack` on this thread that is not active
    already (the backward of a collective whose forward ran under them:
    autograd may run it on its own thread, or on this one)."""
    mine = _stack()
    extra = [c for c in stack if not any(c is m for m in mine)]
    mine.extend(extra)
    try:
        yield
    finally:
        del mine[len(mine) - len(extra):]


def _scale() -> int:
    return getattr(_local, "scale", 1)


@contextmanager
def scaled(k: int):
    """Multiply recorded bytes and calls by `k` inside this context
    (glom_tpu's seam for a site that traces once and runs k times: the
    ZeRO stage-2 microbatch loop records its first microbatch's sites
    scaled by the microbatch count and its later ones `paused`, so the
    collective count is glom_tpu's count of sites)."""
    prev = _scale()
    _local.scale = prev * int(k)
    try:
        yield
    finally:
        _local.scale = prev


@contextmanager
def paused():
    """Record nothing on this thread inside this context (a site's later
    executions, once `scaled` has priced them at the first)."""
    saved = _stack()[:]
    _stack().clear()
    try:
        yield
    finally:
        _stack().extend(saved)


def record_collective(kind: str, wire_bytes: int) -> None:
    """No-op unless a recording() context is active."""
    scale = _scale()
    for c in _stack():
        c.record(kind, wire_bytes * scale)


def resolve_collective_timing(mode: str, **_) -> str:
    """Validate the collective-timing mode: only "off" runs here."""
    if mode not in TIMING_MODES:
        raise ValueError(f"collective_timing={mode!r}: one of {TIMING_MODES}")
    if mode != "off":
        raise NotImplementedError(
            f"collective_timing={mode!r} is not ported yet: ROADMAP queue A item 9"
        )
    return mode


def timed_collective(site: str, axis_name: str, kind: str, wire_bytes: int, fn, x, *,
                     collective: str, dim: int = 0):
    """Run `fn(x)` and record its wire bytes and the site under the active
    recording (glom_tpu's wrapper, without its timing modes)."""
    record_collective(kind, wire_bytes)
    scale = _scale()
    for c in _stack():
        c.record_site(site=site, axis=axis_name, collective=collective,
                      wire_bytes=wire_bytes, calls=scale, shape=tuple(x.shape),
                      dtype=x.dtype, dim=dim)
    return fn(x)


def _nbytes(x) -> int:
    return x.nelement() * x.element_size()


def ring_allreduce_bytes(x, k: int) -> int:
    return int(2 * (k - 1) / k * _nbytes(x)) if k > 1 else 0


def ring_reduce_scatter_bytes(x, k: int, *, quantized: bool = False) -> int:
    if k <= 1:
        return 0
    nbytes = _nbytes(x)
    if quantized:
        from glom_tpu_torch.parallel.quantized import quantized_wire_bytes

        # f32 elements -> int8 payload + per-block scales.
        nbytes = quantized_wire_bytes(nbytes // 4)
    return int((k - 1) / k * nbytes)


def ring_all_gather_bytes(x_shard, k: int) -> int:
    return int((k - 1) * _nbytes(x_shard)) if k > 1 else 0


def comm_drift(measured: dict, modeled: dict) -> dict:
    """Relative drift of measured vs modeled per-step wire bytes, a
    stamped metric ((measured - modeled) / modeled; 1e9 for bytes the
    model says are 0)."""
    meas = measured.get("comm_measured_bytes_per_step", 0)
    model = modeled.get("comm_bytes_per_step", 0)
    if model <= 0:
        drift = 0.0 if meas == 0 else float("inf")
    else:
        drift = (meas - model) / model
    return {"comm_model_drift": round(drift, 6) if drift != float("inf") else 1e9}
