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

The per-collective wall-time half: `resolve_collective_timing` resolves
the mode once per path ("off", "sampled", "full"); "sampled" runs
`telemetry/comm_time.CollectiveTimeSampler` outside the step; under
`timing("full", log)` every execution of a registered site is bracketed
and lands in a `CollectiveTimeLog`. glom_tpu brackets with io_callbacks
inside its traced program; the port brackets the eager call itself. On a
CUDA tensor the bracket is a pair of CUDA events on the current stream,
resolved when the log is drained: a host clock around an NCCL call would
measure only its enqueue, and gloo's CUDA path returns before its copy
back lands (the current stream waits for it). On a CPU tensor a gloo
call is synchronous and the bracket is a host clock. Neither touches a
byte of the collective's output.
"""

from __future__ import annotations

import threading
import time
import warnings
from contextlib import contextmanager
from typing import List, Optional

import torch

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


def resolve_collective_timing(mode: str, *, supports_full: bool = True, path: str = "") -> str:
    """The single resolution source for the collective-timing mode:
    validates it and degrades "full" to "sampled", with glom_tpu's
    warning, where the path does not bracket each execution (the trainers:
    the stamped mode is always the resolved one)."""
    if mode not in TIMING_MODES:
        raise ValueError(f"collective_timing={mode!r}: one of {TIMING_MODES}")
    if mode == "full" and not supports_full:
        warnings.warn(
            f"collective_timing='full' is unavailable on {path or 'this'} "
            "path (no AOT trace seam to insert the io_callback brackets); "
            "running 'sampled' — the stamped mode is the resolved one",
            stacklevel=3,
        )
        return "sampled"
    return mode


def _elapsed_s(dt) -> float:
    """A logged duration in seconds: a float, or a (start, end) pair of
    CUDA events (synchronized on the end)."""
    if isinstance(dt, tuple):
        start, end = dt
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return float(dt)


def aggregate_events(events: List[tuple]) -> List[dict]:
    """One dict per (site, axis, wire bytes) with the mean / max wall_ms
    over the executions of `events` ((site, axis, collective, bytes,
    seconds) tuples): glom_tpu's CollectiveTimeLog.drain."""
    agg: dict = {}
    for site, axis, collective, nbytes, dt in events:
        slot = agg.setdefault(
            (site, axis, nbytes),
            {"site": site, "axis": axis, "collective": collective,
             "wire_bytes": nbytes, "calls": 0, "_sum": 0.0, "_max": 0.0},
        )
        slot["calls"] += 1
        slot["_sum"] += dt
        slot["_max"] = max(slot["_max"], dt)
    out = []
    for slot in agg.values():
        calls = slot.pop("calls")
        total = slot.pop("_sum")
        mx = slot.pop("_max")
        out.append(dict(slot, calls=calls,
                        wall_ms=round(1e3 * total / calls, 6) if calls else 0.0,
                        wall_ms_max=round(1e3 * mx, 6), mode="full"))
    return sorted(out, key=lambda r: r["site"])


class CollectiveTimeLog:
    """The sink of the full-mode brackets: thread-safe (engine threads
    dispatch concurrently) and bounded (a long-running server must not grow
    one entry per collective execution forever: drain() aggregates and
    resets)."""

    def __init__(self, max_events: int = 100_000):
        self._events: List[tuple] = []
        self._lock = threading.Lock()
        self._max = max_events
        self.base = time.perf_counter()

    def add(self, site: str, axis: str, collective: str, wire_bytes: int, dt_s) -> None:
        """One execution: `dt_s` in seconds, or a (start, end) pair of CUDA
        events that `take` resolves."""
        with self._lock:
            if len(self._events) < self._max:
                self._events.append((site, axis, collective, int(wire_bytes),
                                     dt_s if isinstance(dt_s, tuple) else float(dt_s)))

    def take(self) -> List[tuple]:
        """The executions logged so far, each duration in seconds, and
        reset (the raw events a sharded engine gathers from its ranks)."""
        with self._lock:
            events, self._events = self._events, []
        return [(s, a, c, b, _elapsed_s(dt)) for s, a, c, b, dt in events]

    def drain(self) -> List[dict]:
        """Aggregate and reset: one dict per (site, axis) with the mean /
        max wall_ms over the drained executions."""
        return aggregate_events(self.take())


def _timing_state():
    return getattr(_local, "timing", None)


@contextmanager
def timing(mode: str, log: Optional[CollectiveTimeLog]):
    """Activate a collective-timing mode for collectives called on this
    thread: under "full" every timed_collective brackets its call into
    `log`; "sampled" and "off" bracket nothing (the sampler runs outside
    the step)."""
    prev = _timing_state()
    _local.timing = (mode, log)
    try:
        yield
    finally:
        _local.timing = prev


def timed_collective(site: str, axis_name: str, kind: str, wire_bytes: int, fn, x, *,
                     collective: str, dim: int = 0):
    """Run `fn(x)`, recording its wire bytes and the site under the active
    recording (glom_tpu's wrapper). Under timing("full", log) the call is
    bracketed: CUDA events on the current stream for a CUDA tensor, a host
    clock for a CPU one. A priced site (a meta tensor: nothing moves) is
    not bracketed."""
    record_collective(kind, wire_bytes)
    scale = _scale()
    for c in _stack():
        c.record_site(site=site, axis=axis_name, collective=collective,
                      wire_bytes=wire_bytes, calls=scale, shape=tuple(x.shape),
                      dtype=x.dtype, dim=dim)
    state = _timing_state()
    if not state or state[0] != "full" or state[1] is None or x.device.type == "meta":
        return fn(x)
    log = state[1]
    if x.is_cuda:
        stream = torch.cuda.current_stream(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = fn(x)
        end.record(stream)
        log.add(site, axis_name, collective, wire_bytes, (start, end))
        return out
    t0 = time.perf_counter()
    out = fn(x)
    log.add(site, axis_name, collective, wire_bytes, time.perf_counter() - t0)
    return out


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
