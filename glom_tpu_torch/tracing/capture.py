"""Programmatic profiler capture: step-windowed torch.profiler traces.

Counterpart of `glom_tpu/tracing/capture.py` on `torch.profiler`.
`--profile-dir` (train/cli.py) wraps a WHOLE run in one trace (`trace`),
unusable past a few hundred steps. `TraceCapture` is the step-windowed
form: `--trace-steps A:B` starts a `torch.profiler.profile` session (CPU
activity, and CUDA activity when a card is present) right before step A,
stops it after step B and exports it as a Chrome trace into the trace
directory; the window's metadata (trace dir, first / last step) rides the
telemetry stream as stamped "note" records, glom_tpu's, and each captured
step runs under `record_function("step#i")`, so the trace's step markers
line up with the trainer's step numbers.

The step counter lives on the TraceCapture itself, so a window can span
checkpoint-span boundaries (the CLI calls fit() once per span over one
shared capture). The profiler is looked up at each start, so tests can
monkeypatch `torch.profiler.profile`. One profiler session runs at a time
(kineto's rule, as jax's), which is why `--profile-dir` and
`--trace-steps` exclude each other.

View a capture in chrome://tracing or Perfetto (ui.perfetto.dev).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Tuple

import torch


def parse_trace_steps(spec: str) -> Tuple[int, int]:
    """'A:B' -> (first, last) inclusive; a bare 'A' captures one step."""
    parts = spec.split(":")
    try:
        if len(parts) == 1:
            first = last = int(parts[0])
        elif len(parts) == 2:
            first, last = int(parts[0]), int(parts[1])
        else:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"--trace-steps {spec!r}: expected 'A:B' (or a bare step 'A')"
        ) from None
    if first < 0 or last < first:
        raise ValueError(f"--trace-steps {spec!r}: need 0 <= first <= last")
    return first, last


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def trace_path(trace_dir: str, tag: str) -> str:
    """Where a session's Chrome trace goes: `trace_dir`, one file a
    session (the process id and the start time keep ranks and runs
    apart)."""
    return os.path.join(trace_dir, f"glom_{tag}_{os.getpid()}_{time.time_ns()}.pt.trace.json")


class TraceCapture:
    """A [first, last]-inclusive step window around a torch.profiler
    session.

    Wrap each training step (or bench unit) in `unit()`; the capture starts
    the profiler when its counter reaches `first` and stops it after
    `last`. `writer` (anything with .write(dict)) receives the stamped
    start / stop "note" records; without one they go to the flight
    recorder. `path` is the exported trace once the window closed.

    Each step ends in a device synchronize (fit_loop's), so the window
    holds its steps' kernels whole.
    """

    def __init__(self, first: int, last: int, trace_dir: str, *, writer=None):
        if first < 0 or last < first:
            raise ValueError(f"need 0 <= first <= last, got {first}:{last}")
        self.first = first
        self.last = last
        self.trace_dir = trace_dir
        self.writer = writer
        self.path = None
        self._prof = None
        self._count = 0  # units seen (monotonic across fit() spans)
        self._active = False
        self._captured = 0
        self._closed = False

    @classmethod
    def parse(cls, spec: str, trace_dir: str, *, writer=None) -> "TraceCapture":
        first, last = parse_trace_steps(spec)
        return cls(first, last, trace_dir, writer=writer)

    def _emit(self, rec: dict) -> None:
        from glom_tpu_torch.telemetry import schema
        from glom_tpu_torch.tracing.flight import write_or_observe

        write_or_observe(self.writer, schema.stamp(rec, kind="note"))

    def _start(self) -> None:
        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.start()
        self._active = True
        self._emit({
            "note": "xla-trace-start",
            "trace_dir": self.trace_dir,
            "first_step": self._count,
            "trace_steps": f"{self.first}:{self.last}",
        })

    def _stop(self, *, reason: str = "window-complete") -> None:
        try:
            self._prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            path = trace_path(self.trace_dir, f"steps{self.first}-{self.last}")
            self._prof.export_chrome_trace(path)
            self.path = path
        finally:
            self._active = False
            self._prof = None
        self._emit({
            "note": "xla-trace-stop",
            "trace_dir": self.trace_dir,
            "last_step": self._count - 1 if self._captured else None,
            "steps_captured": self._captured,
            "reason": reason,
        })

    @contextlib.contextmanager
    def unit(self):
        """Wrap ONE step / measurement unit; yields the unit's index."""
        i = self._count
        if not self._closed and not self._active and i == self.first:
            self._start()
        ctx = (torch.profiler.record_function(f"step#{i}") if self._active
               else contextlib.nullcontext())
        try:
            with ctx:
                yield i
        finally:
            self._count += 1
            if self._active:
                self._captured += 1
                if i >= self.last:
                    self._stop()

    def close(self) -> None:
        """Idempotent teardown: stops a window still open (a run that ended
        before step B must not leak a profiler session) and stamps the
        truncation."""
        if self._closed:
            return
        self._closed = True
        if self._active:
            self._stop(reason="truncated-by-close")


# -- whole-block capture ------------------------------------------------------------


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block into one Chrome trace under `log_dir`
    (yields the directory; the file is written when the block ends)."""
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(trace_path(log_dir, "run"))


def start_server(port: int = 9999):
    """glom_tpu attaches TensorBoard's profile tab to a live job through
    `jax.profiler.start_server`; torch.profiler has no on-demand server."""
    raise NotImplementedError(
        "start_server has no torch counterpart: torch.profiler has no on-demand "
        "profiling server; capture a step window with TraceCapture (--trace-steps) "
        "or a whole block with trace() (--profile-dir)"
    )


def annotate(name: str):
    """Decorator: each call of the function runs under
    `record_function(name)` and an NVTX range, so a profiler trace shows
    host phases (data loading, eval) by name."""

    def deco(fn):
        import functools

        from glom_tpu_torch.tracing.nvtx import nvtx_range

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name), nvtx_range(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
