"""Step-time histograms with the first call of each step variant split out.

The port's copy of `nearest_rank` and `StepTimeStats` from
`glom_tpu/telemetry/sinks.py`. The first call of each step variant builds
kernels and warms the allocator; folding it into steady-state percentiles
would make a slow-step report unreadable, so it is accounted as
`compile_time_s` and the percentiles hold only steady-state steps. The
port's steps end in a device synchronise, so every sample is the step's
device time plus its host time.
"""

from __future__ import annotations

from typing import List, Optional


def nearest_rank(sorted_samples: List[float], q: float) -> float:
    """Nearest-rank quantile over pre-sorted samples (0.0 when empty)."""
    if not sorted_samples:
        return 0.0
    idx = min(len(sorted_samples) - 1, int(q * (len(sorted_samples) - 1) + 0.5))
    return sorted_samples[idx]


class StepTimeStats:
    """Streaming per-step wall-time stats with the warm-up calls split out.

    observe(dt, is_compile=None): is_compile=None treats the FIRST
    observation as the warm-up; fit_loop passes it per step variant.
    compile_time_s accumulates; the samples hold only steady-state steps."""

    def __init__(self, max_samples: int = 4096):
        self.compile_time_s: Optional[float] = None
        self._samples: List[float] = []
        self._max = max_samples
        self._count = 0
        self._running_max = 0.0

    def observe(self, dt_s: float, is_compile: Optional[bool] = None) -> None:
        if is_compile is None:
            is_compile = self.compile_time_s is None
        if is_compile:
            self.compile_time_s = (self.compile_time_s or 0.0) + dt_s
            return
        self._count += 1
        self._running_max = max(self._running_max, dt_s)
        if len(self._samples) < self._max:
            self._samples.append(dt_s)
        else:
            # Keep every other sample once full: the percentiles stay
            # representative and memory stays bounded.
            self._samples = self._samples[::2]
            self._max = max(self._max, 2 * len(self._samples))
            self._samples.append(dt_s)

    def summary(self) -> dict:
        """The stamped histogram fields (milliseconds; warm-up in s)."""
        s = sorted(self._samples)
        return {
            "compile_time_s": round(self.compile_time_s or 0.0, 4),
            "step_time_p50_ms": round(1e3 * nearest_rank(s, 0.50), 3),
            "step_time_p95_ms": round(1e3 * nearest_rank(s, 0.95), 3),
            "step_time_p99_ms": round(1e3 * nearest_rank(s, 0.99), 3),
            "step_time_max_ms": round(1e3 * self._running_max, 3),
            "steps_timed": self._count,
        }
