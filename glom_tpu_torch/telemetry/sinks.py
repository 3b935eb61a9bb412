"""Step-time histograms with the first call of each step variant split out.

The port's copy of `nearest_rank` and `StepTimeStats` from
`glom_tpu/telemetry/sinks.py`. The first call of each step variant builds
kernels and warms the allocator; folding it into steady-state percentiles
would make a slow-step report unreadable, so it is accounted as
`compile_time_s` and the percentiles hold only steady-state steps. The
port's steps end in a device synchronise, so every sample is the step's
device time plus its host time.

`emit` and `bench_bootstrap` are the port's copies of the stamped bench
emitter and its fail-fast backend gate:

  * emit() stamps schema_version/kind and the current watchdog backend
    state on a record, feeds the flight recorder and prints one JSON line,
    so bench rows, trainer JSONL and the compare gate's inputs share one
    schema (`python -m glom_tpu_torch.telemetry FILE` lints them);
  * bench_bootstrap() probes the device through a watchdog (a throwaway
    subprocess: a wedged driver hangs the child, never the bench),
    registers it globally so every later record stamps backend_state, and
    when the probe is down emits ONE "error" record with `value: null` and
    returns False. Unlike glom_tpu's, it never switches to another
    platform: a bench that asked for the card and measured the CPU would
    report a number under the card's name.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from glom_tpu_torch.telemetry import schema


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


def emit(rec: dict, kind: str = "bench", stream=None) -> dict:
    """Stamp (schema_version, kind, watchdog backend state) and print one
    JSON line to `stream` (stdout by default). Returns the stamped record.
    Keys already present win: a bench that carries its own backend state
    or timeline is not overwritten."""
    from glom_tpu_torch.telemetry import watchdog  # torch: deferred past the stdlib readers

    stamped = schema.stamp(rec, kind=kind)
    for k, v in watchdog.backend_record().items():
        stamped.setdefault(k, v)
    from glom_tpu_torch.tracing.flight import observe_event

    observe_event(stamped)
    print(json.dumps(stamped), file=stream or sys.stdout, flush=True)
    return stamped


def bench_bootstrap(
    metric: str,
    unit: str = "column-iters/s/chip",
    *,
    probe_timeout: float = 120.0,
    device_type: str = "cuda",
    stream=None,
) -> bool:
    """Fail-fast backend gate for bench entry points. Registers a
    `BackendWatchdog` over `device_type` globally and probes once. Returns
    True when the device answered. When it did not, emits the UNMEASURED
    record (kind "error", `value: null`, never 0.0, with the bare `metric`
    label the measured rows carry and the watchdog's timeline; `python -m
    glom_tpu_torch.telemetry compare` reads it as missing) to `stream` and
    returns False. It takes no other device: the caller decides what a
    missing card means. The watchdog stays registered either way, so every
    line the bench then emits carries the backend state."""
    from glom_tpu_torch.telemetry.watchdog import BackendWatchdog, set_global_watchdog

    wd = BackendWatchdog(probe_timeout=probe_timeout, device_type=device_type)
    set_global_watchdog(wd)
    if wd.probe_once() != "down":
        return True
    emit(
        {
            "metric": metric,
            "value": None,
            "unit": unit,
            "error": "backend-init-unavailable",
            "note": f"UNMEASURED: {device_type} backend init failed or hung",
            "watchdog_timeline": wd.timeline(),
        },
        kind="error",
        stream=stream,
    )
    return False
