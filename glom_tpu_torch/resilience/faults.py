"""Deterministic fault injection: seedable, scoped, stamped.

The port's copy of the part of `glom_tpu/resilience/faults.py` that the
training side's recovery machinery is tested with: the FaultPlan every
injector consults, the stamped "fault" and "recovery" emitters, and the
injectors for a raising callable (`plan.wrap`), a poisoned batch
(`nan_storm`), a failing dispatch (`dispatch_fault`), a failing elastic
spawn (`spawn_fault`) and a torn checkpoint (`truncate_newest_checkpoint`).
The contract, in order of importance:

  * DETERMINISTIC: every injection decision comes from a FaultPlan, a
    per-site schedule (explicit call indices, or a seeded per-site RNG
    rate inside a window). Same seed, same call sequence, same faults.
  * STAMPED: each injection lands as a "fault" event (fault class, site,
    occurrence index, per-injection detail) through the writer-else-flight
    delivery, so a run's recovery events can be reconciled one-to-one
    against what was injected.
  * SCOPED: injectors attach at the seams the real faults enter through;
    nothing here runs unless wired in.
"""

from __future__ import annotations

import random
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from glom_tpu_torch.telemetry import schema


class InjectedFault(RuntimeError):
    """Default exception raised by exception-type injectors: tests can
    assert THIS fault surfaced (or was recovered from), not a lookalike."""


def emit_fault(writer, rec: dict) -> dict:
    """Stamp one "fault" event and deliver writer-else-flight. Returns the
    stamped record."""
    from glom_tpu_torch.tracing.flight import write_or_observe

    stamped = schema.stamp(rec, kind="fault")
    write_or_observe(writer, stamped)
    return stamped


def emit_recovery(writer, rec: dict) -> dict:
    """The recovery twin of emit_fault: one stamp-and-deliver definition
    for every "recovery" emit site (the restart loop, the checkpoint
    torn-step skip, the CLI's resume). Returns the stamped record."""
    from glom_tpu_torch.telemetry import tracectx
    from glom_tpu_torch.tracing.flight import write_or_observe

    stamped = schema.stamp(rec, kind="recovery")
    if not any(k in stamped for k in ("trace_id", "trace_ids")):
        stamped.update(tracectx.current_fields())
    write_or_observe(writer, stamped)
    return stamped


class FaultPlan:
    """The one seeded decision source every injector consults.

    register() declares a site's schedule; fires() is called by the
    injector once per potential-injection point and returns whether to
    inject, stamping the "fault" event when it does. Schedules:

      * at=(i, j, ...) — fire exactly on those 0-based call indices (the
        form the pinned-window tests use);
      * rate=p with start/stop — fire each in-window call with seeded
        probability p (per-site `random.Random(f"{seed}:{site}")`, so
        adding a site never perturbs another site's schedule).

    Thread-safe: per-site counters and the event log ride one lock
    (injectors may fire from worker threads while the test thread reads
    events()/record())."""

    def __init__(self, seed: int = 0, *, writer=None, clock=time.monotonic):
        self.seed = seed
        self.writer = writer
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._sites: Dict[str, dict] = {}
        self._calls: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._events: List[dict] = []

    def register(
        self,
        site: str,
        *,
        at: Optional[Iterable[int]] = None,
        rate: Optional[float] = None,
        start: int = 0,
        stop: Optional[int] = None,
        fault: Optional[str] = None,
    ) -> "FaultPlan":
        """Declare `site`'s schedule; returns self for chaining. `fault`
        names the fault class on the stamped events (default: the site)."""
        if (at is None) == (rate is None):
            raise ValueError(
                f"site {site!r}: exactly one of at=(indices) or rate=p"
            )
        if rate is not None and not 0.0 <= rate <= 1.0:
            raise ValueError(f"site {site!r}: rate {rate} outside 0..1")
        with self._lock:
            self._sites[site] = {
                "at": frozenset(int(i) for i in at) if at is not None else None,
                "rate": rate,
                "start": start,
                "stop": stop,
                "fault": fault if fault is not None else site,
                "rng": random.Random(f"{self.seed}:{site}"),
            }
            self._calls.setdefault(site, 0)
            self._fired.setdefault(site, 0)
        return self

    def fires(self, site: str, **detail) -> bool:
        """One potential-injection point at `site`: decide, count, stamp.
        Unregistered sites never fire (an injector can be wired in
        unconditionally and armed per test)."""
        with self._lock:
            index = self._calls.get(site, 0)
            self._calls[site] = index + 1
            spec = self._sites.get(site)
            fire = False
            if spec is not None and index >= spec["start"] and (
                spec["stop"] is None or index < spec["stop"]
            ):
                if spec["at"] is not None:
                    fire = index in spec["at"]
                else:
                    fire = spec["rng"].random() < spec["rate"]
            if fire:
                self._fired[site] = self._fired.get(site, 0) + 1
                event = {
                    "fault": spec["fault"],
                    "site": site,
                    "index": index,
                    "t": round(self._clock() - self._t0, 4),
                    "wall_time_s": round(time.time(), 3),
                    **detail,
                }
        if not fire:
            return False
        # Stamp OUTSIDE the lock: the writer chain (MetricsWriter, flight
        # ring) takes its own locks and must not nest inside ours.
        stamped = emit_fault(self.writer, event)
        with self._lock:
            self._events.append(stamped)
        return True

    def wrap(
        self,
        fn: Callable,
        site: str,
        *,
        exc: Optional[Callable[[], BaseException]] = None,
        before: Optional[Callable[[], None]] = None,
    ) -> Callable:
        """Generic injector: when the plan fires at `site`, run `before`
        (a stall, a truncation) and/or raise `exc()` INSTEAD of calling
        through — the checkpoint-write-failure form:

            ckpt.save = plan.wrap(ckpt.save, "ckpt-write",
                                  exc=lambda: OSError("injected"))
        """
        if exc is None and before is None:
            exc = lambda: InjectedFault(f"injected fault at {site}")

        def wrapped(*args, **kwargs):
            if self.fires(site):
                if before is not None:
                    before()
                if exc is not None:
                    raise exc()
            return fn(*args, **kwargs)

        return wrapped

    # -- reads -------------------------------------------------------------

    def events(self) -> List[dict]:
        """The stamped "fault" events injected so far — the ground truth a
        chaos test reconciles recovery against."""
        with self._lock:
            return list(self._events)

    def record(self) -> dict:
        """Per-site calls/fired summary (a stampable rollup)."""
        with self._lock:
            return {
                "seed": self.seed,
                "sites": {
                    s: {"calls": self._calls.get(s, 0),
                        "fired": self._fired.get(s, 0)}
                    for s in sorted(self._sites)
                },
            }


# -- injectors ------------------------------------------------------------


def dispatch_fault(
    plan: FaultPlan,
    site: str = "engine-dispatch",
    *,
    exc_type: Callable[[str], BaseException] = InjectedFault,
):
    """Dispatch-exception injector for InferenceEngine(fault_hook=...):
    raises on scheduled dispatch ATTEMPTS (retries re-roll the schedule,
    so `at=(0,)` means 'first attempt fails, the retry lands')."""

    def hook(ctx: dict) -> None:
        from glom_tpu_torch.telemetry import tracectx

        # An injection that lands under a dispatch scope stamps the
        # victim requests' trace context on the fault event, so a chaos
        # run's trace trees show WHICH requests each injection hit.
        if plan.fires(
            site,
            **{k: ctx.get(k) for k in ("bucket", "n_valid", "attempt")},
            **tracectx.current_fields(),
        ):
            raise exc_type(f"injected dispatch fault at {site}")

    return hook


def spawn_fault(
    plan: FaultPlan,
    site: str = "engine-spawn",
    *,
    exc_type: Callable[[str], BaseException] = InjectedFault,
):
    """Scale-out spawn-failure injector for the elastic autoscaler
    (serve/elastic.Autoscaler(spawn_hook=...)): raises on scheduled spawn
    ATTEMPTS before the engine factory runs. The autoscaler must roll back
    loudly (a stamped spawn_rollback, no registration, the cooldown still
    charged so a persistent fault cannot hot-spin spawns) instead of
    admitting a half-built replica. Every injection is a stamped "fault"
    event, so a run reconciles its rollbacks against what was injected."""

    def hook(ctx: dict) -> None:
        if plan.fires(
            site,
            **{k: (ctx or {}).get(k) for k in ("attempt", "n_engines")},
        ):
            raise exc_type(f"injected spawn fault at {site}")

    return hook


def nan_storm(
    data: Iterator,
    plan: FaultPlan,
    site: str = "nan-storm",
    *,
    fraction: float = 1.0,
) -> Iterator:
    """NaN-grad-storm injector: wraps a batch iterator; scheduled batches
    are copied and poisoned with NaN over the leading `fraction` of
    elements — the in-graph NaN/Inf guard (telemetry/diagnostics.py) and
    the fit loop's anomaly events are the recovery machinery under test."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction {fraction} outside (0, 1]")
    for i, batch in enumerate(data):
        if plan.fires(site, batch=i):
            poisoned = np.array(batch, dtype=np.float32, copy=True)
            flat = poisoned.reshape(-1)
            flat[: max(1, int(fraction * flat.size))] = np.nan
            yield poisoned
        else:
            yield batch


def truncate_newest_checkpoint(
    directory, *, writer=None
) -> Optional[Tuple[int, str]]:
    """Torn-checkpoint injector: truncate the largest file of the NEWEST
    step under a checkpoint directory (its numbered step directories) to
    half its size, stamping the "fault" event. Returns (step, path) or None when no step exists.
    The recovery under test: latest_step()/restore() must skip the torn
    step and land on the previous valid one (utils/checkpoint.py)."""
    directory = Path(directory)
    steps = sorted(
        (int(p.name), p)
        for p in directory.iterdir()
        if p.is_dir() and p.name.isdigit()
    )
    if not steps:
        return None
    step, step_dir = steps[-1]
    files = [p for p in step_dir.rglob("*") if p.is_file()]
    if not files:
        return None
    target = max(files, key=lambda p: p.stat().st_size)
    size = target.stat().st_size
    with open(target, "r+b") as fh:
        fh.truncate(size // 2)
    emit_fault(
        writer,
        {
            "fault": "torn-checkpoint",
            "site": "ckpt-truncate",
            "step": step,
            "path": str(target.relative_to(directory)),
            "bytes_before": size,
            "bytes_after": size // 2,
            "wall_time_s": round(time.time(), 3),
        },
    )
    return step, str(target)
