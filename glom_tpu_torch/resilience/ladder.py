"""The serving degradation ladder: shedding is the last rung, not the only
move.

The port's copy of `glom_tpu/resilience/ladder.py`. Each rung is a cheaper
serving mode, and each transition a stamped, reversible decision:

    rung 0  normal        the configured route (iters="auto", full buckets)
    rung 1  capped_iters  a fixed degraded iteration budget per dispatch
    rung 2  bucket_cap    also gather smaller batches (a capped dispatch
                          ceiling drains the queue in smaller bites)
    rung 3  shed          new admissions fail fast

Inputs per evaluation: the queue fill (pressure) and the watchdog backend
state. Fill >= high_water steps down one rung, fill <= low_water steps
back up; a flapping backend pins the ladder at capped_iters or worse while
the flap lasts, but flapping alone never sheds (a backend that is down is
the batcher's fast-fail path, not the ladder's). A min_dwell_s hysteresis
keeps one burst from riding the ladder up and down per dispatch.

Every transition is a "serve" record (event "ladder") through
serve/events.emit_serve and is kept in an in-memory timeline. Thread-safe:
observe() runs on the batcher's workers while rung()/record() serve caller
threads.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

RUNGS = ("normal", "capped_iters", "bucket_cap", "shed")
NORMAL, CAPPED_ITERS, BUCKET_CAP, SHED = range(4)


def class_rungs(shed_position: int, n_classes: int) -> tuple:
    """(degrade_rung, shed_rung) for the SLO class at `shed_position` of
    `n_classes` in the shed order (serve/qos.py; 0 = first to
    shed). The ladder itself stays ONE shared pressure signal — classes
    differ in WHICH rung starts costing them:

      * the FIRST class in the shed order (the batch end) sheds a rung
        EARLY (bucket_cap instead of shed): under pressure the fleet
        drops its cheapest tenant before anything else degrades hard;
      * the LAST class (the premium end) HOLDS its full route until
        bucket_cap (one rung past everyone else's capped_iters) and
        sheds only at the ladder's own floor;
      * everything between degrades at capped_iters and sheds at shed —
        the classless semantics, unchanged.

    One class (or a classless config) degrades and sheds as the classless
    ladder does: (capped_iters, shed)."""
    if not 0 <= shed_position < n_classes:
        raise ValueError(
            f"shed_position {shed_position} outside 0..{n_classes - 1}"
        )
    if n_classes <= 1:
        return (CAPPED_ITERS, SHED)
    degrade = BUCKET_CAP if shed_position == n_classes - 1 else CAPPED_ITERS
    shed = BUCKET_CAP if shed_position == 0 else SHED
    return (degrade, shed)


class DegradationLadder:
    """Pressure/flap-driven serving mode, one reversible rung at a time."""

    def __init__(
        self,
        *,
        degraded_iters: int,
        bucket_cap: int,
        high_water: float = 0.75,
        low_water: float = 0.25,
        min_dwell_s: float = 0.25,
        writer=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not 0.0 <= low_water < high_water <= 1.0:
            raise ValueError(
                f"need 0 <= low_water ({low_water}) < high_water "
                f"({high_water}) <= 1"
            )
        if degraded_iters < 1:
            raise ValueError(f"degraded_iters {degraded_iters} must be >= 1")
        if bucket_cap < 1:
            raise ValueError(f"bucket_cap {bucket_cap} must be >= 1")
        if min_dwell_s < 0:
            raise ValueError(f"min_dwell_s {min_dwell_s} must be >= 0")
        self.degraded_iters = degraded_iters
        self.bucket_cap = bucket_cap
        self.high_water = high_water
        self.low_water = low_water
        self.min_dwell_s = min_dwell_s
        self.writer = writer
        self._clock = clock
        self._lock = threading.Lock()
        self._rung = NORMAL
        self._last_change: Optional[float] = None
        self._transitions: List[dict] = []
        self._n_degrade = 0
        self._n_restore = 0

    @classmethod
    def from_config(cls, cfg, scfg, *, writer=None, **overrides):
        """Resolve the ladder knobs from a (GlomConfig, ServeConfig) pair:
        degraded_iters defaults to half the model's iteration budget
        (floor 1) and bucket_cap to half the admission ceiling — both
        overridable per ServeConfig field or kwarg."""
        kw = dict(
            degraded_iters=(
                scfg.degraded_iters
                if scfg.degraded_iters is not None
                else max(1, cfg.default_iters // 2)
            ),
            bucket_cap=(
                scfg.degraded_max_batch
                if scfg.degraded_max_batch is not None
                else max(1, scfg.max_batch // 2)
            ),
            high_water=scfg.ladder_high_water,
            low_water=scfg.ladder_low_water,
            writer=writer,
        )
        kw.update(overrides)
        return cls(**kw)

    # -- the decision ------------------------------------------------------

    def observe(self, *, queue_fill: float, backend_state: str = "up") -> int:
        """Evaluate one (pressure, backend) observation; returns the rung
        now in force. At most ONE rung of movement per call, at most one
        transition per min_dwell_s — the ladder is deliberately slower
        than the queue it watches."""
        event = None
        with self._lock:
            now = self._clock()
            desired = self._rung
            reason = None
            if queue_fill >= self.high_water and self._rung < SHED:
                desired, reason = self._rung + 1, "pressure"
            elif queue_fill <= self.low_water and self._rung > NORMAL:
                desired, reason = self._rung - 1, "drained"
            if backend_state == "flapping":
                if desired < CAPPED_ITERS:
                    # Flap floor: degraded service while the backend
                    # settles. NOT shed — a flapping backend still serves.
                    desired, reason = CAPPED_ITERS, "backend-flapping"
            dwell_ok = (
                self._last_change is None
                or now - self._last_change >= self.min_dwell_s
            )
            if desired != self._rung and dwell_ok:
                prev = self._rung
                self._rung = desired
                self._last_change = now
                if desired > prev:
                    self._n_degrade += 1
                else:
                    self._n_restore += 1
                event = {
                    "event": "ladder",
                    "rung": RUNGS[desired],
                    "prev_rung": RUNGS[prev],
                    "direction": "degrade" if desired > prev else "restore",
                    "reason": reason,
                    "queue_fill": round(queue_fill, 3),
                }
            rung = self._rung
        if event is not None:
            # Emit outside the lock (the writer chain locks on its own);
            # emit_serve merges the live backend_state onto the record.
            from glom_tpu_torch.serve.events import emit_serve

            stamped = emit_serve(self.writer, event)
            with self._lock:
                self._transitions.append(stamped)
        return rung

    # -- reads -------------------------------------------------------------

    def rung(self) -> int:
        with self._lock:
            return self._rung

    def rung_name(self) -> str:
        return RUNGS[self.rung()]

    def timeline(self) -> List[dict]:
        """The stamped transition events, oldest first."""
        with self._lock:
            return list(self._transitions)

    def record(self) -> dict:
        """The fields a serve summary stamps."""
        with self._lock:
            return {
                "ladder_rung": RUNGS[self._rung],
                "ladder_degrades": self._n_degrade,
                "ladder_restores": self._n_restore,
            }
