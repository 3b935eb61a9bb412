"""Backend-liveness watchdog: probe heartbeat, state machine, global seam.

The port's copy of `glom_tpu/telemetry/watchdog.py`. `BackendWatchdog`
wraps `utils/metrics.probe_device_count` (a throwaway subprocess under a
timeout that prints the device count of the run's device type: a wedged
driver hangs that child, never the trainer) and stamps every state
transition as a schema-versioned "watchdog" event into the run's JSONL
stream (or the flight recorder).

States: unknown -> up/down on the first probe; up <-> down on changes; and
`flapping` when >= flap_threshold transitions land inside flap_window_s (a
backend that answers, dies, answers again: worse than plainly down,
because half the queued steps dispatch into the gap); a flapping backend
settles to up once its window drains. Between transitions a healthy
backend confirms itself with a low-cadence heartbeat event (heartbeat_s),
so a run that later hangs silently leaves a ring whose last heartbeat
dates the silence. `set_probe_fault` is the chaos seam. The state machine
is glom_tpu's, line for line.

A process-global watchdog (`set_global_watchdog`) lets every sink stamp the
current backend state without threading a handle through each call
(`backend_record()`), and lets the dispatch retry policy fail fast on a
backend that is down (resilience/retry.py). Without one, the state is "up"
once this process has initialised CUDA and "unknown" before: never a guess.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from typing import Callable, List, Optional

import torch

from glom_tpu_torch.telemetry import schema

STATES = schema.WATCHDOG_STATES  # ("unknown", "up", "down", "flapping")


def _default_probe(timeout: float, *, device_type: str = "cuda") -> Optional[int]:
    # Deferred: utils.metrics imports the telemetry package.
    from glom_tpu_torch.utils.metrics import probe_device_count

    return probe_device_count(timeout=timeout, device_type=device_type)


class BackendWatchdog:
    """Heartbeat over the backend probe with transition stamping.

    `probe(timeout) -> Optional[int]` returns the visible device count or
    None (init failed/hung); by default `utils/metrics.probe_device_count`
    for `device_type`, a throwaway subprocess. `writer` (anything with
    .write(dict), e.g. MetricsWriter) receives one stamped "watchdog" event
    per transition;
    the full timeline is also kept in memory for end-of-run records.
    start() runs probes from a daemon thread every interval_s; probe_once()
    is the synchronous form the benches use as their fail-fast gate.
    """

    def __init__(
        self,
        *,
        interval_s: float = 60.0,
        probe: Optional[Callable[[float], Optional[int]]] = None,
        probe_timeout: float = 120.0,
        writer=None,
        flap_window_s: float = 600.0,
        flap_threshold: int = 3,
        heartbeat_s: float = 600.0,
        clock: Callable[[], float] = time.monotonic,
        device_type: str = "cuda",
    ):
        if flap_threshold < 2:
            raise ValueError("flap_threshold must be >= 2 (a single "
                             "transition is just up or down)")
        self.interval_s = interval_s
        self._probe = (probe if probe is not None
                       else functools.partial(_default_probe, device_type=device_type))
        self.probe_timeout = probe_timeout
        self.writer = writer
        self.flap_window_s = flap_window_s
        self.flap_threshold = flap_threshold
        # Low-cadence "up"-confirmation events (0 disables): transitions
        # only fire on CHANGE, so a run that silently hangs leaves a stale
        # flight-recorder ring with no way to date the silence. A
        # heartbeat event at most every heartbeat_s keeps the ring
        # timestamped — the gap after the LAST heartbeat bounds when the
        # hang began (ROADMAP backlog item).
        self.heartbeat_s = heartbeat_s
        self._last_heartbeat: Optional[float] = None
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._state = "unknown"
        self._devices: Optional[int] = None
        self._transitions = 0
        self._transition_times: deque = deque()
        self._timeline: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._probes = 0
        self._probe_fault: Optional[Callable[[Optional[int]], Optional[int]]] = None

    # -- fault-injection seam ---------------------------------------------

    def set_probe_fault(
        self, fault: Optional[Callable[[Optional[int]], Optional[int]]]
    ) -> None:
        """Chaos seam (resilience/faults.py): `fault` receives the
        REAL probe's result and returns the possibly-corrupted one (None =
        backend looks down). The state machine, transition stamping, and
        every downstream consumer see only the faulted value — exactly the
        view a genuinely flapping backend would present — while the
        injector stamps its own schema "fault" event per injection, so a
        chaos run can reconcile observed transitions against injected
        flaps. Pass None to remove."""
        with self._lock:
            self._probe_fault = fault

    # -- state machine ----------------------------------------------------

    def probe_once(self) -> str:
        """Run one probe, update the state machine, stamp any transition."""
        n = self._probe(self.probe_timeout)
        with self._lock:
            fault = self._probe_fault
        if fault is not None:
            # Outside the lock: the injector stamps "fault" events, and a
            # writer that re-enters record() must not deadlock.
            n = fault(n)
        with self._lock:
            self._probes += 1
            self._devices = n
            raw = "up" if n is not None and n >= 1 else "down"
            prev = self._state
            prev_raw = "up" if prev in ("up", "flapping") else prev
            now = self._clock() - self._t0
            if raw != prev_raw:
                self._transitions += 1
                self._transition_times.append(now)
                while (
                    self._transition_times
                    and now - self._transition_times[0] > self.flap_window_s
                ):
                    self._transition_times.popleft()
                flapping = (
                    prev != "unknown"
                    and len(self._transition_times) >= self.flap_threshold
                )
                new = "flapping" if flapping and raw == "up" else raw
                self._record_transition(prev, new, now)
                self._state = new
            elif self._state == "flapping" and not self._transition_times:
                # Flap window drained with no new transitions: settled.
                self._record_transition("flapping", "up", now)
                self._state = "up"
            else:
                # Re-confirmations age the flap window.
                while (
                    self._transition_times
                    and now - self._transition_times[0] > self.flap_window_s
                ):
                    self._transition_times.popleft()
                # Quiet re-confirmation of a healthy backend: emit the
                # low-cadence heartbeat so a later total hang is datable
                # from the ring (transitions reset the cadence — a fresh
                # transition event IS a timestamp).
                if (
                    self.heartbeat_s > 0
                    and self._state == "up"
                    and (
                        self._last_heartbeat is None
                        or now - self._last_heartbeat >= self.heartbeat_s
                    )
                ):
                    self._record_heartbeat(now)
            return self._state

    def _record_transition(self, prev: str, new: str, t: float) -> None:
        event = schema.stamp(
            {
                "t": round(t, 3),
                "wall_time_s": round(time.time(), 3),
                "event": "backend_transition",
                "prev_state": prev,
                "backend_state": new,
                "backend_devices": self._devices,
                "transitions": self._transitions,
            },
            kind="watchdog",
        )
        self._timeline.append(event)
        self._last_heartbeat = t  # any stamped event restarts the cadence
        self._write_event(event)

    def _record_heartbeat(self, t: float) -> None:
        """The "up"-confirmation event: NOT a transition (the timeline and
        transition counter stay clean), just a timestamped pulse into the
        writer / flight ring. Only ever fired for state "up" — a repeated
        "down" heartbeat would re-trigger the flight recorder's
        backend-down dump on every probe."""
        self._last_heartbeat = t
        event = schema.stamp(
            {
                "t": round(t, 3),
                "wall_time_s": round(time.time(), 3),
                "event": "heartbeat",
                "backend_state": self._state,
                "backend_devices": self._devices,
                "probes": self._probes,
            },
            kind="watchdog",
        )
        self._write_event(event)

    def _write_event(self, event: dict) -> None:
        # No writer: the global flight recorder gets the event directly,
        # so a down transition still triggers the postmortem dump.
        from glom_tpu_torch.tracing.flight import write_or_observe

        write_or_observe(self.writer, event)

    # -- heartbeat thread -------------------------------------------------

    def start(self) -> "BackendWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.probe_once()
                except Exception:
                    pass  # the watchdog must never take the run down
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(
            target=loop, name="glom-backend-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- reads ------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def timeline(self) -> List[dict]:
        with self._lock:
            return list(self._timeline)

    def record(self) -> dict:
        """The fields every metrics/bench record stamps."""
        with self._lock:
            return {
                "backend_state": self._state,
                "backend_devices": self._devices,
                "backend_transitions": self._transitions,
            }


# -- process-global registration ------------------------------------------

_GLOBAL = None


def set_global_watchdog(wd) -> None:
    global _GLOBAL
    _GLOBAL = wd


def get_global_watchdog():
    return _GLOBAL


def _inprocess_backend_live() -> bool:
    """Has this process already initialised CUDA? A live in-process
    context is the one case where "up" is certain without a probe."""
    return torch.cuda.is_initialized()


def backend_record() -> dict:
    """Watchdog fields for a record: the global watchdog's state when one
    is registered; otherwise "up" iff CUDA is live in this process, else
    "unknown"."""
    wd = get_global_watchdog()
    if wd is not None:
        return wd.record()
    return {"backend_state": "up" if _inprocess_backend_live() else "unknown"}
