"""Crash flight recorder: the last N telemetry events, saved at the moment
of death.

The port's copy of `glom_tpu/tracing/flight.py`. A ring of the last
`capacity` schema-stamped events (steps, spans, anomalies, faults,
recoveries), fed by the sinks that already see every record
(MetricsWriter, the fit loop, the checkpoint spans), dumped to
`flight_<ts>.jsonl` when something dies:

    * a watchdog "down" transition lands in the stream,
    * an anomaly storm (>= storm_threshold "anomaly" events inside
      storm_window_s: the NaN-cascade signature),
    * SIGTERM / interpreter exit (install_process_hooks; a SIGTERM first
      runs the checkpoint hook, so a preempted run leaves a resumable
      step; one that lands inside an optimizer step waits for the step's
      end, see `optimizer_step`),
    * an unhandled exception inside fit_loop (the trainer calls
      dump_flight_recorder before re-raising).

Dumps are plain JSONL: a stamped "note" header (trigger, event count,
context) followed by the buffered events in arrival order, each carrying a
monotonic `flight_seq`. Pure stdlib, thread-safe, and observe() never
raises into the caller.

Registration is process-global: sinks call `observe_event(rec)` (a no-op
until `set_global_flight_recorder`). In-process callers that register one
(the training CLI) unregister it on the way out.

The trainers update their parameters and Adam moments in place, so a
SIGTERM save taken in the middle of a step would copy a mix of two steps
(glom_tpu swaps an immutable state in one assignment, and its hook always
sees a whole step). Both trainers run each step inside `optimizer_step()`:
a SIGTERM that lands there (on the main thread, where Python runs signal
handlers) is deferred to the step's end, and the whole handler (the
checkpoint hook, the dump, the chained handler) runs the moment the step
returns, its save bounded by what is left of the deadline that started at
the signal. The saved state is the one after the step.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, List, Optional

# The main thread's optimizer-step depth, and the SIGTERM handlers deferred
# to its end (optimizer_step). Only the main thread runs Python signal
# handlers, so only its steps defer them.
_STEP_DEPTH = 0
_DEFERRED: List[Callable[[Optional[BaseException]], None]] = []


def in_optimizer_step() -> bool:
    """Whether the main thread is inside an optimizer step."""
    return _STEP_DEPTH > 0


@contextlib.contextmanager
def optimizer_step():
    """Run one optimizer step with SIGTERM's handler deferred to its end.

    The trainers wrap each step in this (train/trainer.py,
    parallel/runtime.py). A handler installed by install_process_hooks
    that fires inside it only records itself; when the outermost step
    returns, each deferred handler runs with the step's exception (None
    when it finished), so a preemption save copies a whole step. On any
    thread but the main one this is a no-op."""
    global _STEP_DEPTH
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    _STEP_DEPTH += 1
    failed: Optional[BaseException] = None
    try:
        yield
    except BaseException as e:
        failed = e
        raise
    finally:
        _STEP_DEPTH -= 1
        if _STEP_DEPTH == 0:
            while _DEFERRED:
                _DEFERRED.pop(0)(failed)


class FlightRecorder:
    """Bounded ring of stamped telemetry events + triggered JSONL dumps."""

    def __init__(
        self,
        dump_dir: str,
        capacity: int = 256,
        *,
        storm_threshold: int = 3,
        storm_window_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        if storm_threshold < 1:
            raise ValueError(f"storm_threshold={storm_threshold} must be >= 1")
        self.dump_dir = Path(dump_dir)
        self.capacity = capacity
        self.storm_threshold = storm_threshold
        self.storm_window_s = storm_window_s
        self._clock = clock
        self._lock = threading.RLock()
        self._buf: deque = deque(maxlen=capacity)
        self._seq = 0
        self._last_dump_seq = 0
        self._anomaly_times: deque = deque()
        self.dumps: List[str] = []  # paths written, oldest first
        # Preemption checkpoint hook (set_checkpoint_hook): run a bounded
        # save before the SIGTERM dump so a preempted worker leaves a
        # RESUMABLE step, not just a postmortem.
        self._checkpoint_fn: Optional[Callable[[], Optional[int]]] = None
        self._checkpoint_deadline_s: float = 30.0

    # -- feed --------------------------------------------------------------

    def observe(self, rec: dict) -> None:
        """Buffer one stamped event; fire a dump when it is a trigger.
        Never raises — a postmortem buffer that can crash the run it
        documents is worse than none."""
        try:
            trigger = None
            with self._lock:
                self._seq += 1
                self._buf.append({**rec, "flight_seq": self._seq})
                kind = rec.get("kind")
                if kind == "watchdog" and rec.get("backend_state") == "down":
                    trigger = "backend-down"
                elif kind in ("anomaly", "slo_breach"):
                    # SLO breaches (telemetry/aggregate.SLOMonitor) count
                    # toward the same storm trigger as NaN anomalies: a
                    # burst of breaches is a serving incident, and the
                    # ring should dump itself while the evidence is hot.
                    now = self._clock()
                    self._anomaly_times.append(now)
                    while (
                        self._anomaly_times
                        and now - self._anomaly_times[0] > self.storm_window_s
                    ):
                        self._anomaly_times.popleft()
                    if len(self._anomaly_times) >= self.storm_threshold:
                        trigger = "anomaly-storm"
                        self._anomaly_times.clear()
            if trigger is not None:
                self.dump(trigger)
        except Exception:
            pass

    # Writer protocol: a FlightRecorder can sit anywhere a MetricsWriter
    # can (e.g. as a BackendWatchdog's writer).
    write = observe

    # -- dump --------------------------------------------------------------

    def dump(self, trigger: str, *, context: Optional[dict] = None) -> Optional[str]:
        """Write the buffered events to flight_<ts>_<seq>.jsonl; returns the
        path, or None when nothing new arrived since the last dump (the
        atexit hook after a triggered dump must not write an empty twin)."""
        from glom_tpu_torch.telemetry import schema

        with self._lock:
            if self._seq == self._last_dump_seq:
                return None
            events = list(self._buf)
            self._last_dump_seq = self._seq
            self.dump_dir.mkdir(parents=True, exist_ok=True)
            ts = time.strftime("%Y%m%d_%H%M%S")
            path = self.dump_dir / f"flight_{ts}_{self._seq:06d}.jsonl"
            header = schema.stamp(
                {
                    "note": "flight-recorder dump",
                    "trigger": trigger,
                    "n_events": len(events),
                    "capacity": self.capacity,
                    "wall_time_s": round(time.time(), 3),
                    **(context or {}),
                },
                kind="note",
            )
            with open(path, "w") as fh:
                fh.write(json.dumps(header, default=str) + "\n")
                for e in events:
                    fh.write(json.dumps(e, default=str) + "\n")
            self.dumps.append(str(path))
            return str(path)

    # -- process hooks -----------------------------------------------------

    def set_checkpoint_hook(
        self,
        checkpoint_fn: Optional[Callable[[], Optional[int]]],
        *,
        deadline_s: float = 30.0,
    ) -> None:
        """Grow the SIGTERM (preemption) hook a checkpoint step: before the
        flight dump, `checkpoint_fn` — typically `lambda: save-and-wait the
        current TrainState, returning the step` — runs in a daemon thread
        bounded by `deadline_s` (preemption notices give a fixed grace
        window; a save that can't land inside it must not stall the dump or
        the exit). The outcome is stamped as a schema "recovery" event
        (action "preemption-checkpoint", ok/step/elapsed_s) into the ring
        ahead of the dump, so the postmortem records whether a resumable
        step was left behind. A hook may return a dict instead of a bare
        step — its fields merge into the recovery record (the pod save
        barrier returns step/round/n_hosts that way). Installed separately from
        install_process_hooks because the trainer/manager usually exist
        only after the hooks do (train/cli.py installs hooks first thing).
        Pass None to remove."""
        with self._lock:
            self._checkpoint_fn = checkpoint_fn
            self._checkpoint_deadline_s = deadline_s

    def _preemption_checkpoint(
        self,
        signalled: Optional[float] = None,
        step_failed: Optional[BaseException] = None,
    ) -> None:
        """Run the bounded checkpoint hook; never raises (the SIGTERM
        handler must always reach the dump and the chained handler).
        `signalled` is the monotonic time the signal arrived: a handler
        deferred to a step's end gets what is left of the deadline. A
        step that raised leaves no whole state to save (`step_failed`):
        the hook is not run and the record says why."""
        with self._lock:
            fn = self._checkpoint_fn
            deadline = self._checkpoint_deadline_s
        if fn is None:
            return
        deferred_s = 0.0 if signalled is None else time.monotonic() - signalled
        if step_failed is not None:
            failure = step_failed

            def fn():
                raise RuntimeError(
                    "the optimizer step the signal landed in raised "
                    f"({type(failure).__name__}): no whole state to save")
        try:
            from glom_tpu_torch.telemetry import schema

            result: List = [None, None]  # [step, exception]

            def run():
                try:
                    result[0] = fn()
                except BaseException as e:  # noqa: BLE001 — relayed on the record
                    result[1] = e

            t0 = time.monotonic()
            worker = threading.Thread(
                target=run, name="glom-preempt-ckpt", daemon=True
            )
            worker.start()
            worker.join(timeout=max(0.0, deadline - deferred_s))
            elapsed = time.monotonic() - t0
            ok = not worker.is_alive() and result[1] is None
            rec = {
                "action": "preemption-checkpoint",
                "ok": ok,
                "deadline_s": deadline,
                "elapsed_s": round(elapsed, 3),
                "wall_time_s": round(time.time(), 3),
            }
            if signalled is not None:
                # The signal landed inside an optimizer step: the save
                # waited this long for the step to end.
                rec["deferred_s"] = round(deferred_s, 3)
            if isinstance(result[0], dict):
                # Pod-mode hooks (resilience/coordinator.pod_preemption_
                # save) return the whole barrier outcome — committed
                # step, round id, n_hosts — which rides the recovery
                # record so one stamped event tells the coordinated
                # story; plain hooks keep returning the bare step.
                rec.update(result[0])
            elif result[0] is not None:
                rec["step"] = result[0]
            if worker.is_alive():
                rec["note"] = "save overran the deadline; dumping anyway"
                # The postmortem's first question is "stuck WHERE": snap
                # the overrunning thread's live stack into the record
                # (sys._current_frames is a point-in-time copy, no pause).
                import sys
                import traceback

                frame = sys._current_frames().get(worker.ident)
                if frame is not None:
                    rec["stuck_at"] = [
                        ln.strip()
                        for ln in traceback.format_stack(frame)[-4:]
                    ]
            elif result[1] is not None:
                rec["note"] = f"{type(result[1]).__name__}: {result[1]}"[:300]
            self.observe(schema.stamp(rec, kind="recovery"))
        except Exception:
            pass

    def install_process_hooks(self, *, sigterm: bool = True, on_exit: bool = True):
        """Dump on SIGTERM (the pod-preemption path) and at interpreter
        exit. SIGTERM chains any previously installed handler; installing
        from a non-main thread (where signal.signal raises) skips the
        signal hook silently. When a checkpoint hook is set
        (set_checkpoint_hook), SIGTERM first runs the bounded preemption
        save so the dump records a resumable step. Inside an optimizer
        step the handler defers itself to the step's end
        (optimizer_step). Returns self."""
        if on_exit:
            import atexit

            atexit.register(self._dump_atexit)
        if sigterm:
            import signal

            try:
                prev = signal.getsignal(signal.SIGTERM)

                def _run(signum, frame, signalled=None, step_failed=None):
                    self._preemption_checkpoint(signalled, step_failed)
                    self.dump("sigterm")
                    if callable(prev):
                        prev(signum, frame)
                    elif prev is signal.SIG_IGN:
                        # The host intentionally ignored SIGTERM; dumping
                        # must not convert 'ignored' into 'terminated'.
                        return
                    else:
                        raise SystemExit(128 + signum)

                def _handler(signum, frame):
                    if in_optimizer_step():
                        # The parameters are half updated: run at the
                        # step's end (optimizer_step), within the deadline.
                        t = time.monotonic()
                        _DEFERRED.append(
                            lambda failed: _run(signum, frame, t, failed))
                        return
                    _run(signum, frame)

                signal.signal(signal.SIGTERM, _handler)
            except ValueError:
                pass
        return self

    def _dump_atexit(self) -> None:
        try:
            self.dump("atexit")
        except Exception:
            pass


# -- process-global registration (same pattern as the watchdog) ------------

_GLOBAL: Optional[FlightRecorder] = None


def set_global_flight_recorder(fr: Optional[FlightRecorder]) -> None:
    global _GLOBAL
    _GLOBAL = fr


def get_global_flight_recorder() -> Optional[FlightRecorder]:
    return _GLOBAL


def observe_event(rec: dict) -> None:
    """Feed one stamped event to the global recorder; no-op without one.
    Called by MetricsWriter.write, sinks.emit, the fit loop, and watchdog
    transitions — the places every telemetry record already flows through."""
    fr = _GLOBAL
    if fr is not None:
        fr.observe(rec)


def write_or_observe(writer, rec: dict) -> None:
    """THE writer-else-flight fallback every writerless sink takes: a
    stamped record goes to `writer` when one is attached (MetricsWriter
    already forwards to the flight ring — feeding both would double-buffer
    it), else straight to the global recorder so a writerless run still
    leaves a postmortem trail. One definition, not five copies (watchdog,
    serve engine/batcher, checkpoint spans, prefetch spans)."""
    if writer is not None:
        writer.write(rec)
    else:
        observe_event(rec)


def dump_flight_recorder(
    trigger: str, *, context: Optional[dict] = None
) -> Optional[str]:
    """Force a dump of the global recorder (the fit-loop exception path);
    no-op without one. Never raises."""
    fr = _GLOBAL
    if fr is None:
        return None
    try:
        return fr.dump(trigger, context=context)
    except Exception:
        return None
