"""fit_supervised: the restart loop that stands between a fault and a
dead training run.

Counterpart of `glom_tpu/train/supervise.py`. Recovery is
checkpoint-based restart: restore the newest VALID step and continue.

    attempt:
        fresh trainer  (a crashed attempt's state never leaks forward)
        restore the newest valid checkpoint  -> stamped "recovery" event
        realign the data stream to the restored step
        fit in checkpoint spans, saving each span
    on failure:
        bounded exponential backoff           -> stamped "recovery" event
        next attempt (budget: max_restarts)
    budget exhausted:
        stamped "give-up" + the original exception re-raised

The trainer protocol is thin: `.state` (settable, a TrainState),
`.fit(data, num_steps, log_every=...)`, and `.generator` (the noise
generator the checkpoint carries, optional). A trainer with
`save_checkpoint(manager, step)` and `restore_checkpoint(directory,
manager=)` (DistributedTrainer) saves and restores its global state through
them: every rank calls them, and rank 0 (`.rank`) alone writes, so
`checkpoint_dir` holds one copy, which every rank reads. Cross-process faults (a killed process)
compose with the same loop: the replacement process calls fit_supervised
over the same checkpoint directory and its first attempt resumes where the
dead one committed.

The gang mode (`gang=` a resilience.coordinator.PodCoordinator,
`pod_peers=` the sibling hosts' checkpoint directories) restarts a gang as
one unit, as glom_tpu's does: each attempt meets at the restart barrier
before it restores, the restore reconciles to the newest step valid on
every host, a member's failure posts a gang-wide stop, and the others
raise GangRestart at their next checkpoint-span boundary. The training
CLI runs it for pod hosts (`--pod-*`) and for the ranks of `--distributed
--supervise`, whose one global-state copy needs no `pod_peers` and whose
`make_trainer` builds the rank mesh afresh after the barrier.
"""

from __future__ import annotations

import inspect
import threading
import time
from typing import Callable, Iterator, List, Optional

from glom_tpu_torch.resilience.faults import emit_recovery
from glom_tpu_torch.resilience.retry import next_backoff, validate_backoff


class TrainSupervisor:
    """Restart budget + backoff state, stamped. The counters ride one lock,
    so monitoring threads can read record() while the loop runs."""

    def __init__(
        self,
        *,
        max_restarts: int = 3,
        backoff_s: float = 0.5,
        backoff_factor: float = 2.0,
        backoff_max_s: float = 30.0,
        writer=None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if max_restarts < 0:
            raise ValueError(f"max_restarts {max_restarts} must be >= 0")
        validate_backoff(backoff_s, backoff_factor, backoff_max_s)
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.backoff_factor = backoff_factor
        self.backoff_max_s = backoff_max_s
        self.writer = writer
        self._sleep = sleep
        self._lock = threading.Lock()
        self._attempts = 0
        self._restarts = 0
        self._gave_up = False
        self._last_error: Optional[str] = None

    def begin_attempt(self) -> int:
        with self._lock:
            self._attempts += 1
            return self._attempts

    def on_failure(self, exc: BaseException) -> Optional[float]:
        """One failed attempt: returns the backoff slept before the next
        attempt, or None when the budget is exhausted (the caller
        re-raises). Stamps the "recovery" event either way."""
        err = f"{type(exc).__name__}: {exc}"[:300]
        with self._lock:
            self._last_error = err
            attempt = self._attempts
            if self._restarts >= self.max_restarts:
                self._gave_up = True
                backoff = None
            else:
                self._restarts += 1
                restarts = self._restarts
                backoff = next_backoff(
                    self.backoff_s, self.backoff_factor, self.backoff_max_s, restarts - 1
                )
        if backoff is None:
            emit_recovery(self.writer, {
                "action": "give-up",
                "attempt": attempt,
                "max_restarts": self.max_restarts,
                "exception": err,
            })
            return None
        emit_recovery(self.writer, {
            "action": "restart",
            "attempt": attempt,
            "restarts": restarts,
            "max_restarts": self.max_restarts,
            "backoff_s": round(backoff, 4),
            "exception": err,
        })
        if backoff > 0:
            self._sleep(backoff)
        return backoff

    def record(self) -> dict:
        """Status snapshot (stampable; readable from monitor threads)."""
        with self._lock:
            return {
                "attempts": self._attempts,
                "restarts": self._restarts,
                "max_restarts": self.max_restarts,
                "gave_up": self._gave_up,
                "last_error": self._last_error,
            }


def fit_supervised(
    make_trainer: Callable[[], object],
    make_data: Callable[[], Iterator],
    num_steps: int,
    *,
    checkpoint_dir: str,
    checkpoint_every: int = 100,
    log_every: int = 10,
    supervisor: Optional[TrainSupervisor] = None,
    metrics_writer=None,
    checkpoint_async: bool = False,
    max_to_keep: int = 3,
    preemption_deadline_s: float = 30.0,
    gang=None,
    pod_peers=None,
    gang_barrier_deadline_s: float = 30.0,
) -> List[dict]:
    """Run `num_steps` updates under the restart supervisor; returns the
    concatenated fit history across attempts.

    make_trainer/make_data are FACTORIES, called fresh per attempt: the
    checkpoint is the one source of resumed state, and the data stream
    must be deterministic from its start so the resumed attempt can
    realign by skipping the restored number of batches. A make_data that
    takes a `start` parameter is asked for the stream from the restored
    step instead (the port's loaders seek there, glom_tpu_torch/data).

    Checkpoints land every `checkpoint_every` steps through the
    manifest-verified CheckpointManager (utils/checkpoint.py), with the
    trainer's noise generator, so a resumed attempt draws the noise the
    uninterrupted run would have. checkpoint_async=False by default: a
    synchronous save is committed the moment its span ends. While an
    attempt runs, the global flight recorder's SIGTERM hook (when one is
    installed) carries a bounded preemption checkpoint of the live state
    (tracing/flight.py set_checkpoint_hook); a SIGTERM inside an optimizer
    step saves the state at the step's end.

    GANG MODE (`gang=`, `pod_peers=`): see the module docstring. Epochs
    are the attempt numbers, which the stop-flag propagation keeps in
    lockstep; pod gangs should raise max_to_keep, since retention bounds
    the step drift the preemption barrier can bridge."""
    from glom_tpu_torch.tracing.flight import get_global_flight_recorder
    from glom_tpu_torch.utils.checkpoint import CheckpointManager

    if num_steps < 1:
        raise ValueError(f"num_steps {num_steps} must be >= 1")
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every {checkpoint_every} must be >= 1")
    if gang is None and pod_peers:
        raise ValueError("pod_peers without gang= (pod restore needs the coordinator's "
                         "restart rendezvous)")
    sup = supervisor if supervisor is not None else TrainSupervisor(writer=metrics_writer)
    history: List[dict] = []
    while True:
        attempt = sup.begin_attempt()
        ckpt = CheckpointManager(
            checkpoint_dir, async_save=checkpoint_async, max_to_keep=max_to_keep,
            metrics_writer=metrics_writer, pod_peers=pod_peers,
        )
        fr = get_global_flight_recorder()
        try:
            if gang is not None:
                # Meet BEFORE reconciling: every member must have stopped
                # writing its previous attempt's checkpoints. Arrivals
                # persist per epoch, so a member deep in backoff sails
                # through a barrier its peers already filled.
                gang.gang_barrier("restart", attempt, deadline_s=gang_barrier_deadline_s)
            trainer = make_trainer()
            generator = getattr(trainer, "generator", None)
            global_state = hasattr(trainer, "restore_checkpoint")
            start = 0
            if global_state:
                # DistributedTrainer: collectives over its ranks; rank 0's
                # manager picks the step and writes the one copy.
                writer_ckpt = ckpt if trainer.rank == 0 else None
                restored = trainer.restore_checkpoint(checkpoint_dir, manager=writer_ckpt)
                start = 0 if restored is None else restored
            elif ckpt.latest_step() is not None:
                start, trainer.state = ckpt.restore(state=trainer.state, generator=generator)
            if start:
                emit_recovery(metrics_writer, {
                    "action": "resume-from-checkpoint",
                    "step": int(start),
                    "attempt": attempt,
                })
            if start >= num_steps:
                if gang is not None:
                    gang.signal_gang_done(num_steps)
                return history
            data = _stream_from(make_data, start)
            if fr is not None:
                fr.set_checkpoint_hook(
                    preemption_hook(trainer, checkpoint_dir, metrics_writer=metrics_writer,
                                    gang=gang, deadline_s=preemption_deadline_s, start=start),
                    deadline_s=preemption_deadline_s)
            done = start
            while done < num_steps:
                if gang is not None and gang.gang_stop_requested(attempt):
                    from glom_tpu_torch.resilience.coordinator import GangRestart

                    raise GangRestart(f"gang stop requested in epoch {attempt}")
                span = min(checkpoint_every, num_steps - done)
                history.extend(trainer.fit(data, num_steps=span, log_every=log_every))
                done += span
                if global_state:
                    trainer.save_checkpoint(writer_ckpt, done)
                else:
                    ckpt.save(done, trainer.state, generator=generator)
            ckpt.wait()
            if gang is not None:
                # A finished member leaves the gang: the persistent done flag
                # excuses it from later restart barriers, so a peer that
                # fails after we return can still recover.
                gang.signal_gang_done(num_steps)
            return history
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 - the supervisor classifies
            if gang is not None:
                from glom_tpu_torch.resilience.coordinator import GangRestart

                if not isinstance(e, GangRestart):
                    # OUR failure becomes the gang's: peers raise GangRestart
                    # at their next span boundary, and the gang meets at the
                    # next restart barrier.
                    gang.signal_gang_stop(attempt, f"{type(e).__name__}: {e}"[:300])
            if sup.on_failure(e) is None:
                raise
        finally:
            if fr is not None:
                fr.set_checkpoint_hook(None)
            try:
                ckpt.close()
            except Exception:  # noqa: BLE001 - best effort on teardown
                pass


def _stream_from(make_data, start: int):
    """make_data's stream from batch `start`: asked for when the factory
    takes `start`, else realigned by skipping, as glom_tpu's is."""
    try:
        seeks = "start" in inspect.signature(make_data).parameters
    except (TypeError, ValueError):  # a callable without a signature
        seeks = False
    if seeks:
        return make_data(start=start)
    data = make_data()
    for _ in range(start):
        next(data)  # realign the deterministic stream
    return data


def preemption_hook(trainer, checkpoint_dir, *, metrics_writer=None, gang=None,
                    deadline_s: float = 30.0, start: int = 0):
    """The SIGTERM checkpoint hook (tracing/flight.set_checkpoint_hook) over
    a live trainer: the single-host grace save, or in a gang the pod barrier
    round `preempt-g<start>`, whose budget sits inside the hook's deadline so
    an abort is stamped before the dump. A DistributedTrainer's ranks step
    together and keep one copy: every rank gathers the global state (so
    every rank must be signalled, as torch.distributed.run forwards a
    SIGTERM to each), and rank 0 alone saves it."""
    from glom_tpu_torch.resilience.coordinator import pod_preemption_save
    from glom_tpu_torch.utils.checkpoint import preemption_save

    generator = getattr(trainer, "generator", None)

    def hook():
        if hasattr(trainer, "global_state"):
            state = trainer.global_state()
            if trainer.rank != 0:
                return {"step": int(state.step), "writer_rank": 0}
            return preemption_save(checkpoint_dir, state, int(state.step),
                                   generator=generator, metrics_writer=metrics_writer)
        state = trainer.state
        if gang is not None:
            return pod_preemption_save(
                gang, checkpoint_dir, state, int(state.step), deadline_s=deadline_s * 0.8,
                round_id=f"preempt-g{int(start)}", metrics_writer=metrics_writer,
                generator=generator)
        return preemption_save(checkpoint_dir, state, int(state.step), generator=generator,
                               metrics_writer=metrics_writer)

    return hook
