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
generator the checkpoint carries, optional). Cross-process faults (a
killed process) compose with the same loop: the replacement process calls
fit_supervised over the same checkpoint directory and its first attempt
resumes where the dead one committed. The gang mode (`gang=`, pod
coordination) is not ported (ROADMAP queue A item 9).
"""

from __future__ import annotations

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
) -> List[dict]:
    """Run `num_steps` updates under the restart supervisor; returns the
    concatenated fit history across attempts.

    make_trainer/make_data are FACTORIES, called fresh per attempt: the
    checkpoint is the one source of resumed state, and the data stream
    must be deterministic from its start so the resumed attempt can
    realign by skipping the restored number of batches.

    Checkpoints land every `checkpoint_every` steps through the
    manifest-verified CheckpointManager (utils/checkpoint.py), with the
    trainer's noise generator, so a resumed attempt draws the noise the
    uninterrupted run would have. checkpoint_async=False by default: a
    synchronous save is committed the moment its span ends. While an
    attempt runs, the global flight recorder's SIGTERM hook (when one is
    installed) carries a bounded preemption checkpoint of the live state
    (tracing/flight.py set_checkpoint_hook)."""
    from glom_tpu_torch.tracing.flight import get_global_flight_recorder
    from glom_tpu_torch.utils.checkpoint import CheckpointManager, preemption_save

    if gang is not None or pod_peers:
        raise NotImplementedError(
            "fit_supervised(gang=..., pod_peers=...) is not ported yet: ROADMAP "
            "queue A item 9 (the pod coordinator)"
        )
    if num_steps < 1:
        raise ValueError(f"num_steps {num_steps} must be >= 1")
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every {checkpoint_every} must be >= 1")
    sup = supervisor if supervisor is not None else TrainSupervisor(writer=metrics_writer)
    history: List[dict] = []
    while True:
        attempt = sup.begin_attempt()
        ckpt = CheckpointManager(
            checkpoint_dir, async_save=checkpoint_async, max_to_keep=max_to_keep,
            metrics_writer=metrics_writer,
        )
        fr = get_global_flight_recorder()
        try:
            trainer = make_trainer()
            generator = getattr(trainer, "generator", None)
            start = 0
            if ckpt.latest_step() is not None:
                start, trainer.state = ckpt.restore(state=trainer.state, generator=generator)
                emit_recovery(metrics_writer, {
                    "action": "resume-from-checkpoint",
                    "step": int(start),
                    "attempt": attempt,
                })
            if start >= num_steps:
                return history
            data = make_data()
            for _ in range(start):
                next(data)  # realign the deterministic stream
            if fr is not None:

                def preempt_save():
                    if getattr(trainer, "in_step", False):
                        raise RuntimeError(
                            "SIGTERM landed inside an optimizer step: no "
                            "consistent state to save"
                        )
                    return preemption_save(
                        checkpoint_dir, trainer.state, int(trainer.state.step),
                        generator=generator, metrics_writer=metrics_writer,
                    )

                fr.set_checkpoint_hook(preempt_save, deadline_s=preemption_deadline_s)
            done = start
            while done < num_steps:
                span = min(checkpoint_every, num_steps - done)
                history.extend(trainer.fit(data, num_steps=span, log_every=log_every))
                done += span
                ckpt.save(done, trainer.state, generator=generator)
            ckpt.wait()
            return history
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 - the supervisor classifies
            if sup.on_failure(e) is None:
                raise
        finally:
            if fr is not None:
                fr.set_checkpoint_hook(None)
            try:
                ckpt.close()
            except Exception:  # noqa: BLE001 - best effort on teardown
                pass
