"""Retry with backoff for transient dispatch failures, watchdog-aware.

The port's copy of `glom_tpu/resilience/retry.py`: the bounded
exponential backoff contract (`validate_backoff`, `next_backoff`, shared
with the training restart loop, train/supervise.TrainSupervisor) and
`RetryPolicy`, which wraps each serving dispatch
(serve/engine.InferenceEngine):

  * backend_state "down" -> fail fast, no retry (the caller's shed path
    owns it);
  * "up" / "flapping" / "unknown" -> bounded exponential backoff, each
    retry stamped as a "recovery" event (action "dispatch-retry"), and a
    success after retries stamped as "dispatch-recovered".

Nonretryable types raise on the first attempt: caller bugs (ValueError,
TypeError), as in glom_tpu, and, in the port, a kernel that failed to
build or launch (kernels/_build.KernelError), torch's CUDA errors and a
collective that failed (`CollectiveError`). A CUDA fault is not
transient, and a retry would hide a kernel that fails now and then; after
a collective times out, its group's transport is closed and every later
call over it fails too. KeyboardInterrupt and SystemExit are never caught. The
counters ride one lock: the engine may be called from a worker thread
while a summary reads them from another.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple, Type

import torch

from glom_tpu_torch.kernels._build import KernelError

# torch's CUDA error types where the installed torch has them:
# AcceleratorError from a failed CUDA call inside an op, CudaError from
# the runtime bindings.
CUDA_ERRORS: Tuple[Type[BaseException], ...] = tuple(
    t for t in (getattr(torch, "AcceleratorError", None),
                getattr(torch.cuda, "CudaError", None))
    if t is not None
)


class CollectiveError(RuntimeError):
    """A torch.distributed call of a rank group failed (a timeout, a peer
    that left, a tensor the backend refuses). The group's transport is not
    to be trusted after it, so no retry goes over the same group
    (parallel/collectives.py raises it)."""


NONRETRYABLE_DEFAULT: Tuple[Type[BaseException], ...] = (
    ValueError, TypeError, KernelError, CollectiveError, *CUDA_ERRORS,
)


def validate_backoff(
    backoff_s: float, backoff_factor: float, backoff_max_s: float
) -> None:
    """Backoffs must be >= 0 and the growth factor >= 1."""
    if backoff_s < 0 or backoff_max_s < 0 or backoff_factor < 1.0:
        raise ValueError(
            f"backoff_s={backoff_s} backoff_max_s={backoff_max_s} "
            f"backoff_factor={backoff_factor}: backoffs must be >= 0 "
            "and the factor >= 1"
        )


def next_backoff(
    backoff_s: float, backoff_factor: float, backoff_max_s: float, n: int
) -> float:
    """The n-th (0-based) delay of the bounded exponential schedule:
    min(backoff_s * factor**n, backoff_max_s)."""
    return min(backoff_s * backoff_factor ** n, backoff_max_s)


class RetryPolicy:
    """Bounded exponential-backoff retry around one callable attempt."""

    def __init__(
        self,
        *,
        retries: int = 2,
        backoff_s: float = 0.025,
        backoff_factor: float = 2.0,
        backoff_max_s: float = 1.0,
        nonretryable: Optional[Tuple[Type[BaseException], ...]] = None,
        writer=None,
        sleep: Callable[[float], None] = time.sleep,
        site: str = "dispatch",
    ):
        if retries < 0:
            raise ValueError(f"retries {retries} must be >= 0")
        validate_backoff(backoff_s, backoff_factor, backoff_max_s)
        self.retries = retries
        self.backoff_s = backoff_s
        self.backoff_factor = backoff_factor
        self.backoff_max_s = backoff_max_s
        self.nonretryable = (
            nonretryable if nonretryable is not None else NONRETRYABLE_DEFAULT
        )
        self.writer = writer
        self.site = site
        self._sleep = sleep
        self._lock = threading.Lock()
        self._n_calls = 0
        self._n_retries = 0
        self._n_recovered = 0
        self._n_gave_up = 0
        self._n_fast_failed = 0

    def _emit(self, rec: dict) -> None:
        from glom_tpu_torch.resilience.faults import emit_recovery

        emit_recovery(self.writer, rec)

    def record(self) -> dict:
        """Counter snapshot for summary records (one consistent read)."""
        with self._lock:
            return {
                "retry_site": self.site,
                "n_calls": self._n_calls,
                "n_retries": self._n_retries,
                "n_recovered": self._n_recovered,
                "n_gave_up": self._n_gave_up,
                "n_fast_failed": self._n_fast_failed,
            }

    def run(self, attempt: Callable[[], object], **context):
        """Call `attempt` until it returns, the budget runs out, or the
        backend goes down. `context` (bucket, n_valid, ...) rides every
        stamped recovery event."""
        from glom_tpu_torch.telemetry.watchdog import backend_record

        with self._lock:
            self._n_calls += 1
        tries = 0
        while True:
            try:
                out = attempt()
            except self.nonretryable:
                raise
            except Exception as e:  # noqa: BLE001 (classified below)
                state = backend_record().get("backend_state", "unknown")
                if state == "down":
                    # Never retry into a dead backend.
                    with self._lock:
                        self._n_fast_failed += 1
                    raise
                if tries >= self.retries:
                    with self._lock:
                        self._n_gave_up += 1
                    raise
                tries += 1
                with self._lock:
                    self._n_retries += 1
                backoff = next_backoff(
                    self.backoff_s, self.backoff_factor, self.backoff_max_s, tries - 1
                )
                self._emit(
                    {
                        "action": "dispatch-retry",
                        "site": self.site,
                        "attempt": tries,
                        "retries_budget": self.retries,
                        "backoff_s": round(backoff, 4),
                        "backend_state": state,
                        "exception": f"{type(e).__name__}: {e}"[:300],
                        **context,
                    }
                )
                if backoff > 0:
                    self._sleep(backoff)
                continue
            if tries:
                with self._lock:
                    self._n_recovered += 1
                self._emit(
                    {
                        "action": "dispatch-recovered",
                        "site": self.site,
                        "attempts": tries + 1,
                        **context,
                    }
                )
            return out
