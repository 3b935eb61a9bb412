"""The bounded exponential backoff contract.

The port's copy of `validate_backoff` and `next_backoff` from
`glom_tpu/resilience/retry.py`: one definition of what a valid backoff is
and of its n-th delay, for every policy that backs off (the training
restart loop, train/supervise.TrainSupervisor). glom_tpu's RetryPolicy
wraps serving dispatches and comes with the serving stack (ROADMAP queue A
item 7).
"""

from __future__ import annotations


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
