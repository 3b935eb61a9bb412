"""Training diagnostics computed on the device, beside the step.

Counterpart of the part of `glom_tpu/telemetry/diagnostics.py` that the
single-device train step calls: the telemetry-level resolution, the
grad/update/param norms and the NaN/Inf guard. The guard is one scalar: a
non-finite gradient anywhere makes the grad norm non-finite, so
`isfinite(loss + grad_norm)` covers every leaf. Under the "skip" policy,
`guard_update` keeps the previous value of every parameter and optimizer
state tensor with `torch.where`, so the step reads no flag on the host.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

TELEMETRY_LEVELS = ("off", "scalars", "full")
NONFINITE_POLICIES = ("skip", "warn")


def resolve_telemetry_level(tcfg) -> str:
    """The effective telemetry level, validated (the one resolution source
    the trainer stamps)."""
    level = tcfg.telemetry_level
    if level not in TELEMETRY_LEVELS:
        raise ValueError(f"telemetry_level={level!r}: one of {TELEMETRY_LEVELS}")
    if tcfg.nonfinite_policy not in NONFINITE_POLICIES:
        raise ValueError(
            f"nonfinite_policy={tcfg.nonfinite_policy!r}: one of {NONFINITE_POLICIES}"
        )
    return level


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element, in f32 (optax's
    global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def nonfinite_flag(loss: torch.Tensor, grad_norm: torch.Tensor) -> torch.Tensor:
    """True when the loss or any gradient element is non-finite."""
    return ~torch.isfinite(loss.float() + grad_norm.float())


def guard_update(
    nonfinite: torch.Tensor, new: List[torch.Tensor], old: List[torch.Tensor]
) -> List[torch.Tensor]:
    """Skip-step policy: where the step was non-finite, the old value of
    every tensor (parameters AND optimizer state -- a poisoned Adam moment
    would re-emit the NaN on the next healthy step)."""
    return [
        torch.where(nonfinite.to(n.device), o, n) for n, o in zip(new, old)
    ]


def scalar_taps(*, loss, grad_norm, updates, params) -> dict:
    """The "scalars" bundle: update and param norms plus the non-finite
    flag (grad_norm rides in from the caller)."""
    return {
        "grad_norm": grad_norm,
        "update_norm": global_norm(updates),
        "param_norm": global_norm(params),
        "nonfinite": nonfinite_flag(loss, grad_norm),
    }
