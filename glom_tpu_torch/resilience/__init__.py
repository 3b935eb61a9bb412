"""Fault injection and the recovery contract the training side is held to.

    faults -- seedable, scoped, stamped injectors (FaultPlan, the
              "fault"/"recovery" emitters, a poisoned batch, a failing
              dispatch, a torn checkpoint)
    retry  -- the bounded exponential backoff contract

The restart loop lives with the trainers (train/supervise.fit_supervised);
the checkpoint integrity layer with the checkpoints (utils/checkpoint.py).
glom_tpu's degradation ladder, chaos scenarios and pod coordinator are
ROADMAP queue A items 7 and 9.
"""

from glom_tpu_torch.resilience.faults import (
    FaultPlan,
    InjectedFault,
    dispatch_fault,
    emit_fault,
    emit_recovery,
    nan_storm,
    truncate_newest_checkpoint,
)
from glom_tpu_torch.resilience.retry import next_backoff, validate_backoff

__all__ = [
    "FaultPlan",
    "InjectedFault",
    "dispatch_fault",
    "emit_fault",
    "emit_recovery",
    "nan_storm",
    "next_backoff",
    "truncate_newest_checkpoint",
    "validate_backoff",
]
