"""Fault injection and the recovery contract training and serving are held to.

    faults -- seedable, scoped, stamped injectors (FaultPlan, the
              "fault"/"recovery" emitters, a poisoned batch, a failing
              dispatch, a failing elastic spawn, a torn checkpoint)
    retry  -- the bounded exponential backoff contract and RetryPolicy,
              the serving dispatch's watchdog-aware retry
    ladder -- the serving degradation ladder (normal -> capped_iters ->
              bucket_cap -> shed, one reversible rung at a time)

The restart loop lives with the trainers (train/supervise.fit_supervised);
the checkpoint integrity layer with the checkpoints (utils/checkpoint.py).
glom_tpu's chaos scenarios and pod coordinator are ROADMAP queue A
item 9.
"""

from glom_tpu_torch.resilience.faults import (
    FaultPlan,
    InjectedFault,
    dispatch_fault,
    emit_fault,
    emit_recovery,
    nan_storm,
    spawn_fault,
    truncate_newest_checkpoint,
)
from glom_tpu_torch.resilience.ladder import (
    RUNGS,
    DegradationLadder,
    class_rungs,
)
from glom_tpu_torch.resilience.retry import RetryPolicy, next_backoff, validate_backoff

__all__ = [
    "DegradationLadder",
    "FaultPlan",
    "InjectedFault",
    "RUNGS",
    "RetryPolicy",
    "class_rungs",
    "dispatch_fault",
    "emit_fault",
    "emit_recovery",
    "nan_storm",
    "next_backoff",
    "spawn_fault",
    "truncate_newest_checkpoint",
    "validate_backoff",
]
