"""Fault injection and the recovery contract training and serving are held to.

    faults      -- seedable, scoped, stamped injectors (FaultPlan, the
                   "fault"/"recovery" emitters, one injector a fault class)
    retry       -- the bounded exponential backoff contract and RetryPolicy,
                   the serving dispatch's watchdog-aware retry
    ladder      -- the serving degradation ladder (normal -> capped_iters ->
                   bucket_cap -> shed, one reversible rung at a time)
    coordinator -- pod-coordinated preemption: the two-phase save barrier,
                   gang supervision, the directory and store transports
    chaos       -- end-to-end scenarios (`python -m glom_tpu_torch.resilience`)
                   that fault-inject the port's real CLIs and verify recovery

The restart loop lives with the trainers (train/supervise.fit_supervised);
the checkpoint integrity layer and its pod mode with the checkpoints
(utils/checkpoint.py).
"""

from glom_tpu_torch.resilience.coordinator import (
    BarrierAbort,
    DirectoryTransport,
    GangRestart,
    PodCoordinator,
    StoreTransport,
    peer_host_dirs,
    pod_preemption_save,
    read_pod_commit,
)
from glom_tpu_torch.resilience.faults import (
    FaultPlan,
    InjectedFault,
    barrier_delay,
    dispatch_fault,
    emit_fault,
    emit_recovery,
    message_loss,
    nan_storm,
    probe_flap,
    queue_stall,
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
    "BarrierAbort",
    "DegradationLadder",
    "DirectoryTransport",
    "FaultPlan",
    "GangRestart",
    "InjectedFault",
    "PodCoordinator",
    "RUNGS",
    "RetryPolicy",
    "StoreTransport",
    "barrier_delay",
    "class_rungs",
    "dispatch_fault",
    "emit_fault",
    "emit_recovery",
    "message_loss",
    "nan_storm",
    "next_backoff",
    "peer_host_dirs",
    "pod_preemption_save",
    "probe_flap",
    "queue_stall",
    "read_pod_commit",
    "spawn_fault",
    "truncate_newest_checkpoint",
    "validate_backoff",
]
