from glom_tpu_torch.train.objectives import (
    DenoiseParams,
    default_recon_index,
    denoise_loss,
    init_denoise,
    reconstruct,
)
from glom_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    accumulate_grads,
    create_train_state,
    default_optimizer,
    fit_loop,
    make_lr_schedule,
    make_train_step,
    pinned_grad_accum,
    resolve_route_keys,
    resolve_training_route,
)

__all__ = [
    "DenoiseParams",
    "TrainState",
    "Trainer",
    "accumulate_grads",
    "create_train_state",
    "default_optimizer",
    "default_recon_index",
    "denoise_loss",
    "fit_loop",
    "init_denoise",
    "make_lr_schedule",
    "make_train_step",
    "pinned_grad_accum",
    "reconstruct",
    "resolve_route_keys",
    "resolve_training_route",
]
