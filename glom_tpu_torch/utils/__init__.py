from glom_tpu_torch.utils.config import GlomConfig, MeshConfig, ServeConfig, TrainConfig
from glom_tpu_torch.utils.helpers import (
    TOKEN_ATTEND_SELF_VALUE,
    default,
    exists,
    halo_supported,
    l2norm,
    max_neg_value,
    resolve_device,
)

__all__ = [
    "TOKEN_ATTEND_SELF_VALUE",
    "GlomConfig",
    "MeshConfig",
    "ServeConfig",
    "TrainConfig",
    "default",
    "exists",
    "halo_supported",
    "l2norm",
    "max_neg_value",
    "resolve_device",
]
