from glom_tpu_torch.utils.config import GlomConfig, ServeConfig, TrainConfig
from glom_tpu_torch.utils.helpers import (
    TOKEN_ATTEND_SELF_VALUE,
    default,
    exists,
    l2norm,
    max_neg_value,
    resolve_device,
)

__all__ = [
    "TOKEN_ATTEND_SELF_VALUE",
    "GlomConfig",
    "ServeConfig",
    "TrainConfig",
    "default",
    "exists",
    "l2norm",
    "max_neg_value",
    "resolve_device",
]
