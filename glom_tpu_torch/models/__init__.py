from glom_tpu_torch.models.api import Glom
from glom_tpu_torch.models.core import (
    GlomParams,
    contribution_divisor,
    glom_forward,
    init_glom,
    map_params,
    update_step,
)
from glom_tpu_torch.models.transplant import params_from_numpy

__all__ = [
    "Glom",
    "GlomParams",
    "contribution_divisor",
    "glom_forward",
    "init_glom",
    "map_params",
    "params_from_numpy",
    "update_step",
]
