"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Importing this package builds nothing: each wrapper compiles its source
with nvcc on its first launch (see `_build.py`)."""

from glom_tpu_torch.kernels.banded_consensus import banded_ragged_consensus
from glom_tpu_torch.kernels.consensus_update import fused_consensus_update
from glom_tpu_torch.kernels.fused_loop import fused_glom_loop, loop_supported
from glom_tpu_torch.kernels.grouped_mlp import fused_grouped_ffw, fused_grouped_ffw_lm

__all__ = [
    "banded_ragged_consensus",
    "fused_consensus_update",
    "fused_glom_loop",
    "fused_grouped_ffw",
    "fused_grouped_ffw_lm",
    "loop_supported",
]
