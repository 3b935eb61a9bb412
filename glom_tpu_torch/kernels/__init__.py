"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Importing this package builds nothing: each wrapper compiles its source
with nvcc on its first launch (see `_build.py`)."""

from glom_tpu_torch.kernels.consensus_update import fused_consensus_update
from glom_tpu_torch.kernels.grouped_mlp import fused_grouped_ffw_lm

__all__ = ["fused_consensus_update", "fused_grouped_ffw_lm"]
