"""The parallel runtime: the rank mesh, DP with ZeRO 1 / 2 and the
quantized reduce, ring / Ulysses / halo sequence parallelism and
hidden-axis tensor parallelism, over torch.distributed.

Counterpart of `glom_tpu/parallel/` for training across ranks, with
glom_tpu's names. One process per rank; every collective is an explicit
call over the group of one mesh axis (`collectives.py`), and each rank
runs glom_tpu's per-shard bodies through the port's kernels
(`manual.py`). Not ported yet (ROADMAP queue A item 8b): sharded
inference (`serve_mesh.py`, `make_manual_forward`, `Glom(mesh=)`, the
engine meshes) and the EP-style `tp_axis="levels"`. `to_named` has no
counterpart (there is no GSPMD; see `sharding.py`).
"""

from glom_tpu_torch.parallel.halo import make_halo_consensus
from glom_tpu_torch.parallel.manual import (
    make_manual_loss,
    make_manual_train_step,
    make_manual_zero_train_step,
    manual_supported,
)
from glom_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
from glom_tpu_torch.parallel.ring import make_ring_consensus
from glom_tpu_torch.parallel.runtime import SP_STRATEGIES, DistributedTrainer, make_consensus_fn
from glom_tpu_torch.parallel.sharding import (
    batch_spec,
    denoise_param_specs,
    ffw_specs,
    glom_param_specs,
    levels_spec,
    opt_state_specs,
    zero_param_specs,
    zero_shard_axis,
)
from glom_tpu_torch.parallel.ulysses import make_ulysses_consensus

__all__ = [
    "make_halo_consensus",
    "make_manual_loss",
    "make_manual_train_step",
    "make_manual_zero_train_step",
    "manual_supported",
    "initialize_multihost",
    "make_mesh",
    "make_ring_consensus",
    "SP_STRATEGIES",
    "DistributedTrainer",
    "make_consensus_fn",
    "batch_spec",
    "denoise_param_specs",
    "ffw_specs",
    "glom_param_specs",
    "levels_spec",
    "opt_state_specs",
    "zero_param_specs",
    "zero_shard_axis",
    "make_ulysses_consensus",
]
