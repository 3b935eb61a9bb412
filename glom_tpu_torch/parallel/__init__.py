"""The parallel runtime: the rank mesh, DP with ZeRO 1 / 2 and the
quantized reduce, ring / Ulysses / halo sequence parallelism and
hidden-axis tensor parallelism, over torch.distributed.

Counterpart of `glom_tpu/parallel/`, with glom_tpu's names: training
across ranks, and sharded inference (`make_manual_forward`, which
`Glom(mesh=)` runs; `serve_mesh.py`, the serving engine's per-rank
forward over a `ServeMesh`; the engine meshes). One process per rank;
every collective is an explicit call over the group of one mesh axis
(`collectives.py`), and each rank runs glom_tpu's per-shard bodies
through the port's kernels (`manual.py`), with tensor parallelism on the
hidden axis or, EP-style, on bottom_up's level groups (`tp_axis`).
`to_named` and `serve_shardings` have no counterpart (there is no GSPMD; see
`sharding.py` and `serve_mesh.py`).
"""

from glom_tpu_torch.parallel.halo import make_halo_consensus
from glom_tpu_torch.parallel.manual import (
    make_manual_forward,
    make_manual_loss,
    make_manual_train_step,
    make_manual_zero_train_step,
    manual_supported,
)
from glom_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
from glom_tpu_torch.parallel.ring import make_ring_consensus
from glom_tpu_torch.parallel.runtime import (
    SP_STRATEGIES,
    DistributedTrainer,
    engine_mesh_for,
    make_consensus_fn,
    make_engine_meshes,
)
from glom_tpu_torch.parallel.serve_mesh import ServeMesh, make_serve_forward, make_serve_mesh
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
    "make_manual_forward",
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
    "make_engine_meshes",
    "engine_mesh_for",
    "ServeMesh",
    "make_serve_forward",
    "make_serve_mesh",
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
