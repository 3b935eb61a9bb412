"""The rank mesh and process-group bring-up.

Counterpart of `glom_tpu/parallel/mesh.py`. glom_tpu lays a named `Mesh`
over the chips of one program; the port runs one process per rank and
lays a `torch.distributed.device_mesh.DeviceMesh` of shape (data, seq,
model) over the ranks, with glom_tpu's axis names:

  data  -- batch sharding (DP): the gradient reduction
  seq   -- patch-axis sharding (SP): ring / halo / all-to-all consensus
  model -- hidden-axis sharding (TP) of the grouped-FFW weights

Ranks are laid out row-major over (data, seq, model), so the model axis
is innermost; a multi-slice mesh (num_slices > 1) keeps the same layout,
which puts the slice split on the outermost part of the data axis
(slice-major, as glom_tpu lays out devices).

Each rank runs on one device: `cuda:LOCAL_RANK` unless the caller passes
the devices (one per rank, by global rank; ranks that share a card pass
["cuda:0"] * world). A rank whose LOCAL_RANK has no card raises; nothing
lands on the CPU unless a CPU device is passed. The backend is explicit:
"nccl" by default for CUDA devices, "gloo" for the CPU, and nothing
switches backends after a failure.

The mesh's groups are made here, one `new_group` a line of each axis, with
the collective timeout GROUP_TIMEOUT_S, and never reuse the default group.
So a rank that fails before a step's all-reduce leaves its peers an error
after GROUP_TIMEOUT_S, not a hang, and a mesh made after that (a supervised
gang's next attempt, train/cli.py `--distributed --supervise`) runs on
groups the failure never touched.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from glom_tpu_torch.utils.config import MeshConfig

BACKENDS = ("nccl", "gloo")
# Every rank mesh's collective timeout, in seconds: long enough for a rank
# that builds the kernels on its first step while its peers wait.
GROUP_TIMEOUT_S = 300


def default_backend(device) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(devices: Optional[Sequence] = None, rank: Optional[int] = None) -> torch.device:
    """This rank's device: `devices[rank]` when the caller passes them,
    else cuda:LOCAL_RANK, which must exist."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", 0))
    if devices is not None:
        if rank >= len(devices):
            raise ValueError(f"rank {rank} has no device in {list(devices)}")
        device = torch.device(devices[rank])
    else:
        local = int(os.environ.get("LOCAL_RANK", rank))
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} has no CUDA device (count "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}); "
                "pass devices=[...] (\"cuda:0\" for every rank to share one card, "
                "\"cpu\" for the CPU)"
            )
        device = torch.device("cuda", local)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu', ...]")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    init_method: Optional[str] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Bring up the default process group (glom_tpu's jax.distributed
    initialize, as `torch.distributed.init_process_group`).

    The rendezvous is `init_method` (e.g. "file:///shared/path" or
    "tcp://host:port"), else tcp://`coordinator_address`, else torchrun's
    env (MASTER_ADDR, RANK, WORLD_SIZE); the world size and rank come from
    the arguments or RANK / WORLD_SIZE. The backend defaults by `device`
    (this rank's device; its default is `rank_device()`). A no-op that
    returns False when the group is already up, or when nothing names a
    rendezvous (one process, as glom_tpu's single host); True when it
    initialized the group."""
    if dist.is_initialized():
        return False
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None:
        return False
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    device = rank_device(rank=rank) if device is None else torch.device(device)
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kw)
    return True


def make_mesh(
    cfg: MeshConfig, devices: Optional[Sequence] = None, backend: Optional[str] = None
) -> Tuple[DeviceMesh, torch.device]:
    """(DeviceMesh of shape (data, seq, model) over every rank on groups
    of its own (see the module docstring), this rank's device). Brings the
    process group up from the environment when it is not up yet; its
    backend must be `backend` when one is named."""
    device = rank_device(devices)
    initialize_multihost(backend=backend, device=device)
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call initialize_multihost(init_method=..., "
            "num_processes=..., process_id=...) or launch under torch.distributed.run"
        )
    if backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, not {backend!r}")
    world = dist.get_world_size()
    if cfg.num_devices != world:
        raise ValueError(f"mesh {cfg.shape} needs {cfg.num_devices} ranks, the world has {world}")
    if cfg.num_slices > 1 and world % cfg.num_slices:
        raise ValueError(f"{world} ranks do not split into {cfg.num_slices} slices")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # Row-major over (data, seq, model): also slice-major for a hybrid mesh,
    # since the data axis is outermost. Every rank makes every line's group,
    # in the same order, and keeps its own line of each axis.
    ranks = torch.arange(world).reshape(cfg.shape)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    mine = []
    for dim, size in enumerate(cfg.shape):
        for line in ranks.movedim(dim, -1).reshape(-1, size).tolist():
            group = dist.new_group(ranks=line, timeout=timeout)
            if dist.get_rank() in line:
                mine.append(group)
    mesh = DeviceMesh.from_group(mine, device.type, mesh=ranks, mesh_dim_names=cfg.axis_names)
    return mesh, device


def replica_device_groups(devices: list, per_replica: int) -> list:
    """Partition `devices` into contiguous groups of `per_replica`, one
    group per serving engine replica (glom_tpu's, as it is); leftover
    devices beyond the last full group are unused."""
    if per_replica < 1:
        raise ValueError(f"per_replica {per_replica} must be >= 1")
    n_groups = len(devices) // per_replica
    if n_groups < 1:
        raise ValueError(f"{len(devices)} devices cannot host a {per_replica}-device replica")
    return [devices[i * per_replica : (i + 1) * per_replica] for i in range(n_groups)]
