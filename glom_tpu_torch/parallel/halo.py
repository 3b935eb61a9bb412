"""Halo-exchange consensus for the local-radius path.

Counterpart of `glom_tpu/parallel/halo.py`. With a local radius r > 0 a
patch attends only within r grid rows / cols, so with the patch grid
sharded into contiguous ROW BANDS over 'seq', each rank needs exactly
floor(r) rows from each neighbour (grid distances are integers), not the
whole ring: one differentiable neighbour exchange of k and v
(`collectives.halo_exchange`) instead of S ring steps. Requires
rows_per_shard >= floor(r) (`helpers.halo_supported`); use the ring for
larger radii or finer shardings.

Out-of-image halo slots (the top rank's upper halo, the bottom rank's
lower halo) arrive zero-filled and are hard-masked by their global
indices, so they contribute exactly zero attention.
"""

from __future__ import annotations

import math

import torch

from glom_tpu_torch.parallel.collectives import Axis, all_gather, halo_exchange
from glom_tpu_torch.parallel.ring import _block_sim_masks
from glom_tpu_torch.utils.helpers import halo_supported, l2norm


def check_halo(seq: int, side: int, radius: float) -> None:
    """Raise where glom_tpu's make_halo_consensus raises."""
    if halo_supported(seq, side, radius):
        return
    if radius <= 0:
        raise ValueError("halo consensus requires local_consensus_radius > 0")
    if side % seq != 0:
        raise ValueError(f"grid side {side} not divisible by seq axis {seq}")
    raise ValueError(
        f"radius {radius} needs {math.floor(radius)} halo rows but shards "
        f"only hold {side // seq}; use ring consensus instead"
    )


def halo_consensus_shard(x: torch.Tensor, *, axis: Axis, attend_self: bool, side: int,
                         radius: float) -> torch.Tensor:
    """Per-rank body (n sharded over `axis` in row-major row bands):
    x [b, n_loc, L, d] -> [b, n_loc, L, d], f32 inside."""
    b, n_loc, L, d = x.shape
    n_total = n_loc * axis.size
    # A patch within Euclidean distance r is at most floor(r) rows away.
    h = min(int(math.floor(radius)), n_loc // side) * side  # halo size in patches
    q = x.to(torch.float32)
    k_loc, v_loc = l2norm(q), q
    if h > 0:
        k_ext, v_ext = halo_exchange(k_loc, axis, h), halo_exchange(v_loc, axis, h)
    else:
        # radius < 1: no cross-shard pair is within reach.
        k_ext, v_ext = k_loc, v_loc
    i_offset = axis.index * n_loc
    sim = torch.einsum("bild,bjld->blij", q, k_ext) * d ** -0.5
    sim = _block_sim_masks(sim, i_offset, i_offset - h, n_loc, n_loc + 2 * h,
                           attend_self=attend_self, side=side, radius=radius, n_total=n_total)
    out = torch.einsum("blij,bjld->blid", sim.softmax(dim=-1), v_ext)
    return out.permute(0, 2, 1, 3).to(x.dtype)


def make_halo_consensus(axis: Axis, *, attend_self: bool, side: int, radius: float):
    """A global-view consensus_fn for the local-radius path (each rank runs
    its band, then the bands are all-gathered). Checks the one-hop halo
    precondition first."""
    check_halo(axis.size, side, radius)

    def fn(levels: torch.Tensor) -> torch.Tensor:
        n_loc = levels.shape[1] // axis.size
        band = levels[:, axis.index * n_loc:(axis.index + 1) * n_loc]
        out = halo_consensus_shard(band, axis=axis, attend_self=attend_self, side=side,
                                   radius=radius)
        return all_gather(out, axis, dim=1)

    return fn
