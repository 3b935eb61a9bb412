"""Ulysses-style sequence parallelism for consensus attention.

Counterpart of `glom_tpu/parallel/ulysses.py`. Consensus attention is
independent per level (sim is [b, L, n, n] with no cross-level terms), so
L plays the role heads play in Ulysses: an all-to-all over 'seq' trades
the n-sharding for an L-sharding, each rank runs the dense attention over
the FULL patch axis for its L/S levels, and the inverse all-to-all
restores the n-sharding. Exact, two collectives a call. Both all-to-alls
are differentiable (`collectives.all_to_all`), and the dense attention
between them runs under autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from glom_tpu_torch.ops.consensus import consensus_attention
from glom_tpu_torch.parallel.collectives import Axis, all_gather, all_to_all


def ulysses_consensus_shard(x: torch.Tensor, *, axis: Axis, attend_self: bool,
                            side: Optional[int] = None, radius: float = 0.0) -> torch.Tensor:
    """Per-rank body: x [b, n_loc, L, d] -> [b, n_loc, L, d]; needs S | L.
    The local-radius mask is built on the device from (side, radius)."""
    L = x.shape[2]
    if L % axis.size != 0:
        raise ValueError(f"Ulysses needs levels ({L}) divisible by mesh axis ({axis.size})")
    y = all_to_all(x, axis, split_dim=2, concat_dim=1)  # [b, n, L/S, d]
    out = consensus_attention(y, attend_self=attend_self, side=side, radius=radius)
    return all_to_all(out, axis, split_dim=1, concat_dim=2)  # [b, n_loc, L, d]


def make_ulysses_consensus(axis: Axis, *, attend_self: bool, side: Optional[int] = None,
                           radius: float = 0.0):
    """A global-view consensus_fn [b, n, L, d] -> [b, n, L, d] (each rank
    runs its band, then the bands are all-gathered)."""

    def fn(levels: torch.Tensor) -> torch.Tensor:
        n_loc = levels.shape[1] // axis.size
        band = levels[:, axis.index * n_loc:(axis.index + 1) * n_loc]
        out = ulysses_consensus_shard(band, axis=axis, attend_self=attend_self, side=side,
                                      radius=radius)
        return all_gather(out, axis, dim=1)

    return fn
