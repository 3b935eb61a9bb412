"""Ring consensus: exact sequence-parallel consensus attention.

Counterpart of `glom_tpu/parallel/ring.py`. The patch axis n is sharded
over the 'seq' axis in contiguous bands; each step every rank attends its
local queries to the k / v block it holds, then passes the block to rank
p - 1 and takes rank p + 1's (`collectives.ring_shift`), accumulating with
an online softmax. After S steps every query has seen every key.

Mask parity with the dense op, from global offsets:
  * self mask: the global diagonal REPLACED with -5e-4 (soft);
  * local radius: hard -finfo.max beyond the Euclidean patch-grid radius,
    integer-exact (squared distances against radius^2).

torch's point-to-point calls are not differentiable, so the shard body is
one autograd Function with the blockwise attention backward written out:
it rotates the k / v blocks around the ring again, recomputes each
block's probabilities from the saved log-sum-exp, and lets each block's
dk and dv travel with it, so they arrive home after S steps. Memory is
O(n_loc * n_loc) a step, in both directions.
"""

from __future__ import annotations

import torch

from glom_tpu_torch.parallel.collectives import Axis, all_gather, ring_shift
from glom_tpu_torch.utils.helpers import TOKEN_ATTEND_SELF_VALUE, l2norm

NEG_MAX = -torch.finfo(torch.float32).max


def _block_masks(i_offset: int, j_offset: int, n_i: int, n_j: int, *, attend_self: bool,
                 side: int, radius: float, n_total: int, device):
    """(self mask or None, invalid mask), [n_i, n_j] bools, for a block
    whose rows / cols sit at global offsets i_offset / j_offset."""
    idx_i = i_offset + torch.arange(n_i, device=device)[:, None]
    idx_j = j_offset + torch.arange(n_j, device=device)[None, :]
    eye = None if attend_self else idx_i == idx_j
    invalid = (idx_j < 0) | (idx_j >= n_total)  # out-of-image halo positions
    if radius > 0:
        dist2 = (idx_i // side - idx_j // side) ** 2 + (idx_i % side - idx_j % side) ** 2
        invalid = invalid | (dist2.to(torch.float32) > radius * radius)
    return eye, invalid


def _block_sim_masks(sim: torch.Tensor, i_offset: int, j_offset: int, n_i: int, n_j: int, *,
                     attend_self: bool, side: int, radius: float, n_total: int) -> torch.Tensor:
    """Apply the self / local / validity masks to one [b, L, n_i, n_j] sim
    block (glom_tpu's `_block_sim_masks`)."""
    eye, invalid = _block_masks(i_offset, j_offset, n_i, n_j, attend_self=attend_self,
                                side=side, radius=radius, n_total=n_total, device=sim.device)
    if eye is not None:
        sim = sim.masked_fill(eye, TOKEN_ATTEND_SELF_VALUE)
    return sim.masked_fill(invalid, NEG_MAX)


def _norm_vjp(dk: torch.Tensor, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The VJP of l2norm(x) (x / max(||x||, eps)) along the last axis."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    nc = norm.clamp_min(eps)
    k = x / nc
    inner = (dk * k).sum(-1, keepdim=True)
    return torch.where(norm > eps, (dk - k * inner) / nc, dk / nc)


class _RingConsensus(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, attend_self, side, radius):
        S, my = axis.size, axis.index
        b, n_loc, L, d = x.shape
        geo = dict(attend_self=attend_self, side=side, radius=radius, n_total=n_loc * S)
        scale = d ** -0.5
        q = x.to(torch.float32).permute(0, 2, 1, 3)  # [b, L, n_loc, d]
        k_blk, v_blk = l2norm(q), q
        m = torch.full((b, L, n_loc, 1), NEG_MAX, dtype=torch.float32, device=x.device)
        s = torch.zeros_like(m)
        o = torch.zeros_like(q)
        for r in range(S):
            # Post the next rotation before this step's products (the
            # blocks are not written, so the transfer reads them as is).
            nxt = ring_shift([k_blk, v_blk], axis) if r < S - 1 else None
            sim = q @ k_blk.transpose(-1, -2) * scale
            sim = _block_sim_masks(sim, my * n_loc, ((my + r) % S) * n_loc, n_loc, n_loc, **geo)
            m_new = torch.maximum(m, sim.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(sim - m_new)
            s = s * corr + p.sum(-1, keepdim=True)
            o = o * corr + p @ v_blk
            m = m_new
            if nxt is not None:
                k_blk, v_blk = nxt
        out = o / s
        ctx.save_for_backward(q, out, m + torch.log(s))
        ctx.args = (axis, geo)
        return out.permute(0, 2, 1, 3).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        q, out, lse = ctx.saved_tensors
        axis, geo = ctx.args
        S, my = axis.size, axis.index
        b, L, n_loc, d = q.shape
        scale = d ** -0.5
        do = g.to(torch.float32).permute(0, 2, 1, 3)
        delta = (do * out).sum(-1, keepdim=True)
        k0 = l2norm(q)
        k_blk, v_blk = k0, q
        dk_blk, dv_blk = torch.zeros_like(q), torch.zeros_like(q)
        dq = torch.zeros_like(q)
        for r in range(S):
            i_off, j_off = my * n_loc, ((my + r) % S) * n_loc
            sim = q @ k_blk.transpose(-1, -2) * scale
            sim = _block_sim_masks(sim, i_off, j_off, n_loc, n_loc, **geo)
            p = torch.exp(sim - lse)
            dv_blk = dv_blk + p.transpose(-1, -2) @ do
            ds = p * (do @ v_blk.transpose(-1, -2) - delta)
            # Replaced and masked scores are constants: no gradient.
            eye, invalid = _block_masks(i_off, j_off, n_loc, n_loc, device=q.device, **geo)
            ds = ds.masked_fill(invalid if eye is None else invalid | eye, 0.0)
            dq = dq + ds @ k_blk * scale
            dk_blk = dk_blk + ds.transpose(-1, -2) @ q * scale
            # dk / dv travel with their block: after S shifts they are home.
            if r < S - 1:
                k_blk, v_blk, dk_blk, dv_blk = ring_shift([k_blk, v_blk, dk_blk, dv_blk], axis)
            else:
                dk_blk, dv_blk = ring_shift([dk_blk, dv_blk], axis)
        dx = dq + dv_blk + _norm_vjp(dk_blk, q)
        return dx.permute(0, 2, 1, 3).to(g.dtype), None, None, None, None


def ring_consensus_shard(x: torch.Tensor, *, axis: Axis, attend_self: bool, side: int,
                         radius: float) -> torch.Tensor:
    """Per-rank body: x [b, n_loc, L, d], this rank's band of the patch
    axis sharded over `axis` -> [b, n_loc, L, d]. f32 inside."""
    return _RingConsensus.apply(x, axis, bool(attend_self), int(side), float(radius))


def make_ring_consensus(axis: Axis, *, attend_self: bool, side: int, radius: float = 0.0):
    """A global-view consensus_fn [b, n, L, d] -> [b, n, L, d]: each rank
    takes the full levels, runs the ring on its band and all-gathers the
    bands (so callers can compare whole arrays). Drop-in for
    glom_forward(consensus_fn=...)."""

    def fn(levels: torch.Tensor) -> torch.Tensor:
        n_loc = levels.shape[1] // axis.size
        band = levels[:, axis.index * n_loc:(axis.index + 1) * n_loc]
        out = ring_consensus_shard(band, axis=axis, attend_self=attend_self, side=side,
                                   radius=radius)
        return all_gather(out, axis, dim=1)

    return fn
