"""Consensus attention: same-level attention across all columns (patches).

Counterpart of `glom_tpu/ops/consensus.py`. Reference parity:
ConsensusAttention (glom_pytorch/glom_pytorch.py:36-71):

  * no learned projections: q = levels, k = l2norm(levels), v = levels;
    the scale is d^-1/2;
  * each of the L levels attends over the n patch positions on its own;
  * attend_self=False REPLACES the diagonal similarity with -5e-4;
  * local_consensus_radius > 0 hard-masks pairs farther than the radius in
    Euclidean patch-grid distance with -finfo(float32).max.

This dense form materializes the [b, L, n, n] similarity; the fused kernel
(glom_tpu_torch/kernels/consensus_update.py) is held against it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from glom_tpu_torch.utils.helpers import TOKEN_ATTEND_SELF_VALUE, l2norm, max_neg_value


def build_local_mask(num_patches_side: int, radius: float) -> Optional[np.ndarray]:
    """Static [n, n] boolean mask; True = NON-local pair (to be hard-masked).
    Mirrors the reference's meshgrid -> cdist -> (dist > radius) buffer."""
    if radius <= 0:
        return None
    side = num_patches_side
    hs, ws = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    coords = np.stack([hs, ws], axis=-1).reshape(-1, 2).astype(np.float64)
    dist = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
    return dist > radius


def iota_local_mask(
    n: int, side: int, radius: float, device=None
) -> Optional[torch.Tensor]:
    """The same [n, n] mask (True = non-local) built on `device` from index
    arithmetic, with no host buffer."""
    if radius <= 0:
        return None
    idx = torch.arange(n, dtype=torch.int32, device=device)
    hi, wi = idx // side, idx % side
    dh = (hi[:, None] - hi[None, :]).to(torch.float32)
    dw = (wi[:, None] - wi[None, :]).to(torch.float32)
    return dh * dh + dw * dw > radius * radius


def consensus_attention(
    levels: torch.Tensor,
    *,
    attend_self: bool = False,
    local_mask=None,
    side: Optional[int] = None,
    radius: float = 0.0,
    compute_dtype=None,
) -> torch.Tensor:
    """Dense consensus attention: levels [b, n, L, d] -> [b, n, L, d].

    local_mask: optional [n, n] bool (numpy or torch), True = masked out.
    Alternatively pass (side, radius) to build the same mask on the device.
    """
    if compute_dtype is not None:
        levels = levels.to(compute_dtype)
    b, n, L, d = levels.shape
    if local_mask is None and side is not None and radius > 0:
        local_mask = iota_local_mask(n, side, radius, device=levels.device)
    f32 = torch.float32
    q = levels
    k = l2norm(levels, dim=-1)
    v = levels

    sim = torch.einsum("bild,bjld->blij", q.to(f32), k.to(f32)) * d ** -0.5
    if not attend_self:
        eye = torch.eye(n, dtype=torch.bool, device=levels.device)
        sim = sim.masked_fill(eye, TOKEN_ATTEND_SELF_VALUE)
    if local_mask is not None:
        mask = torch.as_tensor(local_mask, device=levels.device)
        sim = sim.masked_fill(mask, max_neg_value(f32))

    attn = torch.softmax(sim, dim=-1).to(levels.dtype)
    out = torch.einsum("blij,bjld->bild", attn.to(f32), v.to(f32))
    return out.to(levels.dtype)
