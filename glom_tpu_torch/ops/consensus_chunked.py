"""Chunked (online-softmax) consensus attention: single-device long rows.

The port's copy of `glom_tpu/ops/consensus_chunked.py`. The dense op
(ops/consensus.py) materializes [b, L, n, n]; at n = 4096 that is 64 MiB a
(image, level) in f32. This variant loops over key/value chunks with a
running (max, sumexp, out) accumulator — flash-attention's recurrence — so
memory is O(n * chunk) while keeping the consensus contract:

  * k-only L2 normalization, d^-1/2 scale;
  * the soft -5e-4 self value (the diagonal REPLACED), computed per chunk
    from global column indices;
  * the hard -finfo.max local-radius mask from integer squared distances.

A plain PyTorch loop, differentiable by autograd. A chunk size that does
not divide n leaves a shorter last chunk, where glom_tpu's `lax.scan` needs
equal chunks and raises. Only tests call it, as in glom_tpu: the serving
and training paths run the kernels (K2, K4).
"""

from __future__ import annotations

from typing import Optional

import torch

from glom_tpu_torch.utils.helpers import TOKEN_ATTEND_SELF_VALUE, l2norm


def chunked_consensus_attention(
    levels: torch.Tensor,
    *,
    attend_self: bool = False,
    num_patches_side: Optional[int] = None,
    local_radius: float = 0.0,
    chunk_size: int = 512,
) -> torch.Tensor:
    """[b, n, L, d] -> [b, n, L, d] without materializing the n x n matrix.

    `num_patches_side` is required when local_radius > 0 (grid geometry).
    """
    b, n, L, d = levels.shape
    if chunk_size < 1:
        raise ValueError(f"chunk_size={chunk_size} must be >= 1")
    if local_radius > 0 and num_patches_side is None:
        raise ValueError("num_patches_side required when local_radius > 0")
    f32 = torch.float32
    neg_max = -torch.finfo(f32).max
    dev = levels.device

    x32 = levels.to(f32)
    q = x32
    k = l2norm(x32, dim=-1)
    v = x32
    scale = d ** -0.5
    idx_i = torch.arange(n, dtype=torch.int32, device=dev)[:, None]  # global query index

    m = torch.full((b, L, n, 1), neg_max, dtype=f32, device=dev)
    s = torch.zeros((b, L, n, 1), dtype=f32, device=dev)
    o = torch.zeros((b, L, n, d), dtype=f32, device=dev)
    for c0 in range(0, n, chunk_size):
        c1 = min(c0 + chunk_size, n)
        sim = torch.einsum("bild,bjld->blij", q, k[:, c0:c1]) * scale  # [b, L, n, chunk]
        idx_j = torch.arange(c0, c1, dtype=torch.int32, device=dev)[None, :]
        if not attend_self:
            sim = sim.masked_fill(idx_i == idx_j, TOKEN_ATTEND_SELF_VALUE)
        if local_radius > 0:
            side = num_patches_side
            ri, ci = idx_i // side, idx_i % side
            rj, cj = idx_j // side, idx_j % side
            dist2 = ((ri - rj) ** 2 + (ci - cj) ** 2).to(f32)
            sim = sim.masked_fill(dist2 > local_radius * local_radius, neg_max)
        m_new = torch.maximum(m, sim.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(sim - m_new)
        s = s * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.einsum("blij,bjld->blid", p, v[:, c0:c1])
        m = m_new
    out = o / s  # [b, L, n, d]
    return out.permute(0, 2, 1, 3).to(levels.dtype)
