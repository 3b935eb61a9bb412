"""Grouped per-level feed-forward network.

Counterpart of `glom_tpu/ops/ffw.py`. Reference parity: GroupedFeedForward
(glom_pytorch/glom_pytorch.py:21-34), one independent d -> d*mult -> d MLP
per level, written as batched einsums over stacked per-level weights:

    h   = gelu(einsum('...gd,gdf->...gf', x, w1) + b1)
    out =      einsum('...gf,gfd->...gd', h, w2) + b2

with w1 [G, d, f] and w2 [G, f, d]. The GELU is the exact (erf) form and
both contractions accumulate in float32 (the operands are upcast, which is
exact), rounding to the input dtype after each, as the reference does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class GroupedFFWParams(NamedTuple):
    """Per-group MLP weights. Leading axis = group (level)."""

    w1: torch.Tensor  # [G, d, d*mult]
    b1: torch.Tensor  # [G, d*mult]
    w2: torch.Tensor  # [G, d*mult, d]
    b2: torch.Tensor  # [G, d]


def init_grouped_ffw(
    groups: int,
    dim: int,
    mult: int = 4,
    *,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
) -> GroupedFFWParams:
    """Fan-in-scaled uniform init (torch Conv1d's default family:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with the per-group fan-in)."""
    hidden = dim * mult

    def u(s, *shape):
        return torch.rand(*shape, generator=generator, dtype=dtype) * (2 * s) - s

    s1 = 1.0 / math.sqrt(dim)
    s2 = 1.0 / math.sqrt(hidden)
    return GroupedFFWParams(
        w1=u(s1, groups, dim, hidden),
        b1=u(s1, groups, hidden),
        w2=u(s2, groups, hidden, dim),
        b2=u(s2, groups, dim),
    )


def grouped_ffw(
    params: GroupedFFWParams, x: torch.Tensor, *, compute_dtype=None
) -> torch.Tensor:
    """x: [..., G, d] -> [..., G, d], no mixing across the G axis."""
    w1, b1, w2, b2 = params
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w1, b1, w2, b2 = (t.to(compute_dtype) for t in (w1, b1, w2, b2))
    f32 = torch.float32
    h = torch.einsum("...gd,gdf->...gf", x.to(f32), w1.to(f32)) + b1.to(f32)
    h = F.gelu(h).to(x.dtype)
    out = torch.einsum("...gf,gfd->...gd", h.to(f32), w2.to(f32)) + b2.to(f32)
    return out.to(x.dtype)


def grouped_ffw_lm(params: GroupedFFWParams, x: torch.Tensor) -> torch.Tensor:
    """Level-major form: x [G, M, d] -> [G, M, d]. Same math as grouped_ffw
    with the group axis leading."""
    w1, b1, w2, b2 = params
    f32 = torch.float32
    h = torch.bmm(x.to(f32), w1.to(f32)) + b1.to(f32)[:, None, :]
    h = F.gelu(h).to(x.dtype)
    out = torch.bmm(h.to(f32), w2.to(f32)) + b2.to(f32)[:, None, :]
    return out.to(x.dtype)
