"""Patchify / unpatchify and the token embedding.

Counterpart of `glom_tpu/ops/patch.py`. Reference parity: the
`image_to_tokens` Sequential in Glom.__init__
(glom_pytorch/glom_pytorch.py:88-91):

    Rearrange('b c (h p1) (w p2) -> b (h w) (p1 p2 c)') ; Linear(p*p*c -> dim)

Images are channel-first [b, c, H, W]; the weight is [in, out].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from einops import rearrange


class LinearParams(NamedTuple):
    w: torch.Tensor  # [in, out]
    b: torch.Tensor  # [out]


def init_linear(
    d_in: int,
    d_out: int,
    *,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
) -> LinearParams:
    """U(-1/sqrt(d_in), 1/sqrt(d_in)) for both weight and bias, drawn on
    the CPU from `generator` (the reference's init family)."""
    s = 1.0 / math.sqrt(d_in)

    def u(*shape):
        return torch.rand(*shape, generator=generator, dtype=dtype) * (2 * s) - s

    return LinearParams(w=u(d_in, d_out), b=u(d_out))


def patchify(img: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[b, c, H, W] -> [b, n, p*p*c]; within a patch the channel axis is
    innermost, as the reference's einops pattern has it."""
    p = patch_size
    return rearrange(img, "b c (h p1) (w p2) -> b (h w) (p1 p2 c)", p1=p, p2=p)


def unpatchify(patches: torch.Tensor, patch_size: int, image_size: int) -> torch.Tensor:
    """[b, n, p*p*c] -> [b, c, H, W]; exact inverse of `patchify`."""
    p = patch_size
    h = image_size // p
    return rearrange(
        patches, "b (h w) (p1 p2 c) -> b c (h p1) (w p2)", h=h, w=h, p1=p, p2=p
    )


def image_to_tokens(params: LinearParams, img: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[b, c, H, W] -> [b, n, dim] token embedding."""
    x = patchify(img, patch_size)
    return x @ params.w + params.b


def tokens_to_image(
    params: LinearParams, tokens: torch.Tensor, patch_size: int, image_size: int
) -> torch.Tensor:
    """[b, n, dim] -> [b, c, H, W] reconstruction head (README denoise recipe)."""
    x = tokens @ params.w + params.b
    return unpatchify(x, patch_size, image_size)
