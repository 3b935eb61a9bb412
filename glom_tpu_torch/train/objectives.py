"""Training objectives.

Counterpart of `glom_tpu/train/objectives.py`: the reference README's
self-supervised denoising recipe (README :30-75),

    noised     = img + noise
    all_levels = model(noised, return_all=True)     # [T+1, b, n, L, d]
    top        = all_levels[k, :, :, -1]            # mid-iteration top level
    recon      = patches_to_images(top)             # Linear(d -> p*p*c) + unpatchify
    loss       = mse(img, recon)

run for exactly k iterations (iterations k+1..T are dead for this loss),
keeping only the final top level.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from glom_tpu_torch.models.core import (
    ConsensusFn,
    GlomParams,
    glom_forward,
    init_glom,
)
from glom_tpu_torch.ops.patch import LinearParams, init_linear, tokens_to_image
from glom_tpu_torch.tracing.nvtx import nvtx_range
from glom_tpu_torch.utils.config import GlomConfig


class DenoiseParams(NamedTuple):
    """GLOM params + the reconstruction head from the README recipe."""

    glom: GlomParams
    to_pixels: LinearParams  # Linear(d -> p*p*c)


def init_denoise(
    cfg: GlomConfig,
    *,
    generator: Optional[torch.Generator] = None,
    device="cpu",
    dtype=torch.float32,
) -> DenoiseParams:
    """The reference's shapes and init families, drawn on the CPU from
    `generator`, then moved to `device`."""
    glom = init_glom(cfg, generator=generator, device=device, dtype=dtype)
    head = init_linear(cfg.dim, cfg.patch_dim, generator=generator, dtype=dtype)
    return DenoiseParams(glom=glom, to_pixels=LinearParams(*(t.to(device) for t in head)))


def default_recon_index(iters: int) -> int:
    """Which stacked state feeds the reconstruction head: T//2 + 1, the
    reference README's index 7 at T = 12."""
    return iters // 2 + 1


def denoise_loss(
    params: DenoiseParams,
    img: torch.Tensor,
    noise: torch.Tensor,
    cfg: GlomConfig,
    *,
    recon_index: Optional[int] = None,
    iters: Optional[int] = None,
    remat: bool = False,
    compute_dtype=None,
    consensus_fn: Optional[ConsensusFn] = None,
    use_pallas: bool = False,
    scan_only: bool = False,
    with_diagnostics: bool = False,
):
    """MSE between the clean image and the reconstruction from the noised
    image's top level at iteration `recon_index` (exactly that many
    iterations run). scan_only keeps the forward off the whole-loop VJP
    (see `glom_forward`). with_diagnostics=True (telemetry_level "full")
    returns (loss, aux), aux holding the per-level agreement of the same
    final state the loss reads, detached: one [L] reduction, no second
    forward, nothing in the backward."""
    T = iters if iters is not None else cfg.default_iters
    k = recon_index if recon_index is not None else default_recon_index(T)
    if not 1 <= k <= T:
        raise ValueError(f"recon_index {k} outside 1..{T}")
    final = glom_forward(
        params.glom,
        img + noise,
        cfg,
        iters=k,
        remat=remat,
        compute_dtype=compute_dtype,
        consensus_fn=consensus_fn,
        use_pallas=use_pallas,
        scan_only=scan_only,
    )
    top = final[:, :, -1]  # [b, n, d]: the top level
    with nvtx_range("reconstruction"):
        recon = tokens_to_image(
            params.to_pixels, top.to(img.dtype), cfg.patch_size, cfg.image_size
        )
    loss = torch.mean((img - recon) ** 2)
    if with_diagnostics:
        from glom_tpu_torch.telemetry.diagnostics import level_agreement

        return loss, {"level_agreement": level_agreement(final)}
    return loss


def reconstruct(
    params: DenoiseParams,
    img: torch.Tensor,
    cfg: GlomConfig,
    *,
    recon_index: Optional[int] = None,
    iters: Optional[int] = None,
    compute_dtype=None,
    consensus_fn: Optional[ConsensusFn] = None,
    use_pallas: bool = False,
) -> torch.Tensor:
    """The reconstruction the loss scores (for eval and inspection). Pass
    the consensus_fn the model was trained with."""
    T = iters if iters is not None else cfg.default_iters
    k = recon_index if recon_index is not None else default_recon_index(T)
    final = glom_forward(
        params.glom, img, cfg, iters=k, compute_dtype=compute_dtype,
        consensus_fn=consensus_fn, use_pallas=use_pallas,
    )
    return tokens_to_image(
        params.to_pixels, final[:, :, -1].to(img.dtype), cfg.patch_size, cfg.image_size
    )
