"""glom_tpu_torch: the GLOM forward and its fixed-route server in PyTorch,
with hand-written CUDA kernels for Hopper (sm_90a).

A port of `glom_tpu` that imports neither JAX nor `glom_tpu`. The fused
path runs the grouped-MLP kernel (K1) twice and the consensus-update
kernel (K2) once per iteration on a CUDA device; on CPU tensors the same
functions run as plain PyTorch. Entry points default to `device="cuda"`
and raise when no card is present unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import torch

from glom_tpu_torch.models import (
    Glom,
    GlomParams,
    glom_forward,
    init_glom,
    params_from_numpy,
)
from glom_tpu_torch.serve import InferenceEngine, ServeResult
from glom_tpu_torch.utils import GlomConfig, ServeConfig, resolve_device


def entry(device="cuda"):
    """Forward step of the flagship model plus example args, as glom_tpu's
    `__graft_entry__.entry()`: ImageNet-224, patch 14, L = 6, d = 512, bf16
    compute through the fused kernel path, a batch of 4 zero images.
    Returns (fn, (params, img)); call `fn(params, img)`."""
    device = resolve_device(device)
    cfg = GlomConfig(dim=512, levels=6, image_size=224, patch_size=14)
    params = init_glom(cfg, generator=torch.Generator().manual_seed(0), device=device)
    img = torch.zeros((4, 3, 224, 224), dtype=torch.float32, device=device)

    def fn(params, img):
        with torch.inference_mode():
            return glom_forward(
                params, img, cfg, compute_dtype=torch.bfloat16, use_pallas=True
            )

    return fn, (params, img)


__all__ = [
    "Glom",
    "GlomConfig",
    "GlomParams",
    "InferenceEngine",
    "ServeConfig",
    "ServeResult",
    "entry",
    "glom_forward",
    "init_glom",
    "params_from_numpy",
]
