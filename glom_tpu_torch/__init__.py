"""glom_tpu_torch: the GLOM forward, its server (fixed, early-exit,
incremental and ragged routes, warm from the host or from a device page
pool) and its single-device denoising trainer in PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a).

A port of `glom_tpu` that imports neither JAX nor `glom_tpu`. The fused
path runs the grouped-MLP kernel (K1) twice and the consensus-update
kernel (K2) once per iteration on a CUDA device, training adds their
backward kernels, and the ragged serving route runs K1 twice and the
banded consensus kernel (K4) once per iteration; on CPU tensors the same
functions run as plain PyTorch.
Entry points default to `device="cuda"` and raise when no card is present
unless the caller passes `device="cpu"`.

Re-exports are lazy (PEP 562), as glom_tpu's are: `import glom_tpu_torch`
imports no torch, so the operator's tools that read files only (`python -m
glom_tpu_torch.analysis`, and the telemetry CLI's lint, compare and perfetto)
start without loading it.
"""

from __future__ import annotations

from glom_tpu_torch.version import __version__

_EXPORTS = {
    "Glom": "glom_tpu_torch.models",
    "GlomParams": "glom_tpu_torch.models",
    "glom_forward": "glom_tpu_torch.models",
    "init_glom": "glom_tpu_torch.models",
    "params_from_numpy": "glom_tpu_torch.models",
    "InferenceEngine": "glom_tpu_torch.serve",
    "PagedColumnPool": "glom_tpu_torch.serve",
    "RaggedServeResult": "glom_tpu_torch.serve",
    "ServeResult": "glom_tpu_torch.serve",
    "Trainer": "glom_tpu_torch.train",
    "GlomConfig": "glom_tpu_torch.utils",
    "ServeConfig": "glom_tpu_torch.utils",
    "TrainConfig": "glom_tpu_torch.utils",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'glom_tpu_torch' has no attribute {name!r}")


def entry(device="cuda"):
    """Forward step of the flagship model plus example args, as glom_tpu's
    `__graft_entry__.entry()`: ImageNet-224, patch 14, L = 6, d = 512, bf16
    compute through the fused kernel path, a batch of 4 zero images.
    Returns (fn, (params, img)); call `fn(params, img)`."""
    import torch

    from glom_tpu_torch.models import glom_forward, init_glom
    from glom_tpu_torch.utils import GlomConfig, resolve_device

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
    "PagedColumnPool",
    "RaggedServeResult",
    "ServeConfig",
    "ServeResult",
    "TrainConfig",
    "Trainer",
    "__version__",
    "entry",
    "glom_forward",
    "init_glom",
    "params_from_numpy",
]
