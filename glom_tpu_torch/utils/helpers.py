"""Small functional helpers shared across the port.

Counterpart of `glom_tpu/utils/helpers.py`, kept as the port's own copy
(the port imports nothing of `glom_tpu`).
"""

from __future__ import annotations

import math

import torch

# The *soft* self-attention penalty used by consensus attention when
# attend_self=False. Deliberately NOT -inf: columns attend weakly to
# themselves. (reference: glom_pytorch/glom_pytorch.py:9)
TOKEN_ATTEND_SELF_VALUE = -5e-4


def exists(val):
    return val is not None


def default(val, d):
    return val if exists(val) else d


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||_2, eps) along `dim` (torch.nn.functional.normalize)."""
    norm = torch.linalg.vector_norm(x, ord=2, dim=dim, keepdim=True)
    return x / torch.clamp_min(norm, eps)


def halo_supported(seq: int, side: int, radius: float) -> bool:
    """True when one-hop halo-exchange consensus is valid for `seq`-way
    row-band sharding of a side x side patch grid with the given local
    radius: the floor(radius) grid rows a shard needs from each neighbour
    must fit inside one neighbouring shard. Pure geometry, so the presets
    can check it without a parallel runtime."""
    if radius <= 0 or side % seq != 0:
        return False
    return (side // seq) >= math.floor(radius)


def max_neg_value(dtype) -> float:
    """The -finfo.max fill used for the *hard* (local-radius) attention mask.

    Distinct from TOKEN_ATTEND_SELF_VALUE: the reference uses two mask
    semantics in one attention op (soft self-penalty vs hard locality
    cutoff). (reference: glom_pytorch/glom_pytorch.py:63-67)
    """
    return -torch.finfo(dtype).max


def resolve_device(device) -> torch.device:
    """The device rule of the port's entry points: a CUDA device must exist
    when one is asked for; the CPU runs only when the caller names it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return device


def resolve_dtype(dtype) -> torch.dtype | None:
    """Accept a torch dtype, a name ("bfloat16", "float32") or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None), torch.dtype):
        return getattr(torch, dtype)
    raise TypeError(f"dtype={dtype!r}: a torch.dtype, its name, or None")
