"""NVTX ranges: the port's counterpart of glom_tpu's `jax.named_scope`.

A range names a block on the card's timeline (Nsight Systems, and the
CUDA activity torch.profiler records), as glom_tpu's named scopes name its
XLA ops. Ranges are pushed only once this process has initialised CUDA:
without a CUDA context there is no device timeline to annotate, and a
CPU-only torch build has no NVTX library to call.
"""

from __future__ import annotations

import contextlib

import torch


def nvtx_range(name: str):
    """A context manager: an NVTX range named `name` on the card, nothing
    before CUDA is initialised."""
    if torch.cuda.is_initialized():
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()
