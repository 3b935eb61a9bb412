"""Temporal / video mode: columns persist across frames.

Counterpart of `glom_tpu/train/temporal.py`, the reference README's video
recipe (README :80-100):

    levels = None
    for frame in frames:
        if levels is not None: levels = levels.detach()
        levels = model(frame, iters=12, levels=levels)

Backprop through time is truncated at frame boundaries: frame 0 keeps its
gradient into `init_levels`, and each later frame starts from the detached
carry. With use_pallas=True every frame runs the fused route (the K1 and
K2 kernels on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from glom_tpu_torch.models.core import ConsensusFn, GlomParams, glom_forward
from glom_tpu_torch.utils.config import GlomConfig


def temporal_rollout(
    params: GlomParams,
    frames: torch.Tensor,
    cfg: GlomConfig,
    *,
    iters: Optional[int] = None,
    detach_between_frames: bool = True,
    init_levels: Optional[torch.Tensor] = None,
    remat: bool = False,
    compute_dtype=None,
    consensus_fn: Optional[ConsensusFn] = None,
    use_pallas: bool = False,
) -> torch.Tensor:
    """Run GLOM over a frame sequence, carrying column state.

    frames: [t, b, c, H, W] -> per-frame final levels [t, b, n, L, d].
    """

    def run_frame(levels, frame):
        return glom_forward(
            params, frame, cfg, iters=iters, levels=levels, remat=remat,
            compute_dtype=compute_dtype, consensus_fn=consensus_fn, use_pallas=use_pallas,
        )

    outs = [run_frame(init_levels, frames[0])]
    for frame in frames[1:]:
        levels = outs[-1].detach() if detach_between_frames else outs[-1]
        outs.append(run_frame(levels, frame))
    return torch.stack(outs, dim=0)
