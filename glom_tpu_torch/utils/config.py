"""Configuration dataclasses.

Counterpart of `glom_tpu/utils/config.py`: `GlomConfig` field for field,
and the part of `ServeConfig` that the fixed serving route reads. The
port keeps its own copy because the reference module pulls in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union


@dataclasses.dataclass(frozen=True)
class GlomConfig:
    """Model hyperparameters: field-for-field the reference constructor."""

    dim: int = 512
    levels: int = 6
    image_size: int = 224
    patch_size: int = 14
    consensus_self: bool = False
    local_consensus_radius: int = 0
    # Extensions beyond the reference kwargs (defaults match its hardcoded values):
    mult: int = 4  # FFW expansion, reference hardcodes 4
    channels: int = 3  # reference hardcodes RGB

    def __post_init__(self):
        if self.image_size % self.patch_size != 0:
            raise ValueError(
                f"image_size {self.image_size} not divisible by patch_size {self.patch_size}"
            )
        if self.levels < 2:
            raise ValueError("levels must be >= 2 (top-down net needs levels-1 groups)")

    @property
    def num_patches_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_side ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def default_iters(self) -> int:
        # "twice the levels, for information to propagate up and back down"
        # (reference :105)
        return 2 * self.levels


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Batched-inference serving policy, fixed-iteration route only.

    The fields keep the reference's names and defaults; the reference's
    other fields (the batcher's `max_batch`, early exit, meshes, pages,
    retry, telemetry) belong to parts the port does not run yet (ROADMAP
    queue A item 7)."""

    # Ascending batch-size buckets; a dispatch pads to the smallest bucket
    # >= its request count. The largest bucket is the dispatch ceiling.
    buckets: Tuple[int, ...] = (1, 2, 4, 8)
    # Forward iteration budget: an int pins the count, None uses the model
    # default (2L). "auto" (early exit) is not ported yet.
    iters: Union[int, str, None] = None
    compute_dtype: str = "float32"  # "bfloat16" for tensor-core serving
    use_pallas: bool = False  # True: the fused level-major kernel path

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("buckets must be non-empty")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets {self.buckets} must be strictly ascending")
        if any(b < 1 for b in self.buckets):
            raise ValueError(f"buckets {self.buckets} must be >= 1")
        if self.iters is not None and self.iters != "auto":
            if not isinstance(self.iters, int) or self.iters < 1:
                raise ValueError(f"iters={self.iters!r}: an int >= 1, 'auto', or None")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}: 'float32' or 'bfloat16'")
