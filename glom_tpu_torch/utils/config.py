"""Configuration dataclasses.

Counterpart of `glom_tpu/utils/config.py`: `GlomConfig` and `TrainConfig`
field for field, and the part of `ServeConfig` that the port's serving
routes read. The port keeps its own copy because the reference module pulls in
JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


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
    """Batched-inference serving policy: the part of glom_tpu's
    `ServeConfig` that the port's engine reads, with its names, defaults
    and checks.

    The bucket route (fixed `iters` or `"auto"` early exit) and the ragged
    route (`ragged=True`: rows of differing patch counts packed onto one
    page-aligned token axis) are ported. The reference's other fields (the
    batcher's admission and retry, meshes, the column cache, pool aliasing,
    delta streaming, telemetry) belong to parts the port does not run yet
    (ROADMAP queue A items 7-9); `page_pool_pages > 0` and
    `max_continuations > 0` are accepted here and refused by the engine."""

    # Ascending batch-size buckets; a dispatch pads to the smallest bucket
    # >= its request count. The largest bucket is the dispatch ceiling.
    buckets: Tuple[int, ...] = (1, 2, 4, 8)
    # Rows a dispatch gathers; also the row capacity of a ragged signature.
    max_batch: int = 8
    # Forward iteration budget: an int pins the count, None uses the model
    # default (2L), "auto" runs the early-exit route: up to max_auto_iters
    # updates, a row converging once no level's agreement moves more than
    # exit_threshold between iterations, the dispatch exiting once
    # ceil(exit_quorum * valid rows) rows have converged.
    iters: Union[int, str, None] = None
    exit_threshold: float = 1e-3
    min_iters: int = 1
    max_auto_iters: Optional[int] = None  # None -> model default (2L)
    exit_quorum: float = 1.0
    # Continuation hops for stragglers: the batcher's, not ported yet, so
    # the engine refuses a value > 0 (ROADMAP queue A item 7).
    max_continuations: int = 0
    compute_dtype: str = "float32"  # "bfloat16" for tensor-core serving
    use_pallas: bool = False  # True: the fused kernel path (name kept)
    # Paged column memory: the page pool itself is not ported yet;
    # page_tokens is the page granularity of the ragged route too (0
    # resolves from the model, serve/paged_columns.resolve_page_tokens).
    page_pool_pages: int = 0
    page_tokens: int = 0
    # Ragged admission: the page-count ladder (empty resolves from
    # max_batch and the pages of one full-resolution row) and the
    # consensus gather: "windowed" (per-token window), "banded" (per-page
    # band, plain PyTorch) or "banded-pallas" (the K4 kernel on the card).
    ragged: bool = False
    ragged_pages: Tuple[int, ...] = ()
    ragged_attention: str = "windowed"

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("buckets must be non-empty")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets {self.buckets} must be strictly ascending")
        if any(b < 1 for b in self.buckets):
            raise ValueError(f"buckets {self.buckets} must be >= 1")
        if self.max_batch > max(self.buckets):
            raise ValueError(
                f"max_batch {self.max_batch} exceeds the largest bucket "
                f"{max(self.buckets)} (the dispatch ceiling)"
            )
        if self.max_batch < 1:
            raise ValueError(f"max_batch {self.max_batch} must be >= 1")
        if self.iters is not None and self.iters != "auto":
            if not isinstance(self.iters, int) or self.iters < 1:
                raise ValueError(f"iters={self.iters!r}: an int >= 1, 'auto', or None")
        if self.exit_threshold < 0:
            raise ValueError(f"exit_threshold {self.exit_threshold} must be >= 0")
        if self.min_iters < 1:
            raise ValueError(f"min_iters {self.min_iters} must be >= 1")
        if not 0.0 < self.exit_quorum <= 1.0:
            raise ValueError(
                f"exit_quorum {self.exit_quorum} outside (0, 1] (1.0 = all "
                "valid rows must converge before the bucket exits)"
            )
        if self.max_continuations < 0:
            raise ValueError(f"max_continuations {self.max_continuations} must be >= 0")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}: 'float32' or 'bfloat16'")
        if self.page_pool_pages < 0:
            raise ValueError(
                f"page_pool_pages {self.page_pool_pages} must be >= 0 "
                "(0 disables the device-resident column page pool)"
            )
        if self.page_tokens < 0:
            raise ValueError(
                f"page_tokens {self.page_tokens} must be >= 0 (0 resolves "
                "from the model's patch count)"
            )
        if self.ragged and self.max_continuations > 0 and self.iters != "auto":
            raise ValueError(
                "ragged continuations need iters='auto': a fixed route "
                "has no convergence witness to leave stragglers behind"
            )
        if self.ragged_attention not in ("windowed", "banded", "banded-pallas"):
            raise ValueError(
                f"ragged_attention {self.ragged_attention!r}: 'windowed', "
                "'banded', or 'banded-pallas'"
            )
        if self.ragged_pages:
            if list(self.ragged_pages) != sorted(set(self.ragged_pages)):
                raise ValueError(
                    f"ragged_pages {self.ragged_pages} must be strictly ascending"
                )
            if any(p < 1 for p in self.ragged_pages):
                raise ValueError(f"ragged_pages {self.ragged_pages} must be >= 1")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Self-supervised denoising trainer (the reference's README recipe):
    glom_tpu's fields, names and defaults. The trainer validates them
    (train/trainer.py, telemetry/diagnostics.py), as glom_tpu's does."""

    batch_size: int = 8
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    # "constant" | "cosine" | "warmup_cosine"; cosine decays to
    # lr_final_fraction * learning_rate; schedule_steps is the TOTAL length,
    # including warmup_steps for warmup_cosine (optax semantics).
    lr_schedule: str = "constant"
    schedule_steps: int = 10_000
    warmup_steps: int = 0
    lr_final_fraction: float = 0.0
    # Microbatches per optimizer update (exact strided accumulation). None
    # is the auto-routing sentinel: one pass while no route needs a split.
    grad_accum: Optional[int] = None
    noise_std: float = 1.0
    recon_iter_index: Optional[int] = None  # None -> T // 2 + 1 (7 at T=12)
    iters: Optional[int] = None  # None -> model default (2L)
    # Recompute in the backward: the whole-loop VJP recomputes the FFWs'
    # pre-activations; the per-iteration route checkpoints each iteration.
    remat: bool = False
    compute_dtype: str = "float32"  # "bfloat16" for tensor-core training
    use_pallas: bool = False  # True: the fused kernel route (name kept)
    # Sharded weight update and quantized reduce: multi-device only, not
    # ported yet (ROADMAP queue A item 8); the trainer refuses them.
    zero_stage: int = 0
    quantized_reduce: bool = False
    # "off" | "scalars" (grad/update/param norms + the NaN/Inf guard) |
    # "full" (adds per-level agreement; not ported yet).
    telemetry_level: str = "off"
    nonfinite_policy: str = "skip"  # "skip" drops a non-finite update; "warn" applies it
    # Eager PyTorch runs the iterations as a Python loop, which is what the
    # JAX scan's unroll produced; kept for the reference's field set.
    scan_unroll: bool = False
    collective_timing: str = "off"  # multi-device only (ROADMAP queue A item 9)
    collective_timing_interval: int = 10
    seed: int = 0
