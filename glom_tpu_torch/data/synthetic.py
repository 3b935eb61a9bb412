"""Synthetic image datasets, generated with numpy on the host.

The port's copy of `shapes_dataset` and `gaussian_dataset` from
`glom_tpu/data/synthetic.py` (same generators, same seeds, same images):
procedural images with real part-whole structure -- random coloured
rectangles and circles on tinted backgrounds -- so the denoising objective
has signal to learn. Batches are float32 [b, 3, H, W] in [-1, 1].
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def _draw_shapes(rng: np.random.Generator, size: int, num_shapes: int) -> np.ndarray:
    """One [3, size, size] image in [-1, 1]."""
    img = np.ones((3, size, size), np.float32) * rng.uniform(-0.4, 0.4, (3, 1, 1))
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(num_shapes):
        color = rng.uniform(-1, 1, (3, 1, 1)).astype(np.float32)
        kind = rng.integers(0, 2)
        if kind == 0:  # rectangle
            x0, y0 = rng.integers(0, size, 2)
            w, h = rng.integers(size // 8, size // 2, 2)
            mask = (xx >= x0) & (xx < x0 + w) & (yy >= y0) & (yy < y0 + h)
        else:  # circle
            cx, cy = rng.integers(0, size, 2)
            r = rng.integers(size // 10, size // 3)
            mask = (xx - cx) ** 2 + (yy - cy) ** 2 < r ** 2
        img = np.where(mask[None], color, img)
    return np.clip(img, -1.0, 1.0)


def shapes_dataset(
    batch_size: int,
    image_size: int,
    *,
    seed: int = 0,
    num_shapes: int = 5,
    num_batches: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Infinite (or bounded) iterator of [b, 3, H, W] float32 batches."""
    rng = np.random.default_rng(seed)
    produced = 0
    while num_batches is None or produced < num_batches:
        batch = np.stack([_draw_shapes(rng, image_size, num_shapes) for _ in range(batch_size)])
        yield batch.astype(np.float32)
        produced += 1


def gaussian_dataset(batch_size: int, image_size: int, *, seed: int = 0) -> Iterator[np.ndarray]:
    """Pure-noise images, for smoke runs where content does not matter."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.normal(size=(batch_size, 3, image_size, image_size)).astype(np.float32)
