"""Synthetic image datasets, generated with numpy on the host.

The port's copy of `shapes_dataset` and `gaussian_dataset` from
`glom_tpu/data/synthetic.py` (same generators, same seeds, same images):
procedural images with real part-whole structure -- random coloured
rectangles and circles on tinted backgrounds -- so the denoising objective
has signal to learn. Batches are float32 [b, 3, H, W] in [-1, 1].
`write_shapes_dataset` renders the same distribution to disk, for the
file loaders (data/loaders.py).

`start=k` gives the stream from its batch k, the batches a resumed run has
not trained on. The streams are sequential draws from one generator, so
the skipped batches' draws are still made: shapes draws their parameters
without rendering the images (a small share of a batch's time), and
gaussian draws their values (the normals take a data-dependent count of
the generator's words, so its state cannot be advanced in one step).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def _shape_draws(rng: np.random.Generator, size: int, num_shapes: int):
    """One image's draws, in glom_tpu's order: (tint, [(color, kind,
    geometry), ...])."""
    tint = rng.uniform(-0.4, 0.4, (3, 1, 1))
    shapes = []
    for _ in range(num_shapes):
        color = rng.uniform(-1, 1, (3, 1, 1)).astype(np.float32)
        kind = rng.integers(0, 2)
        if kind == 0:  # rectangle: x0, y0, w, h
            geometry = (*rng.integers(0, size, 2), *rng.integers(size // 8, size // 2, 2))
        else:  # circle: cx, cy, r
            geometry = (*rng.integers(0, size, 2), rng.integers(size // 10, size // 3))
        shapes.append((color, kind, geometry))
    return tint, shapes


def _draw_shapes(rng: np.random.Generator, size: int, num_shapes: int) -> np.ndarray:
    """One [3, size, size] image in [-1, 1]."""
    tint, shapes = _shape_draws(rng, size, num_shapes)
    img = np.ones((3, size, size), np.float32) * tint
    yy, xx = np.mgrid[0:size, 0:size]
    for color, kind, geometry in shapes:
        if kind == 0:
            x0, y0, w, h = geometry
            mask = (xx >= x0) & (xx < x0 + w) & (yy >= y0) & (yy < y0 + h)
        else:
            cx, cy, r = geometry
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
    start: int = 0,
) -> Iterator[np.ndarray]:
    """Infinite (or bounded) iterator of [b, 3, H, W] float32 batches, from
    batch `start` (see the module docstring)."""
    rng = np.random.default_rng(seed)
    produced = 0
    while num_batches is None or produced < num_batches:
        if produced < start:
            for _ in range(batch_size):
                _shape_draws(rng, image_size, num_shapes)
        else:
            batch = np.stack([_draw_shapes(rng, image_size, num_shapes)
                              for _ in range(batch_size)])
            yield batch.astype(np.float32)
        produced += 1


def gaussian_dataset(
    batch_size: int, image_size: int, *, seed: int = 0, start: int = 0
) -> Iterator[np.ndarray]:
    """Pure-noise images, for smoke runs where content does not matter;
    from batch `start` (see the module docstring)."""
    rng = np.random.default_rng(seed)
    shape = (batch_size, 3, image_size, image_size)
    if start:
        # The same draws as rng.normal's, into one reused buffer.
        skipped = np.empty(shape)
        for _ in range(start):
            rng.standard_normal(out=skipped)
    while True:
        yield rng.normal(size=shape).astype(np.float32)


def write_shapes_dataset(
    out_dir: str,
    num_images: int,
    image_size: int,
    *,
    seed: int = 0,
    fmt: str = "png",
    shard_size: int = 512,
) -> list:
    """Render the seeded shapes distribution to disk (glom_tpu's
    `write_shapes_dataset`, the same files).

    fmt='png': one 8-bit RGB PNG per image (for image_folder_dataset;
    needs PIL). fmt='npy': [shard_size, 3, H, W] float32 shards (for
    npy_dataset; numpy only). Returns the list of file paths written.
    """
    import os

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    if fmt == "png":
        from PIL import Image

        for i in range(num_images):
            img = _draw_shapes(rng, image_size, 5)  # [3, H, W] in [-1, 1]
            u8 = ((np.transpose(img, (1, 2, 0)) + 1.0) * 127.5).round()
            u8 = np.clip(u8, 0, 255).astype(np.uint8)
            p = os.path.join(out_dir, f"shape_{i:06d}.png")
            Image.fromarray(u8).save(p)
            paths.append(p)
        return paths
    if fmt == "npy":
        for s in range(0, num_images, shard_size):
            count = min(shard_size, num_images - s)
            shard = np.stack([_draw_shapes(rng, image_size, 5) for _ in range(count)])
            p = os.path.join(out_dir, f"shard_{s // shard_size:04d}.npy")
            np.save(p, shard)
            paths.append(p)
        return paths
    raise ValueError(f"fmt={fmt!r}: one of 'png', 'npy'")
