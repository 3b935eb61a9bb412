"""File-backed image datasets: the real-data input path.

Counterpart of `glom_tpu/data/loaders.py` (the same files give the same
batches, bit for bit): a directory of images (PIL-decodable) or .npy shard
files -> shuffled, normalized [b, 3, H, W] float32 batches, ready for
`prefetch_to_device` and the trainer's on-device noising.

Sharding is per process (`shard_index` / `num_shards`): each process reads
only its slice of the file list. The port trains on one process, so its
CLI reads every file.

Normalization matches the synthetic datasets: images land in [-1, 1]
(uint8 -> x/127.5 - 1; float inputs are assumed pre-scaled to [0, 1] or
[-1, 1] and mapped accordingly). PIL is imported only by the image-folder
loader, at its first call.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence

import numpy as np

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")


def _to_chw_float(arr: np.ndarray) -> np.ndarray:
    """[H, W, C] or [H, W] uint8/float -> [3, H, W] float32 in [-1, 1]."""
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:  # grayscale -> triple
        arr = np.repeat(arr, 3, axis=-1)
    if arr.shape[-1] == 4:  # drop alpha
        arr = arr[..., :3]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 127.5 - 1.0
    else:
        arr = arr.astype(np.float32)
        if arr.min() >= 0.0 and arr.max() > 1.5:  # 0..255 floats
            arr = arr / 127.5 - 1.0
        elif arr.min() >= 0.0:  # 0..1 floats
            arr = arr * 2.0 - 1.0
    return np.transpose(arr, (2, 0, 1))


def _list_shard(paths: Sequence[str], shard_index: int, num_shards: int):
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard {shard_index} outside 0..{num_shards - 1}")
    shard = list(paths[shard_index::num_shards])
    if not shard:
        raise ValueError(
            f"shard {shard_index}/{num_shards} is empty ({len(paths)} files)"
        )
    return shard


def image_folder_dataset(
    data_dir: str,
    batch_size: int,
    image_size: int,
    *,
    seed: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    num_batches: Optional[int] = None,
    start: int = 0,
) -> Iterator[np.ndarray]:
    """Recursively scan `data_dir` for images; yield shuffled, resized
    [b, 3, image_size, image_size] float32 batches in [-1, 1], reshuffling
    every epoch, from batch `start` (its epochs' shuffles are drawn, no
    image of a skipped batch is read). Requires PIL, imported here."""
    from PIL import Image

    paths = sorted(
        os.path.join(root, f)
        for root, _, files in os.walk(data_dir)
        for f in files
        if f.lower().endswith(_IMG_EXTS)
    )
    if not paths:
        raise FileNotFoundError(f"no images under {data_dir!r} ({_IMG_EXTS})")
    paths = _list_shard(paths, shard_index, num_shards)
    rng = np.random.default_rng(seed + shard_index)

    def load(path):
        with Image.open(path) as im:
            im = im.convert("RGB").resize(
                (image_size, image_size), Image.BILINEAR
            )
            return _to_chw_float(np.asarray(im))

    produced = 0
    while num_batches is None or produced < num_batches:
        order = rng.permutation(len(paths))
        for first in range(0, len(order) - batch_size + 1, batch_size):
            if produced >= start:
                yield np.stack([load(paths[i]) for i in order[first : first + batch_size]])
            produced += 1
            if num_batches is not None and produced >= num_batches:
                return


def npy_dataset(
    path: str,
    batch_size: int,
    image_size: Optional[int] = None,
    *,
    seed: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    num_batches: Optional[int] = None,
    start: int = 0,
) -> Iterator[np.ndarray]:
    """Batches from .npy shard file(s): `path` is one .npy file or a
    directory of them; each holds [N, H, W, C] or [N, C, H, W] images
    (uint8 or float). Shards are memory-mapped (a CIFAR-scale file loads
    lazily; an ImageNet-scale shard set streams one file at a time),
    distributed across hosts file-wise when there are >= num_shards files,
    row-wise otherwise. Yields [b, 3, H, W] float32 in [-1, 1], shuffling
    rows within each shard pass, from batch `start` (the passes' shuffles
    are drawn, no row of a skipped batch is read)."""
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.endswith(".npy")
        )
        if not files:
            raise FileNotFoundError(f"no .npy files under {path!r}")
    else:
        files = [path]

    row_shard = len(files) < num_shards
    if not row_shard:
        files = _list_shard(files, shard_index, num_shards)
    rng = np.random.default_rng(seed + shard_index)

    def rows(arr):
        n = arr.shape[0]
        idx = (
            np.arange(shard_index, n, num_shards) if row_shard else np.arange(n)
        )
        return idx[rng.permutation(len(idx))]

    def to_batch(arr, idx):
        x = np.asarray(arr[np.sort(idx)])  # sorted: sequential mmap reads
        if x.ndim != 4:
            raise ValueError(f"expected [N, ...] image array, got {x.shape}")
        if x.shape[-1] in (1, 3, 4) and x.shape[1] not in (1, 3):
            x = np.stack([_to_chw_float(img) for img in x])
        else:  # already [b, C, H, W]
            x = np.stack(
                [_to_chw_float(np.transpose(img, (1, 2, 0))) for img in x]
            )
        if image_size is not None and (
            x.shape[-1] != image_size or x.shape[-2] != image_size
        ):
            raise ValueError(
                f"images are {x.shape[-2]}x{x.shape[-1]}, config wants "
                f"{image_size} (resize .npy shards offline; only the image "
                "folder loader resizes)"
            )
        return x

    produced = 0
    while num_batches is None or produced < num_batches:
        for f in files:
            arr = np.load(f, mmap_mode="r")
            order = rows(arr)
            for first in range(0, len(order) - batch_size + 1, batch_size):
                if produced >= start:
                    yield to_batch(arr, order[first : first + batch_size])
                produced += 1
                if num_batches is not None and produced >= num_batches:
                    return


def file_dataset(
    path: str,
    batch_size: int,
    image_size: int,
    **kw,
) -> Iterator[np.ndarray]:
    """Dispatch on what `path` holds: .npy file / directory of .npy shards
    -> npy_dataset; directory of images -> image_folder_dataset."""
    if path.endswith(".npy"):
        return npy_dataset(path, batch_size, image_size, **kw)
    if os.path.isdir(path):
        has_npy = any(f.endswith(".npy") for f in os.listdir(path))
        if has_npy:
            return npy_dataset(path, batch_size, image_size, **kw)
        return image_folder_dataset(path, batch_size, image_size, **kw)
    raise FileNotFoundError(f"{path!r} is neither a .npy file nor a directory")
