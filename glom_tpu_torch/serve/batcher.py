"""Host-side packing for the serving routes.

Counterpart of the packing inside `glom_tpu/serve/batcher.py`:
`_patchify_host` and the page-aligned row layout its ragged dispatch
builds. `DynamicBatcher` itself (admission, continuation queue, fan-out)
is not ported yet (ROADMAP queue A item 7).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from glom_tpu_torch.serve.paged_columns import pages_for_tokens


def _patchify_host(img: np.ndarray, patch_size: int) -> np.ndarray:
    """[c, H, W] -> [n, p*p*c] in ops/patch.patchify's order ('b c (h p1)
    (w p2) -> b (h w) (p1 p2 c)'): a reshape and transpose with no float
    operation, so the ragged route embeds exactly the values the bucket
    route's patchify gives."""
    c, height, width = img.shape
    p = patch_size
    h, w = height // p, width // p
    x = img.reshape(c, h, p, w, p)
    x = x.transpose(1, 3, 2, 4, 0)  # [h, w, p1, p2, c]
    return np.ascontiguousarray(x.reshape(h * w, p * p * c))


def ragged_row_starts(n_patches: Sequence[int], page_tokens: int) -> list:
    """Each row's first flat token: rows in order, each on whole pages
    (early_exit.ragged_row_layout, on the host). A row of 0 patches takes
    no page."""
    starts, off = [], 0
    for n in n_patches:
        starts.append(off * page_tokens)
        if n > 0:
            off += pages_for_tokens(int(n), page_tokens)
    return starts


def pack_ragged(
    imgs: Sequence[np.ndarray], patch_size: int, page_tokens: int, pages: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack images of differing resolutions ([c, H_i, W_i], H_i and W_i
    multiples of patch_size) page-aligned onto one flat token axis of
    `pages` pages, as the reference batcher's ragged dispatch does.
    Returns (patches [pages * page_tokens, p*p*c] f32, zeros past each
    row's patches; n_patches [rows] int32)."""
    rows = [_patchify_host(np.asarray(img, np.float32), patch_size) for img in imgs]
    n_patches = np.array([r.shape[0] for r in rows], np.int32)
    need = sum(pages_for_tokens(int(n), page_tokens) for n in n_patches)
    if need > pages:
        raise ValueError(f"rows need {need} pages > {pages}")
    flat = np.zeros((pages * page_tokens, rows[0].shape[1]), np.float32)
    for row, start in zip(rows, ragged_row_starts(n_patches, page_tokens)):
        flat[start:start + row.shape[0]] = row
    return flat, n_patches
