"""Page arithmetic of paged column memory.

Counterpart of the helpers at the top of `glom_tpu/serve/paged_columns.py`:
the page size, pages per row and the bytes of one page. The ragged route
lays rows out on whole pages of `page_tokens` tokens. The device page pool
itself (`PagedColumnPool`) is not ported yet (ROADMAP queue A item 7).
"""

from __future__ import annotations

from typing import Optional


def resolve_page_tokens(cfg, scfg) -> int:
    """The page granularity in patch tokens. An explicit
    `ServeConfig.page_tokens` must tile the full-resolution row; 0
    resolves to the largest divisor of `num_patches` that is at most
    min(64, num_patches // 4): at least four pages per full-resolution
    row, at most 64 tokens a page (flagship: 256 patches -> 64)."""
    n = cfg.num_patches
    if scfg.page_tokens > 0:
        if n % scfg.page_tokens != 0:
            raise ValueError(
                f"page_tokens {scfg.page_tokens} does not divide "
                f"num_patches {n} (pages must tile the full-resolution row)"
            )
        return scfg.page_tokens
    for cand in range(max(1, min(64, n // 4)), 0, -1):
        if n % cand == 0:
            return cand
    return n  # pragma: no cover: cand = 1 always divides


def pages_for_tokens(n_tokens: int, page_tokens: int) -> int:
    """ceil(n_tokens / page_tokens): the pages one row's columns occupy."""
    if n_tokens < 1:
        raise ValueError(f"n_tokens {n_tokens} must be >= 1")
    return -(-n_tokens // page_tokens)


def page_state_bytes(cfg, scfg, page_tokens: Optional[int] = None) -> int:
    """The bytes of ONE page: page_tokens x levels x dim in the serving
    dtype."""
    pt = page_tokens if page_tokens is not None else resolve_page_tokens(cfg, scfg)
    itemsize = 2 if scfg.compute_dtype == "bfloat16" else 4
    return pt * cfg.levels * cfg.dim * itemsize
