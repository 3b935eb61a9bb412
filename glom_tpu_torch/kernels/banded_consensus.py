"""K4: block-banded ragged consensus attention over a flat page-aligned
token axis [T, L, d].

Counterpart of `glom_tpu/kernels/banded_consensus.py`. The CUDA kernel
`csrc/banded_consensus.cu` replaces `_banded_kernel` (the pallas_call at
:174): token t of page p attends over its row's page band of `window`
slots, slot j * pt + u reading token min(band_page0[p] + j, P - 1) * pt + u,
with q = v = levels and k = l2norm(levels), d^-1/2 scale; the self slot
scores -5e-4 when attend_self is off, then slots past the row length score
finfo(float32).min. Everything after the load is f32; the output is cast
once.

`banded_ragged_consensus` has glom_tpu's signature (per-token row_start and
row_len maps). It runs `banded_ragged_consensus_plain` for tensors on the
CPU and launches the kernel for CUDA tensors, raising on anything the
kernel does not take. Unlike glom_tpu's wrapper it never falls back to the
plain "banded" route on the card. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels.grouped_mlp import refuse_grad
from glom_tpu_torch.utils.helpers import TOKEN_ATTEND_SELF_VALUE

LAUNCHES = 0

TILE = 32  # query rows per block and key rows per step (csrc/banded_consensus.cu)
MAX_DIM = 512  # d a multiple of 128, at most this

_NEG_MAX = float(torch.finfo(torch.float32).min)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "banded_consensus_fwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "banded_consensus_error_string": ([_I], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    return _build.load("banded_consensus", _SIGNATURES)


def _page_counts(T: int, window: int, page_tokens: int) -> tuple[int, int]:
    if T % page_tokens or window % page_tokens:
        raise ValueError(
            f"banded consensus needs page-aligned shapes: T={T}, "
            f"window={window}, page_tokens={page_tokens}"
        )
    return T // page_tokens, window // page_tokens


def page_maps(row_start: torch.Tensor, row_len: torch.Tensor, page_tokens: int):
    """The per-page maps from the per-token ones, on their device: the
    band's first page (row_start // pt) and the row length, int32 [P]
    (rows start on a page, so both are constant within a page)."""
    band_page0 = torch.div(row_start[::page_tokens], page_tokens, rounding_mode="floor")
    return (band_page0.to(torch.int32).contiguous(),
            row_len[::page_tokens].to(torch.int32).contiguous())


def banded_ragged_consensus_plain(
    levels: torch.Tensor,
    *,
    row_start: torch.Tensor,
    row_len: torch.Tensor,
    window: int,
    page_tokens: int,
    attend_self: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points:
    the levels converted to f32 on load, k normalised, scores, softmax and
    p . v in f32, the output cast once to the levels' dtype."""
    T, L, d = levels.shape
    pt = page_tokens
    P, n_band = _page_counts(T, window, pt)
    band_page0, len_page = page_maps(row_start, row_len, pt)
    dev = levels.device
    kv = levels.float()
    k = kv / torch.linalg.vector_norm(kv, dim=-1, keepdim=True).clamp_min(1e-12)
    raw = band_page0[:, None] + torch.arange(n_band, device=dev, dtype=torch.int32)
    band = raw.clamp(max=P - 1).long()  # [P, n_band] pages read
    q = kv.view(P, pt, L, d)
    kb = k.view(P, pt, L, d)[band].reshape(P, window, L, d)
    vb = q[band].reshape(P, window, L, d)
    s = torch.einsum("pqld,pwld->pqlw", q, kb) * d ** -0.5
    if not attend_self:
        u = torch.arange(pt, device=dev, dtype=torch.int32)
        slot_tok = (raw[:, :, None] * pt + u).reshape(P, 1, window)  # unclamped
        q_tok = torch.arange(T, device=dev, dtype=torch.int32).view(P, pt, 1)
        s = s.masked_fill((slot_tok == q_tok)[:, :, None, :], TOKEN_ATTEND_SELF_VALUE)
    w = torch.arange(window, device=dev, dtype=torch.int32)
    past = w[None, :] >= len_page[:, None]  # [P, window]
    s = s.masked_fill(past[:, None, None, :], _NEG_MAX)
    out = torch.einsum("pqlw,pwld->pqld", torch.softmax(s, dim=-1), vb)
    return out.reshape(T, L, d).to(levels.dtype)


def check_kernel_args(levels, row_start, row_len, window, page_tokens) -> None:
    """Raise ValueError for anything the CUDA kernel does not take."""
    if levels.dim() != 3:
        raise ValueError(f"levels must be [T, L, d], got {tuple(levels.shape)}")
    T, L, d = levels.shape
    _page_counts(T, window, page_tokens)
    if window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if levels.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype {levels.dtype}: the kernel takes bfloat16 or float32")
    if not levels.is_contiguous():
        raise ValueError("levels must be contiguous")
    if d % 128 or d > MAX_DIM:
        raise ValueError(f"d={d} must be a multiple of 128, at most {MAX_DIM}")
    if page_tokens > TILE and page_tokens % TILE:
        raise ValueError(f"page_tokens={page_tokens} must be <= {TILE} or a multiple of it")
    for name, t in (("row_start", row_start), ("row_len", row_len)):
        if tuple(t.shape) != (T,) or t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name} must be an int tensor of shape ({T},)")
        if t.device != levels.device:
            raise ValueError(f"{name} on {t.device}, levels on {levels.device}")


def banded_ragged_consensus(
    levels: torch.Tensor,
    *,
    row_start: torch.Tensor,
    row_len: torch.Tensor,
    window: int,
    page_tokens: int,
    attend_self: bool = False,
) -> torch.Tensor:
    """levels [T, L, d] -> [T, L, d]; row_start / row_len: per-token int
    maps [T] (each row's first flat token and its patch count)."""
    global LAUNCHES
    refuse_grad(levels)
    kw = dict(row_start=row_start, row_len=row_len, window=window,
              page_tokens=page_tokens, attend_self=attend_self)
    if levels.device.type == "cpu":
        return banded_ragged_consensus_plain(levels, **kw)
    if levels.device.type != "cuda":
        raise ValueError(f"no kernel for device {levels.device}")
    check_kernel_args(levels, row_start, row_len, window, page_tokens)
    T, L, d = levels.shape
    P, n_band = T // page_tokens, window // page_tokens
    band_page0, len_page = page_maps(row_start, row_len, page_tokens)
    out = torch.empty_like(levels)
    lib = _lib()
    err = lib.banded_consensus_fwd(
        levels.data_ptr(), out.data_ptr(), band_page0.data_ptr(), len_page.data_ptr(),
        P, page_tokens, L, d, n_band, int(bool(attend_self)),
        int(levels.dtype == torch.bfloat16), torch.cuda.current_stream(levels.device).cuda_stream,
    )
    _build.check(err, "banded_consensus_fwd", lib.banded_consensus_error_string)
    LAUNCHES += 1
    return out
