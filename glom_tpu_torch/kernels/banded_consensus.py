"""K4: block-banded ragged consensus attention over a flat page-aligned
token axis [T, L, d].

Counterpart of `glom_tpu/kernels/banded_consensus.py`. The CUDA kernel
`csrc/banded_consensus.cu` replaces `_banded_kernel` (the pallas_call at
:174): token t of page p attends over its row's page band of `window`
slots, slot j * pt + u reading token min(band_page0[p] + j, P - 1) * pt + u,
with q = v = levels and k = l2norm(levels), d^-1/2 scale; the self slot
scores -5e-4 when attend_self is off, then slots past the row length score
finfo(float32).min. The output is cast once.

Three instances (the C entry derives the instance from the dtype, the
page size and d; `k4_instance` repeats the rule for the scratch): "wgmma"
for bf16 at page sizes that are multiples of 64 (the flagship's 64 and its
multiples) up to d = 512, Hopper's tensor cores after a pre-pass that
writes the normalised k rounded to bf16 into a [T, L, d] scratch the
wrapper allocates (`khat_scratch`), with p rounded to bf16 before p . v,
as glom_tpu's bf16 K2 rounds both; "wgmma_wide" the same at 512 < d <=
1024 (glom_tpu's imagenet224-pod width), streaming each key tile's d
through a ring and the output in 512-column groups; "fma" for f32 and for
bf16 at smaller pages, the CUDA cores, everything after the load f32 as in
the Pallas body (16 query rows a block past d = 512).
`banded_ragged_consensus_plain` is the f32 function (the "fma" rounding
points); the card's tests hold "wgmma" to it at a bf16 bar.

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
from glom_tpu_torch.kernels.grouped_mlp import _ptr, refuse_grad
from glom_tpu_torch.utils.helpers import TOKEN_ATTEND_SELF_VALUE

LAUNCHES = 0

TILE = 32  # "fma": query rows per block and key rows per step (csrc/banded_consensus.cu)
WIDE_TILE = 16  # the same past NARROW_DIM
WGMMA_ROWS = 64  # "wgmma": query rows per block and keys per tile
# bytes: "wgmma" reads the levels by TMA, "fma" in vectors of 4 elements
TMA_ALIGN = 16
NARROW_DIM = 512  # the widest d of "wgmma" and of "fma"'s 32-row tiles
MAX_DIM = 1024  # d a multiple of 128, at most this

_NEG_MAX = float(torch.finfo(torch.float32).min)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "banded_consensus_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "banded_consensus_instance": ([_I, _I, _I], ctypes.c_char_p),
    "banded_consensus_wide_launch": ([_P] * 4, _I),
    "banded_consensus_error_string": ([_I], ctypes.c_char_p),
}


def __getattr__(name):
    """K4_INSTANCES: the C entry's instance names by number, read from the C
    source on first use (importing the module opens no file)."""
    if name == "K4_INSTANCES":
        return _build.instance_names("banded_consensus")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _lib() -> ctypes.CDLL:
    return _build.load("banded_consensus", _SIGNATURES)


def wide_launch() -> dict:
    """The launch of K4's "wgmma_wide" on the current card:
    threads a block, dynamic shared memory a block (bytes), blocks a cluster
    (the two 512-column groups, along grid z) and the most such clusters
    the card holds at once (cudaOccupancyMaxActiveClusters)."""
    vals = [ctypes.c_int(0) for _ in range(4)]
    lib = _lib()
    err = lib.banded_consensus_wide_launch(*(ctypes.byref(v) for v in vals))
    _build.check(err, "banded_consensus_wide_launch", lib.banded_consensus_error_string)
    return dict(zip(("threads", "smem_bytes", "cluster", "max_active_clusters"),
                    (v.value for v in vals)))


def k4_instance(dtype: torch.dtype, page_tokens: int, d: int) -> str:
    """The kernel instance for a launch, the C entry's rule (`instance_for`,
    csrc/banded_consensus.cu): "wgmma" for bfloat16 where a page holds
    whole 64-row blocks (page_tokens % 64 == 0) and d <= NARROW_DIM,
    "wgmma_wide" for those pages at NARROW_DIM < d <= MAX_DIM, else "fma".
    Past MAX_DIM it raises ValueError."""
    if d > MAX_DIM:
        raise ValueError(f"d={d}: K4 takes d <= {MAX_DIM}")
    if dtype == torch.bfloat16 and page_tokens % WGMMA_ROWS == 0:
        return "wgmma" if d <= NARROW_DIM else "wgmma_wide"
    return "fma"


def khat_scratch(levels: torch.Tensor, page_tokens: int):
    """The "wgmma" instances' scratch for the normalised keys, [T, L, d]
    bf16 (what the plain version's k gives, rounded once): filled by the
    pre-pass and read by the attention, once a launch. "fma" needs none
    (None)."""
    if k4_instance(levels.dtype, page_tokens, levels.shape[-1]) == "fma":
        return None
    return torch.empty_like(levels, memory_format=torch.contiguous_format)


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
    the levels converted to f32 on load, k normalised, softmax and p . v in
    f32, the output cast once to the levels' dtype. Two sums are taken in
    f64 and rounded once, as the "fma" kernel takes them: each key's
    squared norm and each score's d products (f32 sums of them in two
    orders differ by up to three times K4's f32 bar at d = 1024)."""
    T, L, d = levels.shape
    pt = page_tokens
    P, n_band = _page_counts(T, window, pt)
    band_page0, len_page = page_maps(row_start, row_len, pt)
    dev = levels.device
    kv = levels.float()
    norm = torch.sqrt(torch.sum(kv.double() * kv.double(), dim=-1, keepdim=True)).float()
    k = kv / norm.clamp_min(1e-12)
    raw = band_page0[:, None] + torch.arange(n_band, device=dev, dtype=torch.int32)
    band = raw.clamp(max=P - 1).long()  # [P, n_band] pages read
    q = kv.view(P, pt, L, d)
    kb = k.view(P, pt, L, d)[band].reshape(P, window, L, d)
    vb = q[band].reshape(P, window, L, d)
    s = torch.einsum("pqld,pwld->pqlw", q.double(), kb.double()).float() * d ** -0.5
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
    tile = WIDE_TILE if k4_instance(levels.dtype, page_tokens, d) == "fma" and d > NARROW_DIM \
        else TILE
    if page_tokens > tile and page_tokens % tile:
        raise ValueError(f"page_tokens={page_tokens} must be <= {tile} or a multiple of it")
    if levels.data_ptr() % TMA_ALIGN:
        raise ValueError(f"levels must start on a {TMA_ALIGN}-byte boundary")
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
    # Each block reads its page's entries of the per-token maps (no-ops for
    # the engine's contiguous int32 maps).
    rs = row_start.to(torch.int32).contiguous()
    rl = row_len.to(torch.int32).contiguous()
    out = torch.empty_like(levels)
    khat = khat_scratch(levels, page_tokens)  # held until the launch is enqueued
    lib = _lib()
    err = lib.banded_consensus_fwd(
        levels.data_ptr(), out.data_ptr(), _ptr(khat),
        rs.data_ptr(), rl.data_ptr(), P, page_tokens, L, d, n_band,
        int(bool(attend_self)), int(levels.dtype == torch.bfloat16),
        torch.cuda.current_stream(levels.device).cuda_stream,
    )
    _build.check(err, "banded_consensus_fwd", lib.banded_consensus_error_string)
    _build.count(globals(), "LAUNCHES")
    return out
