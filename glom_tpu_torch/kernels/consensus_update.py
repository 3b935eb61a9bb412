"""K2 forward: consensus attention fused with the 4-way mean column update,
level-major [L, B, n, d].

Counterpart of `glom_tpu/kernels/consensus_update.py` (forward). The CUDA
kernel `csrc/consensus_update.cu` replaces `_consensus_update_kernel` and
`_consensus_update_kernel_streamed`:

    cons = softmax_j(q_i . l2norm(k_j) * d^-1/2 [masks]) @ v
    out  = (levels + bu + pad(td) + cons) / (4, or 3 at the top level)

Per-dtype rules of the reference kernel: k is normalized in f32 and rounded
to the compute dtype; scores and the softmax statistics are f32; p is
rounded to the compute dtype before p @ v; the diagonal is replaced by
-5e-4 when attend_self is off; pairs past the radius get finfo(f32).min.

`fused_consensus_update` runs the plain PyTorch version
`consensus_update_plain` for tensors on the CPU and launches the kernel for
CUDA tensors (raising on anything it does not take). Unlike the TPU
dispatch, it never hands small batches to a dense op: on the card the
kernel runs at every batch. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from glom_tpu_torch.kernels import _build
from glom_tpu_torch.utils.helpers import TOKEN_ATTEND_SELF_VALUE

LAUNCHES = 0

WIDTH_MULTIPLE = 64  # d must be a multiple of this
ROW_TILE = {torch.bfloat16: 32, torch.float32: 16}  # n must be a multiple

_NEG_MAX = torch.finfo(torch.float32).min

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "consensus_update_fwd": (
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_double, _I, _I, _P], _I,
    ),
    "consensus_update_error_string": ([_I], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    return _build.load("consensus_update", _SIGNATURES)


def consensus_update_plain(
    levels_lm: torch.Tensor,
    bu_lm: torch.Tensor,
    td_lm: torch.Tensor,
    *,
    side: int,
    radius: float = 0.0,
    attend_self: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points (one
    j tile: the softmax statistics are taken over the whole row)."""
    L, B, n, d = levels_lm.shape
    dt, f32 = levels_lm.dtype, torch.float32
    kv = levels_lm.to(f32)
    norm = torch.sqrt(torch.sum(kv * kv, dim=-1, keepdim=True))
    k = (kv / torch.clamp_min(norm, 1e-12)).to(dt).to(f32)
    s = torch.matmul(kv, k.transpose(-1, -2)) * d ** -0.5  # [L, B, n, n]
    idx = torch.arange(n, device=levels_lm.device)
    if not attend_self:
        s = s.masked_fill(idx[:, None] == idx[None, :], TOKEN_ATTEND_SELF_VALUE)
    if radius > 0:
        r, c = idx // side, idx % side
        dist2 = (r[:, None] - r[None, :]) ** 2 + (c[:, None] - c[None, :]) ** 2
        s = s.masked_fill(dist2.to(f32) > radius * radius, _NEG_MAX)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    cons = torch.matmul(p.to(dt).to(f32), kv) / p.sum(dim=-1, keepdim=True)
    td = torch.cat([td_lm.to(f32), torch.zeros_like(kv[:1])], dim=0)
    div = torch.full((L, 1, 1, 1), 4.0, device=levels_lm.device)
    div[-1] = 3.0
    return ((((kv + bu_lm.to(f32)) + td) + cons) / div).to(dt)


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def check_kernel_args(levels_lm, bu_lm, td_lm, out, *, side, radius) -> None:
    """Raise ValueError for anything the CUDA kernel does not take."""
    if levels_lm.dim() != 4:
        raise ValueError(f"levels must be [L, B, n, d], got {tuple(levels_lm.shape)}")
    L, B, n, d = levels_lm.shape
    dt = levels_lm.dtype
    if dt not in ROW_TILE:
        raise ValueError(f"dtype {dt}: the kernel takes bfloat16 or float32")
    if L < 2:
        raise ValueError("levels must be >= 2")
    want = {"bu": (L, B, n, d), "td": (L - 1, B, n, d), "out": (L, B, n, d)}
    got = {"bu": bu_lm, "td": td_lm, "out": out}
    for name, shape in want.items():
        t = got[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    for name, t in dict(got, levels=levels_lm).items():
        if t.dtype != dt:
            raise ValueError(f"{name} dtype {t.dtype} != levels dtype {dt}")
        if t.device != levels_lm.device:
            raise ValueError(f"{name} on {t.device}, levels on {levels_lm.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("levels", "bu", "td"):
        if _overlaps(out, dict(got, levels=levels_lm)[name]):
            raise ValueError(f"out must not alias {name}: other row tiles still read it")
    if d % WIDTH_MULTIPLE:
        raise ValueError(f"d={d} must be a multiple of {WIDTH_MULTIPLE}")
    if n % ROW_TILE[dt]:
        raise ValueError(f"n={n} must be a multiple of {ROW_TILE[dt]} in {dt}")
    if radius > 0 and side * side != n:
        raise ValueError(f"a local radius needs n = side^2, got n={n}, side={side}")


def fused_consensus_update(
    levels_lm: torch.Tensor,
    bu_lm: torch.Tensor,
    td_lm: torch.Tensor,
    *,
    side: int,
    radius: float = 0.0,
    attend_self: bool = False,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """new_levels = (levels + bu + pad(td) + consensus(levels)) / div.

    levels_lm, bu_lm: [L, B, n, d]; td_lm: [L-1, B, n, d]. Returns
    [L, B, n, d], written into `out` when given (it must not overlap the
    inputs)."""
    global LAUNCHES
    if levels_lm.device.type == "cpu":
        new = consensus_update_plain(
            levels_lm, bu_lm, td_lm, side=side, radius=radius, attend_self=attend_self
        )
        return new if out is None else out.copy_(new)
    if levels_lm.device.type != "cuda":
        raise ValueError(f"no kernel for device {levels_lm.device}")
    if out is None:
        out = torch.empty_like(levels_lm)
    check_kernel_args(levels_lm, bu_lm, td_lm, out, side=side, radius=radius)
    lib = _lib()
    L, B, n, d = levels_lm.shape
    is_bf16 = int(levels_lm.dtype == torch.bfloat16)
    err = lib.consensus_update_fwd(
        levels_lm.data_ptr(), bu_lm.data_ptr(), td_lm.data_ptr(), out.data_ptr(),
        L, B, n, d, side, float(radius), int(attend_self), is_bf16,
        torch.cuda.current_stream(levels_lm.device).cuda_stream,
    )
    _build.check(err, "consensus_update_fwd", lib.consensus_update_error_string)
    LAUNCHES += 1
    return out
