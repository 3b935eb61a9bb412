"""K2: consensus attention fused with the 4-way mean column update,
level-major [L, B, n, d], and its VJP.

Counterpart of `glom_tpu/kernels/consensus_update.py` (forward). The CUDA
kernel `csrc/consensus_update.cu` replaces `_consensus_update_kernel` and
`_consensus_update_kernel_streamed`:

    cons = softmax_j(q_i . l2norm(k_j) * d^-1/2 [masks]) @ v
    out  = (levels + bu + pad(td) + cons) / (4, or 3 at the top level)

Per-dtype rules of the reference kernel: k is normalized in f32 and rounded
to the compute dtype; scores and the softmax statistics are f32; p is
rounded to the compute dtype before p @ v; the diagonal is replaced by
-5e-4 when attend_self is off; pairs past the radius get finfo(f32).min.
For training the forward also writes the f32 row statistics m, l.

`csrc/consensus_update_bwd.cu` replaces the backward kernels
`_consensus_bwd_small_kernel`, `_consensus_bwd_dq_kernel` and
`_consensus_bwd_dkv_kernel` with two passes that cover every n: the dq pass
(f32 dq and dd) and the dkv pass (dv, dk through the norm VJP, and the
complete dlevels = dmean + dq + dv + normVJP(dk), plus dmean). Its
arithmetic is the single-tile kernel's (`_small_bwd_math`). Their combine
mode is glom_tpu's `fused_loop._cons_bwd_combine_kernel`, the whole-loop
VJP's consensus backward: the output cotangent of a level is the sum, in
f32, of the previous iteration's dlevels and the slot-shifted input
cotangents of the two FFWs (`dx_bu`, `dx_td`).
`consensus_update_vjp` is the differentiable entry, the twin of `_fused`:
d(bu) = dmean and d(td) = dmean[:L-1].

`fused_consensus_update` and `consensus_update_bwd` run the plain PyTorch
versions (`consensus_update_plain`, `consensus_update_bwd_plain`) for
tensors on the CPU and launch the kernels for CUDA tensors (raising on
anything they do not take). Unlike the TPU dispatch, they never hand small
batches to a dense op: on the card the kernels run at every batch. The raw
forward refuses an input that requires grad while grad mode is on.
`LAUNCHES` counts forward launches, `LAUNCHES_BWD_DQ` and
`LAUNCHES_BWD_DKV` the two backward passes, and `LAUNCHES_BWD_COMBINE_DQ`
and `LAUNCHES_BWD_COMBINE_DKV` those launched in combine mode (counted
there only).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels.grouped_mlp import _ptr, refuse_grad
from glom_tpu_torch.utils.helpers import TOKEN_ATTEND_SELF_VALUE

LAUNCHES = 0
LAUNCHES_BWD_DQ = 0
LAUNCHES_BWD_DKV = 0
LAUNCHES_BWD_COMBINE_DQ = 0
LAUNCHES_BWD_COMBINE_DKV = 0

WIDTH_MULTIPLE = 64  # d must be a multiple of this
ROW_TILE = {torch.bfloat16: 32, torch.float32: 16}  # n must be a multiple

_NEG_MAX = torch.finfo(torch.float32).min

_P, _I = ctypes.c_void_p, ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "consensus_update_fwd": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _I, _I, _P], _I,
    ),
    "consensus_update_error_string": ([_I], ctypes.c_char_p),
}
_BWD_SIGNATURES = {
    "consensus_update_bwd_dq": ([*[_P] * 9, _I, _I, _I, _I, _I, _D, _I, _I, _P], _I),
    "consensus_update_bwd_dkv": ([*[_P] * 11, _I, _I, _I, _I, _I, _D, _I, _I, _P], _I),
    "consensus_update_bwd_error_string": ([_I], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    return _build.load("consensus_update", _SIGNATURES)


def _bwd_lib() -> ctypes.CDLL:
    return _build.load("consensus_update_bwd", _BWD_SIGNATURES)


def _masked_scores(levels_lm, k, *, side, radius, attend_self):
    """f32 scores s = q . k^T * d^-1/2 with the kernels' masks; q = levels."""
    n, d = levels_lm.shape[-2:]
    s = torch.matmul(levels_lm.float(), k.transpose(-1, -2)) * d ** -0.5
    idx = torch.arange(n, device=levels_lm.device)
    diag = idx[:, None] == idx[None, :]
    if not attend_self:
        s = s.masked_fill(diag, TOKEN_ATTEND_SELF_VALUE)
    if radius > 0:
        r, c = idx // side, idx % side
        dist2 = (r[:, None] - r[None, :]) ** 2 + (c[:, None] - c[None, :]) ** 2
        s = s.masked_fill(dist2.to(torch.float32) > radius * radius, _NEG_MAX)
    return s, diag


def _normalized_k(levels_lm):
    """k = levels / max(||levels||, 1e-12) in f32, rounded to the dtype."""
    kv = levels_lm.float()
    norm = torch.sqrt(torch.sum(kv * kv, dim=-1, keepdim=True))
    return (kv / torch.clamp_min(norm, 1e-12)).to(levels_lm.dtype).float()


def _divisor(L, device):
    div = torch.full((L, 1, 1, 1), 4.0, device=device)
    div[-1] = 3.0
    return div


def consensus_update_plain(
    levels_lm: torch.Tensor,
    bu_lm: torch.Tensor,
    td_lm: torch.Tensor,
    *,
    side: int,
    radius: float = 0.0,
    attend_self: bool = False,
    stats: bool = False,
):
    """The kernel's function in plain PyTorch, with its rounding points (one
    j tile: the softmax statistics are taken over the whole row).
    stats=True returns (out, m, l) with the f32 row statistics [L, B, n, 1]."""
    L = levels_lm.shape[0]
    dt, f32 = levels_lm.dtype, torch.float32
    kv = levels_lm.to(f32)
    s, _ = _masked_scores(
        levels_lm, _normalized_k(levels_lm), side=side, radius=radius,
        attend_self=attend_self,
    )  # [L, B, n, n]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    cons = torch.matmul(p.to(dt).to(f32), kv) / l
    td = torch.cat([td_lm.to(f32), torch.zeros_like(kv[:1])], dim=0)
    out = ((((kv + bu_lm.to(f32)) + td) + cons) / _divisor(L, levels_lm.device)).to(dt)
    return (out, m, l) if stats else out


def _cotangent(g, dx_bu, dx_td):
    """The f32 output cotangent of each level: g alone, or, in combine mode,
    g + dx_bu[level + 1] (below the top) + dx_td[level - 1] (above level 0),
    summed in that order as the kernels sum it."""
    cot = g.to(torch.float32)
    if dx_bu is not None:
        cot = cot.clone()
        cot[:-1] += dx_bu[1:].to(torch.float32)
        cot[1:] += dx_td.to(torch.float32)
    return cot


def _bwd_terms(levels_lm, g, m, l, *, side, radius, attend_self, dx_bu=None, dx_td=None):
    """What both backward passes recompute: f32 x, k, p, dcons and its
    rounding, dP, and ds rounded to the levels dtype (needs dd: None)."""
    L = levels_lm.shape[0]
    dt, f32 = levels_lm.dtype, torch.float32
    x = levels_lm.to(f32)
    k = _normalized_k(levels_lm)
    s, diag = _masked_scores(
        levels_lm, k, side=side, radius=radius, attend_self=attend_self
    )
    p = torch.exp(s - m) / l  # [L, B, n(i), n(j)]
    dcons = _cotangent(g, dx_bu, dx_td) / _divisor(L, levels_lm.device)
    dcr = dcons.to(dt).to(f32)
    dp = torch.matmul(dcr, x.transpose(-1, -2))  # dP_ij = dcons_i . v_j

    def ds_rounded(dd):
        ds = p * (dp - dd)
        if not attend_self:
            ds = ds.masked_fill(diag, 0.0)  # the diagonal's score was a constant
        return ds.to(dt).to(f32)

    return x, k, p, dcons, dcr, dp, ds_rounded


def consensus_bwd_dq_plain(
    levels_lm, g, m, l, *, side, radius=0.0, attend_self=False, dx_bu=None, dx_td=None
):
    """The dq pass in plain PyTorch (glom_tpu's _small_bwd_math up to dq):
    f32 dq = scale * ds . k and dd = rowsum(p * dP), the full sum."""
    _, k, p, _, _, dp, ds_rounded = _bwd_terms(
        levels_lm, g, m, l, side=side, radius=radius, attend_self=attend_self,
        dx_bu=dx_bu, dx_td=dx_td,
    )
    dd = (p * dp).sum(dim=-1, keepdim=True)
    return torch.matmul(ds_rounded(dd), k) * levels_lm.shape[-1] ** -0.5, dd


def consensus_bwd_dkv_plain(
    levels_lm, g, m, l, dq, dd, *, side, radius=0.0, attend_self=False, dx_bu=None,
    dx_td=None, parts=False,
):
    """The dkv pass in plain PyTorch: dv, dk through the VJP of the k
    normalization (glom_tpu's _norm_vjp), and (dlevels = dcons + dq + dv +
    normVJP(dk), dmean = dcons) in the levels dtype. parts=True also
    returns {"dv": ..., "dxn": ...} in f32."""
    dt = levels_lm.dtype
    x, _, p, dcons, dcr, _, ds_rounded = _bwd_terms(
        levels_lm, g, m, l, side=side, radius=radius, attend_self=attend_self,
        dx_bu=dx_bu, dx_td=dx_td,
    )
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dcr)  # unmasked p
    dk = torch.matmul(ds_rounded(dd).transpose(-1, -2), x) * levels_lm.shape[-1] ** -0.5
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    inv = 1.0 / torch.clamp_min(norm, 1e-12)
    a = torch.sum(dk * x, dim=-1, keepdim=True)
    dxn = dk * inv - torch.where(norm >= 1e-12, a * x * inv * inv / norm, 0.0)
    out = ((dcons + dq + dv + dxn).to(dt), dcons.to(dt))
    return (*out, {"dv": dv, "dxn": dxn}) if parts else out


def consensus_update_bwd_plain(
    levels_lm: torch.Tensor,
    g: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    *,
    side: int,
    radius: float = 0.0,
    attend_self: bool = False,
    dx_bu: Optional[torch.Tensor] = None,
    dx_td: Optional[torch.Tensor] = None,
):
    """The backward kernels' function in plain PyTorch, with their rounding
    points (glom_tpu's _small_bwd_math and _norm_vjp): for the output
    cotangent g [L, B, n, d] and the forward's row statistics m, l
    [L, B, n, 1], returns (dlevels, dmean) in the levels dtype. With the
    combine's streams dx_bu [L, B, n, d] and dx_td [L-1, B, n, d], the
    cotangent is their f32 sum with g (glom_tpu's _cons_bwd_combine_kernel)."""
    kw = dict(side=side, radius=radius, attend_self=attend_self, dx_bu=dx_bu, dx_td=dx_td)
    dq, dd = consensus_bwd_dq_plain(levels_lm, g, m, l, **kw)
    return consensus_bwd_dkv_plain(levels_lm, g, m, l, dq, dd, **kw)


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def _check_levels(levels_lm, *, side, radius) -> None:
    """Raise ValueError for levels every K2 kernel refuses."""
    if levels_lm.dim() != 4:
        raise ValueError(f"levels must be [L, B, n, d], got {tuple(levels_lm.shape)}")
    L, B, n, d = levels_lm.shape
    dt = levels_lm.dtype
    if dt not in ROW_TILE:
        raise ValueError(f"dtype {dt}: the kernel takes bfloat16 or float32")
    if L < 2:
        raise ValueError("levels must be >= 2")
    if not levels_lm.is_contiguous():
        raise ValueError("levels must be contiguous")
    if d % WIDTH_MULTIPLE:
        raise ValueError(f"d={d} must be a multiple of {WIDTH_MULTIPLE}")
    if n % ROW_TILE[dt]:
        raise ValueError(f"n={n} must be a multiple of {ROW_TILE[dt]} in {dt}")
    if radius > 0 and side * side != n:
        raise ValueError(f"a local radius needs n = side^2, got n={n}, side={side}")


def check_kernel_args(levels_lm, bu_lm, td_lm, out, *, side, radius) -> None:
    """Raise ValueError for anything the CUDA kernel does not take."""
    _check_levels(levels_lm, side=side, radius=radius)
    L, B, n, d = levels_lm.shape
    dt = levels_lm.dtype
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


def fused_consensus_update(
    levels_lm: torch.Tensor,
    bu_lm: torch.Tensor,
    td_lm: torch.Tensor,
    *,
    side: int,
    radius: float = 0.0,
    attend_self: bool = False,
    out: Optional[torch.Tensor] = None,
    stats: bool = False,
):
    """new_levels = (levels + bu + pad(td) + consensus(levels)) / div.

    levels_lm, bu_lm: [L, B, n, d]; td_lm: [L-1, B, n, d]. Returns
    [L, B, n, d], written into `out` when given (it must not overlap the
    inputs); stats=True returns (out, m, l) with the f32 row statistics
    [L, B, n, 1] the backward reads."""
    global LAUNCHES
    refuse_grad(levels_lm, bu_lm, td_lm)
    if levels_lm.device.type == "cpu":
        res = consensus_update_plain(
            levels_lm, bu_lm, td_lm, side=side, radius=radius,
            attend_self=attend_self, stats=stats,
        )
        if out is None:
            return res
        if stats:
            return (out.copy_(res[0]), *res[1:])
        return out.copy_(res)
    if levels_lm.device.type != "cuda":
        raise ValueError(f"no kernel for device {levels_lm.device}")
    if out is None:
        out = torch.empty_like(levels_lm)
    check_kernel_args(levels_lm, bu_lm, td_lm, out, side=side, radius=radius)
    lib = _lib()
    L, B, n, d = levels_lm.shape
    m = l = None
    if stats:
        m = levels_lm.new_empty((L, B, n, 1), dtype=torch.float32)
        l = torch.empty_like(m)
    is_bf16 = int(levels_lm.dtype == torch.bfloat16)
    err = lib.consensus_update_fwd(
        levels_lm.data_ptr(), bu_lm.data_ptr(), td_lm.data_ptr(), out.data_ptr(),
        None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
        L, B, n, d, side, float(radius), int(attend_self), is_bf16,
        torch.cuda.current_stream(levels_lm.device).cuda_stream,
    )
    _build.check(err, "consensus_update_fwd", lib.consensus_update_error_string)
    LAUNCHES += 1
    return (out, m, l) if stats else out


def _check_bwd_args(levels_lm, g, m, l, side, radius, dx_bu, dx_td, combine, dcons=None) -> None:
    """Raise ValueError for anything the backward kernels do not take."""
    _check_levels(levels_lm, side=side, radius=radius)
    L, B, n, d = levels_lm.shape
    if (dx_bu is None) != (dx_td is None):
        raise ValueError("dx_bu and dx_td come together")
    if dx_bu is not None and not combine:
        raise ValueError("the dx_bu/dx_td streams are the combine's: pass combine=True")
    checks = [
        ("g", g, (L, B, n, d), levels_lm.dtype),
        ("m", m, (L, B, n, 1), torch.float32),
        ("l", l, (L, B, n, 1), torch.float32),
    ]
    if dx_bu is not None:
        checks += [("dx_bu", dx_bu, (L, B, n, d), levels_lm.dtype),
                   ("dx_td", dx_td, (L - 1, B, n, d), levels_lm.dtype)]
    if dcons is not None:
        checks.append(("dcons", dcons, (L, B, n, d), levels_lm.dtype))
    for name, t, shape, dtype in checks:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != levels_lm.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {levels_lm.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def consensus_bwd_dq(
    levels_lm, g, m, l, *, side, radius=0.0, attend_self=False, dx_bu=None, dx_td=None,
    combine=False,
):
    """The dq pass on the card: (f32 dq [L, B, n, d], f32 dd [L, B, n, 1],
    dcons [L, B, n, d] rounded to the levels dtype, which the dkv pass
    reads). combine=True is the whole-loop VJP's launch (with or without
    streams)."""
    global LAUNCHES_BWD_DQ, LAUNCHES_BWD_COMBINE_DQ
    _check_bwd_args(levels_lm, g, m, l, side, radius, dx_bu, dx_td, combine)
    lib = _bwd_lib()
    L, B, n, d = levels_lm.shape
    dq = levels_lm.new_empty((L, B, n, d), dtype=torch.float32)
    dd = levels_lm.new_empty((L, B, n, 1), dtype=torch.float32)
    dcons = torch.empty_like(levels_lm)
    err = lib.consensus_update_bwd_dq(
        levels_lm.data_ptr(), g.data_ptr(), _ptr(dx_bu), _ptr(dx_td), m.data_ptr(),
        l.data_ptr(), dq.data_ptr(), dd.data_ptr(), dcons.data_ptr(), L, B, n, d, side,
        float(radius),
        int(attend_self), int(levels_lm.dtype == torch.bfloat16),
        torch.cuda.current_stream(levels_lm.device).cuda_stream,
    )
    _build.check(err, "consensus_update_bwd_dq", lib.consensus_update_bwd_error_string)
    if combine:
        LAUNCHES_BWD_COMBINE_DQ += 1
    else:
        LAUNCHES_BWD_DQ += 1
    return dq, dd, dcons


def consensus_bwd_dkv(
    levels_lm, g, m, l, dq, dd, dcons, *, side, radius=0.0, attend_self=False, dx_bu=None,
    dx_td=None, combine=False,
):
    """The dkv pass on the card, from the dq pass's outputs: (dlevels,
    dmean) in the levels dtype."""
    global LAUNCHES_BWD_DKV, LAUNCHES_BWD_COMBINE_DKV
    _check_bwd_args(levels_lm, g, m, l, side, radius, dx_bu, dx_td, combine, dcons)
    for name, t in (("dq", dq), ("dd", dd)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    lib = _bwd_lib()
    L, B, n, d = levels_lm.shape
    dlv = torch.empty_like(levels_lm)
    dmean = torch.empty_like(levels_lm)
    err = lib.consensus_update_bwd_dkv(
        levels_lm.data_ptr(), g.data_ptr(), _ptr(dx_bu), _ptr(dx_td), m.data_ptr(),
        l.data_ptr(), dq.data_ptr(), dd.data_ptr(), dcons.data_ptr(), dlv.data_ptr(),
        dmean.data_ptr(),
        L, B, n, d, side, float(radius), int(attend_self),
        int(levels_lm.dtype == torch.bfloat16),
        torch.cuda.current_stream(levels_lm.device).cuda_stream,
    )
    _build.check(err, "consensus_update_bwd_dkv", lib.consensus_update_bwd_error_string)
    if combine:
        LAUNCHES_BWD_COMBINE_DKV += 1
    else:
        LAUNCHES_BWD_DKV += 1
    return dlv, dmean


def consensus_update_bwd(
    levels_lm, g, m, l, *, side, radius=0.0, attend_self=False, dx_bu=None, dx_td=None,
    combine=False,
):
    """The VJP of `fused_consensus_update` for the output cotangent g:
    (dlevels, dmean), as `consensus_update_bwd_plain`. On the card: the dq
    pass, then the dkv pass.
    combine=True is the whole-loop VJP's call: it
    may add the streams dx_bu [L, B, n, d] and dx_td [L-1, B, n, d] to g
    (the loop's first backward iteration has none) and counts its launches
    as the combine's. levels_lm, g and the streams may be contiguous views
    of larger buffers (the loop's carry slots)."""
    kw = dict(side=side, radius=radius, attend_self=attend_self)
    if levels_lm.device.type == "cpu":
        if dx_bu is not None and not combine:
            raise ValueError("the dx_bu/dx_td streams are the combine's: pass combine=True")
        return consensus_update_bwd_plain(levels_lm, g, m, l, dx_bu=dx_bu, dx_td=dx_td, **kw)
    if levels_lm.device.type != "cuda":
        raise ValueError(f"no kernel for device {levels_lm.device}")
    kw.update(dx_bu=dx_bu, dx_td=dx_td, combine=combine)
    dq, dd, dcons = consensus_bwd_dq(levels_lm, g, m, l, **kw)
    return consensus_bwd_dkv(levels_lm, g, m, l, dq, dd, dcons, **kw)


class _ConsensusUpdate(torch.autograd.Function):
    """The differentiable fused consensus update: glom_tpu's _fused
    (custom_vjp). The mean is linear, so d(bu) = dmean = g / div and d(td)
    is its first L-1 levels; bu and td are not saved."""

    @staticmethod
    def forward(ctx, levels_lm, bu_lm, td_lm, side, radius, attend_self):
        out, m, l = fused_consensus_update(
            levels_lm, bu_lm, td_lm, side=side, radius=radius,
            attend_self=attend_self, stats=True,
        )
        ctx.save_for_backward(levels_lm, m, l)
        ctx.geometry = dict(side=side, radius=radius, attend_self=attend_self)
        return out

    @staticmethod
    def backward(ctx, g):
        levels_lm, m, l = ctx.saved_tensors
        dlv, dmean = consensus_update_bwd(
            levels_lm, g.contiguous().to(levels_lm.dtype), m, l, **ctx.geometry
        )
        return dlv, dmean, dmean[:-1], None, None, None


def consensus_update_vjp(
    levels_lm: torch.Tensor,
    bu_lm: torch.Tensor,
    td_lm: torch.Tensor,
    *,
    side: int,
    radius: float = 0.0,
    attend_self: bool = False,
) -> torch.Tensor:
    """`fused_consensus_update` with a gradient: the kernels' forward and
    backward under autograd (plain versions for CPU tensors)."""
    return _ConsensusUpdate.apply(
        levels_lm, bu_lm, td_lm, side, float(radius), bool(attend_self)
    )
