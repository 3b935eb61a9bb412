"""K1: the fused grouped per-level MLP, level-major [G, M, d], and its VJP.

Counterpart of `glom_tpu/kernels/grouped_mlp.py`. The CUDA kernel
`csrc/grouped_mlp.cu` replaces both `_mlp_kernel` (bottom-up) and
`_mlp_kernel_add` (top-down, positional addend folded into the load):

    out[g] = GELU((x[g] + tile(add)) @ w1[g] + b1[g]) @ w2[g] + b2[g]

Per-dtype rules of the reference kernel: bf16 uses the tanh GELU, f32 the
exact erf; both products accumulate in f32, the hidden is rounded to x's
dtype before the second. In bf16 the kernel is two passes of the Hopper
GEMM mainloop (`csrc/sm90_gemm.cuh`: TMA, mbarriers, wgmma), the rounded
hidden written once to a [G, R, f] scratch between them; past
`H_SCRATCH_CAP` the passes run over row slabs of R rows (`slab_rows`). The
wrapper allocates that scratch, and for the addend's groups an [split, R,
d] scratch of x + tile(add), with `torch.empty`. f32 runs on the CUDA
cores with the [G, M, f] hidden kept in shared memory. For training the
forward can also write the pre-activation [G, M, f], and
`grouped_mlp_pre` runs only its first product (glom_tpu's
`fused_loop._pre_kernel`/`_pre_add_kernel`, the whole-loop VJP's remat
recompute): a pre bit for bit equal to the one the forward saves.

`csrc/grouped_mlp_bwd.cu` replaces the backward kernels `_mlp_bwd_kernel`,
`_mlp_bwd_kernel_saved` and `_mlp_bwd_kernel_saved_add`: dx, the four
weight and bias grads (f32 sums, cast to the parameter dtype) and, with an
addend, da. In bf16 from the saved pre it is three passes of the same GEMM
mainloop (dh with the GELU derivative, dx, and dw1 and dw2 in one grid,
reading w1, w2 K-major and xa, h MN-major); the bf16 recompute and f32
paths run a row pass and a weight pass. The scratch each call hands
between its launches comes from `bwd_workspaces`. `grouped_ffw_lm_vjp` is
the differentiable entry, the twin of `_fused_lm`/`_fused_lm_add`: it
saves the pre-activation where `_fwd` does (bf16 under a 512 MB cap) and
recomputes it otherwise. With `acc` (f32 weight-gradient totals) the
backward adds its gradients into them in place (glom_tpu's
`fused_loop._ffw_bwd_acc_kernel`/`_ffw_bwd_acc_add_kernel`), and with an
addend its da into `da_in`.

With `cat=True` the three launches run over the whole-loop VJP's combined
td || bu grid (glom_tpu's `fused_loop._ffw_fwd_cat`, `_pre_fwd_cat`,
`_ffw_bwd_cat`): the weights hold 2L-1 groups, the L-1 top-down ones first
(`cat_params`), x is the loop's [L+1, M, d] slot carry, read in place by
the kernels' group rule (top-down group g reads slot g + 2 with the addend,
bottom-up group g' reads slot g'), and the backward's cotangent is dmean
[L, M, d] (top-down group g reads level g, bottom-up group g' level g').
Each group's arithmetic is the split launches', so the results are theirs
bit for bit; the plain versions are the two split calls on views.

`fused_grouped_ffw_lm` and `grouped_mlp_bwd` run the plain PyTorch versions
(`grouped_mlp_plain`, `grouped_mlp_bwd_plain`) for tensors on the CPU and
launch the kernels for CUDA tensors (raising on anything they do not take).
The raw forward writes through a pointer autograd cannot see, so it refuses
an input that requires grad while grad mode is on. `LAUNCHES` counts
forward launches, `LAUNCHES_ADD` those with an addend; `LAUNCHES_PRE` and
`LAUNCHES_PRE_ADD` the pre-only launches; `LAUNCHES_BWD` and
`LAUNCHES_BWD_ADD` backward launches, and `LAUNCHES_BWD_ACC` and
`LAUNCHES_BWD_ACC_ADD` those in accumulate mode (counted there only).
`LAUNCHES_CAT`, `LAUNCHES_PRE_CAT` and `LAUNCHES_BWD_ACC_CAT` count the
combined-grid launches, which count in `LAUNCHES`, `LAUNCHES_PRE` and
`LAUNCHES_BWD_ACC` too, but not in the `_ADD` counts. Every count moves
through `_build.count`, under one lock, so engines launching from several
threads lose no increment.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from glom_tpu_torch.kernels import _build
from glom_tpu_torch.ops.ffw import GroupedFFWParams

LAUNCHES = 0
LAUNCHES_ADD = 0
LAUNCHES_PRE = 0
LAUNCHES_PRE_ADD = 0
LAUNCHES_BWD = 0
LAUNCHES_BWD_ADD = 0
LAUNCHES_BWD_ACC = 0
LAUNCHES_BWD_ACC_ADD = 0
LAUNCHES_CAT = 0
LAUNCHES_PRE_CAT = 0
LAUNCHES_BWD_ACC_CAT = 0

ROW_TILE = 32  # M must be a multiple of this (the f32 kernel's rows a block)
WIDTH_MULTIPLE = 64  # d and f must be multiples of this
GEMM_ROW_TILE = 128  # the bf16 GEMM's rows a tile (csrc/sm90_gemm.cuh BM)
# Cap on the bf16 forward's [G, R, f] hidden scratch: past it the two
# passes run over row slabs (`slab_rows`).
H_SCRATCH_CAP = 256 * 1024 * 1024
# Per-call cap on the saved [G, M, f] pre-activation (glom_tpu's
# _SAVE_PRE_LIMIT): past it the backward recomputes the first product.
SAVE_PRE_LIMIT = 512 * 1024 * 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "grouped_mlp_fwd": ([_P, _P, _I, *[_P] * 8, *[_I] * 8, _P], _I),
    "grouped_mlp_pre": ([_P, _P, _I, *[_P] * 4, *[_I] * 8, _P], _I),
    "grouped_mlp_error_string": ([_I], ctypes.c_char_p),
}
_BWD_SIGNATURES = {
    "grouped_mlp_bwd": ([_P, _P, _I, *[_P] * 15, *[_I] * 8, _P], _I),
    "grouped_mlp_bwd_error_string": ([_I], ctypes.c_char_p),
}
# The combined grid's top-down groups read carry slots 2..L (glom_tpu's
# `_cat_x_spec`).
CAT_TD_SLOT = 2


def _lib() -> ctypes.CDLL:
    return _build.load("grouped_mlp", _SIGNATURES)


def _bwd_lib() -> ctypes.CDLL:
    return _build.load("grouped_mlp_bwd", _BWD_SIGNATURES)


def refuse_grad(*tensors) -> None:
    """Raise when grad mode is on and an input requires grad: a raw kernel
    writes through a pointer autograd cannot see, so its result would carry
    no gradient. The autograd Functions call the kernels with grad off."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            "a raw kernel wrapper got an input that requires grad under grad "
            "mode; differentiate through the autograd entry instead"
        )


def gelu_value_and_grad(z: torch.Tensor, *, tanh_form: bool):
    """GELU and its derivative in f32 (glom_tpu's _gelu_value_and_grad):
    the tanh form in bf16, the erf form in f32."""
    if tanh_form:
        c, k = 0.7978845608028654, 0.044715
        t = torch.tanh(c * (z + k * z * z * z))
        val = 0.5 * z * (1.0 + t)
        grad = 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * c * (1.0 + 3.0 * k * z * z)
        return val, grad
    phi = torch.exp(-0.5 * z * z) * (2.0 * torch.pi) ** -0.5
    cdf = 0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
    return z * cdf, cdf + z * phi


def _with_addend(x: torch.Tensor, add: Optional[torch.Tensor]) -> torch.Tensor:
    """x + tile(add), rounded once to x's dtype, as the kernels load it."""
    if add is None:
        return x
    return (x + add.repeat(x.shape[1] // add.shape[0], 1)[None]).to(x.dtype)


def cat_params(td_params: GroupedFFWParams, bu_params: GroupedFFWParams) -> GroupedFFWParams:
    """The combined grid's weights: each leaf's top-down groups, then its
    bottom-up ones (glom_tpu's `_cat_params`)."""
    return GroupedFFWParams(*(torch.cat([t, b]) for t, b in zip(td_params, bu_params)))


def cat_split(params: GroupedFFWParams) -> int:
    """The combined grid's top-down group count, L - 1 of its 2L - 1."""
    G = params.w1.shape[0]
    if G < 3 or G % 2 == 0:
        raise ValueError(f"a combined grid has 2L-1 >= 3 groups, got {G}")
    return (G - 1) // 2


def _cat_views(params: GroupedFFWParams, x: torch.Tensor):
    """The combined grid as its two split launches: (top-down params, their
    slot view of the carry, bottom-up params, theirs)."""
    split = cat_split(params)
    td = GroupedFFWParams(*(t[:split] for t in params))
    bu = GroupedFFWParams(*(t[split:] for t in params))
    return td, x[CAT_TD_SLOT:CAT_TD_SLOT + split], bu, x[:split + 1]


def grouped_mlp_plain(
    params: GroupedFFWParams,
    x: torch.Tensor,
    add: Optional[torch.Tensor] = None,
    *,
    save_pre: bool = False,
    cat: bool = False,
):
    """The kernel's function in plain PyTorch, with its rounding points.
    save_pre=True also returns the pre-activation [G, M, f] in x's dtype.
    cat=True: the combined grid, as its two split calls."""
    if cat:
        td, x_td, bu, x_bu = _cat_views(params, x)
        parts = (grouped_mlp_plain(td, x_td, add, save_pre=save_pre),
                 grouped_mlp_plain(bu, x_bu, save_pre=save_pre))
        if save_pre:
            return tuple(torch.cat(p) for p in zip(*parts))
        return torch.cat(parts)
    w1, b1, w2, b2 = params
    f32 = torch.float32
    x = _with_addend(x, add)
    pre = torch.bmm(x.to(f32), w1.to(f32)) + b1.to(f32)[:, None, :]
    h = F.gelu(pre, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
    h = h.to(x.dtype)
    out = torch.bmm(h.to(f32), w2.to(f32)) + b2.to(f32)[:, None, :]
    out = out.to(x.dtype)
    return (out, pre.to(x.dtype)) if save_pre else out


def grouped_mlp_pre_plain(
    params: GroupedFFWParams, x: torch.Tensor, add: Optional[torch.Tensor] = None,
    *, cat: bool = False,
) -> torch.Tensor:
    """The pre-only kernel's function: pre = (x + tile(add)) @ w1 + b1,
    summed in f32 and rounded to x's dtype, as `grouped_mlp_plain` saves it."""
    if cat:
        td, x_td, bu, x_bu = _cat_views(params, x)
        return torch.cat([grouped_mlp_pre_plain(td, x_td, add), grouped_mlp_pre_plain(bu, x_bu)])
    f32 = torch.float32
    xa = _with_addend(x, add)
    pre = torch.bmm(xa.to(f32), params.w1.to(f32)) + params.b1.to(f32)[:, None, :]
    return pre.to(x.dtype)


def grouped_mlp_bwd_plain(
    params: GroupedFFWParams,
    x: torch.Tensor,
    g: torch.Tensor,
    add: Optional[torch.Tensor] = None,
    pre: Optional[torch.Tensor] = None,
    acc: Optional[GroupedFFWParams] = None,
    da_in: Optional[torch.Tensor] = None,
    *,
    cat: bool = False,
):
    """The backward kernel's function in plain PyTorch, with its rounding
    points (glom_tpu's _mlp_bwd_tail): h and dpre rounded to x's dtype,
    every product and sum in f32. `pre` is the forward's saved
    pre-activation, or None to recompute it. Returns (dx, grads, da): grads
    in the parameter dtypes, da [n, d] (the addend's dtype) or None.

    Accumulate mode (`acc`, f32 totals shaped like the params; with an
    addend also `da_in`, f32 [n, d]): this call's f32 gradients are added
    to them in place, as the kernel does, and grads = acc, da = da_in.
    cat=True (accumulate mode only): the combined grid as its two split
    calls, each adding into its part of `acc`."""
    if cat:
        td, x_td, bu, x_bu = _cat_views(params, x)
        split = cat_split(params)
        pre_td, pre_bu = (None, None) if pre is None else (pre[:split], pre[split:])
        dx_td, _, da = grouped_mlp_bwd_plain(
            td, x_td, g[:split], add, pre_td, GroupedFFWParams(*(t[:split] for t in acc)), da_in)
        dx_bu, _, _ = grouped_mlp_bwd_plain(
            bu, x_bu, g[:split + 1], None, pre_bu, GroupedFFWParams(*(t[split:] for t in acc)))
        return torch.cat([dx_td, dx_bu]), acc, da
    w1, b1, w2, b2 = params
    f32 = torch.float32
    G, M, d = x.shape
    xa = _with_addend(x, add)
    if pre is None:
        z = torch.bmm(xa.to(f32), w1.to(f32)) + b1.to(f32)[:, None, :]
    else:
        z = pre.to(f32)
    val, grad = gelu_value_and_grad(z, tanh_form=x.dtype == torch.bfloat16)
    h = val.to(x.dtype).to(f32)
    g32 = g.to(f32)
    dh = torch.bmm(g32, w2.to(f32).transpose(1, 2))
    dpre = (dh * grad).to(x.dtype).to(f32)
    dx32 = torch.bmm(dpre, w1.to(f32).transpose(1, 2))
    sums = (
        torch.bmm(xa.to(f32).transpose(1, 2), dpre),
        dpre.sum(dim=1),
        torch.bmm(h.transpose(1, 2), g32),
        g32.sum(dim=1),
    )
    da32 = None
    if add is not None:
        n = add.shape[0]
        da32 = dx32.reshape(G, M // n, n, d).sum(dim=(0, 1))
    if acc is not None:
        for total, s in zip(acc, sums):
            total.add_(s)
        return dx32.to(x.dtype), acc, None if da32 is None else da_in.add_(da32)
    grads = GroupedFFWParams(*(s.to(p.dtype) for s, p in zip(sums, params)))
    return dx32.to(x.dtype), grads, None if da32 is None else da32.to(add.dtype)


def check_kernel_args(
    params: GroupedFFWParams, x: torch.Tensor, add: Optional[torch.Tensor], cat: bool = False
) -> None:
    """Raise ValueError for anything the CUDA kernel does not take."""
    w1, b1, w2, b2 = params
    if x.dim() != 3:
        raise ValueError(f"x must be [G, M, d], got {tuple(x.shape)}")
    G, M, d = x.shape
    if cat:
        G = w1.shape[0]
        if x.shape[0] != cat_split(params) + 2:
            raise ValueError(f"the combined grid reads an [L+1, M, d] carry: x {tuple(x.shape)} "
                             f"for {G} groups")
        if add is None:
            raise ValueError("the combined grid's top-down groups take the addend")
    f = w1.shape[-1]
    want = {"w1": (G, d, f), "b1": (G, f), "w2": (G, f, d), "b2": (G, d)}
    got = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
    tensors = dict(got, x=x)
    if add is not None:
        want["add"] = (add.shape[0], d)
        got["add"] = tensors["add"] = add
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} shape {tuple(got[name].shape)} != {shape}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype {x.dtype}: the kernel takes bfloat16 or float32")
    for name, t in tensors.items():
        if t.dtype != x.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != x dtype {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("x", "w1", "w2", "add"):  # read by TMA or in 16-byte vectors
        if name in tensors and tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if d % WIDTH_MULTIPLE or f % WIDTH_MULTIPLE:
        raise ValueError(f"d={d} and f={f} must be multiples of {WIDTH_MULTIPLE}")
    if M % ROW_TILE:
        raise ValueError(f"M={M} must be a multiple of {ROW_TILE}")
    if add is not None and M % add.shape[0]:
        raise ValueError(f"addend rows {add.shape[0]} must divide M={M}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def slab_rows(G: int, M: int, f: int) -> int:
    """Rows per slab of the bf16 forward: all M while the [G, M, f] bf16
    hidden fits under `H_SCRATCH_CAP`, else the most whole GEMM row tiles
    that do, and at least one tile."""
    if G * M * f * 2 <= H_SCRATCH_CAP:
        return M
    return max(GEMM_ROW_TILE, H_SCRATCH_CAP // (G * f * 2) // GEMM_ROW_TILE * GEMM_ROW_TILE)


def _scratch(x: torch.Tensor, G: int, f: int, split: int, hidden: bool):
    """(R, h, xa): the bf16 forward's slab rows, its [G, R, f] hidden
    scratch (when `hidden`) and the addend groups' [split, R, d] scratch
    (when split > 0); f32 takes none of them (R = M)."""
    M, d = x.shape[1:]
    if x.dtype != torch.bfloat16:
        return M, None, None
    R = slab_rows(G, M, f)
    h = torch.empty((G, R, f), dtype=x.dtype, device=x.device) if hidden else None
    xa = torch.empty((split, R, d), dtype=x.dtype, device=x.device) if split else None
    return R, h, xa


def _group_rule(params: GroupedFFWParams, add: Optional[torch.Tensor], cat: bool):
    """(split, x_lo) for the kernels' group rule: the combined grid, or a
    plain launch (every group takes the addend, or none does)."""
    if cat:
        return cat_split(params), CAT_TD_SLOT
    return (params.w1.shape[0] if add is not None else 0), 0


def fused_grouped_ffw_lm(
    params: GroupedFFWParams,
    x: torch.Tensor,
    *,
    add: Optional[torch.Tensor] = None,
    save_pre: bool = False,
    cat: bool = False,
):
    """x [G, M, d] -> [G, M, d]; add: optional [n, d] positional addend with
    M = b * n (n inner), added to row r as add[r mod n] on load.
    save_pre=True returns (out, pre) with the [G, M, f] pre-activation.
    cat=True: the combined grid (see the module note) over the [L+1, M, d]
    carry x, returning [2L-1, M, d] (and pre [2L-1, M, f])."""
    refuse_grad(x, add, *params)
    if x.device.type == "cpu":
        return grouped_mlp_plain(params, x, add, save_pre=save_pre, cat=cat)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_kernel_args(params, x, add, cat)
    lib = _lib()
    M, d = x.shape[1:]
    G, f = params.w1.shape[0], params.w1.shape[-1]
    split, x_lo = _group_rule(params, add, cat)
    is_bf16 = int(x.dtype == torch.bfloat16)
    out = x.new_empty((G, M, d))
    pre = x.new_empty((G, M, f)) if save_pre else None
    R, h, xa = _scratch(x, G, f, split, hidden=True)
    w1, b1, w2, b2 = params
    err = lib.grouped_mlp_fwd(
        x.data_ptr(), _ptr(add), add.shape[0] if add is not None else 0,
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        _ptr(pre), _ptr(h), _ptr(xa), G, M, d, f, split, x_lo, R, is_bf16,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "grouped_mlp_fwd", lib.grouped_mlp_error_string)
    _build.count(globals(), "LAUNCHES", "LAUNCHES_CAT" if cat
                 else "LAUNCHES_ADD" if add is not None else None)
    return (out, pre) if save_pre else out


def fused_grouped_ffw(params: GroupedFFWParams, x: torch.Tensor) -> torch.Tensor:
    """The reference-layout entry, glom_tpu's `fused_grouped_ffw`: x
    [..., G, d] -> [..., G, d] through `fused_grouped_ffw_lm`, transposed
    to level-major [G, M, d] and back around the launch. The early-exit
    and ragged serving routes call it where they call the grouped FFW."""
    *lead, G, d = x.shape
    x_lm = x.reshape(-1, G, d).transpose(0, 1).contiguous()
    out = fused_grouped_ffw_lm(params, x_lm)
    return out.transpose(0, 1).reshape(*lead, G, d)


def grouped_mlp_pre(
    params: GroupedFFWParams, x: torch.Tensor, *, add: Optional[torch.Tensor] = None,
    cat: bool = False,
) -> torch.Tensor:
    """The pre-activation [G, M, f] alone, bit for bit the one
    `fused_grouped_ffw_lm(..., save_pre=True)` returns for the same inputs
    (cat=True: over the combined grid)."""
    refuse_grad(x, add, *params)
    if x.device.type == "cpu":
        return grouped_mlp_pre_plain(params, x, add, cat=cat)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_kernel_args(params, x, add, cat)
    lib = _lib()
    M, d = x.shape[1:]
    G, f = params.w1.shape[0], params.w1.shape[-1]
    split, x_lo = _group_rule(params, add, cat)
    pre = x.new_empty((G, M, f))
    R, _, xa = _scratch(x, G, f, split, hidden=False)
    err = lib.grouped_mlp_pre(
        x.data_ptr(), _ptr(add), add.shape[0] if add is not None else 0,
        params.w1.data_ptr(), params.b1.data_ptr(), pre.data_ptr(), _ptr(xa), G, M, d, f,
        split, x_lo, R, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "grouped_mlp_pre", lib.grouped_mlp_error_string)
    _build.count(globals(), "LAUNCHES_PRE", "LAUNCHES_PRE_CAT" if cat
                 else "LAUNCHES_PRE_ADD" if add is not None else None)
    return pre


def bwd_workspaces(x: torch.Tensor, G: int, f: int, split: int, saved_pre: bool) -> dict:
    """The scratch a backward call hands between its launches, allocated on
    x's device and held by the caller until every launch is enqueued:
    `dpre_ws` [G, M, f] (x's dtype) always; `h_ws` [G, M, f] unless f32
    forms h from the saved pre in its weight pass; with an addend (split >
    0) the f32 `dx32_ws` [split, M, d] that da sums and, in bf16 from the
    saved pre, `xa` [split, M, d], the addend's groups' x + tile(add) (TMA
    cannot add)."""
    M, d = x.shape[1:]
    bf16 = x.dtype == torch.bfloat16
    ws = {"dpre_ws": x.new_empty((G, M, f))}
    if bf16 or not saved_pre:
        ws["h_ws"] = x.new_empty((G, M, f))
    if split:
        ws["dx32_ws"] = x.new_empty((split, M, d), dtype=torch.float32)
        if bf16 and saved_pre:
            ws["xa"] = x.new_empty((split, M, d))
    return ws


def _check_accumulators(params, x, add, acc, da_in) -> None:
    """Raise ValueError for accumulators the kernel's accumulate mode does
    not take: f32, contiguous, shaped like the params (da_in like the
    addend, and given exactly when the addend is)."""
    pairs = list(zip(("dw1", "db1", "dw2", "db2"), acc, params))
    if (da_in is None) != (add is None):
        raise ValueError("da_in goes with an addend in accumulate mode, and only then")
    if add is not None:
        pairs.append(("da_in", da_in, add))
    for name, t, like in pairs:
        if t.shape != like.shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be float32 {tuple(like.shape)} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_bwd_args(params, x, g, *, add=None, pre=None, acc=None, da_in=None, cat=False):
    """Raise ValueError for anything the backward kernels do not take:
    `check_kernel_args`, the cotangent's and the saved pre's shapes,
    dtypes, devices and contiguity, in bf16 a 16-byte aligned start for
    both (the saved-pre path reads them by TMA; views of the loop's carry
    slots and dmean prefixes start whole slots in), and the accumulators."""
    check_kernel_args(params, x, add, cat)
    M, d = x.shape[1:]
    G, f = params.w1.shape[0], params.w1.shape[-1]
    split, _ = _group_rule(params, add, cat)
    g_groups = split + 1 if cat else G  # dmean's L levels, or one a group
    for name, t, shape in (("g", g, (g_groups, M, d)), ("pre", pre, (G, M, f))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} must be {shape} {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary in bf16")
    if acc is not None:
        _check_accumulators(params, x, add, acc, da_in)
    elif da_in is not None:
        raise ValueError("da_in needs acc (accumulate mode)")


def grouped_mlp_bwd(
    params: GroupedFFWParams,
    x: torch.Tensor,
    g: torch.Tensor,
    *,
    add: Optional[torch.Tensor] = None,
    pre: Optional[torch.Tensor] = None,
    acc: Optional[GroupedFFWParams] = None,
    da_in: Optional[torch.Tensor] = None,
    cat: bool = False,
):
    """The VJP of `fused_grouped_ffw_lm` at (params, x, add) for the output
    cotangent g [G, M, d]: (dx, grads, da), as `grouped_mlp_bwd_plain`.
    `pre` is the forward's saved pre-activation, or None to recompute it.
    With `acc` (and `da_in` for an addend) the f32 totals are updated in
    place and returned as grads and da. x and g may be views into larger
    buffers (a carry slot, a prefix of levels) as long as each is
    contiguous: the kernel reads them through their pointers. cat=True
    (accumulate mode only): the combined grid over the [L+1, M, d] carry x
    and dmean g [L, M, d]; dx is [2L-1, M, d], top-down groups first."""
    if cat and acc is None:
        raise ValueError("the combined grid's backward runs in accumulate mode: pass acc")
    if x.device.type == "cpu":
        return grouped_mlp_bwd_plain(params, x, g, add, pre, acc, da_in, cat=cat)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_bwd_args(params, x, g, add=add, pre=pre, acc=acc, da_in=da_in, cat=cat)
    M, d = x.shape[1:]
    G, f = params.w1.shape[0], params.w1.shape[-1]
    split, x_lo = _group_rule(params, add, cat)
    lib = _bwd_lib()
    w1, b1, w2, b2 = params
    dx = x.new_empty((G, M, d))
    grads = acc if acc is not None else GroupedFFWParams(*(torch.empty_like(t) for t in params))
    ws = bwd_workspaces(x, G, f, split, pre is not None)  # held until the launches are enqueued
    da = None
    if add is not None:
        da = da_in if acc is not None else torch.empty_like(add)
    err = lib.grouped_mlp_bwd(
        x.data_ptr(), _ptr(add), add.shape[0] if add is not None else 0,
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), _ptr(pre), g.data_ptr(),
        dx.data_ptr(), *(t.data_ptr() for t in grads), _ptr(da),
        *(_ptr(ws.get(k)) for k in ("h_ws", "dpre_ws", "dx32_ws", "xa")),
        G, M, d, f, split, x_lo, int(acc is not None), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "grouped_mlp_bwd", lib.grouped_mlp_bwd_error_string)
    has_add = add is not None
    if cat:
        _build.count(globals(), "LAUNCHES_BWD_ACC", "LAUNCHES_BWD_ACC_CAT")
    elif acc is not None:
        _build.count(globals(), "LAUNCHES_BWD_ACC", "LAUNCHES_BWD_ACC_ADD" if has_add else None)
    else:
        _build.count(globals(), "LAUNCHES_BWD", "LAUNCHES_BWD_ADD" if has_add else None)
    return dx, grads, da


def save_pre_ok(params: GroupedFFWParams, x: torch.Tensor) -> bool:
    """Whether the training forward saves the pre-activation (glom_tpu's
    _save_pre_ok): bf16, and the [G, M, f] residual under SAVE_PRE_LIMIT.
    f32 recomputes it in the backward."""
    G, M, _ = x.shape
    return (
        x.dtype == torch.bfloat16
        and G * M * params.w1.shape[-1] * x.element_size() <= SAVE_PRE_LIMIT
    )


class _GroupedFFW(torch.autograd.Function):
    """The differentiable grouped FFW: glom_tpu's _fused_lm (custom_vjp)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        params = GroupedFFWParams(w1, b1, w2, b2)
        pre = None
        if save_pre_ok(params, x):
            out, pre = fused_grouped_ffw_lm(params, x, save_pre=True)
        else:
            out = fused_grouped_ffw_lm(params, x)
        ctx.save_for_backward(x, w1, b1, w2, b2, pre)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, pre = ctx.saved_tensors
        params = GroupedFFWParams(w1, b1, w2, b2)
        dx, grads, _ = grouped_mlp_bwd(params, x, g.contiguous().to(x.dtype), pre=pre)
        return (dx, *grads)


class _GroupedFFWAdd(torch.autograd.Function):
    """The differentiable grouped FFW with a folded positional addend:
    glom_tpu's _fused_lm_add (custom_vjp). da is summed over groups, batch
    copies and rows in f32, then cast to the addend's dtype."""

    @staticmethod
    def forward(ctx, x, add, w1, b1, w2, b2):
        params = GroupedFFWParams(w1, b1, w2, b2)
        pre = None
        if save_pre_ok(params, x):
            out, pre = fused_grouped_ffw_lm(params, x, add=add, save_pre=True)
        else:
            out = fused_grouped_ffw_lm(params, x, add=add)
        ctx.save_for_backward(x, add, w1, b1, w2, b2, pre)
        return out

    @staticmethod
    def backward(ctx, g):
        x, add, w1, b1, w2, b2, pre = ctx.saved_tensors
        params = GroupedFFWParams(w1, b1, w2, b2)
        dx, grads, da = grouped_mlp_bwd(
            params, x, g.contiguous().to(x.dtype), add=add, pre=pre
        )
        return (dx, da, *grads)


def grouped_ffw_lm_vjp(
    params: GroupedFFWParams, x: torch.Tensor, *, add: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """`fused_grouped_ffw_lm` with a gradient: the kernels' forward and
    backward under autograd (plain versions for CPU tensors)."""
    if add is None:
        return _GroupedFFW.apply(x, *params)
    return _GroupedFFWAdd.apply(x, add, *params)
