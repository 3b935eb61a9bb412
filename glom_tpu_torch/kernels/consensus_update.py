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
For training the forward also writes the f32 row statistics m, l. In bf16
the kernel first writes the normalized k once a launch to a [L, B, n, d]
scratch the wrapper allocates (`khat_scratch`), then runs its attention
on Hopper's tensor cores (wgmma, TMA); f32 runs on the CUDA cores.

`csrc/consensus_update_bwd.cu` replaces the backward kernels
`_consensus_bwd_small_kernel`, `_consensus_bwd_dq_kernel` and
`_consensus_bwd_dkv_kernel` with two passes that cover every n: the dq pass
(f32 dq and dd) and the dkv pass (dv, dk through the norm VJP, and the
complete dlevels = dmean + dq + dv + normVJP(dk), plus dmean). Its
arithmetic is the single-tile kernel's (`_small_bwd_math`). Two instances,
one rule (`k2_bwd_instance`, checked again by the C entries): "wgmma" for
bf16 (Hopper's tensor cores; the dq pass first runs a pre-pass that
writes the normalised k and the rounded dcons to scratches the wrapper
allocates, `bwd_workspaces`, and the dkv pass, a dv launch and a dk launch,
reads that k, or normalises the keys again when called on its own), "fma"
for f32 (the CUDA cores). Their combine
mode is glom_tpu's `fused_loop._cons_bwd_combine_kernel`, the whole-loop
VJP's consensus backward: the output cotangent of a level is the sum, in
f32, of the previous iteration's dlevels and the slot-shifted input
cotangents of the two FFWs (`dx_bu`, `dx_td`).
`consensus_update_vjp` is the differentiable entry, the twin of `_fused`:
d(bu) = dmean and d(td) = dmean[:L-1].

Long rows (`use_onesweep`: n > 512 where glom_tpu's one-sweep fits) train
through the one-sweep backward, glom_tpu's `_consensus_bwd_onesweep`: the
forward also writes the attention output `cons` (`cons=True`), which makes
D_i = dcons_i . cons_i row-local, so the dq pass needs one sweep of the key
tiles instead of two (`consensus_bwd_onesweep`, its plain version
`consensus_bwd_onesweep_plain`). glom_tpu's rounding points are kept:
dcons = g * (1 / div) in f32 feeds D, its rounding feeds dv and dP, and
the partial g / div + dv + normVJP(dk) is rounded before dq is added.

`fused_consensus_update` and `consensus_update_bwd` run the plain PyTorch
versions (`consensus_update_plain`, `consensus_update_bwd_plain`) for
tensors on the CPU and launch the kernels for CUDA tensors (raising on
anything they do not take). Unlike the TPU dispatch, they never hand small
batches to a dense op: on the card the kernels run at every batch. The raw
forward refuses an input that requires grad while grad mode is on.
`LAUNCHES` counts forward launches, `LAUNCHES_BWD_DQ` and
`LAUNCHES_BWD_DKV` the two backward passes, and `LAUNCHES_BWD_COMBINE_DQ`
and `LAUNCHES_BWD_COMBINE_DKV` those launched in combine mode (counted
there only); `LAUNCHES_CONS` the forwards that wrote `cons`, and
`LAUNCHES_BWD_ONESWEEP` the one-sweep backwards (all its launches, one call).
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
LAUNCHES_CONS = 0
LAUNCHES_BWD_ONESWEEP = 0

WIDTH_MULTIPLE = 64  # d must be a multiple of this
ROW_TILE = {torch.bfloat16: 32, torch.float32: 16}  # n must be a multiple
TMA_ALIGN = 16  # bytes: the bf16 kernels read by TMA and in 16-byte vectors
BWD_MAX_D = 640  # the "wgmma" backward's widest row (csrc/consensus_update_bwd.cu)
K2_BWD_INSTANCES = ("fma", "wgmma")  # the backward C entries' instance numbers

_NEG_MAX = torch.finfo(torch.float32).min

_P, _I = ctypes.c_void_p, ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "consensus_update_fwd": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _I, _I, _P], _I,
    ),
    "consensus_update_error_string": ([_I], ctypes.c_char_p),
}
_BWD_SIGNATURES = {
    "consensus_update_bwd_dq": ([*[_P] * 10, *[_I] * 5, _D, _I, _I, _I, _P], _I),
    "consensus_update_bwd_dkv": ([*[_P] * 10, _I, *[_P] * 3, *[_I] * 5, _D, _I, _I, _I, _P],
                                 _I),
    "consensus_update_bwd_onesweep": ([*[_P] * 11, *[_I] * 5, _D, _I, _I, _I, _P], _I),
    "consensus_update_bwd_error_string": ([_I], ctypes.c_char_p),
}

# glom_tpu's one-sweep eligibility (consensus_update.py:316-319, :960-978),
# kept for route parity: it is the TPU's VMEM rule (the whole-row f32 dq
# block resident beside the tiles), not a measurement on the card.
_SMALL_BWD_N = 512
_ONESWEEP_BUDGET = 48 * 1024 * 1024


def _pick_tile(n: int) -> int:
    for t in (256, 128, 64, 32, 16, 8):
        if n % t == 0 and t <= n:
            return t
    return n


def _onesweep_ok(n: int, d: int, itemsize: int) -> bool:
    """The one-sweep's working set at batch tile 1 within the budget: the
    whole-row f32 dq, resident and streamed tiles, scratch, sim tiles, out."""
    tile = _pick_tile(n)
    ws = (n * d * 4 + 2 * tile * d * itemsize * 2
          + 3 * tile * d * itemsize * 2 + 2 * tile * 4 * 2
          + 2 * tile * d * 4 + 3 * tile * tile * 4 + tile * d * itemsize * 2)
    return ws <= _ONESWEEP_BUDGET


def use_onesweep(levels_shape, itemsize: int) -> bool:
    """Whether the training forward saves `cons` and the backward runs the
    one-sweep kernel: glom_tpu's save_cons gate (consensus_update.py:
    1349-1353), n > 512 and `_onesweep_ok`, with its blockwise side always
    taken. glom_tpu sends a mid-length global row (n < 4096) to its dense
    XLA backward instead; the port has no dense backward, so it takes the
    one-sweep there. The size rule is the TPU's VMEM arithmetic; the card
    has no such limit (the port's one-sweep keeps no whole-row dq). It is
    kept on purpose, for route parity: past it (n near 22k at d = 512)
    glom_tpu trains with the two passes, and so does the port, so both run
    the same backward, with the same rounding, at every n."""
    n, d = levels_shape[-2:]
    return n > _SMALL_BWD_N and _onesweep_ok(n, d, itemsize)


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
    cons: bool = False,
):
    """The kernel's function in plain PyTorch, with its rounding points (one
    j tile: the softmax statistics are taken over the whole row).
    stats=True returns (out, m, l) with the f32 row statistics [L, B, n, 1];
    cons=True returns (out, m, l, cons) with the attention output [L, B, n,
    d] rounded to the levels dtype."""
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
    att = torch.matmul(p.to(dt).to(f32), kv) / l
    td = torch.cat([td_lm.to(f32), torch.zeros_like(kv[:1])], dim=0)
    out = ((((kv + bu_lm.to(f32)) + td) + att) / _divisor(L, levels_lm.device)).to(dt)
    if cons:
        return out, m, l, att.to(dt)
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
    dxn = _norm_vjp(dk, x)
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


def _norm_vjp(dk, x):
    """The VJP of k = x / max(||x||, 1e-12) (glom_tpu's _norm_vjp), f32."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    inv = 1.0 / torch.clamp_min(norm, 1e-12)
    a = torch.sum(dk * x, dim=-1, keepdim=True)
    return dk * inv - torch.where(norm >= 1e-12, a * x * inv * inv / norm, 0.0)


def consensus_bwd_onesweep_plain(
    levels_lm, g, m, l, cons, *, side, radius=0.0, attend_self=False
):
    """The one-sweep backward in plain PyTorch, with glom_tpu's rounding
    points (`_consensus_bwd_onesweep_kernel` and its dq join): dlevels in
    the levels dtype from the raw cotangent g, the row statistics m, l and
    the forward's saved attention output cons."""
    L = levels_lm.shape[0]
    dt, f32 = levels_lm.dtype, torch.float32
    scale = levels_lm.shape[-1] ** -0.5
    x = levels_lm.to(f32)
    k = _normalized_k(levels_lm)
    s, diag = _masked_scores(levels_lm, k, side=side, radius=radius, attend_self=attend_self)
    p = torch.exp(s - m) / l
    dcons = g.to(f32) * (1.0 / _divisor(L, levels_lm.device))  # unrounded: D takes it
    D = torch.sum(dcons * cons.to(f32), dim=-1, keepdim=True)
    dcr = dcons.to(dt).to(f32)
    dp = torch.matmul(dcr, x.transpose(-1, -2))  # dP_ij = dcons_i . v_j
    ds = p * (dp - D)
    if not attend_self:
        ds = ds.masked_fill(diag, 0.0)
    ds = ds.to(dt).to(f32)
    dv = torch.matmul(p.to(dt).to(f32).transpose(-1, -2), dcr)
    dk = torch.matmul(ds.transpose(-1, -2), x) * scale
    dq = torch.matmul(ds, k) * scale
    partial = (dcons + dv + _norm_vjp(dk, x)).to(dt)
    return (partial.to(f32) + dq).to(dt)


def k2_bwd_instance(dtype: torch.dtype, n: int, d: int) -> str:
    """The backward kernels' instance for a launch: "wgmma" for bfloat16
    where n % 32 == 0, d % 64 == 0 and d <= BWD_MAX_D (the bf16 forward's
    shapes), "fma" for float32. A rule by dtype and shape: other shapes
    raise ValueError, nothing falls back."""
    if dtype == torch.float32:
        return "fma"
    if dtype == torch.bfloat16:
        if n % ROW_TILE[dtype] or d % WIDTH_MULTIPLE or d > BWD_MAX_D:
            raise ValueError(
                f"no bf16 backward for n={n}, d={d}: it needs n % {ROW_TILE[dtype]} == 0, "
                f"d % {WIDTH_MULTIPLE} == 0 and d <= {BWD_MAX_D}")
        return "wgmma"
    raise ValueError(f"dtype {dtype}: the backward takes bfloat16 or float32")


def bwd_workspaces(levels_lm: torch.Tensor, form: str) -> dict:
    """The buffers a backward call hands between its launches, allocated on
    the levels' device and held by the caller until every launch that reads
    them is enqueued. form: "dq" (the "wgmma" pre-pass's normalised keys),
    "dkv" (the keys, and the f32 dv the dk launch reads: what the dkv pass
    needs alone, and what `consensus_update_bwd` hands to both passes) or
    "onesweep" (also f32 dq, f32 dd and the rounded dcons). "fma" needs
    neither keys nor dv."""
    L, B, n, d = levels_lm.shape
    wgmma = k2_bwd_instance(levels_lm.dtype, n, d) == "wgmma"
    ws = {}
    if form == "onesweep":
        ws["dq"] = levels_lm.new_empty((L, B, n, d), dtype=torch.float32)
        ws["dd"] = levels_lm.new_empty((L, B, n, 1), dtype=torch.float32)
        ws["dcons"] = torch.empty_like(levels_lm)
    elif form not in ("dq", "dkv"):
        raise ValueError(f"form {form!r}: one of 'dq', 'dkv', 'onesweep'")
    if wgmma:
        ws["khat"] = torch.empty_like(levels_lm)
        if form != "dq":
            ws["dv"] = levels_lm.new_empty((L, B, n, d), dtype=torch.float32)
    return ws


def khat_scratch(levels_lm: torch.Tensor) -> Optional[torch.Tensor]:
    """The bf16 kernel's scratch for the normalized keys, [L, B, n, d] bf16
    (what `_normalized_k` gives, rounded): filled by the kernel's pre-pass
    and read by its attention, once a launch. f32 needs none (None)."""
    if levels_lm.dtype != torch.bfloat16:
        return None
    return torch.empty_like(levels_lm)


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
    dt, dev = levels_lm.dtype, levels_lm.device
    full = levels_lm.shape
    for name, t, shape in (("bu", bu_lm, full), ("td", td_lm, (L - 1, B, n, d)),
                           ("out", out, full)):
        if t.shape != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    align = TMA_ALIGN if dt == torch.bfloat16 else 1
    ptrs = {}
    for name, t in (("bu", bu_lm), ("td", td_lm), ("out", out), ("levels", levels_lm)):
        if t.dtype != dt:
            raise ValueError(f"{name} dtype {t.dtype} != levels dtype {dt}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, levels on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        ptrs[name] = ptr = t.data_ptr()
        if ptr % align:
            raise ValueError(f"{name} must start on a {TMA_ALIGN}-byte boundary in bf16")
    o0, o1 = ptrs["out"], ptrs["out"] + out.nbytes
    for name, t in (("levels", levels_lm), ("bu", bu_lm), ("td", td_lm)):
        if o0 < ptrs[name] + t.nbytes and ptrs[name] < o1:
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
    cons: bool = False,
):
    """new_levels = (levels + bu + pad(td) + consensus(levels)) / div.

    levels_lm, bu_lm: [L, B, n, d]; td_lm: [L-1, B, n, d]. Returns
    [L, B, n, d], written into `out` when given (it must not overlap the
    inputs); stats=True returns (out, m, l) with the f32 row statistics
    [L, B, n, 1] the backward reads; cons=True returns (out, m, l, cons)
    with the attention output the one-sweep backward reads."""
    refuse_grad(levels_lm, bu_lm, td_lm)
    stats = stats or cons
    if levels_lm.device.type == "cpu":
        res = consensus_update_plain(
            levels_lm, bu_lm, td_lm, side=side, radius=radius,
            attend_self=attend_self, stats=stats, cons=cons,
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
    m = l = att = None
    if stats:
        m = levels_lm.new_empty((L, B, n, 1), dtype=torch.float32)
        l = torch.empty_like(m)
    if cons:
        att = torch.empty_like(levels_lm)
    is_bf16 = int(levels_lm.dtype == torch.bfloat16)
    khat = khat_scratch(levels_lm)  # held until the launch is enqueued
    err = lib.consensus_update_fwd(
        levels_lm.data_ptr(), bu_lm.data_ptr(), td_lm.data_ptr(), out.data_ptr(),
        _ptr(m), _ptr(l), _ptr(att), _ptr(khat),
        L, B, n, d, side, float(radius), int(attend_self), is_bf16,
        torch.cuda.current_stream(levels_lm.device).cuda_stream,
    )
    _build.check(err, "consensus_update_fwd", lib.consensus_update_error_string)
    _build.count(globals(), "LAUNCHES", "LAUNCHES_CONS" if cons else None)
    if cons:
        return out, m, l, att
    return (out, m, l) if stats else out


def _check_bwd_args(levels_lm, g, m, l, side, radius, dx_bu=None, dx_td=None, combine=False,
                    dcons=None, cons=None, dq=None, dd=None) -> None:
    """Raise ValueError for anything the backward kernels do not take: the
    shapes, dtypes, devices and contiguity, the instance rule, and in bf16
    ("wgmma", which reads by TMA and in 16-byte vectors) a 16-byte aligned
    start for every tensor, views of the loop's carry slots included."""
    _check_levels(levels_lm, side=side, radius=radius)
    L, B, n, d = levels_lm.shape
    wgmma = k2_bwd_instance(levels_lm.dtype, n, d) == "wgmma"
    if (dx_bu is None) != (dx_td is None):
        raise ValueError("dx_bu and dx_td come together")
    if dx_bu is not None and not combine:
        raise ValueError("the dx_bu/dx_td streams are the combine's: pass combine=True")
    full, rows, f32 = (L, B, n, d), (L, B, n, 1), torch.float32
    checks = [("levels", levels_lm, full, levels_lm.dtype), ("g", g, full, levels_lm.dtype),
              ("m", m, rows, f32), ("l", l, rows, f32)]
    if dx_bu is not None:
        checks += [("dx_bu", dx_bu, full, levels_lm.dtype),
                   ("dx_td", dx_td, (L - 1, B, n, d), levels_lm.dtype)]
    for name, t, shape, dtype in (("dcons", dcons, full, levels_lm.dtype),
                                  ("cons", cons, full, levels_lm.dtype),
                                  ("dq", dq, full, f32), ("dd", dd, rows, f32)):
        if t is not None:
            checks.append((name, t, shape, dtype))
    for name, t, shape, dtype in checks:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != levels_lm.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {levels_lm.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if wgmma and t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name} must start on a {TMA_ALIGN}-byte boundary in bf16")


def _bwd_call(levels_lm):
    """(library, stream, is_bf16, instance number) of a backward launch."""
    instance = K2_BWD_INSTANCES.index(k2_bwd_instance(levels_lm.dtype, *levels_lm.shape[-2:]))
    return (_bwd_lib(), torch.cuda.current_stream(levels_lm.device).cuda_stream,
            int(levels_lm.dtype == torch.bfloat16), instance)


def _launch_dq(levels_lm, g, m, l, khat, *, side, radius, attend_self, dx_bu, dx_td,
               combine):
    """Enqueue the dq pass ("wgmma": its pre-pass writes the normalised keys
    into khat): (dq, dd, dcons)."""
    lib, stream, is_bf16, instance = _bwd_call(levels_lm)
    L, B, n, d = levels_lm.shape
    dq = levels_lm.new_empty((L, B, n, d), dtype=torch.float32)
    dd = levels_lm.new_empty((L, B, n, 1), dtype=torch.float32)
    dcons = torch.empty_like(levels_lm)
    err = lib.consensus_update_bwd_dq(
        levels_lm.data_ptr(), g.data_ptr(), _ptr(dx_bu), _ptr(dx_td), m.data_ptr(),
        l.data_ptr(), dq.data_ptr(), dd.data_ptr(), dcons.data_ptr(), _ptr(khat),
        L, B, n, d, side, float(radius), int(attend_self), is_bf16, instance, stream,
    )
    _build.check(err, "consensus_update_bwd_dq", lib.consensus_update_bwd_error_string)
    _build.count(globals(), "LAUNCHES_BWD_COMBINE_DQ" if combine else "LAUNCHES_BWD_DQ")
    return dq, dd, dcons


def _launch_dkv(levels_lm, g, m, l, dq, dd, dcons, ws, khat_ready, *, side, radius,
                attend_self, dx_bu, dx_td, combine):
    """Enqueue the dkv pass with the scratches ws ("dkv" form); khat_ready:
    ws["khat"] already holds the keys the dq pass wrote. (dlevels, dmean)."""
    lib, stream, is_bf16, instance = _bwd_call(levels_lm)
    L, B, n, d = levels_lm.shape
    dlv = torch.empty_like(levels_lm)
    dmean = torch.empty_like(levels_lm)
    err = lib.consensus_update_bwd_dkv(
        levels_lm.data_ptr(), g.data_ptr(), _ptr(dx_bu), _ptr(dx_td), m.data_ptr(),
        l.data_ptr(), dq.data_ptr(), dd.data_ptr(), dcons.data_ptr(), _ptr(ws.get("khat")),
        int(khat_ready), _ptr(ws.get("dv")), dlv.data_ptr(), dmean.data_ptr(),
        L, B, n, d, side, float(radius), int(attend_self), is_bf16, instance, stream,
    )
    _build.check(err, "consensus_update_bwd_dkv", lib.consensus_update_bwd_error_string)
    _build.count(globals(), "LAUNCHES_BWD_COMBINE_DKV" if combine else "LAUNCHES_BWD_DKV")
    return dlv, dmean


def consensus_bwd_dq(
    levels_lm, g, m, l, *, side, radius=0.0, attend_self=False, dx_bu=None, dx_td=None,
    combine=False,
):
    """The dq pass on the card: (f32 dq [L, B, n, d], f32 dd [L, B, n, 1],
    dcons [L, B, n, d] rounded to the levels dtype, which the dkv pass
    reads). combine=True is the whole-loop VJP's launch (with or without
    streams)."""
    _check_bwd_args(levels_lm, g, m, l, side, radius, dx_bu, dx_td, combine)
    ws = bwd_workspaces(levels_lm, "dq")  # held until the launches are enqueued
    return _launch_dq(levels_lm, g, m, l, ws.get("khat"), side=side, radius=radius,
                      attend_self=attend_self, dx_bu=dx_bu, dx_td=dx_td, combine=combine)


def consensus_bwd_dkv(
    levels_lm, g, m, l, dq, dd, dcons, *, side, radius=0.0, attend_self=False, dx_bu=None,
    dx_td=None, combine=False,
):
    """The dkv pass on the card, from the dq pass's outputs: (dlevels,
    dmean) in the levels dtype. Called on its own it normalises the keys
    again ("wgmma")."""
    _check_bwd_args(levels_lm, g, m, l, side, radius, dx_bu, dx_td, combine, dcons=dcons,
                    dq=dq, dd=dd)
    ws = bwd_workspaces(levels_lm, "dkv")  # held until the launches are enqueued
    return _launch_dkv(levels_lm, g, m, l, dq, dd, dcons, ws, False, side=side,
                       radius=radius, attend_self=attend_self, dx_bu=dx_bu, dx_td=dx_td,
                       combine=combine)


def consensus_bwd_onesweep(levels_lm, g, m, l, cons, *, side, radius=0.0, attend_self=False):
    """The one-sweep backward: dlevels [L, B, n, d] in the levels dtype, as
    `consensus_bwd_onesweep_plain`, from the raw cotangent g, the forward's
    m, l and its saved attention output cons. On the card: the dq pass
    with D from cons (one sweep of the key tiles), then the dkv pass,
    one launch count ("wgmma": the pre-pass, the dq, dv and dk launches)."""
    kw = dict(side=side, radius=radius, attend_self=attend_self)
    if levels_lm.device.type == "cpu":
        return consensus_bwd_onesweep_plain(levels_lm, g, m, l, cons, **kw)
    if levels_lm.device.type != "cuda":
        raise ValueError(f"no kernel for device {levels_lm.device}")
    _check_bwd_args(levels_lm, g, m, l, side, radius, cons=cons)
    lib, stream, is_bf16, instance = _bwd_call(levels_lm)
    L, B, n, d = levels_lm.shape
    ws = bwd_workspaces(levels_lm, "onesweep")  # held until the launches are enqueued
    dlv = torch.empty_like(levels_lm)
    err = lib.consensus_update_bwd_onesweep(
        levels_lm.data_ptr(), g.data_ptr(), cons.data_ptr(), m.data_ptr(), l.data_ptr(),
        ws["dq"].data_ptr(), ws["dd"].data_ptr(), ws["dcons"].data_ptr(),
        _ptr(ws.get("khat")), _ptr(ws.get("dv")), dlv.data_ptr(), L, B, n, d, side,
        float(radius), int(attend_self), is_bf16, instance, stream,
    )
    _build.check(err, "consensus_update_bwd_onesweep", lib.consensus_update_bwd_error_string)
    _build.count(globals(), "LAUNCHES_BWD_ONESWEEP")
    return dlv


def consensus_update_bwd(
    levels_lm, g, m, l, *, side, radius=0.0, attend_self=False, dx_bu=None, dx_td=None,
    combine=False,
):
    """The VJP of `fused_consensus_update` for the output cotangent g:
    (dlevels, dmean), as `consensus_update_bwd_plain`. On the card: the dq
    pass, then the dkv pass on the keys the dq pass normalised.
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
    _check_bwd_args(levels_lm, g, m, l, side, radius, dx_bu, dx_td, combine)
    # One set of scratches for both passes: the dkv pass reads the keys the
    # dq pass's pre-pass wrote ("wgmma"; "fma" has none). Held until both
    # are enqueued.
    ws = bwd_workspaces(levels_lm, "dkv")
    dq, dd, dcons = _launch_dq(levels_lm, g, m, l, ws.get("khat"), **kw)
    return _launch_dkv(levels_lm, g, m, l, dq, dd, dcons, ws, "khat" in ws, **kw)


class _ConsensusUpdate(torch.autograd.Function):
    """The differentiable fused consensus update: glom_tpu's _fused
    (custom_vjp). The mean is linear, so d(bu) = dmean = g / div and d(td)
    is its first L-1 levels; bu and td are not saved. Where `use_onesweep`
    holds, the forward also saves cons and the backward is the one-sweep
    (which gives no dmean: g / div is formed here, rounded once, as
    glom_tpu's _fused_bwd forms it); elsewhere the dq and dkv passes."""

    @staticmethod
    def forward(ctx, levels_lm, bu_lm, td_lm, side, radius, attend_self):
        geometry = dict(side=side, radius=radius, attend_self=attend_self)
        cons = None
        if use_onesweep(levels_lm.shape, levels_lm.element_size()):
            out, m, l, cons = fused_consensus_update(
                levels_lm, bu_lm, td_lm, cons=True, **geometry)
        else:
            out, m, l = fused_consensus_update(levels_lm, bu_lm, td_lm, stats=True, **geometry)
        ctx.save_for_backward(levels_lm, m, l, cons)
        ctx.geometry = geometry
        return out

    @staticmethod
    def backward(ctx, g):
        levels_lm, m, l, cons = ctx.saved_tensors
        g = g.contiguous().to(levels_lm.dtype)
        if cons is None:
            dlv, dmean = consensus_update_bwd(levels_lm, g, m, l, **ctx.geometry)
        else:
            dlv = consensus_bwd_onesweep(levels_lm, g, m, l, cons, **ctx.geometry)
            div = _divisor(levels_lm.shape[0], g.device)
            dmean = (g.to(torch.float32) / div).to(levels_lm.dtype)
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
