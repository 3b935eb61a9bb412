"""K3: the hand-written VJP of the whole T-iteration GLOM loop.

Counterpart of `glom_tpu/kernels/fused_loop.py` on its combined td || bu
grid (`GLOM_LOOP_GRID=combined`).
Training at batch >= 8 takes this route (`models/core.py:resolve_vjp_path`).
It removes the glue that per-iteration autograd leaves between the K1 and
K2 kernels:

  * the carry is one [L+1, B, n, d] slot buffer with the tokens in slot 0
    and level l in slot l+1, so the bottom-up FFW reads slots 0..L-1, the
    top-down FFW slots 2..L and consensus slots 1..L as contiguous views:
    no concatenate in the forward and no split in the backward (each
    kernel gets the slot's pointer);
  * each K1 phase of an iteration (forward, remat's pre-only, backward) is
    one launch over the 2L-1 groups, the L-1 top-down ones first, with the
    weights concatenated once per forward and once per backward
    (`cat_params`, glom_tpu's `_ffw_fwd_cat`, `_pre_fwd_cat`,
    `_ffw_bwd_cat`): the kernels' group rule reads the carry's slots and
    dmean's levels in place, the top-down and bottom-up outputs (and dx,
    the saved pre) are views of the one [2L-1] result that the K2 launches
    read through their pointers, and d pos_emb sums the top-down groups
    only. Each group's arithmetic is a split launch's, so the results are
    the split grid's bit for bit (`chip_smoke.py`'s `k1_cat_vs_plain`);
  * the K1 backward runs in accumulate mode: it adds each iteration's
    weight and bias gradients (and d pos_emb) into one [2L-1] set of f32
    totals in place, split back into the top-down and bottom-up gradients
    and rounded to the parameter dtype once, after the loop, where
    autograd would sum the per-iteration gradients in the parameter dtype;
  * the K2 backward runs in combine mode: it reads the previous
    iteration's dlevels and the two FFWs' input cotangents (slot-shifted
    views of dx) and sums them in f32 before the divide, so no pad, slice
    or add of the three streams reaches device memory; the top-down
    groups then read dmean's first L-1 levels.

The forward saves, per iteration, the carry, the [2L-1] pre-activations
and the consensus row statistics (m, l). With remat=True it saves only the
carry and the statistics, and the backward recomputes the pre-activations
with the pre-only K1 kernel, bit for bit the ones the forward would have
saved, so remat gradients equal non-remat ones exactly.

What the port's limits change against glom_tpu's (`loop_supported`):
  * a residual budget taken from the H100's 80 GB (`RESIDUAL_BUDGET`), not
    a v5e's 16: at the flagship, batch 128 without remat (12 GB of
    residuals) stays on the loop without a split, where glom_tpu splits it;
  * no VMEM working-set rules: the accumulating K1 backward keeps one f32
    tile per block, so the port always chains the accumulators (glom_tpu's
    unchained fallback, `fused_loop.py:536`/`:632`/`:659`, has no
    counterpart);
  * one grid: glom_tpu's default is the split grid (a top-down and a
    bottom-up launch per phase) and its env var selects the combined one;
    the port always runs the combined grid, whose gradients are the split
    grid's bit for bit, and reads no env var.

On CPU tensors every launch runs its kernel's plain version, through the
same autograd Function.
"""

from __future__ import annotations

from typing import Optional

import torch

from glom_tpu_torch.kernels.consensus_update import (
    ROW_TILE as CONS_ROW_TILE,
    WIDTH_MULTIPLE as CONS_WIDTH_MULTIPLE,
    consensus_update_bwd,
    fused_consensus_update,
)
from glom_tpu_torch.kernels.grouped_mlp import (
    ROW_TILE,
    WIDTH_MULTIPLE,
    cat_params,
    fused_grouped_ffw_lm,
    grouped_mlp_bwd,
    grouped_mlp_pre,
)
from glom_tpu_torch.ops.ffw import GroupedFFWParams

# Residuals the whole loop may keep (saved carries, both FFWs'
# pre-activations, the consensus statistics, times the iterations): 40 % of
# the H100's 80 GB, leaving the rest to the weights, Adam's moments, the
# backward's per-iteration workspaces and the allocator. Past it the
# trainer splits the batch or the per-iteration route takes over.
RESIDUAL_BUDGET = 32 * 1024 ** 3

# The longest row the loop takes (glom_tpu's cap, fused_loop.py:865). On the
# card at n = 4096 the loop's step cost 124.65 ms against the per-iteration
# route's 102.63 (`chip_smoke.py` train_longrow_ab, PERF.md section 5): the
# one-sweep K2 backward there beats the loop's two-pass combine.
MAX_LOOP_N = 512

_CONS_ROW_TILE = {2: CONS_ROW_TILE[torch.bfloat16], 4: CONS_ROW_TILE[torch.float32]}


def residual_bytes(L: int, B: int, n: int, d: int, f: int, itemsize: int, iters: int,
                   remat: bool = False) -> int:
    """What the forward keeps for the backward (glom_tpu's per-iteration
    formula, `fused_loop.py:877-883`)."""
    M = B * n
    per_iter = (L + 1) * M * d * itemsize + 2 * L * M * 4
    if not remat:
        per_iter += (2 * L - 1) * M * f * itemsize
    return iters * per_iter


def loop_supported(
    L: int, B: int, n: int, d: int, f: int, itemsize: int, iters: int, pos_n: int,
    remat: bool = False, *, side: Optional[int] = None, radius: float = 0.0,
) -> bool:
    """Whether `fused_glom_loop` takes these shapes: the K1 and K2 kernels'
    shape rules (d and f multiples of 64, rows a multiple of K1's row tile,
    n a multiple of K2's, the positional table one row per patch, a square
    patch grid under a radius), L >= 2, iters >= 1, a dtype the kernels
    take, n <= MAX_LOOP_N, and the residuals within `RESIDUAL_BUDGET`."""
    M = B * n
    if iters < 1 or L < 2 or itemsize not in _CONS_ROW_TILE:
        return False
    if n > MAX_LOOP_N:
        return False
    if d % WIDTH_MULTIPLE or f % WIDTH_MULTIPLE or d % CONS_WIDTH_MULTIPLE:
        return False
    if M % ROW_TILE or n % _CONS_ROW_TILE[itemsize] or pos_n != n:
        return False
    if radius > 0 and (side is None or side * side != n):
        return False
    return residual_bytes(L, B, n, d, f, itemsize, iters, remat) <= RESIDUAL_BUDGET


def _zeros_f32(params: GroupedFFWParams) -> GroupedFFWParams:
    return GroupedFFWParams(*(torch.zeros_like(t, dtype=torch.float32) for t in params))


class _FusedGlomLoop(torch.autograd.Function):
    """glom_tpu's `fused_glom_loop` custom VJP: `_loop_fwd` / `_loop_bwd`."""

    @staticmethod
    def forward(ctx, pos_emb, tokens, levels0, iters, geometry, remat, *weights):
        wcat = cat_params(GroupedFFWParams(*weights[4:]), GroupedFFWParams(*weights[:4]))
        L = levels0.shape[0]
        B, n, d = tokens.shape
        M = B * n
        ext = torch.empty((L + 1, B, n, d), dtype=tokens.dtype, device=tokens.device)
        ext[0] = tokens
        ext[1:] = levels0
        saved = []
        for _ in range(iters):
            ext2 = ext.view(L + 1, M, d)
            if remat:
                out = fused_grouped_ffw_lm(wcat, ext2, add=pos_emb, cat=True)
            else:
                out, pre = fused_grouped_ffw_lm(wcat, ext2, add=pos_emb, save_pre=True, cat=True)
            # A fresh carry every iteration: the backward keeps this one.
            new = torch.empty_like(ext)
            _, m, l = fused_consensus_update(
                ext[1:], out[L - 1:].view(L, B, n, d), out[: L - 1].view(L - 1, B, n, d),
                out=new[1:], stats=True, **geometry,
            )
            new[0] = tokens
            saved += (ext, m, l) if remat else (ext, pre, m, l)
            ext = new
        # Every residual goes through save_for_backward, so autograd's
        # version check guards it and saved-tensor hooks see it.
        ctx.geometry, ctx.remat = geometry, remat
        ctx.save_for_backward(pos_emb, *weights, *saved)
        return ext[1:]

    @staticmethod
    def backward(ctx, g):
        pos_emb, *rest = ctx.saved_tensors
        weights, flat = rest[:8], rest[8:]
        bu_params = GroupedFFWParams(*weights[:4])
        td_params = GroupedFFWParams(*weights[4:])
        per_iter = 3 if ctx.remat else 4  # (ext, m, l) or (ext, pre, m, l)
        saved = [flat[i : i + per_iter] for i in range(0, len(flat), per_iter)]
        geometry = ctx.geometry
        L, B, n, d = g.shape
        M = B * n
        f32 = torch.float32
        dtype = saved[0][0].dtype
        wcat = cat_params(td_params, bu_params)
        acc = _zeros_f32(wcat)
        da = torch.zeros((n, d), dtype=f32, device=g.device)
        dtok = torch.zeros((B, n, d), dtype=f32, device=g.device)
        dlv = g.contiguous().to(dtype)
        dx_bu = dx_td = None
        for t in reversed(range(len(saved))):
            if ctx.remat:
                ext, m, l = saved[t]
                ext2 = ext.view(L + 1, M, d)
                pre = grouped_mlp_pre(wcat, ext2, add=pos_emb, cat=True)
            else:
                ext, pre, m, l = saved[t]
                ext2 = ext.view(L + 1, M, d)
            dlv, dmean = consensus_update_bwd(
                ext[1:], dlv, m, l, dx_bu=dx_bu, dx_td=dx_td, combine=True, **geometry
            )
            dx, acc, da = grouped_mlp_bwd(
                wcat, ext2, dmean.view(L, M, d), add=pos_emb, pre=pre, acc=acc, da_in=da,
                cat=True,
            )
            dx_bu, dx_td = dx[L - 1:].view(L, B, n, d), dx[: L - 1].view(L - 1, B, n, d)
            dtok += dx_bu[0].to(f32)

        # d(levels0) gathers all three streams at the loop's entry, in f32
        # (glom_tpu's final combine, `fused_loop.py:1100-1113`).
        parts = [dlv[:1].to(f32) + dx_bu[1:2]]
        if L > 2:
            parts.append(dlv[1 : L - 1].to(f32) + dx_bu[2:] + dx_td[: L - 2])
        parts.append(dlv[L - 1 :].to(f32) + dx_td[L - 2 :])
        dlv0 = torch.cat(parts)

        # The f32 totals, top-down groups first, rounded to the parameters'
        # dtype as the bottom-up then the top-down gradients.
        grads = [a[L - 1:].to(p.dtype) for a, p in zip(acc, bu_params)]
        grads += [a[: L - 1].to(p.dtype) for a, p in zip(acc, td_params)]
        return (da.to(pos_emb.dtype), dtok.to(dtype), dlv0.to(dtype), None, None, None, *grads)


def fused_glom_loop(
    bu_params: GroupedFFWParams,
    td_params: GroupedFFWParams,
    pos_emb: torch.Tensor,  # [n, d]
    tokens: torch.Tensor,  # [B, n, d]
    levels0: torch.Tensor,  # [L, B, n, d] level-major
    iters: int,
    side: int,
    radius: float,
    attend_self: bool,
    remat: bool = False,
) -> torch.Tensor:
    """Run `iters` GLOM column updates and return the final level-major
    [L, B, n, d] state, differentiable in every input through the
    whole-loop VJP. All inputs share one dtype (bf16 or f32)."""
    if iters < 1:
        raise ValueError(f"iters={iters}: the loop runs at least one iteration")
    geometry = dict(side=side, radius=float(radius), attend_self=bool(attend_self))
    return _FusedGlomLoop.apply(
        pos_emb, tokens, levels0, iters, geometry, bool(remat), *bu_params, *td_params
    )
