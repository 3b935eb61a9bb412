"""Per-rank training across torch.distributed ranks: glom_tpu's manual path.

Counterpart of `glom_tpu/parallel/manual.py`. glom_tpu runs the whole loss
(and `make_manual_forward`'s inference) inside one `shard_map` over (data,
seq, model), where every array is local and a Pallas call is plain
per-device work. The port has no GSPMD and no shard_map: each rank is a
process, runs glom_tpu's per-shard body (`_forward_local`) on its own
tensors through the same Hopper kernels the single-device trainer runs,
and every collective is an explicit `torch.distributed` call over the
group of one mesh axis (`collectives.py`):

  * DP   -- each rank takes its band of the global batch. A rank at seq =
            1 and model = 1 runs the single-device loss on its band
            (`denoise_loss`): the K1 / K2 per-iteration kernels, or the
            whole-loop VJP (K3) where the rank-local batch admits it, as
            glom_tpu's `_use_loop_vjp` dispatches at the shard-local batch.
  * SP   -- the patch axis n is cut into contiguous row bands over 'seq';
            consensus runs the ring / Ulysses / halo body of the rank's
            band (f32 inside), K1 runs on the band's rows, and the update
            is the f32 four-way mean.
  * TP   -- the grouped-FFW hidden axis f is cut over 'model' (Megatron):
            each rank runs K1 on its [G, d, f/mp] / [G, f/mp, d] weight
            shards with b2 scaled by 1/mp (exact: mp must be a power of
            two), and one all-reduce of the output reconstructs the FFW
            (`reduce_from_model`, counted as glom_tpu's "tp_ffw_psum").
            The replicated inputs of the shard (x, the positional addend,
            b2) enter through `copy_to_model`, whose backward sums their
            partial gradients over 'model'; K2 runs whole on every rank.
            With tp_axis="levels" (glom_tpu's EP-style split) bottom_up's
            group axis is cut instead: model rank r holds groups [r L/mp,
            (r+1) L/mp) at full f, runs K1 on the carry slots they read
            (`split_to_model`, whose backward all-gathers those slots'
            gradient) and all-gathers the outputs into [L, b, n, d]
            (`gather_from_model`, whose backward keeps the rank's slice);
            top_down (G = L-1) keeps the hidden split. glom_tpu runs this
            layout under GSPMD only, without its kernels; here K1 runs on
            the rank's groups, the same math.
  * loss -- the patch-space MSE on the rank's (batch band x patch band)
            block, divided by the seq size: summed over 'seq' it is each
            data rank's full-image loss, and the mean over 'data' is the
            global loss.

Gradients. torch's autograd on a rank reaches only that rank's tensors;
the ring's, the halo's and the all-to-all's backward passes send each
cotangent back to the rank that owns the rows. So each rank's gradient of
a replicated parameter is its partial, and the global gradient is their
sum over 'seq' and 'data' (scaled by 1/dp for the mean over data).
`make_manual_loss` returns the global loss: its backward hands every rank
the 1/dp seed, and the parameters enter through one Function whose
backward sums the partials over 'seq' and then 'data' -- glom_tpu's
shard_map transpose, written out. Under TP the replicated parameters'
gradients are already whole on every model rank (Megatron's pair), and
the sharded weights' are their shards'.

`use_pallas=False` runs the same per-rank bodies on the plain ops
(glom_tpu's dense composition, `manual.py:362-372`); unlike glom_tpu, the
port takes this path for every DistributedTrainer (there is no GSPMD
route to fall back to).

`make_manual_forward` is the inference counterpart (the path `Glom(mesh=)`
takes): every rank is given the global batch, runs its band and
all-gathers the output over 'seq' and then 'data', so each rank returns
the global answer (glom_tpu's out_specs, written out).

The ZeRO step (`make_manual_zero_train_step`) differentiates the rank's
own objective and writes glom_tpu's schedule out: the seq all-reduce, the
optional quantized wire hop, the reduce-scatter over 'data' (or a mean
for a leaf with no dp-divisible axis), Adam on the rank's shard of every
leaf, and the all-gather of the updated shards; stage 2 scatters each
microbatch before it is accumulated. Each rank holds 1/dp of the Adam
moments, laid out per leaf along `zero_shard_axis` (glom_tpu's layout;
torch's ZeroRedundancyOptimizer shards by whole parameter instead).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from glom_tpu_torch.kernels.consensus_update import consensus_update_vjp
from glom_tpu_torch.kernels.grouped_mlp import grouped_ffw_lm_vjp
from glom_tpu_torch.models.core import (
    contribution_divisor,
    map_params,
    param_leaves,
    unflatten_params,
)
from glom_tpu_torch.ops.consensus import build_local_mask, consensus_attention
from glom_tpu_torch.ops.ffw import grouped_ffw_lm
from glom_tpu_torch.ops.patch import image_to_tokens, patchify
from glom_tpu_torch.parallel.collectives import (
    Axis,
    all_gather,
    all_reduce,
    all_reduce_tensors,
    copy_to_model,
    gather_from_model,
    mesh_axis,
    reduce_from_model,
    reduce_scatter,
    split_to_model,
)
from glom_tpu_torch.parallel.halo import halo_consensus_shard
from glom_tpu_torch.parallel.quantized import quantize_dequantize
from glom_tpu_torch.parallel.ring import ring_consensus_shard
from glom_tpu_torch.parallel.sharding import (
    denoise_param_specs,
    glom_param_specs,
    shard_leaf,
    spec_axis,
)
from glom_tpu_torch.parallel.ulysses import ulysses_consensus_shard
from glom_tpu_torch.telemetry import counters as tele_counters
from glom_tpu_torch.telemetry import diagnostics as diag
from glom_tpu_torch.train.objectives import default_recon_index, denoise_loss
from glom_tpu_torch.train.trainer import (
    TrainState,
    _state_tensors,
    accumulate_grads,
    apply_update,
    make_lr_schedule,
    pinned_grad_accum,
)
from glom_tpu_torch.utils.config import GlomConfig, TrainConfig

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


class RankAxes(NamedTuple):
    """This rank's view of the three mesh axes."""

    data: Axis
    seq: Axis
    model: Axis


def rank_axes(mesh) -> RankAxes:
    """The rank's Axis for each of (data, seq, model) of a DeviceMesh (an
    axis it does not name has size 1)."""
    names = tuple(mesh.mesh_dim_names)
    return RankAxes(*(mesh_axis(mesh, n) if n in names else Axis(n, None, 1, 0)
                      for n in (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)))


TP_AXES = ("hidden", "levels")


def manual_supported(mesh, tp_axis: str = "hidden") -> bool:
    """The manual path covers DP x SP x TP on either axis (glom_tpu's
    covers 'hidden' only; its 'levels' is GSPMD's)."""
    return tp_axis in TP_AXES


def check_model_axis(mp: int) -> None:
    """TP adds b2 * (1/mp) on every rank and sums the ranks: exact only
    when 1/mp is, i.e. for a power-of-two mp (glom_tpu's assumption)."""
    if mp < 1 or mp & (mp - 1):
        raise ValueError(f"the model axis ({mp}) must be a power of two")


def check_tp_layout(cfg: GlomConfig, mp: int, tp_axis: str) -> None:
    """The model axis against the layout: a power of two; the hidden width
    (top_down's split on either axis) and, under 'levels', the level
    count (bottom_up's groups) divisible by it."""
    if tp_axis not in TP_AXES:
        raise ValueError(f"tp_axis must be 'hidden' or 'levels', got {tp_axis!r}")
    if mp == 1:
        return
    check_model_axis(mp)
    if (cfg.dim * cfg.mult) % mp:
        raise ValueError(f"hidden width {cfg.dim * cfg.mult} not divisible by model axis {mp}")
    if tp_axis == "levels" and cfg.levels % mp:
        raise ValueError(f"levels {cfg.levels} not divisible by model axis {mp} "
                         "(tp_axis='levels' splits bottom_up's groups)")


def shard_consensus_fn(cfg: GlomConfig, seq: Axis, sp_strategy: str):
    """The per-rank consensus body ([b, n_loc, L, d] -> same) for a
    seq-sharded axis; None when seq is unsharded (the fused consensus +
    update kernel runs whole). Resolution (auto and its fallbacks) is
    runtime.effective_sp_strategy's; 'none' with a sharded seq builds the
    ring, which is exact for any geometry."""
    from glom_tpu_torch.parallel.runtime import effective_sp_strategy

    sp_strategy = effective_sp_strategy(cfg, seq.size, sp_strategy)
    if seq.size == 1:
        return None
    kw = dict(axis=seq, attend_self=cfg.consensus_self, side=cfg.num_patches_side,
              radius=float(cfg.local_consensus_radius))
    if sp_strategy == "ulysses":
        return partial(ulysses_consensus_shard, **kw)
    if sp_strategy == "halo":
        return partial(halo_consensus_shard, **kw)
    return partial(ring_consensus_shard, **kw)


def _band(t: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous 1/size of `t` along `dim`."""
    size = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * size, size)


def _ffw_fn(use_pallas: bool, model: Axis, split: str = "hidden"):
    """ffw(params, x [G, M, d], add=None [n, d]) -> [G, M, d]: K1 with its
    backward (or the plain grouped FFW), as this rank's hidden shard under
    TP, or with split="levels" on this rank's G/mp groups of x (`params`
    holds those groups), the outputs gathered over 'model'."""

    def base(p, x, add=None):
        if use_pallas:
            return grouped_ffw_lm_vjp(p, x, add=add)
        if add is not None:
            x = x + add.repeat(x.shape[1] // add.shape[0], 1)
        return grouped_ffw_lm(p, x)

    if model.size == 1:
        return base
    if split == "levels":
        def ep(p, x, add=None):
            return gather_from_model(base(p, split_to_model(x, model), add=add), model)

        return ep
    inv_mp = 1.0 / model.size

    def tp(p, x, add=None):
        ins = [x, p.b2] if add is None else [x, p.b2, add]
        x, b2, *rest = copy_to_model(ins, model)
        out = base(p._replace(b2=b2 * inv_mp), x, add=rest[0] if rest else None)
        return reduce_from_model(out, model, site="tp_ffw_psum")

    return tp


RETURN_MODES = ("top", "final", "all")


def _forward_local(gp, noised: torch.Tensor, cfg: GlomConfig, *, iters: int, axes: RankAxes,
                   consensus_shard, remat: bool, use_pallas: bool,
                   levels0_lm: Optional[torch.Tensor] = None,
                   return_mode: str = "top", tp_axis: str = "hidden") -> torch.Tensor:
    """The per-rank forward of a seq- or model-sharded rank: its batch band
    of `noised`, its patch band, its hidden shard (or under tp_axis
    "levels" its bottom_up groups); level-major carry, K1 per
    FFW, K2 whole at seq = 1 (per-op) or the shard consensus and the f32
    mean at seq > 1. `levels0_lm` carries in an [L, b_loc, n_loc, d] state
    (the temporal API). return_mode: 'top' the final top level [b_loc,
    n_loc, d] (the training loss), 'final' the final state [L, b_loc,
    n_loc, d], 'all' all T+1 states [T+1, L, b_loc, n_loc, d], the initial
    one included."""
    if return_mode not in RETURN_MODES:
        raise ValueError(f"return_mode={return_mode!r}: one of {RETURN_MODES}")
    L, d = cfg.levels, cfg.dim
    n_loc = cfg.num_patches // axes.seq.size
    # Patchify and embed the whole image, then keep the band: the grid is
    # row-major, so a contiguous n-band is a contiguous row band.
    tokens = _band(image_to_tokens(gp.token_embed, noised, cfg.patch_size), axes.seq, dim=1)
    pos = _band(gp.pos_emb, axes.seq)
    b = tokens.shape[0]
    M = b * n_loc
    ffw = _ffw_fn(use_pallas, axes.model)
    bu_ffw = _ffw_fn(use_pallas, axes.model, tp_axis)
    geometry = dict(side=cfg.num_patches_side, radius=float(cfg.local_consensus_radius),
                    attend_self=cfg.consensus_self)
    if consensus_shard is None and not use_pallas:
        mask = build_local_mask(cfg.num_patches_side, cfg.local_consensus_radius)
        consensus_shard = partial(
            consensus_attention, attend_self=cfg.consensus_self,
            local_mask=None if mask is None else torch.as_tensor(mask, device=tokens.device),
        )
    divisor = contribution_divisor(L, torch.float32, tokens.device).reshape(L, 1, 1, 1)

    def step(carry):
        lv = carry[1:]
        bu = bu_ffw(gp.bottom_up, carry[:L].reshape(L, M, d)).view(L, b, n_loc, d)
        td = ffw(gp.top_down, carry[2:].reshape(L - 1, M, d), add=pos).view(L - 1, b, n_loc, d)
        if consensus_shard is None:
            new = consensus_update_vjp(lv, bu, td, **geometry)
        else:
            cons = consensus_shard(lv.permute(1, 2, 0, 3)).permute(2, 0, 1, 3)
            td_full = F.pad(td, (0, 0, 0, 0, 0, 0, 0, 1))
            new = ((lv.float() + bu.float() + td_full.float() + cons.float())
                   / divisor).to(lv.dtype)
        return torch.cat([carry[:1], new])

    if levels0_lm is not None:
        levels0 = levels0_lm.to(tokens.dtype)
    else:
        levels0 = gp.init_levels[:, None, None, :].expand(L, b, n_loc, d).to(tokens.dtype)
    carry = torch.cat([tokens[None], levels0])
    states = [carry[1:]]
    for _ in range(iters):
        carry = checkpoint(step, carry, use_reentrant=False) if remat else step(carry)
        if return_mode == "all":
            states.append(carry[1:])
    if return_mode == "all":
        return torch.stack(states)
    return carry[1:] if return_mode == "final" else carry[-1]


def make_manual_forward(mesh, cfg: GlomConfig, *, iters: Optional[int] = None,
                        sp_strategy: str = "none", compute_dtype=None, use_pallas: bool = True,
                        return_all: bool = False, with_levels: bool = False,
                        remat: bool = False):
    """Sharded inference through the kernels (glom_tpu `manual.py:464`):
    glom_forward's contract -- the final [b, n, L, d], or all T+1 states
    with return_all -- as the per-rank body over (data, seq, model). Returns
    fn(params, img) (fn(params, img, levels0) with with_levels, a carried-in
    [b, n, L, d] state): every rank passes the GLOBAL params, batch and
    state, runs its band and gets the global answer (gathered over 'seq',
    then 'data').

    A rank at seq = 1 and model = 1 with use_pallas runs `glom_forward`'s
    fused route on its batch band (without a gradient the no-grad fused
    forward, K1 and K2 into two swapped carries; with one the whole-loop
    VJP or the per-iteration Functions, as glom_tpu's `_use_loop_vjp` picks
    at the rank-local batch). Any other rank runs `_forward_local`: K1 on
    its hidden shard (the 'tp_ffw_psum' all-reduce at model > 1), K2 whole
    at seq = 1, the ring / Ulysses / halo body at seq > 1."""
    from glom_tpu_torch.models.core import glom_forward

    axes = rank_axes(mesh)
    seq, mp = axes.seq.size, axes.model.size
    T = iters if iters is not None else cfg.default_iters
    if cfg.num_patches % seq:
        raise ValueError(f"patches {cfg.num_patches} not divisible by seq axis {seq}")
    check_tp_layout(cfg, mp, "hidden")
    consensus_shard = shard_consensus_fn(cfg, axes.seq, sp_strategy)
    fused = seq == 1 and mp == 1 and use_pallas
    specs = glom_param_specs("hidden")
    coords = {MODEL_AXIS: (axes.model.index, mp)}

    def fwd(params, img, levels0=None):
        if with_levels != (levels0 is not None):
            raise ValueError("levels0 is required with with_levels=True and refused without")
        if mp > 1:
            from glom_tpu_torch.utils.checkpoint import named_leaves

            params = unflatten_params(params, [
                shard_leaf(t, specs[name], coords).contiguous()
                for name, t in named_leaves(params)])
        if compute_dtype is not None:
            params = map_params(lambda t: t.to(compute_dtype), params)
            img = img.to(compute_dtype)
        img = _band(img, axes.data)
        lv = None
        if levels0 is not None:
            lv = _band(_band(levels0, axes.data), axes.seq, dim=1).to(img.dtype)
        if fused:
            out = glom_forward(params, img, cfg, iters=T, levels=lv, return_all=return_all,
                               use_pallas=True, remat=remat)
        else:
            out = _forward_local(
                params, img, cfg, iters=T, axes=axes, consensus_shard=consensus_shard,
                remat=remat, use_pallas=use_pallas,
                levels0_lm=None if lv is None else lv.permute(2, 0, 1, 3),
                return_mode="all" if return_all else "final")
            # level-major -> the reference layout [.., b, n, L, d]
            out = out.permute(0, 2, 3, 1, 4) if return_all else out.permute(1, 2, 0, 3)
        n_dim, b_dim = (2, 1) if return_all else (1, 0)
        return all_gather(all_gather(out, axes.seq, n_dim), axes.data, b_dim)

    if with_levels:
        return fwd
    return lambda params, img: fwd(params, img)


def _build_local_loss(axes: RankAxes, cfg: GlomConfig, tcfg: TrainConfig, *,
                      sp_strategy: str = "none", tp_axis: str = "hidden"):
    """The per-rank objective both manual train steps share: returns
    (local_obj, seq, mp) where local_obj(params, img_band, noise_band) ->
    scalar is this rank's partial of its data rank's loss (the band MSE
    divided by seq; summed over 'seq' it is the loss of the batch band).
    Not yet reduced over anything."""
    seq, mp = axes.seq.size, axes.model.size
    T = tcfg.iters if tcfg.iters is not None else cfg.default_iters
    k = tcfg.recon_iter_index if tcfg.recon_iter_index is not None else default_recon_index(T)
    if not 1 <= k <= T:
        raise ValueError(f"recon_index {k} outside 1..{T}")
    if cfg.num_patches % seq:
        raise ValueError(f"patches {cfg.num_patches} not divisible by seq axis {seq}")
    check_tp_layout(cfg, mp, tp_axis)
    compute_dtype = torch.bfloat16 if tcfg.compute_dtype == "bfloat16" else None

    if seq == 1 and mp == 1:
        # A DP rank: the single-device loss on its batch band, whose
        # resolve_vjp_path at the rank-local batch is glom_tpu's
        # _use_loop_vjp: the whole-loop VJP where the band admits it.
        def dp_obj(params, img, noise):
            return denoise_loss(
                params, img, noise, cfg, recon_index=tcfg.recon_iter_index, iters=tcfg.iters,
                remat=tcfg.remat, compute_dtype=compute_dtype, use_pallas=tcfg.use_pallas,
            )

        return dp_obj, seq, mp

    consensus_shard = shard_consensus_fn(cfg, axes.seq, sp_strategy)

    def band_obj(params, img, noise):
        gp = params.glom
        if compute_dtype is not None:
            gp = map_params(lambda t: t.to(compute_dtype), gp)
        noised = (img + noise).to(compute_dtype or img.dtype)
        top = _forward_local(gp, noised, cfg, iters=k, axes=axes, consensus_shard=consensus_shard,
                             remat=tcfg.remat, use_pallas=tcfg.use_pallas, tp_axis=tp_axis)
        # The reconstruction and MSE in PATCH space: the same pixel set as
        # the image-space MSE (patchify is a permutation), on the band.
        recon = top.to(img.dtype) @ params.to_pixels.w + params.to_pixels.b
        target = _band(patchify(img, cfg.patch_size), axes.seq, dim=1)
        return torch.mean((target - recon) ** 2) / seq

    return band_obj, seq, mp


class _GlobalLoss(torch.autograd.Function):
    """The global loss from every rank's objective: summed over 'seq',
    averaged over 'data'. Backward: each rank's objective gets 1/dp, so the
    ranks' partial gradients sum to the global one."""

    @staticmethod
    def forward(ctx, obj, axes):
        ctx.dp = axes.data.size
        return all_reduce(all_reduce(obj.detach(), axes.seq), axes.data) / ctx.dp

    @staticmethod
    def backward(ctx, g):
        return g / ctx.dp, None


class _SumGrads(torch.autograd.Function):
    """The parameter leaves as they enter the loss: the same values, whose
    partial gradients are summed over 'seq' and then 'data' (one flat
    all-reduce each) -- glom_tpu's shard_map transpose of replicated-in
    params."""

    @staticmethod
    def forward(ctx, axes, *leaves):
        ctx.axes = axes
        ctx.meta = [(t.shape, t.dtype, t.device) for t in leaves]
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=dt, device=dev) if g is None else g
              for g, (s, dt, dev) in zip(gs, ctx.meta)]
        gs = all_reduce_tensors(all_reduce_tensors(gs, ctx.axes.seq), ctx.axes.data)
        return (None, *gs)


def _global_band_loss(local_obj, axes: RankAxes):
    """loss(params, img_band, noise_band) -> the global loss, differentiable
    to the globally reduced gradients on every rank (the identity on one
    rank)."""
    if axes.data.size == 1 and axes.seq.size == 1:
        return local_obj

    def loss(params, img, noise):
        leaves = _SumGrads.apply(axes, *param_leaves(params))
        return _GlobalLoss.apply(local_obj(unflatten_params(params, leaves), img, noise), axes)

    return loss


def make_manual_loss(mesh, cfg: GlomConfig, tcfg: TrainConfig, *, sp_strategy: str = "none",
                     tp_axis: str = "hidden"):
    """loss(params, img, noise) -> the global loss on every rank, from the
    GLOBAL img and noise (each rank takes its data band). Differentiable:
    torch.autograd.grad of it gives every rank the global gradient of each
    of its leaves (the TP shards' for the model-sharded weights, laid out
    by `tp_axis`)."""
    axes = rank_axes(mesh)
    local_obj, _, _ = _build_local_loss(axes, cfg, tcfg, sp_strategy=sp_strategy,
                                        tp_axis=tp_axis)
    band_loss = _global_band_loss(local_obj, axes)

    def loss(params, img, noise):
        return band_loss(params, _band(img, axes.data), _band(noise, axes.data))

    return loss


def _check_batch(tcfg: TrainConfig, dp: int) -> int:
    accum = pinned_grad_accum(tcfg)
    if tcfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype={tcfg.compute_dtype!r}: must be 'float32' or 'bfloat16'")
    if tcfg.batch_size % accum:
        raise ValueError(f"grad_accum={accum} must divide batch_size={tcfg.batch_size}")
    if (tcfg.batch_size // accum) % dp:
        raise ValueError(f"microbatch {tcfg.batch_size // accum} not divisible by data axis {dp}")
    return accum


def model_sharded(params, tp_axis: str = "hidden") -> list:
    """For each leaf (param_leaves order): whether the `tp_axis` layout
    splits it over 'model'."""
    from glom_tpu_torch.utils.checkpoint import named_leaves

    specs = denoise_param_specs(tp_axis)
    return [MODEL_AXIS in specs[name] for name, _ in named_leaves(params)]


def mesh_norm(tensors, sharded, axis: Axis) -> torch.Tensor:
    """The global L2 norm of a list of leaves of which those flagged in
    `sharded` are this rank's shards over `axis` (their squares are summed
    over it) and the rest are whole on every rank (counted once)."""
    sq_sharded = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    sq_whole = torch.zeros_like(sq_sharded)
    for t, s in zip(tensors, sharded):
        sq = torch.sum(t.float() ** 2)
        if s:
            sq_sharded = sq_sharded + sq
        else:
            sq_whole = sq_whole + sq
    return torch.sqrt(all_reduce(sq_sharded, axis) + sq_whole)


def make_manual_train_step(mesh, cfg: GlomConfig, tcfg: TrainConfig, *,
                           sp_strategy: str = "none", with_grad_norm: bool = True,
                           level: Optional[str] = None, tp_axis: str = "hidden"):
    """(state, img, generator) -> (state, metrics): the stage-0 step (the
    single-device step's contract: the noise of the GLOBAL batch drawn from
    `generator`, each rank its band; the strided microbatches; Adam on the
    rank's leaves with the globally reduced gradients; grad norm and, under
    telemetry, the taps and the guard). `level` is the resolved telemetry
    level (DistributedTrainer degrades "full" to "scalars"); `tp_axis` the
    layout of the rank's model-sharded leaves."""
    axes = rank_axes(mesh)
    accum = _check_batch(tcfg, axes.data.size)
    level = level if level is not None else diag.resolve_telemetry_level(tcfg)
    local_obj, _, mp = _build_local_loss(axes, cfg, tcfg, sp_strategy=sp_strategy,
                                         tp_axis=tp_axis)
    band_loss = _global_band_loss(local_obj, axes)
    lr = make_lr_schedule(tcfg)

    def train_step(state: TrainState, img: torch.Tensor, generator: torch.Generator):
        noise = tcfg.noise_std * torch.randn(img.shape, generator=generator, device=img.device,
                                             dtype=img.dtype)
        img, noise = _band(img, axes.data), _band(noise, axes.data)
        leaves = param_leaves(state.params)
        loss, grads = accumulate_grads(band_loss, state.params, img, noise, accum)
        norm = diag.global_norm
        if mp > 1:
            norm = partial(mesh_norm, sharded=model_sharded(state.params, tp_axis),
                           axis=axes.model)
        metrics = apply_update(state, leaves, grads, {"loss": loss, "step": state.step}, lr=lr,
                               level=level, tcfg=tcfg, with_grad_norm=with_grad_norm, norm=norm)
        return state._replace(step=state.step + 1), metrics

    return train_step


def zero_shard_axes(params, zero_pspecs: Dict[str, tuple]) -> list:
    """For each leaf (param_leaves order): the dimension 'data' splits in the
    ZeRO layout, or -1 for a leaf whose optimizer state stays replicated."""
    from glom_tpu_torch.utils.checkpoint import named_leaves

    return [spec_axis(zero_pspecs[name], DATA_AXIS) for name, _ in named_leaves(params)]


def zero_shards(params, shard_axes: list, data: Axis) -> list:
    """The rank's shard of every leaf along its ZeRO axis (a whole copy for
    a replicated leaf): the tensors the ZeRO step's optimizer updates."""
    return [
        (_band(t.detach(), data, ax) if ax >= 0 else t.detach()).clone().requires_grad_()
        for t, ax in zip(param_leaves(params), shard_axes)
    ]


def make_manual_zero_train_step(mesh, cfg: GlomConfig, tcfg: TrainConfig, *, zero_stage: int,
                                zero_pspecs: Dict[str, tuple], sp_strategy: str = "none",
                                with_grad_norm: bool = True,
                                quantized_reduce: Optional[bool] = None,
                                level: Optional[str] = None):
    """(state, img, generator) -> (state, metrics): glom_tpu's explicit
    ZeRO weight update. `state.params` are the whole (data-replicated)
    leaves; `state.optimizer` runs over `zero_shards(params, ...)`, in leaf
    order. Per step:

      1. the rank's objective and its gradient (no implicit reduction);
      2. the all-reduce over 'seq' of every leaf ("zero_seq_psum");
      3. with the quantized reduce, one int8 wire hop on the local
         contribution;
      4. the reduce-scatter over 'data' along the leaf's ZeRO axis, / dp
         ("zero_psum_scatter"), or the mean for a leaf with none
         ("zero_pmean_fallback");
      5. Adam on the shards;
      6. the all-gather of the updated shards into the leaves
         ("zero_all_gather").

    Stage 2 runs 2-4 on each microbatch before accumulating, so the
    accumulator holds only the shards. Requires model == 1."""
    axes = rank_axes(mesh)
    if axes.model.size > 1:
        raise ValueError("the manual ZeRO step supports model == 1")
    dp, seq = axes.data.size, axes.seq
    accum = _check_batch(tcfg, dp)
    local_obj, _, _ = _build_local_loss(axes, cfg, tcfg, sp_strategy=sp_strategy)
    quantized = bool(tcfg.quantized_reduce) if quantized_reduce is None else quantized_reduce
    level = level if level is not None else diag.resolve_telemetry_level(tcfg)
    lr = make_lr_schedule(tcfg)
    # The quantization probe needs the hop to see the full accumulated
    # gradient; stage 2 with accumulation quantizes per microbatch.
    probe_quant = quantized and level != "off" and not (zero_stage >= 2 and accum > 1)

    def seq_reduce(grads):
        return [all_reduce(g, seq, site="zero_seq_psum") for g in grads]

    def scatter_leaf(g, ax):
        if ax < 0:
            # No dp-divisible axis: the leaf stays replicated through a full
            # all-reduce, which comm_volume_model prices as scattered.
            nbytes = tele_counters.ring_reduce_scatter_bytes(g, dp, quantized=quantized) * 2
            return all_reduce(g, axes.data, site="zero_pmean_fallback", collective="pmean",
                              wire_bytes=nbytes) / dp
        nbytes = tele_counters.ring_reduce_scatter_bytes(g, dp, quantized=quantized)
        return reduce_scatter(g, axes.data, ax, site="zero_psum_scatter", wire_bytes=nbytes) / dp

    def scatter_tree(grads, shard_axes):
        return [scatter_leaf(g, ax) for g, ax in zip(grads, shard_axes)]

    def sharded_grad_norm(shards, shard_axes):
        # The sum of squares splits over the ownership partition: the
        # scattered leaves' sums add over 'data', the replicated leaves
        # count once.
        return mesh_norm(shards, [ax >= 0 for ax in shard_axes], axes.data)

    def train_step(state: TrainState, img: torch.Tensor, generator: torch.Generator):
        noise = tcfg.noise_std * torch.randn(img.shape, generator=generator, device=img.device,
                                             dtype=img.dtype)
        img, noise = _band(img, axes.data), _band(noise, axes.data)
        leaves = param_leaves(state.params)
        shard_axes = zero_shard_axes(state.params, zero_pspecs)
        opt = state.optimizer
        shards = opt.param_groups[0]["params"]
        qerr = None
        if zero_stage >= 2 and accum > 1:
            done = []

            def per_microbatch(grads):
                # glom_tpu traces this hook once and runs it per
                # microbatch: its counters price the first call times
                # accum, and count each site once.
                with (tele_counters.paused() if done else tele_counters.scaled(accum)):
                    done.append(True)
                    grads = seq_reduce(grads)
                    if quantized:
                        grads = [quantize_dequantize(g) for g in grads]
                    return scatter_tree(grads, shard_axes)

            obj, g_shards = accumulate_grads(local_obj, state.params, img, noise, accum,
                                             grad_transform=per_microbatch)
        else:
            obj, grads = accumulate_grads(local_obj, state.params, img, noise, accum)
            grads = seq_reduce(grads)
            if quantized:
                dq = [quantize_dequantize(g) for g in grads]
                if probe_quant:
                    qerr = diag.quantization_error(grads, dq)
                grads = dq
            g_shards = scatter_tree(grads, shard_axes)
        loss = all_reduce(all_reduce(obj.detach(), seq), axes.data) / dp
        metrics = {"loss": loss}
        if with_grad_norm or level != "off":
            gnorm = sharded_grad_norm(g_shards, shard_axes)
            metrics["grad_norm"] = gnorm
        if level != "off":
            old_p = [t.detach().clone() for t in leaves]
            old_s = [t.detach().clone() for t in shards]
            old_state = [t.clone() for t in _state_tensors(opt)]
        for s, g in zip(shards, g_shards):
            s.grad = g
        for group in opt.param_groups:
            group["lr"] = lr(state.step) if callable(lr) else lr
        opt.step()
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            for p, s, ax in zip(leaves, shards, shard_axes):
                p.copy_(all_gather(s.detach(), axes.data, ax, site="zero_all_gather")
                        if ax >= 0 else s)
            if level != "off":
                new_s = [s.detach() for s in shards]
                metrics["update_norm"] = sharded_grad_norm(
                    [n - o for n, o in zip(new_s, old_s)], shard_axes)
                new_p = [p.detach() for p in leaves]
                metrics["param_norm"] = diag.global_norm(new_p)
                nonfinite = diag.nonfinite_flag(loss, gnorm)
                if tcfg.nonfinite_policy == "skip":
                    cur = _state_tensors(opt)
                    if not old_state:  # the first step made the state
                        old_state = [torch.zeros_like(t) for t in cur]
                    for new, old in ((new_p, old_p), (new_s, old_s), (cur, old_state)):
                        for t, v in zip(new, diag.guard_update(nonfinite, new, old)):
                            t.copy_(v)
                    metrics["skipped_nonfinite"] = nonfinite.to(torch.int32)
                metrics["nonfinite_step"] = nonfinite.to(torch.int32)
                if probe_quant:
                    metrics["quant_rel_err"] = qerr
        metrics["step"] = state.step
        return state._replace(step=state.step + 1), metrics

    return train_step
