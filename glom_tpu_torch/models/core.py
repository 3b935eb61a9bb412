"""The functional GLOM core: parameter init, one column-update step, and the
T-iteration forward.

Counterpart of `glom_tpu/models/core.py`. Reference parity: Glom.__init__ /
Glom.forward (glom_pytorch/glom_pytorch.py:75-152). Plain functions over a
`GlomParams` tuple of tensors, in the reference's layouts: images
[b, c, H, W], levels [b, n, L, d], `return_all` -> [T+1, b, n, L, d].

Two routes behind `glom_forward`:
  * the reference layout (`use_pallas=False`): concat, the two grouped
    FFWs, dense consensus and the mean, one op at a time;
  * the fused route (`use_pallas=True`, the name kept for parity): a
    level-major carry and, per iteration, the K1 kernel twice (bottom-up,
    top-down with the positional addend folded in) and the K2 kernel once
    (consensus + 4-way mean). On CPU tensors the kernels' plain versions run.
    When grad mode is on and an input requires grad, the route depends on
    the shapes (`resolve_vjp_path`, glom_tpu's rule): at batch >= 8 the
    whole loop runs under the hand-written whole-loop VJP (K3,
    `kernels/fused_loop.py`, "fused_loop"); otherwise each launch goes
    through an autograd Function whose backward is the K1 or K2 backward
    kernel (glom_tpu's per-iteration custom VJPs, "scan_blockwise").

`remat=True` recomputes each iteration in the backward: on the whole-loop
VJP it recomputes the FFWs' pre-activations with the pre-only kernel, and
elsewhere it is `torch.utils.checkpoint` (glom_tpu's jax.checkpoint over
the scan body).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from glom_tpu_torch.kernels.consensus_update import (
    consensus_update_vjp,
    fused_consensus_update,
)
from glom_tpu_torch.kernels.fused_loop import fused_glom_loop, loop_supported
from glom_tpu_torch.kernels.grouped_mlp import fused_grouped_ffw_lm, grouped_ffw_lm_vjp
from glom_tpu_torch.ops.consensus import build_local_mask, consensus_attention
from glom_tpu_torch.ops.ffw import GroupedFFWParams, grouped_ffw, init_grouped_ffw
from glom_tpu_torch.ops.patch import LinearParams, image_to_tokens, init_linear
from glom_tpu_torch.utils.config import GlomConfig
from glom_tpu_torch.utils.helpers import default, exists

ConsensusFn = Callable[[torch.Tensor], torch.Tensor]
FFWFn = Callable[[GroupedFFWParams, torch.Tensor], torch.Tensor]


def _on_card(device) -> bool:
    """Seam for the dispatch policy's device check, the twin of glom_tpu's
    `_on_tpu` (the CPU tests patch it to drive the card's routing through
    the kernels' plain versions)."""
    return torch.device(device).type == "cuda"


class GlomParams(NamedTuple):
    """Learnable state, mirroring the reference module tree."""

    token_embed: LinearParams  # Linear(p*p*c -> d)        (reference :88-91)
    pos_emb: torch.Tensor  # [n, d] learned position table   (reference :92)
    init_levels: torch.Tensor  # [L, d] learned column init  (reference :95)
    bottom_up: GroupedFFWParams  # groups = L               (reference :98)
    top_down: GroupedFFWParams  # groups = L - 1            (reference :99)


def param_leaves(params) -> list:
    """The tensors of a (nested) params NamedTuple, in field order."""
    if isinstance(params, torch.Tensor):
        return [params]
    return [t for field in params for t in param_leaves(field)]


def unflatten_params(template, leaves):
    """`template`'s (nested) NamedTuple structure over `leaves`, given in
    `param_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        return type(node)(*(build(field) for field in node))

    return build(template)


def map_params(fn, params: GlomParams) -> GlomParams:
    """Apply `fn` to every tensor of `params`."""
    return GlomParams(
        token_embed=LinearParams(*map(fn, params.token_embed)),
        pos_emb=fn(params.pos_emb),
        init_levels=fn(params.init_levels),
        bottom_up=GroupedFFWParams(*map(fn, params.bottom_up)),
        top_down=GroupedFFWParams(*map(fn, params.top_down)),
    )


def init_glom(
    cfg: GlomConfig,
    *,
    generator: Optional[torch.Generator] = None,
    device="cpu",
    dtype=torch.float32,
) -> GlomParams:
    """The reference's shapes and init families, drawn on the CPU from
    `generator` (so a seed gives the same weights on every device), then
    moved to `device`."""
    params = GlomParams(
        token_embed=init_linear(cfg.patch_dim, cfg.dim, generator=generator, dtype=dtype),
        pos_emb=torch.randn(cfg.num_patches, cfg.dim, generator=generator, dtype=dtype),
        init_levels=torch.randn(cfg.levels, cfg.dim, generator=generator, dtype=dtype),
        bottom_up=init_grouped_ffw(
            cfg.levels, cfg.dim, cfg.mult, generator=generator, dtype=dtype
        ),
        top_down=init_grouped_ffw(
            cfg.levels - 1, cfg.dim, cfg.mult, generator=generator, dtype=dtype
        ),
    )
    return map_params(lambda t: t.to(device), params)


def contribution_divisor(levels: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[L, 1] per-level mean divisor: 4 contributions everywhere except the
    top level, which has no top-down input and divides by 3 (reference
    :121-122)."""
    div = torch.full((levels, 1), 4.0, dtype=dtype, device=device)
    div[-1] = 3.0
    return div


def update_step(
    params: GlomParams,
    levels: torch.Tensor,
    bottom: torch.Tensor,
    pos: torch.Tensor,
    divisor: torch.Tensor,
    *,
    consensus_fn: ConsensusFn,
    ffw_fn: FFWFn = grouped_ffw,
) -> torch.Tensor:
    """One column update: the mean of (previous value, bottom-up, top-down,
    consensus) (reference :124-140).

    levels: [b, n, L, d]   bottom: [b, n, 1, d]   pos: [1, n, 1, d]
    """
    with_input = torch.cat([bottom, levels], dim=-2)  # [b, n, L+1, d]
    # Bottom-up sees (image tokens, levels 1..L-1): level 1 re-reads the
    # raw tokens every iteration (reference :127).
    bottom_up_out = ffw_fn(params.bottom_up, with_input[..., :-1, :])
    # Top-down sees levels 2..L with the positional embedding injected here
    # only (reference :129), zero-padded at the top (reference :130).
    top_down_out = ffw_fn(params.top_down, with_input[..., 2:, :] + pos)
    top_down_out = torch.nn.functional.pad(top_down_out, (0, 0, 0, 1))
    consensus = consensus_fn(levels)
    new_levels = (levels + bottom_up_out + top_down_out + consensus) / divisor
    return new_levels.to(levels.dtype)


def glom_forward(
    params: GlomParams,
    img: torch.Tensor,
    cfg: GlomConfig,
    *,
    iters: Optional[int] = None,
    levels: Optional[torch.Tensor] = None,
    return_all: bool = False,
    compute_dtype=None,
    consensus_fn: Optional[ConsensusFn] = None,
    use_pallas: bool = False,
    remat: bool = False,
    scan_only: bool = False,
) -> torch.Tensor:
    """The T-iteration GLOM forward (reference :103-152).

    img: [b, c, H, W] -> [b, n, L, d], or [T+1, b, n, L, d] with return_all
    (T+1 includes the initial state). `levels` [b, n, L, d] continues from a
    previous call. Params, image and levels are cast to `compute_dtype`
    once, before the loop. use_pallas=True selects the fused level-major
    route through the K1/K2 kernels. remat=True recomputes each iteration's
    activations in the backward instead of keeping them. scan_only=True
    keeps a training forward off the whole-loop VJP (glom_tpu's
    `scan_only`): its backward is then the per-iteration kernels'.
    """
    T = default(iters, cfg.default_iters)
    if compute_dtype is not None:
        params = map_params(lambda t: t.to(compute_dtype), params)
        img = img.to(compute_dtype)
        if exists(levels):
            levels = levels.to(compute_dtype)

    if use_pallas:
        if consensus_fn is not None:
            raise NotImplementedError(
                "use_pallas with a custom consensus_fn is the sharded route "
                "(ROADMAP queue A item 8b)"
            )
        return _glom_forward_fused(
            params, img, cfg, iters=T, levels_in=levels, return_all=return_all,
            remat=remat, scan_only=scan_only,
        )

    if consensus_fn is None:
        mask = build_local_mask(cfg.num_patches_side, cfg.local_consensus_radius)
        consensus_fn = partial(
            consensus_attention,
            attend_self=cfg.consensus_self,
            local_mask=None if mask is None else torch.as_tensor(mask, device=img.device),
        )

    tokens = image_to_tokens(params.token_embed, img, cfg.patch_size)  # [b, n, d]
    b, n, d = tokens.shape
    pos = params.pos_emb[None, :, None, :]
    bottom = tokens[:, :, None, :]
    if not exists(levels):
        levels = params.init_levels[None, None].expand(b, n, cfg.levels, d).to(tokens.dtype)
    divisor = contribution_divisor(cfg.levels, torch.float32, img.device)

    step = partial(update_step, params, bottom=bottom, pos=pos, divisor=divisor,
                   consensus_fn=consensus_fn)
    states = [levels]
    for _ in range(T):
        levels = checkpoint(step, levels, use_reentrant=False) if remat else step(levels)
        if return_all:
            states.append(levels)
    if return_all:
        return torch.stack(states, dim=0)  # [T+1, b, n, L, d]
    return levels


def resolve_vjp_path(
    cfg: GlomConfig,
    b: int,
    iters: int,
    *,
    remat: bool = False,
    use_pallas: bool = False,
    itemsize: int = 2,
    custom_consensus: bool = False,
    return_all: bool = False,
    scan_only: bool = False,
    device="cuda",
) -> str:
    """Which backward a training forward at these shapes takes (glom_tpu's
    resolve_vjp_path, the one source both the dispatch and the records
    read):

      'fused_loop'     -- the whole-loop VJP (K3, kernels/fused_loop.py):
                          on the card, batch >= 8, the final state only
                          (not return_all), not scan_only, and shapes
                          `loop_supported` takes;
      'scan_blockwise' -- the fused route on the card otherwise: per
                          iteration, the K1 and K2 backward kernels;
      'scan_dense'     -- anything else (the reference route, a custom
                          consensus_fn, or the plain versions on the CPU).

    The batch >= 8 threshold is glom_tpu's, measured on the TPU and kept
    for route parity. Where glom_tpu answers 'scan_dense' on the TPU for a
    small global-consensus batch, the port answers 'scan_blockwise': its
    K2 backward kernel runs at every batch. Its `loop_supported` has the
    port's own limits (see kernels/fused_loop.py).
    """
    if not use_pallas or custom_consensus or not _on_card(device):
        return "scan_dense"
    n, d, L = cfg.num_patches, cfg.dim, cfg.levels
    if (
        not scan_only
        and not return_all
        and b >= 8
        and loop_supported(
            L, b, n, d, d * cfg.mult, itemsize, iters, n, remat,
            side=cfg.num_patches_side, radius=float(cfg.local_consensus_radius),
        )
    ):
        return "fused_loop"
    return "scan_blockwise"


def _wants_grad(params: GlomParams, *tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (*param_leaves(params), *tensors)
    )


def _use_fused_loop(
    params: GlomParams, cfg: GlomConfig, tokens: torch.Tensor, iters: int,
    levels_in: Optional[torch.Tensor], return_all: bool, remat: bool, scan_only: bool,
) -> bool:
    """Dispatch to the whole-loop VJP (glom_tpu's `_use_fused_loop`): what
    needs the actual tensors (a carried-in levels dtype, the token and FFW
    widths against the config; the caller has checked the positional table
    against the tokens) is checked here; the policy lives in
    `resolve_vjp_path`."""
    b, n, d = tokens.shape
    if exists(levels_in) and levels_in.dtype != params.init_levels.dtype:
        return False
    if (n, d) != (cfg.num_patches, cfg.dim) or params.bottom_up.w1.shape[-1] != d * cfg.mult:
        return False
    return resolve_vjp_path(
        cfg, b, iters, remat=remat, use_pallas=True, itemsize=tokens.element_size(),
        return_all=return_all, scan_only=scan_only, device=tokens.device,
    ) == "fused_loop"


def per_iteration_loop(
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
    return_all: bool = False,
) -> torch.Tensor:
    """The per-iteration route ('scan_blockwise'): `fused_glom_loop`'s
    arguments and result, each launch through its own autograd Function
    with a fresh carry each iteration. Returns the final level-major
    [L, B, n, d] state, or [T+1, L, B, n, d] with return_all."""
    L = levels0.shape[0]
    b, n, d = tokens.shape
    geometry = dict(side=side, radius=float(radius), attend_self=bool(attend_self))
    carry = torch.cat([tokens[None], levels0])

    def step(carry):
        bu = grouped_ffw_lm_vjp(bu_params, carry[:L].reshape(L, b * n, d))
        td = grouped_ffw_lm_vjp(td_params, carry[2:].reshape(L - 1, b * n, d), add=pos_emb)
        new = consensus_update_vjp(
            carry[1:], bu.view(L, b, n, d), td.view(L - 1, b, n, d), **geometry
        )
        return torch.cat([tokens[None], new])

    states = [carry[1:]]
    for _ in range(iters):
        carry = checkpoint(step, carry, use_reentrant=False) if remat else step(carry)
        if return_all:
            states.append(carry[1:])
    return torch.stack(states) if return_all else carry[1:]


def _glom_forward_fused(
    params: GlomParams,
    img: torch.Tensor,
    cfg: GlomConfig,
    *,
    iters: int,
    levels_in: Optional[torch.Tensor],
    return_all: bool,
    remat: bool = False,
    scan_only: bool = False,
) -> torch.Tensor:
    """The fused forward: a level-major carry and three kernel launches per
    iteration.

    The carry is one [L+1, b, n, d] buffer with the image tokens in slot 0
    and the levels in slots 1..L, so the bottom-up input (slots 0..L-1), the
    top-down input (slots 2..L) and the consensus input (slots 1..L) are all
    contiguous views. A carried-in `levels` takes the tokens' dtype.

    Without a gradient (serving), K2 writes the next levels into a second
    such buffer (it must not write over rows other blocks still read), and
    the two buffers swap each iteration: no concat and no copy. With one,
    the whole loop goes through the whole-loop VJP where `_use_fused_loop`
    says so, or else each launch through the per-iteration autograd
    Functions, with a fresh carry each iteration: autograd keeps the carry
    for the backward, and a kernel's write into a kept buffer would change
    it unseen.
    """
    tokens = image_to_tokens(params.token_embed, img, cfg.patch_size)  # [b, n, d]
    b, n, d = tokens.shape
    L = cfg.levels
    if params.pos_emb.shape != (n, d):
        raise ValueError(f"pos_emb {tuple(params.pos_emb.shape)} != ({n}, {d})")
    geometry = dict(
        side=cfg.num_patches_side,
        radius=float(cfg.local_consensus_radius),
        attend_self=cfg.consensus_self,
    )
    if _wants_grad(params, img, levels_in):
        if exists(levels_in):
            levels_lm = levels_in.permute(2, 0, 1, 3)
        else:
            levels_lm = params.init_levels[:, None, None, :].expand(L, b, n, d)
        args = (params.bottom_up, params.top_down, params.pos_emb, tokens,
                levels_lm.to(tokens.dtype), iters)
        if _use_fused_loop(params, cfg, tokens, iters, levels_in, return_all, remat, scan_only):
            final = fused_glom_loop(*args, remat=remat, **geometry)
            return final.permute(1, 2, 0, 3)  # [b, n, L, d]
        out = per_iteration_loop(*args, remat=remat, return_all=return_all, **geometry)
        if return_all:
            return out.permute(0, 2, 3, 1, 4)  # [T+1, b, n, L, d]
        return out.permute(1, 2, 0, 3)  # [b, n, L, d]

    carry = torch.empty((L + 1, b, n, d), dtype=tokens.dtype, device=tokens.device)
    carry[0] = tokens
    if exists(levels_in):
        carry[1:] = levels_in.permute(2, 0, 1, 3)
    else:
        carry[1:] = params.init_levels[:, None, None, :]
    spare = torch.empty_like(carry)
    spare[0] = tokens
    states = [carry[1:].clone()] if return_all else None

    for _ in range(iters):
        bu = fused_grouped_ffw_lm(params.bottom_up, carry[:L].reshape(L, b * n, d))
        td = fused_grouped_ffw_lm(
            params.top_down, carry[2:].reshape(L - 1, b * n, d), add=params.pos_emb
        )
        fused_consensus_update(
            carry[1:], bu.view(L, b, n, d), td.view(L - 1, b, n, d),
            out=spare[1:], **geometry,
        )
        carry, spare = spare, carry
        if return_all:
            states.append(carry[1:].clone())

    if return_all:
        return torch.stack(states).permute(0, 2, 3, 1, 4)  # [T+1, b, n, L, d]
    return carry[1:].permute(1, 2, 0, 3)  # [b, n, L, d]
