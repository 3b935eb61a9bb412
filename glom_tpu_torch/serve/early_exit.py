"""Consensus-convergence early exit, and the ragged paged forward.

Counterpart of `glom_tpu/serve/early_exit.py`. GLOM's T is a budget: the
per-level consensus agreement doubles as a stopping witness, and a row has
converged once one more update moves no level's agreement by more than a
threshold.

  * `glom_forward_auto` / `glom_forward_tiered` are the fixed-iteration
    forward with the scan replaced by a loop that may stop early (batch
    witness / per-row witness and a quorum). The loop body is the same
    `update_step` in the same order, so threshold 0 (the strict `delta <
    threshold` test can never pass) runs exactly `max_iters` updates and
    gives the fixed loop's state bit for bit. glom_tpu's `lax.while_loop`
    becomes a Python loop whose exit test reads one device flag per
    iteration (a host sync); the carry and the agreement math stay on the
    device. With `use_pallas` the grouped FFW is the K1 kernel
    (`fused_grouped_ffw`) and consensus stays the dense op, as in glom_tpu.
  * `glom_forward_ragged` serves rows of differing patch counts in one
    dispatch, packed page-aligned on a flat [T] token axis: every token
    attends over its own row's window of full-row pages, slots past the
    row's length hard-masked. Three consensus gathers: "windowed" (per
    token), "banded" (per page, the same values from a smaller working
    set), "banded-pallas" (the K4 kernel, `kernels/banded_consensus.py`;
    its plain version on CPU tensors). Warm state arrives as a flat
    `levels0` (a continuation's carry) or as pool pages by index
    (`pool`/`page_idx`, serve/paged_columns.py; -1 takes the cold init).
  * `glom_forward_incremental` is the tiered forward seeded from the input
    delta's page support (`support_agreement` is its witness): rows whose
    frame did not change start converged and pay the `min_iters` floor.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import torch

from glom_tpu_torch.kernels.banded_consensus import banded_ragged_consensus
from glom_tpu_torch.kernels.grouped_mlp import fused_grouped_ffw
from glom_tpu_torch.models.core import contribution_divisor, map_params, update_step
from glom_tpu_torch.ops.consensus import build_local_mask, consensus_attention
from glom_tpu_torch.ops.ffw import grouped_ffw
from glom_tpu_torch.ops.patch import image_to_tokens
from glom_tpu_torch.utils.config import GlomConfig
from glom_tpu_torch.utils.helpers import (
    TOKEN_ATTEND_SELF_VALUE,
    exists,
    l2norm,
    max_neg_value,
)


def batch_agreement(levels: torch.Tensor) -> torch.Tensor:
    """Per-image, per-level agreement of a state [b, n, L, d]: the mean
    over n of the cosine between each patch's level vector and the image's
    mean direction at that level -> [b, L] float32."""
    x = levels.float()
    eps = 1e-8
    xhat = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
    mean = xhat.mean(dim=1, keepdim=True)  # [b, 1, L, d]
    mhat = mean / (torch.linalg.vector_norm(mean, dim=-1, keepdim=True) + eps)
    return (xhat * mhat).sum(dim=-1).mean(dim=1)  # [b, L]


def masked_level_agreement(
    levels: torch.Tensor, valid_mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """[L] agreement over the valid rows only (all rows when mask is None)."""
    per_image = batch_agreement(levels)
    if valid_mask is None:
        return per_image.mean(dim=0)
    w = valid_mask.float()[:, None]  # [b, 1]
    return (per_image * w).sum(dim=0) / w.sum().clamp_min(1.0)


def _validate_auto_args(T: int, min_iters: int, threshold: float) -> None:
    if T < 1:
        raise ValueError(f"max_iters={T} must be >= 1")
    if not 1 <= min_iters <= T:
        raise ValueError(f"min_iters={min_iters} outside 1..{T}")
    if threshold < 0:
        raise ValueError(f"threshold={threshold} must be >= 0")


def _build_update_step(params, img, cfg, levels, compute_dtype, use_pallas):
    """The shared prologue of the auto forwards: cast once, patchify,
    build the per-iteration update. Returns (step(lv) -> new_lv, levels0)
    with the ops of glom_forward's reference-layout route, in its order."""
    ffw_fn = fused_grouped_ffw if use_pallas else grouped_ffw
    mask = build_local_mask(cfg.num_patches_side, cfg.local_consensus_radius)
    consensus_fn = partial(
        consensus_attention,
        attend_self=cfg.consensus_self,
        local_mask=None if mask is None else torch.as_tensor(mask, device=img.device),
    )
    if compute_dtype is not None:
        params = map_params(lambda t: t.to(compute_dtype), params)
        img = img.to(compute_dtype)
        if exists(levels):
            levels = levels.to(compute_dtype)

    tokens = image_to_tokens(params.token_embed, img, cfg.patch_size)  # [b, n, d]
    b, n, d = tokens.shape
    pos = params.pos_emb[None, :, None, :]
    bottom = tokens[:, :, None, :]
    if not exists(levels):
        levels = params.init_levels[None, None].expand(b, n, cfg.levels, d).to(tokens.dtype)
    divisor = contribution_divisor(cfg.levels, torch.float32, img.device)

    def step(lv):
        return update_step(params, lv, bottom, pos, divisor,
                           consensus_fn=consensus_fn, ffw_fn=ffw_fn)

    return step, levels


def glom_forward_auto(
    params,
    img: torch.Tensor,
    cfg: GlomConfig,
    *,
    max_iters: Optional[int] = None,
    threshold: float = 1e-3,
    min_iters: int = 1,
    levels: Optional[torch.Tensor] = None,
    valid_mask: Optional[torch.Tensor] = None,
    compute_dtype=None,
    use_pallas: bool = False,
):
    """The early-exit forward: up to `max_iters` updates, stopping once the
    max-over-levels change of the [L] agreement (valid rows only) drops
    below `threshold`, after at least `min_iters`. Returns (levels
    [b, n, L, d], iters_run int, agreement [L] f32 of the final state)."""
    T = max_iters if max_iters is not None else cfg.default_iters
    _validate_auto_args(T, min_iters, threshold)
    step, lv = _build_update_step(params, img, cfg, levels, compute_dtype, use_pallas)
    agree = masked_level_agreement(lv, valid_mask)
    i = 0
    while i < T:
        new = step(lv)
        new_agree = masked_level_agreement(new, valid_mask)
        done = (new_agree - agree).abs().max() < threshold  # on the device
        lv, agree, i = new, new_agree, i + 1
        if i < T and i >= min_iters and bool(done):  # the one host read
            break
    return lv, i, agree


class TieredAutoResult(NamedTuple):
    """One tiered auto forward's outcome. `row_converged`/`row_iters` are
    per row (device tensors): whether each row's own witness dropped below
    threshold, and the update count at which it first did (rows that never
    converged carry `iters_run`). Every row executes `iters_run` updates."""

    levels: torch.Tensor  # [b, n, L, d]
    iters_run: int
    agreement: torch.Tensor  # [L] float32 (valid rows only)
    row_converged: torch.Tensor  # [b] bool
    row_iters: torch.Tensor  # [b] int32


def row_agreement_delta(agree_rows: torch.Tensor, prev_rows: torch.Tensor) -> torch.Tensor:
    """Per-row witness: max over levels of the absolute agreement move
    between consecutive iterations. [b, L] x2 -> [b] float32."""
    return (agree_rows - prev_rows).abs().amax(dim=-1)


def quorum_need(quorum: float, n_valid: torch.Tensor) -> torch.Tensor:
    """ceil(quorum * n_valid) as an int32 scalar, floored at 1: the
    converged-row count at which a dispatch may exit (f32 arithmetic, as
    glom_tpu's)."""
    q = torch.tensor(quorum, dtype=torch.float32, device=n_valid.device)
    need = torch.ceil(q * n_valid.float())
    return need.to(torch.int32).clamp_min(1)


def _tiered_loop(step, lv, row_agreement, valid, T, threshold, min_iters, quorum,
                 conv0=None, row_iters0=None):
    """The quorum-exit loop shared by the tiered, incremental and ragged
    auto routes: (final state, iters_run, row_converged, row_iters).
    `conv0`/`row_iters0` seed rows that start converged (the incremental
    route's clean rows); the min_iters floor sits in the exit test, so a
    bucket converged from the start still pays it."""
    R = valid.shape[0]
    dev = valid.device
    need = quorum_need(quorum, valid.float().sum())
    prev = row_agreement(lv)
    conv = torch.zeros(R, dtype=torch.bool, device=dev) if conv0 is None else conv0
    row_iters = (torch.full((R,), T, dtype=torch.int32, device=dev)
                 if row_iters0 is None else row_iters0)
    i = 0
    while i < T:
        new = step(lv)
        agree = row_agreement(new)
        delta = row_agreement_delta(agree, prev)
        newly = (delta < threshold) & (i + 1 >= min_iters)
        row_iters = torch.where(newly & ~conv, i + 1, row_iters)
        conv = conv | newly
        lv, prev, i = new, agree, i + 1
        # The one host read, taken only once the floor is paid.
        if i < T and i >= min_iters and bool((conv & valid).sum() >= need):
            break
    # Rows that never converged executed (and still need) iters_run.
    row_iters = torch.where(conv, row_iters, i).to(torch.int32)
    return lv, i, conv, row_iters


def glom_forward_tiered(
    params,
    img: torch.Tensor,
    cfg: GlomConfig,
    *,
    max_iters: Optional[int] = None,
    threshold: float = 1e-3,
    min_iters: int = 1,
    quorum: float = 1.0,
    levels: Optional[torch.Tensor] = None,
    valid_mask: Optional[torch.Tensor] = None,
    compute_dtype=None,
    use_pallas: bool = False,
) -> TieredAutoResult:
    """The two-tier early-exit forward: the update loop of
    glom_forward_auto with a per-row witness and a quorum exit, once
    ceil(quorum * n_valid) valid rows have each converged (after
    `min_iters`). Pad rows (valid_mask False) neither count toward the
    quorum nor against it. threshold 0 runs exactly `max_iters` updates."""
    T = max_iters if max_iters is not None else cfg.default_iters
    _validate_auto_args(T, min_iters, threshold)
    step, lv = _build_update_step(params, img, cfg, levels, compute_dtype, use_pallas)
    b = lv.shape[0]
    valid = (torch.ones(b, dtype=torch.bool, device=lv.device) if valid_mask is None
             else valid_mask.to(device=lv.device, dtype=torch.bool))
    final, iters_run, conv, row_iters = _tiered_loop(
        step, lv, batch_agreement, valid, T, threshold, min_iters, quorum
    )
    agreement = masked_level_agreement(final, valid_mask)
    return TieredAutoResult(final, iters_run, agreement, conv, row_iters)


def support_agreement(levels: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Per-row [b, L] agreement restricted to the support token positions
    ([b, n] bool: the input delta's page support expanded to tokens):
    batch_agreement with both the mean direction and the cosine average
    taken over support tokens only. Rows with empty support read 0.0 at
    every level (constant across iterations: their delta is 0)."""
    x = levels.float()
    eps = 1e-8
    xhat = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
    s = support.float()
    w = s[:, :, None, None]  # [b, n, 1, 1]
    cnt = w.sum(dim=(1, 2, 3)).clamp_min(1.0)  # [b]
    mean = (xhat * w).sum(dim=1, keepdim=True) / cnt[:, None, None, None]
    mhat = mean / (torch.linalg.vector_norm(mean, dim=-1, keepdim=True) + eps)
    cos = (xhat * mhat).sum(dim=-1)  # [b, n, L]
    return (cos * s[:, :, None]).sum(dim=1) / cnt[:, None]


def glom_forward_incremental(
    params,
    img: torch.Tensor,
    cfg: GlomConfig,
    *,
    max_iters: Optional[int] = None,
    threshold: float = 1e-3,
    min_iters: int = 1,
    quorum: float = 1.0,
    levels: Optional[torch.Tensor] = None,
    support_mask: Optional[torch.Tensor] = None,
    valid_mask: Optional[torch.Tensor] = None,
    compute_dtype=None,
    use_pallas: bool = False,
) -> TieredAutoResult:
    """The sparse incremental warm forward: glom_forward_tiered seeded from
    the input delta's support. `support_mask` [b, n] marks the token
    positions whose input changed since the frame that produced `levels`:

      * rows with empty support (a hold frame) start converged: they count
        toward the quorum from iteration zero, and a bucket of clean rows
        pays exactly the `min_iters` floor (the floor sits in the exit
        test);
      * rows with support iterate under a witness computed on the support
        (support_agreement), so the perturbed region's settling gates the
        exit.

    threshold 0.0, or no support, is exactly glom_forward_tiered: no row
    converges and max_iters updates run, bit for bit the full warm path.
    """
    if threshold == 0.0 or support_mask is None:
        return glom_forward_tiered(
            params, img, cfg, max_iters=max_iters, threshold=threshold,
            min_iters=min_iters, quorum=quorum, levels=levels, valid_mask=valid_mask,
            compute_dtype=compute_dtype, use_pallas=use_pallas,
        )
    T = max_iters if max_iters is not None else cfg.default_iters
    _validate_auto_args(T, min_iters, threshold)
    step, lv = _build_update_step(params, img, cfg, levels, compute_dtype, use_pallas)
    b = lv.shape[0]
    dev = lv.device
    valid = (torch.ones(b, dtype=torch.bool, device=dev) if valid_mask is None
             else valid_mask.to(device=dev, dtype=torch.bool))
    support = support_mask.to(device=dev, dtype=torch.bool)
    row_dirty = support.any(dim=1)  # [b]
    final, iters_run, conv, row_iters = _tiered_loop(
        step, lv, lambda x: support_agreement(x, support), valid, T, threshold,
        min_iters, quorum,
        conv0=~row_dirty,  # empty support: converged before the first update
        row_iters0=torch.where(row_dirty, T, 0).to(torch.int32),
    )
    agreement = masked_level_agreement(final, valid_mask)
    return TieredAutoResult(final, iters_run, agreement, conv, row_iters)


# -- the ragged paged dispatch ------------------------------------------------


class RaggedResult(NamedTuple):
    """One ragged dispatch's outcome. `levels` is the flat [T, L, d]
    page-aligned state: row r's columns at [row_start[r], row_start[r] +
    n_patches[r]). Rows with n_patches 0 are unused slots."""

    levels: torch.Tensor  # [T, L, d]
    iters_run: int
    row_converged: torch.Tensor  # [R] bool
    row_iters: torch.Tensor  # [R] int32


def ragged_row_layout(n_patches: torch.Tensor, page_tokens: int) -> torch.Tensor:
    """Page-aligned row starts from the patch counts alone: [R+1] int32,
    starts[r] row r's first flat token, starts[R] the used-token total
    (serve/batcher.ragged_row_starts computes the same on the host)."""
    pages = (n_patches + page_tokens - 1) // page_tokens
    zero = torch.zeros(1, dtype=torch.int32, device=n_patches.device)
    return torch.cat([zero, torch.cumsum(pages, 0).to(torch.int32)]) * page_tokens


def _ragged_structure(n_patches: torch.Tensor, page_tokens: int, T: int):
    """(row_id [T], tok_off [T], tok_valid [T], starts [R+1]) from the
    page-aligned layout. Tokens past the last used page clamp to the final
    row and read invalid (their offset lands past its patch count)."""
    R = n_patches.shape[0]
    starts = ragged_row_layout(n_patches, page_tokens)
    t = torch.arange(T, dtype=torch.int32, device=n_patches.device)
    row_id = (t[:, None] >= starts[None, 1:]).sum(dim=1).clamp(max=R - 1)
    tok_off = t - starts[row_id]
    tok_valid = tok_off < n_patches[row_id]
    return row_id, tok_off, tok_valid, starts


def ragged_consensus_attention(
    levels: torch.Tensor,
    *,
    row_start: torch.Tensor,
    row_len: torch.Tensor,
    window: int,
    attend_self: bool = False,
) -> torch.Tensor:
    """Row-windowed consensus attention over a flat [T, L, d] state: token
    t attends over the `window` positions from its row's flat start, slots
    past the row's length hard-masked, the self slot soft-masked. row_start
    and row_len are per token ([T] int). q and v raw, k = l2norm(levels) in
    the levels' dtype, d^-1/2, scores and softmax in f32, the probabilities
    rounded to the levels' dtype, f32 sums."""
    T, _, d = levels.shape
    f32 = torch.float32
    k = l2norm(levels, dim=-1)
    w = torch.arange(window, dtype=torch.int32, device=levels.device)
    widx = row_start[:, None] + w[None, :]  # [T, W]
    wvalid = w[None, :] < row_len[:, None]
    widx_c = widx.clamp(0, T - 1).long()
    kw, vw = k[widx_c], levels[widx_c]  # [T, W, L, d]
    sim = torch.einsum("tld,twld->tlw", levels.to(f32), kw.to(f32)) * d ** -0.5
    if not attend_self:
        t = torch.arange(T, dtype=widx.dtype, device=levels.device)
        sim = sim.masked_fill((widx == t[:, None])[:, None, :], TOKEN_ATTEND_SELF_VALUE)
    sim = sim.masked_fill(~wvalid[:, None, :], max_neg_value(f32))
    attn = torch.softmax(sim, dim=-1).to(levels.dtype)
    out = torch.einsum("tlw,twld->tld", attn.to(f32), vw.to(f32))
    return out.to(levels.dtype)


def banded_ragged_consensus_attention(
    levels: torch.Tensor,
    *,
    row_start: torch.Tensor,
    row_len: torch.Tensor,
    window: int,
    page_tokens: int,
    attend_self: bool = False,
) -> torch.Tensor:
    """The page-granular form of ragged_consensus_attention: rows occupy
    whole pages, so the k/v band is gathered once per page (window /
    page_tokens pages, clamped to the last page) instead of once per
    token. Masks come from the same per-token predicates as the windowed
    route; same rounding points."""
    T, L, d = levels.shape
    pt = page_tokens
    if T % pt or window % pt:
        raise ValueError(
            f"banded consensus needs page-aligned shapes: T={T}, "
            f"window={window}, page_tokens={pt}"
        )
    f32 = torch.float32
    P, Wp = T // pt, window // pt
    q = levels.reshape(P, pt, L, d)
    k = l2norm(levels, dim=-1).reshape(P, pt, L, d)
    band_page0 = torch.div(row_start[::pt], pt, rounding_mode="floor")  # [P]
    wp = torch.arange(Wp, dtype=band_page0.dtype, device=levels.device)
    band = (band_page0[:, None] + wp[None, :]).clamp(0, P - 1).long()
    kb = k[band].reshape(P, window, L, d)
    vb = q[band].reshape(P, window, L, d)
    sim = torch.einsum("pqld,pwld->pqlw", q.to(f32), kb.to(f32)).reshape(T, L, window)
    sim = sim * d ** -0.5
    w = torch.arange(window, dtype=torch.int32, device=levels.device)
    widx = row_start[:, None] + w[None, :]
    wvalid = w[None, :] < row_len[:, None]
    if not attend_self:
        t = torch.arange(T, dtype=widx.dtype, device=levels.device)
        sim = sim.masked_fill((widx == t[:, None])[:, None, :], TOKEN_ATTEND_SELF_VALUE)
    sim = sim.masked_fill(~wvalid[:, None, :], max_neg_value(f32))
    attn = torch.softmax(sim, dim=-1).to(levels.dtype)
    out = torch.einsum("pqlw,pwld->pqld", attn.reshape(P, pt, L, window).to(f32), vb.to(f32))
    return out.reshape(T, L, d).to(levels.dtype)


def ragged_window_bytes(
    T: int, window: int, levels: int, dim: int, itemsize: int,
    page_tokens: int, attention: str = "windowed",
) -> int:
    """Duplicated k/v working-set bytes one consensus iteration builds
    beyond the flat [T, L, d] state: W column states per token (windowed)
    or per page (banded); glom_tpu prices the kernel route as the banded
    one, and so does the port (its plain version builds that band)."""
    per_pos = 2 * levels * dim * itemsize  # k + v, one column state
    if attention == "windowed":
        return T * window * per_pos
    if attention in ("banded", "banded-pallas"):
        return (T // page_tokens) * (window // page_tokens) * page_tokens * per_pos
    raise ValueError(
        f"attention {attention!r}: 'windowed', 'banded', or 'banded-pallas'"
    )


def ragged_row_agreement(
    levels: torch.Tensor, row_weight: torch.Tensor, row_id: torch.Tensor,
    n_patches: torch.Tensor,
) -> torch.Tensor:
    """Per-row [R, L] agreement of a flat [T, L, d] state: batch_agreement
    with each row's mean taken over its valid tokens only. row_weight is
    the [T, R] float one-hot of (row_id, tok_valid)."""
    x = levels.float()
    eps = 1e-8
    xhat = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
    denom = n_patches.float().clamp_min(1.0)
    mean = torch.einsum("tr,tld->rld", row_weight, xhat) / denom[:, None, None]
    mhat = mean / (torch.linalg.vector_norm(mean, dim=-1, keepdim=True) + eps)
    cos = (xhat * mhat[row_id]).sum(dim=-1)  # [T, L]
    return torch.einsum("tr,tl->rl", row_weight, cos) / denom[:, None]


def glom_forward_ragged(
    params,
    patches: torch.Tensor,
    cfg: GlomConfig,
    *,
    n_patches: torch.Tensor,
    page_tokens: int,
    route,
    max_iters: Optional[int] = None,
    threshold: float = 1e-3,
    min_iters: int = 1,
    quorum: float = 1.0,
    levels0: Optional[torch.Tensor] = None,
    pool: Optional[torch.Tensor] = None,
    page_idx: Optional[torch.Tensor] = None,
    compute_dtype=None,
    use_pallas: bool = False,
    ragged_attention: str = "windowed",
) -> RaggedResult:
    """The ragged paged forward: one dispatch over a flat page-aligned
    token axis.

    patches: [T, patch_dim] host-patchified rows packed page-aligned in row
    order (T = pages x page_tokens; the embed runs here). n_patches: [R]
    per-row patch counts (int tensor on the patches' device), 0 marking
    unused row slots. route: "auto" (per-row witness, quorum exit, budget
    max_iters) or an int (a fixed count). Warm state arrives one of two
    ways: levels0 [T, L, d] (the continuation form), or pool [N,
    page_tokens, L, d] with page_idx [T / page_tokens] int (the device page
    pool; -1 takes the cold init page), gathered here so warm columns never
    cross from the host. threshold 0 runs exactly max_iters updates, bit
    for bit the fixed route of the same budget.
    """
    if cfg.local_consensus_radius > 0:
        raise ValueError(
            "ragged dispatch requires local_consensus_radius == 0 (the "
            "row window has no per-resolution 2D grid to build a radius "
            "mask from)"
        )
    if pool is not None and levels0 is not None:
        raise ValueError("pass levels0 OR pool+page_idx, not both")
    if (pool is None) != (page_idx is None):
        raise ValueError("pool and page_idx come together")
    auto = route == "auto"
    if auto:
        T_budget = max_iters if max_iters is not None else cfg.default_iters
        _validate_auto_args(T_budget, min_iters, threshold)
    else:
        T_budget = int(route)
        if T_budget < 1:
            raise ValueError(f"route={route!r}: an int >= 1 or 'auto'")
    if ragged_attention not in ("windowed", "banded", "banded-pallas"):
        raise ValueError(
            f"ragged_attention={ragged_attention!r}: 'windowed', 'banded' "
            "or 'banded-pallas'"
        )
    ffw_fn = fused_grouped_ffw if use_pallas else grouped_ffw

    T = patches.shape[0]
    R = n_patches.shape[0]
    n_patches = n_patches.to(torch.int32)
    pt = page_tokens
    # The row window: full-resolution pages x page_tokens, the same width
    # in every ragged signature.
    window = min(T, -(-cfg.num_patches // pt) * pt)
    if compute_dtype is not None:
        params = map_params(lambda t: t.to(compute_dtype), params)
        patches = patches.to(compute_dtype)
        if exists(levels0):
            levels0 = levels0.to(compute_dtype)

    row_id, tok_off, tok_valid, starts = _ragged_structure(n_patches, pt, T)
    row_start_tok = starts[row_id]  # [T]
    row_len_tok = n_patches[row_id]  # [T]
    tokens = patches @ params.token_embed.w + params.token_embed.b  # [T, d]
    d = tokens.shape[-1]
    pos_flat = params.pos_emb[tok_off.clamp(0, params.pos_emb.shape[0] - 1).long()]
    pos = pos_flat[None, :, None, :]  # [1, T, 1, d]
    bottom = tokens[None, :, None, :]  # [1, T, 1, d]
    init = params.init_levels.to(tokens.dtype)  # [L, d]
    if pool is not None:
        # glom_tpu's order of casts: the pages to the tokens' dtype, then
        # the cold pages (-1) replaced by the init broadcast.
        page_idx = page_idx.to(device=patches.device, dtype=torch.long)
        pages = pool[page_idx.clamp(0, pool.shape[0] - 1)].to(tokens.dtype)
        pages = torch.where((page_idx >= 0)[:, None, None, None], pages, init)
        levels = pages.reshape(1, T, cfg.levels, d)
    elif exists(levels0):
        levels = levels0.to(tokens.dtype).reshape(1, T, cfg.levels, d).contiguous()
    else:
        levels = init.expand(1, T, cfg.levels, d).contiguous()
    divisor = contribution_divisor(cfg.levels, torch.float32, patches.device)

    band = dict(row_start=row_start_tok, row_len=row_len_tok, window=window,
                attend_self=cfg.consensus_self)
    if ragged_attention == "banded-pallas":
        def consensus_fn(lv):
            return banded_ragged_consensus(lv[0], page_tokens=pt, **band)[None]
    elif ragged_attention == "banded":
        def consensus_fn(lv):
            return banded_ragged_consensus_attention(lv[0], page_tokens=pt, **band)[None]
    else:
        def consensus_fn(lv):
            return ragged_consensus_attention(lv[0], **band)[None]

    def step(lv):
        return update_step(params, lv, bottom, pos, divisor,
                           consensus_fn=consensus_fn, ffw_fn=ffw_fn)

    if not auto:
        for _ in range(T_budget):
            levels = step(levels)
        return RaggedResult(
            levels[0], T_budget,
            torch.ones(R, dtype=torch.bool, device=patches.device),
            torch.full((R,), T_budget, dtype=torch.int32, device=patches.device),
        )

    rows = torch.arange(R, device=patches.device)
    row_weight = ((row_id[:, None] == rows[None, :]) & tok_valid[:, None]).float()  # [T, R]

    def row_agreement(lv):
        return ragged_row_agreement(lv[0], row_weight, row_id, n_patches)

    final, iters_run, conv, row_iters = _tiered_loop(
        step, levels, row_agreement, n_patches > 0, T_budget, threshold, min_iters, quorum
    )
    return RaggedResult(final[0], iters_run, conv, row_iters)
