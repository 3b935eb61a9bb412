"""The sharded serving forward: bucket batches over a (data, seq) rank group,
with the early exit's collectives inside the loop.

Counterpart of `glom_tpu/parallel/serve_mesh.py`. glom_tpu's engine runs
one manual `shard_map` over ('data', 'seq') from one controller. The port
has one process a rank: an engine's group of `mesh_data x mesh_seq` ranks
is a `ServeMesh`, the leader's `InferenceEngine` sends each dispatch to the
follower ranks (serve/mesh_follower.py), and every rank runs the per-rank
body `make_serve_forward` builds on its band: batch rows split over
'data', the patch axis over 'seq'. The loop body is the reference-layout
`update_step` of serve/early_exit's routes (K1 through `fused_grouped_ffw`
with `use_pallas`, dense consensus whole at seq = 1, the ring / Ulysses /
halo body of `manual.shard_consensus_fn` at seq > 1).

The `iters="auto"` loop: glom_tpu's `lax.while_loop` becomes a Python loop
whose exit test is itself an all-reduce over 'data' ("quorum_exit_psum")
read on the host, so every rank reads the same count and takes the same
trips; the quorum target is one all-reduce outside the loop
("quorum_valid_psum"). At seq = 1 the witness is `batch_agreement` (no
collective: a data rank runs the single-device program on its rows); at
seq > 1 it is decomposed into partial sums and two all-reduces over 'seq'
a trip ("witness_mean_psum", "witness_cos_psum").

Every wire-moving site records its bytes through
`telemetry/counters.timed_collective` under glom_tpu's site names and
formulas. The pricing is glom_tpu's trace-time convention: a loop site is
priced at the BUDGET, once under `counters.scaled(T)` before the loop,
and the loop's executions record nothing (`counters.paused`), whatever
trip the exit takes.

The paged warm variant takes this rank's shard of the pool (the page axis
split over 'data') and the replicated page map, and assembles its rows'
levels0 with one of two exchanges (`ServeConfig.page_gather`): "pool"
all-gathers every shard ("page_pool_all_gather"), "needed" sends only the
referenced pages by a reduce-scatter of integer words
("page_needed_psum_scatter": exactly one rank owns a page and the others
send zeros, so the integer sum is the owner's bits, -0.0 included; glom_tpu
sends bf16 as int16, which gloo refuses for its reductions, so the port
sends a pair of bf16 as one int32 word, the same bytes); "auto" takes
whichever moves fewer bytes at the signature's shapes.

glom_tpu's `serve_shardings` (the NamedSharding of each argument) has no
counterpart: there are no global arrays here, each rank holds its band.
"""

from __future__ import annotations

import datetime
import time
from functools import partial
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from glom_tpu_torch.models.core import contribution_divisor, map_params, update_step
from glom_tpu_torch.ops.consensus import build_local_mask, consensus_attention
from glom_tpu_torch.ops.patch import image_to_tokens
from glom_tpu_torch.parallel.collectives import Axis, all_gather, all_reduce, transport
from glom_tpu_torch.parallel.manual import RankAxes, shard_consensus_fn
from glom_tpu_torch.telemetry import counters as tele_counters
from glom_tpu_torch.utils.config import GlomConfig, ServeConfig

DATA_AXIS = "data"
SEQ_AXIS = "seq"
PAGE_GATHERS = ("auto", "pool", "needed")
# How long a rank waits in one of an engine's collectives: a rank that
# fails inside a body that has collectives (seq > 1, or the auto route's
# exit tests) leaves its peers waiting until this runs out, and the group
# is then broken (serve/mesh_follower.py; the status all-reduces catch
# every other failure).
GROUP_TIMEOUT_S = 300


class ServeMesh:
    """One engine's rank group, as this rank sees it.

    `ranks`: the global ranks of the group, row-major over (data, seq);
    `leader`: the global rank that holds the engine (ranks[0], or a rank
    outside the group that dispatches without a band); `group`: the
    engine's own process group over the leader and the ranks (headers,
    payloads, statuses); `axes`: this rank's (data, seq, model) axes, each
    over its own group, or None on a rank outside the group; `out_group`:
    the pair (leader, ranks[0]) when the leader is outside the group;
    `gate`: see MeshChannel.header."""

    def __init__(self, ranks: Sequence[int], data: int, seq: int, leader: int, group,
                 axes: Optional[RankAxes], out_group=None):
        self.ranks = tuple(ranks)
        self.shape = {DATA_AXIS: data, SEQ_AXIS: seq}
        self.leader = leader
        self.group = group
        self.axes = axes
        # A leader outside the group receives the outputs from ranks[0]
        # over this pair's group.
        self.out_group = out_group
        # An elastic fleet's engine: (store, prefix) its op headers wait on
        # (serve/mesh_follower.MeshChannel.header); None: headers ungated.
        self.gate = None

    @property
    def is_member(self) -> bool:
        return self.axes is not None

    @property
    def leader_in_group(self) -> bool:
        """Whether the leader computes a band (else it only dispatches)."""
        return self.leader in self.ranks

    def __repr__(self) -> str:
        return (f"ServeMesh(ranks={list(self.ranks)}, data={self.shape[DATA_AXIS]}, "
                f"seq={self.shape[SEQ_AXIS]}, leader={self.leader})")


def _group(ranks: List[int], timeout: datetime.timedelta):
    return dist.new_group(ranks=sorted(ranks), timeout=timeout)


def build_serve_mesh(ranks: Sequence[int], data: int, seq: int,
                     leader: Optional[int] = None) -> ServeMesh:
    """The ServeMesh of `ranks` (data x seq of them, row-major). Makes the
    group's process groups, so EVERY rank of the world calls it, with the
    same arguments and in the same order as every other rank."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.mesh.initialize_multihost(...) or launch "
            "under torch.distributed.run"
        )
    ranks = [int(r) for r in ranks]
    if len(ranks) != data * seq:
        raise ValueError(f"a {data} x {seq} serve mesh needs {data * seq} ranks, got {ranks}")
    world = dist.get_world_size()
    if max(ranks) >= world:
        raise ValueError(f"ranks {ranks} outside the world of {world}")
    leader = ranks[0] if leader is None else int(leader)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    me = dist.get_rank()
    group = _group(sorted(set(ranks) | {leader}), timeout)
    grid = [ranks[d * seq:(d + 1) * seq] for d in range(data)]
    axes = {DATA_AXIS: None, SEQ_AXIS: None}
    # One group a line of each axis, made in the same order on every rank.
    for name, lines in ((DATA_AXIS, [[grid[d][s] for d in range(data)] for s in range(seq)]),
                        (SEQ_AXIS, grid)):
        for line in lines:
            g = _group(line, timeout) if len(line) > 1 else None
            if me in line:
                axes[name] = Axis(name, g, len(line), line.index(me))
    out_group = _group([leader, ranks[0]], timeout) if leader not in ranks else None
    rank_axes = None
    if me in ranks:
        rank_axes = RankAxes(axes[DATA_AXIS], axes[SEQ_AXIS], Axis("model", None, 1, 0))
    return ServeMesh(ranks, data, seq, leader, group, rank_axes, out_group)


def make_serve_mesh(scfg: ServeConfig, ranks: Optional[Sequence[int]] = None,
                    leader: Optional[int] = None) -> Optional[ServeMesh]:
    """The engine's mesh, or None for the single-device route: the first
    mesh_data x mesh_seq ranks of the world (or `ranks`), axes named as the
    training mesh's ('model' stays 1). Every rank of the world calls it
    (it makes process groups)."""
    if scfg.mesh_data == 1 and scfg.mesh_seq == 1:
        return None
    per = scfg.mesh_data * scfg.mesh_seq
    if ranks is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world < per:
            raise ValueError(f"a {scfg.mesh_data} x {scfg.mesh_seq} serve mesh needs {per} "
                             f"ranks, the world has {world}")
        ranks = range(per)
    return build_serve_mesh(ranks, scfg.mesh_data, scfg.mesh_seq, leader)


def _band(t: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    size = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * size, size)


def _psum_wire(x: torch.Tensor, axis: Axis, site: str = "serve_psum") -> torch.Tensor:
    """A counted all-reduce: every wire-moving sum of this module goes
    through it, so the counters see each site (recorded at an axis of one
    too, as glom_tpu's trace records it)."""
    return tele_counters.timed_collective(
        site, axis.name, "reduce", tele_counters.ring_allreduce_bytes(x, axis.size),
        lambda v: all_reduce(v, axis), x, collective="psum",
    )


def _gather_pages_wire(pool_loc: torch.Tensor, data: Axis) -> torch.Tensor:
    """The whole-pool page gather: every rank's pool shard, all-gathered
    over 'data' ((k-1) x the shard's bytes: the provisioning bound)."""
    return tele_counters.timed_collective(
        "page_pool_all_gather", DATA_AXIS, "gather",
        tele_counters.ring_all_gather_bytes(pool_loc, data.size),
        lambda p: all_gather(p, data, 0), pool_loc, collective="all_gather", dim=0,
    )


def _words(t: torch.Tensor) -> torch.Tensor:
    """A view of `t`'s bits as int32 words (a bf16 pair a word)."""
    return t.view(torch.int32)


def _scatter_needed_pages_wire(pool_loc: torch.Tensor, page_idx: torch.Tensor, data: Axis,
                               b_loc: int) -> torch.Tensor:
    """The needed-pages exchange: each rank contributes the pages it owns of
    every destination rank's referenced list, and one reduce-scatter over
    'data' hands each rank its own rows' pages (the payload is k x rows x
    pages a row of pages, whatever the pool's size). Unowned slots (page
    -1) arrive as zeros; the caller's cold-init select replaces them.

    page_idx: [k * b_loc, pages_per_row] int (every rank's). Returns
    [b_loc, pages_per_row, page_tokens, L, d]."""
    k = data.size
    pps = pool_loc.shape[0]
    ppr = page_idx.shape[1]
    flat = page_idx.reshape(k, b_loc * ppr).long()
    owner = torch.where(flat >= 0, flat // pps, -1)
    local = (flat - data.index * pps).clamp(0, pps - 1)
    mine = owner == data.index
    bits = _words(pool_loc)
    contrib = torch.where(mine[..., None, None, None], bits[local],
                          torch.zeros((), dtype=bits.dtype, device=bits.device))
    got = tele_counters.timed_collective(
        "page_needed_psum_scatter", DATA_AXIS, "reduce_scatter",
        tele_counters.ring_reduce_scatter_bytes(contrib, k),
        lambda c: _reduce_scatter_sum(c, data), contrib, collective="psum_scatter", dim=0,
    )
    return got.reshape(b_loc, ppr, *bits.shape[1:]).view(pool_loc.dtype)


def _reduce_scatter_sum(x: torch.Tensor, data: Axis) -> torch.Tensor:
    """The sum over 'data' of x [k, ...], this rank keeping its slice
    [1, ...] (lax.psum_scatter, tiled), uncounted."""
    if data.size == 1:
        return x
    out = x.new_empty((1, *x.shape[1:]))
    transport("reduce_scatter", data.name,
              lambda o, i: dist.reduce_scatter_tensor(o, i, group=data.group), out,
              x.contiguous())
    return out


def _sharded_row_agreement(levels: torch.Tensor, n: int, seq: Axis) -> torch.Tensor:
    """Per-row [b_loc, L] agreement over the FULL patch axis from a
    seq-sharded [b_loc, n_loc, L, d] state: early_exit.batch_agreement
    decomposed into local partial sums and two all-reduces over 'seq'."""
    x = levels.float()
    eps = 1e-8
    xhat = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
    part = xhat.sum(dim=1, keepdim=True)  # [b_loc, 1, L, d]
    mean = _psum_wire(part, seq, site="witness_mean_psum") / n
    mhat = mean / (torch.linalg.vector_norm(mean, dim=-1, keepdim=True) + eps)
    cos = (xhat * mhat).sum(dim=-1).sum(dim=1)  # [b_loc, L]
    return _psum_wire(cos, seq, site="witness_cos_psum") / n


def _price(site: str, axis: Axis, shape, dtype) -> None:
    """Record one all-reduce site of `shape` without moving anything: the
    loop sites' budget price (see the module docstring)."""
    x = torch.empty(shape, dtype=dtype, device="meta")
    tele_counters.timed_collective(
        site, axis.name, "reduce", tele_counters.ring_allreduce_bytes(x, axis.size),
        lambda v: v, x, collective="psum",
    )


class ExitReads:
    """The auto loop's per-trip exit test on this rank: how many it took
    and their host seconds (the all-reduce and the read together)."""

    def __init__(self):
        self.n = 0
        self.seconds = 0.0


def make_serve_forward(
    axes: RankAxes,
    cfg: GlomConfig,
    *,
    route,
    max_iters: Optional[int] = None,
    threshold: float = 1e-3,
    min_iters: int = 1,
    quorum: float = 1.0,
    compute_dtype=None,
    use_pallas: bool = False,
    sp_strategy: str = "auto",
    warm: bool = False,
    page_tokens: Optional[int] = None,
    page_gather: str = "auto",
    exit_reads: Optional[ExitReads] = None,
):
    """The per-rank bucket forward of one engine signature.

    route: "auto" (tiered early exit, budget `max_iters`) or an int (a
    fixed count). Returns fn(params, img [b_loc, c, H, W], mask [b_loc]
    bool) -- plus levels0 [b_loc, n_loc, L, d] when warm, or pool_loc
    [pages / data, page_tokens, L, d] and page_idx [b, pages_per_row] (every
    rank's rows; -1 cold) with page_tokens -- -> (levels [b_loc, n_loc, L,
    d], iters_run int, row_converged [b_loc] bool, row_iters [b_loc]
    int32): the single-device tiered route's contract, on this rank's band.
    """
    from glom_tpu_torch.serve.early_exit import (
        _validate_auto_args,
        batch_agreement,
        quorum_need,
        row_agreement_delta,
    )

    seq_axis, data_axis = axes.seq, axes.data
    seq = seq_axis.size
    auto = route == "auto"
    if auto:
        T = max_iters if max_iters is not None else cfg.default_iters
        _validate_auto_args(T, min_iters, threshold)
    else:
        T = int(route)
        if T < 1:
            raise ValueError(f"route={route!r}: an int >= 1 or 'auto'")
    if cfg.num_patches % seq != 0:
        raise ValueError(f"patches {cfg.num_patches} not divisible by seq axis {seq}")
    if warm and page_tokens is not None:
        raise ValueError("warm (host levels0) and page_tokens are exclusive")
    if page_gather not in PAGE_GATHERS:
        raise ValueError(f"page_gather {page_gather!r}: 'auto', 'pool', or 'needed'")

    if use_pallas:
        from glom_tpu_torch.kernels.grouped_mlp import fused_grouped_ffw as ffw_fn
    else:
        from glom_tpu_torch.ops.ffw import grouped_ffw as ffw_fn

    consensus_shard = shard_consensus_fn(cfg, seq_axis, sp_strategy)
    n = cfg.num_patches
    n_loc = n // seq
    reads = exit_reads if exit_reads is not None else ExitReads()

    def body_fn(gp, img, mask, levels0):
        # The prologue of early_exit._build_update_step, in its order:
        # cast once, tokenize, then keep this rank's patch band.
        nonlocal consensus_shard
        if compute_dtype is not None:
            gp = map_params(lambda t: t.to(compute_dtype), gp)
            img = img.to(compute_dtype)
            if levels0 is not None:
                levels0 = levels0.to(compute_dtype)
        if consensus_shard is None:
            # seq == 1: the dense single-device consensus.
            local = build_local_mask(cfg.num_patches_side, cfg.local_consensus_radius)
            consensus_shard = partial(
                consensus_attention, attend_self=cfg.consensus_self,
                local_mask=None if local is None else torch.as_tensor(local, device=img.device),
            )
        tokens = _band(image_to_tokens(gp.token_embed, img, cfg.patch_size), seq_axis, 1)
        pos = _band(gp.pos_emb, seq_axis)[None, :, None, :]  # [1, n_loc, 1, d]
        bottom = tokens[:, :, None, :]  # [b_loc, n_loc, 1, d]
        b_loc, d = tokens.shape[0], tokens.shape[-1]
        if levels0 is None:
            levels = gp.init_levels[None, None].expand(b_loc, n_loc, cfg.levels, d).to(tokens.dtype)
        else:
            levels = levels0
        divisor = contribution_divisor(cfg.levels, torch.float32, img.device)

        def step(lv):
            return update_step(gp, lv, bottom, pos, divisor, consensus_fn=consensus_shard,
                               ffw_fn=ffw_fn)

        def row_agreement(lv):
            return batch_agreement(lv) if seq == 1 else _sharded_row_agreement(lv, n, seq_axis)

        valid = mask.to(dtype=torch.bool)
        if not auto:
            # Fixed route: every row "converged" by fiat.
            for _ in range(T):
                levels = step(levels)
            return (levels, T, torch.ones(b_loc, dtype=torch.bool, device=img.device),
                    torch.full((b_loc,), T, dtype=torch.int32, device=img.device))

        # The quorum target over ALL valid rows: one hop over 'data' outside
        # the loop.
        n_valid = _psum_wire(valid.float().sum(), data_axis, site="quorum_valid_psum")
        need = int(quorum_need(quorum, n_valid))
        prev = row_agreement(levels)
        # The loop's sites, priced at the budget; their executions record
        # nothing.
        with tele_counters.scaled(T):
            if seq > 1:
                _price("witness_mean_psum", seq_axis, (b_loc, 1, cfg.levels, d), torch.float32)
                _price("witness_cos_psum", seq_axis, (b_loc, cfg.levels), torch.float32)
            _price("quorum_exit_psum", data_axis, (), torch.int32)
        conv = torch.zeros(b_loc, dtype=torch.bool, device=img.device)
        row_iters = torch.full((b_loc,), T, dtype=torch.int32, device=img.device)
        i = 0
        with tele_counters.paused():
            while i < T:
                new = step(levels)
                agree = row_agreement(new)
                delta = row_agreement_delta(agree, prev)
                newly = (delta < threshold) & (i + 1 >= min_iters)
                row_iters = torch.where(newly & ~conv, i + 1, row_iters)
                conv = conv | newly
                levels, prev, i = new, agree, i + 1
                if i < T and i >= min_iters:
                    # The exit test: the converged count over 'data', read on
                    # every rank, so every rank takes the same trips.
                    t0 = time.perf_counter()
                    n_conv = _psum_wire((conv & valid).sum().to(torch.int32), data_axis,
                                        site="quorum_exit_psum")
                    stop = int(n_conv) >= need
                    reads.n += 1
                    reads.seconds += time.perf_counter() - t0
                    if stop:
                        break
        row_iters = torch.where(conv, row_iters, i).to(torch.int32)
        return levels, i, conv, row_iters

    if page_tokens is None:
        if warm:
            return body_fn
        return lambda gp, img, mask: body_fn(gp, img, mask, None)

    if n % page_tokens != 0:
        raise ValueError(f"page_tokens {page_tokens} does not divide patches {n}")
    pt = page_tokens

    def paged_body(gp, img, mask, pool_loc, page_idx):
        # The rank's rows' levels0 from the sharded pool: the whole-pool
        # gather or the needed-pages exchange ("auto": whichever moves
        # fewer bytes at this signature's shapes).
        b_loc = img.shape[0]
        dp = data_axis.size
        mode = page_gather
        if mode == "auto":
            page_bytes = pt * cfg.levels * cfg.dim * pool_loc.element_size()
            whole = (dp - 1) * pool_loc.shape[0] * page_bytes
            needed = (dp - 1) * b_loc * page_idx.shape[1] * page_bytes
            mode = "needed" if needed < whole else "pool"
        my_idx = _band(page_idx, data_axis)  # [b_loc, pages_per_row]
        if mode == "needed":
            pages = _scatter_needed_pages_wire(pool_loc, page_idx, data_axis, b_loc)
        else:
            full = _gather_pages_wire(pool_loc, data_axis)
            pages = full[my_idx.clamp(0, full.shape[0] - 1).long()]
        init = gp.init_levels.to(pool_loc.dtype)
        pages = torch.where((my_idx >= 0)[..., None, None, None], pages, init)
        lv = pages.reshape(b_loc, n, cfg.levels, cfg.dim)
        return body_fn(gp, img, mask, _band(lv, seq_axis, 1))

    return paged_body
