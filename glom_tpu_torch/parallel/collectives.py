"""Every collective the port's parallel paths issue, one function each.

glom_tpu writes its collectives as `lax` calls inside `shard_map` and
gets their transposes from JAX. Here each is an explicit
`torch.distributed` call over the process group of one mesh axis (an
`Axis`). Where a gradient must cross ranks inside autograd, the call is a
`torch.autograd.Function` whose backward is the transpose:

  * the Megatron pair for hidden-axis TP: `copy_to_model` (identity
    forward, all-reduce backward) where a replicated tensor enters the
    rank's f/mp shard of the FFW, and `reduce_from_model` (all-reduce
    forward, identity backward) on its partial output;
  * the pair for levels TP (the group axis over 'model'):
    `split_to_model` (the rank's slice of a replicated tensor forward, an
    all-gather of the slices' gradients backward) where the carry enters
    the rank's groups, and `gather_from_model` (all-gather forward, the
    rank's slice backward) on the groups' outputs; both gathers count at
    the one site `tp_levels_all_gather`;
  * `all_to_all` (Ulysses), whose backward is the inverse all-to-all;
  * `halo_exchange` (halo SP), whose backward sends each halo's
    cotangent back to the neighbour that owns those rows.

The ring consensus moves its k / v blocks with `ring_shift` inside its
own Function (parallel/ring.py), whose backward rotates the blocks with
their dk / dv the same way.

A call given a `site` adds its wire bytes to the active counters
(telemetry/counters.py) under glom_tpu's site name. An axis of size 1
issues nothing: every function is then the identity.

Ranks that share one card run the gloo backend with CUDA tensors. Where
gloo takes no CUDA tensor for an op (`GLOO_CUDA_STAGED`), that op's
gloo call copies its tensors through pinned host memory and back; nothing
else does, it never happens under NCCL, it never depends on an
exception, and `STAGED` counts those calls by op. The kernels stay on the
card; only the transport moves. On an H100 with torch 2.11, gloo took CUDA
tensors (f32 and bf16) for all_reduce, reduce_scatter_tensor,
all_gather_into_tensor, all_to_all_single and broadcast, and refused them
for point-to-point (isend / irecv, "writev: Bad address"), so only "p2p"
is staged. Tensors travel in their own dtype: gloo refuses int16 for its
gathers and all-to-all, and takes bf16.

A torch.distributed call that raises (a timeout, a peer that left)
raises `CollectiveError` (resilience/retry.py), which no retry policy
retries: the group's transport is closed after a timeout.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from glom_tpu_torch.resilience.retry import CollectiveError
from glom_tpu_torch.telemetry import counters

# The ops gloo refuses for CUDA tensors (chip_smoke.py's dist phases print
# which were staged).
GLOO_CUDA_STAGED = frozenset({"p2p"})
STAGED: collections.Counter = collections.Counter()


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: its name, process group, size
    and this rank's index along it."""

    name: str
    group: Optional[object]
    size: int
    index: int


def mesh_axis(mesh, name: str) -> Axis:
    """The Axis `name` of a DeviceMesh."""
    size = mesh.mesh.shape[mesh.mesh_dim_names.index(name)]
    return Axis(name, mesh.get_group(name), size, mesh.get_local_rank(name))


def _staged(op: str, axis: Axis, tensors) -> bool:
    return (op in GLOO_CUDA_STAGED and any(t.is_cuda for t in tensors)
            and dist.get_backend(axis.group) == "gloo")


def transport(op: str, axis_name: str, fn, *args) -> None:
    """fn(*args), one torch.distributed call; its failure raises
    CollectiveError."""
    try:
        fn(*args)
    except CollectiveError:
        raise
    except Exception as e:  # noqa: BLE001 - every backend failure, one type
        raise CollectiveError(f"{op} over the {axis_name!r} group failed: {e}") from e


def _call(op: str, axis: Axis, fn, ins: Sequence[torch.Tensor], outs: Sequence[torch.Tensor]):
    """fn(*ins, *outs) over the axis's group, through pinned host copies
    where gloo takes no CUDA tensor for `op`."""
    if not _staged(op, axis, (*ins, *outs)):
        transport(op, axis.name, fn, *ins, *outs)
        return
    STAGED[op] += 1
    h_ins = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t) for t in ins]
    h_outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs]
    transport(op, axis.name, fn, *h_ins, *h_outs)
    for t, h in zip(outs, h_outs):
        t.copy_(h)


def _counted(site: Optional[str], axis: Axis, kind: str, nbytes: int, fn, x, *,
             collective: str, dim: int = 0):
    if site is None:
        return fn(x)
    return counters.timed_collective(site, axis.name, kind, nbytes, fn, x,
                                     collective=collective, dim=dim)


def _peer(axis: Axis, offset: int) -> int:
    return dist.get_global_rank(axis.group, (axis.index + offset) % axis.size)


# -- reductions and gathers ---------------------------------------------------


def all_reduce(x: torch.Tensor, axis: Axis, *, site: Optional[str] = None,
               collective: str = "psum", wire_bytes: Optional[int] = None) -> torch.Tensor:
    """The sum over the axis, as a new tensor. A site records
    `wire_bytes`, by default the ring all-reduce's."""
    if axis.size == 1:
        return x

    def run(x):
        out = x.detach().clone().contiguous()
        _call("all_reduce", axis, lambda t: dist.all_reduce(t, group=axis.group), [], [out])
        return out

    if wire_bytes is None:
        wire_bytes = counters.ring_allreduce_bytes(x, axis.size)
    return _counted(site, axis, "reduce", wire_bytes, run, x, collective=collective)


def all_reduce_tensors(tensors: Sequence[torch.Tensor], axis: Axis) -> list:
    """The sum over the axis of each tensor: one flat all-reduce for each
    dtype among them (not one a tensor); uncounted."""
    if axis.size == 1 or not tensors:
        return list(tensors)
    out = list(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _call("all_reduce", axis, lambda t: dist.all_reduce(t, group=axis.group), [], [flat])
        for i, v in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = v.view_as(tensors[i])
    return out


def reduce_scatter(x: torch.Tensor, axis: Axis, dim: int, *, site: Optional[str] = None,
                   wire_bytes: int = 0) -> torch.Tensor:
    """The sum over the axis, this rank keeping its `index`-th slice of
    `dim` (lax.psum_scatter with tiled=True). `wire_bytes` is what the
    site records."""
    if axis.size == 1:
        return x

    def run(x):
        xm = x.movedim(dim, 0).contiguous()
        out = xm.new_empty((xm.shape[0] // axis.size, *xm.shape[1:]))
        _call("reduce_scatter", axis,
              lambda i, o: dist.reduce_scatter_tensor(o, i, group=axis.group), [xm], [out])
        return out.movedim(0, dim)

    return _counted(site, axis, "reduce", wire_bytes, run, x, collective="psum_scatter", dim=dim)


def all_gather(x: torch.Tensor, axis: Axis, dim: int, *, site: Optional[str] = None) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in axis order
    (lax.all_gather with tiled=True)."""
    if axis.size == 1:
        return x

    def run(x):
        xm = x.movedim(dim, 0).contiguous()
        out = xm.new_empty((xm.shape[0] * axis.size, *xm.shape[1:]))
        _call("all_gather", axis,
              lambda i, o: dist.all_gather_into_tensor(o, i, group=axis.group), [xm], [out])
        return out.movedim(0, dim)

    return _counted(site, axis, "gather", counters.ring_all_gather_bytes(x, axis.size), run, x,
                    collective="all_gather", dim=dim)


def _all_to_all(x: torch.Tensor, axis: Axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    """lax.all_to_all(tiled=True): split `split_dim` into `size` chunks,
    send chunk j to rank j, concatenate what arrives along `concat_dim` in
    rank order."""
    send = torch.stack(x.chunk(axis.size, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    _call("all_to_all", axis,
          lambda i, o: dist.all_to_all_single(o, i, group=axis.group), [send], [recv])
    return torch.cat(recv.unbind(0), dim=concat_dim)


# -- point to point -------------------------------------------------------------


def _p2p(axis: Axis, sends, recvs) -> None:
    """Post every (tensor, peer offset) send and receive at once and wait."""
    ops = [dist.P2POp(dist.isend, t, _peer(axis, off), axis.group) for t, off in sends]
    ops += [dist.P2POp(dist.irecv, t, _peer(axis, off), axis.group) for t, off in recvs]

    def post_and_wait():
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    transport("p2p", axis.name, post_and_wait)


def _p2p_call(axis: Axis, sends, recvs) -> None:
    tensors = [t for t, _ in (*sends, *recvs)]
    if not _staged("p2p", axis, tensors):
        _p2p(axis, sends, recvs)
        return
    STAGED["p2p"] += 1
    h_sends = [(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t), o) for t, o in sends]
    h_recvs = [(torch.empty(t.shape, dtype=t.dtype, pin_memory=True), o) for t, o in recvs]
    _p2p(axis, h_sends, h_recvs)
    for (t, _), (h, _) in zip(recvs, h_recvs):
        t.copy_(h)


def ring_shift(tensors: Sequence[torch.Tensor], axis: Axis) -> list:
    """Rotate each tensor one step along the ring: send to rank p - 1,
    receive from rank p + 1 (lax.ppermute with perm (i, i - 1))."""
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    _p2p_call(axis, [(t, -1) for t in tensors], [(o, 1) for o in outs])
    return outs


def neighbor_exchange(up: torch.Tensor, down: torch.Tensor, axis: Axis):
    """Non-periodic neighbour exchange: send `up` to rank p - 1 and `down`
    to rank p + 1; return (what p - 1 sent down, what p + 1 sent up), zeros
    where there is no neighbour (the grid's edges)."""
    up, down = up.contiguous(), down.contiguous()
    from_up, from_down = torch.zeros_like(down), torch.zeros_like(up)
    sends, recvs = [], []
    if axis.index > 0:
        sends.append((up, -1))
        recvs.append((from_up, -1))
    if axis.index < axis.size - 1:
        sends.append((down, 1))
        recvs.append((from_down, 1))
    _p2p_call(axis, sends, recvs)
    return from_up, from_down


# -- differentiable collectives ----------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """Megatron's f over several tensors: identity forward, one all-reduce
    over 'model' of their gradients backward."""

    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=dt, device=dev) if g is None else g
              for g, (s, dt, dev) in zip(gs, ctx.meta)]
        return (None, *all_reduce_tensors(gs, ctx.axis))


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce over 'model' forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis, site):
        return all_reduce(x, axis, site=site)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


LEVELS_SITE = "tp_levels_all_gather"


class _SplitToModel(torch.autograd.Function):
    """Levels TP's entry: forward, this rank's contiguous 1/size of a
    tensor that is the same on every model rank (dim 0); backward, the
    slices' gradients all-gathered over 'model', so every rank holds the
    whole gradient of the replicated tensor. The backward's gather is
    recorded under the counters that were active at the forward (autograd
    may run the backward on another thread)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        ctx.counters = counters.active()
        size = x.shape[0] // axis.size
        return x.narrow(0, axis.index * size, size)

    @staticmethod
    def backward(ctx, g):
        with counters.recording_all(ctx.counters):
            return all_gather(g.contiguous(), ctx.axis, 0, site=LEVELS_SITE), None


class _GatherFromModel(torch.autograd.Function):
    """Levels TP's exit: forward, every rank's slice all-gathered on dim 0;
    backward, this rank's slice of the gradient (the same on every model
    rank: what follows the gather is replicated)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_gather(x, axis, 0, site=LEVELS_SITE)

    @staticmethod
    def backward(ctx, g):
        size = g.shape[0] // ctx.axis.size
        return g.narrow(0, ctx.axis.index * size, size).contiguous(), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim, concat_dim)
        return _all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return _all_to_all(g.contiguous(), axis, concat_dim, split_dim), None, None, None


class _HaloExchange(torch.autograd.Function):
    """[b, n_loc, ...] -> [b, h + n_loc + h, ...]: the h rows above from
    rank p - 1 and the h rows below from rank p + 1 around this rank's
    rows (zeros past the grid's edges). The backward sends each halo's
    cotangent back to its owner, which adds it to the rows it sent."""

    @staticmethod
    def forward(ctx, t, axis, h):
        ctx.args = (axis, h)
        top, bot = neighbor_exchange(t[:, :h], t[:, -h:], axis)
        return torch.cat([top, t, bot], dim=1)

    @staticmethod
    def backward(ctx, g):
        axis, h = ctx.args
        g_top, g_bot = g[:, :h], g[:, -h:]
        d_first, d_last = neighbor_exchange(g_top, g_bot, axis)
        dt = g[:, h:-h].clone()
        dt[:, :h] += d_first
        dt[:, -h:] += d_last
        return dt, None, None


def copy_to_model(xs: Sequence[torch.Tensor], axis: Axis) -> list:
    """Megatron's f on each of `xs` (replicated tensors entering this
    rank's hidden shard): the same values, whose gradients are summed over
    'model' in one all-reduce."""
    return list(xs) if axis.size == 1 else list(_CopyToModel.apply(axis, *xs))


def reduce_from_model(x: torch.Tensor, axis: Axis, *, site: Optional[str] = None) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceFromModel.apply(x, axis, site)


def split_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Levels TP: this rank's groups of a replicated [G, ...] tensor, whose
    gradient is all-gathered over 'model' (see _SplitToModel)."""
    return x if axis.size == 1 else _SplitToModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Levels TP: every rank's [G/size, ...] groups gathered into [G, ...]
    (see _GatherFromModel)."""
    return x if axis.size == 1 else _GatherFromModel.apply(x, axis)


def all_to_all(x: torch.Tensor, axis: Axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Differentiable lax.all_to_all(tiled=True) over the axis."""
    return x if axis.size == 1 else _AllToAll.apply(x, axis, split_dim, concat_dim)


def halo_exchange(t: torch.Tensor, axis: Axis, h: int) -> torch.Tensor:
    """Differentiable halo exchange of h rows (see _HaloExchange)."""
    if axis.size == 1 or h == 0:
        raise ValueError("a halo exchange needs a sharded axis and h > 0")
    return _HaloExchange.apply(t, axis, h)
