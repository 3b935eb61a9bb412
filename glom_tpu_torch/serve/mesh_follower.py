"""The ranks of a sharded engine: the leader's channel and the follower loop.

glom_tpu serves a mesh from one controller: its engine's forward is one
`shard_map` over every device. The port has one process a rank, so an
`InferenceEngine(mesh=)` over a `ServeMesh` (parallel/serve_mesh.py) is a
**leader**, and the engine's other ranks are **followers** that run
`run_follower` until the leader stops them. Every op goes over the
engine's own process group (leader and ranks), in this order:

  1. a fixed int64[HEADER_LEN] header, broadcast by the leader: the op
     (`warmup`, `dispatch`, `write_back`, `release`, `stop`), the bucket,
     the route (auto or fixed, and the budget), the warm kind (cold, host
     `levels0`, paged), pages per row, n_valid (the mask is `arange(b) <
     n_valid`), a write-back's page count and in-place flag, and whether
     the dispatch counts its wire bytes;
  2. the payload, broadcast: the image (not on `warmup`), then `levels0`
     or `page_idx`; a `write_back` sends the page ids and the pages;
  3. a status all-reduce (MAX of three flags: failed, a kernel fault, a
     broken collective): a follower's fault hook fires before it;
  4. the body, in steps, each followed by a status all-reduce: every
     compute rank runs the same `MeshWorker`, first `compute` (the
     per-rank forward of `serve_mesh.make_serve_forward`), then `gather`
     (`levels` all-gathered over 'seq' and 'data', `row_converged` /
     `row_iters` over 'data'); a `write_back` applies the pages it owns;
  5. a leader outside the group then receives the outputs from the
     group's first rank.

After any status with a flag set, every rank skips the rest of the op, and
the leader raises: `KernelError` for a kernel fault on any rank
(nonretryable, resilience/retry.NONRETRYABLE_DEFAULT), else its own error,
else `FollowerError`, which the engine's retry policy retries by sending
the header again. A rank that fails in `compute` on the fixed route at
seq 1 fails the op cleanly: that step issues no collective, so every rank
reaches the status. Where `compute` has collectives (the ring / Ulysses /
halo consensus at seq > 1, the auto route's exit tests), a rank that fails
there leaves its peers in a collective until the group's timeout
(serve_mesh.GROUP_TIMEOUT_S); the collective then raises `CollectiveError`,
which sets the broken flag, or fails the status itself. A broken group is
never used again: the leader raises `CollectiveError` (nonretryable) for
that op and every later one, and the followers' loops raise it.

Ops on one engine are serialized by the leader's channel lock, so a
batcher thread and a write-back never interleave their collectives. At
start the leader sends the configs and the parameters, so every follower
serves the leader's model.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from glom_tpu_torch.kernels._build import KernelError
from glom_tpu_torch.models.core import GlomParams, param_leaves
from glom_tpu_torch.ops.ffw import GroupedFFWParams
from glom_tpu_torch.ops.patch import LinearParams
from glom_tpu_torch.parallel.collectives import all_gather, transport
from glom_tpu_torch.parallel.serve_mesh import ExitReads, make_serve_forward
from glom_tpu_torch.resilience.retry import CollectiveError
from glom_tpu_torch.serve.paged_columns import resolve_page_tokens
from glom_tpu_torch.telemetry import counters as tele_counters
from glom_tpu_torch.utils.helpers import resolve_dtype

OPS = ("stop", "warmup", "dispatch", "write_back", "release")
OP = {name: i for i, name in enumerate(OPS)}
WARM_KINDS = (False, True, "paged")
HEADER_LEN = 10
# header slots
H_OP, H_BUCKET, H_AUTO, H_BUDGET, H_WARM, H_PPR, H_NVALID, H_PAGES, H_INPLACE, H_COUNT = range(10)
# A dispatch's body steps (MeshWorker.steps: compute, gather).
DISPATCH_STEPS = 2
# status flags (slots of the status all-reduce)
FAILED, KERNEL_FAULT, BROKEN = range(3)
COUNT_KEYS = ("comm_measured_reduce_bytes_per_step", "comm_measured_gather_bytes_per_step",
              "comm_measured_bytes_per_step", "comm_measured_collective_count")


class FollowerError(RuntimeError):
    """A rank of a sharded engine failed an op (a transient failure: the
    retry policy sends the op again)."""


def _status_flags(exc: Optional[BaseException]) -> list:
    """This rank's status flags for an op step that raised `exc` (None: ok)."""
    flags = [0, 0, 0]
    if exc is not None:
        flags[FAILED] = 1
        flags[KERNEL_FAULT] = int(isinstance(exc, KernelError))
        flags[BROKEN] = int(isinstance(exc, CollectiveError))
    return flags


def _wire_dtype(t: torch.Tensor) -> torch.Tensor:
    """bool travels as uint8 (gloo's collectives take no bool)."""
    return t.to(torch.uint8) if t.dtype == torch.bool else t


class MeshChannel:
    """One engine's op channel on this rank: header, payloads and statuses
    over the ServeMesh's group, rooted at the leader."""

    def __init__(self, mesh, device):
        self.mesh = mesh
        self.device = torch.device(device)
        # Headers and statuses stay in host memory where the group's backend
        # takes it (gloo), so reading them costs no device synchronize.
        self.host = (torch.device("cpu") if dist.get_backend(mesh.group) == "gloo"
                     else self.device)
        self.lock = threading.Lock()
        # Bytes this rank moved through the channel and the gathers, by kind.
        self.wire = {"header": 0, "payload": 0, "status": 0, "gather": 0, "outputs": 0}

    def bcast(self, t: torch.Tensor, src: Optional[int] = None, kind: str = "payload",
              group=None):
        t = t.contiguous()
        transport("broadcast", "engine", lambda: dist.broadcast(
            t, src=self.mesh.leader if src is None else src,
            group=self.mesh.group if group is None else group))
        self.wire[kind] += t.nelement() * t.element_size()
        return t

    def header(self, values=None) -> list:
        h = torch.zeros(HEADER_LEN, dtype=torch.int64, device=self.host)
        if values is not None:
            h.copy_(torch.as_tensor(values, dtype=torch.int64))
        return self.bcast(h, kind="header").tolist()

    def status(self, exc: Optional[BaseException] = None) -> list:
        """Every rank's flags for one step, MAX-reduced over the group;
        `exc` is what this rank's step raised, or None."""
        t = torch.tensor(_status_flags(exc), dtype=torch.int32, device=self.host)
        transport("status all_reduce", "engine",
                  lambda: dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.group))
        self.wire["status"] += t.nelement() * t.element_size()
        return t.tolist()


class PoolShard:
    """A follower's shard of the engine's page pool: pages [index x pps,
    (index + 1) x pps) of the pool, for its data index (replicated over
    'seq'). Writes keep the single-device rules: in place when the leader
    says so, else copy-on-write."""

    def __init__(self, pps: int, page_tokens: int, levels: int, dim: int, dtype, device,
                 data_index: int):
        self.lo = data_index * pps
        self.buffer = torch.zeros((pps, page_tokens, levels, dim), dtype=dtype, device=device)

    def acquire_read(self) -> torch.Tensor:
        return self.buffer

    def release_read(self) -> None:
        pass

    def apply(self, ids: torch.Tensor, pages: torch.Tensor, in_place: bool) -> None:
        self.buffer = apply_owned(self.buffer, self.lo, ids, pages, in_place)

    def release(self) -> None:
        self.buffer = None


def apply_owned(buffer: torch.Tensor, lo: int, ids: torch.Tensor, pages: torch.Tensor,
                in_place: bool) -> torch.Tensor:
    """`buffer` with the pages of global ids in [lo, lo + len(buffer))
    written: in place, or into a copy (copy-on-write). Returns the buffer
    now current."""
    local = ids.long() - lo
    own = (local >= 0) & (local < buffer.shape[0])
    if not bool(own.any()):
        return buffer
    idx, rows = local[own], pages[own]
    if in_place:
        return buffer.index_copy_(0, idx, rows)
    return buffer.clone().index_copy_(0, idx, rows)


class MeshWorker:
    """A compute rank's side of an engine: the parameters, the pool shard and
    one per-rank forward a signature."""

    def __init__(self, cfg, scfg, mesh, params: GlomParams, device, *, pool=None,
                 wire: Optional[dict] = None):
        self.cfg, self.scfg, self.mesh = cfg, scfg, mesh
        self.axes = mesh.axes
        self.params = params
        self.device = torch.device(device)
        self.pool = pool
        self.compute_dtype = resolve_dtype(scfg.compute_dtype)
        self.wire = wire if wire is not None else {"gather": 0}
        self._fns = {}
        self.exit_reads = ExitReads()

    def _fn(self, auto: bool, budget: int, warm):
        key = (auto, budget, warm)
        if key not in self._fns:
            scfg = self.scfg
            self._fns[key] = make_serve_forward(
                self.axes, self.cfg, route="auto" if auto else budget,
                max_iters=budget if auto else None, threshold=scfg.exit_threshold,
                min_iters=min(scfg.min_iters, budget), quorum=scfg.exit_quorum,
                compute_dtype=self.compute_dtype, use_pallas=scfg.use_pallas, warm=warm is True,
                page_tokens=resolve_page_tokens(self.cfg, scfg) if warm == "paged" else None,
                page_gather=scfg.page_gather, exit_reads=self.exit_reads,
            )
        return self._fns[key]

    def steps(self, h: list, img: torch.Tensor, levels0=None, page_idx=None) -> list:
        """One bucket dispatch from the GLOBAL inputs as the op's two body
        steps: `compute` (this rank's band) and `gather` (the outputs
        gathered: levels [b, n, L, d], iters_run, row_converged [b],
        row_iters [b])."""
        return [lambda _: self.compute(h, img, levels0, page_idx), self.gather]

    def compute(self, h: list, img: torch.Tensor, levels0=None, page_idx=None):
        """The per-rank forward on this rank's band, synchronized (so a
        fault of its kernels shows before the step's status)."""
        data, seq = self.axes.data, self.axes.seq
        b = h[H_BUCKET]
        b_loc = b // data.size
        rows = slice(data.index * b_loc, (data.index + 1) * b_loc)
        warm = WARM_KINDS[h[H_WARM]]
        fn = self._fn(bool(h[H_AUTO]), h[H_BUDGET], warm)
        mask = (torch.arange(b, device=img.device) < h[H_NVALID])[rows]
        args = [self.params, img[rows], mask]
        pool = None
        if warm is True:
            n_loc = levels0.shape[1] // seq.size
            args.append(levels0[rows, seq.index * n_loc:(seq.index + 1) * n_loc])
        elif warm == "paged":
            pool = self.pool.acquire_read()
            args += [pool, page_idx]
        try:
            with torch.inference_mode():
                out = fn(*args)
            self._sync()
        finally:
            if pool is not None:
                self.pool.release_read()
        return out

    def gather(self, local):
        """The bands of `compute` gathered on every compute rank."""
        levels, iters_run, conv, row_iters = local
        data, seq = self.axes.data, self.axes.seq
        with torch.inference_mode():
            band = levels.nelement() * levels.element_size()
            levels = all_gather(all_gather(levels, seq, 1), data, 0)
            self.wire["gather"] += levels.nelement() * levels.element_size() - band
            conv = all_gather(_wire_dtype(conv), data, 0).to(torch.bool)
            row_iters = all_gather(row_iters, data, 0)
        self._sync()
        return levels, int(iters_run), conv, row_iters

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def send_params(channel: MeshChannel, cfg, scfg, params: GlomParams) -> None:
    """The leader's start: the configs, the leaf shapes and every leaf."""
    leaves = param_leaves(params)
    meta = [cfg, scfg, [(tuple(t.shape), t.dtype) for t in leaves]]
    dist.broadcast_object_list(meta, src=channel.mesh.leader, group=channel.mesh.group)
    for t in leaves:
        channel.bcast(t.detach().to(channel.device))


def recv_params(channel: MeshChannel):
    """A follower's start: (cfg, scfg, params)."""
    meta = [None] * 3
    dist.broadcast_object_list(meta, src=channel.mesh.leader, group=channel.mesh.group)
    cfg, scfg, shapes = meta
    leaves = [channel.bcast(torch.empty(s, dtype=dt, device=channel.device))
              for s, dt in shapes]
    params = GlomParams(LinearParams(*leaves[0:2]), leaves[2], leaves[3],
                        GroupedFFWParams(*leaves[4:8]), GroupedFFWParams(*leaves[8:12]))
    return cfg, scfg, params


class MeshLeader:
    """The leader's side of a sharded engine: sends each op and returns the
    outputs. `worker` is the leader's own MeshWorker when it is a rank of
    the group (None when it dispatches without a band). `broken` is why
    the group broke (None while it serves): a broken group takes no op."""

    def __init__(self, cfg, scfg, mesh, params: GlomParams, device):
        self.cfg, self.scfg, self.mesh = cfg, scfg, mesh
        self.device = torch.device(device)
        self.channel = MeshChannel(mesh, device)
        self.worker = (MeshWorker(cfg, scfg, mesh, params, device, wire=self.channel.wire)
                       if mesh.is_member else None)
        self.stopped = False
        self.broken: Optional[str] = None
        with self.channel.lock:
            send_params(self.channel, cfg, scfg, params)

    @property
    def lock(self) -> threading.Lock:
        return self.channel.lock

    @contextlib.contextmanager
    def _op(self, held: bool = False):
        """An op on a live group, under the lock (`held`: the caller holds
        it); a CollectiveError inside marks the group broken."""
        with contextlib.nullcontext() if held else self.lock:
            if self.broken is not None:
                raise CollectiveError(f"the engine's mesh {list(self.mesh.ranks)} broke earlier "
                                      f"({self.broken}): it serves no more ops")
            if self.stopped:
                raise RuntimeError("the engine's followers were stopped")
            try:
                yield self.channel
            except CollectiveError as e:
                self.broken = str(e)
                raise

    def _check(self, flags: list, what: str, err: Optional[BaseException]) -> None:
        """Raise for a step whose status has a flag set: a kernel fault on
        any rank first, then a broken group, then the leader's own error,
        then a follower's."""
        where = f"the engine's mesh {list(self.mesh.ranks)}"
        if flags[KERNEL_FAULT]:
            if isinstance(err, KernelError):
                raise err
            raise KernelError(f"a rank of {where} hit a kernel fault in {what}") from err
        if flags[BROKEN]:
            raise CollectiveError(f"a collective of {where} failed in {what}: the group is "
                                  "broken and serves no more ops") from err
        if err is not None:
            raise err
        if flags[FAILED]:
            raise FollowerError(f"a rank of {where} failed {what}")

    def _run(self, what: str, steps) -> object:
        """Steps 3-4 of an op on the leader: the pre-body status, then each
        body step and its status."""
        self._check(self.channel.status(), what, None)
        out = None
        for step in steps:
            err = None
            try:
                out = step(out)
            except Exception as e:  # noqa: BLE001 - every rank must reach the status
                err = e
            self._check(self.channel.status(err), what, err)
        return out

    def dispatch(self, *, op: str, bucket: int, n_valid: int, auto: bool, budget: int, warm,
                 img: Optional[torch.Tensor] = None, levels0=None, page_idx=None,
                 count: bool = False):
        """One warm-up or dispatch across the group -> (levels [b, n, L, d],
        iters_run, row_converged [b] bool, row_iters [b] int32, counted
        wire bytes or None)."""
        cfg, dtype = self.cfg, self.worker_dtype()
        ppr = page_idx.shape[1] if page_idx is not None else 0
        h = [OP[op], bucket, int(auto), budget, WARM_KINDS.index(warm), ppr, n_valid, 0, 0,
             int(count)]
        with self._op() as ch:
            ch.header(h)
            if img is None:
                img = torch.zeros((bucket, cfg.channels, cfg.image_size, cfg.image_size),
                                  device=self.device)
            else:
                img = ch.bcast(img.to(self.device, torch.float32))
            if warm is True:
                levels0 = ch.bcast(levels0.to(self.device, dtype))
            elif warm == "paged":
                page_idx = ch.bcast(page_idx.to(self.device, torch.int32))
            counters = tele_counters.CollectiveCounters() if count else None
            # A leader outside the group joins every step's status idle.
            steps = [_idle] * DISPATCH_STEPS
            if self.worker is not None:
                steps = [_counted_step(step, counters)
                         for step in self.worker.steps(h, img, levels0, page_idx)]
            out = self._run(f"{op} of bucket {bucket}", steps)
            comm = counters.totals() if counters is not None else None
            if self.worker is None:
                out, comm = recv_outputs(ch, bucket, cfg, dtype, count)
            return (*out, comm)

    def worker_dtype(self):
        return resolve_dtype(self.scfg.compute_dtype) or torch.float32

    def write_back(self, ids, pages: torch.Tensor, in_place: bool, apply_local) -> None:
        """Send one write-back's pages; every compute rank writes the ones it
        owns (`apply_local(ids, pages, in_place)` on the leader, under the
        pool's lock). The caller holds `lock`."""
        with self._op(held=True) as ch:
            ids_t = torch.as_tensor(list(ids), dtype=torch.int64, device=self.device)
            ch.header([OP["write_back"], 0, 0, 0, 0, 0, 0, len(ids), int(in_place), 0])
            ids_t = ch.bcast(ids_t)
            pages = ch.bcast(pages.to(self.device))
            steps = [_idle]
            if self.worker is not None:
                steps = [lambda _: apply_local(ids_t, pages, in_place)]
            self._run(f"a write-back of {len(ids)} pages", steps)

    def stop(self, op: str = "stop") -> None:
        """End the followers' loops ("release" also frees their state); a
        broken group is not sent anything (its followers' loops have
        raised)."""
        with self.lock:
            if self.stopped:
                return
            self.stopped = True
            if self.broken is None:
                self.channel.header([OP[op]] + [0] * (HEADER_LEN - 1))


def _idle(prev):
    return prev


def _counted_step(step, counters):
    """`step` with the collectives it calls recorded into `counters` (None:
    nothing)."""
    def run(prev):
        with (tele_counters.recording(counters) if counters is not None
              else contextlib.nullcontext()):
            return step(prev)
    return run


def send_outputs(channel: MeshChannel, out, comm: Optional[dict]) -> None:
    """The group's first rank to a leader outside the group: the gathered
    outputs and the counted bytes."""
    levels, iters_run, conv, row_iters = out
    kw = dict(src=channel.mesh.ranks[0], kind="outputs", group=channel.mesh.out_group)
    channel.bcast(levels, **kw)
    counts = [iters_run] + [int((comm or {}).get(k, 0)) for k in COUNT_KEYS]
    channel.bcast(torch.tensor(counts, dtype=torch.int64, device=channel.device), **kw)
    channel.bcast(_wire_dtype(conv), **kw)
    channel.bcast(row_iters, **kw)


def recv_outputs(channel: MeshChannel, bucket: int, cfg, dtype, count: bool):
    """A leader outside the group: ((levels, iters_run, conv, row_iters),
    counted bytes or None), from the group's first rank."""
    kw = dict(src=channel.mesh.ranks[0], kind="outputs", group=channel.mesh.out_group)
    dev = channel.device
    levels = channel.bcast(torch.empty((bucket, cfg.num_patches, cfg.levels, cfg.dim),
                                       dtype=dtype, device=dev), **kw)
    counts = channel.bcast(torch.zeros(1 + len(COUNT_KEYS), dtype=torch.int64, device=dev),
                           **kw).tolist()
    conv = channel.bcast(torch.empty(bucket, dtype=torch.uint8, device=dev), **kw).to(torch.bool)
    row_iters = channel.bcast(torch.empty(bucket, dtype=torch.int32, device=dev), **kw)
    comm = dict(zip(COUNT_KEYS, counts[1:])) if count else None
    return (levels, counts[0], conv, row_iters), comm


def run_follower(mesh, device, *, fault_hook=None) -> dict:
    """Serve the leader's ops on this rank until it sends `stop` or
    `release`. `fault_hook(header)` is called before each op's body (the
    chaos seam: a raise there fails the op on the leader). Returns {"ops":
    ops served by kind, "failed": ops this rank failed, "exit_reads": the
    auto loop's exit tests, "wire": bytes moved by kind}."""
    device = torch.device(device)
    if not mesh.is_member:
        raise ValueError(f"rank {dist.get_rank()} is not a rank of {mesh}")
    if dist.get_rank() == mesh.leader:
        raise ValueError("the leader holds the engine; it does not follow")
    channel = MeshChannel(mesh, device)
    cfg, scfg, params = recv_params(channel)
    dtype = resolve_dtype(scfg.compute_dtype) or torch.float32
    pool = None
    if scfg.page_pool_pages > 0:
        pt = resolve_page_tokens(cfg, scfg)
        pool = PoolShard(scfg.page_pool_pages // mesh.shape["data"], pt, cfg.levels, cfg.dim,
                         dtype, device, mesh.axes.data.index)
    worker = MeshWorker(cfg, scfg, mesh, params, device, pool=pool, wire=channel.wire)
    first = dist.get_rank() == mesh.ranks[0]
    stats = {"ops": {}, "failed": 0, "exit_reads": worker.exit_reads, "wire": channel.wire}
    while True:
        h = channel.header()
        op = OPS[h[H_OP]]
        stats["ops"][op] = stats["ops"].get(op, 0) + 1
        if op in ("stop", "release"):
            if op == "release":
                worker.params = None
                if pool is not None:
                    pool.release()
            return stats
        if op == "write_back":
            k = h[H_PAGES]
            ids = channel.bcast(torch.empty(k, dtype=torch.int64, device=device))
            pages = channel.bcast(torch.empty((k, pool.buffer.shape[1], cfg.levels, cfg.dim),
                                              dtype=dtype, device=device))
        else:
            b = h[H_BUCKET]
            warm = WARM_KINDS[h[H_WARM]]
            if op == "warmup":
                img = torch.zeros((b, cfg.channels, cfg.image_size, cfg.image_size),
                                  device=device)
            else:
                img = channel.bcast(torch.empty((b, cfg.channels, cfg.image_size,
                                                 cfg.image_size), device=device))
            levels0 = page_idx = None
            if warm is True:
                levels0 = channel.bcast(torch.empty((b, cfg.num_patches, cfg.levels, cfg.dim),
                                                    dtype=dtype, device=device))
            elif warm == "paged":
                page_idx = channel.bcast(torch.empty((b, h[H_PPR]), dtype=torch.int32,
                                                     device=device))
        err = None
        try:
            if fault_hook is not None:
                fault_hook(dict(zip(("op", "bucket", "auto", "budget", "warm"),
                                    (op, *h[1:5]))))
        except Exception as e:  # noqa: BLE001 - reported through the status
            err = e
            traceback.print_exc(file=sys.stderr)
        flags = channel.status(err)
        counters = tele_counters.CollectiveCounters() if h[H_COUNT] else None
        if op == "write_back":
            steps = [lambda _: pool.apply(ids, pages, bool(h[H_INPLACE]))]
        else:
            steps = [_counted_step(step, counters)
                     for step in worker.steps(h, img, levels0, page_idx)]
        out = None
        for step in steps:
            if any(flags):
                break
            err = None
            try:
                out = step(out)
            except Exception as e:  # noqa: BLE001 - reported through the status
                err = e
                traceback.print_exc(file=sys.stderr)
            flags = channel.status(err)
        if any(flags):
            stats["failed"] += err is not None
            if flags[BROKEN]:
                raise CollectiveError(f"the engine's mesh {list(mesh.ranks)} broke in a "
                                      f"{op}: rank {dist.get_rank()} follows no more") from err
            continue
        if op != "write_back" and first and not mesh.leader_in_group:
            send_outputs(channel, out, counters.totals() if counters is not None else None)
