"""The ranks of a sharded engine: the leader's channel and the follower loop.

glom_tpu serves a mesh from one controller: its engine's forward is one
`shard_map` over every device. The port has one process a rank, so an
`InferenceEngine(mesh=)` over a `ServeMesh` (parallel/serve_mesh.py) is a
**leader**, and the engine's other ranks are **followers** that run
`run_follower` until the leader stops them. Every op goes over the
engine's own process group (leader and ranks), in this order:

  1. a fixed int64[HEADER_LEN] header, broadcast by the leader: the op
     (`warmup`, `dispatch`, the pool ops, the timing ops, `release`,
     `stop`), the bucket,
     the route (auto or fixed, and the budget), the warm kind (cold, host
     `levels0`, paged), pages per row, n_valid (the mask is `arange(b) <
     n_valid`), a pool op's page count and a write's in-place flag, and
     whether the dispatch counts its wire bytes;
  2. the payload, broadcast: the image (not on `warmup`), then `levels0`
     or `page_idx`; a pool op sends its page ids (and a write or a
     residual the pages);
  3. a status all-reduce (MAX of three flags: failed, a kernel fault, a
     broken collective): a follower's fault hook fires before it;
  4. the body, in steps, each followed by a status all-reduce: every
     compute rank runs the same `MeshWorker`, first `compute` (the
     per-rank forward of `serve_mesh.make_serve_forward`), then `gather`
     (`levels` all-gathered over 'seq' and 'data', `row_converged` /
     `row_iters` over 'data'); a pool op runs `pool_steps`;
  5. a leader outside the group then receives the outputs from the
     group's first rank.

The pool ops carry the sharded page pool's device seams
(paged_columns.ShardedColumnPool; the leader keeps the page table and
decides everything the single-device pool decides):

  * `write_back`: each rank writes the pages it owns, in place or
    copy-on-write as the leader says;
  * `residual` (a delta stream's next frame): each rank compares the
    frame's pages with the pages it owns (any bit, max |diff|), and one
    MAX all-reduce of the [2, k] flags gives every rank the whole answer;
  * `read` (read-back, the drain migration) and `copy` (chain compaction,
    defrag): the ranks at seq index 0 contribute the pages they own as
    int32 words, zeros elsewhere, and one SUM all-reduce hands every rank
    the pages bit for bit (one contributor a page: integer sums are
    exact, where a float sum would turn -0.0 into 0.0); `copy` then
    writes each destination page on its owner, copy-on-write, from the
    buffers before the move.

The timing ops carry the engine's collective timing
(`ServeConfig.collective_timing`; every rank's MeshWorker resolves the
same mode from the config the leader sent, registers a signature's sites
on its counted first dispatch, and under "full" brackets every site's
execution into its own log):

  * `sample`: every compute rank re-dispatches each registered site alone
    (telemetry/comm_time.CollectiveTimeSampler, the sites in one sorted
    order, each site's minimum MAX-reduced over 'data' and 'seq'), then
    the group's first rank broadcasts the samples to the group (a leader
    outside the group included);
  * `drain`: every rank hands over its logged executions, and one object
    all-gather over the group gives the leader every rank's.

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
serves the leader's model. On `release` every follower drops its
parameters and its pool shard and reports the device bytes that freed, in
one all-gather the leader joins.

An elastic fleet (serve/elastic.RankGroupFleet) runs engines on rank groups
that come and go: a follower rank runs `follow_engines`, a loop over its
group's engine lifetimes (generations). Between two engines it waits on a
key of the `torch.distributed` store (the group's prefix and the
generation), outside any collective, so a spare group may wait for
minutes without reaching its collectives' timeout; "serve" starts the next
`run_follower`, "exit" ends the loop. Such an engine's mesh carries a
`gate` (the store and the generation's prefix): before each header the
leader posts the op's number on the store and the followers wait for it
there, so an idle engine (a warm spare, a quiet replica) holds no
collective open either.
"""

from __future__ import annotations

import contextlib
import datetime
import sys
import threading
import traceback
from typing import Dict, Optional

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
from glom_tpu_torch.telemetry.comm_time import CollectiveTimeSampler
from glom_tpu_torch.utils.helpers import resolve_dtype

OPS = ("stop", "warmup", "dispatch", "write_back", "release", "residual", "read", "copy",
       "sample", "drain")
POOL_OPS = ("write_back", "residual", "read", "copy")
TIMING_OPS = ("sample", "drain")
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
        # An elastic fleet's engine: (store, prefix) gating each header, and
        # the number of headers so far.
        self.gate = getattr(mesh, "gate", None)
        self.n_headers = 0
        # Bytes this rank moved through the channel and the gathers, by kind.
        self.wire = {"header": 0, "payload": 0, "status": 0, "gather": 0, "outputs": 0,
                     "pool": 0}

    def bcast(self, t: torch.Tensor, src: Optional[int] = None, kind: str = "payload",
              group=None):
        """`t` from `src` (the leader) to the group, in place. Under
        inference mode: gloo's broadcast of a CUDA tensor writes it in place
        even at its source, and a dispatch's outputs are inference tensors."""
        t = t.contiguous()
        with torch.inference_mode():
            transport("broadcast", "engine", lambda: dist.broadcast(
                t, src=self.mesh.leader if src is None else src,
                group=self.mesh.group if group is None else group))
        self.wire[kind] += t.nelement() * t.element_size()
        return t

    def header(self, values=None) -> list:
        """The op's header, from the leader (`values`) to every rank. With a
        gate the leader first posts the header's number on the store (and
        drops the previous one: every rank has passed it) and the followers
        wait for it there."""
        if self.gate is not None:
            store, prefix = self.gate
            key = f"{prefix}/op{self.n_headers}"
            if values is not None:
                store.set(key, "1")
                if self.n_headers:
                    store.delete_key(f"{prefix}/op{self.n_headers - 1}")
            else:
                wait_key(store, key)
            self.n_headers += 1
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
    """A rank's shard of the engine's page pool: pages [index x pps,
    (index + 1) x pps) of the pool, for its data index (replicated over
    'seq'; the rank at seq index 0 contributes them to reads). Writes keep
    the single-device rules: in place when the leader says so, else
    copy-on-write. The leader's ShardedColumnPool holds its shard the same
    way."""

    def __init__(self, pps: int, page_tokens: int, levels: int, dim: int, dtype, device,
                 data_index: int, contributes: bool = True):
        self.lo = data_index * pps
        self.contributes = contributes
        self.buffer = torch.zeros((pps, page_tokens, levels, dim), dtype=dtype, device=device)

    def acquire_read(self) -> torch.Tensor:
        return self.buffer

    def release_read(self) -> None:
        pass

    def apply(self, ids: torch.Tensor, pages: torch.Tensor, in_place: bool) -> None:
        self.buffer = apply_owned(self.buffer, self.lo, ids, pages, in_place)

    def local_pages(self) -> Optional[torch.Tensor]:
        return self.buffer

    def release(self) -> None:
        self.buffer = None


def _owned(buffer: torch.Tensor, lo: int, ids: torch.Tensor):
    """(local index, owned mask) of global page ids against a shard."""
    local = ids.long() - lo
    return local, (local >= 0) & (local < buffer.shape[0])


def apply_owned(buffer: torch.Tensor, lo: int, ids: torch.Tensor, pages: torch.Tensor,
                in_place: bool) -> torch.Tensor:
    """`buffer` with the pages of global ids in [lo, lo + len(buffer))
    written: in place, or into a copy (copy-on-write). Returns the buffer
    now current."""
    local, own = _owned(buffer, lo, ids)
    if not bool(own.any()):
        return buffer
    idx, rows = local[own], pages[own]
    if in_place:
        return buffer.index_copy_(0, idx, rows)
    return buffer.clone().index_copy_(0, idx, rows)


def owned_residual(buffer: torch.Tensor, lo: int, ids: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """[2, k] f32 on the host: for each page id this shard owns, whether any
    bit of `rows` differs from it (through an integer view of the same
    width, so 0.0 against -0.0 is a change) and the max |diff| in f32;
    zeros for the pages it does not own (the MAX over the group keeps the
    owner's values exactly)."""
    out = torch.zeros((2, ids.shape[0]), dtype=torch.float32, device=rows.device)
    local, own = _owned(buffer, lo, ids)
    if bool(own.any()):
        cur, new = buffer.index_select(0, local[own]), rows[own]
        int_t = torch.int16 if buffer.dtype == torch.bfloat16 else torch.int32
        out[0, own] = (cur.view(int_t) != new.view(int_t)).flatten(1).any(dim=1).float()
        out[1, own] = (cur.float() - new.float()).abs().flatten(1).amax(dim=1)
    return out.cpu()


def owned_words(buffer: torch.Tensor, lo: int, ids: torch.Tensor,
                contributes: bool) -> torch.Tensor:
    """[k, page_tokens, L, d x itemsize / 4] int32: the bits of the pages of
    `ids` this shard owns (when it contributes), zeros elsewhere."""
    words = torch.zeros((ids.shape[0], *buffer.shape[1:]), dtype=buffer.dtype,
                        device=buffer.device).view(torch.int32)
    local, own = _owned(buffer, lo, ids)
    if contributes and bool(own.any()):
        words[own] = buffer.index_select(0, local[own]).view(torch.int32)
    return words


def pool_steps(channel, shard, op: str, ids: torch.Tensor, pages=None,
               in_place: bool = False) -> list:
    """The body steps of a pool op on one rank, the same on the leader and
    the followers (`shard`: a PoolShard, or anything with its
    `local_pages`, `lo`, `contributes` and `apply`). Each step's collective is reached only after a clean
    status, so every rank joins it. The last step returns the op's answer:
    the [2, k] residual, the read pages, or None."""
    group = channel.mesh.group

    def all_reduce(t, op_):
        transport("pool all_reduce", "engine",
                  lambda: dist.all_reduce(t, op=op_, group=group))
        channel.wire["pool"] += t.nelement() * t.element_size()
        return t

    if op == "write_back":
        return [lambda _: shard.apply(ids, pages, in_place)]
    if op == "residual":
        return [lambda _: owned_residual(shard.local_pages(), shard.lo, ids, pages),
                lambda res: all_reduce(res.to(channel.host), dist.ReduceOp.MAX).cpu()]
    src = ids[0] if op == "copy" else ids
    dtype = shard.local_pages().dtype
    steps = [lambda _: owned_words(shard.local_pages(), shard.lo, src, shard.contributes),
             lambda words: all_reduce(words, dist.ReduceOp.SUM).view(dtype)]
    if op == "copy":
        steps.append(lambda moved: shard.apply(ids[1], moved, False))
    return steps


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
        # Collective timing: the mode, the sites the counted dispatches
        # registered ((site, shape) -> site), the sampler, the full log.
        self.timing = scfg.collective_timing
        self.time_log = tele_counters.CollectiveTimeLog() if self.timing == "full" else None
        self.sites: Dict[tuple, dict] = {}
        self.sampler: Optional[CollectiveTimeSampler] = None

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
        row_iters [b]), each under the engine's timing mode."""
        return [lambda _: self._timed(self.compute, h, img, levels0, page_idx),
                lambda local: self._timed(self.gather, local)]

    def _timed(self, fn, *args):
        with tele_counters.timing(self.timing, self.time_log):
            return fn(*args)

    def register_sites(self, sites: list) -> None:
        """The sites a counted dispatch recorded (glom_tpu's registry)."""
        for site in sites:
            self.sites.setdefault((site["site"], site["shape"]), site)

    def sample_sites(self) -> list:
        """One sampled pass over the registered sites on this rank's groups
        (every compute rank runs it in the `sample` op)."""
        sites = list(self.sites.values())
        if self.sampler is None:
            self.sampler = CollectiveTimeSampler(self.axes, sites, interval=1,
                                                 device=self.device)
        else:
            self.sampler.update_sites(sites)
        return self.sampler.sample()

    def take_events(self) -> list:
        """This rank's logged executions since the last drain."""
        return self.time_log.take() if self.time_log is not None else []

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


def timing_steps(channel: MeshChannel, worker: Optional[MeshWorker], op: str) -> list:
    """The body steps of a timing op, the same on every rank of the group
    (`worker` None: a leader outside the group). `sample`: the compute
    ranks sample, then the group's first rank broadcasts the samples.
    `drain`: each rank's logged executions, all-gathered over the group.
    The last step returns the op's answer on every rank."""
    mesh = channel.mesh

    def share(samples):
        obj = [samples]
        transport("timing broadcast", "engine", lambda: dist.broadcast_object_list(
            obj, src=mesh.ranks[0], group=mesh.group))
        return obj[0]

    def gather(events):
        out = [None] * dist.get_world_size(mesh.group)
        transport("timing all_gather", "engine",
                  lambda: dist.all_gather_object(out, events, group=mesh.group))
        return [e for rank_events in out for e in rank_events]

    if op == "sample":
        return [(lambda _: worker.sample_sites()) if worker is not None else _idle, share]
    return [(lambda _: worker.take_events()) if worker is not None else (lambda _: []), gather]


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
            if counters is not None and self.worker is not None:
                self.worker.register_sites(counters.sites)
            if self.worker is None:
                out, comm = recv_outputs(ch, bucket, cfg, dtype, count)
            return (*out, comm)

    def timing_op(self, op: str):
        """One timing op across the group (`sample` or `drain`, see the
        module docstring): the samples, or every rank's logged executions."""
        with self._op() as ch:
            ch.header([OP[op]] + [0] * (HEADER_LEN - 1))
            return self._run(f"a {op} of the collective timing",
                             timing_steps(ch, self.worker, op))

    def worker_dtype(self):
        return resolve_dtype(self.scfg.compute_dtype) or torch.float32

    def pool_op(self, op: str, ids: torch.Tensor, shard, pages=None, in_place: bool = False):
        """One pool op across the group (see the module docstring): `ids`
        int64 [k] ([2, k] of (src, dst) for `copy`), `pages` the rows of a
        write or a residual, `shard` the leader's own (its ShardedColumnPool,
        under the pool's lock). Returns the op's answer. The caller holds
        `lock`."""
        with self._op(held=True) as ch:
            k = ids.shape[-1]
            ch.header([OP[op], 0, 0, 0, 0, 0, 0, k, int(in_place), 0])
            ids = ch.bcast(ids.to(self.device, torch.int64))
            if op in ("write_back", "residual"):
                pages = ch.bcast(pages.to(self.device))
            return self._run(f"a {op} of {k} pages", pool_steps(ch, shard, op, ids, pages,
                                                                 in_place))

    def stop(self, op: str = "stop") -> Dict[int, int]:
        """End the followers' loops ("release" also frees their state); a
        broken group is not sent anything (its followers' loops have
        raised). Returns, for "release", the device bytes each follower
        freed by global rank, else {}."""
        with self.lock:
            if self.stopped:
                return {}
            self.stopped = True
            if self.broken is not None:
                return {}
            self.channel.header([OP[op]] + [0] * (HEADER_LEN - 1))
            if op != "release":
                return {}
            freed = release_report(self.channel, 0)
            return {r: b for r, b in freed.items() if r != self.mesh.leader}


def release_report(channel: MeshChannel, freed: int) -> Dict[int, int]:
    """Every rank of the group's freed device bytes, by global rank (one
    int64 all-gather: the last collective of a released engine)."""
    group = channel.mesh.group
    ranks = dist.get_process_group_ranks(group)
    mine = torch.tensor([freed], dtype=torch.int64, device=channel.host)
    out = torch.zeros(len(ranks), dtype=torch.int64, device=channel.host)
    transport("release all_gather", "engine",
              lambda: dist.all_gather_into_tensor(out, mine, group=group))
    return dict(zip(ranks, out.tolist()))


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
    auto loop's exit tests, "wire": bytes moved by kind, "pool": the rank's
    PoolShard or None, and after a release "freed_bytes"}."""
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
                         dtype, device, mesh.axes.data.index, mesh.axes.seq.index == 0)
    worker = MeshWorker(cfg, scfg, mesh, params, device, pool=pool, wire=channel.wire)
    first = dist.get_rank() == mesh.ranks[0]
    stats = {"ops": {}, "failed": 0, "exit_reads": worker.exit_reads, "wire": channel.wire,
             "pool": pool}
    while True:
        h = channel.header()
        op = OPS[h[H_OP]]
        stats["ops"][op] = stats["ops"].get(op, 0) + 1
        if op in ("stop", "release"):
            if op == "release":
                before = allocated_bytes(device)
                worker.params = params = None
                worker._fns.clear()
                if pool is not None:
                    pool.release()
                stats["freed_bytes"] = before - allocated_bytes(device)
                release_report(channel, stats["freed_bytes"])
            return stats
        if op in POOL_OPS:
            k = h[H_PAGES]
            ids = channel.bcast(torch.empty((2, k) if op == "copy" else k, dtype=torch.int64,
                                            device=device))
            pages = None
            if op in ("write_back", "residual"):
                pages = channel.bcast(torch.empty((k, *pool.buffer.shape[1:]), dtype=dtype,
                                                  device=device))
        elif op in TIMING_OPS:
            pass  # no payload
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
        if op in POOL_OPS:
            steps = pool_steps(channel, pool, op, ids, pages, bool(h[H_INPLACE]))
        elif op in TIMING_OPS:
            steps = timing_steps(channel, worker, op)
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
        if counters is not None:
            worker.register_sites(counters.sites)
        if op not in POOL_OPS + TIMING_OPS and first and not mesh.leader_in_group:
            send_outputs(channel, out, counters.totals() if counters is not None else None)


def allocated_bytes(device: torch.device) -> int:
    """The device memory this process's tensors hold (0 off the card)."""
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


# How long one wait on the store lasts before it is posted again: a waiting
# group holds no collective, so it may wait any number of these.
STORE_WAIT_S = 30.0


def group_prefix(run_prefix: str, index: int) -> str:
    """The store prefix of the run's `index`-th rank group."""
    return f"{run_prefix}/group{index}"


def group_key(prefix: str, generation: int) -> str:
    """The store key that starts (or ends) a group's `generation`-th
    engine lifetime."""
    return f"{prefix}/gen{generation}"


def wait_key(store, key: str) -> None:
    """Wait until `key` is set on the store, however long: each wait that
    times out is posted again (any other store failure raises)."""
    while True:
        try:
            store.wait([key], datetime.timedelta(seconds=STORE_WAIT_S))
            return
        except RuntimeError as e:
            if "timeout" not in str(e).lower():
                raise


def follow_engines(mesh, device, store, prefix: str, *, fault_hook=None) -> list:
    """A follower rank of an elastic fleet's group: for each generation,
    wait on the store (outside any collective) for the leader's word;
    "serve" runs `run_follower` for the engine the leader builds on the
    group (its headers gated on the store), "exit" returns. Returns each
    lifetime's `run_follower` stats. A group whose collective broke raises
    (the fleet retires it)."""
    served = []
    while True:
        key = group_key(prefix, len(served))
        wait_key(store, key)
        if store.get(key) == b"exit":
            return served
        mesh.gate = (store, key)
        served.append(run_follower(mesh, device, fault_hook=fault_hook))
