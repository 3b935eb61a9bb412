"""Rank bodies for the port's multi-rank CPU tests (gloo, a file store).

The test modules import glom_tpu for the reference; spawned ranks import
this module instead, whose top level imports only torch, numpy and
glom_tpu_torch, so no rank ever imports JAX. `run` spawns `world` ranks,
each running a list of (case name, kwargs) in order over one process
group, and returns every rank's list of results (numpy arrays and plain
Python). A rank that raises fails the call with its traceback.
"""

from __future__ import annotations

import os
import queue
import time
import traceback

import numpy as np
import torch

SPAWN_TIMEOUT_S = 300


def run(world: int, cases, tmp_path, timeout: float = SPAWN_TIMEOUT_S):
    """[(case, kwargs), ...] on `world` gloo ranks -> results[rank][i]."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = "file://" + os.path.join(str(tmp_path), f"store-{os.getpid()}-{id(cases)}")
    procs = [ctx.Process(target=_child, args=(r, world, init, cases, q)) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            try:
                rank, status, payload = q.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    errors.append(f"ranks exited {dead} or gave no result within {timeout} s")
                    break
                continue
            if status == "ok":
                results[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]


def _child(rank, world, init, cases, q):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from glom_tpu_torch.parallel.mesh import initialize_multihost

    try:
        initialize_multihost(num_processes=world, process_id=rank, init_method=init,
                             device="cpu", backend="gloo")
        out = [CASES[name](**kw) for name, kw in cases]
        q.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 - relayed to the parent, which raises
        q.put((rank, "err", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# -- helpers ---------------------------------------------------------------


def _np(t):
    return t.detach().float().cpu().numpy()


def _mesh(shape):
    from glom_tpu_torch.parallel.mesh import make_mesh
    from glom_tpu_torch.utils.config import MeshConfig

    world = int(np.prod(shape))
    mesh, _ = make_mesh(MeshConfig(*shape), devices=["cpu"] * world)
    return mesh


def _params(arrays):
    from glom_tpu_torch.models.transplant import params_from_numpy

    return params_from_numpy(arrays)


def _gathered_grads(mesh, params, grads):
    """Every leaf's global gradient (TP shards gathered over 'model')."""
    from glom_tpu_torch.parallel.collectives import all_gather, mesh_axis
    from glom_tpu_torch.parallel.sharding import denoise_param_specs, spec_axis
    from glom_tpu_torch.utils.checkpoint import named_leaves

    specs = denoise_param_specs("hidden")
    model = mesh_axis(mesh, "model")
    out = []
    for (name, _), g in zip(named_leaves(params), grads):
        md = spec_axis(specs[name], "model")
        out.append(_np(all_gather(g, model, md) if md >= 0 else g))
    return out


# -- cases -------------------------------------------------------------------


def loss_grads(shape, sp, cfg_kw, tcfg_kw, arrays, img, noise):
    """make_manual_loss on the mesh: the global loss and every leaf's
    global gradient, on every rank."""
    from glom_tpu_torch.models.core import param_leaves, unflatten_params
    from glom_tpu_torch.parallel.manual import make_manual_loss, rank_axes
    from glom_tpu_torch.parallel.sharding import denoise_param_specs, shard_leaf
    from glom_tpu_torch.utils.checkpoint import named_leaves
    from glom_tpu_torch.utils.config import GlomConfig, TrainConfig

    mesh = _mesh(shape)
    axes = rank_axes(mesh)
    full = _params(arrays)
    specs = denoise_param_specs("hidden")
    coords = {"model": (axes.model.index, axes.model.size)}
    leaves = [shard_leaf(t, specs[name], coords).clone().requires_grad_()
              for name, t in named_leaves(full)]
    params = unflatten_params(full, leaves)
    loss_fn = make_manual_loss(mesh, GlomConfig(**cfg_kw), TrainConfig(**tcfg_kw), sp_strategy=sp)
    loss = loss_fn(params, torch.from_numpy(img), torch.from_numpy(noise))
    grads = torch.autograd.grad(loss, param_leaves(params))
    return {"loss": float(loss.detach()), "grads": _gathered_grads(mesh, params, grads)}


def trainer_run(shape, sp, cfg_kw, tcfg_kw, arrays, steps, data_seed, log_every=1,
                tp_axis="hidden"):
    """DistributedTrainer.fit over shapes_dataset(seed=data_seed): the
    records, the final global params and optimizer state, the bytes of
    this rank's optimizer state, over the run the (G, f, addend) of each
    K1 Function call and the counted collective sites, and the
    "collective_time" records the writer rank wrote."""
    import warnings

    from glom_tpu_torch.data import shapes_dataset
    from glom_tpu_torch.parallel import DistributedTrainer
    from glom_tpu_torch.parallel import manual
    from glom_tpu_torch.telemetry import counters
    from glom_tpu_torch.utils.checkpoint import named_leaves
    from glom_tpu_torch.utils.config import GlomConfig, MeshConfig, TrainConfig

    cfg, tcfg = GlomConfig(**cfg_kw), TrainConfig(**tcfg_kw)
    world = int(np.prod(shape))
    writer = _ListWriter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr = DistributedTrainer(cfg, tcfg, MeshConfig(*shape), sp_strategy=sp,
                                devices=["cpu"] * world, backend="gloo",
                                params=None if arrays is None else _params(arrays),
                                tp_axis=tp_axis, metrics_writer=writer)
    k1_calls, vjp = [], manual.grouped_ffw_lm_vjp

    def recording_vjp(p, x, add=None):
        k1_calls.append((int(p.w1.shape[0]), int(p.w1.shape[-1]), add is not None))
        return vjp(p, x, add=add)

    manual.grouped_ffw_lm_vjp = recording_vjp
    sites = counters.CollectiveCounters()
    try:
        with counters.recording(sites):
            hist = tr.fit(shapes_dataset(tcfg.batch_size, cfg.image_size, seed=data_seed),
                          steps, log_every=log_every)
    finally:
        manual.grouped_ffw_lm_vjp = vjp
    g = tr.global_state()
    opt_bytes = sum(v.numel() * v.element_size()
                    for s in tr.state.optimizer.state.values() for v in s.values()
                    if torch.is_tensor(v))
    return {
        "records": [{k: v for k, v in r.items() if isinstance(v, (int, float, str, bool))
                     or v is None} for r in hist],
        "params": {name: _np(t) for name, t in named_leaves(g.params)},
        "moments": {i: {k: _np(v) for k, v in s.items() if torch.is_tensor(v)}
                    for i, s in g.optimizer.state_dict()["state"].items()},
        "opt_bytes": opt_bytes,
        "warnings": [str(w.message) for w in caught],
        "vjp_path": tr.vjp_path, "sp_strategy": tr.sp_strategy,
        "k1_calls": k1_calls, "sites": sites.sites,
        "collective_time": [r for r in writer.recs if r.get("kind") == "collective_time"],
    }


def checkpoint_roundtrip(cfg_kw, tcfg_kw, arrays, directory, data_seed):
    """Train 2 steps at stage 2 on dp 2 and save; restore into stage 0 and
    into stage 1 with the other ZeRO layout; each takes one more step. The
    results of those steps, and of the uninterrupted stage-2 run's third
    step, on every rank."""
    import dataclasses

    from glom_tpu_torch.data import shapes_dataset
    from glom_tpu_torch.parallel import DistributedTrainer
    from glom_tpu_torch.utils.checkpoint import CheckpointManager, named_leaves
    from glom_tpu_torch.utils.config import GlomConfig, MeshConfig, TrainConfig
    import torch.distributed as dist

    cfg = GlomConfig(**cfg_kw)
    base = TrainConfig(**tcfg_kw)
    rank = dist.get_rank()

    def trainer(stage):
        return DistributedTrainer(cfg, dataclasses.replace(base, zero_stage=stage),
                                  MeshConfig(data=2), devices=["cpu"] * 2, backend="gloo",
                                  params=_params(arrays))

    batches = list(shapes_dataset(base.batch_size, cfg.image_size, seed=data_seed,
                                  num_batches=3))
    first = trainer(2)
    for b in batches[:2]:
        first.step(b)
    mgr = CheckpointManager(directory, async_save=False) if rank == 0 else None
    assert first.save_checkpoint(mgr, 2) == (rank == 0)
    want = first.step(batches[2])
    out = {"want_loss": float(want["loss"]),
           "want_params": {n: _np(t) for n, t in named_leaves(first.global_state().params)}}
    for stage in (0, 1):
        tr = trainer(stage)
        step = tr.restore_checkpoint(directory, manager=mgr)
        m = tr.step(batches[2])
        out[f"stage{stage}"] = {
            "step": step, "after": tr.state.step, "loss": float(m["loss"]),
            "params": {n: _np(t) for n, t in named_leaves(tr.global_state().params)},
        }
    return out


def sp_bodies(seq, strategy, levels, weights, attend_self, side, radius):
    """The strategy's shard body on this rank's band of `levels`
    [b, n, L, d]: its output band and the band's gradient of
    sum(out * weights), on every rank."""
    from glom_tpu_torch.parallel.collectives import mesh_axis
    from glom_tpu_torch.parallel.halo import halo_consensus_shard
    from glom_tpu_torch.parallel.ring import ring_consensus_shard
    from glom_tpu_torch.parallel.ulysses import ulysses_consensus_shard

    mesh = _mesh((1, seq, 1))
    axis = mesh_axis(mesh, "seq")
    body = {"ring": ring_consensus_shard, "ulysses": ulysses_consensus_shard,
            "halo": halo_consensus_shard}[strategy]
    n_loc = levels.shape[1] // seq
    band = slice(axis.index * n_loc, (axis.index + 1) * n_loc)
    x = torch.from_numpy(levels[:, band]).clone().requires_grad_()
    out = body(x, axis=axis, attend_self=attend_self, side=side, radius=radius)
    (dx,) = torch.autograd.grad((out * torch.from_numpy(weights[:, band])).sum(), x)
    return {"out": _np(out), "dx": _np(dx)}


def consensus_fns(seq, cfg_kw, strategy, levels):
    """runtime.make_consensus_fn's global view on every rank (None where
    it builds none)."""
    from glom_tpu_torch.parallel.runtime import make_consensus_fn
    from glom_tpu_torch.utils.config import GlomConfig

    fn = make_consensus_fn(_mesh((1, seq, 1)), GlomConfig(**cfg_kw), strategy)
    return None if fn is None else _np(fn(torch.from_numpy(levels)))


def collective_grads(x):
    """Each differentiable collective's backward against its transpose,
    at world 2 over one axis: results on every rank."""
    from glom_tpu_torch.parallel.collectives import (
        all_to_all,
        copy_to_model,
        halo_exchange,
        mesh_axis,
        reduce_from_model,
    )

    axis = mesh_axis(_mesh((1, 1, 2)), "model")
    r = axis.index
    t = torch.from_numpy(x).clone() * (r + 1)
    out = {}
    a = t.clone().requires_grad_()
    (c,) = copy_to_model([a], axis)
    (g,) = torch.autograd.grad((c * (r + 2)).sum(), a)
    out["copy"] = _np(g)  # the sum over ranks of (r + 2): 2 + 3 = 5 everywhere
    a = t.clone().requires_grad_()
    s = reduce_from_model(a, axis)
    (g,) = torch.autograd.grad((s * (r + 2)).sum(), a)
    out["reduce_fwd"], out["reduce_bwd"] = _np(s), _np(g)
    a = t.clone().requires_grad_()  # [b, n, L, d] with n and L divisible by 2
    y = all_to_all(a, axis, split_dim=2, concat_dim=1)
    w = torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)
    (g,) = torch.autograd.grad((y * w).sum(), a)
    out["a2a_fwd"], out["a2a_bwd"], out["a2a_w"] = _np(y), _np(g), _np(w)
    a = t.clone().requires_grad_()
    h = halo_exchange(a, axis, 1)
    w = torch.arange(h.numel(), dtype=h.dtype).reshape(h.shape) * (r + 1)
    (g,) = torch.autograd.grad((h * w).sum(), a)
    out["halo_fwd"], out["halo_bwd"], out["halo_w"] = _np(h), _np(g), _np(w)
    return out


def mesh_facts(shape, num_slices=1):
    """The mesh's layout as this rank sees it."""
    from glom_tpu_torch.parallel.collectives import mesh_axis
    from glom_tpu_torch.parallel.mesh import make_mesh
    from glom_tpu_torch.utils.config import MeshConfig
    import torch.distributed as dist

    cfg = MeshConfig(*shape, num_slices=num_slices)
    mesh, dev = make_mesh(cfg, devices=["cpu"] * cfg.num_devices, backend="gloo")
    axes = {n: mesh_axis(mesh, n) for n in cfg.axis_names}
    return {"names": list(mesh.mesh_dim_names), "ranks": mesh.mesh.tolist(), "device": str(dev),
            "rank": dist.get_rank(), "backend": dist.get_backend(),
            "index": {n: a.index for n, a in axes.items()},
            "size": {n: a.size for n, a in axes.items()}}


def fail_on(rank_to_fail):
    """Raise on one rank (the spawn's failure path)."""
    import torch.distributed as dist

    if dist.get_rank() == rank_to_fail:
        raise RuntimeError(f"rank {rank_to_fail} fails on purpose")
    return "ok"


# -- sharded inference ----------------------------------------------------------


def glom_mesh(shape, sp, cfg_kw, arrays, img, levels0, iters, use_pallas=True):
    """Glom(mesh=MeshConfig(*shape)) on every rank: the final state, all
    T+1 states, and the final state from a carried-in levels0; and the
    auto route's refusal."""
    from glom_tpu_torch.models.api import Glom
    from glom_tpu_torch.utils.config import MeshConfig

    m = Glom(**cfg_kw, params=_params(arrays), mesh=MeshConfig(*shape), sp_strategy=sp,
             device="cpu", use_pallas=use_pallas)
    x, lv = torch.from_numpy(img), torch.from_numpy(levels0)
    out = {"final": _np(m(x, iters=iters)), "all": _np(m(x, iters=iters, return_all=True)),
           "with_levels": _np(m(x, iters=iters, levels=lv))}
    try:
        m(x, iters="auto")
    except NotImplementedError as e:
        out["auto_refused"] = str(e)
    return out


def _serve_script(eng, calls):
    """Run `calls` on the leader's engine: each a dict with "kind" infer /
    warmup / write_back / write_back_stream / lookup / stats / pool_record
    / release; "levels0_from" and "from" name an earlier infer call by its
    index, "page_rows_from" the sessions whose pages an infer reads.
    Returns one entry a call."""
    import numpy as np

    results, out = [], []  # one entry a call (the ServeResult of an infer)
    for c in calls:
        kind = c["kind"]
        if kind != "infer":
            results.append(None)
        if kind == "infer":
            kw = {k: c[k] for k in ("n_valid", "auto_budget", "iters_override", "page_rows",
                                    "support_rows") if c.get(k) is not None}
            if c.get("levels0_from") is not None:
                kw["levels0"] = results[c["levels0_from"]].levels.cpu()
            if c.get("page_rows_from") is not None:
                kw["page_rows"] = np.array([eng.pool.lookup(sid)[0]
                                            for sid in c["page_rows_from"]], np.int32)
            try:
                r = eng.infer(c["img"], **kw)
            except Exception as e:  # noqa: BLE001 - the test reads the error
                results.append(None)
                out.append({"error": type(e).__name__, "message": str(e)})
                continue
            results.append(r)
            out.append({"levels": _np(r.levels), "iters_run": r.iters_run,
                        "row_converged": np.asarray(r.row_converged),
                        "row_iters": np.asarray(r.row_iters),
                        "levels0_h2d_bytes": r.levels0_h2d_bytes})
        elif kind == "warmup":
            out.append(eng.warmup(**c.get("kw", {})))
        elif kind == "write_back":
            row = results[c["from"]].levels[c["row"]]
            out.append(eng.pool.write_back(c["sid"], row, eng.cfg.num_patches))
        elif kind == "write_back_stream":
            row = results[c["from"]].levels[c["row"]]
            out.append(eng.pool.write_back_stream(c["sid"], row, eng.cfg.num_patches))
        elif kind == "lookup":
            got = eng.pool.lookup(c["sid"])
            out.append(None if got is None else list(got[0]))
        elif kind == "stats":
            out.append([{k: v for k, v in r.items() if isinstance(v, (int, float, str, bool))
                         or v is None} for r in eng.stats_records()])
        elif kind == "pool_record":
            out.append(eng.pool.record())
        elif kind == "release":
            eng.release()
            out.append(True)
        elif kind == "timing":
            out.append([{k: v for k, v in r.items() if isinstance(v, (int, float, str))
                         or v is None} for r in eng.collective_time_records()])
    return out


def _batcher_script(eng, reqs, timeout=300.0):
    """The two-tier test's traffic through DynamicBatcher over the engine:
    each ticket's (levels row, iters) and the summary record."""
    from glom_tpu_torch.serve.batcher import DynamicBatcher

    with DynamicBatcher(eng) as b:
        tickets = [b.submit(r) for r in reqs]
        outs = [t.result(timeout=timeout) for t in tickets]
        summary = b.summary_record()
    return {"iters": [int(o[1]) for o in outs], "summary": {
        k: v for k, v in summary.items() if isinstance(v, (int, float, str, bool))}}


def serve_mesh(cfg_kw, scfg_kw, arrays, calls=None, batcher=None, fault=None, engines=1,
               leader=None, group_timeout_s=None):
    """InferenceEngine(mesh=) on the leader, run_follower elsewhere. With
    `engines` > 1 the ranks split into that many groups
    (runtime.make_engine_meshes), every engine held by `leader`; each runs
    the same calls. `fault`: {"rank": r, "fail": [(op index, "transient" |
    "kernel")], "body": [(compute call index, kind)], "skip_sample": True}
    makes rank r's fault hook raise before those ops, its MeshWorker.compute
    raise inside those calls, and its `sample` ops skip their collectives.
    `group_timeout_s` sets the groups' collective timeout.
    Returns the leader's results, or a follower's {"ops", "failed"} (or
    {"error"} when its loop raised)."""
    import dataclasses

    import torch.distributed as dist

    from glom_tpu_torch.kernels._build import KernelError
    from glom_tpu_torch.parallel import serve_mesh as sm
    from glom_tpu_torch.parallel.runtime import make_engine_meshes
    from glom_tpu_torch.serve import mesh_follower
    from glom_tpu_torch.serve.engine import InferenceEngine
    from glom_tpu_torch.utils.config import GlomConfig, ServeConfig

    cfg, scfg = GlomConfig(**cfg_kw), ServeConfig(**scfg_kw)
    rank = dist.get_rank()
    saved_timeout = sm.GROUP_TIMEOUT_S
    if group_timeout_s is not None:
        sm.GROUP_TIMEOUT_S = group_timeout_s
    try:
        meshes = make_engine_meshes(scfg, engines, leader=leader)
    finally:
        sm.GROUP_TIMEOUT_S = saved_timeout
    if rank == meshes[0].leader:
        out = []
        for i, mesh in enumerate(meshes):
            eng = InferenceEngine(cfg, dataclasses.replace(scfg), params=_params(arrays),
                                  device="cpu", mesh=mesh, name=f"engine{i}")
            try:
                if batcher is not None:
                    out.append(_batcher_script(eng, batcher))
                else:
                    out.append(_serve_script(eng, calls))
                out[-1] = {"results": out[-1], "ranks": list(mesh.ranks),
                           "wire": dict(eng._mesh.channel.wire),
                           "broken": eng._mesh.broken is not None}
            finally:
                eng.close()
        return out
    fault = fault or {}
    mine = fault.get("rank") == rank

    def raise_at(n, table, what):
        for at, kind in table:
            if mine and n == at:
                raise (KernelError if kind == "kernel" else RuntimeError)(
                    f"rank {rank} fails {what} {at} on purpose")

    seen = [0]

    def hook(h):
        seen[0] += 1
        raise_at(seen[0], fault.get("fail", []), "op")

    computed = [0]
    compute = mesh_follower.MeshWorker.compute

    def failing_compute(self, *args, **kw):
        computed[0] += 1
        raise_at(computed[0], fault.get("body", []), "compute call")
        return compute(self, *args, **kw)

    mesh_follower.MeshWorker.compute = failing_compute
    sample_sites = mesh_follower.MeshWorker.sample_sites
    if mine and fault.get("skip_sample"):
        mesh_follower.MeshWorker.sample_sites = lambda self: []
    try:
        for mesh in meshes:
            if mesh.is_member:
                try:
                    stats = mesh_follower.run_follower(mesh, "cpu", fault_hook=hook)
                except Exception as e:  # noqa: BLE001 - the test reads the error
                    return {"error": type(e).__name__, "message": str(e),
                            "ranks": list(mesh.ranks)}
                return {"ops": stats["ops"], "failed": stats["failed"],
                        "ranks": list(mesh.ranks)}
    finally:
        mesh_follower.MeshWorker.compute = compute
        mesh_follower.MeshWorker.sample_sites = sample_sites
    return None


class _ListWriter:
    def __init__(self):
        self.recs = []

    def write(self, rec):
        self.recs.append(rec)


def _bits(t):
    """The bits of a pool tensor as a signed integer numpy array (a copy: a
    later in-place write must not reach a recorded state)."""
    return t.detach().cpu().clone().view(
        torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


def pool_state(pool, writer, sessions, read_all):
    """A pool's observable state after an op: table, free list, counters,
    record, pins, events (minus the backend state) and, with `read_all`,
    every page's bits (on a sharded pool through a `read` op of the whole
    pool: each page from its owner)."""
    out = {"free": list(pool._free), "record": pool.record(),
           "epoch": pool.epoch(), "read_pins": pool.read_pins(),
           "events": [{k: v for k, v in r.items() if k != "backend_state"}
                      for r in writer.recs],
           "sessions": {sid: (pool.lookup(sid), pool.is_pinned(sid), pool.delta_chain_len(sid),
                              pool.base_refs(sid)) for sid in sessions}}
    writer.recs.clear()
    if read_all and pool.buffer() is not None:
        with pool._leader.lock, pool._lock:
            out["pages"] = _bits(pool._gather_pages(None, list(range(pool.n_pages))))
        out["own"] = _bits(pool.buffer())
    return out


def run_pool_script(pool, writer, script, sessions, dtype, read_all=True):
    """Each (method, args, kwargs) of `script` on the pool (numpy rows as
    tensors in the pool's dtype): [(answer, state after it)]."""
    out = []
    for method, args, kw in script:
        args = [torch.from_numpy(a).to(dtype) if isinstance(a, np.ndarray) else a for a in args]
        got = getattr(pool, method)(*args, **kw)
        if torch.is_tensor(got):
            got = {"bits": _bits(got), "device": got.device.type}
        out.append((got, pool_state(pool, writer, sessions, read_all)))
    return out


def sharded_pool(cfg_kw, scfg_kw, script, sessions, engines=1, leader=None):
    """ShardedColumnPool through `script` on the leader of each engine
    (make_engine_meshes' groups; `leader` holds them all), every follower
    running its engine's ops. The leader returns one run_pool_script list
    an engine; a follower its shard's final bits and first page id."""
    import torch.distributed as dist

    from glom_tpu_torch.models.core import init_glom
    from glom_tpu_torch.parallel.runtime import make_engine_meshes
    from glom_tpu_torch.serve import mesh_follower
    from glom_tpu_torch.serve.engine import InferenceEngine
    from glom_tpu_torch.utils.config import GlomConfig, ServeConfig

    cfg, scfg = GlomConfig(**cfg_kw), ServeConfig(**scfg_kw)
    dtype = torch.bfloat16 if scfg.compute_dtype == "bfloat16" else torch.float32
    meshes = make_engine_meshes(scfg, engines, leader=leader)
    if dist.get_rank() == meshes[0].leader:
        out = []
        params = init_glom(cfg, generator=torch.Generator().manual_seed(0))
        for i, mesh in enumerate(meshes):
            w = _ListWriter()
            # every engine named as glom_tpu's pool names itself
            eng = InferenceEngine(cfg, scfg, params=params, device="cpu", mesh=mesh,
                                  name="engine0", writer=w)
            try:
                w.recs.clear()
                out.append(run_pool_script(eng.pool, w, script, sessions, dtype))
            finally:
                eng.close()
        return out
    for mesh in meshes:
        if mesh.is_member:
            shard = mesh_follower.run_follower(mesh, "cpu")["pool"]
            return {"lo": shard.lo, "bits": None if shard.buffer is None else _bits(shard.buffer)}
    return None


def _scripted_policy(actions, targets):
    """An ElasticPolicy that pops scripted actions (and drain targets)."""
    from glom_tpu_torch.serve import elastic

    class Scripted(elastic.ElasticPolicy):
        def __init__(self):
            super().__init__(min_engines=1, max_engines=8)
            self._actions, self._targets = list(actions), list(targets)

        def decide(self, n_engines):
            if not self._actions:
                return None
            return {"action": self._actions.pop(0), "signal": {"rule": "test"}}

        def pick_drain_target(self, caps):
            return self._targets.pop(0)

    return Scripted()


def elastic_fleet(cfg_kw, scfg_kw, arrays, rounds, wait_s, group_timeout_s):
    """An elastic fleet on the world's rank groups (data 2: three groups at
    world 6), rank 0 holding every engine, driven by a scripted policy:

      engine0 on group 0 and a warm spare (engine1) on group 1; round 0 of
      two sessions; promote the spare; wait `wait_s` (past the groups'
      collective timeout: group 2's followers wait on the store); a cold
      spawn on group 2 (engine2); a spawn past the last group (rolled
      back); drain engine0 (its sessions migrate; demoted into the pool);
      drain engine2 (released: group 2 waits again); round 1 (warm from
      the pages); promote engine0 back; a cold spawn on group 2 (engine3,
      generation 1) whose follower rank 4 fails inside the auto route's
      body, so its group breaks and is retired; a spawn with no waiting
      group (rolled back).

    The leader returns the tickets' rows and iterations, the migrated
    sessions' bits before and after, the stamped records, the autoscaler's
    and the fleet's rollups; a follower its engine lifetimes or its error."""
    import time as _time

    import torch.distributed as dist

    from glom_tpu_torch.parallel import serve_mesh as sm
    from glom_tpu_torch.parallel.runtime import make_engine_meshes
    from glom_tpu_torch.serve import mesh_follower
    from glom_tpu_torch.serve.batcher import DynamicBatcher
    from glom_tpu_torch.serve.elastic import Autoscaler, RankGroupFleet, fleet_store
    from glom_tpu_torch.serve.engine import InferenceEngine
    from glom_tpu_torch.utils.config import GlomConfig, ServeConfig

    cfg, scfg = GlomConfig(**cfg_kw), ServeConfig(**scfg_kw)
    saved = sm.GROUP_TIMEOUT_S
    sm.GROUP_TIMEOUT_S = group_timeout_s
    try:
        meshes = make_engine_meshes(scfg, None, leader=0)
    finally:
        sm.GROUP_TIMEOUT_S = saved
    store, prefix = fleet_store(meshes)
    broke = f"{prefix}/break"
    rank = dist.get_rank()
    if rank != 0:
        compute = mesh_follower.MeshWorker.compute

        def failing_compute(self, *args, **kw):
            if rank == 4 and store.check([broke]):
                raise RuntimeError("rank 4 fails inside the body on purpose")
            return compute(self, *args, **kw)

        mesh_follower.MeshWorker.compute = failing_compute
        try:
            for index, mesh in enumerate(meshes):
                if mesh.is_member:
                    try:
                        lives = mesh_follower.follow_engines(
                            mesh, "cpu", store, mesh_follower.group_prefix(prefix, index))
                    except Exception as e:  # noqa: BLE001 - the test reads the error
                        return {"error": type(e).__name__, "group": index}
                    return {"group": index, "lives": [
                        {"ops": st["ops"], "freed_bytes": st.get("freed_bytes")}
                        for st in lives]}
        finally:
            mesh_follower.MeshWorker.compute = compute
        return None

    w = _ListWriter()
    params = _params(arrays)
    fleet = RankGroupFleet(meshes, store, prefix, writer=w)
    built = []

    def factory():
        eng = fleet.build(lambda mesh: InferenceEngine(
            cfg, scfg, params=params, device="cpu", mesh=mesh, name=f"engine{len(built)}",
            writer=w))
        built.append(eng)
        return eng

    bat = DynamicBatcher(engines=[factory()], writer=w, max_delay_ms=5000.0, max_batch=2)
    sc = Autoscaler(bat, factory, writer=w, warm_pool=1, policy=_scripted_policy(
        ["scale_out"] * 3 + ["scale_in"] * 2 + ["scale_out"] * 3, ["engine0", "engine2"]))
    out = {"tickets": []}
    try:
        sc.fill_warm_pool()
        bat.start()

        def serve(rnd):
            ts = [bat.submit(img, session_id=sid) for img, sid in rnd]
            for t in ts:
                levels, iters, _ = t.result(timeout=120)
                out["tickets"].append({"levels": _np(levels), "iters": int(iters)})

        serve(rounds[0])
        sc.tick()  # promote engine1
        _time.sleep(wait_s)
        sc.tick()  # engine2 on group 2
        sc.tick()  # no group: rolled back
        sessions = [sid for _, sid in rounds[0]]
        out["before"] = {sid: _bits(built[0].pool.read_block(sid)) for sid in sessions}
        sc.tick()  # drain engine0: migrate, demote
        out["after"] = {}
        for sid in sessions:
            e = bat.cache._entries[sid].engine
            out["after"][sid] = (e, _bits(bat.engine_by_name(e).pool.read_block(sid)))
        sc.tick()  # drain engine2: release
        serve(rounds[1])
        sc.tick()  # promote engine0
        sc.tick()  # engine3 on group 2, generation 1
        store.set(broke, "1")
        try:
            built[3].infer(rounds[0][0][0][None].repeat(2, 0))
        except Exception as e:  # noqa: BLE001 - the test reads the error
            out["broken_error"] = type(e).__name__
        built[3].close()  # the fleet retires group 2
        sc.tick()  # no waiting group: rolled back
        out["fleet"] = list(fleet.state)
    finally:
        bat.stop()
        for eng in built:
            eng.close()
        fleet.close()
        out["fleet_closed"] = list(fleet.state)
    out["records"] = [{k: v for k, v in r.items() if isinstance(v, (int, float, str, bool, list,
                                                                    dict)) or v is None}
                      for r in w.recs]
    out["elastic"] = {k: v for k, v in sc.record().items()
                      if isinstance(v, (int, float, str, bool, list)) or v is None}
    return out


def engine_meshes(scfg_kw, n_engines, leader=None):
    """make_engine_meshes' groups as every rank sees them, and
    engine_mesh_for's."""
    from glom_tpu_torch.parallel.runtime import engine_mesh_for, make_engine_meshes
    from glom_tpu_torch.utils.config import ServeConfig

    scfg = ServeConfig(**scfg_kw)
    meshes = make_engine_meshes(scfg, n_engines, leader=leader)
    out = {"groups": [list(m.ranks) for m in meshes], "leaders": [m.leader for m in meshes],
           "member": [m.is_member for m in meshes],
           "index": [None if m.axes is None else (m.axes.data.index, m.axes.seq.index)
                     for m in meshes],
           "for_1": list(engine_mesh_for(scfg, 1).ranks)}
    try:
        make_engine_meshes(scfg, n_engines + 1)
    except ValueError as e:
        out["too_many"] = str(e)
    return out


def serve_cli(argv, out):
    """`python -m glom_tpu_torch.serve` on every rank of the group that is
    up: the exit code, and on rank 0 the stream's records."""
    import json

    import torch.distributed as dist

    from glom_tpu_torch.serve import cli

    rc = cli.main([*argv, "--out", out] if dist.get_rank() == 0 else argv)
    if dist.get_rank() != 0:
        return {"rc": rc}
    with open(out) as fh:
        return {"rc": rc, "records": [json.loads(ln) for ln in fh]}


CASES = {f.__name__: f for f in (fail_on, loss_grads, trainer_run, checkpoint_roundtrip, sp_bodies,
                                 consensus_fns, collective_grads, mesh_facts, glom_mesh,
                                 serve_mesh, sharded_pool, elastic_fleet, engine_meshes,
                                 serve_cli)}
