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


def trainer_run(shape, sp, cfg_kw, tcfg_kw, arrays, steps, data_seed, log_every=1):
    """DistributedTrainer.fit over shapes_dataset(seed=data_seed): the
    records, the final global params and optimizer state, and the bytes of
    this rank's optimizer state."""
    import warnings

    from glom_tpu_torch.data import shapes_dataset
    from glom_tpu_torch.parallel import DistributedTrainer
    from glom_tpu_torch.utils.checkpoint import named_leaves
    from glom_tpu_torch.utils.config import GlomConfig, MeshConfig, TrainConfig

    cfg, tcfg = GlomConfig(**cfg_kw), TrainConfig(**tcfg_kw)
    world = int(np.prod(shape))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr = DistributedTrainer(cfg, tcfg, MeshConfig(*shape), sp_strategy=sp,
                                devices=["cpu"] * world, backend="gloo",
                                params=None if arrays is None else _params(arrays))
    hist = tr.fit(shapes_dataset(tcfg.batch_size, cfg.image_size, seed=data_seed), steps,
                  log_every=log_every)
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


CASES = {f.__name__: f for f in (fail_on, loss_grads, trainer_run, checkpoint_roundtrip, sp_bodies,
                                 consensus_fns, collective_grads, mesh_facts)}
