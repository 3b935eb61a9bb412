"""The distributed training runtime: the SP strategy policy and
DistributedTrainer.

Counterpart of `glom_tpu/parallel/runtime.py`, with the engine meshes
(`make_engine_meshes`, `engine_mesh_for`: one rank group a serving
engine). glom_tpu picks between a GSPMD step and its
fully-manual shard_map step; the port has no GSPMD, so every
DistributedTrainer runs the manual per-rank step (`parallel/manual.py`):
with `use_pallas` through the Hopper kernels, without it through the plain
ops. That includes the EP-style `tp_axis="levels"`, which glom_tpu runs
under GSPMD only (with `use_pallas` it warns and drops its kernels): here
each model rank runs K1 on its bottom_up groups, the same math, and
nothing falls back.

One process per rank. Each rank builds the same global parameters from
the seed, keeps its tensor-parallel shard, draws the same global noise
from its seeded generator, iterates the same seeded global batches and
takes its data band, so the run sees what the single-device Trainer sees
for the same seed. Only rank 0 writes metrics. Where glom_tpu degrades
loudly, the port does too, at the same point and with the resolved value
stamped: `zero_stage >= 1` on a model-sharded mesh runs stage 0, the
quantized reduce without ZeRO runs exact, telemetry "full" runs
"scalars", collective timing "full" runs "sampled" (and any timing mode
runs "off" without the ZeRO step's sites), and `effective_sp_strategy`
falls back to the ring. With timing on, every rank samples the ZeRO
step's sites at each `collective_timing_interval`-th logging boundary
(telemetry/comm_time.py); the writer rank writes the records.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from glom_tpu_torch.data.prefetch import prefetch_to_device
from glom_tpu_torch.models.core import param_leaves, resolve_vjp_path, unflatten_params
from glom_tpu_torch.parallel.halo import make_halo_consensus
from glom_tpu_torch.parallel.manual import (
    check_tp_layout,
    make_manual_train_step,
    make_manual_zero_train_step,
    rank_axes,
    zero_shard_axes,
    zero_shards,
)
from glom_tpu_torch.parallel.mesh import make_mesh
from glom_tpu_torch.parallel.ring import make_ring_consensus
from glom_tpu_torch.parallel.collectives import all_gather, mesh_axis
from glom_tpu_torch.parallel.sharding import (
    denoise_param_specs,
    opt_state_specs,
    shard_leaf,
    spec_axis,
    zero_param_specs,
)
from glom_tpu_torch.parallel.ulysses import make_ulysses_consensus
from glom_tpu_torch.telemetry import counters as tele_counters
from glom_tpu_torch.telemetry import diagnostics as diag
from glom_tpu_torch.telemetry.comm_time import CollectiveTimeSampler, collective_time_records
from glom_tpu_torch.tracing.memory import memory_record, model_live_bytes_total
from glom_tpu_torch.train.objectives import init_denoise
from glom_tpu_torch.train.trainer import (
    TrainState,
    backend_fields,
    default_optimizer,
    fit_loop,
    pinned_grad_accum,
    resolve_quantized_reduce,
    resolve_route_keys,
    resolve_zero_stage,
)
from glom_tpu_torch.utils.checkpoint import STATE_FILE, named_leaves
from glom_tpu_torch.utils.config import GlomConfig, MeshConfig, TrainConfig
from glom_tpu_torch.utils.helpers import halo_supported
from glom_tpu_torch.utils.metrics import comm_volume_model, live_bytes_model, tree_bytes_per_replica

SP_STRATEGIES = ("none", "ring", "ulysses", "halo", "auto")

# glom_tpu's ring-vs-Ulysses crossover, measured on a TPU v5e
# (results/sp_crossover.jsonl): the total FLOPs and collective volume are
# the same; Ulysses' dense full-row similarity ([n, n] f32 per level) wins
# while it stays on-chip and loses past it (ring's [n/seq, n/seq] chunks
# stay small at any n). The table brackets the flip between n = 1024 and
# n = 4096; n^2 * 4 < 16 MB encodes it. Kept as glom_tpu's policy (the
# port's own crossover on the H100 is not measured).
_ULYSSES_SIM_BUDGET = 16 * 1024 * 1024


def ulysses_preferred(n: int) -> bool:
    """True when Ulysses' full-row similarity block is under the budget
    (strictly: the unmeasured n = 2048 point keeps the ring)."""
    return n * n * 4 < _ULYSSES_SIM_BUDGET


def select_sp_strategy(cfg: GlomConfig, seq: int) -> str:
    """Resolve sp_strategy='auto' from the geometry: halo for a local
    radius one-hop shards cover; Ulysses when the levels divide the seq
    axis and the row is short; the ring otherwise."""
    if seq <= 1:
        return "none"
    radius = float(cfg.local_consensus_radius)
    if radius > 0 and halo_supported(seq, cfg.num_patches_side, radius):
        return "halo"
    if cfg.levels % seq == 0 and ulysses_preferred(cfg.num_patches):
        return "ulysses"
    return "ring"


def effective_sp_strategy(cfg: GlomConfig, seq: int, strategy: str) -> str:
    """The strategy a config actually runs (the single source both the
    consensus builders and the records read): 'auto' through the
    selector, and the exactness fallbacks (an impossible halo, an
    indivisible Ulysses -> ring). Downgrading an explicitly requested
    strategy warns; idempotent."""
    if strategy not in SP_STRATEGIES:
        raise ValueError(f"unknown SP strategy {strategy!r}; one of {SP_STRATEGIES}")
    if strategy == "auto":
        return select_sp_strategy(cfg, seq)
    if seq <= 1:
        return "none"
    radius = float(cfg.local_consensus_radius)
    if strategy == "halo" and not halo_supported(seq, cfg.num_patches_side, radius):
        warnings.warn(
            f"halo consensus unsupported (radius={radius}, side={cfg.num_patches_side}, "
            f"seq={seq}); falling back to ring consensus",
            stacklevel=3,
        )
        return "ring"
    if strategy == "ulysses" and cfg.levels % seq != 0:
        warnings.warn(
            f"ulysses needs levels ({cfg.levels}) divisible by the seq axis ({seq}); using "
            "ring (identical result, different collectives)",
            stacklevel=3,
        )
        return "ring"
    return strategy


def make_consensus_fn(mesh, cfg: GlomConfig, strategy: str, axis_name: str = "seq"):
    """The global-view sequence-parallel consensus for `strategy` over the
    mesh axis `axis_name` ([b, n, L, d] -> the same on every rank), or None
    for 'none'."""
    axis = mesh_axis(mesh, axis_name)
    strategy = effective_sp_strategy(cfg, axis.size, strategy)
    if strategy == "none":
        return None
    kw = dict(attend_self=cfg.consensus_self, side=cfg.num_patches_side,
              radius=float(cfg.local_consensus_radius))
    build = {"ring": make_ring_consensus, "ulysses": make_ulysses_consensus,
             "halo": make_halo_consensus}[strategy]
    return build(axis, **kw)


def _replica_groups(scfg, wanted: int, ranks: Optional[list]) -> Optional[list]:
    """The world's ranks (or `ranks`) split into contiguous groups of
    mesh_data x mesh_seq (`mesh.replica_device_groups`), at least `wanted`
    of them; None on the single-device route."""
    from glom_tpu_torch.parallel.mesh import replica_device_groups

    per = scfg.mesh_data * scfg.mesh_seq
    if per == 1:
        return None
    if ranks is None:
        ranks = list(range(dist.get_world_size() if dist.is_initialized() else 1))
    groups = replica_device_groups(list(ranks), per)
    if len(groups) < wanted:
        raise ValueError(
            f"{len(ranks)} ranks host only {len(groups)} {per}-rank engine replicas; "
            f"{wanted} requested"
        )
    return groups


def make_engine_meshes(scfg, n_engines: Optional[int], ranks: Optional[list] = None, *,
                       leader: Optional[int] = None) -> list:
    """One serve mesh (or None for single-device engines) a serving engine:
    the first `n_engines` groups of `_replica_groups` (every group the
    ranks hold for n_engines=None: an elastic fleet's), each with its own
    process groups. `leader` (default: each group's first rank) is the rank
    that holds every engine, for a batcher in one process: a leader outside
    a group dispatches to it without a band. Every rank of the world calls
    it, in the same order."""
    from glom_tpu_torch.parallel.serve_mesh import build_serve_mesh

    if n_engines is not None and n_engines < 1:
        raise ValueError(f"n_engines {n_engines} must be >= 1")
    groups = _replica_groups(scfg, n_engines or 1, ranks)
    if groups is None:
        return [None] * (n_engines or 1)
    if n_engines is None:
        n_engines = len(groups)
    return [build_serve_mesh(g, scfg.mesh_data, scfg.mesh_seq, leader)
            for g in groups[:n_engines]]


def engine_mesh_for(scfg, index: int, ranks: Optional[list] = None, *,
                    leader: Optional[int] = None):
    """The mesh of ONE engine replica by fleet index: the group the static
    partitioning gives index `index` (glom_tpu's elastic scale-out
    resolution). Raises when the ranks have no group `index`; None on the
    single-device route. Every rank calls it."""
    from glom_tpu_torch.parallel.serve_mesh import build_serve_mesh

    if index < 0:
        raise ValueError(f"index {index} must be >= 0")
    groups = _replica_groups(scfg, index + 1, ranks)
    if groups is None:
        return None
    return build_serve_mesh(groups[index], scfg.mesh_data, scfg.mesh_seq, leader)


class _StateDictSink:
    """Stands in for an optimizer while a checkpoint restores into a host
    template: keeps the state dict it is given."""

    def __init__(self):
        self.state_dict_loaded = None

    def load_state_dict(self, sd):
        self.state_dict_loaded = sd


class _GatheredOptimizer:
    """The global optimizer state, for CheckpointManager.save."""

    def __init__(self, sd: dict):
        self._sd = sd

    def state_dict(self) -> dict:
        return self._sd


class DistributedTrainer:
    """Trainer over a (data, seq, model) rank mesh: this process is one
    rank. `devices` (one per global rank; ["cuda:0"] * world shares one
    card) and `backend` ("nccl" or "gloo") are explicit; by default the
    rank runs on cuda:LOCAL_RANK over NCCL. The process group comes from
    the caller (`mesh.initialize_multihost`) or torchrun's environment.
    `sp_strategy` picks how consensus crosses the 'seq' axis."""

    def __init__(
        self,
        cfg: GlomConfig,
        tcfg: TrainConfig,
        mesh_cfg: MeshConfig,
        *,
        sp_strategy: str = "none",
        tp_axis: str = "hidden",
        optimizer=None,
        metrics_writer=None,
        devices=None,
        backend: Optional[str] = None,
        params=None,
    ):
        if tcfg.batch_size % mesh_cfg.data:
            raise ValueError(f"batch {tcfg.batch_size} not divisible by data axis {mesh_cfg.data}")
        accum = pinned_grad_accum(tcfg)
        if accum > 1 and (tcfg.batch_size // accum) % mesh_cfg.data:
            raise ValueError(
                f"microbatch {tcfg.batch_size // accum} (batch {tcfg.batch_size} / grad_accum "
                f"{accum}) not divisible by data axis {mesh_cfg.data}"
            )
        if cfg.num_patches % mesh_cfg.seq:
            raise ValueError(f"patches {cfg.num_patches} not divisible by seq axis {mesh_cfg.seq}")
        check_tp_layout(cfg, mesh_cfg.model, tp_axis)
        self.cfg = cfg
        self.tp_axis = tp_axis
        self.mesh_cfg = mesh_cfg
        self.mesh, self.device = make_mesh(mesh_cfg, devices, backend)
        self.axes = rank_axes(self.mesh)
        self.rank = dist.get_rank()
        self.metrics_writer = metrics_writer if self.rank == 0 else None
        self.sp_strategy = effective_sp_strategy(cfg, mesh_cfg.seq, sp_strategy)
        # No GSPMD route: the manual per-rank step always runs (with
        # use_pallas=False on the plain ops).
        self.use_manual = True

        self.telemetry_level = diag.resolve_telemetry_level(tcfg)
        if self.telemetry_level == "full":
            warnings.warn(
                "telemetry_level='full' has no per-level channel on the manual path; "
                "running 'scalars' (the stamped level is the resolved one)",
                stacklevel=2,
            )
            self.telemetry_level = "scalars"
            tcfg = dataclasses.replace(tcfg, telemetry_level="scalars")
        self.tcfg = tcfg

        self.grad_accum = accum
        if mesh_cfg.seq > 1:
            self.vjp_path = "scan_sharded"
        else:
            k, itemsize = resolve_route_keys(cfg, tcfg)
            self.vjp_path = resolve_vjp_path(
                cfg, tcfg.batch_size // accum // mesh_cfg.data, k, remat=tcfg.remat,
                use_pallas=tcfg.use_pallas, itemsize=itemsize, scan_only=mesh_cfg.model > 1,
                device=self.device,
            )

        self.zero_stage = resolve_zero_stage(tcfg, mesh_cfg.data)
        self.quantized_reduce = resolve_quantized_reduce(tcfg, mesh_cfg.data)
        if self.zero_stage >= 1 and mesh_cfg.model > 1:
            warnings.warn(
                "zero_stage >= 1 on the manual path supports model == 1 only; running this "
                "mesh with zero_stage=0 (replicated optimizer state)",
                stacklevel=2,
            )
            self.zero_stage = 0
        if self.quantized_reduce and self.zero_stage == 0:
            warnings.warn(
                "quantized_reduce on the manual path requires zero_stage >= 1 (the explicit "
                "reduce-scatter carries the emulation hook); running with exact f32 reduction",
                stacklevel=2,
            )
            self.quantized_reduce = False

        # Per-collective wall time, resolved once and stamped (glom_tpu's
        # gate): only the ZeRO step (zero_stage >= 1) has registered sites;
        # "full" degrades to "sampled" with glom_tpu's warning, and anywhere
        # else the mode resolves to "off" with its warning.
        self._timing_sites_reachable = self.zero_stage >= 1
        if self._timing_sites_reachable:
            self.collective_timing = tele_counters.resolve_collective_timing(
                tcfg.collective_timing, supports_full=False, path="the manual trainer")
        else:
            tele_counters.resolve_collective_timing(tcfg.collective_timing)  # validate
            if tcfg.collective_timing != "off":
                warnings.warn(
                    "collective_timing has no registered sites on this route (GSPMD, or "
                    "manual zero_stage 0) — resolving 'off'; the stamped mode is the "
                    "resolved one",
                    stacklevel=2,
                )
            self.collective_timing = "off"
        self.collective_sampler = None

        # Every rank builds the same global parameters from the seed and
        # keeps its tensor-parallel shard.
        gparams = params if params is not None else init_denoise(
            cfg, generator=torch.Generator().manual_seed(tcfg.seed))
        self._pspecs = denoise_param_specs(tp_axis)
        self._coords = {"model": (self.axes.model.index, self.axes.model.size)}
        leaves = [
            shard_leaf(t.detach(), self._pspecs[name], self._coords).to(self.device).clone()
            .requires_grad_()
            for name, t in named_leaves(gparams)
        ]
        self._global_shapes = {name: tuple(t.shape) for name, t in named_leaves(gparams)}
        rank_params = unflatten_params(gparams, leaves)
        self._optimizer_factory = optimizer if optimizer is not None else default_optimizer(tcfg)
        if self.zero_stage >= 1:
            self._zpspecs = zero_param_specs(gparams, mesh_cfg.data, tp_axis)
            self._shard_axes = zero_shard_axes(rank_params, self._zpspecs)
            opt = self._optimizer_factory(zero_shards(rank_params, self._shard_axes,
                                                      self.axes.data))
        else:
            self._zpspecs = None
            self._shard_axes = [-1] * len(leaves)
            opt = self._optimizer_factory(rank_params)
        self.state = TrainState(params=rank_params, optimizer=opt, step=0)
        self.optimizer = self._optimizer_factory
        self.generator = torch.Generator(device=self.device).manual_seed(tcfg.seed)

        def build(with_grad_norm):
            if self.zero_stage >= 1:
                return make_manual_zero_train_step(
                    self.mesh, cfg, tcfg, zero_stage=self.zero_stage, zero_pspecs=self._zpspecs,
                    sp_strategy=self.sp_strategy, with_grad_norm=with_grad_norm,
                    quantized_reduce=self.quantized_reduce, level=self.telemetry_level,
                )
            return make_manual_train_step(
                self.mesh, cfg, tcfg, sp_strategy=self.sp_strategy,
                with_grad_norm=with_grad_norm, level=self.telemetry_level, tp_axis=tp_axis,
            )

        self._step = build(True)
        self._step_fast = build(False)
        self._compile_tracker: set = set()
        self.in_step = False
        self._static_record = self._analytic_record(gparams)
        # The measured collective counters: the ZeRO step's named sites
        # counted over its first real step (collective shapes do not change
        # between steps) and stamped from then on, with the drift against
        # the model; with timing on, that count's site registry builds the
        # sampler. glom_tpu counts one abstract trace of the step, under
        # the same gate.
        counting = self.telemetry_level != "off" or self.collective_timing != "off"
        self._counters = (tele_counters.CollectiveCounters()
                          if counting and self._timing_sites_reachable else None)
        self._model_live_bytes = model_live_bytes_total(self._static_record)

    # -- the static record -----------------------------------------------------

    def _analytic_record(self, gparams) -> dict:
        """glom_tpu's static record: the resolved stage and flags, the
        per-replica live-bytes model and the gradient / update path's
        comm model, from the global shapes and this mesh's specs."""
        axis_sizes = dict(zip(self.mesh_cfg.axis_names, self.mesh_cfg.shape))
        meta = {name: torch.empty(t.shape, dtype=t.dtype, device="meta")
                for name, t in named_leaves(gparams)}
        moment_specs = self._zpspecs if self.zero_stage >= 1 else self._pspecs
        # torch's Adam keeps two moments and a float32 step count a leaf.
        opt_meta = {name: {"exp_avg": t, "exp_avg_sq": t,
                           "step": torch.empty((), dtype=torch.float32, device="meta")}
                    for name, t in meta.items()}
        grad_specs = self._zpspecs if self.zero_stage >= 2 else self._pspecs
        mem = live_bytes_model(meta, opt_meta, axis_sizes=axis_sizes, param_specs=self._pspecs,
                               opt_specs=opt_state_specs(moment_specs), grad_specs=grad_specs)
        # The DP gradient's payload: what each replica contributes, with the
        # model sharding divided out and 'data' not.
        wire_bytes = tree_bytes_per_replica(meta, self._pspecs, axis_sizes)
        return {
            "zero_stage": self.zero_stage,
            "quantized_reduce": self.quantized_reduce,
            "telemetry_level": self.telemetry_level,
            "collective_timing": self.collective_timing,
            **mem,
            **comm_volume_model(wire_bytes, wire_bytes, self.mesh_cfg.data, self.zero_stage,
                                quantized=self.quantized_reduce, grad_accum=self.grad_accum),
        }

    # -- steps -------------------------------------------------------------------

    def _run(self, fn, batch) -> dict:
        img = torch.as_tensor(
            np.asarray(batch) if not torch.is_tensor(batch) else batch,
            dtype=torch.float32, device=self.device,
        )
        counting = self._counters
        self.in_step = True
        try:
            if counting is not None:
                with tele_counters.recording(counting):
                    self.state, metrics = fn(self.state, img, self.generator)
                measured = counting.totals()
                self._static_record.update(measured)
                self._static_record.update(tele_counters.comm_drift(measured,
                                                                    self._static_record))
                self._counters = None
                if self.collective_timing != "off":
                    self.collective_sampler = CollectiveTimeSampler(
                        self.axes, counting.sites,
                        interval=self.tcfg.collective_timing_interval, device=self.device)
            else:
                self.state, metrics = fn(self.state, img, self.generator)
        finally:
            self.in_step = False
        return self._annotate(metrics)

    def _annotate(self, metrics: dict) -> dict:
        metrics = dict(metrics)
        metrics["sp_strategy"] = self.sp_strategy
        metrics["vjp_path"] = self.vjp_path
        metrics["grad_accum"] = self.grad_accum
        metrics.update(self._static_record)
        metrics.update(backend_fields())
        return metrics

    def step(self, batch) -> dict:
        """One update from a GLOBAL batch [B, c, H, W] (this rank takes its
        data band)."""
        return self._run(self._step, batch)

    def step_fast(self, batch) -> dict:
        """The step without the grad-norm sweep."""
        return self._run(self._step_fast, batch)

    def _memory_record(self) -> dict:
        """The card's allocator watermarks beside the live-bytes model's
        per-replica total (tracing/memory.py); {} off the card."""
        return memory_record(self._model_live_bytes, self.device)

    def collective_time_records(self, *, force: bool = False) -> list:
        """Stamped "collective_time" rows from the sampled harness: empty
        with timing off, before the first step has registered the sites, and
        between sampling intervals unless `force`. A sample is a collective:
        every rank calls this at the same boundary (fit() does, at each
        logging step); only the writer rank writes what it returns."""
        if self.collective_sampler is None:
            return []
        path = f"train-zero{self.zero_stage}"
        if force:
            return collective_time_records(self.collective_sampler.sample(), path=path,
                                           mode="sampled")
        return self.collective_sampler.maybe_sample(path=path)

    def fit(self, data: Iterator, num_steps: int, *, log_every: int = 10,
            prefetch: int = 0, trace_capture=None) -> list:
        """Run `num_steps` updates over global batches from `data` (every
        rank the same stream). prefetch > 0 stages that many batches ahead
        on this rank's device."""
        if prefetch > 0:
            data = prefetch_to_device(data, size=prefetch, device=self.device)
        return fit_loop(
            self.step, iter(data), num_steps, log_every=log_every,
            metrics_writer=self.metrics_writer, step_fast=self.step_fast,
            compile_tracker=self._compile_tracker, trace_capture=trace_capture,
            memory_probe=self._memory_record,
            aux_records_probe=(self.collective_time_records
                               if self.collective_timing != "off" else None),
        )

    # -- the global state: checkpoints ---------------------------------------------

    def _leaf_dims(self):
        """(name, model dim or -1, ZeRO dim or -1) for each leaf."""
        return [(name, spec_axis(self._pspecs[name], "model"), ax)
                for (name, _), ax in zip(named_leaves(self.state.params), self._shard_axes)]

    def _gather(self, t: torch.Tensor, model_dim: int, zero_dim: int) -> torch.Tensor:
        if zero_dim >= 0 and t.dim():
            t = all_gather(t, self.axes.data, zero_dim)
        if model_dim >= 0 and t.dim():
            t = all_gather(t, self.axes.model, model_dim)
        return t

    def global_state(self) -> TrainState:
        """The global train state on every rank (a collective: every rank
        calls it): whole parameters and the optimizer state in the
        single-device optimizer's layout, so a checkpoint of it restores
        into any mesh, any ZeRO stage, or the single-device Trainer."""
        dims = self._leaf_dims()
        with torch.no_grad():
            params = unflatten_params(self.state.params, [
                self._gather(t.detach(), md, -1)
                for t, (_, md, _) in zip(param_leaves(self.state.params), dims)])
            sd = self.state.optimizer.state_dict()
            state = {i: {key: self._gather(v, md, zd) if torch.is_tensor(v) else v
                         for key, v in s.items()}
                     for i, s in sd["state"].items() for (_, md, zd) in [dims[i]]}
        return TrainState(params=params, optimizer=_GatheredOptimizer(
            {"state": state, "param_groups": sd["param_groups"]}), step=self.state.step)

    def save_checkpoint(self, manager, step: int) -> bool:
        """Every rank calls it (the ZeRO moments and TP shards are
        gathered); rank 0 passes its CheckpointManager and writes, the
        others pass None. Returns what the manager's save returned on rank
        0, False elsewhere."""
        view = self.global_state()
        if manager is None:
            return False
        return manager.save(step, view, generator=self.generator)

    def load_global_state(self, payload: dict) -> None:
        """Shard a global payload (CheckpointManager's layout) into this
        rank's parameters, optimizer state and generator."""
        saved = payload["params"]
        got = {name: tuple(t.shape) for name, t in saved.items()}
        if got != self._global_shapes:
            raise ValueError(f"checkpoint params {got} do not match the trainer's "
                             f"{self._global_shapes}")
        dims = self._leaf_dims()
        data = (self.axes.data.index, self.axes.data.size)
        leaves = param_leaves(self.state.params)
        with torch.no_grad():
            for t, (name, _, _) in zip(leaves, dims):
                t.copy_(shard_leaf(saved[name], self._pspecs[name], self._coords))
            opt = self.state.optimizer
            if self.zero_stage >= 1:
                for s, t, ax in zip(opt.param_groups[0]["params"], leaves, self._shard_axes):
                    s.copy_(t.narrow(ax, data[0] * (t.shape[ax] // data[1]),
                                     t.shape[ax] // data[1]) if ax >= 0 else t)

        def local(v, name, zd):
            if not torch.is_tensor(v) or not v.dim():
                return v
            v = shard_leaf(v, self._pspecs[name], self._coords)
            if zd >= 0:
                v = v.narrow(zd, data[0] * (v.shape[zd] // data[1]), v.shape[zd] // data[1])
            return v.contiguous()

        sd = payload["optimizer"]
        opt.load_state_dict({
            "state": {int(i): {key: local(v, dims[int(i)][0], dims[int(i)][2])
                               for key, v in s.items()} for i, s in sd["state"].items()},
            "param_groups": sd["param_groups"],
        })
        if payload.get("generator") is not None:
            self.generator.set_state(payload["generator"].cpu())
        self.state = self.state._replace(step=int(payload["step"]))

    def restore_checkpoint(self, directory, manager=None) -> Optional[int]:
        """Restore the newest valid step on every rank (a collective): rank
        0's manager picks it (verification, the torn-step walk and
        quarantine), every rank loads that step's file and takes its shard.
        Returns the step, or None on every rank when rank 0 finds no valid
        step."""
        chosen = [None]
        if manager is not None and manager.latest_step() is not None:
            template = TrainState(
                params=unflatten_params(self.state.params, [
                    torch.zeros(self._global_shapes[name])
                    for name, _ in named_leaves(self.state.params)]),
                optimizer=_StateDictSink(), step=0)
            chosen[0], _ = manager.restore(state=template)
        dist.broadcast_object_list(chosen, src=0)
        if chosen[0] is None:
            return None
        payload = torch.load(Path(directory) / str(int(chosen[0])) / STATE_FILE,
                             map_location="cpu", weights_only=True)
        self.load_global_state(payload)
        return int(chosen[0])
