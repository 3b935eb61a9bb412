#!/usr/bin/env python3
"""Drive the PyTorch port (glom_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from glom_tpu_torch/csrc/ (one nvcc per source, in
parallel, into build/glom_tpu_torch/), holds each kernel -- the K1 and K2
forwards and their backwards, the whole-loop VJP's modes of them (the
pre-only K1 forward, the accumulating K1 backward, the K2 backward's
three-stream combine), the banded ragged consensus (K4), the K2 forward's
saved attention output and the one-sweep K2 backward at the long-row shape
[6, 2, 4096, 512] (twice, bit for bit), and the combined td || bu K1 grid
(bit for bit the two split launches) -- against its plain PyTorch version
(the bf16 K1 forward, a TMA + wgmma GEMM, also at edge shapes of its
128-row, 128-column tiles; the bf16 K1 backward from the saved pre, three
launches of the same GEMM with transposed operand orders, and its WMMA
recompute path without one; the bf16 K2 forward, TMA + wgmma attention, also
at edge shapes of its 64-row, 64-key tiles; the bf16 K2 backward, a pre-pass
and TMA + wgmma dq, dv and dk passes, in its pair, combine and one-sweep
forms; K4 in both instances, the bf16
"wgmma" one at pages of 64 and 128 on flat and peaked inputs, "fma" at
pages of 32, every row span and the unused trailing pages), times both
(with K2's and K4's host time a call and their k pre-pass's share; and,
where one PyTorch call
computes the same function, that call: scaled_dot_product_attention for
K2's attention and K4, torch.baddbmm for the pre-only K1; for K1's forward
the three calls baddbmm, tanh GELU, baddbmm as `library_seq_ms`, and
autograd through them for K1's backward, which is also timed by kernel
with its host time a call and the path it took; K2's backward by kernel, with its
pre-pass share and SDPA's backward), then
drives the port's main paths on the flagship
model (ImageNet-224, patch 14, L = 6, d = 512, bf16, random weights from a
seed), each with every launch count set to 0 just before it and read just
after:

  * serving: every bucket through InferenceEngine, with the launch counts
    of that run, its float32 parity with the plain path and the bf16
    answer's distance from that path;
  * training at batch 8, the flagship's default, on the whole-loop VJP
    (its K1 launches over the combined td || bu grid, one a phase):
    six Adam steps of the denoising trainer on synthetic shapes images,
    through both of Trainer.fit's step variants (with and without the grad
    norm), with the route and exact launch counts per step, the step time
    and a profiled step; the same with remat (three steps, and one batch's
    gradients equal to the non-remat loop's bit for bit); the step on the
    loop and on the per-iteration route in turns, and the loop's forward
    and backward alone on both routes at batches 1 to 8; the float32 loss
    and gradients against the plain route;
  * training at batch 4 on the per-iteration route (three steps, exact
    launch counts), and its float32 gradients at batch 2;
  * long global rows: the flagship widths at 896 px (side 64, n = 4096),
    batch 2, through Trainer.fit on the per-iteration route, whose K2
    forward saves cons and whose K2 backward is the one-sweep (exact
    launches per step, a profiled step); its float32 loss and gradients at
    batch 1 against the plain route; and the loop's forward and backward
    (two-pass combine) against the per-iteration route's in turns;
  * ragged serving (before training in the script): mixed-resolution rows
    (224/168/112/56 px) packed page-aligned at 8, 24 and 32 pages through
    InferenceEngine.infer_ragged, K1 twice and the banded consensus kernel
    (K4) once per iteration, with exact launch counts per dispatch, its
    float32 parity with the plain banded route and with the bucket route,
    and its early-exit form (bit for bit the fixed route at threshold 0);
  * early-exit serving on the bucket route (iters="auto": K1 and the plain
    consensus), timed at threshold 0 against the fixed loop of the same
    step to show the per-iteration host read of the exit flag.
  * the serving device layer, with a page pool of 96 pages: a paged warm
    bucket-8 dispatch (levels0 gathered from the pool) against the
    host-carried one, bit for bit, with no levels0 bytes from the host and
    the fixed route's launches, both timed in turns, and the peak memory;
    the paged route's float32 parity with the plain path; 32 ragged pages
    from the pool, mixed cold and warm, bit for bit their levels0 form;
    the incremental route's hold frame (exactly min_iters), a perturbed
    frame, and threshold 0 bit for bit the paged tiered dispatch; the same
    write-backs into a copy-on-write and an aliasing pool (identical bytes,
    the analytic bytes moved, one fallback under a read pin, ms a
    write-back); Glom(iters="auto"); a dispatch fault that the retry
    recovers bit for bit and a KernelError that it does not retry; and the
    release of an engine's pool.
  * the serving host stack (`serve_host_stack`): DynamicBatcher over the
    engines. The fixed route behind the batcher (closed-loop clients for
    the ceiling, then open-loop arrivals at fractions of it: request
    latency p50/p95/p99, requests/s, dispatches per bucket, exact launches
    per dispatch, every ticket bit for bit an engine.infer replay of its
    padded bucket, an f32 engine against the plain path); the auto route
    with quorum exit and continuation hops against the batch-level exit on
    heterogeneous traffic, in turns (iterations by tier, hops, the
    continuations' levels0 bytes; threshold 0 bit for bit the fixed loop);
    session streams warm from the page pool (48 hits, no levels0 bytes on
    warm rows, the cache within its budget); two engines on the card, one
    failing, failing over, dying, on probation and rejoining (its cache
    entries dropped before any requeue); ragged admission of 224/168/112/
    56-px requests bit for bit `infer_ragged`; and `python -m
    glom_tpu_torch.serve` at the imagenet224-dp8 preset with a killed
    engine, its stream linted. Each kernel's launches there ride the
    kernels line as `batcher_launches`.
  * the elastic fleet (`serve_elastic`): flagship bucket engines with
    96-page pools behind DynamicBatcher and the Autoscaler (one engine, up
    to three, one warm spare), under an open-loop ramp (low, a spike above
    one engine's measured ceiling, low) with streaming sessions: a spare
    promoted, an injected spawn fault rolled back, a cold spawn, a
    scale-in demoting to the pool and one draining and releasing, the
    drained engines' session pages migrated to a sibling bit for bit.
    Every request served once, each ticket bit for bit its bucket's
    engine.infer replay, each decision's chain in order under its
    decision_id, no dispatch on a replica before its warm-up and
    registration, each release returning its pool, exact launches over
    warm-ups and dispatches, the audit clean; fleet size over time,
    requests/s and p50/p99 by fleet size, decision-to-admission and
    decision-to-release times, migration pages, bytes and ms, the MiB each
    release freed, and K2's host time a call by fleet size. Then `python -m
    glom_tpu_torch.serve --elastic` with a warm pool and the forecaster,
    its stream linted and audited. Each kernel's launches there ride the
    kernels line as `elastic_launches`.
  * the training CLI (`python -m glom_tpu_torch.train.cli`, in process)
    at the imagenet224-dp8 preset, batch 64, on the loop: 4 steps on .npy
    shards with a checkpoint every 2, then --resume to 6, with the exact
    launches of each run, finite records, verified manifests, the step
    p50 and MFU from the records, the checkpoints' save times and sizes
    and the peak device memory; a restored step at batch 8 bit for bit
    the uninterrupted one; fit_supervised with a fault at step 3 bit for
    bit the clean run, with its recovery events; temporal rollouts (3
    frames, batch 2) fused against plain in f32, the bf16 ms a frame; and
    the peak device memory of one loop step at batch 128.
  * training across ranks (`dist_phases`): DistributedTrainer in an NCCL
    group of one, 3 bf16 steps on the loop at batch 8, losses and
    parameters bit for bit the single-device Trainer's with its launches
    (`dist_world1_nccl`); then ranks spawned on the card over gloo (NCCL
    refuses two ranks on one card): DP over 2 ranks at global batch 16
    (the f32 all-reduced gradients against the single batch-16 step's,
    3 bf16 steps against the single-device losses, the loop's launches a
    rank a step; `dist_dp2`), ZeRO 0 / 1 / 2 and 2 with the quantized
    reduce (f32 parameters against stage 0, each rank's moments and the
    counted wire bytes against the layout's leaf-by-leaf schedule;
    `dist_zero`), the ring and Ulysses at seq 2 and halo at seq 4
    (imagenet256-local) with f32 gradients against the single device, K1
    only (`dist_sp`), hidden TP at model 2 (K1 at f = 1024, K2 whole;
    `dist_tp2`), and `python -m torch.distributed.run -m
    glom_tpu_torch.train.cli --distributed` with two ranks on the card (a
    resume, the stream linted, `--check-parity`;
    `train_cli_distributed`). Each kernel's launches there ride the
    kernels line as `dist_launches`.
  * sharded execution's last pieces (`sharded_phases`): tp_axis="levels" at
    model 2 (bottom_up's 3 groups a rank at full f, the f32 gradients
    against the single device, bf16 losses, exact launches, the K1 calls'
    groups and widths, the counted group gathers against the design's
    bytes; `dist_tp_levels`, its launches in `dist_launches`); a data-2
    sharded engine's 96-page pool with delta streams driven with a
    single-device pool by the same rows (every answer, table, record,
    event and read-back bit for bit, a base shared by content hash, a chain
    folded, defrag on a non-delta sharded pool, one warm dispatch from the
    delta pages with no levels0 bytes; `serve_mesh_pool`, its launches in
    `mesh_launches`); and `python -m glom_tpu_torch.serve --mesh-data 2
    --elastic` on six ranks (three rank groups: a warm spare promoted, a
    cold spawn, drains with migration checked page for page, each
    release's freed bytes on every rank; `serve_cli_mesh_elastic`).
  * telemetry's measuring half (`telemetry_phases`): the batch-8 loop at
    telemetry_level "full" (the per-level agreement on every record, in
    [-1, 1], and in f32 against level_agreement of the plain route's final
    state; every record's hbm_* fields against torch.cuda.memory_allocated
    at the read; exactly the loop's launches; `train_telemetry_full`); ZeRO
    stage 1 on 2 gloo ranks with collective timing off, sampled and full
    (degraded to sampled, with its warning): every site's sampled wall_ms
    and bytes, each row's bytes the counted bytes, losses and launches bit
    for bit the off run's (`dist_collective_timing`); three data-2 engines
    (bucket 8, T = 12) timed off, sampled every 2nd dispatch and full, in
    turns: dispatch p50s, answers bit for bit the off arm's, the full log's
    calls from both ranks, 24 K1 a rank a dispatch (`serve_mesh_timing`);
    the training CLI in process with --trace-steps 2:3 and with
    --profile-dir (one Chrome trace each naming K1's and K2's kernels, the
    note records, hbm_* on every record; `train_cli_trace`); the CLI with
    --watchdog-interval 1 (unknown -> up, "up" on the records), then an
    injected probe fault driving the state down, a dispatch through the
    engine's RetryPolicy failing after one attempt, and the state back up
    (`watchdog`). Each kernel's launches there ride the kernels line as
    `telemetry_launches`.
  * resilience (`resilience_phases`), every worker the training CLI in a
    subprocess at imagenet224-dp8 on the loop, each step's route and
    launches counted: `python -m glom_tpu_torch.resilience --scenario
    preempt-train` three times, the SIGTERM 0, 0.35 and 0.7 s after the
    2nd committed checkpoint (batch 8, 6 steps, a checkpoint a step), and
    once more with the worker's own SIGTERM inside its 4th optimizer step
    (the save waits for the step's end): each grace save ok, its ms and
    MiB, the resumed run's losses and final params, Adam state and noise
    generator bit for bit an uninterrupted run's (`preempt_train`); `--scenario preempt-pod`, two CLI hosts on the
    card over a shared directory: one common step committed at the min of
    the proposals, both hosts resumed from it, the barrier round's ms from
    the stamped phases (`preempt_pod`); the CLI's `--distributed
    --supervise 1` on 2 gloo ranks (global batch 16) under
    torch.distributed.run, clean, with rank 1 failing at a checkpoint-span
    boundary and inside an optimizer step under a 10 s group timeout: both
    faults resumed from the common step and ending bit for bit on the clean
    run (`dist_gang`); `--scenario kill-serve` and `ramp-serve` through the
    serve CLI (`chaos_serve`). Each kernel's launches there ride the kernels
    line as `resilience_launches`.

It prints one JSON line per phase. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed phase raises, and the script exits nonzero without that line.
It also exits nonzero, printing no result, when no CUDA device is present.
Bounds use the H100 SXM's published peaks: 989 TFLOP/s bf16 tensor, 67
TFLOP/s f32 (K4's "fma" instance computes in f32), 3.35 TB/s HBM.
"""

from __future__ import annotations

import collections
import json
from functools import partial
import math
import statistics
import subprocess
import sys
import time

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
SEED = 0
# Max abs gap allowed between the bf16 served levels and the plain f32
# path at bucket 2 (the flagship, T = 12, seed-0 weights).
BF16_SERVE_ATOL = 1e-2
# Backward bars: max abs error over max |want|, per output, about 4x the
# largest ratio seen on the card with these inputs (one bf16 ulp is 2^-8
# to 2^-7 of a value; weight grads are sums over M = 2048 rows).
BWD_BARS = {"K1": {"bf16": 2.5e-2, "f32": 8e-6}, "K2": {"bf16": 1.8e-2, "f32": 4e-5}}
# The fused f32 training loss and gradients against the plain f32 route at
# batch 2 (the per-iteration route) and at batch 8 (the whole-loop VJP):
# max abs error over max |want| per parameter leaf.
TRAIN_F32_BAR = 8e-6
LOOP_F32_BAR = 9e-6  # about 4x the 2.27e-6 seen at batch 8 (to_pixels.w)
# The one-sweep K2 backward at [6, 2, 4096, 512]: max abs error over max
# |want| of dlevels, and in bf16 the share of elements that differ at all.
ONESWEEP_BARS = {"bf16": 1.8e-2, "f32": 1.8e-6}  # about 4x the 4.6e-3 and 4.5e-7 seen
ONESWEEP_MISMATCH_BAR = 1.2e-2  # about 4x the 0.30 % seen
# The long-row f32 training loss and gradients (batch 1, n = 4096) against
# the plain route: about 4x the 3.41e-5 seen (to_pixels.w).
LONGROW_F32_BAR = 1.4e-4
# K4's "wgmma" instance on peaked inputs (rank 4, rms 8) against the f32
# plain version: p's bf16 rounding needs atol up to 0.110 at rtol 1e-2
# there (kernel_probe.py k4, seeds 0-7; tests/test_torch_port_gpu.py's
# K4_PEAKED_WGMMA_BARS). Flat inputs and "fma" keep K2's bars.
K4_PEAKED_WGMMA_BARS = (1e-2, 0.25)
# Batch-8 steps timed per route in the loop / per-iteration A/B.
AB_ROUNDS = 10
# Dispatches per ragged ladder entry and per route in the serve phases.
RAGGED_DISPATCHES = 5
# Timed dispatches per bucket, and rounds per arm of the exit-test A/B, on
# the bucket auto route (after AUTO_WARM untimed ones).
AUTO_DISPATCHES = 15
AUTO_WARM = 2
TRAIN_STEPS = 6
# Long-row training steps (the first untimed, then three timed step_fast
# calls and one full step) and loop / per-iteration rounds at n = 4096.
LONGROW_STEPS = 5
LONGROW_AB_ROUNDS = 3
# Trainer.fit runs the full step (with the grad norm) every TRAIN_LOG_EVERY
# steps and step_fast on the others: both variants run and are counted.
TRAIN_LOG_EVERY = 3
# The training CLI's phase: the flagship preset's batch, and the images
# written to .npy shards for it (two shards of one batch each).
CLI_BATCH = 64
CLI_IMAGES = 128
# The restart supervisor's run, and the temporal rollout's frames and timed
# bf16 rounds.
SUPERVISED_STEPS = 6
TEMPORAL_FRAMES = 3
TEMPORAL_ROUNDS = 5
# The serving device layer: the page pool's pages (384 KiB each at the
# flagship in bf16, 36 MiB), the dispatches per arm of the paged / host-carry
# and the ragged pool / levels0 turns, the incremental route's min_iters
# (the hold frame pays exactly that), and the timed write-backs per pool.
POOL_PAGES = 96
PAGED_DISPATCHES = 20
INC_MIN_ITERS = 2
WRITEBACK_ROUNDS = 20
# The serving host stack (DynamicBatcher over the engine): closed-loop
# clients and requests each for the ceiling, open-loop requests per load
# (as fractions of that ceiling), the two-tier mix (requests, the hard
# share at 100x scale, passes per arm in turns), the stream's sessions and
# frames, and the serve CLI's ramp.
BATCHER_CLIENTS = 8
BATCHER_PER_CLIENT = 16
OPEN_LOOP_REQUESTS = 96
OPEN_LOOP_LOADS = (0.5, 0.9)
TWO_TIER_REQUESTS = 32
TWO_TIER_HARD = 0.25
TWO_TIER_PASSES = 2
STREAM_SESSIONS = 16
STREAM_FRAMES = 4
CLI_RAMP = "8x2,32x0,8x2"
# The elastic fleet (serve_elastic): max engines, the warm pool, the policy
# (short times keep the phase within a minute; a p99 rule over a short
# window drives the scale-outs through the spike, set above the latency a
# drain's flush adds to the requests waiting on the drained engine, which
# at 100 ms re-triggered a scale-out a cooldown after each drain on the
# card; headroom above the high
# water for the dwell the scale-ins; the low water sits under any headroom
# a 4096-deep queue shows, the high water under the headroom of a pool
# holding all the cache's sessions: 12 of 4 pages in 96 is 0.5), the
# open-loop ramp (low at a fraction of one engine's measured ceiling; a
# spike of a fixed count of requests over a fixed time, 2000 requests/s,
# above one engine's closed-loop ceiling on an H100 at 700 W (377-902
# requests/s over the readings this phase took), so a low reading of the
# ceiling cannot leave the spike under it; low again
# until the fleet is back at one engine or the settle ends), the
# streaming clients (each a session of ELASTIC_FRAMES frames, then a
# new one, so sessions land on every replica) and the cache's sessions,
# and the elastic serve CLI's ramp.
ELASTIC_MAX = 3
ELASTIC_WARM_POOL = 1
ELASTIC_QUEUE = 4096
ELASTIC_POLICY = dict(elastic_dwell_s=0.5, elastic_cooldown_s=1.0, elastic_interval_s=0.1,
                      elastic_window_s=2.0, elastic_low_water=0.05, elastic_high_water=0.45,
                      elastic_p99_ms=300.0)
ELASTIC_LOW = (0.3, 1.5)  # (fraction of the ceiling, seconds)
ELASTIC_SPIKE = (800, 0.4)  # (requests, seconds)
ELASTIC_TAIL = 0.1  # the last phase's fraction, until settled
ELASTIC_SETTLE_S = 30.0
ELASTIC_CLIENTS = 4
ELASTIC_FRAMES = 3
ELASTIC_SESSIONS = 12
CLI_ELASTIC_RAMP = "8x20,240x0,40x20"


# -- training across ranks (dist_* phases) -------------------------------------
# Ranks are spawned processes with a file:// store, every one on cuda:0 over
# gloo (NCCL refuses two ranks on one card; its route runs at world 1). The
# kernels are built by the parent before any rank starts. A rank's failure
# fails its phase.
DIST_HALO_CFG = dict(dim=512, levels=6, image_size=256, patch_size=8, local_consensus_radius=7)
DIST_DP_BATCH = 16  # global; 8 a rank, on the loop
DIST_SP_BATCH = 2
DIST_ZERO_BATCH = 4  # f32 steps: 2 a rank
DIST_STEPS = 3
DIST_TIMEOUT_S = 600
# The route a data rank's batch of 8 takes, by device type.
LOOP_ROUTE = {"cuda": "fused_loop", "cpu": "scan_dense"}
DIST_COUNTERS = {
    "K1 fwd": ("grouped_mlp", "LAUNCHES"), "K1 fwd add": ("grouped_mlp", "LAUNCHES_ADD"),
    "K1 fwd cat": ("grouped_mlp", "LAUNCHES_CAT"), "K1 pre cat": ("grouped_mlp", "LAUNCHES_PRE_CAT"),
    "K1 bwd": ("grouped_mlp", "LAUNCHES_BWD"), "K1 bwd add": ("grouped_mlp", "LAUNCHES_BWD_ADD"),
    "K1 bwd acc": ("grouped_mlp", "LAUNCHES_BWD_ACC"),
    "K1 bwd acc cat": ("grouped_mlp", "LAUNCHES_BWD_ACC_CAT"),
    "K2 fwd": ("consensus_update", "LAUNCHES"), "K2 fwd cons": ("consensus_update", "LAUNCHES_CONS"),
    "K2 bwd dq": ("consensus_update", "LAUNCHES_BWD_DQ"),
    "K2 bwd dkv": ("consensus_update", "LAUNCHES_BWD_DKV"),
    "K2 combine dq": ("consensus_update", "LAUNCHES_BWD_COMBINE_DQ"),
    "K2 combine dkv": ("consensus_update", "LAUNCHES_BWD_COMBINE_DKV"),
    "K2 onesweep": ("consensus_update", "LAUNCHES_BWD_ONESWEEP"),
    "K4": ("banded_consensus", "LAUNCHES"),
}


def _dist_counts(reset=False) -> dict:
    import importlib

    out = {}
    for key, (mod, attr) in DIST_COUNTERS.items():
        m = importlib.import_module(f"glom_tpu_torch.kernels.{mod}")
        out[key] = getattr(m, attr)
        if reset:
            setattr(m, attr, 0)
    return out


def dist_kernel_launches(c: dict) -> dict:
    """Counter readings -> launches by the kernels line's names."""
    return {
        "grouped_mlp_fwd": c["K1 fwd"] - c["K1 fwd add"] - c["K1 fwd cat"],
        "grouped_mlp_fwd_add": c["K1 fwd add"],
        "consensus_update_fwd": c["K2 fwd"] - c["K2 fwd cons"],
        "grouped_mlp_bwd": c["K1 bwd"] - c["K1 bwd add"],
        "grouped_mlp_bwd_add": c["K1 bwd add"],
        "consensus_update_bwd_dq": c["K2 bwd dq"],
        "consensus_update_bwd_dkv": c["K2 bwd dkv"],
        "consensus_update_bwd_combine": c["K2 combine dq"] + c["K2 combine dkv"],
        "consensus_update_fwd_cons": c["K2 fwd cons"],
        "consensus_update_bwd_onesweep": c["K2 onesweep"],
        "grouped_mlp_fwd_cat": c["K1 fwd cat"],
        "grouped_mlp_pre_cat": c["K1 pre cat"],
        "grouped_mlp_bwd_acc_cat": c["K1 bwd acc cat"],
        "banded_consensus_fwd": c["K4"],
    }


def _zero_expected(cfg, dp: int, quantized: bool, accum: int = 1, stage: int = 1) -> dict:
    """What a ZeRO step moves and keeps on each rank, leaf by leaf from the
    shapes and the ZeRO layout (a leaf with no dp-divisible free axis stays
    replicated: a full all-reduce, whole moments): the reduce and gather
    wire bytes a step and the Adam moments' bytes a rank."""
    from glom_tpu_torch.parallel.quantized import quantized_wire_bytes
    from glom_tpu_torch.parallel.sharding import zero_param_specs
    from glom_tpu_torch.utils.checkpoint import named_leaves

    params = _dist_params(cfg, SEED)
    specs = zero_param_specs(params, dp)
    frac = (dp - 1) / dp
    reduce_b = gather_b = moments = 0
    for name, t in named_leaves(params):
        nbytes = t.numel() * 4
        wire = quantized_wire_bytes(nbytes // 4) if quantized else nbytes
        scattered = "data" in specs[name]
        reduce_b += (int(frac * wire) * (1 if scattered else 2)) * (accum if stage >= 2 else 1)
        gather_b += int((dp - 1) * nbytes // dp) if scattered else 0
        moments += 2 * (nbytes // dp if scattered else nbytes)
    return {"reduce": reduce_b, "gather": gather_b, "moment_bytes": moments}


def _dist_err(got, want):
    """(max abs error, that over max |want|)."""
    got, want = got.float(), want.float()
    diff = float((got - want).abs().max())
    return diff, diff / max(float(want.abs().max()), 1e-30)


def _dist_params(cfg, seed):
    import torch

    from glom_tpu_torch.train import init_denoise

    return init_denoise(cfg, generator=torch.Generator().manual_seed(seed))


def _dist_batch(cfg, batch, seed, dev):
    """A global shapes batch and f32 noise, the same on every rank."""
    import torch

    from glom_tpu_torch.data import shapes_dataset

    img = torch.from_numpy(next(shapes_dataset(batch, cfg.image_size, seed=seed))).to(dev)
    noise = torch.randn(img.shape, generator=torch.Generator().manual_seed(seed)).to(dev)
    return img, noise


def _dist_f32_grads(mesh, cfg, batch, sp, dev, rank, tp_axis="hidden"):
    """make_manual_loss's f32 loss and gradients (TP shards, laid out by
    `tp_axis`, gathered) on every rank, against the single-device fused
    step's on rank 0: (worst of the loss's relative error and each leaf's
    error over max |want|, per leaf)."""
    import torch

    from glom_tpu_torch.models.core import param_leaves, unflatten_params
    from glom_tpu_torch.parallel.collectives import all_gather, mesh_axis
    from glom_tpu_torch.parallel.manual import make_manual_loss, rank_axes
    from glom_tpu_torch.parallel.sharding import denoise_param_specs, shard_leaf, spec_axis
    from glom_tpu_torch.train import denoise_loss
    from glom_tpu_torch.utils.config import TrainConfig
    from glom_tpu_torch.utils.checkpoint import named_leaves

    tcfg = TrainConfig(batch_size=batch, use_pallas=True)
    params = _dist_params(cfg, SEED)
    img, noise = _dist_batch(cfg, batch, SEED + 40, dev)
    axes = rank_axes(mesh)
    specs = denoise_param_specs(tp_axis)
    coords = {"model": (axes.model.index, axes.model.size)}
    leaves = [shard_leaf(t, specs[nm], coords).to(dev).clone().requires_grad_()
              for nm, t in named_leaves(params)]
    pp = unflatten_params(params, leaves)
    loss = make_manual_loss(mesh, cfg, tcfg, sp_strategy=sp, tp_axis=tp_axis)(pp, img, noise)
    grads = torch.autograd.grad(loss, leaves)
    model = mesh_axis(mesh, "model")
    grads = [all_gather(g, model, spec_axis(specs[nm], "model"))
             if spec_axis(specs[nm], "model") >= 0 else g
             for (nm, _), g in zip(named_leaves(params), grads)]
    if rank != 0:
        return None
    ref_leaves = [t.to(dev).clone().requires_grad_() for t in param_leaves(params)]
    ref = denoise_loss(unflatten_params(params, ref_leaves), img, noise, cfg, use_pallas=True)
    ref_grads = torch.autograd.grad(ref, ref_leaves)
    errs = {nm: _dist_err(g, r)[1] for (nm, _), g, r in
            zip(named_leaves(params), grads, ref_grads)}
    loss_rel = abs(float(loss.detach()) - float(ref)) / abs(float(ref))
    del ref_grads, grads
    return max(max(errs.values()), loss_rel), loss_rel, errs


def _dist_train(mesh_cfg, cfg, tcfg, sp, dev, steps, seed, *, single=False, params=None,
                tp_axis="hidden", sites=None):
    """DistributedTrainer steps on the same seeded global batches: per-step
    launches (counted from 0 around each step), host ms, records; and on
    rank 0 with `single`, the single-device Trainer's losses. `sites`, a
    CollectiveCounters, records the collective sites of the first step."""
    import torch
    import torch.distributed as dist

    from glom_tpu_torch.data import shapes_dataset
    from glom_tpu_torch.parallel import DistributedTrainer
    from glom_tpu_torch.train import Trainer

    params = params if params is not None else _dist_params(cfg, SEED)
    tr = DistributedTrainer(cfg, tcfg, mesh_cfg, sp_strategy=sp,
                            devices=[dev] * mesh_cfg.num_devices, backend="gloo",
                            params=params, tp_axis=tp_axis)
    batches = list(shapes_dataset(tcfg.batch_size, cfg.image_size, seed=seed,
                                  num_batches=steps))
    launches, ms, recs = [], [], []
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for b in batches:
        dist.barrier()
        sync()
        _dist_counts(reset=True)
        import contextlib

        from glom_tpu_torch.telemetry import counters as tele_counters

        rec = (tele_counters.recording(sites) if sites is not None and not ms
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rec:
            m = tr.step(b)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(_dist_counts())
        recs.append({k: (float(v) if hasattr(v, "item") else v) for k, v in m.items()})
    out = dict(trainer=tr, launches=launches, ms=ms, records=recs,
               losses=[r["loss"] for r in recs])
    if single and dist.get_rank() == 0:
        st = Trainer(cfg, tcfg, params=params, device=dev)
        out["single_losses"] = [float(st.step(b)["loss"]) for b in batches]
        del st
    return out


def _dist_child(rank, world, init, device, cases, q):
    """One rank: the process group (gloo, on `device`), then each case."""
    import traceback

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    try:
        from glom_tpu_torch.parallel.mesh import initialize_multihost

        initialize_multihost(num_processes=world, process_id=rank, init_method=init,
                             device=device, backend="gloo")
        import collections

        from glom_tpu_torch.parallel import collectives

        out, staged = {}, {}
        for i, (name, kw) in enumerate(cases):
            before = collections.Counter(collectives.STAGED)
            out[i] = DIST_CASES[name](rank=rank, device=device, **kw)
            staged[i] = dict(collectives.STAGED - before)
        out["staged"] = staged
        q.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 - relayed to the parent, which fails the phase
        q.put((rank, "err", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _dist_spawn(world: int, cases, device: str = "cuda:0") -> list:
    """[(case, kwargs), ...] on `world` gloo ranks on `device` -> each
    rank's {i: the i-th case's result, "staged": {i: the ops its gloo calls
    staged through host memory}}. Raises with the failing ranks'
    tracebacks."""
    import os
    import queue
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    results, errors = {}, []
    with tempfile.TemporaryDirectory(prefix="glom_dist_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_dist_child, args=(r, world, init, device, cases, q))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_TIMEOUT_S
        try:
            while len(results) + len(errors) < world:
                try:
                    rank, status, payload = q.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead or time.monotonic() > deadline:
                        errors.append(f"ranks exited {dead} or timed out")
                        break
                    continue
                if status == "ok":
                    results[rank] = payload
                else:
                    errors.append(f"rank {rank}:\n{payload}")
        finally:
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise AssertionError("a rank failed:\n" + "\n".join(errors))
    return [results[r] for r in range(world)]


def _loop_launches(k):
    return {"K1 fwd": k, "K1 fwd cat": k, "K2 fwd": k, "K1 bwd acc": k,
            "K1 bwd acc cat": k, "K2 combine dq": k, "K2 combine dkv": k}


def _per_op_launches(k, with_k2):
    want = {"K1 fwd": 2 * k, "K1 fwd add": k, "K1 bwd": 2 * k, "K1 bwd add": k}
    if with_k2:
        want.update({"K2 fwd": k, "K2 bwd dq": k, "K2 bwd dkv": k})
    return want


def _full(counts_want):
    return {key: counts_want.get(key, 0) for key in DIST_COUNTERS}


def _case_dp2(rank, device, cfg_kw):
    """imagenet224-dp8 at global batch 16 on 2 data ranks: the f32 first
    step's all-reduced gradients against the single-process batch-16
    step's; 3 bf16 steps against the single-device Trainer's losses; exact
    launches a step (each rank's 8 on the loop)."""
    import torch

    from glom_tpu_torch.parallel.mesh import make_mesh
    from glom_tpu_torch.utils.config import TrainConfig
    from glom_tpu_torch.utils.config import GlomConfig, MeshConfig

    cfg, dev = GlomConfig(**cfg_kw), torch.device(device)
    mesh, _ = make_mesh(MeshConfig(data=2), devices=[device] * 2, backend="gloo")
    f32 = _dist_f32_grads(mesh, cfg, DIST_DP_BATCH, "none", dev, rank)
    torch.cuda.empty_cache()
    tcfg = TrainConfig(batch_size=DIST_DP_BATCH, compute_dtype="bfloat16", use_pallas=True)
    run = _dist_train(MeshConfig(data=2), cfg, tcfg, "none", dev, DIST_STEPS, SEED + 41,
                      single=True)
    tr = run.pop("trainer")
    run.update(f32=f32, vjp_path=tr.vjp_path)
    return run


def _case_zero(rank, device, cfg_kw):
    """The dp2 mesh at stages 0, 1, 2 and 2 with the quantized reduce: f32
    steps (telemetry on, so the counters count); final params, losses,
    optimizer-state bytes read from each rank's tensors, the records."""
    import torch

    from glom_tpu_torch.utils.config import TrainConfig
    from glom_tpu_torch.utils.checkpoint import named_leaves
    from glom_tpu_torch.utils.config import GlomConfig, MeshConfig

    cfg, dev = GlomConfig(**cfg_kw), torch.device(device)
    out = {}
    base_params = _dist_params(cfg, SEED)
    finals = {}
    for arm, kw in (("stage0", {}), ("stage1", {"zero_stage": 1}), ("stage2", {"zero_stage": 2}),
                    ("stage2_quantized", {"zero_stage": 2, "quantized_reduce": True})):
        tcfg = TrainConfig(batch_size=DIST_ZERO_BATCH, use_pallas=True,
                           telemetry_level="scalars", learning_rate=1e-3, **kw)
        run = _dist_train(MeshConfig(data=2), cfg, tcfg, "none", dev, DIST_STEPS, SEED + 42,
                          params=base_params)
        tr = run.pop("trainer")
        state = [v for s_ in tr.state.optimizer.state.values() for v in s_.values()
                 if torch.is_tensor(v)]
        opt_bytes = sum(v.numel() * v.element_size() for v in state)
        moment_bytes = sum(v.numel() * v.element_size() for v in state if v.dim())
        g = tr.global_state()
        if rank == 0:
            finals[arm] = {nm: t.detach().clone() for nm, t in named_leaves(g.params)}
        rec = run["records"][-1]
        out[arm] = dict(losses=run["losses"], ms=run["ms"], opt_bytes=opt_bytes,
                        moment_bytes=moment_bytes,
                        record={k: rec.get(k) for k in (
                            "zero_stage", "quantized_reduce", "opt_bytes_per_replica",
                            "comm_bytes_per_step", "comm_reduce_bytes_per_step",
                            "comm_gather_bytes_per_step", "comm_measured_bytes_per_step",
                            "comm_measured_reduce_bytes_per_step",
                            "comm_measured_gather_bytes_per_step", "comm_model_drift",
                            "comm_measured_collective_count", "quant_rel_err", "grad_norm")})
        del tr, g, run
        torch.cuda.empty_cache()
    if rank == 0:
        for arm in ("stage1", "stage2", "stage2_quantized"):
            errs = {nm: _dist_err(finals[arm][nm], finals["stage0"][nm])[1]
                    for nm in finals["stage0"]}
            out[arm]["params_err_over_max_vs_stage0"] = max(errs.values())
    return out


def _case_sp(rank, device, strategy, seq, cfg_kw):
    """SP on `seq` ranks, dp 1: the f32 gradients of one step against the
    single-device step's; then bf16 steps timed, with exact launches (K1
    only: consensus is the shard body)."""
    import torch

    from glom_tpu_torch.parallel.mesh import make_mesh
    from glom_tpu_torch.utils.config import TrainConfig
    from glom_tpu_torch.utils.config import GlomConfig, MeshConfig

    cfg, dev = GlomConfig(**cfg_kw), torch.device(device)
    mesh, _ = make_mesh(MeshConfig(seq=seq), devices=[device] * seq, backend="gloo")
    f32 = _dist_f32_grads(mesh, cfg, DIST_SP_BATCH, strategy, dev, rank)
    torch.cuda.empty_cache()
    tcfg = TrainConfig(batch_size=DIST_SP_BATCH, compute_dtype="bfloat16", use_pallas=True)
    run = _dist_train(MeshConfig(seq=seq), cfg, tcfg, strategy, dev, DIST_STEPS, SEED + 43)
    tr = run.pop("trainer")
    run.update(f32=f32, sp_strategy=tr.sp_strategy, vjp_path=tr.vjp_path)
    return run


def _case_tp2(rank, device, cfg_kw):
    """Hidden TP at model 2 on the flagship: K1 at f = 1024 a rank, K2 whole
    on the per-op route; f32 gradients against the single device; bf16
    steps timed with exact launches."""
    import torch

    from glom_tpu_torch.parallel.mesh import make_mesh
    from glom_tpu_torch.utils.config import TrainConfig
    from glom_tpu_torch.utils.config import GlomConfig, MeshConfig

    cfg, dev = GlomConfig(**cfg_kw), torch.device(device)
    mesh, _ = make_mesh(MeshConfig(model=2), devices=[device] * 2, backend="gloo")
    f32 = _dist_f32_grads(mesh, cfg, DIST_SP_BATCH, "none", dev, rank)
    torch.cuda.empty_cache()
    tcfg = TrainConfig(batch_size=DIST_SP_BATCH, compute_dtype="bfloat16", use_pallas=True)
    run = _dist_train(MeshConfig(model=2), cfg, tcfg, "none", dev, DIST_STEPS, SEED + 44)
    tr = run.pop("trainer")
    run.update(f32=f32, vjp_path=tr.vjp_path,
               hidden_per_rank=int(tr.state.params.glom.bottom_up.w1.shape[-1]))
    return run


DIST_CASES = {"dp2": _case_dp2, "zero": _case_zero, "sp": _case_sp, "tp2": _case_tp2}
# Step p50s a rank of earlier dist phases, for the later ones' rows.
DIST_P50: dict = {}


def dist_phases(cfg, dev, smi: str, *, halo_cfg=DIST_HALO_CFG,
                cli_preset: str = "imagenet224-dp8") -> dict:
    """The dist_* phases and train_cli_distributed on `dev` (ranks spawned
    on it too); returns each kernel's launches on their main-path runs
    (every rank's counted steps and the world-1 steps), for the kernels
    line's `dist_launches`."""
    import collections
    import os
    import statistics
    import tempfile

    import torch
    import torch.distributed as dist

    from glom_tpu_torch.data import shapes_dataset
    from glom_tpu_torch.models.core import param_leaves
    from glom_tpu_torch.parallel import collectives
    from glom_tpu_torch.parallel import DistributedTrainer
    from glom_tpu_torch.parallel.mesh import initialize_multihost
    from glom_tpu_torch.train import Trainer, default_recon_index
    from glom_tpu_torch.utils.config import TrainConfig
    from glom_tpu_torch.utils.checkpoint import named_leaves
    from glom_tpu_torch.utils.config import MeshConfig

    k = default_recon_index(cfg.default_iters)
    total = {key: 0 for key in DIST_COUNTERS}

    def add(counts):
        for key, v in counts.items():
            total[key] += v

    def p50(xs):
        return statistics.median(xs[1:]) if len(xs) > 1 else xs[0]

    # -- dist_world1_nccl: an NCCL group of one in this process ------------------
    t0 = time.perf_counter()
    tcfg = TrainConfig(batch_size=8, compute_dtype="bfloat16", use_pallas=True)
    params = _dist_params(cfg, SEED)
    staged_before = collections.Counter(collectives.STAGED)
    with tempfile.TemporaryDirectory(prefix="glom_nccl1_") as tmp:
        nccl = "nccl" if dev.type == "cuda" else "gloo"
        initialize_multihost(num_processes=1, process_id=0,
                             init_method="file://" + os.path.join(tmp, "store"),
                             device=dev, backend=nccl)
        try:
            dtr = DistributedTrainer(cfg, tcfg, MeshConfig(), devices=[dev], backend=nccl,
                                     params=params)
            backend = dist.get_backend()
            single = Trainer(cfg, tcfg, params=params, device=dev)
            batches = list(shapes_dataset(8, cfg.image_size, seed=SEED + 45,
                                          num_batches=DIST_STEPS))
            d_launch, s_launch, d_loss, s_loss = [], [], [], []
            for b in batches:
                for tr, ls, ln in ((dtr, d_loss, d_launch), (single, s_loss, s_launch)):
                    _dist_counts(reset=True)
                    ls.append(float(tr.step(b)["loss"]))
                    ln.append(_dist_counts())
            unequal = [nm for (nm, a), b_ in zip(named_leaves(dtr.state.params),
                                                 param_leaves(single.state.params))
                       if not torch.equal(a, b_)]
            for c in d_launch:
                add(c)
            want = _full(_loop_launches(k))
            emit("dist_world1_nccl", nvidia_smi=smi, backend=backend, batch=8,
                 vjp_path=dtr.vjp_path, losses=d_loss, single_losses=s_loss,
                 losses_bitwise=d_loss == s_loss, params_bitwise=not unequal,
                 unequal_leaves=unequal, launches_per_step=d_launch,
                 same_launches_as_trainer=d_launch == s_launch,
                 exact_launches=all(c == want for c in d_launch),
                 staged=dict(collectives.STAGED - staged_before),
                 memory=dtr._memory_record(), seconds=time.perf_counter() - t0)
            if d_loss != s_loss or unequal or d_launch != s_launch or any(
                    c != want for c in d_launch) or backend != nccl:
                raise AssertionError("dist_world1_nccl: the NCCL world-1 step differs from "
                                     f"Trainer's: {unequal}, {d_loss} vs {s_loss}")
            del dtr, single
        finally:
            dist.destroy_process_group()
    cfg_kw = dict(dim=cfg.dim, levels=cfg.levels, image_size=cfg.image_size,
                  patch_size=cfg.patch_size)
    device = str(dev)

    # -- dist_dp2, dist_zero, dist_sp (ring, ulysses), dist_tp2: one 2-rank spawn --
    t0 = time.perf_counter()
    res2 = _dist_spawn(2, [
        ("dp2", {"cfg_kw": cfg_kw}), ("zero", {"cfg_kw": cfg_kw}),
        ("sp", {"strategy": "ring", "seq": 2, "cfg_kw": cfg_kw}),
        ("sp", {"strategy": "ulysses", "seq": 2, "cfg_kw": cfg_kw}),
        ("tp2", {"cfg_kw": cfg_kw}),
    ], device)
    spawn2_s = time.perf_counter() - t0
    staged = [r["staged"] for r in res2]
    for r in res2:
        r.update(dp2=r[0], zero=r[1], ring=r[2], ulysses=r[3], tp2=r[4])
        for case in ("dp2", "ring", "ulysses", "tp2"):
            for c in r[case]["launches"]:
                add(c)
    dp0 = res2[0]["dp2"]
    worst, loss_rel, errs = dp0["f32"]
    bf16_rel = max(abs(a - b) / abs(b) for a, b in zip(dp0["losses"], dp0["single_losses"]))
    want_dp = _full(_loop_launches(k))
    exact_dp = all(c == want_dp for r in res2 for c in r["dp2"]["launches"])
    ok = (worst <= LOOP_F32_BAR and bf16_rel < 1e-2 and exact_dp
          and dp0["vjp_path"] == LOOP_ROUTE[dev.type])
    emit("dist_dp2", nvidia_smi=smi, backend="gloo", ranks_on=device, global_batch=16,
         vjp_path=dp0["vjp_path"], f32_worst=worst, f32_loss_rel_err=loss_rel,
         f32_err_over_max=errs, f32_bar=LOOP_F32_BAR, f32_bar_ratio=worst / LOOP_F32_BAR,
         bf16_losses=dp0["losses"], single_losses=dp0["single_losses"],
         bf16_worst_rel_loss=bf16_rel, bf16_bar=1e-2,
         launches_per_step=[r["dp2"]["launches"] for r in res2], want_per_step=want_dp,
         exact_launches=exact_dp,
         step_ms=[r["dp2"]["ms"] for r in res2],
         step_p50_ms=[p50(r["dp2"]["ms"]) for r in res2], staged=[st[0] for st in staged],
         spawn_seconds=spawn2_s, ok=ok)
    if not ok:
        raise AssertionError("dist_dp2 failed its bars")

    z0 = res2[0]["zero"]
    zrows, zok = {}, True
    for arm, row in z0.items():
        rec = row["record"]
        zrows[arm] = dict(row, opt_bytes_by_rank=[r["zero"][arm]["opt_bytes"] for r in res2],
                          moment_bytes_by_rank=[r["zero"][arm]["moment_bytes"] for r in res2])
        if arm == "stage0":
            continue
        # Each rank's Adam moments (read from its tensors) and the counted
        # wire bytes against the layout's leaf-by-leaf schedule; the share
        # of stage 0's moments and the drift from comm_volume_model beside.
        want = _zero_expected(cfg, 2, rec["quantized_reduce"], stage=rec["zero_stage"])
        moments_ok = all(r["zero"][arm]["moment_bytes"] == want["moment_bytes"] for r in res2)
        counts_ok = (rec["comm_measured_reduce_bytes_per_step"] == want["reduce"]
                     and rec["comm_measured_gather_bytes_per_step"] == want["gather"])
        zrows[arm].update(expected=want, moments_as_laid_out=moments_ok,
                          counters_equal_schedule=counts_ok,
                          moment_share_of_stage0=row["moment_bytes"]
                          / z0["stage0"]["moment_bytes"])
        ok = moments_ok and counts_ok and rec["zero_stage"] in (1, 2)
        if arm == "stage2_quantized":
            close = max(abs(a - b) / abs(b) for a, b in
                        zip(row["losses"], z0["stage0"]["losses"])) < 5e-2
            zrows[arm]["losses_within_5e-2"] = close
            ok = ok and close and rec["quantized_reduce"] is True
        else:
            ok = ok and row["params_err_over_max_vs_stage0"] <= LOOP_F32_BAR
        zrows[arm]["ok"] = ok
        zok = zok and ok
    emit("dist_zero", nvidia_smi=smi, backend="gloo", global_batch=DIST_ZERO_BATCH,
         steps=DIST_STEPS, dtype="float32", f32_bar=LOOP_F32_BAR, arms=zrows,
         staged=[st[1] for st in staged], ok=zok)
    if not zok:
        raise AssertionError("dist_zero failed its bars")

    # -- dist_sp: ring and Ulysses at seq 2 (above), halo at seq 4 (imagenet256-local) --
    t0 = time.perf_counter()
    res_h = _dist_spawn(4, [("sp", {"strategy": "halo", "seq": 4, "cfg_kw": halo_cfg})], device)
    halo_s = time.perf_counter() - t0
    want_sp = _full(_per_op_launches(k, with_k2=False))
    sp_rows, sp_ok = {}, True
    for name, res in (("ring", [r["ring"] for r in res2]),
                      ("ulysses", [r["ulysses"] for r in res2]), ("halo", [r[0] for r in res_h])):
        if name == "halo":
            for r in res:
                for c in r["launches"]:
                    add(c)
        worst, loss_rel, errs = res[0]["f32"]
        exact = all(c == want_sp for r in res for c in r["launches"])
        ok = worst <= TRAIN_F32_BAR and exact and res[0]["sp_strategy"] == name
        sp_rows[name] = dict(ranks=len(res), sp_strategy=res[0]["sp_strategy"],
                             vjp_path=res[0]["vjp_path"], f32_worst=worst,
                             f32_loss_rel_err=loss_rel, f32_err_over_max=errs,
                             f32_bar_ratio=worst / TRAIN_F32_BAR,
                             bf16_losses=res[0]["losses"],
                             step_p50_ms=[p50(r["ms"]) for r in res],
                             launches_per_step=res[0]["launches"][-1], want_per_step=want_sp,
                             exact_launches=exact, ok=ok)
        sp_ok = sp_ok and ok
    emit("dist_sp", nvidia_smi=smi, backend="gloo", batch=DIST_SP_BATCH, f32_bar=TRAIN_F32_BAR,
         strategies=sp_rows, staged={"ring": [st[2] for st in staged],
                                     "ulysses": [st[3] for st in staged],
                                     "halo": [r["staged"][0] for r in res_h]},
         halo_spawn_seconds=halo_s, ok=sp_ok)
    if not sp_ok:
        raise AssertionError("dist_sp failed its bars")

    tp = [r["tp2"] for r in res2]
    worst, loss_rel, errs = tp[0]["f32"]
    want_tp = _full(_per_op_launches(k, with_k2=True))
    exact_tp = all(c == want_tp for r in tp for c in r["launches"])
    tp_ok = worst <= TRAIN_F32_BAR and exact_tp and (
        tp[0]["hidden_per_rank"] == cfg.dim * cfg.mult // 2)
    emit("dist_tp2", nvidia_smi=smi, backend="gloo", batch=DIST_SP_BATCH,
         hidden_per_rank=tp[0]["hidden_per_rank"], vjp_path=tp[0]["vjp_path"],
         f32_worst=worst, f32_loss_rel_err=loss_rel, f32_err_over_max=errs,
         f32_bar=TRAIN_F32_BAR, f32_bar_ratio=worst / TRAIN_F32_BAR,
         bf16_losses=tp[0]["losses"], step_p50_ms=[p50(r["ms"]) for r in tp],
         launches_per_step=tp[0]["launches"][-1], want_per_step=want_tp, exact_launches=exact_tp,
         staged=[st[4] for st in staged], ok=tp_ok)
    if not tp_ok:
        raise AssertionError("dist_tp2 failed its bars")
    # dist_tp_levels (sharded_phases) prints its p50 beside these.
    DIST_P50["tp2"] = [p50(r["ms"]) for r in tp]

    # -- train_cli_distributed: torch.distributed.run, 2 ranks on cuda:0 ----------
    import subprocess

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="glom_dist_cli_") as tmp:
        metrics, ck = os.path.join(tmp, "train.jsonl"), os.path.join(tmp, "ckpt")
        base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "--monitor-interval", "0.1", "-m", "glom_tpu_torch.train.cli", "--preset",
                cli_preset, "--distributed", "--dist-backend", "gloo", "--device",
                device, "--batch-size", str(DIST_DP_BATCH), "--log-every", "1"]
        runs = []
        for extra in (["--zero-stage", "2", "--steps", "4", "--checkpoint-every", "2",
                       "--checkpoint-dir", ck, "--metrics-file", metrics,
                       "--telemetry-level", "scalars"],
                      ["--zero-stage", "2", "--steps", "6", "--checkpoint-every", "2",
                       "--checkpoint-dir", ck, "--metrics-file", metrics, "--resume",
                       "--telemetry-level", "scalars"],
                      ["--check-parity", "--steps", "3"]):
            t1 = time.perf_counter()
            p = subprocess.run(base + extra, capture_output=True, text=True, timeout=600,
                               cwd=os.path.dirname(os.path.abspath(__file__)))
            p.seconds = time.perf_counter() - t1
            runs.append(p)
        lint = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", metrics],
                              capture_output=True, text=True, timeout=120,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        with open(metrics) as fh:
            recs = [json.loads(ln) for ln in fh]
        steps = [r for r in recs if r.get("kind") == "train_step"]
        ck_steps = sorted(int(n) for n in os.listdir(ck) if n.isdigit())
    rcs = [p.returncode for p in runs]
    mesh_line = [ln for ln in runs[0].stderr.splitlines() if ln.startswith("mesh ")]
    parity_line = [ln for ln in runs[2].stdout.splitlines() if ln.startswith("parity:")]
    ok = (rcs == [0, 0, 0] and "resumed from step 4" in runs[1].stderr and lint.returncode == 0
          and [r["step"] for r in steps] == list(range(6)) and ck_steps == [2, 4, 6]
          and all(math.isfinite(r["loss"]) and r["zero_stage"] == 2 for r in steps))
    emit("train_cli_distributed", nvidia_smi=smi, exit_codes=rcs, mesh_line=mesh_line,
         resumed="resumed from step 4" in runs[1].stderr, lint_rc=lint.returncode,
         records=len(steps), losses=[r["loss"] for r in steps],
         steps=[r["step"] for r in steps], checkpoint_steps=ck_steps,
         step_p50_ms=[r.get("step_time_p50_ms") for r in steps][-1:],
         comm_model_drift=[r.get("comm_model_drift") for r in steps][-1:],
         parity=parity_line, run_seconds=[p.seconds for p in runs],
         staged="none: a data-parallel mesh issues no point-to-point",
         seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        tails = [(p.stderr[-2000:]) for p in runs] + [lint.stdout[-500:]]
        raise AssertionError(f"train_cli_distributed: {rcs}: {tails}")
    return dist_kernel_launches(total)


# -- sharded inference across ranks (mesh_* phases) -------------------------------
# Two gloo ranks on the card in one spawn: Glom(mesh=) (`mesh_forward`) and
# InferenceEngine(mesh=) with rank 1 following (`serve_mesh`); then the serve
# CLI under torch.distributed.run (`serve_cli_mesh`). Launches are counted a
# rank from 0 around each engine's or forward's main-path run.
MESH_T = 12
MESH_BUCKET = 8
MESH_DISPATCHES = 10
MESH_POOL_PAGES = 32  # 4 pages a row x 8 rows, split 16 a rank
MESH_CLI_ARGV = ["--preset", "imagenet224-dp8", "--mesh-data", "2", "--buckets", "2,4,8,16",
                 "--dist-backend", "gloo", "--synthetic", "32"]
MESH_F32 = dict(rtol=2e-3, atol=2e-4)  # serve_parity_f32's bars
# The bf16 sharded engine's fixed loop against the single-device bf16
# engine's (max abs): the bf16 serve bar, 2.6x the 3.9e-3 (one bf16 ulp
# at 1) read at the flagship on an H100.
MESH_BF16_ATOL = BF16_SERVE_ATOL


def _within(got, want, rtol, atol):
    """(every element within atol + rtol |want|, max abs error, the worst
    element's error over its allowance)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    allow = atol + rtol * want.abs()
    return bool((diff <= allow).all()), float(diff.max()), float((diff / allow).max())


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _ring_allreduce(nbytes: int, k: int) -> int:
    return int(2 * (k - 1) / k * nbytes) if k > 1 else 0


def serve_wire_formula(cfg, bucket: int, dp: int, seq: int, *, auto: bool, T: int,
                       paged=None, pool_pages=0, page_tokens=64, itemsize=2) -> dict:
    """glom_tpu's counted wire bytes of one serve-mesh signature
    (parallel/serve_mesh.py: each site's ring formula, the loop's sites at
    the budget T), from the shapes alone: {reduce, gather, count}."""
    L, d = cfg.levels, cfg.dim
    b_loc = bucket // dp
    reduce_b = gather_b = count = 0
    if auto:
        reduce_b += _ring_allreduce(4, dp)  # quorum_valid_psum (f32 scalar)
        count += 1
        if seq > 1:  # witness_mean_psum / witness_cos_psum: the initial one + T
            reduce_b += (1 + T) * (_ring_allreduce(b_loc * L * d * 4, seq)
                                   + _ring_allreduce(b_loc * L * 4, seq))
            count += 4
        reduce_b += T * _ring_allreduce(4, dp)  # quorum_exit_psum (int32 scalar)
        count += 1
    if paged is not None:
        ppr = cfg.num_patches // page_tokens
        page_bytes = page_tokens * L * d * itemsize
        pps = pool_pages // dp
        if paged == "auto":
            paged = "needed" if b_loc * ppr < pps else "pool"
        if paged == "pool":
            gather_b += (dp - 1) * pps * page_bytes
        else:
            reduce_b += int((dp - 1) / dp * dp * b_loc * ppr * page_bytes)
        count += 1
    return {"comm_measured_reduce_bytes_per_step": reduce_b,
            "comm_measured_gather_bytes_per_step": gather_b,
            "comm_measured_bytes_per_step": reduce_b + gather_b,
            "comm_measured_collective_count": count}


def _case_mesh_forward(rank, device, cfg_kw):
    """Glom(mesh=) at the flagship width: data 2 at batch 8 (K1 and K2 a
    rank), seq 2 at batch 2 through the ring and Ulysses (K1 only). f32
    final, return_all and with_levels against the single-device Glom on
    rank 0; launches a rank around the f32 final forward; bf16 ms."""
    import torch

    from glom_tpu_torch.models.api import Glom
    from glom_tpu_torch.models.core import init_glom
    from glom_tpu_torch.utils.config import GlomConfig, MeshConfig

    cfg, dev = GlomConfig(**cfg_kw), torch.device(device)
    params = init_glom(cfg, generator=torch.Generator().manual_seed(SEED))
    kw = dict(cfg_kw, params=params, device=dev, use_pallas=True)
    out = {}
    for name, shape, sp, b in (("data2", (2, 1, 1), "none", 8), ("ring", (1, 2, 1), "ring", 2),
                               ("ulysses", (1, 2, 1), "ulysses", 2)):
        g = torch.Generator().manual_seed(SEED + 60)
        x = torch.randn((b, cfg.channels, cfg.image_size, cfg.image_size), generator=g).to(dev)
        lv0 = (0.5 * torch.randn((b, cfg.num_patches, cfg.levels, cfg.dim), generator=g)).to(dev)
        m = Glom(**kw, mesh=MeshConfig(*shape), sp_strategy=sp)
        _sync(dev)
        _dist_counts(reset=True)
        final = m(x, iters=MESH_T)
        _sync(dev)
        launches = _dist_counts()
        every = m(x, iters=MESH_T, return_all=True)
        warm = m(x, iters=MESH_T, levels=lv0)
        m16 = Glom(**kw, mesh=MeshConfig(*shape), sp_strategy=sp, compute_dtype=torch.bfloat16)
        ms = []
        for _ in range(4):
            _sync(dev)
            t0 = time.perf_counter()
            y16 = m16(x, iters=MESH_T)
            _sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
        row = dict(batch=b, launches=launches, bf16_ms=ms, bf16_finite=bool(y16.isfinite().all()),
                   shapes=[list(final.shape), list(every.shape), list(warm.shape)])
        if rank == 0:
            single = Glom(**kw)
            for key, got, want in (("final", final, single(x, iters=MESH_T)),
                                   ("return_all", every, single(x, iters=MESH_T,
                                                                return_all=True)),
                                   ("with_levels", warm, single(x, iters=MESH_T, levels=lv0))):
                ok, err, ratio = _within(got, want, **MESH_F32)
                row[key] = dict(ok=ok, max_abs_err=err, bar_ratio=ratio)
            del single
        out[name] = row
        del m, m16, final, every, warm
        torch.cuda.empty_cache()
    return out


def _mesh_engine_script(eng, rank, dev, spec, img, single):
    """One leader-side engine run of `_case_serve_mesh` (see there);
    `single` is the single-device engine's levels on `img` (f32: the
    engine's route, bf16: the fixed loop of T), on the host."""
    import numpy as np
    import torch

    from glom_tpu_torch.parallel import collectives

    res = {}
    sync = partial(_sync, dev)
    if spec["name"].startswith("f32"):
        got = eng.infer(img).levels.float().cpu()
        ok, err, ratio = _within(got, single, **MESH_F32)
        res.update(ok=ok, max_abs_err=err, bar_ratio=ratio)
        return res
    staged = collections.Counter(collectives.STAGED)
    eng.warmup()
    eng.warmup(iters_override=MESH_T)
    auto_ms, fixed_ms, reads = [], [], []
    auto = fixed = None
    for _ in range(MESH_DISPATCHES):  # the auto route and the fixed loop in turns
        r0 = eng._mesh.worker.exit_reads.seconds
        sync()
        t0 = time.perf_counter()
        auto = eng.infer(img)
        auto_ms.append(1e3 * (time.perf_counter() - t0))
        reads.append(1e3 * (eng._mesh.worker.exit_reads.seconds - r0))
        t0 = time.perf_counter()
        fixed = eng.infer(img, iters_override=MESH_T)
        fixed_ms.append(1e3 * (time.perf_counter() - t0))
    single_err = float((fixed.levels.float().cpu() - single).abs().max())
    res.update(auto_ms=auto_ms, fixed_ms=fixed_ms, exit_read_ms=reads,
               auto_iters=auto.iters_run,
               auto_bitwise_fixed=bool(torch.equal(auto.levels, fixed.levels)),
               finite=bool(auto.levels.float().isfinite().all()),
               single_max_abs_err=single_err, single_ok=single_err <= MESH_BF16_ATOL)
    # The warm host carry: 12 more from the fixed result's columns equal a
    # 24-iteration cold dispatch, bit for bit.
    host = fixed.levels.cpu()
    warm = eng.infer(img, levels0=host, iters_override=MESH_T)
    cold24 = eng.infer(img, iters_override=2 * MESH_T)
    res.update(warm_bitwise_cold24=bool(torch.equal(warm.levels, cold24.levels)),
               warm_levels0_bytes=warm.levels0_h2d_bytes)
    if eng.pool is not None:
        for i in range(MESH_BUCKET):
            assert eng.pool.write_back(f"s{i}", fixed.levels[i], eng.cfg.num_patches)
        rows = np.stack([eng.pool.lookup(f"s{i}")[0] for i in range(MESH_BUCKET)])
        paged = eng.infer(img, page_rows=rows.astype(np.int32), iters_override=MESH_T)
        res.update(paged_bitwise_warm=bool(torch.equal(paged.levels, warm.levels)),
                   paged_levels=paged.levels.cpu(), paged_levels0_bytes=paged.levels0_h2d_bytes,
                   pool=eng.pool.record())
    if spec.get("fault"):
        # The follower's hook fails the next op (transient: retried); its
        # compute step then raises a KernelError inside the body of the op
        # after (raised on the leader, not retried).
        ok1 = eng.infer(img, iters_override=MESH_T)
        try:
            eng.infer(img, iters_override=MESH_T)
            res["kernel_fault"] = None
        except Exception as e:  # noqa: BLE001 - the phase reads the type
            res["kernel_fault"] = type(e).__name__
        ok2 = eng.infer(img, iters_override=MESH_T)
        res["fault_served_bitwise"] = bool(torch.equal(ok1.levels, fixed.levels)
                                           and torch.equal(ok2.levels, fixed.levels))
    sync()
    res["stats"] = [{k: v for k, v in r.items() if isinstance(v, (int, float, str, bool))}
                    for r in eng.stats_records()]
    res["staged"] = dict(collections.Counter(collectives.STAGED) - staged)
    res["wire"] = dict(eng._mesh.channel.wire)
    res["exit_reads"] = eng._mesh.worker.exit_reads.n
    return res


MESH_ENGINES = [
    dict(name="f32_data2", mesh_data=2, dtype="float32"),
    dict(name="f32_seq2", mesh_seq=2, dtype="float32"),
    dict(name="bf16_data2_pool", mesh_data=2, page_gather="pool"),
    dict(name="bf16_data2_needed", mesh_data=2, page_gather="needed", fault=True),
    dict(name="bf16_seq2", mesh_seq=2),
]


def _case_serve_mesh(rank, device, cfg_kw):
    """InferenceEngine(mesh=) at the flagship width, bucket 8, T = 12, rank 0
    leading and rank 1 following, one engine a spec of MESH_ENGINES: f32 at
    data 2 and seq 2 against the single-device f32 engine, and each bf16
    engine's fixed loop against the single-device bf16 engine's (each run
    before the counters go to 0, so no launch of theirs counts); bf16 at data 2
    (a 32-page pool gathered whole, then only the needed pages, with a
    follower fault) and seq 2 (the engine's "auto" strategy: Ulysses at the
    flagship, the ring where the levels do not split): the auto route at
    threshold 0 and the fixed loop in turns, the warm host carry, the paged
    dispatches, the counted wire bytes, the staged calls; launches a rank
    over each engine."""
    import dataclasses

    import torch

    from glom_tpu_torch.kernels._build import KernelError
    from glom_tpu_torch.models.core import init_glom
    from glom_tpu_torch.parallel.serve_mesh import make_serve_mesh
    from glom_tpu_torch.serve.engine import InferenceEngine
    from glom_tpu_torch.serve.mesh_follower import run_follower
    from glom_tpu_torch.utils.config import GlomConfig, ServeConfig

    from glom_tpu_torch.serve import mesh_follower

    cfg, dev = GlomConfig(**cfg_kw), torch.device(device)
    params = init_glom(cfg, generator=torch.Generator().manual_seed(SEED))
    img = torch.randn((MESH_BUCKET, cfg.channels, cfg.image_size, cfg.image_size),
                      generator=torch.Generator().manual_seed(SEED + 61))
    base = ServeConfig(buckets=(MESH_BUCKET,), max_batch=MESH_BUCKET, iters="auto",
                       exit_threshold=0.0, max_auto_iters=MESH_T, compute_dtype="bfloat16",
                       use_pallas=True, dispatch_retries=0)
    out = {}
    for spec in MESH_ENGINES:
        f32 = spec.get("dtype") == "float32"
        scfg = dataclasses.replace(
            base, mesh_data=spec.get("mesh_data", 1), mesh_seq=spec.get("mesh_seq", 1),
            compute_dtype="float32" if f32 else "bfloat16",
            iters=MESH_T if f32 else "auto",
            page_pool_pages=MESH_POOL_PAGES if "page_gather" in spec else 0,
            page_gather=spec.get("page_gather", "auto"),
            dispatch_retries=1 if spec.get("fault") else 0)
        mesh = make_serve_mesh(scfg)
        if rank == mesh.leader:
            # The single-device engine's answer, before the counted window.
            single = InferenceEngine(cfg, dataclasses.replace(scfg, mesh_data=1, mesh_seq=1,
                                                              page_pool_pages=0),
                                     params=params, device=dev)
            want = single.infer(img, iters_override=None if f32 else MESH_T).levels
            want = want.float().cpu()
            del single
            torch.cuda.empty_cache()
            _sync(dev)
            _dist_counts(reset=True)
            eng = InferenceEngine(cfg, scfg, params=params, device=dev, mesh=mesh,
                                  name=spec["name"])
            try:
                res = _mesh_engine_script(eng, rank, dev, spec, img, want)
            finally:
                eng.close()
        else:
            _sync(dev)
            _dist_counts(reset=True)
            seen = [0]
            at = {}

            def hook(h):
                # The fault spec: the first dispatch after the paged one
                # fails here once; the one after its retry fails inside
                # the body (`failing_compute`).
                seen[0] += 1
                if not spec.get("fault"):
                    return
                if h["op"] == "dispatch" and h["warm"] == 2:
                    at["paged"] = seen[0]
                if "paged" in at and seen[0] == at["paged"] + 1:
                    raise RuntimeError("the follower fails this op on purpose")

            def failing_compute(worker, h, *args):
                if "paged" in at and seen[0] == at["paged"] + 3:
                    raise KernelError("the follower's kernel fault, injected in the body")
                return compute(worker, h, *args)

            compute = mesh_follower.MeshWorker.compute
            mesh_follower.MeshWorker.compute = failing_compute
            try:
                stats = run_follower(mesh, dev, fault_hook=hook)
            finally:
                mesh_follower.MeshWorker.compute = compute
            res = {"ops": stats["ops"], "failed": stats["failed"],
                   "exit_reads": stats["exit_reads"].n, "wire": dict(stats["wire"])}
        _sync(dev)
        res["launches"] = _dist_counts()
        out[spec["name"]] = res
        torch.cuda.empty_cache()
    return out


DIST_CASES.update({"mesh_forward": _case_mesh_forward, "serve_mesh": _case_serve_mesh})


def mesh_phases(cfg, dev, smi: str, *, cli_argv=MESH_CLI_ARGV) -> dict:
    """mesh_forward, serve_mesh (one 2-rank spawn on `dev`) and
    serve_cli_mesh; returns each kernel's launches over every rank's
    main-path runs, for the kernels line's `mesh_launches`."""
    import os
    import statistics
    import tempfile

    import torch

    from glom_tpu_torch.serve.paged_columns import resolve_page_tokens
    from glom_tpu_torch.utils.config import ServeConfig

    cfg_kw = dict(dim=cfg.dim, levels=cfg.levels, image_size=cfg.image_size,
                  patch_size=cfg.patch_size)
    page_tokens = resolve_page_tokens(cfg, ServeConfig())
    total = {key: 0 for key in DIST_COUNTERS}

    def add(counts):
        for key, v in counts.items():
            total[key] += v

    # The kernels count launches on the card only (a CPU run, the dry run of
    # these phases, takes the plain versions).
    counted = dev.type == "cuda"
    t0 = time.perf_counter()
    res = _dist_spawn(2, [("mesh_forward", {"cfg_kw": cfg_kw}),
                          ("serve_mesh", {"cfg_kw": cfg_kw})], str(dev))
    spawn_s = time.perf_counter() - t0

    # -- mesh_forward ----------------------------------------------------------------
    fwd = [r[0] for r in res]
    k = MESH_T
    want = {"data2": _full({"K1 fwd": 2 * k, "K1 fwd add": k, "K2 fwd": k}),
            "ring": _full({"K1 fwd": 2 * k, "K1 fwd add": k}),
            "ulysses": _full({"K1 fwd": 2 * k, "K1 fwd add": k})}
    rows, ok = {}, True
    for name in want:
        for r in fwd:
            add(r[name]["launches"])
        exact = all(r[name]["launches"] == want[name] for r in fwd) or not counted
        row = dict(fwd[0][name], exact_launches=exact, want_per_rank=want[name],
                   launches_by_rank=[r[name]["launches"] for r in fwd],
                   bf16_p50_ms_by_rank=[statistics.median(r[name]["bf16_ms"][1:]) for r in fwd])
        row.pop("launches")
        rows[name] = row
        ok = ok and exact and all(row[key]["ok"] for key in ("final", "return_all",
                                                             "with_levels"))
        ok = ok and all(r[name]["bf16_finite"] for r in fwd)
    emit("mesh_forward", nvidia_smi=smi, backend="gloo", ranks_on=str(dev), iters=k,
         bars=MESH_F32, meshes=rows, spawn_seconds=spawn_s, ok=ok)
    if not ok:
        raise AssertionError("mesh_forward failed its bars")

    # -- serve_mesh --------------------------------------------------------------------
    lead, fol = res[0][1], res[1][1]
    srows, ok = {}, True
    for spec in MESH_ENGINES:
        nm = spec["name"]
        a, b = lead[nm], fol[nm]
        add(a["launches"])
        add(b["launches"])
        if nm.startswith("f32"):
            # One fixed dispatch of T on each rank, K1 only (the reference
            # layout with the plain consensus).
            want_l = _full({"K1 fwd": 2 * k})
            exact = (a["launches"] == want_l and b["launches"] == want_l) or not counted
            srows[nm] = dict(ok=a["ok"] and exact, max_abs_err=a["max_abs_err"],
                             bar_ratio=a["bar_ratio"], exact_launches=exact,
                             launches=[a["launches"], b["launches"]], want_per_rank=want_l)
            ok = ok and a["ok"] and exact
            continue
        dp, seq = spec.get("mesh_data", 1), spec.get("mesh_seq", 1)
        # Iterations a rank ran: 2 warm-ups, the dispatches in turns, the
        # warm carry and the 24-iteration cold one, the paged one, and the
        # fault spec's 2 dispatches that ran a body (the transient failure's
        # retry, and the one after the kernel fault; the transient attempt
        # stops at the status before the body). The kernel fault's attempt
        # fails in the follower's compute step, so the leader alone runs its
        # band of T there.
        iters = (2 * k + MESH_DISPATCHES * 2 * k + k + 2 * k
                 + (k if "page_gather" in spec else 0) + (2 * k if spec.get("fault") else 0))
        want_l = _full({"K1 fwd": 2 * iters})
        want_lead = _full({"K1 fwd": 2 * (iters + (k if spec.get("fault") else 0))})
        exact = (a["launches"] == want_lead and b["launches"] == want_l) or not counted
        formula, got = {}, {}
        for r in a["stats"]:
            key = "auto" if r["iters"] == "auto" else f"{r['iters']}:{r['warm_state']}"
            got[key] = {kk: v for kk, v in r.items() if kk.startswith("comm_")}
            formula[key] = serve_wire_formula(
                cfg, MESH_BUCKET, dp, seq, auto=key == "auto",
                T=k if key == "auto" else int(r["iters"]),
                paged=spec["page_gather"] if r["warm_state"] == "paged" else None,
                pool_pages=MESH_POOL_PAGES, page_tokens=page_tokens)
        formula_ok = all(got[key] == formula[key] for key in got)
        row = dict(mesh=[dp, seq], auto_p50_ms=statistics.median(a["auto_ms"][1:]),
                   fixed_p50_ms=statistics.median(a["fixed_ms"][1:]),
                   exit_read_ms_p50=statistics.median(a["exit_read_ms"][1:]),
                   exit_read_share=statistics.median(
                       [r / t for r, t in zip(a["exit_read_ms"][1:], a["auto_ms"][1:])]),
                   auto_iters=a["auto_iters"], auto_bitwise_fixed=a["auto_bitwise_fixed"],
                   single_max_abs_err=a["single_max_abs_err"], single_atol=MESH_BF16_ATOL,
                   warm_bitwise_cold24=a["warm_bitwise_cold24"],
                   warm_levels0_bytes=a["warm_levels0_bytes"],
                   counted=got, glom_tpu_formula=formula,
                   counted_equal_formula=formula_ok, staged=a["staged"], wire_leader=a["wire"],
                   wire_follower=b["wire"], follower_ops=b["ops"], exact_launches=exact,
                   launches=[a["launches"], b["launches"]], want_per_rank=[want_lead, want_l],
                   auto_ms=a["auto_ms"], fixed_ms=a["fixed_ms"])
        okr = (exact and formula_ok and a["auto_bitwise_fixed"] and a["warm_bitwise_cold24"]
               and a["finite"] and a["auto_iters"] == k and a["single_ok"])
        if "page_gather" in spec:
            row.update(paged_bitwise_warm=a["paged_bitwise_warm"],
                       paged_levels0_bytes=a["paged_levels0_bytes"], pool=a["pool"])
            okr = okr and a["paged_bitwise_warm"] and a["paged_levels0_bytes"] == 0
        if spec.get("fault"):
            row.update(kernel_fault=a["kernel_fault"], fault_served=a["fault_served_bitwise"],
                       follower_failed=b["failed"])
            okr = okr and a["kernel_fault"] == "KernelError" and a["fault_served_bitwise"] \
                and b["failed"] == 2
        row["ok"] = okr
        srows[nm] = row
        ok = ok and okr
    pool_bits = bool(torch.equal(lead["bf16_data2_pool"]["paged_levels"],
                                 lead["bf16_data2_needed"]["paged_levels"]))
    ok = ok and pool_bits
    emit("serve_mesh", nvidia_smi=smi, backend="gloo", bucket=MESH_BUCKET, iters=k,
         engines=srows, paged_pool_bitwise_needed=pool_bits,
         dispatch_p50_ms={nm: r.get("fixed_p50_ms") for nm, r in srows.items()}, ok=ok)
    if not ok:
        raise AssertionError("serve_mesh failed its checks")

    # -- serve_cli_mesh: torch.distributed.run, 2 ranks on the card ---------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="glom_serve_mesh_cli_") as tmp:
        out = os.path.join(tmp, "serve.jsonl")
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "--monitor-interval", "0.1", "-m",
                "glom_tpu_torch.serve", *cli_argv, "--device", str(dev), "--out", out]
        proc = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        lint = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", out],
                              capture_output=True, text=True, timeout=120,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        recs = []
        if os.path.exists(out):
            with open(out) as fh:
                recs = [json.loads(ln) for ln in fh]
    summary = [r for r in recs if r.get("event") == "summary"]
    n_req = int(cli_argv[cli_argv.index("--synthetic") + 1])
    ok = (proc.returncode == 0 and lint.returncode == 0 and len(summary) == 1
          and summary[0]["n_served"] == summary[0]["n_requests"] == n_req
          and summary[0]["n_failed"] == 0)
    stats = [r for r in recs if r.get("event") == "bucket_stats"]
    emit("serve_cli_mesh", nvidia_smi=smi, argv=cli_argv, rc=proc.returncode,
         lint_rc=lint.returncode, summary={kk: v for kk, v in (summary[0] if summary else {})
                                           .items() if isinstance(v, (int, float, str))},
         bucket_stats=[{kk: r.get(kk) for kk in ("bucket", "iters", "warm_state",
                                                  "step_time_p50_ms",
                                                  "comm_measured_bytes_per_step")}
                       for r in stats],
         seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError(f"serve_cli_mesh: rc {proc.returncode}, lint {lint.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return dist_kernel_launches(total)


# -- sharded execution finished (dist_tp_levels, serve_mesh_pool, ----------------
# serve_cli_mesh_elastic). Two gloo ranks on the card in one spawn, then the
# serve CLI under torch.distributed.run with six ranks (three engine groups).
LEVELS_GATHER_SITE = "tp_levels_all_gather"
POOL_MESH_PAGES = 96  # 48 a rank
POOL_ATOL = 0.05  # delta_page_atol: a frame's changed pages move by 0.5
POOL_CHAIN_CAP = 3
POOL_STREAMS = 4
POOL_FRAMES = 6
ELASTIC_MESH_RANKS = 6
ELASTIC_MESH_RAMP = "8x20,240x0,120x40"
ELASTIC_MESH_ARGV = ["--preset", "imagenet224-dp8", "--mesh-data", "2", "--buckets", "2,4,8,16",
                     "--dist-backend", "gloo", "--elastic", "--min-engines", "1",
                     "--max-engines", "3", "--warm-pool", "1", "--streams", "64",
                     "--ramp", ELASTIC_MESH_RAMP, "--queue-depth", "512",
                     "--elastic-p99-ms", "500", "--elastic-window", "1",
                     "--elastic-low-water", "0.3", "--elastic-high-water", "0.5",
                     "--elastic-dwell", "0.05", "--elastic-cooldown", "0.5",
                     "--elastic-interval", "0.05", "--elastic-settle", "20"]


def _case_tp_levels(rank, device, cfg_kw):
    """tp_axis="levels" at model 2 on the flagship: bottom_up's 3 groups a
    rank at full f, top_down's hidden shard at f = 1024; f32 gradients
    against the single device; bf16 steps timed with exact launches, the
    (G, f, addend) of each K1 call of one step and the counted gathers."""
    import torch

    from glom_tpu_torch.parallel import manual
    from glom_tpu_torch.parallel.mesh import make_mesh
    from glom_tpu_torch.telemetry import counters as tele_counters
    from glom_tpu_torch.utils.config import GlomConfig, MeshConfig, TrainConfig

    cfg, dev = GlomConfig(**cfg_kw), torch.device(device)
    mesh, _ = make_mesh(MeshConfig(model=2), devices=[device] * 2, backend="gloo")
    f32 = _dist_f32_grads(mesh, cfg, DIST_SP_BATCH, "none", dev, rank, tp_axis="levels")
    torch.cuda.empty_cache()
    tcfg = TrainConfig(batch_size=DIST_SP_BATCH, compute_dtype="bfloat16", use_pallas=True)
    sites = tele_counters.CollectiveCounters()
    calls, vjp = [], manual.grouped_ffw_lm_vjp

    def recording_vjp(p, x, add=None):
        if len(calls) < 64:
            calls.append((int(p.w1.shape[0]), int(p.w1.shape[-1]), add is not None))
        return vjp(p, x, add=add)

    manual.grouped_ffw_lm_vjp = recording_vjp
    try:
        run = _dist_train(MeshConfig(model=2), cfg, tcfg, "none", dev, DIST_STEPS, SEED + 44,
                          single=True, tp_axis="levels", sites=sites)
    finally:
        manual.grouped_ffw_lm_vjp = vjp
    tr = run.pop("trainer")
    run.update(f32=f32, vjp_path=tr.vjp_path, k1_calls=calls, sites=sites.sites,
               bottom_up_groups=int(tr.state.params.glom.bottom_up.w1.shape[0]))
    return run


def _pool_rows(cfg, pt, n_streams, frames, seed):
    """Each stream's rows frame by frame ([n, L, d] bf16 on the host, pages
    of `pt` tokens): frame 0 a seeded row (streams 0 and 1 the same row: a
    shared content hash), then each frame moves one or two pages by 0.5
    (past POOL_ATOL) and a few tokens of another by 1e-3 (under it)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    shape = (cfg.num_patches, cfg.levels, cfg.dim)
    base = [torch.randn(shape, generator=g).to(torch.bfloat16) for _ in range(n_streams)]
    base[1] = base[0].clone()
    k = cfg.num_patches // pt
    out = []
    for s in range(n_streams):
        rows, row = [base[s]], base[s]
        for f in range(1, frames):
            row = row.clone()
            pages = [(s + f) % k] + ([(s + f + 1) % k] if f % 2 else [])
            for pg in pages:
                row[pg * pt:(pg + 1) * pt] += 0.5
            quiet = (s + f + 2) % k
            row[quiet * pt:quiet * pt + 2] += 1e-3
            rows.append(row)
        out.append(rows)
    return out


def _case_serve_mesh_pool(rank, device, cfg_kw):
    """A data-2 sharded engine's 96-page pool with delta streams, and a
    single-device pool, driven by the same rows: every write's answer,
    the tables, free lists, records and events after it, and each session's
    read-back (host and device) bit for bit; the host ms of each write on
    both; then one warm dispatch of bucket 8 from the streams' delta pages
    against the same engine's host-carried dispatch; then defrag on a
    non-delta sharded pool against the single-device pool's."""
    import dataclasses

    import torch

    from glom_tpu_torch.models.core import init_glom
    from glom_tpu_torch.parallel.serve_mesh import make_serve_mesh
    from glom_tpu_torch.serve.engine import InferenceEngine
    from glom_tpu_torch.serve.mesh_follower import run_follower
    from glom_tpu_torch.serve.paged_columns import PagedColumnPool, content_hash
    from glom_tpu_torch.utils.config import GlomConfig, ServeConfig

    cfg, dev = GlomConfig(**cfg_kw), torch.device(device)
    scfg = ServeConfig(buckets=(MESH_BUCKET,), max_batch=MESH_BUCKET, iters="auto",
                       exit_threshold=0.0, max_auto_iters=MESH_T, compute_dtype="bfloat16",
                       use_pallas=True, dispatch_retries=0, mesh_data=2,
                       page_pool_pages=POOL_MESH_PAGES, delta_streaming=True,
                       delta_page_atol=POOL_ATOL, delta_chain_cap=POOL_CHAIN_CAP)
    plain = dataclasses.replace(scfg, delta_streaming=False)
    out = {}
    for name, sc in (("delta", scfg), ("defrag", plain)):
        mesh = make_serve_mesh(sc)
        if rank != mesh.leader:
            _sync(dev)
            _dist_counts(reset=True)
            stats = run_follower(mesh, dev)
            _sync(dev)
            out[name] = {"ops": stats["ops"], "launches": _dist_counts(),
                         "wire": dict(stats["wire"])}
            continue
        params = init_glom(cfg, generator=torch.Generator().manual_seed(SEED))
        taps = {"sharded": _Tap(), "single": _Tap()}
        eng = InferenceEngine(cfg, sc, params=params, device=dev, mesh=mesh, name="pool",
                              writer=taps["sharded"])
        single = PagedColumnPool(cfg, dataclasses.replace(sc, mesh_data=1),
                                 writer=taps["single"], name="pool", device=dev)
        pools = {"sharded": eng.pool, "single": single}
        sessions = [f"s{i}" for i in range(POOL_STREAMS if name == "delta" else 14)]

        def state(pool, tap):
            recs = [{k: v for k, v in r.items() if k != "backend_state"} for r in tap.recs]
            tap.recs.clear()
            return {"free": list(pool._free), "record": pool.record(), "events": recs,
                    "table": {s: pool.lookup(s) for s in sessions}}

        mismatches, ms = [], {"sharded": [], "single": []}
        steps = 0
        try:
            def both(method, *args, **kw):
                nonlocal steps
                steps += 1
                got = {}
                for key, pool in pools.items():
                    _sync(dev)
                    t0 = time.perf_counter()
                    got[key] = getattr(pool, method)(*args, **kw)
                    _sync(dev)
                    ms[key].append(1e3 * (time.perf_counter() - t0))
                sh, si = (state(pools[k], taps[k]) for k in ("sharded", "single"))
                if got["sharded"] != got["single"] or sh != si:
                    mismatches.append((steps, method, str(got)[:300]))
                for sid in sessions:
                    a = pools["sharded"].read_block(sid, on_device=sid == sessions[0])
                    b = pools["single"].read_block(sid)
                    if (a is None) != (b is None) or (a is not None and not torch.equal(
                            a.cpu().view(torch.int16), b.view(torch.int16))):
                        mismatches.append((steps, f"read {sid}"))

            if name == "delta":
                rows = _pool_rows(cfg, eng.pool.page_tokens, POOL_STREAMS, POOL_FRAMES,
                                  SEED + 70)
                for f in range(POOL_FRAMES):
                    for s, sid in enumerate(sessions):
                        kw = {"content_hash": content_hash(rows[s][0])} if f == 0 else {}
                        both("write_back_stream", sid, rows[s][f].to(dev), cfg.num_patches,
                             **kw)
                # The streams' columns as the pool holds them (pages moved by
                # less than the atol kept their earlier frame's values).
                held = [pools["sharded"].read_block(sid) for sid in sessions]
                page_rows = torch.tensor([eng.pool.lookup(sessions[i % POOL_STREAMS])[0]
                                          for i in range(MESH_BUCKET)], dtype=torch.int32)
                img = torch.randn((MESH_BUCKET, cfg.channels, cfg.image_size, cfg.image_size),
                                  generator=torch.Generator().manual_seed(SEED + 71))
                _sync(dev)
                _dist_counts(reset=True)
                paged = eng.infer(img, page_rows=page_rows.numpy())
                carried = eng.infer(img, levels0=torch.stack(
                    [held[i % POOL_STREAMS] for i in range(MESH_BUCKET)]))
                _sync(dev)
                res = dict(launches=_dist_counts(), paged_levels0_bytes=paged.levels0_h2d_bytes,
                           carried_levels0_bytes=carried.levels0_h2d_bytes,
                           paged_bitwise_carried=bool(torch.equal(paged.levels, carried.levels)),
                           paged_iters=paged.iters_run, finite=bool(
                               paged.levels.float().isfinite().all()))
            else:
                rows = _pool_rows(cfg, eng.pool.page_tokens, len(sessions), 1, SEED + 72)
                for s, sid in enumerate(sessions):
                    both("write_back", sid, rows[s][0].to(dev), cfg.num_patches)
                for sid in sessions[:12:2]:
                    both("free", sid)
                both("defrag")
                res = {"moves": eng.pool.record()["n_defrag_moves"]}
            res.update(mismatches=mismatches[:20], n_mismatches=len(mismatches), steps=steps,
                       write_ms=ms, record=eng.pool.record(), wire=dict(eng._mesh.channel.wire))
            out[name] = res
        finally:
            eng.close()
            del single
            torch.cuda.empty_cache()
    return out


DIST_CASES.update({"tp_levels": _case_tp_levels, "serve_mesh_pool": _case_serve_mesh_pool})


def _elastic_cli_rank(check_path: str, argv: list) -> int:
    """One rank of `python -m torch.distributed.run ... chip_smoke.py
    --serve-cli-rank CHECK ARGV...`: `python -m glom_tpu_torch.serve ARGV`,
    with rank 0's drain migrations checked page for page into CHECK as
    JSON: each row the migration read from the drained pool against the
    destination's read-back right after the migration's write (both through
    their rank groups). A read-back that another write of the destination
    pool overtook (traffic goes on during a drain) counts as raced, not
    checked."""
    import os
    import threading

    import torch

    from glom_tpu_torch.serve import cli
    from glom_tpu_torch.serve.column_cache import ColumnCache

    checks = []
    migrate = ColumnCache.migrate_engine_sessions

    def checked(cache, src, dst, **kw):
        pool = (cache.pools or {}).get(dst)
        row = {"src": src, "dst": dst, "checked": 0, "bitwise": 0, "raced": 0}
        me = threading.get_ident()
        wrapped = {}
        if pool is not None:
            for name in ("write_back", "write_back_stream"):
                orig = getattr(pool, name)

                def write(sid, levels, n_tokens, _orig=orig, **wkw):
                    before = pool.n_writebacks
                    got = _orig(sid, levels, n_tokens, **wkw)
                    # the migration's own writes (the batcher's workers
                    # write the pool too meanwhile)
                    if got and threading.get_ident() == me:
                        back = pool.read_block(sid)
                        if pool.n_writebacks != before + 1:
                            row["raced"] += 1
                        else:
                            row["checked"] += 1
                            row["bitwise"] += int(back is not None and torch.equal(
                                back.view(torch.int16),
                                levels[:n_tokens].cpu().view(torch.int16)))
                    return got

                wrapped[name] = write
                setattr(pool, name, write)
        t0 = time.perf_counter()
        try:
            got = migrate(cache, src, dst, **kw)
        finally:
            for name in wrapped:
                delattr(pool, name)
        row.update(ms=1e3 * (time.perf_counter() - t0), **got)
        checks.append(row)
        return got

    ColumnCache.migrate_engine_sessions = checked
    try:
        rc = cli.main(argv)
    finally:
        ColumnCache.migrate_engine_sessions = migrate
    # cli.main has taken its process group down: the launcher's RANK says
    # which rank this is.
    if int(os.environ.get("RANK", "0")) == 0:
        with open(check_path, "w") as fh:
            json.dump({"migrations": checks}, fh)
    return rc


def sharded_phases(cfg, dev, smi: str, *, cli_argv=ELASTIC_MESH_ARGV) -> tuple:
    """dist_tp_levels and serve_mesh_pool (one 2-rank spawn on `dev`), then
    serve_cli_mesh_elastic (six ranks under torch.distributed.run, the serve
    CLI with `cli_argv`); returns the launches of each kernel over every
    rank's main-path runs: (the levels TP steps', the pool engine's
    dispatches')."""
    import os
    import statistics
    import tempfile

    from glom_tpu_torch.train import default_recon_index

    cfg_kw = dict(dim=cfg.dim, levels=cfg.levels, image_size=cfg.image_size,
                  patch_size=cfg.patch_size)
    counted = dev.type == "cuda"
    t0 = time.perf_counter()
    res = _dist_spawn(2, [("tp_levels", {"cfg_kw": cfg_kw}),
                          ("serve_mesh_pool", {"cfg_kw": cfg_kw})], str(dev))
    spawn_s = time.perf_counter() - t0

    # -- dist_tp_levels -----------------------------------------------------------------
    k = default_recon_index(cfg.default_iters)
    tp = [r[0] for r in res]
    train_total = {key: 0 for key in DIST_COUNTERS}
    for r in tp:
        for c in r["launches"]:
            for key, v in c.items():
                train_total[key] += v
    worst, loss_rel, errs = tp[0]["f32"]
    bf16_rel = max(abs(a - b) / abs(b) for a, b in zip(tp[0]["losses"], tp[0]["single_losses"]))
    want = _full(_per_op_launches(k, with_k2=True))
    exact = all(c == want for r in tp for c in r["launches"]) or not counted
    L, f = cfg.levels, cfg.dim * cfg.mult
    want_calls = [(L // 2, f, False), (L - 1, f // 2, True)] * k
    calls_ok = all(r["k1_calls"][:2 * k] == want_calls for r in tp)
    # The design's count: one [L/2, b, n, d] bf16 shard into each rank a
    # gather, k forward and k backward gathers a step.
    shard = (L // 2) * DIST_SP_BATCH * cfg.num_patches * cfg.dim * 2
    sites = [[st for st in r["sites"] if st["site"] == LEVELS_GATHER_SITE] for r in tp]
    gathered = [sum(st["wire_bytes"] * st["calls"] for st in rs) for rs in sites]
    gather_ok = gathered == [2 * k * shard] * 2
    p50 = [statistics.median(r["ms"][1:]) for r in tp]
    ok = (worst <= TRAIN_F32_BAR and bf16_rel < 1e-2 and exact and calls_ok and gather_ok
          and tp[0]["bottom_up_groups"] == L // 2)
    emit("dist_tp_levels", nvidia_smi=smi, backend="gloo", batch=DIST_SP_BATCH,
         tp_axis="levels", bottom_up_groups_per_rank=tp[0]["bottom_up_groups"],
         vjp_path=tp[0]["vjp_path"], f32_worst=worst, f32_loss_rel_err=loss_rel,
         f32_err_over_max=errs, f32_bar=TRAIN_F32_BAR, f32_bar_ratio=worst / TRAIN_F32_BAR,
         bf16_losses=tp[0]["losses"], single_losses=tp[0]["single_losses"],
         bf16_worst_rel_loss=bf16_rel, bf16_bar=1e-2, k1_calls_first_step=tp[0]["k1_calls"][:2],
         k1_calls_as_designed=calls_ok, gather_sites=sites[0],
         gather_bytes_per_step=gathered, gather_bytes_design=2 * k * shard,
         gather_equal_design=gather_ok, launches_per_step=tp[0]["launches"][-1],
         want_per_step=want, exact_launches=exact, step_ms=[r["ms"] for r in tp],
         step_p50_ms=p50, dist_tp2_step_p50_ms=DIST_P50.get("tp2"),
         staged=[r["staged"][0] for r in res], spawn_seconds=spawn_s, ok=ok)
    if not ok:
        raise AssertionError("dist_tp_levels failed its bars")

    # -- serve_mesh_pool ------------------------------------------------------------------
    lead, fol = res[0][1], res[1][1]
    pool_total = {key: 0 for key in DIST_COUNTERS}
    d, fd = lead["delta"], fol["delta"]
    for c in (d["launches"], fd["launches"]):
        for key, v in c.items():
            pool_total[key] += v
    # Two dispatches (paged and host-carried) of T iterations a rank.
    want_l = _full({"K1 fwd": 2 * 2 * MESH_T})
    exact = (d["launches"] == want_l and fd["launches"] == want_l) or not counted
    dl = d["record"].get("delta", {})
    ok = (d["n_mismatches"] == 0 and lead["defrag"]["n_mismatches"] == 0 and exact
          and d["paged_levels0_bytes"] == 0 and d["paged_bitwise_carried"] and d["finite"]
          and dl.get("n_compactions", 0) >= 1
          and dl.get("n_base_shares", 0) >= 1 and lead["defrag"]["moves"] > 0)
    emit("serve_mesh_pool", nvidia_smi=smi, backend="gloo", pages=POOL_MESH_PAGES,
         delta_page_atol=POOL_ATOL, delta_chain_cap=POOL_CHAIN_CAP, streams=POOL_STREAMS,
         frames=POOL_FRAMES, steps={nm: lead[nm]["steps"] for nm in ("delta", "defrag")},
         mismatches={nm: lead[nm]["mismatches"] for nm in ("delta", "defrag")},
         write_ms_p50={nm: {key: statistics.median(v) for key, v in lead[nm]["write_ms"].items()}
                       for nm in ("delta", "defrag")},
         write_ms=lead["delta"]["write_ms"], delta=dl, defrag_moves=lead["defrag"]["moves"],
         paged_levels0_bytes=d["paged_levels0_bytes"],
         carried_levels0_bytes=d["carried_levels0_bytes"],
         paged_bitwise_carried=d["paged_bitwise_carried"], wire_leader=d["wire"],
         wire_follower=fd["wire"], follower_ops={nm: fol[nm]["ops"] for nm in fol},
         launches=[d["launches"], fd["launches"]], want_per_rank=want_l, exact_launches=exact,
         ok=ok)
    if not ok:
        raise AssertionError("serve_mesh_pool failed its checks")

    # -- serve_cli_mesh_elastic: torch.distributed.run, six ranks on the card -----------
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="glom_serve_elastic_mesh_") as tmp:
        out, check = os.path.join(tmp, "serve.jsonl"), os.path.join(tmp, "migrations.json")
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(ELASTIC_MESH_RANKS), "--monitor-interval", "0.1",
                os.path.abspath(__file__), "--serve-cli-rank", check, *cli_argv,
                "--device", str(dev), "--out", out]
        proc = subprocess.run(argv, capture_output=True, text=True, timeout=600, cwd=root)
        cli_s = time.perf_counter() - t0
        lint = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", out],
                              capture_output=True, text=True, timeout=120, cwd=root)
        audit = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", "audit", out],
                               capture_output=True, text=True, timeout=120, cwd=root)
        recs, migrations = [], []
        if os.path.exists(out):
            with open(out) as fh:
                recs = [json.loads(ln) for ln in fh if ln.startswith("{")]
        if os.path.exists(check):
            with open(check) as fh:
                migrations = json.load(fh)["migrations"]
    summary = [r for r in recs if r.get("event") == "summary"]
    s = summary[-1] if summary else {}
    el = s.get("elastic") or {}
    ramp = cli_argv[cli_argv.index("--ramp") + 1]
    n_ramp = sum(int(p.split("x")[0]) for p in ramp.split(","))
    served = sorted(r["id"] for r in recs if r.get("event") == "response" and r.get("ok"))
    # Each decision's chain in order: the decisions numbered in turn, every
    # event after the decision it names (the audit replays the rest).
    last, chains_ok = 0, True
    for r in recs:
        if r.get("kind") == "decision":
            chains_ok = chains_ok and r["decision_id"] == last + 1
            last = r["decision_id"]
        elif r.get("decision_id") is not None and r.get("kind") == "serve":
            chains_ok = chains_ok and 1 <= r["decision_id"] <= last
    decided = {r["decision_id"]: r["wall_time"] for r in recs if r.get("kind") == "decision"}
    admissions = [(r["engine"], round(1e3 * (r["wall_time"] - decided[r["decision_id"]]), 3),
                   r.get("spare") is True or any(
                       q.get("event") == "spare_promote" and q["decision_id"] == r["decision_id"]
                       for q in recs))
                  for r in recs if r.get("event") == "admission_open"]
    releases = [{"engine": r["engine"], "freed_mib_by_rank": {
        rk: b / 2 ** 20 for rk, b in r["freed_bytes_by_rank"].items()}}
        for r in recs if r.get("event") == "engine_release" and "freed_bytes_by_rank" in r]
    groups = [(r["group"], r["state"], r["generation"]) for r in recs
              if r.get("event") == "rank_group"]
    migrated_ok = (sum(m["checked"] for m in migrations) > 0
                   and all(m["bitwise"] == m["checked"] for m in migrations))
    ok = (proc.returncode == 0 and lint.returncode == 0 and audit.returncode == 0
          and len(summary) == 1 and s.get("n_requests") == s.get("n_served") == n_ramp
          and served == list(range(n_ramp)) and chains_ok and migrated_ok
          and el.get("n_promotions", 0) >= 1 and el.get("n_scale_outs", 0) >= 1
          and el.get("n_scale_ins", 0) >= 1
          and all(all(b > 0 for rk, b in rel["freed_mib_by_rank"].items() if rk != "0")
                  for rel in releases))
    emit("serve_cli_mesh_elastic", nvidia_smi=smi, ranks=ELASTIC_MESH_RANKS,
         argv=cli_argv, rc=proc.returncode, lint_rc=lint.returncode,
         audit_rc=audit.returncode, seconds=cli_s, requests=s.get("n_requests"),
         served=s.get("n_served"), served_once=served == list(range(n_ramp)),
         chains_in_order=chains_ok, elastic={kk: v for kk, v in el.items()
                                             if isinstance(v, (int, float, str, list))},
         decision_to_admission_ms=admissions, releases=releases, rank_groups=groups,
         migrations=migrations, migrated_bitwise=migrated_ok, ok=ok,
         stderr_tail=None if ok else (proc.stderr[-3000:] + audit.stderr[-500:]))
    if not ok:
        raise AssertionError(f"serve_cli_mesh_elastic: rc {proc.returncode}, lint "
                             f"{lint.returncode}, audit {audit.returncode}")
    return dist_kernel_launches(train_total), dist_kernel_launches(pool_total)


# -- telemetry's measuring half (train_telemetry_full, dist_collective_timing, --------
# serve_mesh_timing, train_cli_trace, watchdog). The two rank phases share one
# 2-rank spawn on the card over gloo; the rest run in this process.
TIMING_ARMS = ("off", "sampled", "full")
TIMING_STEPS = 3
TIMING_ROUNDS = 10  # dispatches an arm, in turns, after each arm's warm-up
TIMING_INTERVAL = 2  # the serve engine's sampled arm samples every 2nd dispatch
WATCHDOG_STEPS = 400  # long enough that the first probe (a fresh python) answers
TRACE_KERNELS = ("mlp_fwd_hidden_bf16", "consensus_update_kernel_bf16")


def _case_coll_timing(rank, device, cfg_kw):
    """ZeRO stage 1 on 2 data ranks, f32 at DIST_ZERO_BATCH, telemetry
    "scalars", through DistributedTrainer.fit (log_every 1) with collective
    timing "off", "sampled" (interval 1: a sample at every logging step)
    and "full" (degraded to "sampled"): per arm the losses, the writer
    rank's collective_time records, the construction's warnings, the counted
    bytes, the step ms and the launches over the fit."""
    import warnings

    import torch

    from glom_tpu_torch.data import shapes_dataset
    from glom_tpu_torch.parallel import DistributedTrainer
    from glom_tpu_torch.utils.config import GlomConfig, MeshConfig, TrainConfig

    class Records:
        def __init__(self):
            self.records = []

        def write(self, rec):
            self.records.append(rec)

    cfg, dev = GlomConfig(**cfg_kw), torch.device(device)
    params = _dist_params(cfg, SEED)
    out = {}
    for arm in TIMING_ARMS:
        tcfg = TrainConfig(batch_size=DIST_ZERO_BATCH, use_pallas=True, telemetry_level="scalars",
                           learning_rate=1e-3, zero_stage=1, collective_timing=arm,
                           collective_timing_interval=1)
        w = Records()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tr = DistributedTrainer(cfg, tcfg, MeshConfig(data=2), devices=[dev] * 2,
                                    backend="gloo", params=params, metrics_writer=w)
        _sync(dev)
        _dist_counts(reset=True)
        hist = tr.fit(shapes_dataset(tcfg.batch_size, cfg.image_size, seed=SEED + 42),
                      TIMING_STEPS, log_every=1)
        _sync(dev)
        launches = _dist_counts()
        steps = [r for r in w.records if r.get("kind") == "span"
                 and r.get("name") == "host_step_dispatch"]
        out[arm] = dict(
            losses=[r["loss"] for r in hist], launches=launches,
            warnings=[str(c.message) for c in caught],
            resolved=hist[-1]["collective_timing"],
            counted={k: hist[0][k] for k in ("comm_measured_bytes_per_step",
                                            "comm_measured_collective_count")},
            step_ms=[r["mean_ms"] for r in steps],
            rows=[r for r in w.records if r.get("kind") == "collective_time"])
        del tr
        torch.cuda.empty_cache()
    return out


def _case_serve_mesh_timing(rank, device, cfg_kw):
    """Three data-2 engines at the flagship, bucket 8, the auto route at
    threshold 0 with a budget of T = 12 (so every dispatch runs 12
    iterations and the exit sites), one a timing arm ("off", "sampled"
    every TIMING_INTERVAL-th dispatch, "full"), rank 0 leading all three and
    rank 1 following each in a thread of its own: a warm-up dispatch an
    arm, then TIMING_ROUNDS rounds of one dispatch an arm in turns; then
    each engine's records. Launches a rank over the engines' dispatches."""
    import dataclasses
    import threading

    import torch

    from glom_tpu_torch.models.core import init_glom
    from glom_tpu_torch.parallel.serve_mesh import make_serve_mesh
    from glom_tpu_torch.serve.engine import InferenceEngine
    from glom_tpu_torch.serve.mesh_follower import run_follower
    from glom_tpu_torch.utils.config import GlomConfig, ServeConfig

    cfg, dev = GlomConfig(**cfg_kw), torch.device(device)
    params = init_glom(cfg, generator=torch.Generator().manual_seed(SEED))
    img = torch.randn((MESH_BUCKET, cfg.channels, cfg.image_size, cfg.image_size),
                      generator=torch.Generator().manual_seed(SEED + 61))
    base = ServeConfig(buckets=(MESH_BUCKET,), max_batch=MESH_BUCKET, iters="auto",
                       exit_threshold=0.0, max_auto_iters=MESH_T, compute_dtype="bfloat16",
                       use_pallas=True, dispatch_retries=0, mesh_data=2,
                       collective_timing_interval=TIMING_INTERVAL)
    scfgs = {arm: dataclasses.replace(base, collective_timing=arm) for arm in TIMING_ARMS}
    meshes = {arm: make_serve_mesh(scfgs[arm]) for arm in TIMING_ARMS}  # every rank, in order
    _sync(dev)
    _dist_counts(reset=True)
    if rank != meshes["off"].leader:
        stats, errors = {}, {}

        def follow(arm):
            try:
                stats[arm] = run_follower(meshes[arm], dev)
            except BaseException as e:  # noqa: BLE001 - the phase reads it
                errors[arm] = f"{type(e).__name__}: {e}"

        threads = [threading.Thread(target=follow, args=(arm,)) for arm in TIMING_ARMS]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _sync(dev)
        return {"launches": _dist_counts(), "errors": errors,
                "ops": {arm: st["ops"] for arm, st in stats.items()}}
    engines = {arm: InferenceEngine(cfg, scfgs[arm], params=params, device=dev,
                                    mesh=meshes[arm], name=f"timing_{arm}")
               for arm in TIMING_ARMS}
    import numpy as np

    def same(a, b) -> bool:
        return (torch.equal(a.levels, b.levels) and a.iters_run == b.iters_run
                and np.array_equal(a.row_converged, b.row_converged)
                and np.array_equal(a.row_iters, b.row_iters))

    try:
        ms = {arm: [] for arm in TIMING_ARMS}
        bitwise = {arm: True for arm in TIMING_ARMS}
        for arm, eng in engines.items():
            eng.infer(img)  # the signature's first dispatch: its warm-up
        for _ in range(TIMING_ROUNDS):
            answers = {}
            for arm, eng in engines.items():
                _sync(dev)
                t0 = time.perf_counter()
                answers[arm] = eng.infer(img)
                ms[arm].append(1e3 * (time.perf_counter() - t0))
            for arm in TIMING_ARMS:
                bitwise[arm] = bitwise[arm] and same(answers[arm], answers["off"])
        rows = {arm: [{k: v for k, v in r.items() if isinstance(v, (int, float, str))
                       or v is None} for r in eng.collective_time_records()]
                for arm, eng in engines.items()}
        iters = {arm: answers[arm].iters_run for arm in TIMING_ARMS}
        finite = bool(answers["off"].levels.float().isfinite().all())
    finally:
        for eng in engines.values():
            eng.close()
    _sync(dev)
    return {"launches": _dist_counts(), "ms": ms, "bitwise": bitwise, "rows": rows,
            "iters": iters, "finite": finite}


DIST_CASES.update({"coll_timing": _case_coll_timing, "serve_mesh_timing": _case_serve_mesh_timing})


def telemetry_phases(cfg, dev, smi: str, *, cli_preset: str = "imagenet224-dp8") -> dict:
    """train_telemetry_full, dist_collective_timing and serve_mesh_timing
    (one 2-rank spawn on `dev`), train_cli_trace and watchdog (the CLI at
    `cli_preset`, batch 8); returns the
    launches of each kernel over every main-path run of these phases (every
    rank's), for the kernels line's `telemetry_launches`."""
    import contextlib
    import io
    import os
    import statistics
    import tempfile

    import torch

    from glom_tpu_torch.data import shapes_dataset
    from glom_tpu_torch.models.core import glom_forward, map_params
    from glom_tpu_torch.resilience.faults import InjectedFault
    from glom_tpu_torch.serve.engine import InferenceEngine
    from glom_tpu_torch.telemetry import watchdog as wd_mod
    from glom_tpu_torch.telemetry.diagnostics import level_agreement
    from glom_tpu_torch.train import Trainer, default_recon_index
    from glom_tpu_torch.train import cli as train_cli
    from glom_tpu_torch.train import trainer as trainer_mod
    from glom_tpu_torch.utils.config import ServeConfig, TrainConfig

    class Records:
        def __init__(self):
            self.records = []

        def write(self, rec):
            self.records.append(rec)

    counted = dev.type == "cuda"
    k = default_recon_index(cfg.default_iters)
    want_loop = _full(_loop_launches(k))
    total = {key: 0 for key in DIST_COUNTERS}

    def add(counts):
        for key, v in counts.items():
            total[key] += v

    def times(want, n):
        return {key: v * n for key, v in want.items()}

    # -- train_telemetry_full: batch 8 on the loop, bf16, then f32 --------------------
    t0 = time.perf_counter()
    dparams = _dist_params(cfg, SEED)
    w = Records()
    tr = Trainer(cfg, TrainConfig(batch_size=8, compute_dtype="bfloat16", use_pallas=True,
                                  telemetry_level="full"),
                 params=dparams, device=dev, metrics_writer=w)
    reads = []
    probe = tr._memory_record

    def read_and_compare():
        rec = probe()
        reads.append((rec.get("hbm_bytes_in_use"),
                      torch.cuda.memory_allocated(dev) if counted else None))
        return rec

    tr._memory_record = read_and_compare
    _sync(dev)
    _dist_counts(reset=True)
    hist = tr.fit(shapes_dataset(8, cfg.image_size, seed=SEED + 70), TIMING_STEPS, log_every=1)
    _sync(dev)
    bf16_launches = _dist_counts()
    add(bf16_launches)
    keys = [f"consensus_agreement_l{i}" for i in range(cfg.levels)]
    agreement = [[r.get(key) for key in keys] for r in hist]
    agree_ok = all(v is not None and math.isfinite(v) and -1.0 <= v <= 1.0
                   for row in agreement for v in row)
    exact_bf16 = bf16_launches == times(want_loop, TIMING_STEPS) or not counted
    hbm_ok = not counted or (all(a == b for a, b in reads) and all(
        {"hbm_bytes_in_use", "hbm_peak_bytes", "hbm_bytes_limit", "hbm_model_drift"} <= set(r)
        for r in hist))
    del tr
    # f32: the step's agreement against level_agreement on the plain route's
    # final state from the same parameters and image (noise_std 0).
    img = torch.from_numpy(next(shapes_dataset(8, cfg.image_size, seed=SEED + 71))).to(dev)
    with torch.no_grad():
        final = glom_forward(map_params(lambda t: t.to(dev), dparams.glom), img, cfg, iters=k,
                             use_pallas=False)
        want_agree = level_agreement(final).cpu()
    del final
    tr32 = Trainer(cfg, TrainConfig(batch_size=8, use_pallas=True, telemetry_level="full",
                                    noise_std=0.0), params=dparams, device=dev)
    _sync(dev)
    _dist_counts(reset=True)
    m = tr32.step(img)
    _sync(dev)
    f32_launches = _dist_counts()
    add(f32_launches)
    got_agree = m["level_agreement"].float().cpu()
    f32_err = float((got_agree - want_agree).abs().max())
    f32_route = tr32.vjp_path
    del tr32, m
    if counted:
        torch.cuda.empty_cache()
    exact_f32 = f32_launches == want_loop or not counted
    ok = (agree_ok and exact_bf16 and exact_f32 and hbm_ok and f32_err <= 1e-5
          and hist[0]["vjp_path"] == LOOP_ROUTE[dev.type] and f32_route == LOOP_ROUTE[dev.type])
    emit("train_telemetry_full", nvidia_smi=smi, batch=8, steps=TIMING_STEPS,
         vjp_path=hist[0]["vjp_path"], agreement_by_step=agreement, agreement_in_range=agree_ok,
         launches=bf16_launches, want=times(want_loop, TIMING_STEPS), exact_launches=exact_bf16,
         hbm_reads=reads, hbm_equals_memory_allocated=hbm_ok,
         hbm=[{kk: r.get(kk) for kk in ("hbm_bytes_in_use", "hbm_peak_bytes",
                                         "hbm_bytes_limit", "hbm_model_live_bytes",
                                         "hbm_model_drift")} for r in hist],
         step_p50_ms=hist[-1].get("step_time_p50_ms"),
         f32_agreement=got_agree.tolist(), f32_plain_agreement=want_agree.tolist(),
         f32_max_abs_err=f32_err, f32_bar=1e-5, f32_vjp_path=f32_route,
         f32_launches=f32_launches, f32_exact_launches=exact_f32,
         seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("train_telemetry_full failed its checks")

    # -- dist_collective_timing and serve_mesh_timing: one 2-rank spawn -----------------
    cfg_kw = dict(dim=cfg.dim, levels=cfg.levels, image_size=cfg.image_size,
                  patch_size=cfg.patch_size)
    t0 = time.perf_counter()
    res = _dist_spawn(2, [("coll_timing", {"cfg_kw": cfg_kw}),
                          ("serve_mesh_timing", {"cfg_kw": cfg_kw})], str(dev))
    spawn_s = time.perf_counter() - t0
    coll = [r[0] for r in res]
    lead = coll[0]
    for r in coll:
        for arm in TIMING_ARMS:
            add(r[arm]["launches"])
    off = lead["off"]
    arms, ok = {}, True
    for arm in ("sampled", "full"):
        a = lead[arm]
        rows = a["rows"]
        model_at = [i for i, r in enumerate(rows) if r["site"] == "comm_time_model"]
        sites = rows[:model_at[0]] if model_at else []
        last = rows[model_at[-2] + 1:model_at[-1]] if len(model_at) > 1 else sites
        counted_bytes = a["counted"]["comm_measured_bytes_per_step"]
        bytes_ok = sum(r["wire_bytes"] * r["calls"] for r in sites) == counted_bytes
        step_ms = statistics.median(a["step_ms"][1:]) if len(a["step_ms"]) > 1 else None
        # The isolated collectives' time a step (each site's sampled wall_ms x
        # its calls) against the step: an upper bound on the transport's share.
        comm_ms = sum(r["wall_ms"] * r["calls"] for r in last)
        bitwise = all(r[arm]["losses"] == r["off"]["losses"] for r in coll)
        same_launches = all(r[arm]["launches"] == r["off"]["launches"] for r in coll)
        warned = [x for x in a["warnings"] if "collective_timing" in x]
        okr = (len(model_at) == TIMING_STEPS and bytes_ok and bitwise and same_launches
               and a["resolved"] == "sampled" and coll[1][arm]["rows"] == []
               and all(r["wall_ms"] > 0 for r in sites)
               and (len(warned) == 1 if arm == "full" else not warned))
        arms[arm] = dict(
            resolved=a["resolved"], warnings=warned, samples=len(model_at),
            sites=[{kk: r.get(kk) for kk in ("site", "wire_bytes", "calls", "wall_ms",
                                              "bytes_per_s", "comm_time_model_drift")}
                   for r in last],
            comm_time_model={kk: rows[model_at[-1]].get(kk) for kk in (
                "alpha_ms", "beta_ms_per_byte", "n_points", "wall_ms",
                "comm_time_model_drift")} if model_at else None,
            wire_bytes_equal_counted=bytes_ok, counted=a["counted"],
            losses_bitwise_off=bitwise, launches_equal_off=same_launches,
            step_ms_p50=step_ms, sampled_comm_ms_a_step=comm_ms,
            transport_share_bound=comm_ms / step_ms if step_ms else None, ok=okr)
        ok = ok and okr
    emit("dist_collective_timing", nvidia_smi=smi, backend="gloo", zero_stage=1,
         global_batch=DIST_ZERO_BATCH, dtype="float32", steps=TIMING_STEPS,
         off_losses=off["losses"], off_step_ms=off["step_ms"], arms=arms,
         launches_by_rank=[r["sampled"]["launches"] for r in coll],
         spawn_seconds=spawn_s, ok=ok)
    if not ok:
        raise AssertionError("dist_collective_timing failed its checks")

    sm = [r[1] for r in res]
    lead_s, fol_s = sm[0], sm[1]
    add(lead_s["launches"])
    add(fol_s["launches"])
    dispatches = len(TIMING_ARMS) * (1 + TIMING_ROUNDS)
    want_s = _full({"K1 fwd": 2 * MESH_T * dispatches})
    exact = (lead_s["launches"] == want_s and fol_s["launches"] == want_s) or not counted
    full_rows = {r["site"]: r for r in lead_s["rows"]["full"]}
    samp_rows = lead_s["rows"]["sampled"]
    n_samples = (1 + TIMING_ROUNDS) // TIMING_INTERVAL
    both_ranks = full_rows.get("quorum_valid_psum", {}).get("calls") == 2 * (1 + TIMING_ROUNDS)
    want_ops = {"off": {"dispatch": 1 + TIMING_ROUNDS, "stop": 1},
                "sampled": {"dispatch": 1 + TIMING_ROUNDS, "sample": n_samples, "stop": 1},
                "full": {"dispatch": 1 + TIMING_ROUNDS, "drain": 1, "stop": 1}}
    ok = (exact and all(lead_s["bitwise"].values()) and lead_s["finite"]
          and set(lead_s["iters"].values()) == {MESH_T} and both_ranks
          and not fol_s["errors"] and fol_s["ops"] == want_ops
          and lead_s["rows"]["off"] == []
          and sum(r["site"] == "comm_time_model" for r in samp_rows) == n_samples)
    emit("serve_mesh_timing", nvidia_smi=smi, backend="gloo", bucket=MESH_BUCKET, iters=MESH_T,
         rounds=TIMING_ROUNDS, sampled_interval=TIMING_INTERVAL,
         dispatch_p50_ms={arm: statistics.median(v) for arm, v in lead_s["ms"].items()},
         dispatch_ms=lead_s["ms"], answers_bitwise_off=lead_s["bitwise"],
         full_records=list(full_rows.values()), sampled_records=samp_rows,
         full_calls_count_both_ranks=both_ranks, follower_ops=fol_s["ops"],
         follower_errors=fol_s["errors"], launches=[lead_s["launches"], fol_s["launches"]],
         want_per_rank=want_s, exact_launches=exact, ok=ok)
    if not ok:
        raise AssertionError("serve_mesh_timing failed its checks")

    # -- train_cli_trace: the CLI in process, a step window, then the whole run --------
    def run_cli(argv):
        out, err = io.StringIO(), io.StringIO()
        _sync(dev)
        _dist_counts(reset=True)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = train_cli.main(argv)
        _sync(dev)
        return rc, err.getvalue(), _dist_counts()

    def trace_names(path):
        with open(path) as fh:
            return {e.get("name", "") for e in json.load(fh).get("traceEvents", [])}

    reads = []
    memory_record = trainer_mod.memory_record

    def read_and_compare(model_live_bytes=None, device=None):
        rec = memory_record(model_live_bytes, device)
        reads.append((rec.get("hbm_bytes_in_use"),
                      torch.cuda.memory_allocated(device) if counted else None))
        return rec

    t0 = time.perf_counter()
    cli_steps = 4
    with tempfile.TemporaryDirectory(prefix="glom_trace_") as tmp:
        base = ["--preset", cli_preset, "--batch-size", "8", "--steps", str(cli_steps),
                "--log-every", "1", "--device", str(dev)]
        runs = {}
        trainer_mod.memory_record = read_and_compare
        try:
            for name, extra in (("trace_steps", ["--trace-steps", "2:3", "--trace-dir",
                                                 os.path.join(tmp, "window")]),
                                ("profile_dir", ["--profile-dir", os.path.join(tmp, "run")])):
                metrics = os.path.join(tmp, f"{name}.jsonl")
                rc, err, launches = run_cli(base + extra + ["--metrics-file", metrics])
                add(launches)
                with open(metrics) as fh:
                    recs = [json.loads(ln) for ln in fh]
                trace_dir = os.path.join(tmp, "window" if name == "trace_steps" else "run")
                files = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
                names = trace_names(os.path.join(trace_dir, files[0])) if len(files) == 1 else set()
                steps = [r for r in recs if r.get("kind") == "train_step"]
                runs[name] = dict(
                    rc=rc, trace_files=len(files),
                    trace_bytes=os.path.getsize(os.path.join(trace_dir, files[0]))
                    if files else 0,
                    kernels_named={kn: any(kn in n for n in names) for kn in TRACE_KERNELS},
                    step_markers=sorted(n for n in names if n.startswith("step#")),
                    notes=[(r["note"], r.get("first_step"), r.get("last_step"),
                            r.get("steps_captured")) for r in recs if r.get("kind") == "note"],
                    hbm_on_every_record=all(any(kk.startswith("hbm_") for kk in r)
                                            for r in steps) and bool(steps),
                    records=len(steps), launches=launches,
                    exact_launches=launches == times(want_loop, cli_steps) or not counted,
                    step_p50_ms=steps[-1].get("step_time_p50_ms") if steps else None,
                    stderr_tail=None if rc == 0 else err[-2000:])
        finally:
            trainer_mod.memory_record = memory_record
    w_run, p_run = runs["trace_steps"], runs["profile_dir"]
    hbm_equal = all(a == b for a, b in reads) and bool(reads)
    ok = (w_run["rc"] == 0 and p_run["rc"] == 0
          and w_run["notes"] == [("xla-trace-start", 2, None, None),
                                 ("xla-trace-stop", None, 3, 2)]
          and p_run["notes"] == [] and w_run["trace_files"] == 1 and p_run["trace_files"] == 1
          and w_run["step_markers"] == ["step#2", "step#3"]
          and ((w_run["hbm_on_every_record"] and p_run["hbm_on_every_record"]) or not counted)
          and w_run["exact_launches"] and p_run["exact_launches"]
          and (all(w_run["kernels_named"].values()) and all(p_run["kernels_named"].values())
               or not counted)
          and (hbm_equal or not counted))
    emit("train_cli_trace", nvidia_smi=smi, preset=cli_preset, batch=8,
         steps=cli_steps, runs=runs, hbm_reads=reads,
         hbm_equals_memory_allocated=hbm_equal, seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("train_cli_trace failed its checks")

    # -- watchdog: the CLI's heartbeat, then an injected fault through the retry -------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="glom_watchdog_") as tmp:
        metrics = os.path.join(tmp, "wd.jsonl")
        rc, err, launches = run_cli(["--preset", cli_preset, "--batch-size", "8",
                                     "--steps", str(WATCHDOG_STEPS), "--log-every", "20",
                                     "--device", str(dev), "--watchdog-interval", "1",
                                     "--metrics-file", metrics])
        add(launches)
        with open(metrics) as fh:
            recs = [json.loads(ln) for ln in fh]
    events = [(r.get("prev_state"), r.get("backend_state"), r.get("backend_devices"))
              for r in recs if r.get("kind") == "watchdog"]
    up_at = next((i for i, r in enumerate(recs) if r.get("kind") == "watchdog"), None)
    after = [r["backend_state"] for r in recs[up_at or 0:]
             if r.get("kind") == "train_step"] if up_at is not None else []
    cli_ok = (rc == 0 and events[:1] == [("unknown", "up", torch.cuda.device_count()
                                          if counted else 1)]
              and len(events) == 1 and bool(after) and set(after) == {"up"}
              and wd_mod.get_global_watchdog() is None
              and (launches == times(want_loop, WATCHDOG_STEPS) or not counted))
    # The state machine under a fault that makes the probe read no device
    # (an in-process count: the CLI run above exercised the subprocess
    # probe), and a dispatch through the engine's RetryPolicy while down.
    w = Records()
    n_dev = torch.cuda.device_count() if counted else 1
    wd = wd_mod.BackendWatchdog(interval_s=1.0, writer=w, flap_threshold=10,
                                probe=lambda timeout: n_dev)
    states = [wd.probe_once()]
    attempts = []

    def failing(ctx):
        attempts.append(ctx["attempt"])
        raise InjectedFault("an injected transient dispatch failure")

    eng = InferenceEngine(cfg, ServeConfig(buckets=(1,), max_batch=1, dispatch_retries=2,
                                           retry_backoff_ms=0.0), device=dev, fault_hook=failing)
    one = torch.zeros((1, cfg.channels, cfg.image_size, cfg.image_size))
    tried = {}
    wd_mod.set_global_watchdog(wd)
    try:
        for state in ("up", "down"):
            if state == "down":
                wd.set_probe_fault(lambda n: None)
                states.append(wd.probe_once())
            attempts.clear()
            try:
                eng.infer(one)
                tried[state] = ("served", list(attempts))
            except InjectedFault:
                tried[state] = ("raised", list(attempts))
        wd.set_probe_fault(None)
        states.append(wd.probe_once())
    finally:
        wd_mod.set_global_watchdog(None)
    retry_rec = eng.retry.record()
    del eng
    timeline = [(e["prev_state"], e["backend_state"]) for e in wd.timeline()]
    ok = (cli_ok and states == ["up", "down", "up"]
          and timeline == [("unknown", "up"), ("up", "down"), ("down", "up")]
          and tried["up"] == ("raised", [1, 2, 3]) and tried["down"] == ("raised", [1])
          and retry_rec["n_fast_failed"] == 1 and retry_rec["n_gave_up"] == 1)
    emit("watchdog", nvidia_smi=smi, cli_rc=rc, cli_steps=WATCHDOG_STEPS, cli_events=events,
         cli_records_after_up=len(after), cli_states_after_up=sorted(set(after)),
         cli_launches=launches, states=states, timeline=timeline,
         attempts_up=tried["up"][1], attempts_down=tried["down"][1], retry=retry_rec,
         seconds=time.perf_counter() - t0, ok=ok,
         stderr_tail=None if rc == 0 else err[-2000:])
    if not ok:
        raise AssertionError("watchdog failed its checks")
    return dist_kernel_launches(total)


# -- resilience: the chaos harness and the gang (resilience_phases) -------------------
# Every worker is a subprocess running the training CLI through this script:
# `--counted-train-cli DIR ARGV` appends each step's route and launches to
# DIR, and `--gang-cli-rank SPEC ARGV` is one rank of `--distributed
# --supervise` under torch.distributed.run, with SPEC's planted fault.
RES_STEPS = 6
RES_BATCH = 8
RES_KILL_AFTER = 2
# The preempt_train SIGTERMs land this long after the RES_KILL_AFTER-th
# committed checkpoint: at different points of a step or of its save.
PREEMPT_OFFSETS_S = (0.0, 0.35, 0.7)
GANG_BATCH = 16  # global: 8 a rank, on the loop
GANG_STEPS = 6
# The gang's group timeout: a rank left waiting in a collective by a failed
# peer raises after this.
GANG_TIMEOUT_S = 10.0
RES_TIMEOUT_S = 300
# resume_seek skips this many batches of the preset's batch.
SEEK_SKIP = 8


def _count_steps(cls, path: str):
    """Wrap cls.step and cls.step_fast so that each call appends its step,
    route and kernel launches to `path` (a step a SIGTERM ended writes
    nothing); returns the function that puts them back."""
    fh = open(path, "a", buffering=1)
    origs = {name: getattr(cls, name) for name in ("step", "step_fast")}
    for name, orig in origs.items():

        def counted(self, batch, _orig=orig):
            before = _dist_counts()
            metrics = _orig(self, batch)
            after = _dist_counts()
            fh.write(json.dumps({"step": int(self.state.step) - 1, "vjp_path": self.vjp_path,
                                 "launches": {k: after[k] - before[k] for k in after}}) + "\n")
            return metrics

        setattr(cls, name, counted)

    def restore():
        for name, orig in origs.items():
            setattr(cls, name, orig)
        fh.close()

    return restore


def _counted_train_cli(out_dir: str, argv: list) -> int:
    """`python -m glom_tpu_torch.train.cli ARGV`, each step counted into
    OUT_DIR/steps_<pid>.jsonl (the chaos harness's training worker)."""
    import os

    from glom_tpu_torch.train import cli as train_cli
    from glom_tpu_torch.train.trainer import Trainer

    _count_steps(Trainer, os.path.join(out_dir, f"steps_{os.getpid()}.jsonl"))
    return train_cli.main(argv)


def _sigterm_train_cli(out_dir: str, at: str, argv: list) -> int:
    """_counted_train_cli with this process SIGTERMing itself from inside
    its `at`-th optimizer step (0-based), before the in-place update: the
    save must wait for the step's end."""
    import os
    import signal

    from torch.optim.optimizer import register_optimizer_step_pre_hook

    count = [0]

    def hook(opt, args, kwargs):
        if count[0] == int(at):
            os.kill(os.getpid(), signal.SIGTERM)
        count[0] += 1

    register_optimizer_step_pre_hook(hook)
    return _counted_train_cli(out_dir, argv)


def _gang_cli_rank(spec_path: str, argv: list) -> int:
    """One rank of `python -m torch.distributed.run ... chip_smoke.py
    --gang-cli-rank SPEC ARGV`: the training CLI with SPEC's group timeout,
    each step counted, and SPEC's fault planted once on its rank in the
    first attempt ("boundary": the data stream raises before batch `at`;
    "in_step": the `at`-th optimizer step raises). Writes the exit code,
    the seconds and whether the fault fired to OUT/rank<r>.json."""
    import os

    from torch.optim.optimizer import register_optimizer_step_pre_hook

    import glom_tpu_torch.data as data_mod
    from glom_tpu_torch.parallel import mesh
    from glom_tpu_torch.parallel.runtime import DistributedTrainer
    from glom_tpu_torch.resilience import InjectedFault
    from glom_tpu_torch.train import cli as train_cli

    with open(spec_path) as fh:
        spec = json.load(fh)
    rank = int(os.environ["RANK"])
    mesh.GROUP_TIMEOUT_S = spec["group_timeout_s"]
    _count_steps(DistributedTrainer, os.path.join(spec["out"], f"steps_rank{rank}.jsonl"))
    fault, fired = spec.get("fault"), [False]
    if fault and fault["rank"] == rank:
        if fault["kind"] == "boundary":
            shapes = data_mod.shapes_dataset

            def faulty(*a, **kw):
                for i, b in enumerate(shapes(*a, **kw)):
                    if i == fault["at"] and not fired[0]:
                        fired[0] = True
                        raise InjectedFault("injected fault at a step boundary")
                    yield b

            data_mod.shapes_dataset = faulty
        else:
            count = [0]

            def hook(opt, args, kwargs):
                count[0] += 1
                if count[0] == fault["at"] + 1 and not fired[0]:
                    fired[0] = True
                    raise InjectedFault("injected fault inside an optimizer step")

            register_optimizer_step_pre_hook(hook)
    t0 = time.monotonic()
    rc = train_cli.main(argv)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as fh:
        json.dump({"rc": rc, "seconds": time.monotonic() - t0, "fired": fired[0]}, fh)
    return rc


def resilience_phases(cfg, dev, smi: str, *, preset: str = "imagenet224-dp8",
                      batch: int = RES_BATCH, steps: int = RES_STEPS,
                      gang_batch: int = GANG_BATCH, serve_preset: str = None) -> dict:
    """preempt_train, preempt_pod and chaos_serve (python -m
    glom_tpu_torch.resilience at `preset` on `dev`) and dist_gang (the CLI's
    2-rank gang under torch.distributed.run on `dev`); returns the launches
    of each kernel over every counted training step of their workers, for
    the kernels line's `resilience_launches`."""
    import contextlib
    import glob
    import io
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from glom_tpu_torch.resilience import chaos
    from glom_tpu_torch.resilience.coordinator import read_pod_commit
    from glom_tpu_torch.train import default_recon_index
    from glom_tpu_torch.utils.checkpoint import STATE_FILE

    counted = dev.type == "cuda"
    k = default_recon_index(cfg.default_iters)
    want_loop = _full(_loop_launches(k))
    route = LOOP_ROUTE[dev.type]
    total = {key: 0 for key in DIST_COUNTERS}
    here = os.path.abspath(__file__)
    root = os.path.dirname(here)
    work = tempfile.mkdtemp(prefix="glom_resilience_")

    def step_rows(d):
        rows = []
        for path in sorted(glob.glob(os.path.join(d, "steps_*.jsonl"))):
            with open(path) as fh:
                rows += [json.loads(ln) for ln in fh]
        return rows

    def launch_check(rows):
        """(every step on the loop with exactly its launches, routes, steps
        counted); the launches join `total`."""
        for r in rows:
            for key, v in r["launches"].items():
                total[key] += v
        exact = bool(rows) and all(r["launches"] == want_loop for r in rows) or (
            bool(rows) and not counted)
        return exact and {r["vjp_path"] for r in rows} == {route}, sorted(
            {r["vjp_path"] for r in rows}), len(rows)

    def run_chaos(argv, steps_dir):
        """chaos.main(argv) with its training workers counted into
        steps_dir; (exit code, the harness's stamped records)."""
        os.makedirs(steps_dir, exist_ok=True)
        saved = chaos.TRAIN_WORKER
        chaos.TRAIN_WORKER = [here, "--counted-train-cli", steps_dir]
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                rc = chaos.main(argv)
        finally:
            chaos.TRAIN_WORKER = saved
        return rc, [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]

    def records(path):
        if not os.path.exists(path):
            return []
        with open(path) as fh:
            return [json.loads(ln) for ln in fh if ln.startswith("{")]

    def payload(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    def bitwise(a, b):
        """Params, optimizer state and generator of two payloads, bit for bit."""
        if a["params"].keys() != b["params"].keys():
            return False
        sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
        return (all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
                and sa.keys() == sb.keys()
                and all(torch.equal(v, sb[i][key]) if torch.is_tensor(v) else v == sb[i][key]
                        for i in sa for key, v in sa[i].items())
                and (a["generator"] is None) == (b["generator"] is None)
                and (a["generator"] is None or torch.equal(a["generator"], b["generator"])))

    base = ["--device", str(dev), "--preset", preset, "--steps", str(steps),
            "--batch-size", str(batch), "--kill-after", str(RES_KILL_AFTER),
            "--timeout", str(RES_TIMEOUT_S)]

    # -- preempt_train: SIGTERM at three offsets, each resumed, against one
    # uninterrupted run of the same worker's arguments, in this process -----------------
    from glom_tpu_torch.train import cli as train_cli
    from glom_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    clean_dir = os.path.join(work, "clean")
    os.makedirs(clean_dir)
    clean_args = chaos.build_parser().parse_args(["--dir", clean_dir, *base])
    clean_paths = {"ckpt": os.path.join(clean_dir, "ckpt"),
                   "metrics": os.path.join(clean_dir, "metrics.jsonl"),
                   "flight": os.path.join(clean_dir, "flight")}
    cmd = chaos._worker_cmd(clean_args, clean_paths)
    at = cmd.index("--preset")
    cli_argv = [a for a in cmd[at:] if a not in ("--flight-recorder", clean_paths["flight"])]
    restore = _count_steps(Trainer, os.path.join(clean_dir, "steps_clean.jsonl"))
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            clean_rc = train_cli.main(cli_argv)
    finally:
        restore()
    clean = subprocess.CompletedProcess(cli_argv, clean_rc, "", err.getvalue())
    clean_losses = {r["step"]: r["loss"] for r in records(clean_paths["metrics"])
                    if r.get("kind") == "train_step"}
    clean_final = payload(os.path.join(clean_paths["ckpt"], str(steps), STATE_FILE))
    clean_exact, clean_routes, clean_n = launch_check(step_rows(clean_dir))
    wait = chaos._wait_for_checkpoints
    runs = []
    for off in PREEMPT_OFFSETS_S:
        d = os.path.join(work, f"preempt_{off}")

        def late(proc, ckpt_dir, n, deadline, _off=off):
            ok = wait(proc, ckpt_dir, n, deadline)
            time.sleep(_off)
            return ok

        chaos._wait_for_checkpoints = late
        try:
            rc, stamped = run_chaos(["--dir", d, "--scenario", "preempt-train", *base],
                                   os.path.join(d, "steps"))
        finally:
            chaos._wait_for_checkpoints = wait
        summary = ([r for r in stamped if r.get("event") == "chaos-summary"] or [{}])[-1]
        recs = records(os.path.join(d, "metrics.jsonl"))
        saves = []
        for dump in sorted(glob.glob(os.path.join(d, "flight", "flight_*.jsonl"))):
            saves += [r for r in records(dump) if r.get("action") == "preemption-checkpoint"]
        saves = list({r["flight_seq"]: r for r in saves}.values())  # dumps repeat the ring
        saved_step = saves[0].get("step") if saves else None
        losses = {r["step"]: r["loss"] for r in recs if r.get("kind") == "train_step"}
        final = os.path.join(d, "ckpt", str(steps), STATE_FILE)
        # The saved step's write (the grace save's, or the loop's if it
        # committed that step first).
        writes = [r["bytes"] for r in recs if r.get("name") == "host_checkpoint_write"
                  and r.get("step") == saved_step]
        exact, routes, n_rows = launch_check(step_rows(os.path.join(d, "steps")))
        runs.append(dict(
            offset_s=off, rc=rc, summary_ok=summary.get("ok"),
            failures=summary.get("failures"), resumed_from=summary.get("resumed_from_step"),
            saves=[{key: r.get(key) for key in ("ok", "step", "elapsed_s", "deferred_s", "note")}
                   for r in saves],
            grace_save_ms=1e3 * saves[0]["elapsed_s"] if saves else None,
            grace_deferred_ms=(1e3 * saves[0]["deferred_s"] if saves and "deferred_s" in saves[0]
                               else None),
            grace_mib=writes[-1] / 2 ** 20 if writes else None,
            losses_bitwise=bool(losses) and all(clean_losses.get(s) == v
                                                for s, v in losses.items()),
            steps_logged=sorted(losses),
            final_bitwise=os.path.exists(final) and bitwise(payload(final), clean_final),
            exact_launches=exact, routes=routes, counted_steps=n_rows))
    # ... and one SIGTERM the worker sends itself inside its 4th optimizer step
    # (the chaos harness's land between steps), then the same worker resumed.
    d = os.path.join(work, "preempt_in_step")
    paths = {"ckpt": os.path.join(d, "ckpt"), "metrics": os.path.join(d, "metrics.jsonl"),
             "flight": os.path.join(d, "flight")}
    os.makedirs(os.path.join(d, "steps"))
    cli_args = chaos._worker_cmd(chaos.build_parser().parse_args(["--dir", d, *base]), paths)
    cli_args = cli_args[cli_args.index("--preset"):]
    in_step = [subprocess.run([sys.executable, "-u", here, *entry, *cli_args],
                              capture_output=True, text=True, timeout=RES_TIMEOUT_S, cwd=root)
               for entry in (["--sigterm-train-cli", os.path.join(d, "steps"), "3"],
                             ["--counted-train-cli", os.path.join(d, "steps")])]
    recs = records(paths["metrics"])
    saves = []
    for dump in sorted(glob.glob(os.path.join(d, "flight", "flight_*.jsonl"))):
        saves += [r for r in records(dump) if r.get("action") == "preemption-checkpoint"]
    saves = list({r["flight_seq"]: r for r in saves}.values())
    losses = {r["step"]: r["loss"] for r in recs if r.get("kind") == "train_step"}
    resumes = [r["step"] for r in recs if r.get("action") == "resume-from-checkpoint"]
    final = os.path.join(paths["ckpt"], str(steps), STATE_FILE)
    writes = [r["bytes"] for r in recs if r.get("name") == "host_checkpoint_write"
              and saves and r.get("step") == saves[0].get("step")]
    exact, routes, n_rows = launch_check(step_rows(os.path.join(d, "steps")))
    runs.append(dict(
        offset_s="inside step 3", rc=[p.returncode for p in in_step], summary_ok=None,
        failures=None, resumed_from=resumes[0] if resumes else None,
        saves=[{key: r.get(key) for key in ("ok", "step", "elapsed_s", "deferred_s", "note")}
               for r in saves],
        grace_save_ms=1e3 * saves[0]["elapsed_s"] if saves else None,
        grace_deferred_ms=(1e3 * saves[0]["deferred_s"] if saves and "deferred_s" in saves[0]
                           else None),
        grace_mib=writes[-1] / 2 ** 20 if writes else None,
        losses_bitwise=bool(losses) and all(clean_losses.get(s) == v for s, v in losses.items()),
        steps_logged=sorted(losses),
        final_bitwise=os.path.exists(final) and bitwise(payload(final), clean_final),
        exact_launches=exact, routes=routes, counted_steps=n_rows))
    ok = (clean.returncode == 0 and clean_exact and len(clean_losses) == steps
          and all((r["rc"] == 0 and r["summary_ok"]) or r["rc"] == [143, 0] for r in runs)
          and all(len(r["saves"]) == 1
                  and r["saves"][0]["ok"] and r["saves"][0]["step"] == r["resumed_from"]
                  and r["losses_bitwise"] and r["final_bitwise"] and r["exact_launches"]
                  for r in runs)
          and runs[-1]["grace_deferred_ms"] is not None and runs[-1]["resumed_from"] == 4)
    emit("preempt_train", nvidia_smi=smi, preset=preset, batch=batch, steps=steps,
         kill_after=RES_KILL_AFTER, clean_rc=clean.returncode, clean_routes=clean_routes,
         clean_counted_steps=clean_n, clean_exact_launches=clean_exact, runs=runs,
         want_per_step=want_loop, seconds=time.perf_counter() - t0, ok=ok,
         stderr_tail=None if clean.returncode == 0 else clean.stderr[-2000:])
    if not ok:
        raise AssertionError("preempt_train failed its checks")

    # -- preempt_pod: two pod hosts on the card over a directory transport ------------------
    t0 = time.perf_counter()
    d = os.path.join(work, "pod")
    rc, stamped = run_chaos(["--dir", d, "--scenario", "preempt-pod", "--hosts", "2", *base],
                           os.path.join(d, "steps"))
    summary = ([r for r in stamped if r.get("event") == "chaos-summary"] or [{}])[-1]
    marker = read_pod_commit(os.path.join(d, "coord"))
    phases = []
    for h in (0, 1):
        for dump in sorted(glob.glob(os.path.join(d, f"flight_h{h}", "flight_*.jsonl"))):
            phases += [r for r in records(dump) if r.get("kind") == "barrier"
                       and r.get("round") == "preempt-g0"]
    phases = list({(r["host"], r["phase"]): r for r in phases}.values())
    at = {(r["host"], r["phase"]): r["wall_time_s"] for r in phases}
    round_ms = (1e3 * (max(t for (_, ph), t in at.items() if ph == "complete")
                       - min(t for (_, ph), t in at.items() if ph == "propose"))
                if any(ph == "complete" for _, ph in at) else None)
    save_ms = {h: 1e3 * (at[(h, "saved")] - at[(h, "commit")])
               for h in (0, 1) if (h, "saved") in at and (h, "commit") in at}
    exact, routes, n_rows = launch_check(step_rows(os.path.join(d, "steps")))
    resumes = {h: sorted({r["step"] for r in records(os.path.join(d, f"metrics_h{h}.jsonl"))
                          if r.get("action") == "resume-from-checkpoint"}) for h in (0, 1)}
    ok = (rc == 0 and summary.get("ok") is True and marker is not None
          and marker["step"] == min(int(v) for v in marker["proposals"].values())
          and all(v == [marker["step"]] for v in resumes.values()) and exact)
    emit("preempt_pod", nvidia_smi=smi, preset=preset, batch=batch, steps=steps, hosts=2,
         rc=rc, summary=summary, marker=marker, resumes=resumes, barrier_round_ms=round_ms,
         barrier_save_ms=save_ms, kill_gap_s=0.5, exact_launches=exact, routes=routes,
         counted_steps=n_rows, seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("preempt_pod failed its checks")

    # -- resume_seek: the host time a resumed run spends on its data stream before its
    # first step, a skipped batch against a produced one, at the preset's batch ----------
    from glom_tpu_torch.data import gaussian_dataset, shapes_dataset
    from glom_tpu_torch.utils.presets import get_preset

    t0 = time.perf_counter()
    seek_batch = get_preset(preset).train.batch_size
    seek = {}
    for name, make in (("shapes", shapes_dataset), ("gaussian", gaussian_dataset)):
        t1 = time.perf_counter()
        first = next(make(seek_batch, cfg.image_size, seed=SEED))
        t2 = time.perf_counter()
        later = next(make(seek_batch, cfg.image_size, seed=SEED, start=SEEK_SKIP))
        t3 = time.perf_counter()
        seek[name] = dict(batch_ms=1e3 * (t2 - t1),
                          skip_ms_per_batch=1e3 * ((t3 - t2) - (t2 - t1)) / SEEK_SKIP,
                          shape=list(later.shape), finite=bool(np.isfinite(later).all()),
                          differs=not np.array_equal(first, later))
    ok = all(v["finite"] and v["differs"] and v["shape"] == [seek_batch, 3, cfg.image_size,
                                                              cfg.image_size]
             for v in seek.values())
    emit("resume_seek", nvidia_smi=smi, preset=preset, batch=seek_batch, skipped=SEEK_SKIP,
         sources=seek, seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("resume_seek failed its checks")

    # -- dist_gang: the CLI's --distributed --supervise on 2 gloo ranks sharing the card;
    # the three launches run at once (six ranks on the card) ------------------------------
    t0 = time.perf_counter()
    gang, procs = {}, {}
    for name, fault in (("clean", None),
                        ("boundary", {"rank": 1, "kind": "boundary", "at": 4}),
                        ("in_step", {"rank": 1, "kind": "in_step", "at": 3})):
        gd = os.path.join(work, f"gang_{name}")
        os.makedirs(gd)
        spec = os.path.join(gd, "spec.json")
        with open(spec, "w") as fh:
            json.dump({"fault": fault, "group_timeout_s": GANG_TIMEOUT_S, "out": gd}, fh)
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "--monitor-interval", "0.1", here, "--gang-cli-rank",
                spec, "--preset", preset, "--distributed", "--dist-backend", "gloo",
                "--device", str(dev), "--batch-size", str(gang_batch),
                "--steps", str(GANG_STEPS), "--checkpoint-every", "2", "--log-every", "1",
                "--prefetch", "0", "--supervise", "1",
                "--checkpoint-dir", os.path.join(gd, "ckpt"),
                "--metrics-file", os.path.join(gd, "m.jsonl")]
        logf = open(os.path.join(gd, "torchrun.log"), "w")
        procs[name] = (subprocess.Popen(argv, stdout=logf, stderr=subprocess.STDOUT, cwd=root),
                       time.perf_counter(), logf)
    ended = {}
    deadline = time.perf_counter() + RES_TIMEOUT_S
    while len(ended) < len(procs) and time.perf_counter() < deadline:
        for name, (proc, _, _) in procs.items():
            if name not in ended and proc.poll() is not None:
                ended[name] = time.perf_counter()
        time.sleep(0.1)
    for name, (proc, t1, logf) in procs.items():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()
        seconds = ended.get(name, time.perf_counter()) - t1
        gd = os.path.join(work, f"gang_{name}")
        with open(os.path.join(gd, "torchrun.log")) as fh:
            log_tail = fh.read()[-2000:]
        ranks = []
        for r in (0, 1):
            path = os.path.join(gd, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as fh:
                    ranks.append(json.load(fh))
            else:
                ranks.append(None)
        recs = records(os.path.join(gd, "m.jsonl"))
        # One global-state copy, rank 0's, in the checkpoint dir itself.
        final = os.path.join(gd, "ckpt", str(GANG_STEPS), STATE_FILE)
        copies = sorted(os.listdir(os.path.join(gd, "ckpt"))) if os.path.isdir(
            os.path.join(gd, "ckpt")) else []
        exact, routes, n_rows = launch_check(step_rows(gd))
        gang[name] = dict(
            rc=proc.returncode, seconds=seconds, ranks=ranks,
            restarts=[r.get("exception", "")[:120] for r in recs if r.get("action") == "restart"],
            resumes=[(r["step"], r.get("attempt")) for r in recs
                     if r.get("action") == "resume-from-checkpoint"],
            steps_logged=sorted({r["step"] for r in recs if r.get("kind") == "train_step"}),
            final=final if os.path.exists(final) else None,
            per_rank_copies=[c for c in copies if c.startswith("host_")],
            checkpoint_mib={r["step"]: r["bytes"] / 2 ** 20 for r in recs
                            if r.get("name") == "host_checkpoint_write"},
            exact_launches=exact, routes=routes, counted_steps=n_rows,
            log_tail=None if proc.returncode == 0 else log_tail)
    clean_final = payload(gang["clean"]["final"]) if gang["clean"]["final"] else None
    for name, g in gang.items():
        g["final_bitwise"] = (clean_final is not None and g["final"] is not None
                              and bitwise(payload(g.pop("final")), clean_final))
    clean_s = gang["clean"]["seconds"]
    # The boundary fault leaves rank 0 in step 4's all-reduce until the
    # groups time out; the in-step one lands after step 3's all-reduce, so
    # rank 0 finishes that step and writes step 4.
    ok = (all(g["rc"] == 0 and g["exact_launches"] and g["steps_logged"] == list(range(GANG_STEPS))
              and g["final_bitwise"] and g["per_rank_copies"] == [] for g in gang.values())
          and gang["clean"]["restarts"] == [] and gang["clean"]["resumes"] == []
          and all(len(gang[n]["restarts"]) == 1 and (gang[n]["ranks"][1] or {}).get("fired")
                  and gang[n]["resumes"] == [(4, 2)]
                  and gang[n]["seconds"] < clean_s + GANG_TIMEOUT_S + 60.0
                  for n in ("boundary", "in_step")))
    emit("dist_gang", nvidia_smi=smi, preset=preset, batch=gang_batch, ranks=2, backend="gloo",
         steps=GANG_STEPS, group_timeout_s=GANG_TIMEOUT_S, runs=gang,
         seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("dist_gang failed its checks")

    # -- chaos_serve: kill-serve and ramp-serve through the serve CLI ----------------------
    t0 = time.perf_counter()
    serve = {}
    for scenario in ("kill-serve", "ramp-serve"):
        d = os.path.join(work, scenario)
        rc, stamped = run_chaos(["--dir", d, "--scenario", scenario, "--device", str(dev),
                                "--preset", serve_preset or preset,
                                "--timeout", str(RES_TIMEOUT_S)], os.path.join(d, "steps"))
        summary = ([r for r in stamped if r.get("event") == "chaos-summary"] or [{}])[-1]
        serve[scenario] = dict(rc=rc, summary=summary)
    ok = all(v["rc"] == 0 and v["summary"].get("ok") is True for v in serve.values())
    emit("chaos_serve", nvidia_smi=smi, preset=serve_preset or preset, runs=serve,
         seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("chaos_serve failed its checks")
    shutil.rmtree(work, ignore_errors=True)
    return dist_kernel_launches(total)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


class _Tap:
    """A writer that keeps every stamped record (list appends are atomic,
    so worker threads may write concurrently)."""

    def __init__(self):
        self.recs = []

    def write(self, rec):
        self.recs.append(rec)

    def events(self, *names):
        return [r for r in self.recs if r.get("event") in names]


def serve_host_stack(cfg, params, dev, engine, ragged, fixed_loop, compare,
                     cli_argv=None) -> dict:
    """The serving host stack on the card: DynamicBatcher over the port's
    engines at the given width, in six phases (serve_batcher,
    serve_two_tier, serve_stream, serve_fanout, serve_ragged_batcher,
    serve_cli). `engine` is a warmed fixed-route bucket engine, `ragged` a
    warmed ragged one, `fixed_loop(imgs)` the fixed loop of the auto
    route's step; `cli_argv` the serve CLI's preset and device arguments.
    Returns each kernel's launches over the phases' main-path runs (the
    replays that hold them to the engine are not counted). Raises on the
    first failed check."""
    import collections
    import dataclasses
    import os
    import tempfile
    import threading

    import numpy as np
    import torch

    import glom_tpu_torch.kernels.banded_consensus as k4
    import glom_tpu_torch.kernels.consensus_update as k2
    import glom_tpu_torch.kernels.grouped_mlp as k1
    from glom_tpu_torch import InferenceEngine, ServeConfig, glom_forward
    from glom_tpu_torch.models.core import map_params
    from glom_tpu_torch.resilience import FaultPlan, dispatch_fault
    from glom_tpu_torch.serve import DynamicBatcher, ShedError, column_state_bytes, pack_ragged
    from glom_tpu_torch.serve.batcher import ragged_row_starts

    T, side, n_tok = cfg.default_iters, cfg.image_size, cfg.num_patches
    shape = (cfg.channels, side, side)
    rng = np.random.default_rng(SEED)
    pool_imgs = [rng.standard_normal(shape).astype(np.float32) for _ in range(32)]
    batcher_launches = collections.Counter()

    def zero():
        k1.LAUNCHES = k1.LAUNCHES_ADD = k2.LAUNCHES = k4.LAUNCHES = 0

    def take():
        """This run's launches (K1, K1 with the addend, K2, K4), added to
        the kernels line's batcher totals."""
        got = (k1.LAUNCHES, k1.LAUNCHES_ADD, k2.LAUNCHES, k4.LAUNCHES)
        batcher_launches.update({"grouped_mlp_fwd": got[0] - got[1],
                                 "grouped_mlp_fwd_add": got[1],
                                 "consensus_update_fwd": got[2],
                                 "banded_consensus_fwd": got[3]})
        return got

    def ms(xs, q):
        return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else None

    def conserved(b, tickets, tap):
        """(summary, ok): every admitted request served, none failed, each
        resolved exactly once (one resolve leaf per trace)."""
        s = b.summary_record()
        leaves = collections.Counter(r["trace_id"] for r in tap.events("resolve"))
        ok = (s["n_submitted"] == s["n_served"] == len(tickets) and s["n_failed"] == 0
              and all(t.done() for t in tickets) and len(leaves) == len(tickets)
              and all(leaves[t.trace_id] == 1 for t in tickets))
        return s, ok

    def fixed_launches_ok(got, n_dispatch):
        return got == (2 * T * n_dispatch, T * n_dispatch, T * n_dispatch, 0)

    def replay_buckets(eng, tap, by_trace):
        """Each dispatch again through engine.infer on the same padded
        bucket: True iff every ticket's levels equal it bit for bit."""
        ok = True
        for r in tap.events("dispatch"):
            rows = [by_trace[tid] for tid in r["trace_ids"]]
            imgs = np.zeros((r["bucket"], *shape), np.float32)
            for i, (img, _) in enumerate(rows):
                imgs[i] = img
            want = eng.infer(imgs, n_valid=r["n_valid"]).levels[:r["n_valid"]].cpu()
            ok &= all(torch.equal(t.result()[0], want[i]) for i, (_, t) in enumerate(rows))
        return ok

    # -- serve_batcher: the fixed route behind the batcher --------------------
    def closed_loop(b):
        done = [[] for _ in range(BATCHER_CLIENTS)]

        def client(c):
            for j in range(BATCHER_PER_CLIENT):
                k = (c * BATCHER_PER_CLIENT + j) % len(pool_imgs)
                t = b.submit(pool_imgs[k])
                t.result(timeout=300)
                done[c].append((pool_imgs[k], t))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(BATCHER_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return [x for xs in done for x in xs], time.perf_counter() - t0, 0

    def open_loop(b, rate):
        gaps = np.random.default_rng(SEED + 1).exponential(1.0 / rate, OPEN_LOOP_REQUESTS)
        out, shed = [], 0
        t0 = t_next = time.perf_counter()
        for k in range(OPEN_LOOP_REQUESTS):
            t_next += gaps[k]
            wait = t_next - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            img = pool_imgs[k % len(pool_imgs)]
            try:
                out.append((img, b.submit(img)))
            except ShedError:
                shed += 1
        for _, t in out:
            t.result(timeout=300)
        return out, time.perf_counter() - t0, shed

    runs, ceiling = {}, None
    for name in ("closed", *(f"open_{f}" for f in OPEN_LOOP_LOADS)):
        tap = _Tap()
        b = DynamicBatcher(engine, writer=tap)
        b.start()
        zero()
        if name == "closed":
            done, wall, shed = closed_loop(b)
        else:
            done, wall, shed = open_loop(b, float(name.split("_")[1]) * ceiling)
        b.stop()
        got = take()
        s, ok = conserved(b, [t for _, t in done], tap)
        disp = tap.events("dispatch")
        launches_ok = fixed_launches_ok(got, len(disp))
        bitwise = replay_buckets(engine, tap, {t.trace_id: (img, t) for img, t in done})
        lat = [t.result()[2] for _, t in done]
        rps = len(done) / wall
        if name == "closed":
            ceiling = rps
        busy = [r["h2d_ms"] + r["device_ms"] + r["resolve_ms"] for r in disp]
        runs[name] = dict(
            requests=len(done), shed=shed, requests_per_s=rps, wall_s=wall,
            latency_ms={"p50": ms(lat, 50), "p95": ms(lat, 95), "p99": ms(lat, 99)},
            dispatch_engine_ms_p50=float(np.median(busy)), dispatches=len(disp),
            dispatches_per_bucket=dict(collections.Counter(str(r["bucket"]) for r in disp)),
            mean_batch=s["mean_batch"], latency_phases_ms=s.get("latency_phases"),
            launches={"K1": got[0], "K1_add": got[1], "K2": got[2], "K4": got[3]},
            launches_exact=launches_ok, conserved=ok, bitwise_equal_engine_replay=bitwise)
        if not (ok and launches_ok and bitwise):
            emit("serve_batcher", failed_run=name, **runs[name])
            raise AssertionError(f"serve_batcher {name}: conserved {ok}, launches {got} "
                                 f"over {len(disp)} dispatches, replay bitwise {bitwise}")
    # An f32 engine through the batcher against the plain f32 path.
    f32_eng = InferenceEngine(cfg, ServeConfig(buckets=(2,), max_batch=2, use_pallas=True),
                              params=params, device=dev)
    with DynamicBatcher(f32_eng, max_delay_ms=1000.0) as b32:
        ts = [b32.submit(img) for img in pool_imgs[:2]]
        got32 = torch.stack([t.result(timeout=300)[0] for t in ts])
    with torch.inference_mode():
        plain32 = glom_forward(map_params(lambda t: t.to(dev), params),
                               torch.from_numpy(np.stack(pool_imgs[:2])).to(dev), cfg,
                               use_pallas=False).cpu()
    ok32, err32, rel32, ratio32 = compare(got32, plain32, 2e-3, 2e-4)
    emit("serve_batcher", max_batch=engine.scfg.max_batch,
         max_delay_ms=engine.scfg.max_delay_ms, clients=BATCHER_CLIENTS,
         ceiling_requests_per_s=ceiling, runs=runs,
         f32_parity=dict(rtol=2e-3, atol=2e-4, max_abs_err=err32, max_rel_err=rel32,
                         bar_ratio=ratio32, ok=ok32))
    if not ok32:
        raise AssertionError("an f32 engine through the batcher disagrees with the plain path")

    # -- serve_two_tier: the auto route, quorum exit with continuation hops ------
    base = ServeConfig(buckets=(1, 2, 4, 8), max_batch=8, iters="auto",
                       compute_dtype="bfloat16", use_pallas=True)
    arms = {"two_tier": dataclasses.replace(base, exit_quorum=0.5, max_continuations=2),
            "batch_level": dataclasses.replace(base, exit_quorum=1.0, max_continuations=0)}
    tt_engines = {a: InferenceEngine(cfg, c, params=params, device=dev) for a, c in arms.items()}
    for e in tt_engines.values():
        e.warmup()
    n_hard = int(round(TWO_TIER_HARD * TWO_TIER_REQUESTS))
    hard = set(np.linspace(0, TWO_TIER_REQUESTS - 1, n_hard).astype(int).tolist())
    trng = np.random.default_rng(SEED + 7)
    tt_imgs = [trng.standard_normal(shape).astype(np.float32) * (100.0 if i in hard else 1.0)
               for i in range(TWO_TIER_REQUESTS)]
    budget = tt_engines["two_tier"].auto_budget
    tt = {a: dict(iters=[], hard_iters=[], hops=[], lat=[], h2d=0, cont_h2d=0, k1=0)
          for a in arms}
    for p in range(TWO_TIER_PASSES):
        for arm in (("two_tier", "batch_level") if p % 2 == 0 else ("batch_level", "two_tier")):
            tap, acc = _Tap(), tt[arm]
            b = DynamicBatcher(tt_engines[arm], writer=tap)
            b.start()
            zero()
            tickets = []
            for w in range(0, TWO_TIER_REQUESTS, 8):
                window = [b.submit(img) for img in tt_imgs[w:w + 8]]
                for t in window:
                    t.result(timeout=300)
                tickets += window
            b.stop()
            got = take()
            s, ok = conserved(b, tickets, tap)
            disp = tap.events("dispatch")
            steps = sum(r["iters_run"] for r in disp)
            within = all(t.result()[1] <= budget for t in tickets)
            if not (ok and within and got == (2 * steps, got[1], 0, 0)):
                raise AssertionError(f"serve_two_tier {arm}: conserved {ok}, within budget "
                                     f"{within}, launches {got} for {steps} updates")
            for i, t in enumerate(tickets):
                acc["iters"].append(t.result()[1])
                acc["hops"].append(t.hops)
                acc["lat"].append(t.result()[2])
                if i in hard:
                    acc["hard_iters"].append(t.result()[1])
            acc["h2d"] += s["levels0_h2d_bytes"]
            acc["cont_h2d"] += sum(r["levels0_h2d_bytes"] for r in disp if r["tier"] > 0)
            acc["k1"] += got[0]
    # Threshold 0: nothing exits, no row straggles, and every ticket equals
    # the fixed loop of the same step on its padded bucket, bit for bit.
    eng0 = InferenceEngine(cfg, dataclasses.replace(arms["two_tier"], exit_threshold=0.0),
                           params=params, device=dev)
    with DynamicBatcher(eng0, max_delay_ms=1000.0) as b0:
        ts0 = [b0.submit(img) for img in tt_imgs[:8]]
        for t in ts0:
            t.result(timeout=300)
    want0 = fixed_loop(np.stack(tt_imgs[:8]))[:8].cpu()
    bitwise0 = all(torch.equal(t.result()[0], want0[i]) and t.result()[1] == T and t.hops == 0
                   for i, t in enumerate(ts0))

    def tier_means(acc):
        out = collections.defaultdict(list)
        for it, h in zip(acc["iters"], acc["hops"]):
            out[str(h)].append(it)
        return {h: float(np.mean(v)) for h, v in sorted(out.items())}

    emit("serve_two_tier", budget=budget, requests=TWO_TIER_REQUESTS, hard_share=TWO_TIER_HARD,
         hard_scale=100.0, passes_per_arm=TWO_TIER_PASSES, order="arms in turns",
         exit_threshold=base.exit_threshold,
         arms={a: dict(quorum=arms[a].exit_quorum, max_continuations=arms[a].max_continuations,
                       mean_executed_iters=float(np.mean(acc["iters"])),
                       mean_iters_hard=float(np.mean(acc["hard_iters"])),
                       mean_iters_by_tier=tier_means(acc),
                       hops_histogram=dict(collections.Counter(map(str, acc["hops"]))),
                       latency_ms={"p50": ms(acc["lat"], 50), "p99": ms(acc["lat"], 99)},
                       levels0_h2d_bytes=acc["h2d"],
                       continuation_levels0_h2d_bytes=acc["cont_h2d"],
                       k1_launches=acc["k1"])
               for a, acc in tt.items()},
         launches_per_update={"K1": 2, "K2": 0}, threshold0_bitwise_equal_fixed=bitwise0)
    if not bitwise0:
        raise AssertionError("two-tier at threshold 0 differs from the fixed loop of its step")

    # -- serve_stream: session warm starts from the page pool --------------------
    scfg_s = ServeConfig(buckets=(1, 2, 4, 8), max_batch=8, iters="auto",
                         compute_dtype="bfloat16", use_pallas=True, page_pool_pages=POOL_PAGES)
    budget_s = STREAM_SESSIONS * column_state_bytes(cfg, scfg_s)
    scfg_s = dataclasses.replace(scfg_s, column_cache_bytes=budget_s)
    s_eng = InferenceEngine(cfg, scfg_s, params=params, device=dev)
    for warm in (False, "paged"):
        s_eng.warmup(warm=warm)
    srng = np.random.default_rng(SEED + 11)
    bases = [100.0 * srng.standard_normal(shape).astype(np.float32)
             for _ in range(STREAM_SESSIONS)]
    frames = [[(bases[s] + 0.05 * srng.standard_normal(shape)).astype(np.float32)
               for _ in range(STREAM_FRAMES)] for s in range(STREAM_SESSIONS)]
    tap = _Tap()
    b = DynamicBatcher(s_eng, writer=tap)
    b.start()
    zero()
    results = [[None] * STREAM_FRAMES for _ in range(STREAM_SESSIONS)]

    def stream(s):
        for f in range(STREAM_FRAMES):
            t = b.submit(frames[s][f], session_id=f"cam{s}")
            t.result(timeout=300)
            results[s][f] = t

    threads = [threading.Thread(target=stream, args=(s,)) for s in range(STREAM_SESSIONS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    b.stop()
    got = take()
    tickets = [t for row in results for t in row]
    s, ok = conserved(b, tickets, tap)
    disp = tap.events("dispatch")
    steps = sum(r["iters_run"] for r in disp)
    cache = s["column_cache"]
    warm_h2d = sum(r["levels0_h2d_bytes"] for r in disp if r["n_page_warm"])
    stream_ok = (ok and cache["n_hits"] == STREAM_SESSIONS * (STREAM_FRAMES - 1)
                 and warm_h2d == 0 and s["levels0_h2d_bytes"] == 0
                 and cache["bytes_peak"] <= cache["budget_bytes"]
                 and got == (2 * steps, got[1], 0, 0))
    first_iters = [row[0].result()[1] for row in results]
    later_iters = [t.result()[1] for row in results for t in row[1:]]
    emit("serve_stream", sessions=STREAM_SESSIONS, frames=STREAM_FRAMES, pool_pages=POOL_PAGES,
         budget_bytes=budget_s, hits=cache["n_hits"], misses=cache["n_misses"],
         evictions=cache["n_evictions"], bytes_peak=cache["bytes_peak"],
         warm_rows=s["n_page_warm"], warm_levels0_h2d_bytes=warm_h2d,
         levels0_h2d_bytes=s["levels0_h2d_bytes"], mean_iters_frame1=float(np.mean(first_iters)),
         mean_iters_frames2_4=float(np.mean(later_iters)), dispatches=len(disp),
         mean_batch=s["mean_batch"],
         latency_ms={"p50": ms([t.result()[2] for t in tickets], 50),
                     "p99": ms([t.result()[2] for t in tickets], 99)},
         launches={"K1": got[0], "K2": got[2]}, conserved=ok, ok=stream_ok)
    if not stream_ok:
        raise AssertionError("serve_stream: hits, warm bytes, budget, launches or conservation")
    del s_eng

    # -- serve_fanout: two engines on the card, failover and rejoin -------------
    fcfg = ServeConfig(buckets=(1, 2, 4, 8), max_batch=8, compute_dtype="bfloat16",
                       use_pallas=True, rejoin_threshold=2, rejoin_interval_ms=20.0)
    fcfg = dataclasses.replace(fcfg, column_cache_bytes=4 * column_state_bytes(cfg, fcfg))
    tap = _Tap()
    # Engine 1's dispatch calls 2..7 raise: its third and fourth dispatches
    # fail after their retries (three attempts each), then the window closes.
    plan = FaultPlan(SEED, writer=tap).register("engine1-dispatch", at=range(2, 8),
                                                fault="engine-dead")
    fan = [InferenceEngine(cfg, fcfg, params=params, device=dev, name=f"engine{i}",
                           fault_hook=dispatch_fault(plan, "engine1-dispatch") if i else None)
           for i in range(2)]
    for e in fan:
        e.warmup()
    b = DynamicBatcher(engines=fan, writer=tap)
    for i in range(2):  # entries engine 1 wrote: its failure must drop them
        b.cache.store(f"pre{i}", torch.zeros(n_tok, cfg.levels, cfg.dim, dtype=torch.bfloat16),
                      engine="engine1")
    stale_at_failover = []

    def watch(rec):
        if rec.get("event") == "engine_failover" and rec.get("engine") == "engine1":
            stale_at_failover.append(sum(e.engine == "engine1"
                                         for e in list(b.cache._entries.values())))

    b.add_event_tap(watch)
    b.start()
    zero()
    stop_at = time.monotonic() + 120.0
    done = []

    def rejoined_and_serving():
        with b._engine_lock:
            st = dict(b._engine_state["engine1"])
        return st["rejoins"] >= 1 and st["dispatches"] >= 3

    def fan_client(c):
        k = c
        while time.monotonic() < stop_at and not rejoined_and_serving():
            img = pool_imgs[k % len(pool_imgs)]
            t = b.submit(img)
            t.result(timeout=300)
            done.append((img, t))
            k += BATCHER_CLIENTS

    threads = [threading.Thread(target=fan_client, args=(c,)) for c in range(BATCHER_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    b.stop()
    got = take()
    s, ok = conserved(b, [t for _, t in done], tap)
    disp = tap.events("dispatch")
    life = [(r["event"], r.get("engine")) for r in tap.events(
        "engine_failover", "engine_dead", "engine_probation", "engine_rejoin",
        "cache_invalidate")]
    order = [e for e, who in life if who == "engine1" and e != "cache_invalidate"]
    first_fail = next(i for i, (e, _) in enumerate(life) if e == "engine_failover")
    invalidated_first = any(e == "cache_invalidate" and who == "engine1"
                            for e, who in life[:first_fail])
    probes = sum(r["health_dispatches"] for r in tap.events("engine_rejoin"))
    n_fwd = len(disp) + probes
    fan_ok = (ok and order == ["engine_failover", "engine_failover", "engine_dead",
                               "engine_probation", "engine_rejoin"]
              and invalidated_first and stale_at_failover == [0, 0]
              and fixed_launches_ok(got, n_fwd) and s["n_redispatched"] > 0)
    bitwise = replay_buckets(fan[0], tap, {t.trace_id: (img, t) for img, t in done})
    emit("serve_fanout", engines={n: {k: v for k, v in st.items() if k != "retry"}
                                  for n, st in s["engines"].items()},
         requests=len(done), dispatches=len(disp), health_dispatches=probes,
         redispatched=s["n_redispatched"], lifecycle=order,
         cache_invalidated_before_requeue=invalidated_first,
         engine1_entries_at_failover=stale_at_failover,
         launches={"K1": got[0], "K1_add": got[1], "K2": got[2]},
         launches_per_dispatch={"K1": 2 * T, "K2": T},
         faults_injected=sum(1 for r in tap.recs if r.get("kind") == "fault"),
         bitwise_equal_engine_replay=bitwise, conserved=ok, ok=fan_ok and bitwise)
    if not (fan_ok and bitwise):
        raise AssertionError(f"serve_fanout: lifecycle {order}, invalidated first "
                             f"{invalidated_first}, launches {got} over {n_fwd}, conserved {ok}")
    del fan

    # -- serve_ragged_batcher: mixed resolutions through ragged admission --------
    pt = ragged.page_tokens
    sides = [side, side * 3 // 4, side // 2, side // 4]
    rrng = np.random.default_rng(SEED + 13)
    tap = _Tap()
    b = DynamicBatcher(ragged, writer=tap, max_delay_ms=1000.0)
    b.start()
    zero()
    done = []
    for _ in range(4):
        imgs = [rrng.standard_normal((cfg.channels, sd, sd)).astype(np.float32)
                for sd in sides for _ in range(2)]
        window = [(img, b.submit(img)) for img in imgs]
        for _, t in window:
            t.result(timeout=300)
        done += window
    b.stop()
    got = take()
    s, ok = conserved(b, [t for _, t in done], tap)
    disp = tap.events("dispatch")
    by_trace = {t.trace_id: (img, t) for img, t in done}
    bitwise = True
    for r in disp:
        rows = [by_trace[tid] for tid in r["trace_ids"]]
        flat, n_p = pack_ragged([img for img, _ in rows], cfg.patch_size, pt, r["n_pages"])
        want = ragged.infer_ragged(flat, n_p).levels.cpu()
        for (_, t), st, c in zip(rows, ragged_row_starts(n_p, pt), n_p):
            bitwise &= torch.equal(t.result()[0], want[st:st + c])
    rag_ok = ok and bitwise and got == (2 * T * len(disp), got[1], 0, T * len(disp))
    emit("serve_ragged_batcher", sides=sides, requests=len(done), dispatches=len(disp),
         pages=[r["n_pages"] for r in disp], pad_fraction_mean=s["pad_fraction_mean"],
         latency_ms={"p50": ms([t.result()[2] for _, t in done], 50),
                     "p99": ms([t.result()[2] for _, t in done], 99)},
         launches={"K1": got[0], "K2": got[2], "K4": got[3]},
         launches_per_dispatch={"K1": 2 * T, "K4": T, "K2": 0},
         bitwise_equal_infer_ragged=bitwise, conserved=ok, ok=rag_ok)
    if not rag_ok:
        raise AssertionError(f"serve_ragged_batcher: launches {got} over {len(disp)} "
                             f"dispatches, bitwise {bitwise}, conserved {ok}")

    # -- serve_cli: python -m glom_tpu_torch.serve with a killed engine ----------
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "serve.jsonl")
        argv = [sys.executable, "-m", "glom_tpu_torch.serve",
                *(cli_argv or ["--preset", "imagenet224-dp8"]), "--engines", "2",
                "--kill-engine", "1:after=2", "--ramp", CLI_RAMP, "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        lint = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", out],
                              cwd=root, capture_output=True, text=True, timeout=120)
        recs = []
        if os.path.exists(out):
            with open(out) as fh:
                recs = [json.loads(line) for line in fh if line.startswith("{")]
    summary = [r for r in recs if r.get("event") == "summary"]
    n_ramp = sum(int(p.split("x")[0]) for p in CLI_RAMP.split(","))
    s = summary[-1] if summary else {}
    lat = [r["latency_ms"] for r in recs if r.get("event") == "response" and r.get("ok")]
    cli_ok = (proc.returncode == 0 and lint.returncode == 0 and len(summary) == 1
              and s.get("n_requests") == s.get("n_served") == n_ramp)
    emit("serve_cli", argv=argv[1:], rc=proc.returncode, lint_rc=lint.returncode,
         seconds=cli_s, requests=s.get("n_requests"), served=s.get("n_served"),
         failed=s.get("n_failed"), redispatched=s.get("n_redispatched"),
         engines={n: {k: v for k, v in st.items() if k != "retry"}
                  for n, st in s.get("engines", {}).items()},
         latency_ms={"p50": float(np.median(lat)) if lat else None},
         events=dict(collections.Counter(r.get("event") for r in recs
                                         if str(r.get("event", "")).startswith("engine_"))),
         ok=cli_ok, stderr_tail=None if cli_ok else proc.stderr[-2000:])
    if not cli_ok:
        raise AssertionError(f"serve_cli: rc {proc.returncode}, lint {lint.returncode}, "
                             f"summary {s.get('n_requests')}/{s.get('n_served')}")
    if min(batcher_launches.values()) == 0:
        raise AssertionError(f"a kernel ran no time behind the batcher: {batcher_launches}")
    return dict(batcher_launches)


def serve_elastic(cfg, params, dev, cli_argv=None) -> dict:
    """The elastic fleet on the card: flagship bf16 bucket engines, each with
    a POOL_PAGES-page pool, behind DynamicBatcher with the Autoscaler, in
    two phases (serve_elastic, serve_cli_elastic). `cli_argv` is the serve
    CLI's preset and device arguments. Returns each kernel's launches over
    the phase's main-path run (every replica's warm-ups and dispatches; the
    replays that hold the tickets to their engine are not counted). Raises
    on the first failed check."""
    import collections
    import dataclasses
    import os
    import tempfile
    import threading
    import weakref

    import numpy as np
    import torch

    import glom_tpu_torch.kernels.consensus_update as k2
    import glom_tpu_torch.kernels.grouped_mlp as k1
    import glom_tpu_torch.models.core as core
    from glom_tpu_torch import InferenceEngine, ServeConfig
    from glom_tpu_torch.resilience import FaultPlan, spawn_fault
    from glom_tpu_torch.serve import (
        Autoscaler,
        DynamicBatcher,
        ShedError,
        column_state_bytes,
        content_hash,
        resolve_policy,
    )

    T, side = cfg.default_iters, cfg.image_size
    shape = (cfg.channels, side, side)
    buckets = (1, 2, 4, 8)
    scfg = ServeConfig(buckets=buckets, max_batch=8, compute_dtype="bfloat16", use_pallas=True,
                       page_pool_pages=POOL_PAGES, queue_depth=ELASTIC_QUEUE, elastic=True,
                       min_engines=1, max_engines=ELASTIC_MAX, warm_pool=ELASTIC_WARM_POOL,
                       **ELASTIC_POLICY)
    scfg = dataclasses.replace(
        scfg, column_cache_bytes=ELASTIC_SESSIONS * column_state_bytes(cfg, scfg))
    rng = np.random.default_rng(SEED + 17)
    pool_imgs = [rng.standard_normal(shape).astype(np.float32) for _ in range(32)]

    class TimedTap(_Tap):
        """Every stamped record with the host clock at its write."""

        def __init__(self):
            super().__init__()
            self.timed = []
            self._lock = threading.Lock()

        def write(self, rec):
            with self._lock:
                self.timed.append((time.monotonic(), rec))
                self.recs.append(rec)

    tap = TimedTap()
    probe = dict(warm_end={}, calls=collections.defaultdict(list), releases=[],
                 registrations=[], early=[], admitted={"engine0"})
    # Replicas by the name each was built with; that name by object; and
    # the built name of each fleet name (a re-promoted spare is renamed).
    engines, made, alias = {}, {}, {"engine0": "engine0"}

    def make(name):
        """A replica on the card, its warm-up end, its dispatches (with the
        rows the pool served warm) and its release instrumented."""
        eng = InferenceEngine(cfg, scfg, params=params, device=dev, name=name, writer=tap)
        warm, infer, release = eng.warmup, eng.infer, eng.release

        def warmup(*a, **kw):
            out = warm(*a, **kw)
            probe["warm_end"][name] = time.monotonic()
            return out

        def traced_infer(imgs, n_valid=None, **kw):
            if name not in probe["admitted"]:
                probe["early"].append(name)
            pr = kw.get("page_rows")
            probe["calls"][name].append(None if pr is None else [bool(r[0] >= 0) for r in pr])
            return infer(imgs, n_valid=n_valid, **kw)

        def traced_release():
            buf = eng.pool.buffer()
            ref = weakref.ref(buf)
            del buf
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev)
            release()
            torch.cuda.synchronize(dev)
            probe["releases"].append(dict(
                engine=name, freed_mib=(held - torch.cuda.memory_allocated(dev)) / 2**20,
                pool_mib=eng.pool.pool_bytes / 2**20, buffer_freed=ref() is None,
                released=eng.released))

        eng.warmup, eng.infer, eng.release = warmup, traced_infer, traced_release
        engines[name], made[id(eng)] = eng, name
        return eng

    k2_fn = core.fused_consensus_update

    def closed_loop(fleet, clients):
        """(requests/s, K2's median host µs a call) of `fleet` behind one
        batcher with `clients` closed-loop clients of 12 stateless requests
        each."""
        k2_us = []

        def timed(*a, **kw):
            t_call = time.perf_counter()
            out = k2_fn(*a, **kw)
            k2_us.append(1e6 * (time.perf_counter() - t_call))
            return out

        core.fused_consensus_update = timed
        try:
            with DynamicBatcher(engines=list(fleet), writer=_Tap()) as cb:
                done = []

                def client(c):
                    for j in range(12):
                        img = pool_imgs[(c * 12 + j) % len(pool_imgs)]
                        cb.submit(img).result(timeout=300)
                        done.append(1)

                threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
                t0 = time.perf_counter()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                rps = len(done) / (time.perf_counter() - t0)
        finally:
            core.fused_consensus_update = k2_fn
        return rps, statistics.median(k2_us)

    # One engine's ceiling (closed loop, before the counted run).
    eng0 = make("engine0")
    eng0.warmup()
    closed_loop([eng0], 8)  # the first pass reads low (allocator, host caches): dropped
    ceiling, _ = closed_loop([eng0], 8)
    probe["calls"].clear()

    # -- the counted run --------------------------------------------------------
    b = DynamicBatcher(engines=[eng0], writer=tap)
    orig_add = b.add_engine

    orig_drain = b.drain_engine

    def traced_add(engine, **kw):
        # Admitted before the call: the worker starts inside it. A
        # re-promoted spare registers under a suffixed name; the probes
        # stay keyed by the name it was built with.
        built = made[id(engine)]
        probe["registrations"].append((built, probe["warm_end"].get(built), time.monotonic()))
        probe["admitted"].add(built)
        fleet_name = orig_add(engine, **kw)
        alias[fleet_name] = built
        return fleet_name

    def traced_drain(name, **kw):
        out = orig_drain(name, **kw)
        probe["admitted"].discard(alias[name])
        return out

    b.add_engine, b.drain_engine = traced_add, traced_drain
    migrations = []
    orig_migrate = b.cache.migrate_engine_sessions

    def traced_migrate(src, dst, **kw):
        """The drain's migration, with the source's rows gathered before it
        and each destination row right after the migration's own write. The
        gathers stay on the card (a copy to the host would wait on every
        replica's queued work on the shared stream, stalling the drain):
        stream order makes each read see the pool as it stood when it was
        enqueued. The destination's other writers keep running (a sibling
        storing a stream frame that reached it while this engine drained),
        so only this thread's writes are read back, and the migrated
        sessions are the ones the migration stamped `cache_migrate`: one
        whose entry moved under the copy is invalidated, not migrated."""
        src_pool = b.cache.pools.get(src)
        dst_pool = b.cache.pools.get(dst) if dst is not None else None
        with b.cache._lock:
            sids = [sid for sid, e in b.cache._entries.items() if e.engine == src]
        before = {sid: src_pool.read_block(sid, on_device=True)
                  for sid in sids if src_pool.holds(sid)}
        after, others = {}, [0, 0]  # other threads' writes: all, of src's sessions
        me = threading.get_ident()
        if dst_pool is not None:
            write_back = dst_pool.write_back

            def traced_wb(sid, row, n_tokens):
                ok = write_back(sid, row, n_tokens)
                if threading.get_ident() != me:
                    others[0] += 1
                    others[1] += sid in before
                elif ok and sid in before:
                    after[sid] = dst_pool.read_block(sid, on_device=True)
                return ok

            dst_pool.write_back = traced_wb
        n0 = len(tap.recs)
        t0 = time.monotonic()
        try:
            out = orig_migrate(src, dst, **kw)
        finally:
            if dst_pool is not None:
                del dst_pool.write_back
        t_end = time.monotonic()
        moved = [r["session"] for r in tap.recs[n0:]
                 if r.get("event") == "cache_migrate" and r.get("src_engine") == src]
        # Host time: the copies are enqueued on the device's stream.
        migrations.append(dict(src=src, dst=dst, before=before, after=after, out=out,
                               moved=moved, t_end=t_end, ms=1e3 * (t_end - t0),
                               dst_writes_by_others=others, page_bytes=src_pool.page_bytes))
        return out

    b.cache.migrate_engine_sessions = traced_migrate
    seq = [1]

    def factory():
        name = f"engine{seq[0]}"
        seq[0] += 1
        return make(name)

    plan = FaultPlan(SEED, writer=tap).register("engine-spawn", at=(0,), fault="spawn-fault")
    k2_calls = []

    def timed_k2(*a, **kw):
        t_call = time.perf_counter()
        out = k2_fn(*a, **kw)
        k2_calls.append((time.monotonic(), time.perf_counter() - t_call))
        return out

    k1.LAUNCHES = k1.LAUNCHES_ADD = k2.LAUNCHES = 0
    core.fused_consensus_update = timed_k2
    sc = Autoscaler(b, factory, policy=resolve_policy(scfg),
                    rules={"p99_ms": scfg.elastic_p99_ms}, writer=tap,
                    interval_s=scfg.elastic_interval_s, spawn_hook=spawn_fault(plan),
                    warm_pool=scfg.warm_pool)
    b.start()
    sc.start()  # builds and warms the spare first
    t_run = time.monotonic()
    stateless, streams = [], []  # (submit t, img, ticket) / (session, frame, submit t, img, t)
    shed = [0]
    stop_streams = threading.Event()
    bases = {}

    def submit(img, session=None):
        try:
            return b.submit(img, session_id=session)
        except ShedError:
            shed[0] += 1
            return None

    def stream_client(c):
        """Sessions of ELASTIC_FRAMES frames each, one after another."""
        srng = np.random.default_rng(SEED + 100 + c)
        gen = 0
        while not stop_streams.is_set():
            sid = f"c{c}g{gen}"
            bases[sid] = 100.0 * srng.standard_normal(shape).astype(np.float32)
            f = 0
            while not stop_streams.is_set() and f < ELASTIC_FRAMES:
                img = (bases[sid] + 0.05 * srng.standard_normal(shape)).astype(np.float32)
                t_sub = time.monotonic()
                t = submit(img, sid)
                if t is None:
                    break
                t.result(timeout=300)
                streams.append((sid, f, t_sub, img, t))
                f += 1
                time.sleep(0.1)
            gen += 1

    sthreads = [threading.Thread(target=stream_client, args=(c,))
                for c in range(ELASTIC_CLIENTS)]
    for th in sthreads:
        th.start()
    orng = np.random.default_rng(SEED + 19)

    def open_loop(rate, until):
        t_next = time.monotonic()
        k = len(stateless)
        while not until():
            t_next += orng.exponential(1.0 / rate)
            wait = t_next - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            img = pool_imgs[k % len(pool_imgs)]
            k += 1
            t_sub = time.monotonic()
            t = submit(img)
            if t is not None:
                stateless.append((t_sub, img, t))

    for rate, dur in ((ELASTIC_LOW[0] * ceiling, ELASTIC_LOW[1]),
                      (ELASTIC_SPIKE[0] / ELASTIC_SPIKE[1], ELASTIC_SPIKE[1])):
        end = time.monotonic() + dur
        open_loop(rate, lambda: time.monotonic() >= end)
    settle_end = time.monotonic() + ELASTIC_SETTLE_S

    def settled():
        el = sc.record()
        return time.monotonic() >= settle_end or (
            el["n_scale_ins"] >= 2 and b.n_active_engines() == scfg.min_engines)

    open_loop(ELASTIC_TAIL * ceiling, settled)
    stop_streams.set()
    for th in sthreads:
        th.join()
    for _, _, t in stateless:
        t.result(timeout=300)
    # One more frame of every session the cache still holds: each starts
    # warm from the surviving engine's pool, the migrated ones included.
    last = {}
    for sid, f, _, _, t in streams:
        last[sid] = (f, t)
    for sid in sorted(last):
        if b.cache.lookup(sid) is None:
            continue
        img = (bases[sid] + 0.05 * orng.standard_normal(shape)).astype(np.float32)
        t_sub = time.monotonic()
        t = submit(img, sid)
        if t is not None:
            t.result(timeout=300)
            streams.append((sid, last[sid][0] + 1, t_sub, img, t))
    t_end = time.monotonic()
    sc.stop()
    b.stop()
    core.fused_consensus_update = k2_fn
    got = (k1.LAUNCHES, k1.LAUNCHES_ADD, k2.LAUNCHES)
    el = sc.record()
    s = b.summary_record()

    # -- the checks -------------------------------------------------------------
    tickets = [t for _, _, t in stateless] + [x[4] for x in streams]
    leaves = collections.Counter(r["trace_id"] for r in tap.events("resolve"))
    served_once = (shed[0] == 0 and s["n_failed"] == 0 and s["n_shed"] == 0
                   and s["n_served"] == s["n_submitted"] == len(tickets)
                   and all(t.done() for t in tickets)
                   and all(leaves[t.trace_id] == 1 for t in tickets))
    errors = [r for r in tap.recs if r.get("kind") == "error"]
    # 3. Each decision's chain, in order, under its decision_id.
    chain_events = ("scale_out_decision", "engine_add", "scale_out", "spare_promote",
                    "admission_open", "spawn_rollback", "scale_in_decision", "drain_begin",
                    "drain_flush", "drain_migrate", "drain_release", "spare_demote",
                    "drain_abort")
    by_id = collections.defaultdict(list)
    for rec in tap.recs:
        if rec.get("kind") == "decision":
            by_id[rec.get("decision_id")].append("decision")
        elif rec.get("kind") == "serve" and rec.get("event") in chain_events:
            by_id[rec.get("decision_id")].append(rec["event"])
    drain = ["decision", "scale_in_decision", "drain_begin", "drain_flush", "drain_migrate",
             "drain_release"]
    patterns = {
        "spawn": ["decision", "scale_out_decision", "engine_add", "scale_out", "admission_open"],
        "promote": ["decision", "scale_out_decision", "engine_add", "spare_promote",
                    "admission_open"],
        "rollback": ["decision", "scale_out_decision", "spawn_rollback"],
        "release": drain, "demote": drain + ["spare_demote"],
    }
    kinds = {did: next((k for k, p in patterns.items() if p == evs), None)
             for did, evs in by_id.items()}
    rollbacks = tap.events("spawn_rollback")
    chains_ok = (None not in by_id and None not in kinds.values()
                 and sorted(by_id) == list(range(1, len(by_id) + 1))
                 and all(sum(k == want for k in kinds.values()) >= 1
                         for want in ("spawn", "promote", "release", "demote"))
                 and len(rollbacks) == 1
                 and rollbacks[0]["exception"].startswith("InjectedFault"))
    # 4. No dispatch reaches an engine outside its registration (admission
    # opens inside add_engine; admission_open is stamped right after), and
    # every registration comes after the engine's warm-up returned.
    added = sorted({n for n, _, _ in probe["registrations"]})
    admission_ok = bool(added) and not probe["early"] and all(
        w is not None and w <= t for _, w, t in probe["registrations"])
    t_rec = {id(r): t for t, r in tap.timed}
    first_disp, opened = {}, {}
    for r in tap.events("dispatch"):
        first_disp.setdefault(alias[r["engine"]], t_rec[id(r)])
    for r in tap.events("admission_open"):
        opened.setdefault(alias[r["engine"]], t_rec[id(r)])
    dispatch_after_record = {n: first_disp.get(n, math.inf) >= opened.get(n, -math.inf)
                             for n in added}
    warm_to_admit_ms = [round(1e3 * (t - w), 3) for _, w, t in probe["registrations"]
                        if w is not None]
    # 5. Migrated pages bit for bit; each migrated session's next frame
    # (the stream's, or the final one) served warm from the pool it landed
    # in, with no levels0 from the host.
    mig_ok, n_mig, next_frame = True, 0, {}
    for m in migrations:
        n_mig += m["out"]["n_migrated"]
        mig_ok &= len(set(m["moved"])) == len(m["moved"]) == m["out"]["n_migrated"]
        mig_ok &= all(sid in m["after"] for sid in m["moved"])
        for sid in m["moved"]:
            row = m["after"].get(sid)
            if row is None:
                continue
            mig_ok &= torch.equal(row, m["before"][sid])
            mig_ok &= content_hash(row.cpu()) == content_hash(m["before"][sid].cpu())
            later = [x for x in streams if x[0] == sid and x[2] > m["t_end"]]
            if later:
                next_frame[sid] = min(later, key=lambda x: x[2])[4]
    disp_by_trace = {}
    per_engine = collections.defaultdict(list)
    for r in tap.events("dispatch"):
        per_engine[alias[r["engine"]]].append(r)
    warm_rows = {}
    calls_ok = True
    for name, recs in per_engine.items():
        calls = probe["calls"][name]
        calls_ok &= len(calls) == len(recs)
        for r, call in zip(recs, calls):
            for i, tid in enumerate(r["trace_ids"]):
                disp_by_trace[tid] = r
                warm_rows[tid] = bool(call and call[i])
            calls_ok &= r["n_page_warm"] == sum(call or [])
    next_hits = 0
    for tick in next_frame.values():
        r = disp_by_trace.get(tick.trace_id)
        next_hits += bool(r and warm_rows[tick.trace_id] and r["levels0_h2d_bytes"] == 0)
    migrate_ok = mig_ok and n_mig >= 1 and calls_ok and next_hits == len(next_frame) >= 1
    # 6. Each release returned its pool's buffer.
    demoted = sum(bool(r["demoted"]) for r in tap.events("drain_release"))
    releases = probe["releases"]
    release_ok = (len(releases) == len(tap.events("drain_release")) - demoted >= 1
                  and all(r["buffer_freed"] and r["released"] for r in releases))
    # 7. Exact launches: every warm-up forward and every bucket dispatch.
    n_disp = len(tap.events("dispatch"))
    n_warm = len(buckets) * len([n for n in probe["warm_end"] if n != "engine0"])
    launches_ok = got == (2 * T * (n_disp + n_warm), T * (n_disp + n_warm), T * (n_disp + n_warm))
    # 2. Every ticket bit for bit its bucket replayed through engine.infer
    # on the engine that served it (a released engine's through a fresh
    # replica with the same weights: it serves no more), warm rows from the
    # session's previous frame.
    replay_eng = InferenceEngine(cfg, dataclasses.replace(
        scfg, page_pool_pages=0, column_cache_bytes=0, elastic=False), params=params,
        device=dev, name="replay")
    prev, by_trace = {}, {}
    for sid, f, _, img, t in streams:
        by_trace[t.trace_id] = (img, t, prev.get(sid))
        prev[sid] = t
    for _, img, t in stateless:
        by_trace[t.trace_id] = (img, t, None)
    bitwise, n_replayed_fresh = True, 0
    cold = eng0.cold_levels()
    for r in tap.events("dispatch"):
        rows = [by_trace[tid] for tid in r["trace_ids"]]
        eng = engines[alias[r["engine"]]]
        if eng.released:
            eng, n_replayed_fresh = replay_eng, n_replayed_fresh + 1
        imgs = np.zeros((r["bucket"], *shape), np.float32)
        lv0 = torch.zeros((r["bucket"], *cold.shape), dtype=cold.dtype)
        warm_any = False
        for i, (img, _, before_t) in enumerate(rows):
            imgs[i] = img
            if warm_rows[r["trace_ids"][i]]:
                lv0[i] = before_t.result()[0]
                warm_any = True
            else:
                lv0[i] = cold
        kw = {"levels0": lv0} if warm_any else {}
        want = eng.infer(imgs, n_valid=r["n_valid"], **kw).levels[:r["n_valid"]].cpu()
        bitwise &= all(torch.equal(t.result()[0], want[i]) for i, (_, t, _) in enumerate(rows))
    # 8. The decision chain audits clean from the phase's stream alone.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "elastic.jsonl")
        with open(path, "w") as fh:
            for rec in tap.recs:
                fh.write(json.dumps(rec) + "\n")
        audit = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", "audit", path],
                               cwd=os.path.dirname(os.path.abspath(__file__)),
                               capture_output=True, text=True, timeout=120)
    audit_rep = json.loads(audit.stdout.splitlines()[-1]) if audit.stdout.strip() else {}
    # What each fleet size reaches on the card: closed-loop ceilings of
    # fleets of 1, 2 and 3 replicas (8 clients an engine, sizes in turns
    # 1, 2, 3, 3, 2, 1), with K2's host time a call under that load.
    ceiling_fleet = [replay_eng] + [
        InferenceEngine(cfg, replay_eng.scfg, params=params, device=dev, name=f"ceiling{i}")
        for i in (1, 2)]
    for e in ceiling_fleet:
        e.warmup()
    by_size_ceiling = collections.defaultdict(list)
    for size in (1, 2, 3, 3, 2, 1):
        by_size_ceiling[size].append(closed_loop(ceiling_fleet[:size], 8 * size))

    # -- the numbers ----------------------------------------------------------
    timeline = el["timeline"]

    def fleet_at(t_mono):
        rel, n = t_mono - sc._t0, timeline[0][1]
        for t_rel, size in timeline:
            if t_rel <= rel:
                n = size
        return n

    per_size = collections.defaultdict(lambda: dict(lat=[], done=0))
    for t_sub, _, t in stateless + [(x[2], x[3], x[4]) for x in streams]:
        per_size[fleet_at(t_sub)]["lat"].append(t.result()[2])
    span_s = collections.Counter()
    edges = [(t_rel + sc._t0, n) for t_rel, n in timeline] + [(t_end, None)]
    for (ta, n), (tb, _) in zip(edges, edges[1:]):
        lo, hi = max(ta, t_run), min(tb, t_end)
        if hi > lo:
            span_s[n] += hi - lo
    for t_sub, _, t in stateless + [(x[2], x[3], x[4]) for x in streams]:
        per_size[fleet_at(t_sub + t.result()[2])]["done"] += 1
    by_size = {str(n): dict(
        seconds=span_s[n], requests=len(v["lat"]),
        requests_per_s=v["done"] / span_s[n] if span_s[n] else None,
        latency_ms={"p50": float(np.percentile(np.asarray(v["lat"]) * 1e3, 50)),
                    "p99": float(np.percentile(np.asarray(v["lat"]) * 1e3, 99))})
        for n, v in sorted(per_size.items()) if v["lat"]}
    t_dec = {r["decision_id"]: t_rec[id(r)] for r in tap.recs if r.get("kind") == "decision"}
    actions = []
    for did, kind in sorted(kinds.items(), key=str):
        if kind is None or did not in t_dec:
            continue
        end_ev = {"spawn": "admission_open", "promote": "admission_open",
                  "rollback": "spawn_rollback", "release": "drain_release",
                  "demote": "drain_release"}[kind]
        t_done = next(t_rec[id(r)] for r in tap.events(end_ev) if r.get("decision_id") == did)
        actions.append(dict(decision_id=did, action=kind, to=end_ev,
                            ms=1e3 * (t_done - t_dec[did])))
    k2_by_size = collections.defaultdict(list)
    for t_call, dt in k2_calls:
        k2_by_size[fleet_at(t_call)].append(dt * 1e6)
    launches = {"grouped_mlp_fwd": got[0] - got[1], "grouped_mlp_fwd_add": got[1],
                "consensus_update_fwd": got[2]}
    spawn = tap.events("scale_out")
    ok = (served_once and not errors and chains_ok and admission_ok and migrate_ok
          and release_ok and launches_ok and bitwise and audit.returncode == 0)
    emit("serve_elastic", ceiling_one_engine_requests_per_s=ceiling,
         policy=dict(ELASTIC_POLICY, min_engines=1, max_engines=ELASTIC_MAX,
                     warm_pool=ELASTIC_WARM_POOL, queue_depth=ELASTIC_QUEUE),
         ramp=[dict(requests_per_s=ELASTIC_LOW[0] * ceiling, seconds=ELASTIC_LOW[1]),
               dict(requests_per_s=ELASTIC_SPIKE[0] / ELASTIC_SPIKE[1],
                    seconds=ELASTIC_SPIKE[1]),
               dict(requests_per_s=ELASTIC_TAIL * ceiling, seconds=None)],
         requests=len(tickets), stateless=len(stateless), stream_frames=len(streams),
         fleet_timeline=timeline, by_fleet_size=by_size, actions=actions,
         spawn_ms=[r["spawn_ms"] for r in spawn],
         promote_ms=[r["promote_ms"] for r in tap.events("spare_promote")],
         spare_spawn_ms=[r["spawn_ms"] for r in tap.events("spare_spawn")],
         migrations=[dict(src=m["src"], dst=m["dst"], sessions=m["out"]["n_migrated"],
                          invalidated=m["out"]["n_invalidated"],
                          bytes=m["out"]["bytes_migrated"],
                          pages=m["out"]["bytes_migrated"] // m["page_bytes"], ms=m["ms"],
                          written_not_migrated=len(set(m["after"]) - set(m["moved"])),
                          dst_writes_by_others=m["dst_writes_by_others"][0],
                          dst_writes_by_others_of_src_sessions=m["dst_writes_by_others"][1])
                     for m in migrations],
         flush_ms=[r["flush_ms"] for r in tap.events("drain_flush")],
         migrated_next_frame_hits=next_hits, releases=releases,
         closed_loop_by_fleet_size={str(n): dict(
             requests_per_s=[rps for rps, _ in v], k2_host_us_per_call=[us for _, us in v],
             clients=8 * n) for n, v in sorted(by_size_ceiling.items())},
         k2_host_us_per_call={str(n): dict(median=statistics.median(v), calls=len(v))
                              for n, v in sorted(k2_by_size.items())},
         launches={"K1": got[0], "K1_add": got[1], "K2": got[2]}, dispatches=n_disp,
         warmup_forwards=n_warm, launches_per_dispatch={"K1": 2 * T, "K1_add": T, "K2": T},
         decisions=len(by_id), chains={str(k): v for k, v in kinds.items()},
         audit=audit_rep, summary_elastic=el,
         replayed_on_fresh_replica=n_replayed_fresh,
         dispatch_after_admission_record=dispatch_after_record,
         warmup_to_registration_ms=warm_to_admit_ms,
         checks=dict(served_once=served_once, autoscaler_errors=len(errors),
                     chains=chains_ok, admission_after_warmup=admission_ok,
                     migration_bitwise_and_next_hit=migrate_ok, release_frees_pool=release_ok,
                     launches_exact=launches_ok, bitwise_equal_engine_replay=bitwise,
                     audit_rc=audit.returncode), ok=ok)
    if not ok:
        raise AssertionError(
            f"serve_elastic: served once {served_once}, errors {len(errors)}, chains "
            f"{chains_ok} {dict(kinds)}, admission {admission_ok}, migration {migrate_ok} (pages "
            f"{mig_ok}, migrated {n_mig}, calls {calls_ok}, next frames warm {next_hits} of "
            f"{len(next_frame)}), "
            f"release {release_ok}, launches {got} for {n_disp} + {n_warm}, bitwise {bitwise}, "
            f"audit {audit.returncode} {audit.stderr[-500:]}")
    del engines, replay_eng, ceiling_fleet, tickets, streams, stateless, migrations

    # -- serve_cli_elastic: python -m glom_tpu_torch.serve --elastic -------------
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "serve.jsonl")
        argv = [sys.executable, "-m", "glom_tpu_torch.serve",
                *(cli_argv or ["--preset", "imagenet224-dp8", "--device", "cuda"]),
                "--elastic", "--min-engines", "1", "--max-engines", "2", "--warm-pool", "1",
                "--forecast", "--ramp", CLI_ELASTIC_RAMP, "--queue-depth", "512",
                "--elastic-p99-ms", "100", "--elastic-window", "2",
                "--elastic-low-water", "0.7", "--elastic-high-water", "0.9",
                "--elastic-dwell", "0.05",
                "--elastic-cooldown", "0.5", "--elastic-interval", "0.05",
                "--elastic-settle", "10", "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        lint = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", out],
                              cwd=root, capture_output=True, text=True, timeout=120)
        audit = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", "audit", out],
                               cwd=root, capture_output=True, text=True, timeout=120)
        recs = []
        if os.path.exists(out):
            with open(out) as fh:
                recs = [json.loads(line) for line in fh if line.startswith("{")]
    summary = [r for r in recs if r.get("event") == "summary"]
    n_ramp = sum(int(p.split("x")[0]) for p in CLI_ELASTIC_RAMP.split(","))
    s = summary[-1] if summary else {}
    cli_ok = (proc.returncode == 0 and lint.returncode == 0 and audit.returncode == 0
              and len(summary) == 1 and s.get("n_requests") == s.get("n_served") == n_ramp)
    emit("serve_cli_elastic", argv=argv[1:], rc=proc.returncode, lint_rc=lint.returncode,
         audit_rc=audit.returncode, seconds=cli_s, requests=s.get("n_requests"),
         served=s.get("n_served"), failed=s.get("n_failed"), elastic=s.get("elastic"),
         forecasts=sum(1 for r in recs if r.get("kind") == "forecast"),
         decisions=sum(1 for r in recs if r.get("kind") == "decision"),
         audit=json.loads(audit.stdout.splitlines()[-1]) if audit.stdout.strip() else None,
         ok=cli_ok, stderr_tail=None if cli_ok else (proc.stderr + audit.stderr)[-2000:])
    if not cli_ok:
        raise AssertionError(f"serve_cli_elastic: rc {proc.returncode}, lint {lint.returncode}, "
                             f"audit {audit.returncode}, summary {s.get('n_requests')}/"
                             f"{s.get('n_served')}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel ran no time in the elastic fleet: {launches}")
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_timing import device_us_by_kernel, host_us, time_ms
    import glom_tpu_torch.kernels.banded_consensus as k4
    import glom_tpu_torch.kernels.consensus_update as k2
    import glom_tpu_torch.kernels.grouped_mlp as k1
    from glom_tpu_torch import GlomConfig, InferenceEngine, ServeConfig, entry, glom_forward
    from glom_tpu_torch.kernels import _build
    from glom_tpu_torch.models.core import init_glom, map_params
    from glom_tpu_torch.ops.ffw import GroupedFFWParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.prebuild()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in logs.items()
    }
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # -- device --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi, flush=True)
    emit("device", name=name, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape, dtype=f32, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def compare(got, want, rtol, atol):
        """(ok, max abs err, max rel err, largest err / bar: ok iff <= 1)."""
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        ratio = float((diff / (atol + rtol * want.abs())).max())
        rel = float((diff / want.abs().clamp_min(1e-6)).max())
        return ratio <= 1.0, float(diff.max()), rel, ratio

    # (rtol, atol). f32: glom_tpu's kernel bars. bf16: about 1-2 bf16 ulps
    # of the output (one ulp is 2^-8 to 2^-7 of the value), tight enough
    # that a dropped bias term or softmax rescale fails on the inputs below.
    bars = {bf16: (1e-2, 1.6e-2), f32: (1e-4, 1e-5)}
    cons_bars = {bf16: (1e-2, 1.6e-2), f32: (2e-4, 2e-5)}
    # K4: K2's bars; bf16 is 1-2 ulps of the output (K4_PEAKED_WGMMA_BARS
    # for peaked inputs on "wgmma"), f32 about 20x the 1.2e-6 seen at these
    # inputs.
    k4_bars = cons_bars

    def ragged_maps(counts, pages, page_tokens, device):
        """Per-token row_start / row_len of rows packed page-aligned onto
        `pages` pages, each row's page span, and the used-token count. The
        pages past the last row are an empty last slot, as the engine packs
        one: they start at the used-token count with length 0, and their
        band runs past the last page (the clamp) where the rows leave fewer
        free pages than the band holds."""
        T = pages * page_tokens
        rs, rl = torch.zeros(T, dtype=torch.int32), torch.zeros(T, dtype=torch.int32)
        spans, off = [], 0
        for c in counts:
            k = -(-c // page_tokens)
            rs[off * page_tokens:(off + k) * page_tokens] = off * page_tokens
            rl[off * page_tokens:(off + k) * page_tokens] = c
            if k:
                spans.append((off * page_tokens, (off + k) * page_tokens))
            off += k
        rs[off * page_tokens:] = off * page_tokens
        return (dict(row_start=rs.to(device), row_len=rl.to(device)), spans,
                off * page_tokens)
    failures = []

    # -- K1 vs plain -----------------------------------------------------------
    L, n, d, f = 6, 256, 512, 2048
    M8 = 8 * n

    def ffw_params(G):
        # Biases at 0.1, so b1 and b2 move the output by many ulps.
        def rn(*shape, scale):
            return torch.randn(*shape, generator=gen) * scale
        return GroupedFFWParams(rn(G, d, f, scale=d ** -0.5), rn(G, f, scale=0.1),
                                rn(G, f, d, scale=f ** -0.5), rn(G, d, scale=0.1))

    ffw = {"bottom_up": ffw_params(L), "top_down": ffw_params(L - 1)}
    pos = torch.randn(n, d, generator=gen)
    # Edge shapes of the bf16 GEMM (128-row, 128-column tiles): M not a
    # multiple of the row tile, d = 64 and f = 192 not of the column tile, an
    # addend of n = 64 rows that wraps twice inside a row tile. (which, G,
    # M, d, f, n); n = 0: no addend.
    k1_edge = (("edge_bottom_up", 3, 2080, 64, 192, 0), ("edge_top_down", 2, 2112, 64, 192, 64))
    # Their inputs come from a generator of their own, so every later
    # phase draws what it drew before they were added.
    gen_e = torch.Generator().manual_seed(SEED + 1)
    edge_inputs = {}
    for which, G_e, M_e, d_e, f_e, n_e in k1_edge:
        edge_params = GroupedFFWParams(
            torch.randn(G_e, d_e, f_e, generator=gen_e) * d_e ** -0.5,
            torch.randn(G_e, f_e, generator=gen_e) * 0.1,
            torch.randn(G_e, f_e, d_e, generator=gen_e) * f_e ** -0.5,
            torch.randn(G_e, d_e, generator=gen_e) * 0.1)
        edge_inputs[which] = (edge_params, torch.randn(G_e, M_e, d_e, generator=gen_e),
                              torch.randn(n_e, d_e, generator=gen_e) if n_e else None)

    def edge_cases(dtype):
        """(which, params, x, add) at the edge shapes."""
        return [(which, GroupedFFWParams(*(t.to(dev, dtype) for t in p_e)), x_e.to(dev, dtype),
                 None if a_e is None else a_e.to(dev, dtype))
                for which, (p_e, x_e, a_e) in edge_inputs.items()]

    k1_err = {}
    for dtype in (bf16, f32):
        flagship = [(which, GroupedFFWParams(*(t.to(dev, dtype) for t in ffw[which])),
                     randn(G, M8, d, dtype=dtype),
                     pos.to(dev, dtype) if which == "top_down" else None)
                    for which, G in (("bottom_up", L), ("top_down", L - 1))]
        for which, params, x, add in flagship + edge_cases(dtype):
            got = k1.fused_grouped_ffw_lm(params, x, add=add)
            torch.cuda.synchronize()
            want = k1.grouped_mlp_plain(params, x, add)
            rtol, atol = bars[dtype]
            ok, abs_err, rel_err, ratio = compare(got, want, rtol, atol)
            if dtype == bf16:
                k1_err[which] = abs_err
            emit("k1_vs_plain", which=which, shape=list(x.shape), f=params.w1.shape[-1],
                 addend_rows=None if add is None else add.shape[0], dtype=str(dtype),
                 max_abs_err=abs_err, max_rel_err=rel_err, rtol=rtol, atol=atol,
                 bar_ratio=ratio, ok=ok)
            if not ok:
                failures.append(f"K1 {which} {dtype}")

    # -- K2 vs plain -----------------------------------------------------------
    def consensus_inputs(shape, dtype, rank=4, rms=8.0, g=None):
        """Levels of rank `rank` and rms `rms`: scores spread with std about
        rms / sqrt(rank) = 4, so the softmax is peaked and its running max
        moves between j tiles. bu = -(levels + pad(td)) cancels the other
        terms of the mean, so out = cons / div: the consensus term is what
        the check sees, while bu and td are still read. g: the generator
        (default `gen`)."""
        g = gen if g is None else g
        Lc, B, nc, dc = shape
        coef = torch.randn(Lc, B, nc, rank, generator=g)
        basis = torch.randn(Lc, B, rank, dc, generator=g) / rank ** 0.5
        lv = (rms * (coef @ basis)).to(dev, dtype)
        td = torch.randn(Lc - 1, B, nc, dc, generator=g).to(dev, dtype)
        td_pad = torch.cat([td.float(), torch.zeros_like(lv[:1], dtype=f32)])
        return lv, (-(lv.float() + td_pad)).to(dtype), td

    side = 16
    k2_err = None
    cases = [
        ((L, 8, n, d), side, 0.0, False),
        ((L, 8, n, d), side, 0.0, True),
        ((L, 8, n, d), side, 3.0, False),
    ]
    # Edge shapes of the bf16 kernel's 64-row, 64-key tiles: n % 64 == 32
    # (query rows past n, key columns past n that must get p = 0), a radius
    # window that crosses tile edges (side 24), attend_self both ways. Score
    # std about 1 (rms 2), so the keys past n would carry weight if unmasked.
    # Their inputs come from a generator of their own, so every later phase
    # draws what it drew before they were added.
    gen_k2e = torch.Generator().manual_seed(SEED + 2)
    k2_edge = [((L, 2, 96, d), 1, 0.0, False), ((L, 2, 160, d), 1, 0.0, True),
               ((L, 2, 576, d), 24, 3.0, False), ((L, 2, 576, d), 24, 3.0, True)]
    for dtype in (bf16, f32):
        for shape, sd, radius, attend_self in cases + k2_edge + (
            [((2, 1, 4096, d), 64, 0.0, False)] if dtype == bf16 else []
        ):
            edge = (shape, sd, radius, attend_self) in k2_edge
            lv, bu, td = consensus_inputs(shape, dtype, **(dict(rms=2.0, g=gen_k2e) if edge
                                                           else {}))
            got = k2.fused_consensus_update(lv, bu, td, side=sd, radius=radius,
                                            attend_self=attend_self)
            torch.cuda.synchronize()
            want = k2.consensus_update_plain(lv, bu, td, side=sd, radius=radius,
                                             attend_self=attend_self)
            rtol, atol = cons_bars[dtype]
            ok, abs_err, rel_err, ratio = compare(got, want, rtol, atol)
            if dtype == bf16 and shape == (L, 8, n, d) and radius == 0 and not attend_self:
                k2_err = abs_err
            emit("k2_vs_plain", shape=list(shape), dtype=str(dtype), radius=radius,
                 attend_self=attend_self, edge_case=edge, max_abs_err=abs_err,
                 max_rel_err=rel_err,
                 rtol=rtol, atol=atol, bar_ratio=ratio, ok=ok)
            if not ok:
                failures.append(f"K2 {shape} {dtype} r={radius} self={attend_self}")
    # -- K4 vs plain ------------------------------------------------------------
    # The flagship's largest ragged signature: 32 pages of 64 tokens, window
    # 256 (one 224-px row). Rows of 256/144/64/16/49/100 patches packed
    # page-aligned, with intra-row pads, an empty row slot, a last real row
    # whose band runs past the last page, and an unused trailing page
    # (row length 0, its band clamped: the uniform average of the last page).
    # bf16 runs the "wgmma" instance, f32 "fma". Then, from a generator of
    # their own (so later phases draw as before): peaked levels (rank 4 a
    # level, rms 8: p's rounding shows) at the same signature; pages of 128
    # (two key tiles a page), flat and peaked; pages of 32 ("fma" in bf16).
    # Every row span and the unused pages are held to the plain version.
    pt, P_sig, window = 64, 32, 256
    k4_counts = [256, 144, 64, 16, 256, 49, 0, 256, 144, 64, 16, 256, 49, 100, 16]
    gen_k4 = torch.Generator().manual_seed(SEED + 3)

    def k4_levels(T, dtype, inputs):
        """[T, L, d] levels from gen_k4: "flat" iid at rms 2, "peaked" of
        rank 4 a level at rms 8."""
        if inputs == "flat":
            return (2.0 * torch.randn(T, L, d, generator=gen_k4)).to(dev, dtype)
        coef = torch.randn(T, L, 4, generator=gen_k4)
        basis = torch.randn(L, 4, d, generator=gen_k4)
        return (4.0 * torch.einsum("tlr,lrd->tld", coef, basis)).contiguous().to(dev, dtype)

    # Each layout leaves fewer free pages than a band holds, so the unused
    # pages' band runs past the last page.
    k4_extra = [(64, P_sig, k4_counts, "peaked"),
                (128, 11, [256, 200, 64, 256, 49, 0, 128, 100], "flat"),
                (128, 11, [256, 200, 64, 256, 49, 0, 128, 100], "peaked"),
                (32, 64, k4_counts, "flat")]
    k4_err = 0.0
    for k4_pt, pages, counts, inputs in [(pt, P_sig, k4_counts, "flat")] + k4_extra:
        maps, spans, used = ragged_maps(counts, pages, k4_pt, dev)
        for dtype in (bf16, f32):
            instance = k4.k4_instance(dtype, k4_pt)
            rtol, atol = (K4_PEAKED_WGMMA_BARS if inputs == "peaked" and instance == "wgmma"
                          else k4_bars[dtype])
            for attend_self in (False, True):
                if inputs == "flat" and k4_pt == pt:
                    lv = randn(pages * k4_pt, L, d, dtype=dtype, scale=2.0)
                else:
                    lv = k4_levels(pages * k4_pt, dtype, inputs)
                kw = dict(maps, window=window, page_tokens=k4_pt, attend_self=attend_self)
                got = k4.banded_ragged_consensus(lv, **kw)
                torch.cuda.synchronize()
                want = k4.banded_ragged_consensus_plain(lv, **kw)
                rows = [compare(got[a:b], want[a:b], rtol, atol) for a, b in spans]
                unused = compare(got[used:], want[used:], rtol, atol)
                ok = all(w[0] for w in rows) and unused[0]
                abs_err = max(w[1] for w in rows)
                if dtype == bf16 and k4_pt == pt:
                    k4_err = max(k4_err, abs_err)
                emit("k4_vs_plain", shape=[pages * k4_pt, L, d], page_tokens=k4_pt,
                     window=window, dtype=str(dtype), instance=instance, inputs=inputs,
                     attend_self=attend_self, rows=counts, max_abs_err=abs_err,
                     max_rel_err=max(w[2] for w in rows), rtol=rtol, atol=atol,
                     bar_ratio=max(w[3] for w in rows), unused_pages=(pages * k4_pt - used)
                     // k4_pt, unused_max_abs_err=unused[1], unused_bar_ratio=unused[3], ok=ok)
                if not ok:
                    failures.append(f"K4 {dtype} pt={k4_pt} {inputs} self={attend_self}")
    if failures:
        raise AssertionError(f"kernel/plain mismatch: {failures}")

    # -- backward kernels vs plain -------------------------------------------------
    def err_over_max(got, want):
        """max |got - want| over max |want|."""
        got, want = got.float(), want.float()
        return float((got - want).abs().max()), float(
            (got - want).abs().max() / want.abs().max().clamp_min(1e-30))

    def check_bwd(kernel, case, pairs, bar, phase=None):
        """Compare each (name, got, want); record and emit; return the
        largest max-abs error. A case's `entry_equals_passes`, where it has
        one, must hold too."""
        errs = {name: err_over_max(got, want) for name, got, want in pairs}
        ok = all(r <= bar for _, r in errs.values()) and case.get("entry_equals_passes", True)
        emit(phase or f"{kernel.lower()}_bwd_vs_plain", **case, bar=bar,
             max_abs_err={k: v[0] for k, v in errs.items()},
             err_over_max={k: v[1] for k, v in errs.items()},
             bar_ratio=max(r for _, r in errs.values()) / bar, ok=ok)
        if not ok:
            failures.append(f"{kernel} bwd {case}")
        return max(a for a, _ in errs.values())

    k1_bwd_err = {}
    for dtype in (bf16, f32):
        dname = "bf16" if dtype == bf16 else "f32"
        # (which, groups, b1 centre, recompute): the saved pre where the
        # training forward saves it (bf16), else the recompute.
        k1_cases = [("bottom_up", L, None, False), ("top_down", L - 1, None, False)]
        if dtype == bf16:
            # b1 near -4, where the tanh GELU's derivative and the erf one
            # differ by a third: the derivative form is what this case sees.
            k1_cases.append(("gelu_tail", L, -4.0, False))
            # The bf16 recompute path (pre=None, past SAVE_PRE_LIMIT on no
            # measured route), still the WMMA row and weight passes.
            k1_cases += [("bottom_up", L, None, True), ("top_down", L - 1, None, True)]
        for which, G, b1_center, recompute in k1_cases:
            src = ffw["top_down" if which == "top_down" else "bottom_up"]
            params = GroupedFFWParams(*(t.to(dev, dtype) for t in src))
            if b1_center is not None:
                params = GroupedFFWParams(
                    params.w1 * 0.1, b1_center + 0.1 * randn(G, f, dtype=dtype),
                    params.w2, params.b2)
            x = randn(G, M8, d, dtype=dtype)
            g = randn(G, M8, d, dtype=dtype)
            add = pos.to(dev, dtype) if which == "top_down" else None
            pre = None
            if k1.save_pre_ok(params, x) and not recompute:  # the forward's saved pre
                pre = k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1]
            got = k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre)
            torch.cuda.synchronize()
            want = k1.grouped_mlp_bwd_plain(params, x, g, add, pre)
            pairs = [("dx", got[0], want[0]),
                     *((nm, a, b) for nm, a, b in zip(("dw1", "db1", "dw2", "db2"),
                                                       got[1], want[1]))]
            if add is not None:
                pairs.append(("da", got[2], want[2]))  # over 8 batch copies
            err = check_bwd("K1", dict(which=which, shape=[G, M8, d], dtype=str(dtype),
                                       saved_pre=pre is not None), pairs, BWD_BARS["K1"][dname])
            if dtype == bf16 and which in ("bottom_up", "top_down") and pre is not None:
                k1_bwd_err[which] = err

    def flat_levels(shape, dtype):
        """Unit-variance levels: scores near 0, so inside a radius-1 window
        the diagonal carries about a fifth of each row's weight."""
        return randn(*shape, dtype=dtype)

    k2_bwd_err = {}
    for dtype in (bf16, f32):
        dname = "bf16" if dtype == bf16 else "f32"
        k2_cases = [
            ((L, 8, n, d), side, 0.0, False, "peaked"),
            ((L, 8, n, d), side, 0.0, True, "peaked"),
            ((L, 8, n, d), side, 3.0, False, "peaked"),
            ((L, 8, n, d), side, 3.0, True, "peaked"),
            ((L, 8, n, d), side, 1.0, False, "flat"),
            ((2, 1, 1024, d), 32, 0.0, False, "peaked"),
        ]
        for shape, sd, radius, attend_self, kind in k2_cases:
            lv = (consensus_inputs(shape, dtype)[0] if kind == "peaked"
                  else flat_levels(shape, dtype))
            bu, td = randn(*shape, dtype=dtype), randn(shape[0] - 1, *shape[1:], dtype=dtype)
            kw = dict(side=sd, radius=radius, attend_self=attend_self)
            _, m, l = k2.fused_consensus_update(lv, bu, td, stats=True, **kw)
            g = randn(*shape, dtype=dtype)
            dq, dd, dcons = k2.consensus_bwd_dq(lv, g, m, l, **kw)
            dlv, dmean = k2.consensus_bwd_dkv(lv, g, m, l, dq, dd, dcons, **kw)
            via_entry = k2.consensus_update_bwd(lv, g, m, l, **kw)
            torch.cuda.synchronize()
            want_dq, want_dd = k2.consensus_bwd_dq_plain(lv, g, m, l, **kw)
            want_dlv, want_dmean, parts = k2.consensus_bwd_dkv_plain(
                lv, g, m, l, want_dq, want_dd, parts=True, **kw)
            bar = BWD_BARS["K2"][dname]
            # On the peaked inputs each summed term must be larger than the
            # error the bar allows in dlevels, so dropping any one of them
            # fails the check. The flat inputs are for the diagonal rule,
            # which the dq check sees.
            allowed = bar * float(want_dlv.float().abs().max())
            terms = {"dq": float(want_dq.abs().max()), "dv": float(parts["dv"].abs().max()),
                     "dxn": float(parts["dxn"].abs().max())}
            # The entry shares the dq pass's keys with the dkv pass: the same
            # bits as the two passes called alone.
            case = dict(shape=list(shape), dtype=str(dtype), radius=radius,
                        attend_self=attend_self, levels=kind,
                        term_over_allowed={k: v / allowed for k, v in terms.items()},
                        entry_equals_passes=all(map(torch.equal, via_entry, (dlv, dmean))))
            err = check_bwd("K2", case, [("dq", dq, want_dq), ("dd", dd, want_dd),
                                         ("dlevels", dlv, want_dlv), ("dmean", dmean, want_dmean)],
                            bar)
            if kind == "peaked" and min(terms.values()) <= allowed:
                failures.append(f"K2 bwd terms too small to check: {case}")
            if dtype == bf16 and shape == (L, 8, n, d) and radius == 0 and not attend_self:
                k2_bwd_err["dq"] = err_over_max(dq, want_dq)[0]
                k2_bwd_err["dkv"] = err_over_max(dlv, want_dlv)[0]
    if failures:
        raise AssertionError(f"backward kernel/plain mismatch: {failures}")

    # -- the whole-loop VJP's kernels vs plain --------------------------------------
    # The pre-only K1 launch, read through slot views of an [L+1] carry as the
    # loop reads it: bottom-up slots 0..L-1, top-down slots 2..L with the
    # addend; and at the edge shapes. It must equal the pre the K1 forward
    # saves, bit for bit.
    for dtype in (bf16, f32):
        carry = randn(L + 1, M8, d, dtype=dtype)
        cases = [(which, GroupedFFWParams(*(t.to(dev, dtype) for t in ffw[which])), x, add)
                 for which, x, add in (("bottom_up", carry[:L], None),
                                       ("top_down", carry[2:], pos.to(dev, dtype)))]
        for which, params, x, add in cases + edge_cases(dtype):
            got = k1.grouped_mlp_pre(params, x, add=add)
            saved = k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1]
            torch.cuda.synchronize()
            rtol, atol = bars[dtype]
            ok, abs_err, rel_err, ratio = compare(got, k1.grouped_mlp_pre_plain(params, x, add),
                                                  rtol, atol)
            equal = bool(torch.equal(got, saved))
            emit("k1_pre_vs_plain", which=which, shape=list(x.shape), dtype=str(dtype),
                 max_abs_err=abs_err, max_rel_err=rel_err, rtol=rtol, atol=atol,
                 bar_ratio=ratio, equals_saved_pre=equal, ok=ok and equal)
            if not (ok and equal):
                failures.append(f"K1 pre {which} {dtype}")

    # The accumulating K1 backward: incoming f32 totals and da as large as one
    # call's gradients, so a kernel that drops them (or writes over them)
    # fails; acc_over_allowed is each total's size over the error the bar
    # allows in the result.
    for dtype in (bf16, f32):
        dname = "bf16" if dtype == bf16 else "f32"
        bar = BWD_BARS["K1"][dname]
        cases = [("bottom_up", L, None), ("top_down", L - 1, None)]
        if dtype == bf16:
            cases.append(("gelu_tail", L, -4.0))
        for which, G, b1_center in cases:
            src = ffw["top_down" if which == "top_down" else "bottom_up"]
            params = GroupedFFWParams(*(t.to(dev, dtype) for t in src))
            if b1_center is not None:
                params = GroupedFFWParams(params.w1 * 0.1,
                                          b1_center + 0.1 * randn(G, f, dtype=dtype),
                                          params.w2, params.b2)
            carry = randn(L + 1, M8, d, dtype=dtype)
            x = carry[2:] if which == "top_down" else carry[:L]
            dmean = randn(L, M8, d, dtype=dtype)
            g = dmean[:G]  # the top-down call reads a prefix view of dmean
            add = pos.to(dev, dtype) if which == "top_down" else None
            pre = k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1]
            fresh = k1.grouped_mlp_bwd_plain(params, x, g, add, pre)
            acc = GroupedFFWParams(*(randn(*t.shape) * float(t.float().abs().max())
                                     for t in fresh[1]))
            da_in = None if add is None else randn(n, d) * float(fresh[2].float().abs().max())
            want = k1.grouped_mlp_bwd_plain(
                params, x, g, add, pre, GroupedFFWParams(*(t.clone() for t in acc)),
                None if da_in is None else da_in.clone())
            totals_in = dict(zip(("dw1", "db1", "dw2", "db2"), acc))
            if da_in is not None:
                totals_in["da"] = da_in
            totals_in = {k: float(v.abs().max()) for k, v in totals_in.items()}
            got = k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre, acc=acc, da_in=da_in)
            torch.cuda.synchronize()
            pairs = [("dx", got[0], want[0]),
                     *((nm, a, b) for nm, a, b in zip(("dw1", "db1", "dw2", "db2"),
                                                      got[1], want[1]))]
            if add is not None:
                pairs.append(("da", got[2], want[2]))
            allowed = {nm: bar * float(b.float().abs().max()) for nm, _, b in pairs}
            case = dict(which=which, shape=[G, M8, d], dtype=str(dtype),
                        acc_over_allowed={k: v / allowed[k] for k, v in totals_in.items()})
            check_bwd("K1 acc", case, pairs, bar, phase="k1_bwd_acc_vs_plain")
            if min(case["acc_over_allowed"].values()) <= 1.0:
                failures.append(f"K1 acc totals too small to check: {case}")

    # The K2 backward's combine: three nonzero cotangent streams, each
    # independent, so a stream dropped or read one level off moves dmean (=
    # their sum over the divisor) by about that stream / 4, far past the
    # bar: term_over_allowed says by how much.
    k2_comb_err = {}
    for dtype in (bf16, f32):
        dname = "bf16" if dtype == bf16 else "f32"
        bar = BWD_BARS["K2"][dname]
        for shape, sd, radius, kind, streams in (
            ((L, 8, n, d), side, 0.0, "peaked", True),
            ((L, 8, n, d), side, 3.0, "peaked", True),
            ((L, 8, n, d), side, 1.0, "flat", True),
            ((L, 8, n, d), side, 0.0, "peaked", False),
        ):
            lv = (consensus_inputs(shape, dtype)[0] if kind == "peaked"
                  else flat_levels(shape, dtype))
            kw = dict(side=sd, radius=radius, attend_self=False)
            bu, td = randn(*shape, dtype=dtype), randn(shape[0] - 1, *shape[1:], dtype=dtype)
            _, m, l = k2.fused_consensus_update(lv, bu, td, stats=True, **kw)
            dg = randn(*shape, dtype=dtype)
            dx_bu = randn(*shape, dtype=dtype) if streams else None
            dx_td = randn(shape[0] - 1, *shape[1:], dtype=dtype) if streams else None
            streams_kw = dict(kw, dx_bu=dx_bu, dx_td=dx_td)
            dq, dd, dcons = k2.consensus_bwd_dq(lv, dg, m, l, combine=True, **streams_kw)
            dlv, dmean = k2.consensus_bwd_dkv(lv, dg, m, l, dq, dd, dcons, combine=True,
                                              **streams_kw)
            via_entry = k2.consensus_update_bwd(lv, dg, m, l, combine=True, **streams_kw)
            torch.cuda.synchronize()
            want_dq, want_dd = k2.consensus_bwd_dq_plain(lv, dg, m, l, **streams_kw)
            want_dlv, want_dmean = k2.consensus_bwd_dkv_plain(lv, dg, m, l, want_dq, want_dd,
                                                              **streams_kw)
            allowed = bar * float(want_dmean.float().abs().max())
            terms = {nm: float(t.float().abs().max()) / 4.0 / allowed
                     for nm, t in (("dg", dg), ("dx_bu", dx_bu), ("dx_td", dx_td))
                     if t is not None}
            case = dict(shape=list(shape), dtype=str(dtype), radius=radius, levels=kind,
                        streams=streams, term_over_allowed=terms,
                        entry_equals_passes=all(map(torch.equal, via_entry, (dlv, dmean))))
            check_bwd("K2 combine", case, [("dq", dq, want_dq), ("dd", dd, want_dd),
                                           ("dlevels", dlv, want_dlv),
                                           ("dmean", dmean, want_dmean)],
                      bar, phase="k2_bwd_combine_vs_plain")
            if min(terms.values()) <= 1.0:
                failures.append(f"K2 combine streams too small to check: {case}")
            if dtype == bf16 and radius == 0 and streams:
                k2_comb_err["dq"] = err_over_max(dq, want_dq)[0]
                k2_comb_err["dkv"] = err_over_max(dlv, want_dlv)[0]
    if failures:
        raise AssertionError(f"whole-loop kernel/plain mismatch: {failures}")

    # -- the long-row training route's kernels vs plain ----------------------------
    # The K2 forward with the attention output saved, at the long-row training
    # shape (side 64, n = 4096, batch 2): cons, m, l and out against the plain
    # version, and out, m, l the same bits as the launch without the store.
    Lr, Br, nr, sr = L, 2, 4096, 64
    long_shape = (Lr, Br, nr, d)
    # m and l are f32 in both dtypes. In bf16 an element of k (normalised in
    # f32, its norm summed in another order) can round to the other bf16
    # neighbour in one of the two versions, which moves a whole column of
    # scores by up to about 1e-3 of its value: the row max m by that (1.9e-3
    # seen at a max score near 11), and l by the factor e^(that). About 4x.
    stat_bars = {bf16: {"m": (1e-3, 1e-3), "l": (8e-3, 1e-5)},
                 f32: {"m": cons_bars[f32], "l": cons_bars[f32]}}
    k2_cons_err = None
    for dtype in (bf16, f32):
        lv, bu, td = consensus_inputs(long_shape, dtype)
        got = k2.fused_consensus_update(lv, bu, td, side=sr, cons=True)
        no_store = k2.fused_consensus_update(lv, bu, td, side=sr, stats=True)
        torch.cuda.synchronize()
        want = k2.consensus_update_plain(lv, bu, td, side=sr, cons=True)
        same = all(torch.equal(a, b) for a, b in zip(got[:3], no_store))
        res = {nm: compare(a, b, *stat_bars[dtype].get(nm, cons_bars[dtype]))
               for nm, a, b in zip(("out", "m", "l", "cons"), got, want)}
        ok = same and all(r[0] for r in res.values())
        if dtype == bf16:
            k2_cons_err = res["cons"][1]
        emit("k2_fwd_cons_vs_plain", shape=list(long_shape), dtype=str(dtype), side=sr,
             max_abs_err={k: r[1] for k, r in res.items()},
             bar_ratio={k: r[3] for k, r in res.items()}, equals_launch_without_cons=same,
             ok=ok)
        if not ok:
            failures.append(f"K2 cons {dtype}")

    # The one-sweep backward at the same shape: peaked levels at global
    # consensus, attend_self both ways, and flat levels in a radius-1 window
    # (the diagonal carries about a fifth of each row's weight there, so the
    # diagonal rule is seen). Bars on max abs error over max |want|, and in
    # bf16 on the share of elements that differ at all (a moved rounding
    # point moves many by one ulp); each run twice, bit for bit.
    onesweep_err = {}
    for dtype in (bf16, f32):
        dname = "bf16" if dtype == bf16 else "f32"
        for radius, attend_self, kind in ((0.0, False, "peaked"), (0.0, True, "peaked"),
                                          (1.0, False, "flat")):
            lv = (consensus_inputs(long_shape, dtype)[0] if kind == "peaked"
                  else flat_levels(long_shape, dtype))
            kw = dict(side=sr, radius=radius, attend_self=attend_self)
            bu, td = randn(*long_shape, dtype=dtype), randn(Lr - 1, Br, nr, d, dtype=dtype)
            _, m, l, cons = k2.fused_consensus_update(lv, bu, td, cons=True, **kw)
            g = randn(*long_shape, dtype=dtype)
            got = k2.consensus_bwd_onesweep(lv, g, m, l, cons, **kw)
            again = k2.consensus_bwd_onesweep(lv, g, m, l, cons, **kw)
            torch.cuda.synchronize()
            want = k2.consensus_bwd_onesweep_plain(lv, g, m, l, cons, **kw)
            abs_err, ratio = err_over_max(got, want)
            mismatch = float((got != want).float().mean())
            bar = ONESWEEP_BARS[dname]
            mbar = ONESWEEP_MISMATCH_BAR if dtype == bf16 else None  # f32: every bit moves
            repeat = bool(torch.equal(got, again))
            ok = ratio <= bar and (mbar is None or mismatch <= mbar) and repeat
            onesweep_err[(dname, radius, attend_self)] = abs_err
            emit("k2_onesweep_vs_plain", shape=list(long_shape), dtype=str(dtype),
                 radius=radius, attend_self=attend_self, levels=kind, max_abs_err=abs_err,
                 err_over_max=ratio, bar=bar, bar_ratio=ratio / bar, mismatch_share=mismatch,
                 mismatch_bar=mbar, mismatch_bar_ratio=None if mbar is None else mismatch / mbar,
                 bitwise_repeat=repeat, ok=ok)
            if not ok:
                failures.append(f"K2 one-sweep {dtype} r={radius} self={attend_self}")

    # The combined td || bu K1 grid at flagship batch 8 (11 groups): forward
    # with the saved pre, pre-only, accumulating backward, each against the
    # two split launches on the same carry and dmean, bit for bit; the
    # forward's error against the plain version for the kernels line.
    k1_cat_err = None
    for dtype in (bf16, f32):
        bu_p = GroupedFFWParams(*(t.to(dev, dtype) for t in ffw["bottom_up"]))
        td_p = GroupedFFWParams(*(t.to(dev, dtype) for t in ffw["top_down"]))
        wcat = k1.cat_params(td_p, bu_p)
        carry = randn(L + 1, M8, d, dtype=dtype)
        add = pos.to(dev, dtype)
        out, pre = k1.fused_grouped_ffw_lm(wcat, carry, add=add, save_pre=True, cat=True)
        pre_only = k1.grouped_mlp_pre(wcat, carry, add=add, cat=True)
        out_td, pre_td = k1.fused_grouped_ffw_lm(td_p, carry[2:], add=add, save_pre=True)
        out_bu, pre_bu = k1.fused_grouped_ffw_lm(bu_p, carry[:L], save_pre=True)
        dmean = randn(L, M8, d, dtype=dtype)
        acc = GroupedFFWParams(*(randn(*t.shape) for t in wcat))
        da_in = randn(n, d)
        acc_td = GroupedFFWParams(*(t[:L - 1].clone() for t in acc))
        acc_bu = GroupedFFWParams(*(t[L - 1:].clone() for t in acc))
        acc0, da0 = GroupedFFWParams(*(t.clone() for t in acc)), da_in.clone()
        da_split = da_in.clone()
        dx, grads, da = k1.grouped_mlp_bwd(wcat, carry, dmean, add=add, pre=pre, acc=acc,
                                           da_in=da_in, cat=True)
        dx_td, _, _ = k1.grouped_mlp_bwd(td_p, carry[2:], dmean[:L - 1], add=add, pre=pre_td,
                                         acc=acc_td, da_in=da_split)
        dx_bu, _, _ = k1.grouped_mlp_bwd(bu_p, carry[:L], dmean, pre=pre_bu, acc=acc_bu)
        torch.cuda.synchronize()
        equal = {
            "fwd_out": torch.equal(out, torch.cat([out_td, out_bu])),
            "fwd_pre": torch.equal(pre, torch.cat([pre_td, pre_bu])),
            "pre_only": torch.equal(pre_only, pre),
            "bwd_dx": torch.equal(dx, torch.cat([dx_td, dx_bu])),
            "bwd_totals": all(torch.equal(a, torch.cat([t, b]))
                              for a, t, b in zip(grads, acc_td, acc_bu)),
            "bwd_da": torch.equal(da, da_split),
        }
        # Against the plain versions: the forward's out and the pre-only
        # launch at the forward bars, the backward's dx at K1's backward bar.
        want_out, want_pre = k1.grouped_mlp_plain(wcat, carry, add, save_pre=True, cat=True)
        want_dx = k1.grouped_mlp_bwd_plain(wcat, carry, dmean, add, pre, acc0, da0, cat=True)[0]
        vs_plain = {"fwd": compare(out, want_out, *bars[dtype]),
                    "pre": compare(pre_only, want_pre, *bars[dtype])}
        dx_err, dx_ratio = err_over_max(dx, want_dx)
        dx_bar = BWD_BARS["K1"]["bf16" if dtype == bf16 else "f32"]
        ok_p = all(r[0] for r in vs_plain.values()) and dx_ratio <= dx_bar
        if dtype == bf16:
            k1_cat_err = {"fwd": vs_plain["fwd"][1], "pre": vs_plain["pre"][1], "bwd": dx_err}
        emit("k1_cat_vs_plain", groups=2 * L - 1, shape=[L + 1, M8, d], dtype=str(dtype),
             equal_to_split=equal,
             max_abs_err_vs_plain={"fwd": vs_plain["fwd"][1], "pre": vs_plain["pre"][1],
                                   "bwd_dx": dx_err},
             bar_ratio_vs_plain={"fwd": vs_plain["fwd"][3], "pre": vs_plain["pre"][3],
                                 "bwd_dx": dx_ratio / dx_bar},
             ok=all(equal.values()) and ok_p)
        if not (all(equal.values()) and ok_p):
            failures.append(f"K1 cat grid {dtype}: {equal}")
    if failures:
        raise AssertionError(f"long-row / combined-grid kernel mismatch: {failures}")

    # -- timing ----------------------------------------------------------------
    def bound(ops, nbytes, peak_ops):
        t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    timings = {}

    def record_timing(label, shape, ms, plain_ms, ops, nbytes, library_ms=None,
                      peak=PEAK_BF16, library_seq_ms=None, **extra):
        """Keep and print one bf16 kernel's times beside its bound (its
        operations at `peak`: the bf16 tensor rate, or f32 for K4's "fma").
        library_seq_ms: a short sequence of PyTorch calls for the same
        function, where no one call computes it."""
        b_ms, b_by = bound(ops, nbytes, peak)
        timings[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=library_ms)
        # A kernel made of several launches lists each with its own time. The
        # products a design computes are constants of the script: they stay
        # on the `timing` row, off the kernels line.
        timings[label].update({k: extra[k] for k in ("kernels_ms", "instance", "path")
                               if k in extra})
        if library_seq_ms is not None:
            timings[label]["library_seq_ms"] = library_seq_ms
        emit("timing", kernel=label, shape=shape, dtype="bfloat16", ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, ratio_to_bound=ms / b_ms,
             library_ms=library_ms, library_seq_ms=library_seq_ms, **extra)

    def k1_library_seq(params, x):
        """The K1 forward as three PyTorch calls on its input (the addend
        already added): baddbmm, gelu(approximate="tanh"), baddbmm."""
        h = torch.nn.functional.gelu(torch.baddbmm(params.b1[:, None], x, params.w1),
                                     approximate="tanh")
        return torch.baddbmm(params.b2[:, None], h, params.w2)

    k1_seq_call = ("torch.baddbmm, gelu(approximate='tanh'), torch.baddbmm (three calls; "
                   "with the addend, x + tile(add) first)")
    k1_seq_bwd_call = ("seq backward: torch.autograd.grad through torch.baddbmm, "
                       "gelu(approximate='tanh'), torch.baddbmm (dx, dw1, db1, dw2, db2, "
                       "retain_graph; with the addend, x + tile(add) is the leaf and no da is "
                       "formed; no f32 totals are accumulated)")

    def k1_seq_bwd_ms(params, x_in, g):
        """The K1 backward as autograd through the forward's three calls."""
        leaves = [t.detach().clone().requires_grad_() for t in (x_in, *params)]
        out = k1_library_seq(GroupedFFWParams(*leaves[1:]), leaves[0])
        return time_ms(lambda: torch.autograd.grad(out, leaves, grad_outputs=g,
                                                   retain_graph=True))

    # K1's backward launches by kernel (torch.profiler): the saved pre's sm90
    # passes (the addend's xa, dh, dx, the weight pass, da_reduce) or the
    # recompute's WMMA row and weight passes; the path they make; the host's
    # time a call.
    k1_bwd_names = ("mlp_bwd_addend_bf16", "mlp_bwd_dh_sm90", "mlp_bwd_dx_sm90",
                    "mlp_bwd_dw_sm90", "da_reduce", "mlp_bwd_rows_bf16", "mlp_bwd_weights_bf16")

    def k1_bwd_profile(run):
        for _ in range(3):
            us = device_us_by_kernel(run, calls=10, key=lambda name: next(
                (k for k in k1_bwd_names if k in name), "other"))
            if sum(us.values()):
                break
        else:
            raise AssertionError("three profiles of a K1 backward call saw no kernel")
        path = ("sm90" if "mlp_bwd_dh_sm90" in us else
                "wmma" if "mlp_bwd_rows_bf16" in us else "unknown")
        return dict(kernels_ms={k: v / 1e3 for k, v in us.items()},
                    host_us_per_call=host_us(run), path=path)

    def with_add(x, add):
        G = x.shape[0]
        return x if add is None else (x.view(G, -1, n, d) + add).view(x.shape)
    for label, which, G, M in (
        ("k1_bottom_up_b8", "bottom_up", L, M8),
        ("k1_top_down_b8", "top_down", L - 1, M8),
        ("k1_bottom_up_b1", "bottom_up", L, n),
    ):
        params = type(ffw[which])(*(t.to(dev, bf16) for t in ffw[which]))
        x = randn(G, M, d, dtype=bf16)
        add = pos.to(dev, bf16) if which == "top_down" else None
        ms = time_ms(lambda: k1.fused_grouped_ffw_lm(params, x, add=add))
        plain_ms = time_ms(lambda: k1.grouped_mlp_plain(params, x, add))
        if add is None:
            seq_ms = time_ms(lambda: k1_library_seq(params, x))
        else:
            seq_ms = time_ms(lambda: k1_library_seq(params, (x.view(G, -1, n, d) + add)
                                                    .view(G, M, d)))
        nbytes = 2 * (2 * G * M * d + 2 * G * d * f + G * (f + d) + (n * d if add is not None else 0))
        record_timing(label, [G, M, d], ms, plain_ms, 4 * G * M * d * f, nbytes,
                      library_seq_ms=seq_ms, library_seq_call=k1_seq_call,
                      host_us_per_call=host_us(lambda: k1.fused_grouped_ffw_lm(params, x, add=add)))

    # The library's one call for K2's attention alone, forward or backward:
    # scaled_dot_product_attention (q = levels, k = the l2-normalised levels,
    # v = levels, scale d^-1/2, bf16, attend_self=True). It leaves out the
    # self-score replacement, the mean update with bu and td (forward) and
    # the l2 norm's VJP and the mean's streams (backward).
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k2_lib_call = ("torch.nn.functional.scaled_dot_product_attention (q = levels, normalised "
                   "k, v = levels, bf16, attend_self=True): no self-score replacement, no mean "
                   "update")
    k2_lib_bwd_call = ("torch.nn.functional.scaled_dot_product_attention backward (dq, dk, dv "
                       "on q = levels, normalised k, v = levels, bf16, attend_self=True), "
                       "retain_graph: no norm VJP, no mean streams; the whole backward, both "
                       "passes")

    def k2_qkv(lv):
        """SDPA's q, k̂, v for levels [L, B, n, d], as [L*B, 1, n, d]."""
        Lc, B, nc, dc = lv.shape
        return (lv.reshape(Lc * B, 1, nc, dc),
                k2._normalized_k(lv).to(lv.dtype).reshape(Lc * B, 1, nc, dc),
                lv.reshape(Lc * B, 1, nc, dc))

    def prepass_host(run, main="consensus_update_kernel"):
        """The host's time a K2 or K4 forward call (checks, scratch, tensor
        maps, two launches) in us, the device time of its k pre-pass and of
        its two kernels together (`main` names the attention kernel;
        torch.profiler, over ten calls; a profile that saw none of the call's
        kernels is taken again, twice at most), and the pre-pass's share."""
        for _ in range(3):
            us = device_us_by_kernel(run, calls=10, key=lambda name: (
                "khat" if "khat" in name else "main" if main in name else "other"))
            if us.get("main"):
                break
        else:
            raise AssertionError(f"three profiles of a {main} call saw no {main}")
        khat, all_us = us.get("khat", 0.0), us.get("khat", 0.0) + us.get("main", 0.0)
        return dict(host_us_per_call=host_us(run), prepass_ms=khat / 1e3,
                    prepass_share=khat / all_us if all_us else None, kernels_ms=all_us / 1e3)

    # K2 at buckets 1 and 8, and one long row (the TPU's streamed kernel's
    # regime).
    for label, (Lc, B, nc), sd in (("k2_b1", (L, 1, n), side), ("k2_b8", (L, 8, n), side),
                                   ("k2_long_row", (2, 1, 4096), 64)):
        lv = randn(Lc, B, nc, d, dtype=bf16)
        bu = randn(Lc, B, nc, d, dtype=bf16)
        td = randn(Lc - 1, B, nc, d, dtype=bf16)
        ms = time_ms(lambda: k2.fused_consensus_update(lv, bu, td, side=sd))
        plain_ms = time_ms(lambda: k2.consensus_update_plain(lv, bu, td, side=sd))
        q_s, k_s, v_s = k2_qkv(lv)
        record_timing(label, [Lc, B, nc, d], ms, plain_ms, 4 * Lc * B * nc * nc * d,
                      2 * (4 * Lc - 1) * B * nc * d,
                      library_ms=time_ms(lambda: sdpa(q_s, k_s, v_s)), library_call=k2_lib_call,
                      **prepass_host(lambda: k2.fused_consensus_update(lv, bu, td, side=sd)))
    # K4 at the largest ragged signature, bf16, as the ragged route runs it
    # (the "wgmma" instance): 32 full-resolution rows' pages (every slot of
    # every band valid) and the k4_vs_plain row mix. Its work depends on the
    # row lengths: each query row of a page scores and averages min(len,
    # window) slots (all `window` on an unused page), 2 x 2 x d operations
    # a slot and level, at the bf16 tensor rate; bytes: levels read once and
    # written once.
    def k4_ops(counts):
        slots = [min(c, window) for c in counts for _ in range(-(-c // pt))]
        return 4 * L * d * pt * (sum(slots) + (P_sig - len(slots)) * window)

    lib_call = ("torch.nn.functional.scaled_dot_product_attention on the band gathered "
                "beforehand (q [P, L, pt, d], normalised k and v [P, L, window, d], bf16, "
                "an additive length mask): the attention alone, attend_self=True; "
                "library_f32_ms: the same call in f32, the yardstick of the \"fma\" "
                "instance")
    for label, counts in (("k4_ragged32_full", [256] * 8), ("k4_ragged32_mixed", k4_counts)):
        maps, _, used = ragged_maps(counts, P_sig, pt, dev)
        lv = randn(P_sig * pt, L, d, dtype=bf16, scale=2.0)
        kw = dict(maps, window=window, page_tokens=pt, attend_self=False)
        # 100 calls: the host's ~35 us a call is near the device's ~46 us, so
        # one pause of the host inside 20 calls would show in their mean.
        ms = time_ms(lambda: k4.banded_ragged_consensus(lv, **kw), reps=100)
        plain_ms = time_ms(lambda: k4.banded_ragged_consensus_plain(lv, **kw))
        # The library's one call for the same function (attend_self=True:
        # an additive mask cannot replace the self score), on the same
        # levels gathered into bands by the plain version's indexing first.
        band0, len_page = k4.page_maps(maps["row_start"], maps["row_len"], pt)
        pages = (band0[:, None].long() + torch.arange(window // pt, device=dev)).clamp(
            max=P_sig - 1)
        kv = lv.float().view(P_sig, pt, L, d)
        khat = kv / torch.linalg.vector_norm(kv, dim=-1, keepdim=True).clamp_min(1e-12)
        q_b = kv.permute(0, 2, 1, 3)  # [P, L, pt, d]
        k_b = khat[pages].reshape(P_sig, window, L, d).permute(0, 2, 1, 3).contiguous()
        v_b = kv[pages].reshape(P_sig, window, L, d).permute(0, 2, 1, 3).contiguous()
        past = torch.arange(window, device=dev)[None, :] >= len_page[:, None]
        mask = torch.zeros(P_sig, 1, 1, window, device=dev).masked_fill(
            past[:, None, None, :], float(torch.finfo(f32).min))

        q_h, k_h, v_h = (t.to(bf16) for t in (q_b, k_b, v_b))
        mask_h = mask.clamp_min(torch.finfo(bf16).min).to(bf16)  # finite in bf16

        def library():
            return torch.nn.functional.scaled_dot_product_attention(q_h, k_h, v_h,
                                                                    attn_mask=mask_h)
        lib_ms = time_ms(library)
        lib_f32_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q_b, k_b, v_b, attn_mask=mask))
        # Over the used pages (an unused page is outside the library call's
        # function).
        self_kw = dict(kw, attend_self=True)
        lib_gap = float((library().float().permute(0, 2, 1, 3).reshape(P_sig * pt, L, d)[:used]
                         - k4.banded_ragged_consensus(lv, **self_kw)[:used].float()).abs().max())
        full_ops = 4 * L * d * P_sig * pt * window
        instance = k4.k4_instance(bf16, pt)
        peak = PEAK_BF16 if instance == "wgmma" else PEAK_F32
        record_timing(label, [P_sig * pt, L, d], ms, plain_ms, k4_ops(counts),
                      2 * 2 * P_sig * pt * L * d, library_ms=lib_ms, peak=peak,
                      rows=counts, instance=instance,
                      bound_full_band_ms=bound(full_ops, 0, peak)[0],
                      library_call=lib_call, library_max_abs_diff=lib_gap,
                      library_f32_ms=lib_f32_ms,
                      **prepass_host(lambda: k4.banded_ragged_consensus(lv, **kw),
                                     "banded_consensus_kernel"))
    # The backward kernels at bucket 8, bf16, as the training step runs them:
    # K1 from the saved pre (4 products), K2 at global consensus (all pairs).
    for label, which, G in (("k1_bwd_b8", "bottom_up", L), ("k1_bwd_add_b8", "top_down", L - 1)):
        params = type(ffw[which])(*(t.to(dev, bf16) for t in ffw[which]))
        x, g = randn(G, M8, d, dtype=bf16), randn(G, M8, d, dtype=bf16)
        add = pos.to(dev, bf16) if which == "top_down" else None
        pre = k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1]

        def k1_bwd():
            return k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre)
        ms = time_ms(k1_bwd)
        plain_ms = time_ms(lambda: k1.grouped_mlp_bwd_plain(params, x, g, add, pre))
        # read x, pre, g, w1, w2 (+ a); write dx, dw1, db1, dw2, db2 (+ da)
        nbytes = 2 * (3 * G * M8 * d + G * M8 * f + 4 * G * d * f + G * (f + d)
                      + (2 * n * d if add is not None else 0))
        record_timing(label, [G, M8, d], ms, plain_ms, 8 * G * M8 * d * f, nbytes,
                      library_seq_ms=k1_seq_bwd_ms(params, with_add(x, add), g),
                      library_seq_call=k1_seq_bwd_call, **k1_bwd_profile(k1_bwd))
    # K2's backward launches by kernel (torch.profiler): the pre-pass (k and
    # the rounded dcons), the dq pass, the key side's k pre-pass, dv and dk
    # passes ("wgmma"), with the host's time a call; products a pair as the
    # bound counts them (the TPU kernels'), as the design computes them, and
    # as the tensor cores execute them (each warpgroup of a block recomputes
    # its whole S and dP).
    def bwd_kernel_key(name):
        """A backward kernel's function name (its instance: `_sm90` for
        "wgmma", `_kernel` for "fma"), without its template arguments."""
        for part in ("consensus_bwd_", "khat_kernel"):
            if part in name:
                return name[name.index(part):].split("(")[0].split("<")[0]
        return "other"

    def bwd_kernels(run, levels, calls=10):
        for _ in range(3):
            us = device_us_by_kernel(run, calls=calls, key=bwd_kernel_key)
            if sum(us.values()):
                break
        else:
            raise AssertionError("three profiles of a K2 backward call saw no kernel")
        total = sum(us.values())
        pre = us.get("consensus_bwd_prepass", 0.0) + us.get("khat_kernel", 0.0)
        return dict(kernels_ms={k: v / 1e3 for k, v in us.items()}, prepass_ms=pre / 1e3,
                    prepass_share=pre / total, host_us_per_call=host_us(run),
                    instance=k2.k2_bwd_instance(levels.dtype, *levels.shape[-2:]))

    def library_kernels(run):
        """The kernels one PyTorch call ran (its backend), largest first."""
        return list(device_us_by_kernel(run, calls=2))[:4]

    lv = consensus_inputs((L, 8, n, d), bf16)[0]
    g = randn(L, 8, n, d, dtype=bf16)
    _, m, l = k2.fused_consensus_update(lv, g, g[1:], side=side, stats=True)
    dq, dd, dcons = k2.consensus_bwd_dq(lv, g, m, l, side=side)
    elems = L * 8 * n * d
    # The TPU kernels' own traffic (the port's rounded dcons, handed from
    # the dq pass to the dkv pass, is not counted): dq pass: read levels, g,
    # m, l; write f32 dq, dd. dkv pass: read levels, g, m, l, dq, dd; write
    # dlevels, dmean.
    dq_bytes = 2 * 2 * elems + 4 * elems + 4 * 3 * L * 8 * n
    dkv_bytes = 2 * 2 * elems + 4 * elems + 2 * 2 * elems + 4 * 3 * L * 8 * n
    # SDPA's backward at the same shape, the whole attention backward.
    q_b, k_b, v_b = (t.clone().requires_grad_() for t in k2_qkv(lv))
    att_b = sdpa(q_b, k_b, v_b)
    g_b = g.reshape(L * 8, 1, n, d)
    def k2_bwd_lib():
        return torch.autograd.grad(att_b, (q_b, k_b, v_b), grad_outputs=g_b, retain_graph=True)
    k2_bwd_lib_ms = time_ms(k2_bwd_lib)
    k2_bwd_lib_kernels = library_kernels(k2_bwd_lib)
    del att_b
    for label, run, plain, products, nbytes in (
        # Products: s, dP, ds.k (the design: s and dP twice, then dq)
        ("k2_bwd_dq_b8", lambda: k2.consensus_bwd_dq(lv, g, m, l, side=side),
         lambda: k2.consensus_bwd_dq_plain(lv, g, m, l, side=side),
         dict(bound=3, design=5, executed=9), dq_bytes),
        # Products: s, dP, dv, dk (the design: s, dv; s, dP, dk)
        ("k2_bwd_dkv_b8",
         lambda: k2.consensus_bwd_dkv(lv, g, m, l, dq, dd, dcons, side=side),
         lambda: k2.consensus_bwd_dkv_plain(lv, g, m, l, dq, dd, side=side),
         dict(bound=4, design=5, executed=8), dkv_bytes),
    ):
        record_timing(label, [L, 8, n, d], time_ms(run), time_ms(plain),
                      products["bound"] * 2 * L * 8 * n * n * d, nbytes,
                      library_ms=k2_bwd_lib_ms, library_call=k2_lib_bwd_call,
                      library_kernels=k2_bwd_lib_kernels, products=products,
                      **bwd_kernels(run, lv))
    # The whole K2 backward against its least work: the single-tile form's
    # five products (s, dP, dq, dv, dk) and its bytes (read levels, g, m, l;
    # write dlevels, dmean).
    k2_bwd_ops, k2_bwd_bytes = 5 * 2 * L * 8 * n * n * d, 2 * 4 * elems + 4 * 2 * L * 8 * n
    # The pair as the per-iteration step calls it (`consensus_update_bwd`:
    # both passes on one k pre-pass), beside its two passes called alone.
    k2_pair_products = dict(bound=5, design=10, executed=17)
    b_ms, b_by = bound(k2_bwd_ops, k2_bwd_bytes, PEAK_BF16)
    def k2_pair():
        return k2.consensus_update_bwd(lv, g, m, l, side=side)
    emit("timing", kernel="k2_bwd_b8", shape=[L, 8, n, d], dtype="bfloat16",
         ms=time_ms(k2_pair),
         plain_ms=time_ms(lambda: k2.consensus_update_bwd_plain(lv, g, m, l, side=side)),
         passes_alone_ms=timings["k2_bwd_dq_b8"]["ms"] + timings["k2_bwd_dkv_b8"]["ms"],
         bound_ms=b_ms, bound_by=b_by, library_ms=k2_bwd_lib_ms, library_call=k2_lib_bwd_call,
         library_kernels=k2_bwd_lib_kernels, products=k2_pair_products,
         **bwd_kernels(k2_pair, lv))
    # The whole-loop VJP's kernels at batch 8, bf16, as its step runs them.
    for label, which, G in (("k1_pre_b8", "bottom_up", L), ("k1_pre_add_b8", "top_down", L - 1)):
        params = type(ffw[which])(*(t.to(dev, bf16) for t in ffw[which]))
        x = randn(G, M8, d, dtype=bf16)
        add = pos.to(dev, bf16) if which == "top_down" else None
        ms = time_ms(lambda: k1.grouped_mlp_pre(params, x, add=add))
        plain_ms = time_ms(lambda: k1.grouped_mlp_pre_plain(params, x, add))
        # The library's one call for the same function: cuBLAS's bf16 batched
        # GEMM with the bias (f32 sums, rounded once), after the addend's add.
        b1 = params.b1[:, None, :]
        if add is None:
            def library():
                return torch.baddbmm(b1, x, params.w1)
        else:
            def library():
                return torch.baddbmm(b1, (x.view(G, -1, n, d) + add).view(G, M8, d), params.w1)
        lib_ms = time_ms(library)
        lib_gap = float((library().float() - k1.grouped_mlp_pre(params, x, add=add).float())
                        .abs().max())
        # read x, w1, b1 (+ a); write pre. One product.
        nbytes = 2 * (G * M8 * d + G * d * f + G * f + G * M8 * f
                      + (n * d if add is not None else 0))
        record_timing(label, [G, M8, d], ms, plain_ms, 2 * G * M8 * d * f, nbytes,
                      library_ms=lib_ms, library_call="torch.baddbmm" + (
                          "" if add is None else " after x + tile(add)"),
                      library_max_abs_diff=lib_gap)
    for label, which, G in (("k1_bwd_acc_b8", "bottom_up", L),
                            ("k1_bwd_acc_add_b8", "top_down", L - 1)):
        params = type(ffw[which])(*(t.to(dev, bf16) for t in ffw[which]))
        x, g1 = randn(G, M8, d, dtype=bf16), randn(G, M8, d, dtype=bf16)
        add = pos.to(dev, bf16) if which == "top_down" else None
        pre = k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1]
        acc = GroupedFFWParams(*(torch.zeros(t.shape, device=dev) for t in params))
        da_in = torch.zeros(n, d, device=dev) if add is not None else None

        def k1_bwd_acc():
            return k1.grouped_mlp_bwd(params, x, g1, add=add, pre=pre, acc=acc, da_in=da_in)
        ms = time_ms(k1_bwd_acc)
        plain_ms = time_ms(lambda: k1.grouped_mlp_bwd_plain(params, x, g1, add, pre, acc, da_in))
        # read x, pre, g, w1, w2 (+ a); write dx; read and write the f32 totals
        # of dw1, db1, dw2, db2 (+ da). Four products.
        extra = n * d if add is not None else 0
        nbytes = (2 * (3 * G * M8 * d + G * M8 * f + 2 * G * d * f + extra)
                  + 4 * 2 * (2 * G * d * f + G * (f + d) + extra))
        record_timing(label, [G, M8, d], ms, plain_ms, 8 * G * M8 * d * f, nbytes,
                      library_seq_ms=k1_seq_bwd_ms(params, with_add(x, add), g1),
                      library_seq_call=k1_seq_bwd_call, **k1_bwd_profile(k1_bwd_acc))
    dx_bu, dx_td = randn(L, 8, n, d, dtype=bf16), randn(L - 1, 8, n, d, dtype=bf16)
    comb = dict(side=side, dx_bu=dx_bu, dx_td=dx_td)
    dq, dd, dcons = k2.consensus_bwd_dq(lv, g, m, l, combine=True, **comb)
    passes = {}
    for label, run, plain in (
        ("dq", lambda: k2.consensus_bwd_dq(lv, g, m, l, combine=True, **comb),
         lambda: k2.consensus_bwd_dq_plain(lv, g, m, l, **comb)),
        ("dkv", lambda: k2.consensus_bwd_dkv(lv, g, m, l, dq, dd, dcons, combine=True, **comb),
         lambda: k2.consensus_bwd_dkv_plain(lv, g, m, l, dq, dd, **comb)),
    ):
        passes[label] = dict(ms=time_ms(run), plain_ms=time_ms(plain))
        emit("timing", kernel=f"k2_bwd_combine_{label}_b8", shape=[L, 8, n, d],
             dtype="bfloat16", **passes[label])
    # The pair replaces one TPU kernel (fused_loop.py:826): its bound is that
    # function's least work, the whole K2 backward's plus the two streams it
    # reads (bottom-up slots 1..L-1, top-down 0..L-2). Timed as the loop
    # calls it (`consensus_update_bwd`: one k pre-pass for both passes);
    # `passes` are the two called alone.
    def k2_combine():
        return k2.consensus_update_bwd(lv, g, m, l, combine=True, **comb)
    record_timing("k2_bwd_combine_b8", [L, 8, n, d], time_ms(k2_combine),
                  time_ms(lambda: k2.consensus_update_bwd_plain(lv, g, m, l, **comb)),
                  k2_bwd_ops, k2_bwd_bytes + 2 * 2 * (L - 1) * 8 * n * d, passes=passes,
                  library_ms=k2_bwd_lib_ms, library_call=k2_lib_bwd_call,
                  library_kernels=k2_bwd_lib_kernels, products=k2_pair_products,
                  **bwd_kernels(k2_combine, lv))
    # The combined K1 grid at batch 8 (11 groups), each launch beside the
    # split pair it replaces. Bytes: the [L+1]-slot carry read once, the
    # weights, the addend; written out and pre (forward), pre (pre-only), dx
    # and the f32 totals read and written (backward).
    Gc = 2 * L - 1
    bu_p = GroupedFFWParams(*(t.to(dev, bf16) for t in ffw["bottom_up"]))
    td_p = GroupedFFWParams(*(t.to(dev, bf16) for t in ffw["top_down"]))
    wcat = k1.cat_params(td_p, bu_p)
    carry = randn(L + 1, M8, d, dtype=bf16)
    add = pos.to(dev, bf16)
    carry_bytes, w_bytes = 2 * (L + 1) * M8 * d, 2 * (2 * Gc * d * f + Gc * (f + d))
    pre_cat = k1.fused_grouped_ffw_lm(wcat, carry, add=add, save_pre=True, cat=True)[1]
    pre_td, pre_bu = pre_cat[:L - 1], pre_cat[L - 1:]
    dmean = randn(L, M8, d, dtype=bf16)
    acc = GroupedFFWParams(*(torch.zeros(t.shape, device=dev) for t in wcat))
    acc_td = GroupedFFWParams(*(torch.zeros(t.shape, device=dev) for t in td_p))
    acc_bu = GroupedFFWParams(*(torch.zeros(t.shape, device=dev) for t in bu_p))
    da_cat, da_split = torch.zeros(n, d, device=dev), torch.zeros(n, d, device=dev)

    # The library's one call for the pre-only grid's function: one cuBLAS
    # bf16 batched GEMM with the bias over the 11 groups' inputs (the
    # top-down slots after the addend's add, then the bottom-up slots).
    def pre_cat_library():
        x_cat = torch.cat([(carry[2:].view(L - 1, -1, n, d) + add).view(L - 1, M8, d),
                           carry[:L]])
        return torch.baddbmm(wcat.b1[:, None], x_cat, wcat.w1)

    def fwd_cat_library_seq():
        x_cat = torch.cat([(carry[2:].view(L - 1, -1, n, d) + add).view(L - 1, M8, d),
                           carry[:L]])
        return k1_library_seq(wcat, x_cat)

    for label, run, split_pair, plain, library, ops, nbytes in (
        ("k1_fwd_cat_b8",
         lambda: k1.fused_grouped_ffw_lm(wcat, carry, add=add, save_pre=True, cat=True),
         lambda: (k1.fused_grouped_ffw_lm(td_p, carry[2:], add=add, save_pre=True),
                  k1.fused_grouped_ffw_lm(bu_p, carry[:L], save_pre=True)),
         lambda: k1.grouped_mlp_plain(wcat, carry, add, save_pre=True, cat=True), None,
         4 * Gc * M8 * d * f, carry_bytes + w_bytes + 2 * n * d + 2 * Gc * M8 * (d + f)),
        ("k1_pre_cat_b8", lambda: k1.grouped_mlp_pre(wcat, carry, add=add, cat=True),
         lambda: (k1.grouped_mlp_pre(td_p, carry[2:], add=add),
                  k1.grouped_mlp_pre(bu_p, carry[:L])),
         lambda: k1.grouped_mlp_pre_plain(wcat, carry, add, cat=True), pre_cat_library,
         2 * Gc * M8 * d * f, carry_bytes + 2 * (Gc * d * f + Gc * f + n * d + Gc * M8 * f)),
        ("k1_bwd_acc_cat_b8",
         lambda: k1.grouped_mlp_bwd(wcat, carry, dmean, add=add, pre=pre_cat, acc=acc,
                                    da_in=da_cat, cat=True),
         lambda: (k1.grouped_mlp_bwd(td_p, carry[2:], dmean[:L - 1], add=add, pre=pre_td,
                                     acc=acc_td, da_in=da_split),
                  k1.grouped_mlp_bwd(bu_p, carry[:L], dmean, pre=pre_bu, acc=acc_bu)),
         lambda: k1.grouped_mlp_bwd_plain(wcat, carry, dmean, add, pre_cat, acc, da_cat,
                                          cat=True), None,
         8 * Gc * M8 * d * f,
         carry_bytes + 2 * (Gc * M8 * f + L * M8 * d + 2 * Gc * d * f + n * d + Gc * M8 * d)
         + 4 * 2 * (2 * Gc * d * f + Gc * (f + d) + n * d)),
    ):
        lib = {}
        if library is not None:
            lib = dict(library_ms=time_ms(library),
                       library_call="torch.baddbmm over the 11 groups after x + tile(add)",
                       library_max_abs_diff=float((library().float() - run().float())
                                                  .abs().max()))
        if label == "k1_fwd_cat_b8":
            lib = dict(library_seq_ms=time_ms(fwd_cat_library_seq),
                       library_seq_call=k1_seq_call + ", over the 11 groups' concatenated input")
        if label == "k1_bwd_acc_cat_b8":
            x_cat = torch.cat([with_add(carry[2:], add), carry[:L]])
            lib = dict(library_seq_ms=k1_seq_bwd_ms(wcat, x_cat,
                                                    torch.cat([dmean[:L - 1], dmean])),
                       library_seq_call=k1_seq_bwd_call + ", over the 11 groups",
                       **k1_bwd_profile(run))
        record_timing(label, [Gc, M8, d], time_ms(run), time_ms(plain), ops, nbytes,
                      split_pair_ms=time_ms(split_pair), **lib)
    # The long-row route's K2 launches at [6, 2, 4096, 512] (fewer
    # repetitions: each takes tens of ms). Forward bytes: levels, bu, td read;
    # out, m, l (and cons) written.
    lv_r = consensus_inputs(long_shape, bf16)[0]
    bu_r, td_r = randn(*long_shape, dtype=bf16), randn(Lr - 1, Br, nr, d, dtype=bf16)
    elems_r, rows_r = Lr * Br * nr * d, Lr * Br * nr
    fwd_ops_r = 4 * Lr * Br * nr * nr * d
    fwd_bytes_r = 2 * (3 * elems_r + (Lr - 1) * Br * nr * d) + 4 * 2 * rows_r
    q_r, k_r, v_r = k2_qkv(lv_r)
    fwd_lib_ms_r = time_ms(lambda: sdpa(q_r, k_r, v_r), reps=5)
    for label, cons_out, nbytes in (("k2_fwd_longrow", False, fwd_bytes_r),
                                    ("k2_fwd_cons_longrow", True, fwd_bytes_r + 2 * elems_r)):
        kw = dict(side=sr, stats=True, cons=cons_out)
        record_timing(label, list(long_shape),
                      time_ms(lambda: k2.fused_consensus_update(lv_r, bu_r, td_r, **kw), reps=5),
                      time_ms(lambda: k2.consensus_update_plain(lv_r, bu_r, td_r, **kw), reps=3),
                      fwd_ops_r, nbytes, library_ms=fwd_lib_ms_r, library_call=k2_lib_call,
                      **prepass_host(lambda: k2.fused_consensus_update(lv_r, bu_r, td_r, **kw)))
    _, m_r, l_r, cons_r = k2.fused_consensus_update(lv_r, bu_r, td_r, side=sr, cons=True)
    g_r = randn(*long_shape, dtype=bf16)
    # The library's one call for the attention backward alone: SDPA's
    # backward from the normalised k, attend_self=True, bf16 (the mean, the
    # divisor and the norm VJP left out), timed with retain_graph.
    q_l = lv_r.view(Lr * Br, 1, nr, d).clone().requires_grad_()
    k_l = k2._normalized_k(lv_r).to(bf16).view(Lr * Br, 1, nr, d).requires_grad_()
    v_l = lv_r.view(Lr * Br, 1, nr, d).clone().requires_grad_()
    att_l = torch.nn.functional.scaled_dot_product_attention(q_l, k_l, v_l)
    g_l = g_r.view(Lr * Br, 1, nr, d)

    def onesweep_lib():
        return torch.autograd.grad(att_l, (q_l, k_l, v_l), grad_outputs=g_l, retain_graph=True)
    lib_ms = time_ms(onesweep_lib, reps=5)
    lib_kernels = library_kernels(onesweep_lib)
    del att_l
    twopass_ms = time_ms(lambda: k2.consensus_update_bwd(lv_r, g_r, m_r, l_r, side=sr), reps=5)
    # Bound: the TPU kernel's five products (s, dP, dq, dv, dk); bytes:
    # levels, g, cons, m, l read, dlevels written.
    def onesweep():
        return k2.consensus_bwd_onesweep(lv_r, g_r, m_r, l_r, cons_r, side=sr)
    record_timing(
        "k2_bwd_onesweep_longrow", list(long_shape), time_ms(onesweep, reps=5),
        time_ms(lambda: k2.consensus_bwd_onesweep_plain(lv_r, g_r, m_r, l_r, cons_r, side=sr),
                reps=3),
        5 * 2 * Lr * Br * nr * nr * d, 2 * 4 * elems_r + 4 * 2 * rows_r, library_ms=lib_ms,
        library_call=("torch.nn.functional.scaled_dot_product_attention backward (q = levels, "
                      "normalised k, v = levels, bf16, attend_self=True), retain_graph"),
        library_kernels=lib_kernels, products=dict(bound=5, design=8, executed=13),
        two_pass_ms=twopass_ms, **bwd_kernels(onesweep, lv_r, calls=2))

    # -- serve: the main path ----------------------------------------------------
    cfg = GlomConfig()  # flagship: dim 512, L 6, 224 px, patch 14
    T = cfg.default_iters
    params = init_glom(cfg, generator=torch.Generator().manual_seed(SEED))
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    if tuple(out.shape) != (4, 256, 6, 512) or not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"entry(): shape {tuple(out.shape)} or non-finite values")
    emit("entry", shape=list(out.shape), dtype=str(out.dtype))

    scfg = ServeConfig(buckets=(1, 2, 4, 8), compute_dtype="bfloat16", use_pallas=True)
    engine = InferenceEngine(cfg, scfg, params=params, device="cuda")
    warm = engine.warmup()
    emit("warmup", seconds={str(b): s for b, s in warm.items()})

    requests = [1, 2, 3, 4, 5, 8, 1, 2, 4, 7, 8, 1, 2, 4, 8]
    k1.LAUNCHES = k1.LAUNCHES_ADD = k2.LAUNCHES = 0
    lat: dict = {}
    n_served = 0
    for n_req in requests:
        b = engine.pick_bucket(n_req)
        imgs = torch.randn(b, 3, 224, 224, generator=gen)
        imgs[n_req:] = 0.0
        before = (k1.LAUNCHES, k1.LAUNCHES_ADD, k2.LAUNCHES)
        res = engine.infer(imgs, n_valid=n_req)
        got = (k1.LAUNCHES - before[0], k1.LAUNCHES_ADD - before[1], k2.LAUNCHES - before[2])
        if got != (2 * T, T, T):
            raise AssertionError(f"bucket {b}: launches (K1, K1 add, K2) {got} != {(2 * T, T, T)}")
        lv_out = res.levels[:n_req].float()
        if tuple(res.levels.shape) != (b, 256, 6, 512) or not bool(torch.isfinite(lv_out).all()):
            raise AssertionError(f"bucket {b}: bad result shape or non-finite values")
        lat.setdefault(b, []).append(res.latency_s)
        n_served += n_req
    launches = {"grouped_mlp_fwd": k1.LAUNCHES - k1.LAUNCHES_ADD,
                "grouped_mlp_fwd_add": k1.LAUNCHES_ADD,
                "consensus_update_fwd": k2.LAUNCHES}
    if set(lat) != set(scfg.buckets) or min(launches.values()) == 0:
        raise AssertionError(f"buckets served {sorted(lat)}, launches {launches}")
    for b in sorted(lat):
        xs = sorted(lat[b])
        p50 = xs[len(xs) // 2]
        emit("serve", bucket=b, dispatches=len(xs), p50_ms=1e3 * p50, min_ms=1e3 * xs[0],
             column_iters_per_s=b * T / p50, launches_per_dispatch={"K1": 2 * T, "K2": T})
    emit("serve_total", requests=n_served, dispatches=len(requests), launches=launches)

    # Where one bucket-8 dispatch spends its device time (torch.profiler).
    def device_ms_by_kernel(prof):
        """Device time of each kernel name in a profile, largest first (ms)."""
        us: dict = {}
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                key = evt.name if len(evt.name) < 60 else evt.name[:57] + "..."
                us[key] = us.get(key, 0.0) + evt.time_range.elapsed_us()
        return {key: v / 1e3 for key, v in sorted(us.items(), key=lambda kv: -kv[1])}

    imgs8 = torch.randn(8, 3, 224, 224, generator=gen)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = 1e3 * engine.infer(imgs8).latency_s
    kernel_ms = device_ms_by_kernel(prof)
    busy_ms = sum(kernel_ms.values())
    emit("serve_profile", bucket=8, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms if busy_ms else None,
         p50_unprofiled_ms=1e3 * sorted(lat[8])[len(lat[8]) // 2], kernel_ms=kernel_ms)

    # f32 end-to-end parity on the card: fused kernels vs the plain path.
    img2 = torch.randn(2, 3, 224, 224, generator=gen)
    f32_engine = InferenceEngine(
        cfg, ServeConfig(buckets=(2,), max_batch=2, compute_dtype="float32", use_pallas=True),
        params=params, device="cuda",
    )
    fused32 = f32_engine.infer(img2).levels.float()
    with torch.inference_mode():
        plain32 = glom_forward(map_params(lambda t: t.to(dev), params), img2.to(dev),
                               cfg, use_pallas=False)
    ok, abs_err, rel_err, _ = compare(fused32, plain32, 2e-3, 2e-4)
    # The bf16 served answer (the main path) against the same f32 answer.
    bf16_ok, bf16_err, _, _ = compare(engine.infer(img2).levels, plain32, 0.0, BF16_SERVE_ATOL)
    emit("serve_parity_f32", bucket=2, max_abs_err=abs_err, max_rel_err=rel_err,
         rtol=2e-3, atol=2e-4, ok=ok, bf16_vs_f32_max_abs_err=bf16_err,
         bf16_atol=BF16_SERVE_ATOL, bf16_ok=bf16_ok)
    if not ok:
        raise AssertionError("f32 fused serve path disagrees with the plain path")
    if not bf16_ok:
        raise AssertionError("bf16 served levels are too far from the plain f32 path")

    # -- serve: the ragged route, K1 and K4 ------------------------------------------
    import dataclasses

    from glom_tpu_torch.serve import pack_ragged
    from glom_tpu_torch.serve.early_exit import _build_update_step

    px = {256: 224, 144: 168, 64: 112, 16: 56}  # patches -> image side (patch 14)

    def ragged_batch(counts, pages):
        imgs = [torch.randn(3, px[c], px[c], generator=gen).numpy() for c in counts]
        return pack_ragged(imgs, cfg.patch_size, pt, pages)

    def p50(xs):
        return statistics.median(xs)

    def ragged_counts():
        return (k1.LAUNCHES, k4.LAUNCHES, k2.LAUNCHES)

    rcfg = ServeConfig(ragged=True, ragged_attention="banded-pallas", use_pallas=True,
                       compute_dtype="bfloat16", max_batch=8)
    ragged = InferenceEngine(cfg, rcfg, params=params, device="cuda")
    if ragged.page_tokens != pt:
        raise AssertionError(f"flagship page_tokens {ragged.page_tokens} != {pt}")
    warm_r = ragged.warmup_ragged()
    emit("warmup_ragged", ladder=list(ragged.ragged_page_buckets),
         seconds={str(p): t for p, t in warm_r.items()})
    # 224/168/112/56-px rows (256/144/64/16 patches, 4/3/1/1 pages) at three
    # ladder entries; 32 pages of full-resolution rows hold bucket 8's tokens.
    mixes = {8: [256, 144, 64], 24: [256, 256, 256, 256, 144, 144, 16, 16], 32: [256] * 8}
    batches = {p: [ragged_batch(m, p) for _ in range(RAGGED_DISPATCHES)] for p, m in mixes.items()}
    want_ragged = (2 * T, T, 0)  # K1, K4, K2 per fixed dispatch
    k1.LAUNCHES = k1.LAUNCHES_ADD = k2.LAUNCHES = k4.LAUNCHES = 0
    ragged_lat = {p: [] for p in mixes}
    for i in range(RAGGED_DISPATCHES):
        for p in mixes:
            flat, n_p = batches[p][i]
            before = ragged_counts()
            res = ragged.infer_ragged(flat, n_p)
            got = tuple(a - b for a, b in zip(ragged_counts(), before))
            if got != want_ragged:
                raise AssertionError(f"ragged {p} pages: launches (K1, K4, K2) {got} != "
                                     f"{want_ragged}")
            used = sum(-(-c // pt) for c in mixes[p]) * pt
            if (tuple(res.levels.shape) != (p * pt, L, d) or res.pages != p
                    or not bool(torch.isfinite(res.levels[:used].float()).all())):
                raise AssertionError(f"ragged {p} pages: bad result shape or values")
            ragged_lat[p].append(res.latency_s)
    ragged_launches = {"grouped_mlp_fwd": k1.LAUNCHES, "banded_consensus_fwd": k4.LAUNCHES,
                       "consensus_update_fwd": k2.LAUNCHES}
    for p, xs in ragged_lat.items():
        emit("serve_ragged", pages=p, rows=mixes[p], patches=sum(mixes[p]),
             dispatches=len(xs), p50_ms=1e3 * p50(xs), min_ms=1e3 * min(xs),
             valid_patch_iters_per_s=sum(mixes[p]) * T / p50(xs),
             launches_per_dispatch={"K1": 2 * T, "K4": T, "K2": 0})
    # The same tokens on the two routes, in turns: 8 full-resolution rows as
    # 32 ragged pages, and as a bucket-8 dispatch (K1 + K2).
    turns = {"ragged32_full": [], "bucket8": []}
    flat32, n32 = batches[32][0]
    imgs8 = torch.randn(8, 3, 224, 224, generator=gen)
    for i in range(RAGGED_DISPATCHES):
        for r in (("ragged32_full", "bucket8") if i % 2 == 0 else ("bucket8", "ragged32_full")):
            res = ragged.infer_ragged(flat32, n32) if r == "ragged32_full" else engine.infer(imgs8)
            turns[r].append(res.latency_s)
    emit("serve_ragged_total", dispatches=sum(len(x) for x in ragged_lat.values()),
         launches=ragged_launches, order="bucket 8 and ragged 32 in turns",
         p50_ms={r: 1e3 * p50(x) for r, x in turns.items()},
         ragged_over_bucket=p50(turns["ragged32_full"]) / p50(turns["bucket8"]))

    # Where the device time of the two goes: one profiled dispatch each, the
    # kernels split into the ported kernels and the rest (the plain glue).
    def split_profile(run):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_ms = 1e3 * run().latency_s
        kernel_ms = device_ms_by_kernel(prof)
        ported = {key: v for key, v in kernel_ms.items()
                  if any(k in key for k in ("mlp_fwd_", "consensus_update_kernel",
                                            "banded_consensus_kernel", "khat_kernel"))}
        glue = {key: v for key, v in kernel_ms.items() if key not in ported}
        busy = sum(kernel_ms.values())
        return dict(wall_ms=wall_ms, device_busy_ms=busy, device_idle_share=1 - busy / wall_ms,
                    ported_kernels_ms=ported, glue_ms=sum(glue.values()),
                    glue_top_ms=dict(list(glue.items())[:8]))
    emit("serve_ragged_profile",
         ragged32_full=split_profile(lambda: ragged.infer_ragged(flat32, n32)),
         bucket8=split_profile(lambda: engine.infer(imgs8)))

    # f32 parity on the card, every row's page span: the K4 route against
    # the port's plain "banded" route, and one full-resolution ragged row
    # against the bucket route's answer for the same image alone.
    r32 = {mode: InferenceEngine(cfg, dataclasses.replace(rcfg, compute_dtype="float32",
                                                          ragged_attention=mode),
                                 params=params, device="cuda")
           for mode in ("banded-pallas", "banded")}
    mix32 = [256, 144, 64, 16]
    flat, n_p = ragged_batch(mix32, r32["banded"].pick_pages(9))
    got, want = (r32[m].infer_ragged(flat, n_p).levels for m in ("banded-pallas", "banded"))
    _, spans, _ = ragged_maps(mix32, len(flat) // pt, pt, dev)
    span_cmp = [compare(got[a:b], want[a:b], 2e-3, 2e-4) for a, b in spans]
    img1 = torch.randn(1, 3, 224, 224, generator=gen)
    flat1, n1 = pack_ragged([img1[0].numpy()], cfg.patch_size, pt, 4)
    row = r32["banded-pallas"].infer_ragged(flat1, n1).levels[:256]
    bucket1 = InferenceEngine(cfg, ServeConfig(buckets=(1,), max_batch=1, compute_dtype="float32",
                                               use_pallas=True), params=params, device="cuda")
    row_cmp = compare(row, bucket1.infer(img1).levels[0], 2e-3, 2e-4)
    ok = all(c[0] for c in span_cmp) and row_cmp[0]
    emit("serve_ragged_parity_f32", rows=mix32, rtol=2e-3, atol=2e-4,
         banded_pallas_vs_banded_max_abs_err=max(c[1] for c in span_cmp),
         banded_pallas_vs_banded_bar_ratio=max(c[3] for c in span_cmp),
         full_row_vs_bucket_max_abs_err=row_cmp[1], full_row_vs_bucket_bar_ratio=row_cmp[3],
         ok=ok)
    if not ok:
        raise AssertionError("f32 ragged route disagrees with the plain banded or bucket route")

    # The ragged auto route: at threshold 0 the fixed route's levels bit for
    # bit; at the default threshold, what exits.
    rauto0 = InferenceEngine(cfg, dataclasses.replace(rcfg, iters="auto", exit_threshold=0.0),
                             params=params, device="cuda")
    flat, n_p = batches[24][0]
    fixed_res, auto_res = ragged.infer_ragged(flat, n_p), rauto0.infer_ragged(flat, n_p)
    bitwise = auto_res.iters_run == T and torch.equal(fixed_res.levels, auto_res.levels)
    rauto = InferenceEngine(cfg, dataclasses.replace(rcfg, iters="auto"), params=params,
                            device="cuda")
    rauto.warmup_ragged(tuple(mixes))
    auto_runs = {p: [] for p in mixes}
    for i in range(RAGGED_DISPATCHES):
        for p in mixes:
            before = ragged_counts()
            res = rauto.infer_ragged(*batches[p][i])
            got = tuple(a - b for a, b in zip(ragged_counts(), before))
            if got != (2 * res.iters_run, res.iters_run, 0):
                raise AssertionError(f"ragged auto {p} pages: launches {got}, {res.iters_run} "
                                     "iterations")
            auto_runs[p].append(res)
    emit("serve_ragged_auto", threshold0_bitwise_equal_fixed=bitwise,
         exit_threshold=rauto.scfg.exit_threshold, budget=rauto.auto_budget,
         by_pages={str(p): dict(p50_ms=1e3 * p50([r.latency_s for r in rs]),
                                iters_run=[r.iters_run for r in rs],
                                row_iters=rs[0].row_iters[:len(mixes[p])].tolist())
                   for p, rs in auto_runs.items()})
    if not bitwise:
        raise AssertionError("ragged auto route at threshold 0 differs from the fixed route")

    # The bucket route with iters="auto": K1 and plain consensus (no K2), one
    # host read of the exit flag per iteration. Every bucket in turns, with
    # and without a pad row, AUTO_DISPATCHES timed dispatches each.
    import contextlib

    import glom_tpu_torch.serve.early_exit as early_exit

    acfg = ServeConfig(buckets=(1, 2, 4, 8), iters="auto", compute_dtype="bfloat16",
                       use_pallas=True)
    auto_eng = InferenceEngine(cfg, acfg, params=params, device="cuda")
    auto_eng.warmup()
    auto_imgs = {b: torch.randn(b, 3, 224, 224, generator=gen) for b in acfg.buckets}
    auto_lat = {b: [] for b in acfg.buckets}
    auto_iters = {b: set() for b in acfg.buckets}
    for i in range(AUTO_WARM + AUTO_DISPATCHES):
        for b in acfg.buckets:
            n_req = max(1, b - i % 2)
            imgs = auto_imgs[b].clone()
            imgs[n_req:] = 0.0
            before = ragged_counts()
            res = auto_eng.infer(imgs, n_valid=n_req)
            got = tuple(now - was for now, was in zip(ragged_counts(), before))
            if got != (2 * res.iters_run, 0, 0) or not bool(torch.isfinite(res.levels.float()).all()):
                raise AssertionError(f"auto bucket {b}: launches {got}, {res.iters_run} iterations")
            if i >= AUTO_WARM:
                auto_lat[b].append(res.latency_s)
                auto_iters[b].add(res.iters_run)

    # The exit test's price at bucket 8, threshold 0 (the flag never rises,
    # so every arm runs all T updates): in turns, the auto route; the same
    # engine with the flag's one host read removed (early_exit's `bool`
    # answers False without reading the device); and the fixed loop of the
    # same step, with no witness and none of the engine's per-dispatch work.
    auto0 = InferenceEngine(cfg, dataclasses.replace(acfg, exit_threshold=0.0), params=params,
                            device="cuda")

    @contextlib.contextmanager
    def no_exit_read():
        early_exit.bool = lambda flag: False
        try:
            yield
        finally:
            del early_exit.bool

    def auto0_no_read(imgs):
        with no_exit_read():
            return auto0.infer(imgs)

    def same_step_fixed(imgs):
        t0 = time.perf_counter()
        with torch.inference_mode():
            img = torch.as_tensor(imgs, dtype=f32, device=dev)
            step, lv = _build_update_step(auto0.params, img, cfg, None, bf16, True)
            for _ in range(T):
                lv = step(lv)
        torch.cuda.synchronize()
        return lv, time.perf_counter() - t0

    arms = {"auto_threshold0": lambda: auto0.infer(imgs8),
            "auto_threshold0_no_read": lambda: auto0_no_read(imgs8),
            "fixed_same_step": lambda: same_step_fixed(imgs8)}
    sync_turns = {r: [] for r in arms}
    for i in range(AUTO_WARM + AUTO_DISPATCHES):
        order = list(arms)[i % 3:] + list(arms)[:i % 3]
        for r in order:
            out = arms[r]()
            if i >= AUTO_WARM:
                sync_turns[r].append(out[1] if r == "fixed_same_step" else out.latency_s)
    want_lv = same_step_fixed(imgs8)[0]
    equal = {r: torch.equal(arms[r]().levels, want_lv)
             for r in ("auto_threshold0", "auto_threshold0_no_read")}

    def paired(a, b):
        """Per-iteration ms of arm a over arm b: the median, min and max of
        the per-round differences over T."""
        diffs = [1e3 * (x - y) / T for x, y in zip(sync_turns[a], sync_turns[b])]
        return dict(median=statistics.median(diffs), min=min(diffs), max=max(diffs))

    # The witness's device time alone, at bucket 8 (CUDA events): the loop's
    # per-row agreement, delta and converged-row updates on one state.
    with torch.inference_mode():
        lv8 = same_step_fixed(imgs8)[0]
        prev8 = early_exit.batch_agreement(lv8)
        conv8 = torch.zeros(8, dtype=torch.bool, device=dev)
        iters8 = torch.full((8,), T, dtype=torch.int32, device=dev)

        def witness():
            agree = early_exit.batch_agreement(lv8)
            newly = early_exit.row_agreement_delta(agree, prev8) < 0.0
            return torch.where(newly & ~conv8, 1, iters8), conv8 | newly
        witness_ms = time_ms(witness)
    emit("serve_auto", exit_threshold=acfg.exit_threshold, budget=auto_eng.auto_budget,
         by_bucket={str(b): dict(dispatches=len(xs), p50_ms=1e3 * p50(xs), min_ms=1e3 * min(xs),
                                 max_ms=1e3 * max(xs), iters_run=sorted(auto_iters[b]))
                    for b, xs in auto_lat.items()},
         launches_per_iteration={"K1": 2, "K2": 0},
         threshold0_bucket8={r: dict(rounds=len(xs), p50_ms=1e3 * p50(xs), min_ms=1e3 * min(xs),
                                     max_ms=1e3 * max(xs)) for r, xs in sync_turns.items()},
         order="the three arms in rotating turns",
         # the one host read of the exit flag, per iteration
         exit_read_ms_per_iteration=paired("auto_threshold0", "auto_threshold0_no_read"),
         # the witness math plus the engine's per-dispatch work, over T
         witness_and_dispatch_ms_per_iteration=paired("auto_threshold0_no_read",
                                                      "fixed_same_step"),
         witness_device_ms_per_iteration=witness_ms,
         threshold0_bitwise_equal_same_step=equal)
    if not all(equal.values()):
        raise AssertionError(f"auto route at threshold 0 differs from the fixed loop of its step: "
                             f"{equal}")

    # -- serve: the device page pool, paged and incremental dispatches ----------------
    # The flagship at bf16, T = 12, with a pool of POOL_PAGES pages (384 KiB
    # each): the warm paged dispatch gathers levels0 from the pool, the
    # host-carry one uploads it. Both run the fixed route's kernels.
    from glom_tpu_torch import Glom
    from glom_tpu_torch.kernels._build import KernelError
    from glom_tpu_torch.resilience import FaultPlan, dispatch_fault
    from glom_tpu_torch.serve import PagedColumnPool
    from glom_tpu_torch.serve.early_exit import glom_forward_auto

    class Records:
        def __init__(self):
            self.recs = []

        def write(self, rec):
            self.recs.append(rec)

    def fixed_counts():
        return (k1.LAUNCHES, k1.LAUNCHES_ADD, k2.LAUNCHES)

    def delta(before, after):
        return tuple(a - b for a, b in zip(after, before))

    side, n_tok = cfg.image_size, cfg.num_patches
    pcfg = ServeConfig(buckets=(1, 2, 4, 8), compute_dtype="bfloat16", use_pallas=True,
                       page_pool_pages=POOL_PAGES)
    paged_eng = InferenceEngine(cfg, pcfg, params=params, device=dev)
    pool = paged_eng.pool
    ppr = paged_eng.pages_per_row
    for warm in (False, "paged", True):
        paged_eng.warmup((8,), warm=warm)
    imgs_p = torch.randn(8, 3, side, side, generator=gen)
    cold = paged_eng.infer(imgs_p)
    for i in range(8):
        if not pool.write_back(f"row{i}", cold.levels[i], cfg.num_patches):
            raise AssertionError(f"pool of {POOL_PAGES} pages refused row {i}")
    page_rows = np.array([pool.lookup(f"row{i}")[0] for i in range(8)], np.int32)
    host_levels = cold.levels.cpu()  # the same columns, carried from the host
    want_fixed = (2 * T, T, T)
    k1.LAUNCHES = k1.LAUNCHES_ADD = k2.LAUNCHES = 0
    paged_turns = {"paged": [], "host_carry": []}
    paged_phases = {"paged": [], "host_carry": []}
    first = {}
    for i in range(PAGED_DISPATCHES):
        for arm in (("paged", "host_carry") if i % 2 == 0 else ("host_carry", "paged")):
            before = fixed_counts()
            res = (paged_eng.infer(imgs_p, page_rows=page_rows) if arm == "paged"
                   else paged_eng.infer(imgs_p, levels0=host_levels))
            got = delta(before, fixed_counts())
            if got != want_fixed:
                raise AssertionError(f"{arm}: launches (K1, K1 add, K2) {got} != {want_fixed}")
            first.setdefault(arm, res)
            paged_turns[arm].append(res.latency_s)
            paged_phases[arm].append(res.phases)
    paged_launches = {"grouped_mlp_fwd": k1.LAUNCHES - k1.LAUNCHES_ADD,
                      "grouped_mlp_fwd_add": k1.LAUNCHES_ADD, "consensus_update_fwd": k2.LAUNCHES}
    paged_bitwise = torch.equal(first["paged"].levels, first["host_carry"].levels)
    h2d = {arm: r.levels0_h2d_bytes for arm, r in first.items()}
    torch.cuda.synchronize()
    base_mib = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    paged_eng.infer(imgs_p, page_rows=page_rows)
    paged_peak = torch.cuda.max_memory_allocated() / 2**20
    emit("serve_paged", bucket=8, pool_pages=POOL_PAGES, pool_mib=pool.pool_bytes / 2**20,
         page_rows_first=page_rows[0].tolist(), bitwise_equal_host_carry=paged_bitwise,
         levels0_h2d_bytes=h2d, launches_per_dispatch={"K1": 2 * T, "K2": T},
         launches=paged_launches, dispatches=PAGED_DISPATCHES, order="in turns",
         p50_ms={a: 1e3 * p50(xs) for a, xs in paged_turns.items()},
         min_ms={a: 1e3 * min(xs) for a, xs in paged_turns.items()},
         h2d_ms_p50={a: p50([p["h2d_ms"] for p in ps]) for a, ps in paged_phases.items()},
         resolve_ms_p50={a: p50([p["resolve_ms"] for p in ps])
                         for a, ps in paged_phases.items()},
         paged_over_host_carry=p50(paged_turns["paged"]) / p50(paged_turns["host_carry"]),
         memory_allocated_mib=base_mib, paged_dispatch_peak_mib=paged_peak)
    if not paged_bitwise:
        raise AssertionError("the paged warm dispatch differs from the host-carried one")
    if h2d != {"paged": 0, "host_carry": 8 * cfg.num_patches * L * d * 2}:
        raise AssertionError(f"levels0 bytes from the host {h2d}")
    if min(paged_launches.values()) == 0:
        raise AssertionError(f"a kernel ran no time on the paged path: {paged_launches}")

    # The f32 paged route against the plain f32 path from the same columns,
    # and the bf16 paged route against it, at serve_parity_f32's bars.
    f32_paged = InferenceEngine(cfg, ServeConfig(buckets=(2,), max_batch=2, use_pallas=True,
                                                 page_pool_pages=2 * ppr),
                                params=params, device=dev)
    img2p = torch.randn(2, 3, side, side, generator=gen)
    rows32 = f32_paged.infer(img2p).levels
    rows16 = rows32.to(bf16)
    bf_rows = np.array([pool.lookup(f"row{i}")[0] for i in range(2)], np.int32)
    for i in range(2):
        f32_paged.pool.write_back(f"row{i}", rows32[i], cfg.num_patches)
        pool.write_back(f"row{i}", rows16[i], cfg.num_patches)
    rows_f32 = np.array([f32_paged.pool.lookup(f"row{i}")[0] for i in range(2)], np.int32)
    got32 = f32_paged.infer(img2p, page_rows=rows_f32).levels
    p_dev = map_params(lambda t: t.to(dev), params)
    with torch.inference_mode():
        plain32 = glom_forward(p_dev, img2p.to(dev), cfg, levels=rows32, use_pallas=False)
        plain16 = glom_forward(p_dev, img2p.to(dev), cfg, levels=rows16.float(), use_pallas=False)
    ok32, err32, rel32, ratio32 = compare(got32, plain32, 2e-3, 2e-4)
    got16 = paged_eng.infer(torch.cat([img2p, torch.zeros(6, 3, side, side)]),
                            page_rows=np.concatenate([bf_rows, page_rows[2:]])).levels[:2]
    ok16, err16, _, _ = compare(got16, plain16, 0.0, BF16_SERVE_ATOL)
    emit("serve_paged_parity_f32", bucket=2, rtol=2e-3, atol=2e-4, max_abs_err=err32,
         max_rel_err=rel32, bar_ratio=ratio32, ok=ok32, bf16_vs_f32_max_abs_err=err16,
         bf16_atol=BF16_SERVE_ATOL, bf16_ok=ok16)
    if not (ok32 and ok16):
        raise AssertionError("the paged route disagrees with the plain f32 path")

    # The ragged route from the pool: 32 pages, rows 0-3 warm from pool
    # pages, rows 4-7 cold (-1), against the levels0 form of the same state.
    rp_eng = InferenceEngine(cfg, dataclasses.replace(rcfg, page_pool_pages=POOL_PAGES),
                             params=params, device=dev)
    rp_eng.warmup_ragged((32,))
    flat32p, n32p = batches[32][1]
    first_r = rp_eng.infer_ragged(flat32p, n32p)
    for i in range(4):
        rp_eng.pool.write_back(f"row{i}", first_r.levels[i * n_tok:(i + 1) * n_tok], n_tok)
    page_idx = np.full(32, -1, np.int32)
    page_idx[:4 * ppr] = np.concatenate([rp_eng.pool.lookup(f"row{i}")[0] for i in range(4)])
    cold_tok = rp_eng.cold_levels()[0]
    lv0_r = torch.stack([cold_tok] * (32 * pt)).to(dev)
    lv0_r[:4 * n_tok] = first_r.levels[:4 * n_tok]
    k1.LAUNCHES = k4.LAUNCHES = k2.LAUNCHES = 0
    rp_turns = {"pool": [], "levels0": []}
    rp_first = {}
    for i in range(PAGED_DISPATCHES):
        for arm in (("pool", "levels0") if i % 2 == 0 else ("levels0", "pool")):
            before = ragged_counts()
            res = (rp_eng.infer_ragged(flat32p, n32p, page_idx=page_idx) if arm == "pool"
                   else rp_eng.infer_ragged(flat32p, n32p, levels0=lv0_r))
            got = delta(before, ragged_counts())
            if got != want_ragged:
                raise AssertionError(f"ragged {arm}: launches (K1, K4, K2) {got} != "
                                     f"{want_ragged}")
            rp_first.setdefault(arm, res)
            rp_turns[arm].append(res.latency_s)
    rp_launches = {"grouped_mlp_fwd": k1.LAUNCHES, "banded_consensus_fwd": k4.LAUNCHES}
    rp_bitwise = torch.equal(rp_first["pool"].levels, rp_first["levels0"].levels)
    emit("serve_ragged_paged", pages=32, warm_pages=4 * ppr, cold_pages=32 - 4 * ppr,
         bitwise_equal_levels0_form=rp_bitwise,
         levels0_h2d_bytes={a: r.levels0_h2d_bytes for a, r in rp_first.items()},
         launches_per_dispatch={"K1": 2 * T, "K4": T, "K2": 0}, launches=rp_launches,
         dispatches=PAGED_DISPATCHES, order="in turns",
         p50_ms={a: 1e3 * p50(xs) for a, xs in rp_turns.items()},
         min_ms={a: 1e3 * min(xs) for a, xs in rp_turns.items()})
    if not rp_bitwise or rp_first["pool"].levels0_h2d_bytes != 0:
        raise AssertionError("the ragged pool dispatch differs from its levels0 form")

    # The incremental route (iters="auto", K1 and plain consensus): a hold
    # frame, a frame with one page perturbed in two rows, and threshold 0.
    icfg = ServeConfig(buckets=(8,), iters="auto", compute_dtype="bfloat16", use_pallas=True,
                       page_pool_pages=POOL_PAGES, min_iters=INC_MIN_ITERS)
    inc = InferenceEngine(cfg, icfg, params=params, device=dev)
    inc0 = InferenceEngine(cfg, dataclasses.replace(icfg, exit_threshold=0.0), params=params,
                           device=dev)
    for e in (inc, inc0):
        e.warmup(warm="paged-inc")
    frame0 = torch.randn(8, 3, side, side, generator=gen)
    warm_rows = inc.infer(frame0).levels
    for e in (inc, inc0):
        for i in range(8):
            e.pool.write_back(f"row{i}", warm_rows[i], cfg.num_patches)
    inc_rows = np.array([inc.pool.lookup(f"row{i}")[0] for i in range(8)], np.int32)
    frame1 = frame0.clone()
    page_px = pt // cfg.num_patches_side * cfg.patch_size  # the pixel rows of one page
    frame1[:2, :, page_px:2 * page_px] += torch.randn(2, 3, page_px, side, generator=gen)
    support = np.zeros((8, ppr), bool)
    support[:2, 1] = True
    inc_runs = {}
    for label, e, img, supp in (("hold", inc, frame0, np.zeros((8, ppr), bool)),
                                ("perturbed", inc, frame1, support),
                                ("threshold0", inc0, frame1, support)):
        k1.LAUNCHES = k2.LAUNCHES = 0
        res = e.infer(img, page_rows=inc_rows, support_rows=supp)
        launched = (k1.LAUNCHES, k2.LAUNCHES)
        if launched != (2 * res.iters_run, 0) or not bool(torch.isfinite(res.levels.float()).all()):
            raise AssertionError(f"incremental {label}: launches {launched}, "
                                 f"{res.iters_run} iterations")
        inc_runs[label] = res
    tiered0 = inc0.infer(frame1, page_rows=inc_rows)
    hold = inc_runs["hold"]
    inc_bitwise = (inc_runs["threshold0"].iters_run == T
                   and torch.equal(inc_runs["threshold0"].levels, tiered0.levels))
    hold_ok = (hold.iters_run == INC_MIN_ITERS and not hold.row_iters.any()
               and bool(hold.row_converged.all()))
    emit("serve_incremental", bucket=8, exit_threshold=icfg.exit_threshold,
         min_iters=INC_MIN_ITERS, budget=inc.auto_budget,
         hold=dict(iters_run=hold.iters_run, row_iters=hold.row_iters.tolist(),
                   ms=1e3 * hold.latency_s),
         perturbed=dict(iters_run=inc_runs["perturbed"].iters_run,
                        row_iters=inc_runs["perturbed"].row_iters.tolist(),
                        row_converged=inc_runs["perturbed"].row_converged.tolist(),
                        ms=1e3 * inc_runs["perturbed"].latency_s),
         threshold0_bitwise_equal_tiered=inc_bitwise, hold_pays_min_iters=hold_ok)
    if not (inc_bitwise and hold_ok):
        raise AssertionError("incremental route: the hold frame or the threshold-0 contract")

    # The same write-backs into a copy-on-write pool and an aliasing one; one
    # read pin forces one fallback. Then ms per write-back for each, in turns.
    pools = {a: PagedColumnPool(cfg, dataclasses.replace(pcfg, pool_aliasing=a), device=dev)
             for a in (False, True)}
    wb_rows = [cold.levels[i] for i in range(8)] + [first["paged"].levels[i] for i in range(4)]
    for a, p in pools.items():
        for i, row in enumerate(wb_rows):
            if i == 10:
                p.acquire_read()
            p.write_back(f"s{i % 8}", row, cfg.num_patches)
            if i == 10:
                p.release_read()
    torch.cuda.synchronize()
    same_bytes = torch.equal(pools[False].buffer().view(torch.int16),
                             pools[True].buffer().view(torch.int16))
    recs = {a: p.record() for a, p in pools.items()}
    n_wb, row_bytes = len(wb_rows), ppr * pool.page_bytes
    analytic = {"cow": n_wb * pool.pool_bytes,
                "alias": (n_wb - 1) * row_bytes, "alias_cow": pool.pool_bytes}
    moved = {"cow": recs[False]["cow_bytes_moved"],
             "alias": recs[True]["alias"]["alias_bytes_moved"],
             "alias_cow": recs[True]["cow_bytes_moved"]}
    fallbacks = recs[True]["alias"]["n_alias_fallbacks"]
    wb_ms = {"cow": [], "alias": []}
    for i in range(WRITEBACK_ROUNDS):
        for arm in (("cow", "alias") if i % 2 == 0 else ("alias", "cow")):
            p = pools[arm == "alias"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.write_back(f"s{i % 8}", wb_rows[i % len(wb_rows)], cfg.num_patches)
            torch.cuda.synchronize()
            wb_ms[arm].append(1e3 * (time.perf_counter() - t0))
    emit("serve_pool_alias", pool_pages=POOL_PAGES, writes=n_wb, pinned_writes=1,
         identical_pool_bytes=same_bytes, bytes_moved=moved, analytic_bytes_moved=analytic,
         alias_fallbacks=fallbacks, epoch=recs[True]["alias"]["epoch"],
         writeback_ms_p50={a: p50(xs) for a, xs in wb_ms.items()},
         writeback_ms_min={a: min(xs) for a, xs in wb_ms.items()}, rounds=WRITEBACK_ROUNDS,
         order="in turns")
    if not same_bytes or moved != analytic or fallbacks != 1:
        raise AssertionError(f"pool aliasing: bytes equal {same_bytes}, moved {moved} vs "
                             f"{analytic}, fallbacks {fallbacks}")
    del pools

    # Glom(iters="auto") on the card: the early exit at the default
    # threshold, and at threshold 0 the budget, equal to glom_forward_auto.
    shape_kw = dict(dim=cfg.dim, levels=cfg.levels, image_size=side, patch_size=cfg.patch_size)
    gm = Glom(**shape_kw, params=params, compute_dtype=bf16, use_pallas=True, device=dev)
    gm0 = Glom(**shape_kw, params=params, compute_dtype=bf16, use_pallas=True, device=dev,
               exit_threshold=0.0)
    img_g = torch.randn(2, 3, side, side, generator=gen).to(dev)
    gm(img_g, iters="auto")  # the first call warms the allocator
    k1.LAUNCHES = k2.LAUNCHES = 0
    t0 = time.perf_counter()
    out_g = gm(img_g, iters="auto")
    torch.cuda.synchronize()
    g_ms = 1e3 * (time.perf_counter() - t0)
    g_iters = int(gm.last_auto_iters)
    g_launches = (k1.LAUNCHES, k2.LAUNCHES)
    out_g0 = gm0(img_g, iters="auto")
    with torch.inference_mode():
        want_g0, _, _ = glom_forward_auto(gm0.params, img_g, cfg, max_iters=T, threshold=0.0,
                                          compute_dtype=bf16, use_pallas=True)
    g_ok = (g_launches == (2 * g_iters, 0) and int(gm0.last_auto_iters) == T
            and torch.equal(out_g0, want_g0) and bool(torch.isfinite(out_g.float()).all())
            and tuple(out_g.shape) == (2, n_tok, L, d))
    emit("glom_auto", batch=2, exit_threshold=gm.exit_threshold, last_auto_iters=g_iters,
         launches={"K1": g_launches[0], "K2": g_launches[1]}, ms=g_ms,
         threshold0_iters=int(gm0.last_auto_iters), threshold0_bitwise_equal_auto=g_ok)
    if not g_ok:
        raise AssertionError("Glom(iters='auto') on the card")

    # Retry: an injected fault recovers, bit for bit; a launch failure, raised
    # by the kernels' own check() with the loaded library's error string, is
    # not retried.
    rec = Records()
    plan = FaultPlan(0, writer=rec).register("engine-dispatch", at=(0,))
    faulty = InferenceEngine(cfg, scfg, params=params, device=dev, writer=rec,
                             fault_hook=dispatch_fault(plan))
    recovered = faulty.infer(imgs_p)
    again = engine.infer(imgs_p)
    actions = [r["action"] for r in rec.recs if r.get("kind") == "recovery"]
    calls = []

    def kernel_fault(ctx):
        calls.append(ctx["attempt"])
        _build.check(700, "grouped_mlp_fwd", k1._lib().grouped_mlp_error_string)

    broken = InferenceEngine(cfg, scfg, params=params, device=dev, writer=rec,
                             fault_hook=kernel_fault)
    try:
        broken.infer(imgs_p)
        kernel_raised = False
    except KernelError:
        kernel_raised = True
    retry_ok = (torch.equal(recovered.levels, again.levels)
                and actions == ["dispatch-retry", "dispatch-recovered"]
                and kernel_raised and calls == [1] and broken.retry.record()["n_retries"] == 0)
    emit("serve_retry", recovery_actions=actions, recovered_bitwise=torch.equal(
        recovered.levels, again.levels), kernel_error_attempts=calls,
         kernel_error_raised=kernel_raised, retry=faulty.retry.record(),
         kernel_retry=broken.retry.record())
    if not retry_ok:
        raise AssertionError("dispatch retry: the fault did not recover bit for bit, or a "
                             "KernelError was retried")
    del faulty, broken

    # Release: the pool's device memory returns, and the engine refuses work.
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    paged_eng.release()
    freed = held - torch.cuda.memory_allocated()
    try:
        paged_eng.infer(imgs_p)
        refused = False
    except RuntimeError as e:  # only the release refusal; anything else propagates
        if not (paged_eng.released and "was released" in str(e)):
            raise
        refused = True
    emit("engine_release", freed_mib=freed / 2**20, pool_mib=pool.pool_bytes / 2**20,
         refuses_dispatch=refused)
    if freed < pool.pool_bytes or not refused:
        raise AssertionError(f"release freed {freed} bytes of a {pool.pool_bytes}-byte pool, "
                             f"refused {refused}")

    # -- serve: the host stack (DynamicBatcher) over the engines -----------------
    batcher_launches = serve_host_stack(
        cfg, params, dev, engine, ragged, lambda imgs: same_step_fixed(imgs)[0], compare)

    # -- serve: the elastic fleet (Autoscaler, spares, drains, migration) --------
    elastic_launches = serve_elastic(cfg, params, dev)

    # -- train: the flagship denoising trainer, the second main path -------------
    from glom_tpu_torch import TrainConfig, Trainer
    from glom_tpu_torch.data import shapes_dataset
    from glom_tpu_torch.kernels.fused_loop import fused_glom_loop
    from glom_tpu_torch.models.core import param_leaves, per_iteration_loop, unflatten_params
    from glom_tpu_torch.models.transplant import HEAD_KEYS, PARAM_KEYS
    from glom_tpu_torch.train import (
        create_train_state,
        default_recon_index,
        denoise_loss,
        init_denoise,
        make_train_step,
    )

    k = default_recon_index(T)  # iterations the loss runs: 7
    dparams = init_denoise(cfg, generator=torch.Generator().manual_seed(SEED))
    counters = {
        "K1 fwd": (k1, "LAUNCHES"), "K1 fwd add": (k1, "LAUNCHES_ADD"),
        "K1 pre": (k1, "LAUNCHES_PRE"), "K1 pre add": (k1, "LAUNCHES_PRE_ADD"),
        "K2 fwd": (k2, "LAUNCHES"),
        "K1 bwd": (k1, "LAUNCHES_BWD"), "K1 bwd add": (k1, "LAUNCHES_BWD_ADD"),
        "K1 bwd acc": (k1, "LAUNCHES_BWD_ACC"), "K1 bwd acc add": (k1, "LAUNCHES_BWD_ACC_ADD"),
        "K2 bwd dq": (k2, "LAUNCHES_BWD_DQ"), "K2 bwd dkv": (k2, "LAUNCHES_BWD_DKV"),
        "K2 combine dq": (k2, "LAUNCHES_BWD_COMBINE_DQ"),
        "K2 combine dkv": (k2, "LAUNCHES_BWD_COMBINE_DKV"),
        "K1 fwd cat": (k1, "LAUNCHES_CAT"), "K1 pre cat": (k1, "LAUNCHES_PRE_CAT"),
        "K1 bwd acc cat": (k1, "LAUNCHES_BWD_ACC_CAT"),
        "K2 fwd cons": (k2, "LAUNCHES_CONS"), "K2 onesweep": (k2, "LAUNCHES_BWD_ONESWEEP"),
    }

    def counts():
        return {key: getattr(mod, attr) for key, (mod, attr) in counters.items()}

    def reset_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def launches_per_step(nonzero):
        return {key: nonzero.get(key, 0) for key in counters}

    forward = {"K1 fwd": 2 * k, "K1 fwd add": k, "K2 fwd": k}
    # The loop: one K1 launch a phase over the combined grid.
    want_loop = launches_per_step({"K1 fwd": k, "K1 fwd cat": k, "K2 fwd": k, "K1 bwd acc": k,
                                   "K1 bwd acc cat": k, "K2 combine dq": k,
                                   "K2 combine dkv": k})
    want_remat = dict(want_loop, **{"K1 pre": k, "K1 pre cat": k})
    want_scan = launches_per_step({**forward, "K1 bwd": 2 * k, "K1 bwd add": k,
                                   "K2 bwd dq": k, "K2 bwd dkv": k})

    def drive_trainer(phase, tcfg, steps, want_step, want_route, model=None,
                      log_every=TRAIN_LOG_EVERY):
        """Train `steps` Adam steps through Trainer.fit with every launch
        count set to 0 just before and read just after; check the route and
        the exact launches of every step; emit the phase. `model` is a
        (GlomConfig, DenoiseParams) pair, the flagship's by default."""
        mcfg, mparams = model if model is not None else (cfg, dparams)
        trainer = Trainer(mcfg, tcfg, params=mparams, device="cuda")
        per_step = []  # (variant, launches, metrics) of every step

        def counted(fn, variant):
            def run(batch):
                before = counts()
                out = fn(batch)
                per_step.append((variant, {key: v - before[key] for key, v in counts().items()},
                                 out))
                return out
            return run

        trainer.step = counted(trainer.step, "step")
        trainer.step_fast = counted(trainer.step_fast, "step_fast")
        reset_counts()
        records = trainer.fit(shapes_dataset(tcfg.batch_size, mcfg.image_size, seed=SEED), steps,
                              log_every=log_every, prefetch=2)
        path_launches = counts()
        variants = [v for v, _, _ in per_step]
        losses = [float(mm["loss"]) for _, _, mm in per_step]
        n_full = steps // log_every
        if variants != (["step_fast"] * (log_every - 1) + ["step"]) * n_full:
            raise AssertionError(f"{phase}: step variants {variants}")
        if len(records) != n_full or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{phase}: losses {losses}, {len(records)} records")
        if any(c != want_step for _, c, _ in per_step):
            raise AssertionError(f"{phase}: launches per step {[c for _, c, _ in per_step]} "
                                 f"!= {want_step}")
        if {(r["vjp_path"], r["grad_accum"]) for r in records} != {want_route}:
            raise AssertionError(f"{phase}: route "
                                 f"{[(r['vjp_path'], r['grad_accum']) for r in records]}")
        p50 = records[-1]["step_time_p50_ms"]
        emit(phase, config=dict(batch_size=tcfg.batch_size, compute_dtype=tcfg.compute_dtype,
                                use_pallas=True, remat=tcfg.remat, iters=k, steps=steps,
                                log_every=log_every, prefetch=2, image_size=mcfg.image_size,
                                num_patches=mcfg.num_patches),
             variants=variants, losses=losses, grad_norms=[r["grad_norm"] for r in records],
             vjp_path=records[-1]["vjp_path"], grad_accum=records[-1]["grad_accum"],
             step_time_p50_ms=p50, step_time_p95_ms=records[-1]["step_time_p95_ms"],
             steps_timed=records[-1]["steps_timed"],
             column_iters_per_s=tcfg.batch_size * k / (p50 / 1e3),
             launches_per_step={key: v for key, v in want_step.items() if v},
             launches=path_launches)
        return trainer, records, path_launches

    # The flagship's default TrainConfig batch: the whole-loop VJP.
    tcfg = TrainConfig(batch_size=8, compute_dtype="bfloat16", use_pallas=True)
    trainer, records, train_launches = drive_trainer("train", tcfg, TRAIN_STEPS, want_loop,
                                                     ("fused_loop", 1))
    p50_ms = records[-1]["step_time_p50_ms"]
    # Its remat mode: the pre-activations recomputed by the pre-only kernel.
    _, _, remat_launches = drive_trainer(
        "train_remat", TrainConfig(batch_size=8, compute_dtype="bfloat16", use_pallas=True,
                                   remat=True),
        TRAIN_LOG_EVERY, want_remat, ("fused_loop", 1))
    # Below batch 8: the per-iteration route (the per-op K1/K2 backward kernels).
    _, _, scan_launches = drive_trainer(
        "train_scan_blockwise", TrainConfig(batch_size=4, compute_dtype="bfloat16",
                                            use_pallas=True),
        TRAIN_LOG_EVERY, want_scan, ("scan_blockwise", 1))

    leaves0 = [t.to(dev) for t in param_leaves(dparams)]

    def loss_and_grads(img, noise, model=None, **kw):
        """The denoising loss and its gradients on fresh leaves (the
        flagship's params, or a (GlomConfig, DenoiseParams) `model`)."""
        mcfg, mparams = model if model is not None else (cfg, dparams)
        base = leaves0 if model is None else [t.to(dev) for t in param_leaves(mparams)]
        leaves = [t.clone().requires_grad_() for t in base]
        loss = denoise_loss(unflatten_params(mparams, leaves), img, noise, mcfg, **kw)
        return loss, torch.autograd.grad(loss, leaves)

    # remat gradients are the non-remat loop's, bit for bit: one batch, the
    # same params and noise.
    img8 = torch.from_numpy(next(shapes_dataset(8, cfg.image_size, seed=SEED + 3))).to(dev)
    noise8 = randn(8, 3, cfg.image_size, cfg.image_size)
    _, g_remat = loss_and_grads(img8, noise8, use_pallas=True, compute_dtype=bf16, remat=True)
    _, g_keep = loss_and_grads(img8, noise8, use_pallas=True, compute_dtype=bf16)
    unequal = [nm for nm, a, b in zip(PARAM_KEYS + HEAD_KEYS, g_remat, g_keep)
               if not torch.equal(a, b)]
    emit("train_remat_grads", batch=8, leaves=len(g_keep), bitwise_equal=not unequal,
         unequal_leaves=unequal)
    if unequal:
        raise AssertionError(f"remat gradients differ from the non-remat loop's: {unequal}")

    # The batch-8 step on the loop and on the per-iteration route (scan_only),
    # in turns in this call, the step without the grad norm (step_fast).
    routes = {"fused_loop": False, "scan_blockwise": True}
    ab_steps = {r: make_train_step(cfg, tcfg, with_grad_norm=False, scan_only=so, device="cuda")
                for r, so in routes.items()}
    if {r: fn.vjp_path for r, fn in ab_steps.items()} != {r: r for r in routes}:
        raise AssertionError(f"A/B routes {[fn.vjp_path for fn in ab_steps.values()]}")
    ab_state = {r: create_train_state(cfg, tcfg, params=dparams, device="cuda")[0] for r in routes}
    ab_gen = {r: torch.Generator(device=dev).manual_seed(SEED) for r in routes}
    ab_data = shapes_dataset(8, cfg.image_size, seed=SEED + 4)
    ab_ms = {r: [] for r in routes}
    for i in range(AB_ROUNDS + 1):  # round 0 warms both up and is not timed
        batch = torch.from_numpy(next(ab_data)).to(dev)
        for r in (list(routes) if i % 2 == 0 else list(routes)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ab_state[r], _ = ab_steps[r](ab_state[r], batch, ab_gen[r])
            torch.cuda.synchronize()
            if i:
                ab_ms[r].append(1e3 * (time.perf_counter() - t0))
    ab_p50 = {r: sorted(v)[len(v) // 2] for r, v in ab_ms.items()}
    emit("train_ab", batch=8, rounds=AB_ROUNDS, order="alternating", step="without grad norm",
         p50_ms=ab_p50, min_ms={r: min(v) for r, v in ab_ms.items()},
         loop_over_scan=ab_p50["fused_loop"] / ab_p50["scan_blockwise"])

    # The two routes' only difference, the k-iteration loop's forward and
    # backward (bf16, global consensus), at batches 1 to 8, in turns: where
    # the batch >= 8 rule (glom_tpu's) sits against this card.
    loop_leaves = [t.to(dev, bf16).requires_grad_()
                   for t in (*ffw["bottom_up"], *ffw["top_down"], pos)]
    geometry = dict(side=side, radius=0.0, attend_self=False)
    sweep = {}
    for bs in (1, 2, 4, 8):
        tok = randn(bs, n, d, dtype=bf16).requires_grad_()
        lv0 = randn(L, bs, n, d, dtype=bf16).requires_grad_()
        gout = randn(L, bs, n, d, dtype=bf16)
        ins = [*loop_leaves, tok, lv0]
        route_fn = {"fused_loop": fused_glom_loop, "scan_blockwise": per_iteration_loop}
        ms_by = {r: [] for r in route_fn}
        for i in range(AB_ROUNDS + 1):  # round 0 warms both up and is not timed
            for r in (list(route_fn) if i % 2 == 0 else list(route_fn)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = route_fn[r](GroupedFFWParams(*ins[:4]), GroupedFFWParams(*ins[4:8]),
                                  *ins[8:], k, **geometry)
                torch.autograd.grad(out, ins, grad_outputs=gout)
                torch.cuda.synchronize()
                if i:
                    ms_by[r].append(1e3 * (time.perf_counter() - t0))
        p50s = {r: sorted(v)[len(v) // 2] for r, v in ms_by.items()}
        sweep[bs] = dict(p50_ms=p50s, loop_over_scan=p50s["fused_loop"] / p50s["scan_blockwise"])
    emit("train_ab_batches", iters=k, rounds=AB_ROUNDS, order="alternating",
         timed="loop forward + backward", by_batch=sweep)

    # Where one training step on the loop spends its device time (torch.profiler).
    batch8 = next(shapes_dataset(8, cfg.image_size, seed=SEED + 1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch8)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernel_ms = device_ms_by_kernel(prof)
    busy_ms = sum(kernel_ms.values())
    emit("train_profile", batch=8, vjp_path=trainer.vjp_path, wall_ms=wall_ms,
         device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms if busy_ms else None,
         p50_unprofiled_ms=p50_ms, kernel_ms=dict(list(kernel_ms.items())[:25]))

    def parity(phase, got, want, bar, **extra):
        """Loss relative error and every leaf's max abs error over max
        |want|; emit; return the worst (None when `bar` is None: printed
        only)."""
        leaf_err = {nm: err_over_max(a, b) for nm, a, b in
                    zip(PARAM_KEYS + HEAD_KEYS, got[1], want[1])}
        loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        worst = max(max(r for _, r in leaf_err.values()), loss_rel)
        emit(phase, **extra, loss_got=float(got[0]), loss_want=float(want[0]),
             loss_rel_err=loss_rel, max_abs_err={nm: v[0] for nm, v in leaf_err.items()},
             err_over_max={nm: v[1] for nm, v in leaf_err.items()}, worst=worst, bar=bar,
             bar_ratio=None if bar is None else worst / bar,
             ok=None if bar is None else worst <= bar)
        return worst

    # f32 loss and gradients: the fused route against the plain route, on
    # the card, same weights and noise, batch 2 (the per-iteration route).
    img2 = torch.from_numpy(next(shapes_dataset(2, cfg.image_size, seed=SEED + 2))).to(dev)
    noise2 = randn(2, 3, cfg.image_size, cfg.image_size)
    worst = parity("train_parity_f32", loss_and_grads(img2, noise2, use_pallas=True),
                   loss_and_grads(img2, noise2), TRAIN_F32_BAR, batch=2, iters=k,
                   vjp_path="scan_blockwise")
    if worst > TRAIN_F32_BAR:
        raise AssertionError("f32 fused training gradients disagree with the plain route")

    # The same at batch 8, where the fused route is the loop; then the bf16
    # loop's and the bf16 per-iteration route's gradients against the f32
    # plain ones (printed: how far each dtype's rounding moves them).
    reset_counts()
    loop32 = loss_and_grads(img8, noise8, use_pallas=True)
    took_loop = counts()["K2 combine dkv"] == k and counts()["K2 bwd dkv"] == 0
    plain32 = loss_and_grads(img8, noise8)
    worst = parity("train_loop_parity_f32", loop32, plain32, LOOP_F32_BAR, batch=8, iters=k,
                   vjp_path="fused_loop", took_the_loop=took_loop)
    # The per-iteration route at the same batch, for scale (printed only).
    parity("train_scan_parity_f32", loss_and_grads(img8, noise8, use_pallas=True,
                                                   scan_only=True),
           plain32, None, batch=8, iters=k, vjp_path="scan_blockwise")
    for route, kw in (("fused_loop", {}), ("scan_blockwise", {"scan_only": True})):
        parity("train_bf16_vs_f32", loss_and_grads(img8, noise8, use_pallas=True,
                                                   compute_dtype=bf16, **kw),
               plain32, None, batch=8, iters=k, vjp_path=route)
    if not took_loop or worst > LOOP_F32_BAR:
        raise AssertionError("f32 loop training gradients disagree with the plain route")

    # -- train: long global rows (n = 4096) through the one-sweep K2 backward ---------
    # GlomConfig at 896 px, patch 14: side 64, n = 4096, global consensus,
    # flagship widths; batch 2 resolves to the per-iteration route, whose K2
    # forward saves cons and whose K2 backward is the one-sweep.
    cfg_long = GlomConfig(dim=512, levels=6, image_size=896, patch_size=14)
    if cfg_long.num_patches != 4096:
        raise AssertionError(f"long-row config has {cfg_long.num_patches} patches")
    lparams = init_denoise(cfg_long, generator=torch.Generator().manual_seed(SEED))
    long_model = (cfg_long, lparams)
    want_long = launches_per_step({**forward, "K2 fwd cons": k, "K1 bwd": 2 * k,
                                   "K1 bwd add": k, "K2 onesweep": k})
    long_trainer, long_records, long_launches = drive_trainer(
        "train_longrow", TrainConfig(batch_size=2, compute_dtype="bfloat16", use_pallas=True),
        LONGROW_STEPS, want_long, ("scan_blockwise", 1), model=long_model,
        log_every=LONGROW_STEPS)
    batch_long = next(shapes_dataset(2, cfg_long.image_size, seed=SEED + 7))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        long_trainer.step(batch_long)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernel_ms = device_ms_by_kernel(prof)
    busy_ms = sum(kernel_ms.values())
    emit("train_longrow_profile", batch=2, num_patches=4096, vjp_path=long_trainer.vjp_path,
         wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms if busy_ms else None,
         p50_unprofiled_ms=long_records[-1]["step_time_p50_ms"],
         kernel_ms=dict(list(kernel_ms.items())[:25]))

    # f32 loss and gradients at batch 1, n = 4096: the fused route (the
    # one-sweep) against the plain route, same weights and noise.
    img_l = torch.from_numpy(next(shapes_dataset(1, cfg_long.image_size, seed=SEED + 8))).to(dev)
    noise_l = randn(1, 3, cfg_long.image_size, cfg_long.image_size)
    reset_counts()
    long32 = loss_and_grads(img_l, noise_l, model=long_model, use_pallas=True)
    took_onesweep = counts()["K2 onesweep"] == k and counts()["K2 bwd dkv"] == 0
    worst = parity("train_longrow_parity_f32", long32,
                   loss_and_grads(img_l, noise_l, model=long_model), LONGROW_F32_BAR, batch=1,
                   iters=k, num_patches=4096, vjp_path="scan_blockwise",
                   took_the_onesweep=took_onesweep)
    if not took_onesweep or worst > LONGROW_F32_BAR:
        raise AssertionError("f32 long-row training gradients disagree with the plain route")

    # The loop (two-pass combine) against the per-iteration route (the
    # one-sweep) at n = 4096, batch 2: forward and backward of the k-iteration
    # loop alone, bf16, in turns. No route changes: the evidence for whether
    # the loop should take long rows.
    tok_l = randn(2, 4096, d, dtype=bf16).requires_grad_()
    lv0_l = randn(L, 2, 4096, d, dtype=bf16).requires_grad_()
    pos_l = randn(4096, d, dtype=bf16).requires_grad_()
    gout_l = randn(L, 2, 4096, d, dtype=bf16)
    ins_l = [*loop_leaves[:8], pos_l, tok_l, lv0_l]
    geometry_l = dict(side=64, radius=0.0, attend_self=False)
    long_ms = {r: [] for r in route_fn}
    route_counts = {}
    for i in range(LONGROW_AB_ROUNDS + 1):  # round 0 warms both up and is not timed
        for r in (list(route_fn) if i % 2 == 0 else list(route_fn)[::-1]):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = route_fn[r](GroupedFFWParams(*ins_l[:4]), GroupedFFWParams(*ins_l[4:8]),
                              *ins_l[8:], k, **geometry_l)
            torch.autograd.grad(out, ins_l, grad_outputs=gout_l)
            torch.cuda.synchronize()
            if i:
                long_ms[r].append(1e3 * (time.perf_counter() - t0))
            route_counts[r] = {key: v - before[key] for key, v in counts().items() if v != before[key]}
            del out
    if (route_counts["scan_blockwise"].get("K2 onesweep") != k
            or route_counts["fused_loop"].get("K2 combine dkv") != k):
        raise AssertionError(f"long-row A/B routes: {route_counts}")
    long_p50 = {r: statistics.median(v) for r, v in long_ms.items()}
    emit("train_longrow_ab", batch=2, num_patches=4096, iters=k, rounds=LONGROW_AB_ROUNDS,
         order="alternating", timed="loop forward + backward", p50_ms=long_p50,
         min_ms={r: min(v) for r, v in long_ms.items()}, launches_per_round=route_counts,
         loop_over_scan=long_p50["fused_loop"] / long_p50["scan_blockwise"])

    # -- train: the training CLI at the flagship preset, batch 64 -----------------
    # python -m glom_tpu_torch.train.cli --preset imagenet224-dp8, in process:
    # 4 steps with a checkpoint every 2, then --resume to 6, on .npy shards of
    # 224-px shapes images. --log-every 1, so every step writes a record and
    # a host_step_dispatch span of its own (the step ends in a synchronize).
    import contextlib
    import gc
    import io
    import os
    import tempfile

    from glom_tpu_torch.data import write_shapes_dataset
    from glom_tpu_torch.kernels.fused_loop import residual_bytes
    from glom_tpu_torch.resilience import FaultPlan, InjectedFault
    from glom_tpu_torch.train import TrainSupervisor, fit_supervised, temporal_rollout
    from glom_tpu_torch.train import cli as train_cli
    from glom_tpu_torch.utils.checkpoint import CheckpointManager, verify_manifest
    from glom_tpu_torch.utils.metrics import detect_chip, mfu
    from glom_tpu_torch.utils.presets import get_preset

    class Records:
        """A metrics writer that keeps what it is given."""

        def __init__(self):
            self.records = []

        def write(self, rec):
            self.records.append(rec)

    preset = get_preset("imagenet224-dp8")
    if preset.model != cfg or preset.train.batch_size != CLI_BATCH:
        raise AssertionError(f"the flagship preset changed: {preset.model}, {preset.train}")
    work = tempfile.TemporaryDirectory(prefix="glom_chip_smoke_")
    data_dir, ck_dir = os.path.join(work.name, "shards"), os.path.join(work.name, "ckpt")
    metrics_path = os.path.join(work.name, "train.jsonl")
    write_shapes_dataset(data_dir, CLI_IMAGES, cfg.image_size, seed=SEED, fmt="npy",
                         shard_size=CLI_BATCH)
    cli_argv = ["--preset", "imagenet224-dp8", "--data-dir", data_dir, "--checkpoint-every",
                "2", "--checkpoint-dir", ck_dir, "--metrics-file", metrics_path,
                "--log-every", "1"]

    def run_cli(extra):
        """main(argv) with its echoed records and notes kept off this log;
        (exit code, stderr, launches by counter)."""
        out, err = io.StringIO(), io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = train_cli.main(cli_argv + extra)
        torch.cuda.synchronize()
        return rc, err.getvalue(), counts()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    cli_base_mib = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    rc1, _, cli_launches1 = run_cli(["--steps", "4"])
    with open(metrics_path) as fh:
        n_first = sum(1 for _ in fh)
    rc2, err2, cli_launches2 = run_cli(["--steps", "6", "--resume"])
    cli_peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    with open(metrics_path) as fh:
        cli_records = [json.loads(ln) for ln in fh]
    step_recs = [r for r in cli_records if r["kind"] == "train_step"]
    # Each run's first step builds its step function's state (allocator
    # warm-up); the rest are steady-state samples.
    dispatch = [[r["dur_s"] for r in recs if r.get("name") == "host_step_dispatch"]
                for recs in (cli_records[:n_first], cli_records[n_first:])]
    step_ms = [1e3 * x for run in dispatch for x in run[1:]]
    ck_spans = {name: [r for r in cli_records if r.get("name") == name]
                for name in ("host_checkpoint_save", "host_checkpoint_write",
                             "host_checkpoint_wait")}
    mgr = CheckpointManager(ck_dir)
    manifest_errors = {}
    for s in mgr.all_steps():
        with open(os.path.join(ck_dir, f"manifest_{s}.json")) as fh:
            manifest_errors[s] = verify_manifest(os.path.join(ck_dir, str(s)), json.load(fh))
    want_cli = [{key: steps * v for key, v in want_loop.items()} for steps in (4, 2)]
    cli_p50 = statistics.median(step_ms)
    cli_cips = CLI_BATCH * k / (cli_p50 / 1e3)
    chip = detect_chip(dev)
    emit("train_cli", preset="imagenet224-dp8", batch=CLI_BATCH, steps=[4, 6],
         exit_codes=[rc1, rc2], resumed="resumed from step 4" in err2,
         records=len(step_recs), losses=[r["loss"] for r in step_recs],
         vjp_paths=sorted({r["vjp_path"] for r in step_recs}),
         grad_accum=sorted({r["grad_accum"] for r in step_recs}),
         step_ms=step_ms, step_p50_ms=cli_p50, column_iters_per_s=cli_cips,
         chip=chip, mfu=mfu(cfg, cli_cips, chip=chip, backward=True),
         checkpoint_save_ms=[1e3 * r["dur_s"] for r in ck_spans["host_checkpoint_save"]],
         checkpoint_write_ms=[1e3 * r["dur_s"] for r in ck_spans["host_checkpoint_write"]],
         checkpoint_wait_ms=[1e3 * r["dur_s"] for r in ck_spans["host_checkpoint_wait"]],
         checkpoint_mib=[r["bytes"] / 2 ** 20 for r in ck_spans["host_checkpoint_write"]],
         checkpoint_steps=mgr.all_steps(), manifests_verified=manifest_errors,
         peak_mib=cli_peak_mib, base_mib=cli_base_mib,
         launches_per_run=[cli_launches1, cli_launches2])
    if (rc1, rc2) != (0, 0) or "resumed from step 4" not in err2:
        raise AssertionError(f"train_cli: exit codes {rc1}, {rc2}; stderr {err2[-300:]}")
    if len(step_recs) != 6 or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
            and r["vjp_path"] == "fused_loop" for r in step_recs):
        raise AssertionError(f"train_cli: records {step_recs}")
    if mgr.all_steps() != [2, 4, 6] or mgr.valid_steps() != [2, 4, 6] or any(
            manifest_errors.values()):
        raise AssertionError(f"train_cli: checkpoints {manifest_errors}")
    if [cli_launches1, cli_launches2] != want_cli:
        raise AssertionError(f"train_cli: launches {cli_launches1}, {cli_launches2} "
                             f"!= {want_cli}")

    # -- train: a restored step equals the uninterrupted one, bit for bit ---------
    # Three steps, an asynchronous save (its host copy is taken before save()
    # returns, while the next step updates the parameters in place), one more
    # step; then a fresh Trainer restored from the save takes the same step.
    tcfg8 = TrainConfig(batch_size=8, compute_dtype="bfloat16", use_pallas=True)
    data8 = shapes_dataset(8, cfg.image_size, seed=SEED + 11)
    batches8 = [next(data8) for _ in range(4)]

    def state_tensors(trainer):
        opt = trainer.state.optimizer.state_dict()["state"]
        return ([t.detach() for t in param_leaves(trainer.state.params)],
                [v for st in opt.values() for v in st.values()])

    tr_a = Trainer(cfg, tcfg8, params=dparams, device="cuda")
    for b in batches8[:3]:
        tr_a.step(b)
    resume_mgr = CheckpointManager(os.path.join(work.name, "resume_exact"))
    resume_mgr.save(3, tr_a.state, generator=tr_a.generator)
    loss_a = tr_a.step(batches8[3])["loss"]
    resume_mgr.wait()
    tr_b = Trainer(cfg, tcfg8, params=dparams, device="cuda")
    step_b, tr_b.state = resume_mgr.restore(state=tr_b.state, generator=tr_b.generator)
    loss_b = tr_b.step(batches8[3])["loss"]
    (pa, oa), (pb, ob) = state_tensors(tr_a), state_tensors(tr_b)
    unequal = [nm for nm, a, b in zip(PARAM_KEYS + HEAD_KEYS, pa, pb) if not torch.equal(a, b)]
    opt_equal = len(oa) == len(ob) and all(a.device == b.device and torch.equal(a, b)
                                           for a, b in zip(oa, ob))
    emit("train_resume_exact", batch=8, restored_step=step_b, vjp_path=tr_b.vjp_path,
         loss=float(loss_a), loss_bitwise_equal=bool(torch.equal(loss_a, loss_b)),
         params_bitwise_equal=not unequal, unequal_leaves=unequal,
         optimizer_bitwise_equal=opt_equal)
    if step_b != 3 or not torch.equal(loss_a, loss_b) or unequal or not opt_equal:
        raise AssertionError("a restored step differs from the uninterrupted one")
    del tr_a, tr_b

    # -- train: the restart supervisor, a fault at step 3, bit for bit ---------------
    def supervised(tag, at):
        """fit_supervised for SUPERVISED_STEPS steps, a checkpoint every 2,
        the data stream raising where the plan fires; (recoveries, last
        trainer)."""
        plan = FaultPlan(seed=SEED)
        if at is not None:
            plan.register("train-step", at=at, fault="trainer-crash")
        rec = Records()
        trainers = []

        def make_trainer():
            trainers.append(Trainer(cfg, tcfg8, params=dparams, device="cuda"))
            return trainers[-1]

        def make_data():
            for batch in shapes_dataset(8, cfg.image_size, seed=SEED + 12):
                if plan.fires("train-step"):
                    raise InjectedFault("injected trainer crash")
                yield batch

        fit_supervised(make_trainer, make_data, SUPERVISED_STEPS,
                       checkpoint_dir=os.path.join(work.name, tag), checkpoint_every=2,
                       log_every=2, metrics_writer=rec,
                       supervisor=TrainSupervisor(max_restarts=2, backoff_s=0.01, writer=rec))
        recoveries = [(r["action"], r.get("attempt"), r.get("step"), r.get("backoff_s"))
                      for r in rec.records if r.get("kind") == "recovery"]
        return recoveries, trainers[-1]

    got_rec, faulted = supervised("supervised_fault", (3,))
    clean_rec, clean = supervised("supervised_clean", None)
    want_rec = [("restart", 1, None, 0.01), ("resume-from-checkpoint", 2, 2, None)]
    (pf, of), (pc, oc) = state_tensors(faulted), state_tensors(clean)
    unequal = [nm for nm, a, b in zip(PARAM_KEYS + HEAD_KEYS, pf, pc) if not torch.equal(a, b)]
    opt_equal = len(of) == len(oc) and all(a.device == b.device and torch.equal(a, b)
                                           for a, b in zip(of, oc))
    emit("train_supervised", batch=8, steps=SUPERVISED_STEPS, fault_at_batch=3,
         recoveries=got_rec, clean_recoveries=clean_rec, final_steps=[faulted.state.step,
                                                                      clean.state.step],
         params_bitwise_equal=not unequal, unequal_leaves=unequal,
         optimizer_bitwise_equal=opt_equal)
    if got_rec != want_rec or clean_rec or unequal or not opt_equal or (
            faulted.state.step, clean.state.step) != (SUPERVISED_STEPS,) * 2:
        raise AssertionError("the supervised restart is not the uninterrupted run")
    del faulted, clean

    # -- temporal rollouts: the fused route against the plain one, f32 ----------------
    gparams = map_params(lambda t: t.to(dev), params)
    frames = torch.stack([torch.from_numpy(next(shapes_dataset(2, cfg.image_size,
                                                               seed=SEED + 20 + i)))
                          for i in range(TEMPORAL_FRAMES)]).to(dev)
    with torch.inference_mode():
        reset_counts()
        fused_t = temporal_rollout(gparams, frames, cfg, use_pallas=True)
        torch.cuda.synchronize()
        temporal_launches = counts()
        plain_t = temporal_rollout(gparams, frames, cfg)
        rollout_ms = []
        for i in range(TEMPORAL_ROUNDS + 1):  # round 0 warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bf16_t = temporal_rollout(gparams, frames, cfg, use_pallas=True, compute_dtype=bf16)
            torch.cuda.synchronize()
            if i:
                rollout_ms.append(1e3 * (time.perf_counter() - t0))
    ok, abs_err, rel_err, ratio = compare(fused_t, plain_t, 2e-3, 2e-4)
    want_t = launches_per_step({"K1 fwd": 2 * T * TEMPORAL_FRAMES, "K1 fwd add": T * TEMPORAL_FRAMES,
                                "K2 fwd": T * TEMPORAL_FRAMES})
    finite = bool(torch.isfinite(bf16_t.float()).all())
    emit("temporal_parity_f32", frames=TEMPORAL_FRAMES, batch=2, iters=T,
         shape=list(fused_t.shape), max_abs_err=abs_err, max_rel_err=rel_err, rtol=2e-3,
         atol=2e-4, bar_ratio=ratio, ok=ok, launches=temporal_launches,
         bf16_rollout_ms=statistics.median(rollout_ms),
         bf16_ms_per_frame=statistics.median(rollout_ms) / TEMPORAL_FRAMES,
         bf16_rounds=TEMPORAL_ROUNDS, bf16_finite=finite)
    if not ok or temporal_launches != want_t or not finite or tuple(fused_t.shape) != (
            TEMPORAL_FRAMES, 2, cfg.num_patches, cfg.levels, cfg.dim):
        raise AssertionError("temporal rollout: the fused route disagrees with the plain one")
    del fused_t, plain_t, bf16_t

    # -- train: the peak device memory of one loop step at batch 128 ------------------
    tcfg128 = TrainConfig(batch_size=128, compute_dtype="bfloat16", use_pallas=True)
    step128 = make_train_step(cfg, tcfg128, with_grad_norm=False, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    state128, _ = create_train_state(cfg, tcfg128, params=dparams, device="cuda")
    img128 = torch.from_numpy(next(shapes_dataset(128, cfg.image_size, seed=SEED + 30))).to(dev)
    noise128 = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    base128_mib = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state128, m128 = step128(state128, img128, noise128)
    torch.cuda.synchronize()
    peak128_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    launches128 = counts()
    card_mib = torch.cuda.get_device_properties(dev).total_memory / 2 ** 20
    emit("train_peak_b128", batch=128, remat=False, vjp_path=step128.vjp_path,
         grad_accum=step128.grad_accum, loss=float(m128["loss"]), peak_mib=peak128_mib,
         base_mib=base128_mib, card_mib=card_mib,
         residual_mib=residual_bytes(L, 128, n, d, f, 2, k) / 2 ** 20,
         k1_bwd_scratch_mib=2 * (2 * L - 1) * 128 * n * f * 2 / 2 ** 20,
         b64_peak_mib=cli_peak_mib, b64_base_mib=cli_base_mib, launches=launches128)
    if (step128.vjp_path, step128.grad_accum) != ("fused_loop", 1) or launches128 != want_loop \
            or not math.isfinite(float(m128["loss"])):
        raise AssertionError("batch 128 left the loop or its step failed")
    if max(peak128_mib, cli_peak_mib) > card_mib:
        raise AssertionError("a training peak passes the card's memory")
    del state128, img128
    work.cleanup()

    # -- training across ranks: world 1 over NCCL, 2 and 4 ranks over gloo -----------
    gc.collect()
    torch.cuda.empty_cache()
    dist_launches = dist_phases(cfg, dev, smi)

    # -- sharded inference across ranks: 2 gloo ranks on the card ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches = mesh_phases(cfg, dev, smi)

    # -- levels TP, the sharded pool's other writers, an elastic fleet on rank groups ---
    gc.collect()
    torch.cuda.empty_cache()
    levels_launches, pool_launches = sharded_phases(cfg, dev, smi)
    for key, v in levels_launches.items():
        dist_launches[key] += v
    for key, v in pool_launches.items():
        mesh_launches[key] += v

    # -- telemetry's measuring half: per-level agreement, collective timing on ranks
    # and mesh engines, profiler captures, the memory probe, the watchdog --------------
    gc.collect()
    torch.cuda.empty_cache()
    telemetry_launches = telemetry_phases(cfg, dev, smi)

    # -- resilience: preemption saves, the pod barrier, the gang across ranks, serve chaos
    gc.collect()
    torch.cuda.empty_cache()
    resilience_launches = resilience_phases(cfg, dev, smi)

    # -- kernels -----------------------------------------------------------------
    k1_paths = {k: timings[k]["path"] for k in ("k1_bwd_b8", "k1_bwd_add_b8", "k1_bwd_acc_b8",
                                                 "k1_bwd_acc_add_b8", "k1_bwd_acc_cat_b8")}
    if set(k1_paths.values()) != {"sm90"}:
        raise AssertionError(f"a saved-pre K1 backward left the sm90 passes: {k1_paths}")
    # Each kernel's launches on the path that drives it: the forwards on the
    # serve path, the loop's kernels on the batch-8 train path (the pre-only
    # launch under remat), the per-iteration backward on the batch-4 path.
    # The loop's K1 launches all run over the combined grid, so the split
    # pre-only and accumulating launches (fused_loop.py:210/:198, :648/:621)
    # run on no path: their groups run inside the cat-grid launches, whose
    # entries name those sites under `also_replaces`.
    launches.update({
        "grouped_mlp_bwd": scan_launches["K1 bwd"] - scan_launches["K1 bwd add"],
        "grouped_mlp_bwd_add": scan_launches["K1 bwd add"],
        "consensus_update_bwd_dq": scan_launches["K2 bwd dq"],
        "consensus_update_bwd_dkv": scan_launches["K2 bwd dkv"],
        # the dq and dkv passes that together replace one TPU kernel
        "consensus_update_bwd_combine": (train_launches["K2 combine dq"]
                                         + train_launches["K2 combine dkv"]),
    })
    if min(train_launches["K2 combine dq"], train_launches["K2 combine dkv"]) == 0:
        raise AssertionError(f"a combine pass ran no time on its main path: {train_launches}")
    csrc = "glom_tpu_torch/csrc/"
    loop_src = "glom_tpu/kernels/fused_loop.py:"
    kernels = []
    for kname, src, replaces, err, tkey in (
        ("grouped_mlp_fwd", "grouped_mlp.cu", "glom_tpu/kernels/grouped_mlp.py:170",
         k1_err["bottom_up"], "k1_bottom_up_b8"),
        ("grouped_mlp_fwd_add", "grouped_mlp.cu", "glom_tpu/kernels/grouped_mlp.py:218",
         k1_err["top_down"], "k1_top_down_b8"),
        ("consensus_update_fwd", "consensus_update.cu",
         "glom_tpu/kernels/consensus_update.py:473", k2_err, "k2_b8"),
        ("grouped_mlp_bwd", "grouped_mlp_bwd.cu", "glom_tpu/kernels/grouped_mlp.py:503",
         k1_bwd_err["bottom_up"], "k1_bwd_b8"),
        ("grouped_mlp_bwd_add", "grouped_mlp_bwd.cu", "glom_tpu/kernels/grouped_mlp.py:543",
         k1_bwd_err["top_down"], "k1_bwd_add_b8"),
        ("consensus_update_bwd_dq", "consensus_update_bwd.cu",
         "glom_tpu/kernels/consensus_update.py:1142", k2_bwd_err["dq"], "k2_bwd_dq_b8"),
        ("consensus_update_bwd_dkv", "consensus_update_bwd.cu",
         "glom_tpu/kernels/consensus_update.py:1179", k2_bwd_err["dkv"], "k2_bwd_dkv_b8"),
        ("consensus_update_bwd_combine", "consensus_update_bwd.cu", loop_src + "826",
         max(k2_comb_err.values()), "k2_bwd_combine_b8"),
    ):
        kernels.append(dict(name=kname, route="cuda", source=csrc + src, replaces=replaces,
                            launches=launches[kname], max_abs_err=err, **timings[tkey]))
    # The combine's two passes, each with its launches and times.
    kernels[-1]["passes"] = {p: dict(launches=train_launches[f"K2 combine {p}"], **t)
                             for p, t in passes.items()}
    # This slice's kernels: the K2 forward's cons store and the one-sweep on
    # the long-row training path (glom_tpu's bf16 long row, n*d*2 = 4 MB,
    # is within its resident-row limit: the :473 kernel with save_cons);
    # the combined K1 grid on the loop.
    for kname, src, replaces, n_launch, err, tkey, also in (
        ("consensus_update_fwd_cons", "consensus_update.cu",
         "glom_tpu/kernels/consensus_update.py:473", long_launches["K2 fwd cons"], k2_cons_err,
         "k2_fwd_cons_longrow", None),
        ("consensus_update_bwd_onesweep", "consensus_update_bwd.cu",
         "glom_tpu/kernels/consensus_update.py:1004", long_launches["K2 onesweep"],
         onesweep_err[("bf16", 0.0, False)], "k2_bwd_onesweep_longrow", None),
        ("grouped_mlp_fwd_cat", "grouped_mlp.cu", loop_src + "354", train_launches["K1 fwd cat"],
         k1_cat_err["fwd"], "k1_fwd_cat_b8", ["144", "132"]),
        ("grouped_mlp_pre_cat", "grouped_mlp.cu", loop_src + "387", remat_launches["K1 pre cat"],
         k1_cat_err["pre"], "k1_pre_cat_b8", ["210", "198"]),
        ("grouped_mlp_bwd_acc_cat", "grouped_mlp_bwd.cu", loop_src + "525",
         train_launches["K1 bwd acc cat"], k1_cat_err["bwd"], "k1_bwd_acc_cat_b8",
         ["648", "621"]),
    ):
        kernels.append(dict(name=kname, route="cuda", source=csrc + src, replaces=replaces,
                            launches=n_launch, max_abs_err=err, **timings[tkey]))
        if also:  # the split-grid sites whose groups this launch runs
            kernels[-1]["also_replaces"] = [loop_src + line for line in also]
    # K4 on the ragged serve path, timed at its largest signature.
    kernels.append(dict(name="banded_consensus_fwd", route="cuda",
                        source=csrc + "banded_consensus.cu",
                        replaces="glom_tpu/kernels/banded_consensus.py:174",
                        launches=ragged_launches["banded_consensus_fwd"], max_abs_err=k4_err,
                        **timings["k4_ragged32_full"]))
    # The serving device layer's paths run these kernels again: their
    # launches on the paged bucket route and on the ragged route from the
    # pool (each counted from 0 over its timed turns).
    for kd in kernels:
        if kd["name"] in paged_launches:
            kd["paged_launches"] = paged_launches[kd["name"]]
        if kd["name"] in rp_launches:
            kd["ragged_pool_launches"] = rp_launches[kd["name"]]
        # ... and behind the batcher (serve_host_stack's main-path runs).
        if kd["name"] in batcher_launches:
            kd["batcher_launches"] = batcher_launches[kd["name"]]
        # ... and in the elastic fleet (every replica's warm-ups and
        # dispatches in serve_elastic's main-path run).
        if kd["name"] in elastic_launches:
            kd["elastic_launches"] = elastic_launches[kd["name"]]
        # ... and across ranks (every rank's counted steps of the dist_*
        # phases, dist_tp_levels included, and the world-1 NCCL steps).
        kd["dist_launches"] = dist_launches[kd["name"]]
        # ... and in sharded inference (every rank's forwards and engines in
        # mesh_forward, serve_mesh and serve_mesh_pool).
        kd["mesh_launches"] = mesh_launches[kd["name"]]
        # ... and under telemetry (train_telemetry_full, every rank's
        # dist_collective_timing and serve_mesh_timing runs, train_cli_trace
        # and the watchdog's CLI run).
        kd["telemetry_launches"] = telemetry_launches[kd["name"]]
        # ... and in the resilience phases' training workers (every counted
        # step of preempt_train, preempt_pod and dist_gang).
        kd["resilience_launches"] = resilience_launches[kd["name"]]
    if min(kd["launches"] for kd in kernels) == 0:
        raise AssertionError(f"a kernel ran no time on its main path: {launches}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


def _repeat_serve_elastic(n: int) -> int:
    """`python3 chip_smoke.py --repeat-serve-elastic N`: the flagship's
    serve_elastic phase alone, N times on one card (a timing-dependent
    phase's failure rate). Each pass prints its record on stdout and its
    outcome on stderr; the last stdout line lists the outcomes. Exit 1 if
    any pass failed."""
    import torch

    from glom_tpu_torch import GlomConfig
    from glom_tpu_torch.kernels import _build
    from glom_tpu_torch.models.core import init_glom

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.prebuild()
    dev = torch.device("cuda", 0)
    cfg = GlomConfig()
    params = init_glom(cfg, generator=torch.Generator().manual_seed(SEED))
    outcomes = []
    for i in range(n):
        t0 = time.perf_counter()
        try:
            serve_elastic(cfg, params, dev)
            outcomes.append(dict(ok=True, seconds=time.perf_counter() - t0))
        except AssertionError as e:
            outcomes.append(dict(ok=False, seconds=time.perf_counter() - t0, error=str(e)[:600]))
        print(f"serve_elastic pass {i}: {outcomes[-1]}", file=sys.stderr, flush=True)
    print(json.dumps({"repeat_serve_elastic": outcomes}), flush=True)
    return 0 if all(o["ok"] for o in outcomes) else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--repeat-serve-elastic":
        sys.exit(_repeat_serve_elastic(int(sys.argv[2])))
    if len(sys.argv) > 2 and sys.argv[1] == "--serve-cli-rank":
        # One rank of serve_cli_mesh_elastic (under torch.distributed.run).
        sys.exit(_elastic_cli_rank(sys.argv[2], sys.argv[3:]))
    if len(sys.argv) > 2 and sys.argv[1] == "--counted-train-cli":
        # A training worker of the resilience phases' chaos scenarios.
        sys.exit(_counted_train_cli(sys.argv[2], sys.argv[3:]))
    if len(sys.argv) > 3 and sys.argv[1] == "--sigterm-train-cli":
        # preempt_train's worker whose SIGTERM lands inside a step.
        sys.exit(_sigterm_train_cli(sys.argv[2], sys.argv[3], sys.argv[4:]))
    if len(sys.argv) > 2 and sys.argv[1] == "--gang-cli-rank":
        # One rank of dist_gang (under torch.distributed.run).
        sys.exit(_gang_cli_rank(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
