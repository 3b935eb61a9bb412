"""Command-line trainer: `python -m glom_tpu_torch.train.cli --preset cifar10 ...`

Counterpart of `glom_tpu/train/cli.py`: presets, the JSONL metrics
stream, manifest-verified checkpoints and resume, the restart supervisor
(`--supervise`), the crash flight recorder, and training across ranks.
The flags are glom_tpu's, plus `--device` (default `cuda`; `cpu` runs the
kernels' plain versions, as the tests do) and `--dist-backend`. Without a
card and without `--device cpu` it raises: it never falls back to the CPU.

`--distributed` runs DistributedTrainer on the preset's mesh scaled to
the world size (ranks past the mesh widen its data axis), one process a
rank, under `python -m
torch.distributed.run --nproc-per-node N -m glom_tpu_torch.train.cli
--distributed ...`; launched alone it is one rank, its group over a file
store in a temporary directory. Each rank runs on cuda:LOCAL_RANK for `--device cuda`,
on the named device for any other (`--device cuda:0` puts every rank on
that card; `--device cpu` on the CPU), over `--dist-backend` (nccl for a
card, gloo for the CPU by default). Rank 0 writes the metrics and the
checkpoints; every rank restores. `--check-parity` trains the same
batches on one device on rank 0 and exits 1 when the worst relative loss
deviation reaches 1e-2. `--zero-stage` and `--quantized-reduce` shard the
update across the data ranks (one device resolves them to 0 and off).

Observability: `--telemetry-level full` adds the per-level consensus
agreement to every record on one device (across ranks it runs "scalars",
glom_tpu's degradation); every logging record carries the card's
allocator watermarks (`hbm_*`, tracing/memory.py); `--trace-steps A:B`
profiles steps A..B into a Chrome trace under `--trace-dir`, and
`--profile-dir` the whole run (tracing/capture.py; one profiler session at a
time, so the two exclude each other); `--watchdog-interval S` runs the
backend watchdog (telemetry/watchdog.py) every S seconds, registered
globally for the run, so every record stamps its backend state and the
retry policies fail fast on a backend that is down.

Pods and gangs (resilience/coordinator.py): `--pod-index I --pod-count N
--pod-dir DIR` make this process host I of an N-host pod whose checkpoint
directory is `<root>/host_I`; the hosts meet over a DirectoryTransport in
DIR. A SIGTERM then saves through the two-phase barrier (every host commits
one common step, or the round aborts loudly), the resume reconciles to the
newest step valid on every host, and `--supervise` restarts the pod as a
gang. With `--distributed --supervise R` every rank is a gang member (host =
rank) over a StoreTransport on the process group's store: rank 0 writes the
global state to --checkpoint-dir, one copy that every rank restores, a
rank's failure restarts every rank from its newest step, and each attempt
builds the rank mesh afresh on groups whose collectives time out after
`parallel/mesh.GROUP_TIMEOUT_S`, so peers left waiting in a collective by
a failed rank raise instead of hanging.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import tempfile

# How long a relaunched pod host waits for its peers at the resume
# rendezvous. Every host of the pod is relaunched together: a host
# relaunched alone aborts after this long, since it cannot tell a peer that
# is down from one still training, whose newest steps its reconciliation
# would quarantine.
POD_RESUME_DEADLINE_S = 120.0


def _nonneg_int(s: str) -> int:
    v = int(s)
    if v < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {v}")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="glom-tpu-torch-train", description="Train GLOM (self-supervised denoising)"
    )
    p.add_argument("--preset", default="cifar10", help="see glom_tpu_torch.utils.presets")
    p.add_argument(
        "--device", default="cuda",
        help="torch device to train on (default cuda; cpu runs the kernels' "
        "plain versions)",
    )
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument(
        "--lr-schedule", choices=["constant", "cosine", "warmup_cosine"], default=None,
    )
    p.add_argument("--warmup-steps", type=int, default=None)
    p.add_argument(
        "--schedule-steps", type=int, default=None,
        help="cosine decay horizon (defaults to --steps when a schedule is set)",
    )
    p.add_argument(
        "--grad-accum", type=int, default=None, metavar="A",
        help="split each batch into A microbatches, accumulate grads, one "
        "optimizer update (peak activation memory of one microbatch)",
    )
    p.add_argument(
        "--zero-stage", type=int, choices=[0, 1, 2], default=None,
        help="ZeRO sharded weight update over the 'data' ranks: 1 shards the "
        "optimizer state, 2 also the gradient accumulator (one device: 0)",
    )
    p.add_argument(
        "--quantized-reduce", action="store_true",
        help="EXPERIMENTAL int8 block-scaled quantized-reduce emulation on the "
        "ZeRO reduce-scatter (needs --zero-stage >= 1 across ranks)",
    )
    p.add_argument(
        "--telemetry-level", choices=["off", "scalars", "full"], default=None,
        help="diagnostics depth: scalars = grad/update/param norms + the "
        "NaN/Inf guard in the step; full adds the per-level consensus "
        "agreement (one device; across ranks it runs scalars)",
    )
    p.add_argument(
        "--nonfinite-policy", choices=["skip", "warn"], default=None,
        help="what the NaN/Inf guard does (telemetry on): skip drops the "
        "poisoned update, warn applies it and flags the record",
    )
    p.add_argument(
        "--watchdog-interval", type=float, default=0.0, metavar="SECONDS",
        help="backend-liveness heartbeat: probe the device in a throwaway "
        "subprocess every SECONDS and stamp its state on every record (0 = off)",
    )
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--data", choices=["shapes", "gaussian"], default="shapes")
    p.add_argument(
        "--data-dir", default=None, metavar="PATH",
        help="train on REAL data: a directory of images (resized to the "
        "config's image_size), a .npy file, or a directory of .npy shards "
        "([N,H,W,C] or [N,C,H,W], uint8 or float). Overrides --data.",
    )
    p.add_argument(
        "--prefetch", type=_nonneg_int, default=2, metavar="N",
        help="stage N batches ahead from a background thread (0 = off)",
    )
    p.add_argument("--metrics-file", default=None, help="JSONL metrics path")
    p.add_argument(
        "--tensorboard", default=None, metavar="DIR",
        help="also mirror scalar metrics to TensorBoard summaries in DIR",
    )
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument(
        "--checkpoint-keep", type=int, default=3, metavar="N",
        help="checkpoint retention (the newest N steps)",
    )
    p.add_argument("--resume", action="store_true", help="resume from latest ckpt")
    p.add_argument(
        "--pod-index", type=int, default=None, metavar="I",
        help="this process's host index in a pod (with --pod-count and "
        "--pod-dir; --checkpoint-dir must be <root>/host_I)",
    )
    p.add_argument(
        "--pod-count", type=int, default=None, metavar="N",
        help="hosts in the pod (>= 2): SIGTERM saves through the two-phase "
        "barrier, resume reconciles to the newest common step",
    )
    p.add_argument(
        "--pod-dir", default=None, metavar="DIR",
        help="shared coordination directory of the pod's barrier rounds and "
        "commit markers",
    )
    p.add_argument(
        "--supervise", type=_nonneg_int, default=None, metavar="RESTARTS",
        help="run under the fit_supervised restart loop: on an unhandled "
        "training exception, restore the newest VALID checkpoint and retry "
        "with bounded exponential backoff, up to RESTARTS restarts; every "
        "decision is a stamped 'recovery' event. Requires --checkpoint-dir; "
        "implies --resume semantics.",
    )
    p.add_argument(
        "--preempt-deadline", type=float, default=30.0, metavar="SECONDS",
        help="SIGTERM grace budget: with --flight-recorder and "
        "--checkpoint-dir, the SIGTERM hook saves a checkpoint bounded by "
        "this deadline before dumping the flight ring",
    )
    p.add_argument("--profile-dir", default=None,
                   help="whole-run torch.profiler trace (a Chrome trace) into this dir")
    p.add_argument("--trace-steps", default=None, metavar="A:B",
                   help="torch.profiler trace of steps A..B only (a Chrome trace in "
                   "--trace-dir); excludes --profile-dir")
    p.add_argument("--trace-dir", default=os.path.join(tempfile.gettempdir(), "glom_tpu_trace"),
                   metavar="DIR", help="where --trace-steps writes its trace")
    p.add_argument(
        "--flight-recorder", default=None, metavar="DIR",
        help="crash flight recorder: keep a ring of the last --flight-events "
        "telemetry events and dump flight_<ts>.jsonl into DIR on an anomaly "
        "storm, SIGTERM/exit, or an unhandled training-loop exception",
    )
    p.add_argument(
        "--flight-events", type=int, default=256, metavar="N",
        help="flight-recorder ring capacity (default 256)",
    )
    p.add_argument("--distributed", action="store_true",
                   help="DistributedTrainer on the preset's mesh scaled to the world "
                   "size (launch under python -m torch.distributed.run)")
    p.add_argument("--check-parity", action="store_true",
                   help="train the same batches sharded and on one device; exit 1 "
                   "when the worst relative loss deviation reaches 1e-2")
    p.add_argument(
        "--dist-backend", choices=["nccl", "gloo"], default=None,
        help="torch.distributed backend of --distributed (default nccl on a card, "
        "gloo on the CPU; ranks sharing one card need gloo)",
    )
    p.add_argument(
        "--debug-nans", action="store_true",
        help="torch.autograd anomaly detection with NaN checks in the backward",
    )
    return p


def _pod_setup(args, writer):
    """(PodCoordinator, peer host dirs) for a pod run; (None, None) for the
    single-host path. Partial pod flags fail loudly: a pod member that fell
    back to a single-host save would resume inconsistently."""
    pod_args = (args.pod_index, args.pod_count, args.pod_dir)
    if all(a is None for a in pod_args):
        return None, None
    if any(a is None for a in pod_args):
        raise SystemExit("--pod-index/--pod-count/--pod-dir come together (pod coordination)")
    if args.pod_count < 2:
        raise SystemExit("--pod-count must be >= 2 (one host is the single-host path; drop "
                         "the pod flags)")
    if not args.checkpoint_dir:
        raise SystemExit("pod coordination requires --checkpoint-dir (the pod root's "
                         "host_<i> dir)")
    from glom_tpu_torch.resilience.coordinator import (
        DirectoryTransport,
        PodCoordinator,
        peer_host_dirs,
    )

    try:
        peers = peer_host_dirs(args.checkpoint_dir, args.pod_index, args.pod_count)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    transport = DirectoryTransport(args.pod_dir, args.pod_index, args.pod_count)
    return PodCoordinator(transport, writer=writer), peers


def _check_supervise(args) -> None:
    if not args.checkpoint_dir:
        raise SystemExit("--supervise requires --checkpoint-dir (the restart loop resumes "
                         "from checkpoints)")
    if args.check_parity or args.profile_dir or args.trace_steps:
        raise SystemExit("--supervise does not compose with --check-parity/--profile-dir/"
                         "--trace-steps (one concern per run)")
    if args.prefetch > 0:
        print("note: --prefetch is ignored under --supervise (the data stream is rebuilt "
              "per attempt)", file=sys.stderr)


def _trace_capture(args, writer):
    """(the step-window TraceCapture or None, the whole-run trace context)."""
    from glom_tpu_torch.tracing.capture import TraceCapture
    from glom_tpu_torch.utils.profiling import trace

    cap = (TraceCapture.parse(args.trace_steps, args.trace_dir, writer=writer)
           if args.trace_steps else None)
    return cap, trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if (args.distributed or args.check_parity) and args.pod_index is not None:
        raise SystemExit("--pod-* runs one process a host; the ranks of --distributed "
                         "--supervise are their own gang")
    if args.trace_steps and args.profile_dir:
        # One profiler session at a time: the step window would open inside
        # the whole-run session.
        raise SystemExit(
            "--profile-dir (whole-run trace) and --trace-steps (step window) are "
            "mutually exclusive — torch.profiler runs one session at a time; pick one"
        )
    if args.trace_steps:
        from glom_tpu_torch.tracing.capture import parse_trace_steps

        parse_trace_steps(args.trace_steps)  # a bad window fails before any setup

    import torch

    from glom_tpu_torch.utils.helpers import resolve_device
    from glom_tpu_torch.utils.metrics import MetricsWriter
    from glom_tpu_torch.utils.presets import get_preset

    device = resolve_device(args.device)
    preset = get_preset(args.preset)
    tcfg = preset.train
    overrides = {}
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.learning_rate is not None:
        overrides["learning_rate"] = args.learning_rate
    if args.lr_schedule is not None:
        overrides["lr_schedule"] = args.lr_schedule
        overrides["schedule_steps"] = (
            args.schedule_steps if args.schedule_steps is not None else args.steps
        )
    elif args.schedule_steps is not None or args.warmup_steps is not None:
        raise SystemExit(
            "--schedule-steps/--warmup-steps require --lr-schedule "
            "(the preset's default schedule is 'constant')"
        )
    if args.warmup_steps is not None:
        overrides["warmup_steps"] = args.warmup_steps
    if args.grad_accum is not None:
        overrides["grad_accum"] = args.grad_accum
    if args.telemetry_level is not None:
        overrides["telemetry_level"] = args.telemetry_level
    if args.nonfinite_policy is not None:
        overrides["nonfinite_policy"] = args.nonfinite_policy
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.zero_stage is not None:
        overrides["zero_stage"] = args.zero_stage
    if args.quantized_reduce:
        overrides["quantized_reduce"] = True
    if overrides:
        tcfg = dataclasses.replace(tcfg, **overrides)
    cfg = preset.model

    # The flight recorder first: even a setup failure then leaves a trail
    # of whatever telemetry preceded it. Its process hooks stay installed
    # for the process (a dump with nothing new is a no-op); the GLOBAL
    # registration is cleared on the way out, so in-process callers do not
    # keep feeding a finished run's ring.
    fr = None
    if args.flight_recorder:
        from glom_tpu_torch.tracing.flight import FlightRecorder, set_global_flight_recorder

        fr = FlightRecorder(args.flight_recorder, capacity=args.flight_events)
        fr.install_process_hooks()
        set_global_flight_recorder(fr)
    # Across ranks only rank 0 writes the metrics (RANK is torchrun's).
    rank0 = not (args.distributed or args.check_parity) or int(os.environ.get("RANK", 0)) == 0
    writer = (MetricsWriter(args.metrics_file, echo=True, tensorboard_dir=args.tensorboard)
              if rank0 else MetricsWriter(None, echo=False))
    anomaly_mode = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
    wd = None
    if args.watchdog_interval > 0:
        from glom_tpu_torch.telemetry.watchdog import BackendWatchdog, set_global_watchdog

        wd = BackendWatchdog(interval_s=args.watchdog_interval, writer=writer,
                             device_type=device.type)
        set_global_watchdog(wd)
        wd.start()
    # Everything past the heartbeat's start runs under its try/finally: a
    # setup failure must not leak a probing thread, or a stopped watchdog's
    # state, into an in-process caller.
    try:
        if args.distributed or args.check_parity:
            return _train_distributed(args, preset, cfg, tcfg, writer, device)
        return _train_body(args, cfg, tcfg, writer, device)
    finally:
        if wd is not None:
            wd.stop()
            from glom_tpu_torch.telemetry.watchdog import set_global_watchdog

            set_global_watchdog(None)
        torch.autograd.set_detect_anomaly(*anomaly_mode)
        writer.close()
        if fr is not None:
            fr.dump("run-end")
            from glom_tpu_torch.tracing.flight import set_global_flight_recorder

            set_global_flight_recorder(None)


def _train_body(args, cfg, tcfg, writer, device) -> int:
    from glom_tpu_torch.data import gaussian_dataset, shapes_dataset
    from glom_tpu_torch.train.trainer import Trainer

    if args.data_dir is not None:
        from glom_tpu_torch.data import file_dataset

        def make_data(batch_size, image_size, seed=0, start=0):
            return file_dataset(args.data_dir, batch_size, image_size, seed=seed, start=start)
    else:
        make_data = shapes_dataset if args.data == "shapes" else gaussian_dataset

    pod_coord, pod_peers = _pod_setup(args, writer)

    if args.supervise is not None:
        # The restart loop owns the trainer, data and checkpoint lifecycle
        # of each attempt (factories: a crashed attempt's state never leaks).
        from glom_tpu_torch.train.supervise import TrainSupervisor, fit_supervised

        _check_supervise(args)
        fit_supervised(
            lambda: Trainer(cfg, tcfg, metrics_writer=writer, device=device),
            lambda start: make_data(tcfg.batch_size, cfg.image_size, seed=tcfg.seed,
                                    start=start),
            args.steps,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            log_every=args.log_every,
            supervisor=TrainSupervisor(max_restarts=args.supervise, writer=writer),
            metrics_writer=writer,
            max_to_keep=args.checkpoint_keep,
            preemption_deadline_s=args.preempt_deadline,
            gang=pod_coord,
            pod_peers=pod_peers,
        )
        return 0

    trainer = Trainer(cfg, tcfg, metrics_writer=writer, device=device)

    ckpt = None
    fr_live = None
    start_step = 0
    if args.checkpoint_dir:
        from glom_tpu_torch.telemetry import schema
        from glom_tpu_torch.tracing.flight import get_global_flight_recorder
        from glom_tpu_torch.utils.checkpoint import CheckpointManager

        ckpt = CheckpointManager(
            args.checkpoint_dir, metrics_writer=writer, max_to_keep=args.checkpoint_keep,
            pod_peers=pod_peers,
        )
        epoch = None
        if pod_coord is not None and args.resume:
            # A relaunched pod reconciles together: every host is up (its old
            # lifetime's writes stopped) before any reconciles, and none
            # trains before all have, since a fast host's new steps would
            # otherwise count as common steps to a slower peer that still
            # holds its old lifetime's copies. The rounds are keyed on this
            # launch's epoch, so no earlier lifetime's arrivals fill them.
            epoch = pod_coord.launch_epoch(deadline_s=POD_RESUME_DEADLINE_S)
        if args.resume and ckpt.latest_step() is not None:
            start_step, trainer.state = ckpt.restore(
                state=trainer.state, generator=trainer.generator
            )
            # The resume IS a recovery action, stamped into the same stream.
            writer.write(schema.stamp(
                {"action": "resume-from-checkpoint", "step": int(start_step)},
                kind="recovery",
            ))
            print(f"resumed from step {start_step}", file=sys.stderr)
        if epoch is not None:
            pod_coord.gang_barrier("reconciled", epoch, deadline_s=POD_RESUME_DEADLINE_S)
        fr_live = get_global_flight_recorder()
        if fr_live is not None:
            # Preemption grace path: SIGTERM saves the live state, bounded
            # by --preempt-deadline, then dumps the flight ring (a SIGTERM
            # inside a step saves at the step's end). In a pod the save
            # rides the two-phase barrier: every host commits ONE common
            # step or the round aborts loudly.
            from glom_tpu_torch.train.supervise import preemption_hook

            fr_live.set_checkpoint_hook(
                preemption_hook(trainer, args.checkpoint_dir, metrics_writer=writer,
                                gang=pod_coord, deadline_s=args.preempt_deadline,
                                start=start_step),
                deadline_s=args.preempt_deadline)

    remaining = args.steps - start_step
    if remaining <= 0:
        print("nothing to do (already past --steps)", file=sys.stderr)
        return 0
    # The seeded stream from the first batch not trained on: the resumed run
    # is the uninterrupted one.
    data = make_data(tcfg.batch_size, cfg.image_size, seed=tcfg.seed, start=start_step)
    if args.prefetch > 0:
        # Wrap ONCE, outside the checkpoint-span loop: a per-span wrap would
        # drop its staged batches at every span boundary.
        from glom_tpu_torch.data import prefetch_to_device

        data = prefetch_to_device(
            data, size=args.prefetch, device=trainer.device, metrics_writer=writer
        )
    done = 0
    # One TraceCapture across every checkpoint span (its step counter is the
    # run's), closed in the finally so no window outlives the run.
    cap, whole = _trace_capture(args, writer)
    try:
        with whole:
            while done < remaining:
                span = min(args.checkpoint_every, remaining - done) if ckpt else remaining
                trainer.fit(data, num_steps=span, log_every=args.log_every,
                            trace_capture=cap)
                done += span
                if ckpt:
                    ckpt.save(start_step + done, trainer.state, generator=trainer.generator)
            if ckpt:
                ckpt.wait()
    finally:
        if cap is not None:
            cap.close()
        if fr_live is not None:
            fr_live.set_checkpoint_hook(None)
        if args.prefetch > 0:
            data.close()  # stop the worker; its span rollups reach the writer
    return 0


def _train_distributed(args, preset, cfg, tcfg, writer, device) -> int:
    """--distributed / --check-parity: this process is one rank."""
    import tempfile

    import torch
    import torch.distributed as dist

    from glom_tpu_torch.data import gaussian_dataset, shapes_dataset
    from glom_tpu_torch.parallel import DistributedTrainer
    from glom_tpu_torch.parallel.mesh import initialize_multihost, rank_device

    if args.data_dir is not None:
        from glom_tpu_torch.data import file_dataset

        def make_data(batch_size, image_size, seed=0, start=0):
            return file_dataset(args.data_dir, batch_size, image_size, seed=seed, start=start)
    else:
        make_data = shapes_dataset if args.data == "shapes" else gaussian_dataset

    world = int(os.environ.get("WORLD_SIZE", 1))
    # --device cuda: each rank on cuda:LOCAL_RANK; a named device: every rank there.
    devices = None if str(args.device) == "cuda" else [str(device)] * world
    store = None
    if "RANK" not in os.environ and not dist.is_initialized():
        # Launched without torch.distributed.run: one rank, whose group this
        # process brings up over a file store (glom_tpu's single host).
        store = tempfile.TemporaryDirectory(prefix="glom_dist_")
        initialize_multihost(num_processes=1, process_id=0,
                             init_method="file://" + os.path.join(store.name, "store"),
                             backend=args.dist_backend, device=rank_device(devices, rank=0))
    scaled = preset.scaled_to(world)
    mesh = scaled.mesh
    if mesh.num_devices < world:
        # More ranks than the preset's mesh: the data axis, the elastic one,
        # takes them (glom_tpu leaves the extra devices unused; a process
        # rank cannot sit out the group's collectives).
        if world % (mesh.seq * mesh.model) or tcfg.batch_size % (world // (mesh.seq * mesh.model)):
            raise SystemExit(f"{world} ranks do not fit the mesh {mesh.shape} at batch "
                             f"{tcfg.batch_size}")
        scaled = dataclasses.replace(scaled, mesh=dataclasses.replace(
            mesh, data=world // (mesh.seq * mesh.model), num_slices=1))
    print(f"mesh {scaled.mesh.shape} (axes data/seq/model), sp={scaled.sp_strategy}",
          file=sys.stderr)
    trainer = None
    try:
        if args.supervise is not None:
            return _supervise_ranks(args, cfg, tcfg, writer, scaled, devices, make_data)
        trainer = DistributedTrainer(
            cfg, tcfg, scaled.mesh, sp_strategy=scaled.sp_strategy, metrics_writer=writer,
            devices=devices, backend=args.dist_backend,
        )
        return _run_ranks(args, cfg, tcfg, writer, trainer, make_data)
    finally:
        if trainer is not None and trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        if dist.is_initialized():
            dist.destroy_process_group()
        if store is not None:
            store.cleanup()


def _supervise_ranks(args, cfg, tcfg, writer, scaled, devices, make_data) -> int:
    """--distributed --supervise: this rank is gang member `rank` over a
    StoreTransport on the process group's store. Rank 0 writes the one
    global-state copy in --checkpoint-dir, which every rank restores. Each
    attempt builds its DistributedTrainer (and so its rank mesh, on groups
    of its own) after the restart barrier."""
    import torch.distributed as dist

    from glom_tpu_torch.parallel import DistributedTrainer, mesh
    from glom_tpu_torch.parallel.mesh import initialize_multihost, rank_device
    from glom_tpu_torch.resilience.coordinator import PodCoordinator, StoreTransport
    from glom_tpu_torch.train.supervise import TrainSupervisor, fit_supervised

    _check_supervise(args)
    # Under torch.distributed.run the group comes up here, before the gang's
    # store is taken from it (a trainer would bring it up itself).
    initialize_multihost(backend=args.dist_backend, device=rank_device(devices))
    rank, world = dist.get_rank(), dist.get_world_size()
    # A relaunch under the same torch.distributed.run agent reuses its
    # store: the restart count keeps each launch's rounds apart.
    store = dist.PrefixStore(
        f"glom-gang/{os.environ.get('TORCHELASTIC_RESTART_COUNT', '0')}/",
        dist.distributed_c10d._get_default_store())
    gang = PodCoordinator(StoreTransport(store, rank, world), writer=writer)

    def make_trainer():
        return DistributedTrainer(
            cfg, tcfg, scaled.mesh, sp_strategy=scaled.sp_strategy, metrics_writer=writer,
            devices=devices, backend=args.dist_backend,
        )

    fit_supervised(
        make_trainer,
        lambda start: make_data(tcfg.batch_size, cfg.image_size, seed=tcfg.seed, start=start),
        args.steps,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        log_every=args.log_every,
        supervisor=TrainSupervisor(max_restarts=args.supervise, writer=writer),
        metrics_writer=writer,
        max_to_keep=args.checkpoint_keep,
        preemption_deadline_s=args.preempt_deadline,
        gang=gang,
        # A member that failed waits here for peers still held in a
        # collective until its timeout.
        gang_barrier_deadline_s=mesh.GROUP_TIMEOUT_S + 60.0,
    )
    return 0


def _run_ranks(args, cfg, tcfg, writer, trainer, make_data) -> int:
    import torch.distributed as dist

    from glom_tpu_torch.train.trainer import Trainer

    rank = dist.get_rank()
    if args.check_parity:
        data = make_data(tcfg.batch_size, cfg.image_size, seed=tcfg.seed)
        h2 = trainer.fit(data, num_steps=args.steps, log_every=args.log_every)
        worst = [None]
        if rank == 0:
            single = Trainer(cfg, tcfg, device=trainer.device)
            h1 = single.fit(make_data(tcfg.batch_size, cfg.image_size, seed=tcfg.seed),
                            num_steps=args.steps, log_every=args.log_every)
            worst[0] = max(abs(a["loss"] - b["loss"]) / max(abs(a["loss"]), 1e-9)
                           for a, b in zip(h1, h2))
            print(f"parity: worst relative loss deviation = {worst[0]:.2e}")
        dist.broadcast_object_list(worst, src=0)
        return 0 if worst[0] < 1e-2 else 1

    ckpt = None
    start_step = 0
    if args.checkpoint_dir:
        from glom_tpu_torch.telemetry import schema
        from glom_tpu_torch.utils.checkpoint import CheckpointManager

        if rank == 0:
            ckpt = CheckpointManager(args.checkpoint_dir, metrics_writer=writer,
                                     max_to_keep=args.checkpoint_keep)
        if args.resume:
            restored = trainer.restore_checkpoint(args.checkpoint_dir, manager=ckpt)
            if restored is not None:
                start_step = restored
                writer.write(schema.stamp(
                    {"action": "resume-from-checkpoint", "step": int(start_step)},
                    kind="recovery",
                ))
                print(f"resumed from step {start_step}", file=sys.stderr)
    remaining = args.steps - start_step
    if remaining <= 0:
        print("nothing to do (already past --steps)", file=sys.stderr)
        return 0
    data = make_data(tcfg.batch_size, cfg.image_size, seed=tcfg.seed, start=start_step)
    if args.prefetch > 0:
        from glom_tpu_torch.data import prefetch_to_device

        data = prefetch_to_device(data, size=args.prefetch, device=trainer.device,
                                  metrics_writer=writer if rank == 0 else None)
    done = 0
    cap, whole = _trace_capture(args, writer)
    try:
        with whole:
            while done < remaining:
                span = (min(args.checkpoint_every, remaining - done) if args.checkpoint_dir
                        else remaining)
                trainer.fit(data, num_steps=span, log_every=args.log_every,
                            trace_capture=cap)
                done += span
                if args.checkpoint_dir:
                    trainer.save_checkpoint(ckpt, start_step + done)
            if ckpt:
                ckpt.wait()
    finally:
        if cap is not None:
            cap.close()
        if args.prefetch > 0:
            data.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
