"""Command-line trainer: `python -m glom_tpu_torch.train.cli --preset cifar10 ...`

Counterpart of `glom_tpu/train/cli.py`, on one device: presets, the JSONL
metrics stream, manifest-verified checkpoints and resume, the restart
supervisor (`--supervise`) and the crash flight recorder. The flags are
glom_tpu's, plus `--device` (default `cuda`; `cpu` runs the kernels' plain
versions, as the tests do). Without a card and without `--device cpu` it
raises: it never falls back to the CPU.

Flags whose machinery is not ported raise NotImplementedError naming the
ROADMAP queue A item that brings it: the parallel paths (`--distributed`,
`--check-parity`, `--zero-stage` 1 or 2, `--quantized-reduce`; item 8),
the pod coordinator and the backend watchdog (`--pod-*`,
`--watchdog-interval`; item 9), and trace capture (`--profile-dir`,
`--trace-steps`, `--telemetry-level full`; item 9).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

_NOT_PORTED = "{} is not ported yet: ROADMAP queue A item {}"


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
        help="ZeRO sharded weight update (1 and 2: not ported, ROADMAP item 8)",
    )
    p.add_argument(
        "--quantized-reduce", action="store_true",
        help="int8 block-scaled quantized reduce (not ported, ROADMAP item 8)",
    )
    p.add_argument(
        "--telemetry-level", choices=["off", "scalars", "full"], default=None,
        help="diagnostics depth: scalars = grad/update/param norms + the "
        "NaN/Inf guard in the step; full (per-level agreement) is not "
        "ported (ROADMAP item 9)",
    )
    p.add_argument(
        "--nonfinite-policy", choices=["skip", "warn"], default=None,
        help="what the NaN/Inf guard does (telemetry on): skip drops the "
        "poisoned update, warn applies it and flags the record",
    )
    p.add_argument(
        "--watchdog-interval", type=float, default=0.0, metavar="SECONDS",
        help="backend-liveness heartbeat (not ported, ROADMAP item 9; 0 = off)",
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
    p.add_argument("--pod-index", type=int, default=None, metavar="I",
                   help="pod coordination (not ported, ROADMAP item 9)")
    p.add_argument("--pod-count", type=int, default=None, metavar="N",
                   help="pod coordination (not ported, ROADMAP item 9)")
    p.add_argument("--pod-dir", default=None, metavar="DIR",
                   help="pod coordination (not ported, ROADMAP item 9)")
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
                   help="whole-run profiler trace (not ported, ROADMAP item 9)")
    p.add_argument("--trace-steps", default=None, metavar="A:B",
                   help="step-windowed profiler trace (not ported, ROADMAP item 9)")
    p.add_argument("--trace-dir", default="/tmp/glom_tpu_trace", metavar="DIR",
                   help="where --trace-steps writes its trace")
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
                   help="the preset's mesh (not ported, ROADMAP item 8)")
    p.add_argument("--check-parity", action="store_true",
                   help="sharded vs single-device losses (not ported, ROADMAP item 8)")
    p.add_argument(
        "--debug-nans", action="store_true",
        help="torch.autograd anomaly detection with NaN checks in the backward",
    )
    return p


def _refuse_unported(args) -> None:
    """Flags whose machinery is not ported: raise, never fall back."""
    refusals = (
        ("--distributed", args.distributed, 8),
        ("--check-parity", args.check_parity, 8),
        ("--zero-stage 1 and 2", bool(args.zero_stage), 8),
        ("--quantized-reduce", args.quantized_reduce, 8),
        ("--pod-index/--pod-count/--pod-dir",
         any(a is not None for a in (args.pod_index, args.pod_count, args.pod_dir)), 9),
        ("--watchdog-interval", args.watchdog_interval > 0, 9),
        ("--profile-dir", args.profile_dir is not None, 9),
        ("--trace-steps", args.trace_steps is not None, 9),
        ("--telemetry-level full", args.telemetry_level == "full", 9),
    )
    for flag, asked, item in refusals:
        if asked:
            raise NotImplementedError(_NOT_PORTED.format(flag, item))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

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
    writer = MetricsWriter(args.metrics_file, echo=True, tensorboard_dir=args.tensorboard)
    anomaly_mode = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        return _train_body(args, cfg, tcfg, writer, device)
    finally:
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

        def make_data(batch_size, image_size, seed=0):
            return file_dataset(args.data_dir, batch_size, image_size, seed=seed)
    else:
        make_data = shapes_dataset if args.data == "shapes" else gaussian_dataset

    if args.supervise is not None:
        # The restart loop owns the trainer, data and checkpoint lifecycle
        # of each attempt (factories: a crashed attempt's state never leaks).
        from glom_tpu_torch.train.supervise import TrainSupervisor, fit_supervised

        if not args.checkpoint_dir:
            raise SystemExit("--supervise requires --checkpoint-dir (the "
                             "restart loop resumes from checkpoints)")
        if args.prefetch > 0:
            print("note: --prefetch is ignored under --supervise (the data "
                  "stream is rebuilt per attempt)", file=sys.stderr)
        fit_supervised(
            lambda: Trainer(cfg, tcfg, metrics_writer=writer, device=device),
            lambda: make_data(tcfg.batch_size, cfg.image_size, seed=tcfg.seed),
            args.steps,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            log_every=args.log_every,
            supervisor=TrainSupervisor(max_restarts=args.supervise, writer=writer),
            metrics_writer=writer,
            max_to_keep=args.checkpoint_keep,
            preemption_deadline_s=args.preempt_deadline,
        )
        return 0

    data = make_data(tcfg.batch_size, cfg.image_size, seed=tcfg.seed)
    trainer = Trainer(cfg, tcfg, metrics_writer=writer, device=device)

    ckpt = None
    fr_live = None
    start_step = 0
    if args.checkpoint_dir:
        from glom_tpu_torch.telemetry import schema
        from glom_tpu_torch.tracing.flight import get_global_flight_recorder
        from glom_tpu_torch.utils.checkpoint import CheckpointManager, preemption_save

        ckpt = CheckpointManager(
            args.checkpoint_dir, metrics_writer=writer, max_to_keep=args.checkpoint_keep
        )
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
        fr_live = get_global_flight_recorder()
        if fr_live is not None:
            # Preemption grace path: SIGTERM saves the live state, bounded
            # by --preempt-deadline, then dumps the flight ring.
            def _preempt_save(trainer=trainer):
                if trainer.in_step:
                    raise RuntimeError(
                        "SIGTERM landed inside an optimizer step: no "
                        "consistent state to save"
                    )
                return preemption_save(
                    args.checkpoint_dir, trainer.state, int(trainer.state.step),
                    generator=trainer.generator, metrics_writer=writer,
                )

            fr_live.set_checkpoint_hook(_preempt_save, deadline_s=args.preempt_deadline)

    remaining = args.steps - start_step
    if remaining <= 0:
        print("nothing to do (already past --steps)", file=sys.stderr)
        return 0
    if args.prefetch > 0:
        # Wrap ONCE, outside the checkpoint-span loop: a per-span wrap would
        # drop its staged batches at every span boundary.
        from glom_tpu_torch.data import prefetch_to_device

        data = prefetch_to_device(
            data, size=args.prefetch, device=trainer.device, metrics_writer=writer
        )
    done = 0
    try:
        while done < remaining:
            span = min(args.checkpoint_every, remaining - done) if ckpt else remaining
            trainer.fit(data, num_steps=span, log_every=args.log_every)
            done += span
            if ckpt:
                ckpt.save(start_step + done, trainer.state, generator=trainer.generator)
        if ckpt:
            ckpt.wait()
    finally:
        if fr_live is not None:
            fr_live.set_checkpoint_hook(None)
        if args.prefetch > 0:
            data.close()  # stop the worker; its span rollups reach the writer
    return 0

if __name__ == "__main__":
    sys.exit(main())
