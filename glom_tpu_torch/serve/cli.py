"""`python -m glom_tpu_torch.serve`: the stdin/file micro-server.

Counterpart of `glom_tpu/serve/cli.py`: the operational harness that drives
the serving stack (warmup, admission, early exit, continuation hops, the
ladder, the session column cache, failover and rejoin, and the elastic
fleet with its autoscaler, warm-pool spares and load forecast) from a
shell.
Requests come from `--synthetic N` (seeded gaussian images), `--requests
FILE|-` (JSON lines `{"id": ..., "seed": ...}`), `--ramp N1xG1,...`
(offered-load phases) or `--replay FILE` (a workload artifact). Every
response, dispatch, warmup and shed lands as a stamped record in the
metrics stream, which lints with `python -m glom_tpu_torch.telemetry FILE`.

The flags and exit codes are glom_tpu's, plus `--device` (default `cuda`;
`cpu` runs the kernels' plain versions, as the tests do). Without a card
and without `--device cpu` it raises: it never falls back to the CPU.
Params come from the port's `init_glom` with a `torch.Generator` seeded 0.
With `--elastic` the fleet starts at `--min-engines` and every replica the
autoscaler spawns is built on `--device` (on one card the replicas share
it).

The serve mesh (`--mesh-data D`, `--mesh-seq S`) runs each engine on a
group of D x S ranks: launch `python -m torch.distributed.run
--nproc-per-node N -m glom_tpu_torch.serve ...` with N a multiple of D x S
(`--engines` groups, `parallel/runtime.make_engine_meshes`). The process
of global rank 0 holds every engine (it computes engine 0's first band and
dispatches to the other groups), runs the batcher and writes the metrics
stream; every other rank of a group follows its engine
(serve/mesh_follower.run_follower) and exits 0 when rank 0 stops it. Each
rank runs on cuda:LOCAL_RANK for `--device cuda`, or on the named device
(ranks sharing one card: `--device cuda:0 --dist-backend gloo`).
With `--elastic` on a mesh every group the world holds is built at start
and the fleet grows and shrinks over them (serve/elastic.RankGroupFleet): a
spawn takes the first waiting group, a release gives it back, and the
followers of a waiting group wait on the store, outside any collective,
until rank 0 builds an engine there or ends the run.

Exit codes: 0 when every request was served, 1 when any failed or was
shed (or none was served), 2 for a bad command line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Iterable, Tuple

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m glom_tpu_torch.serve",
        description="GLOM batched-inference micro-server (docs/SERVING.md)",
    )
    p.add_argument("--preset", default="mnist", help="see glom_tpu_torch.utils.presets")
    p.add_argument(
        "--device", default="cuda",
        help="torch device of every engine (default cuda; cpu runs the "
        "kernels' plain versions)",
    )
    p.add_argument(
        "--synthetic", type=int, default=None, metavar="N",
        help="serve N seeded synthetic requests (the reproducible load)",
    )
    p.add_argument(
        "--requests", default=None, metavar="FILE",
        help="JSONL request source ('-' = stdin): {\"id\":..., \"seed\":...}",
    )
    p.add_argument(
        "--iters", default=None,
        help="forward iteration budget: an int, or 'auto' for consensus "
        "early exit (serve/early_exit)",
    )
    p.add_argument(
        "--exit-threshold", type=float, default=None, metavar="D",
        help="iters=auto: exit once no level's agreement moves more than D "
        "between iterations (0 disables the exit — full budget always runs)",
    )
    p.add_argument("--max-batch", type=int, default=None)
    p.add_argument("--max-delay-ms", type=float, default=None)
    p.add_argument("--queue-depth", type=int, default=None)
    p.add_argument(
        "--buckets", default=None, metavar="B1,B2,...",
        help="ascending batch buckets to warm up (default: preset's)",
    )
    p.add_argument(
        "--no-warmup", action="store_true",
        help="skip the warmup (each signature's first dispatch then pays "
        "its kernel builds and allocations mid-traffic; for A/B only)",
    )
    p.add_argument(
        "--ladder", action="store_true",
        help="enable the degradation ladder (resilience/ladder.py): "
        "under queue pressure or a flapping backend, step down capped-iters "
        "-> capped-buckets -> shed instead of shedding outright "
        "(docs/RESILIENCE.md; one ladder per engine)",
    )
    p.add_argument(
        "--engines", type=int, default=1, metavar="N",
        help="multi-engine fan-out: N InferenceEngines (shared params) "
        "behind one shared-admission batcher, one worker per engine; a "
        "failing engine's batches re-dispatch to its siblings",
    )
    p.add_argument(
        "--mesh-data", type=int, default=None, metavar="D",
        help="serve mesh: shard every bucket's batch rows over a D-way "
        "'data' axis (parallel/serve_mesh.py; buckets must divide by D)",
    )
    p.add_argument(
        "--mesh-seq", type=int, default=None, metavar="S",
        help="serve mesh: shard the patch axis over an S-way 'seq' axis",
    )
    p.add_argument(
        "--dist-backend", choices=["nccl", "gloo"], default=None,
        help="torch.distributed backend of the serve mesh (default nccl on a card, "
        "gloo on the CPU; ranks sharing one card need gloo)",
    )
    p.add_argument(
        "--quorum", type=float, default=None, metavar="Q",
        help="iters=auto: exit the bucket once ceil(Q * n_valid) valid "
        "rows have individually converged (two-tier early exit; 1.0 = all)",
    )
    p.add_argument(
        "--max-continuations", type=int, default=None, metavar="M",
        help="re-bucket unconverged stragglers (warm state, remaining "
        "budget) up to M hops through the continuation queue; 0 disables",
    )
    p.add_argument(
        "--kill-engine", default=None, metavar="IDX:after=K[,until=M]",
        help="CHAOS: fail engine IDX's dispatches from its K-th call on "
        "(a seeded FaultPlan dispatch_fault — every injection a stamped "
        "'fault' event), so the kill-serve scenario can validate failover "
        "from the evidence trail (docs/RESILIENCE.md). ',until=M' bounds "
        "the fault window — calls from M on succeed again, the recovered-"
        "replica shape the rejoin-serve scenario drives",
    )
    p.add_argument(
        "--rejoin", type=int, default=None, metavar="N",
        help="re-admit a dead engine after N consecutive successful "
        "probation health dispatches (stamped engine_rejoin; "
        "docs/RESILIENCE.md). Default: preset's rejoin_threshold (0 = "
        "death stays terminal)",
    )
    p.add_argument(
        "--rejoin-interval-ms", type=float, default=None, metavar="MS",
        help="pace the probation health dispatches (default: preset's)",
    )
    p.add_argument(
        "--streams", type=int, default=None, metavar="S",
        help="synthetic mode: spread requests over S temporal STREAMS — "
        "each request is a perturbed frame of its stream's base image and "
        "carries session id 's<k>', so the warm-start column cache "
        "(--column-cache-bytes) serves frame t+1 from frame t's converged "
        "columns (docs/SERVING.md, Streaming)",
    )
    p.add_argument(
        "--column-cache-bytes", type=int, default=None, metavar="B",
        help="session column-cache HBM budget in bytes (LRU eviction; "
        "0 disables streaming warm-start). Default: preset's",
    )
    p.add_argument(
        "--column-cache-ttl", type=float, default=None, metavar="S",
        help="expire a quiet stream's cached columns after S seconds",
    )
    p.add_argument(
        "--request-gap-ms", type=float, default=0.0, metavar="G",
        help="pace request submission G ms apart (0 = submit as fast as "
        "admission allows) — chaos scenarios use it to keep traffic "
        "flowing across a fault window",
    )
    p.add_argument(
        "--dispatch-retries", type=int, default=None, metavar="N",
        help="transient dispatch failures retry up to N times with backoff "
        "(watchdog-aware: a DOWN backend never retries; default: preset's)",
    )
    p.add_argument("--out", default=None, help="JSONL metrics path")
    p.add_argument(
        "--flight-recorder", default=None, metavar="DIR",
        help="crash flight recorder over the serve event stream",
    )
    p.add_argument(
        "--elastic", action="store_true",
        help="SLO-driven elastic serving (serve/elastic.py): run the "
        "Autoscaler control loop — scale OUT builds and warms an engine "
        "replica on --device at runtime (admission opens only after its "
        "warmup), scale IN gracefully drains the least-loaded engine "
        "(migrate cache sessions, release its device memory). The fleet "
        "starts at --min-engines; --engines is ignored",
    )
    p.add_argument(
        "--min-engines", type=int, default=None, metavar="N",
        help="elastic: the fleet never drains below N (default preset's)",
    )
    p.add_argument(
        "--max-engines", type=int, default=None, metavar="N",
        help="elastic: the fleet never grows past N (default preset's)",
    )
    p.add_argument(
        "--elastic-low-water", type=float, default=None, metavar="H",
        help="scale OUT when worst eligible headroom sits below H for "
        "the dwell (default preset's)",
    )
    p.add_argument(
        "--elastic-high-water", type=float, default=None, metavar="H",
        help="scale IN when worst eligible headroom sits above H for "
        "the dwell (default preset's)",
    )
    p.add_argument(
        "--elastic-dwell", type=float, default=None, metavar="S",
        help="min-dwell hysteresis: a water-mark condition must hold "
        "continuously this long before it may act",
    )
    p.add_argument(
        "--elastic-cooldown", type=float, default=None, metavar="S",
        help="post-action cooldown before the next decision",
    )
    p.add_argument(
        "--elastic-interval", type=float, default=None, metavar="S",
        help="control-tick cadence (capacity records are emitted live "
        "each tick)",
    )
    p.add_argument(
        "--elastic-window", type=float, default=None, metavar="S",
        help="signal window shared by the policy and its SLO monitor "
        "(breaches age out of it; shorter = faster post-spike recovery)",
    )
    p.add_argument(
        "--elastic-p99-ms", type=float, default=None, metavar="MS",
        help="arm the in-process SLO monitor's p99 rule: a windowed "
        "breach forces scale-out and vetoes scale-in",
    )
    p.add_argument(
        "--elastic-shed-rate", type=float, default=None, metavar="R",
        help="arm the shed-rate SLO rule (same precedence as p99)",
    )
    p.add_argument(
        "--elastic-settle", type=float, default=0.0, metavar="S",
        help="after the last ticket resolves, keep the loop running up "
        "to S seconds or until a scale-in lands — the ramp scenario's "
        "deterministic window for the post-spike drain",
    )
    p.add_argument(
        "--ramp", default=None, metavar="N1xG1,N2xG2,...",
        help="offered-load RAMP traffic instead of --synthetic: each "
        "phase submits N seeded synthetic requests paced G ms apart "
        "(e.g. '6x120,48x0,10x150' = low, spike, low) — the chaos "
        "ramp-serve scenario's traffic shape (docs/RESILIENCE.md)",
    )
    p.add_argument(
        "--replay", default=None, metavar="FILE",
        help="replay a recorded workload artifact (serve/workload.py, "
        "docs/SERVING.md 'Record and replay'): re-offer its requests "
        "with faithful inter-arrival pacing and session structure — "
        "the fourth traffic source, exclusive with the others",
    )
    p.add_argument(
        "--replay-time-scale", type=float, default=1.0, metavar="X",
        help="stretch (>1) or compress (<1) the replayed inter-arrival "
        "gaps (1.0 = as recorded)",
    )
    p.add_argument(
        "--record-workload", default=None, metavar="FILE",
        help="record this run's offered traffic as a schema-v9 workload "
        "artifact (arrival time, shape signature, session, outcome) — "
        "replayable later with --replay",
    )
    p.add_argument(
        "--forecast", action="store_true",
        help="emit scored short-horizon 'forecast' records over the "
        "live arrival rate plus a spawn-lead-time model "
        "(telemetry/forecast.py): every window stamps "
        "predicted-vs-realized forecast_abs_err",
    )
    p.add_argument(
        "--elastic-anticipatory", action="store_true",
        help="elastic: act on PREDICTED load at now + spawn lead time "
        "instead of waiting for live breaches — the policy consumes the "
        "forecaster's latest scored window plus the spawn-lead-time "
        "quantile, and every decision is stamped as a schema-v10 "
        "'decision' record carrying its full evidence bundle "
        "(auditable with `python -m glom_tpu_torch.telemetry audit`). "
        "Implies --forecast",
    )
    p.add_argument(
        "--elastic-target-utilization", type=float, default=None,
        metavar="U",
        help="anticipatory: scale out when predicted arrival rate "
        "exceeds U * fleet service rate (0 < U <= 1; default preset's)",
    )
    p.add_argument(
        "--warm-pool", type=int, default=None, metavar="N",
        help="elastic: hold N pre-spawned, warmed spare engines "
        "OUTSIDE admission; scale-out promotes a spare (milliseconds) "
        "instead of paying a cold spawn, scale-in demotes the drained "
        "engine back into the pool. Every promotion/demotion is stamped "
        "with its owning decision_id",
    )
    p.add_argument(
        "--slo-class", action="append", default=None, metavar="SPEC",
        dest="slo_class",
        help="declare one SLO class (repeatable): "
        "'name:weight=W,p99_ms=MS,shed_rate=R,queue_depth=N' — e.g. "
        "--slo-class premium:weight=8,p99_ms=150 --slo-class batch:"
        "weight=1. Declaring classes arms the weighted-fair admission "
        "scheduler, class-aware degradation/shed, and per-class "
        "telemetry (serve/qos.py, docs/SERVING.md 'SLO classes')",
    )
    p.add_argument(
        "--slo-default-class", default=None, metavar="NAME",
        help="class for unclassed submits (default: 'standard' when "
        "declared, else the highest-weight class)",
    )
    p.add_argument(
        "--slo-shed-order", default=None, metavar="C1,C2,...",
        help="override the shed order (first = first to shed/degrade; "
        "must be a permutation of the declared classes; default: "
        "ascending weight)",
    )
    p.add_argument(
        "--slo-starvation-floor", type=float, default=None, metavar="F",
        help="guaranteed served fraction per non-top class under strict "
        "priority (default 0.05): each backlogged lower class banks F "
        "credit per pick and preempts at a whole owed pick",
    )
    p.add_argument(
        "--husk-max", type=int, default=None, metavar="N",
        help="elastic: retain at most N drained-engine evidence husks "
        "in the summary (oldest retire into a stamped "
        "engine_husk_retired record; default: retain all)",
    )
    p.add_argument(
        "--husk-max-age", type=float, default=None, metavar="S",
        help="elastic: retire a drained husk S seconds after its drain "
        "(default: retain forever)",
    )
    return p


def parse_ramp(spec: str):
    """'6x120,48x0,10x150' -> [(6, 0.12), (48, 0.0), (10, 0.15)] —
    (requests, per-request gap seconds) per phase. Loud on malformed
    phases (a typo'd ramp that silently serves nothing is worse than
    none)."""
    phases = []
    for part in spec.split(","):
        n_s, sep, gap_s = part.partition("x")
        if not sep:
            raise ValueError(
                f"--ramp phase {part!r}: expected NxGAP_MS"
            )
        n, gap = int(n_s), float(gap_s)
        if n < 1 or gap < 0:
            raise ValueError(
                f"--ramp phase {part!r}: need N >= 1 and GAP_MS >= 0"
            )
        phases.append((n, gap / 1e3))
    if not phases:
        raise ValueError(f"--ramp {spec!r}: no phases")
    return phases


def _req_source(args) -> Iterable[Tuple[object, int, object]]:
    """(request id, seed, session id) triples from --synthetic or
    --requests. Synthetic with --streams S deals requests round-robin
    over S sessions ('s0'..'s{S-1}'); request files carry an optional
    "session" field per line."""
    if args.synthetic is not None:
        streams = args.streams or 0
        for i in range(args.synthetic):
            session = f"s{i % streams}" if streams > 0 else None
            yield i, i, session
        return
    fh = sys.stdin if args.requests == "-" else open(args.requests)
    try:
        for line in fh:
            line = line.strip()
            if not line or not line.startswith("{"):
                continue
            rec = json.loads(line)
            yield rec.get("id"), int(rec.get("seed", 0)), rec.get("session")
    finally:
        if fh is not sys.stdin:
            fh.close()


def _overrides(args) -> dict:
    """ServeConfig fields the command line sets over the preset's."""
    out = {}
    if args.iters is not None:
        out["iters"] = "auto" if args.iters == "auto" else int(args.iters)
    for flag, field in (
        ("exit_threshold", "exit_threshold"),
        ("max_batch", "max_batch"),
        ("max_delay_ms", "max_delay_ms"),
        ("queue_depth", "queue_depth"),
        ("dispatch_retries", "dispatch_retries"),
        ("mesh_data", "mesh_data"),
        ("mesh_seq", "mesh_seq"),
        ("quorum", "exit_quorum"),
        ("max_continuations", "max_continuations"),
        ("rejoin", "rejoin_threshold"),
        ("rejoin_interval_ms", "rejoin_interval_ms"),
        ("column_cache_bytes", "column_cache_bytes"),
        ("column_cache_ttl", "column_cache_ttl_s"),
        ("slo_default_class", "slo_default_class"),
        ("slo_starvation_floor", "slo_starvation_floor"),
        ("min_engines", "min_engines"),
        ("max_engines", "max_engines"),
        ("elastic_low_water", "elastic_low_water"),
        ("elastic_high_water", "elastic_high_water"),
        ("elastic_dwell", "elastic_dwell_s"),
        ("elastic_cooldown", "elastic_cooldown_s"),
        ("elastic_interval", "elastic_interval_s"),
        ("elastic_window", "elastic_window_s"),
        ("elastic_p99_ms", "elastic_p99_ms"),
        ("elastic_shed_rate", "elastic_shed_rate"),
        ("husk_max", "husk_max"),
        ("husk_max_age", "husk_max_age_s"),
        ("elastic_target_utilization", "elastic_target_utilization"),
        ("warm_pool", "warm_pool"),
    ):
        v = getattr(args, flag)
        if v is not None:
            out[field] = v
    if args.elastic:
        out["elastic"] = True
    if args.elastic_anticipatory:
        out["elastic_anticipatory"] = True
    if args.buckets is not None:
        out["buckets"] = tuple(int(b) for b in args.buckets.split(",") if b)
    if args.ladder:
        out["ladder"] = True
    if args.slo_class:
        out["slo_classes"] = tuple(args.slo_class)
    if args.slo_shed_order is not None:
        out["slo_shed_order"] = tuple(
            c.strip() for c in args.slo_shed_order.split(",") if c.strip()
        )
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    n_sources = sum(
        x is not None
        for x in (args.synthetic, args.requests, args.ramp, args.replay)
    )
    if n_sources != 1:
        print(
            "exactly one of --synthetic N, --requests FILE, "
            "--ramp N1xG1,..., or --replay FILE required",
            file=sys.stderr,
        )
        return 2
    ramp_phases = None
    if args.ramp is not None:
        try:
            ramp_phases = parse_ramp(args.ramp)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
    replay_records = None
    if args.replay is not None:
        # Loud before the engines spend a warmup: an unreadable or empty
        # artifact is an argv error, not a mid-run surprise.
        from glom_tpu_torch.serve.workload import load_workload

        try:
            replay_records = load_workload(args.replay)
        except (OSError, ValueError) as e:
            print(str(e), file=sys.stderr)
            return 2

    from glom_tpu_torch.utils.helpers import resolve_device
    from glom_tpu_torch.utils.presets import get_preset

    device = resolve_device(args.device)
    preset = get_preset(args.preset)
    cfg = preset.model
    scfg = preset.serve
    overrides = _overrides(args)
    if overrides:
        try:
            scfg = dataclasses.replace(scfg, **overrides)
        except ValueError as e:  # e.g. a bucket --mesh-data does not divide
            print(str(e), file=sys.stderr)
            return 2
    if args.engines < 1:
        print("--engines must be >= 1", file=sys.stderr)
        return 2
    n_init = scfg.min_engines if scfg.elastic else args.engines
    if args.kill_engine is not None and not 0 <= int(args.kill_engine.partition(":")[0]) < n_init:
        # Before any follower starts waiting for its engine.
        print(f"--kill-engine index outside 0..{n_init - 1}", file=sys.stderr)
        return 2
    meshes, created, groups = None, False, None
    if scfg.mesh_data > 1 or scfg.mesh_seq > 1:
        got = _mesh_ranks(args, scfg, device)
        if isinstance(got, int):
            return got
        meshes, device, created = got
        if scfg.elastic:
            from glom_tpu_torch.serve.elastic import fleet_store

            groups = fleet_store(meshes)
    try:
        if meshes is not None and _follow(meshes, device, groups):
            return 0
        return _main_leader(args, cfg, scfg, device, ramp_phases, replay_records, meshes,
                            groups)
    finally:
        if created:
            import torch.distributed as dist

            dist.destroy_process_group()


def _mesh_ranks(args, scfg, device):
    """The serve mesh's ranks: (one ServeMesh an engine, this rank's device,
    whether this call brought the process group up), or an exit code."""
    import torch.distributed as dist

    from glom_tpu_torch.parallel.mesh import initialize_multihost, rank_device
    from glom_tpu_torch.parallel.runtime import make_engine_meshes

    # --device cuda: each rank on cuda:LOCAL_RANK; a named device: every rank there.
    if str(args.device) == "cuda":
        device = rank_device()
    created = initialize_multihost(backend=args.dist_backend, device=device)
    per = scfg.mesh_data * scfg.mesh_seq
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = scfg.min_engines if scfg.elastic else args.engines
    if world < n * per:
        print(f"{n} engine(s) of a {scfg.mesh_data} x {scfg.mesh_seq} serve mesh need "
              f"{n * per} ranks, the world has {world}: launch under python -m "
              f"torch.distributed.run --nproc-per-node {n * per}", file=sys.stderr)
        return 2
    # An elastic fleet builds every group the world holds.
    return make_engine_meshes(scfg, None if scfg.elastic else n, leader=0), device, created


def _follow(meshes, device, groups=None) -> bool:
    """On a rank other than global rank 0: follow this rank's engine until
    rank 0 stops it (an elastic fleet's group: every engine rank 0 builds on
    it, until the run ends), and return True; False on rank 0."""
    import torch.distributed as dist

    from glom_tpu_torch.serve.mesh_follower import follow_engines, group_prefix, run_follower

    if dist.get_rank() == 0:
        return False
    for index, mesh in enumerate(meshes):
        if mesh.is_member:
            if groups is None:
                run_follower(mesh, device)
            else:
                store, prefix = groups
                follow_engines(mesh, device, store, group_prefix(prefix, index))
    return True


def _main_leader(args, cfg, scfg, device, ramp_phases, replay_records, meshes,
                 groups=None) -> int:
    """The serving process (global rank 0 on a mesh): the metrics stream,
    the engines, the batcher."""
    from glom_tpu_torch.utils.metrics import MetricsWriter

    writer = MetricsWriter(args.out, echo=True)
    fr = None
    if args.flight_recorder:
        from glom_tpu_torch.tracing.flight import FlightRecorder, set_global_flight_recorder

        fr = FlightRecorder(args.flight_recorder)
        fr.install_process_hooks()
        set_global_flight_recorder(fr)
    try:
        return _serve(args, cfg, scfg, device, writer, ramp_phases, replay_records, meshes,
                      groups)
    finally:
        writer.close()
        if fr is not None:
            fr.dump("run-end")
            from glom_tpu_torch.tracing.flight import set_global_flight_recorder

            set_global_flight_recorder(None)


def _serve(args, cfg, scfg, device, writer, ramp_phases, replay_records, meshes=None,
           groups=None) -> int:
    import torch

    from glom_tpu_torch.models.core import init_glom
    from glom_tpu_torch.serve.engine import InferenceEngine

    fleet = None
    if groups is not None:
        from glom_tpu_torch.serve.elastic import RankGroupFleet

        fleet = RankGroupFleet(meshes, *groups, writer=writer)

    # One params init shared by every engine replica (fan-out serves one
    # model), from a seeded generator.
    params = init_glom(cfg, generator=torch.Generator().manual_seed(0))
    # Elastic mode starts at the policy floor (--engines is the static
    # fleet size); scale-out spawns the rest at runtime.
    n_init = scfg.min_engines if scfg.elastic else args.engines
    kill_idx, kill_plan = None, None
    if args.kill_engine is not None:
        # "IDX:after=K[,until=M]": engine IDX's dispatch hook raises on
        # every attempt from call K on (until call M), each injection a
        # stamped "fault" record.
        from glom_tpu_torch.resilience.faults import FaultPlan, dispatch_fault

        idx_s, _, window = args.kill_engine.partition(":after=")
        kill_idx = int(idx_s)
        if not 0 <= kill_idx < n_init:
            print(f"--kill-engine index {kill_idx} outside 0..{n_init - 1}", file=sys.stderr)
            return 2
        after_s, _, until_s = window.partition(",until=")
        kill_plan = FaultPlan(writer=writer)
        kill_plan.register(
            f"engine{kill_idx}-dispatch",
            rate=1.0,
            start=int(after_s or 0),
            stop=int(until_s) if until_s else None,
            fault="engine-dead",
        )
    # Every engine built (the autoscaler's spawns and spares too), closed at
    # the end.
    engines = []
    try:
        for i in range(n_init):
            hook = None
            if kill_plan is not None and i == kill_idx:
                hook = dispatch_fault(kill_plan, f"engine{i}-dispatch")
            def make(mesh, i=i, hook=hook):
                return InferenceEngine(cfg, scfg, params=params, writer=writer,
                                       name=f"engine{i}", fault_hook=hook, device=device,
                                       mesh=mesh)

            engines.append(fleet.build(make) if fleet is not None
                           else make(None if meshes is None else meshes[i]))
        return _serve_engines(args, cfg, scfg, device, writer, ramp_phases, replay_records,
                              params, n_init, list(engines), fleet, engines)
    finally:
        # A sharded engine's followers leave their loops (an elastic
        # fleet's: wait for their group's next generation, then exit).
        for engine in engines:
            engine.close()
        if fleet is not None:
            fleet.close()


def _serve_engines(args, cfg, scfg, device, writer, ramp_phases, replay_records, params,
                   n_init, engines, fleet=None, built=None) -> int:
    import numpy as np
    import torch

    from glom_tpu_torch.serve.batcher import DynamicBatcher, ShedError
    from glom_tpu_torch.serve.events import stamp_serve as serve_rec

    degraded_iters = None
    if scfg.ladder:
        degraded_iters = (
            scfg.degraded_iters if scfg.degraded_iters is not None
            else max(1, cfg.default_iters // 2)
        )
    if not args.no_warmup:
        for engine in engines:
            engine.warmup()
            if degraded_iters is not None:
                # The capped-iters route too: the first degraded dispatch
                # must not pay its warm-up on top of the pressure that
                # degraded it.
                engine.warmup(iters_override=degraded_iters)

    shape = (cfg.channels, cfg.image_size, cfg.image_size)

    def rng_img(seed):
        return np.random.default_rng(seed).normal(size=shape).astype(np.float32)

    def frame_img(seed, session):
        # A stream's frames are small perturbations of its base image (the
        # temporal coherence the column cache exploits); stateless requests
        # stay pure seeded gaussians.
        if session is None:
            return rng_img(seed)
        import zlib  # deterministic across processes, unlike hash()

        base = rng_img(zlib.crc32(str(session).encode()) & 0x7FFFFFFF)
        return base + 0.05 * rng_img((1 << 20) + seed)

    def req_plan():
        """(rid, seed, session, gap_s) per request: the flat --synthetic /
        --requests source at the constant --request-gap-ms, or the --ramp
        phases at each phase's own pace (a stamped record marks every
        phase boundary)."""
        flat_gap = max(0.0, args.request_gap_ms) / 1e3
        if ramp_phases is None:
            for rid, seed, session in _req_source(args):
                yield rid, seed, session, flat_gap
            return
        streams = args.streams or 0
        i = 0
        for phase, (n, gap) in enumerate(ramp_phases):
            writer.write(serve_rec({
                "event": "ramp_phase", "phase": phase, "n_requests": n,
                "gap_ms": round(1e3 * gap, 3),
            }))
            for _ in range(n):
                session = f"s{i % streams}" if streams > 0 else None
                yield i, i, session, gap
                i += 1

    def shed_response(rid, e):
        # The shed exception's detail carries the minted trace_id, so even
        # a rejected request's response joins its trace's shed leaf.
        writer.write(serve_rec({
            "event": "response", "id": rid, "ok": False,
            "reason": f"{type(e).__name__}: {e}"[:200],
            "trace_id": getattr(e, "detail", {}).get("trace_id"),
        }))

    served = failed = 0
    scaler = None
    with DynamicBatcher(engines=engines, writer=writer) as batcher:
        recorder = None
        if args.record_workload is not None:
            from glom_tpu_torch.serve.workload import WorkloadRecorder

            recorder = WorkloadRecorder().attach(batcher)
        forecaster = None
        if args.forecast or scfg.elastic_anticipatory:
            # Anticipatory scaling feeds on the forecaster: a policy told
            # to act on predicted load with no prediction source would
            # stay reactive forever, so --elastic-anticipatory implies
            # --forecast.
            from glom_tpu_torch.telemetry.forecast import ForecastEmitter
            from glom_tpu_torch.tracing.flight import write_or_observe

            batcher.enable_admission_events()
            forecaster = ForecastEmitter(lambda r: write_or_observe(writer, r))
            batcher.add_event_tap(forecaster.tap)
        if scfg.elastic:
            scaler = _autoscaler(batcher, cfg, scfg, params, writer, device,
                                 len(engines), forecaster, degraded_iters, fleet, built)
        tickets = []
        if replay_records is not None:
            from glom_tpu_torch.serve import workload as wl

            def offer(rec, i):
                rid = rec.get("request_id", i)
                try:
                    tickets.append((rid, batcher.submit(
                        wl.synth_input(rec, i), session_id=rec.get("session"),
                        slo_class=rec.get("slo_class"),
                    )))
                except ShedError as e:
                    shed_response(rid, e)
                    raise  # replay counts it as shed and drives on

            stats = wl.replay(replay_records, offer, time_scale=args.replay_time_scale)
            failed += stats["n_shed"]
            writer.write(serve_rec({
                "event": "replay_summary", "source": args.replay,
                "time_scale": args.replay_time_scale, **stats,
            }))
        else:
            for rid, seed, session, gap_s in req_plan():
                if gap_s and tickets:
                    time.sleep(gap_s)
                try:
                    tickets.append((rid, batcher.submit(frame_img(seed, session),
                                                        session_id=session)))
                except ShedError as e:
                    failed += 1
                    shed_response(rid, e)
        for rid, ticket in tickets:
            try:
                levels, iters_run, latency_s = ticket.result(timeout=300.0)
            except Exception as e:  # noqa: BLE001 — per-request record
                failed += 1
                writer.write(serve_rec({
                    "event": "response", "id": rid, "ok": False,
                    "reason": f"{type(e).__name__}: {e}"[:200],
                    "trace_id": ticket.trace_id, "parent_span": ticket.span_id,
                }))
                continue
            served += 1
            # The response is the trace's user-visible leaf: it parents to
            # the submit root.
            top = levels[:, -1].float()
            writer.write(serve_rec({
                "event": "response", "id": rid, "ok": True,
                "latency_ms": round(1e3 * latency_s, 3),
                "iters_run": iters_run,
                "top_level_norm": round(
                    float(torch.linalg.vector_norm(top)) / levels.shape[0], 4),
                "trace_id": ticket.trace_id, "parent_span": ticket.span_id,
            }))
        if scaler is not None:
            # The settle window: the ramp's post-spike drain lands here
            # (bounded: the loop exits the moment a scale-in completes).
            deadline = time.monotonic() + max(0.0, args.elastic_settle)
            while time.monotonic() < deadline:
                if scaler.record()["n_scale_ins"] >= 1:
                    break
                time.sleep(0.05)
            scaler.stop()
        if forecaster is not None:
            # Flush the final partial window and the lead-time model while
            # the stream is open: the run's last traffic still scores the
            # forecast.
            forecaster.close()
        writer.write(serve_rec(batcher.summary_record()))
        for rec in batcher.span_records():
            writer.write(rec)
        if recorder is not None:
            n_rec = recorder.write(args.record_workload, source=f"serve-cli:{args.preset}")
            writer.write(serve_rec({
                "event": "workload_recorded", "path": args.record_workload,
                "n_requests": n_rec, **recorder.summary(),
            }))
    for engine in batcher.engines:
        for rec in engine.stats_records():
            writer.write(serve_rec(rec))
        # Stamped "collective_time" records (a mesh engine with timing on;
        # empty otherwise).
        for rec in engine.collective_time_records():
            writer.write(rec)
    return 0 if failed == 0 and served > 0 else 1


def _autoscaler(batcher, cfg, scfg, params, writer, device, n_init, forecaster, degraded_iters,
                fleet=None, built=None):
    """The started Autoscaler over `batcher`: each replica it spawns is a
    new InferenceEngine on `device` with the shared params (fan-out serves
    one model), on the fleet's first waiting rank group on a mesh; the
    autoscaler warms it before registration. No waiting group raises into
    the spawn's rollback. Each engine built is appended to `built`."""
    from glom_tpu_torch.serve.elastic import Autoscaler, resolve_policy
    from glom_tpu_torch.serve.engine import InferenceEngine

    spawn_seq = [n_init]

    def engine_factory():
        def make(mesh):
            return InferenceEngine(cfg, scfg, params=params, writer=writer,
                                   name=f"engine{spawn_seq[0]}", device=device, mesh=mesh)

        eng = fleet.build(make) if fleet is not None else make(None)
        if built is not None:
            built.append(eng)
        spawn_seq[0] += 1
        return eng

    rules = {}
    if scfg.elastic_p99_ms is not None:
        rules["p99_ms"] = scfg.elastic_p99_ms
    if scfg.elastic_shed_rate is not None:
        rules["shed_rate"] = scfg.elastic_shed_rate
    if scfg.slo_classes:
        # Each class's declared targets become class-scoped monitor rules
        # ("p99_ms[premium]"); low-class breaches are recorded but
        # non-binding (the policy's low_classes filter, serve/qos.py).
        from glom_tpu_torch.serve.qos import class_slo_rules, resolve_slo_classes

        spec = resolve_slo_classes(scfg)
        if spec is not None:
            rules.update(class_slo_rules(spec))
    return Autoscaler(
        batcher, engine_factory,
        policy=resolve_policy(scfg),
        rules=rules,
        writer=writer,
        interval_s=scfg.elastic_interval_s,
        warm_degraded_iters=degraded_iters,
        forecast=forecaster,
        warm_pool=scfg.warm_pool,
    ).start()


if __name__ == "__main__":
    sys.exit(main())
