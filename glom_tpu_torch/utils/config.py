"""Configuration dataclasses.

Counterpart of `glom_tpu/utils/config.py`: `GlomConfig`, `MeshConfig` and
`TrainConfig` field for field, and the part of `ServeConfig` that the
port's serving routes read. `MeshConfig` lays the ranks of the port's
parallel paths out (`glom_tpu_torch.parallel.mesh`). The port keeps its own copy because the reference module pulls in
JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class GlomConfig:
    """Model hyperparameters: field-for-field the reference constructor."""

    dim: int = 512
    levels: int = 6
    image_size: int = 224
    patch_size: int = 14
    consensus_self: bool = False
    local_consensus_radius: int = 0
    # Extensions beyond the reference kwargs (defaults match its hardcoded values):
    mult: int = 4  # FFW expansion, reference hardcodes 4
    channels: int = 3  # reference hardcodes RGB

    def __post_init__(self):
        if self.image_size % self.patch_size != 0:
            raise ValueError(
                f"image_size {self.image_size} not divisible by patch_size {self.patch_size}"
            )
        if self.levels < 2:
            raise ValueError("levels must be >= 2 (top-down net needs levels-1 groups)")

    @property
    def num_patches_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_side ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def default_iters(self) -> int:
        # "twice the levels, for information to propagate up and back down"
        # (reference :105)
        return 2 * self.levels


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism layout (glom_tpu's names). Axis sizes of 1 disable an
    axis.

    data:  batch sharding (DP)
    seq:   patch-axis sharding (SP)
    model: dim sharding (TP) of the FFW weights

    num_slices > 1 marks a multi-slice topology: the data axis is laid out
    slice-major, its outermost num_slices-way split crossing slices.
    """

    data: int = 1
    seq: int = 1
    model: int = 1
    num_slices: int = 1

    def __post_init__(self):
        if self.num_slices > 1 and self.data % self.num_slices != 0:
            raise ValueError(
                f"data axis {self.data} not divisible by num_slices "
                f"{self.num_slices} (the slice split is the outer data axis)"
            )

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data", "seq", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data, self.seq, self.model)

    @property
    def num_devices(self) -> int:
        return self.data * self.seq * self.model


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Batched-inference serving policy: the part of glom_tpu's
    `ServeConfig` that the port's engine reads, with its names, defaults
    and checks.

    The bucket route (fixed `iters` or `"auto"` early exit), the ragged
    route (`ragged=True`: rows of differing patch counts packed onto one
    page-aligned token axis), the device page pool with its delta streaming
    and aliasing, and the engine's retry and phase split are ported, and so is the host
    stack's policy over them (serve/batcher.py, qos.py, column_cache.py,
    resilience/ladder.py): admission, continuation hops, the degradation
    ladder, the session column cache, engine rejoin, request tracing and
    SLO classes, and the elastic fleet (serve/elastic.py: the autoscaler's
    policy, warm-pool spares and drained-husk retention), and the serve
    mesh (`mesh_data` x `mesh_seq` ranks an engine, parallel/serve_mesh.py)."""

    # Ascending batch-size buckets; a dispatch pads to the smallest bucket
    # >= its request count. The largest bucket is the dispatch ceiling.
    buckets: Tuple[int, ...] = (1, 2, 4, 8)
    # Admission (serve/batcher.py): dispatch when max_batch requests wait,
    # or once the oldest waiting one has aged max_delay_ms. max_batch is
    # also the row capacity of a ragged signature. A submit past
    # queue_depth waiting requests is shed at once (QueueFullError).
    max_batch: int = 8
    max_delay_ms: float = 5.0
    queue_depth: int = 64
    # Forward iteration budget: an int pins the count, None uses the model
    # default (2L), "auto" runs the early-exit route: up to max_auto_iters
    # updates, a row converging once no level's agreement moves more than
    # exit_threshold between iterations, the dispatch exiting once
    # ceil(exit_quorum * valid rows) rows have converged.
    iters: Union[int, str, None] = None
    exit_threshold: float = 1e-3
    min_iters: int = 1
    max_auto_iters: Optional[int] = None  # None -> model default (2L)
    exit_quorum: float = 1.0
    # Continuation hops: rows still unconverged when the bucket exits
    # re-bucket in the batcher's continuation queue with their column
    # state and remaining budget, up to max_continuations hops (0: they
    # resolve with the state they have).
    max_continuations: int = 0
    # Serve mesh (parallel/serve_mesh.py): axis sizes > 1 run every bucket
    # signature on a group of mesh_data x mesh_seq ranks, batch rows split
    # over 'data' and the patch axis over 'seq', the early-exit witness
    # collectives inside the loop. Every bucket must be divisible by
    # mesh_data.
    mesh_data: int = 1
    mesh_seq: int = 1
    compute_dtype: str = "float32"  # "bfloat16" for tensor-core serving
    use_pallas: bool = False  # True: the fused kernel path (name kept)
    # Input donation: eager PyTorch donates nothing, so None resolves to
    # False (glom_tpu resolves it to False off the TPU too).
    donate: Optional[bool] = None
    # Transient-dispatch retry (resilience/retry.RetryPolicy): a failed
    # dispatch retries up to dispatch_retries times with exponential
    # backoff from retry_backoff_ms, unless the backend is down. 0
    # disables. Caller bugs (ValueError, TypeError) and kernel faults
    # (kernels/_build.KernelError) never retry.
    dispatch_retries: int = 2
    retry_backoff_ms: float = 25.0
    # Degradation ladder (resilience/ladder.py; the batcher builds one per
    # engine when ladder=True): under queue pressure or a flapping backend
    # step down normal -> capped_iters -> bucket_cap -> shed, one rung at
    # a time. degraded_iters None -> half the model budget (floor 1);
    # degraded_max_batch None -> half max_batch (floor 1).
    ladder: bool = False
    degraded_iters: Optional[int] = None
    degraded_max_batch: Optional[int] = None
    ladder_high_water: float = 0.75  # queue fill that steps down a rung
    ladder_low_water: float = 0.25  # queue fill that steps back up
    # Session column cache (serve/column_cache.py): requests with a
    # session_id write their converged columns back under the session and
    # the stream's next frame starts warm from them. column_cache_bytes is
    # the hard residency budget (LRU eviction; 0 disables the cache);
    # column_cache_ttl_s expires a quiet stream's entry (None: never).
    # With a page pool the entries are pool pages (no levels0 crosses
    # from the host on the warm path).
    column_cache_bytes: int = 0
    column_cache_ttl_s: Optional[float] = None
    # Paged column memory (serve/paged_columns.py): page_pool_pages > 0
    # preallocates one device buffer of [page_pool_pages, page_tokens, L,
    # d] per engine; warm dispatches gather levels0 from it by page index
    # (no levels0 crosses from the host) and write-backs copy converged
    # columns into owned pages on the device. page_tokens is the page
    # granularity (of the ragged route too; 0 resolves from the model,
    # serve/paged_columns.resolve_page_tokens).
    page_pool_pages: int = 0
    page_tokens: int = 0
    # In-place pool write-backs: True updates the pool's pages in place
    # when no dispatch holds a read pin (the epoch advances), and falls
    # back to copy-on-write, counted and stamped, when one does. False
    # copies the whole pool on every write-back.
    pool_aliasing: bool = False
    # Ragged admission: the page-count ladder (empty resolves from
    # max_batch and the pages of one full-resolution row) and the
    # consensus gather: "windowed" (per-token window), "banded" (per-page
    # band, plain PyTorch) or "banded-pallas" (the K4 kernel on the card).
    ragged: bool = False
    ragged_pages: Tuple[int, ...] = ()
    ragged_attention: str = "windowed"
    # Delta streaming (serve/paged_columns.PagedColumnPool.write_back_stream):
    # a session keeps a paged base plus a chain of deltas holding only the
    # pages whose residual exceeds delta_page_atol (0.0: any changed bit);
    # the chain folds into the base at delta_chain_cap; delta_base_share
    # lets content-identical bases share pool pages; delta_incremental
    # makes the batcher route warm frames through
    # serve/early_exit.glom_forward_incremental, seeded from the input
    # delta's page support. Needs a page pool; the bucket route only.
    delta_streaming: bool = False
    delta_page_atol: float = 0.0
    delta_chain_cap: int = 4
    delta_base_share: bool = True
    delta_incremental: bool = True
    # The engine's latency split: each dispatch reports the ms it spent
    # staging inputs (h2d) and reading results back (resolve).
    phase_split: bool = True
    # How a sharded paged dispatch gathers pool pages (the pool's page axis
    # is split over 'data'): "pool" all-gathers every rank's pages,
    # "needed" sends only the pages the dispatch's rows reference, "auto"
    # takes whichever moves fewer bytes at the signature's shapes.
    page_gather: str = "auto"
    # Engine rejoin: a dead engine of a multi-engine batcher serves again
    # after rejoin_threshold consecutive successful probation dispatches,
    # one every rejoin_interval_ms (0 keeps death terminal).
    rejoin_threshold: int = 0
    rejoin_interval_ms: float = 200.0
    # Request tracing (telemetry/tracectx.py): each submit mints a trace
    # and every serve record of the request carries it (False stamps the
    # keys as null).
    trace_requests: bool = True
    # Per-collective wall time (telemetry/comm_time.py): "sampled" re-runs
    # each site every collective_timing_interval-th dispatch, "full"
    # brackets every execution; a single-device engine has no collectives,
    # so any mode resolves to "off" there, with a warning.
    collective_timing: str = "off"
    collective_timing_interval: int = 16
    # Elastic serving (serve/elastic.py): elastic=True runs an Autoscaler
    # control loop beside the batcher that reads the live capacity records
    # (headroom) and in-process SLO breaches and changes the fleet:
    # scale-out builds a replica on the card and warms it before admission
    # opens, scale-in drains the least-loaded engine (stop admitting,
    # flush, migrate its cache sessions, release its device memory).
    # False keeps the static fleet. The policy is windowed low/high water
    # with min-dwell hysteresis and a post-action cooldown, clamped to
    # [min_engines, max_engines]:
    #   * worst eligible headroom < elastic_low_water continuously for
    #     elastic_dwell_s (or any armed upper-bound SLO breach,
    #     elastic_p99_ms / elastic_shed_rate, None = not armed) scales
    #     out; a breach also vetoes scale-in;
    #   * worst eligible headroom > elastic_high_water continuously for
    #     elastic_dwell_s scales in (drains the max-headroom engine).
    # elastic_interval_s paces the control ticks; elastic_window_s is the
    # signal window the policy and its SLO monitor share.
    elastic: bool = False
    min_engines: int = 1
    max_engines: int = 4
    elastic_low_water: float = 0.15
    elastic_high_water: float = 0.6
    elastic_dwell_s: float = 2.0
    elastic_cooldown_s: float = 5.0
    elastic_window_s: float = 10.0
    elastic_interval_s: float = 0.5
    elastic_p99_ms: Optional[float] = None
    elastic_shed_rate: Optional[float] = None
    # Drained-husk retention: a scale-in leaves the drained engine in the
    # summary as an evidence husk. None (both defaults) keeps every husk;
    # husk_max keeps at most N (oldest retire first); husk_max_age_s
    # retires a husk once it has been drained that long. Retirement folds
    # the husk's counters into the summary's husks_retired nest and stamps
    # one engine_husk_retired event, so conservation still reconciles.
    husk_max: Optional[int] = None
    husk_max_age_s: Optional[float] = None
    # Anticipatory autoscaling: elastic_anticipatory=True lets the policy
    # act on the forecast load at `now + spawn_lead_time`: a positive
    # predicted deficit over the fleet's usable capacity (measured service
    # rate x elastic_target_utilization) arms scale-out and vetoes
    # scale-in, once both models have matured (a scored forecast_abs_err
    # and spawn-lead evidence); until then the policy is the reactive one.
    # Every decision stamps its evidence bundle (`python -m
    # glom_tpu_torch.telemetry audit` replays it).
    elastic_anticipatory: bool = False
    elastic_target_utilization: float = 0.8
    # Warm-pool spares: N engines built and warmed ahead, held outside
    # admission (never registered with the batcher: a spare is not a husk
    # and serves no traffic). Scale-out promotes a spare; scale-in demotes
    # the drained engine back into the pool instead of releasing it.
    warm_pool: int = 0
    # SLO classes (serve/qos.py): named classes such as
    # ("premium:weight=8,p99_ms=150", "batch:weight=1") turn the shared
    # admission FIFO into a weighted-fair class scheduler with per-class
    # bounded lanes and class-aware ladder gates. None keeps the classless
    # batcher. slo_default_class labels unclassed submits; slo_shed_order
    # overrides the ascending-weight shed order; slo_starvation_floor is
    # each lower class's guaranteed pick share under contention.
    slo_classes: Optional[Tuple[str, ...]] = None
    slo_default_class: Optional[str] = None
    slo_shed_order: Optional[Tuple[str, ...]] = None
    slo_starvation_floor: float = 0.05

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("buckets must be non-empty")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets {self.buckets} must be strictly ascending")
        if any(b < 1 for b in self.buckets):
            raise ValueError(f"buckets {self.buckets} must be >= 1")
        if self.max_batch > max(self.buckets):
            raise ValueError(
                f"max_batch {self.max_batch} exceeds the largest bucket "
                f"{max(self.buckets)} (the dispatch ceiling)"
            )
        if self.max_batch < 1:
            raise ValueError(f"max_batch {self.max_batch} must be >= 1")
        if self.queue_depth < 1:
            raise ValueError(f"queue_depth {self.queue_depth} must be >= 1")
        if self.max_delay_ms < 0:
            raise ValueError(f"max_delay_ms {self.max_delay_ms} must be >= 0")
        if self.iters is not None and self.iters != "auto":
            if not isinstance(self.iters, int) or self.iters < 1:
                raise ValueError(f"iters={self.iters!r}: an int >= 1, 'auto', or None")
        if self.exit_threshold < 0:
            raise ValueError(f"exit_threshold {self.exit_threshold} must be >= 0")
        if self.min_iters < 1:
            raise ValueError(f"min_iters {self.min_iters} must be >= 1")
        if not 0.0 < self.exit_quorum <= 1.0:
            raise ValueError(
                f"exit_quorum {self.exit_quorum} outside (0, 1] (1.0 = all "
                "valid rows must converge before the bucket exits)"
            )
        if self.max_continuations < 0:
            raise ValueError(f"max_continuations {self.max_continuations} must be >= 0")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}: 'float32' or 'bfloat16'")
        if self.mesh_data < 1 or self.mesh_seq < 1:
            raise ValueError(
                f"mesh_data={self.mesh_data} mesh_seq={self.mesh_seq}: "
                "serve mesh axes must be >= 1"
            )
        if self.mesh_data > 1 and any(b % self.mesh_data for b in self.buckets):
            raise ValueError(
                f"every bucket {self.buckets} must be divisible by "
                f"mesh_data={self.mesh_data} (batch rows shard over 'data')"
            )
        if self.dispatch_retries < 0:
            raise ValueError(f"dispatch_retries {self.dispatch_retries} must be >= 0")
        if self.retry_backoff_ms < 0:
            raise ValueError(f"retry_backoff_ms {self.retry_backoff_ms} must be >= 0")
        if self.degraded_iters is not None and self.degraded_iters < 1:
            raise ValueError(f"degraded_iters {self.degraded_iters} must be >= 1 or None")
        if self.degraded_max_batch is not None and self.degraded_max_batch < 1:
            raise ValueError(
                f"degraded_max_batch {self.degraded_max_batch} must be >= 1 or None"
            )
        if not 0.0 <= self.ladder_low_water < self.ladder_high_water <= 1.0:
            raise ValueError(
                f"need 0 <= ladder_low_water ({self.ladder_low_water}) < "
                f"ladder_high_water ({self.ladder_high_water}) <= 1"
            )
        if self.column_cache_bytes < 0:
            raise ValueError(
                f"column_cache_bytes {self.column_cache_bytes} must be >= 0 "
                "(0 disables the streaming column cache)"
            )
        if self.column_cache_ttl_s is not None and self.column_cache_ttl_s <= 0:
            raise ValueError(
                f"column_cache_ttl_s {self.column_cache_ttl_s} must be > 0 or None"
            )
        if self.page_pool_pages < 0:
            raise ValueError(
                f"page_pool_pages {self.page_pool_pages} must be >= 0 "
                "(0 disables the device-resident column page pool)"
            )
        if self.page_tokens < 0:
            raise ValueError(
                f"page_tokens {self.page_tokens} must be >= 0 (0 resolves "
                "from the model's patch count)"
            )
        if self.ragged and self.max_continuations > 0 and self.iters != "auto":
            raise ValueError(
                "ragged continuations need iters='auto': a fixed route "
                "has no convergence witness to leave stragglers behind"
            )
        if self.ragged_attention not in ("windowed", "banded", "banded-pallas"):
            raise ValueError(
                f"ragged_attention {self.ragged_attention!r}: 'windowed', "
                "'banded', or 'banded-pallas'"
            )
        if self.pool_aliasing and self.page_pool_pages <= 0:
            raise ValueError(
                "pool_aliasing needs a device page pool "
                "(page_pool_pages > 0): there is no buffer to alias"
            )
        if self.ragged_pages:
            if list(self.ragged_pages) != sorted(set(self.ragged_pages)):
                raise ValueError(
                    f"ragged_pages {self.ragged_pages} must be strictly ascending"
                )
            if any(p < 1 for p in self.ragged_pages):
                raise ValueError(f"ragged_pages {self.ragged_pages} must be >= 1")
        if self.delta_streaming:
            if self.page_pool_pages <= 0:
                raise ValueError(
                    "delta_streaming needs a device page pool "
                    "(page_pool_pages > 0): delta entries are pool pages"
                )
            if self.ragged:
                raise ValueError(
                    "delta_streaming rides the bucket route only (ragged "
                    "delta chains are a documented follow-on)"
                )
        if self.delta_page_atol < 0:
            raise ValueError(
                f"delta_page_atol {self.delta_page_atol} must be >= 0 "
                "(0.0 = exact: any changed bit stores the page)"
            )
        if self.delta_chain_cap < 1:
            raise ValueError(f"delta_chain_cap {self.delta_chain_cap} must be >= 1")
        if self.page_gather not in ("auto", "pool", "needed"):
            raise ValueError(
                f"page_gather {self.page_gather!r}: 'auto', 'pool', or 'needed'"
            )
        if self.rejoin_threshold < 0:
            raise ValueError(
                f"rejoin_threshold {self.rejoin_threshold} must be >= 0 "
                "(0 keeps engine death terminal)"
            )
        if self.rejoin_interval_ms <= 0:
            raise ValueError(f"rejoin_interval_ms {self.rejoin_interval_ms} must be > 0")
        if self.collective_timing not in ("off", "sampled", "full"):
            raise ValueError(
                f"collective_timing {self.collective_timing!r}: one of "
                "('off', 'sampled', 'full')"
            )
        if self.collective_timing_interval < 1:
            raise ValueError(
                f"collective_timing_interval "
                f"{self.collective_timing_interval} must be >= 1"
            )
        if self.min_engines < 1:
            raise ValueError(f"min_engines {self.min_engines} must be >= 1")
        if self.max_engines < self.min_engines:
            raise ValueError(
                f"max_engines {self.max_engines} must be >= min_engines "
                f"{self.min_engines}"
            )
        if not 0.0 <= self.elastic_low_water < self.elastic_high_water <= 1.0:
            raise ValueError(
                f"need 0 <= elastic_low_water ({self.elastic_low_water}) < "
                f"elastic_high_water ({self.elastic_high_water}) <= 1"
            )
        if self.elastic_dwell_s < 0 or self.elastic_cooldown_s < 0:
            raise ValueError(
                f"elastic_dwell_s {self.elastic_dwell_s} and "
                f"elastic_cooldown_s {self.elastic_cooldown_s} must be >= 0"
            )
        if self.elastic_window_s <= 0 or self.elastic_interval_s <= 0:
            raise ValueError(
                f"elastic_window_s {self.elastic_window_s} and "
                f"elastic_interval_s {self.elastic_interval_s} must be > 0"
            )
        if self.elastic_p99_ms is not None and self.elastic_p99_ms <= 0:
            raise ValueError(
                f"elastic_p99_ms {self.elastic_p99_ms} must be > 0 or None"
            )
        if self.elastic_shed_rate is not None and not (
            0.0 <= self.elastic_shed_rate <= 1.0
        ):
            raise ValueError(
                f"elastic_shed_rate {self.elastic_shed_rate} must be in [0, 1] or None"
            )
        if self.husk_max is not None and self.husk_max < 0:
            raise ValueError(f"husk_max {self.husk_max} must be >= 0 or None")
        if self.husk_max_age_s is not None and self.husk_max_age_s < 0:
            raise ValueError(
                f"husk_max_age_s {self.husk_max_age_s} must be >= 0 or None"
            )
        if not 0.0 < self.elastic_target_utilization <= 1.0:
            raise ValueError(
                f"elastic_target_utilization "
                f"{self.elastic_target_utilization} must be in (0, 1]"
            )
        if self.warm_pool < 0:
            raise ValueError(f"warm_pool {self.warm_pool} must be >= 0")
        if not 0.0 <= self.slo_starvation_floor < 1.0:
            raise ValueError(
                f"slo_starvation_floor {self.slo_starvation_floor} must be in [0, 1)"
            )
        if self.slo_classes is not None or self.slo_shed_order is not None:
            # The class table resolves here, so a typo'd class spec, a
            # duplicate name or an unknown default or shed-order entry
            # fails at construction, not mid-traffic.
            if not self.slo_classes:
                raise ValueError(
                    "slo_shed_order needs slo_classes: there are no "
                    "declared classes to order"
                )
            from glom_tpu_torch.serve.qos import resolve_slo_classes

            resolve_slo_classes(self)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Self-supervised denoising trainer (the reference's README recipe):
    glom_tpu's fields, names and defaults. The trainer validates them
    (train/trainer.py, telemetry/diagnostics.py), as glom_tpu's does."""

    batch_size: int = 8
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    # "constant" | "cosine" | "warmup_cosine"; cosine decays to
    # lr_final_fraction * learning_rate; schedule_steps is the TOTAL length,
    # including warmup_steps for warmup_cosine (optax semantics).
    lr_schedule: str = "constant"
    schedule_steps: int = 10_000
    warmup_steps: int = 0
    lr_final_fraction: float = 0.0
    # Microbatches per optimizer update (exact strided accumulation). None
    # is the auto-routing sentinel: one pass while no route needs a split.
    grad_accum: Optional[int] = None
    noise_std: float = 1.0
    recon_iter_index: Optional[int] = None  # None -> T // 2 + 1 (7 at T=12)
    iters: Optional[int] = None  # None -> model default (2L)
    # Recompute in the backward: the whole-loop VJP recomputes the FFWs'
    # pre-activations; the per-iteration route checkpoints each iteration.
    remat: bool = False
    compute_dtype: str = "float32"  # "bfloat16" for tensor-core training
    use_pallas: bool = False  # True: the fused kernel route (name kept)
    # Sharded weight update and quantized reduce: across data ranks
    # (parallel/manual.py); one device resolves them to 0 and off.
    zero_stage: int = 0
    quantized_reduce: bool = False
    # "off" | "scalars" (grad/update/param norms + the NaN/Inf guard) |
    # "full" (adds the per-level consensus agreement; across ranks it runs
    # "scalars").
    telemetry_level: str = "off"
    nonfinite_policy: str = "skip"  # "skip" drops a non-finite update; "warn" applies it
    # Eager PyTorch runs the iterations as a Python loop, which is what the
    # JAX scan's unroll produced; kept for the reference's field set.
    scan_unroll: bool = False
    # The ZeRO step's collective timing (DistributedTrainer at zero_stage
    # >= 1; "full" runs "sampled"): a sample every interval-th logging step.
    collective_timing: str = "off"
    collective_timing_interval: int = 10
    seed: int = 0
