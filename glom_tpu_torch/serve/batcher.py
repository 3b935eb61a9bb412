"""Host-side dynamic batching: the bounded queue, bucket padding, the
continuation queue, multi-engine fan-out and the shed path.

The port's counterpart of `glom_tpu/serve/batcher.py`, over the port's
`InferenceEngine`. The host gathers concurrent requests into bucket shapes
with two knobs:

  * max_batch: dispatch the moment this many requests are waiting;
  * max_delay_ms: dispatch anyway once the oldest waiting request has aged
    this long.

Gathered requests pad up to the smallest admitting bucket with a validity
mask, so pad rows neither reach callers nor vote on the early-exit
witness (serve/early_exit). With `ServeConfig.ragged` requests of
differing resolutions pack page-aligned onto one flat token axis instead
(`infer_ragged`, K4's route).

Two-tier early exit (`max_continuations > 0`, the auto route): a bucket
exits when its quorum converges; rows still unconverged are stragglers,
whose column state re-buckets into the continuation queue as one group,
with the remaining per-request budget. Workers drain that queue ahead of
fresh traffic, and a continuation group folds waiting fresh rows into its
pad slots. A request resolves exactly once, with the sum of its hops'
iterations.

Mixed warm and cold buckets: each row is cold, warm from the session
cache, or a continuation straggler, through a per-row `levels0` select. The
select is a CPU tensor in the serving dtype (numpy has no bfloat16); cold
rows take `engine.cold_levels()`, exactly the init the forward builds.
With a page pool the session cache holds pool pages, warm rows ride
`page_rows` (and, in delta mode, the incremental route's `support_rows`),
and converged rows write back device-to-device.

Multi-engine fan-out: one worker thread per engine pulls from the shared
queue. Each worker sets its engine's CUDA device (the current device is
per thread in torch); every engine runs on its device's default stream. A
dispatch failure hands the batch to the siblings (a bounded per-request
redispatch budget), an engine whose failures persist is marked dead, and
with `rejoin_threshold > 0` a probation thread re-admits it after that
many consecutive healthy dispatches. A `kernels/_build.KernelError` is a
fault of the program, not of one engine: it fails the batch's tickets
with itself and is never handed to a sibling. Each engine keeps its own
`RetryPolicy` and, with `ServeConfig.ladder`, its own `DegradationLadder`.

Lock order: `_engine_lock` is always taken before `_counter_lock`, never
the reverse; the per-engine bookkeeping and the conservation counters
move together.

Failure discipline: the request queue is bounded (a submit against a full
queue sheds with QueueFullError and a stamped "shed" record carrying the
why); a backend the watchdog reports down fails submissions and gathered
requests fast (BackendDownError); a dispatch exception with no sibling
fails only that batch's tickets; the ladder steps serving down one
reversible rung at a time before it sheds (LadderShedError).

The elastic fleet (serve/elastic.py): `add_engine()` registers a warmed
replica at runtime (admission opens the moment its worker starts), and
`drain_engine()` runs the graceful scale-in: draining is an engine state
of its own, distinct from dead (a draining worker stops pulling new work,
finishes its in-flight dispatch, hands its affinity queue back to the
shared queue and exits, never into probation); the engine's cache
sessions migrate to a sibling pool device-to-device (or are invalidated
with a stamped `drain` reason); the engine leaves the fleet as drained,
excluded from the capacity records but kept in the summary's engines nest
as evidence (a husk, retired under `husk_max` / `husk_max_age_s`). With no
autoscaler attached none of this runs and the static fleet keeps its
records' shape.

Host phases ride tracing.spans (serve_enqueue, serve_batch,
serve_dispatch, serve_fetch), drained by span_records().
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from glom_tpu_torch.kernels._build import KernelError
from glom_tpu_torch.serve.paged_columns import content_hash, pages_for_tokens
from glom_tpu_torch.telemetry import schema, tracectx
from glom_tpu_torch.tracing.spans import SpanAggregator, span


class ShedError(RuntimeError):
    """Base of the fast-fail admission errors (never a hang). `detail`
    carries the machine-readable why (queue depth, ladder rung) — the
    same fields the stamped shed record gets, so a caller's except block
    and the telemetry stream read one story."""

    def __init__(self, message: str, **detail):
        super().__init__(message)
        self.detail = detail


class QueueFullError(ShedError):
    """Bounded queue at capacity: backpressure, retry later."""


class BackendDownError(ShedError):
    """The backend watchdog reports the accelerator down."""


class LadderShedError(ShedError):
    """The degradation ladder's last rung: every cheaper serving mode is
    already exhausted (resilience/ladder.py)."""


class Ticket:
    """One request's future: result() blocks until served or failed.

    `trace_id`/`span_id` are the request's minted trace context
    (telemetry/tracectx.py; None when ServeConfig.trace_requests is off):
    trace_id names the request's causal tree across every hop it rides,
    span_id is the submit root every first-hop record parents to. After
    resolve, `hops` and `dispatch_ms` carry the served totals the trace
    tree's conservation check reconciles against."""

    def __init__(self, request_id, trace_id=None, span_id=None,
                 slo_class=None):
        self.request_id = request_id
        self.trace_id = trace_id
        self.span_id = span_id
        # The request's SLO class (serve/qos.py; None = unclassed or a
        # classless config): stamped on every record this request leaves
        # (admit, shed, settle, resolve), so per-class conservation
        # reconciles from the stream alone (schema v11).
        self.slo_class = slo_class
        self.hops: Optional[int] = None
        self.dispatch_ms: Optional[float] = None
        self._done = threading.Event()
        self._levels: Optional[torch.Tensor] = None
        self._iters_run: Optional[int] = None
        self._latency_s: Optional[float] = None
        self._error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        # Armed by enable_admission_events: called exactly once with
        # (ticket, "served"|"failed") at the terminal, whichever path got
        # there (resolve, redispatch exhaustion, stop()'s drain).
        self._settle_cb = None

    def _settled(self, outcome: str) -> None:
        cb = self._settle_cb
        if cb is None:
            return
        self._settle_cb = None  # terminal states are terminal
        try:
            cb(self, outcome)
        except Exception:  # noqa: BLE001 — evidence never kills a worker
            pass

    def _resolve(self, levels, iters_run, hops=None, dispatch_ms=None):
        self._levels = levels
        self._iters_run = iters_run
        self.hops = hops
        self.dispatch_ms = dispatch_ms
        self._latency_s = time.perf_counter() - self.t_submit
        self._done.set()
        self._settled("served")

    def _fail(self, exc: BaseException):
        self._error = exc
        self._latency_s = time.perf_counter() - self.t_submit
        self._done.set()
        self._settled("failed")

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """(levels [n, L, d], iters_run, latency_s) for this request, or
        re-raises the failure. levels is a CPU tensor in the serving dtype
        ([n_patches, L, d] on the ragged route); latency_s is
        submit-to-resolve wall time (queueing, gathering, every hop's
        dispatch and fetch); iters_run is the total of column iterations
        over every hop the request rode."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not served within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._levels, self._iters_run, self._latency_s


class _Item:
    """One request's dispatch-side state, COLD or WARM in one shape (the
    per-row `levels0` select needs rows of both kinds in one batch):

      * cold, `levels is None`: the forward builds its own init;
      * warm from the session cache, `warm_src == "cache"`: levels is the
        stream's previous converged state (a CPU tensor in the serving
        dtype), the full budget remains;
      * warm from pool pages, `warm_src == "pages"`: `pages` is the
        pinned PageHit;
      * a continuation straggler, `warm_src == "cont"`: levels is this
        request's own mid-flight state, `executed` iterations already
        run, `hops` continuation dispatches taken.

    The image rides every hop; `redispatches` counts failover hand-offs.
    `parent_span` is the span this item's NEXT record parents to — the
    submit root initially, then the last dispatch/failover span it rode;
    `dispatch_ms` accumulates the rounded per-hop dispatch latencies so
    the resolve leaf's total reconciles EXACTLY with the hop records."""

    __slots__ = (
        "img", "ticket", "session", "levels", "executed", "hops",
        "redispatches", "warm_src", "parent_span", "dispatch_ms",
        "n_patches", "pages", "patches", "t_enq", "phase_ms",
        "slo_class",
    )

    def __init__(
        self, img: np.ndarray, ticket: Ticket, session=None,
        n_patches: Optional[int] = None,
    ):
        self.img = img
        self.ticket = ticket
        self.session = session
        self.levels: Optional[torch.Tensor] = None
        self.executed = 0  # column iterations run so far
        self.hops = 0      # continuation dispatches so far
        self.redispatches = 0
        # None | "cache" (host tensor) | "cont" (straggler) | "pages"
        # (device-resident pool pages, serve/paged_columns.py)
        self.warm_src: Optional[str] = None
        self.parent_span = ticket.span_id
        self.dispatch_ms = 0.0
        self.n_patches = n_patches  # ragged: this row's patch count
        self.pages = None           # pages-warm: the pinned PageHit
        self.patches = None         # delta mode: host-patchified input
        # When this item last ENTERED a queue (batcher clock): the
        # dispatch phase split's queue_wait anchor — reset on every
        # re-enqueue (continuation, failover requeue), so each hop's
        # queue_wait measures ITS OWN wait, not the request's lifetime.
        self.t_enq = 0.0
        # Per-phase accumulation across hops (the rounded per-hop values,
        # in hop order) — the resolve leaf's phase_ms_total, conserved
        # bit-exactly by `telemetry trace` (tracectx.PHASE_KEYS).
        self.phase_ms: dict = {}
        # The ticket's SLO class, mirrored on the item so the class
        # scheduler routes requeues/continuations without touching the
        # ticket (serve/qos.py; None = classless).
        self.slo_class = ticket.slo_class


def _bind_device(engine) -> None:
    """The current CUDA device is per thread in torch: a worker or
    probation thread binds its engine's device before it dispatches."""
    dev = getattr(engine, "device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda":
        torch.cuda.set_device(dev)


def _backend_down() -> bool:
    from glom_tpu_torch.telemetry.watchdog import backend_record

    return backend_record().get("backend_state") == "down"



class DynamicBatcher:
    """The admission scheduler in front of one or more InferenceEngines.

    Lifecycle: use as a context manager (or start()/stop()). submit() is
    thread-safe and returns a Ticket; one worker thread PER ENGINE
    gathers, pads, and dispatches from the shared queue. `engine` needs
    .infer(imgs, n_valid) -> ServeResult and .pick_bucket(n) (a fake
    engine drives the policy with no device). Pass
    `engines=[...]` (or a list as the first argument) for multi-engine
    fan-out behind one admission queue.
    """

    def __init__(
        self,
        engine=None,
        *,
        engines: Optional[List] = None,
        max_batch: Optional[int] = None,
        max_delay_ms: Optional[float] = None,
        queue_depth: Optional[int] = None,
        writer=None,
        shed_when_down: bool = True,
        ladder=None,
        engine_fail_threshold: int = 2,
        max_redispatch: int = 2,
        column_cache=None,
        rejoin_threshold: Optional[int] = None,
        rejoin_interval_ms: Optional[float] = None,
        trace: Optional[bool] = None,
        phase_split: Optional[bool] = None,
        clock=time.perf_counter,
    ):
        if (engine is None) == (engines is None):
            raise ValueError("exactly one of engine= or engines=[...]")
        if engines is None:
            engines = list(engine) if isinstance(engine, (list, tuple)) else [
                engine
            ]
        if not engines:
            raise ValueError("engines must be non-empty")
        self.engines = list(engines)
        self.engine = self.engines[0]  # single-engine compatibility alias
        scfg = getattr(self.engine, "scfg", None)
        self.max_batch = (
            max_batch if max_batch is not None
            else (scfg.max_batch if scfg else 8)
        )
        self.max_delay_s = (
            max_delay_ms if max_delay_ms is not None
            else (scfg.max_delay_ms if scfg else 5.0)
        ) / 1e3
        depth = (
            queue_depth if queue_depth is not None
            else (scfg.queue_depth if scfg else 64)
        )
        if self.max_batch < 1:
            raise ValueError(f"max_batch {self.max_batch} must be >= 1")
        if engine_fail_threshold < 1:
            raise ValueError(
                f"engine_fail_threshold {engine_fail_threshold} must be >= 1"
            )
        self.writer = writer
        self.shed_when_down = shed_when_down
        self.engine_fail_threshold = engine_fail_threshold
        self.max_redispatch = max_redispatch
        # Request-scoped tracing (telemetry/tracectx.py): None resolves
        # from the lead engine's ServeConfig (trace_requests, default ON).
        # When off, the trace-context keys still stamp as null — an
        # explicitly UNTRACED record lints; an absent key would not.
        self._trace = (
            trace if trace is not None
            else bool(getattr(scfg, "trace_requests", True)) if scfg else True
        )
        # Latency decomposition (schema v7): every dispatch record splits
        # latency_ms into queue_wait/pack/h2d/device/resolve, and
        # latency_ms is defined as the left-to-right float sum of the
        # rounded phase values (tracectx.PHASE_KEYS order); the
        # per-request resolve leaf accumulates the same values per phase.
        # None resolves from the lead engine's ServeConfig (phase_split);
        # off stamps the keys as null and latency_ms is the bare engine
        # dispatch wall.
        self._phase_split = (
            phase_split if phase_split is not None
            else bool(getattr(scfg, "phase_split", True)) if scfg else True
        )
        # Page pools (serve/paged_columns.py): engines carrying a device
        # page pool switch the session cache to PAGES mode — entries are
        # page-table references, warm dispatches take pages in-graph,
        # and session AFFINITY routes a stream to the engine holding its
        # pages. Ragged admission (scfg.ragged) packs mixed-resolution
        # requests onto the page axis.
        self._pools = {
            self._ename(eng, i): eng.pool
            for i, eng in enumerate(self.engines)
            if getattr(eng, "pool", None) is not None
        }
        self._ragged = bool(getattr(scfg, "ragged", False)) if scfg else False
        # Streaming warm-start column cache (serve/column_cache.py):
        # None RESOLVES from the lead engine's ServeConfig
        # (column_cache_bytes > 0 builds one) — the ladder pattern. Pass
        # an explicit ColumnCache to own the knobs/clock (tests do).
        if column_cache is None:
            from glom_tpu_torch.serve.column_cache import resolve_column_cache

            column_cache = resolve_column_cache(
                scfg, writer=writer, pools=self._pools or None
            )
        self.cache = column_cache
        if (
            self.cache is not None
            and getattr(self.cache, "pools", None) is not None
        ):
            # Pages mode must cover the WHOLE fleet: a pool-less engine
            # would receive PageHits its host-path dispatch cannot use
            # (and its write-backs have no pool to land in) — a config
            # error, caught loudly here rather than as a mid-traffic
            # worker crash.
            missing = [
                self._ename(eng, i)
                for i, eng in enumerate(self.engines)
                if self._ename(eng, i) not in self.cache.pools
            ]
            if missing:
                raise ValueError(
                    f"pages-mode column cache but engines {missing} carry "
                    "no page pool — mixed pool/pool-less fleets are "
                    "unsupported (give every engine page_pool_pages, or "
                    "none)"
                )
        # Engine REJOIN after recovery: a dead engine's worker hands off
        # to a PROBATION thread that health-dispatches until
        # rejoin_threshold consecutive successes re-admit the engine
        # (stamped engine_rejoin). 0 (the default) keeps death terminal.
        self._rejoin_threshold = (
            rejoin_threshold if rejoin_threshold is not None
            else (getattr(scfg, "rejoin_threshold", 0) if scfg else 0)
        )
        self._rejoin_interval_s = (
            rejoin_interval_ms if rejoin_interval_ms is not None
            else (getattr(scfg, "rejoin_interval_ms", 200.0) if scfg else 200.0)
        ) / 1e3
        if self._rejoin_threshold < 0:
            raise ValueError(
                f"rejoin_threshold {self._rejoin_threshold} must be >= 0"
            )
        # Degradation ladders (resilience/ladder.py), one PER
        # ENGINE: each engine's worker feeds its own ladder queue pressure
        # + backend state, a capped_iters-or-worse rung dispatches with
        # the degraded fixed budget, a bucket_cap-or-worse rung gathers
        # smaller batches, and admission sheds only when EVERY live
        # engine's ladder is on its shed rung. ladder=None RESOLVES from
        # each engine's ServeConfig (scfg.ladder=True builds one — a
        # config that asks for the ladder must never be silently
        # two-mode); pass an explicit instance (single-engine only) to
        # own the knobs.
        self._ladders = {}
        for i, eng in enumerate(self.engines):
            name = self._ename(eng, i)
            escfg = getattr(eng, "scfg", None)
            if ladder is not None:
                if len(self.engines) > 1:
                    raise ValueError(
                        "pass ladder= with a single engine only; "
                        "multi-engine ladders resolve per engine from "
                        "ServeConfig.ladder"
                    )
                self._ladders[name] = ladder
            elif (
                escfg is not None
                and getattr(escfg, "ladder", False)
                and getattr(eng, "cfg", None) is not None
            ):
                from glom_tpu_torch.resilience.ladder import DegradationLadder

                self._ladders[name] = DegradationLadder.from_config(
                    eng.cfg, escfg, writer=writer
                )
            else:
                self._ladders[name] = None
        self.ladder = self._ladders[self._ename(self.engines[0], 0)]
        self._clock = clock
        # Multi-tenant QoS (serve/qos.py): a ServeConfig that declares
        # slo_classes swaps the shared FIFO for the deficit-weighted-fair
        # class scheduler, per-class bounded lanes behind the same
        # queue.Queue facade (get/get_nowait/put_nowait/qsize/empty/
        # maxsize), so every gather/requeue/drain path below reads one
        # queue either way. A classless config keeps the plain
        # queue.Queue.
        self._qos = None
        if scfg is not None and getattr(scfg, "slo_classes", None):
            from glom_tpu_torch.serve.qos import ClassQueues, resolve_slo_classes

            self._qos = resolve_slo_classes(scfg)
            self._q = ClassQueues(self._qos, default_depth=depth)
        else:
            self._q: queue.Queue = queue.Queue(maxsize=depth)
        # SESSION-AFFINITY queues (pages mode): one per engine. A stream
        # whose pages live in engine E's pool routes to E's queue — its
        # worker drains it ahead of the shared queue, so the warm path
        # actually finds its pages on the engine that holds them. A full
        # affinity queue (or a dead target) falls back to the shared
        # queue: affinity is a fast path, never a trap.
        self._aff_q = {
            self._ename(eng, i): queue.Queue(maxsize=depth)
            for i, eng in enumerate(self.engines)
        }
        # Continuation queue: one GROUP (list of warm _Item sharing a
        # source dispatch) per entry. Unbounded:
        # its population is bounded by admitted-but-unresolved requests,
        # which the admission queue already bounds.
        self._cont_q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.spans = SpanAggregator()
        # Per-engine dispatch bookkeeping. LOCK ORDER: _engine_lock
        # before _counter_lock (see module docstring) — the nested
        # acquisition in _note_dispatch/_note_failure is the pattern the
        # lock-order checker verifies stays acyclic.
        self._engine_lock = threading.Lock()
        self._engine_state = {
            self._ename(eng, i): {
                "alive": True,
                "dispatches": 0,
                "consecutive_failures": 0,
                "probation": False,
                "rejoins": 0,
            }
            for i, eng in enumerate(self.engines)
        }
        # Counters for the end-of-run summary record. n_requests counts
        # every submit() ATTEMPT (n_submitted only the admitted ones), so
        # chaos runs can assert conservation: every request is served,
        # shed, or failed — never lost, never hung.
        self.n_requests = 0
        self.n_submitted = 0
        self.n_served = 0
        self.n_shed = 0
        self.n_failed = 0
        self.n_degraded = 0   # requests served on a capped-iters rung
        self.n_continued = 0  # straggler re-bucket hops taken
        self.n_redispatched = 0  # engine-failover hand-offs
        self.n_folded = 0     # fresh rows folded into warm-group dispatches
        self.n_rejoined = 0   # engines re-admitted after probation
        self.n_affinity = 0   # requests routed by session affinity
        self.n_page_warm = 0  # rows warm-started from pool pages
        self.n_incremental = 0  # rows served on the incremental route
        # Per-SLO-class conservation counters: lazily keyed by the class
        # names seen, each holding the served/shed/failed/degraded
        # ledger, so conservation reconciles per class (n_served + n_shed
        # + n_failed == n_requests within every class). Guarded by
        # _counter_lock like its siblings.
        self._class_counts: dict = {}
        # Pad-tax rollup: the summary carries the mean dispatch pad
        # fraction and the bytes the padding wasted (pad token positions
        # x per-token column bytes); levels0 upload bytes aggregate
        # alongside (zero on the paged warm path).
        self._pad_fraction_sum = 0.0
        self._pad_bytes_wasted = 0
        self._levels0_h2d_bytes = 0
        # Per-phase latency sums across dispatches (the summary's
        # latency_phases rollup: mean ms per phase per dispatch).
        self._phase_sums: dict = {}
        # The most recent request's [c, H, W] shape — what the probation
        # health probe dispatches (engine-agnostic: the batcher never
        # assumes a model config). Guarded by _counter_lock: submit()
        # writes it, the probation thread reads it.
        self._probe_shape = None
        # Fairness: under slow paced traffic one worker can win every
        # 50ms-timeout
        # first-get race for seconds at a time — its loop re-enters get()
        # microseconds after a dispatch while the sibling's expired wait
        # re-queues behind it, and per-engine utilization phase-locks on
        # one engine. Two deterministic counters break the lock: the
        # worker that won the LAST first-get defers a small handicap when
        # the queue is idle (so an already-waiting sibling is first in
        # the queue's waiter list when the next request lands), and each
        # worker's first-get timeout carries a per-engine jitter so
        # equally-idle workers never expire in phase. _last_pickup rides
        # _counter_lock (worker threads write AND read it).
        self._last_pickup: Optional[str] = None
        self._pickup_handicap_s = 0.004
        self._engine_index = {
            self._ename(eng, i): i for i, eng in enumerate(self.engines)
        }
        self.dispatches: List[dict] = []  # one dict per dispatched batch
        # Per-request accounting, maintained INCREMENTALLY (a long-running
        # server must not retain one record per resolved request):
        # histogram of total executed iters, the same split by tier
        # (0 = resolved by the first dispatch, k = after k continuation
        # hops), and the running sum for the mean — the measurement units
        # of the two-tier win.
        self._iters_hist: dict = {}
        self._iters_hist_by_tier: dict = {}
        self._iters_total = 0
        self._counter_lock = threading.Lock()
        self._seq = 0
        # Elastic fleet state (serve/elastic.py). Draining engines stop
        # admitting but are not dead (their in-flight work flushes);
        # drained engines have left the fleet voluntarily, kept in
        # `engines`/`_engine_state` as evidence husks (index math and the
        # summary's engines nest stay stable) but excluded from capacity
        # records, worker spawns and the failover fleet-size accounting.
        # Both ride _engine_lock with the rest of the engine state.
        self._draining: set = set()
        self._drained: set = set()
        # Affinity items a draining worker handed back to the shared
        # queue on its way out (read by drain_engine's flush event).
        self._drain_handoff: dict = {}
        # Event taps: each stamped serve record fans out to every tap
        # after delivery (the autoscaler's in-process SLO monitor rides
        # one). A tap never takes down a worker: exceptions are swallowed.
        self._taps: List = []
        # The attached Autoscaler (None = static fleet, the default):
        # summary_record() nests its rollup under "elastic".
        self._elastic = None
        # Per-request admission events (schema v9, serve/workload.py):
        # armed by enable_admission_events() at setup time; off, the hot
        # path pays one boolean read.
        self._admit_events = False
        # Drained-husk retention: a long-lived elastic server accumulates
        # one evidence husk per scale-in. When the lead ServeConfig bounds
        # retention (husk_max / husk_max_age_s; None keeps all), the
        # oldest husks retire: removed from `engines`/`_engine_state`,
        # their counters folded into the _husks_retired rollup and stamped
        # as an `engine_husk_retired` event, so summary conservation still
        # reconciles. The state half rides _engine_lock; the container
        # half follows add_engine's single-atomic-op convention
        # (see _prune_husks).
        self._husk_max = getattr(scfg, "husk_max", None) if scfg else None
        self._husk_max_age_s = getattr(scfg, "husk_max_age_s", None) if scfg else None
        self._husk_drained_at: dict = {}  # name -> batcher-clock drain time
        self._husks_retired: dict = {
            "n": 0, "dispatches": 0, "rejoins": 0, "age_s_max": 0.0,
        }

    @staticmethod
    def _ename(eng, i: int) -> str:
        return getattr(eng, "name", None) or f"engine{i}"

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "DynamicBatcher":
        with self._counter_lock:
            started = bool(self._threads)
        if not started:
            self._stop.clear()
            for i, eng in enumerate(self.engines):
                name = self._ename(eng, i)
                with self._engine_lock:
                    if name in self._drained:
                        continue  # a drained husk never serves again
                t = threading.Thread(
                    target=self._worker,
                    args=(eng, name),
                    name=f"glom-serve-batcher-{name}",
                    daemon=True,
                )
                t.start()
                # _threads rides _counter_lock everywhere: the probation
                # path appends a revived engine's worker from ITS thread,
                # so the list is no longer caller-thread-only.
                with self._counter_lock:
                    self._threads.append(t)
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the workers. drain=True serves what is already queued
        first (the graceful path; stragglers resolve with their current
        state rather than opening new continuation hops); False fails
        queued requests FAST — both queues are drained and every ticket
        failed BEFORE waiting on the workers, so at most the in-flight
        batches dispatch after the call. Also safe on a never-started
        batcher: queued tickets are failed (drain=False) — there is no
        worker to ever resolve them. Probation threads (engine rejoin)
        observe the stop flag and exit on their next tick."""
        self._stop.set()
        if not drain:
            self._fail_queued()
        with self._counter_lock:
            threads = list(self._threads)
        for t in threads:
            # drain=True: a worker exits once the stop flag is set AND
            # both queues are empty — queued work is served on the way out.
            t.join(timeout=60.0)
        with self._counter_lock:
            self._threads = []
        # Whatever is STILL queued (drain=True with a dead/timed-out
        # worker, or a never-started batcher) can no longer resolve.
        self._fail_queued()

    def _fail_queued(self) -> None:
        while True:
            got = None
            try:
                got = [self._q.get_nowait()]
            except queue.Empty:
                try:
                    got = self._cont_q.get_nowait()  # a continuation group
                except queue.Empty:
                    for aq in list(self._aff_q.values()):
                        try:
                            got = [aq.get_nowait()]
                            break
                        except queue.Empty:
                            continue
                    if got is None:
                        return
            # Counted as FAILED: these tickets were admitted (n_submitted
            # incremented) and can no longer resolve — without the count,
            # summary_record()'s conservation (n_served + n_shed +
            # n_failed == n_requests) silently loses them.
            for item in got:
                with self._counter_lock:
                    self.n_failed += 1
                    self._bump_class_locked(item.ticket.slo_class, "n_failed")
                item.ticket._fail(ShedError("batcher stopped"))

    def __enter__(self) -> "DynamicBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission --------------------------------------------------------

    def _alive_engines(self) -> List[str]:
        """Engines that can take new work: alive and not draining (a
        draining engine still flushes its in-flight dispatch, but
        admission, affinity routing and the ladder-shed vote stop seeing
        it)."""
        with self._engine_lock:
            return [
                n for n, st in self._engine_state.items()
                if st["alive"] and n not in self._draining
            ]

    def n_active_engines(self) -> int:
        """The live serving fleet size (alive, not draining): the count
        the elastic policy clamps against."""
        return len(self._alive_engines())

    def engine_by_name(self, name: str):
        idx = self._engine_index.get(name)
        return self.engines[idx] if idx is not None else None

    def add_event_tap(self, tap) -> None:
        """Subscribe `tap(stamped_record)` to every record this batcher
        emits — the autoscaler's in-process SLO monitor reads the same
        stream `telemetry watch` would tail, with no file between.
        Registration is SETUP-time (before traffic): the list is
        append-only and the emit path reads a snapshot, so the hot path
        pays no lock for the common zero-tap case."""
        self._taps.append(tap)

    def enable_admission_events(self) -> None:
        """Arm per-request ADMISSION evidence (schema v9, the workload
        observatory — serve/workload.py): every submit() emits one
        compact "admit" event BEFORE the shed checks (a shed request was
        still OFFERED, and a replay must re-offer it), carrying arrival
        time, shape signature, and session; every ticket's terminal
        emits a "settle" event ("served" | "failed") via the ticket
        callback, so the recorder stitches outcomes without a hook at
        every failure site. Setup-time like add_event_tap; the un-armed
        hot path pays one boolean read."""
        self._admit_events = True

    def _signature(self, img, session_id) -> str:
        """The request's SHAPE CLASS — the unit a workload replay
        re-offers and the forecast buckets by: ragged admission priced
        per page ("ragged:<N>p"), delta streaming per session frame
        ("delta:CxHxW"), everything else by its image dims
        ("bucket:CxHxW"). Computed from np.shape WITHOUT converting the
        input (the admit event precedes the shed checks, which must not
        pay an asarray); malformed shapes fall through to the bucket
        form — submit's own validation raises the loud error."""
        shape = tuple(np.shape(img))
        dims = "x".join(str(int(d)) for d in shape)
        if self._ragged and len(shape) == 3:
            try:
                cfg = getattr(self.engine, "cfg", None)
                p = cfg.patch_size
                tokens = (shape[1] // p) * (shape[2] // p)
                pool = next(iter(self._pools.values()), None)
                if pool is not None:
                    pt = pool.page_tokens
                else:
                    from glom_tpu_torch.serve.paged_columns import resolve_page_tokens

                    pt = resolve_page_tokens(cfg, self.engine.scfg)
                pages = max(1, -(-tokens // pt))
                return f"ragged:{pages}p"
            except Exception:  # noqa: BLE001 — evidence, not validation
                return f"ragged:{dims}"
        scfg = getattr(self.engine, "scfg", None)
        if session_id is not None and getattr(
            scfg, "delta_streaming", False
        ):
            return f"delta:{dims}"
        return f"bucket:{dims}"

    def _settle_event(self, ticket: Ticket, outcome: str) -> None:
        """The per-request terminal leaf of the armed admission stream
        (Ticket._settled calls it exactly once, whichever path got
        there). Sheds keep their richer "shed" leaf; the recorder
        prefers it over the settle's "failed"."""
        self._emit(
            {
                "event": "settle",
                "request_id": ticket.request_id,
                "outcome": outcome,
                "latency_ms": (
                    round(1e3 * ticket._latency_s, 3)
                    if ticket._latency_s is not None else None
                ),
                "trace_id": ticket.trace_id,
                "slo_class": ticket.slo_class,
            }
        )

    def _bump_class_locked(self, slo_class, key: str, n: int = 1) -> None:
        """Advance one per-class conservation counter. Caller HOLDS
        _counter_lock (the sites all sit inside existing counter-lock
        blocks; taking it here would deadlock — threading.Lock is not
        reentrant). Unclassed requests (None) stay aggregate-only."""
        if slo_class is None:
            return
        c = self._class_counts.get(slo_class)
        if c is None:
            c = self._class_counts[slo_class] = {
                "n_requests": 0, "n_served": 0, "n_shed": 0,
                "n_failed": 0, "n_degraded": 0,
            }
        c[key] += n

    def submit(self, img, session_id=None, slo_class=None) -> Ticket:
        """Enqueue one [c, H, W] request. Sheds immediately (raises) when
        the queue is full, the backend is down, every engine is dead, or
        every live engine's degradation ladder is on its shed rung —
        admission never blocks the caller. Requests submitted before
        start() queue up and are served once the workers run; stop()
        fails whatever can no longer resolve, so a ticket is never
        silently stranded.

        `session_id` marks the request as one frame of a STREAM: at
        dispatch the worker warm-starts it from the session's cached
        column state when one is resident (serve/column_cache.py), and
        on resolve the converged columns are written back under the key
        for the stream's next frame. None (the default) is the
        stateless cold path.

        `slo_class` names the request's SLO class (serve/qos.py): under a
        ServeConfig declaring
        slo_classes it routes admission through the class's bounded lane
        and the weighted-fair pick (None takes the default class; an
        UNDECLARED name raises ValueError before any counter moves). A
        classless config stamps the label on the request's records as
        pure observability — scheduling stays byte-for-byte FIFO."""
        if self._qos is not None:
            # Resolve BEFORE any counter or event: an unknown class is a
            # caller bug, not traffic — it must not dent conservation.
            slo_class = self._qos.resolve(slo_class)
        elif slo_class is not None:
            slo_class = str(slo_class)
        with self._counter_lock:
            self._seq += 1
            rid = self._seq
            self.n_requests += 1
            self._bump_class_locked(slo_class, "n_requests")
        # Mint the request's trace context HERE, at admission: trace_id
        # names the causal tree, span_id is the submit root every
        # first-hop record parents to (telemetry/tracectx.py). Tracing
        # off mints nothing — downstream records stamp the keys as null.
        if self._trace:
            ticket = Ticket(
                rid,
                trace_id=tracectx.new_trace_id(),
                span_id=tracectx.new_span_id(),
                slo_class=slo_class,
            )
        else:
            ticket = Ticket(rid, slo_class=slo_class)
        if self._admit_events:
            # The workload observatory's arrival record: emitted BEFORE
            # the shed checks — a shed request was offered traffic, and
            # a replay must re-offer it. np.shape reads lists
            # and arrays alike; conversion stays where it was.
            ticket._settle_cb = self._settle_event
            self._emit(
                {
                    "event": "admit",
                    "request_id": rid,
                    "t": round(self._clock(), 6),
                    "signature": self._signature(img, session_id),
                    "shape": [int(d) for d in np.shape(img)],
                    "session": session_id,
                    "trace_id": ticket.trace_id,
                    "slo_class": slo_class,
                }
            )
        with span("serve_enqueue", aggregator=self.spans):
            if self.shed_when_down and _backend_down():
                # trace_id rides the exception's detail too, so a caller
                # stamping its own failure record (the CLI's response)
                # can join it to the shed leaf without holding the ticket.
                detail = dict(self._pressure(), trace_id=ticket.trace_id)
                self._shed(ticket, "backend-down", **detail)
                raise BackendDownError(
                    "backend watchdog reports the accelerator down; "
                    "request shed (fast-fail, never a hang)",
                    **detail,
                )
            alive = self._alive_engines()
            with self._counter_lock:
                started = bool(self._threads)
            if started and not alive:
                detail = dict(self._pressure(), trace_id=ticket.trace_id)
                self._shed(ticket, "no-live-engine", **detail)
                raise ShedError(
                    "every engine is dead (failover exhausted); request "
                    "shed fast rather than stranded",
                    **detail,
                )
            live_ladders = [
                self._ladders[n] for n in (alive or list(self._ladders))
                if self._ladders.get(n) is not None
            ]
            if live_ladders:
                from glom_tpu_torch.resilience.ladder import SHED

                # Class-aware shed gate (serve/qos.py): the
                # first class in the shed order sheds a rung EARLY, the
                # premium end holds until the ladder's own floor — load
                # drops tenant-by-tenant. Classless keeps the SHED gate.
                shed_gate = SHED
                if self._qos is not None:
                    shed_gate = self._qos.shed_rung(slo_class)
                if min(l.rung() for l in live_ladders) >= shed_gate:
                    detail = dict(self._pressure(), trace_id=ticket.trace_id)
                    self._shed(ticket, "ladder-shed", **detail)
                    cls_note = (
                        f" for class {slo_class!r}"
                        if self._qos is not None else ""
                    )
                    raise LadderShedError(
                        f"degradation ladder at its shed rung{cls_note} "
                        "on every live engine (every cheaper serving "
                        "mode exhausted); retry later",
                        **detail,
                    )
            img = np.asarray(img, np.float32)
            n_patches = None
            if self._ragged:
                n_patches = self._ragged_patch_count(img)
            # SESSION AFFINITY (pages mode): a stream whose pages live
            # in a LIVE engine's pool routes to that engine's queue —
            # the warm path must reach the pool that holds the state.
            # Cold streams (and dead/unknown targets) ride the shared
            # queue's least-depth dispatch as always.
            target = None
            if (
                session_id is not None
                and self.cache is not None
                and self._pools
            ):
                t = self.cache.engine_of(session_id)
                if t is not None and t in alive and t in self._aff_q:
                    target = t
            # Count the admission BEFORE the put (rolled back on a full
            # queue): the instant the request is enqueued a worker may
            # serve it, and n_served must never exceed n_submitted even
            # transiently (the race harness caught both orderings that
            # counted after the put as off-by-ones).
            with self._counter_lock:
                self.n_submitted += 1
                self._probe_shape = img.shape
            item = _Item(img, ticket, session_id, n_patches=n_patches)
            item.t_enq = self._clock()
            placed = False
            if target is not None:
                try:
                    self._aff_q[target].put_nowait(item)
                    placed = True
                    with self._counter_lock:
                        self.n_affinity += 1
                except queue.Full:
                    pass  # fall back to the shared queue
                if placed:
                    # Race with a concurrent death or drain: the failure
                    # handler sets alive=False (and drain_engine the
                    # draining flag) before draining the affinity queue,
                    # so either that drain saw this put, or we see the
                    # flag here and drain ourselves; the ticket never
                    # strands in a queue no worker reads (a draining
                    # worker has stopped reading its queue by the time
                    # the flag is set).
                    with self._engine_lock:
                        serving = (
                            self._engine_state[target]["alive"]
                            and target not in self._draining
                        )
                    if not serving:
                        self._drain_affinity(target)
            if not placed:
                try:
                    self._q.put_nowait(item)
                except queue.Full:
                    with self._counter_lock:
                        self.n_submitted -= 1
                    detail = dict(
                        self._pressure(), trace_id=ticket.trace_id
                    )
                    self._shed(ticket, "queue-full", **detail)
                    raise QueueFullError(
                        f"request queue at capacity ({self._q.maxsize}); "
                        "backpressure — retry later",
                        **detail,
                    ) from None
            with self._counter_lock:
                threads = list(self._threads)
            if self._stop.is_set() and not any(
                t.is_alive() for t in threads
            ):
                # Race with stop(): the put landed after the (dead or
                # never-started) workers' final drain — no one will ever
                # dispatch it, so fail it here rather than strand the
                # ticket. A LIVE draining worker still owns the queue.
                self._fail_queued()
                raise ShedError("batcher stopped")
        return ticket

    def _ragged_patch_count(self, img: np.ndarray) -> int:
        """Validate a ragged-mode request's shape and return its patch
        count: [c, H, W] with H and W multiples of the patch size and at
        most the full-resolution patch count (the pos table bounds a
        row's length)."""
        cfg = getattr(self.engine, "cfg", None)
        if cfg is None or img.ndim != 3:
            raise ValueError(
                f"ragged submit needs a [c, H, W] image; got {img.shape}"
            )
        p = cfg.patch_size
        c, h, w = img.shape
        if c != cfg.channels or h % p or w % p or h < p or w < p:
            raise ValueError(
                f"ragged image {img.shape}: channels must be "
                f"{cfg.channels} and H, W multiples of patch_size {p}"
            )
        n = (h // p) * (w // p)
        if n > cfg.num_patches:
            raise ValueError(
                f"{n} patches exceed the model's {cfg.num_patches} (the "
                "pos table bounds the row length)"
            )
        return n

    def _pressure(self, engine_name: Optional[str] = None) -> dict:
        """The machine-readable WHY of a shed/ladder decision: queue depth
        and capacity, plus the ladder rung when one is attached — these
        fields ride both the stamped record and the raised exception
        (before this, the shed path lost the why)."""
        detail = {
            "queue_depth": self._q.qsize(),
            "queue_capacity": self._q.maxsize,
            "continuations_queued": self._cont_q.qsize(),
        }
        if self._qos is not None:
            # Per-class lane pressure (serve/qos.py): which
            # tenant's lane is actually full — the aggregate depth alone
            # reads one story for every class.
            detail["class_depth"] = {
                n: f["depth"] for n, f in self._q.class_fill().items()
            }
        ladder = self._ladders.get(
            engine_name or self._ename(self.engines[0], 0)
        )
        if ladder is not None:
            detail["rung"] = ladder.rung_name()
        return detail

    def _shed(self, ticket: Ticket, reason: str, **detail) -> None:
        with self._counter_lock:
            self.n_shed += 1
            self._bump_class_locked(ticket.slo_class, "n_shed")
        detail.setdefault("trace_id", ticket.trace_id)
        detail.setdefault("slo_class", ticket.slo_class)
        exc_type = {
            "backend-down": BackendDownError,
            "ladder-shed": LadderShedError,
            "no-live-engine": ShedError,
        }.get(reason, QueueFullError)
        ticket._fail(exc_type(reason, **detail))
        # The shed decision itself is a "serve" event carrying the why
        # (queue depth / ladder rung; stamp_serve merges backend_state)
        # plus the request's trace context — a shed is this trace's
        # terminal leaf, so `telemetry trace` shows WHY the request never
        # resolved. A backend-down shed ALSO emits the schema "error"
        # record (value null, machine-readable cause) — the same
        # UNMEASURED discipline as the benches.
        rec = {
            "event": "shed",
            "reason": reason,
            "request_id": ticket.request_id,
            "trace_id": ticket.trace_id,
            **detail,
        }
        if ticket.trace_id is not None:
            rec.setdefault("span_id", tracectx.new_span_id())
            rec.setdefault("parent_span", ticket.span_id)
        self._emit(rec)
        if reason == "backend-down":
            self._emit(
                {
                    "error": "backend-down",
                    "value": None,
                    "request_id": ticket.request_id,
                    "trace_id": ticket.trace_id,
                    "note": "request shed: backend watchdog reports down",
                },
                kind="error",
            )

    # -- the workers -------------------------------------------------------

    def _ladder_observe(self, engine_name: str) -> None:
        """Feed this engine's ladder one (pressure, backend) observation.
        Runs every worker cycle — INCLUDING idle ones, so a drained queue
        steps the ladder back up even when no traffic arrives to
        dispatch."""
        ladder = self._ladders.get(engine_name)
        if ladder is None:
            return
        from glom_tpu_torch.telemetry.watchdog import backend_record

        fill = self._q.qsize() / max(1, self._q.maxsize)
        ladder.observe(
            queue_fill=fill,
            backend_state=backend_record().get("backend_state", "unknown"),
        )

    def _first_get_timeout(self, engine_name: str) -> float:
        """Per-engine jittered first-get timeout: 50ms base plus a
        deterministic per-engine offset (prime-stepped, bounded at +40%)
        so idle workers' timeout expiries drift apart instead of
        re-queueing in the same order forever."""
        idx = self._engine_index.get(engine_name, 0)
        return 0.05 * (1.0 + 0.4 * ((idx * 7) % 10) / 10.0)

    def _defer_pickup(self, engine_name: str) -> bool:
        """True when this worker should yield the next first-get: it won
        the last one, the queue is idle (the handicap must never slow a
        backed-up queue), and a live sibling exists to take the hand-off.
        Locks are taken SEQUENTIALLY in the documented engine->counter
        order (never nested here)."""
        if len(self.engines) < 2 or not self._q.empty():
            return False
        with self._engine_lock:
            has_sibling = any(
                st["alive"]
                for n, st in self._engine_state.items()
                if n != engine_name
            )
        if not has_sibling:
            return False
        with self._counter_lock:
            return self._last_pickup == engine_name

    def _gather(self, engine_name: str) -> List[_Item]:
        """Block for the first request, then gather until max_batch or the
        first request ages past max_delay — the two-knob admission. A
        ladder at bucket_cap or worse gathers smaller batches: smaller,
        faster dispatches drain a backed-up queue in bounded bites. The
        first get is fairness-rotated (see __init__): last winner defers
        a handicap on an idle queue, timeouts carry per-engine jitter."""
        max_batch = self._effective_max_batch(engine_name)
        aq = self._aff_q[engine_name]
        first = None
        try:
            # Affinity first: streams routed HERE hold pages in this
            # engine's pool — serving them elsewhere would cold-start.
            first = aq.get_nowait()
        except queue.Empty:
            pass
        if first is None:
            if self._defer_pickup(engine_name):
                time.sleep(self._pickup_handicap_s)
            try:
                first = self._q.get(
                    timeout=self._first_get_timeout(engine_name)
                )
            except queue.Empty:
                return []
            with self._counter_lock:
                self._last_pickup = engine_name
        batch = [first]
        deadline = self._clock() + self.max_delay_s
        while len(batch) < max_batch:
            try:
                batch.append(aq.get_nowait())
                continue
            except queue.Empty:
                pass
            remaining = deadline - self._clock()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _effective_max_batch(self, engine_name: str) -> int:
        """max_batch under the ladder's bucket cap (shared by _gather and
        the warm-group top-up, so both gathering paths degrade alike)."""
        max_batch = self.max_batch
        ladder = self._ladders.get(engine_name)
        if ladder is not None:
            from glom_tpu_torch.resilience.ladder import BUCKET_CAP

            if ladder.rung() >= BUCKET_CAP:
                max_batch = min(max_batch, ladder.bucket_cap)
        return max_batch

    def _top_up(self, engine_name: str, have: int) -> List[_Item]:
        """MIXED warm/cold buckets: fold whatever fresh traffic is
        ALREADY waiting into a warm continuation group, up to the
        admission ceiling — a lone straggler no longer dispatches into a
        mostly-pad bucket, and the fresh rows it pulls in skip their own
        gathering delay. Non-blocking on purpose: stragglers are the
        oldest requests in the system, so the fold never ADDS latency
        waiting for company (an empty queue keeps the lone-group
        dispatch, the pre-fold contract)."""
        added: List[_Item] = []
        limit = self._effective_max_batch(engine_name)
        while have + len(added) < limit:
            try:
                added.append(self._q.get_nowait())
            except queue.Empty:
                break
        if added:
            with self._counter_lock:
                self.n_folded += len(added)
        return added

    def _worker(self, engine, engine_name: str) -> None:
        _bind_device(engine)
        while not (
            self._stop.is_set()
            and self._q.empty()
            and self._cont_q.empty()
            and self._aff_q[engine_name].empty()
        ):
            with self._engine_lock:
                if not self._engine_state[engine_name]["alive"]:
                    break  # dead: queued work drains to siblings
                draining = engine_name in self._draining
            if draining:
                # Voluntary drain (distinct from death, never into
                # probation): the in-flight dispatch already completed
                # (the flag is checked at loop top), so hand the affinity
                # queue back to the shared queue and exit; stragglers this
                # worker produced sit in the shared continuation queue for
                # the siblings.
                handed = self._drain_affinity(engine_name)
                with self._counter_lock:
                    self._drain_handoff[engine_name] = (
                        self._drain_handoff.get(engine_name, 0) + handed
                    )
                return
            self._ladder_observe(engine_name)
            # Continuations first: stragglers are the OLDEST requests in
            # the system; waiting fresh rows fold into their bucket's pad
            # slots (per-row levels0 select in _dispatch).
            try:
                group = self._cont_q.get_nowait()
            except queue.Empty:
                group = None
            if group is not None:
                batch = list(group)
                batch.extend(self._top_up(engine_name, len(batch)))
                self._dispatch(engine, engine_name, batch)
                continue
            with span("serve_batch", aggregator=self.spans):
                batch = self._gather(engine_name)
            if not batch:
                continue
            self._dispatch(engine, engine_name, batch)
        else:
            return  # normal stop-drain exit
        # Dead-engine exit: hand off to probation when rejoin is enabled
        # (N consecutive successful health dispatches re-admit the
        # engine); otherwise death stays terminal until restart. A drained
        # or draining engine never probes: a drain whose in-flight flush
        # outlived the join timeout reaches here with alive already False,
        # its device state being released, and a rejoin would re-admit a
        # husk (_start_probation re-checks under the lock).
        with self._engine_lock:
            voluntary = engine_name in self._drained or engine_name in self._draining
        if self._rejoin_threshold > 0 and not self._stop.is_set() and not voluntary:
            self._start_probation(engine, engine_name)

    # -- engine rejoin (probation re-admit) --------------------------------

    def _start_probation(self, engine, engine_name: str) -> None:
        """Spawn the probation thread for a just-died engine (at most one
        per engine). The thread health-dispatches the smallest bucket
        until `rejoin_threshold` CONSECUTIVE successes re-admit the
        engine — a flapping engine that fails a probe starts its count
        over, so rejoin certifies sustained health, not one lucky call."""
        # Registration is ATOMIC with stop()'s thread snapshot (both ride
        # _counter_lock, nested in the documented engine->counter order):
        # either stop() already set the flag and nothing spawns, or the
        # thread lands in _threads before the snapshot and stop() joins
        # it — a probe thread can never outlive stop() untracked.
        with self._engine_lock:
            st = self._engine_state[engine_name]
            if st["alive"] or st["probation"]:
                return
            if engine_name in self._drained or engine_name in self._draining:
                return  # voluntary exit: released husks never probe back
            with self._counter_lock:
                if self._stop.is_set():
                    return
                st["probation"] = True
                t = threading.Thread(
                    target=self._probation,
                    args=(engine, engine_name),
                    name=f"glom-serve-probation-{engine_name}",
                    daemon=True,
                )
                t.start()
                self._threads.append(t)
        self._emit(
            {
                "event": "engine_probation",
                "engine": engine_name,
                "need": self._rejoin_threshold,
            }
        )

    def _probation(self, engine, engine_name: str) -> None:
        _bind_device(engine)
        ok = 0
        while not self._stop.wait(self._rejoin_interval_s):
            with self._counter_lock:
                shape = self._probe_shape
            cfg = getattr(engine, "cfg", None)
            if cfg is not None:
                # A config-carrying engine probes at its own full
                # resolution — ragged traffic's last-seen shape may be a
                # smaller canvas than the bucket signatures compile for.
                shape = (cfg.channels, cfg.image_size, cfg.image_size)
            if shape is None:
                continue  # no traffic seen yet: nothing to probe with
            try:
                bucket = engine.pick_bucket(1)
                engine.infer(np.zeros((bucket, *shape), np.float32), n_valid=1)
                ok += 1
            except BaseException:  # noqa: BLE001 — a failed probe is data
                ok = 0
                continue
            if ok < self._rejoin_threshold:
                continue
            # Re-admit: alive again with a clean failure count, its cache
            # entries long invalidated (death dropped them) — the engine
            # re-earns warm state from fresh write-backs. The stop-check,
            # the alive flip, and the worker's start+registration are ONE
            # critical section shared with stop()'s snapshot (engine ->
            # counter lock order): a stop() that already snapshotted
            # cannot miss the new worker, and a stop() that already set
            # the flag gets no worker at all: no duplicate or orphan
            # worker survives a stop()/rejoin race.
            with self._engine_lock:
                with self._counter_lock:
                    if self._stop.is_set():
                        self._engine_state[engine_name]["probation"] = False
                        return
                    st = self._engine_state[engine_name]
                    st["alive"] = True
                    st["consecutive_failures"] = 0
                    st["probation"] = False
                    st["rejoins"] += 1
                    self.n_rejoined += 1
                    worker = threading.Thread(
                        target=self._worker,
                        args=(engine, engine_name),
                        name=f"glom-serve-batcher-{engine_name}",
                        daemon=True,
                    )
                    # Started INSIDE the critical section: its first loop
                    # step blocks on _engine_lock until we release, and a
                    # joiner can never see a registered-but-unstarted
                    # thread.
                    worker.start()
                    self._threads.append(worker)
            self._emit(
                {
                    "event": "engine_rejoin",
                    "engine": engine_name,
                    "health_dispatches": ok,
                }
            )
            return
        # Stopped while still on probation: leave the engine dead.
        with self._engine_lock:
            self._engine_state[engine_name]["probation"] = False

    # -- elastic fleet (serve/elastic.py) ----------------------------------

    def attach_elastic(self, scaler) -> None:
        """Attach the Autoscaler whose rollup summary_record() nests under
        "elastic" (serve/elastic.py calls this; a static fleet never does,
        and its summary keeps its shape)."""
        with self._counter_lock:
            self._elastic = scaler

    def add_engine(
        self,
        engine,
        *,
        name: Optional[str] = None,
        detail: Optional[dict] = None,
    ) -> str:
        """Register a new engine replica at runtime: the autoscaler's
        scale-out landing. The engine must arrive warmed: admission opens
        the instant its worker starts (the autoscaler runs warmup() before
        calling this, so a spawned engine takes no admitted work before
        its warm-up returns). The worker binds the engine's CUDA device
        before its first dispatch. Registration mirrors __init__'s
        per-engine setup: ladder (from the engine's own ServeConfig),
        affinity queue, engine state, page pool (a pages-mode fleet stays
        homogeneous, loudly). `detail` merges into the stamped engine_add
        event (the autoscaler threads the owning decision_id and fleet
        through it, so the audit chains the registration to its
        decision). Returns the engine's fleet name."""
        ename = name or getattr(engine, "name", None)
        pool = getattr(engine, "pool", None)
        pages_mode = (
            self.cache is not None and getattr(self.cache, "pools", None) is not None
        )
        if pages_mode and pool is None:
            raise ValueError(
                "pages-mode fleet: a runtime-added engine must carry a "
                "page pool (mixed pool/pool-less fleets are unsupported)"
            )
        # The engine's ladder resolves outside the locks (pure config).
        ladder = None
        escfg = getattr(engine, "scfg", None)
        if (
            escfg is not None
            and getattr(escfg, "ladder", False)
            and getattr(engine, "cfg", None) is not None
        ):
            from glom_tpu_torch.resilience.ladder import DegradationLadder

            ladder = DegradationLadder.from_config(
                engine.cfg, escfg, writer=self.writer
            )
        # Phase 1, reserve the name: the state entry exists (a duplicate
        # registration is impossible from here) but reads alive=False and
        # probation=True, so admission, affinity routing, drain and the
        # capacity stream (state "probation", excluded from the headroom
        # min) all ignore the half-registered engine.
        with self._engine_lock:
            if ename is None:
                k = len(self._engine_state)
                while f"engine{k}" in self._engine_state:
                    k += 1
                ename = f"engine{k}"
            elif ename in self._engine_state:
                raise ValueError(f"engine name {ename!r} already registered")
            self._engine_state[ename] = {
                "alive": False,
                "dispatches": 0,
                "consecutive_failures": 0,
                "probation": True,
                "rejoins": 0,
            }
        # Phase 2, container registration: each is one atomic setitem or
        # append on a container no reader locks, and nothing routes to
        # the engine until phase 3 flips it alive.
        self.engines.append(engine)
        self._engine_index[ename] = len(self.engines) - 1
        self._aff_q[ename] = queue.Queue(maxsize=self._q.maxsize)
        self._ladders[ename] = ladder
        if pool is not None:
            self._pools[ename] = pool
        if pages_mode and pool is not None:
            self.cache.add_pool(ename, pool)
        # Phase 3, open admission, atomically with stop()'s thread
        # snapshot (the probation-spawn pattern): a stopped batcher keeps
        # the engine registered but spawns no worker.
        with self._engine_lock:
            st = self._engine_state[ename]
            with self._counter_lock:
                st["alive"] = True
                st["probation"] = False
                if bool(self._threads) and not self._stop.is_set():
                    t = threading.Thread(
                        target=self._worker,
                        args=(engine, ename),
                        name=f"glom-serve-batcher-{ename}",
                        daemon=True,
                    )
                    t.start()
                    self._threads.append(t)
        self._emit(
            {
                "event": "engine_add",
                "engine": ename,
                "n_engines": self.n_active_engines(),
                **(detail or {}),
            }
        )
        return ename

    def begin_drain(self, name: str, *, detail: Optional[dict] = None) -> None:
        """Enter the draining state: the engine stops admitting (it leaves
        _alive_engines, so affinity routing, the ladder-shed vote and
        failover sibling lists stop seeing it) while its worker finishes
        the in-flight dispatch and exits. Refuses loudly when the engine
        is dead, on probation, already draining, or the last live engine
        (a fleet never drains itself to zero)."""
        with self._engine_lock:
            st = self._engine_state.get(name)
            if st is None:
                raise ValueError(f"unknown engine {name!r}")
            if name in self._drained or name in self._draining:
                raise ValueError(f"engine {name} is already drained/draining")
            if not st["alive"] or st["probation"]:
                raise ValueError(
                    f"engine {name} is not drainable (dead or on "
                    "probation: drain is a voluntary transition of a "
                    "healthy engine)"
                )
            others = [
                n for n, s in self._engine_state.items()
                if n != name and s["alive"] and n not in self._draining
            ]
            if not others:
                raise ValueError(
                    f"refusing to drain {name}: it is the last live "
                    "engine (min fleet is 1)"
                )
            self._draining.add(name)
        self._emit({"event": "drain_begin", "engine": name, **(detail or {})})

    def _join_worker(self, name: str, timeout: float) -> bool:
        """Wait for `name`'s worker thread to exit (the in-flight flush).
        True when it is gone inside the timeout."""
        tname = f"glom-serve-batcher-{name}"
        deadline = time.monotonic() + timeout
        while True:
            with self._counter_lock:
                workers = [t for t in self._threads if t.name == tname and t.is_alive()]
            if not workers:
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            workers[0].join(timeout=min(0.5, remaining))

    def _migration_target(self, src: str) -> Optional[str]:
        """Where a draining engine's cache sessions land: the live
        non-draining sibling; in pages mode the one whose pool has the
        most free pages (the best chance every session fits)."""
        with self._engine_lock:
            live = [
                n for n, s in self._engine_state.items()
                if n != src and s["alive"] and n not in self._draining
            ]
        if self.cache is not None and getattr(self.cache, "pools", None):
            pooled = [
                (self._pools[n].n_pages - self._pools[n].pages_used(), n)
                for n in live
                if n in self._pools
            ]
            return max(pooled)[1] if pooled else None
        return live[0] if live else None

    def drain_engine(
        self,
        name: str,
        *,
        timeout: float = 60.0,
        detail: Optional[dict] = None,
    ) -> dict:
        """The graceful scale-in (the autoscaler's actuator, also callable
        directly), in this order:

          1. begin_drain: stop admitting (stamped drain_begin);
          2. flush: the worker finishes its in-flight dispatch, hands its
             affinity queue back to the shared queue and exits;
             stragglers it produced sit in the shared continuation queue
             for the siblings (stamped drain_flush);
          3. migrate: every cache session whose state lives on this
             engine moves to a sibling pool, device-to-device and bit for
             bit, falling back to a stamped `drain` invalidation when no
             sibling has page budget (stamped drain_migrate);
          4. the engine leaves the fleet as drained, distinct from dead
             (no probation, no failover accounting, no capacity record).

        The worker has exited by step 3 (or the flush timed out, stamped
        flush_ok False), so the migration reads the source pool after its
        last write-back; every pool write runs on the device's current
        stream, and so does the migration's copy. Device release
        (InferenceEngine.release) is the caller's step: the autoscaler
        stamps drain_release after it. Returns the drain stats. `detail`
        (the decision_id) merges into every stamped event so the evidence
        chain joins."""
        detail = dict(detail or {})
        self.begin_drain(name, detail=detail)
        t0 = time.monotonic()
        flushed = self._join_worker(name, timeout)
        # A never-started batcher has no worker to hand the affinity queue
        # back: drain it here either way.
        handed = self._drain_affinity(name)
        with self._counter_lock:
            handed += self._drain_handoff.pop(name, 0)
        self._emit(
            {
                "event": "drain_flush",
                "engine": name,
                "flush_ok": flushed,
                "n_affinity_handed_back": handed,
                "continuations_queued": self._cont_q.qsize(),
                "flush_ms": round(1e3 * (time.monotonic() - t0), 3),
                **detail,
            }
        )
        stats = {
            "engine": name,
            "flush_ok": flushed,
            "n_migrated": 0,
            "n_invalidated": 0,
            "bytes_migrated": 0,
        }
        dst = None
        if self.cache is not None:
            dst = self._migration_target(name)
            stats.update(self.cache.migrate_engine_sessions(name, dst, reason="drain"))
        # Emitted even with no cache (zero counts): the drain chain is
        # always complete.
        self._emit(
            {
                "event": "drain_migrate",
                "engine": name,
                "dst_engine": dst,
                "n_migrated": stats["n_migrated"],
                "n_invalidated": stats["n_invalidated"],
                "bytes_migrated": stats["bytes_migrated"],
                **detail,
            }
        )
        # Namedness is decided here, outside the lock (engine_by_name's
        # convention): only named husks enter _husk_drained_at and are
        # ever retirement candidates; removing an unnamed engine (a test
        # fake keyed by list index) would renumber its siblings' evidence.
        eng = self.engine_by_name(name)
        named = getattr(eng, "name", None) is not None
        with self._engine_lock:
            st = self._engine_state[name]
            st["alive"] = False
            self._draining.discard(name)
            self._drained.add(name)
            if named:
                self._husk_drained_at[name] = self._clock()
        # The drained pool leaves the fleet maps (its record would
        # otherwise ride every later summary as live capacity).
        self._pools.pop(name, None)
        if self.cache is not None:
            self.cache.remove_pool(name)
        self._prune_husks()
        return stats

    def _prune_husks(self) -> None:
        """Drained-husk retention (schema v9): bound the evidence husks a
        long-lived elastic server keeps. With husk_max and husk_max_age_s
        unset (the default) this is a no-op and every husk is kept.
        Otherwise the oldest husks past either bound retire: removed from
        `engines`/`_engine_state`/`_drained`, their counters folded into
        the _husks_retired rollup (summary_record nests it, so per-engine
        dispatch totals still reconcile against the globals), one
        `engine_husk_retired` event stamped per retirement. Unnamed
        engines are never retired."""
        if self._husk_max is None and self._husk_max_age_s is None:
            return
        now = self._clock()
        retired = []  # (name, age_s, reason, dispatches, rejoins)
        # Phase 1, select victims and retire their state under the lock.
        # Popping _engine_state is the commit point: concurrent prunes
        # race to it and the loser skips, so each husk retires exactly
        # once and the conservation fold is exact.
        with self._engine_lock:
            husks = sorted(
                (n for n in self._drained if n in self._husk_drained_at),
                key=lambda n: self._husk_drained_at[n],
            )
            marked = {}
            if self._husk_max_age_s is not None:
                for n in husks:
                    if now - self._husk_drained_at[n] > self._husk_max_age_s:
                        marked[n] = "age-bound"
            if self._husk_max is not None:
                kept = [n for n in husks if n not in marked]
                for n in kept[: max(0, len(kept) - self._husk_max)]:
                    marked[n] = "count-bound"
            for n in husks:
                if n not in marked:
                    continue
                st = self._engine_state.pop(n, None)
                if st is None:
                    continue  # a concurrent prune won the commit
                self._drained.discard(n)
                age = now - self._husk_drained_at.pop(n)
                self._drain_handoff.pop(n, None)
                fold = self._husks_retired
                fold["n"] += 1
                fold["dispatches"] += st.get("dispatches", 0)
                fold["rejoins"] += st.get("rejoins", 0)
                fold["age_s_max"] = round(max(fold["age_s_max"], age), 3)
                retired.append(
                    (n, age, marked[n], st.get("dispatches", 0), st.get("rejoins", 0))
                )
        # Phase 2, container teardown outside the lock, mirroring
        # add_engine's registration convention: the husk serves nothing
        # (phase 1 unregistered it), so the brief window where the list
        # and the index disagree is visible only to fleet observers,
        # never to a dispatch.
        for name, age, reason, dispatches, rejoins in retired:
            self._ladders.pop(name, None)
            self._aff_q.pop(name, None)
            idx = self._engine_index.get(name)
            if idx is not None:
                del self.engines[idx]
                self._engine_index = {
                    self._ename(eng, i): i for i, eng in enumerate(self.engines)
                }
            self._emit(
                {
                    "event": "engine_husk_retired",
                    "engine": name,
                    "reason": reason,
                    "age_s": round(age, 3),
                    "dispatches": dispatches,
                    "rejoins": rejoins,
                }
            )

    # -- dispatch ----------------------------------------------------------

    @staticmethod
    def _token_state_bytes(engine) -> Optional[int]:
        """Per-token column bytes (L x d x itemsize) — the pad-waste
        pricing unit. None for config-less fake engines."""
        cfg = getattr(engine, "cfg", None)
        scfg = getattr(engine, "scfg", None)
        if cfg is None or scfg is None:
            return None
        itemsize = (
            2 if getattr(scfg, "compute_dtype", "") == "bfloat16" else 4
        )
        return cfg.levels * cfg.dim * itemsize

    def _degrade_gate(self, batch) -> int:
        """The ladder rung at which THIS batch's route degrades: the
        most protected class present wins (qos.py class_rungs) — one
        premium row holds the whole dispatch at its full route until
        the ladder reaches premium's own degrade rung, while a
        pure-batch dispatch degrades at the classless rung. Classless
        configs: capped_iters, the pre-QoS semantics unchanged."""
        from glom_tpu_torch.resilience.ladder import CAPPED_ITERS

        if self._qos is None:
            return CAPPED_ITERS
        return max(self._qos.degrade_rung(it.slo_class) for it in batch)

    @staticmethod
    def _class_rows(items) -> Optional[dict]:
        """{slo_class: n_rows} over classed items — None when nothing
        is classed, so classless records stay byte-identical."""
        rows: dict = {}
        for it in items:
            if it.slo_class is not None:
                rows[it.slo_class] = rows.get(it.slo_class, 0) + 1
        return rows or None

    def _note_dispatch(self, engine_name: str, rec: dict, resolved: List[dict],
                       n_served: int, n_degraded: int, n_continued: int,
                       class_served: Optional[dict] = None) -> None:
        """Per-engine + global bookkeeping for one successful dispatch,
        under BOTH locks in the documented order — the per-engine
        dispatch count and the conservation counters must be mutually
        consistent for summary_record()'s snapshot."""
        with self._engine_lock:  # LOCK ORDER: _engine_lock -> _counter_lock
            st = self._engine_state[engine_name]
            st["dispatches"] += 1
            st["consecutive_failures"] = 0
            with self._counter_lock:
                self.n_served += n_served
                self.n_degraded += n_degraded
                if class_served:
                    # A degraded dispatch degrades EVERY row it resolves,
                    # so per-class degraded rides the same row counts.
                    for cls, k in class_served.items():
                        self._bump_class_locked(cls, "n_served", k)
                        if n_degraded:
                            self._bump_class_locked(cls, "n_degraded", k)
                self.n_continued += n_continued
                self.n_page_warm += rec.get("n_page_warm") or 0
                self.n_incremental += rec.get("n_incremental") or 0
                self._pad_fraction_sum += rec.get("pad_fraction") or 0.0
                self._pad_bytes_wasted += rec.get("pad_bytes") or 0
                self._levels0_h2d_bytes += (
                    rec.get("levels0_h2d_bytes") or 0
                )
                from glom_tpu_torch.telemetry.tracectx import PHASE_KEYS

                for k in PHASE_KEYS:
                    v = rec.get(k)
                    if isinstance(v, (int, float)):
                        self._phase_sums[k] = (
                            self._phase_sums.get(k, 0.0) + v
                        )
                self.dispatches.append(rec)
                for r in resolved:
                    key = str(r["iters"])
                    self._iters_hist[key] = self._iters_hist.get(key, 0) + 1
                    tier = self._iters_hist_by_tier.setdefault(
                        str(r["tier"]), {}
                    )
                    tier[key] = tier.get(key, 0) + 1
                    self._iters_total += r["iters"]

    def _note_failure(self, engine_name: str) -> dict:
        """One dispatch failure's engine-state transition; returns a
        snapshot {alive, siblings} the failover decision reads."""
        with self._engine_lock:  # LOCK ORDER: _engine_lock -> _counter_lock
            st = self._engine_state[engine_name]
            st["consecutive_failures"] += 1
            # The single-engine fleet never marks itself dead (it keeps
            # serving and retrying). Drained husks and draining engines
            # do not count toward the fleet size: while a sibling drains,
            # the one remaining admitting engine is the single-engine
            # fleet and keeps that contract rather than kill all
            # admission.
            fleet = len(self._engine_state) - len(self._drained) - len(self._draining)
            if (
                st["consecutive_failures"] >= self.engine_fail_threshold
                and fleet > 1
            ):
                st["alive"] = False
            siblings = [
                n for n, s in self._engine_state.items()
                if n != engine_name and s["alive"] and n not in self._draining
            ]
            return {"alive": st["alive"], "siblings": siblings}

    def _requeue(self, items) -> int:
        """Hand a failed dispatch's requests to the sibling engines via
        the shared queues; tickets whose redispatch budget is exhausted
        fail instead (bounded — a poison batch cannot ping-pong forever).
        Mixed batches split per row: continuation stragglers keep their
        mid-flight warm state (it is THEIR computed progress) and rejoin
        the continuation queue as one group; cache-warmed rows DROP their
        warmth back to cold — the failing engine's cache entries are
        being invalidated right now, and a re-dispatch must re-decide
        against the post-invalidation cache, never ride state read before
        the failure. Returns how many were requeued."""
        requeued = 0
        warm_survivors: List[_Item] = []
        for item in items:
            item.redispatches += 1
            item.t_enq = self._clock()  # next hop's queue_wait starts now
            if item.redispatches > self.max_redispatch:
                with self._counter_lock:
                    self.n_failed += 1
                    self._bump_class_locked(item.ticket.slo_class, "n_failed")
                item.ticket._fail(
                    ShedError(
                        "redispatch budget exhausted "
                        f"({self.max_redispatch}) after engine failures"
                    )
                )
                continue
            if item.warm_src in ("cache", "pages"):
                # Cache/page warmth drops to COLD on requeue: the
                # failing engine's entries (and pool pages) are being
                # invalidated right now — a re-dispatch must re-decide
                # against the post-invalidation cache.
                item.levels = None
                item.pages = None
                item.warm_src = None
            if item.levels is not None:
                warm_survivors.append(item)
                continue
            try:
                self._q.put_nowait(item)
                requeued += 1
            except queue.Full:
                with self._counter_lock:
                    self.n_failed += 1
                    self._bump_class_locked(item.ticket.slo_class, "n_failed")
                item.ticket._fail(
                    QueueFullError("requeue after engine failure: full")
                )
        if warm_survivors:
            self._cont_q.put(warm_survivors)
            requeued += len(warm_survivors)
        with self._counter_lock:
            self.n_redispatched += requeued
        return requeued

    def _drain_affinity(self, engine_name: str) -> int:
        """A dead (or draining) engine's affinity queue drains back to
        the SHARED queue (its streams serve on a sibling — cold after a
        death, still warm after a drain-migration). Tickets that no
        longer fit anywhere fail fast. Returns how many moved."""
        aq = self._aff_q.get(engine_name)
        if aq is None:
            return 0
        moved = 0
        while True:
            try:
                item = aq.get_nowait()
            except queue.Empty:
                return moved
            try:
                self._q.put_nowait(item)
                moved += 1
            except queue.Full:
                with self._counter_lock:
                    self.n_failed += 1
                    self._bump_class_locked(item.ticket.slo_class, "n_failed")
                item.ticket._fail(
                    QueueFullError("affinity drain after engine death: full")
                )

    def _ragged_chunks(self, engine, batch) -> List[list]:
        """Split a gathered ragged batch so each chunk's total pages fit
        the largest ragged signature (one chunk in the common case — the
        default ladder tops at max_batch x pages-per-full-row).

        Rung selection is PAD-AWARE, not token round-up only: packing
        one more row can escalate the chunk onto the next ladder rung,
        and on a fine ladder the escalation's round-up pad can exceed
        the pad of closing the chunk where it is and starting the row
        fresh — the one-token-overflow-doubles-the-band shape. Compare
        both pads in pages and close early only when it strictly wins
        (ties pack, preserving the coarse-ladder behavior where
        escalation is always at least as tight)."""
        from glom_tpu_torch.serve.paged_columns import resolve_page_tokens

        pool = getattr(engine, "pool", None)
        pt = (
            pool.page_tokens if pool is not None
            else resolve_page_tokens(engine.cfg, engine.scfg)
        )
        top = max(engine.ragged_page_buckets)
        chunks: List[list] = []
        cur: List = []
        pages = 0
        for it in batch:
            need = pages_for_tokens(it.n_patches, pt)
            close = False
            if cur:
                if pages + need > top:
                    close = True
                else:
                    rung_grow = engine.pick_pages(pages + need)
                    rung_cur = engine.pick_pages(pages)
                    if rung_grow > rung_cur:
                        # Escalating pad vs close-here pad: the current
                        # chunk's round-up plus the row opening its own
                        # chunk at its own rung.
                        pad_grow = rung_grow - (pages + need)
                        pad_close = (rung_cur - pages) + (
                            engine.pick_pages(need) - need
                        )
                        close = pad_grow > pad_close
            if close:
                chunks.append(cur)
                cur, pages = [], 0
            cur.append(it)
            pages += need
        if cur:
            chunks.append(cur)
        return chunks

    def _dispatch(self, engine, engine_name: str, batch) -> None:
        if self.shed_when_down and _backend_down():
            # Gathered but undispatchable: fail every ticket fast with the
            # stamped evidence: never dispatch into a dead backend, where
            # the dispatch could hang.
            for req in batch:
                self._shed(
                    req.ticket, "backend-down", **self._pressure(engine_name)
                )
            return
        if self._ragged and hasattr(engine, "infer_ragged"):
            for chunk in self._ragged_chunks(engine, batch):
                self._dispatch_traced(engine, engine_name, chunk)
            return
        self._dispatch_traced(engine, engine_name, batch)

    def _dispatch_traced(self, engine, engine_name: str, batch) -> None:
        if self._trace:
            # One span per dispatch ATTEMPT: the batch-level records of
            # this dispatch (dispatch/continuation/failover) share it, and
            # the thread-local scope hands it to every nested sink (retry
            # recovery events, cache evictions, lazy warmup compiles, host
            # spans) without signature threading. parent_spans is row-
            # aligned with the batch: each row parents to ITS previous hop
            # (the submit root on the first).
            dspan = tracectx.new_span_id()
            tfields = {
                "span_id": dspan,
                "trace_ids": [it.ticket.trace_id for it in batch],
                "parent_spans": [it.parent_span for it in batch],
            }
            with tracectx.dispatch_scope(
                dspan, tfields["trace_ids"], tfields["parent_spans"]
            ):
                self._dispatch_one(engine, engine_name, batch, dspan, tfields)
        else:
            # Untraced: the context keys still stamp — as null, so the
            # schema's presence contract holds (an explicitly untraced
            # record lints; an absent key would not).
            self._dispatch_one(
                engine, engine_name, batch, None, {"trace_ids": None}
            )

    def _phase_fields(self, queue_wait_s, pack_s, result, fetch_s):
        """(phase dict, latency_ms) for one dispatch record — THE
        latency_ms definition under phase_split: the five phases (rounded
        to 3 decimals each) summed left to right in tracectx.PHASE_KEYS
        order, so `telemetry trace`'s extended conservation check can
        recompute the exact float sum. queue_wait/pack are batcher wall;
        h2d and the engine-side resolve come from the engine's own split;
        device is the engine dispatch wall MINUS both (absorbing what the
        split cannot see — validation, retry backoff — so the phases
        always partition the whole); the batcher's host fetch of the
        result rides resolve. Split off: keys stamp null (presence, like
        the trace-context contract) and latency_ms is the bare engine
        wall — the pre-v7 reading."""
        from glom_tpu_torch.telemetry.tracectx import PHASE_KEYS

        if not self._phase_split:
            return (
                {k: None for k in PHASE_KEYS},
                round(1e3 * result.latency_s, 3),
            )
        eng_ms = 1e3 * result.latency_s
        eph = getattr(result, "phases", None) or {}
        h2d = float(eph.get("h2d_ms") or 0.0)
        eng_resolve = float(eph.get("resolve_ms") or 0.0)
        device = max(0.0, eng_ms - h2d - eng_resolve)
        phases = {
            "queue_wait_ms": round(max(0.0, 1e3 * queue_wait_s), 3),
            "pack_ms": round(max(0.0, 1e3 * pack_s), 3),
            "h2d_ms": round(h2d, 3),
            "device_ms": round(device, 3),
            "resolve_ms": round(eng_resolve + max(0.0, 1e3 * fetch_s), 3),
        }
        latency_ms = 0.0
        for k in PHASE_KEYS:
            latency_ms = latency_ms + phases[k]
        return phases, latency_ms

    def _note_item_phases(self, item, phases) -> None:
        """Accumulate one hop's rounded phase values onto the item — the
        resolve leaf's phase_ms_total, added in hop order so the
        conservation sum is bit-exact."""
        if not self._phase_split:
            return
        for k, v in phases.items():
            if isinstance(v, (int, float)):
                item.phase_ms[k] = item.phase_ms.get(k, 0.0) + v

    def _dispatch_one(
        self, engine, engine_name: str, batch, dspan, tfields
    ) -> None:
        if self._ragged and hasattr(engine, "infer_ragged"):
            self._dispatch_ragged_batch(
                engine, engine_name, batch, dspan, tfields
            )
        else:
            self._dispatch_batch(engine, engine_name, batch, dspan, tfields)

    def _handle_dispatch_failure(
        self, engine_name: str, batch, e, dspan, tfields, n: int, warm: bool
    ) -> None:
        """One dispatch failure's full consequence chain, shared by the
        bucket and ragged routes: engine-state transition, cache (and
        page) invalidation BEFORE any requeue, affinity fallback,
        sibling failover or per-ticket failure, and the stamped
        evidence. A KernelError (a kernel that failed to build or
        launch) never fails over: every sibling runs the same kernels,
        so the batch's tickets fail with it."""
        state = self._note_failure(engine_name)
        if self.cache is not None:
            # A failing engine's cache entries are suspect the moment
            # the failure is observed: drop them BEFORE any requeue
            # re-decides warmth, so stale or dead-engine state can
            # never warm-start a request. In pages mode this frees the
            # engine's pool pages, before any failover requeue.
            self.cache.invalidate_engine(engine_name)
        if not state["alive"]:
            # Streams routed here by session affinity fall back to
            # the shared queue (their pages just died with the pool).
            self._drain_affinity(engine_name)
        if state["siblings"] and not isinstance(e, KernelError):
            # FAILOVER: hand this batch to the siblings instead of
            # failing it. The failover record takes this attempt's span (the failed
            # dispatch emitted no record of its own), and the items
            # re-parent to it, so the redispatch hop is a CHILD of
            # the failover in each request's causal tree.
            if dspan is not None:
                for item in batch:
                    item.parent_span = dspan
            n_req = self._requeue(batch)
            self._emit(
                {
                    "event": "engine_failover",
                    "engine": engine_name,
                    "engine_alive": state["alive"],
                    "n_requeued": n_req,
                    "n_valid": n,
                    "warm_state": warm,
                    "exception": f"{type(e).__name__}: {e}"[:300],
                    **tfields,
                }
            )
            if not state["alive"]:
                self._emit(
                    {"event": "engine_dead", "engine": engine_name}
                )
            if not self._alive_engines():
                # The sibling snapshot raced a concurrent death: the
                # requeued batch landed in queues no live worker will
                # drain — fail it (and everything else queued) now
                # rather than strand tickets until stop().
                self._fail_queued()
            return
        with self._counter_lock:
            self.n_failed += len(batch)
            for req in batch:
                self._bump_class_locked(req.ticket.slo_class, "n_failed")
        for req in batch:
            req.ticket._fail(e)
        self._emit(
            {
                "event": "dispatch_error",
                "engine": engine_name,
                "n_valid": n,
                "exception": f"{type(e).__name__}: {e}"[:300],
                **tfields,
            }
        )
        if not state["alive"]:
            self._emit({"event": "engine_dead", "engine": engine_name})
            if not self._alive_engines():
                # The LAST engine just died: nothing will ever drain
                # the queues — fail what is waiting rather than
                # strand it until stop() (tickets stay terminal).
                self._fail_queued()

    def _dispatch_batch(
        self, engine, engine_name: str, batch, dspan, tfields
    ) -> None:
        # Phase anchors: queue_wait ends (and pack begins) the moment the
        # worker starts processing this batch; the oldest item's enqueue
        # time anchors the wait (the same "oldest request" convention the
        # max_delay admission knob uses).
        t_proc = self._clock()
        queue_wait_s = t_proc - min(
            (it.t_enq for it in batch if it.t_enq), default=t_proc
        )
        n = len(batch)
        iters_override = None
        rung_name = None
        ladder = self._ladders.get(engine_name)
        if ladder is not None:
            from glom_tpu_torch.resilience.ladder import RUNGS

            rung = ladder.rung()
            rung_name = RUNGS[rung]
            if rung >= self._degrade_gate(batch):
                iters_override = ladder.degraded_iters
        scfg = getattr(engine, "scfg", None)
        budget = getattr(engine, "auto_budget", None)
        tiered = (
            scfg is not None
            and getattr(scfg, "max_continuations", 0) > 0
            and getattr(engine, "iters_key", None) == "auto"
            and iters_override is None
            and budget is not None
        )
        # Session warm-start: a cold row carrying a session_id rides the
        # stream's cached columns when one is resident (full budget — a
        # new frame, not a continuation). Decided HERE, at dispatch, so
        # the state is the freshest write-back and a cache invalidated
        # since submit can never warm-start the row. PAGES mode: the hit
        # is a pinned PageHit — the row carries page INDICES into the
        # engine's paged signature and the columns never leave HBM; a
        # hit in a SIBLING's pool (affinity raced a failover) reads as a
        # miss here. Continuation groups skip lookups in pages mode (the
        # paged signature and the host levels0 carry are different
        # programs — folded fresh rows go cold, stamped as misses).
        pages_mode = (
            engine_name in self._pools
            and self.cache is not None
            and self.cache.pools is not None
        )
        # DELTA STREAMING (docs/SERVING.md, "Delta streaming"): a
        # delta-config pool stores base+Σdeltas chains; warm session rows
        # additionally compute their INPUT delta's page support (bitwise
        # vs the previous frame's host patches) and ride the engine's
        # incremental signature, where empty-support rows start
        # pre-converged. Threshold 0 disables the seeding (bitwise
        # contract) and the dispatch is the plain paged route.
        pool = self._pools.get(engine_name)
        delta_mode = (
            pages_mode and pool is not None and getattr(pool, "delta", False)
        )
        use_inc = (
            delta_mode
            and getattr(scfg, "delta_incremental", True)
            and getattr(engine, "iters_key", None) == "auto"
            and getattr(scfg, "exit_threshold", 0.0) > 0.0
            and iters_override is None
            and getattr(engine, "mesh", None) is None
        )
        has_cont = any(it.warm_src == "cont" for it in batch)
        n_cache_warm = n_cache_miss = 0
        hold_rows = None  # delta mode: rows whose input did not change
        pinned: List[str] = []
        if self.cache is not None:
            for it in batch:
                if (
                    it.levels is not None
                    or it.pages is not None
                    or it.session is None
                ):
                    continue
                if pages_mode:
                    if has_cont:
                        n_cache_miss += 1
                        continue
                    if delta_mode and it.patches is None:
                        # Once per row: the support comparison AND the
                        # next write-back's prev-input reference read
                        # these same host patches.
                        it.patches = _patchify_host(
                            it.img, engine.cfg.patch_size
                        )
                    hit = self.cache.lookup(it.session, pin=True)
                    full_n = engine.cfg.num_patches
                    if (
                        hit is not None
                        and getattr(hit, "engine", None) == engine_name
                        and getattr(hit, "n_tokens", None) == full_n
                    ):
                        it.pages = hit
                        it.warm_src = "pages"
                        pinned.append(it.session)
                        n_cache_warm += 1
                    else:
                        if hit is not None:
                            self.cache.unpin(it.session)
                        n_cache_miss += 1
                else:
                    hit = self.cache.lookup(it.session)
                    if hit is not None:
                        it.levels = hit
                        it.warm_src = "cache"
                        n_cache_warm += 1
                    else:
                        n_cache_miss += 1
        warm_pages = any(it.pages is not None for it in batch)
        warm = any(it.levels is not None for it in batch)
        # The remaining per-request budget caps the auto route at the
        # TIGHTEST row (min over rows of budget - executed; cold and
        # cache-warm rows have the full budget) — UNLESS a degraded
        # ladder rung pinned a fixed iters_override for this dispatch
        # (the engine rejects the combination: a fixed route has no
        # budget to cap, and the degraded budget already bounds cost).
        # Rows capped below their own remaining budget simply re-enter
        # the continuation queue with the difference — per-request
        # totals never exceed the budget.
        prior = max((it.executed for it in batch), default=0)
        try:
            bucket = engine.pick_bucket(n)
            imgs = np.zeros((bucket, *batch[0].img.shape), np.float32)
            for i, req in enumerate(batch):
                imgs[i] = req.img
            kw = {}
            if iters_override is not None:
                kw["iters_override"] = iters_override
            if warm:
                # Per-row levels0 select, the mixed warm/cold bucket: a
                # CPU tensor in the serving dtype. Warm rows carry their
                # cached or mid-flight state, cold rows the engine's own
                # cold init (bit for bit the init the forward builds);
                # pad rows stay zeros (the mask keeps them out of the
                # witness either way).
                proto = next(it.levels for it in batch if it.levels is not None)
                lv0 = torch.zeros((bucket, *proto.shape), dtype=proto.dtype)
                cold = None
                for i, it in enumerate(batch):
                    if it.levels is not None:
                        lv0[i] = it.levels
                    else:
                        if cold is None:
                            cold = engine.cold_levels()
                        lv0[i] = cold
                kw["levels0"] = lv0
                remaining = max(1, budget - prior) if budget else None
                if (
                    iters_override is None
                    and remaining is not None
                    and remaining < budget
                ):
                    kw["auto_budget"] = remaining
            elif warm_pages:
                # The paged warm path: rows carry page indices, cold rows
                # -1; the engine gathers the pool pages on the device (no
                # levels0 upload). In delta mode the indices are each
                # session's effective base + deltas map.
                ppr = engine.cfg.num_patches // pool.page_tokens
                prow = np.full((bucket, ppr), -1, np.int32)
                for i, it in enumerate(batch):
                    if it.pages is not None:
                        prow[i] = it.pages.pages
                kw["page_rows"] = prow
                if use_inc:
                    # The incremental route's seed: warm rows carry
                    # their input delta's page support, cold/miss rows
                    # full support (they behave like plain tiered exit).
                    srow = np.zeros((bucket, ppr), bool)
                    for i, it in enumerate(batch):
                        if it.pages is not None and it.patches is not None:
                            srow[i] = self.cache.input_support(
                                it.session, it.patches, pool.page_tokens
                            )
                        else:
                            srow[i] = True
                    srow[n:] = False  # pad rows: masked out anyway
                    kw["support_rows"] = srow
                    # A HOLD frame (empty input support) also skips its
                    # write-back below: an unchanged input adds nothing
                    # worth storing, and one floor-iteration of drift
                    # written back every frame would churn delta pages
                    # (and force compactions that privatize shared
                    # bases) for state the next frame reconverges to
                    # anyway. The cache stays warm with the previous
                    # entry; prev_input is unchanged by construction.
                    hold_rows = [
                        bool(it.pages is not None and not srow[i].any())
                        for i, it in enumerate(batch)
                    ]
            pack_s = self._clock() - t_proc
            with span("serve_dispatch", aggregator=self.spans):
                result = engine.infer(imgs, n_valid=n, **kw)
            for sid in pinned:
                self.cache.unpin(sid)
            pinned = []
            t_fetch = self._clock()
            with span("serve_fetch", aggregator=self.spans):
                levels = result.levels[:n].cpu()
            fetch_s = self._clock() - t_fetch
        except BaseException as e:  # noqa: BLE001 — relayed per ticket
            for sid in pinned:
                self.cache.unpin(sid)
            self._handle_dispatch_failure(
                engine_name, batch, e, dspan, tfields, n, warm or warm_pages
            )
            return

        # Resolve vs re-bucket, row by row. Stragglers (valid, unconverged,
        # budget left, hops left) carry their warm state into the
        # continuation queue as ONE group; everyone else resolves with
        # their TOTAL executed iterations (per row now — a mixed bucket's
        # rows entered with different priors) and, when the row carries a
        # session, writes its converged columns back to the cache for the
        # stream's next frame. Draining stop() opens no new hops —
        # stragglers resolve with the state they have.
        conv = result.row_converged
        stragglers: List[_Item] = []
        resolved: List[dict] = []
        n_resolved = 0
        entry_tier = max((it.hops for it in batch), default=0)
        # This hop's wall span, as the dispatch record will carry it: the
        # items accumulate EXACTLY these values (latency_ms is the
        # left-to-right float sum of the rounded phase fields under
        # phase_split — see _phase_fields), in hop order, so the resolve
        # leaf's dispatch_ms_total AND per-phase phase_ms_total equal the
        # sums of its trace's per-hop fields bit-for-bit (the
        # conservation check in telemetry/tracectx.py is exact).
        phases, latency_ms = self._phase_fields(
            queue_wait_s, pack_s, result, fetch_s
        )
        to_resolve: List[tuple] = []  # (item, row index, total iters)
        for i, it in enumerate(batch):
            executed_i = it.executed + result.iters_run
            it.dispatch_ms += latency_ms
            self._note_item_phases(it, phases)
            if dspan is not None:
                it.parent_span = dspan  # the next record parents HERE
            open_hop = (
                tiered
                and conv is not None
                and not self._stop.is_set()
                and it.hops < scfg.max_continuations
                and executed_i < budget
            )
            if open_hop and not bool(conv[i]):
                it.levels = levels[i].clone()
                it.executed = executed_i
                it.hops += 1
                it.warm_src = "cont"
                it.t_enq = self._clock()  # cont-queue wait starts now
                stragglers.append(it)
            else:
                # Write-back BEFORE resolve: the moment the caller sees
                # frame t's response it may submit frame t+1, and that
                # frame must find the cache already warm. Pages mode
                # hands the DEVICE row slice straight to the pool
                # (device-to-device — the converged columns never visit
                # the host on the way in).
                skip_store = bool(
                    hold_rows is not None and i < len(hold_rows)
                    and hold_rows[i]
                )
                if (
                    self.cache is not None
                    and it.session is not None
                    and not skip_store
                ):
                    if pages_mode:
                        ch = None
                        if delta_mode and not pool.holds(it.session):
                            # Content hash over the exact row bytes the
                            # pool will store: identical converged bases
                            # alias refcounted pool pages. Hashed from the
                            # host copy the fetch already made, and only
                            # on base creation (a session holding a block
                            # appends deltas; the pool reads no hash
                            # there).
                            ch = content_hash(levels[i])
                        self.cache.store(
                            it.session, result.levels[i],
                            engine=engine_name,
                            n_tokens=engine.cfg.num_patches,
                            patches=it.patches if delta_mode else None,
                            content_hash=ch,
                        )
                    else:
                        self.cache.store(
                            it.session, levels[i].clone(),
                            engine=engine_name,
                        )
                to_resolve.append((it, i, executed_i))
                resolved.append({"iters": executed_i, "tier": it.hops})
                n_resolved += 1
        if stragglers:
            self._cont_q.put(stragglers)
            worst = max(it.executed for it in stragglers)
            cont = {
                "event": "continuation",
                "engine": engine_name,
                "n_stragglers": len(stragglers),
                "executed_iters": worst,
                "remaining_budget": budget - worst,
                "hop": max(it.hops for it in stragglers),
                "trace_ids": (
                    [it.ticket.trace_id for it in stragglers]
                    if self._trace else None
                ),
            }
            if self._trace:
                cont["span_id"] = tracectx.new_span_id()
                cont["parent_spans"] = [dspan] * len(stragglers)
            self._emit(cont)
        n_page_warm = sum(1 for it in batch if it.warm_src == "pages")
        tok_bytes = self._token_state_bytes(engine)
        pad_tokens = None
        if getattr(engine, "cfg", None) is not None:
            pad_tokens = (result.bucket - n) * engine.cfg.num_patches
        rec = {
            "event": "dispatch",
            "engine": engine_name,
            "bucket": result.bucket,
            "n_valid": n,
            "warm_state": warm or warm_pages,
            "paged": warm_pages,
            "tier": entry_tier,
            "pad_fraction": round(1.0 - n / result.bucket, 4),
            "latency_ms": latency_ms,
            **phases,
            "iters_run": result.iters_run,
            "n_stragglers": len(stragglers),
            "n_cache_warm": n_cache_warm,
            "n_cache_miss": n_cache_miss,
            "n_page_warm": n_page_warm,
            "levels0_h2d_bytes": getattr(result, "levels0_h2d_bytes", 0),
            "compiled": result.compiled,
            **tfields,
        }
        if use_inc and warm_pages:
            # The incremental dispatch stamps its route and its explicit
            # tolerance (the compare gate reads delta_page_atol — 0.0
            # would be the bitwise mode, which never reaches this route).
            rec["incremental"] = True
            rec["n_incremental"] = n
            rec["delta_page_atol"] = pool.delta_page_atol
        if pad_tokens is not None:
            rec["pad_tokens"] = pad_tokens
            if tok_bytes is not None:
                rec["pad_bytes"] = pad_tokens * tok_bytes
        if rung_name is not None:
            rec["rung"] = rung_name
        if iters_override is not None:
            rec["iters_override"] = iters_override
        cls_rows = self._class_rows(batch)
        if cls_rows is not None:
            rec["classes"] = cls_rows
        # The dispatch log is read by summary_record() from the CALLER's
        # thread while this worker appends — glom-lint's lockset checker
        # flagged the bare append (iteration during append is a crash, not
        # just a stale read), so the batch log rides the counter lock
        # (nested inside the engine lock: see _note_dispatch).
        self._note_dispatch(
            engine_name, rec, resolved,
            n_served=n_resolved,
            n_degraded=n_resolved if iters_override is not None else 0,
            n_continued=len(stragglers),
            class_served=self._class_rows([t[0] for t in to_resolve]),
        )
        # Tickets resolve AFTER the counters: the instant result() returns
        # a caller may read summary_record(), and its conservation
        # (n_served + n_shed + n_failed == n_requests) must already hold.
        for it, i, executed_i in to_resolve:
            it.ticket._resolve(
                levels[i], executed_i,
                hops=it.hops, dispatch_ms=it.dispatch_ms,
            )
            if self._trace:
                # The RESOLVE leaf: one per-request record carrying the
                # served totals the trace tree must conserve against
                # (summed hop iters_run / latency_ms == these exactly).
                # Only minted when tracing — it exists for the tree, and
                # the trace-ab gate prices it.
                self._emit(
                    {
                        "event": "resolve",
                        "request_id": it.ticket.request_id,
                        "engine": engine_name,
                        "iters_total": executed_i,
                        "dispatch_ms_total": it.dispatch_ms,
                        # Per-phase accumulation across this request's
                        # hops (tracectx conservation reads it); null
                        # when phase_split is off, like the hop fields.
                        "phase_ms_total": (
                            dict(it.phase_ms) if self._phase_split
                            else None
                        ),
                        "hops": it.hops,
                        "redispatches": it.redispatches,
                        "latency_ms": round(1e3 * it.ticket._latency_s, 3),
                        "slo_class": it.ticket.slo_class,
                        "trace_id": it.ticket.trace_id,
                        "span_id": tracectx.new_span_id(),
                        "parent_span": dspan,
                    }
                )
        self._emit(rec)
        self._ladder_observe(engine_name)

    def _dispatch_ragged_batch(
        self, engine, engine_name: str, batch, dspan, tfields
    ) -> None:
        """One RAGGED dispatch (docs/SERVING.md, "Ragged admission"):
        rows of differing patch counts pack page-aligned onto a flat
        token axis sized by a ragged-ladder page count — no worst-row
        bucket shape, no pad rows. Warm state rides the page pool
        (session hits pin their pages and the dispatch carries indices)
        — EXCEPT continuation groups: straggler rows re-enter carrying
        their mid-flight columns as a flat levels0 with their REMAINING
        budget (ragged x continuation composition; a continuation's
        state is unresolved, so it has no pages to ride)."""
        from glom_tpu_torch.serve.paged_columns import resolve_page_tokens

        t_proc = self._clock()
        queue_wait_s = t_proc - min(
            (it.t_enq for it in batch if it.t_enq), default=t_proc
        )
        n = len(batch)
        iters_override = None
        rung_name = None
        ladder = self._ladders.get(engine_name)
        if ladder is not None:
            from glom_tpu_torch.resilience.ladder import RUNGS

            rung = ladder.rung()
            rung_name = RUNGS[rung]
            if rung >= self._degrade_gate(batch):
                iters_override = ladder.degraded_iters
        scfg = getattr(engine, "scfg", None)
        budget = getattr(engine, "auto_budget", None)
        tiered = (
            scfg is not None
            and getattr(scfg, "max_continuations", 0) > 0
            and getattr(engine, "iters_key", None) == "auto"
            and iters_override is None
            and budget is not None
        )
        has_cont = any(it.warm_src == "cont" for it in batch)
        pool = self._pools.get(engine_name)
        pages_mode = (
            pool is not None
            and self.cache is not None
            and self.cache.pools is not None
        )
        n_cache_warm = n_cache_miss = 0
        pinned: List[str] = []
        if self.cache is not None:
            for it in batch:
                if it.session is None or it.levels is not None:
                    continue
                if not pages_mode or has_cont:
                    # A host-array cache cannot warm a ragged dispatch
                    # (the route has no levels0 input by design — that
                    # is the transfer being killed), and a continuation
                    # group's dispatch is the levels0 program (pages do
                    # not compose with it — folded fresh rows go cold):
                    # stamped as a miss either way.
                    n_cache_miss += 1
                    continue
                hit = self.cache.lookup(it.session, pin=True)
                if (
                    hit is not None
                    and getattr(hit, "engine", None) == engine_name
                    and getattr(hit, "n_tokens", None) == it.n_patches
                ):
                    it.pages = hit
                    it.warm_src = "pages"
                    pinned.append(it.session)
                    n_cache_warm += 1
                else:
                    if hit is not None:
                        self.cache.unpin(it.session)
                    n_cache_miss += 1
        pt = (
            pool.page_tokens if pool is not None
            else resolve_page_tokens(engine.cfg, engine.scfg)
        )
        counts = [it.n_patches for it in batch]
        row_pages = [pages_for_tokens(c, pt) for c in counts]
        try:
            pages_sig = engine.pick_pages(sum(row_pages))
            T = pages_sig * pt
            flat = np.zeros((T, engine.cfg.patch_dim), np.float32)
            pidx = (
                np.full((pages_sig,), -1, np.int32)
                if pool is not None else None
            )
            starts = []
            off = 0
            for it, k in zip(batch, row_pages):
                start = off * pt
                starts.append(start)
                flat[start:start + it.n_patches] = _patchify_host(
                    it.img, engine.cfg.patch_size
                )
                if it.pages is not None:
                    pidx[off:off + k] = it.pages.pages
                off += k
            kw = {}
            if iters_override is not None:
                kw["iters_override"] = iters_override
            if has_cont:
                # Ragged x continuation composition: straggler rows carry
                # their mid-flight columns into the flat levels0 at their
                # row's page span; folded-in fresh rows take the engine's
                # cold init (bit for bit the init the forward builds; pad
                # slots stay zeros, the witness masks them), in a CPU
                # tensor of the serving dtype. A continuation dispatch is
                # the levels0 form, exclusive with page indices at the
                # engine, so pidx is dropped.
                cold = engine.cold_levels()
                lv0 = torch.zeros((T, *cold.shape[1:]), dtype=cold.dtype)
                for it, start in zip(batch, starts):
                    c = it.n_patches
                    if it.levels is not None:
                        lv0[start:start + c] = it.levels
                    else:
                        lv0[start:start + c] = cold[:c]
                kw["levels0"] = lv0
                pidx = None
                prior = max((it.executed for it in batch), default=0)
                remaining = max(1, budget - prior) if budget else None
                if (
                    iters_override is None
                    and remaining is not None
                    and remaining < budget
                ):
                    kw["auto_budget"] = remaining
            pack_s = self._clock() - t_proc
            with span("serve_dispatch", aggregator=self.spans):
                result = engine.infer_ragged(
                    flat, counts, page_idx=pidx, **kw
                )
            for sid in pinned:
                self.cache.unpin(sid)
            pinned = []
            t_fetch = self._clock()
            with span("serve_fetch", aggregator=self.spans):
                levels_flat = result.levels.cpu()
            fetch_s = self._clock() - t_fetch
        except BaseException as e:  # noqa: BLE001 — relayed per ticket
            for sid in pinned:
                self.cache.unpin(sid)
            self._handle_dispatch_failure(
                engine_name, batch, e, dspan, tfields, n, n_cache_warm > 0
            )
            return

        phases, latency_ms = self._phase_fields(
            queue_wait_s, pack_s, result, fetch_s
        )
        conv = result.row_converged
        stragglers: List[_Item] = []
        resolved: List[dict] = []
        n_resolved = 0
        entry_tier = max((it.hops for it in batch), default=0)
        to_resolve: List[tuple] = []
        for i, it in enumerate(batch):
            executed_i = it.executed + result.iters_run
            it.dispatch_ms += latency_ms
            self._note_item_phases(it, phases)
            if dspan is not None:
                it.parent_span = dspan
            open_hop = (
                tiered
                and conv is not None
                and not self._stop.is_set()
                and it.hops < scfg.max_continuations
                and executed_i < budget
            )
            if open_hop and not bool(conv[i]):
                # The straggler carries its ROW SPAN (the unit the
                # banded parity contract covers) into the continuation
                # queue; next hop it repacks page-aligned as a ragged
                # row with the remaining budget.
                it.levels = levels_flat[starts[i]:starts[i] + it.n_patches].clone()
                it.executed = executed_i
                it.hops += 1
                it.warm_src = "cont"
                it.t_enq = self._clock()  # cont-queue wait starts now
                stragglers.append(it)
                continue
            # Write-back BEFORE resolve, device-to-device: the row's
            # converged columns go straight from the dispatch output
            # into owned pool pages (the next frame's warm state never
            # visits the host). Stragglers skip it — their state is
            # mid-flight, not a frame worth warming from.
            if pages_mode and it.session is not None:
                self.cache.store(
                    it.session,
                    result.levels[starts[i]:starts[i] + it.n_patches],
                    engine=engine_name,
                    n_tokens=it.n_patches,
                )
            row_levels = levels_flat[starts[i]:starts[i] + it.n_patches]
            to_resolve.append((it, row_levels, executed_i))
            resolved.append({"iters": executed_i, "tier": it.hops})
            n_resolved += 1
        if stragglers:
            self._cont_q.put(stragglers)
            worst = max(it.executed for it in stragglers)
            cont = {
                "event": "continuation",
                "engine": engine_name,
                "ragged": True,
                "n_stragglers": len(stragglers),
                "executed_iters": worst,
                "remaining_budget": budget - worst,
                "hop": max(it.hops for it in stragglers),
                "trace_ids": (
                    [it.ticket.trace_id for it in stragglers]
                    if self._trace else None
                ),
            }
            if self._trace:
                cont["span_id"] = tracectx.new_span_id()
                cont["parent_spans"] = [dspan] * len(stragglers)
            self._emit(cont)
        pad_tokens = T - sum(counts)
        tok_bytes = self._token_state_bytes(engine)
        rec = {
            "event": "dispatch",
            "engine": engine_name,
            "bucket": f"ragged{pages_sig}",
            "ragged": True,
            "n_valid": n,
            "n_pages": pages_sig,
            "n_tokens": sum(counts),
            "warm_state": n_cache_warm > 0 or has_cont,
            "paged": n_cache_warm > 0,
            "tier": entry_tier,
            # Token-based pad accounting: the ragged pad tax is the page
            # tails plus the ladder round-up — row axis padding is GONE.
            "pad_fraction": round(pad_tokens / T, 4),
            "pad_tokens": pad_tokens,
            "latency_ms": latency_ms,
            **phases,
            "iters_run": result.iters_run,
            "n_stragglers": len(stragglers),
            "n_cache_warm": n_cache_warm,
            "n_cache_miss": n_cache_miss,
            "n_page_warm": n_cache_warm,
            "levels0_h2d_bytes": getattr(result, "levels0_h2d_bytes", 0),
            "compiled": result.compiled,
            **tfields,
        }
        if tok_bytes is not None:
            rec["pad_bytes"] = pad_tokens * tok_bytes
        if rung_name is not None:
            rec["rung"] = rung_name
        if iters_override is not None:
            rec["iters_override"] = iters_override
        cls_rows = self._class_rows(batch)
        if cls_rows is not None:
            rec["classes"] = cls_rows
        self._note_dispatch(
            engine_name, rec, resolved,
            n_served=n_resolved,
            n_degraded=n_resolved if iters_override is not None else 0,
            n_continued=len(stragglers),
            class_served=self._class_rows([t[0] for t in to_resolve]),
        )
        for it, row_levels, iters in to_resolve:
            it.ticket._resolve(
                row_levels, iters,
                hops=it.hops, dispatch_ms=it.dispatch_ms,
            )
            if self._trace:
                self._emit(
                    {
                        "event": "resolve",
                        "request_id": it.ticket.request_id,
                        "engine": engine_name,
                        "iters_total": iters,
                        "dispatch_ms_total": it.dispatch_ms,
                        "phase_ms_total": (
                            dict(it.phase_ms) if self._phase_split
                            else None
                        ),
                        "hops": it.hops,
                        "redispatches": it.redispatches,
                        "latency_ms": round(1e3 * it.ticket._latency_s, 3),
                        "slo_class": it.ticket.slo_class,
                        "trace_id": it.ticket.trace_id,
                        "span_id": tracectx.new_span_id(),
                        "parent_span": dspan,
                    }
                )
        self._emit(rec)
        self._ladder_observe(engine_name)

    # -- telemetry ---------------------------------------------------------

    def _emit(self, rec: dict, kind: str = "serve") -> None:
        from glom_tpu_torch.serve.events import emit_serve

        stamped = emit_serve(self.writer, rec, kind=kind)
        for tap in list(self._taps):
            try:
                tap(stamped)
            except Exception:  # noqa: BLE001 — a tap never kills a worker
                pass

    def span_records(self, **extra) -> list:
        """Drain the serve-phase span rollups (one "span" record per phase
        seen since the last drain)."""
        return self.spans.records(extra=extra or None)

    def capacity_records(self) -> list:
        """One stamped "capacity" record per engine (schema v7): the
        signal an elastic-serving control loop reads.

          * service_rate_rps — sustainable requests/s estimated from the
            engine's own dispatch evidence (valid rows served per second
            of dispatch wall — the per-bucket latency histograms'
            aggregate; None before the first dispatch);
          * queue/continuation/affinity/pool fills — LIVE occupancy of
            every lane a request can wait in, each normalized to [0, 1];
          * utilization — the WORST lane (capacity is gone when any lane
            saturates: a full pool blocks warm streams even with an
            empty queue);
          * headroom — 1 - utilization, clamped to [0, 1]; 0.0 for a
            dead engine (no capacity, whatever its queues say).

        `telemetry watch --slo headroom=X` breaches when headroom drops
        BELOW X — the one lower-bound rule.

        Every record stamps `state` ("ok" | "draining" | "probation" |
        "dead"): the SLO monitor excludes draining and probation engines
        from the headroom windowed min (a deliberately draining engine's
        headroom would otherwise fire a permanent false breach that
        re-triggers the autoscaler that drained it), and drained engines
        emit no record at all: they left the fleet."""
        # Age-bounded husks retire on the capacity cadence (the
        # autoscaler calls this every tick), not only at the next drain.
        self._prune_husks()
        with self._engine_lock:  # LOCK ORDER: _engine_lock -> _counter_lock
            engines = {
                name: dict(st) for name, st in self._engine_state.items()
            }
            draining = set(self._draining)
            drained = set(self._drained)
            with self._counter_lock:
                dispatches = list(self.dispatches)
        qcap = max(1, self._q.maxsize)
        queue_fill = round(min(1.0, self._q.qsize() / qcap), 4)
        # The continuation lane holds GROUPS (lists of warm items): its
        # occupancy is the ITEM count — 8 queued bucket-8 groups are a
        # saturated lane, not 8/64 of one (stdlib Queue's mutex guards
        # the snapshot; the lane is unbounded, so the admission queue's
        # capacity is the normalizer).
        with self._cont_q.mutex:
            cont_items = sum(len(g) for g in self._cont_q.queue)
        cont_fill = round(min(1.0, cont_items / qcap), 4)
        out = []
        for i, eng in enumerate(self.engines):
            name = self._ename(eng, i)
            if name in drained:
                continue  # voluntarily left the fleet: no capacity record
            st = engines.get(name, {})
            own = [d for d in dispatches if d.get("engine") == name]
            # The service-rate denominator is ENGINE-BUSY time (h2d +
            # device + resolve), not latency_ms — which under
            # phase_split includes queue_wait, so at saturation (the
            # exact regime the autoscaler reads this) it would collapse
            # the estimate several-fold below what the engine sustains.
            # Dispatches without a phase split fall back to latency_ms
            # (there it IS the bare engine wall).
            busy_s = 0.0
            for d in own:
                parts = [
                    d.get(k) for k in ("h2d_ms", "device_ms", "resolve_ms")
                ]
                if all(isinstance(v, (int, float)) for v in parts):
                    busy_s += sum(parts) / 1e3
                elif isinstance(d.get("latency_ms"), (int, float)):
                    busy_s += d["latency_ms"] / 1e3
            served = sum(d.get("n_valid") or 0 for d in own)
            service_rate = (
                round(served / busy_s, 3) if busy_s > 0 else None
            )
            aq = self._aff_q.get(name)
            aff_fill = (
                round(min(1.0, aq.qsize() / max(1, aq.maxsize)), 4)
                if aq is not None else 0.0
            )
            pool = self._pools.get(name)
            pool_fill = None
            if pool is not None:
                pr = pool.record()
                total = pr.get("pages_total") or 0
                if total:
                    pool_fill = round(pr.get("pages_used", 0) / total, 4)
            alive = bool(st.get("alive", True))
            lanes = [queue_fill, cont_fill, aff_fill]
            if pool_fill is not None:
                lanes.append(pool_fill)
            utilization = round(max(lanes), 4)
            headroom = (
                0.0 if not alive
                else round(max(0.0, 1.0 - utilization), 4)
            )
            state = (
                "draining" if name in draining
                else "probation" if st.get("probation")
                else "ok" if alive
                else "dead"
            )
            cap_rec = {
                "engine": name,
                "alive": alive,
                "state": state,
                "headroom": headroom,
                "utilization": utilization,
                "service_rate_rps": service_rate,
                "queue_fill": queue_fill,
                "continuation_fill": cont_fill,
                "affinity_fill": aff_fill,
                "pool_fill": pool_fill,
                "n_dispatches": len(own),
            }
            if self._qos is not None:
                # Per-class LANE fill (qos.py ClassQueues): the elastic
                # loop needs to see WHICH tenant's lane is saturating —
                # aggregate queue_fill hides a full premium lane behind
                # an empty batch lane. Classless records keep the exact
                # pre-QoS shape (no key).
                cap_rec["class_fill"] = {
                    cn: round(
                        min(1.0, f["depth"] / max(1, f["capacity"])), 4
                    )
                    for cn, f in self._q.class_fill().items()
                }
            out.append(schema.stamp(cap_rec, kind="capacity"))
        return out

    def summary_record(self) -> dict:
        """The end-of-run "serve" summary event. The iteration histogram
        is PER REQUEST: each resolved request's TOTAL executed column
        iterations across all of its hops — the two-tier accounting unit
        (iters_histogram_by_tier splits it by how many continuation hops
        the request rode). Snapshot under both locks in the documented
        order: workers may still be serving while a caller summarizes,
        and the per-engine counts must be consistent with the global
        conservation counters."""
        with self._engine_lock:  # LOCK ORDER: _engine_lock -> _counter_lock
            engines = {
                name: dict(st) for name, st in self._engine_state.items()
            }
            # Drain-state annotation, added only on fleets that drained
            # (a static fleet's engines nest keeps its shape).
            for name in self._draining:
                if name in engines:
                    engines[name]["draining"] = True
            for name in self._drained:
                if name in engines:
                    engines[name]["drained"] = True
            with self._counter_lock:
                elastic = self._elastic
                dispatches = list(self.dispatches)
                hist = dict(self._iters_hist)
                by_tier = {
                    t: dict(h) for t, h in self._iters_hist_by_tier.items()
                }
                iters_total = self._iters_total
                n_requests = self.n_requests
                n_submitted = self.n_submitted
                n_served = self.n_served
                n_shed = self.n_shed
                n_failed = self.n_failed
                n_degraded = self.n_degraded
                n_continued = self.n_continued
                n_redispatched = self.n_redispatched
                n_folded = self.n_folded
                n_rejoined = self.n_rejoined
                n_affinity = self.n_affinity
                n_page_warm = self.n_page_warm
                n_incremental = self.n_incremental
                pad_fraction_sum = self._pad_fraction_sum
                pad_bytes_wasted = self._pad_bytes_wasted
                levels0_h2d_bytes = self._levels0_h2d_bytes
                phase_sums = dict(self._phase_sums)
                class_counts = {
                    c: dict(v) for c, v in self._class_counts.items()
                }
            husks_retired = dict(self._husks_retired)
        rec = {
            "event": "summary",
            "n_requests": n_requests,
            "n_submitted": n_submitted,
            "n_served": n_served,
            "n_shed": n_shed,
            "n_failed": n_failed,
            "n_degraded": n_degraded,
            "n_continued": n_continued,
            "n_redispatched": n_redispatched,
            "n_folded": n_folded,
            "n_rejoined": n_rejoined,
            "n_affinity": n_affinity,
            "n_page_warm": n_page_warm,
            "n_incremental": n_incremental,
            "n_dispatches": len(dispatches),
            # Pad-tax rollup (mean dispatch pad fraction + the bytes the
            # padding wasted) and the warm-path upload total — the pair
            # the ragged bench's CI gate and `telemetry compare` read
            # (pad regresses UP as a cost; levels0_h2d_bytes must be 0
            # on the paged warm path).
            "pad_fraction_mean": round(
                pad_fraction_sum / len(dispatches), 4
            ) if dispatches else 0.0,
            "pad_bytes_wasted": pad_bytes_wasted,
            "levels0_h2d_bytes": levels0_h2d_bytes,
            # Mean GATHERED batch size: valid rows per dispatch (a warm
            # continuation hop is a dispatch too) — n_served would skew
            # it, since a straggler's rows resolve on a LATER dispatch
            # than the one that gathered them.
            "mean_batch": round(
                sum(d["n_valid"] for d in dispatches) / len(dispatches), 3
            ) if dispatches else 0.0,
            "iters_histogram": hist,
            "iters_histogram_by_tier": by_tier,
            "mean_executed_iters": round(
                iters_total / n_served, 3
            ) if n_served else None,
            "engines": engines,
        }
        if class_counts or self._qos is not None:
            # Per-class conservation: each class's counters
            # must reconcile on their own — n_served + n_shed + n_failed
            # == n_requests PER CLASS, not just in aggregate. Classless
            # runs add no key (bit-parity with the pre-QoS summary).
            classes = {}
            for cls in sorted(class_counts):
                cnt = dict(class_counts[cls])
                cnt["served_fraction"] = (
                    round(cnt["n_served"] / cnt["n_requests"], 4)
                    if cnt["n_requests"] else None
                )
                classes[cls] = cnt
            rec["classes"] = classes
            if self._qos is not None:
                # The admission scheduler's own evidence: pick counts,
                # floor preemptions, per-lane rejections.
                rec["class_scheduler"] = self._q.record()
        if husks_retired.get("n"):
            # Retention trimmed the engines nest: the folded counters keep
            # the books whole (global dispatch totals == the nest's sum +
            # these); added only when a husk retired.
            rec["husks_retired"] = husks_retired
        if dispatches and phase_sums:
            # The latency decomposition rollup: MEAN ms per phase per
            # dispatch (the same five fields every dispatch record splits
            # latency_ms into, so p99 investigations start from the
            # summary and drill into `telemetry trace`). Compare flattens
            # these as serve_latency.* cost rows.
            from glom_tpu_torch.telemetry.tracectx import PHASE_KEYS

            rec["latency_phases"] = {
                k: round(phase_sums.get(k, 0.0) / len(dispatches), 3)
                for k in PHASE_KEYS
            }
        # The capacity/headroom rollup, emitted as standalone "capacity"
        # records on EVERY summary (the watch --slo headroom tail reads
        # the stream) and nested here for the compare gate.
        cap = self.capacity_records()
        if cap:
            rec["capacity"] = {
                c["engine"]: {
                    "headroom": c["headroom"],
                    "utilization": c["utilization"],
                    "service_rate_rps": c["service_rate_rps"],
                }
                for c in cap
            }
            for c in cap:
                self._emit(c, kind="capacity")
        if self.cache is not None:
            # The streaming column cache's rollup (hits/misses/evictions/
            # bytes vs budget) — the temporal bench and its CI gate read
            # this nest (docs/OBSERVABILITY.md, cache metrics).
            rec["column_cache"] = self.cache.record()
        if self._pools:
            # The page pools' rollup (capacity/churn in live-bytes form;
            # pages_used + pages_free == pages_total is the conservation
            # pair the churn test reads).
            rec["page_pools"] = {
                name: pool.record() for name, pool in self._pools.items()
            }
        if elastic is not None:
            # The autoscaler's rollup (serve/elastic.py): scale counts,
            # spawn latency, migration totals and the fleet-size timeline.
            rec["elastic"] = elastic.record()
        # Ladder/retry rollups: flat on a single-engine summary, nested
        # per engine under
        # `engines` on fan-out — a flat merge would let the last engine's
        # ladder_rung/n_retries overwrite every sibling's evidence.
        for i, eng in enumerate(self.engines):
            name = self._ename(eng, i)
            ladder = self._ladders.get(name)
            retry = getattr(eng, "retry", None)
            if len(self.engines) == 1:
                if ladder is not None:
                    rec.update(ladder.record())
                if retry is not None:
                    rec.update(retry.record())
            else:
                if ladder is not None:
                    rec["engines"][name]["ladder"] = ladder.record()
                if retry is not None:
                    rec["engines"][name]["retry"] = retry.record()
        return schema.stamp(rec, kind="serve")


def _patchify_host(img: np.ndarray, patch_size: int) -> np.ndarray:
    """[c, H, W] -> [n, p*p*c] in ops/patch.patchify's order ('b c (h p1)
    (w p2) -> b (h w) (p1 p2 c)'): a reshape and transpose with no float
    operation, so the ragged route embeds exactly the values the bucket
    route's patchify gives."""
    c, height, width = img.shape
    p = patch_size
    h, w = height // p, width // p
    x = img.reshape(c, h, p, w, p)
    x = x.transpose(1, 3, 2, 4, 0)  # [h, w, p1, p2, c]
    return np.ascontiguousarray(x.reshape(h * w, p * p * c))


def ragged_row_starts(n_patches: Sequence[int], page_tokens: int) -> list:
    """Each row's first flat token: rows in order, each on whole pages
    (early_exit.ragged_row_layout, on the host). A row of 0 patches takes
    no page."""
    starts, off = [], 0
    for n in n_patches:
        starts.append(off * page_tokens)
        if n > 0:
            off += pages_for_tokens(int(n), page_tokens)
    return starts


def pack_ragged(
    imgs: Sequence[np.ndarray], patch_size: int, page_tokens: int, pages: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack images of differing resolutions ([c, H_i, W_i], H_i and W_i
    multiples of patch_size) page-aligned onto one flat token axis of
    `pages` pages, as the reference batcher's ragged dispatch does.
    Returns (patches [pages * page_tokens, p*p*c] f32, zeros past each
    row's patches; n_patches [rows] int32)."""
    rows = [_patchify_host(np.asarray(img, np.float32), patch_size) for img in imgs]
    n_patches = np.array([r.shape[0] for r in rows], np.int32)
    need = sum(pages_for_tokens(int(n), page_tokens) for n in n_patches)
    if need > pages:
        raise ValueError(f"rows need {need} pages > {pages}")
    flat = np.zeros((pages * page_tokens, rows[0].shape[1]), np.float32)
    for row, start in zip(rows, ragged_row_starts(n_patches, page_tokens)):
        flat[start:start + row.shape[0]] = row
    return flat, n_patches
