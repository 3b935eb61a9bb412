"""SLO-driven elastic serving: the control loop over the batcher's fleet.

The port's copy of `glom_tpu/serve/elastic.py`. The capacity records show
trouble (every summary carries per-engine `headroom`, and `telemetry watch
--slo` stamps breaches); this module acts on it:

  * `ElasticPolicy` is the pure decision core: a windowed low/high-water
    policy over the fleet's worst eligible headroom plus the live SLO
    breach signal, with min-dwell hysteresis (a condition must hold
    continuously for `dwell_s` before it may act), a post-action cooldown
    and hard `min_engines`/`max_engines` clamps. Fake-clock injectable,
    no threads, no engines.

  * `Autoscaler` is the supervised control thread: each tick it pulls the
    batcher's live capacity records (probation and draining engines are
    excluded from the headroom signal), evaluates its in-process
    `SLOMonitor` (p99 / shed-rate rules over the batcher's own resolve
    and shed stream, fed by an event tap), asks the policy, and changes
    the fleet:

      - scale-out builds a new engine replica through the injected
        `engine_factory` (on the caller's device: on one card every
        replica shares it, as glom_tpu's replicas share the default
        device when no serve mesh is configured), runs its full
        `warmup()` off the hot path, and only then registers it with the
        batcher, so admission opens after the warm-up has returned. A
        factory or warm-up failure (the `spawn_fault` injector rides
        here) rolls back loudly: a stamped `spawn_rollback`, no
        registration, the cooldown still charged.

      - scale-in picks the least-loaded eligible engine (max headroom)
        and runs the batcher's graceful drain (serve/batcher.drain_engine:
        stop admitting, flush the in-flight dispatch and hand the
        affinity queue back, migrate the engine's cache sessions to a
        sibling pool device-to-device or invalidate them with a stamped
        `drain` reason, join the worker), then releases the engine's
        device memory (`InferenceEngine.release`) or, with a warm pool
        below its target, demotes the engine into the pool.

Every decision and transition is a stamped "serve" event
(`scale_out_decision` / `scale_out` / `admission_open` /
`scale_in_decision` / `drain_begin` / `drain_flush` / `drain_migrate` /
`drain_release` / `spawn_rollback` / `spare_*`), each carrying the
`decision_id` that chains it to its "decision" record. That record holds
the full evidence bundle (headroom, dwell and breach state, the forecast
believed at decision time, the lead-time quantile, the measured service
rate), and decide() computes the action from that bundle through the pure
`telemetry/audit.py policy_action`, so `python -m glom_tpu_torch.telemetry
audit` replays the JSONL and demands the stamped action back bit for bit.

With `elastic_anticipatory=True` the policy also reads the live load
forecast (telemetry/forecast.py ForecastEmitter) and the spawn-lead-time
quantile each tick; a positive predicted deficit arms scale-out and vetoes
scale-in once both models have matured. `warm_pool=N` holds N built,
warmed spares outside admission: scale-out promotes one, scale-in demotes
the drained engine back into the pool ("spare_promote" / "spare_demote"),
and the spares' build times ("spare_spawn") feed the lead-time model.

With a serve mesh (`mesh_data` / `mesh_seq` > 1) every replica is a sharded
engine on a rank group: `RankGroupFleet` holds every group of the world
(their process groups made at start, since `new_group` is collective over
the world), hands a spawn the first waiting group, and takes a group back
when its engine is closed or released (a demoted spare keeps its group). A
group whose collective broke is retired for good; a spawn that finds no
waiting group raises into `spawn_rollback`. The followers of a waiting
group wait on the store outside any collective
(serve/mesh_follower.follow_engines).

With `ServeConfig.elastic=False` (the default) none of this constructs and
the fleet is static.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from glom_tpu_torch.telemetry import schema


# The serve-event vocabulary of one elastic action, in chain order; the
# `n_engines` they carry samples the fleet size.
SCALE_EVENTS = (
    "scale_out_decision",
    "scale_out",
    "admission_open",
    "spawn_rollback",
    "scale_in_decision",
    "drain_begin",
    "drain_flush",
    "drain_migrate",
    "drain_release",
    "spare_spawn",
    "spare_promote",
    "spare_demote",
)


class ElasticPolicy:
    """The pure scale-out/scale-in decision core (no threads, no engines).

    Signals, in PRECEDENCE order:

      1. SLO breaches (`note_breach`, fed from the monitor's upper-bound
         rules — p99, shed_rate): a breach inside the window forces
         scale-out consideration even while headroom looks fine (latency
         is the contract; queue occupancy is only its proxy), and VETOES
         scale-in outright — capacity is never removed from a fleet that
         is currently failing its SLO.
      2. Headroom low/high water (`observe_headroom`, one worst-eligible
         sample per control tick): below `low_water` continuously for
         `dwell_s` arms scale-out; above `high_water` continuously for
         `dwell_s` (and no breach) arms scale-in.

    `decide(n_engines)` returns None or {"action", "signal"} with the
    triggering signal window embedded — the decision record stamps it
    verbatim. `acted()` starts the cooldown and resets both dwell
    anchors (the fleet's new shape must re-earn any further action)."""

    def __init__(
        self,
        *,
        min_engines: int = 1,
        max_engines: int = 4,
        low_water: float = 0.15,
        high_water: float = 0.6,
        dwell_s: float = 2.0,
        cooldown_s: float = 5.0,
        window_s: float = 10.0,
        anticipatory: bool = False,
        target_utilization: float = 0.8,
        low_classes=frozenset(),
        class_weights: Optional[Dict[str, float]] = None,
        clock=time.monotonic,
    ):
        if min_engines < 1:
            raise ValueError(f"min_engines {min_engines} must be >= 1")
        if max_engines < min_engines:
            raise ValueError(
                f"max_engines {max_engines} must be >= min_engines "
                f"{min_engines}"
            )
        if not 0.0 <= low_water < high_water <= 1.0:
            raise ValueError(
                f"need 0 <= low_water ({low_water}) < high_water "
                f"({high_water}) <= 1"
            )
        if dwell_s < 0 or cooldown_s < 0:
            raise ValueError(
                f"dwell_s {dwell_s} and cooldown_s {cooldown_s} must be >= 0"
            )
        if window_s <= 0:
            raise ValueError(f"window_s {window_s} must be > 0")
        if not 0.0 < target_utilization <= 1.0:
            raise ValueError(
                f"target_utilization {target_utilization} must be in (0, 1]"
            )
        self.min_engines = min_engines
        self.max_engines = max_engines
        self.low_water = low_water
        self.high_water = high_water
        self.dwell_s = dwell_s
        self.cooldown_s = cooldown_s
        self.window_s = window_s
        self.anticipatory = bool(anticipatory)
        self.target_utilization = float(target_utilization)
        # QoS (serve/qos.py): breaches of rules scoped to a
        # LOW class (e.g. "p99_ms[batch]") are recorded but NON-BINDING
        # — they neither force scale-out nor veto an earned scale-in.
        # Cheap-tenant pressure alone never spends hardware; the weights
        # ride the evidence bundle so the audit can score class-weighted
        # regret. Empty/None = classless semantics bit-for-bit.
        self.low_classes = frozenset(str(c) for c in (low_classes or ()))
        self.class_weights = (
            {str(k): float(v) for k, v in class_weights.items()}
            if class_weights else None
        )
        self._clock = clock
        self._samples: deque = deque()   # (t, worst eligible headroom)
        self._breaches: deque = deque()  # (t, rule)
        self._below_since: Optional[float] = None
        self._above_since: Optional[float] = None
        self._last_action_t: Optional[float] = None
        self._last_action: Optional[str] = None
        # Anticipatory inputs, refreshed by the autoscaler each tick
        # (telemetry/forecast.py): the latest closed-window load
        # forecast, the spawn-lead-time quantile, the fleet's measured
        # ok-engine service rate. All default None = reactive semantics.
        self._forecast: Optional[dict] = None
        self._lead_time_ms: Optional[float] = None
        self._lead_quantile: Optional[float] = None
        self._service_rate_rps: Optional[float] = None

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        for q in (self._samples, self._breaches):
            while q and q[0][0] < horizon:
                q.popleft()

    def observe_headroom(self, headroom: float) -> None:
        """Feed one control tick's WORST eligible headroom (the min
        across engines that are neither draining nor on probation —
        serve/batcher.capacity_records stamps the state). The dwell
        anchors track how long the value has been continuously past a
        water mark; crossing back resets them — the hysteresis that
        keeps a value oscillating AROUND a mark from ever acting."""
        now = self._clock()
        self._samples.append((now, float(headroom)))
        if headroom < self.low_water:
            if self._below_since is None:
                self._below_since = now
        else:
            self._below_since = None
        if headroom > self.high_water:
            if self._above_since is None:
                self._above_since = now
        else:
            self._above_since = None
        self._prune(now)

    def note_breach(self, rule: str) -> None:
        """One live SLO breach (the monitor's upper-bound rules). Ages
        out of the window like any sample."""
        self._breaches.append((self._clock(), str(rule)))
        self._prune(self._clock())

    def note_forecast(self, rec: Optional[dict]) -> None:
        """The latest closed-window load forecast record (the fields the
        evidence bundle stamps: predicted / forecast_abs_err / horizon_s
        / trend_per_s / t). None clears it."""
        self._forecast = dict(rec) if rec else None

    def note_lead_time(
        self, lead_ms: Optional[float], quantile: Optional[float] = None
    ) -> None:
        """The spawn-lead-time model's current quantile estimate (None =
        no spawn evidence yet — the anticipatory signal stays dark)."""
        self._lead_time_ms = float(lead_ms) if lead_ms is not None else None
        self._lead_quantile = (
            float(quantile) if quantile is not None else None
        )

    def note_service_rate(self, rate_rps: Optional[float]) -> None:
        """The fleet's measured service rate (sum of ok engines'
        service_rate_rps from the capacity records) — the capacity side
        of the anticipated deficit."""
        self._service_rate_rps = (
            float(rate_rps) if rate_rps is not None else None
        )

    def active_breaches(self) -> List[str]:
        self._prune(self._clock())
        return sorted({rule for _, rule in self._breaches})

    def _signal(self, now: float, rule: str) -> dict:
        """The triggering signal window the decision record embeds: the
        rule that fired, the last observed value, the water marks, and
        the trailing samples (time-relative, bounded) — enough to replay
        WHY from the JSONL alone."""
        tail = list(self._samples)[-32:]
        return {
            "rule": rule,
            "observed": round(tail[-1][1], 4) if tail else None,
            "low_water": self.low_water,
            "high_water": self.high_water,
            "dwell_s": self.dwell_s,
            "window_s": self.window_s,
            "breaches": self.active_breaches(),
            "samples": [
                [round(t - now, 3), round(h, 4)] for t, h in tail
            ],
        }

    def evidence(self, n_engines: int) -> dict:
        """The full input bundle one decision is judged on — every value
        ALREADY in its stamped (rounded, JSON-safe) form, because
        decide() computes the action FROM this dict via the pure
        `telemetry/audit.py policy_action`: what the audit replays is
        what the policy saw, bit for bit, by construction."""
        now = self._clock()
        self._prune(now)
        tail = self._samples[-1] if self._samples else None
        fc = None
        if self._forecast is not None:
            fc = {
                "predicted": self._forecast.get("predicted"),
                "forecast_abs_err": self._forecast.get("forecast_abs_err"),
                "horizon_s": self._forecast.get("horizon_s"),
                "trend_per_s": self._forecast.get("trend_per_s"),
                "t": self._forecast.get("t"),
            }
        ev = {
            "n_engines": int(n_engines),
            "min_engines": self.min_engines,
            "max_engines": self.max_engines,
            "breaches": sorted({rule for _, rule in self._breaches}),
            "headroom": round(tail[1], 4) if tail else None,
            "low_water": self.low_water,
            "high_water": self.high_water,
            "dwell_s": self.dwell_s,
            "below_held_s": (
                round(now - self._below_since, 6)
                if self._below_since is not None else None
            ),
            "above_held_s": (
                round(now - self._above_since, 6)
                if self._above_since is not None else None
            ),
            "anticipatory": self.anticipatory,
            "target_utilization": self.target_utilization,
            "forecast": fc,
            "lead_time_ms": self._lead_time_ms,
            "lead_quantile": self._lead_quantile,
            "fleet_service_rate_rps": (
                round(self._service_rate_rps, 4)
                if self._service_rate_rps is not None else None
            ),
        }
        if self.low_classes:
            # Stamped ONLY when SLO classes are declared: a classless
            # fleet's evidence bundle stays byte-identical to v10. The
            # pure policy function reads "low_classes" to drop
            # non-binding breaches; "class_weights" is audit-side
            # evidence for the weighted regret score.
            ev["low_classes"] = sorted(self.low_classes)
            if self.class_weights is not None:
                ev["class_weights"] = dict(
                    sorted(self.class_weights.items())
                )
        return ev

    def decide(self, n_engines: int) -> Optional[dict]:
        """The next fleet action at the current signals, or None. Clamped
        to [min_engines, max_engines]; silent inside the cooldown.

        Returns {"action", "signal", "evidence"}: the action comes from
        the pure policy function applied to the evidence bundle decide()
        is about to stamp (reactive semantics verbatim when the
        anticipatory inputs are absent or unmatured), and the audit CLI
        replays the same function on the JSONL."""
        from glom_tpu_torch.telemetry.audit import (
            anticipated_deficit, binding_breaches, policy_action,
        )

        now = self._clock()
        self._prune(now)
        if (
            self._last_action_t is not None
            and now - self._last_action_t < self.cooldown_s
        ):
            return None
        ev = self.evidence(n_engines)
        action = policy_action(ev)
        if action is None:
            return None
        if action == "scale_out":
            # The trigger rule names a BINDING breach: a low-class
            # breach cannot be the reason a decision spent hardware.
            breaches = binding_breaches(ev)
            below = (
                ev["below_held_s"] is not None
                and ev["below_held_s"] >= self.dwell_s
            )
            if breaches:
                rule = breaches[0]
            elif below:
                rule = "headroom"
            else:
                rule = "forecast"
                deficit = anticipated_deficit(ev)
                if deficit is not None:
                    ev["anticipated_deficit_rps"] = deficit
        else:
            rule = "headroom"
        return {
            "action": action,
            "signal": self._signal(now, rule),
            "evidence": ev,
        }

    def acted(self, action: str) -> None:
        now = self._clock()
        self._last_action_t = now
        self._last_action = action
        # The fleet changed shape: both dwell conditions must re-earn
        # their hold from scratch under the NEW capacity.
        self._below_since = None
        self._above_since = None

    @staticmethod
    def pick_drain_target(capacity_records: List[dict]) -> Optional[str]:
        """The least-loaded drainable engine: max headroom among records
        whose stamped state is "ok" (never a draining, probation, or
        dead engine). Ties break on name for determinism."""
        eligible = [
            c for c in capacity_records
            if c.get("state") == "ok"
            and isinstance(c.get("headroom"), (int, float))
        ]
        if not eligible:
            return None
        best = max(eligible, key=lambda c: (c["headroom"], c["engine"]))
        return best["engine"]


def resolve_policy(scfg, *, clock=time.monotonic) -> ElasticPolicy:
    """The one ServeConfig -> policy resolution (the ladder pattern).
    Declared SLO classes arm the QoS extension: the first class in the
    shed order becomes non-binding for elastic decisions and the class
    weights ride every evidence bundle."""
    low_classes: frozenset = frozenset()
    class_weights = None
    if getattr(scfg, "slo_classes", None):
        from glom_tpu_torch.serve.qos import resolve_slo_classes

        spec = resolve_slo_classes(scfg)
        if spec is not None:
            low_classes = spec.low_classes()
            class_weights = spec.weights()
    return ElasticPolicy(
        min_engines=scfg.min_engines,
        max_engines=scfg.max_engines,
        low_water=scfg.elastic_low_water,
        high_water=scfg.elastic_high_water,
        dwell_s=scfg.elastic_dwell_s,
        cooldown_s=scfg.elastic_cooldown_s,
        window_s=scfg.elastic_window_s,
        anticipatory=getattr(scfg, "elastic_anticipatory", False),
        target_utilization=getattr(
            scfg, "elastic_target_utilization", 0.8
        ),
        low_classes=low_classes,
        class_weights=class_weights,
        clock=clock,
    )


class RankGroupFleet:
    """The rank groups an elastic fleet's sharded engines run on, on the
    leader (global rank 0, which holds every engine). `meshes` is every
    group's ServeMesh (parallel/runtime.make_engine_meshes), `store` the
    `torch.distributed` store the followers wait on and `prefix` this
    run's key prefix (the same on every rank). A group is waiting, serving
    (an engine, in the fleet or a spare, holds it) or retired. Each
    transition is a stamped "rank_group" serve event."""

    def __init__(self, meshes: list, store, prefix: str, *, writer=None):
        self.meshes = list(meshes)
        self.store = store
        self.prefix = prefix
        self.writer = writer
        self._lock = threading.Lock()
        self.state = ["waiting"] * len(self.meshes)
        self.generation = [0] * len(self.meshes)

    def _post(self, index: int, word: str) -> str:
        from glom_tpu_torch.serve.mesh_follower import group_key, group_prefix

        key = group_key(group_prefix(self.prefix, index), self.generation[index])
        self.store.set(key, word)
        return key

    def _emit(self, index: int) -> None:
        from glom_tpu_torch.serve.events import emit_serve

        emit_serve(self.writer, {
            "event": "rank_group", "group": index, "ranks": list(self.meshes[index].ranks),
            "state": self.state[index], "generation": self.generation[index],
            "n_waiting": self.state.count("waiting"),
        })

    def acquire(self):
        """(index, mesh) of the first waiting group, now serving: its
        followers start their next engine lifetime. Raises RuntimeError when
        no group waits (the spawn rolls back)."""
        with self._lock:
            if "waiting" not in self.state:
                raise RuntimeError(
                    f"no waiting rank group: {self.state.count('serving')} of "
                    f"{len(self.meshes)} hold an engine, {self.state.count('retired')} retired"
                )
            index = self.state.index("waiting")
            self.state[index] = "serving"
            mesh = self.meshes[index]
            # The engine's headers are gated on the store under this
            # generation's key (serve/mesh_follower.MeshChannel.header).
            mesh.gate = (self.store, self._post(index, "serve"))
        self._emit(index)
        return index, mesh

    def build(self, make):
        """`make(mesh)` on the first waiting group: the engine, which gives
        the group back when it is closed or released. A `make` that raises
        loses the group (its followers wait in the parameters' broadcast
        until their collectives time out), and the error propagates."""
        index, mesh = self.acquire()
        try:
            engine = make(mesh)
        except BaseException:
            self.free(index, broken=True)
            raise
        engine.on_group_free = lambda broken=False: self.free(index, broken=broken)
        return engine

    def free(self, index: int, *, broken: bool = False) -> None:
        """The group's engine is gone: back to waiting for its next
        generation, or retired when its collective broke (its followers'
        loops have raised)."""
        with self._lock:
            if self.state[index] != "serving":
                return
            self.state[index] = "retired" if broken else "waiting"
            self.generation[index] += 1
        self._emit(index)

    def close(self) -> None:
        """End every follower loop: each group not retired is told "exit" for
        the generation it waits on (close or release the engines first)."""
        with self._lock:
            for index, st in enumerate(self.state):
                if st == "serving":
                    self.generation[index] += 1
                if st != "retired":
                    self._post(index, "exit")
                    self.state[index] = "closed"


def fleet_store(meshes) -> tuple:
    """(the `torch.distributed` store, this run's key prefix) of an elastic
    fleet's rank groups; every rank calls it once the groups are made. The
    prefix numbers the runs that share the store, agreed from rank 0."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _get_default_store

    store = _get_default_store()
    run = [store.add("glom_tpu_torch/serve/runs", 1) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(run, src=0)
    return store, f"glom_tpu_torch/serve/run{run[0]}"


def _close_quietly(engine) -> None:
    """A failed spawn's engine: end its use of its ranks (a no-op on one
    device), so a rank group returns to the fleet."""
    close = getattr(engine, "close", None)
    if callable(close):
        try:
            close()
        except Exception:  # noqa: BLE001 - the rollback is already loud
            pass


class Autoscaler:
    """The supervised control loop around one DynamicBatcher.

    `engine_factory()` must return a NOT-yet-registered engine replica
    (fresh name, on its device) — the scaler runs its full `warmup()`
    before the batcher ever sees it. `spawn_hook` is the fault-injection
    seam (resilience/faults.spawn_fault):
    called once per spawn attempt with {"attempt", "n_engines"}; a raise
    there — or anywhere in factory/warmup — is a failed scale-out and
    rolls back loudly. `rules` arms the in-process SLO monitor's
    upper-bound triggers (e.g. {"p99_ms": 250.0, "shed_rate": 0.05});
    the headroom low/high-water signal always rides the capacity
    records directly.

    Use as a context manager (or start()/stop()); `tick()` is public so
    the fake-clock tests drive one evaluation without any thread."""

    def __init__(
        self,
        batcher,
        engine_factory: Callable[[], object],
        *,
        policy: Optional[ElasticPolicy] = None,
        rules: Optional[Dict[str, float]] = None,
        writer=None,
        interval_s: float = 0.5,
        spawn_hook=None,
        warm_degraded_iters: Optional[int] = None,
        forecast=None,
        warm_pool: int = 0,
        fleet: str = "fleet0",
        clock=time.monotonic,
    ):
        from glom_tpu_torch.telemetry.aggregate import SLOMonitor

        if interval_s <= 0:
            raise ValueError(f"interval_s {interval_s} must be > 0")
        if warm_pool < 0:
            raise ValueError(f"warm_pool {warm_pool} must be >= 0")
        self.batcher = batcher
        self.engine_factory = engine_factory
        scfg = getattr(batcher.engine, "scfg", None)
        if policy is None:
            if scfg is None:
                policy = ElasticPolicy(clock=clock)
            else:
                policy = resolve_policy(scfg, clock=clock)
        self.policy = policy
        self.writer = writer
        self.interval_s = interval_s
        self.spawn_hook = spawn_hook
        self.warm_degraded_iters = warm_degraded_iters
        # The live forecast glue (telemetry/forecast.py ForecastEmitter,
        # tapped into the batcher's event stream by the caller): each
        # tick pulls its latest closed-window load forecast and the
        # spawn-lead-time quantile into the policy. None = the policy's
        # anticipatory inputs stay dark (reactive semantics).
        self.forecast = forecast
        self.warm_pool = int(warm_pool)
        self.fleet = str(fleet)
        self._clock = clock
        self.monitor = SLOMonitor(
            dict(rules or {}),
            window_s=policy.window_s,
            writer=writer,
            clock=clock,
        )
        # The batcher's event tap feeds the monitor every emitted serve
        # record (resolve leaves, sheds) — the autoscaler sees the same
        # stream `telemetry watch` would tail, in process, with no file.
        batcher.add_event_tap(self.monitor.observe)
        batcher.attach_elastic(self)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Counters + the fleet timeline, guarded by one lock: the control
        # thread writes, record()/summary readers snapshot.
        self._lock = threading.Lock()
        self._t0 = clock()
        self._decision_seq = 0
        self._last_decision_id: Optional[int] = None
        self._spawn_attempts = 0
        self.n_scale_outs = 0
        self.n_scale_ins = 0
        self.n_spawn_failures = 0
        self.n_ticks = 0
        self.n_decisions = 0
        self.decisions_late = 0
        self.spawn_lead_violations = 0
        self.n_migrated_sessions = 0
        self.n_invalidated_sessions = 0
        self.migrated_bytes = 0
        self._spawn_ms: List[float] = []
        # Warm-pool spares: pre-spawned, fully-warmed engines held
        # OUTSIDE the batcher (never registered — a spare is not a husk
        # and serves no traffic) until a scale-out promotes one.
        self._spares: List[object] = []
        self._spare_spawn_ms: List[float] = []
        self.n_promotions = 0
        self.n_demotions = 0
        self._timeline: List[list] = [
            [0.0, batcher.n_active_engines()]
        ]

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is None or not self._thread.is_alive():
            self.fill_warm_pool()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="glom-serve-autoscaler", daemon=True
            )
            self._thread.start()
        return self

    def fill_warm_pool(self) -> int:
        """Pre-spawn spares up to `warm_pool` (factory + FULL warmup,
        exactly the scale-out build), held outside admission. Runs
        before the control thread starts — provisioning happens before
        traffic, and each spare's spawn_ms is REAL lead-time evidence
        (the "spare_spawn" event feeds ForecastEmitter's lead model),
        so the anticipatory signal can arm before the first live
        scale-out. A failed spare spawn is stamped and stops the fill —
        the fleet runs with the spares it has."""
        n_built = 0
        while True:
            with self._lock:
                if len(self._spares) >= self.warm_pool:
                    return n_built
                n_spares = len(self._spares)
            t0 = self._clock()
            engine = None
            try:
                engine = self.engine_factory()
                warmup = getattr(engine, "warmup", None)
                if callable(warmup):
                    warmup()
                    if self.warm_degraded_iters is not None:
                        warmup(iters_override=self.warm_degraded_iters)
            except BaseException as e:  # noqa: BLE001 — stamped, fill stops
                _close_quietly(engine)
                self._emit(
                    {
                        "event": "spawn_rollback",
                        "decision_id": None,
                        "fleet": self.fleet,
                        "spare": True,
                        "n_engines": self.batcher.n_active_engines(),
                        "exception": f"{type(e).__name__}: {e}"[:300],
                    }
                )
                return n_built
            spawn_ms = round(1e3 * (self._clock() - t0), 3)
            with self._lock:
                self._spares.append(engine)
                self._spare_spawn_ms.append(spawn_ms)
                n_spares = len(self._spares)
            n_built += 1
            self._emit(
                {
                    "event": "spare_spawn",
                    "fleet": self.fleet,
                    "engine": getattr(engine, "name", None),
                    "spawn_ms": spawn_ms,
                    "n_spares": n_spares,
                    "n_engines": self.batcher.n_active_engines(),
                }
            )

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=60.0)
        self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        # Supervised: one tick's exception is stamped evidence, never the
        # loop's death — a control plane that silently stops controlling
        # is the failure mode this file exists to not have.
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except BaseException as e:  # noqa: BLE001 — stamped, loop lives
                self._emit(
                    {
                        "error": "autoscaler-tick",
                        "value": None,
                        "note": f"{type(e).__name__}: {e}"[:300],
                    },
                    kind="error",
                )

    # -- the control tick --------------------------------------------------

    def tick(self) -> Optional[dict]:
        """One evaluation: capacity -> signals -> policy -> (maybe) act.
        Returns the decision taken, or None."""
        caps = self.batcher.capacity_records()
        for c in caps:
            # Live capacity on the stream each tick (the summary-only
            # cadence is too coarse for a watch tailing the scale loop)
            # and into the monitor (which skips probation/draining
            # headroom — the capacity-record contract).
            self._emit(c, kind=None)
            self.monitor.observe(c)
        eligible = [
            c["headroom"] for c in caps
            if c.get("state") == "ok"
            and isinstance(c.get("headroom"), (int, float))
        ]
        if eligible:
            self.policy.observe_headroom(min(eligible))
        # The capacity side of the anticipated deficit: the fleet's
        # measured ok-engine service rate, refreshed every tick.
        rates = [
            c["service_rate_rps"] for c in caps
            if c.get("state") == "ok"
            and isinstance(c.get("service_rate_rps"), (int, float))
        ]
        self.policy.note_service_rate(sum(rates) if rates else None)
        if self.forecast is not None:
            self.policy.note_forecast(self.forecast.latest_forecast())
            lead_model = self.forecast.lead_model
            self.policy.note_lead_time(
                lead_model.lead_time_ms(), lead_model.quantile
            )
        for b in self.monitor.evaluate():
            # Lower-bound rules (headroom) are the policy's OWN water
            # marks — only upper-bound breaches (p99, shed_rate) feed
            # the breach-precedence signal.
            if b.get("bound") != "lower":
                self.policy.note_breach(b["rule"])
        with self._lock:
            self.n_ticks += 1
        n = self.batcher.n_active_engines()
        decision = self.policy.decide(n)
        if decision is None:
            return None
        if decision["action"] == "scale_out":
            self._scale_out(n, decision["signal"], decision.get("evidence"))
        else:
            self._scale_in(
                n, decision["signal"], caps, decision.get("evidence")
            )
        return decision

    def _mint_decision(
        self, action: str, evidence: Optional[dict]
    ) -> int:
        """Mint the next decision_id and stamp the schema-v10 "decision"
        record — the evidence bundle, the action the pure policy
        function derived from it, and the chain link to the previous
        decision. Every actuation event that follows carries this id."""
        from glom_tpu_torch.telemetry.audit import binding_breaches

        with self._lock:
            self._decision_seq += 1
            decision_id = self._decision_seq
            prev = self._last_decision_id
            self._last_decision_id = decision_id
            self.n_decisions += 1
            if (
                action == "scale_out"
                and isinstance(evidence, dict)
                and binding_breaches(evidence)
            ):
                # Scaled AFTER the SLO already broke — the reactive
                # failure mode the anticipatory signal exists to avoid.
                self.decisions_late += 1
        self._emit(
            {
                "t": round(self._clock() - self._t0, 3),
                "fleet": self.fleet,
                "decision_id": decision_id,
                "prev_decision_id": prev,
                "action": action,
                "evidence": evidence,
            },
            kind="decision",
        )
        return decision_id

    def _note_fleet(self, n: int) -> None:
        with self._lock:
            self._timeline.append(
                [round(self._clock() - self._t0, 3), n]
            )

    def _scale_out(
        self, n: int, signal: dict, evidence: Optional[dict] = None
    ) -> None:
        decision_id = self._mint_decision("scale_out", evidence)
        self._emit(
            {
                "event": "scale_out_decision",
                "decision_id": decision_id,
                "fleet": self.fleet,
                "n_engines": n,
                "signal": signal,
            }
        )
        # A warm spare absorbs the scale-out at ~0 spawn cost: promote
        # it (register with the batcher) instead of building cold.
        with self._lock:
            spare = self._spares.pop(0) if self._spares else None
        if spare is not None:
            self._promote_spare(spare, decision_id, n)
            return
        with self._lock:
            self._spawn_attempts += 1
            attempt = self._spawn_attempts
        t0 = self._clock()
        engine = None
        try:
            if self.spawn_hook is not None:
                self.spawn_hook({"attempt": attempt, "n_engines": n})
            engine = self.engine_factory()
            # The full warm-up, off the hot path: every bucket
            # signature (and the ladder's degraded route when armed)
            # runs once before admission can open. A fake engine without
            # warmup() is the policy tests' no-op.
            warmup = getattr(engine, "warmup", None)
            if callable(warmup):
                warmup()
                if self.warm_degraded_iters is not None:
                    warmup(iters_override=self.warm_degraded_iters)
        except BaseException as e:  # noqa: BLE001 — rollback is the contract
            # FAILED scale-out: no registration, loud evidence, cooldown
            # still charged (a persistently failing spawn must not retry
            # every tick at full speed).
            _close_quietly(engine)
            with self._lock:
                self.n_spawn_failures += 1
            self.policy.acted("spawn_rollback")
            self._emit(
                {
                    "event": "spawn_rollback",
                    "decision_id": decision_id,
                    "fleet": self.fleet,
                    "n_engines": n,
                    "exception": f"{type(e).__name__}: {e}"[:300],
                }
            )
            return
        spawn_ms = round(1e3 * (self._clock() - t0), 3)
        name = self.batcher.add_engine(
            engine,
            detail={"decision_id": decision_id, "fleet": self.fleet},
        )
        # Did the spawn land inside the lead the decision believed? A
        # violation means the anticipatory act-ahead margin was too
        # short — the audit counts these against the lead-time model.
        lead_ms = (
            evidence.get("lead_time_ms")
            if isinstance(evidence, dict) else None
        )
        violation = (
            isinstance(lead_ms, (int, float)) and spawn_ms > lead_ms
        )
        with self._lock:
            self.n_scale_outs += 1
            self._spawn_ms.append(spawn_ms)
            if violation:
                self.spawn_lead_violations += 1
        self.policy.acted("scale_out")
        self._note_fleet(n + 1)
        rec = {
            "event": "scale_out",
            "decision_id": decision_id,
            "fleet": self.fleet,
            "engine": name,
            "spawn_ms": spawn_ms,
            "n_engines": n + 1,
            "signal": signal,
        }
        if violation:
            rec["lead_violation"] = True
            rec["lead_time_ms"] = lead_ms
        self._emit(rec)
        # Admission is OPEN from add_engine's worker start — stamped as
        # its own transition so a chain check can pin the order:
        # decision -> (warmup inside spawn_ms) -> admission.
        self._emit(
            {
                "event": "admission_open",
                "decision_id": decision_id,
                "fleet": self.fleet,
                "engine": name,
                "n_engines": n + 1,
            }
        )

    def _promote_spare(self, engine, decision_id: int, n: int) -> None:
        """Register a pre-warmed spare with the batcher — the ~0-cost
        scale-out path. A demoted spare's old name lives on in the
        batcher as a drained husk (the evidence of its drain), so a
        re-promotion takes a fresh suffixed name."""
        t0 = self._clock()
        base = getattr(engine, "name", None) or "spare"
        name = base
        k = 0
        while name in getattr(self.batcher, "_engine_state", {}):
            k += 1
            name = f"{base}~p{k}"
        if name != base:
            try:
                engine.name = name
            except AttributeError:
                pass
        name = self.batcher.add_engine(
            engine,
            name=name,
            detail={
                "decision_id": decision_id,
                "fleet": self.fleet,
                "spare": True,
            },
        )
        promote_ms = round(1e3 * (self._clock() - t0), 3)
        with self._lock:
            self.n_promotions += 1
            n_spares = len(self._spares)
        self.policy.acted("scale_out")
        self._note_fleet(n + 1)
        self._emit(
            {
                "event": "spare_promote",
                "decision_id": decision_id,
                "fleet": self.fleet,
                "engine": name,
                "promote_ms": promote_ms,
                "n_spares": n_spares,
                "n_engines": n + 1,
            }
        )
        self._emit(
            {
                "event": "admission_open",
                "decision_id": decision_id,
                "fleet": self.fleet,
                "engine": name,
                "n_engines": n + 1,
            }
        )

    def _scale_in(
        self,
        n: int,
        signal: dict,
        caps: List[dict],
        evidence: Optional[dict] = None,
    ) -> None:
        target = self.policy.pick_drain_target(caps)
        if target is None:
            return
        decision_id = self._mint_decision("scale_in", evidence)
        self._emit(
            {
                "event": "scale_in_decision",
                "decision_id": decision_id,
                "fleet": self.fleet,
                "engine": target,
                "n_engines": n,
                "signal": signal,
            }
        )
        # Resolve the engine object BEFORE the drain: husk retention
        # (husk_max=0) may retire the name from the batcher's registry
        # inside drain_engine, and a retired husk must still be able to
        # demote into the warm pool — the spare outlives its husk.
        engine = self.batcher.engine_by_name(target)
        try:
            stats = self.batcher.drain_engine(
                target,
                detail={"decision_id": decision_id, "fleet": self.fleet},
            )
        except ValueError as e:
            # Raced a death/concurrent drain: the fleet can no longer
            # spare the target — stamped, no action, cooldown charged.
            self.policy.acted("drain_abort")
            self._emit(
                {
                    "event": "drain_abort",
                    "decision_id": decision_id,
                    "fleet": self.fleet,
                    "engine": target,
                    "exception": f"{type(e).__name__}: {e}"[:300],
                }
            )
            return
        # Demote into the warm pool instead of releasing when the pool
        # is below target: the drained engine keeps its device state and
        # warmed signatures, so the next scale-out promotes it at ~0
        # cost. Otherwise release as before.
        demote = False
        if engine is not None:
            with self._lock:
                if len(self._spares) < self.warm_pool:
                    self._spares.append(engine)
                    self.n_demotions += 1
                    demote = True
                    n_spares = len(self._spares)
        if not demote:
            release = getattr(engine, "release", None)
            if callable(release):
                release()
        with self._lock:
            self.n_scale_ins += 1
            self.n_migrated_sessions += stats.get("n_migrated", 0)
            self.n_invalidated_sessions += stats.get("n_invalidated", 0)
            self.migrated_bytes += stats.get("bytes_migrated", 0)
        self.policy.acted("scale_in")
        self._note_fleet(n - 1)
        self._emit(
            {
                "event": "drain_release",
                "decision_id": decision_id,
                "fleet": self.fleet,
                "engine": target,
                "n_engines": n - 1,
                "demoted": demote,
                **{
                    k: stats.get(k)
                    for k in (
                        "n_migrated", "n_invalidated", "bytes_migrated",
                        "flush_ok",
                    )
                },
            }
        )
        if demote:
            self._emit(
                {
                    "event": "spare_demote",
                    "decision_id": decision_id,
                    "fleet": self.fleet,
                    "engine": target,
                    "n_spares": n_spares,
                    "n_engines": n - 1,
                }
            )

    # -- telemetry ---------------------------------------------------------

    def _emit(self, rec: dict, kind: Optional[str] = "serve") -> None:
        from glom_tpu_torch.tracing.flight import write_or_observe

        if kind is None:
            # Already-stamped records (the capacity rollup) pass through.
            write_or_observe(self.writer, rec)
            return
        if kind in ("serve", "decision"):
            stamped = rec
            if kind == "serve":
                from glom_tpu_torch.serve.events import emit_serve

                stamped = emit_serve(self.writer, rec)
            else:
                stamped = schema.stamp(rec, kind="decision")
                write_or_observe(self.writer, stamped)
            # Scale events AND decision records join the batcher's tap
            # fan-out: the forecast emitter's spawn-lead-time model
            # (telemetry/forecast.py) reads spawn_ms from the same
            # in-process stream `telemetry watch` would tail — the
            # scale_out record must not exist only on disk. Taps never
            # kill the control loop.
            for tap in list(getattr(self.batcher, "_taps", ())):
                try:
                    tap(stamped)
                except Exception:  # noqa: BLE001
                    pass
            return
        write_or_observe(self.writer, schema.stamp(rec, kind=kind))

    def record(self) -> dict:
        """The `elastic` summary nest (serve/batcher.summary_record nests
        it; `telemetry compare` flattens it as serve_elastic.* rows with
        spawn latency and migration bytes classified as costs)."""
        with self._lock:
            spawn_ms = list(self._spawn_ms)
            spare_spawn_ms = list(self._spare_spawn_ms)
            rec = {
                "n_scale_outs": self.n_scale_outs,
                "n_scale_ins": self.n_scale_ins,
                "n_spawn_failures": self.n_spawn_failures,
                "n_ticks": self.n_ticks,
                # The decision observatory's runtime counters (the audit
                # recomputes all three from the JSONL independently):
                # decisions_late = scale-outs decided while a breach was
                # already live; spawn_lead_violations = spawns slower
                # than the lead the decision believed. `telemetry
                # compare` classifies every one a cost.
                "n_decisions": self.n_decisions,
                "decisions_late": self.decisions_late,
                "spawn_lead_violations": self.spawn_lead_violations,
                # Warm-pool spares (a spare is NOT a husk: it was never
                # registered with the batcher, serves no traffic, and
                # husk retention cannot touch it).
                "warm_pool": self.warm_pool,
                "n_spares": len(self._spares),
                "n_promotions": self.n_promotions,
                "n_demotions": self.n_demotions,
                "spare_spawn_ms_mean": (
                    round(sum(spare_spawn_ms) / len(spare_spawn_ms), 3)
                    if spare_spawn_ms else None
                ),
                "n_migrated_sessions": self.n_migrated_sessions,
                "n_invalidated_sessions": self.n_invalidated_sessions,
                "migrated_bytes": self.migrated_bytes,
                "spawn_ms_mean": (
                    round(sum(spawn_ms) / len(spawn_ms), 3)
                    if spawn_ms else None
                ),
                "spawn_ms_max": max(spawn_ms) if spawn_ms else None,
                # The RAW spawn latencies, in spawn order: the lead-time
                # model (telemetry/forecast.py SpawnLeadTimeModel) fits
                # its percentile from these, not from the mean/max pair.
                "spawn_ms": spawn_ms,
                "n_engines": self.batcher.n_active_engines(),
                "n_engines_peak": max(n for _, n in self._timeline),
                # The fleet-size timeline ([t_rel_s, n_engines] per
                # change), what fleet-size reports read.
                "timeline": [list(e) for e in self._timeline],
            }
        return rec
