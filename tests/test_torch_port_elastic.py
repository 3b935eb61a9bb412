"""The port's elastic fleet (`glom_tpu_torch/serve/elastic.py` and the
batcher's fleet methods) against glom_tpu's, on the CPU.

  * `ElasticPolicy` is pure Python: the same fake clock and the same
    headroom, breach, forecast and service-rate sequences give equal
    decisions, signal windows and evidence bundles in both packages.
  * The `Autoscaler` over a `DynamicBatcher`: both packages run the same
    scripted policy over engine-shaped fakes (each package's own result
    type) under fake clocks, and the fleet's stamped chain (decision
    records, the scale, drain, spare and husk events with their
    `decision_id`s) and its counters must be exact.
  * A fleet of real CPU engines (the tiny config, page pools and the
    session column cache): a scale-out by spawn, a scale-in that drains
    the engine holding the sessions, their pages migrated to the sibling
    bit for bit and the next frames served warm from it. Levels are held
    at rtol 2e-3 / atol 2e-4, iterations, routes and counters exactly.
  * Session migration on the port's pools: bit for bit with the same
    content hash, through the destination's aliasing seam, and each
    fallback (no budget, no destination, a pinned session, host mode).
  * `python -m glom_tpu_torch.telemetry audit` on a fleet's stream exits
    0, and 1 once a decision_id is dropped.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from glom_tpu.resilience import faults as jfaults
from glom_tpu.serve import batcher as jbatcher
from glom_tpu.serve import elastic as jelastic
from glom_tpu.serve import engine as jengine
from glom_tpu.telemetry import audit as jaudit
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import GlomConfig, InferenceEngine, ServeConfig
from glom_tpu_torch.resilience import faults as tfaults
from glom_tpu_torch.serve import batcher as tbatcher
from glom_tpu_torch.serve import elastic as telastic
from glom_tpu_torch.serve import engine as tengine
from glom_tpu_torch.serve.column_cache import ColumnCache, column_state_bytes
from glom_tpu_torch.serve.paged_columns import PagedColumnPool, content_hash
from glom_tpu_torch.telemetry import schema
from test_torch_port_batcher import AUTO, ListWriter, _images, model  # noqa: F401
from test_torch_port_model import ATOL, RTOL, TINY

REPO = Path(__file__).resolve().parent.parent
IMG = np.zeros((3, 8, 8), np.float32)
PKGS = {
    "ref": (jbatcher, jelastic, jengine, jconfig, jfaults),
    "port": (tbatcher, telastic, tengine, __import__("glom_tpu_torch.utils.config",
                                                     fromlist=["ServeConfig"]), tfaults),
}
FLEET_EVENTS = (*telastic.SCALE_EVENTS, "engine_add", "drain_abort", "engine_husk_retired",
                "cache_migrate", "engine_probation")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


def fake_engine(pkg, name="engine0", buckets=(1, 2, 4), **kw):
    """An engine-shaped probe that records warm-up and dispatch order, in
    `pkg`'s result type (numpy for glom_tpu, torch for the port)."""
    _, _, eng_mod, cfg_mod, _ = PKGS[pkg]

    class FakeEngine:
        def __init__(self):
            self.name = name
            self.scfg = cfg_mod.ServeConfig(buckets=buckets, max_batch=max(buckets),
                                            max_delay_ms=2.0, queue_depth=16, **kw)
            self.warmed = self.released = False
            self.calls = []
            self.infer_before_warmup = 0

        def warmup(self, *a, **k):
            self.warmed = True
            return {}

        def release(self):
            self.released = True

        def pick_bucket(self, n):
            return next(b for b in self.scfg.buckets if n <= b)

        def infer(self, imgs, n_valid=None, **k):
            if not self.warmed:
                self.infer_before_warmup += 1
            b = imgs.shape[0]
            self.calls.append((b, n_valid))
            levels = (np.zeros((b, 16, 3, 16), np.float32) if pkg == "ref"
                      else torch.zeros((b, 16, 3, 16)))
            return eng_mod.ServeResult(levels=levels, iters_run=4, latency_s=0.0, bucket=b,
                                       compiled=False)

    return FakeEngine()


def scripted(pkg, actions, *, evidenced=False, target=None, clock=None):
    """A policy that pops scripted actions; `evidenced` stamps a real
    evidence bundle that replays to the action; `target` pins the drain."""
    elastic = PKGS[pkg][1]

    class Scripted(elastic.ElasticPolicy):
        def __init__(self):
            super().__init__(min_engines=1, max_engines=8, clock=clock or FakeClock())
            self._actions = list(actions)

        def decide(self, n_engines):
            if not self._actions:
                return None
            action = self._actions.pop(0)
            out = {"action": action, "signal": {"rule": "test"}}
            if evidenced:
                ev = self.evidence(n_engines)
                if action == "scale_out":
                    ev["breaches"] = ["p99_ms"]
                else:
                    ev["above_held_s"] = ev["dwell_s"] + 1.0
                out["evidence"] = ev
            return out

        def pick_drain_target(self, caps):
            return target or elastic.ElasticPolicy.pick_drain_target(caps)

    return Scripted()


def chain(recs):
    """The fleet's stamped chain: decision records and fleet events, with
    the fields both packages stamp from the same inputs."""
    out = []
    for r in recs:
        if r.get("kind") == "decision":
            ev = r["evidence"]
            if ev is not None and ev.get("fleet_service_rate_rps") is not None:
                # A measured rate (rows a second of engine time) differs
                # between runs; that it was measured is what both share.
                ev = dict(ev, fleet_service_rate_rps="measured")
            out.append(("decision", r["decision_id"], r["prev_decision_id"], r["fleet"],
                        r["action"], json.dumps(ev, sort_keys=True)))
        elif r.get("kind") == "serve" and r.get("event") in FLEET_EVENTS:
            out.append(tuple((k, r.get(k)) for k in (
                "event", "decision_id", "fleet", "engine", "n_engines", "n_spares",
                "demoted", "spare", "n_migrated", "n_invalidated", "bytes_migrated",
                "flush_ok", "reason", "src_engine", "dst_engine", "bytes", "spawn_ms")))
    return out


def _wait_served(b, n, timeout=30.0):
    t0 = time.monotonic()
    while b.summary_record()["n_served"] < n:
        assert time.monotonic() - t0 < timeout
        time.sleep(0.005)


# -- the policy core --------------------------------------------------------


def _script(seed, n=60):
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n):
        u = rng.random()
        if u < 0.65:
            steps.append(("headroom", float(rng.choice([0.05, 0.1, 0.4, 0.65, 0.8, 0.95]))))
        elif u < 0.75:
            steps.append(("breach", str(rng.choice(["p99_ms", "shed_rate", "p99_ms[batch]"]))))
        elif u < 0.85:
            steps.append(("forecast", {
                "predicted": float(rng.uniform(0, 40)), "horizon_s": 0.5,
                "forecast_abs_err": None if rng.random() < 0.4 else float(rng.uniform(0, 3)),
                "trend_per_s": float(rng.normal()), "t": 1.0}))
        elif u < 0.9:
            steps.append(("lead", float(rng.uniform(50, 900))))
        else:
            steps.append(("rate", float(rng.uniform(0, 30))))
        steps.append(("dt", float(rng.choice([0.0, 0.2, 0.6, 1.5]))))
    return steps


POLICY_CASES = [
    dict(),
    dict(min_engines=1, max_engines=3, low_water=0.2, high_water=0.7, dwell_s=1.0,
         cooldown_s=2.0, window_s=5.0),
    dict(dwell_s=0.0, cooldown_s=0.0, anticipatory=True, target_utilization=0.6),
    dict(anticipatory=True, low_classes={"batch"}, class_weights={"batch": 1.0,
                                                                 "premium": 8.0}),
]


@pytest.mark.parametrize("kw", POLICY_CASES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_decisions_equal_reference(kw, seed):
    clocks = FakeClock(), FakeClock()
    pols = [mod.ElasticPolicy(clock=c, **kw) for mod, c in zip((jelastic, telastic), clocks)]
    n, acted = 1, []
    for op, arg in _script(seed):
        for p, c in zip(pols, clocks):
            if op == "dt":
                c.advance(arg)
            elif op == "headroom":
                p.observe_headroom(arg)
            elif op == "breach":
                p.note_breach(arg)
            elif op == "forecast":
                p.note_forecast(arg)
            elif op == "lead":
                p.note_lead_time(arg, 0.9)
            else:
                p.note_service_rate(arg)
        want, got = pols[0].decide(n), pols[1].decide(n)
        assert got == want
        assert pols[1].active_breaches() == pols[0].active_breaches()
        if got is not None:
            for p in pols:
                p.acted(got["action"])
            acted.append(got["action"])
            n += 1 if got["action"] == "scale_out" else -1
    caps = [{"engine": f"e{i}", "state": s, "headroom": h}
            for i, (s, h) in enumerate((("ok", 0.3), ("draining", 0.9), ("ok", 0.3),
                                        ("probation", 1.0)))]
    assert telastic.ElasticPolicy.pick_drain_target(caps) == \
        jelastic.ElasticPolicy.pick_drain_target(caps) == "e2"
    assert acted


@pytest.mark.parametrize("kw", [
    dict(), dict(min_engines=2, max_engines=5, elastic_dwell_s=0.5, elastic_cooldown_s=1.0,
                 elastic_window_s=3.0, elastic_anticipatory=True,
                 elastic_target_utilization=0.6),
    dict(slo_classes=("premium:weight=8,p99_ms=150", "batch:weight=1,shed_rate=0.5")),
])
def test_resolve_policy_equals_reference(kw):
    j = jelastic.resolve_policy(jconfig.ServeConfig(**kw), clock=FakeClock())
    t = telastic.resolve_policy(ServeConfig(**kw), clock=FakeClock())
    for attr in ("min_engines", "max_engines", "low_water", "high_water", "dwell_s",
                 "cooldown_s", "window_s", "anticipatory", "target_utilization",
                 "low_classes", "class_weights"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.evidence(1) == j.evidence(1)


@pytest.mark.parametrize("kw", [dict(min_engines=0), dict(max_engines=0),
                                dict(low_water=0.8), dict(dwell_s=-1.0), dict(window_s=0.0),
                                dict(target_utilization=0.0)])
def test_policy_validation_equals_reference(kw):
    with pytest.raises(ValueError) as want:
        jelastic.ElasticPolicy(**kw)
    with pytest.raises(ValueError) as got:
        telastic.ElasticPolicy(**kw)
    assert str(got.value) == str(want.value)


# -- the autoscaler over fake engines ---------------------------------------


def _fleet(pkg, n=1, writer=None, engine_kw=None, **bkw):
    batcher = PKGS[pkg][0]
    engines = [fake_engine(pkg, f"engine{i}", **(engine_kw or {})) for i in range(n)]
    for e in engines:
        e.warmup()
    return batcher.DynamicBatcher(engines=engines, writer=writer, **bkw), engines


def _both(run):
    """run(pkg) -> (records, extra) in each package; the chains must be
    equal. Returns the port's (records, extra)."""
    (jrecs, jx), (trecs, tx) = run("ref"), run("port")
    assert chain(trecs) == chain(jrecs)
    assert tx == jx
    return trecs, tx


def test_spawn_warms_before_admission():
    """A spawned engine takes no admitted work before its warm-up
    returned; the chain is decision, scale_out_decision, engine_add,
    scale_out, admission_open under one decision_id."""
    def run(pkg):
        w = ListWriter()
        b, _ = _fleet(pkg, 1, writer=w)
        spawned = []

        def factory():
            spawned.append(fake_engine(pkg, "engine1"))
            return spawned[-1]

        with b:
            sc = PKGS[pkg][1].Autoscaler(b, factory, policy=scripted(pkg, ["scale_out"],
                                                                      evidenced=True),
                                         writer=w, clock=FakeClock())
            assert sc.tick() is not None and b.n_active_engines() == 2
            for _ in range(8):
                b.submit(IMG)
            _wait_served(b, 8)
        (eng,) = spawned
        return w.recs, (eng.warmed, eng.infer_before_warmup, sc.record()["n_scale_outs"],
                        b.summary_record()["n_served"])

    recs, extra = _both(run)
    assert extra == (True, 0, 1, 8)
    assert [r[0][1] for r in chain(recs)[1:]] == [
        "scale_out_decision", "engine_add", "scale_out", "admission_open"]


@pytest.mark.parametrize("how", ["spawn_fault", "factory", "warmup"])
def test_failed_spawn_rolls_back(how):
    """An injected spawn fault, a raising factory or a raising warm-up: the
    fleet is unchanged, spawn_rollback is stamped with the decision_id, the
    fault event names its site, the next attempt lands."""
    def run(pkg):
        w = ListWriter()
        b, _ = _fleet(pkg, 1, writer=w)
        faults = PKGS[pkg][4]
        plan = faults.FaultPlan(writer=w)
        plan.register("engine-spawn", at=(0,), fault="spawn-fault")
        calls = []

        def factory():
            calls.append(1)
            if how == "factory" and len(calls) == 1:
                raise RuntimeError("no device memory left")
            e = fake_engine(pkg, f"engine{len(calls)}")
            if how == "warmup" and len(calls) == 1:
                def broken(*a, **k):
                    raise RuntimeError("warmup failed")
                e.warmup = broken
            return e

        with b:
            sc = PKGS[pkg][1].Autoscaler(
                b, factory, policy=scripted(pkg, ["scale_out", "scale_out"], evidenced=True),
                writer=w, clock=FakeClock(),
                spawn_hook=faults.spawn_fault(plan) if how == "spawn_fault" else None)
            sc.tick()
            after_one = b.n_active_engines()
            sc.tick()
        rb = [r for r in w.recs if r.get("event") == "spawn_rollback"]
        faults_seen = [r["site"] for r in w.recs if r.get("kind") == "fault"]
        return w.recs, (after_one, b.n_active_engines(), sc.n_spawn_failures, len(rb),
                        rb[0]["exception"].split(":")[0], rb[0]["decision_id"], faults_seen)

    _, extra = _both(run)
    assert extra[:4] == (1, 2, 1, 1) and extra[5] == 1
    assert extra[6] == (["engine-spawn"] if how == "spawn_fault" else [])


def test_drain_chain_and_release():
    """The graceful drain: decision, scale_in_decision, drain_begin,
    drain_flush, drain_migrate, drain_release under one decision_id; the
    drained engine is drained, not dead (no probation with rejoin armed, no
    capacity record), released, and later requests go to the survivor."""
    def run(pkg):
        w = ListWriter()
        b, engines = _fleet(pkg, 2, writer=w, rejoin_threshold=3)
        with b:
            for _ in range(4):
                b.submit(IMG)
            _wait_served(b, 4)
            sc = PKGS[pkg][1].Autoscaler(b, lambda: fake_engine(pkg, "x"), writer=w,
                                         policy=scripted(pkg, ["scale_in"], evidenced=True),
                                         clock=FakeClock())
            assert sc.tick() is not None
            for _ in range(6):
                b.submit(IMG)
            _wait_served(b, 10)
            s = b.summary_record()
            caps = b.capacity_records()
        drained = [r for r in w.recs if r.get("event") == "drain_release"][0]["engine"]
        return w.recs, (drained, b.engine_by_name(drained).released,
                        s["engines"][drained].get("drained"), s["n_failed"], s["n_served"],
                        sorted(c["engine"] for c in caps), [c["state"] for c in caps],
                        s["elastic"]["n_scale_ins"], s["elastic"]["n_engines"])

    recs, extra = _both(run)
    assert extra == ("engine1", True, True, 0, 10, ["engine0"], ["ok"], 1, 1)
    assert [r[0][1] for r in chain(recs)[1:]] == [
        "scale_in_decision", "drain_begin", "drain_flush", "drain_migrate", "drain_release"]


def test_fleet_method_refusals_equal_reference():
    """The last live engine is never drained; a dead, draining or unknown
    engine is refused; a duplicate name is refused; each with glom_tpu's
    message. The drained engine never enters probation, and while a
    sibling drains the last admitting engine is never marked dead."""
    msgs = {}
    for pkg in PKGS:
        b1, _ = _fleet(pkg, 1)
        b2, engines = _fleet(pkg, 2, rejoin_threshold=2)
        out = []
        for call in (lambda: b1.drain_engine("engine0"), lambda: b1.begin_drain("nope"),
                     lambda: b1.add_engine(fake_engine(pkg, "engine0"))):
            with pytest.raises(ValueError) as e:
                call()
            out.append(str(e.value))
        b2.begin_drain("engine1")
        with pytest.raises(ValueError) as e:
            b2.begin_drain("engine1")
        out.append(str(e.value))
        for _ in range(5):
            state = b2._note_failure("engine0")
        out.append((state["alive"], b2._alive_engines(), b2.n_active_engines()))
        caps = {c["engine"]: c["state"] for c in b2.capacity_records()}
        out.append(caps)
        b3, engines3 = _fleet(pkg, 2, rejoin_threshold=2)
        with b3:
            stats = b3.drain_engine("engine0")
        b3._start_probation(engines3[0], "engine0")
        out.append((stats, dict(b3._engine_state["engine0"]), "engine0" in b3._drained))
        msgs[pkg] = out
    assert msgs["port"] == msgs["ref"]
    assert msgs["port"][5] == {"engine0": "ok", "engine1": "draining"}


def test_tick_feeds_only_eligible_headroom():
    seen = {}
    for pkg in PKGS:
        elastic = PKGS[pkg][1]
        got = seen[pkg] = []

        class Recording(elastic.ElasticPolicy):
            def observe_headroom(self, h):
                got.append(h)
                super().observe_headroom(h)

        b, _ = _fleet(pkg, 2)
        b.begin_drain("engine0")
        elastic.Autoscaler(b, lambda: None, policy=Recording(clock=FakeClock()),
                           clock=FakeClock()).tick()
    assert seen["port"] == seen["ref"] == [1.0]


def test_warm_pool_fill_promote_demote():
    """fill_warm_pool builds and warms a spare outside admission; a
    scale-out promotes it (no cold spawn); a scale-in demotes the drained
    engine back into the pool (no release); the next scale-out re-promotes
    it under a suffixed name. The chain audits clean."""
    def run(pkg):
        w = ListWriter()
        b, _ = _fleet(pkg, 1, writer=w)
        built = []

        def factory():
            built.append(fake_engine(pkg, f"engine{1 + len(built)}"))
            return built[-1]

        with b:
            sc = PKGS[pkg][1].Autoscaler(
                b, factory, writer=w, warm_pool=1, clock=FakeClock(),
                policy=scripted(pkg, ["scale_out", "scale_in", "scale_out"], evidenced=True,
                                target="engine1"))
            n_fill = sc.fill_warm_pool()
            fleet = [b.n_active_engines()]
            for _ in range(3):
                sc.tick()
                fleet.append(b.n_active_engines())
            el = sc.record()
            s = b.summary_record()
        return w.recs, (n_fill, fleet, len(built), built[0].released,
                        {k: el[k] for k in ("n_promotions", "n_demotions", "n_spares",
                                            "n_scale_outs", "n_scale_ins", "timeline")},
                        sorted(s["engines"]))

    recs, extra = _both(run)
    assert extra[:4] == (1, [1, 2, 1, 2], 1, False)
    assert extra[5] == ["engine0", "engine1", "engine1~p1"]
    assert taudit_errors(recs) == []


def taudit_errors(recs):
    from glom_tpu_torch.telemetry.audit import audit_records

    rep = audit_records(recs)
    assert rep == jaudit.audit_records(recs)
    return rep["errors"]


def test_spare_is_not_a_husk():
    """husk_max=0 retires every husk at once: the demoted spare leaves the
    engines nest (a retired husk, folded into husks_retired) yet stays warm
    in the pool; spares never appear in the nest before promotion; a
    failing factory stops the fill loudly."""
    def run(pkg):
        w = ListWriter()
        b, _ = _fleet(pkg, 2, writer=w, engine_kw=dict(husk_max=0))
        built = []

        def factory():
            if len(built) >= 2:
                raise RuntimeError("device pool exhausted")
            built.append(fake_engine(pkg, f"engine{5 + len(built)}"))
            return built[-1]

        with b:
            sc = PKGS[pkg][1].Autoscaler(b, factory, writer=w, warm_pool=3, clock=FakeClock(),
                                         policy=scripted(pkg, ["scale_in"], evidenced=True))
            n_fill = sc.fill_warm_pool()
            before = sorted(b.summary_record()["engines"])
            sc.tick()
            s = b.summary_record()
        el = sc.record()
        return w.recs, (n_fill, before, sorted(s["engines"]), s["husks_retired"]["n"],
                        s["husks_retired"]["dispatches"], el["n_spares"], el["n_demotions"])

    _, extra = _both(run)
    assert extra[0] == 2 and extra[1] == ["engine0", "engine1"]
    assert extra[2] == ["engine0"] and extra[3] == 1 and extra[5:] == (3, 1)


def test_husk_age_bound_retires_on_the_capacity_cadence():
    def run(pkg):
        w = ListWriter()
        clk = FakeClock()
        b, _ = _fleet(pkg, 3, writer=w, engine_kw=dict(husk_max_age_s=5.0), clock=clk)
        b.drain_engine("engine2")
        clk.advance(3.0)
        b.drain_engine("engine1")
        clk.advance(3.0)
        b.capacity_records()
        s = b.summary_record()
        return w.recs, (sorted(s["engines"]), s["husks_retired"])

    _, extra = _both(run)
    assert extra[0] == ["engine0", "engine1"] and extra[1]["n"] == 1


# -- a fleet of real CPU engines ---------------------------------------------


def _real_engine(pkg, model, name, kw):
    jcfg, tcfg, jp, tp = model
    if pkg == "ref":
        return jengine.InferenceEngine(jcfg, jconfig.ServeConfig(**kw), params=jp, name=name)
    return InferenceEngine(tcfg, ServeConfig(**kw, use_pallas=True), params=tp, device="cpu",
                           name=name)


@pytest.mark.parametrize("pool_aliasing", [False, True])
def test_real_fleet_spawn_drain_and_migrate(model, pool_aliasing):
    """Engine 0 serves two sessions' first frames into its page pool; a
    scale-out spawns engine 1 (warmed before admission); a scale-in drains
    engine 0: its sessions' pages migrate to engine 1's pool bit for bit,
    engine 0 is released; the sessions' next frames hit engine 1's pool
    warm, with no levels0 from the host."""
    _, tcfg, _, _ = model
    a, b2 = _images(2, seed=31), _images(2, seed=32)
    rounds = [[(a[0], "s0"), (a[1], "s1")],
              [(a[0] + 0.05 * b2[0], "s0"), (a[1] + 0.05 * b2[1], "s1")]]
    kw = dict(buckets=(1, 2), max_batch=2, page_pool_pages=16, pool_aliasing=pool_aliasing,
              dispatch_retries=0,
              column_cache_bytes=8 * column_state_bytes(tcfg, ServeConfig()), **AUTO)
    runs = {}
    for pkg in ("ref", "port"):
        w = ListWriter()
        eng0 = _real_engine(pkg, model, "engine0", kw)
        bat = PKGS[pkg][0].DynamicBatcher(engines=[eng0], writer=w, max_delay_ms=5000.0,
                                          max_batch=2)
        spawned = []

        def factory():
            spawned.append(_real_engine(pkg, model, "engine1", kw))
            return spawned[-1]

        sc = PKGS[pkg][1].Autoscaler(
            bat, factory, writer=w, clock=FakeClock(),
            policy=scripted(pkg, ["scale_out", "scale_in"], evidenced=True, target="engine0"))
        tickets = [bat.submit(img, session_id=s) for img, s in rounds[0]]
        bat.start()
        res = [t.result(timeout=120) for t in tickets]
        before = {s: eng0.pool.read_block(s) for s in ("s0", "s1")}
        sc.tick()
        sc.tick()
        after = {s: spawned[0].pool.read_block(s) for s in ("s0", "s1")}
        ts2 = [bat.submit(img, session_id=s) for img, s in rounds[1]]
        res += [t.result(timeout=120) for t in ts2]
        bat.stop()
        runs[pkg] = (w.recs, res, tickets + ts2, bat.summary_record(), sc.record(),
                     before, after, eng0, spawned[0])
    jrecs, jres, jt, js, jel, *_ = runs["ref"]
    trecs, tres, tt, ts, tel, before, after, eng0, eng1 = runs["port"]
    assert chain(trecs) == chain(jrecs)
    for (tl, ti, _), (jl, ji, _) in zip(tres, jres):
        assert ti == ji
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                                   rtol=RTOL, atol=ATOL)
    disp = lambda recs: [(r["engine"], r["n_valid"], r["n_page_warm"], r["levels0_h2d_bytes"])
                         for r in recs if r.get("event") == "dispatch"]
    assert disp(trecs) == disp(jrecs) == [("engine0", 2, 0, 0), ("engine1", 2, 2, 0)]
    for k in ("n_served", "n_failed", "n_page_warm", "levels0_h2d_bytes", "n_dispatches"):
        assert ts[k] == js[k], k
    for k in ("n_hits", "n_misses", "n_writes", "n_invalidations"):
        assert ts["column_cache"][k] == js["column_cache"][k], k
    for k in ("n_scale_outs", "n_scale_ins", "n_decisions", "n_migrated_sessions",
              "n_invalidated_sessions", "migrated_bytes", "n_engines", "timeline"):
        assert tel[k] == jel[k], k
    assert tel["n_migrated_sessions"] == 2 and ts["engines"]["engine0"]["drained"] is True
    # Bit for bit: the sibling's pages hold exactly the drained pool's rows.
    for s in ("s0", "s1"):
        assert torch.equal(after[s], before[s]) and content_hash(after[s]) == content_hash(
            before[s])
    assert eng0.released and eng0.pool.buffer() is None
    assert ts["column_cache"]["n_hits"] == 2
    assert taudit_errors(trecs) == []


# -- session migration on the port's pools -----------------------------------


CFG = GlomConfig(dim=16, levels=3, image_size=8, patch_size=2)


def _pools(dst_pages=16, **kw):
    mk = lambda name, pages: PagedColumnPool(  # noqa: E731
        CFG, ServeConfig(page_pool_pages=pages, page_tokens=4, **kw), name=name, device="cpu")
    pools = {"A": mk("A", 16), "B": mk("B", dst_pages)}
    return pools, ColumnCache(budget_bytes=1 << 24, pools=pools)


def _state(seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(CFG.num_patches, CFG.levels, CFG.dim)).astype(np.float32))


@pytest.mark.parametrize("aliasing,pinned_reader", [(False, False), (True, False),
                                                     (True, True)])
def test_migration_bit_for_bit(aliasing, pinned_reader):
    """The destination's pages equal the source's bit for bit with the
    same content hash; an aliasing destination writes in place (the epoch
    advances) unless a dispatch holds a read pin, then copy-on-write (a
    counted fallback); the source's pages are freed."""
    pools, cache = _pools(pool_aliasing=aliasing)
    states = {f"s{i}": _state(i) for i in range(3)}
    for sid, st in states.items():
        assert cache.store(sid, st, engine="A", n_tokens=CFG.num_patches)
    epoch0 = pools["B"].epoch()
    if pinned_reader:
        pools["B"].acquire_read()
    out = cache.migrate_engine_sessions("A", "B", reason="drain")
    assert out == {"n_migrated": 3, "n_invalidated": 0,
                   "bytes_migrated": 3 * states["s0"].nbytes}
    for sid, st in states.items():
        hit = cache.lookup(sid)
        got = pools["B"].read_block(sid)
        assert hit.engine == "B" and torch.equal(got, st)
        assert content_hash(got) == content_hash(st)
    assert pools["A"].pages_used() == 0
    rec = pools["B"].record()
    if aliasing:
        if pinned_reader:
            assert rec["alias"]["n_alias_fallbacks"] == 3 and pools["B"].epoch() == epoch0
        else:
            assert rec["alias"]["n_alias_writes"] == 3 and pools["B"].epoch() == epoch0 + 3


def test_migration_fallbacks_invalidate_with_the_drain_reason():
    """No page budget on the sibling, no destination, a session pinned by an
    in-flight read: each is invalidated with the stamped `drain` reason and
    its source pages freed; host mode re-tags at zero bytes; remove_pool
    invalidates leftovers; add_pool refuses a host-mode cache."""
    pools, cache = _pools(dst_pages=4)
    w = ListWriter()
    cache.writer = w
    assert cache.store("b0", _state(0), engine="B", n_tokens=CFG.num_patches)
    assert cache.store("a0", _state(1), engine="A", n_tokens=CFG.num_patches)
    cache.lookup("b0", pin=True)
    assert cache.migrate_engine_sessions("A", "B") == {
        "n_migrated": 0, "n_invalidated": 1, "bytes_migrated": 0}
    assert cache.lookup("a0") is None and pools["A"].pages_used() == 0
    assert [r["reason"] for r in w.recs if r.get("event") == "cache_invalidate"] == ["drain"]

    pools, cache = _pools()
    assert cache.store("a0", _state(2), engine="A", n_tokens=CFG.num_patches)
    assert cache.store("a1", _state(3), engine="A", n_tokens=CFG.num_patches)
    cache.lookup("a1", pin=True)
    out = cache.migrate_engine_sessions("A", "B")
    assert out["n_migrated"] == 1 and out["n_invalidated"] == 1
    assert cache.lookup("a1") is None
    assert cache.migrate_engine_sessions("B", None)["n_invalidated"] == 1

    pools, cache = _pools()
    assert cache.store("a0", _state(4), engine="A", n_tokens=CFG.num_patches)
    cache.remove_pool("A")
    assert cache.lookup("a0") is None and "A" not in cache.pools
    pools["A"].release()
    assert pools["A"].record()["pages_used"] == 0 and pools["A"].buffer() is None

    host = ColumnCache(budget_bytes=1 << 20)
    host.store("s0", torch.ones((4, 2, 4)), engine="A")
    assert host.migrate_engine_sessions("A", "B") == {
        "n_migrated": 1, "n_invalidated": 0, "bytes_migrated": 0}
    assert host.lookup("s0") is not None
    with pytest.raises(ValueError, match="host-mode"):
        host.add_pool("C", pools["B"])


def test_delta_pool_migration_starts_a_fresh_base():
    """A delta-streamed session migrates as its effective state into a
    fresh base on a delta destination, bit for bit."""
    pools, cache = _pools(delta_streaming=True)
    st = _state(5)
    assert cache.store("s0", st, engine="A", n_tokens=CFG.num_patches)
    st2 = st.clone()
    st2[:4] += 1.0
    assert cache.store("s0", st2, engine="A", n_tokens=CFG.num_patches)
    assert pools["A"].delta_chain_len("s0") == 1
    assert cache.migrate_engine_sessions("A", "B")["n_migrated"] == 1
    assert torch.equal(pools["B"].read_block("s0"), st2)
    assert pools["B"].delta_chain_len("s0") == 0


# -- the audit CLI on a fleet's stream -----------------------------------------


def test_audit_cli_on_the_fleet_stream(tmp_path):
    def run(pkg):
        w = ListWriter()
        b, _ = _fleet(pkg, 1, writer=w)
        with b:
            sc = PKGS[pkg][1].Autoscaler(
                b, lambda: fake_engine(pkg, "engine1"), writer=w, clock=FakeClock(),
                policy=scripted(pkg, ["scale_out", "scale_in"], evidenced=True))
            sc.tick()
            sc.tick()
        return w.recs, None

    recs, _ = _both(run)
    for r in recs:
        assert schema.validate_record(r) == []
    path = tmp_path / "fleet.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    dropped = [dict(r) for r in recs]
    victim = next(r for r in dropped if r.get("event") == "drain_release")
    del victim["decision_id"]
    bad = tmp_path / "dropped.jsonl"
    bad.write_text("".join(json.dumps(r) + "\n" for r in dropped))
    for p, want in ((path, 0), (bad, 1)):
        res = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", "audit", str(p)],
                             cwd=REPO, capture_output=True, text=True, timeout=120)
        assert res.returncode == want == jaudit.main([str(p)]), res.stderr


def test_config_fields_drive_the_policy():
    scfg = ServeConfig(elastic=True, min_engines=2, max_engines=3, warm_pool=1, husk_max=4)
    pol = telastic.resolve_policy(scfg)
    assert (pol.min_engines, pol.max_engines) == (2, 3)
    with pytest.raises(ValueError, match="warm_pool"):
        b, _ = _fleet("port", 1)
        telastic.Autoscaler(b, lambda: None, warm_pool=-1, policy=pol)
    assert dataclasses.replace(scfg, warm_pool=0).warm_pool == 0
