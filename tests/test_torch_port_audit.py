"""The port's decision audit and pod aggregation (`glom_tpu_torch/telemetry/
audit.py`, `aggregate.py`) against glom_tpu's, on the CPU.

Both are pure Python, so the same inputs must give equal outputs:

  * the pure policy function (`policy_action`, `anticipated_deficit`,
    `binding_breaches`, `rule_class`) over seeded grids of evidence
    bundles;
  * `audit_records` over clean decision chains and over every way of
    breaking one, verdict for verdict;
  * `SLOMonitor` over the same seeded record streams under the same fake
    clock: `observed()` equal, and the stamped breach records equal apart
    from the wall clock and the backend state (each package stamps its
    own: glom_tpu's watchdog seam, the port's CUDA liveness);
  * `rollup`, `merge_timeline`, `parse_slo` and the barrier-chain check;
  * the CLIs: `python -m glom_tpu_torch.telemetry audit | aggregate |
    watch` exit with glom_tpu's codes on the same files.
"""

import json
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest

from glom_tpu.telemetry import aggregate as jagg
from glom_tpu.telemetry import audit as jaudit
from glom_tpu_torch.telemetry import aggregate as tagg
from glom_tpu_torch.telemetry import audit as taudit
from glom_tpu_torch.telemetry import schema

REPO = Path(__file__).resolve().parent.parent


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


def _bundle(rng):
    """One evidence bundle with every field drawn, matured or not."""
    n_engines = int(rng.integers(1, 5))
    forecast = None
    if rng.random() < 0.7:
        forecast = {
            "predicted": None if rng.random() < 0.2 else float(rng.uniform(0, 60)),
            "forecast_abs_err": None if rng.random() < 0.2 else float(rng.uniform(0, 5)),
            "horizon_s": float(rng.choice([0.5, 1.0, 2.0])),
            "trend_per_s": float(rng.normal(scale=5.0)),
            "t": 1.0,
        }
    ev = {
        "n_engines": n_engines,
        "min_engines": int(rng.integers(1, 3)),
        "max_engines": int(rng.integers(2, 5)),
        "breaches": sorted(set(rng.choice(
            ["p99_ms", "shed_rate", "p99_ms[batch]", "p99_ms[premium]", "p99_ms[]"],
            size=int(rng.integers(0, 3))).tolist())),
        "headroom": float(rng.random()),
        "low_water": 0.2,
        "high_water": 0.7,
        "dwell_s": float(rng.choice([0.0, 1.0])),
        "below_held_s": None if rng.random() < 0.5 else float(rng.uniform(0, 2)),
        "above_held_s": None if rng.random() < 0.5 else float(rng.uniform(0, 2)),
        "anticipatory": bool(rng.random() < 0.6),
        "target_utilization": float(rng.choice([0.5, 0.8, 1.0])),
        "forecast": forecast,
        "lead_time_ms": None if rng.random() < 0.3 else float(rng.uniform(100, 3000)),
        "lead_quantile": 0.9,
        "fleet_service_rate_rps": None if rng.random() < 0.2 else float(rng.uniform(-1, 40)),
    }
    if rng.random() < 0.3:
        ev["low_classes"] = ["batch"]
        ev["class_weights"] = {"batch": 1.0, "premium": 8.0}
    return ev


@pytest.mark.parametrize("seed", range(6))
def test_policy_function_equals_reference(seed):
    rng = np.random.default_rng(seed)
    seen = set()
    for _ in range(300):
        ev = _bundle(rng)
        assert taudit.policy_action(ev) == jaudit.policy_action(ev)
        assert taudit.anticipated_deficit(ev) == jaudit.anticipated_deficit(ev)
        assert taudit.binding_breaches(ev) == jaudit.binding_breaches(ev)
        seen.add(taudit.policy_action(ev))
        for rule in ev["breaches"]:
            assert taudit.rule_class(rule) == jaudit.rule_class(rule)
    assert seen == {"scale_out", "scale_in", None}


def _decision(did, action, evidence, *, prev=None, fleet="fleet0", t=0.0):
    return {"kind": "decision", "schema_version": 10, "t": t, "fleet": fleet,
            "decision_id": did, "prev_decision_id": prev, "action": action,
            "evidence": evidence}


def _serve(event, did, *, fleet="fleet0", t=0.0, **kw):
    rec = {"kind": "serve", "event": event, "fleet": fleet, "t": t}
    if did is not None:
        rec["decision_id"] = did
    rec.update(kw)
    return rec


def _chain(fleet="fleet0"):
    """A clean scale-out by spawn, a scale-in with demotion, a scale-out by
    promotion, with failures inside the cover windows."""
    base = dict(n_engines=1, min_engines=1, max_engines=4, breaches=[], headroom=0.5,
                low_water=0.2, high_water=0.7, dwell_s=1.0, below_held_s=None,
                above_held_s=None, anticipatory=False, target_utilization=0.8,
                forecast=None, lead_time_ms=None, lead_quantile=None,
                fleet_service_rate_rps=None)
    out_ev = dict(base, breaches=["p99_ms"], lead_time_ms=100.0)
    in_ev = dict(base, n_engines=2, above_held_s=5.0)
    out2 = dict(base, below_held_s=3.0, class_weights={"premium": 8.0},
                low_classes=["batch"])
    return [
        _decision(1, "scale_out", out_ev, t=1.0, fleet=fleet),
        _serve("scale_out_decision", 1, t=1.0, fleet=fleet),
        _serve("shed", None, t=1.05, fleet=fleet, slo_class="premium"),
        _serve("scale_out", 1, t=1.2, spawn_ms=150.0, fleet=fleet),
        _serve("admission_open", 1, t=1.2, fleet=fleet),
        _decision(2, "scale_in", in_ev, prev=1, t=5.0, fleet=fleet),
        _serve("scale_in_decision", 2, t=5.0, fleet=fleet),
        _serve("drain_begin", 2, t=5.0, fleet=fleet),
        _serve("drain_flush", 2, t=5.1, fleet=fleet),
        _serve("drain_migrate", 2, t=5.2, fleet=fleet),
        _serve("drain_release", 2, t=5.3, fleet=fleet),
        _serve("spare_demote", 2, t=5.3, fleet=fleet),
        _decision(3, "scale_out", out2, prev=2, t=8.0, fleet=fleet),
        {"kind": "slo_breach", "rule": "p99_ms[premium]", "t": 8.2, "slo_class": "premium"},
        _serve("settle", None, t=8.3, outcome="failed", fleet=fleet),
        _serve("spare_promote", 3, t=8.01, promote_ms=1.5, fleet=fleet),
        _serve("admission_open", 3, t=8.01, fleet=fleet),
    ]


def _broken_chains():
    """Each way a stream can break, one at a time."""
    out = {"clean": _chain(), "two_fleets": _chain() + _chain("fleet1")}
    c = _chain()
    c[0]["evidence"]["breaches"] = []
    out["corrupted_evidence"] = c
    c = _chain()
    c[5]["decision_id"] = 4
    out["chain_gap"] = c
    c = _chain()
    c[5]["prev_decision_id"] = None
    out["bad_prev"] = c
    c = _chain()
    del c[3]["decision_id"]
    out["unchained_actuation"] = c
    out["orphan_decision"] = _chain() + [_decision(4, "scale_in", _chain()[5]["evidence"],
                                                   prev=3, t=9.0)]
    c = _chain()
    c[10]["decision_id"] = 1
    out["wrong_family"] = c
    out["duplicate_id"] = _chain() + [_chain()[0]]
    c = _chain()
    c[3]["decision_id"] = 9
    out["unknown_decision"] = c
    c = _chain()
    c[0]["evidence"] = None
    out["no_evidence"] = c
    c = _chain()
    c[0]["decision_id"] = "1"
    out["non_int_id"] = c
    return out


@pytest.mark.parametrize("name", sorted(_broken_chains()))
def test_audit_records_equal_reference(name):
    recs = _broken_chains()[name]
    for cover in (0.25, 1.0):
        want = jaudit.audit_records(recs, default_cover_s=cover)
        got = taudit.audit_records(recs, default_cover_s=cover)
        assert got == want
    if name in ("clean", "two_fleets"):
        assert got["errors"] == [] and got["regret_total"] > 0


def _write(path, recs):
    with open(path, "w") as fh:
        for r in recs:
            fh.write(json.dumps(r) + "\n")
    return str(path)


@pytest.mark.parametrize("name,flags", [
    ("clean", []), ("clean", ["--strict"]), ("orphan_decision", []),
    ("orphan_decision", ["--strict"]), ("corrupted_evidence", []),
    ("clean", ["--baseline", "BASE"]),
])
def test_audit_cli_exit_codes_equal(name, flags, tmp_path, capsys):
    path = _write(tmp_path / "a.jsonl", _broken_chains()[name])
    base = _write(tmp_path / "b.jsonl", _broken_chains()["corrupted_evidence"])
    argv = [path] + [base if f == "BASE" else f for f in flags]
    want = jaudit.main(argv)
    jout = capsys.readouterr().out
    res = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", "audit", *argv],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == want
    assert [json.loads(x) for x in res.stdout.splitlines()] == [
        json.loads(x) for x in jout.splitlines()]


def _stream(seed, n=300):
    """(dt, record): resolves and responses sharing trace ids, sheds,
    classed settles, capacity records in every state, forecasts with and
    without a matured error, and unrelated records."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        u = rng.random()
        cls = str(rng.choice(["premium", "batch"])) if rng.random() < 0.5 else None
        tid = f"t{int(rng.integers(0, n))}"
        if u < 0.35:
            rec = {"kind": "serve", "event": "resolve", "latency_ms": float(rng.gamma(2, 20)),
                   "iters_total": int(rng.integers(1, 13)), "trace_id": tid, "request_id": i}
        elif u < 0.5:
            rec = {"kind": "serve", "event": "response", "ok": bool(rng.random() < 0.9),
                   "latency_ms": float(rng.gamma(2, 20)), "trace_id": tid}
        elif u < 0.6:
            rec = {"kind": "serve", "event": "shed", "request_id": i}
        elif u < 0.72:
            rec = {"kind": "serve", "event": "settle", "request_id": int(rng.integers(0, i + 1)),
                   "outcome": str(rng.choice(["served", "failed"])),
                   "latency_ms": float(rng.gamma(2, 20))}
        elif u < 0.87:
            rec = {"kind": "capacity", "engine": f"engine{int(rng.integers(0, 3))}",
                   "headroom": float(rng.random()),
                   "state": str(rng.choice(["ok", "draining", "probation", "dead"]))}
        elif u < 0.95:
            rec = {"kind": "forecast", "forecast_abs_err": (
                None if rng.random() < 0.3 else float(rng.uniform(0, 4)))}
        else:
            rec = {"kind": "train_step", "step": i}
        if cls is not None and rec["kind"] == "serve":
            rec["slo_class"] = cls
        out.append((float(rng.choice([0.0, 0.05, 0.3, 1.0])), rec))
    return out


RULES = {"p50_ms": 30.0, "p95_ms": 60.0, "p99_ms": 80.0, "mean_ms": 40.0, "shed_rate": 0.05,
         "failure_rate": 0.05, "mean_iters": 6.0, "headroom": 0.3, "forecast_abs_err": 1.0,
         "p99_ms[premium]": 70.0, "shed_rate[batch]": 0.1, "failure_rate[premium]": 0.2,
         "mean_iters[batch]": 5.0, "mean_ms[premium]": 30.0}
VOLATILE = ("wall_time_s", "backend_state", "backend_devices", "backend_transitions")


@pytest.mark.parametrize("window_s,min_samples", [(None, 1), (5.0, 1), (2.0, 4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_slo_monitor_equals_reference(window_s, min_samples, seed):
    jclk, tclk = FakeClock(), FakeClock()
    jw, tw = [], []

    class W:
        def __init__(self, out):
            self.write = out.append

    j = jagg.SLOMonitor(RULES, window_s=window_s, min_samples=min_samples,
                        writer=W(jw), clock=jclk)
    t = tagg.SLOMonitor(RULES, window_s=window_s, min_samples=min_samples,
                        writer=W(tw), clock=tclk)
    for k, (dt, rec) in enumerate(_stream(seed)):
        jclk.advance(dt)
        tclk.advance(dt)
        j.observe(dict(rec))
        t.observe(dict(rec))
        if k % 10 == 0:
            assert t.observed() == j.observed()
            got, want = t.evaluate(), j.evaluate()
            strip = lambda rs: [{k: v for k, v in r.items() if k not in VOLATILE} for r in rs]
            assert strip(got) == strip(want)
    assert t.n_breaches == j.n_breaches > 0
    assert len(tw) == len(jw)
    for r in tw:
        assert schema.validate_record(r) == []


@pytest.mark.parametrize("spec", ["p99_ms=50", "p99_ms[premium]=40", "headroom=0.2",
                                  "p99=5", "p99_ms", "headroom[premium]=0.2",
                                  "p99_ms[premium=4", "p99_ms=abc", "shed_rate[ ]=0.1"])
def test_parse_slo_equals_reference(spec):
    try:
        want = jagg.parse_slo(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tagg.parse_slo(spec)
        assert str(got.value) == str(e)
    else:
        assert tagg.parse_slo(spec) == want
    assert set(tagg.SLO_RULES) == set(jagg.SLO_RULES)
    assert tagg.CLASS_SCOPED_RULES == jagg.CLASS_SCOPED_RULES
    assert (tagg.CLOCK_KEYS, tagg.EPOCH_CUTOFF_S) == (jagg.CLOCK_KEYS, jagg.EPOCH_CUTOFF_S)


def _hosts(seed):
    """Two hosts' streams: dispatches, resolves, responses, sheds, failover
    and ladder events, capacity and decision records, barrier rounds
    (one committed round broken on host 1), summaries with cache and class
    counters, under anchored, epoch and clockless records."""
    rng = np.random.default_rng(seed)
    out = OrderedDict()
    for h in range(2):
        recs = []
        t0 = 1.7e9 + 100 * h
        for i in range(60):
            rel = 0.1 * i
            u = rng.random()
            if u < 0.3:
                r = {"kind": "serve", "event": "dispatch", "engine": f"engine{i % 2}",
                     "bucket": int(rng.choice([1, 4, 8])), "n_valid": 3,
                     "latency_ms": float(rng.gamma(2, 5)), "wall_time": rel}
            elif u < 0.5:
                r = {"kind": "serve", "event": "resolve", "latency_ms": float(rng.gamma(2, 9)),
                     "iters_total": int(rng.integers(1, 13)), "wall_time": rel,
                     "slo_class": "premium"}
            elif u < 0.6:
                r = {"kind": "serve", "event": "response", "ok": bool(rng.random() < 0.8),
                     "latency_ms": 3.0}
            elif u < 0.65:
                r = {"kind": "serve", "event": "shed", "wall_time": rel}
            elif u < 0.7:
                r = {"kind": "serve", "event": str(rng.choice(
                    ["engine_failover", "engine_dead", "engine_rejoin", "ladder"])),
                    "engine": "engine1", "rung": 1, "direction": "down"}
            elif u < 0.78:
                r = {"kind": "capacity", "engine": f"engine{i % 2}",
                     "headroom": float(rng.random()), "wall_time": rel, "wall_time_s": t0 + rel}
            elif u < 0.84:
                r = {"kind": "decision", "fleet": "fleet0",
                     "action": str(rng.choice(["scale_out", "scale_in"])),
                     "evidence": {"breaches": ["p99_ms"] if rng.random() < 0.5 else []}}
            elif u < 0.9:
                r = {"kind": "train_step", "step": i, "wall_time": rel}
            else:
                r = {"kind": "note", "text": "clockless"}
            recs.append(r)
        for phase in ("propose", "commit", "saved", "complete"):
            if not (h == 1 and phase == "complete"):
                recs.append({"kind": "barrier", "round": "r1", "phase": phase, "step": 3,
                             "wall_time_s": t0 + 7.0})
        recs.append({"kind": "serve", "event": "summary",
                     "column_cache": {"n_hits": 3 + h, "n_misses": 1, "n_writes": 4,
                                      "n_evictions": 0},
                     "classes": {"premium": {"n_requests": 5, "n_served": 4, "n_shed": 1,
                                             "n_failed": 0, "n_degraded": 0}}})
        out[f"metrics_h{h}"] = recs
    out["relonly"] = [{"kind": "serve", "event": "dispatch", "engine": "e9", "bucket": 1,
                       "latency_ms": 1.0, "wall_time": 0.5}]
    return out


def _without_capacity(hosts):
    return OrderedDict(
        (h, [r for r in recs if r.get("kind") != "capacity"]) for h, recs in hosts.items())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rollup_and_timeline_equal_reference(seed):
    hosts = _hosts(seed)
    assert tagg.rollup(_without_capacity(hosts)) == jagg.rollup(_without_capacity(hosts))
    assert tagg.merge_timeline(hosts) == jagg.merge_timeline(hosts)
    roll = tagg.rollup(hosts)
    assert tagg.check_barrier_chains(roll["timelines"]["barrier"]) == \
        jagg.check_barrier_chains(roll["timelines"]["barrier"]) != []
    for q in (0.0, 0.5, 0.99, 1.0):
        vals = [float(v) for v in np.random.default_rng(seed).normal(size=37)]
        assert tagg.percentile(vals, q) == jagg.percentile(vals, q)


def test_rollup_reads_capacity_records():
    """A capacity record followed by another record of its host: glom_tpu's
    rollup raises (the headroom rebinds its per-host dict's name); the
    port's rolls the headroom up per engine, last and min, and counts every
    other record as the reference does on the stream without them."""
    hosts = _hosts(0)
    with pytest.raises(TypeError):
        jagg.rollup(hosts)
    got, want = tagg.rollup(hosts), jagg.rollup(_without_capacity(hosts))
    caps = [r for r in hosts["metrics_h0"] + hosts["metrics_h1"] if r["kind"] == "capacity"]
    assert caps
    for name in {r["engine"] for r in caps}:
        vals = [r["headroom"] for r in caps if r["engine"] == name]
        assert got["per_engine"][name]["headroom_last"] == vals[-1]
        assert got["per_engine"][name]["headroom_min"] == min(vals)
        for k in ("headroom_last", "headroom_min"):
            got["per_engine"][name].pop(k)
    for h in got["per_host"]:
        got["per_host"][h]["n_records"] -= sum(r["kind"] == "capacity" for r in hosts[h])
    got["n_records"] -= len(caps)
    assert got == want


@pytest.mark.parametrize("argv", [
    ["aggregate", "DIR"], ["aggregate", "DIR", "--strict"], ["aggregate", "NONE"],
    ["watch", "DIR", "--slo", "p99_ms=5", "--once"],
    ["watch", "DIR", "--slo", "p99_ms=5000", "--once"],
    ["watch", "DIR", "--slo", "nope=1", "--once"],
    ["watch", "EMPTY", "--slo", "p99_ms=5", "--once"],
])
def test_aggregate_and_watch_cli_exit_codes_equal(argv, tmp_path, capsys):
    d = tmp_path / "pod"
    d.mkdir()
    (tmp_path / "empty").mkdir()
    for host, recs in _without_capacity(_hosts(0)).items():
        _write(d / f"{host}.jsonl", recs)
    sub = {"DIR": str(d), "NONE": str(tmp_path / "none"), "EMPTY": str(tmp_path / "empty")}
    argv = [sub.get(a, a) for a in argv]
    main = {"aggregate": jagg.aggregate_main, "watch": jagg.watch_main}[argv[0]]
    want = main(argv[1:])
    capsys.readouterr()
    res = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", *argv],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == want, res.stderr[-2000:]
