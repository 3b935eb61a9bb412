"""The port's `DynamicBatcher` against glom_tpu's, request for request, on
the CPU.

Each case builds the same engines in both packages (weights transplanted
from glom_tpu's params, inputs from a numpy seed) and drives the two
batchers through the same traffic. Requests are submitted before start()
with max_batch equal to the requests of a round and a long max_delay_ms, so
every gather is the same in both packages. Each ticket's levels are held at
rtol 2e-3 / atol 2e-4 (tests/test_model.py), and its iterations, hops, the
dispatch records' routes and every counter of `summary_record()` exactly.
The auto-route thresholds sit where both packages' exits agree (scale-100
images, as tests/test_torch_port_early_exit.py uses).
"""

import time

import jax
import numpy as np
import pytest
import torch

import glom_tpu.telemetry.watchdog as jwatchdog
from glom_tpu.models import core as jcore
from glom_tpu.resilience import ladder as jladder
from glom_tpu.serve import batcher as jbatcher
from glom_tpu.serve import engine as jengine
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import GlomConfig, InferenceEngine, ServeConfig, params_from_numpy
from glom_tpu_torch.kernels._build import KernelError
from glom_tpu_torch.resilience import ladder as tladder
from glom_tpu_torch.serve import batcher as tbatcher
from glom_tpu_torch.serve.column_cache import column_state_bytes
from glom_tpu_torch.telemetry import watchdog as twatchdog
from test_torch_port_model import ATOL, RTOL, TINY, flatten

SIDE = TINY["image_size"]
AUTO = dict(iters="auto", max_auto_iters=8, min_iters=2, exit_threshold=2e-2)
SUMMARY_KEYS = (
    "n_requests", "n_submitted", "n_served", "n_shed", "n_failed", "n_degraded",
    "n_continued", "n_redispatched", "n_folded", "n_rejoined", "n_affinity",
    "n_page_warm", "n_incremental", "n_dispatches", "pad_fraction_mean",
    "pad_bytes_wasted", "levels0_h2d_bytes", "mean_batch", "iters_histogram",
    "iters_histogram_by_tier", "mean_executed_iters", "engines", "column_cache",
    "page_pools", "ladder_rung", "ladder_degrades", "ladder_restores",
)
DISPATCH_KEYS = (
    "engine", "bucket", "n_valid", "warm_state", "paged", "tier", "pad_fraction",
    "iters_run", "n_stragglers", "n_cache_warm", "n_cache_miss", "n_page_warm",
    "levels0_h2d_bytes", "pad_tokens", "pad_bytes", "rung", "iters_override",
    "incremental", "n_incremental", "n_pages", "n_tokens",
)


class ListWriter:
    def __init__(self):
        self.recs = []

    def write(self, rec):
        self.recs.append(rec)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfig.GlomConfig(**TINY)
    jp = jcore.init_glom(jax.random.PRNGKey(0), jcfg)
    return jcfg, GlomConfig(**TINY), jp, params_from_numpy(flatten(jp), device="cpu")


def _images(n, seed, scale=100.0, side=SIDE):
    imgs = (scale * np.random.default_rng(seed).standard_normal((n, 3, side, side)))
    imgs = imgs.astype(np.float32)
    imgs[1::3] *= 0.01  # easier rows: the rows converge at different counts
    return imgs


def _engines(model, n=1, hooks=(), **kw):
    """(glom_tpu's engines, the port's) on the same weights and config."""
    jcfg, tcfg, jp, tp = model
    kw = dict(dispatch_retries=0, **kw)
    hooks = dict(hooks)
    ref = [jengine.InferenceEngine(jcfg, jconfig.ServeConfig(**kw), params=jp,
                                   name=f"engine{i}", fault_hook=hooks.get((0, i)))
           for i in range(n)]
    port = [InferenceEngine(tcfg, ServeConfig(**kw, use_pallas=True), params=tp,
                            device="cpu", name=f"engine{i}", fault_hook=hooks.get((1, i)))
            for i in range(n)]
    return ref, port


def _serve(mod, engines, rounds, **bkw):
    """Run `rounds` (lists of (image, session)) through a batcher: the first
    round is queued before start(), each later one after the previous
    resolved. Returns (batcher, tickets, results, records)."""
    w = ListWriter()
    b = mod.DynamicBatcher(engines=engines, writer=w, max_delay_ms=5000.0,
                           max_batch=len(rounds[0]), **bkw)
    tickets, results = [], []
    for k, reqs in enumerate(rounds):
        ts = [b.submit(img, session_id=s) for img, s in reqs]
        if k == 0:
            b.start()
        results += [t.result(timeout=120) for t in ts]
        tickets += ts
    b.stop()
    return b, tickets, results, w.recs


def _project(rec, keys):
    return {k: rec[k] for k in keys if k in rec}


def _held(ref_run, port_run):
    """Every ticket, dispatch record and summary counter of the two runs."""
    jb, jt, jres, jrecs = ref_run
    tb, tt, tres, trecs = port_run
    assert len(tres) == len(jres)
    for (tl, ti, _), (jl, ji, _), t, j in zip(tres, jres, tt, jt):
        assert ti == ji and t.hops == j.hops
        assert isinstance(tl, torch.Tensor) and tl.device.type == "cpu"
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                                   rtol=RTOL, atol=ATOL)
    jd = [_project(r, DISPATCH_KEYS) for r in jrecs if r.get("event") == "dispatch"]
    td = [_project(r, DISPATCH_KEYS) for r in trecs if r.get("event") == "dispatch"]
    assert td == jd
    js, ts = jb.summary_record(), tb.summary_record()
    assert _project(ts, SUMMARY_KEYS) == _project(js, SUMMARY_KEYS)
    assert ts["n_served"] + ts["n_shed"] + ts["n_failed"] == ts["n_requests"]
    return js, ts


def test_fixed_route(model):
    """Three requests pad to bucket 4 on the fixed route, then one alone."""
    imgs = _images(4, seed=1)
    rounds = [[(img, None) for img in imgs[:3]]]
    ref, port = _engines(model, buckets=(1, 2, 4), max_batch=4, iters=3)
    js, ts = _held(_serve(jbatcher, ref, rounds), _serve(tbatcher, port, rounds))
    assert ts["n_dispatches"] == 1 and ts["iters_histogram"] == {"3": 3}
    assert ts["pad_fraction_mean"] == 0.25


def test_auto_route_with_continuations(model):
    """Six requests at max_batch 4: the first bucket exits at its quorum, its
    stragglers re-bucket warm with their remaining budget and fold the two
    queued fresh requests into their bucket's pad slots; each request
    resolves once, with the sum of its hops' iterations."""
    imgs = _images(6, seed=5)
    rounds = [[(img, None) for img in imgs[:4]]]
    ref, port = _engines(model, buckets=(1, 2, 4), max_batch=4, exit_quorum=0.5,
                         max_continuations=2, **AUTO)
    jrun, trun = [], []
    for mod, engs, out in ((jbatcher, ref, jrun), (tbatcher, port, trun)):
        w = ListWriter()
        b = mod.DynamicBatcher(engines=engs, writer=w, max_delay_ms=5000.0, max_batch=4)
        ts = [b.submit(img) for img in imgs]
        b.start()
        res = [t.result(timeout=120) for t in ts]
        b.stop()
        out += [b, ts, res, w.recs]
    js, ts = _held(jrun, trun)
    assert ts["n_continued"] > 0 and ts["n_folded"] > 0
    assert max(int(k) for k in ts["iters_histogram"]) <= 8
    hops = [t.hops for t in trun[1]]
    assert max(hops) >= 1 and ts["iters_histogram_by_tier"].keys() > {"0"}
    # Ticket conservation: resolved exactly once, within the budget.
    assert all(t.done() for t in trun[1]) and ts["n_served"] == 6


def test_mixed_warm_and_cold_buckets(model):
    """Host-mode column cache: a second round mixes a session hit (warm from
    the cached columns), a stateless row and a session miss in one bucket
    through the per-row levels0 select, with the cache's counters equal."""
    _, tcfg, _, _ = model
    a, b = _images(3, seed=7), _images(3, seed=8)
    rounds = [[(a[0], "s0"), (a[1], "s1"), (a[2], None)],
              [(a[0] + 0.05 * b[0], "s0"), (b[1], None), (b[2], "s2")]]
    budget = 4 * column_state_bytes(tcfg, ServeConfig())
    ref, port = _engines(model, buckets=(1, 2, 4), max_batch=4,
                         column_cache_bytes=budget, **AUTO)
    js, ts = _held(_serve(jbatcher, ref, rounds), _serve(tbatcher, port, rounds))
    cache = ts["column_cache"]
    assert cache["n_hits"] == 1 and cache["n_misses"] == 3 and cache["n_writes"] == 4
    assert ts["levels0_h2d_bytes"] > 0  # the warm bucket carried its levels0


def test_shed_errors_and_their_details(model, monkeypatch):
    """QueueFullError, BackendDownError and LadderShedError: the same types,
    messages' reasons and details (all but the minted trace id)."""

    class Down:
        def record(self):
            return {"backend_state": "down", "backend_devices": 0, "backend_transitions": 1}

    img = _images(1, seed=2)[0]
    got = {}
    for key, mod, wd_mod, lad_mod, engs in (
        ("ref", jbatcher, jwatchdog, jladder, _engines(model, buckets=(1, 2), max_batch=2)[0]),
        ("port", tbatcher, twatchdog, tladder, _engines(model, buckets=(1, 2), max_batch=2)[1]),
    ):
        out = got[key] = []
        b = mod.DynamicBatcher(engines=engs, queue_depth=2, max_batch=2)
        b.submit(img), b.submit(img)
        with pytest.raises(mod.QueueFullError) as e:
            b.submit(img)
        out.append((type(e.value).__name__, {k: v for k, v in e.value.detail.items()
                                             if k != "trace_id"}))
        b.stop(drain=False)
        monkeypatch.setattr(wd_mod, "_GLOBAL", Down())
        b = mod.DynamicBatcher(engines=engs, max_batch=2)
        with pytest.raises(mod.BackendDownError) as e:
            b.submit(img)
        out.append((type(e.value).__name__, {k: v for k, v in e.value.detail.items()
                                             if k != "trace_id"}))
        monkeypatch.setattr(wd_mod, "_GLOBAL", None)
        ladder = lad_mod.DegradationLadder(degraded_iters=2, bucket_cap=1, min_dwell_s=0.0,
                                           clock=lambda: 0.0)
        for _ in range(3):
            ladder.observe(queue_fill=1.0)
        b = mod.DynamicBatcher(engines=engs[:1], max_batch=2, ladder=ladder)
        with pytest.raises(mod.LadderShedError) as e:
            b.submit(img)
        out.append((type(e.value).__name__, {k: v for k, v in e.value.detail.items()
                                             if k != "trace_id"}))
        s = b.summary_record()
        out.append((s["n_shed"], s["n_requests"], s["ladder_rung"]))
    assert got["port"] == got["ref"]
    assert [name for name, _ in got["port"][:3]] == [
        "QueueFullError", "BackendDownError", "LadderShedError"]
    assert got["port"][0][1]["queue_depth"] == 2 and got["port"][2][1]["rung"] == "shed"


def test_ladder_rung_moves(model):
    """The same observations move both ladders through the same rungs,
    timelines and counts; a batch dispatched at capped_iters runs the
    degraded budget in both batchers."""
    seq = [(0.9, "up"), (0.9, "up"), (0.1, "up"), (0.5, "flapping"), (0.9, "flapping"),
           (0.95, "up"), (0.95, "up"), (0.0, "up"), (0.0, "up"), (0.0, "up")]
    timelines, rungs = [], []
    for mod in (jladder, tladder):
        t = [0.0]
        lad = mod.DegradationLadder(degraded_iters=3, bucket_cap=2, min_dwell_s=0.25,
                                    clock=lambda: t[0])
        seen = []
        for fill, state in seq:
            t[0] += 0.3
            seen.append(lad.observe(queue_fill=fill, backend_state=state))
        rungs.append((seen, lad.record()))
        timelines.append([{k: v for k, v in r.items()
                           if k not in ("backend_state", "wall_time")} for r in lad.timeline()])
    assert rungs[1] == rungs[0] and timelines[1] == timelines[0]
    assert tladder.class_rungs(0, 3) == jladder.class_rungs(0, 3)

    imgs = _images(2, seed=3)
    rounds = [[(img, None) for img in imgs]]
    ref, port = _engines(model, buckets=(1, 2), max_batch=2, **AUTO)
    runs = []
    for mod, lad_mod, engs in ((jbatcher, jladder, ref), (tbatcher, tladder, port)):
        lad = lad_mod.DegradationLadder(degraded_iters=3, bucket_cap=2, min_dwell_s=0.25,
                                        clock=lambda: 0.0)
        lad.observe(queue_fill=1.0)  # capped_iters; the frozen clock holds it
        runs.append(_serve(mod, engs, rounds, ladder=lad))
    js, ts = _held(*runs)
    assert ts["n_degraded"] == 2 and ts["iters_histogram"] == {"3": 2}
    assert ts["ladder_rung"] == "capped_iters"


class Gated:
    """An engine whose dispatches wait until `ready()` holds: it keeps one
    worker busy so the failing sibling takes the next requests, which makes
    the failover sequence the same in both packages."""

    def __init__(self, engine, ready):
        self._engine, self._ready = engine, ready

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def infer(self, *args, **kw):
        t0 = time.monotonic()
        while not self._ready() and time.monotonic() - t0 < 60:
            time.sleep(0.002)
        return self._engine.infer(*args, **kw)


class Failing:
    """A fault hook raising on dispatch calls [0, stop)."""

    def __init__(self, stop):
        self.calls, self.stop = 0, stop

    def __call__(self, ctx):
        self.calls += 1
        if self.calls <= self.stop:
            raise RuntimeError(f"injected engine fault, call {self.calls}")


@pytest.mark.parametrize("rejoin", [False, True])
def test_failover_and_rejoin(model, rejoin):
    """Engine 1 fails its first two dispatches (dead at two consecutive
    failures), its requests fail over to engine 0; with rejoin_threshold 2
    its hook's window closes and two probation dispatches re-admit it. The
    events come in order: engine_failover, engine_dead, engine_probation,
    engine_rejoin; every request resolves once."""
    imgs = _images(2, seed=9)
    hooks = {(0, 1): Failing(2), (1, 1): Failing(2)}
    ref, port = _engines(model, n=2, hooks=hooks, buckets=(1,), max_batch=1, iters=2)
    runs = []
    for mod, engs in ((jbatcher, ref), (tbatcher, port)):
        w = ListWriter()
        box = {}
        if rejoin:
            # Engine 0 holds its first request until the other resolved on
            # the revived engine 1.
            ready = lambda: any(t.done() for t in box.get("tickets", ()))  # noqa: E731
        else:
            ready = lambda: not box["b"]._engine_state["engine1"]["alive"]  # noqa: E731
        gated = [Gated(engs[0], ready), engs[1]]
        b = box["b"] = mod.DynamicBatcher(
            engines=gated, writer=w, max_batch=1, max_delay_ms=0.0,
            rejoin_threshold=2 if rejoin else 0, rejoin_interval_ms=5.0,
        )
        ts = box["tickets"] = [b.submit(img) for img in imgs]
        b.start()
        res = [t.result(timeout=120) for t in ts]
        if rejoin:
            t0 = time.monotonic()
            while b.summary_record()["n_rejoined"] < 1 and time.monotonic() - t0 < 30:
                time.sleep(0.01)
        b.stop()
        runs.append((b, ts, res, w.recs))
    js, ts = _held(*runs)
    events = [r["event"] for r in runs[1][3] if r.get("event", "").startswith("engine_")]
    want = ["engine_failover", "engine_failover", "engine_dead"]
    if rejoin:
        want += ["engine_probation", "engine_rejoin"]
    assert events == want
    assert ts["n_redispatched"] == 2 and ts["engines"]["engine1"]["alive"] is rejoin


def test_kernel_error_reaches_the_tickets(model):
    """A KernelError fails its batch's tickets with itself: no failover to
    the sibling, no requeue, no retry."""
    _, port = _engines(model, n=2, buckets=(1, 2), max_batch=2, iters=2)

    def broken(ctx):
        raise KernelError("grouped_mlp_fwd: launch failed")

    for eng in port:
        eng._fault_hook = broken
    b = tbatcher.DynamicBatcher(engines=port, max_batch=2, max_delay_ms=5000.0)
    ts = [b.submit(img) for img in _images(2, seed=4)]
    b.start()
    for t in ts:
        with pytest.raises(KernelError, match="launch failed"):
            t.result(timeout=60)
    b.stop()
    s = b.summary_record()
    assert s["n_failed"] == 2 and s["n_redispatched"] == 0 and s["n_served"] == 0


def test_ragged_admission(model):
    """Mixed resolutions (16, 12, 8 and 4 px) pack page-aligned into one
    ragged dispatch in both batchers; each ticket is its row's columns."""
    rng = np.random.default_rng(13)
    sides = (16, 12, 8, 4)
    rounds = [[((100.0 * rng.standard_normal((3, s, s))).astype(np.float32), None)
               for s in sides]]
    ref, port = _engines(model, buckets=(1, 2, 4), max_batch=4, page_tokens=4, ragged=True,
                         ragged_attention="banded", iters=3)
    trun = _serve(tbatcher, port, rounds)
    js, ts = _held(_serve(jbatcher, ref, rounds), trun)
    assert [tuple(r[0].shape) for r in trun[2]] == [((s // 4) ** 2, 3, 32) for s in sides]
    assert ts["n_dispatches"] == 1


@pytest.mark.parametrize("route", ["paged", "incremental"])
def test_paged_and_incremental_warm_routes(model, route):
    """Pages mode: a session's converged columns write back into the
    engine's pool and its next frame dispatches warm from the pages (no
    levels0 from the host); in delta mode the next frames ride the
    incremental route, a held frame starting converged."""
    _, tcfg, _, _ = model
    a = _images(2, seed=21)
    frames = [[(a[0], "s0"), (a[1], "s1")],
              [(a[0] + 0.05 * a[1], "s0"), (a[1], "s1")],
              [(a[0] + 0.05 * a[1], "s0"), (a[1] + 0.05 * a[0], "s1")]]
    kw = dict(buckets=(1, 2), max_batch=2, page_pool_pages=16,
              column_cache_bytes=8 * column_state_bytes(tcfg, ServeConfig()), **AUTO)
    if route == "incremental":
        kw.update(delta_streaming=True)
    ref, port = _engines(model, **kw)
    js, ts = _held(_serve(jbatcher, ref, frames), _serve(tbatcher, port, frames))
    assert ts["n_page_warm"] == 4 and ts["levels0_h2d_bytes"] == 0
    assert ts["column_cache"]["n_hits"] == 4
    if route == "incremental":
        assert ts["n_incremental"] == 4


def test_elastic_fleet_methods_refuse(model):
    """The fleet methods of the elastic slice raise, naming their item."""
    _, port = _engines(model, buckets=(1,), max_batch=1)
    b = tbatcher.DynamicBatcher(engines=port, max_batch=1)
    for call in (lambda: b.attach_elastic(None), lambda: b.add_engine(port[0]),
                 lambda: b.begin_drain("engine0"), lambda: b.drain_engine("engine0")):
        with pytest.raises(NotImplementedError, match="item 7"):
            call()
