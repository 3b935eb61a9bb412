"""The port's `Glom(iters="auto")`, `RetryPolicy` and the engine's retry,
fault hook, writer, stats and release against glom_tpu's, on the CPU.

`Glom(iters="auto")` is held to glom_tpu's `Glom` at a threshold chosen
with a margin: both packages' per-iteration agreement deltas are measured
first, and every one must sit at least 10x their largest disagreement
away from it; then `last_auto_iters` must be equal and the output within
rtol 2e-3 / atol 2e-4 (tests/test_torch_port_model.py). Retry schedules,
recovery events (all fields but the backend state, which each package
reads from its own runtime) and counters must be equal. A `KernelError`
inside an attempt raises on the first attempt, with no recovery event, and
each of `kernels/_build.py`'s three failure sites (no nvcc, nvcc failed, a
nonzero CUDA error at launch) raises `KernelError`.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glom_tpu.telemetry.watchdog as jwatchdog
from glom_tpu.models import api as japi
from glom_tpu.models import core as jcore
from glom_tpu.resilience import faults as jfaults
from glom_tpu.resilience import retry as jretry
from glom_tpu.serve import early_exit as jee
from glom_tpu.serve import engine as jengine
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import Glom, GlomConfig, InferenceEngine, ServeConfig, params_from_numpy
from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels._build import KernelError
from glom_tpu_torch.resilience import faults as tfaults
from glom_tpu_torch.resilience import retry as tretry
from glom_tpu_torch.serve import early_exit as tee
from glom_tpu_torch.telemetry import watchdog as twatchdog
from test_torch_port_model import ATOL, RTOL, TINY, flatten

MARGIN = 10.0


class ListWriter:
    def __init__(self):
        self.recs = []

    def write(self, rec):
        self.recs.append(rec)


def _strip(recs, *keys):
    drop = ("backend_state",) + keys
    return [{k: v for k, v in r.items() if k not in drop} for r in recs]


@pytest.fixture(scope="module")
def model():
    jcfg = jconfig.GlomConfig(**TINY)
    jp = jcore.init_glom(jax.random.PRNGKey(0), jcfg)
    return jcfg, GlomConfig(**TINY), jp, params_from_numpy(flatten(jp), device="cpu")


def _images(seed, b=2):
    return np.random.default_rng(seed).standard_normal((b, 3, 16, 16)).astype(np.float32)


class TestGlomAuto:
    def _deltas(self, model, img, iters):
        """Both packages' per-iteration batch-witness deltas."""
        jcfg, tcfg, jp, tp = model
        out = []
        for ee, p, cfg, x in ((tee, tp, tcfg, torch.from_numpy(img)),
                              (jee, jp, jcfg, jnp.asarray(img))):
            step, lv = ee._build_update_step(p, x, cfg, None, None, False)
            prev, ds = ee.masked_level_agreement(lv, None), []
            with torch.no_grad():
                for _ in range(iters):
                    lv = step(lv)
                    agree = ee.masked_level_agreement(lv, None)
                    ds.append(float(np.abs(np.asarray(agree) - np.asarray(prev)).max()))
                    prev = agree
            out.append(np.array(ds))
        return out

    def test_matches_reference_at_a_safe_threshold(self, model):
        _, _, jp, tp = model
        img = _images(50)
        got_d, want_d = self._deltas(model, img, 10)
        err = float(np.abs(got_d - want_d).max())
        vals = np.sort(got_d)
        k = int(np.argmax(vals[1:] / vals[:-1]))
        thr = float(np.sqrt(vals[k] * vals[k + 1]))
        assert np.abs(got_d - thr).min() >= MARGIN * err, (thr, err)
        kw = dict(exit_threshold=thr, auto_max_iters=10, auto_min_iters=2, use_pallas=False)
        tm = Glom(**TINY, params=tp, device="cpu", **kw)
        jm = japi.Glom(**TINY, params=jp, **kw)
        got, want = tm(img, iters="auto"), jm(jnp.asarray(img), iters="auto")
        assert int(tm.last_auto_iters) == int(jm.last_auto_iters) < 10
        assert tm.last_auto_iters.dtype == torch.int32 and tm.last_auto_iters.dim() == 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_threshold0_runs_the_budget(self, model, use_pallas):
        tcfg, jp, tp = model[1], model[2], model[3]
        img = _images(51)
        kw = dict(exit_threshold=0.0, auto_max_iters=4, use_pallas=use_pallas)
        tm = Glom(**TINY, params=tp, device="cpu", **kw)
        got = tm(img, iters="auto")
        assert int(tm.last_auto_iters) == 4
        lv, iters, _ = tee.glom_forward_auto(tp, torch.from_numpy(img), tcfg, max_iters=4,
                                             threshold=0.0, use_pallas=use_pallas)
        assert iters == 4 and torch.equal(got, lv)
        jm = japi.Glom(**TINY, params=jp, exit_threshold=0.0, auto_max_iters=4, use_pallas=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(jm(jnp.asarray(img), iters="auto")),
                                   rtol=RTOL, atol=ATOL)
        assert Glom(**TINY, params=tp, device="cpu").auto_max_iters is None

    def test_return_all_refused(self, model):
        jp, tp = model[2], model[3]
        img = _images(52, 1)
        for m, x in ((Glom(**TINY, params=tp, device="cpu"), img),
                     (japi.Glom(**TINY, params=jp), jnp.asarray(img))):
            with pytest.raises(ValueError, match="return_all"):
                m(x, iters="auto", return_all=True)


class _Flaky:
    """Fails its first `n` calls with `exc`, then answers 42."""

    def __init__(self, n, exc=RuntimeError):
        self.n, self.exc, self.calls = n, exc, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.n:
            # torch's CUDA error types take a CUDA error code: build them bare.
            err = self.exc.__new__(self.exc)
            err.args = (f"flap {self.calls}",)
            raise err
        return 42


class _Watchdog:
    def __init__(self, state):
        self.state = state

    def record(self):
        return {"backend_state": self.state, "backend_devices": None, "backend_transitions": 0}


def _policies(**kw):
    out = []
    for mod in (tretry, jretry):
        w, sleeps = ListWriter(), []
        out.append((mod.RetryPolicy(writer=w, sleep=sleeps.append, site="s", **kw), w, sleeps))
    return out


class TestRetryPolicy:
    @pytest.mark.parametrize("fails,retries", [(0, 2), (2, 2), (3, 4), (3, 2)])
    def test_schedule_events_and_counters_match_reference(self, fails, retries):
        (tp, tw, ts), (jp, jw, js) = _policies(retries=retries, backoff_s=0.01,
                                               backoff_factor=3.0, backoff_max_s=0.05)
        results = []
        for pol in (tp, jp):
            try:
                results.append(pol.run(_Flaky(fails), bucket=2, n_valid=1))
            except RuntimeError as e:
                results.append(str(e))
        assert results[0] == results[1]
        assert ts == js and len(ts) == min(fails, retries)
        assert _strip(tw.recs) == _strip(jw.recs)
        assert tp.record() == jp.record()

    def test_nonretryable_types(self):
        assert set(jretry.NONRETRYABLE_DEFAULT) <= set(tretry.NONRETRYABLE_DEFAULT)
        assert KernelError in tretry.NONRETRYABLE_DEFAULT
        assert set(tretry.CUDA_ERRORS) <= set(tretry.NONRETRYABLE_DEFAULT)
        for exc in (ValueError, TypeError, KernelError, *tretry.CUDA_ERRORS):
            (tp, tw, ts), _ = _policies()
            flaky = _Flaky(1, exc)
            with pytest.raises(exc):
                tp.run(flaky)
            assert flaky.calls == 1 and not tw.recs and not ts
        with pytest.raises(ValueError):
            tretry.RetryPolicy(retries=-1)

    def test_down_backend_fails_fast(self):
        try:
            for mod in (twatchdog, jwatchdog):
                mod.set_global_watchdog(_Watchdog("down"))
            (tp, tw, ts), (jp, jw, js) = _policies()
            for pol in (tp, jp):
                with pytest.raises(RuntimeError, match="flap 1"):
                    pol.run(_Flaky(1))
            assert tp.record() == jp.record() and tp.record()["n_fast_failed"] == 1
            assert not tw.recs and not ts
            for mod in (twatchdog, jwatchdog):
                mod.set_global_watchdog(_Watchdog("flapping"))
            assert tp.run(_Flaky(1)) == 42 and tw.recs[0]["backend_state"] == "flapping"
        finally:
            for mod in (twatchdog, jwatchdog):
                mod.set_global_watchdog(None)
        assert twatchdog.backend_record() == {"backend_state": "unknown"}  # no CUDA here


class _FailedNvcc:
    returncode = 1

    def communicate(self):
        return "k.cu(1): error: expected a ';'", None


def _no_nvcc(monkeypatch):
    monkeypatch.setattr(_build, "shutil", SimpleNamespace(which=lambda name: None))
    monkeypatch.setattr(_build, "os", SimpleNamespace(path=SimpleNamespace(exists=lambda p: False)))


_SITES = {
    "launch": lambda: _build.check(700, "grouped_mlp_fwd",
                                   lambda err: b"an illegal memory access was encountered"),
    "no_nvcc": _build._nvcc,
    "nvcc_failed": lambda: _build._finish("k", _FailedNvcc(), Path("k.tmp"), Path("k.so")),
}


class TestKernelErrorSites:
    def test_launch_error_raises_kernel_error(self):
        _build.check(0, "grouped_mlp_fwd", lambda err: b"no error")  # success: silent
        with pytest.raises(KernelError, match="CUDA error 700 at launch .an illegal memory"):
            _SITES["launch"]()

    def test_missing_nvcc_raises_kernel_error(self, monkeypatch):
        _no_nvcc(monkeypatch)
        with pytest.raises(KernelError, match="nvcc not found"):
            _SITES["no_nvcc"]()

    def test_failed_nvcc_raises_kernel_error(self):
        with pytest.raises(KernelError, match="nvcc failed for k.cu:\n.*expected a ';'"):
            _SITES["nvcc_failed"]()


class TestEngineRetryAndRecords:
    @pytest.fixture(scope="class")
    def engines(self, model):
        jcfg, tcfg, jp, tp = model

        def pair(hook_for, use_pallas=True):
            scfg = dict(buckets=(1, 2), max_batch=2, page_pool_pages=8, page_tokens=4,
                        retry_backoff_ms=0.0)
            jw, tw = ListWriter(), ListWriter()
            ref = jengine.InferenceEngine(jcfg, jconfig.ServeConfig(**scfg), params=jp,
                                          writer=jw, fault_hook=hook_for(jfaults, jw))
            port = InferenceEngine(tcfg, ServeConfig(**scfg, use_pallas=use_pallas), params=tp,
                                   device="cpu", writer=tw, fault_hook=hook_for(tfaults, tw))
            return ref, port, jw, tw

        def faulted(mod, writer):
            plan = mod.FaultPlan(0, writer=writer).register("engine-dispatch", at=(0,))
            return mod.dispatch_fault(plan)

        return {"faulted": pair(faulted), "clean": pair(lambda mod, w: None),
                "records": pair(lambda mod, w: None, use_pallas=False)}

    def test_injected_fault_recovers_bit_for_bit(self, engines):
        ref, port, jw, tw = engines["faulted"]
        _, clean, _, _ = engines["clean"]
        imgs = _images(60)
        got, want = port.infer(imgs), ref.infer(imgs)
        assert torch.equal(got.levels, clean.infer(imgs).levels)
        actions = [r.get("action") for r in tw.recs if r.get("kind") == "recovery"]
        assert actions == ["dispatch-retry", "dispatch-recovered"]
        kinds = [[r["kind"] for r in w.recs if r["kind"] != "serve"] for w in (tw, jw)]
        assert kinds[0] == kinds[1] == ["fault", "recovery", "recovery"]
        assert _strip([r for r in tw.recs if r["kind"] == "recovery"], "exception") == \
            _strip([r for r in jw.recs if r["kind"] == "recovery"], "exception")
        assert port.retry.record() == ref.retry.record()
        np.testing.assert_allclose(got.levels.numpy(), np.asarray(want.levels),
                                   rtol=RTOL, atol=ATOL)

    def test_kernel_error_is_not_retried(self, model):
        tcfg, tp = model[1], model[3]
        calls, w = [], ListWriter()

        def hook(ctx):
            calls.append(ctx)
            raise KernelError("grouped_mlp_fwd: CUDA error 719 at launch (unspecified)")

        eng = InferenceEngine(tcfg, ServeConfig(buckets=(2,), max_batch=2), params=tp,
                              device="cpu", writer=w, fault_hook=hook)
        assert eng.retry.retries == 2
        with pytest.raises(KernelError):
            eng.infer(_images(61))
        assert calls == [{"bucket": 2, "n_valid": 2, "attempt": 1}]
        assert not [r for r in w.recs if r["kind"] == "recovery"]
        assert eng.retry.record()["n_retries"] == 0

    @pytest.mark.parametrize("site", ["launch", "no_nvcc", "nvcc_failed"])
    def test_build_and_launch_failures_are_not_retried(self, model, monkeypatch, site):
        # Each of _build's failure sites, raised inside the default engine's
        # attempt, reaches the caller on the first attempt.
        _no_nvcc(monkeypatch)
        tcfg, tp = model[1], model[3]
        calls, w = [], ListWriter()

        def hook(ctx):
            calls.append(ctx["attempt"])
            _SITES[site]()

        eng = InferenceEngine(tcfg, ServeConfig(buckets=(2,), max_batch=2), params=tp,
                              device="cpu", writer=w, fault_hook=hook)
        with pytest.raises(KernelError):
            eng.infer(_images(65))
        assert calls == [1]
        assert not [r for r in w.recs if r["kind"] == "recovery"]
        assert eng.retry.record()["n_retries"] == 0

    def test_stats_records_and_release_match_reference(self, engines):
        ref, port, jw, tw = engines["records"]
        for eng in (ref, port):
            # Every signature warmed first: the port has no compile apart
            # from a signature's first dispatch, which it counts as the
            # warm-up, where glom_tpu compiles and then counts the dispatch.
            eng.warmup((1,))
            eng.warmup((2,), warm="paged")
            eng.infer(_images(62, 1))
            eng.infer(_images(63, 2), page_rows=np.full((2, 4), -1, np.int32))
            eng.infer(_images(64, 2), page_rows=np.full((2, 4), -1, np.int32))
        keys = ("bucket", "iters", "warm_state", "use_pallas", "steps_timed", "event",
                "engine", "kind", "schema_version")
        got, want = port.stats_records(), ref.stats_records()
        assert [sorted(r) for r in got] == [sorted(r) for r in want]
        assert [[r[k] for k in keys] for r in got] == [[r[k] for k in keys] for r in want]
        assert all(r["compile_time_s"] > 0 for r in got)
        warmups = [_strip([r], "compile_time_s")[0] for w in (tw, jw)
                   for r in w.recs if r.get("event") == "warmup"]
        assert warmups[:len(warmups) // 2] == warmups[len(warmups) // 2:]
        for eng in (ref, port):
            eng.release()
            assert eng.released and eng.pool.buffer() is None
        assert _strip([tw.recs[-1]]) == _strip([jw.recs[-1]]) == [
            {"event": "engine_release", "engine": "engine0", "schema_version": 11,
             "kind": "serve"}]
        # A paged dispatch fails on both (glom_tpu's as it rebuilds the
        # signature against the dropped buffer); the port refuses every
        # route with one message.
        with pytest.raises(AttributeError):
            ref.infer(_images(65, 2), page_rows=np.full((2, 4), -1, np.int32))
        for kw in ({"page_rows": np.full((2, 4), -1, np.int32)}, {}):
            with pytest.raises(RuntimeError, match="released"):
                port.infer(_images(65, 2), **kw)
        assert port.stats_records() == got

    def test_config_fields_resolve_as_reference(self, model):
        tcfg, tp = model[1], model[3]
        with pytest.warns(UserWarning, match="single-device"):
            eng = InferenceEngine(tcfg, ServeConfig(collective_timing="sampled"), params=tp,
                                  device="cpu")
        assert eng.collective_timing == "off"
        with pytest.warns(UserWarning, match="donates"):
            InferenceEngine(tcfg, ServeConfig(donate=True), params=tp, device="cpu")
        assert InferenceEngine(tcfg, ServeConfig(dispatch_retries=0), params=tp,
                               device="cpu").retry is None
        for bad in (dict(dispatch_retries=-1), dict(retry_backoff_ms=-1.0),
                    dict(pool_aliasing=True), dict(delta_streaming=True),
                    dict(delta_page_atol=-1.0), dict(delta_chain_cap=0),
                    dict(collective_timing="x"), dict(collective_timing_interval=0),
                    dict(delta_streaming=True, page_pool_pages=4, ragged=True)):
            for cfg in (ServeConfig, jconfig.ServeConfig):
                with pytest.raises(ValueError):
                    cfg(**bad)
        eng = InferenceEngine(tcfg, ServeConfig(phase_split=False, buckets=(1,), max_batch=1),
                              params=tp, device="cpu")
        assert eng.infer(_images(66, 1)).phases is None
