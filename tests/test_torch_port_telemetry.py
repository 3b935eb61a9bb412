"""Telemetry's measuring half in the port against glom_tpu's, on the CPU.

Held here, on numpy-seeded inputs:

  * the alpha-beta time model (`fit_time_model`, `collective_time_records`)
    and `CollectiveTimeLog.drain` equal glom_tpu's exactly on the same
    samples and events; the sampler's site registry (dedupe, update_sites)
    is glom_tpu's; `resolve_collective_timing` warns glom_tpu's text; the
    full-mode bracket logs one execution a call and changes no bit;
  * `level_agreement` / `split_level_agreement` against glom_tpu's at 1e-6
    (f32), and a Trainer at telemetry_level="full" (2 levels, d 32, batch
    2, glom_tpu's initial weights through `params_from_numpy`, noise_std 0,
    the same numpy batches) against glom_tpu's Trainer at 1e-5;
  * `parse_trace_steps`' errors, `TraceCapture`'s note records with both
    profilers faked, and one real torch.profiler window on the CPU;
  * `BackendWatchdog`'s timeline and events against glom_tpu's under one
    injected probe sequence and fake clock, its global registration and
    the retry policy's fail-fast on "down";
  * `memory_record` gives {} on the CPU.

The collective timing across ranks (the ZeRO trainer and a mesh engine)
runs in tests/test_torch_port_dist_train.py and
tests/test_torch_port_serve_mesh.py.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu.telemetry import comm_time as jcomm
from glom_tpu.telemetry import counters as jcounters
from glom_tpu.telemetry import diagnostics as jdiag
from glom_tpu.telemetry import watchdog as jwatchdog
from glom_tpu.tracing import capture as jcapture
from glom_tpu.tracing import memory as jmemory
from glom_tpu.train import trainer as jtrainer
from glom_tpu.utils import config as jconfig
from glom_tpu_torch.models.transplant import params_from_numpy
from glom_tpu_torch.parallel.collectives import Axis
from glom_tpu_torch.resilience.retry import RetryPolicy
from glom_tpu_torch.telemetry import comm_time, counters, diagnostics, schema, watchdog
from glom_tpu_torch.tracing import capture, memory
from glom_tpu_torch.train import Trainer
from glom_tpu_torch.utils.config import GlomConfig, TrainConfig
from glom_tpu_torch.utils.metrics import probe_device_count


class ListWriter:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)


def _samples(seed, n=7):
    rng = np.random.default_rng(seed)
    return [{"site": f"s{i % 4}", "axis": "data", "collective": "psum",
             "wire_bytes": int(rng.integers(1, 1 << 20)),
             "wall_ms": float(rng.uniform(0.01, 5.0)), "calls": int(rng.integers(1, 4))}
            for i in range(n)]


# -- the time model and the records -------------------------------------------------


class TestTimeModel:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_fit_and_records_equal_glom_tpus(self, seed):
        s = _samples(seed)
        assert comm_time.fit_time_model(s) == jcomm.fit_time_model(s)
        for mode in ("sampled", "full"):
            got = comm_time.collective_time_records(s, path="p", mode=mode)
            want = jcomm.collective_time_records(s, path="p", mode=mode)
            assert got == want
            assert all(schema.validate_record(r) == [] for r in got)
        model = {"alpha_ms": 0.5, "beta_ms_per_byte": 1e-6, "n_points": 3}
        assert (comm_time.collective_time_records(s, path="p", mode="sampled", model=model)
                == jcomm.collective_time_records(s, path="p", mode="sampled", model=model))

    @pytest.mark.parametrize("points", [
        [], [{"wire_bytes": 8, "wall_ms": 1.0}], [{"wire_bytes": 8, "wall_ms": 1.0}] * 3,
        [{"wire_bytes": 8, "wall_ms": 2.0}, {"wire_bytes": 16, "wall_ms": 1.0}],
        [{"wire_bytes": "x", "wall_ms": 1.0}],
    ], ids=["none", "one", "one-size", "negative-slope", "malformed"])
    def test_degenerate_fits(self, points):
        assert comm_time.fit_time_model(points) == jcomm.fit_time_model(points)
        for wall, model in ((0.0, 0.0), (1.0, 0.0), (1.0, 2.0)):
            assert comm_time.time_model_drift(wall, model) == jcomm.time_model_drift(wall, model)
        assert comm_time.collective_time_records([], path="p", mode="sampled") == []

    def test_log_drain_equals_glom_tpus(self):
        rng = np.random.default_rng(4)
        ours, ref = counters.CollectiveTimeLog(), jcounters.CollectiveTimeLog()
        for i in range(40):
            ev = (f"s{i % 3}", "data" if i % 2 else "seq", "psum", int(rng.integers(1, 3)) * 64,
                  float(rng.uniform(1e-5, 1e-2)))
            ours.add(*ev)
            ref.add(*ev)
        assert ours.drain() == ref.drain()
        assert ours.drain() == ref.drain() == []

    def test_log_is_bounded(self):
        log = counters.CollectiveTimeLog(max_events=3)
        for _ in range(5):
            log.add("s", "data", "psum", 8, 1e-3)
        assert [r["calls"] for r in log.drain()] == [3]


# -- the timing modes -----------------------------------------------------------------


class TestTimingModes:
    def test_resolution_and_warning_equal_glom_tpus(self):
        for mode in counters.TIMING_MODES:
            assert counters.resolve_collective_timing(mode) == mode
        msgs = []
        for resolve in (counters.resolve_collective_timing, jcounters.resolve_collective_timing):
            with pytest.warns(UserWarning) as rec:
                assert resolve("full", supports_full=False, path="the manual trainer") == "sampled"
            msgs.append(str(rec[0].message))
        assert msgs[0] == msgs[1]
        with pytest.raises(ValueError):
            counters.resolve_collective_timing("always")

    def test_full_brackets_each_call_and_changes_no_bit(self):
        x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 8)).astype(np.float32))
        fn = lambda t: t * 3.0 + 1.0  # noqa: E731
        want = fn(x)
        log = counters.CollectiveTimeLog()
        c = counters.CollectiveCounters()
        for mode in ("off", "sampled", "full"):
            with counters.recording(c), counters.timing(mode, log):
                got = counters.timed_collective("s", "data", "reduce", 64, fn, x,
                                                collective="psum")
                # a priced site (nothing moves) is never bracketed
                counters.timed_collective("p", "data", "reduce", 4, lambda t: t,
                                          torch.empty((), device="meta"), collective="psum")
            assert torch.equal(got, want)
        (row,) = log.drain()
        assert (row["site"], row["calls"], row["wire_bytes"], row["mode"]) == ("s", 1, 64, "full")
        assert row["wall_ms"] >= 0 and row["wall_ms_max"] >= row["wall_ms"]
        assert [s["calls"] for s in c.sites] == [3, 3]  # counting is the same in every mode

    def test_sampler_registry_equals_glom_tpus(self):
        sites = [
            {"site": "a", "axis": "data", "collective": "psum", "wire_bytes": 64, "calls": 1,
             "shape": (4, 4), "dtype": "torch.float32", "dim": 0},
            {"site": "a", "axis": "data", "collective": "psum", "wire_bytes": 64, "calls": 2,
             "shape": (16,), "dtype": "torch.float32", "dim": 0},
            {"site": "b", "axis": "data", "collective": "all_gather", "wire_bytes": 0,
             "calls": 1, "shape": (2,), "dtype": "torch.float32", "dim": 0},
            {"site": "c", "axis": "seq", "collective": "psum_scatter", "wire_bytes": 32,
             "calls": 1, "shape": (2, 4), "dtype": "torch.float32", "dim": 1},
        ]
        axis = {"data": Axis("data", None, 1, 0), "seq": Axis("seq", None, 1, 0)}
        ours = comm_time.CollectiveTimeSampler(axis, sites, interval=2)
        ref = jcomm.CollectiveTimeSampler(None, sites, interval=2)
        key = lambda s: (s["site"], s["wire_bytes"])  # noqa: E731
        assert sorted(ours.sites, key=key) == sorted(ref.sites, key=key)
        more = sites + [{"site": "d", "axis": "data", "collective": "pmean", "wire_bytes": 8,
                         "calls": 5, "shape": (2,), "dtype": "torch.float32", "dim": 0}]
        ours.update_sites(more)
        ref.update_sites(more)
        assert sorted(ours.sites, key=key) == sorted(ref.sites, key=key)
        assert [s["site"] for s in ours.sites] == ["a", "c", "d"]  # the sorted walk
        for bad in (dict(interval=0), dict(repeats=0)):
            with pytest.raises(ValueError):
                comm_time.CollectiveTimeSampler(axis, sites, **bad)

    def test_sampler_on_one_rank(self):
        """Axes of one rank move nothing but run the timed loop: one row a
        site, every N-th call."""
        sites = [{"site": s, "axis": "data", "collective": c, "wire_bytes": 16, "calls": 1,
                  "shape": (2, 4), "dtype": "torch.float32", "dim": 1}
                 for s, c in (("r", "psum"), ("m", "pmean"), ("g", "all_gather"),
                              ("x", "psum_scatter"))]
        sampler = comm_time.CollectiveTimeSampler({"data": Axis("data", None, 1, 0)}, sites,
                                                  interval=2)
        assert sampler.maybe_sample(path="t") == []
        recs = sampler.maybe_sample(path="t")
        assert [r["site"] for r in recs] == ["g", "m", "r", "x", "comm_time_model"]
        assert all(r["wall_ms"] >= 0 and r["mode"] == "sampled" for r in recs)


# -- per-level agreement and telemetry "full" -------------------------------------------


class TestLevelAgreement:
    @pytest.mark.parametrize("seed, shape", [(0, (2, 16, 3, 32)), (1, (1, 4, 6, 8))])
    def test_matches_glom_tpu(self, seed, shape):
        final = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
        got = diagnostics.level_agreement(torch.from_numpy(final))
        want = np.asarray(jdiag.level_agreement(jnp.asarray(final)))
        assert got.dtype == torch.float32 and got.shape == (shape[2],)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        m = {"loss": 1.0, "level_agreement": got}
        ours = diagnostics.split_level_agreement(m)
        ref = jdiag.split_level_agreement({"loss": 1.0, "level_agreement": jnp.asarray(want)})
        assert sorted(ours) == sorted(ref) and "level_agreement" in m
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-6)
        assert diagnostics.split_level_agreement({"loss": 1.0}) == {"loss": 1.0}

    @staticmethod
    def _flatten(params) -> dict:
        out = {}
        for name in params.glom._fields:
            v = getattr(params.glom, name)
            if hasattr(v, "_fields"):
                for sub in v._fields:
                    out[f"{name}.{sub}"] = np.asarray(getattr(v, sub))
            else:
                out[name] = np.asarray(v)
        out["to_pixels.w"] = np.asarray(params.to_pixels.w)
        out["to_pixels.b"] = np.asarray(params.to_pixels.b)
        return out

    @pytest.mark.parametrize("tkw", [{}, {"batch_size": 4, "grad_accum": 2}],
                             ids=["batch2", "accum2"])
    def test_trainer_full_matches_glom_tpu(self, tkw):
        kw = dict(dim=32, levels=2, image_size=8, patch_size=4)
        tk = dict(dict(batch_size=2, telemetry_level="full", noise_std=0.0, learning_rate=1e-3),
                  **tkw)
        ref_w, ours_w = ListWriter(), ListWriter()
        jt = jtrainer.Trainer(jconfig.GlomConfig(**kw), jconfig.TrainConfig(**tk),
                              metrics_writer=ref_w)
        tt = Trainer(GlomConfig(**kw), TrainConfig(**tk), metrics_writer=ours_w, device="cpu",
                     params=params_from_numpy(self._flatten(jt.state.params)))
        rng = np.random.default_rng(7)
        batches = [rng.standard_normal((tk["batch_size"], 3, 8, 8)).astype(np.float32)
                   for _ in range(2)]
        jt.fit(iter([jnp.asarray(b) for b in batches]), 2, log_every=1)
        tt.fit(iter(batches), 2, log_every=1)
        steps = lambda w: [r for r in w.records if r["kind"] == "train_step"]  # noqa: E731
        assert tt.telemetry_level == "full" and len(steps(ours_w)) == 2
        for ours, ref in zip(steps(ours_w), steps(ref_w)):
            keys = sorted(k for k in ref if k.startswith("consensus_agreement_l"))
            assert keys == ["consensus_agreement_l0", "consensus_agreement_l1"]
            assert keys == sorted(k for k in ours if k.startswith("consensus_agreement_l"))
            for k in keys:
                np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-5, err_msg=k)
            assert "level_agreement" not in ours
            np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=5e-4)

    def test_agreement_stays_out_of_the_backward(self):
        kw = dict(dim=16, levels=2, image_size=8, patch_size=4)
        tr = Trainer(GlomConfig(**kw), TrainConfig(batch_size=2, telemetry_level="full",
                                                   noise_std=0.0), device="cpu")
        tr_off = Trainer(GlomConfig(**kw), TrainConfig(batch_size=2, telemetry_level="scalars",
                                                       noise_std=0.0), device="cpu")
        img = np.random.default_rng(8).standard_normal((2, 3, 8, 8)).astype(np.float32)
        m, m_off = tr.step(img), tr_off.step(img)
        assert m["level_agreement"].shape == (2,) and not m["level_agreement"].requires_grad
        assert float(m["loss"]) == float(m_off["loss"])
        for a, b in zip(tr.state.optimizer.param_groups[0]["params"],
                        tr_off.state.optimizer.param_groups[0]["params"]):
            assert torch.equal(a, b)


# -- trace capture ---------------------------------------------------------------------


class FakeJaxProfiler:
    def __init__(self):
        self.calls = []

    def start_trace(self, log_dir):
        self.calls.append(("start", log_dir))

    def stop_trace(self):
        self.calls.append(("stop", None))

    class StepTraceAnnotation:
        def __init__(self, name, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False


class FakeTorchProfile:
    calls = []

    def __init__(self, activities=None):
        self.activities = activities

    def start(self):
        FakeTorchProfile.calls.append("start")

    def stop(self):
        FakeTorchProfile.calls.append("stop")

    def export_chrome_trace(self, path):
        FakeTorchProfile.calls.append(("export", os.path.dirname(path)))


class TestTraceCapture:
    @pytest.mark.parametrize("spec", ["5:3", "-1:2", "a:b", "1:2:3", "", "3:5", "7"])
    def test_parse_equals_glom_tpus(self, spec):
        try:
            want = jcapture.parse_trace_steps(spec)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                capture.parse_trace_steps(spec)
            assert str(got.value) == str(e)
            return
        assert capture.parse_trace_steps(spec) == want

    @pytest.mark.parametrize("spec, units, close", [("2:4", 7, False), ("1:100", 3, True),
                                                    ("0", 2, False)])
    def test_notes_equal_glom_tpus(self, monkeypatch, tmp_path, spec, units, close):
        monkeypatch.setattr(jax, "profiler", FakeJaxProfiler())
        FakeTorchProfile.calls = []
        monkeypatch.setattr(torch.profiler, "profile", FakeTorchProfile)
        ours, ref = ListWriter(), ListWriter()
        caps = (capture.TraceCapture.parse(spec, str(tmp_path), writer=ours),
                jcapture.TraceCapture.parse(spec, str(tmp_path), writer=ref))
        seen = []
        for cap in caps:
            s = []
            for _ in range(units):
                with cap.unit() as i:
                    s.append((i, cap._active))
            if close:
                cap.close()
                cap.close()
            seen.append(s)
        assert seen[0] == seen[1]
        assert ours.records == ref.records
        assert FakeTorchProfile.calls == ["start", "stop", ("export", str(tmp_path))]

    def test_real_cpu_window(self, tmp_path):
        w = ListWriter()
        cap = capture.TraceCapture.parse("1:2", str(tmp_path / "tr"), writer=w)
        x = torch.ones(16, 16)
        for _ in range(4):
            with cap.unit():
                x = torch.tanh(x @ x)
        cap.close()
        assert [r["note"] for r in w.records] == ["xla-trace-start", "xla-trace-stop"]
        (name,) = os.listdir(tmp_path / "tr")
        assert cap.path == str(tmp_path / "tr" / name)
        events = json.load(open(cap.path))["traceEvents"]
        names = {e.get("name") for e in events}
        assert {"step#1", "step#2"} <= names and "step#0" not in names
        with capture.trace(str(tmp_path / "run")):
            torch.tanh(x)
        assert len(os.listdir(tmp_path / "run")) == 1
        with pytest.raises(NotImplementedError, match="no torch counterpart"):
            capture.start_server()

    def test_annotate(self):
        @capture.annotate("host_phase")
        def f(a):
            return a + 1

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            assert f(1) == 2
        assert "host_phase" in {e.key for e in prof.key_averages()}


# -- the watchdog -------------------------------------------------------------------


def _watchdogs(probes, **kw):
    """The port's and glom_tpu's watchdog over the same probe sequence and
    fake clock (10 s a probe), each with a writer."""
    out = []
    for cls in (watchdog.BackendWatchdog, jwatchdog.BackendWatchdog):
        seq, t = iter(probes), [0.0]

        def clock(t=t):
            t[0] += 10.0
            return t[0]

        w = ListWriter()
        out.append((cls(probe=lambda timeout, seq=seq: next(seq), clock=clock, writer=w, **kw),
                    w))
    return out


def _no_wall(recs):
    return [{k: v for k, v in r.items() if k != "wall_time_s"} for r in recs]


class TestWatchdog:
    @pytest.mark.parametrize("probes, kw", [
        ([8, None, 8], {}),  # up, down, up
        ([8, None, 8, None, 8, 8, 8], dict(flap_window_s=25.0)),  # flapping, then settled
        ([8, None, 8, None, 8], dict(flap_threshold=2)),
        ([8] * 8, dict(heartbeat_s=25.0)),  # heartbeats between transitions
        ([None, None, 0, 1], {}),
    ], ids=["up-down", "flap-settle", "threshold2", "heartbeat", "down-first"])
    def test_timeline_equals_glom_tpus(self, probes, kw):
        (ours, ow), (ref, rw) = _watchdogs(probes, **kw)
        states = [(ours.probe_once(), ref.probe_once()) for _ in probes]
        assert [a for a, _ in states] == [b for _, b in states]
        assert _no_wall(ours.timeline()) == _no_wall(ref.timeline())
        assert _no_wall(ow.records) == _no_wall(rw.records)
        assert ours.record() == ref.record()
        assert all(schema.validate_record(r) == [] for r in ow.records)

    def test_probe_fault_and_retry_fail_fast(self):
        (ours, _), (ref, _) = _watchdogs([1] * 4, flap_threshold=10)
        for wd in (ours, ref):
            wd.probe_once()
            wd.set_probe_fault(lambda n: None)
            wd.probe_once()
        assert ours.state == ref.state == "down"
        watchdog.set_global_watchdog(ours)
        try:
            assert watchdog.backend_record()["backend_state"] == "down"
            attempts = []

            def attempt():
                attempts.append(1)
                raise RuntimeError("transient")

            with pytest.raises(RuntimeError):
                RetryPolicy(retries=3, backoff_s=0.0).run(attempt)
            assert len(attempts) == 1
            for wd in (ours, ref):
                wd.set_probe_fault(None)
            assert ours.probe_once() == ref.probe_once() == "up"
            assert watchdog.backend_record()["backend_state"] == "up"
        finally:
            watchdog.set_global_watchdog(None)
        assert _no_wall(ours.timeline()) == _no_wall(ref.timeline())

    def test_thread_and_default_probe(self):
        wd = watchdog.BackendWatchdog(interval_s=0.01, device_type="cpu")
        wd.start()
        try:
            for _ in range(500):
                if wd.state != "unknown":
                    break
                import time

                time.sleep(0.02)
        finally:
            wd.stop()
        assert wd.state == "up" and wd.record()["backend_devices"] == 1
        assert probe_device_count(timeout=60, device_type="cpu") == 1
        with pytest.raises(ValueError):
            probe_device_count(device_type="tpu")
        with pytest.raises(ValueError):
            watchdog.BackendWatchdog(flap_threshold=1)


# -- the memory probe ------------------------------------------------------------------


class TestMemory:
    def test_cpu_gives_nothing(self):
        assert memory.memory_record(1 << 20, "cpu") == {}
        assert memory.hbm_watermarks("cpu") == {}
        assert memory.device_memory_stats(torch.device("cpu")) is None

    def test_model_total_equals_glom_tpus(self):
        rec = {"params_bytes_per_replica": 10, "grads_bytes_per_replica": 20,
               "opt_bytes_per_replica": 30, "other": 5}
        assert memory.model_live_bytes_total(rec) == jmemory.model_live_bytes_total(rec) == 60
        assert memory.model_live_bytes_total({}) == jmemory.model_live_bytes_total({}) == 0

    def test_trainer_records_carry_no_hbm_fields_on_the_cpu(self):
        kw = dict(dim=16, levels=2, image_size=8, patch_size=4)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tr = Trainer(GlomConfig(**kw), TrainConfig(batch_size=2), device="cpu")
        img = np.zeros((2, 3, 8, 8), np.float32)
        (rec,) = tr.fit(iter([img]), 1, log_every=1)
        assert not any(k.startswith("hbm_") for k in rec) and tr._memory_record() == {}
