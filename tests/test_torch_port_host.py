"""The training CLI's host-side modules against glom_tpu's, on the CPU:
presets, the event schema, the file loaders, the FLOP and live-bytes
models, spans, the flight recorder, the metrics writer, the timing helpers,
temporal rollouts, and the trainer's record stream.

Temporal rollouts carry glom_tpu's weights across with `params_from_numpy`
and are held at rtol 2e-3 / atol 2e-4, the bar tests/test_model.py:43
holds glom_tpu's own routes to; everything else is held exactly.
"""

import dataclasses
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu.data import loaders as jloaders
from glom_tpu.data import synthetic as jsynthetic
from glom_tpu.models import core as jcore
from glom_tpu.resilience import FaultPlan as JFaultPlan
from glom_tpu.resilience import nan_storm as jnan_storm
from glom_tpu.telemetry import schema as jschema
from glom_tpu.telemetry import sinks as jsinks
from glom_tpu.tracing import report as jreport
from glom_tpu.tracing import spans as jspans
from glom_tpu.train import temporal as jtemporal
from glom_tpu.train import trainer as jtrainer
from glom_tpu.utils import config as jconfig
from glom_tpu.utils import metrics as jmetrics
from glom_tpu.utils import presets as jpresets
from glom_tpu_torch import GlomConfig, TrainConfig, Trainer, params_from_numpy
from glom_tpu_torch.data import (
    file_dataset,
    image_folder_dataset,
    npy_dataset,
    shapes_dataset,
    write_shapes_dataset,
)
from glom_tpu_torch.resilience import FaultPlan, nan_storm
from glom_tpu_torch.telemetry import schema
from glom_tpu_torch.telemetry.sinks import StepTimeStats
from glom_tpu_torch.tracing import flight
from glom_tpu_torch.tracing.report import StepTimer, perf_report
from glom_tpu_torch.tracing.spans import SpanAggregator, span, spanned
from glom_tpu_torch.train import temporal_rollout
from glom_tpu_torch.utils import metrics, presets, timing

RTOL, ATOL = 2e-3, 2e-4
TINY = {"dim": 16, "levels": 3, "image_size": 8, "patch_size": 4}


class ListWriter:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)


# -- presets and the FLOP / live-bytes models ------------------------------------


class TestPresets:
    def test_the_same_presets(self):
        assert sorted(presets.PRESETS) == sorted(jpresets.PRESETS)
        with pytest.raises(KeyError, match="unknown preset"):
            presets.get_preset("imagenet1k")

    @pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
    def test_configs_match(self, name):
        ours, ref = presets.get_preset(name), jpresets.get_preset(name)
        for part in ("model", "train", "mesh"):
            assert dataclasses.asdict(getattr(ours, part)) == dataclasses.asdict(
                getattr(ref, part)), part
        assert (ours.name, ours.description, ours.sp_strategy) == (
            ref.name, ref.description, ref.sp_strategy)
        # The port's ServeConfig holds a subset of glom_tpu's fields: each
        # one the preset carries has glom_tpu's value.
        for f in dataclasses.fields(ours.serve):
            assert getattr(ours.serve, f.name) == getattr(ref.serve, f.name), f.name

    @pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
    @pytest.mark.parametrize("n", [1, 2, 4, 8])
    def test_scaled_to_matches(self, name, n):
        ours = presets.get_preset(name).scaled_to(n)
        ref = jpresets.get_preset(name).scaled_to(n)
        assert dataclasses.asdict(ours.mesh) == dataclasses.asdict(ref.mesh)
        assert ours.sp_strategy == ref.sp_strategy
        assert ours.mesh.num_devices <= n or ours.mesh.shape == (1, 1, 1)

    @pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
    def test_flops_match(self, name):
        ours, ref = presets.get_preset(name).model, jpresets.get_preset(name).model
        assert metrics.flops_per_column_iter(ours) == jmetrics.flops_per_column_iter(ref)
        assert metrics.tokens_flops(ours) == jmetrics.tokens_flops(ref)

    @pytest.mark.parametrize("tkw", [{}, {"lr_schedule": "cosine", "weight_decay": 0.1}])
    def test_live_bytes_model_matches(self, tkw):
        jt = jtrainer.Trainer(jconfig.GlomConfig(**TINY), jconfig.TrainConfig(batch_size=2, **tkw))
        to_np = lambda tree: [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
        got = metrics.live_bytes_model(to_np(jt.state.params), to_np(jt.state.opt_state))
        want = {k: jt._static_record[k] for k in got}
        assert got == want
        # The port's own Trainer: torch's Adam keeps two moments and a
        # scalar step per parameter.
        tt = Trainer(GlomConfig(**TINY), TrainConfig(batch_size=2, **tkw), device="cpu")
        rec = tt._static_record
        n_leaves = len(jax.tree_util.tree_leaves(jt.state.params))
        assert rec["params_bytes_per_replica"] == want["params_bytes_per_replica"]
        assert rec["opt_bytes_per_replica"] == (2 * rec["params_bytes_per_replica"]
                                                + 4 * n_leaves)

    def test_mfu_against_the_card_peak(self):
        cfg = presets.get_preset("imagenet224-dp8").model
        f = metrics.flops_per_column_iter(cfg)
        assert metrics.mfu(cfg, 1e6, chip="h100-sxm") == pytest.approx(1e6 * f / 989e12)
        assert metrics.mfu(cfg, 1e6, chip="h100-sxm", backward=True) == pytest.approx(
            3e6 * f / 989e12)
        assert metrics.mfu(cfg, 1e6, chip=None) is None
        assert metrics.mfu(cfg, 1e6, chip="cpu") is None
        assert metrics.detect_chip("cpu") == "cpu"
        assert not set(metrics.PEAK_FLOPS) & set(jmetrics.PEAK_FLOPS)  # no TPU number
        rep = perf_report(cfg, column_iters_per_sec=2e5, num_chips=2, backward=True)
        jrep = jreport.perf_report(jconfig.GlomConfig(), column_iters_per_sec=2e5, num_chips=2)
        assert set(rep) == set(jrep)
        assert rep["column_iters_per_sec_per_chip"] == jrep["column_iters_per_sec_per_chip"]


# -- the event schema ----------------------------------------------------------------

SCHEMA_CASES = {
    "train_step": {"step": 3, "loss": 0.5},
    "train_step_bool_step": {"step": True, "loss": 0.5, "kind": "train_step",
                             "schema_version": 11},
    "span": {"name": "host_data_next", "dur_s": 0.01},
    "anomaly": {"step": 4, "reason": "nonfinite_loss_or_grad"},
    "recovery": {"action": "skip-torn-checkpoint", "step": 2},
    "fault": {"fault": "torn-checkpoint", "site": "ckpt-truncate"},
    "bench": {"metric": "m", "value": 1.0, "unit": "u"},
    "error": {"error": "backend-init-unavailable", "value": None},
    "note": {"note": "hello"},
    "watchdog_bad_state": {"backend_state": "sideways", "t": 1.0},
    "serve_untraced": {"event": "dispatch", "kind": "serve", "schema_version": 11},
    "workload_no_class": {"t": 0.0, "signature": "bucket:3x8x8", "outcome": "served",
                          "kind": "workload"},
    "forecast_unscored": {"metric": "arrival_rate_rps", "horizon_s": 1.0, "kind": "forecast"},
    "decision_no_evidence": {"action": "scale_out", "decision_id": 1, "kind": "decision"},
    "unknown_kind": {"kind": "telepathy", "schema_version": 11},
    "old_version": {"step": 1, "loss": 1.0, "schema_version": 99},
    "summary": {"summary": True},
}


class TestSchema:
    def test_the_same_contract(self):
        assert schema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
        assert schema.KINDS == jschema.KINDS
        assert schema.TRACE_REQUIRED_EVENTS == jschema.TRACE_REQUIRED_EVENTS

    @pytest.mark.parametrize("case", sorted(SCHEMA_CASES))
    def test_stamp_and_validate_agree(self, case):
        rec = SCHEMA_CASES[case]
        ours, ref = schema.stamp(rec), jschema.stamp(rec)
        assert ours == ref
        # Each package's stamp validates the same way under the other's rules.
        assert schema.validate_record(ref) == jschema.validate_record(ref)
        assert jschema.validate_record(ours) == schema.validate_record(ours)

    def test_lint_entry(self, tmp_path, capsys):
        good = tmp_path / "good.jsonl"
        good.write_text("noise\n" + json.dumps(schema.stamp({"step": 1, "loss": 1.0})) + "\n")
        bad = tmp_path / "bad.jsonl"
        bad.write_text(json.dumps({"step": 1, "loss": 1.0}) + "\n")
        assert schema.main([str(good)]) == 0
        assert schema.main([str(bad)]) == 1
        assert schema.main(["--allow-unstamped", str(bad)]) == 0
        for path in (good, bad):
            with open(path) as fh:
                ours = schema.lint_stream(fh)
            with open(path) as fh:
                assert ours == jschema.lint_stream(fh)


# -- the file loaders ----------------------------------------------------------------


def _batches(it, k=3):
    return [np.asarray(next(it)) for _ in range(k)]


class TestLoaders:
    @pytest.fixture(scope="class")
    def files(self, tmp_path_factory):
        root = tmp_path_factory.mktemp("data")
        png = write_shapes_dataset(str(root / "png"), 10, 12, seed=1, fmt="png")
        jpng = jsynthetic.write_shapes_dataset(str(root / "jpng"), 10, 12, seed=1, fmt="png")
        shards = write_shapes_dataset(str(root / "shards"), 20, 8, seed=2, fmt="npy",
                                      shard_size=7)
        jshards = jsynthetic.write_shapes_dataset(str(root / "jshards"), 20, 8, seed=2,
                                                  fmt="npy", shard_size=7)
        rng = np.random.default_rng(3)
        one = root / "one.npy"
        np.save(one, rng.integers(0, 256, (9, 8, 8, 3), dtype=np.uint8))  # [N, H, W, C]
        return dict(root=root, png=png, jpng=jpng, shards=shards, jshards=jshards, one=one)

    def test_written_files_match(self, files):
        from PIL import Image

        assert [p.rsplit("/", 1)[1] for p in files["png"]] == [
            p.rsplit("/", 1)[1] for p in files["jpng"]]
        for a, b in zip(files["png"], files["jpng"]):
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        for a, b in zip(files["shards"], files["jshards"]):
            np.testing.assert_array_equal(np.load(a), np.load(b))

    @pytest.mark.parametrize("seed", [0, 5])
    @pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
    def test_image_folder_matches(self, files, seed, shard):
        kw = dict(seed=seed, shard_index=shard[0], num_shards=shard[1])
        d = str(files["root"] / "png")
        for got, want in zip(_batches(image_folder_dataset(d, 2, 8, **kw)),
                             _batches(jloaders.image_folder_dataset(d, 2, 8, **kw))):
            assert got.dtype == np.float32 and got.shape == (2, 3, 8, 8)
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("seed", [0, 5])
    @pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
    @pytest.mark.parametrize("which", ["one", "shards"])
    def test_npy_matches(self, files, seed, shard, which):
        path = str(files["one"] if which == "one" else files["root"] / "shards")
        kw = dict(seed=seed, shard_index=shard[0], num_shards=shard[1])
        for got, want in zip(_batches(npy_dataset(path, 2, 8, **kw), 5),
                             _batches(jloaders.npy_dataset(path, 2, 8, **kw), 5)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(_batches(file_dataset(path, 2, 8, **kw)),
                             _batches(jloaders.file_dataset(path, 2, 8, **kw))):
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("start", [1, 7])
    @pytest.mark.parametrize("source", ["shapes", "gaussian", "folder", "npy_one", "npy_shards"])
    def test_start_is_the_stream_from_that_batch(self, files, source, start, monkeypatch):
        """`start=k` (a resumed run's data) is glom_tpu's stream with its
        first k batches dropped; the file loaders read no image of a
        skipped batch (7 crosses an epoch of the folder and the shards)."""
        import itertools

        from PIL import Image

        import glom_tpu_torch.data as port

        make = {
            "shapes": lambda m, **kw: m.shapes_dataset(2, 8, seed=4, **kw),
            "gaussian": lambda m, **kw: m.gaussian_dataset(2, 8, seed=4, **kw),
            "folder": lambda m, **kw: m.image_folder_dataset(
                str(files["root"] / "png"), 2, 8, seed=4, **kw),
            "npy_one": lambda m, **kw: m.npy_dataset(str(files["one"]), 2, 8, seed=4, **kw),
            "npy_shards": lambda m, **kw: m.npy_dataset(str(files["root"] / "shards"), 2, 8,
                                                        seed=4, **kw),
        }[source]
        jmod = jsynthetic if source in ("shapes", "gaussian") else jloaders
        want = [np.asarray(b, np.float32)
                for b in itertools.islice(make(jmod), start, start + 3)]
        opened = []
        real_open = Image.open
        monkeypatch.setattr(Image, "open", lambda *a, **kw: opened.append(a) or real_open(*a, **kw))
        got = _batches(make(port, start=start))
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
        assert len(opened) == (6 if source == "folder" else 0)

    def test_loader_errors(self, files, tmp_path):
        with pytest.raises(FileNotFoundError):
            next(image_folder_dataset(str(tmp_path), 2, 8))
        with pytest.raises(FileNotFoundError):
            file_dataset(str(tmp_path / "missing"), 2, 8)
        with pytest.raises(ValueError, match="config wants"):
            next(npy_dataset(str(files["one"]), 2, 16))
        with pytest.raises(ValueError, match="outside"):
            next(npy_dataset(str(files["root"] / "shards"), 2, 8, shard_index=3, num_shards=2))


# -- spans, the flight recorder, the metrics writer, step-time stats ---------------


class TestTracing:
    def test_span_records_match(self):
        ours, ref = ListWriter(), ListWriter()
        for mod, w in ((sys.modules[span.__module__], ours), (jspans, ref)):
            with mod.span("outer", writer=w):
                with mod.span("inner", writer=w, step=3):
                    pass
        assert [sorted(r) for r in ours.records] == [sorted(r) for r in ref.records]
        assert [(r["name"], r["depth"], r.get("parent")) for r in ours.records] == [
            ("inner", 1, "outer"), ("outer", 0, None)]

    def test_aggregator_and_annotate(self):
        agg = SpanAggregator()
        traced = spanned("host_step_dispatch", aggregator=agg, annotate=True)(lambda x: x + 1)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            assert traced(1) == 2 and traced(2) == 3
        assert any(e.name == "host_step_dispatch" for e in prof.events())
        (rec,) = agg.records(extra={"step": 1})
        assert rec["count"] == 2 and rec["kind"] == "span" and rec["step"] == 1
        assert schema.validate_record(rec) == []
        assert agg.records() == []

    def test_flight_recorder_dumps_storms_and_hooks(self, tmp_path):
        fr = flight.FlightRecorder(str(tmp_path), capacity=4, storm_threshold=2)
        flight.set_global_flight_recorder(fr)
        try:
            for i in range(5):
                flight.observe_event(schema.stamp({"step": i, "loss": 1.0}))
            assert fr.dumps == []
            flight.observe_event(schema.stamp({"step": 5, "reason": "x"}, kind="anomaly"))
            flight.observe_event(schema.stamp({"step": 6, "reason": "x"}, kind="anomaly"))
            assert len(fr.dumps) == 1  # the anomaly storm
            lines = [json.loads(ln) for ln in open(fr.dumps[0])]
            assert lines[0]["trigger"] == "anomaly-storm" and len(lines) == 5
            assert all(schema.validate_record(r) == [] for r in lines)
            assert flight.dump_flight_recorder("again") is None  # nothing new
            fr.set_checkpoint_hook(lambda: 7, deadline_s=5.0)
            fr._preemption_checkpoint()
            rec = list(fr._buf)[-1]
            assert (rec["kind"], rec["action"], rec["ok"], rec["step"]) == (
                "recovery", "preemption-checkpoint", True, 7)
        finally:
            flight.set_global_flight_recorder(None)

    def test_metrics_writer(self, tmp_path, monkeypatch):
        scalars = []

        class FakeSummaryWriter:  # torch.utils.tensorboard imports TensorFlow here
            def __init__(self, logdir):
                self.logdir = logdir

            def add_scalar(self, tag, value, step):
                scalars.append((tag, value, step))

            def close(self):
                scalars.append("closed")

        fake = type(sys)("torch.utils.tensorboard")
        fake.SummaryWriter = FakeSummaryWriter
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
        w = metrics.MetricsWriter(str(tmp_path / "m.jsonl"), echo=False,
                                  tensorboard_dir=str(tmp_path / "tb"))
        w.write({"step": 4, "loss": 0.5, "vjp_path": "scan_dense", "ok": True})
        w.write({"name": "host_data_next", "dur_s": 0.1})
        w.close()
        recs = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
        assert [r["kind"] for r in recs] == ["train_step", "span"]
        assert all(schema.validate_record(r) == [] for r in recs)
        assert sorted(scalars[:2]) == [("loss", 0.5, 4), ("wall_time", recs[0]["wall_time"], 4)]
        assert ("dur_s", 0.1, 5) in scalars and scalars[-1] == "closed"
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
        with pytest.raises(ImportError, match="tensorboard"):
            metrics.MetricsWriter(None, tensorboard_dir=str(tmp_path / "tb2"))

    def test_step_time_stats_match(self):
        ours, ref = StepTimeStats(max_samples=4), jsinks.StepTimeStats(max_samples=4)
        for i, dt in enumerate([0.5, 0.01, 0.03, 0.02, 0.05, 0.04, 0.01, 0.2]):
            for s in (ours, ref):  # the first implicitly, the fourth explicitly
                s.observe(dt, is_compile=True if i == 3 else None)
        assert ours.summary() == ref.summary()

    def test_timing_on_cpu(self):
        x = torch.ones(64)
        assert timing.best_fetch_time(lambda t: t.sum(), x, repeats=2) > 0
        assert timing.measure_rtt(x, repeats=2) > 0
        per = timing.calibrated_chain_time(
            lambda k: sum(x.sum() for _ in range(int(k))), x, repeats=1, calib_k=4,
            target_s=0.01, max_k=64)
        assert per > 0
        with pytest.raises(RuntimeError, match="non-finite"):
            timing.best_fetch_time(lambda t: t.sum() * math.inf, x, repeats=1)
        timer = StepTimer()
        timer.start()
        assert timer.stop(x.sum()) >= 0 and timer.best == timer.history[0]


# -- temporal rollouts -----------------------------------------------------------------


def _flatten_glom(params) -> dict:
    out = {}
    for name in params._fields:
        v = getattr(params, name)
        if hasattr(v, "_fields"):
            for sub in v._fields:
                out[f"{name}.{sub}"] = np.asarray(getattr(v, sub))
        else:
            out[name] = np.asarray(v)
    return out


class TestTemporal:
    KW = {"dim": 32, "levels": 3, "image_size": 16, "patch_size": 4}

    @pytest.fixture(scope="class")
    def reference(self):
        jcfg = jconfig.GlomConfig(**self.KW)
        jp = jcore.init_glom(jax.random.PRNGKey(0), jcfg)
        rng = np.random.default_rng(0)
        frames = rng.standard_normal((3, 2, 3, 16, 16)).astype(np.float32)
        lv0 = rng.standard_normal((2, 16, 3, 32)).astype(np.float32)
        w = rng.standard_normal((3, 2, 16, 3, 32)).astype(np.float32)

        def loss(lv):
            out = jtemporal.temporal_rollout(jp, jnp.asarray(frames), jcfg, iters=4,
                                             init_levels=lv)
            return jnp.sum(out * w), out

        (_, out), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(lv0))
        return dict(params=_flatten_glom(jp), frames=frames, lv0=lv0, w=w,
                    out=np.asarray(out), grad=np.asarray(g))

    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_rollout_matches(self, reference, use_pallas):
        r = reference
        params = params_from_numpy(r["params"], device="cpu")
        lv0 = torch.from_numpy(r["lv0"]).requires_grad_()
        out = temporal_rollout(params, torch.from_numpy(r["frames"]), GlomConfig(**self.KW),
                               iters=4, init_levels=lv0, use_pallas=use_pallas)
        assert out.shape == (3, 2, 16, 3, 32)
        np.testing.assert_allclose(out.detach().numpy(), r["out"], rtol=RTOL, atol=ATOL)
        (g,) = torch.autograd.grad((out * torch.from_numpy(r["w"])).sum(), lv0)
        np.testing.assert_allclose(g.numpy(), r["grad"], rtol=RTOL, atol=ATOL)

    def test_carry_is_detached(self, reference):
        r = reference
        params = params_from_numpy(r["params"], device="cpu")
        lv0 = torch.from_numpy(r["lv0"]).requires_grad_()
        cfg = GlomConfig(**self.KW)
        out = temporal_rollout(params, torch.from_numpy(r["frames"]), cfg, iters=2,
                               init_levels=lv0)
        (g,) = torch.autograd.grad(out[2].sum(), lv0, allow_unused=True)
        assert g is None or not g.abs().sum()
        kept = temporal_rollout(params, torch.from_numpy(r["frames"]), cfg, iters=2,
                                init_levels=lv0, detach_between_frames=False)
        (g,) = torch.autograd.grad(kept[2].sum(), lv0)
        assert g.abs().sum() > 0
        one = temporal_rollout(params, torch.from_numpy(r["frames"][:1]), cfg, iters=2)
        assert one.shape == (1, 2, 16, 3, 32)


# -- the trainer's record stream -------------------------------------------------------


class TestTrainerRecords:
    @pytest.mark.parametrize("tkw, log_every, timed", [
        ({"telemetry_level": "scalars", "nonfinite_policy": "skip"}, 2, [0, 2, 3]),
        ({"telemetry_level": "off"}, 1, [0, 1, 2, 3, 4]),  # one step variant
    ], ids=["scalars", "off"])
    def test_kinds_and_keys_match_glom_tpu(self, tkw, log_every, timed):
        """One NaN batch (nan_storm at batch 1) makes both loops emit an
        anomaly record under telemetry "scalars"; with log_every 2 its flag
        is held to the next log boundary."""
        tk = dict(batch_size=2, **tkw)
        ref, ours = ListWriter(), ListWriter()
        jt = jtrainer.Trainer(jconfig.GlomConfig(**TINY), jconfig.TrainConfig(**tk),
                              metrics_writer=ref)
        jt.fit(jnan_storm(jsynthetic.shapes_dataset(2, 8),
                          JFaultPlan(0).register("nan-storm", at=(1,))), 5, log_every=log_every)
        tt = Trainer(GlomConfig(**TINY), TrainConfig(**tk), metrics_writer=ours, device="cpu")
        hist = tt.fit(nan_storm(shapes_dataset(2, 8), FaultPlan(0).register("nan-storm", at=(1,))),
                      5, log_every=log_every)
        shape = lambda recs: [(r["kind"], r.get("name"), sorted(r)) for r in recs]
        assert shape(ours.records) == shape(ref.records)
        kinds = [r["kind"] for r in ours.records]
        assert ("anomaly" in kinds) == (tkw["telemetry_level"] == "scalars")
        assert all(schema.validate_record(r) == [] for r in ours.records)
        assert hist == [r for r in ours.records if r["kind"] == "train_step"]
        assert [r["steps_timed"] for r in hist] == timed

    def test_exception_dumps_the_flight_recorder(self, tmp_path):
        fr = flight.FlightRecorder(str(tmp_path))
        flight.set_global_flight_recorder(fr)

        def broken():
            yield np.zeros((2, 3, 8, 8), np.float32)
            raise OSError("disk gone")

        try:
            tt = Trainer(GlomConfig(**TINY), TrainConfig(batch_size=2), device="cpu")
            with pytest.raises(OSError):
                tt.fit(broken(), 3, log_every=1)
        finally:
            flight.set_global_flight_recorder(None)
        (path,) = fr.dumps
        header = json.loads(open(path).readline())
        assert header["trigger"] == "fit-loop-exception" and header["at_iteration"] == 1
