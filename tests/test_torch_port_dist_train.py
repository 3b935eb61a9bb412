"""The port's DistributedTrainer against glom_tpu's, on the CPU over gloo.

Ranks are spawned from tests/torch_dist_ranks.py (a file store in
tmp_path), two per module fixture call at world 2 and one at world 4, each
running every case of its world in one process group. glom_tpu runs the
same mesh shape on its 8-device virtual mesh (tests/conftest.py). Both
start from glom_tpu's initial parameters (its DistributedTrainer's init
key, carried across with params_from_numpy), train on the same seeded
shapes batches, and use noise_std 0, so no random draw differs between
the packages. Losses are held at rtol 5e-4 and parameters after 3 Adam
steps at rtol 2e-3 / atol 1e-5 (tests/test_torch_port_train.py's bars).
The four glom_tpu cases mirrored by name: test_dp_matches_single_device,
test_tp_matches_single_device[hidden|levels],
test_dp_sp_matches_single_device[ring|ulysses|halo] and
test_manual_zero2_accum_matches. tp_axis="levels" runs at model 2 and at
data 2 x model 2 against glom_tpu's GSPMD levels trainer, and with
use_pallas (the kernels' plain versions on the CPU, through the same
Functions) against glom_tpu's, which drops its kernels for this layout.
"""

import warnings

import jax
import numpy as np
import pytest

import torch_dist_ranks as ranks
from glom_tpu.data import shapes_dataset as jshapes
from glom_tpu.parallel import DistributedTrainer as JDistributedTrainer
from glom_tpu.train import trainer as jtrainer
from glom_tpu.utils import config as jconfig
from glom_tpu_torch.data import shapes_dataset
from glom_tpu_torch.models.transplant import params_from_numpy
from glom_tpu_torch.train import Trainer
from glom_tpu_torch.utils.checkpoint import CheckpointManager, named_leaves
from glom_tpu_torch.utils.config import GlomConfig, MeshConfig, TrainConfig

LOSS_RTOL = 5e-4
PARAM_RTOL, PARAM_ATOL = 2e-3, 1e-5
CFG_KW = dict(dim=16, levels=4, image_size=8, patch_size=2)  # glom_tpu's test_parallel CFG
HALO_KW = dict(CFG_KW, local_consensus_radius=1)
BASE = dict(batch_size=4, learning_rate=1e-3, noise_std=0.0, seed=5)
STEPS, DATA_SEED = 3, 3

# name: (mesh shape, sp, config kwargs, train kwargs[, tp_axis])
WORLD2 = {
    "dp": ((2, 1, 1), "none", CFG_KW, BASE),
    "tp": ((1, 1, 2), "none", CFG_KW, BASE),
    "tp_levels": ((1, 1, 2), "none", CFG_KW, BASE, "levels"),
    "tp_levels_pallas": ((1, 1, 2), "none", CFG_KW, dict(BASE, use_pallas=True), "levels"),
    "zero1": ((2, 1, 1), "none", CFG_KW,
              dict(BASE, zero_stage=1, use_pallas=True, telemetry_level="scalars")),
    "zero2_accum": ((2, 1, 1), "none", CFG_KW,
                    dict(BASE, batch_size=8, grad_accum=2, zero_stage=2, use_pallas=True,
                         telemetry_level="scalars")),
    "zero1_quantized": ((2, 1, 1), "none", CFG_KW,
                        dict(BASE, zero_stage=1, quantized_reduce=True, use_pallas=True,
                             telemetry_level="scalars")),
    "quantized_without_zero": ((2, 1, 1), "none", CFG_KW, dict(BASE, quantized_reduce=True)),
    # collective timing on zero1's run: a sample at every logging boundary
    "zero1_sampled": ((2, 1, 1), "none", CFG_KW,
                      dict(BASE, zero_stage=1, use_pallas=True, telemetry_level="scalars",
                           collective_timing="sampled", collective_timing_interval=1)),
    "zero1_full": ((2, 1, 1), "none", CFG_KW,
                   dict(BASE, zero_stage=1, use_pallas=True, telemetry_level="scalars",
                        collective_timing="full", collective_timing_interval=1)),
    "zero0_sampled": ((2, 1, 1), "none", CFG_KW, dict(BASE, collective_timing="sampled")),
}
TIMED = ("zero1_sampled", "zero1_full")
WORLD4 = {
    "dp_sp_ring": ((2, 2, 1), "ring", CFG_KW, BASE),
    "dp_sp_ulysses": ((2, 2, 1), "ulysses", CFG_KW, BASE),
    "dp_sp_halo": ((2, 2, 1), "halo", HALO_KW, BASE),
    "zero_on_tp": ((2, 1, 2), "none", CFG_KW, dict(BASE, zero_stage=1, telemetry_level="full")),
    "dp_tp_levels": ((2, 1, 2), "none", CFG_KW, BASE, "levels"),
}


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


def _init_arrays(cfg_kw, tcfg_kw) -> dict:
    """glom_tpu DistributedTrainer's initial parameters (its init key)."""
    _, init_key = jax.random.split(jax.random.PRNGKey(tcfg_kw["seed"]))
    state, _ = jtrainer.create_train_state(init_key, jconfig.GlomConfig(**cfg_kw),
                                           jconfig.TrainConfig(**tcfg_kw))
    return _flatten(state.params)


def _tp_axis(row) -> str:
    return row[4] if len(row) > 4 else "hidden"


def _cases(table):
    return [("trainer_run", dict(shape=row[0], sp=row[1], cfg_kw=row[2], tcfg_kw=row[3],
                                 arrays=_init_arrays(row[2], row[3]), steps=STEPS,
                                 data_seed=DATA_SEED, tp_axis=_tp_axis(row)))
            for row in table.values()]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every world-2 case and the checkpoint round trip in one spawn; the
    world-4 cases in another. {name: [rank results]}."""
    tmp = tmp_path_factory.mktemp("dist")
    tk = dict(BASE, batch_size=4, use_pallas=True)
    ckpt = ("checkpoint_roundtrip", dict(cfg_kw=CFG_KW, tcfg_kw=tk,
                                         arrays=_init_arrays(CFG_KW, tk),
                                         directory=str(tmp / "ckpt"), data_seed=DATA_SEED))
    res2 = ranks.run(2, _cases(WORLD2) + [ckpt], tmp)
    res4 = ranks.run(4, _cases(WORLD4), tmp)
    out = {name: [r[i] for r in res2] for i, name in enumerate(WORLD2)}
    out.update({name: [r[i] for r in res4] for i, name in enumerate(WORLD4)})
    out["checkpoint"] = [r[-1] for r in res2]
    out["checkpoint_dir"] = tmp / "ckpt"
    return out


def _jax_run(name, table):
    """glom_tpu's DistributedTrainer on the same mesh shape: (initial
    params, records, final params, static record)."""
    shape, sp, ck, tk = table[name][:4]
    with warnings.catch_warnings():
        # glom_tpu warns where use_pallas meets tp_axis="levels" (it drops
        # its kernels for that layout).
        warnings.simplefilter("ignore")
        jd = JDistributedTrainer(jconfig.GlomConfig(**ck), jconfig.TrainConfig(**tk),
                                 jconfig.MeshConfig(*shape), sp_strategy=sp,
                                 tp_axis=_tp_axis(table[name]))
    init = _flatten(jd.state.params)
    hist = jd.fit(jshapes(tk["batch_size"], ck["image_size"], seed=DATA_SEED), STEPS,
                  log_every=1)
    return init, hist, _flatten(jd.state.params), jd._static_record


def _port_params(res) -> dict:
    """The port's final global params under params_from_numpy's names."""
    return {name.replace("glom.", "", 1): v for name, v in res["params"].items()}


def _assert_matches(port_res, name, table):
    init, jhist, jparams, jstatic = _jax_run(name, table)
    arrays = _init_arrays(table[name][2], table[name][3])
    for k, v in init.items():  # both packages start from the same weights
        np.testing.assert_array_equal(v, arrays[k])
    for rank_res in port_res:  # every rank holds the same global state
        np.testing.assert_allclose([r["loss"] for r in rank_res["records"]],
                                   [float(r["loss"]) for r in jhist], rtol=LOSS_RTOL)
        got = _port_params(rank_res)
        for k, v in jparams.items():
            np.testing.assert_allclose(got[k], v, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
    return jhist, jstatic


class TestDistributedTrainer:
    def test_dp_matches_single_device(self, port):
        jhist, jstatic = _assert_matches(port["dp"], "dp", WORLD2)
        rec = port["dp"][0]["records"][-1]
        for key in ("params_bytes_per_replica", "grads_bytes_per_replica",
                    "comm_reduce_bytes_per_step", "comm_gather_bytes_per_step",
                    "comm_bytes_per_step", "zero_stage", "quantized_reduce", "grad_accum"):
            assert rec[key] == jstatic.get(key, jhist[-1].get(key)), key
        assert rec["vjp_path"] == "scan_dense" and rec["sp_strategy"] == "none"

    @pytest.mark.parametrize("tp_axis", ["hidden", "levels"])
    def test_tp_matches_single_device(self, port, tp_axis):
        name = "tp" if tp_axis == "hidden" else "tp_levels"
        jhist, jstatic = _assert_matches(port[name], name, WORLD2)
        # the port runs the manual per-rank step; glom_tpu's GSPMD one here,
        # with the same static record
        rec = port[name][0]["records"][-1]
        for key in ("params_bytes_per_replica", "grads_bytes_per_replica",
                    "comm_reduce_bytes_per_step", "comm_gather_bytes_per_step",
                    "comm_bytes_per_step", "zero_stage"):
            assert rec[key] == jstatic.get(key, jhist[-1].get(key)), key
        assert rec["comm_bytes_per_step"] == 0

    @pytest.mark.parametrize("name", ["tp_levels_pallas", "dp_tp_levels"])
    def test_tp_levels_matches_glom_tpu(self, port, name):
        """Levels TP with the kernels' Functions, and at data 2 x model 2,
        against glom_tpu's levels trainer (GSPMD, without its kernels)."""
        table = WORLD2 if name in WORLD2 else WORLD4
        _assert_matches(port[name], name, table)

    def test_tp_levels_runs_k1_on_its_groups(self, port):
        """use_pallas with tp_axis="levels": every model rank calls the K1
        Function on its L/2 = 2 bottom_up groups at full f, and on top_down's
        L-1 = 3 groups at f/2 with the addend, once each an iteration; the
        group gathers (forward and backward) count at one site. No warning:
        nothing falls back."""
        cfg = GlomConfig(**CFG_KW)
        k = cfg.default_iters // 2 + 1
        f = cfg.dim * cfg.mult
        for rank_res in port["tp_levels_pallas"]:
            calls = rank_res["k1_calls"]
            assert len(calls) == 2 * k * STEPS
            assert calls[:2] == [(2, f, False), (3, f // 2, True)]
            assert sorted(set(calls)) == [(2, f, False), (3, f // 2, True)]
            (site,) = [s for s in rank_res["sites"] if s["site"] == "tp_levels_all_gather"]
            assert site["calls"] == 2 * k * STEPS and site["dim"] == 0
            # one shard [L/2, b, n, d] f32 into each rank a gather
            assert site["wire_bytes"] == 2 * 4 * cfg.num_patches * cfg.dim * 4
            assert not [w for w in rank_res["warnings"] if "levels" in w]

    def test_tp_levels_refuses_indivisible_levels(self):
        from glom_tpu_torch.parallel import DistributedTrainer

        with pytest.raises(ValueError, match="levels 3 not divisible by model axis 2"):
            DistributedTrainer(GlomConfig(**dict(CFG_KW, levels=3)), TrainConfig(**BASE),
                               MeshConfig(model=2), tp_axis="levels", devices=["cpu"] * 2)

    @pytest.mark.parametrize("strategy", ["ring", "ulysses", "halo"])
    def test_dp_sp_matches_single_device(self, port, strategy):
        name = f"dp_sp_{strategy}"
        _assert_matches(port[name], name, WORLD4)
        for rank_res in port[name]:
            assert rank_res["sp_strategy"] == strategy
            assert rank_res["vjp_path"] == "scan_sharded"

    def test_bad_batch_divisibility_raises(self):
        from glom_tpu_torch.parallel import DistributedTrainer

        with pytest.raises(ValueError, match="divisible"):
            DistributedTrainer(GlomConfig(**CFG_KW), TrainConfig(batch_size=3),
                               MeshConfig(data=2), devices=["cpu"] * 2)


class TestZero:
    def test_manual_zero1_matches(self, port):
        _assert_matches(port["zero1"], "zero1", WORLD2)

    def test_manual_zero2_accum_matches(self, port):
        _assert_matches(port["zero2_accum"], "zero2_accum", WORLD2)
        assert port["zero2_accum"][0]["records"][-1]["grad_accum"] == 2

    def test_quantized_zero_matches(self, port):
        jhist, _ = _assert_matches(port["zero1_quantized"], "zero1_quantized", WORLD2)
        for got, want in zip(port["zero1_quantized"][0]["records"], jhist):
            assert got["quantized_reduce"] is True
            np.testing.assert_allclose(got["quant_rel_err"], float(want["quant_rel_err"]),
                                       rtol=2e-2)

    @pytest.mark.parametrize("name", ["zero1", "zero2_accum", "zero1_quantized"])
    def test_measured_counters_equal_glom_tpus_trace(self, port, name):
        """The counters of the port's first real ZeRO step equal glom_tpu's
        counting trace of its step; the model and the drift too."""
        shape, sp, ck, tk = WORLD2[name]
        jd = JDistributedTrainer(jconfig.GlomConfig(**ck), jconfig.TrainConfig(**tk),
                                 jconfig.MeshConfig(*shape), sp_strategy=sp)
        for rank_res in port[name]:
            rec = rank_res["records"][0]
            for key, want in jd._static_record.items():
                if key.startswith("comm_"):
                    assert rec[key] == want, key
            assert rank_res["records"][-1]["comm_measured_bytes_per_step"] == (
                rec["comm_measured_bytes_per_step"])

    def test_optimizer_state_is_sharded(self, port):
        """Each rank holds its 1/dp of every shardable leaf's moments: the
        bytes read from the tensors equal the live-bytes model's."""
        full = port["dp"][0]["opt_bytes"]
        for name in ("zero1", "zero2_accum"):
            for rank_res in port[name]:
                rec = rank_res["records"][-1]
                assert rank_res["opt_bytes"] == rec["opt_bytes_per_replica"]
                assert rank_res["opt_bytes"] < 0.6 * full
        assert port["dp"][0]["records"][-1]["opt_bytes_per_replica"] == full

    def test_loud_degradations(self, port):
        """glom_tpu's degradations at the same points, the resolved values
        stamped: ZeRO on a model-sharded mesh runs stage 0, the quantized
        reduce without ZeRO runs exact, telemetry "full" runs "scalars"."""
        rec = port["zero_on_tp"][0]["records"][-1]
        assert rec["zero_stage"] == 0 and rec["telemetry_level"] == "scalars"
        msgs = " ".join(port["zero_on_tp"][0]["warnings"])
        assert "model == 1" in msgs and "scalars" in msgs
        rec = port["quantized_without_zero"][0]["records"][-1]
        assert rec["quantized_reduce"] is False
        assert "exact f32" in " ".join(port["quantized_without_zero"][0]["warnings"])
        np.testing.assert_allclose([r["loss"] for r in port["quantized_without_zero"][0]
                                    ["records"]],
                                   [r["loss"] for r in port["dp"][0]["records"]], rtol=1e-6)


def _glom_tpu_trainer(name):
    """glom_tpu's DistributedTrainer for a WORLD2 case and the warnings its
    construction raised."""
    shape, sp, ck, tk = WORLD2[name]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jd = JDistributedTrainer(jconfig.GlomConfig(**ck), jconfig.TrainConfig(**tk),
                                 jconfig.MeshConfig(*shape), sp_strategy=sp)
    return jd, [str(w.message) for w in caught]


class TestCollectiveTiming:
    @pytest.mark.parametrize("name", TIMED)
    def test_timing_leaves_every_loss_and_param_bit_for_bit(self, port, name):
        for got, want in zip(port[name], port["zero1"]):
            assert [r["loss"] for r in got["records"]] == [r["loss"] for r in want["records"]]
            for k, v in want["params"].items():
                np.testing.assert_array_equal(got["params"][k], v, err_msg=k)

    @pytest.mark.parametrize("name", TIMED)
    def test_records_price_the_counted_sites(self, port, name):
        """A sample at each logging boundary (interval 1): one row a site
        and one comm_time_model row, written by the writer rank only; each
        row's wire bytes are its site's counted bytes, so the rows' bytes x
        calls sum to the step's counted bytes."""
        lead, other = port[name]
        assert other["collective_time"] == []
        rows = lead["collective_time"]
        models = [i for i, r in enumerate(rows) if r["site"] == "comm_time_model"]
        assert len(models) == STEPS
        first = rows[:models[0]]
        rec = lead["records"][0]
        assert rec["collective_timing"] == "sampled"
        assert sum(r["wire_bytes"] * r["calls"] for r in first) == (
            rec["comm_measured_bytes_per_step"])
        counted = {(s["site"], s["wire_bytes"]) for s in lead["sites"]}
        assert {(r["site"], r["wire_bytes"]) for r in first} == counted
        assert all(r["mode"] == "sampled" and r["path"] == "train-zero1" and r["wall_ms"] > 0
                   for r in rows)
        assert rows[models[0]]["n_points"] == len(first)

    def test_sites_equal_glom_tpus_sampler(self, port):
        jd, _ = _glom_tpu_trainer("zero1_sampled")
        key = lambda s: (s["site"], s["axis"], s["collective"], s["wire_bytes"], s["calls"])  # noqa: E731
        rows = port["zero1_sampled"][0]["collective_time"]
        first = rows[:[r["site"] for r in rows].index("comm_time_model")]
        assert sorted(map(key, first)) == sorted(map(key, jd.collective_sampler.sites))

    def test_degradations_warn_glom_tpus_words(self, port):
        """"full" runs "sampled" on the trainer and a route without the
        ZeRO step's sites runs "off", each with glom_tpu's warning; "off"
        writes no record."""
        for name, want in (("zero1_full", "sampled"), ("zero0_sampled", "off")):
            _, jwarn = _glom_tpu_trainer(name)
            (msg,) = [w for w in jwarn if "collective_timing" in w]
            for rank_res in port[name]:
                assert msg in rank_res["warnings"]
                assert all(r["collective_timing"] == want for r in rank_res["records"])
        assert port["zero0_sampled"][0]["collective_time"] == []


class TestCheckpoints:
    def test_restores_across_zero_stages(self, port):
        """Saved at stage 2 on dp 2, restored at stage 0 and at stage 1: the
        next step equals the uninterrupted stage-2 run's."""
        for rank_res in port["checkpoint"]:
            for stage in ("stage0", "stage1"):
                got = rank_res[stage]
                assert (got["step"], got["after"]) == (2, 3)
                np.testing.assert_allclose(got["loss"], rank_res["want_loss"], rtol=1e-6)
                for k, v in rank_res["want_params"].items():
                    np.testing.assert_allclose(got["params"][k], v, rtol=1e-5, atol=1e-7)

    def test_restores_into_the_single_device_trainer(self, port):
        """The distributed checkpoint is the global state in the
        single-device layout: a Trainer restores it and takes the same
        next step."""
        res = port["checkpoint"][0]
        tk = dict(BASE, batch_size=4, use_pallas=True)
        tr = Trainer(GlomConfig(**CFG_KW), TrainConfig(**tk),
                     params=params_from_numpy(_init_arrays(CFG_KW, tk)), device="cpu")
        step, tr.state = CheckpointManager(port["checkpoint_dir"]).restore(
            2, state=tr.state, generator=tr.generator)
        batch = list(shapes_dataset(4, CFG_KW["image_size"], seed=DATA_SEED, num_batches=3))[2]
        m = tr.step(batch)
        assert step == 2 and tr.state.step == 3
        np.testing.assert_allclose(float(m["loss"]), res["want_loss"], rtol=1e-5)
        for name, t in named_leaves(tr.state.params):
            np.testing.assert_allclose(t.detach().numpy(), res["want_params"][name],
                                       rtol=1e-4, atol=1e-6)


def test_single_device_step_resolves_zero_and_quantized():
    """One device: zero_stage resolves to 0 and the quantized reduce off,
    as glom_tpu's Trainer resolves them; the records say so."""
    cfg = GlomConfig(**CFG_KW)
    kw = dict(BASE, batch_size=2)
    plain = Trainer(cfg, TrainConfig(**kw), device="cpu")
    asked = Trainer(cfg, TrainConfig(**kw, zero_stage=2, quantized_reduce=True), device="cpu")
    jasked = jtrainer.Trainer(jconfig.GlomConfig(**CFG_KW),
                              jconfig.TrainConfig(**kw, zero_stage=2, quantized_reduce=True))
    batch = next(shapes_dataset(2, cfg.image_size, seed=1))
    a, b = plain.step(batch), asked.step(batch)
    assert float(a["loss"]) == float(b["loss"])
    assert (b["zero_stage"], b["quantized_reduce"]) == (jasked.zero_stage,
                                                         jasked.quantized_reduce) == (0, False)


def test_a_failing_rank_fails_the_call(tmp_path):
    """A rank's exception reaches the caller with its traceback."""
    with pytest.raises(AssertionError, match="rank 1 fails on purpose"):
        ranks.run(2, [("fail_on", {"rank_to_fail": 1})], tmp_path, timeout=120)
