"""The port's parallel package against glom_tpu's, on the CPU.

The rank mesh, the sharding specs, the quantized reduce, the collective
counters and byte models, the SP strategy policy, and the per-rank bodies
over gloo ranks (spawned from tests/torch_dist_ranks.py, a file store in
tmp_path): the ring, Ulysses and halo shard bodies and make_consensus_fn
against glom_tpu's on its 8-device virtual mesh (tests/conftest.py) and
their gradients against autograd of the dense consensus; each
differentiable collective's backward against its transpose; and
make_manual_loss on each mesh shape against glom_tpu's make_manual_loss,
with glom_tpu's weights (params_from_numpy) and numpy-seeded images and
noise, loss at rtol 5e-4 and gradients at rtol 2e-3 / atol 1e-5 (as
tests/test_torch_port_train.py holds the single-device trainer).
"""

import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from glom_tpu.parallel import manual as jmanual
from glom_tpu.parallel import mesh as jmesh
from glom_tpu.parallel import quantized as jquant
from glom_tpu.parallel import runtime as jruntime
from glom_tpu.parallel import sharding as jsharding
from glom_tpu.parallel.halo import make_halo_consensus as j_halo
from glom_tpu.parallel.ring import make_ring_consensus as j_ring
from glom_tpu.parallel.ulysses import make_ulysses_consensus as j_ulysses
from glom_tpu.telemetry import counters as jcounters
from glom_tpu.train import objectives as jobj
from glom_tpu.utils import config as jconfig
from glom_tpu.utils import metrics as jmetrics
from glom_tpu_torch.ops.consensus import consensus_attention
from glom_tpu_torch.parallel import mesh, quantized, runtime, sharding
from glom_tpu_torch.telemetry import counters
from glom_tpu_torch.utils import metrics
from glom_tpu_torch.utils.config import GlomConfig

LOSS_RTOL = 5e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5
CFG_KW = dict(dim=16, levels=4, image_size=8, patch_size=2)  # n = 16, side 4
HALO_KW = dict(CFG_KW, image_size=16, local_consensus_radius=2)  # side 8


def _spec_tuple(spec):
    return tuple(spec)


def _jax_specs(tree) -> dict:
    """glom_tpu's PartitionSpec tree -> {dotted name: tuple}."""
    out = {}
    for field in tree._fields:
        sub = getattr(tree, field)
        if hasattr(sub, "_fields"):
            for k, v in _jax_specs(sub).items():
                out[f"{field}.{k}"] = v
        else:
            out[field] = _spec_tuple(sub)
    return out


def _flatten(params) -> dict:
    """glom_tpu DenoiseParams -> params_from_numpy's {name: array}."""
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


def _jmesh(shape):
    return jmesh.make_mesh(jconfig.MeshConfig(*shape), jax.devices()[: int(np.prod(shape))])


# -- the rank mesh -------------------------------------------------------------


class TestMesh:
    def test_layout_over_ranks(self, tmp_path):
        """(data, seq, model) row-major over the ranks, glom_tpu's names; a
        two-slice mesh keeps the same slice-major layout; this rank's index
        along every axis."""
        res = ranks.run(4, [("mesh_facts", {"shape": (2, 2, 1)}),
                            ("mesh_facts", {"shape": (4, 1, 1), "num_slices": 2})], tmp_path)
        for r, (dss, hybrid) in enumerate(res):
            want = np.asarray(_jmesh((2, 2, 1)).devices)
            ids = np.vectorize(lambda d: d.id)(want).tolist()
            assert dss["names"] == list(jconfig.MeshConfig().axis_names)
            assert dss["ranks"] == ids  # glom_tpu's device ids, as rank numbers
            assert dss["rank"] == r and dss["device"] == "cpu" and dss["backend"] == "gloo"
            assert dss["index"] == {"data": r // 2, "seq": r % 2, "model": 0}
            assert dss["size"] == {"data": 2, "seq": 2, "model": 1}
            assert hybrid["ranks"] == [[[0]], [[1]], [[2]], [[3]]]

    def test_replica_device_groups_matches(self):
        for devices, per in ((list(range(8)), 2), (list(range(7)), 3), (list(range(4)), 4)):
            assert mesh.replica_device_groups(devices, per) == jmesh.replica_device_groups(
                devices, per)
        for devices, per in ((list(range(2)), 3), (list(range(4)), 0)):
            with pytest.raises(ValueError):
                jmesh.replica_device_groups(devices, per)
            with pytest.raises(ValueError):
                mesh.replica_device_groups(devices, per)

    def test_device_rule(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="LOCAL_RANK"):
            mesh.rank_device(rank=0)
        assert mesh.rank_device(["cpu", "cpu"], rank=1) == torch.device("cpu")
        with pytest.raises(ValueError, match="no device"):
            mesh.rank_device(["cpu"], rank=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.rank_device(["cuda:0"], rank=0)
        assert mesh.default_backend("cpu") == "gloo"
        assert mesh.default_backend("cuda:0") == "nccl"

    def test_initialize_without_rendezvous(self, monkeypatch):
        for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
        assert mesh.initialize_multihost(device="cpu") is False
        with pytest.raises(ValueError, match="backend"):
            mesh.initialize_multihost(init_method="file:///nonexistent/x", num_processes=1,
                                      process_id=0, device="cpu", backend="mpi")
        with pytest.raises(ValueError, match="CUDA"):
            mesh.initialize_multihost(init_method="file:///nonexistent/x", num_processes=1,
                                      process_id=0, device="cpu", backend="nccl")
        with pytest.raises(RuntimeError, match="process group"):
            mesh.make_mesh(jconfig.MeshConfig(), devices=["cpu"])


# -- specs -------------------------------------------------------------------


class TestSharding:
    @pytest.mark.parametrize("tp_axis", ["hidden", "levels"])
    def test_specs_match(self, tp_axis):
        assert {k: _spec_tuple(v) for k, v in
                jsharding.ffw_specs(tp_axis)._asdict().items()} == sharding.ffw_specs(
            tp_axis)._asdict()
        assert _jax_specs(jsharding.glom_param_specs(tp_axis)) == sharding.glom_param_specs(
            tp_axis)
        assert _jax_specs(jsharding.denoise_param_specs(tp_axis)) == (
            sharding.denoise_param_specs(tp_axis))
        assert _spec_tuple(jsharding.batch_spec()) == sharding.batch_spec()
        assert _spec_tuple(jsharding.levels_spec()) == sharding.levels_spec()
        with pytest.raises(ValueError, match="tp_axis"):
            sharding.ffw_specs("dim")

    def test_zero_shard_axis_matches(self):
        cases = [((6, 512, 2048), (None, None, "model"), 2), ((5, 2048), (None, "model"), 2),
                 ((5, 2048), (None, None), 4), ((588,), (None,), 8), ((3, 7), (None, None), 2),
                 ((4, 16), (None, None), 1), ((12, 16), (None, None), 4)]
        for shape, base, dp in cases:
            from jax.sharding import PartitionSpec as P

            assert sharding.zero_shard_axis(shape, base, dp) == jsharding.zero_shard_axis(
                shape, P(*base), dp), (shape, base, dp)

    @pytest.mark.parametrize("dp", [2, 4, 8])
    def test_zero_param_specs_match(self, dp):
        jcfg = jconfig.GlomConfig(**CFG_KW)
        jp = jobj.init_denoise(jax.random.PRNGKey(0), jcfg)
        from glom_tpu_torch.models.transplant import params_from_numpy

        tp = params_from_numpy(_flatten(jp))
        want = _jax_specs(jsharding.zero_param_specs(jp, dp))
        got = sharding.zero_param_specs(tp, dp)
        assert got == want
        assert sharding.opt_state_specs(got)["glom.pos_emb"] == {
            "exp_avg": got["glom.pos_emb"], "exp_avg_sq": got["glom.pos_emb"], "step": ()}

    def test_shard_leaf(self):
        t = torch.arange(2 * 4 * 6).reshape(2, 4, 6)
        got = sharding.shard_leaf(t, (None, "data", "model"), {"data": (1, 2), "model": (2, 3)})
        assert torch.equal(got, t[:, 2:4, 4:6])
        with pytest.raises(ValueError, match="split"):
            sharding.shard_leaf(t, ("data",), {"data": (0, 3)})
        assert sharding.spec_axis(("data", None), "data") == 0
        assert sharding.spec_axis((None, None), "data") == -1


# -- the quantized reduce ------------------------------------------------------


class TestQuantized:
    @pytest.mark.parametrize("shape", [(300,), (4, 128), (3, 5, 7)])
    def test_matches_glom_tpu(self, shape):
        x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
        x.reshape(-1)[:128] = 0.0  # an all-zero block: scale 1, exact
        q, s, pad = quantized.block_quantize_int8(torch.from_numpy(x))
        jq, js, jpad = jquant.block_quantize_int8(jnp.asarray(x))
        assert pad == jpad
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        got = quantized.quantize_dequantize(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jquant.quantize_dequantize(jnp.asarray(x))))
        blocks = np.pad(x.reshape(-1), (0, pad)).reshape(-1, quantized.DEFAULT_BLOCK)
        bound = np.abs(blocks).max(axis=1, keepdims=True) / (2 * 127) + 1e-7
        err = np.abs(np.pad(got.reshape(-1), (0, pad)).reshape(blocks.shape) - blocks)
        assert (err <= bound).all()
        assert np.all(got.reshape(-1)[:128] == 0.0)

    def test_wire_bytes(self):
        for n in (1, 127, 128, 129, 1000, 301056):
            assert quantized.quantized_wire_bytes(n) == jquant.quantized_wire_bytes(n)


# -- counters and byte models ----------------------------------------------------


class TestCountersAndModels:
    def test_wire_formulas_match(self):
        for shape, dtype in (((6, 512, 2048), torch.float32), ((5,), torch.float32),
                             ((7, 3), torch.bfloat16)):
            x = torch.empty(shape, dtype=dtype, device="meta")
            jx = jax.ShapeDtypeStruct(shape, jnp.float32 if dtype == torch.float32
                                      else jnp.bfloat16)
            for k in (1, 2, 3, 8):
                assert counters.ring_allreduce_bytes(x, k) == jcounters.ring_allreduce_bytes(jx, k)
                assert counters.ring_all_gather_bytes(x, k) == jcounters.ring_all_gather_bytes(
                    jx, k)
                for q in (False, True):
                    assert counters.ring_reduce_scatter_bytes(x, k, quantized=q) == (
                        jcounters.ring_reduce_scatter_bytes(jx, k, quantized=q))

    @pytest.mark.parametrize("stage", [0, 1, 2])
    def test_comm_volume_model_matches(self, stage):
        for g, p, dp, q, a in ((62512, 62512, 2, False, 1), (95_000_000, 95_000_000, 8, True, 2),
                               (1000, 2000, 1, False, 4), (777, 777, 3, True, 3)):
            assert metrics.comm_volume_model(g, p, dp, stage, quantized=q, grad_accum=a) == (
                jmetrics.comm_volume_model(g, p, dp, stage, quantized=q, grad_accum=a))

    def test_tree_bytes_per_replica_matches(self):
        jcfg = jconfig.GlomConfig(**CFG_KW)
        jp = jobj.init_denoise(jax.random.PRNGKey(0), jcfg)
        from glom_tpu_torch.models.transplant import params_from_numpy
        from glom_tpu_torch.utils.checkpoint import named_leaves

        tp = params_from_numpy(_flatten(jp))
        tree = {n: t for n, t in named_leaves(tp)}
        for dp, mp in ((1, 1), (2, 1), (2, 2), (4, 2)):
            sizes = {"data": dp, "seq": 1, "model": mp}
            for jspec, spec in ((jsharding.denoise_param_specs("hidden"),
                                 sharding.denoise_param_specs("hidden")),
                                (jsharding.zero_param_specs(jp, dp),
                                 sharding.zero_param_specs(tp, dp))):
                assert metrics.tree_bytes_per_replica(tree, spec, sizes) == (
                    jmetrics.tree_bytes_per_replica(jp, jspec, sizes))
        assert metrics.tree_bytes_per_replica(tree, None, {"data": 4}) == metrics.tree_bytes(tree)

    def test_comm_drift_matches(self):
        for meas, model in ((100, 100), (110, 100), (5, 0), (0, 0)):
            m = {"comm_measured_bytes_per_step": meas}
            d = {"comm_bytes_per_step": model}
            assert counters.comm_drift(m, d) == jcounters.comm_drift(m, d)

    def test_recording_and_scaling(self):
        c = counters.CollectiveCounters()
        x = torch.empty((4, 8), device="meta")
        counters.timed_collective("s", "data", "reduce", 64, lambda t: t, x, collective="psum")
        with counters.recording(c):
            counters.timed_collective("s", "data", "reduce", 64, lambda t: t, x,
                                      collective="psum")
            with counters.scaled(3):
                counters.timed_collective("g", "data", "gather", 10, lambda t: t, x,
                                          collective="all_gather", dim=1)
            counters.timed_collective("s", "data", "reduce", 64, lambda t: t, x,
                                      collective="psum")
        assert c.totals() == {"comm_measured_reduce_bytes_per_step": 128,
                              "comm_measured_gather_bytes_per_step": 30,
                              "comm_measured_bytes_per_step": 158,
                              "comm_measured_collective_count": 3}
        assert [(s["site"], s["calls"], s["dim"]) for s in c.sites] == [("s", 2, 0), ("g", 3, 1)]

    def test_collective_timing_stays_refused(self):
        """The timed modes are ported (telemetry/comm_time.py): every mode
        resolves as glom_tpu's, "full" degrades to "sampled" with a warning
        where the path does not bracket executions, and an unknown mode is
        still refused."""
        for mode in ("off", "sampled", "full"):
            assert counters.resolve_collective_timing(mode) == mode
            assert jcounters.resolve_collective_timing(mode) == mode
        with pytest.warns(UserWarning, match="running 'sampled'"):
            assert counters.resolve_collective_timing("full", supports_full=False) == "sampled"
        with pytest.raises(ValueError):
            counters.resolve_collective_timing("always")


# -- the SP strategy policy ----------------------------------------------------------


class TestStrategy:
    def test_crossover_rows_agree(self):
        table = Path(__file__).parent.parent / "results" / "sp_crossover.jsonl"
        rows = [json.loads(x) for x in table.read_text().splitlines() if x]
        assert rows
        for r in rows:
            assert runtime.ulysses_preferred(r["n"]) == jruntime.ulysses_preferred(r["n"])
        for n in (256, 1024, 2048, 4096):
            assert runtime.ulysses_preferred(n) == jruntime.ulysses_preferred(n)

    def test_selector_matches(self):
        configs = [dict(dim=64, levels=8, image_size=64, patch_size=4),
                   dict(dim=64, levels=8, image_size=256, patch_size=4),
                   dict(dim=64, levels=8, image_size=128, patch_size=4, local_consensus_radius=7),
                   dict(dim=64, levels=5, image_size=64, patch_size=4),
                   dict(dim=512, levels=6, image_size=224, patch_size=14),
                   dict(dim=512, levels=6, image_size=256, patch_size=8, local_consensus_radius=7)]
        for kw in configs:
            for seq in (1, 2, 4, 8):
                assert runtime.select_sp_strategy(GlomConfig(**kw), seq) == (
                    jruntime.select_sp_strategy(jconfig.GlomConfig(**kw), seq)), (kw, seq)

    def test_effective_fallbacks_match(self):
        kw = dict(dim=16, levels=5, image_size=8, patch_size=2, local_consensus_radius=3)
        cfg, jcfg = GlomConfig(**kw), jconfig.GlomConfig(**kw)
        for seq, strategy in ((2, "halo"), (2, "ulysses"), (2, "ring"), (1, "ring"),
                              (2, "auto"), (4, "none")):
            with warnings.catch_warnings(record=True) as ours:
                warnings.simplefilter("always")
                got = runtime.effective_sp_strategy(cfg, seq, strategy)
            with warnings.catch_warnings(record=True) as theirs:
                warnings.simplefilter("always")
                want = jruntime.effective_sp_strategy(jcfg, seq, strategy)
            assert got == want and len(ours) == len(theirs), (seq, strategy)
        with pytest.raises(ValueError, match="unknown SP strategy"):
            runtime.effective_sp_strategy(cfg, 2, "mystery")


# -- the per-rank bodies over gloo ranks ---------------------------------------------


def _levels(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _dense_out_and_grad(levels, weights, **kw):
    x = torch.from_numpy(levels).clone().requires_grad_()
    out = consensus_attention(x, **kw)
    (dx,) = torch.autograd.grad((out * torch.from_numpy(weights)).sum(), x)
    return out.detach().numpy(), dx.numpy()


# (strategy, seq, attend_self, side, radius); levels [2, n, L, d]
SP_CASES = [
    ("ring", 2, False, 4, 0.0), ("ring", 2, True, 4, 1.5), ("ulysses", 2, False, 4, 0.0),
    ("ulysses", 2, False, 4, 1.0), ("halo", 2, False, 8, 2.0), ("halo", 2, True, 8, 0.5),
]
SP4_CASES = [("ring", 4, False, 8, 0.0), ("ulysses", 4, False, 8, 2.0), ("halo", 4, False, 8, 2.0)]


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """Every world-2 and world-4 body case in one spawn each."""
    tmp = tmp_path_factory.mktemp("sp")
    inputs = {}
    for case in SP_CASES + SP4_CASES:
        strategy, seq, attend_self, side, radius = case
        inputs[case] = (_levels((2, side * side, 4, 8), seed=len(inputs)),
                        _levels((2, side * side, 4, 8), seed=100 + len(inputs)))

    def cases(group):
        return [("sp_bodies", dict(seq=c[1], strategy=c[0], levels=inputs[c][0],
                                   weights=inputs[c][1], attend_self=c[2], side=c[3],
                                   radius=c[4])) for c in group]

    cfg4 = dict(CFG_KW, levels=4)
    world2 = cases(SP_CASES) + [
        ("consensus_fns", dict(seq=2, cfg_kw=cfg4, strategy=s, levels=inputs[SP_CASES[0]][0]))
        for s in ("ring", "ulysses", "none")] + [
        ("collective_grads", dict(x=_levels((2, 4, 2, 3), seed=7)))]
    res2 = ranks.run(2, world2, tmp)
    res4 = ranks.run(4, cases(SP4_CASES), tmp)
    return inputs, res2, res4


@pytest.mark.parametrize("case", SP_CASES + SP4_CASES, ids=lambda c: f"{c[0]}-seq{c[1]}-"
                         f"{'self' if c[2] else 'noself'}-r{c[4]}")
def test_sp_body_matches_glom_tpu_and_dense_grads(sp_runs, case):
    """Each rank's band of the shard body equals glom_tpu's shard_map on the
    virtual mesh (the same seq size); the gathered gradient of
    sum(out * w) equals autograd of the dense consensus."""
    inputs, res2, res4 = sp_runs
    strategy, seq, attend_self, side, radius = case
    levels, weights = inputs[case]
    res = res2 if seq == 2 else res4
    idx = (SP_CASES if seq == 2 else SP4_CASES).index(case)
    out = np.concatenate([r[idx]["out"] for r in res], axis=1)
    dx = np.concatenate([r[idx]["dx"] for r in res], axis=1)
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:seq]), ("seq",))
    build = {"ring": j_ring, "ulysses": j_ulysses, "halo": j_halo}[strategy]
    jfn = build(jm, attend_self=attend_self, side=side, radius=radius)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(levels)))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    dense_out, dense_dx = _dense_out_and_grad(levels, weights, attend_self=attend_self,
                                              side=side, radius=radius)
    np.testing.assert_allclose(out, dense_out, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dx, dense_dx, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_consensus_fn_global_view(sp_runs):
    """make_consensus_fn's global view: every rank holds the whole dense
    answer; 'none' builds nothing."""
    inputs, res2, _ = sp_runs
    levels = inputs[SP_CASES[0]][0]
    base = len(SP_CASES)
    dense = consensus_attention(torch.from_numpy(levels)).numpy()
    for r in res2:
        for j in (0, 1):
            np.testing.assert_allclose(r[base + j], dense, rtol=1e-4, atol=1e-5)
        assert r[base + 2] is None


def test_collective_transposes(sp_runs):
    """Each differentiable collective's backward is its forward's transpose
    (world 2 over one axis): copy_to_model sums the gradients, the reduce
    passes them through, the all-to-all inverts, the halo exchange returns
    each halo's cotangent to its owner."""
    _, res2, _ = sp_runs
    outs = [r[-1] for r in res2]
    x = _levels((2, 4, 2, 3), seed=7)
    xs = [x * 1, x * 2]
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["copy"], np.full_like(x, 5.0))
        np.testing.assert_allclose(o["reduce_fwd"], xs[0] + xs[1], rtol=1e-6)
        np.testing.assert_allclose(o["reduce_bwd"], np.full_like(x, r + 2.0))
    # the all-to-all: gather n, scatter L; its backward is the inverse
    full = np.concatenate(xs, axis=1)  # [b, 2n_loc, L, d]
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["a2a_fwd"], full[:, :, r:r + 1], rtol=1e-6)
    w = [o["a2a_w"] for o in outs]
    for r, o in enumerate(outs):
        want = np.concatenate([w[j][:, r * 4:(r + 1) * 4] for j in (0, 1)], axis=2)
        np.testing.assert_allclose(o["a2a_bwd"], want, rtol=1e-6)
    # the halo: [top from r-1 | own | bottom from r+1], zeros past the edges
    for r, o in enumerate(outs):
        top = xs[r - 1][:, -1:] if r > 0 else np.zeros_like(x[:, :1])
        bot = xs[r + 1][:, :1] if r < 1 else np.zeros_like(x[:, :1])
        np.testing.assert_allclose(o["halo_fwd"], np.concatenate([top, xs[r], bot], axis=1))
        hw = [q["halo_w"] for q in outs]
        want = hw[r][:, 1:-1].copy()
        if r > 0:
            want[:, :1] += hw[r - 1][:, -1:]
        if r < 1:
            want[:, -1:] += hw[r + 1][:, :1]
        np.testing.assert_allclose(o["halo_bwd"], want)


# -- make_manual_loss on each mesh shape ------------------------------------------------


MANUAL = [("dp2", (2, 1, 1), "none", {}), ("sp2-ring", (1, 2, 1), "ring", {}),
          ("sp2-ulysses", (1, 2, 1), "ulysses", {}), ("tp2", (1, 1, 2), "none", {}),
          ("tp2-pallas", (1, 1, 2), "none", {"use_pallas": True}),
          ("sp2-halo", (1, 2, 1), "halo", {"local_consensus_radius": 1})]
MANUAL4 = [("dp2xsp2-ring", (2, 2, 1), "ring", {})]
TCFG_KW = dict(batch_size=4, iters=4, recon_iter_index=3)


def _manual_inputs(extra):
    kw = dict(CFG_KW, **{k: v for k, v in extra.items() if k == "local_consensus_radius"})
    jcfg = jconfig.GlomConfig(**kw)
    jp = jobj.init_denoise(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    img, noise = (rng.standard_normal((4, 3, 8, 8)).astype(np.float32) for _ in range(2))
    return kw, jcfg, jp, img, noise


@pytest.fixture(scope="module")
def manual_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("manual")

    def cases(group):
        out = []
        for _, shape, sp, extra in group:
            kw, _, jp, img, noise = _manual_inputs(extra)
            tk = dict(TCFG_KW, **{k: v for k, v in extra.items() if k == "use_pallas"})
            out.append(("loss_grads", dict(shape=shape, sp=sp, cfg_kw=kw, tcfg_kw=tk,
                                           arrays=_flatten(jp), img=img, noise=noise)))
        return out

    return ranks.run(2, cases(MANUAL), tmp), ranks.run(4, cases(MANUAL4), tmp)


@pytest.mark.parametrize("case", MANUAL + MANUAL4, ids=lambda c: c[0])
def test_manual_loss_matches_glom_tpu(manual_runs, case):
    """The global loss and every leaf's global gradient, on every rank,
    against glom_tpu's make_manual_loss on the same mesh shape."""
    name, shape, sp, extra = case
    res = manual_runs[0] if case in MANUAL else manual_runs[1]
    idx = (MANUAL if case in MANUAL else MANUAL4).index(case)
    kw, jcfg, jp, img, noise = _manual_inputs(extra)
    jt = jconfig.TrainConfig(**dict(TCFG_KW, **{k: v for k, v in extra.items()
                                                if k == "use_pallas"}))
    jloss_fn = jmanual.make_manual_loss(_jmesh(shape), jcfg, jt, sp_strategy=sp)
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jp, jnp.asarray(img),
                                                          jnp.asarray(noise))
    jleaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    for r in res:
        got = r[idx]
        np.testing.assert_allclose(got["loss"], float(jloss), rtol=LOSS_RTOL)
        assert len(got["grads"]) == len(jleaves)
        for g, w in zip(got["grads"], jleaves):
            np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert np.isfinite(float(jloss))
