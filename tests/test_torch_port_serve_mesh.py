"""Sharded inference across gloo ranks against glom_tpu on its 8-device
virtual CPU mesh (tests/conftest.py).

The ranks are spawned from tests/torch_dist_ranks.py (a file store in
tmp_path), one spawn of 2 ranks and one of 4 for the module. Weights are
glom_tpu's, carried over by `models/transplant.params_from_numpy`; images
are numpy-seeded. Held here:

  * `Glom(mesh=)` (parallel/manual.make_manual_forward): the final state,
    all T+1 states and a carried-in levels0, at data 2, seq 2 (ring and
    Ulysses), model 2 and seq 4 (halo), against glom_tpu's `Glom(mesh=)`
    at f32 rtol 2e-3 / atol 2e-4 (`tests/test_model.py`'s bar);
  * every case of glom_tpu's tests/test_serve_mesh.py on the port's
    `InferenceEngine(mesh=)` (a leader and follower ranks): the
    data-sharded threshold-0 auto route bit for bit the port's
    single-device engine (both run the reference layout row for row on the
    CPU) and glom_tpu's at the bar above; data x seq against the single
    device; the fixed route; the warm continuation; the counted wire bytes
    of each signature equal to glom_tpu's counted trace; the divisibility
    errors; make_engine_meshes' partitioning; the two-tier exit behind
    DynamicBatcher; the needed-pages exchange bit for bit the whole-pool
    gather with fewer counted bytes, and "auto" picking it;
  * a follower that raises fails the leader's call (retried once when
    transient, a KernelError never), before the body or inside it, and
    the engine serves on; a collective that times out breaks the engine's
    group for good (CollectiveError, never retried);
  * a leader outside its group (`--engines 2`: global rank 0 holds both
    engines) gets its group's answer;
  * glom_tpu's `serve_shardings` has no counterpart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as ranks
from glom_tpu.models.api import Glom as JGlom
from glom_tpu.models.core import init_glom as j_init_glom
from glom_tpu.parallel import mesh as jmesh
from glom_tpu.parallel import serve_mesh as j_serve_mesh
from glom_tpu.serve.engine import InferenceEngine as JEngine
from glom_tpu.utils import config as jconfig
from glom_tpu_torch.models.transplant import params_from_numpy
from glom_tpu_torch.parallel import serve_mesh
from glom_tpu_torch.serve.engine import InferenceEngine
from glom_tpu_torch.utils.config import GlomConfig, ServeConfig

RTOL, ATOL = 2e-3, 2e-4
CFG_KW = dict(dim=32, levels=3, image_size=28, patch_size=7)  # n = 16, side 4
HALO_KW = dict(CFG_KW, local_consensus_radius=1)
ULYSSES_KW = dict(CFG_KW, levels=4)  # Ulysses splits the levels over seq
ITERS = 3
AUTO = dict(buckets=(8,), max_batch=8, iters="auto", exit_threshold=0.0, max_auto_iters=6,
            dispatch_retries=0)
PAGED = dict(buckets=(2, 8), max_batch=8, iters="auto", exit_threshold=0.0, max_auto_iters=4,
             page_pool_pages=64, page_tokens=4, dispatch_retries=0)


def _arrays(params) -> dict:
    out = {}
    for name in params._fields:
        v = getattr(params, name)
        if hasattr(v, "_fields"):
            for sub in v._fields:
                out[f"{name}.{sub}"] = np.asarray(getattr(v, sub))
        else:
            out[name] = np.asarray(v)
    return out


def _jparams(kw):
    return j_init_glom(jax.random.PRNGKey(1), jconfig.GlomConfig(**kw))


def _imgs(b, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((b, 3, 28, 28))).astype(np.float32)


def _levels0(b, kw, seed=4):
    cfg = GlomConfig(**kw)
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.num_patches, cfg.levels, cfg.dim)).astype(np.float32)


# -- the spawned runs (one spawn of 2 ranks, one of 4) -------------------------------

GLOM2 = [("data2", (2, 1, 1), "none", CFG_KW, 4), ("seq2-ring", (1, 2, 1), "ring", CFG_KW, 2),
         ("seq2-ulysses", (1, 2, 1), "ulysses", ULYSSES_KW, 2), ("model2", (1, 1, 2), "none", CFG_KW, 2)]
GLOM4 = [("seq4-halo", (1, 4, 1), "halo", HALO_KW, 2)]


def _glom_case(case):
    _, shape, sp, kw, b = case
    return ("glom_mesh", dict(shape=shape, sp=sp, cfg_kw=kw, arrays=_arrays(_jparams(kw)),
                              img=_imgs(b, 0), levels0=_levels0(b, kw), iters=ITERS))


def _serve(scfg_kw, calls=None, **kw):
    return ("serve_mesh", dict(cfg_kw=CFG_KW, scfg_kw=scfg_kw, arrays=_arrays(_jparams(CFG_KW)),
                               calls=calls, **kw))


IMG8 = _imgs(8, 3)
IMG2 = _imgs(2, 11, scale=100.0)

# The serve cases at world 2, by name: (case, index in the spawn).
AUTO_CALLS = [dict(kind="warmup"), dict(kind="infer", img=IMG8, n_valid=6),
              dict(kind="stats")]
CONT_CALLS = [dict(kind="infer", img=IMG8), dict(kind="infer", img=IMG8, levels0_from=0,
                                                  auto_budget=3), dict(kind="stats")]
PAGED_CALLS = [dict(kind="infer", img=IMG2, n_valid=2),
               dict(kind="write_back", sid="a", row=0, **{"from": 0}),
               dict(kind="write_back", sid="b", row=1, **{"from": 0}),
               dict(kind="lookup", sid="a"), dict(kind="lookup", sid="b"),
               dict(kind="pool_record")]
FAULT_CALLS = [dict(kind="infer", img=IMG8), dict(kind="infer", img=IMG8),
               dict(kind="infer", img=IMG8), dict(kind="infer", img=IMG8)]
# The collective timeout of the broken-group case's groups.
BROKEN_TIMEOUT_S = 5
# At these widths the 100x rows converge an iteration before the unit one.
HARD = np.random.default_rng(5).standard_normal((3, 28, 28)).astype(np.float32)
EASY = [(100.0 * np.random.default_rng(6 + i).standard_normal((3, 28, 28))).astype(np.float32)
        for i in range(3)]
TWO_TIER = dict(buckets=(4,), max_batch=4, max_delay_ms=100.0, iters="auto", exit_threshold=1e-3,
                max_auto_iters=16, exit_quorum=0.5, max_continuations=3, mesh_data=2)


def _paged_calls(mode_rows):
    """PAGED_CALLS, then the paged dispatch of the written rows."""
    return PAGED_CALLS + [dict(kind="infer", img=IMG2, n_valid=2, page_rows=mode_rows),
                          dict(kind="stats")]


SERVE2 = {
    "auto_data2": _serve(dict(AUTO, mesh_data=2), AUTO_CALLS),
    "fixed_data2": _serve(dict(AUTO, iters=5, mesh_data=2), [dict(kind="infer", img=IMG8),
                                                             dict(kind="stats")]),
    "cont3_data2": _serve(dict(AUTO, max_auto_iters=3, mesh_data=2), CONT_CALLS),
    "auto_seq2": _serve(dict(AUTO, exit_threshold=1e-3, max_auto_iters=12, mesh_seq=2),
                        [dict(kind="infer", img=IMG8), dict(kind="stats")]),
    "paged_pool": _serve(dict(PAGED, mesh_data=2, page_gather="pool"), None),
    "paged_needed": _serve(dict(PAGED, mesh_data=2, page_gather="needed"), None),
    "paged_auto": _serve(dict(PAGED, mesh_data=2, page_gather="auto"), None),
    "fault": _serve(dict(AUTO, mesh_data=2, dispatch_retries=1), FAULT_CALLS,
                    fault={"rank": 1, "fail": [(2, "transient"), (4, "kernel")]}),
    "two_tier": _serve(TWO_TIER, batcher=[EASY[0], HARD, EASY[1], EASY[2]]),
    # Faults inside the body: the fixed route at seq 1 (no collective in
    # the compute step), then the auto route, whose exit tests leave the
    # leader in a collective until the group's (shortened) timeout.
    "fault_body": _serve(dict(AUTO, iters=5, mesh_data=2, dispatch_retries=1), FAULT_CALLS,
                         fault={"rank": 1, "body": [(2, "transient"), (4, "kernel")]}),
    "fault_broken": _serve(dict(AUTO, mesh_data=2, dispatch_retries=1), FAULT_CALLS[:2],
                           fault={"rank": 1, "body": [(1, "transient")]},
                           group_timeout_s=BROKEN_TIMEOUT_S),
}
# Delta streams on the sharded pool: two rows laid down as bases, the next
# dispatch's rows written as deltas, then a warm dispatch from the
# effective pages.
DELTA_CALLS = [dict(kind="infer", img=IMG2, n_valid=2),
               dict(kind="write_back_stream", sid="a", row=0, **{"from": 0}),
               dict(kind="write_back_stream", sid="b", row=1, **{"from": 0}),
               dict(kind="infer", img=IMG2, n_valid=2, page_rows_from=["a", "b"]),
               dict(kind="write_back_stream", sid="a", row=0, **{"from": 3}),
               dict(kind="write_back_stream", sid="b", row=1, **{"from": 3}),
               dict(kind="infer", img=IMG2, n_valid=2, page_rows_from=["a", "b"]),
               dict(kind="pool_record")]
SERVE2["paged_delta"] = _serve(dict(PAGED, mesh_data=2, delta_streaming=True), DELTA_CALLS)
# Collective timing on a data-2 engine: the same four dispatches under each
# mode, then the drain; a follower that skips a sample.
TIMING_CALLS = [dict(kind="infer", img=IMG8, n_valid=6)] * 4 + [dict(kind="timing"),
                                                                dict(kind="stats")]
TIMING_MODES = ("off", "sampled", "full")
for _mode in TIMING_MODES:
    SERVE2[f"timing_{_mode}"] = _serve(dict(AUTO, mesh_data=2, collective_timing=_mode,
                                            collective_timing_interval=2), TIMING_CALLS)
SERVE2["timing_missed"] = _serve(
    dict(AUTO, mesh_data=2, collective_timing="sampled", collective_timing_interval=1),
    TIMING_CALLS[:2], fault={"rank": 1, "skip_sample": True},
    group_timeout_s=BROKEN_TIMEOUT_S)
SERVE4 = {
    "auto_data2xseq2": _serve(dict(AUTO, exit_threshold=1e-3, max_auto_iters=12, mesh_data=2,
                                   mesh_seq=2), [dict(kind="infer", img=IMG8), dict(kind="stats")]),
    "engines2": _serve(dict(AUTO, mesh_data=2), [dict(kind="infer", img=IMG8, n_valid=6)],
                       engines=2, leader=0),
}


def _fill_paged(name, case):
    """The paged cases' last dispatch reads the pages the first wrote: the
    page map comes from the pool's deterministic allocation (a fresh pool
    hands out pages 0.. in order)."""
    rows = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    case[1]["calls"] = _paged_calls(rows)
    return case


for _name in ("paged_pool", "paged_needed", "paged_auto"):
    _fill_paged(_name, SERVE2[_name])


CLI_ARGV = ["--preset", "mnist", "--device", "cpu", "--iters", "auto", "--buckets", "2,4",
            "--max-batch", "4", "--mesh-data", "2", "--dist-backend", "gloo", "--synthetic", "6"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    SERVE2["cli"] = ("serve_cli", dict(argv=CLI_ARGV, out=str(tmp / "serve.jsonl")))
    two = ranks.run(2, [_glom_case(c) for c in GLOM2] + list(SERVE2.values()), tmp)
    four = ranks.run(4, [_glom_case(c) for c in GLOM4] + list(SERVE4.values())
                     + [("engine_meshes", dict(scfg_kw=dict(buckets=(4,), max_batch=4,
                                                             mesh_data=2), n_engines=2))], tmp)
    return two, four


def _res(runs, world, key, rank=0):
    """The result of a named case on one rank."""
    two, four = runs
    if world == 2:
        names = [c[0] for c in GLOM2] + list(SERVE2)
        return two[rank][names.index(key)]
    names = [c[0] for c in GLOM4] + list(SERVE4) + ["engine_meshes"]
    return four[rank][names.index(key)]


def _leader(runs, world, key, engine=0):
    return _res(runs, world, key)[engine]["results"]


def _jmesh(shape):
    return jmesh.make_mesh(jconfig.MeshConfig(*shape), jax.devices()[: int(np.prod(shape))])


# -- Glom(mesh=) ----------------------------------------------------------------------


@pytest.mark.parametrize("case", GLOM2 + GLOM4, ids=lambda c: c[0])
def test_glom_mesh_matches_glom_tpu(runs, case):
    """Every rank's final state, T+1 states and carried-in forward against
    glom_tpu's Glom(mesh=) on the same mesh shape and weights."""
    name, shape, sp, kw, b = case
    world = 2 if case in GLOM2 else 4
    jm = JGlom(**kw, params=_jparams(kw), mesh=_jmesh(shape), sp_strategy=sp, use_pallas=True)
    img, lv = jnp.asarray(_imgs(b, 0)), jnp.asarray(_levels0(b, kw))
    want = {"final": jm(img, iters=ITERS), "all": jm(img, iters=ITERS, return_all=True),
            "with_levels": jm(img, iters=ITERS, levels=lv)}
    for r in range(world):
        got = _res(runs, world, name, r)
        for key, w in want.items():
            np.testing.assert_allclose(got[key], np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=key)
        assert got["all"].shape[0] == ITERS + 1
        assert "single-device" in got["auto_refused"]


def test_glom_mesh_refusals():
    """A mesh without 'data' and 'seq' raises: there is no GSPMD forward to
    fall back to (iters='auto' on a mesh raises in every rank case)."""
    from types import SimpleNamespace

    from glom_tpu_torch.models.api import Glom

    with pytest.raises(ValueError, match="'data' and 'seq'"):
        Glom(**CFG_KW, mesh=SimpleNamespace(mesh_dim_names=("x",)), device="cpu")


# -- the sharded engine ---------------------------------------------------------------


def _single(scfg_kw, params=None):
    kw = {k: v for k, v in scfg_kw.items() if k not in ("mesh_data", "mesh_seq")}
    p = params_from_numpy(_arrays(_jparams(CFG_KW)))
    return InferenceEngine(GlomConfig(**CFG_KW), ServeConfig(**kw), params=p, device="cpu")


def _jengine(scfg_kw, **kw):
    return JEngine(jconfig.GlomConfig(**CFG_KW), jconfig.ServeConfig(**scfg_kw),
                   params=_jparams(CFG_KW), **kw)


def _stats_comm(stats, warm=False):
    rec = [r for r in stats if r["warm_state"] == warm]
    assert len(rec) == 1, stats
    return {k: v for k, v in rec[0].items() if k.startswith("comm_measured")}


class TestShardedParity:
    def test_data_sharded_threshold_zero_is_bitwise_single_device(self, runs):
        """Data 2, seq 1, threshold 0 with pad rows: bit for bit the port's
        single-device engine (the same program row for row), glom_tpu's at
        the bar; the warm-up ran the signature's first dispatch."""
        out = _leader(runs, 2, "auto_data2")
        got = out[1]
        want = _single(dict(AUTO)).infer(IMG8, n_valid=6)
        assert got["iters_run"] == want.iters_run == 6
        assert np.array_equal(got["levels"], want.levels.numpy())
        assert np.array_equal(got["row_converged"], np.asarray(want.row_converged))
        j = _jengine(dict(AUTO, mesh_data=2)).infer(IMG8, n_valid=6)
        assert j.iters_run == 6
        np.testing.assert_allclose(got["levels"], np.asarray(j.levels), rtol=RTOL, atol=ATOL)
        assert np.array_equal(got["row_converged"], j.row_converged)

    @pytest.mark.parametrize("key", ["auto_seq2", "auto_data2xseq2"])
    def test_data_seq_mesh_matches_single_device(self, runs, key):
        """A seq-sharded band with the decomposed witness: the single
        device's answer at the f32 bar, the same trips and per-row exits,
        and glom_tpu's."""
        world = 2 if key == "auto_seq2" else 4
        got = _leader(runs, world, key)[0]
        scfg = dict(AUTO, exit_threshold=1e-3, max_auto_iters=12)
        want = _single(scfg).infer(IMG8)
        assert got["iters_run"] == want.iters_run
        np.testing.assert_allclose(got["levels"], want.levels.numpy(), rtol=RTOL, atol=ATOL)
        assert np.array_equal(got["row_converged"], np.asarray(want.row_converged))
        shape = dict(mesh_seq=2) if key == "auto_seq2" else dict(mesh_data=2, mesh_seq=2)
        j = _jengine(dict(scfg, **shape)).infer(IMG8)
        assert j.iters_run == got["iters_run"]
        np.testing.assert_allclose(got["levels"], np.asarray(j.levels), rtol=RTOL, atol=ATOL)

    def test_fixed_route_sharded_matches_single_device(self, runs):
        got = _leader(runs, 2, "fixed_data2")[0]
        want = _single(dict(AUTO, iters=5)).infer(IMG8)
        assert got["iters_run"] == want.iters_run == 5
        assert np.array_equal(got["levels"], want.levels.numpy())
        assert got["row_converged"].all()  # the fixed route: converged by fiat
        j = _jengine(dict(AUTO, iters=5, mesh_data=2)).infer(IMG8)
        np.testing.assert_allclose(got["levels"], np.asarray(j.levels), rtol=RTOL, atol=ATOL)

    def test_warm_continuation_route_matches(self, runs):
        """Continuing a threshold-0 run for 3 more iterations from its host
        levels0 equals one 6-iteration run, bit for bit."""
        first, cont, _ = _leader(runs, 2, "cont3_data2")
        full = _leader(runs, 2, "auto_data2")
        want = _single(dict(AUTO)).infer(IMG8)
        assert first["iters_run"] == 3 and cont["iters_run"] == 3
        assert cont["levels0_h2d_bytes"] == IMG8.shape[0] * 16 * 3 * 32 * 4
        assert np.array_equal(cont["levels"], want.levels.numpy())
        assert full[1]["iters_run"] == 6

    def test_leader_outside_its_group(self, runs):
        """Two engines on four ranks, both held by rank 0: engine 1's group
        is ranks 2-3 and rank 0 dispatches to it without a band. Both
        answer the single device's bits."""
        res = _res(runs, 4, "engines2")
        assert [e["ranks"] for e in res] == [[0, 1], [2, 3]]
        want = _single(dict(AUTO)).infer(IMG8, n_valid=6)
        for e in res:
            got = e["results"][0]
            assert got["iters_run"] == 6
            assert np.array_equal(got["levels"], want.levels.numpy())
        assert res[1]["wire"]["outputs"] > 0 and res[0]["wire"]["outputs"] == 0
        followers = [_res(runs, 4, "engines2", r) for r in (1, 2, 3)]
        assert [f["ranks"] for f in followers] == [[0, 1], [2, 3], [2, 3]]
        assert all(f["ops"] == {"dispatch": 1, "stop": 1} for f in followers)


class TestServeMeshPlumbing:
    @pytest.mark.parametrize("key,jkw,warm", [
        ("auto_data2", dict(AUTO, mesh_data=2), False),
        ("fixed_data2", dict(AUTO, iters=5, mesh_data=2), False),
        ("auto_seq2", dict(AUTO, exit_threshold=1e-3, max_auto_iters=12, mesh_seq=2), False),
        ("auto_data2xseq2", dict(AUTO, exit_threshold=1e-3, max_auto_iters=12, mesh_data=2,
                                 mesh_seq=2), False),
    ])
    def test_witness_collectives_are_counted(self, runs, key, jkw, warm):
        """Each signature's counted wire bytes equal glom_tpu's counted
        trace of the same signature: the loop's sites priced at the budget,
        a seq > 1 mesh's witness all-reduces every iteration, a data-only
        mesh just the quorum scalars."""
        world = 4 if key == "auto_data2xseq2" else 2
        out = _leader(runs, world, key)
        got = _stats_comm(out[-1], warm)
        j = _jengine(jkw)
        j.warmup()
        want = {k: v for k, v in j._comm[j.signature(8)].items()
                if k.startswith("comm_measured")}
        assert got == want
        if "seq" in key:
            assert got["comm_measured_bytes_per_step"] > 0

    def test_bucket_not_divisible_by_mesh_data_rejected(self):
        with pytest.raises(ValueError, match="divisible") as got:
            ServeConfig(buckets=(1, 2, 4), max_batch=4, mesh_data=4)
        with pytest.raises(ValueError, match="divisible") as want:
            jconfig.ServeConfig(buckets=(1, 2, 4), max_batch=4, mesh_data=4)
        assert str(got.value) == str(want.value)

    def test_patches_not_divisible_by_mesh_seq_rejected(self):
        """Refused before any process group is needed."""
        with pytest.raises(ValueError, match="mesh_seq"):
            InferenceEngine(GlomConfig(**CFG_KW), ServeConfig(buckets=(8,), max_batch=8,
                                                              mesh_seq=3), device="cpu")

    @pytest.mark.parametrize("bad,err,match", [
        (dict(ragged=True, mesh_data=2), ValueError, "single-device route only"),
        (dict(page_pool_pages=3, mesh_data=2), ValueError, "page_pool_pages 3 not divisible"),
    ])
    def test_refused_configs(self, bad, err, match):
        """glom_tpu's refusals of ragged admission and an indivisible pool on
        a mesh."""
        scfg = ServeConfig(**dict(dict(buckets=(8,), max_batch=8), **bad))
        with pytest.raises(err, match=match):
            InferenceEngine(GlomConfig(**CFG_KW), scfg, device="cpu")

    def test_delta_streams_on_a_sharded_engine(self, runs):
        """mesh_data 2 with delta_streaming: the engine builds and serves.
        Two rows go down as bases, the next dispatch's rows as deltas, and
        the warm dispatch over the effective pages (0 levels0 bytes)
        answers what the single-device engine answers after the same
        writes, bit for bit; the pool's record is the single device's."""
        out = _leader(runs, 2, "paged_delta")
        single = _single(dict(PAGED, delta_streaming=True))
        want = []
        for c in DELTA_CALLS:
            if c["kind"] == "infer":
                kw = {}
                if c.get("page_rows_from"):
                    kw["page_rows"] = np.array([single.pool.lookup(s)[0]
                                                for s in c["page_rows_from"]])
                want.append(single.infer(IMG2, n_valid=2, **kw))
            elif c["kind"] == "write_back_stream":
                want.append(single.pool.write_back_stream(
                    c["sid"], want[c["from"]].levels[c["row"]], 16))
            else:
                want.append(single.pool.record())
        for i in (0, 3, 6):
            assert np.array_equal(out[i]["levels"], want[i].levels.numpy()), i
        assert out[3]["levels0_h2d_bytes"] == out[6]["levels0_h2d_bytes"] == 0
        for i in (1, 2, 4, 5):
            assert out[i] == want[i], i
        assert out[1]["kind"] == "base" and out[4]["kind"] == "delta"
        assert out[7] == want[7] and out[7]["delta"]["n_delta_writes"] == 2

    def test_make_engine_meshes_partitions_ranks(self, runs):
        """Four ranks, two 2-rank engines: contiguous groups, each rank in
        exactly one; a third engine does not fit; engine_mesh_for(1) is the
        second group (glom_tpu's partition of 8 devices into 4-device
        replicas, at the port's world)."""
        for r in range(4):
            got = _res(runs, 4, "engine_meshes", r)
            assert got["groups"] == [[0, 1], [2, 3]] and got["for_1"] == [2, 3]
            assert got["leaders"] == [0, 2]
            assert got["member"] == [r < 2, r >= 2]
            assert got["index"][r // 2] == (r % 2, 0)
            assert "replicas" in got["too_many"]
        from glom_tpu.parallel.runtime import make_engine_meshes

        with pytest.raises(ValueError, match="replicas"):
            make_engine_meshes(jconfig.ServeConfig(buckets=(4,), max_batch=4, mesh_data=2,
                                                   mesh_seq=2), 3)

    def test_replica_device_groups_validation(self):
        from glom_tpu.parallel.mesh import replica_device_groups as jgroups
        from glom_tpu_torch.parallel.mesh import replica_device_groups

        devs = list(range(8))
        assert replica_device_groups(devs, 4) == jgroups(devs, 4) == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert replica_device_groups(devs, 3) == jgroups(devs, 3)
        with pytest.raises(ValueError, match=">= 1"):
            replica_device_groups(devs, 0)
        with pytest.raises(ValueError, match="cannot host"):
            replica_device_groups(devs[:2], 4)

    def test_serve_shardings_has_no_counterpart(self):
        """glom_tpu's NamedSharding resolution has no port: each rank holds
        its band, and the module says so."""
        assert hasattr(j_serve_mesh, "serve_shardings")
        assert not hasattr(serve_mesh, "serve_shardings")
        assert "`serve_shardings`" in serve_mesh.__doc__ and "no" in serve_mesh.__doc__


class TestShardedBatcherRide:
    def test_two_tier_over_sharded_engine(self, runs):
        """Heterogeneous traffic through DynamicBatcher over a data-sharded
        engine: the straggler re-buckets, every ticket resolves, and the
        easy quorum resolves in fewer executed iterations than the
        straggler's total."""
        got = _res(runs, 2, "two_tier")[0]["results"]
        s = got["summary"]
        assert s["n_served"] == 4 and s["n_failed"] == 0
        assert s["n_continued"] >= 1
        easy = [got["iters"][i] for i in (0, 2, 3)]
        assert max(easy) < got["iters"][1]


class TestNeededPagesGather:
    def test_needed_bitwise_and_counted_bytes_below_pool_bound(self, runs):
        """The needed-pages exchange delivers the whole-pool gather's pages
        bit for bit and counts fewer bytes; both equal glom_tpu's counted
        bytes and the single device's answer from the same pages."""
        outs, counted = {}, {}
        for mode in ("pool", "needed"):
            res = _leader(runs, 2, f"paged_{mode}")
            assert res[1] and res[2] and res[3] == [0, 1, 2, 3] and res[4] == [4, 5, 6, 7]
            outs[mode] = res[6]["levels"]
            counted[mode] = _stats_comm(res[7], "paged")
            j = _jengine(dict(PAGED, mesh_data=2, page_gather=mode))
            lv = np.asarray(j.infer(IMG2, n_valid=2).levels)
            for i, sid in enumerate(("a", "b")):
                assert j.pool.write_back(sid, lv[i], 16)
            prow = np.stack([j.pool.lookup("a")[0], j.pool.lookup("b")[0]]).astype(np.int32)
            jr = j.infer(IMG2, n_valid=2, page_rows=prow)
            want = {k: v for k, v in j._comm[j.signature(2, warm="paged")].items()
                    if k.startswith("comm_measured")}
            assert counted[mode] == want, mode
            np.testing.assert_allclose(outs[mode], np.asarray(jr.levels), rtol=RTOL, atol=ATOL)
        assert np.array_equal(outs["pool"], outs["needed"])
        assert (counted["needed"]["comm_measured_bytes_per_step"]
                < counted["pool"]["comm_measured_bytes_per_step"])
        single = _single(PAGED)
        lv = single.infer(IMG2, n_valid=2).levels
        for i, sid in enumerate(("a", "b")):
            assert single.pool.write_back(sid, lv[i], 16)
        want = single.infer(IMG2, n_valid=2, page_rows=np.array([[0, 1, 2, 3], [4, 5, 6, 7]]))
        assert np.array_equal(outs["needed"], want.levels.numpy())

    def test_auto_picks_needed_for_big_pools(self, runs):
        counted = {m: _stats_comm(_leader(runs, 2, f"paged_{m}")[7], "paged")
                   for m in ("auto", "needed", "pool")}
        assert counted["auto"] == counted["needed"]
        assert (counted["needed"]["comm_measured_bytes_per_step"]
                < counted["pool"]["comm_measured_bytes_per_step"])

    def test_pool_record_counts_the_write_backs(self, runs):
        """The leader's table: two write-backs of 4 pages each in the
        64-page pool (each rank holds 32)."""
        rec = _leader(runs, 2, "paged_needed")[5]
        assert rec["n_writebacks"] == 2 and rec["pages_used"] == 8
        assert rec["pages_total"] == 64


class TestFollowerFaults:
    def test_a_follower_that_raises_fails_the_leaders_call(self, runs):
        """Rank 1's hook fails its 2nd op once (transient: the retry sends
        the header again and the dispatch answers) and its 4th with a
        KernelError (nonretryable: the leader raises it); the engine then
        serves its next dispatch."""
        out = _leader(runs, 2, "fault")
        want = _single(dict(AUTO)).infer(IMG8).levels.numpy()
        assert np.array_equal(out[0]["levels"], want)
        assert np.array_equal(out[1]["levels"], want)
        assert out[2]["error"] == "KernelError"
        assert np.array_equal(out[3]["levels"], want)
        follower = _res(runs, 2, "fault", 1)
        assert follower["failed"] == 2
        assert follower["ops"] == {"dispatch": 5, "stop": 1}

    def test_a_follower_that_raises_inside_the_body_fails_the_leaders_call(self, runs):
        """The fixed route at seq 1: rank 1's compute step raises in its 2nd
        call (transient: retried, and the dispatch answers) and in its 4th
        with a KernelError (the leader raises it, not its own error and not
        a FollowerError); the status after the compute step reaches every
        rank, so the group serves on."""
        out = _leader(runs, 2, "fault_body")
        want = _single(dict(AUTO, iters=5)).infer(IMG8).levels.numpy()
        for i in (0, 1, 3):
            assert np.array_equal(out[i]["levels"], want)
        assert out[2]["error"] == "KernelError"
        assert not _res(runs, 2, "fault_body")[0]["broken"]
        follower = _res(runs, 2, "fault_body", 1)
        assert follower["failed"] == 2
        assert follower["ops"] == {"dispatch": 5, "stop": 1}

    def test_a_broken_group_serves_no_more(self, runs):
        """The auto route: rank 1's compute step raises before the quorum
        all-reduce, so the leader waits in it until the group's timeout.
        The leader then raises CollectiveError (nonretryable: the retry
        budget of 1 is not spent on a closed group), marks the engine's
        group broken and refuses the next dispatch at once; the follower's
        loop raises the same error."""
        from glom_tpu_torch.resilience.retry import NONRETRYABLE_DEFAULT, CollectiveError

        assert CollectiveError in NONRETRYABLE_DEFAULT
        lead = _res(runs, 2, "fault_broken")[0]
        first, second = lead["results"]
        assert first["error"] == "CollectiveError"
        assert second["error"] == "CollectiveError" and "broke earlier" in second["message"]
        assert lead["broken"]
        follower = _res(runs, 2, "fault_broken", 1)
        assert follower["error"] == "CollectiveError"


class TestCollectiveTiming:
    """A data-2 engine's collective timing over its follower: four
    threshold-0 dispatches (T = 6) under each mode, then a drain."""

    def test_timed_modes_answer_bit_for_bit(self, runs):
        off = _leader(runs, 2, "timing_off")
        for mode in ("sampled", "full"):
            got = _leader(runs, 2, f"timing_{mode}")
            for a, b in zip(got[:4], off[:4]):
                assert a["iters_run"] == b["iters_run"] == 6
                for key in ("levels", "row_converged", "row_iters"):
                    assert np.array_equal(a[key], b[key]), (mode, key)
        assert off[4] == []  # "off" drains no record

    def test_sampled_records_equal_glom_tpus_sites(self, runs):
        """Every 2nd dispatch samples (the follower runs two `sample` ops);
        each sample's sites and calls are glom_tpu's."""
        rows = _leader(runs, 2, "timing_sampled")[4]
        j = _jengine(dict(AUTO, mesh_data=2, collective_timing="sampled",
                          collective_timing_interval=2))
        for _ in range(4):
            j.infer(IMG8, n_valid=6)
        key = lambda r: (r["site"], r.get("axis"), r.get("collective"), r.get("wire_bytes"),  # noqa: E731
                         r.get("calls"), r["mode"], r.get("n_points"))
        assert sorted(map(key, rows)) == sorted(map(key, j.collective_time_records()))
        assert all(r["wall_ms"] > 0 and r["engine"] == "engine0" for r in rows)
        assert _res(runs, 2, "timing_sampled", 1)["ops"] == {"dispatch": 4, "sample": 2,
                                                            "stop": 1}

    def test_full_records_count_both_ranks(self, runs):
        """One drain gathers both ranks' bracketed executions: the quorum
        target's all-reduce once a dispatch a rank, the exit test's once a
        trip that may exit (iterations 1..T-1 at min_iters 1: glom_tpu's
        while loop also runs it around the trips, so its count is higher;
        the same sites and bytes)."""
        rows = _leader(runs, 2, "timing_full")[4]
        by_site = {r["site"]: r for r in rows}
        T, ranks_, dispatches = 6, 2, 4
        assert by_site["quorum_valid_psum"]["calls"] == ranks_ * dispatches
        assert by_site["quorum_exit_psum"]["calls"] == ranks_ * dispatches * (T - 1)
        for r in (by_site["quorum_valid_psum"], by_site["quorum_exit_psum"]):
            assert (r["axis"], r["collective"], r["wire_bytes"], r["mode"]) == (
                "data", "psum", 4, "full")
            assert r["wall_ms_max"] >= r["wall_ms"] > 0
        assert by_site["comm_time_model"]["n_points"] == 2
        assert _res(runs, 2, "timing_full", 1)["ops"] == {"dispatch": 4, "drain": 1, "stop": 1}
        stats = _leader(runs, 2, "timing_full")[5]
        assert _stats_comm(stats) == _stats_comm(_leader(runs, 2, "timing_off")[5])

    def test_a_missed_sample_raises_not_hangs(self, runs):
        """Rank 1 skips its sample's collectives: the leader's sample waits
        in its all-reduce until the group's (shortened) timeout, then
        raises CollectiveError and marks the group broken; the follower's
        loop raises it too. No rank hangs."""
        lead = _res(runs, 2, "timing_missed")[0]
        first, second = lead["results"]
        assert first["error"] == "CollectiveError"
        assert second["error"] == "CollectiveError" and "broke earlier" in second["message"]
        assert lead["broken"]
        assert _res(runs, 2, "timing_missed", 1)["error"] == "CollectiveError"


def test_serve_cli_on_a_mesh(runs):
    """`python -m glom_tpu_torch.serve --mesh-data 2` on two ranks: rank 0
    serves every request through its sharded engine and writes a stream
    that lints; rank 1 follows and exits 0."""
    from glom_tpu_torch.telemetry import schema

    lead, follower = _res(runs, 2, "cli", 0), _res(runs, 2, "cli", 1)
    assert lead["rc"] == 0 and follower["rc"] == 0
    recs = lead["records"]
    assert schema.main([SERVE2["cli"][1]["out"]]) == 0
    (summary,) = [r for r in recs if r.get("event") == "summary"]
    assert summary["n_requests"] == summary["n_served"] == 6
    assert summary["n_failed"] == summary["n_shed"] == 0
    warm = [r for r in recs if r.get("event") == "warmup"]
    assert warm and all(r["sharded"] for r in warm)
    stats = [r for r in recs if r.get("event") == "bucket_stats"]
    assert stats and all("comm_measured_bytes_per_step" in r for r in stats)
