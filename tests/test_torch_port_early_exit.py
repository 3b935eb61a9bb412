"""The port's early-exit route against glom_tpu's, on the CPU.

The agreement witnesses, `glom_forward_auto`, `glom_forward_tiered` and the
engine's `iters="auto"` bucket route, on the same numpy-seeded images and
glom_tpu's `init_glom` weights carried across with `params_from_numpy`.
Iteration counts and per-row exits must be equal; levels are held at
rtol 2e-3 / atol 2e-4 (tests/test_torch_port_model.py). The port's own
threshold-0 contract (the auto loop is the fixed loop, bit for bit) is
checked within the port. `fused_grouped_ffw`, the reference-layout K1
entry these routes call, is held against glom_tpu's in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glom_tpu_torch.kernels.grouped_mlp as tk1
from glom_tpu.kernels.grouped_mlp import fused_grouped_ffw as jax_ffw
from glom_tpu.models import core as jcore
from glom_tpu.ops.ffw import GroupedFFWParams as JaxFFW
from glom_tpu.serve import early_exit as jee
from glom_tpu.serve import engine as jengine
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import GlomConfig, InferenceEngine, ServeConfig, glom_forward, params_from_numpy
from glom_tpu_torch.ops.ffw import GroupedFFWParams
from glom_tpu_torch.serve import early_exit as tee
from test_torch_port_model import ATOL, RTOL, TINY, flatten

WITNESS_TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfig.GlomConfig(**TINY)
    jp = jcore.init_glom(jax.random.PRNGKey(0), jcfg)
    return jcfg, GlomConfig(**TINY), jp, params_from_numpy(flatten(jp), device="cpu")


def _images(b, n_valid, seed=0, scale=1.0):
    imgs = (scale * np.random.default_rng(seed).standard_normal((b, 3, 16, 16))).astype(np.float32)
    imgs[n_valid:] = 0.0  # pad rows, as the batcher pads
    return imgs


class TestWitness:
    def test_batch_and_masked_agreement(self):
        lv = np.random.default_rng(1).standard_normal((3, 16, 3, 32)).astype(np.float32)
        _close(tee.batch_agreement(torch.from_numpy(lv)), jee.batch_agreement(jnp.asarray(lv)),
               **WITNESS_TOL)
        for mask in (None, np.array([True, False, True])):
            want = jee.masked_level_agreement(jnp.asarray(lv),
                                              None if mask is None else jnp.asarray(mask))
            got = tee.masked_level_agreement(torch.from_numpy(lv),
                                             None if mask is None else torch.from_numpy(mask))
            _close(got, want, **WITNESS_TOL)

    def test_row_delta_and_quorum_need(self):
        rng = np.random.default_rng(2)
        a, b = (rng.standard_normal((4, 3)).astype(np.float32) for _ in range(2))
        _close(tee.row_agreement_delta(torch.from_numpy(a), torch.from_numpy(b)),
               jee.row_agreement_delta(jnp.asarray(a), jnp.asarray(b)), **WITNESS_TOL)
        for quorum in (1.0, 0.75, 0.5, 0.3, 1e-6):
            for n in range(0, 9):
                got = tee.quorum_need(quorum, torch.tensor(n))
                assert int(got) == int(jee.quorum_need(quorum, jnp.asarray(n)))

    def test_auto_args_validated(self, model):
        _, tcfg, _, tp = model
        img = torch.from_numpy(_images(1, 1))
        for kw in (dict(max_iters=0), dict(min_iters=0), dict(min_iters=5, max_iters=4),
                   dict(threshold=-1.0)):
            with pytest.raises(ValueError):
                tee.glom_forward_tiered(tp, img, tcfg, **kw)


class TestGlomForwardAuto:
    @pytest.mark.parametrize("use_pallas", [False, True])
    # threshold 0 runs the budget; 2e-2 exits at 6 of 8, 5e-2 at 4 (floor 3).
    @pytest.mark.parametrize("threshold,min_iters", [(0.0, 1), (2e-2, 1), (5e-2, 3)])
    def test_matches_reference(self, model, use_pallas, threshold, min_iters):
        jcfg, tcfg, jp, tp = model
        imgs = _images(3, 2, seed=3, scale=100.0)
        mask = np.array([True, True, False])
        kw = dict(max_iters=8, threshold=threshold, min_iters=min_iters, use_pallas=use_pallas)
        j_lv, j_it, j_ag = jee.glom_forward_auto(jp, jnp.asarray(imgs), jcfg,
                                                 valid_mask=jnp.asarray(mask), **kw)
        t_lv, t_it, t_ag = tee.glom_forward_auto(tp, torch.from_numpy(imgs), tcfg,
                                                 valid_mask=torch.from_numpy(mask), **kw)
        assert t_it == int(j_it) and t_it >= min_iters
        _close(t_lv, j_lv)
        _close(t_ag, j_ag, **WITNESS_TOL)

    def test_threshold0_is_the_fixed_loop_bitwise(self, model):
        _, tcfg, _, tp = model
        img = torch.from_numpy(_images(2, 2, seed=4))
        lv, iters, _ = tee.glom_forward_auto(tp, img, tcfg, max_iters=5, threshold=0.0)
        assert iters == 5 and torch.equal(lv, glom_forward(tp, img, tcfg, iters=5))


class TestGlomForwardTiered:
    @pytest.mark.parametrize("use_pallas", [False, True])
    # Rows converge at different counts: at 2e-2 the full quorum exits at 8
    # (rows at 6, 8, 7), half of them at 7; at 5e-2 a third of them at 4.
    @pytest.mark.parametrize("threshold,quorum", [(0.0, 1.0), (2e-2, 1.0), (2e-2, 0.5),
                                                  (5e-2, 0.34)])
    def test_matches_reference(self, model, use_pallas, threshold, quorum):
        jcfg, tcfg, jp, tp = model
        imgs = _images(4, 3, seed=5, scale=100.0)
        imgs[1] *= 0.01  # an easier row: the rows converge at different counts
        mask = np.array([True, True, True, False])
        kw = dict(max_iters=10, threshold=threshold, quorum=quorum, min_iters=2,
                  use_pallas=use_pallas)
        want = jee.glom_forward_tiered(jp, jnp.asarray(imgs), jcfg,
                                       valid_mask=jnp.asarray(mask), **kw)
        got = tee.glom_forward_tiered(tp, torch.from_numpy(imgs), tcfg,
                                      valid_mask=torch.from_numpy(mask), **kw)
        assert got.iters_run == int(want.iters_run)
        np.testing.assert_array_equal(got.row_converged.numpy(), np.asarray(want.row_converged))
        np.testing.assert_array_equal(got.row_iters.numpy(), np.asarray(want.row_iters))
        _close(got.levels, want.levels)
        _close(got.agreement, want.agreement, **WITNESS_TOL)

    def test_warm_levels_carry_in(self, model):
        jcfg, tcfg, jp, tp = model
        imgs = _images(2, 2, seed=6)
        lv = np.random.default_rng(7).standard_normal((2, 16, 3, 32)).astype(np.float32)
        kw = dict(max_iters=4, threshold=1e-3)
        want = jee.glom_forward_tiered(jp, jnp.asarray(imgs), jcfg, levels=jnp.asarray(lv), **kw)
        got = tee.glom_forward_tiered(tp, torch.from_numpy(imgs), tcfg,
                                      levels=torch.from_numpy(lv), **kw)
        assert got.iters_run == int(want.iters_run)
        _close(got.levels, want.levels)

    def test_pad_rows_never_vote(self, model):
        """A masked row that converges at once must not end the loop."""
        _, tcfg, _, tp = model
        imgs = _images(2, 1, seed=8, scale=100.0)  # row 1: a zero image
        mask = torch.tensor([True, False])
        res = tee.glom_forward_tiered(tp, torch.from_numpy(imgs), tcfg, max_iters=6,
                                      threshold=1e-3, valid_mask=mask)
        alone = tee.glom_forward_tiered(tp, torch.from_numpy(imgs[:1]), tcfg, max_iters=6,
                                        threshold=1e-3)
        assert res.iters_run == alone.iters_run

    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_threshold0_is_the_fixed_loop_bitwise(self, model, use_pallas):
        """The port's threshold-0 contract, on one route: the tiered loop's
        updates are the fixed loop's (the reference layout with the plain
        FFW, or with K1 through fused_grouped_ffw)."""
        _, tcfg, _, tp = model
        img = torch.from_numpy(_images(2, 2, seed=9))
        res = tee.glom_forward_tiered(tp, img, tcfg, max_iters=5, threshold=0.0,
                                      use_pallas=use_pallas)
        step, lv = tee._build_update_step(tp, img, tcfg, None, None, use_pallas)
        for _ in range(5):
            lv = step(lv)
        assert res.iters_run == 5 and not res.row_converged.any()
        assert torch.equal(res.levels, lv)


class TestFusedGroupedFFW:
    @pytest.mark.parametrize("lead", [(2, 16), (1, 64)])
    def test_matches_pallas_interpret(self, lead):
        rng = np.random.default_rng(10)
        G, d, f = 3, 128, 512
        arrs = [rng.uniform(-s, s, shape).astype(np.float32) for s, shape in (
            (d ** -0.5, (G, d, f)), (d ** -0.5, (G, f)), (f ** -0.5, (G, f, d)), (f ** -0.5, (G, d)))]
        x = rng.standard_normal((*lead, G, d)).astype(np.float32)
        want = jax_ffw(JaxFFW(*map(jnp.asarray, arrs)), jnp.asarray(x), interpret=True)
        got = tk1.fused_grouped_ffw(GroupedFFWParams(*map(torch.from_numpy, arrs)),
                                    torch.from_numpy(x))
        assert got.shape == x.shape
        _close(got, want, rtol=1e-4, atol=1e-5)  # glom_tpu's K1 bar (tests/test_kernels.py:26)


@pytest.fixture(scope="module")
def auto_engines(model):
    jcfg, tcfg, jp, tp = model
    common = dict(buckets=(1, 2, 4), max_batch=4, iters="auto", max_auto_iters=8,
                  exit_quorum=0.5, min_iters=2)
    ref = jengine.InferenceEngine(jcfg, jconfig.ServeConfig(**common, dispatch_retries=0),
                                  params=jp)
    port = InferenceEngine(tcfg, ServeConfig(**common, use_pallas=True), params=tp, device="cpu")
    return ref, port


class TestEngineAuto:
    @pytest.mark.parametrize("bucket,n_valid", [(2, 1), (4, 3)])
    def test_infer_matches_reference(self, auto_engines, bucket, n_valid):
        ref, port = auto_engines
        imgs = _images(bucket, n_valid, seed=bucket, scale=100.0)
        want = ref.infer(imgs, n_valid=n_valid)
        got = port.infer(imgs, n_valid=n_valid)
        assert got.iters_run == want.iters_run
        np.testing.assert_array_equal(got.row_converged, want.row_converged)
        np.testing.assert_array_equal(got.row_iters, want.row_iters)
        _close(got.levels[:n_valid], np.asarray(want.levels)[:n_valid])

    def test_auto_budget_and_override(self, auto_engines):
        ref, port = auto_engines
        assert port.iters_key == ref.iters_key == "auto"
        assert port.auto_budget == ref.auto_budget == 8
        assert port.signature(2, auto_budget=3) == (2, "auto:3", True, False)
        imgs = _images(2, 2, seed=11, scale=100.0)
        lv = np.random.default_rng(12).standard_normal((2, 16, 3, 32)).astype(np.float32)
        want = ref.infer(imgs, levels0=lv, auto_budget=3)
        got = port.infer(imgs, levels0=lv, auto_budget=3)
        assert got.iters_run == want.iters_run <= 3
        np.testing.assert_array_equal(got.row_iters, want.row_iters)
        _close(got.levels, want.levels)
        fixed = port.infer(imgs, iters_override=2)
        assert fixed.iters_run == 2 and fixed.row_converged.all()
        with pytest.raises(ValueError, match="auto route only"):
            port.infer(imgs, iters_override=2, auto_budget=2)
        with pytest.raises(ValueError, match="auto_budget"):
            port.infer(imgs, auto_budget=0)

    def test_warmup_runs_the_auto_route(self, model):
        _, tcfg, _, tp = model
        eng = InferenceEngine(tcfg, ServeConfig(buckets=(1, 2), max_batch=2, iters="auto"),
                              params=tp, device="cpu")
        assert set(eng.warmup()) == {1, 2}
        assert not eng.infer(_images(2, 2)).compiled
