"""The port's incremental route against glom_tpu's, on the CPU.

`support_agreement` is held to glom_tpu's at 1e-6. `glom_forward_incremental`
at threshold 0 is the port's `glom_forward_tiered` bit for bit. Above 0 the
route branches on `delta < threshold`, so each such case first measures
both packages' per-iteration deltas on its inputs and asserts that every
delta sits at least 10x their largest disagreement away from the
threshold; only then are `iters_run`, `row_iters` and `row_converged`
compared exactly, and the levels at rtol 2e-3 / atol 2e-4
(tests/test_torch_port_model.py). A hold frame (no support) pays exactly
`min_iters`. The engine's `support_rows` refusals match glom_tpu's in kind.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu.models import core as jcore
from glom_tpu.serve import early_exit as jee
from glom_tpu.serve import engine as jengine
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import GlomConfig, InferenceEngine, ServeConfig, params_from_numpy
from glom_tpu_torch.serve import early_exit as tee
from test_torch_port_model import ATOL, RTOL, TINY, flatten

PT = 4
T = 8
MARGIN = 10.0  # distance from the threshold, in units of the measured disagreement


@pytest.fixture(scope="module")
def model():
    jcfg = jconfig.GlomConfig(**TINY)
    jp = jcore.init_glom(jax.random.PRNGKey(0), jcfg)
    return jcfg, GlomConfig(**TINY), jp, params_from_numpy(flatten(jp), device="cpu")


@pytest.fixture(scope="module")
def frame(model):
    """A warm frame: the columns of 6 cold iterations on frame 0, frame 1
    with pages perturbed per row (row 0 page 1, row 1 none, row 2 pages 0
    and 3), and the page support as tokens."""
    jcfg, _, jp, _ = model
    rng = np.random.default_rng(40)
    img0 = rng.standard_normal((3, 3, 16, 16)).astype(np.float32)
    levels = np.array(jee.glom_forward_auto(jp, jnp.asarray(img0), jcfg, max_iters=6,
                                              threshold=0.0)[0])
    pages = np.zeros((3, 4), bool)
    pages[0, 1] = pages[2, 0] = pages[2, 3] = True
    img1 = img0.copy()
    for r, p in zip(*np.nonzero(pages)):  # page p is patch row p of the 4 x 4 grid
        img1[r, :, 4 * p:4 * p + 4, :] += rng.standard_normal((3, 4, 16)).astype(np.float32)
    support = np.repeat(pages, PT, axis=1)  # [3, 16]
    return img1, levels, support


def _deltas(step, lv, witness, iters):
    out, prev = [], witness(lv)
    for _ in range(iters):
        lv = step(lv)
        agree = witness(lv)
        out.append(np.abs(np.asarray(agree, np.float32) - np.asarray(prev, np.float32))
                   .max(axis=-1))
        prev = agree
    return np.stack(out)  # [iters, b]


def measured_deltas(model, img, levels, support, iters=T):
    """Both packages' per-iteration, per-row support-witness deltas."""
    jcfg, tcfg, jp, tp = model
    jstep, jlv = jee._build_update_step(jp, jnp.asarray(img), jcfg, jnp.asarray(levels),
                                        None, False)
    tstep, tlv = tee._build_update_step(tp, torch.from_numpy(img), tcfg,
                                        torch.from_numpy(levels), None, False)
    js, ts = jnp.asarray(support), torch.from_numpy(support)
    want = _deltas(jstep, jlv, lambda lv: jee.support_agreement(lv, js), iters)
    with torch.no_grad():
        got = _deltas(tstep, tlv, lambda lv: tee.support_agreement(lv, ts), iters)
    return got, want


def pick_threshold(deltas, err):
    """The threshold in the widest gap (in log space) between the measured
    deltas; asserts every delta is MARGIN x err away from it."""
    vals = np.unique(deltas[deltas > 0])
    gaps = vals[1:] / vals[:-1]
    k = int(np.argmax(gaps[: len(gaps) // 2 + 1]))  # low enough that rows exit
    thr = float(np.sqrt(vals[k] * vals[k + 1]))
    assert np.abs(deltas - thr).min() >= MARGIN * err, (thr, np.abs(deltas - thr).min(), err)
    return thr


class TestSupportAgreement:
    def test_matches_reference(self):
        rng = np.random.default_rng(41)
        lv = rng.standard_normal((4, 16, 3, 32)).astype(np.float32)
        support = rng.random((4, 16)) < 0.3
        support[1] = False  # an empty row reads 0.0
        got = tee.support_agreement(torch.from_numpy(lv), torch.from_numpy(support))
        want = jee.support_agreement(jnp.asarray(lv), jnp.asarray(support))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        assert not got[1].any()


class TestIncremental:
    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_threshold0_is_tiered_bitwise(self, model, frame, use_pallas):
        _, tcfg, _, tp = model
        img, levels, support = (torch.from_numpy(a) for a in frame)
        kw = dict(max_iters=4, threshold=0.0, levels=levels, use_pallas=use_pallas)
        got = tee.glom_forward_incremental(tp, img, tcfg, support_mask=support, **kw)
        want = tee.glom_forward_tiered(tp, img, tcfg, **kw)
        assert got.iters_run == want.iters_run == 4
        assert torch.equal(got.levels, want.levels)
        assert torch.equal(got.row_iters, want.row_iters)

    @pytest.mark.parametrize("min_iters", [1, 2])
    def test_matches_reference_at_a_safe_threshold(self, model, frame, min_iters):
        jcfg, tcfg, jp, tp = model
        img, levels, support = frame
        got_d, want_d = measured_deltas(model, img, levels, support)
        err = float(np.abs(got_d - want_d).max())
        thr = pick_threshold(got_d[:, support.any(axis=1)], err)
        kw = dict(max_iters=T, threshold=thr, min_iters=min_iters)
        got = tee.glom_forward_incremental(tp, torch.from_numpy(img), tcfg,
                                           levels=torch.from_numpy(levels),
                                           support_mask=torch.from_numpy(support), **kw)
        want = jee.glom_forward_incremental(jp, jnp.asarray(img), jcfg,
                                            levels=jnp.asarray(levels),
                                            support_mask=jnp.asarray(support), **kw)
        assert got.iters_run == int(want.iters_run) < T
        np.testing.assert_array_equal(got.row_iters.numpy(), np.asarray(want.row_iters))
        np.testing.assert_array_equal(got.row_converged.numpy(), np.asarray(want.row_converged))
        assert int(got.row_iters[1]) == 0  # the clean row
        np.testing.assert_allclose(got.levels.numpy(), np.asarray(want.levels),
                                   rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("min_iters", [1, 3])
    def test_hold_frame_pays_min_iters(self, model, frame, min_iters):
        jcfg, tcfg, jp, tp = model
        img, levels, support = frame
        empty = np.zeros_like(support)
        kw = dict(max_iters=T, threshold=1e-3, min_iters=min_iters)
        got = tee.glom_forward_incremental(tp, torch.from_numpy(img), tcfg,
                                           levels=torch.from_numpy(levels),
                                           support_mask=torch.from_numpy(empty), **kw)
        want = jee.glom_forward_incremental(jp, jnp.asarray(img), jcfg,
                                            levels=jnp.asarray(levels),
                                            support_mask=jnp.asarray(empty), **kw)
        assert got.iters_run == int(want.iters_run) == min_iters
        assert got.row_converged.all() and not got.row_iters.any()
        np.testing.assert_array_equal(got.row_iters.numpy(), np.asarray(want.row_iters))
        np.testing.assert_allclose(got.levels.numpy(), np.asarray(want.levels),
                                   rtol=RTOL, atol=ATOL)


class TestEngineIncremental:
    @pytest.fixture(scope="class")
    def engines(self, model):
        jcfg, tcfg, jp, tp = model

        def pair(**over):
            kw = dict(dict(buckets=(1, 4), max_batch=4, page_pool_pages=16, page_tokens=PT,
                           iters="auto", max_auto_iters=T), **over)
            return (jengine.InferenceEngine(jcfg, jconfig.ServeConfig(**kw), params=jp),
                    InferenceEngine(tcfg, ServeConfig(**kw, use_pallas=True), params=tp,
                                    device="cpu"))

        return {"auto": pair(min_iters=2), "fixed": pair(iters=3), "t0": pair(exit_threshold=0.0)}

    def _warm(self, engines, key, levels):
        ref, port = engines[key]
        for eng, conv in ((port, torch.from_numpy), (ref, jnp.asarray)):
            eng.pool.free_all()
            for i, row in enumerate(levels):
                assert eng.pool.write_back(f"s{i}", conv(row), 16)
        page_rows = np.full((4, 4), -1, np.int32)
        page_rows[:3] = np.arange(12).reshape(3, 4)
        return ref, port, page_rows

    def test_hold_frame_through_the_engine(self, engines, frame):
        img, levels, _ = frame
        ref, port, page_rows = self._warm(engines, "auto", levels)
        imgs = np.concatenate([img, np.zeros((1, 3, 16, 16), np.float32)])
        hold = np.zeros((4, 4), bool)
        got = port.infer(imgs, 3, page_rows=page_rows, support_rows=hold)
        want = ref.infer(imgs, 3, page_rows=page_rows, support_rows=hold)
        assert got.iters_run == want.iters_run == 2 and got.levels0_h2d_bytes == 0
        np.testing.assert_array_equal(got.row_iters, want.row_iters)
        np.testing.assert_allclose(got.levels.numpy(), np.asarray(want.levels),
                                   rtol=RTOL, atol=ATOL)

    def test_threshold0_equals_the_paged_tiered_dispatch(self, engines, frame):
        img, levels, support = frame
        ref, port, page_rows = self._warm(engines, "t0", levels)
        imgs = np.concatenate([img, np.zeros((1, 3, 16, 16), np.float32)])
        supp = np.zeros((4, 4), bool)
        supp[:3] = support[:, ::PT]
        got = port.infer(imgs, 3, page_rows=page_rows, support_rows=supp)
        plain = port.infer(imgs, 3, page_rows=page_rows)
        assert got.iters_run == plain.iters_run == T
        assert torch.equal(got.levels, plain.levels)
        want = ref.infer(imgs, 3, page_rows=page_rows, support_rows=supp)
        np.testing.assert_allclose(got.levels.numpy(), np.asarray(want.levels),
                                   rtol=RTOL, atol=ATOL)

    def test_support_rows_refusals_match_reference(self, engines):
        imgs = np.zeros((4, 3, 16, 16), np.float32)
        rows, supp = np.full((4, 4), -1, np.int32), np.zeros((4, 4), bool)
        cases = (
            ("auto", dict(support_rows=supp), "rides page_rows"),
            ("fixed", dict(page_rows=rows, support_rows=supp), "iters='auto'"),
            ("auto", dict(page_rows=rows, support_rows=supp, iters_override=2), "iters='auto'"),
            ("auto", dict(page_rows=rows, support_rows=supp[:, :2]), "support_rows shape"),
        )
        for key, kw, match in cases:
            for eng in engines[key]:
                with pytest.raises(ValueError, match=match):
                    eng.infer(imgs, **kw)
        for eng in engines["fixed"]:
            with pytest.raises(ValueError, match="iters='auto'"):
                eng.warmup((4,), warm="paged-inc")
