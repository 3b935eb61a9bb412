"""The port's InferenceEngine (fixed route, CPU) against glom_tpu's.

Both engines hold the same weights (glom_tpu's `init_glom`, carried across
with `params_from_numpy`) and answer the same padded batches from
np.random.default_rng, at f32. Tolerance rtol 2e-3 / atol 2e-4, as the
model tests.
"""

import jax
import numpy as np
import pytest
import torch

from glom_tpu.models import core as jcore
from glom_tpu.serve import engine as jengine
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import GlomConfig, InferenceEngine, ServeConfig, params_from_numpy
from test_torch_port_model import ATOL, RTOL, TINY, flatten

BUCKETS = (1, 2, 4)


@pytest.fixture(scope="module")
def engines():
    jp = jcore.init_glom(jax.random.PRNGKey(0), jconfig.GlomConfig(**TINY))
    ref = jengine.InferenceEngine(
        jconfig.GlomConfig(**TINY),
        jconfig.ServeConfig(buckets=BUCKETS, max_batch=4),
        params=jp,
    )
    tp = params_from_numpy(flatten(jp))
    port = {
        use_pallas: InferenceEngine(
            GlomConfig(**TINY),
            ServeConfig(buckets=BUCKETS, max_batch=4, use_pallas=use_pallas),
            params=tp, device="cpu",
        )
        for use_pallas in (False, True)
    }
    return ref, port


def _batch(seed, b, n_valid):
    imgs = np.random.default_rng(seed).standard_normal((b, 3, 16, 16)).astype(np.float32)
    imgs[n_valid:] = 0.0  # pad rows, as the batcher pads
    return imgs


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("bucket,n_valid", [(2, 1), (4, 3)])
def test_answers_match_reference(engines, use_pallas, bucket, n_valid):
    ref, port = engines
    imgs = _batch(bucket, bucket, n_valid)
    want = ref.infer(imgs, n_valid=n_valid)
    got = port[use_pallas].infer(imgs, n_valid=n_valid)
    assert got.bucket == bucket and got.iters_run == want.iters_run == 6
    np.testing.assert_array_equal(got.row_converged, want.row_converged)
    np.testing.assert_array_equal(got.row_iters, want.row_iters)
    assert got.levels.shape == (bucket, 16, 3, 32)
    np.testing.assert_allclose(
        got.levels[:n_valid].numpy(), np.asarray(want.levels)[:n_valid], rtol=RTOL, atol=ATOL
    )


def test_warm_levels_and_iters_override(engines):
    ref, port = engines
    imgs = _batch(5, 2, 2)
    lv = np.random.default_rng(6).standard_normal((2, 16, 3, 32)).astype(np.float32)
    want = ref.infer(imgs, iters_override=2, levels0=lv)
    got = port[True].infer(imgs, iters_override=2, levels0=lv)
    assert got.iters_run == 2 and got.levels0_h2d_bytes == lv.nbytes
    np.testing.assert_allclose(got.levels.numpy(), np.asarray(want.levels), rtol=RTOL, atol=ATOL)


def test_warmup_and_first_dispatch_flags():
    eng = InferenceEngine(
        GlomConfig(**TINY), ServeConfig(buckets=BUCKETS, max_batch=4), device="cpu"
    )
    first = eng.warmup((1, 2))
    assert set(first) == {1, 2} and all(s > 0 for s in first.values())
    assert eng.warmup((1, 2)) == {1: 0.0, 2: 0.0}
    assert not eng.infer(_batch(0, 2, 2)).compiled
    assert eng.infer(_batch(0, 4, 4)).compiled


def test_cold_levels_and_pick_bucket(engines):
    ref, port = engines
    np.testing.assert_array_equal(port[False].cold_levels().numpy(), ref.cold_levels())
    for n in (1, 2, 3, 4):
        assert port[False].pick_bucket(n) == ref.pick_bucket(n)
    with pytest.raises(ValueError):
        port[False].pick_bucket(5)


def test_rejects_non_bucket_batches(engines):
    _, port = engines
    with pytest.raises(ValueError, match="not a bucket"):
        port[True].infer(_batch(0, 3, 3))
    with pytest.raises(ValueError, match="n_valid"):
        port[True].infer(_batch(0, 2, 2), n_valid=3)


def test_unported_routes_raise():
    """The early-exit, ragged and paged routes are ported
    (test_torch_port_early_exit, test_torch_port_ragged,
    test_torch_port_paged), and so are the batcher's continuation hops
    (test_torch_port_batcher); meshes still raise, and the paged forms
    need a pool."""
    with pytest.raises(NotImplementedError, match="item 8"):
        InferenceEngine(GlomConfig(**TINY), device="cpu", mesh=object())
    cont = InferenceEngine(GlomConfig(**TINY), ServeConfig(max_continuations=1), device="cpu")
    assert cont.scfg.max_continuations == 1
    eng = InferenceEngine(GlomConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="page pool"):
        eng.infer(_batch(0, 1, 1), page_rows=np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match="page pool"):
        eng.infer_ragged(np.zeros((16, 48), np.float32), [16], page_idx=np.zeros(4, np.int32))


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(GlomConfig(**TINY))
