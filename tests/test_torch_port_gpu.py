"""The port's CUDA kernels and fused path on the card, against their plain
PyTorch versions. Every test here is marked `gpu` and skips without a CUDA
device. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py

f32 tolerances are glom_tpu's own kernel bars (tests/test_kernels.py:26,
:275) and its model bar (tests/test_model.py:43). bf16 kernel bars are about
1-2 bf16 ulps of the output, on inputs where the biases (K1) and the
consensus term (K2) move the output by many ulps.
"""

import numpy as np
import pytest
import torch

import glom_tpu_torch.kernels.consensus_update as k2
import glom_tpu_torch.kernels.grouped_mlp as k1
from glom_tpu_torch import GlomConfig, InferenceEngine, ServeConfig, glom_forward, init_glom
from glom_tpu_torch.ops.ffw import GroupedFFWParams

K1_BARS = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1.6e-2)}
K2_BARS = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (1e-2, 1.6e-2)}
DTYPES = [torch.float32, torch.bfloat16]

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale)


def _consensus_inputs(rng, L, B, n, d, dtype, rank=4, rms=8.0):
    """Peaked attention (levels of rank 4, score std about 4) and bu =
    -(levels + pad(td)), so the output is the consensus term over its
    divisor."""
    coef, basis = rng.standard_normal((L, B, n, rank)), rng.standard_normal((L, B, rank, d))
    lv = torch.from_numpy((rms * coef @ basis / rank ** 0.5).astype(np.float32)).to(dtype)
    td = _rand(rng, L - 1, B, n, d).to(dtype)
    td_pad = torch.cat([td.float(), torch.zeros(1, B, n, d)])
    return lv, (-(lv.float() + td_pad)).to(dtype), td


def _close(got, want, bars):
    rtol, atol = bars
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=rtol, atol=atol
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("M,d,f", [(256, 128, 512), (2048, 512, 2048)])
def test_grouped_mlp_kernel(dev, dtype, with_add, M, d, f):
    rng = np.random.default_rng(0)
    G, n = 3, 64
    params = GroupedFFWParams(
        _rand(rng, G, d, f, scale=d ** -0.5), _rand(rng, G, f, scale=0.1),
        _rand(rng, G, f, d, scale=f ** -0.5), _rand(rng, G, d, scale=0.1),
    )
    params = GroupedFFWParams(*(t.to(dev, dtype) for t in params))
    x = _rand(rng, G, M, d).to(dev, dtype)
    add = _rand(rng, n, d).to(dev, dtype) if with_add else None
    before = (k1.LAUNCHES, k1.LAUNCHES_ADD)
    got = k1.fused_grouped_ffw_lm(params, x, add=add)
    assert (k1.LAUNCHES, k1.LAUNCHES_ADD) == (before[0] + 1, before[1] + int(with_add))
    _close(got, k1.grouped_mlp_plain(params, x, add), K1_BARS[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("radius", [0.0, 2.0])
@pytest.mark.parametrize("attend_self", [False, True])
def test_consensus_update_kernel(dev, dtype, radius, attend_self):
    rng = np.random.default_rng(1)
    L, B, side, d = 3, 2, 8, 128
    n = side * side
    lv, bu, td = (t.to(dev) for t in _consensus_inputs(rng, L, B, n, d, dtype))
    before = k2.LAUNCHES
    got = k2.fused_consensus_update(lv, bu, td, side=side, radius=radius,
                                    attend_self=attend_self)
    assert k2.LAUNCHES == before + 1
    want = k2.consensus_update_plain(lv, bu, td, side=side, radius=radius,
                                     attend_self=attend_self)
    _close(got, want, K2_BARS[dtype])


def test_kernel_raises_on_unsupported_shape(dev):
    lv = torch.zeros(3, 1, 40, 128, device=dev)  # n = 40: not a multiple of 16
    with pytest.raises(ValueError, match="multiple"):
        k2.fused_consensus_update(lv, lv.clone(), lv[:2].clone(), side=1)


def test_fused_forward_matches_plain_route(dev):
    cfg = GlomConfig(dim=64, levels=3, image_size=32, patch_size=4, local_consensus_radius=2)
    params = init_glom(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    img = _rand(np.random.default_rng(2), 2, 3, 32, 32).to(dev)
    before = (k1.LAUNCHES, k2.LAUNCHES)
    got = glom_forward(params, img, cfg, iters=4, use_pallas=True)
    assert (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1]) == (8, 4)
    _close(got, glom_forward(params, img, cfg, iters=4), (2e-3, 2e-4))


def test_engine_serves_on_card(dev):
    cfg = GlomConfig(dim=64, levels=3, image_size=32, patch_size=4)
    eng = InferenceEngine(
        cfg, ServeConfig(buckets=(1, 2), compute_dtype="bfloat16",
                         use_pallas=True), device="cuda",
    )
    eng.warmup()
    res = eng.infer(np.zeros((2, 3, 32, 32), np.float32), n_valid=1)
    assert res.levels.device.type == "cuda" and res.levels.dtype == torch.bfloat16
    assert bool(torch.isfinite(res.levels.float()).all())
