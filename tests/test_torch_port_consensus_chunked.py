"""`ops/consensus_chunked.py` against glom_tpu's `chunked_consensus_attention`
and against the dense consensus of both packages, in f32.

The same inputs, made from a seed with numpy, go through glom_tpu's jax
function (on the CPU) and the port's; values and the gradients of
sum(out * w) are held at atol 1e-5 / rtol 1e-5 (the largest distance
measured here is printed by `test_report_the_largest_distance`). glom_tpu's
version raises for a chunk that does not divide n; the port's runs a shorter
last chunk, which is held to the dense op of both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu.ops.consensus import build_local_mask as tpu_mask
from glom_tpu.ops.consensus import consensus_attention as tpu_dense
from glom_tpu.ops.consensus_chunked import chunked_consensus_attention as tpu_chunked
from glom_tpu_torch.ops.consensus import build_local_mask, consensus_attention
from glom_tpu_torch.ops.consensus_chunked import chunked_consensus_attention

ATOL = RTOL = 1e-5
B, N, L, D, SIDE = 2, 16, 3, 32, 4

# (chunk_size, attend_self, radius)
CASES = [
    (4, False, 0.0),
    (8, False, 0.0),
    (16, False, 0.0),
    (512, False, 0.0),  # larger than n: one chunk
    (8, True, 1.5),
    (4, False, 2.0),
    (1, True, 0.0),
]
RAGGED = [(5, False, 0.0), (3, True, 1.5), (7, False, 2.0)]  # chunks that do not divide n


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, L, D)).astype(np.float32)
    w = rng.normal(size=(B, N, L, D)).astype(np.float32)
    return x, w


def _port(x, w, **kw):
    t = torch.tensor(x, requires_grad=True)
    out = chunked_consensus_attention(t, **kw)
    (out * torch.tensor(w)).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


def _port_dense(x, w, attend_self, radius):
    t = torch.tensor(x, requires_grad=True)
    out = consensus_attention(t, attend_self=attend_self, local_mask=build_local_mask(SIDE, radius))
    (out * torch.tensor(w)).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


def _tpu(fn, x, w):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    (g,) = vjp(jnp.asarray(w))
    return np.asarray(out), np.asarray(g)


def _kw(chunk, attend_self, radius):
    return dict(attend_self=attend_self, num_patches_side=SIDE if radius > 0 else None,
                local_radius=radius, chunk_size=chunk)


@pytest.mark.parametrize("chunk,attend_self,radius", CASES)
def test_matches_glom_tpus_chunked(chunk, attend_self, radius):
    x, w = _inputs()
    out, g = _port(x, w, **_kw(chunk, attend_self, radius))
    want, want_g = _tpu(lambda t: tpu_chunked(t, **_kw(chunk, attend_self, radius)), x, w)
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g, want_g, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk,attend_self,radius", CASES + RAGGED)
def test_matches_the_dense_op(chunk, attend_self, radius):
    x, w = _inputs(1)
    out, g = _port(x, w, **_kw(chunk, attend_self, radius))
    want, want_g = _port_dense(x, w, attend_self, radius)
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g, want_g, rtol=RTOL, atol=ATOL)
    tpu_want, tpu_g = _tpu(lambda t: tpu_dense(t, attend_self=attend_self,
                                              local_mask=tpu_mask(SIDE, radius)), x, w)
    np.testing.assert_allclose(out, tpu_want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g, tpu_g, rtol=RTOL, atol=ATOL)


def test_a_ragged_chunk_is_where_glom_tpu_raises():
    x, _ = _inputs()
    with pytest.raises(ValueError, match="divisible"):
        tpu_chunked(jnp.asarray(x), chunk_size=5)
    assert chunked_consensus_attention(torch.tensor(x), chunk_size=5).shape == (B, N, L, D)


def test_arguments_are_checked():
    x = torch.zeros(1, N, 2, 8)
    with pytest.raises(ValueError, match="num_patches_side"):
        chunked_consensus_attention(x, local_radius=1.5)
    with pytest.raises(ValueError, match="chunk_size"):
        chunked_consensus_attention(x, chunk_size=0)


def test_keeps_the_input_dtype_and_computes_in_f32():
    x, _ = _inputs()
    got = chunked_consensus_attention(torch.tensor(x).to(torch.bfloat16), chunk_size=4)
    assert got.dtype == torch.bfloat16
    want = consensus_attention(torch.tensor(x).to(torch.bfloat16).float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=1.6e-2, rtol=1e-2)


def test_report_the_largest_distance(capsys):
    worst = 0.0
    for chunk, attend_self, radius in CASES:
        x, w = _inputs()
        out, g = _port(x, w, **_kw(chunk, attend_self, radius))
        want, want_g = _tpu(lambda t: tpu_chunked(t, **_kw(chunk, attend_self, radius)), x, w)
        worst = max(worst, float(np.abs(out - want).max()), float(np.abs(g - want_g).max()))
    with capsys.disabled():
        print(f"\nchunked consensus: largest |port - glom_tpu| over values and grads {worst:.3g}")
    assert worst < ATOL
