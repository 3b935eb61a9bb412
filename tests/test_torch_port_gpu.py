"""The port's CUDA kernels, fused path and trainer on the card, against
their plain PyTorch versions. Every test here is marked `gpu` and skips
without a CUDA device. The file imports no JAX, so it also runs where JAX
is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py

f32 tolerances are glom_tpu's own kernel bars (tests/test_kernels.py:26,
:275) and its model bar (tests/test_model.py:43). bf16 kernel bars are about
1-2 bf16 ulps of the output, on inputs where the biases (K1) and the
consensus term (K2) move the output by many ulps. Backward outputs are held
to max abs error over max |want|, at chip_smoke.py's bars.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import glom_tpu_torch.kernels.consensus_update as k2
import glom_tpu_torch.kernels.grouped_mlp as k1
from glom_tpu_torch import (
    GlomConfig,
    InferenceEngine,
    ServeConfig,
    TrainConfig,
    Trainer,
    glom_forward,
    init_glom,
)
from glom_tpu_torch.data import prefetch_to_device, shapes_dataset
from glom_tpu_torch.models.core import param_leaves, unflatten_params
from glom_tpu_torch.ops.ffw import GroupedFFWParams
from glom_tpu_torch.train import denoise_loss, init_denoise

K1_BARS = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1.6e-2)}
K2_BARS = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (1e-2, 1.6e-2)}
K1_BWD_BARS = {torch.float32: 8e-6, torch.bfloat16: 2.5e-2}
K2_BWD_BARS = {torch.float32: 4e-5, torch.bfloat16: 1.8e-2}
DTYPES = [torch.float32, torch.bfloat16]

pytestmark = pytest.mark.gpu
REPO = pathlib.Path(__file__).resolve().parent.parent


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


# K1 shapes: small, the flagship, and edge shapes of the bf16 GEMM (M not a
# multiple of its 128-row tile, d = 64 and f = 192 not of its 128 columns).
K1_SHAPES = [(256, 128, 512), (2048, 512, 2048), (2080, 64, 192), (2112, 64, 192)]


def _addend_rows(M):
    """n = 64 where it divides M (it wraps twice in a 128-row tile), else 32."""
    return 64 if M % 64 == 0 else 32


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("M,d,f", K1_SHAPES)
def test_grouped_mlp_kernel(dev, dtype, with_add, M, d, f):
    rng = np.random.default_rng(0)
    G, n = 3, _addend_rows(M)
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


# K2 forward cases (dtype, L, B, n, side, d, radius): both kernels on a small
# local grid; then the bf16 kernel at n % 64 == 32 (rows and keys past its
# 64-row tiles), a row shorter than one tile, the flagship and long rows,
# global and local.
K2_CASES = [(dt, 3, 2, 64, 8, 128, r) for dt in DTYPES for r in (0.0, 2.0)] + [
    (torch.bfloat16, 2, 2, n, side, 512, r)
    for n, side, r in ((32, 1, 0.0), (96, 1, 0.0), (160, 1, 0.0), (256, 16, 0.0),
                       (256, 16, 3.0), (4096, 64, 0.0), (4096, 64, 3.0))]
# The forward's row statistics against the plain version (chip_smoke.py's
# stat_bars): in bf16 a k element may round the other way in the two
# versions (its norm summed in another order), moving a column of scores.
K2_STAT_BARS = {torch.float32: {"m": K2_BARS[torch.float32], "l": K2_BARS[torch.float32]},
                torch.bfloat16: {"m": (1e-3, 1e-3), "l": (8e-3, 1e-5)}}
# cons against the plain version: p is rounded to bf16 at the kernel's
# running max and at the plain version's final one, so on these peaked
# inputs a cons that cancels to about 0.01 can miss K2_BARS's atol. Over
# the bf16 cases here and seeds 0-7 (`kernel_probe.py k2`, NVIDIA H100)
# cons needed at most atol 0.028 at rtol 1e-2; a cons store scaled by
# 1 + 2^-5 needs 1.84, the key mask past n dropped 6.88. out keeps K2_BARS.
K2_CONS_BARS = {torch.float32: K2_BARS[torch.float32], torch.bfloat16: (1e-2, 5e-2)}


@pytest.mark.parametrize("dtype,L,B,n,side,d,radius", K2_CASES)
@pytest.mark.parametrize("attend_self", [False, True])
def test_consensus_update_kernel(dev, dtype, L, B, n, side, d, radius, attend_self):
    """The kernel against the plain version; out the same bits with and
    without the stats and cons stores, m and l with and without cons."""
    rng = np.random.default_rng(1)
    lv, bu, td = (t.to(dev) for t in _consensus_inputs(rng, L, B, n, d, dtype))
    kw = dict(side=side, radius=radius, attend_self=attend_self)
    before = (k2.LAUNCHES, k2.LAUNCHES_CONS)
    plain = k2.fused_consensus_update(lv, bu, td, **kw)
    stats = k2.fused_consensus_update(lv, bu, td, stats=True, **kw)
    cons = k2.fused_consensus_update(lv, bu, td, cons=True, **kw)
    assert (k2.LAUNCHES, k2.LAUNCHES_CONS) == (before[0] + 3, before[1] + 1)
    assert torch.equal(plain, stats[0]) and torch.equal(plain, cons[0])
    assert torch.equal(stats[1], cons[1]) and torch.equal(stats[2], cons[2])
    want = k2.consensus_update_plain(lv, bu, td, cons=True, **kw)
    _close(cons[0], want[0], K2_BARS[dtype])
    _close(cons[1], want[1], K2_STAT_BARS[dtype]["m"])
    _close(cons[2], want[2], K2_STAT_BARS[dtype]["l"])
    _close(cons[3], want[3], K2_CONS_BARS[dtype])


@pytest.mark.parametrize("n", [96, 4096])
def test_consensus_update_khat_prepass(dev, monkeypatch, n):
    """The bf16 pre-pass writes k = normalize(levels), rounded, into the
    scratch the attention reads: within one bf16 ulp of the plain
    version's k (the norm is summed in another order)."""
    rng = np.random.default_rng(23)
    lv, bu, td = (t.to(dev) for t in _consensus_inputs(rng, 2, 2, n, 512, torch.bfloat16))
    held = []
    monkeypatch.setattr(k2, "khat_scratch", lambda t, make=k2.khat_scratch: held.append(make(t))
                        or held[-1])
    k2.fused_consensus_update(lv, bu, td, side=1)
    torch.cuda.synchronize()
    assert len(held) == 1
    _close(held[0], k2._normalized_k(lv), (2.0 ** -7, 0.0))


def test_consensus_update_without_allocator_cache(dev):
    """The forward's scratch lives through its launch: with the caching
    allocator off, a tensor freed early is returned by cudaFree before the
    kernel writes it. Runs in a fresh process (the switch is read once)."""
    script = (
        "import torch, glom_tpu_torch.kernels.consensus_update as k2\n"
        "g = torch.Generator().manual_seed(0)\n"
        "lv, bu, td = (torch.randn(*s, generator=g).to('cuda', torch.bfloat16)\n"
        "              for s in ((2, 2, 256, 512), (2, 2, 256, 512), (1, 2, 256, 512)))\n"
        "got = [k2.fused_consensus_update(lv, bu, td, side=16) for _ in range(3)]\n"
        "want = k2.consensus_update_plain(lv, bu, td, side=16)\n"
        "torch.testing.assert_close(got[0].float(), want.float(), rtol=1e-2, atol=1.6e-2)\n"
        "assert all(torch.equal(got[0], x) for x in got[1:])\n"
    )
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("G, M, d, f", [(4, 32, 64, 256), (4, 128, 64, 256), (3, 64, 64, 192)])
def test_grouped_mlp_biases_at_an_allocation_end(dev, G, M, d, f):
    """K1's bf16 forward reads b1 and b2 for the tile's columns only: with
    d (or f) not a multiple of the 128-column tile, the epilogue evaluates
    columns past the end, and it once read the bias there, past the last
    group's row and the buffer's end (an illegal address where the buffer
    ends an allocation, found on the card by the small-width distributed
    run). Fresh process, caching allocator off, each bias the last bytes
    of its own 2 MiB allocation."""
    script = (
        "import sys, torch\n"
        "import glom_tpu_torch.kernels.grouped_mlp as k1\n"
        "from glom_tpu_torch.ops.ffw import GroupedFFWParams\n"
        f"G, M, d, f = {G}, {M}, {d}, {f}\n"
        "g = torch.Generator().manual_seed(0)\n"
        "def at_end(*shape):\n"
        "    n = shape[0] * shape[1]\n"
        "    big = torch.empty(1 << 20, dtype=torch.bfloat16, device='cuda')\n"
        "    v = big[-n:].view(*shape)\n"
        "    v.copy_(torch.randn(*shape, generator=g).mul(0.1))\n"
        "    return v, big\n"
        "w1 = torch.randn(G, d, f, generator=g).mul(0.1).to('cuda', torch.bfloat16)\n"
        "w2 = torch.randn(G, f, d, generator=g).mul(0.1).to('cuda', torch.bfloat16)\n"
        "(b1, k1_), (b2, k2_) = at_end(G, f), at_end(G, d)\n"
        "x = torch.randn(G, M, d, generator=g).to('cuda', torch.bfloat16)\n"
        "p = GroupedFFWParams(w1, b1, w2, b2)\n"
        "got = [k1.fused_grouped_ffw_lm(p, x) for _ in range(3)]\n"
        "torch.cuda.synchronize()\n"
        "want = k1.grouped_mlp_plain(GroupedFFWParams(*(t.cpu() for t in p)), x.cpu())\n"
        "torch.testing.assert_close(got[0].cpu().float(), want.float(), rtol=1e-2, atol=1.6e-2)\n"
        "assert all(torch.equal(got[0], y) for y in got[1:])\n"
    )
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_consensus_update_bf16_rows_do_not_depend_on_batch(dev):
    """Image b alone gives the bits it gives inside a batch of 8, and two
    launches give the same bits."""
    rng = np.random.default_rng(21)
    lv, bu, td = (t.to(dev) for t in _consensus_inputs(rng, 6, 8, 256, 512, torch.bfloat16))
    full = k2.fused_consensus_update(lv, bu, td, side=16, cons=True)
    again = k2.fused_consensus_update(lv, bu, td, side=16, cons=True)
    one = k2.fused_consensus_update(*(t[:, 3:4].contiguous() for t in (lv, bu, td)), side=16,
                                    cons=True)
    for a, b, c in zip(full, again, one):
        assert torch.equal(a, b) and torch.equal(a[:, 3:4], c)


K2_WIDTHS = [64, 128, 384, 576, 640]


@pytest.mark.parametrize("d", K2_WIDTHS)
def test_consensus_update_bf16_widths(dev, d):
    """Widths that fill a warpgroup's four 64-column chunks in part (the
    rest past d) and a second block of columns past 512."""
    rng = np.random.default_rng(22)
    lv, bu, td = (t.to(dev) for t in _consensus_inputs(rng, 3, 2, 96, d, torch.bfloat16))
    got = k2.fused_consensus_update(lv, bu, td, side=1, cons=True)
    want = k2.consensus_update_plain(lv, bu, td, side=1, cons=True)
    _close(got[0], want[0], K2_BARS[torch.bfloat16])
    _close(got[3], want[3], K2_CONS_BARS[torch.bfloat16])


def test_consensus_update_bf16_refuses_wide_rows(dev):
    """d > 640: the q and k tiles no longer fit in shared memory."""
    lv = torch.zeros(2, 1, 64, 704, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="consensus_update_fwd"):
        k2.fused_consensus_update(lv, lv.clone(), lv[:1].clone(), side=1)


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
        cfg, ServeConfig(buckets=(1, 2), max_batch=2, compute_dtype="bfloat16",
                         use_pallas=True), device="cuda",
    )
    eng.warmup()
    res = eng.infer(np.zeros((2, 3, 32, 32), np.float32), n_valid=1)
    assert res.levels.device.type == "cuda" and res.levels.dtype == torch.bfloat16
    assert bool(torch.isfinite(res.levels.float()).all())


def _rel_close(got, want, bar, what=""):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    assert err <= bar, (what, err, bar)


def _ffw_params(rng, G, d, f, dev, dtype):
    params = GroupedFFWParams(
        _rand(rng, G, d, f, scale=d ** -0.5), _rand(rng, G, f, scale=0.1),
        _rand(rng, G, f, d, scale=f ** -0.5), _rand(rng, G, d, scale=0.1),
    )
    return GroupedFFWParams(*(t.to(dev, dtype) for t in params))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("saved_pre", [True, False])  # h from pre, or recomputed
def test_grouped_mlp_bwd_kernel(dev, dtype, with_add, saved_pre):
    rng = np.random.default_rng(3)
    G, M, d, f, n = 3, 256, 128, 512, 64
    params = _ffw_params(rng, G, d, f, dev, dtype)
    x, g = (_rand(rng, G, M, d).to(dev, dtype) for _ in range(2))
    add = _rand(rng, n, d).to(dev, dtype) if with_add else None
    pre = None
    if saved_pre:
        pre = k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1]
    before = (k1.LAUNCHES_BWD, k1.LAUNCHES_BWD_ADD)
    dx, grads, da = k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre)
    assert (k1.LAUNCHES_BWD, k1.LAUNCHES_BWD_ADD) == (before[0] + 1, before[1] + int(with_add))
    want = k1.grouped_mlp_bwd_plain(params, x, g, add, pre)
    for name, got, exp in zip(("dx", "dw1", "db1", "dw2", "db2"), (dx, *grads), (want[0], *want[1])):
        _rel_close(got, exp, K1_BWD_BARS[dtype], name)
    if with_add:
        _rel_close(da, want[2], K1_BWD_BARS[dtype], "da")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("radius", [0.0, 2.0])
@pytest.mark.parametrize("attend_self", [False, True])
def test_consensus_update_bwd_kernels(dev, dtype, radius, attend_self):
    rng = np.random.default_rng(4)
    L, B, side, d = 3, 2, 8, 128
    n = side * side
    lv, bu, td = (t.to(dev) for t in _consensus_inputs(rng, L, B, n, d, dtype))
    g = _rand(rng, L, B, n, d).to(dev, dtype)
    kw = dict(side=side, radius=radius, attend_self=attend_self)
    out, m, l = k2.fused_consensus_update(lv, bu, td, stats=True, **kw)
    torch.testing.assert_close(out, k2.fused_consensus_update(lv, bu, td, **kw), rtol=0, atol=0)
    before = (k2.LAUNCHES_BWD_DQ, k2.LAUNCHES_BWD_DKV)
    dq, dd, dcons = k2.consensus_bwd_dq(lv, g, m, l, **kw)
    dlv, dmean = k2.consensus_bwd_dkv(lv, g, m, l, dq, dd, dcons, **kw)
    assert (k2.LAUNCHES_BWD_DQ, k2.LAUNCHES_BWD_DKV) == (before[0] + 1, before[1] + 1)
    want_dq, want_dd = k2.consensus_bwd_dq_plain(lv, g, m, l, **kw)
    want_dlv, want_dmean = k2.consensus_bwd_dkv_plain(lv, g, m, l, want_dq, want_dd, **kw)
    for name, got, exp in (("dq", dq, want_dq), ("dd", dd, want_dd),
                           ("dlevels", dlv, want_dlv), ("dmean", dmean, want_dmean)):
        _rel_close(got, exp, K2_BWD_BARS[dtype], name)


def test_fused_forward_gradients_reach_every_leaf(dev):
    """The fused route under grad on the card: every leaf gets a nonzero
    gradient, close to the plain route's, through the backward kernels."""
    cfg = GlomConfig(dim=64, levels=3, image_size=32, patch_size=4, local_consensus_radius=2)
    params = init_denoise(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(5)
    img, noise = (_rand(rng, 2, 3, 32, 32).to(dev) for _ in range(2))
    grads = {}
    for use_pallas in (True, False):
        leaves = [t.clone().requires_grad_() for t in param_leaves(params)]
        before = (k1.LAUNCHES_BWD, k2.LAUNCHES_BWD_DKV)
        loss = denoise_loss(unflatten_params(params, leaves), img, noise, cfg,
                            use_pallas=use_pallas)
        grads[use_pallas] = torch.autograd.grad(loss, leaves)
        if use_pallas:  # k = T // 2 + 1 = 4 iterations: two K1 and one K2 backward each
            assert (k1.LAUNCHES_BWD - before[0], k2.LAUNCHES_BWD_DKV - before[1]) == (8, 4)
    for got, want in zip(grads[True], grads[False]):
        assert float(got.abs().max()) > 0
        _rel_close(got, want, 1e-4)


def test_trainer_on_card(dev):
    cfg = GlomConfig(dim=64, levels=3, image_size=32, patch_size=4)
    tr = Trainer(cfg, TrainConfig(batch_size=2, compute_dtype="bfloat16", use_pallas=True),
                 device="cuda")
    hist = tr.fit(shapes_dataset(2, 32), 3, log_every=1, prefetch=2)
    assert [r["vjp_path"] for r in hist] == ["scan_blockwise"] * 3
    assert all(np.isfinite(r["loss"]) for r in hist) and hist[-1]["steps_timed"] == 2


def test_prefetch_on_card(dev):
    batches = [np.full((2, 3), i, np.float32) for i in range(4)]
    got = list(prefetch_to_device(iter(batches), size=2, device=dev))
    assert all(b.device.type == "cuda" for b in got)
    assert [float(b[0, 0]) for b in got] == [0.0, 1.0, 2.0, 3.0]


# -- the whole-loop VJP (K3) ---------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("M,d,f", [K1_SHAPES[0], K1_SHAPES[2], K1_SHAPES[3]])
def test_grouped_mlp_pre_kernel(dev, dtype, with_add, M, d, f):
    """The pre-only K1 launch: the forward's saved pre, bit for bit, read
    through a slot view of a larger carry."""
    rng = np.random.default_rng(6)
    G, n = 3, _addend_rows(M)
    params = _ffw_params(rng, G, d, f, dev, dtype)
    carry = _rand(rng, G + 2, M, d).to(dev, dtype)
    x = carry[2:]  # slots 2.. of the carry, as the top-down FFW reads them
    add = _rand(rng, n, d).to(dev, dtype) if with_add else None
    before = (k1.LAUNCHES_PRE, k1.LAUNCHES_PRE_ADD)
    pre = k1.grouped_mlp_pre(params, x, add=add)
    assert (k1.LAUNCHES_PRE, k1.LAUNCHES_PRE_ADD) == (before[0] + 1, before[1] + int(with_add))
    assert torch.equal(pre, k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1])
    _close(pre, k1.grouped_mlp_pre_plain(params, x, add), K1_BARS[dtype])


@pytest.mark.parametrize("with_add", [False, True])
def test_grouped_mlp_rows_do_not_depend_on_the_grid(dev, with_add):
    """A row's bf16 output, saved pre and pre-only pre are the same bits
    whether its group runs inside G = 6 or alone at G = 1, and whether
    its rows run at M = 2048 or as the first half of M = 4096."""
    rng = np.random.default_rng(14)
    G, d, f, n = 6, 512, 2048, 256
    params = _ffw_params(rng, G, d, f, dev, torch.bfloat16)
    x = _rand(rng, G, 4096, d).to(dev, torch.bfloat16)
    add = _rand(rng, n, d).to(dev, torch.bfloat16) if with_add else None

    def run(p, xs):
        out, pre = k1.fused_grouped_ffw_lm(p, xs, add=add, save_pre=True)
        return out, pre, k1.grouped_mlp_pre(p, xs, add=add)

    full = run(params, x)
    alone = run(GroupedFFWParams(*(t[3:4].contiguous() for t in params)), x[3:4].contiguous())
    half = run(params, x[:, :2048].contiguous())
    for a, b, c in zip(full, alone, half):
        assert torch.equal(a[3:4], b)
        assert torch.equal(a[:, :2048], c)


@pytest.mark.parametrize("with_add", [False, True])
def test_grouped_mlp_slabs_equal_one_pass(dev, monkeypatch, with_add):
    """Past the hidden scratch's cap the bf16 forward runs over row slabs
    (here of 128 rows, the last one partial): the same bits as one pass."""
    rng = np.random.default_rng(15)
    G, M, d, f, n = 3, 2080, 64, 192, 32
    params = _ffw_params(rng, G, d, f, dev, torch.bfloat16)
    x = _rand(rng, G, M, d).to(dev, torch.bfloat16)
    add = _rand(rng, n, d).to(dev, torch.bfloat16) if with_add else None
    assert k1.slab_rows(G, M, f) == M
    one = (*k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True),
           k1.grouped_mlp_pre(params, x, add=add))
    monkeypatch.setattr(k1, "H_SCRATCH_CAP", G * 128 * f * 2)
    assert k1.slab_rows(G, M, f) == 128
    slabs = (*k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True),
             k1.grouped_mlp_pre(params, x, add=add))
    assert all(torch.equal(a, b) for a, b in zip(one, slabs))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_add", [False, True])
def test_grouped_mlp_bwd_acc_kernel(dev, dtype, with_add):
    """The accumulating K1 backward: incoming f32 totals (as large as one
    call's gradients) updated in place, against the plain version."""
    rng = np.random.default_rng(7)
    G, M, d, f, n = 3, 256, 128, 512, 64
    params = _ffw_params(rng, G, d, f, dev, dtype)
    x, g = (_rand(rng, G, M, d).to(dev, dtype) for _ in range(2))
    add = _rand(rng, n, d).to(dev, dtype) if with_add else None
    pre = k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1]
    scale = 4.0 if dtype == torch.bfloat16 else 0.5
    acc = GroupedFFWParams(*(_rand(rng, *t.shape, scale=scale).to(dev) for t in params))
    da_in = _rand(rng, n, d, scale=scale * 8).to(dev) if with_add else None
    want_acc = GroupedFFWParams(*(t.clone() for t in acc))
    want_da = None if da_in is None else da_in.clone()
    want = k1.grouped_mlp_bwd_plain(params, x, g, add, pre, want_acc, want_da)
    before = (k1.LAUNCHES_BWD, k1.LAUNCHES_BWD_ACC, k1.LAUNCHES_BWD_ACC_ADD)
    dx, grads, da = k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre, acc=acc, da_in=da_in)
    assert (k1.LAUNCHES_BWD, k1.LAUNCHES_BWD_ACC, k1.LAUNCHES_BWD_ACC_ADD) == (
        before[0], before[1] + 1, before[2] + int(with_add))
    assert grads is acc and da is da_in
    for name, got, exp in zip(("dx", "dw1", "db1", "dw2", "db2"), (dx, *grads), (want[0], *want[1])):
        _rel_close(got, exp, K1_BWD_BARS[dtype], name)
    if with_add:
        _rel_close(da, want[2], K1_BWD_BARS[dtype], "da")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("radius", [0.0, 2.0])
@pytest.mark.parametrize("streams", [True, False])
def test_consensus_combine_kernels(dev, dtype, radius, streams):
    """The K2 backward in combine mode: three cotangent streams, or none (the
    loop's first backward iteration), against the plain version."""
    rng = np.random.default_rng(8)
    L, B, side, d = 3, 2, 8, 128
    n = side * side
    lv, bu, td = (t.to(dev) for t in _consensus_inputs(rng, L, B, n, d, dtype))
    kw = dict(side=side, radius=radius, attend_self=False)
    _, m, l = k2.fused_consensus_update(lv, bu, td, stats=True, **kw)
    dg = _rand(rng, L, B, n, d).to(dev, dtype)
    dx_bu = _rand(rng, L, B, n, d).to(dev, dtype) if streams else None
    dx_td = _rand(rng, L - 1, B, n, d).to(dev, dtype) if streams else None
    before = (k2.LAUNCHES_BWD_DQ, k2.LAUNCHES_BWD_COMBINE_DQ, k2.LAUNCHES_BWD_COMBINE_DKV)
    dlv, dmean = k2.consensus_update_bwd(lv, dg, m, l, dx_bu=dx_bu, dx_td=dx_td, combine=True, **kw)
    assert (k2.LAUNCHES_BWD_DQ, k2.LAUNCHES_BWD_COMBINE_DQ, k2.LAUNCHES_BWD_COMBINE_DKV) == (
        before[0], before[1] + 1, before[2] + 1)
    want = k2.consensus_update_bwd_plain(lv, dg, m, l, dx_bu=dx_bu, dx_td=dx_td, **kw)
    _rel_close(dlv, want[0], K2_BWD_BARS[dtype], "dlevels")
    _rel_close(dmean, want[1], K2_BWD_BARS[dtype], "dmean")


def test_fused_loop_trains_on_card(dev):
    """At batch 8 the training forward takes the whole-loop VJP: f32 loss and
    gradients against the plain route, the loop's launch counts, and remat
    gradients equal to non-remat ones bit for bit (bf16)."""
    cfg = GlomConfig(dim=64, levels=3, image_size=32, patch_size=4, local_consensus_radius=2)
    rng = np.random.default_rng(9)
    img, noise = (_rand(rng, 8, 3, 32, 32).to(dev) for _ in range(2))
    k = 4  # T // 2 + 1 at T = 6
    params = init_denoise(cfg, generator=torch.Generator().manual_seed(0), device=dev)

    def grads(**kw):
        leaves = [t.clone().requires_grad_() for t in param_leaves(params)]
        loss = denoise_loss(unflatten_params(params, leaves), img, noise, cfg, **kw)
        return loss, torch.autograd.grad(loss, leaves)

    names = ("LAUNCHES_BWD", "LAUNCHES_BWD_ACC", "LAUNCHES_BWD_ACC_CAT", "LAUNCHES_BWD_ACC_ADD")

    def counts():
        return ([getattr(k1, nm) for nm in names]
                + [k2.LAUNCHES_BWD_COMBINE_DQ, k2.LAUNCHES_BWD_COMBINE_DKV])

    before = counts()
    loss, got = grads(use_pallas=True)
    # one accumulating K1 backward an iteration, over the combined grid
    assert [a - b for a, b in zip(counts(), before)] == [0, k, k, 0, k, k]
    want_loss, want = grads(use_pallas=False)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    for g, w in zip(got, want):
        assert float(g.abs().max()) > 0
        _rel_close(g, w, 1e-4)
    kw = dict(use_pallas=True, compute_dtype=torch.bfloat16)
    before = (k1.LAUNCHES_PRE, k1.LAUNCHES_PRE_CAT)
    _, g_remat = grads(remat=True, **kw)
    assert (k1.LAUNCHES_PRE - before[0], k1.LAUNCHES_PRE_CAT - before[1]) == (k, k)
    _, g_keep = grads(**kw)
    assert all(torch.equal(a, b) for a, b in zip(g_remat, g_keep))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_loop_cat_grid_on_card(dev, dtype):
    """The loop runs one combined-grid K1 launch a phase (forward, remat's
    pre-only, backward) and no split one; remat gives the kept pre's
    output and gradients bit for bit."""
    from glom_tpu_torch.kernels.fused_loop import fused_glom_loop

    rng = np.random.default_rng(12)
    L, B, n, d, f, iters = 4, 2, 64, 128, 512, 3
    leaves = [*_ffw_params(rng, L, d, f, dev, dtype), *_ffw_params(rng, L - 1, d, f, dev, dtype),
              _rand(rng, n, d).to(dev, dtype), _rand(rng, B, n, d).to(dev, dtype),
              _rand(rng, L, B, n, d).to(dev, dtype)]
    leaves = [t.requires_grad_() for t in leaves]
    gout = _rand(rng, L, B, n, d).to(dev, dtype)
    names = ("LAUNCHES", "LAUNCHES_CAT", "LAUNCHES_PRE", "LAUNCHES_PRE_CAT", "LAUNCHES_BWD_ACC",
             "LAUNCHES_BWD_ACC_CAT")

    def run(remat):
        before = [getattr(k1, nm) for nm in names]
        out = fused_glom_loop(GroupedFFWParams(*leaves[:4]), GroupedFFWParams(*leaves[4:8]),
                              *leaves[8:], iters, 8, 0.0, False, remat)
        res = out.detach(), torch.autograd.grad(out, leaves, grad_outputs=gout)
        return res, [getattr(k1, nm) - b for nm, b in zip(names, before)]

    keep, c_keep = run(False)
    remat, c_remat = run(True)
    assert c_keep == [iters, iters, 0, 0, iters, iters]
    assert c_remat == [iters] * 6
    assert torch.equal(keep[0], remat[0])
    assert all(torch.equal(a, b) for a, b in zip(keep[1], remat[1]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cat_grid_kernels_equal_split(dev, dtype):
    """Each combined-grid K1 launch (forward with and without the saved
    pre, pre-only, accumulating backward) against the two split launches
    on the same carry, bit for bit."""
    rng = np.random.default_rng(13)
    L, M, d, f, n = 4, 256, 128, 512, 64
    bu, td = _ffw_params(rng, L, d, f, dev, dtype), _ffw_params(rng, L - 1, d, f, dev, dtype)
    wcat = k1.cat_params(td, bu)
    carry = _rand(rng, L + 1, M, d).to(dev, dtype)
    add = _rand(rng, n, d).to(dev, dtype)
    out, pre = k1.fused_grouped_ffw_lm(wcat, carry, add=add, save_pre=True, cat=True)
    out_td, pre_td = k1.fused_grouped_ffw_lm(td, carry[2:], add=add, save_pre=True)
    out_bu, pre_bu = k1.fused_grouped_ffw_lm(bu, carry[:L], save_pre=True)
    assert torch.equal(out, torch.cat([out_td, out_bu]))
    assert torch.equal(pre, torch.cat([pre_td, pre_bu]))
    assert torch.equal(k1.fused_grouped_ffw_lm(wcat, carry, add=add, cat=True), out)
    assert torch.equal(k1.grouped_mlp_pre(wcat, carry, add=add, cat=True), pre)
    dmean = _rand(rng, L, M, d).to(dev, dtype)
    acc = GroupedFFWParams(*(_rand(rng, *t.shape).to(dev) for t in wcat))
    da_in = _rand(rng, n, d).to(dev)
    acc_td = GroupedFFWParams(*(t[: L - 1].clone() for t in acc))
    acc_bu = GroupedFFWParams(*(t[L - 1:].clone() for t in acc))
    da_split = da_in.clone()
    dx, grads, da = k1.grouped_mlp_bwd(wcat, carry, dmean, add=add, pre=pre, acc=acc,
                                       da_in=da_in, cat=True)
    dx_td, _, _ = k1.grouped_mlp_bwd(td, carry[2:], dmean[: L - 1], add=add, pre=pre_td,
                                     acc=acc_td, da_in=da_split)
    dx_bu, _, _ = k1.grouped_mlp_bwd(bu, carry[:L], dmean, pre=pre_bu, acc=acc_bu)
    assert torch.equal(dx, torch.cat([dx_td, dx_bu]))
    assert all(torch.equal(a, torch.cat([t, b])) for a, t, b in zip(grads, acc_td, acc_bu))
    assert torch.equal(da, da_split)


# -- K1's bf16 backward from the saved pre (the sm90 dh, dx and weight passes)


def _k1_bwd_kernels(run):
    """The names of the kernels one call of `run` launched (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {evt.name for evt in prof.events() if evt.device_type == DeviceType.CUDA}


@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("M,d,f", [(96, 128, 192), (160, 64, 320)])
def test_grouped_mlp_bwd_sm90_partial_k_steps(dev, with_add, accumulate, M, d, f):
    """M not a multiple of the weight pass's 64-row K step (and of the dh
    and dx passes' 128-row tiles), d and f not multiples of 128: the
    rounded-up K steps read TMA's zero fill, and the column sums with them."""
    rng = np.random.default_rng(17)
    G, n = 3, 32
    params = _ffw_params(rng, G, d, f, dev, torch.bfloat16)
    x, g = (_rand(rng, G, M, d).to(dev, torch.bfloat16) for _ in range(2))
    add = _rand(rng, n, d).to(dev, torch.bfloat16) if with_add else None
    pre = k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1]
    acc = da_in = want_acc = want_da = None
    if accumulate:
        acc = GroupedFFWParams(*(_rand(rng, *t.shape, scale=4.0).to(dev) for t in params))
        da_in = _rand(rng, n, d, scale=32.0).to(dev) if with_add else None
        want_acc = GroupedFFWParams(*(t.clone() for t in acc))
        want_da = None if da_in is None else da_in.clone()
    want = k1.grouped_mlp_bwd_plain(params, x, g, add, pre, want_acc, want_da)
    dx, grads, da = k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre, acc=acc, da_in=da_in)
    for name, got, exp in zip(("dx", "dw1", "db1", "dw2", "db2"), (dx, *grads), (want[0], *want[1])):
        _rel_close(got, exp, K1_BWD_BARS[torch.bfloat16], name)
    if with_add:
        _rel_close(da, want[2], K1_BWD_BARS[torch.bfloat16], "da")


def test_grouped_mlp_bwd_sm90_cat_equals_split(dev):
    """The 11-group combined launch in accumulate mode, at the flagship's
    level count, against its split pair on the same carry and dmean, bit
    for bit."""
    rng = np.random.default_rng(19)
    L, M, d, f, n = 6, 256, 128, 512, 64
    dtype = torch.bfloat16
    bu, td = _ffw_params(rng, L, d, f, dev, dtype), _ffw_params(rng, L - 1, d, f, dev, dtype)
    wcat = k1.cat_params(td, bu)
    carry = _rand(rng, L + 1, M, d).to(dev, dtype)
    add = _rand(rng, n, d).to(dev, dtype)
    pre = k1.fused_grouped_ffw_lm(wcat, carry, add=add, save_pre=True, cat=True)[1]
    dmean = _rand(rng, L, M, d).to(dev, dtype)
    acc = GroupedFFWParams(*(_rand(rng, *t.shape).to(dev) for t in wcat))
    da_in = _rand(rng, n, d).to(dev)
    acc_td = GroupedFFWParams(*(t[: L - 1].clone() for t in acc))
    acc_bu = GroupedFFWParams(*(t[L - 1:].clone() for t in acc))
    da_split = da_in.clone()
    dx, grads, da = k1.grouped_mlp_bwd(wcat, carry, dmean, add=add, pre=pre, acc=acc,
                                       da_in=da_in, cat=True)
    dx_td, _, _ = k1.grouped_mlp_bwd(td, carry[2:], dmean[: L - 1], add=add, pre=pre[: L - 1],
                                     acc=acc_td, da_in=da_split)
    dx_bu, _, _ = k1.grouped_mlp_bwd(bu, carry[:L], dmean, pre=pre[L - 1:], acc=acc_bu)
    assert torch.equal(dx, torch.cat([dx_td, dx_bu]))
    assert all(torch.equal(a, torch.cat([t, b])) for a, t, b in zip(grads, acc_td, acc_bu))
    assert torch.equal(da, da_split)


@pytest.mark.parametrize("saved_pre", [True, False])
def test_grouped_mlp_bwd_bf16_path_by_pre(dev, saved_pre):
    """The bf16 C entry picks its path from pre alone: from the saved pre
    the sm90 dh, dx and weight passes, without it (the recompute past
    SAVE_PRE_LIMIT) the WMMA row and weight passes, which are still right."""
    rng = np.random.default_rng(23)
    G, M, d, f, n = 3, 256, 128, 512, 64
    params = _ffw_params(rng, G, d, f, dev, torch.bfloat16)
    x, g = (_rand(rng, G, M, d).to(dev, torch.bfloat16) for _ in range(2))
    add = _rand(rng, n, d).to(dev, torch.bfloat16)
    pre = k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1] if saved_pre else None
    names = _k1_bwd_kernels(lambda: k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre))
    sm90 = {"mlp_bwd_dh_sm90", "mlp_bwd_dx_sm90", "mlp_bwd_dw_sm90", "mlp_bwd_addend_bf16"}
    wmma = {"mlp_bwd_rows_bf16", "mlp_bwd_weights_bf16"}
    ran = {k for k in sm90 | wmma if any(k in name for name in names)}
    assert ran == (sm90 if saved_pre else wmma), names
    dx, grads, da = k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre)
    want = k1.grouped_mlp_bwd_plain(params, x, g, add, pre)
    for name, got, exp in zip(("dx", "dw1", "db1", "dw2", "db2", "da"), (dx, *grads, da),
                              (want[0], *want[1], want[2])):
        _rel_close(got, exp, K1_BWD_BARS[torch.bfloat16], name)


@pytest.mark.parametrize("accumulate", [False, True])
def test_grouped_mlp_bwd_sm90_repeats_bit_for_bit(dev, accumulate):
    """Two calls on the same inputs give the same bits: one consumer owns
    each tile and its column sums, and no sum is taken with atomics."""
    rng = np.random.default_rng(29)
    G, M, d, f, n = 3, 512, 128, 512, 64
    params = _ffw_params(rng, G, d, f, dev, torch.bfloat16)
    x, g = (_rand(rng, G, M, d).to(dev, torch.bfloat16) for _ in range(2))
    add = _rand(rng, n, d).to(dev, torch.bfloat16)
    pre = k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1]
    acc0 = GroupedFFWParams(*(_rand(rng, *t.shape).to(dev) for t in params))
    da0 = _rand(rng, n, d).to(dev)

    def run():
        if not accumulate:
            return k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre)
        acc, da_in = GroupedFFWParams(*(t.clone() for t in acc0)), da0.clone()
        return k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre, acc=acc, da_in=da_in)

    first, second = run(), run()
    assert torch.equal(first[0], second[0]) and torch.equal(first[2], second[2])
    assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))


@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("M,d,f", [(96, 128, 192), (2048, 512, 2048)])
def test_forward_instance_unchanged_by_the_backward(dev, with_add, M, d, f):
    """The mainloop's forward instance (A K-major, B MN-major) beside the
    backward's: the pre-only launch still equals the saved pre bit for bit,
    before and after a backward call built from the same header."""
    rng = np.random.default_rng(31)
    G, n = 3, 32
    params = _ffw_params(rng, G, d, f, dev, torch.bfloat16)
    x, g = (_rand(rng, G, M, d).to(dev, torch.bfloat16) for _ in range(2))
    add = _rand(rng, n, d).to(dev, torch.bfloat16) if with_add else None
    out, pre = k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)
    assert torch.equal(k1.grouped_mlp_pre(params, x, add=add), pre)
    k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre)
    assert torch.equal(k1.grouped_mlp_pre(params, x, add=add), pre)
    assert torch.equal(k1.fused_grouped_ffw_lm(params, x, add=add), out)
    _close(pre, k1.grouped_mlp_pre_plain(params, x, add), K1_BARS[torch.bfloat16])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("radius", [0.0, 3.0])
def test_consensus_cons_output(dev, dtype, radius):
    """The forward's cons store: cons against the plain version, and out,
    m, l unchanged by it, bit for bit."""
    rng = np.random.default_rng(14)
    L, B, side, d = 2, 1, 24, 128
    lv, bu, td = (t.to(dev) for t in _consensus_inputs(rng, L, B, side * side, d, dtype))
    kw = dict(side=side, radius=radius, attend_self=False)
    before = (k2.LAUNCHES, k2.LAUNCHES_CONS)
    out, m, l, cons = k2.fused_consensus_update(lv, bu, td, cons=True, **kw)
    assert (k2.LAUNCHES, k2.LAUNCHES_CONS) == (before[0] + 1, before[1] + 1)
    for a, b in zip((out, m, l), k2.fused_consensus_update(lv, bu, td, stats=True, **kw)):
        assert torch.equal(a, b)
    _close(cons, k2.consensus_update_plain(lv, bu, td, cons=True, **kw)[3], K2_BARS[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("radius", [0.0, 3.0])
@pytest.mark.parametrize("attend_self", [False, True])
def test_consensus_onesweep_kernel(dev, dtype, radius, attend_self):
    """The one-sweep backward at n = 576 against its plain version, and the
    same bits on a second run (no atomics)."""
    rng = np.random.default_rng(15)
    L, B, side, d = 2, 2, 24, 128
    lv, bu, td = (t.to(dev) for t in _consensus_inputs(rng, L, B, side * side, d, dtype))
    g = _rand(rng, L, B, side * side, d).to(dev, dtype)
    kw = dict(side=side, radius=radius, attend_self=attend_self)
    _, m, l, cons = k2.fused_consensus_update(lv, bu, td, cons=True, **kw)
    before = (k2.LAUNCHES_BWD_ONESWEEP, k2.LAUNCHES_BWD_DQ, k2.LAUNCHES_BWD_DKV)
    got = k2.consensus_bwd_onesweep(lv, g, m, l, cons, **kw)
    again = k2.consensus_bwd_onesweep(lv, g, m, l, cons, **kw)
    assert (k2.LAUNCHES_BWD_ONESWEEP, k2.LAUNCHES_BWD_DQ, k2.LAUNCHES_BWD_DKV) == (
        before[0] + 2, before[1], before[2])
    assert torch.equal(got, again)
    _rel_close(got, k2.consensus_bwd_onesweep_plain(lv, g, m, l, cons, **kw),
               K2_BWD_BARS[dtype], "dlevels")


def test_consensus_vjp_long_row_on_card(dev):
    """At n = 576 the differentiable update saves cons and runs the
    one-sweep: f32 gradients against autograd through the plain version."""
    rng = np.random.default_rng(16)
    L, B, side, d = 3, 1, 24, 128
    ins = [t.to(dev).requires_grad_() for t in _consensus_inputs(
        rng, L, B, side * side, d, torch.float32)]
    w = _rand(rng, L, B, side * side, d).to(dev)
    before = (k2.LAUNCHES_BWD_ONESWEEP, k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_CONS)
    got = torch.autograd.grad((k2.consensus_update_vjp(*ins, side=side) * w).sum(), ins)
    assert (k2.LAUNCHES_BWD_ONESWEEP, k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_CONS) == (
        before[0] + 1, before[1], before[2] + 1)
    want = torch.autograd.grad((k2.consensus_update_plain(*ins, side=side) * w).sum(), ins)
    for name, a, b in zip(("levels", "bu", "td"), got, want):
        _rel_close(a, b, 1e-4, name)


# The bf16 backward's "wgmma" instance (k2_bwd_instance): (L, B, n, side,
# d, radius, inputs). Peaked inputs (rank 4, rms 8) and flat ones (iid unit
# variance: under radius 1 the diagonal carries about a fifth of each row's
# weight, so the diagonal rule shows) at radius 0, 1 and 3; n = 32 x odd
# (the last 64-row block half past n); widths that fill a warpgroup's
# chunks in part (64), all of them (512) and the 16-row tiles past 512.
K2_BWD_WGMMA_CASES = [
    (3, 2, 64, 8, 128, radius, inputs)
    for radius in (0.0, 1.0, 3.0) for inputs in ("peaked", "flat")
] + [
    (2, 2, 96, 1, 128, 0.0, "peaked"),
    (2, 1, 160, 1, 512, 0.0, "peaked"),
    (2, 1, 96, 1, 64, 0.0, "flat"),
    (2, 1, 96, 1, 576, 0.0, "peaked"),
    (2, 1, 96, 1, 640, 0.0, "peaked"),
    (2, 1, 256, 16, 512, 1.0, "flat"),
]
K2_BWD_FORMS = ["pair", "combine", "onesweep"]


def _k2_bwd_case(rng, L, B, n, side, d, radius, inputs, attend_self, form,
                 dtype=torch.bfloat16):
    """One backward on the card and its plain version on the same inputs:
    {output: (got, want)}. "pair": the dq and dkv passes; "combine": the
    same with the loop's two cotangent streams; "onesweep": from the saved
    cons."""
    if inputs == "peaked":
        lv, bu, td = _consensus_inputs(rng, L, B, n, d, dtype)
    else:
        lv, bu, td = (_rand(rng, *s).to(dtype)
                      for s in ((L, B, n, d), (L, B, n, d), (L - 1, B, n, d)))
    lv, bu, td = (t.cuda() for t in (lv, bu, td))
    g = _rand(rng, L, B, n, d).to("cuda", dtype)
    kw = dict(side=side, radius=radius, attend_self=attend_self)
    if form == "onesweep":
        _, m, l, cons = k2.fused_consensus_update(lv, bu, td, cons=True, **kw)
        got = k2.consensus_bwd_onesweep(lv, g, m, l, cons, **kw)
        return {"dlevels": (got, k2.consensus_bwd_onesweep_plain(lv, g, m, l, cons, **kw))}
    _, m, l = k2.fused_consensus_update(lv, bu, td, stats=True, **kw)
    streams = {}
    if form == "combine":
        streams = dict(dx_bu=_rand(rng, L, B, n, d).to("cuda", dtype),
                       dx_td=_rand(rng, L - 1, B, n, d).to("cuda", dtype))
    combine = form == "combine"
    dq, dd, dcons = k2.consensus_bwd_dq(lv, g, m, l, combine=combine, **streams, **kw)
    dlv, dmean = k2.consensus_bwd_dkv(lv, g, m, l, dq, dd, dcons, combine=combine, **streams,
                                      **kw)
    want_dq, want_dd = k2.consensus_bwd_dq_plain(lv, g, m, l, **streams, **kw)
    want_dlv, want_dmean = k2.consensus_bwd_dkv_plain(lv, g, m, l, want_dq, want_dd, **streams,
                                                      **kw)
    return {"dq": (dq, want_dq), "dd": (dd, want_dd), "dcons": (dcons, want_dmean),
            "dlevels": (dlv, want_dlv), "dmean": (dmean, want_dmean)}


@pytest.mark.parametrize("L,B,n,side,d,radius,inputs", K2_BWD_WGMMA_CASES)
@pytest.mark.parametrize("attend_self", [False, True])
@pytest.mark.parametrize("form", K2_BWD_FORMS)
def test_consensus_bwd_wgmma(dev, L, B, n, side, d, radius, inputs, attend_self, form):
    """The bf16 backward's "wgmma" instance against its plain version, every
    output at K2_BWD_BARS (the rounded dcons against the plain dcons's
    rounding)."""
    assert k2.k2_bwd_instance(torch.bfloat16, n, d) == "wgmma"
    res = _k2_bwd_case(np.random.default_rng(31), L, B, n, side, d, radius, inputs,
                       attend_self, form)
    for name, (got, want) in res.items():
        _rel_close(got, want, K2_BWD_BARS[torch.bfloat16], name)


@pytest.mark.parametrize("form", K2_BWD_FORMS)
def test_consensus_bwd_wgmma_repeats_bit_for_bit(dev, form):
    """Two launches on the same inputs give the same bits (no atomics, fixed
    tile shapes), at the flagship width."""
    runs = [_k2_bwd_case(np.random.default_rng(32), 2, 2, 256, 16, 512, 0.0, "peaked", False,
                         form) for _ in range(2)]
    for name in runs[0]:
        assert torch.equal(runs[0][name][0], runs[1][name][0]), name


@pytest.mark.parametrize("L,B,n,side,d,radius,inputs", [K2_BWD_WGMMA_CASES[i]
                                                         for i in (0, 5, 6, 10)])
@pytest.mark.parametrize("combine", [False, True])
def test_consensus_bwd_entry_shares_the_keys(dev, L, B, n, side, d, radius, inputs, combine):
    """`consensus_update_bwd` hands the keys its dq pass normalised to its
    dkv pass: the same bits as the two passes called alone (the dkv pass
    then normalises them again), one launch of each pass."""
    rng = np.random.default_rng(33)
    lv, bu, td = (t.cuda() for t in _consensus_inputs(rng, L, B, n, d, torch.bfloat16))
    g = _rand(rng, L, B, n, d).to("cuda", torch.bfloat16)
    kw = dict(side=side, radius=radius, attend_self=False, combine=combine)
    if combine:
        kw.update(dx_bu=_rand(rng, L, B, n, d).to("cuda", torch.bfloat16),
                  dx_td=_rand(rng, L - 1, B, n, d).to("cuda", torch.bfloat16))
    _, m, l = k2.fused_consensus_update(lv, bu, td, stats=True, side=side, radius=radius)
    dq, dd, dcons = k2.consensus_bwd_dq(lv, g, m, l, **kw)
    alone = k2.consensus_bwd_dkv(lv, g, m, l, dq, dd, dcons, **kw)
    counts = ("LAUNCHES_BWD_COMBINE_DQ", "LAUNCHES_BWD_COMBINE_DKV") if combine else (
        "LAUNCHES_BWD_DQ", "LAUNCHES_BWD_DKV")
    before = [getattr(k2, c) for c in counts]
    entry = k2.consensus_update_bwd(lv, g, m, l, **kw)
    assert [getattr(k2, c) for c in counts] == [b + 1 for b in before]
    for name, a, b in zip(("dlevels", "dmean"), entry, alone):
        assert torch.equal(a, b), name


def test_consensus_bwd_without_allocator_cache(dev):
    """The backward's scratches (the normalised keys, dv, and the one-sweep's
    dq, dd and dcons) live through their launches: with the caching
    allocator off, a tensor freed early is returned by cudaFree before a
    kernel reads or writes it. Runs in a fresh process (the switch is read
    once)."""
    script = (
        "import torch, glom_tpu_torch.kernels.consensus_update as k2\n"
        "g = torch.Generator().manual_seed(0)\n"
        "lv, bu, td, go = (torch.randn(*s, generator=g).to('cuda', torch.bfloat16)\n"
        "    for s in ((2, 2, 256, 512), (2, 2, 256, 512), (1, 2, 256, 512), (2, 2, 256, 512)))\n"
        "_, m, l, cons = k2.fused_consensus_update(lv, bu, td, side=16, cons=True)\n"
        "pair = [k2.consensus_update_bwd(lv, go, m, l, side=16) for _ in range(3)]\n"
        "one = [k2.consensus_bwd_onesweep(lv, go, m, l, cons, side=16) for _ in range(3)]\n"
        "want = k2.consensus_update_bwd_plain(lv, go, m, l, side=16)\n"
        "want1 = k2.consensus_bwd_onesweep_plain(lv, go, m, l, cons, side=16)\n"
        "def rel(a, b):\n"
        "    return float((a.float() - b.float()).abs().max() / b.float().abs().max())\n"
        f"assert rel(pair[0][0], want[0]) <= {K2_BWD_BARS[torch.bfloat16]}\n"
        f"assert rel(one[0], want1) <= {K2_BWD_BARS[torch.bfloat16]}\n"
        "assert all(torch.equal(pair[0][0], x[0]) for x in pair[1:])\n"
        "assert all(torch.equal(one[0], x) for x in one[1:])\n"
    )
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_consensus_bwd_entry_refuses_another_instance(dev):
    """The C entries check the caller's instance against their own rule."""
    lib = k2._bwd_lib()
    L, B, n, d = 2, 1, 64, 128
    lv = torch.zeros(L, B, n, d, device=dev, dtype=torch.bfloat16)
    m = torch.zeros(L, B, n, 1, device=dev)
    dq, dd = torch.empty(L, B, n, d, device=dev), torch.empty_like(m)
    dcons, khat = torch.empty_like(lv), torch.empty_like(lv)
    stream = torch.cuda.current_stream().cuda_stream

    def dq_pass(scratch, is_bf16, instance, n=n):
        return lib.consensus_update_bwd_dq(
            lv.data_ptr(), lv.data_ptr(), None, None, m.data_ptr(), m.data_ptr(),
            dq.data_ptr(), dd.data_ptr(), dcons.data_ptr(), k2._ptr(scratch), L, B, n, d, 1,
            0.0, 0, is_bf16, instance, stream)

    # "fma" asked for bf16, "wgmma" without its scratch or for f32, a shape
    # no bf16 instance takes (n = 48): each an invalid value.
    for scratch, is_bf16, instance, rows in ((khat, 1, 0, n), (None, 1, 1, n), (khat, 0, 1, n),
                                             (None, 1, 0, n), (khat, 1, 1, 48)):
        assert dq_pass(scratch, is_bf16, instance, rows) == 1, (is_bf16, instance, rows)
    assert dq_pass(khat, 1, 1) == 0
    torch.cuda.synchronize()


def test_trainer_on_card_batch8_takes_the_loop(dev):
    cfg = GlomConfig(dim=64, levels=3, image_size=32, patch_size=4)
    tr = Trainer(cfg, TrainConfig(batch_size=8, compute_dtype="bfloat16", use_pallas=True),
                 device="cuda")
    assert (tr.vjp_path, tr.grad_accum) == ("fused_loop", 1)
    hist = tr.fit(shapes_dataset(8, 32), 2, log_every=1)
    assert [r["vjp_path"] for r in hist] == ["fused_loop"] * 2
    assert all(np.isfinite(r["loss"]) for r in hist)


K4_BARS = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (1e-2, 1.6e-2)}
# The "wgmma" instance rounds k and p to bf16 where the plain version keeps
# f32; on peaked inputs p's rounding (2^-9 of a value up to about 60) needs
# more than K4_BARS's atol. Over the bf16 cases here, seeds 0-7 and both
# attend_self (`kernel_probe.py k4`, NVIDIA H100) it needed at most atol
# 0.110 at rtol 1e-2 (flat inputs 0.0031, within K4_BARS); the planted
# faults need several times this bar (PERF.md).
K4_PEAKED_WGMMA_BARS = (1e-2, 0.25)
# (page_tokens, d, row patch counts, pages). bf16 takes the "wgmma"
# instance at pt 64 and 128 (two key tiles a page) and "fma" at pt 16.
# The rows fill all but the last few pages, so the band of the unused
# pages (one empty slot at the used-token count) runs past the last page.
K4_CASES = [
    (64, 512, [256, 144, 64, 16, 256, 49], 16),  # the flagship's page size and width
    (128, 512, [256, 200, 64, 128], 7),
    (16, 256, [64, 37, 1, 16], 12),  # pages of fewer than 32 tokens; d = 256
]
# Flat levels (iid, rms 2: score std about 0.09, the self slot's about 2)
# and peaked ones (rank 4, rms 8: score std about 4), where p's rounding
# at the running max shows.
K4_INPUTS = ["flat", "peaked"]


def _ragged_maps(counts, pages, pt):
    """Per-token (row_start, row_len) of rows packed page-aligned onto
    `pages` pages, each row's page span, and the used-token count. The
    pages past the last row are an empty last slot, as the engine packs
    one: they start at the used-token count with length 0, and their band
    runs past the last page (the clamp) where the rows leave fewer free
    pages than the band holds."""
    T = pages * pt
    rs, rl = np.zeros(T, np.int32), np.zeros(T, np.int32)
    spans, off = [], 0
    for c in counts:
        k = -(-c // pt)
        rs[off * pt:(off + k) * pt], rl[off * pt:(off + k) * pt] = off * pt, c
        spans.append((off * pt, (off + k) * pt))
        off += k
    rs[off * pt:] = off * pt
    return torch.from_numpy(rs), torch.from_numpy(rl), spans, off * pt


def _k4_levels(rng, T, L, d, inputs, rank=4):
    """[T, L, d] f32 levels: "flat" iid at rms 2, or "peaked" of rank 4 a
    level at rms 8."""
    if inputs == "flat":
        return _rand(rng, T, L, d) * 2
    coef, basis = rng.standard_normal((T, L, rank)), rng.standard_normal((L, rank, d))
    return torch.from_numpy((8.0 * np.einsum("tlr,lrd->tld", coef, basis)
                             / rank ** 0.5).astype(np.float32))


def k4_bars(dtype, pt, inputs):
    """The bar the kernel is held to: K4_BARS, or K4_PEAKED_WGMMA_BARS for
    peaked inputs on the "wgmma" instance."""
    import glom_tpu_torch.kernels.banded_consensus as k4

    if inputs == "peaked" and k4.k4_instance(dtype, pt) == "wgmma":
        return K4_PEAKED_WGMMA_BARS
    return K4_BARS[dtype]


def _k4_case(rng, dtype, pt, d, counts, pages, inputs, attend_self):
    """(levels on the card, the wrapper's keywords, row spans, used tokens)."""
    rs, rl, spans, used = _ragged_maps(counts, pages, pt)
    lv = _k4_levels(rng, pages * pt, 3, d, inputs)
    window = -(-max(counts) // pt) * pt
    kw = dict(row_start=rs.cuda(), row_len=rl.cuda(), window=window, page_tokens=pt,
              attend_self=attend_self)
    return lv.to("cuda", dtype), kw, spans, used


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attend_self", [False, True])
@pytest.mark.parametrize("pt,d,counts,pages", K4_CASES)
@pytest.mark.parametrize("inputs", K4_INPUTS)
@pytest.mark.parametrize("seed", [10, 11])
def test_banded_consensus_kernel(dev, dtype, attend_self, pt, d, counts, pages, inputs, seed):
    """The kernel against the plain version over every row span and the
    unused trailing pages (each the uniform average of its clamped band)."""
    import glom_tpu_torch.kernels.banded_consensus as k4

    lv, kw, spans, used = _k4_case(np.random.default_rng(seed), dtype, pt, d, counts, pages,
                                   inputs, attend_self)
    before = k4.LAUNCHES
    got = k4.banded_ragged_consensus(lv, **kw)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1
    want = k4.banded_ragged_consensus_plain(lv, **kw)
    for s, e in spans + [(used, lv.shape[0])]:
        _close(got[s:e], want[s:e], k4_bars(dtype, pt, inputs))


@pytest.mark.parametrize("pt", [64, 128])
def test_banded_consensus_khat_prepass(dev, monkeypatch, pt):
    """The "wgmma" pre-pass writes k = normalize(levels), rounded, for every
    token and level into the scratch the attention reads: within one bf16
    ulp of the plain normalise (the norm is summed in another order)."""
    import glom_tpu_torch.kernels.banded_consensus as k4

    lv, kw, _, _ = _k4_case(np.random.default_rng(24), torch.bfloat16, pt, 512,
                            [256, 100], 8 * 64 // pt, "peaked", False)
    held = []
    monkeypatch.setattr(k4, "khat_scratch",
                        lambda t, p, make=k4.khat_scratch: held.append(make(t, p)) or held[-1])
    k4.banded_ragged_consensus(lv, **kw)
    torch.cuda.synchronize()
    assert len(held) == 1 and held[0].shape == lv.shape
    kv = lv.float()
    want = kv / torch.linalg.vector_norm(kv, dim=-1, keepdim=True).clamp_min(1e-12)
    _close(held[0], want, (2.0 ** -7, 0.0))


def test_banded_consensus_without_allocator_cache(dev):
    """The "wgmma" wrapper's k scratch lives through its launch: with the
    caching allocator off, a tensor freed early is returned by cudaFree
    before the pre-pass writes it. Runs in a fresh process (the switch is
    read once)."""
    script = (
        "import torch, glom_tpu_torch.kernels.banded_consensus as k4\n"
        "g = torch.Generator().manual_seed(0)\n"
        "lv = (2 * torch.randn(1024, 6, 512, generator=g)).to('cuda', torch.bfloat16)\n"
        "rs = torch.arange(1024, dtype=torch.int32) // 256 * 256\n"
        "kw = dict(row_start=rs.cuda(), row_len=torch.full((1024,), 200, dtype=torch.int32)"
        ".cuda(), window=256, page_tokens=64)\n"
        "assert k4.k4_instance(lv.dtype, 64) == 'wgmma'\n"
        "got = [k4.banded_ragged_consensus(lv, **kw) for _ in range(3)]\n"
        "want = k4.banded_ragged_consensus_plain(lv, **kw)\n"
        f"torch.testing.assert_close(got[0].float(), want.float(), "
        f"rtol={K4_BARS[torch.bfloat16][0]}, atol={K4_BARS[torch.bfloat16][1]})\n"
        "assert all(torch.equal(got[0], x) for x in got[1:])\n"
    )
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_banded_consensus_entry_refuses_another_instance(dev):
    """The C entry checks the caller's instance against its own rule."""
    import glom_tpu_torch.kernels.banded_consensus as k4

    lv, kw, _, _ = _k4_case(np.random.default_rng(25), torch.bfloat16, 64, 128, [64], 2,
                            "flat", False)
    rs, rl = kw["row_start"], kw["row_len"]
    out, khat = torch.empty_like(lv), torch.empty_like(lv)
    lib = k4._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for instance, scratch in ((0, None), (1, None), (0, khat)):  # "wgmma" needs its scratch
        err = lib.banded_consensus_fwd(lv.data_ptr(), out.data_ptr(), k4._ptr(scratch),
                                       rs.data_ptr(), rl.data_ptr(), 2, 64, 3, 128, 1, 0, 1,
                                       instance, stream)
        assert err == 1, (instance, err)  # cudaErrorInvalidValue
    assert lib.banded_consensus_fwd(lv.data_ptr(), out.data_ptr(), khat.data_ptr(),
                                    rs.data_ptr(), rl.data_ptr(), 2, 64, 3, 128, 1, 0, 1, 1,
                                    stream) == 0
    torch.cuda.synchronize()


def test_banded_consensus_kernel_refuses(dev):
    import glom_tpu_torch.kernels.banded_consensus as k4

    rs, rl, _, _ = _ragged_maps([48], 4, 16)
    for lv, match in ((torch.zeros(64, 2, 96, device=dev), "multiple of 128"),
                      (torch.zeros(64, 2, 128, device=dev, dtype=torch.float16), "dtype")):
        with pytest.raises(ValueError, match=match):
            k4.banded_ragged_consensus(lv, row_start=rs.to(dev), row_len=rl.to(dev), window=64,
                                       page_tokens=16)


def test_ragged_dispatch_runs_k1_and_k4(dev):
    """A fixed-route ragged dispatch launches K1 twice and K4 once per
    iteration and K2 never; the auto route at threshold 0 gives the same
    levels bit for bit."""
    import glom_tpu_torch.kernels.banded_consensus as k4
    from glom_tpu_torch.serve import pack_ragged

    cfg = GlomConfig(dim=128, levels=3, image_size=32, patch_size=4)  # n = 64, pages of 16
    common = dict(buckets=(1, 2), max_batch=2, ragged=True, ragged_attention="banded-pallas",
                  use_pallas=True, compute_dtype="bfloat16")
    fixed = InferenceEngine(cfg, ServeConfig(**common), device="cuda")
    auto = InferenceEngine(cfg, ServeConfig(**common, iters="auto", exit_threshold=0.0),
                           params=fixed.params, device="cuda")
    rng = np.random.default_rng(11)
    imgs = [rng.standard_normal((3, 32, 32)).astype(np.float32),
            rng.standard_normal((3, 16, 24)).astype(np.float32)]
    flat, n = pack_ragged(imgs, 4, fixed.page_tokens, fixed.pick_pages(6))
    before = (k1.LAUNCHES, k4.LAUNCHES, k2.LAUNCHES)
    res = fixed.infer_ragged(flat, n)
    after = (k1.LAUNCHES, k4.LAUNCHES, k2.LAUNCHES)
    T = cfg.default_iters
    assert tuple(a - b for a, b in zip(after, before)) == (2 * T, T, 0)
    assert res.levels.device.type == "cuda" and bool(torch.isfinite(res.levels.float()).all())
    again = auto.infer_ragged(flat, n)
    assert again.iters_run == T and torch.equal(again.levels, res.levels)


def _pool_config(**over):
    cfg = GlomConfig(dim=128, levels=3, image_size=32, patch_size=4)  # n = 64, pages of 16
    kw = dict(buckets=(1, 2), max_batch=2, page_pool_pages=16, compute_dtype="bfloat16",
              use_pallas=True)
    return cfg, ServeConfig(**dict(kw, **over))


@pytest.mark.parametrize("aliasing", [False, True])
def test_page_pool_on_card(dev, aliasing):
    """Write-backs, reads, a pinned write's fallback, delta pages and the
    release, on CUDA tensors: the same page bytes under copy-on-write and
    in place, and the buffer's memory returned on release."""
    from glom_tpu_torch.serve.paged_columns import PagedColumnPool

    cfg, scfg = _pool_config(pool_aliasing=aliasing)
    pool = PagedColumnPool(cfg, scfg, device=dev)
    assert pool.buffer().device.type == "cuda" and pool.buffer().dtype == torch.bfloat16
    rows = [_rand(np.random.default_rng(s), 64, 3, 128).to(dev, torch.bfloat16) for s in (3, 4)]
    assert pool.write_back("a", rows[0], 64)
    snap = pool.acquire_read()
    assert pool.write_back("b", rows[1], 64)  # pinned: copy-on-write either way
    pool.release_read()
    assert not snap[4:8].any()  # the pinned snapshot kept its pages
    assert pool.write_back("a", rows[1], 64)
    assert torch.equal(pool.read_block("a").to(dev), rows[1])
    assert torch.equal(pool.read_block("b").to(dev), rows[1])
    alias = pool.record().get("alias")
    assert alias is None or (alias["n_alias_writes"], alias["n_alias_fallbacks"]) == (2, 1)
    del snap
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    pool.release()
    assert held - torch.cuda.memory_allocated(dev) >= pool.pool_bytes


def test_delta_stream_on_card(dev):
    from glom_tpu_torch.serve.paged_columns import PagedColumnPool

    cfg, scfg = _pool_config(delta_streaming=True, delta_chain_cap=2)
    pool = PagedColumnPool(cfg, scfg, device=dev)
    row = torch.zeros(64, 3, 128, dtype=torch.bfloat16, device=dev)
    pool.write_back_stream("s", row, 64)
    neg = row.clone()
    neg[20, 0, 0] = -0.0  # page 1: a changed bit
    assert pool.write_back_stream("s", neg, 64)["pages_written"] == 1
    neg2 = neg.clone()
    neg2[50] = 1.0  # page 3: the chain folds at the cap
    assert pool.write_back_stream("s", neg2, 64)["kind"] == "compact"
    assert torch.equal(pool.read_block("s").to(dev).view(torch.int16), neg2.view(torch.int16))


def test_paged_dispatches_on_card(dev):
    """The paged warm dispatch equals the host-carried one bit for bit, with
    the fixed route's launches; the ragged pool form equals its levels0
    form."""
    from glom_tpu_torch.serve import pack_ragged

    cfg, scfg = _pool_config()
    eng = InferenceEngine(cfg, scfg, device="cuda")
    imgs = _rand(np.random.default_rng(5), 2, 3, 32, 32)
    cold = eng.infer(imgs)
    assert eng.pool.write_back("r0", cold.levels[1], 64)
    page_rows = np.array([[-1] * 4, eng.pool.lookup("r0")[0]], np.int32)
    before = (k1.LAUNCHES, k2.LAUNCHES)
    paged = eng.infer(imgs, page_rows=page_rows)
    assert (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1]) == (2 * 6, 6)
    carry = torch.stack([eng.cold_levels(), cold.levels[1].cpu()])
    host = eng.infer(imgs, levels0=carry)
    assert torch.equal(paged.levels, host.levels)
    assert paged.levels0_h2d_bytes == 0 and host.levels0_h2d_bytes == carry.numel() * 2

    rcfg, rscfg = _pool_config(ragged=True, ragged_attention="banded-pallas")
    ragged = InferenceEngine(rcfg, rscfg, params=eng.params, device="cuda")
    rng = np.random.default_rng(6)
    flat, n = pack_ragged([rng.standard_normal((3, 32, 32)).astype(np.float32),
                           rng.standard_normal((3, 16, 24)).astype(np.float32)],
                          4, ragged.page_tokens, ragged.pick_pages(6))
    assert ragged.pool.write_back("r0", cold.levels[0], 64)
    page_idx = np.full(len(flat) // ragged.page_tokens, -1, np.int32)
    page_idx[:4] = ragged.pool.lookup("r0")[0]
    warm = ragged.infer_ragged(flat, n, page_idx=page_idx)
    lv0 = torch.stack([ragged.cold_levels()[0]] * len(flat)).to(dev)
    lv0[:64] = cold.levels[0]
    again = ragged.infer_ragged(flat, n, levels0=lv0)
    assert torch.equal(warm.levels, again.levels) and warm.levels0_h2d_bytes == 0


def _batcher_config(**over):
    """A card-aligned small model (n = 64, d = 128, bf16) for the batcher."""
    cfg = GlomConfig(dim=128, levels=3, image_size=32, patch_size=4)
    kw = dict(buckets=(1, 2, 4), max_batch=4, compute_dtype="bfloat16", use_pallas=True)
    return cfg, ServeConfig(**dict(kw, **over))


def _replays(eng, tickets, imgs, n_valid):
    """Each ticket bit for bit its padded bucket's engine.infer replay."""
    b = eng.pick_bucket(n_valid)
    pad = np.zeros((b, *imgs[0].shape), np.float32)
    pad[:n_valid] = imgs
    want = eng.infer(pad, n_valid=n_valid).levels[:n_valid].cpu()
    return all(torch.equal(t.result(timeout=60)[0], want[i]) for i, t in enumerate(tickets))


def test_batcher_on_card_fixed_route(dev):
    """A gathered bucket through the batcher: the K1/K2 launches of one
    dispatch, each ticket a CPU tensor bit for bit the engine's replay."""
    from glom_tpu_torch.serve import DynamicBatcher

    cfg, scfg = _batcher_config()
    eng = InferenceEngine(cfg, scfg, device="cuda")
    eng.warmup()
    imgs = [_rand(np.random.default_rng(s), 3, 32, 32).numpy() for s in range(3)]
    b = DynamicBatcher(eng, max_delay_ms=5000.0)
    ts = [b.submit(img) for img in imgs]
    before = (k1.LAUNCHES, k1.LAUNCHES_ADD, k2.LAUNCHES)
    b.start()
    for t in ts:
        lv, iters, _ = t.result(timeout=60)
        assert lv.device.type == "cpu" and lv.dtype == torch.bfloat16 and iters == 6
    b.stop()
    got = tuple(a - w for a, w in zip((k1.LAUNCHES, k1.LAUNCHES_ADD, k2.LAUNCHES), before))
    assert got == (12, 6, 6)
    assert _replays(eng, ts, imgs, 3)


def test_batcher_on_card_two_engines_and_the_counters(dev):
    """Two engines on the card launch from two worker threads: the summed
    launches are exact (the counters' lock), and every request resolves
    once."""
    from glom_tpu_torch.serve import DynamicBatcher

    cfg, scfg = _batcher_config()
    params = init_glom(cfg, generator=torch.Generator().manual_seed(0))
    engs = [InferenceEngine(cfg, scfg, params=params, device="cuda", name=f"engine{i}")
            for i in range(2)]
    for e in engs:
        e.warmup()
    img = _rand(np.random.default_rng(9), 3, 32, 32).numpy()
    k1.LAUNCHES = k2.LAUNCHES = 0
    with DynamicBatcher(engines=engs, max_delay_ms=1.0) as b:
        ts = [b.submit(img) for _ in range(64)]
        for t in ts:
            t.result(timeout=120)
        s = b.summary_record()
    assert s["n_served"] == 64 and s["n_failed"] == 0
    assert (k1.LAUNCHES, k2.LAUNCHES) == (12 * s["n_dispatches"], 6 * s["n_dispatches"])


def test_batcher_on_card_continuations_and_pages(dev):
    """The auto route with continuation hops, then session frames warm from
    the pool: every request resolves once within its budget, and warm rows
    carry no levels0 from the host."""
    import dataclasses

    from glom_tpu_torch.serve import DynamicBatcher, column_state_bytes

    cfg, scfg = _batcher_config(iters="auto", exit_quorum=0.5, max_continuations=2,
                                page_pool_pages=32)
    scfg = dataclasses.replace(scfg, column_cache_bytes=4 * column_state_bytes(cfg, scfg))
    eng = InferenceEngine(cfg, scfg, device="cuda")
    rng = np.random.default_rng(12)
    imgs = [(_rand(rng, 3, 32, 32) * (100.0 if i % 2 else 1.0)).numpy() for i in range(4)]
    recs = []
    with DynamicBatcher(eng, max_delay_ms=5000.0, writer=type("W", (), {
            "write": staticmethod(recs.append)})()) as b:
        ts = [b.submit(img) for img in imgs]
        assert all(t.result(timeout=120)[1] <= eng.auto_budget for t in ts)
        for frame in range(3):
            fs = [b.submit(img + 0.05 * frame, session_id=f"s{i}") for i, img in enumerate(imgs)]
            for t in fs:
                t.result(timeout=120)
        s = b.summary_record()
    assert s["n_served"] == 16 and s["column_cache"]["n_hits"] == 8
    paged = [r for r in recs if r.get("event") == "dispatch" and r["paged"] and r["tier"] == 0]
    assert sum(r["n_cache_warm"] for r in paged) == 8
    assert all(r["levels0_h2d_bytes"] == 0 for r in paged)


def _fleet_on_card(scfg_over=None, **kw):
    """Elastic fleet helpers on the card: the card-aligned config with a
    page pool and a column cache, a writer, one shared params init."""
    import dataclasses

    from glom_tpu_torch.serve import column_state_bytes

    cfg, scfg = _batcher_config(page_pool_pages=32, **(scfg_over or {}))
    scfg = dataclasses.replace(scfg, column_cache_bytes=8 * column_state_bytes(cfg, scfg))
    params = init_glom(cfg, generator=torch.Generator().manual_seed(0))
    recs = []
    writer = type("W", (), {"write": staticmethod(recs.append)})()
    mk = lambda name: InferenceEngine(cfg, scfg, params=params, device="cuda", name=name,
                                      writer=writer)  # noqa: E731
    return cfg, scfg, mk, writer, recs


class _Scripted:
    """A scripted elastic policy (its actions in order; the drain target
    pinned)."""

    def __new__(cls, actions, target):
        from glom_tpu_torch.serve.elastic import ElasticPolicy

        class P(ElasticPolicy):
            def decide(self, n):
                if not actions:
                    return None
                ev = self.evidence(n)
                a = actions.pop(0)
                if a == "scale_out":
                    ev["breaches"] = ["p99_ms"]
                else:
                    ev["above_held_s"] = ev["dwell_s"] + 1.0
                return {"action": a, "signal": {"rule": "test"}, "evidence": ev}

            def pick_drain_target(self, caps):
                return target

        return P(min_engines=1, max_engines=4)


@pytest.mark.parametrize("aliasing", [False, True])
def test_elastic_spawn_drain_migrate_on_card(dev, aliasing):
    """On the card: engine 0 serves four sessions into its pool; the
    autoscaler spawns engine 1 (warmed before admission: its first
    dispatch comes after its admission_open), then drains engine 0: the
    sessions' pages land in engine 1's pool bit for bit with the same
    content hash, engine 0's release frees at least its pool's bytes, and
    the next frames hit engine 1's pool with no levels0 from the host, and
    the decision chain audits clean."""
    from glom_tpu_torch.serve import Autoscaler, DynamicBatcher, content_hash
    from glom_tpu_torch.telemetry.audit import audit_records

    cfg, scfg, mk, writer, recs = _fleet_on_card(dict(pool_aliasing=aliasing))
    eng0 = mk("engine0")
    eng0.warmup()
    eng0.warmup(warm="paged")
    rng = np.random.default_rng(21)
    imgs = [_rand(rng, 3, 32, 32).numpy() for _ in range(4)]
    spawned = []

    def factory():
        e = mk("engine1")
        spawned.append(e)
        return e

    b = DynamicBatcher(eng0, writer=writer, max_delay_ms=5000.0)
    sc = Autoscaler(b, factory, writer=writer,
                    policy=_Scripted(["scale_out", "scale_in"], "engine0"))
    ts = [b.submit(img, session_id=f"s{i}") for i, img in enumerate(imgs)]
    b.start()
    for t in ts:
        t.result(timeout=120)
    before = {f"s{i}": eng0.pool.read_block(f"s{i}") for i in range(4)}
    sc.tick()
    spawned[0].warmup(warm="paged")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    sc.tick()
    torch.cuda.synchronize()
    freed = mem0 - torch.cuda.memory_allocated()
    eng1 = spawned[0]
    for s, row in before.items():
        got = eng1.pool.read_block(s)
        assert torch.equal(got, row) and content_hash(got) == content_hash(row)
    assert eng0.released and freed >= eng0.pool.pool_bytes
    fs = [b.submit(img + 0.05, session_id=f"s{i}") for i, img in enumerate(imgs)]
    out = [t.result(timeout=120)[0] for t in fs]
    b.stop()
    s = b.summary_record()
    assert s["n_served"] == 8 and s["n_failed"] == 0 and s["levels0_h2d_bytes"] == 0
    assert s["elastic"]["n_migrated_sessions"] == 4 and s["column_cache"]["n_hits"] == 4
    warm = [r for r in recs if r.get("event") == "dispatch" and r["engine"] == "engine1"]
    assert warm and all(r["n_page_warm"] == r["n_valid"] for r in warm)
    events = [r.get("event") for r in recs]
    assert events.index("admission_open") < events.index("dispatch", events.index(
        "engine_add"))
    assert audit_records(recs)["errors"] == []
    assert all(o.dtype == torch.bfloat16 and o.device.type == "cpu" for o in out)


def test_distributed_phases_at_small_width(dev):
    """chip_smoke.py's dist_* and train_cli_distributed phases at a small
    width: the NCCL world-1 step bit for bit the Trainer's, DP / ZeRO / SP
    / TP over gloo ranks sharing the card at their f32 bars with exact
    launches, and the distributed CLI. Each phase raises on a miss."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    small = dict(dim=64, levels=4, image_size=32, patch_size=4)
    launches = chip_smoke.dist_phases(
        GlomConfig(**small), dev, "test",
        halo_cfg=dict(small, local_consensus_radius=2), cli_preset="cifar10",
    )
    assert launches["grouped_mlp_fwd_cat"] > 0 and launches["consensus_update_bwd_dq"] > 0
    assert launches["banded_consensus_fwd"] == 0
