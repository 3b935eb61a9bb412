"""The port's one-sweep K2 backward (long rows) against glom_tpu's, at f32
on the CPU.

The same numpy-seeded levels, cotangents and statistics go through
glom_tpu's `_consensus_bwd_onesweep` and its `_forward(..., save_cons=True)`
(Pallas kernels in interpret mode) and through the port's plain versions;
`consensus_update_vjp` is held against `jax.grad` of glom_tpu's `_fused`
with its blockwise side forced, which at n = 576 > 512 runs the one-sweep
(the shape of glom_tpu's own tests/test_kernels.py:327-348). Gradients are
of sum(out * w) for a fixed random w, so they are O(1) and the bar, rtol
2e-3 / atol 1e-5, binds. The trainer's long-row route runs here with the
dispatch seam `_on_card` patched. The kernels themselves are held against
these plain versions on the card (tests/test_torch_port_gpu.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glom_tpu_torch.kernels.consensus_update as tk2
from glom_tpu.kernels import consensus_update as jcu
from glom_tpu.train import objectives as jobj
from glom_tpu.train import trainer as jtrainer
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import GlomConfig, TrainConfig, Trainer, params_from_numpy
from glom_tpu_torch.models import core
from glom_tpu_torch.models.core import param_leaves
from glom_tpu_torch.ops.ffw import GroupedFFWParams

RTOL, ATOL = 2e-3, 1e-5
L, B, SIDE, D = 2, 1, 24, 128  # n = 576 > 512, glom_tpu's multi-tile shape
N = SIDE * SIDE


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if torch.is_tensor(got) else got, np.float32),
        np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=what,
    )


def _inputs(seed):
    """levels, bu, td, a cotangent-sized g, numpy f32."""
    rng = np.random.default_rng(seed)
    shapes = ((L, B, N, D), (L, B, N, D), (L - 1, B, N, D), (L, B, N, D))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


CASES = [(0.0, False), (0.0, True), (3.0, False), (3.0, True)]
IDS = ["global", "global_self", "radius", "radius_self"]


@pytest.mark.parametrize("radius,attend_self", CASES, ids=IDS)
def test_forward_cons_matches_save_cons(radius, attend_self):
    lv, bu, td, _ = _inputs(0)
    kw = dict(side=SIDE, radius=radius, attend_self=attend_self)
    want = jcu._forward(*_j(lv, bu, td), interpret=True, save_stats=True, save_cons=True, **kw)
    got = tk2.fused_consensus_update(*_t(lv, bu, td), cons=True, **kw)
    assert len(got) == 4
    for name, a, b in zip(("out", "m", "l", "cons"), got, want):
        _close(a, b, rtol=1e-5, atol=1e-6, what=name)


@pytest.mark.parametrize("radius,attend_self", CASES, ids=IDS)
def test_plain_onesweep_matches_interpret_kernel(radius, attend_self):
    lv, bu, td, g = _inputs(1)
    kw = dict(side=SIDE, radius=radius, attend_self=attend_self)
    _, m, l, cons = jcu._forward(*_j(lv, bu, td), interpret=True, save_stats=True,
                                 save_cons=True, **kw)
    want = jcu._consensus_bwd_onesweep(*_j(lv, g), m, l, cons, interpret=True, **kw)
    got = tk2.consensus_bwd_onesweep(*_t(lv, g, m, l, cons), **kw)
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("radius,attend_self", CASES, ids=IDS)
def test_vjp_matches_glom_tpu_blockwise_grad(radius, attend_self):
    lv, bu, td, w = _inputs(2)

    def jloss(a, b, c):
        out = jcu._fused(a, b, c, SIDE, radius, attend_self, True, "blockwise")
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(lv, bu, td))
    leaves = [t.requires_grad_() for t in _t(lv, bu, td)]
    out = tk2.consensus_update_vjp(*leaves, side=SIDE, radius=radius, attend_self=attend_self)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for name, a, b in zip(("levels", "bu", "td"), got, want):
        _close(a, b, what=name)


def test_vjp_takes_the_onesweep_on_long_rows_only(monkeypatch):
    calls = []
    real = tk2.consensus_bwd_onesweep
    monkeypatch.setattr(tk2, "consensus_bwd_onesweep",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    for side in (SIDE, 16):  # n = 576: the one-sweep; n = 256: the dq/dkv pair
        lv = torch.randn(L, B, side * side, 64, requires_grad=True)
        out = tk2.consensus_update_vjp(lv, torch.zeros_like(lv), torch.zeros_like(lv[1:]),
                                       side=side)
        out.sum().backward()
    assert calls == [(L, B, N, 64)]


def test_use_onesweep_matches_glom_tpu_gate():
    """glom_tpu's save_cons gate with its blockwise side taken, over long
    and short, f32 and bf16 rows, and a row whose dq block overflows the
    TPU's budget (n = 22500 at d = 512: both take the two passes there)."""
    shapes = [(6, 8, 4096, 512, 64), (6, 1, 4096, 512, 64), (6, 2, 9216, 512, 96),
              (2, 1, 576, 128, 24), (6, 8, 256, 512, 16), (6, 1, 512, 512, 0),
              (6, 1, 1024, 512, 32), (6, 1, 16384, 512, 128), (6, 1, 22500, 512, 150),
              (6, 1, 16384, 1024, 128)]
    seen = set()
    for *shape, side in shapes:
        n, d = shape[2], shape[3]
        for itemsize in (2, 4):
            want = (jcu._use_blockwise_bwd(tuple(shape), side, 0.0, "blockwise", itemsize)
                    and n > jcu._SMALL_BWD_N and jcu._onesweep_ok(shape[1], n, d, itemsize))
            got = tk2.use_onesweep(tuple(shape), itemsize)
            assert got == want, (shape, itemsize)
            seen.add(got)
    assert seen == {True, False}
    assert tk2.use_onesweep((6, 8, 4096, 512), 2) and not tk2.use_onesweep((6, 1, 22500, 512), 2)


def test_onesweep_and_two_pass_agree_to_f32_rounding():
    lv, bu, td, g = _inputs(3)
    kw = dict(side=SIDE, radius=0.0, attend_self=False)
    _, m, l, cons = tk2.fused_consensus_update(*_t(lv, bu, td), cons=True, **kw)
    one = tk2.consensus_bwd_onesweep(*_t(lv, g), m, l, cons, **kw)
    two, _ = tk2.consensus_update_bwd_plain(*_t(lv, g), m, l, **kw)
    _close(one, two, rtol=1e-5, atol=1e-6)
    assert not torch.equal(one, two)  # D from cons, not from dP: another rounding


def test_cpu_counts_no_launch():
    before = (tk2.LAUNCHES_BWD_ONESWEEP, tk2.LAUNCHES_CONS, tk2.LAUNCHES)
    lv, bu, td, _ = _inputs(4)
    leaves = [t.requires_grad_() for t in _t(lv, bu, td)]
    tk2.consensus_update_vjp(*leaves, side=SIDE).sum().backward()
    assert (tk2.LAUNCHES_BWD_ONESWEEP, tk2.LAUNCHES_CONS, tk2.LAUNCHES) == before


def test_refuses_bad_cons_on_the_card_path():
    lv = torch.zeros(L, B, N, 64)
    m = l = torch.ones(L, B, N, 1)
    with pytest.raises(ValueError, match="cons"):
        tk2._check_bwd_args(lv, lv, m, l, SIDE, 0.0, None, None, False, cons=lv[:1])


def test_per_iteration_loop_reaches_the_onesweep(monkeypatch):
    """The per-iteration route at n = 576 saves cons and runs the one-sweep
    once per iteration."""
    calls = []
    real = tk2.consensus_bwd_onesweep
    monkeypatch.setattr(tk2, "consensus_bwd_onesweep",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(5)
    f = 128

    def ffw(G):
        return GroupedFFWParams(*(torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                                   * 0.05).requires_grad_()
                                  for s in ((G, 64, f), (G, f), (G, f, 64), (G, 64))))
    pos = torch.randn(N, 64)
    tok = torch.randn(1, N, 64)
    lv0 = torch.randn(3, 1, N, 64)
    out = core.per_iteration_loop(ffw(3), ffw(2), pos, tok, lv0, 2, SIDE, 0.0, False)
    out.sum().backward()
    assert len(calls) == 2


def test_long_row_trainer_matches_glom_tpu(monkeypatch):
    """The port's Trainer on a side-24 grid (n = 576) with the card's
    routing (`_on_card` patched): records say scan_blockwise, every
    iteration's consensus backward is the one-sweep, and two Adam steps
    match glom_tpu's trainer on transplanted weights (noise_std 0)."""
    kw = dict(dim=64, levels=2, image_size=96, patch_size=4)
    jcfg, cfg = jconfig.GlomConfig(**kw), GlomConfig(**kw)
    assert cfg.num_patches == N
    jp = jobj.init_denoise(jax.random.PRNGKey(0), jcfg)
    flat = {}
    for name in jp.glom._fields:
        v = getattr(jp.glom, name)
        if hasattr(v, "_fields"):
            flat.update({f"{name}.{k}": np.asarray(getattr(v, k)) for k in v._fields})
        else:
            flat[name] = np.asarray(v)
    flat["to_pixels.w"], flat["to_pixels.b"] = map(np.asarray, jp.to_pixels)
    tkw = dict(batch_size=2, learning_rate=3e-3, noise_std=0.0, iters=4)
    rng = np.random.default_rng(9)
    batches = [rng.standard_normal((2, 3, 96, 96)).astype(np.float32) for _ in range(2)]

    jt = jconfig.TrainConfig(**tkw)
    jstate, jopt = jtrainer.create_train_state(jax.random.PRNGKey(0), jcfg, jt)
    jstate = jstate._replace(params=jp, opt_state=jopt.init(jp))
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jt, jopt))
    jlosses = []
    for img in batches:
        jstate, jm = jstep(jstate, jnp.asarray(img), jax.random.PRNGKey(1))
        jlosses.append(float(jm["loss"]))

    calls = []
    real = tk2.consensus_bwd_onesweep
    monkeypatch.setattr(core, "_on_card", lambda device: True)
    monkeypatch.setattr(tk2, "consensus_bwd_onesweep",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tr = Trainer(cfg, TrainConfig(use_pallas=True, **tkw), params=params_from_numpy(flat),
                 device="cpu")
    assert (tr.vjp_path, tr.grad_accum) == ("scan_blockwise", 1)
    hist = tr.fit(iter(batches), 2, log_every=1)
    assert len(calls) == 2 * 3  # k = 4 // 2 + 1 iterations a step
    assert [(r["vjp_path"], r["grad_accum"]) for r in hist] == [("scan_blockwise", 1)] * 2
    np.testing.assert_allclose([r["loss"] for r in hist], jlosses, rtol=5e-4)
    for got, want in zip(param_leaves(tr.state.params), jax.tree_util.tree_leaves(jstate.params)):
        _close(got, want, rtol=1e-3, atol=1e-5)
