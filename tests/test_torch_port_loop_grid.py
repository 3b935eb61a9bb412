"""The whole-loop VJP's combined td || bu grid, the port loop's only K1
layout, against the split launches and against glom_tpu's
`GLOM_LOOP_GRID=combined` loop, at f32 on the CPU.

On the CPU each combined-grid launch runs its plain version, the two split
calls on views, so the cat-grid wrappers equal the split calls bit for bit
here through their own plumbing (the concatenated weights, the slot and
level views, the [2L-1] totals); on the card the one launch is held to the
split pair bit for bit (tests/test_torch_port_gpu.py, chip_smoke.py).
glom_tpu's combined loop runs in interpret mode with its env var set by
monkeypatch (a setting of this test; glom_tpu is not edited), held at
glom_tpu's loop bar, rtol 2e-3 / atol 2e-5. The cat-grid plain versions are
held against glom_tpu's `_ffw_fwd_cat`, `_pre_fwd_cat` and `_ffw_bwd_cat`
in interpret mode.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glom_tpu_torch.kernels.grouped_mlp as tk1
from glom_tpu.kernels import fused_loop as jloop
from glom_tpu.kernels.grouped_mlp import _pick_bwd_tile, _pick_tile
from glom_tpu.ops.ffw import GroupedFFWParams as JaxFFW
from glom_tpu_torch import GlomConfig, TrainConfig
from glom_tpu_torch.kernels.fused_loop import fused_glom_loop
from glom_tpu_torch.models import core
from glom_tpu_torch.models.core import param_leaves, unflatten_params
from glom_tpu_torch.ops.ffw import GroupedFFWParams
from glom_tpu_torch.train import denoise_loss, init_denoise, make_train_step

RTOL, ATOL = 2e-3, 2e-5
L, B, N, D, SIDE, ITERS = 4, 8, 16, 128, 4, 3  # glom_tpu's TestFusedLoop shape
F = 4 * D


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if torch.is_tensor(got) else got, np.float32),
        np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=what,
    )


def _ffw_numpy(rng, G):
    return [rng.uniform(-s, s, shape).astype(np.float32) for s, shape in (
        (D ** -0.5, (G, D, F)), (0.1, (G, F)), (F ** -0.5, (G, F, D)), (0.1, (G, D)),
    )]


def _loop_inputs(seed):
    """bu weights, td weights, pos_emb, tokens, levels0 (level-major)."""
    rng = np.random.default_rng(seed)
    bu, td = _ffw_numpy(rng, L), _ffw_numpy(rng, L - 1)
    rest = [rng.standard_normal(s).astype(np.float32)
            for s in ((N, D), (B, N, D), (L, B, N, D))]
    return bu, td, *rest


def _port(inputs, remat=False, radius=0.0):
    """(output, grads of mean(out^2)) through the port's loop."""
    bu, td, pos, tok, lv0 = inputs
    leaves = [torch.from_numpy(t).requires_grad_() for t in (*bu, *td, pos, tok, lv0)]
    out = fused_glom_loop(GroupedFFWParams(*leaves[:4]), GroupedFFWParams(*leaves[4:8]),
                          *leaves[8:], ITERS, SIDE, radius, False, remat)
    return out.detach(), torch.autograd.grad((out ** 2).mean(), leaves)


def _split_inputs(seed):
    """(bu, td, wcat, carry [L+1, M, d], pos_emb, dmean [L, M, d]) as tensors."""
    rng = np.random.default_rng(seed)
    bu = GroupedFFWParams(*map(torch.from_numpy, _ffw_numpy(rng, L)))
    td = GroupedFFWParams(*map(torch.from_numpy, _ffw_numpy(rng, L - 1)))
    carry, pos, dmean = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                         for s in ((L + 1, B * N, D), (N, D), (L, B * N, D)))
    return bu, td, tk1.cat_params(td, bu), carry, pos, dmean


@pytest.mark.parametrize("phase", ["forward", "pre_only", "backward"])
def test_cat_launch_equals_split_launches(phase):
    """Each cat-grid launch against the top-down launch on slots 2..L with
    the addend and the bottom-up launch on slots 0..L-1, bit for bit."""
    bu, td, wcat, carry, pos, dmean = _split_inputs(10)
    if phase == "forward":
        out, pre = tk1.fused_grouped_ffw_lm(wcat, carry, add=pos, save_pre=True, cat=True)
        split = [tk1.fused_grouped_ffw_lm(td, carry[2:], add=pos, save_pre=True),
                 tk1.fused_grouped_ffw_lm(bu, carry[:L], save_pre=True)]
        assert torch.equal(out, torch.cat([split[0][0], split[1][0]]))
        assert torch.equal(pre, torch.cat([split[0][1], split[1][1]]))
    elif phase == "pre_only":
        got = tk1.grouped_mlp_pre(wcat, carry, add=pos, cat=True)
        assert torch.equal(got, torch.cat([tk1.grouped_mlp_pre(td, carry[2:], add=pos),
                                           tk1.grouped_mlp_pre(bu, carry[:L])]))
    else:
        rng = np.random.default_rng(11)
        acc = GroupedFFWParams(*(torch.from_numpy(rng.standard_normal(tuple(t.shape))
                                                  .astype(np.float32)) for t in wcat))
        da_in = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
        acc_td = GroupedFFWParams(*(t[: L - 1].clone() for t in acc))
        acc_bu = GroupedFFWParams(*(t[L - 1:].clone() for t in acc))
        da_split = da_in.clone()
        pre = tk1.fused_grouped_ffw_lm(wcat, carry, add=pos, save_pre=True, cat=True)[1]
        dx, grads, da = tk1.grouped_mlp_bwd(wcat, carry, dmean, add=pos, pre=pre, acc=acc,
                                            da_in=da_in, cat=True)
        dx_td = tk1.grouped_mlp_bwd(td, carry[2:], dmean[: L - 1], add=pos, pre=pre[: L - 1],
                                    acc=acc_td, da_in=da_split)[0]
        dx_bu = tk1.grouped_mlp_bwd(bu, carry[:L], dmean, pre=pre[L - 1:], acc=acc_bu)[0]
        assert torch.equal(dx, torch.cat([dx_td, dx_bu]))
        assert all(torch.equal(a, torch.cat([t, b])) for a, t, b in zip(grads, acc_td, acc_bu))
        assert torch.equal(da, da_split)


@pytest.mark.parametrize("radius", [0.0, 1.5], ids=["global", "radius"])
def test_remat_equals_keep_bitwise(radius):
    """remat recomputes the [2L-1] pre with the pre-only cat launch: the
    same output and gradients bit for bit."""
    inputs = _loop_inputs(0)
    out_k, g_k = _port(inputs, radius=radius)
    out_r, g_r = _port(inputs, remat=True, radius=radius)
    assert torch.equal(out_k, out_r)
    assert all(torch.equal(a, b) for a, b in zip(g_k, g_r))


@pytest.mark.parametrize("remat", [False, True], ids=["keep", "remat"])
def test_loop_launches_through_the_cat_grid(monkeypatch, remat):
    """Each iteration runs one cat-grid K1 launch per phase (forward,
    remat's pre-only, backward) and no split K1 launch."""
    calls = []
    for name in ("fused_grouped_ffw_lm", "grouped_mlp_pre", "grouped_mlp_bwd"):
        real = getattr(tk1, name)
        monkeypatch.setattr(
            "glom_tpu_torch.kernels.fused_loop." + name,
            partial(lambda real, name, *a, **k: calls.append((name, k.get("cat", False)))
                    or real(*a, **k), real, name))
    _port(_loop_inputs(1), remat=remat)
    bwd = [("grouped_mlp_pre", True)] * remat + [("grouped_mlp_bwd", True)]
    assert calls == [("fused_grouped_ffw_lm", True)] * ITERS + bwd * ITERS


@pytest.fixture(scope="module")
def interpret_combined_loop():
    """glom_tpu's fused_glom_loop gradients on its combined grid in
    interpret mode (about 15 s here)."""
    inputs = _loop_inputs(2)
    bu, td, pos, tok, lv0 = inputs
    args = (JaxFFW(*map(jnp.asarray, bu)), JaxFFW(*map(jnp.asarray, td)),
            jnp.asarray(pos), jnp.asarray(tok), jnp.asarray(lv0))
    mp = pytest.MonkeyPatch()
    mp.setenv("GLOM_LOOP_GRID", "combined")
    try:
        fn = partial(jloop.fused_glom_loop, iters=ITERS, side=SIDE, radius=0.0,
                     attend_self=False, interpret=True)

        def loss(*a):
            out = fn(*a)
            return jnp.mean(out ** 2), out

        (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(5)), has_aux=True)(*args)
    finally:
        mp.undo()
    return inputs, out, jax.tree_util.tree_leaves(grads)


@pytest.mark.parametrize("remat", [False, True], ids=["keep", "remat"])
def test_matches_glom_tpu_combined_loop(interpret_combined_loop, remat):
    inputs, jout, jgrads = interpret_combined_loop
    out, grads = _port(inputs, remat=remat)
    _close(out, jout, what="output")
    names = [f"bu.{k}" for k in "w1 b1 w2 b2".split()] + [
        f"td.{k}" for k in "w1 b1 w2 b2".split()] + ["pos_emb", "tokens", "levels0"]
    for name, got, want in zip(names, grads, jgrads):
        _close(got, want, what=name)


class TestCatKernelFunctions:
    """The cat-grid plain versions against glom_tpu's cat-grid kernels in
    interpret mode, on one [L+1]-slot carry."""

    def _setup(self, seed):
        rng = np.random.default_rng(seed)
        ext2 = rng.standard_normal((L + 1, B * N, D)).astype(np.float32)
        bu, td = _ffw_numpy(rng, L), _ffw_numpy(rng, L - 1)
        pos = rng.standard_normal((N, D)).astype(np.float32)
        wcat_j = jloop._cat_params(JaxFFW(*map(jnp.asarray, td)), JaxFFW(*map(jnp.asarray, bu)))
        wcat = tk1.cat_params(GroupedFFWParams(*map(torch.from_numpy, td)),
                              GroupedFFWParams(*map(torch.from_numpy, bu)))
        return rng, ext2, pos, wcat_j, wcat

    def test_forward_and_pre(self):
        _, ext2, pos, wcat_j, wcat = self._setup(3)
        a2 = jloop._cat_addend(jnp.asarray(pos))
        tile = _pick_tile(B * N, D, F, 4)
        jout, jpre = jloop._ffw_fwd_cat(wcat_j, jnp.asarray(ext2), a2, L, tile_m=tile,
                                        interpret=True)
        jpre_only = jloop._pre_fwd_cat(wcat_j, jnp.asarray(ext2), a2, L, tile_m=tile,
                                       interpret=True)
        x, add = torch.from_numpy(ext2), torch.from_numpy(pos)
        out, pre = tk1.fused_grouped_ffw_lm(wcat, x, add=add, save_pre=True, cat=True)
        assert out.shape == (2 * L - 1, B * N, D) and pre.shape == (2 * L - 1, B * N, F)
        _close(out, jout, what="out")
        _close(pre, jpre, what="pre")
        pre_only = tk1.grouped_mlp_pre(wcat, x, add=add, cat=True)
        _close(pre_only, jpre_only, what="pre-only")
        assert torch.equal(pre_only, pre)

    def test_backward_accumulates(self):
        rng, ext2, pos, wcat_j, wcat = self._setup(4)
        G = 2 * L - 1
        dmean = rng.standard_normal((L, B * N, D)).astype(np.float32)
        acc = [rng.standard_normal(tuple(t.shape)).astype(np.float32) * 8.0 for t in wcat]
        da_in = rng.standard_normal((N, D)).astype(np.float32) * 8.0
        x, add = torch.from_numpy(ext2), torch.from_numpy(pos)
        pre = tk1.fused_grouped_ffw_lm(wcat, x, add=add, save_pre=True, cat=True)[1]
        jacc, jdx, jda = jloop._ffw_bwd_cat(
            wcat_j, jnp.asarray(ext2), jnp.asarray(pre.numpy()), jnp.asarray(dmean),
            JaxFFW(jnp.asarray(acc[0]), jnp.asarray(acc[1])[:, None], jnp.asarray(acc[2]),
                   jnp.asarray(acc[3])[:, None]),
            jloop._cat_addend(jnp.asarray(pos)), jnp.asarray(da_in), L,
            tile_m=_pick_bwd_tile(B * N, D, F, 4), interpret=True, chain=True)
        tacc = GroupedFFWParams(*(torch.from_numpy(a.copy()) for a in acc))
        tda = torch.from_numpy(da_in.copy())
        dx, grads, da = tk1.grouped_mlp_bwd(wcat, x, torch.from_numpy(dmean), add=add, pre=pre,
                                            acc=tacc, da_in=tda, cat=True)
        assert grads is tacc and da is tda and dx.shape == (G, B * N, D)
        _close(dx, jdx, what="dx")
        for name, got, want in zip(("dw1", "db1", "dw2", "db2"), grads,
                                   (jacc.w1, jacc.b1[:, 0], jacc.w2, jacc.b2[:, 0])):
            _close(got, want, what=name)
        _close(da, jda, what="da")

    def test_backward_needs_accumulate_mode(self):
        _, ext2, pos, _, wcat = self._setup(5)
        x = torch.from_numpy(ext2)
        with pytest.raises(ValueError, match="accumulate"):
            tk1.grouped_mlp_bwd(wcat, x, x[:L], add=torch.from_numpy(pos), cat=True)

    def test_split_count(self):
        _, _, _, _, wcat = self._setup(6)
        assert tk1.cat_split(wcat) == L - 1
        with pytest.raises(ValueError, match="2L-1"):
            tk1.cat_split(GroupedFFWParams(*(t[:4] for t in wcat)))


def test_train_step_on_the_loop_matches_per_iteration_route(monkeypatch):
    """make_train_step at batch 8 with the card's routing (`_on_card`
    patched) takes the loop, whose K1 launches are all cat-grid ones; its
    f32 loss and gradients match the per-iteration route's (scan_only)."""
    monkeypatch.setattr(core, "_on_card", lambda device: True)
    cfg = GlomConfig(dim=64, levels=3, image_size=16, patch_size=4)
    tcfg = TrainConfig(batch_size=8, use_pallas=True)
    assert make_train_step(cfg, tcfg, device="cpu").vjp_path == "fused_loop"
    assert make_train_step(cfg, tcfg, scan_only=True, device="cpu").vjp_path == "scan_blockwise"
    params = init_denoise(cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    img, noise = (torch.from_numpy(rng.standard_normal((8, 3, 16, 16)).astype(np.float32))
                  for _ in range(2))
    cat_flags = []
    for name in ("fused_grouped_ffw_lm", "grouped_mlp_bwd"):
        real = getattr(tk1, name)
        monkeypatch.setattr(
            "glom_tpu_torch.kernels.fused_loop." + name,
            partial(lambda real, *a, **k: cat_flags.append(k.get("cat", False)) or real(*a, **k),
                    real))

    def loss_and_grads(**kw):
        leaves = [t.clone().requires_grad_() for t in param_leaves(params)]
        loss = denoise_loss(unflatten_params(params, leaves), img, noise, cfg,
                            use_pallas=True, **kw)
        return loss, torch.autograd.grad(loss, leaves)

    loss, grads = loss_and_grads()
    k = len(cat_flags) // 2
    assert k >= 1 and cat_flags == [True] * (2 * k)
    want_loss, want = loss_and_grads(scan_only=True)
    assert len(cat_flags) == 2 * k  # the per-iteration route runs no loop launch
    _close(loss, want_loss.detach(), what="loss")
    for got, w in zip(grads, want):
        _close(got, w, what="grad")
