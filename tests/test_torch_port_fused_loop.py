"""The port's whole-loop VJP (K3) against glom_tpu's, at f32 on the CPU.

The same numpy-seeded weights and inputs go through glom_tpu's
`fused_glom_loop` (Pallas kernels in interpret mode) or its XLA reference
loop (`update_step` under `jax.grad`, as tests/test_kernels.py:594-614
builds it) and through the port's `fused_glom_loop`, whose launches run
their kernels' plain versions here. Output and cotangents are held at
glom_tpu's own loop bar, rtol 2e-3 / atol 2e-5 (tests/test_kernels.py:
638-642). The three new kernel functions (pre-only K1, accumulating K1
backward, the K2 backward's three-stream combine) are held against
glom_tpu's kernels in interpret mode; the route resolution against
glom_tpu's over the flagship batch grid; and the trainer's batch-8 step
against glom_tpu's trainer, with the dispatch seam `_on_card` patched so
the card's routing runs here. The kernels themselves are held against
these plain versions on the card (tests/test_torch_port_gpu.py,
chip_smoke.py).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glom_tpu_torch.kernels.consensus_update as tk2
import glom_tpu_torch.kernels.grouped_mlp as tk1
from glom_tpu.kernels import fused_loop as jloop
from glom_tpu.kernels.grouped_mlp import _pick_bwd_tile, _pick_tile
from glom_tpu.models import core as jcore
from glom_tpu.ops.consensus import build_local_mask, consensus_attention
from glom_tpu.ops.ffw import GroupedFFWParams as JaxFFW
from glom_tpu.train import objectives as jobj
from glom_tpu.train import trainer as jtrainer
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import GlomConfig, TrainConfig, Trainer, params_from_numpy
from glom_tpu_torch.kernels.fused_loop import (
    RESIDUAL_BUDGET,
    fused_glom_loop,
    loop_supported,
    residual_bytes,
)
from glom_tpu_torch.models import core
from glom_tpu_torch.models.core import param_leaves, resolve_vjp_path
from glom_tpu_torch.ops.ffw import GroupedFFWParams
from glom_tpu_torch.train import resolve_route_keys, resolve_training_route

RTOL, ATOL = 2e-3, 2e-5
L, B, N, D, SIDE, ITERS = 4, 8, 16, 128, 4, 3  # TestFusedLoop's shape
F = 4 * D


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if torch.is_tensor(got) else got, np.float32),
        np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=what,
    )


def _ffw_numpy(rng, G, d, f):
    return [rng.uniform(-s, s, shape).astype(np.float32) for s, shape in (
        (d ** -0.5, (G, d, f)), (0.1, (G, f)), (f ** -0.5, (G, f, d)), (0.1, (G, d)),
    )]


def _loop_inputs(seed, L_=L):
    """bu weights, td weights, pos_emb, tokens, levels0 (level-major)."""
    rng = np.random.default_rng(seed)
    bu, td = _ffw_numpy(rng, L_, D, F), _ffw_numpy(rng, L_ - 1, D, F)
    rest = [rng.standard_normal(s).astype(np.float32)
            for s in ((N, D), (B, N, D), (L_, B, N, D))]
    return bu, td, *rest


def _port_loop_grads(inputs, iters, radius, attend_self, remat=False):
    """(output, grads of mean(out^2) in (bu, td, pos, tokens, levels0) leaf
    order) through the port's fused_glom_loop."""
    bu, td, pos, tok, lv0 = inputs
    leaves = [torch.from_numpy(t).requires_grad_() for t in (*bu, *td, pos, tok, lv0)]
    out = fused_glom_loop(
        GroupedFFWParams(*leaves[:4]), GroupedFFWParams(*leaves[4:8]), *leaves[8:],
        iters, SIDE, radius, attend_self, remat,
    )
    return out.detach(), torch.autograd.grad((out ** 2).mean(), leaves)


def _jax_args(inputs):
    bu, td, pos, tok, lv0 = inputs
    return (JaxFFW(*map(jnp.asarray, bu)), JaxFFW(*map(jnp.asarray, td)),
            jnp.asarray(pos), jnp.asarray(tok), jnp.asarray(lv0))


def _jax_grads(loop_fn, inputs):
    def loss(*a):
        out = loop_fn(*a)
        return jnp.mean(out ** 2), out

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(5)), has_aux=True)(
        *_jax_args(inputs))
    return out, jax.tree_util.tree_leaves(grads)


def _ref_loop(bu_p, td_p, pos, tokens, lv0, *, iters, radius, attend_self):
    """glom_tpu's XLA reference loop (update_step), level-major in and out."""
    class P:  # update_step only touches these three fields
        bottom_up, top_down, pos_emb = bu_p, td_p, pos

    nl = lv0.shape[0]
    levels = jnp.transpose(lv0, (1, 2, 0, 3))
    cons = partial(consensus_attention, attend_self=attend_self,
                   local_mask=build_local_mask(SIDE, radius))
    for _ in range(iters):
        levels = jcore.update_step(P, levels, tokens[:, :, None, :], pos[None, :, None, :],
                                   jcore.contribution_divisor(nl), consensus_fn=cons)
    return jnp.transpose(levels, (2, 0, 1, 3))


@pytest.fixture(scope="module")
def interpret_loop():
    """glom_tpu's fused_glom_loop forward and gradients in interpret mode,
    computed once (about 14 s here)."""
    inputs = _loop_inputs(0)
    fn = partial(jloop.fused_glom_loop, iters=ITERS, side=SIDE, radius=0.0,
                 attend_self=False, interpret=True)
    out, grads = _jax_grads(lambda *a: fn(*a), inputs)
    return inputs, out, grads


class TestLoopAgainstGlomTpu:
    def test_matches_pallas_loop_in_interpret_mode(self, interpret_loop):
        inputs, jout, jgrads = interpret_loop
        out, grads = _port_loop_grads(inputs, ITERS, 0.0, False)
        _close(out, jout, what="output")
        names = [f"bu.{k}" for k in "w1 b1 w2 b2".split()] + [
            f"td.{k}" for k in "w1 b1 w2 b2".split()] + ["pos_emb", "tokens", "levels0"]
        for name, got, want in zip(names, grads, jgrads):
            _close(got, want, what=name)

    def test_per_iteration_route_takes_the_same_arguments(self, interpret_loop):
        """`per_iteration_loop` is the loop's drop-in twin (the A/B in
        chip_smoke.py swaps one for the other): same arguments, same
        output and gradients within glom_tpu's bar."""
        inputs, jout, jgrads = interpret_loop
        bu, td, pos, tok, lv0 = inputs
        leaves = [torch.from_numpy(t).requires_grad_() for t in (*bu, *td, pos, tok, lv0)]
        out = core.per_iteration_loop(
            GroupedFFWParams(*leaves[:4]), GroupedFFWParams(*leaves[4:8]), *leaves[8:],
            ITERS, SIDE, 0.0, False)
        _close(out, jout, what="output")
        for got, want in zip(torch.autograd.grad((out ** 2).mean(), leaves), jgrads):
            _close(got, want)

    def test_remat_gradients_equal_non_remat(self, interpret_loop):
        inputs = interpret_loop[0]
        out0, g0 = _port_loop_grads(inputs, ITERS, 0.0, False)
        out1, g1 = _port_loop_grads(inputs, ITERS, 0.0, False, remat=True)
        assert torch.equal(out0, out1)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))

    @pytest.mark.parametrize("iters,radius,attend_self,levels", [
        (ITERS, 1.5, False, L),   # a local radius: the masked band
        (ITERS, 0.0, True, L),    # attend_self: the diagonal keeps its score
        (1, 0.0, False, L),       # one iteration: the combine without streams
        (2, 0.0, False, 2),       # L = 2: the final combine's two-part form
    ], ids=["radius", "attend_self", "one_iter", "two_levels"])
    def test_matches_xla_reference_loop(self, iters, radius, attend_self, levels):
        inputs = _loop_inputs(1, L_=levels)
        jout, jgrads = _jax_grads(
            partial(_ref_loop, iters=iters, radius=radius, attend_self=attend_self), inputs)
        out, grads = _port_loop_grads(inputs, iters, radius, attend_self)
        _close(out, jout, what="output")
        for got, want in zip(grads, jgrads):
            _close(got, want)
        if levels == L and radius > 0:  # remat under a mask, bit for bit
            _, g1 = _port_loop_grads(inputs, iters, radius, attend_self, remat=True)
            assert all(torch.equal(a, b) for a, b in zip(grads, g1))

    @pytest.mark.parametrize("remat", [False, True], ids=["keep", "remat"])
    def test_residuals_go_through_autograd(self, remat):
        """Every residual is a saved tensor: saved-tensor hooks see each
        one, a second backward over a retained graph gives the same
        gradients, and a carry changed in place after the forward trips
        autograd's version check."""
        bu, td, *rest = _loop_inputs(7)
        leaves = [torch.from_numpy(t).requires_grad_() for t in (*bu, *td, *rest)]
        packed = []

        def loop():
            return fused_glom_loop(GroupedFFWParams(*leaves[:4]), GroupedFFWParams(*leaves[4:8]),
                                   *leaves[8:], 2, SIDE, 0.0, False, remat)

        with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t,
                                                      lambda t: t):
            out = loop()
        # pos, weights, 2 iterations of (carry, [2L-1] pre unless remat, m, l)
        assert len(packed) == 1 + 8 + 2 * (3 if remat else 4)
        g0 = torch.autograd.grad(out.sum(), leaves, retain_graph=True)
        g1 = torch.autograd.grad(out.sum(), leaves)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
        out = loop()
        carry = out.grad_fn.saved_tensors[9]  # iteration 0's slot carry
        assert carry.shape == (L + 1, B, N, D)
        carry.add_(1.0)
        with pytest.raises(RuntimeError, match="modified by an inplace operation"):
            torch.autograd.grad(out.sum(), leaves)

    def test_refuses_zero_iterations(self):
        bu, td, *rest = _loop_inputs(2)
        with pytest.raises(ValueError, match="at least one"):
            fused_glom_loop(GroupedFFWParams(*map(torch.from_numpy, bu)),
                            GroupedFFWParams(*map(torch.from_numpy, td)),
                            *map(torch.from_numpy, rest), 0, SIDE, 0.0, False)


class TestKernelFunctionsAgainstGlomTpu:
    """The three new kernel functions' plain versions against glom_tpu's
    loop kernels in interpret mode, reading a slot carry at its offsets."""

    def _carry(self, seed):
        rng = np.random.default_rng(seed)
        ext = rng.standard_normal((L + 1, B, N, D)).astype(np.float32)
        return rng, ext, ext.reshape(L + 1, B * N, D)

    @pytest.mark.parametrize("which", ["bottom_up", "top_down"])
    def test_pre_only(self, which):
        rng, _, ext2 = self._carry(3)
        G, off = (L, 0) if which == "bottom_up" else (L - 1, 2)
        w = _ffw_numpy(rng, G, D, F)
        pos = rng.standard_normal((N, D)).astype(np.float32) if which == "top_down" else None
        want = jloop._pre_fwd_ext(
            JaxFFW(*map(jnp.asarray, w)), jnp.asarray(ext2), off, G,
            tile_m=_pick_tile(B * N, D, F, 4), interpret=True,
            add=None if pos is None else jnp.asarray(pos))
        params = GroupedFFWParams(*map(torch.from_numpy, w))
        x = torch.from_numpy(ext2)[off:off + G]  # a contiguous slot view
        add = None if pos is None else torch.from_numpy(pos)
        got = tk1.grouped_mlp_pre(params, x, add=add)
        _close(got, want)
        assert torch.equal(got, tk1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1])

    @pytest.mark.parametrize("which", ["bottom_up", "top_down"])
    def test_backward_accumulates(self, which):
        rng, _, ext2 = self._carry(4)
        G, off = (L, 0) if which == "bottom_up" else (L - 1, 2)
        w = _ffw_numpy(rng, G, D, F)
        pos = rng.standard_normal((N, D)).astype(np.float32) if which == "top_down" else None
        dmean = rng.standard_normal((L, B * N, D)).astype(np.float32)
        # Incoming totals as large as one call's gradients, so dropping them fails.
        acc = [rng.standard_normal(t.shape).astype(np.float32) * 8.0 for t in w]
        da_in = rng.standard_normal((N, D)).astype(np.float32) * 8.0
        params = GroupedFFWParams(*map(torch.from_numpy, w))
        x = torch.from_numpy(ext2)[off:off + G]
        add = None if pos is None else torch.from_numpy(pos)
        pre = tk1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1]
        jacc, jdx, jda = jloop._ffw_bwd_ext(
            JaxFFW(*map(jnp.asarray, w)), jnp.asarray(ext2), off, G, jnp.asarray(pre.numpy()),
            jnp.asarray(dmean),
            JaxFFW(jnp.asarray(acc[0]), jnp.asarray(acc[1])[:, None], jnp.asarray(acc[2]),
                   jnp.asarray(acc[3])[:, None]),
            tile_m=_pick_bwd_tile(B * N, D, F, 4), interpret=True,
            add=None if pos is None else jnp.asarray(pos),
            da_in=None if pos is None else jnp.asarray(da_in))
        tacc = GroupedFFWParams(*(torch.from_numpy(a.copy()) for a in acc))
        tda = None if pos is None else torch.from_numpy(da_in.copy())
        g = torch.from_numpy(dmean)[:G]  # a prefix view of dmean
        dx, grads, da = tk1.grouped_mlp_bwd(params, x, g, add=add, pre=pre, acc=tacc, da_in=tda)
        assert grads is tacc and da is tda  # updated in place
        _close(dx, jdx)
        for got, want in zip(grads, (jacc.w1, jacc.b1[:, 0], jacc.w2, jacc.b2[:, 0])):
            _close(got, want)
        if pos is not None:
            _close(da, jda)

    @pytest.mark.parametrize("radius,attend_self,streams", [
        (0.0, False, True), (1.5, True, True), (0.0, False, False),
    ], ids=["global", "radius_self", "no_streams"])
    def test_consensus_combine(self, radius, attend_self, streams):
        rng, ext, _ = self._carry(5)
        ext = ext * 2.0
        lv = torch.from_numpy(ext)[1:]
        kw = dict(side=SIDE, radius=radius, attend_self=attend_self)
        _, m, l = tk2.fused_consensus_update(
            lv, torch.zeros_like(lv), torch.zeros_like(lv[1:]), stats=True, **kw)
        dg, dx_bu = (rng.standard_normal((L, B, N, D)).astype(np.float32) for _ in range(2))
        dx_td = rng.standard_normal((L - 1, B, N, D)).astype(np.float32)
        if not streams:
            dx_bu = dx_td = None
        jdlv, jdmean = jloop._cons_bwd_ext(
            jnp.asarray(ext), jnp.asarray(m.numpy()), jnp.asarray(l.numpy()), jnp.asarray(dg),
            None if dx_bu is None else jnp.asarray(dx_bu),
            None if dx_td is None else jnp.asarray(dx_td), interpret=True, **kw)
        opt = (lambda a: None if a is None else torch.from_numpy(a))
        dlv, dmean = tk2.consensus_update_bwd(
            lv, torch.from_numpy(dg), m, l, dx_bu=opt(dx_bu), dx_td=opt(dx_td), combine=True,
            **kw)
        _close(dlv, jdlv)
        _close(dmean, jdmean)

    def test_streams_need_the_combine(self):
        lv = torch.zeros(3, 1, 16, 64)
        m = l = torch.ones(3, 1, 16, 1)
        with pytest.raises(ValueError, match="combine"):
            tk2.consensus_update_bwd(lv, lv, m, l, side=4, dx_bu=lv, dx_td=lv[1:])

    def test_cpu_counts_no_launch(self):
        names = ("LAUNCHES_PRE", "LAUNCHES_BWD_ACC", "LAUNCHES_BWD_ACC_ADD")
        before = [getattr(tk1, k) for k in names] + [
            tk2.LAUNCHES_BWD_COMBINE_DQ, tk2.LAUNCHES_BWD_COMBINE_DKV]
        _port_loop_grads(_loop_inputs(6), 1, 0.0, False, remat=True)
        after = [getattr(tk1, k) for k in names] + [
            tk2.LAUNCHES_BWD_COMBINE_DQ, tk2.LAUNCHES_BWD_COMBINE_DKV]
        assert after == before


FLAGSHIP_BATCHES = [1, 2, 4, 8, 16, 64, 96]


@pytest.fixture
def jax_on_tpu(monkeypatch):
    """glom_tpu's route resolution as it runs on the TPU."""
    monkeypatch.setattr(jcore, "_on_tpu", lambda: True)


class TestRoutes:
    def _both(self, cfg_kw, b, iters, **kw):
        jp = jcore.resolve_vjp_path(jconfig.GlomConfig(**cfg_kw), b, iters, assume_on_tpu=True, **kw)
        tp = resolve_vjp_path(GlomConfig(**cfg_kw), b, iters, device="cuda", **kw)
        return jp, tp

    @pytest.mark.parametrize("remat", [False, True])
    def test_vjp_path_matches_glom_tpu(self, remat):
        for b in FLAGSHIP_BATCHES:
            for iters in (7, 0):
                for extra in ({}, {"return_all": True}, {"scan_only": True},
                              {"custom_consensus": True}, {"use_pallas": False}):
                    kw = dict(dict(use_pallas=True, remat=remat, itemsize=2), **extra)
                    jp, tp = self._both({}, b, iters, **kw)
                    case = (b, iters, kw, jp, tp)
                    assert (tp == "fused_loop") == (jp == "fused_loop"), case
                    if jp == "scan_dense" and tp != "scan_dense":
                        # The named difference: glom_tpu's TPU crossover sends a
                        # small global-consensus batch to its dense VJP; the
                        # port's K2 backward kernel runs at every batch.
                        assert (tp, b < 8) == ("scan_blockwise", True), case
                    elif tp != "fused_loop":
                        assert tp == jp, case
        # The flagship at batch 8 and up trains on the loop, remat or not.
        assert self._both({}, 8, 7, use_pallas=True, remat=remat) == ("fused_loop",) * 2

    def test_named_differences(self):
        # n = 1024 > 512: both packages leave the loop (glom_tpu's cap, kept
        # by the port because its one-sweep per-iteration route is faster
        # there on the card).
        jp, tp = self._both({"image_size": 448}, 8, 7, use_pallas=True)
        assert jp != "fused_loop" and tp != "fused_loop"
        # Batch 128 without remat: 12 GB of residuals, past glom_tpu's 10 GB
        # (a v5e's HBM) and within the port's 32 GB.
        jp, tp = self._both({}, 128, 7, use_pallas=True)
        assert jp != "fused_loop" and tp == "fused_loop"
        assert residual_bytes(6, 128, 256, 512, 2048, 2, 7) <= RESIDUAL_BUDGET
        assert self._both({}, 128, 7, use_pallas=True, remat=True) == ("fused_loop",) * 2

    @pytest.mark.parametrize("remat", [False, True])
    def test_training_route_matches_glom_tpu(self, remat, jax_on_tpu):
        cfg, jcfg = GlomConfig(), jconfig.GlomConfig()
        for b in FLAGSHIP_BATCHES + [128]:
            for accum in (None, 1, 2):
                if b % (accum or 1):
                    continue
                kw = dict(batch_size=b, grad_accum=accum, remat=remat, use_pallas=True,
                          compute_dtype="bfloat16")
                ja, jp = jtrainer.resolve_training_route(jcfg, jconfig.TrainConfig(**kw))
                ta, tp = resolve_training_route(cfg, TrainConfig(**kw), device="cuda")
                case = (b, accum, remat, (ja, jp), (ta, tp))
                if b == 128 and not remat and accum != 2:
                    # The named difference above: the port trains the whole
                    # batch on the loop, where glom_tpu splits it (auto) or
                    # leaves the loop (pinned to one pass).
                    want_j = (2, "fused_loop") if accum is None else (1, "scan_blockwise")
                    assert (ja, jp) == want_j and (ta, tp) == (1, "fused_loop"), case
                    continue
                assert ta == ja and (tp == "fused_loop") == (jp == "fused_loop"), case
        assert resolve_training_route(
            cfg, TrainConfig(batch_size=64, use_pallas=True), scan_only=True, device="cuda"
        ) == (1, "scan_blockwise")

    def test_auto_split_reaches_the_loop(self):
        """A batch past the port's budget splits into the fewest power-of-two
        microbatches that fit, as glom_tpu's rule does with its own budget."""
        cfg = GlomConfig()
        tcfg = TrainConfig(batch_size=512, use_pallas=True, compute_dtype="bfloat16")
        assert resolve_vjp_path(cfg, 512, 7, use_pallas=True, device="cuda") == "scan_blockwise"
        assert resolve_training_route(cfg, tcfg, device="cuda") == (2, "fused_loop")
        pinned = dataclasses.replace(tcfg, grad_accum=1)
        assert resolve_training_route(cfg, pinned, device="cuda") == (1, "scan_blockwise")

    def test_route_keys_match_glom_tpu(self):
        cfg, jcfg = GlomConfig(levels=4), jconfig.GlomConfig(levels=4)
        for kw in ({}, {"iters": 5}, {"recon_iter_index": 3, "compute_dtype": "bfloat16"}):
            assert resolve_route_keys(cfg, TrainConfig(**kw)) == jtrainer.resolve_route_keys(
                jcfg, jconfig.TrainConfig(**kw))

    def test_loop_supported(self):
        assert loop_supported(6, 8, 256, 512, 2048, 2, 7, 256)  # the flagship
        assert loop_supported(6, 8, 256, 512, 2048, 2, 7, 256, side=16, radius=2.0)
        assert not loop_supported(6, 8, 256, 512, 2048, 2, 0, 256)  # no iterations
        assert not loop_supported(6, 8, 256, 512, 2048, 2, 7, 128)  # pos table mismatch
        assert not loop_supported(6, 8, 256, 512, 2048, 2, 7, 256, side=15, radius=2.0)
        assert not loop_supported(6, 8, 256, 480, 1920, 2, 7, 256)  # d % 64
        assert not loop_supported(6, 4, 24, 512, 2048, 2, 7, 24)  # n % 32 (bf16 K2 tile)
        assert not loop_supported(6, 1, 16, 512, 2048, 4, 7, 16)  # M = 16: K1's tile is 32
        assert not loop_supported(6, 1024, 256, 512, 2048, 2, 7, 256)  # past the budget
        assert not loop_supported(6, 8, 256, 512, 2048, 1, 7, 256)  # no 1-byte kernels


class TestTrainerOnTheLoop:
    def test_batch8_steps_match_glom_tpu_trainer(self, monkeypatch):
        """The port's Trainer at batch 8 with the card's routing (the
        `_on_card` seam patched): its records say fused_loop, its forward
        goes through fused_glom_loop, and two Adam steps match glom_tpu's
        trainer on transplanted weights (noise_std 0, so no draw differs)."""
        kw = dict(dim=64, levels=3, image_size=16, patch_size=4)
        jcfg, cfg = jconfig.GlomConfig(**kw), GlomConfig(**kw)
        jp = jobj.init_denoise(jax.random.PRNGKey(0), jcfg)
        flat = {}
        for name in jp.glom._fields:
            v = getattr(jp.glom, name)
            if hasattr(v, "_fields"):
                flat.update({f"{name}.{k}": np.asarray(getattr(v, k)) for k in v._fields})
            else:
                flat[name] = np.asarray(v)
        flat["to_pixels.w"], flat["to_pixels.b"] = map(np.asarray, jp.to_pixels)
        tkw = dict(batch_size=8, learning_rate=3e-3, noise_std=0.0)
        rng = np.random.default_rng(9)
        batches = [rng.standard_normal((8, 3, 16, 16)).astype(np.float32) for _ in range(2)]

        jt = jconfig.TrainConfig(**tkw)
        jstate, jopt = jtrainer.create_train_state(jax.random.PRNGKey(0), jcfg, jt)
        jstate = jstate._replace(params=jp, opt_state=jopt.init(jp))
        jstep = jax.jit(jtrainer.make_train_step(jcfg, jt, jopt))
        jlosses = []
        for img in batches:
            jstate, jm = jstep(jstate, jnp.asarray(img), jax.random.PRNGKey(1))
            jlosses.append(float(jm["loss"]))

        calls = []
        real = core.fused_glom_loop
        monkeypatch.setattr(core, "_on_card", lambda device: True)
        monkeypatch.setattr(core, "fused_glom_loop",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        tr = Trainer(cfg, TrainConfig(use_pallas=True, **tkw), params=params_from_numpy(flat),
                     device="cpu")
        assert (tr.vjp_path, tr.grad_accum) == ("fused_loop", 1)
        hist = tr.fit(iter(batches), 2, log_every=1)
        assert len(calls) == 2  # one loop per step
        assert [(r["vjp_path"], r["grad_accum"]) for r in hist] == [("fused_loop", 1)] * 2
        np.testing.assert_allclose([r["loss"] for r in hist], jlosses, rtol=5e-4)
        for got, want in zip(param_leaves(tr.state.params),
                             jax.tree_util.tree_leaves(jstate.params)):
            _close(got, want, rtol=1e-3, atol=1e-5)
