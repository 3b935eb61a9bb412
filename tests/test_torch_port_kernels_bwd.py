"""The port's backward kernels (plain versions on the CPU) against the VJPs
of glom_tpu's Pallas kernels, and the raw wrappers' grad refusal.

The same numpy inputs go through `jax.grad` of glom_tpu's
`fused_grouped_ffw_lm` / `fused_consensus_update` in interpret mode (the
custom VJPs' backward kernels run there too) and through the port's plain
backward versions and autograd Functions. float32 only, at the bars
tests/test_kernels.py:38-43 holds glom_tpu's own backward kernels to (rtol
2e-3, atol 1e-5): CPU XLA has no bf16 x bf16 -> f32 dot, so the bf16 paths
are held on the card (tests/test_torch_port_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glom_tpu_torch.kernels.consensus_update as tk2
import glom_tpu_torch.kernels.grouped_mlp as tk1
from glom_tpu.kernels.consensus_update import fused_consensus_update as jax_k2
from glom_tpu.kernels.grouped_mlp import fused_grouped_ffw_lm as jax_k1
from glom_tpu.ops.ffw import GroupedFFWParams as JaxFFW
from glom_tpu_torch.ops.ffw import GroupedFFWParams

RTOL, ATOL = 2e-3, 1e-5


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got.detach() if torch.is_tensor(got) else got, np.float32),
        np.asarray(want, np.float32), rtol=RTOL, atol=ATOL,
    )


def _k1_inputs(seed, G=3, M=256, d=128, f=512, n=64):
    rng = np.random.default_rng(seed)
    w = [rng.uniform(-s, s, shape).astype(np.float32) for s, shape in (
        (d ** -0.5, (G, d, f)), (0.1, (G, f)), (f ** -0.5, (G, f, d)), (0.1, (G, d)),
    )]
    x, g = (rng.standard_normal((G, M, d)).astype(np.float32) for _ in range(2))
    a = rng.standard_normal((n, d)).astype(np.float32)
    return w, x, a, g


def _jax_k1_grads(w, x, a, g, with_add):
    def f(params, xx, aa):
        out = jax_k1(params, xx, add=aa if with_add else None, interpret=True)
        return jnp.sum(out * g)

    return jax.grad(f, argnums=(0, 1, 2))(
        JaxFFW(*map(jnp.asarray, w)), jnp.asarray(x), jnp.asarray(a)
    )


class TestGroupedMLPBackward:
    @pytest.mark.parametrize("with_add", [False, True])
    def test_plain_matches_pallas_vjp(self, with_add):
        w, x, a, g = _k1_inputs(0)
        jgrads, jdx, jda = _jax_k1_grads(w, x, a, g, with_add)
        dx, grads, da = tk1.grouped_mlp_bwd(
            GroupedFFWParams(*map(torch.from_numpy, w)), torch.from_numpy(x),
            torch.from_numpy(g), add=torch.from_numpy(a) if with_add else None,
        )
        _close(dx, jdx)
        for got, want in zip(grads, jgrads):
            _close(got, want)
        if with_add:
            _close(da, jda)
        else:
            assert da is None

    @pytest.mark.parametrize("with_add", [False, True])
    def test_autograd_function_matches_pallas_vjp(self, with_add):
        w, x, a, g = _k1_inputs(1)
        jgrads, jdx, jda = _jax_k1_grads(w, x, a, g, with_add)
        params = GroupedFFWParams(*(torch.from_numpy(t).requires_grad_() for t in w))
        xt = torch.from_numpy(x).requires_grad_()
        at = torch.from_numpy(a).requires_grad_() if with_add else None
        out = tk1.grouped_ffw_lm_vjp(params, xt, add=at)
        _close(out, jax_k1(JaxFFW(*map(jnp.asarray, w)), jnp.asarray(x),
                           add=jnp.asarray(a) if with_add else None, interpret=True))
        out.backward(torch.from_numpy(g))
        _close(xt.grad, jdx)
        for t, want in zip(params, jgrads):
            _close(t.grad, want)
        if with_add:
            _close(at.grad, jda)

    def test_saved_pre_equals_recompute(self):
        w, x, a, g = _k1_inputs(2)
        params = GroupedFFWParams(*map(torch.from_numpy, w))
        xt, at, gt = map(torch.from_numpy, (x, a, g))
        out, pre = tk1.fused_grouped_ffw_lm(params, xt, add=at, save_pre=True)
        torch.testing.assert_close(out, tk1.fused_grouped_ffw_lm(params, xt, add=at))
        saved = tk1.grouped_mlp_bwd(params, xt, gt, add=at, pre=pre)
        recomputed = tk1.grouped_mlp_bwd(params, xt, gt, add=at)
        for got, want in zip((saved[0], *saved[1], saved[2]),
                             (recomputed[0], *recomputed[1], recomputed[2])):
            torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_save_pre_gate(self):
        w, x, _, _ = _k1_inputs(3)
        params = GroupedFFWParams(*map(torch.from_numpy, w))
        xt = torch.from_numpy(x)
        assert not tk1.save_pre_ok(params, xt)  # f32 recomputes
        bf = GroupedFFWParams(*(t.bfloat16() for t in params))
        assert tk1.save_pre_ok(bf, xt.bfloat16())
        # [8, 2^17, f = 512] bf16 is 1 GiB, past the 512 MiB cap (a view:
        # only the shape is read)
        big = torch.zeros((1, 1, x.shape[-1]), dtype=torch.bfloat16).expand(8, 2 ** 17, -1)
        assert not tk1.save_pre_ok(bf, big)

    def test_cpu_counts_no_launch(self):
        w, x, a, g = _k1_inputs(4)
        before = (tk1.LAUNCHES_BWD, tk1.LAUNCHES_BWD_ADD)
        tk1.grouped_mlp_bwd(GroupedFFWParams(*map(torch.from_numpy, w)), torch.from_numpy(x),
                            torch.from_numpy(g), add=torch.from_numpy(a))
        assert (tk1.LAUNCHES_BWD, tk1.LAUNCHES_BWD_ADD) == before


def _k2_inputs(seed, L, B, side, d):
    rng = np.random.default_rng(seed)
    n = side * side
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s, scale in (
        ((L, B, n, d), 2.0), ((L, B, n, d), 1.0), ((L - 1, B, n, d), 1.0), ((L, B, n, d), 1.0),
    )]


K2_CASES = [
    (3, 2, 8, 128, 0.0, False),
    (3, 2, 8, 128, 0.0, True),
    (3, 2, 8, 128, 3.0, False),
    (3, 2, 8, 128, 3.0, True),
    (2, 1, 24, 128, 0.0, False),  # n = 576: past glom_tpu's single-tile backward
    (2, 1, 24, 128, 0.0, True),
    (2, 1, 24, 128, 3.0, False),
    (2, 1, 24, 128, 3.0, True),
]


class TestConsensusUpdateBackward:
    @pytest.mark.parametrize("L,B,side,d,radius,attend_self", K2_CASES)
    def test_vjp_matches_pallas_vjp(self, L, B, side, d, radius, attend_self):
        lv, bu, td, g = _k2_inputs(0, L, B, side, d)
        kw = dict(side=side, radius=radius, attend_self=attend_self)

        def f(lv_, bu_, td_):
            out = jax_k2(lv_, bu_, td_, interpret=True, bwd_impl="blockwise", **kw)
            return jnp.sum(out * g)

        jdlv, jdbu, jdtd = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (lv, bu, td)))
        ts = [torch.from_numpy(t).requires_grad_() for t in (lv, bu, td)]
        out = tk2.consensus_update_vjp(*ts, **kw)
        out.backward(torch.from_numpy(g))
        for t, want in zip(ts, (jdlv, jdbu, jdtd)):
            _close(t.grad, want)

    @pytest.mark.parametrize("radius,attend_self", [(0.0, False), (2.0, True)])
    def test_passes_compose_to_the_whole_backward(self, radius, attend_self):
        lv, bu, td, g = map(torch.from_numpy, _k2_inputs(1, 3, 2, 8, 64))
        kw = dict(side=8, radius=radius, attend_self=attend_self)
        _, m, l = tk2.fused_consensus_update(lv, bu, td, stats=True, **kw)
        dq, dd = tk2.consensus_bwd_dq_plain(lv, g, m, l, **kw)
        dlv, dmean, parts = tk2.consensus_bwd_dkv_plain(lv, g, m, l, dq, dd, parts=True, **kw)
        whole = tk2.consensus_update_bwd(lv, g, m, l, **kw)
        torch.testing.assert_close(dlv, whole[0], rtol=0, atol=0)
        torch.testing.assert_close(dmean, whole[1], rtol=0, atol=0)
        div = torch.tensor([4.0, 4.0, 3.0]).reshape(3, 1, 1, 1)
        torch.testing.assert_close(dmean, g / div)
        torch.testing.assert_close(dlv, g / div + dq + parts["dv"] + parts["dxn"])

    def test_stats_are_the_softmax_statistics(self):
        lv, bu, td, _ = map(torch.from_numpy, _k2_inputs(2, 3, 1, 8, 64))
        out, m, l = tk2.fused_consensus_update(lv, bu, td, side=8, stats=True)
        torch.testing.assert_close(out, tk2.fused_consensus_update(lv, bu, td, side=8))
        assert m.shape == l.shape == (3, 1, 64, 1) and m.dtype == l.dtype == torch.float32
        assert bool((l >= 1.0).all())  # the row maximum contributes exp(0)

    def test_cpu_counts_no_launch(self):
        lv, bu, td, g = map(torch.from_numpy, _k2_inputs(3, 3, 1, 8, 64))
        _, m, l = tk2.fused_consensus_update(lv, bu, td, side=8, stats=True)
        before = (tk2.LAUNCHES_BWD_DQ, tk2.LAUNCHES_BWD_DKV)
        tk2.consensus_update_bwd(lv, g, m, l, side=8)
        assert (tk2.LAUNCHES_BWD_DQ, tk2.LAUNCHES_BWD_DKV) == before


class TestRawWrappersRefuseGrad:
    """A raw wrapper writes through a pointer autograd cannot see: under
    grad mode it refuses an input that requires grad, on every device."""

    def test_grouped_mlp(self):
        w, x, a, _ = _k1_inputs(5, G=2, M=64, d=64, f=128, n=16)
        params = GroupedFFWParams(*map(torch.from_numpy, w))
        xt, at = torch.from_numpy(x), torch.from_numpy(a)
        tk1.fused_grouped_ffw_lm(params, xt, add=at)  # nothing requires grad
        for case in ("x", "add", "w1"):
            p = params._replace(w1=params.w1.clone().requires_grad_()) if case == "w1" else params
            xx = xt.clone().requires_grad_() if case == "x" else xt
            aa = at.clone().requires_grad_() if case == "add" else at
            with pytest.raises(RuntimeError, match="requires grad"):
                tk1.fused_grouped_ffw_lm(p, xx, add=aa)
            with torch.no_grad():
                tk1.fused_grouped_ffw_lm(p, xx, add=aa)

    def test_consensus_update(self):
        lv, bu, td, _ = map(torch.from_numpy, _k2_inputs(6, 3, 1, 4, 64))
        for i in range(3):
            args = [t.clone().requires_grad_() if j == i else t for j, t in enumerate((lv, bu, td))]
            with pytest.raises(RuntimeError, match="requires grad"):
                tk2.fused_consensus_update(*args, side=4)
            with torch.inference_mode():
                tk2.fused_consensus_update(*args, side=4)
