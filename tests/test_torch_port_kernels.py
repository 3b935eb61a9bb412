"""The port's kernel modules against glom_tpu's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which follows the
CUDA kernel's per-dtype rules (tanh GELU in bf16, k normalized in f32).
It is held here against the Pallas kernel run in interpret mode, with the
tolerances glom_tpu holds its own kernels to (tests/test_kernels.py:26,
:97, :275). The CUDA kernels themselves are held against the plain
versions on the card, by tests/test_torch_port_gpu.py and chip_smoke.py.
"""

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

K1_BARS = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (5e-2, 5e-2)}
K2_BARS = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (5e-2, 5e-2)}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _k1_inputs(seed, G=3, M=256, d=128, f=512, n=64):
    rng = np.random.default_rng(seed)
    w = [rng.uniform(-s, s, shape).astype(np.float32) for s, shape in (
        (d ** -0.5, (G, d, f)), (d ** -0.5, (G, f)),
        (f ** -0.5, (G, f, d)), (f ** -0.5, (G, d)),
    )]
    x = rng.standard_normal((G, M, d)).astype(np.float32)
    a = rng.standard_normal((n, d)).astype(np.float32)
    return w, x, a


def _k2_inputs(seed, L=3, B=2, side=8, d=128):
    rng = np.random.default_rng(seed)
    n = side * side
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((L, B, n, d), (L, B, n, d), (L - 1, B, n, d))]


def _as_float(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


class TestGroupedMLP:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("with_add", [False, True])
    def test_plain_matches_pallas_interpret(self, dtype, with_add):
        w, x, a = _k1_inputs(0)
        jd = JAX_DTYPE[dtype]
        want = jax_k1(
            JaxFFW(*(jnp.asarray(t).astype(jd) for t in w)),
            jnp.asarray(x).astype(jd),
            add=jnp.asarray(a).astype(jd) if with_add else None,
            interpret=True,
        )
        params = GroupedFFWParams(*(torch.from_numpy(t).to(dtype) for t in w))
        got = tk1.fused_grouped_ffw_lm(
            params, torch.from_numpy(x).to(dtype),
            add=torch.from_numpy(a).to(dtype) if with_add else None,
        )
        assert got.dtype == dtype
        rtol, atol = K1_BARS[dtype]
        np.testing.assert_allclose(_as_float(got), _as_float(want), rtol=rtol, atol=atol)

    def test_cpu_runs_plain_and_counts_nothing(self):
        w, x, a = _k1_inputs(1)
        params = GroupedFFWParams(*map(torch.from_numpy, w))
        before = (tk1.LAUNCHES, tk1.LAUNCHES_ADD)
        got = tk1.fused_grouped_ffw_lm(params, torch.from_numpy(x), add=torch.from_numpy(a))
        want = tk1.grouped_mlp_plain(params, torch.from_numpy(x), torch.from_numpy(a))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert (tk1.LAUNCHES, tk1.LAUNCHES_ADD) == before

    @pytest.mark.parametrize("case", ["d", "f", "M", "n", "dtype", "layout", "weight"])
    def test_kernel_arg_check_raises(self, case):
        def tensors(arrays):
            return [torch.from_numpy(t).clone() for t in arrays]

        w, x, a = _k1_inputs(2)
        params = GroupedFFWParams(*tensors(w))
        xt, at = tensors([x, a])
        tk1.check_kernel_args(params, xt, at)  # the valid call passes
        if case == "d":
            w2, x2, _ = _k1_inputs(2, d=96)
            params, xt, at = GroupedFFWParams(*tensors(w2)), tensors([x2])[0], None
        elif case == "f":
            w2, _, _ = _k1_inputs(2, f=480)
            params = GroupedFFWParams(*tensors(w2))
        elif case == "M":
            xt = xt[:, :200].contiguous()
            at = None
        elif case == "n":
            at = at[:48].contiguous()
        elif case == "dtype":
            xt = xt.half()
        elif case == "layout":
            xt = xt.transpose(0, 1).contiguous().transpose(0, 1)
        elif case == "weight":
            params = params._replace(w1=params.w1[:, :, :256])
        with pytest.raises(ValueError):
            tk1.check_kernel_args(params, xt, at)


class TestConsensusUpdate:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("radius", [0.0, 2.0])
    @pytest.mark.parametrize("attend_self", [False, True])
    def test_plain_matches_pallas_interpret(self, dtype, radius, attend_self):
        lv, bu, td = _k2_inputs(0)
        jd = JAX_DTYPE[dtype]
        want = jax_k2(
            *(jnp.asarray(t).astype(jd) for t in (lv, bu, td)),
            side=8, radius=radius, attend_self=attend_self,
            interpret=True, bwd_impl="blockwise",
        )
        got = tk2.fused_consensus_update(
            *(torch.from_numpy(t).to(dtype) for t in (lv, bu, td)),
            side=8, radius=radius, attend_self=attend_self,
        )
        assert got.dtype == dtype
        rtol, atol = K2_BARS[dtype]
        np.testing.assert_allclose(_as_float(got), _as_float(want), rtol=rtol, atol=atol)

    def test_out_argument_and_no_count_on_cpu(self):
        lv, bu, td = (torch.from_numpy(t) for t in _k2_inputs(1))
        out = torch.empty_like(lv)
        before = tk2.LAUNCHES
        got = tk2.fused_consensus_update(lv, bu, td, side=8, out=out)
        assert got is out and tk2.LAUNCHES == before
        torch.testing.assert_close(out, tk2.consensus_update_plain(lv, bu, td, side=8))

    @pytest.mark.parametrize("case", ["alias", "td", "n", "d", "side"])
    def test_kernel_arg_check_raises(self, case):
        lv, bu, td = (torch.from_numpy(t) for t in _k2_inputs(2))
        out = torch.empty_like(lv)
        kw = {"side": 8, "radius": 2.0}
        tk2.check_kernel_args(lv, bu, td, out, **kw)  # the valid call passes
        if case == "alias":
            out = lv
        elif case == "td":
            td = td[:1].contiguous()
        elif case == "n":
            lv, bu, out = (t[:, :, :56].contiguous() for t in (lv, bu, out))
            td = td[:, :, :56].contiguous()
            kw["radius"] = 0.0
        elif case == "d":
            lv, bu, out = (t[..., :96].contiguous() for t in (lv, bu, out))
            td = td[..., :96].contiguous()
        elif case == "side":
            kw["side"] = 7
        with pytest.raises(ValueError):
            tk2.check_kernel_args(lv, bu, td, out, **kw)
