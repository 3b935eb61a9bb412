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

    @pytest.mark.parametrize("case", ["d", "f", "M", "n", "dtype", "layout", "weight", "align"])
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
        elif case == "align":  # TMA reads x from a 16-byte-aligned address
            xt = torch.zeros(xt.numel() + 2)[2:].view(xt.shape)
        with pytest.raises(ValueError):
            tk1.check_kernel_args(params, xt, at)

    @pytest.mark.parametrize("G,M,f", [(6, 2048, 2048), (11, 2048, 2048), (6, 8192, 2048),
                                       (6, 32768, 2048), (3, 2080, 192)])
    def test_slab_rows_bound_the_hidden_scratch(self, G, M, f):
        """The bf16 forward's [G, R, f] hidden scratch stays under its cap:
        all M rows when they fit, else whole 128-row GEMM tiles, the most
        that fit."""
        R = tk1.slab_rows(G, M, f)
        tile, cap = tk1.GEMM_ROW_TILE, tk1.H_SCRATCH_CAP
        assert G * R * f * 2 <= cap
        if G * M * f * 2 <= cap:
            assert R == M
        else:
            assert R % tile == 0 and R < M and G * (R + tile) * f * 2 > cap

    def test_slab_rows_take_at_least_one_tile(self, monkeypatch):
        monkeypatch.setattr(tk1, "H_SCRATCH_CAP", 1)
        assert tk1.slab_rows(6, 2048, 2048) == tk1.GEMM_ROW_TILE
        monkeypatch.setattr(tk1, "H_SCRATCH_CAP", 6 * 300 * 2048 * 2)
        assert tk1.slab_rows(6, 2048, 2048) == 256


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

    @pytest.mark.parametrize("n,d", [(32, 512), (96, 512), (160, 512), (256, 512),
                                     (4096, 512), (96, 64), (160, 640)])
    def test_kernel_args_take_bf16_row_multiples(self, n, d):
        """The bf16 kernel takes every n % 32 == 0 with d % 64 == 0, also
        where n is not a multiple of its 64-row tiles."""
        L, B = 2, 1
        lv, bu, out = (torch.zeros(L, B, n, d, dtype=torch.bfloat16) for _ in range(3))
        td = torch.zeros(L - 1, B, n, d, dtype=torch.bfloat16)
        tk2.check_kernel_args(lv, bu, td, out, side=1, radius=0.0)

    @pytest.mark.parametrize("case", ["n", "d", "align"])
    def test_kernel_args_refuse_bf16(self, case):
        L, B, n, d = 2, 1, 96, 128
        shape = {"n": (L, B, 48, d), "d": (L, B, n, 96), "align": (L, B, n, d)}[case]
        lv, bu, out = (torch.zeros(shape, dtype=torch.bfloat16) for _ in range(3))
        td = torch.zeros((L - 1, *shape[1:]), dtype=torch.bfloat16)
        if case == "align":  # TMA reads levels from a 16-byte-aligned address
            lv = torch.zeros(lv.numel() + 1, dtype=torch.bfloat16)[1:].view(shape)
        with pytest.raises(ValueError):
            tk2.check_kernel_args(lv, bu, td, out, side=1, radius=0.0)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_khat_scratch_shape_and_alignment(self, dtype):
        """The bf16 kernel's k scratch has the shape, dtype and device of
        the normalized keys its pre-pass writes (the plain version's k,
        rounded; the card test test_consensus_update_khat_prepass holds the
        contents) and starts on a TMA boundary; f32 normalizes in the
        kernel and needs none."""
        lv = torch.from_numpy(_k2_inputs(3)[0]).to(dtype)
        scratch = tk2.khat_scratch(lv)
        if dtype == torch.float32:
            assert scratch is None
            return
        want = tk2._normalized_k(lv).to(dtype)
        assert (scratch.shape, scratch.dtype, scratch.device) == (
            want.shape, want.dtype, want.device)
        assert scratch.is_contiguous() and scratch.data_ptr() % tk2.TMA_ALIGN == 0


@pytest.mark.parametrize("module,names", [
    ("grouped_mlp", ("LAUNCHES", "LAUNCHES_ADD")),
    ("consensus_update", ("LAUNCHES", "LAUNCHES_CONS")),
    ("banded_consensus", ("LAUNCHES",)),
])
def test_launch_counters_count_exactly_under_threads(module, names, monkeypatch):
    """The batcher's engine workers launch from several threads: every
    wrapper's counts go through `_build.count`, whose lock loses no
    increment when eight threads hammer one counter: the module's own, and
    a namespace that hands the thread switch to another thread between
    each read and its write (where an unlocked `+=` loses counts)."""
    import importlib
    import sys
    import threading
    import time

    from glom_tpu_torch.kernels import _build

    class Yielding(dict):
        def __getitem__(self, key):
            value = super().__getitem__(key)
            time.sleep(0)  # let another thread run between read and write
            return value

    mod = importlib.import_module(f"glom_tpu_torch.kernels.{module}")
    for name in names:
        monkeypatch.setattr(mod, name, 0)
    yielding = Yielding({name: 0 for name in names})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the VM allows
    try:
        n_threads, n_each = 8, 1000
        start = threading.Barrier(n_threads)

        def hammer():
            start.wait()
            for _ in range(n_each):
                _build.count(vars(mod), *names, None)
                _build.count(yielding, *names)

        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    for name in names:
        assert getattr(mod, name) == yielding[name] == n_threads * n_each
