"""The port's ragged serving route against glom_tpu's, on the CPU.

K4's plain version (`banded_ragged_consensus_plain`, what the wrapper runs
for CPU tensors) is held against glom_tpu's Pallas kernel in interpret mode
at glom_tpu's own bar (2e-6, tests/test_banded_alias.py:217) and against
the jnp banded route; the port's windowed and banded routes, the ragged
helpers, `glom_forward_ragged` and the engine's ragged route against
glom_tpu's. Inputs come from np.random.default_rng, weights from
glom_tpu's `init_glom` via `params_from_numpy`. The parity contract covers
each row's page span; unused trailing pages only have to be finite.
Forward tolerance rtol 2e-3 / atol 2e-4 (tests/test_torch_port_model.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glom_tpu_torch.kernels.banded_consensus as tk4
from glom_tpu.kernels.banded_consensus import banded_ragged_consensus as jax_k4
from glom_tpu.models import core as jcore
from glom_tpu.serve import batcher as jbatcher
from glom_tpu.serve import early_exit as jee
from glom_tpu.serve import engine as jengine
from glom_tpu.serve import paged_columns as jpaged
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import GlomConfig, InferenceEngine, ServeConfig, params_from_numpy
from glom_tpu_torch.serve import batcher as tbatcher
from glom_tpu_torch.serve import early_exit as tee
from glom_tpu_torch.serve import paged_columns as tpaged
from test_torch_port_model import ATOL, RTOL, TINY, flatten

PT = 4
COUNTS = [5, 3, 16, 1]  # intra-row pads on three rows
K4_INTERPRET_BAR = 2e-6  # glom_tpu's bar for its kernel against its jnp route
# K4's plain version against the jnp banded route in bf16: the jnp route
# rounds k and the probabilities to bf16, the kernel keeps both in f32;
# about 2 bf16 ulps of values near 2.
K4_BF16_VS_JNP = 1.6e-2
SCFG = dict(buckets=(1, 2, 4), max_batch=4, page_tokens=PT, ragged=True)


def _layout(counts, pages_sig=None, pt=PT):
    """Per-token (row_start, row_len), T, and each row's page span."""
    pages = [-(-c // pt) for c in counts]
    P = pages_sig if pages_sig is not None else sum(pages)
    T = P * pt
    row_start = np.zeros((T,), np.int32)
    row_len = np.zeros((T,), np.int32)
    spans, off = [], 0
    for c, k in zip(counts, pages):
        s = off * pt
        row_start[s:s + k * pt] = s
        row_len[s:s + k * pt] = c
        spans.append((s, s + k * pt))
        off += k
    return row_start, row_len, T, spans


def _levels(T, seed=7, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((T, 3, 32))).astype(np.float32)


def _assert_spans_close(got, want, spans, rtol, atol):
    for s, e in spans:
        np.testing.assert_allclose(
            np.asarray(got, np.float32)[s:e], np.asarray(want, np.float32)[s:e],
            rtol=rtol, atol=atol,
        )


def _tensors(*arrs):
    return [torch.from_numpy(a) for a in arrs]


class TestK4Plain:
    WINDOW = 16  # one full-resolution row: 4 pages of 4

    @pytest.mark.parametrize("attend_self", [False, True])
    def test_matches_pallas_interpret(self, attend_self):
        rs, rl, T, spans = _layout(COUNTS, pages_sig=9)  # one unused trailing page
        lv = _levels(T, seed=9)
        kw = dict(window=self.WINDOW, page_tokens=PT, attend_self=attend_self)
        want = jax_k4(jnp.asarray(lv), row_start=jnp.asarray(rs), row_len=jnp.asarray(rl),
                      interpret=True, **kw)
        t_lv, t_rs, t_rl = _tensors(lv, rs, rl)
        got = tk4.banded_ragged_consensus_plain(t_lv, row_start=t_rs, row_len=t_rl, **kw)
        _assert_spans_close(got, want, spans, K4_INTERPRET_BAR, K4_INTERPRET_BAR)
        assert bool(torch.isfinite(got[spans[-1][1]:]).all())

    @pytest.mark.parametrize("dtype,bar", [(torch.float32, K4_INTERPRET_BAR),
                                           (torch.bfloat16, K4_BF16_VS_JNP)])
    @pytest.mark.parametrize("attend_self", [False, True])
    def test_matches_jnp_banded_route(self, dtype, bar, attend_self):
        rs, rl, T, spans = _layout(COUNTS, pages_sig=10)
        lv = _levels(T, seed=3, scale=2.0)
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        kw = dict(window=self.WINDOW, page_tokens=PT, attend_self=attend_self)
        want = jee.banded_ragged_consensus_attention(
            jnp.asarray(lv, jdt), row_start=jnp.asarray(rs), row_len=jnp.asarray(rl), **kw)
        t_lv, t_rs, t_rl = _tensors(lv, rs, rl)
        got = tk4.banded_ragged_consensus_plain(t_lv.to(dtype), row_start=t_rs, row_len=t_rl,
                                                **kw)
        assert got.dtype == dtype
        _assert_spans_close(got.float(), np.asarray(want, np.float32), spans, bar, bar)

    def test_pad_poisoning_moves_no_valid_token(self):
        rs, rl, T, spans = _layout(COUNTS, pages_sig=10)
        lv = _levels(T)
        valid = np.zeros((T,), bool)
        for c, (s, _) in zip(COUNTS, spans):
            valid[s:s + c] = True
        dirty = lv.copy()
        dirty[~valid] = 1e30  # intra-row pads and the unused trailing pages
        kw = dict(row_start=torch.from_numpy(rs), row_len=torch.from_numpy(rl),
                  window=self.WINDOW, page_tokens=PT)
        clean = tk4.banded_ragged_consensus_plain(torch.from_numpy(lv), **kw)
        poisoned = tk4.banded_ragged_consensus_plain(torch.from_numpy(dirty), **kw)
        assert torch.equal(clean[torch.from_numpy(valid)], poisoned[torch.from_numpy(valid)])

    def test_unused_page_is_the_uniform_band_average(self):
        """row_len 0 masks every slot: each query of the page averages its
        clamped band's values uniformly (finite, outside the contract)."""
        rs, rl, T, spans = _layout([16], pages_sig=6)
        lv = _levels(T)
        got = tk4.banded_ragged_consensus_plain(
            torch.from_numpy(lv), row_start=torch.from_numpy(rs), row_len=torch.from_numpy(rl),
            window=self.WINDOW, page_tokens=PT)
        # Pages 4 and 5 are unused: row_start 0 there, so the band is pages
        # 0..3 (no clamp needed) and every query reads the same 16 tokens.
        want = torch.from_numpy(lv[:16]).mean(dim=0)
        torch.testing.assert_close(got[16:], want.expand(8, 3, 32), rtol=1e-6, atol=1e-6)

    def test_window_past_T_clamps_to_the_last_page(self):
        """T < window (early_exit.py:717 takes min(T, ...)): n_band = T/pt."""
        rs, rl, T, spans = _layout([3, 2])  # 2 pages, T = 8 < 16
        lv = _levels(T, seed=5)
        kw = dict(window=T, page_tokens=PT)
        want = jax_k4(jnp.asarray(lv), row_start=jnp.asarray(rs), row_len=jnp.asarray(rl),
                      interpret=True, **kw)
        got = tk4.banded_ragged_consensus_plain(
            torch.from_numpy(lv), row_start=torch.from_numpy(rs), row_len=torch.from_numpy(rl),
            **kw)
        _assert_spans_close(got, want, spans, K4_INTERPRET_BAR, K4_INTERPRET_BAR)

    def test_wrapper_runs_the_plain_version_on_cpu(self):
        rs, rl, T, _ = _layout(COUNTS)
        lv = torch.from_numpy(_levels(T))
        kw = dict(row_start=torch.from_numpy(rs), row_len=torch.from_numpy(rl),
                  window=self.WINDOW, page_tokens=PT)
        before = tk4.LAUNCHES
        assert torch.equal(tk4.banded_ragged_consensus(lv, **kw),
                           tk4.banded_ragged_consensus_plain(lv, **kw))
        assert tk4.LAUNCHES == before  # counted only where the kernel launches

    def test_kernel_args_refused(self):
        rs, rl, T, _ = _layout([16, 16], pt=64)
        maps = dict(row_start=torch.from_numpy(rs), row_len=torch.from_numpy(rl))
        ok = torch.zeros(T, 2, 128)
        tk4.check_kernel_args(ok, maps["row_start"], maps["row_len"], 128, 64)
        for lv, window, pt, match in (
            (torch.zeros(T, 2, 96), 128, 64, "multiple of 128"),
            (torch.zeros(T, 2, 1152), 128, 64, "at most"),
            (torch.zeros(T, 2, 128, dtype=torch.float16), 128, 64, "dtype"),
            (torch.zeros(T, 128, 2).transpose(1, 2), 128, 64, "contiguous"),
            (ok, 100, 64, "page-aligned"),
            (torch.zeros(96, 2, 128), 96, 48, "multiple of it"),
        ):
            rs_t = torch.zeros(lv.shape[0], dtype=torch.int32)
            with pytest.raises(ValueError, match=match):
                tk4.check_kernel_args(lv, rs_t, rs_t, window, pt)
        with pytest.raises(ValueError, match="row_len"):
            tk4.check_kernel_args(ok, maps["row_start"], maps["row_len"][:-1], 128, 64)

    @pytest.mark.parametrize("dtype,pt,instance", [
        (torch.bfloat16, 64, "wgmma"),  # the flagship's resolved page size
        (torch.bfloat16, 128, "wgmma"),
        (torch.bfloat16, 96, "fma"),  # a multiple of 32, not of 64
        (torch.bfloat16, 32, "fma"),
        (torch.bfloat16, 16, "fma"),
        (torch.float32, 64, "fma"),
        (torch.float32, 16, "fma"),
    ])
    def test_k4_instance(self, dtype, pt, instance):
        assert tk4.k4_instance(dtype, pt, 512) == instance
        assert instance in tk4.K4_INSTANCES

    @pytest.mark.parametrize("dtype,pt", [
        (torch.bfloat16, 64), (torch.bfloat16, 128), (torch.bfloat16, 16), (torch.float32, 64),
    ])
    def test_khat_scratch(self, dtype, pt):
        """The "wgmma" instance's k scratch is [T, L, d] bf16, contiguous;
        "fma" has none."""
        lv = torch.zeros(4 * pt, 3, 128, dtype=dtype)
        khat = tk4.khat_scratch(lv, pt)
        if tk4.k4_instance(dtype, pt, 128) == "fma":
            assert khat is None
        else:
            assert khat.shape == lv.shape and khat.dtype == torch.bfloat16
            assert khat.is_contiguous() and khat.data_ptr() != lv.data_ptr()

    @pytest.mark.parametrize("dtype,pt", [
        (torch.bfloat16, 64),  # "wgmma" reads the levels by TMA
        (torch.bfloat16, 16),  # "fma" in vectors of four elements
        (torch.float32, 64),
    ])
    def test_kernel_args_alignment(self, dtype, pt):
        """Levels that do not start on a 16-byte boundary are refused."""
        T, L, d = 2 * pt, 2, 128
        flat = torch.zeros(T * L * d + 1, dtype=dtype)
        lv = flat[1:].view(T, L, d)
        assert lv.is_contiguous() and lv.data_ptr() % tk4.TMA_ALIGN
        rs = torch.zeros(T, dtype=torch.int32)
        with pytest.raises(ValueError, match="16-byte boundary"):
            tk4.check_kernel_args(lv, rs, rs, pt, pt)
        tk4.check_kernel_args(flat[:-1].view(T, L, d), rs, rs, pt, pt)  # aligned: taken


class TestRaggedAttention:
    def _inputs(self, pages_sig=None):
        rs, rl, T, spans = _layout(COUNTS, pages_sig=pages_sig)
        return _levels(T), rs, rl, spans

    @pytest.mark.parametrize("attend_self", [False, True])
    @pytest.mark.parametrize("mode", ["windowed", "banded"])
    def test_matches_reference(self, mode, attend_self):
        lv, rs, rl, spans = self._inputs(pages_sig=9)
        kw = dict(window=16, attend_self=attend_self)
        if mode == "banded":
            kw["page_tokens"] = PT
        jfn = {"windowed": jee.ragged_consensus_attention,
               "banded": jee.banded_ragged_consensus_attention}[mode]
        tfn = {"windowed": tee.ragged_consensus_attention,
               "banded": tee.banded_ragged_consensus_attention}[mode]
        want = jfn(jnp.asarray(lv), row_start=jnp.asarray(rs), row_len=jnp.asarray(rl), **kw)
        got = tfn(torch.from_numpy(lv), row_start=torch.from_numpy(rs),
                  row_len=torch.from_numpy(rl), **kw)
        _assert_spans_close(got, want, spans, 1e-5, 1e-6)

    def test_windowed_and_banded_agree_within_the_port(self):
        """At f32 the port's two plain gathers agree on every row span to
        f32 rounding, not bit for bit: their score products are matrix
        products of different shapes ([1, d] x [d, W] per token against
        [pt, d] x [d, W] per page), which sum in different orders."""
        lv, rs, rl, spans = self._inputs(pages_sig=9)
        kw = dict(row_start=torch.from_numpy(rs), row_len=torch.from_numpy(rl), window=16)
        win = tee.ragged_consensus_attention(torch.from_numpy(lv), **kw)
        band = tee.banded_ragged_consensus_attention(torch.from_numpy(lv), page_tokens=PT, **kw)
        _assert_spans_close(win, band, spans, 1e-6, 1e-6)

    def test_banded_needs_page_aligned_shapes(self):
        lv, rs, rl, _ = self._inputs()
        with pytest.raises(ValueError, match="page-aligned"):
            tee.banded_ragged_consensus_attention(
                torch.from_numpy(lv), row_start=torch.from_numpy(rs),
                row_len=torch.from_numpy(rl), window=10, page_tokens=PT)


class TestHelpers:
    def test_row_layout_and_structure_exact(self):
        n = np.array([5, 0, 16, 1, 0], np.int32)
        T = 12 * PT
        np.testing.assert_array_equal(
            tee.ragged_row_layout(torch.from_numpy(n), PT).numpy(),
            np.asarray(jee.ragged_row_layout(jnp.asarray(n), PT)))
        for got, want in zip(tee._ragged_structure(torch.from_numpy(n), PT, T),
                             jee._ragged_structure(jnp.asarray(n), PT, T)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_row_agreement(self):
        n = np.array([5, 3, 16, 1], np.int32)
        T = 10 * PT
        lv = _levels(T, seed=2)
        j_row, _, j_valid, _ = jee._ragged_structure(jnp.asarray(n), PT, T)
        weight = (np.asarray(j_row)[:, None] == np.arange(4)[None]) & np.asarray(j_valid)[:, None]
        weight = weight.astype(np.float32)
        want = jee.ragged_row_agreement(jnp.asarray(lv), jnp.asarray(weight), j_row,
                                        jnp.asarray(n))
        got = tee.ragged_row_agreement(torch.from_numpy(lv), torch.from_numpy(weight),
                                       torch.from_numpy(np.array(j_row)).long(),
                                       torch.from_numpy(n))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    def test_window_bytes(self):
        for mode in ("windowed", "banded", "banded-pallas"):
            assert tee.ragged_window_bytes(64, 16, 3, 32, 4, PT, mode) == \
                jee.ragged_window_bytes(64, 16, 3, 32, 4, PT, mode)
        with pytest.raises(ValueError):
            tee.ragged_window_bytes(64, 16, 3, 32, 4, PT, attention="dense")

    def test_page_arithmetic(self):
        for kw, scfg in (
            (TINY, {}), (TINY, {"page_tokens": 8}), ({}, {}), ({}, {"page_tokens": 32}),
            ({"image_size": 28, "patch_size": 4}, {}),
        ):
            jcfg, tcfg = jconfig.GlomConfig(**kw), GlomConfig(**kw)
            js, ts = jconfig.ServeConfig(**scfg), ServeConfig(**scfg)
            assert tpaged.resolve_page_tokens(tcfg, ts) == jpaged.resolve_page_tokens(jcfg, js)
            assert tpaged.page_state_bytes(tcfg, ts) == jpaged.page_state_bytes(jcfg, js)
        with pytest.raises(ValueError, match="does not divide"):
            tpaged.resolve_page_tokens(GlomConfig(**TINY), ServeConfig(page_tokens=3))
        for n in (1, 4, 5, 16, 256):
            assert tpaged.pages_for_tokens(n, PT) == jpaged.pages_for_tokens(n, PT)
        with pytest.raises(ValueError):
            tpaged.pages_for_tokens(0, PT)

    def test_patchify_host_exact(self):
        img = np.random.default_rng(4).standard_normal((3, 16, 8)).astype(np.float32)
        np.testing.assert_array_equal(tbatcher._patchify_host(img, 4),
                                      jbatcher._patchify_host(img, 4))

    def test_pack_ragged_lays_rows_as_the_forward_derives_them(self):
        rng = np.random.default_rng(5)
        imgs = [rng.standard_normal((3, h, w)).astype(np.float32)
                for h, w in ((16, 16), (8, 8), (4, 12), (12, 4))]
        flat, n = tbatcher.pack_ragged(imgs, 4, PT, pages=12)
        np.testing.assert_array_equal(n, [16, 4, 3, 3])
        starts = tee.ragged_row_layout(torch.from_numpy(n), PT).numpy()
        np.testing.assert_array_equal(starts[:-1], tbatcher.ragged_row_starts(n, PT))
        assert flat.shape == (12 * PT, 48)
        for img, c, s in zip(imgs, n, starts):
            np.testing.assert_array_equal(flat[s:s + c], jbatcher._patchify_host(img, 4))
        used = np.zeros(len(flat), bool)
        for c, s in zip(n, starts):
            used[s:s + c] = True
        assert not flat[~used].any()
        with pytest.raises(ValueError, match="pages"):
            tbatcher.pack_ragged(imgs, 4, PT, pages=6)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfig.GlomConfig(**TINY)
    jp = jcore.init_glom(jax.random.PRNGKey(0), jcfg)
    return jcfg, GlomConfig(**TINY), jp, params_from_numpy(flatten(jp), device="cpu")


def _flat_patches(counts, pages_sig, seed=11, scale=1.0):
    rs, rl, T, spans = _layout(counts, pages_sig=pages_sig)
    rng = np.random.default_rng(seed)
    flat = np.zeros((T, 48), np.float32)
    for c, (s, _) in zip(counts, spans):
        flat[s:s + c] = scale * rng.standard_normal((c, 48))
    return flat, spans


MIX = [16, 5, 3, 1]  # pages 4 + 2 + 1 + 1 = 8, dispatched at 10
MIX_N = np.array(MIX + [0, 0], np.int32)  # two unused row slots


def _run_both(model, route, attention="windowed", levels0=None, **kw):
    jcfg, tcfg, jp, tp = model
    flat, spans = _flat_patches(MIX, 10)
    common = dict(page_tokens=PT, route=route, ragged_attention=attention, use_pallas=True, **kw)
    want = jee.glom_forward_ragged(
        jp, jnp.asarray(flat), jcfg, n_patches=jnp.asarray(MIX_N),
        levels0=None if levels0 is None else jnp.asarray(levels0), **common)
    got = tee.glom_forward_ragged(
        tp, torch.from_numpy(flat), tcfg, n_patches=torch.from_numpy(MIX_N),
        levels0=None if levels0 is None else torch.from_numpy(levels0), **common)
    return got, want, spans


class TestGlomForwardRagged:
    @pytest.mark.parametrize("attention", ["windowed", "banded", "banded-pallas"])
    @pytest.mark.parametrize("budget", [1, 3, 6])
    def test_fixed_budgets(self, model, budget, attention):
        got, want, spans = _run_both(model, budget, attention)
        assert got.iters_run == int(want.iters_run) == budget
        np.testing.assert_array_equal(got.row_iters.numpy(), np.asarray(want.row_iters))
        np.testing.assert_array_equal(got.row_converged.numpy(), np.asarray(want.row_converged))
        _assert_spans_close(got.levels, want.levels, spans, RTOL, ATOL)

    # At 2e-2 the rows converge at 7 or 8 (the 1- and 3-patch rows and the
    # unused slots at the min_iters floor of 2): half the rows exit at 7.
    @pytest.mark.parametrize("threshold,quorum", [(0.0, 1.0), (2e-2, 0.5), (2e-2, 1.0)])
    def test_auto_route(self, model, threshold, quorum):
        got, want, spans = _run_both(model, "auto", "banded-pallas", max_iters=8,
                                     threshold=threshold, quorum=quorum, min_iters=2)
        assert got.iters_run == int(want.iters_run)
        np.testing.assert_array_equal(got.row_iters.numpy(), np.asarray(want.row_iters))
        np.testing.assert_array_equal(got.row_converged.numpy(), np.asarray(want.row_converged))
        _assert_spans_close(got.levels, want.levels, spans, RTOL, ATOL)
        if threshold == 0.0:
            assert got.iters_run == 8 and not got.row_converged.any()

    def test_auto_exits_early_at_a_loose_threshold(self, model):
        got, want, _ = _run_both(model, "auto", "banded", max_iters=8, threshold=5e-2,
                                 quorum=0.5)
        assert got.iters_run == int(want.iters_run) < 8

    def test_levels0_continuation(self, model):
        lv0 = np.random.default_rng(8).standard_normal((10 * PT, 3, 32)).astype(np.float32)
        got, want, spans = _run_both(model, 2, "banded-pallas", levels0=lv0)
        _assert_spans_close(got.levels, want.levels, spans, RTOL, ATOL)
        got, want, spans = _run_both(model, "auto", "windowed", levels0=lv0, max_iters=4,
                                     threshold=1e-3)
        assert got.iters_run == int(want.iters_run)
        np.testing.assert_array_equal(got.row_iters.numpy(), np.asarray(want.row_iters))
        _assert_spans_close(got.levels, want.levels, spans, RTOL, ATOL)

    @pytest.mark.parametrize("attention", ["banded", "banded-pallas"])
    def test_threshold0_auto_is_the_fixed_route_bitwise(self, model, attention):
        _, tcfg, _, tp = model
        flat, _ = _flat_patches(MIX, 10)
        kw = dict(n_patches=torch.from_numpy(MIX_N), page_tokens=PT, use_pallas=True,
                  ragged_attention=attention, compute_dtype=torch.bfloat16)
        auto = tee.glom_forward_ragged(tp, torch.from_numpy(flat), tcfg, route="auto",
                                       max_iters=5, threshold=0.0, **kw)
        fixed = tee.glom_forward_ragged(tp, torch.from_numpy(flat), tcfg, route=5, **kw)
        assert auto.iters_run == 5 and torch.equal(auto.levels, fixed.levels)

    def test_pool_and_radius_refused(self, model):
        _, tcfg, _, tp = model
        flat, _ = _flat_patches(MIX, 10)
        kw = dict(n_patches=torch.from_numpy(MIX_N), page_tokens=PT, route=2)
        with pytest.raises(ValueError, match="come together"):
            tee.glom_forward_ragged(tp, torch.from_numpy(flat), tcfg,
                                    page_idx=torch.zeros(10, dtype=torch.int32), **kw)
        with pytest.raises(ValueError, match="levels0 OR pool"):
            tee.glom_forward_ragged(tp, torch.from_numpy(flat), tcfg,
                                    pool=torch.zeros(4, PT, 3, 32),
                                    page_idx=torch.zeros(10, dtype=torch.int32),
                                    levels0=torch.zeros(flat.shape[0], 3, 32), **kw)
        with pytest.raises(ValueError, match="local_consensus_radius"):
            tee.glom_forward_ragged(tp, torch.from_numpy(flat),
                                    GlomConfig(**TINY, local_consensus_radius=1), **kw)
        with pytest.raises(ValueError, match="ragged_attention"):
            tee.glom_forward_ragged(tp, torch.from_numpy(flat), tcfg,
                                    ragged_attention="dense", **kw)


@pytest.fixture(scope="module")
def engines(model):
    jcfg, tcfg, jp, tp = model

    def pair(**over):
        js = jconfig.ServeConfig(**dict(SCFG, **over), dispatch_retries=0)
        ts = ServeConfig(**dict(SCFG, **over), use_pallas=True)
        return (jengine.InferenceEngine(jcfg, js, params=jp),
                InferenceEngine(tcfg, ts, params=tp, device="cpu"))

    return {"fixed": pair(ragged_attention="banded"),
            "auto": pair(iters="auto", max_auto_iters=6, ragged_attention="banded-pallas")}


class TestEngineRagged:
    def test_ladder_and_pick_pages(self, engines):
        ref, port = engines["fixed"]
        assert port.ragged_page_buckets == ref.ragged_page_buckets == (4, 8, 12, 16)
        for n in (1, 4, 5, 9, 16):
            assert port.pick_pages(n) == ref.pick_pages(n)
        for bad in (0, 17):
            with pytest.raises(ValueError):
                port.pick_pages(bad)
        custom = ServeConfig(**dict(SCFG, ragged_pages=(4, 6, 10)))
        assert InferenceEngine(GlomConfig(**TINY), custom, device="cpu").ragged_page_buckets \
            == (4, 6, 10)

    def test_warmup_ragged(self, engines):
        _, port = engines["fixed"]
        first = port.warmup_ragged((4, 8))
        assert set(first) == {4, 8} and all(s > 0 for s in first.values())
        assert port.warmup_ragged((4, 8)) == {4: 0.0, 8: 0.0}

    @pytest.mark.parametrize("route", ["fixed", "auto"])
    def test_cold_dispatch_matches_reference(self, engines, route):
        ref, port = engines[route]
        counts = [16, 4, 5]
        flat, spans = _flat_patches(counts, port.pick_pages(7), seed=12)
        want = ref.infer_ragged(flat, counts)
        got = port.infer_ragged(flat, counts)
        assert got.pages == want.pages == 8 and got.iters_run == want.iters_run
        assert got.levels.shape == (32, 3, 32) and got.levels0_h2d_bytes == 0
        np.testing.assert_array_equal(got.row_iters, want.row_iters)
        np.testing.assert_array_equal(got.row_converged, want.row_converged)
        _assert_spans_close(got.levels, want.levels, spans, RTOL, ATOL)

    def test_continuation_matches_reference(self, engines):
        ref, port = engines["auto"]
        counts = [16, 4]
        flat, spans = _flat_patches(counts, 8, seed=13)
        lv0 = np.random.default_rng(14).standard_normal((32, 3, 32)).astype(np.float32)
        want = ref.infer_ragged(flat, counts, levels0=lv0, auto_budget=3)
        got = port.infer_ragged(flat, counts, levels0=lv0, auto_budget=3)
        assert got.iters_run == want.iters_run <= 3
        assert got.levels0_h2d_bytes == want.levels0_h2d_bytes == lv0.nbytes
        np.testing.assert_array_equal(got.row_iters, want.row_iters)
        _assert_spans_close(got.levels, want.levels, spans, RTOL, ATOL)
        fixed = port.infer_ragged(flat, counts, levels0=lv0, iters_override=2)
        assert fixed.iters_run == 2

    def test_validation_errors(self, engines):
        _, port = engines["fixed"]
        flat, _ = _flat_patches([16], 4)
        for args, kw, match in (
            ((flat[:-1], [16]), {}, "multiple of page_tokens"),
            ((np.zeros((20, 48), np.float32), [16]), {}, "not a ragged signature"),
            ((flat, [1] * 5), {}, "exceed ragged_rows"),
            ((flat, [17]), {}, "0..16"),
            ((flat, [-1]), {}, "0..16"),
            ((flat, [16, 1]), {}, "pages > dispatch size"),
            ((flat, [16]), {"levels0": np.zeros((8, 3, 32), np.float32)}, "levels0 shape"),
            ((flat, [16]), {"iters_override": 0}, "iters_override"),
            ((flat, [16]), {"auto_budget": 0}, "auto_budget"),
            ((flat, [16]), {"auto_budget": 2, "iters_override": 2}, "auto route only"),
        ):
            with pytest.raises(ValueError, match=match):
                port.infer_ragged(*args, **kw)

    def test_pool_refused(self, engines):
        _, port = engines["fixed"]
        flat, _ = _flat_patches([16], 4)
        with pytest.raises(ValueError, match="page pool"):
            port.infer_ragged(flat, [16], page_idx=np.zeros(4, np.int32))
        pooled = InferenceEngine(GlomConfig(**TINY), ServeConfig(**SCFG, page_pool_pages=8),
                                 device="cpu")
        with pytest.raises(ValueError, match="mid-flight"):
            pooled.infer_ragged(flat, [16], page_idx=np.zeros(4, np.int32),
                                levels0=np.zeros((16, 3, 32), np.float32))
        with pytest.raises(ValueError, match=r"page_idx shape"):
            pooled.infer_ragged(flat, [16], page_idx=np.zeros(3, np.int32))
        # Continuation hops are the batcher's: the engine takes the config.
        cont = InferenceEngine(GlomConfig(**TINY),
                               ServeConfig(**dict(SCFG, max_continuations=1, iters="auto")),
                               device="cpu")
        assert cont.scfg.max_continuations == 1

    def test_config_checks(self):
        for bad in (dict(ragged_attention="dense"), dict(ragged_pages=(8, 4)),
                    dict(ragged_pages=(0, 4)), dict(max_continuations=1),
                    dict(max_batch=8), dict(exit_quorum=0.0), dict(min_iters=0),
                    dict(exit_threshold=-1.0), dict(page_tokens=-1)):
            with pytest.raises(ValueError):
                ServeConfig(**dict(SCFG, **bad))
        ServeConfig(**dict(SCFG, max_continuations=1, iters="auto"))
        with pytest.raises(ValueError, match="local_consensus_radius"):
            InferenceEngine(GlomConfig(**TINY, local_consensus_radius=1), ServeConfig(**SCFG),
                            device="cpu")
        with pytest.raises(ValueError, match="below one full-resolution row"):
            InferenceEngine(GlomConfig(**TINY), ServeConfig(**SCFG, ragged_pages=(2,)),
                            device="cpu")

    def test_mixed_resolution_images_end_to_end(self, engines):
        """The recipe a caller runs: pack images of three resolutions, one
        ragged dispatch, each row sliced back at its page-aligned start."""
        ref, port = engines["fixed"]
        rng = np.random.default_rng(15)
        imgs = [rng.standard_normal((3, s, s)).astype(np.float32) for s in (16, 8, 4)]
        flat, n = tbatcher.pack_ragged(imgs, 4, PT, pages=port.pick_pages(6))
        got = port.infer_ragged(flat, n)
        want = ref.infer_ragged(flat, n)
        for c, s in zip(n, tbatcher.ragged_row_starts(n, PT)):
            np.testing.assert_allclose(got.levels[s:s + c].numpy(),
                                       np.asarray(want.levels)[s:s + c], rtol=RTOL, atol=ATOL)


def test_dataclass_replace_keeps_port_checks():
    scfg = ServeConfig(**SCFG)
    with pytest.raises(ValueError):
        dataclasses.replace(scfg, ragged_attention="nope")
