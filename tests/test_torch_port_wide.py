"""The port at glom_tpu's widest kernel width, d = 1024 (the imagenet224-pod
preset: L = 12, d = 1024, f = 4096).

glom_tpu sizes its kernels for d <= 1024 and puts the pod preset's per-rank
shape on its fused loop. The port's routes and kernels take the same range:
the loop and the route rule choose the loop at the pod shape, every kernel
instance the loop runs there exists (K2's backward "wgmma_wide", K4's
"wgmma_wide"), and past d = 1024 every entry raises. On the CPU the
wrappers run their plain versions, held here against glom_tpu's Pallas
kernels in interpret mode at d = 1024 on a small row (L = 3, B = 1, n = 64),
with the bars the port's other CPU tests hold them to; the kernels
themselves are held against the plain versions on the card
(tests/test_torch_port_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glom_tpu_torch.kernels.banded_consensus as tk4
import glom_tpu_torch.kernels.consensus_update as tk2
import glom_tpu_torch.kernels.grouped_mlp as tk1
from glom_tpu.kernels.banded_consensus import banded_ragged_consensus as jax_k4
from glom_tpu.kernels.consensus_update import fused_consensus_update as jax_k2
from glom_tpu.train import objectives as jobj
from glom_tpu.train import trainer as jtrainer
from glom_tpu.utils import config as jconfig
from glom_tpu.utils import presets as jpresets
from glom_tpu_torch import GlomConfig, TrainConfig, params_from_numpy
from glom_tpu_torch.kernels.fused_loop import loop_supported
from glom_tpu_torch.models import core
from glom_tpu_torch.models.core import param_leaves, resolve_vjp_path
from glom_tpu_torch.ops.ffw import GroupedFFWParams
from glom_tpu_torch.train import create_train_state, make_train_step
from glom_tpu_torch.utils import presets

BF16, F32 = torch.bfloat16, torch.float32
POD = dict(dim=1024, levels=12, image_size=224, patch_size=14)  # n = 256
# (L, B, n, d, f, itemsize, iters, pos_n): the pod preset's batch-8 loop.
POD_LOOP = (12, 8, 256, 1024, 4096, 2, 7, 256)
D, PAST = 1024, 1088  # the widest row, and the next multiple of 64 past it

# Bars: K2's plain forward against the Pallas kernel as
# tests/test_torch_port_kernels.py holds f32 (glom_tpu's kernel bars); the
# VJP as tests/test_torch_port_kernels_bwd.py (tests/test_kernels.py:38-43);
# K4 as tests/test_torch_port_ragged.py (glom_tpu's bar for its kernel
# against its jnp route); the training step as tests/test_torch_port_train.py.
K2_RTOL, K2_ATOL = 2e-4, 2e-5
VJP_RTOL, VJP_ATOL = 2e-3, 1e-5
K4_BAR = 2e-6
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-3, 1e-3, 1e-5


@pytest.fixture
def on_card(monkeypatch):
    """The card's route rule on the CPU (the `_on_card` seam)."""
    monkeypatch.setattr(core, "_on_card", lambda device: True)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if torch.is_tensor(got) else got, np.float32),
        np.asarray(want, np.float32), rtol=rtol, atol=atol)


# -- routes and instances: what ROADMAP C1 recorded as refused ---------------------


def test_the_pod_shape_runs_on_the_loop_and_its_kernels(on_card):
    """The loop takes the pod preset's batch-8 shape, the route rule sends
    it there, and every kernel instance the loop runs at that width
    exists: K2's forward takes the levels, its backward has the
    "wgmma_wide" instance (and "fma" in f32), K1 takes d = 1024."""
    assert loop_supported(*POD_LOOP, remat=True)
    assert resolve_vjp_path(GlomConfig(**POD), 8, 7, remat=True, use_pallas=True,
                            device="cuda") == "fused_loop"
    assert resolve_vjp_path(GlomConfig(**POD), 2, 7, remat=True, use_pallas=True,
                            device="cuda") == "scan_blockwise"
    assert tk2.k2_bwd_instance(BF16, 256, D) == "wgmma_wide"
    assert tk2.k2_bwd_instance(F32, 256, D) == "fma"
    lv = torch.zeros(2, 1, 256, D, dtype=BF16)
    tk2.check_kernel_args(lv, lv.clone(), lv[:1].clone(), torch.empty_like(lv), side=16,
                          radius=0.0)
    params = GroupedFFWParams(torch.zeros(2, D, 4 * D, dtype=BF16),
                              torch.zeros(2, 4 * D, dtype=BF16),
                              torch.zeros(2, 4 * D, D, dtype=BF16), torch.zeros(2, D, dtype=BF16))
    tk1.check_kernel_args(params, torch.zeros(2, 256, D, dtype=BF16), None)


@pytest.mark.parametrize("dtype,n,d,want", [
    (BF16, 256, 1024, "wgmma_wide"),  # the pod preset's per-rank row
    (BF16, 96, 704, "wgmma_wide"),  # an odd width: a last column group of 3 chunks
    (BF16, 32, 768, "wgmma_wide"),
    (BF16, 256, 640, "wgmma"),  # the widest resident-tile row stays as it was
    (F32, 256, 1024, "fma"),
])
def test_k2_bwd_instance_takes_the_wide_rows(dtype, n, d, want):
    assert tk2.k2_bwd_instance(dtype, n, d) == want
    assert want in tk2.K2_BWD_INSTANCES


@pytest.mark.parametrize("dtype,pt,d,want", [
    (BF16, 64, 1024, "wgmma_wide"), (BF16, 64, 768, "wgmma_wide"), (BF16, 64, 512, "wgmma"),
    (F32, 64, 1024, "fma"), (BF16, 16, 1024, "fma"),
])
def test_k4_takes_the_pod_width(dtype, pt, d, want):
    rs = torch.zeros(4 * pt, dtype=torch.int32)
    tk4.check_kernel_args(torch.zeros(4 * pt, 2, d, dtype=dtype), rs, rs.clone(), 2 * pt, pt)
    assert tk4.k4_instance(dtype, pt, d) == want
    assert want in tk4.K4_INSTANCES


def test_k4_f32_past_512_takes_16_row_pages_only():
    """Past d = 512 "fma" blocks own 16 query rows: a page of 24 tokens
    would put two pages in one block, and is refused; 16 and 48 are taken."""
    for pt, ok in ((16, True), (48, True), (24, False)):
        rs = torch.zeros(4 * pt, dtype=torch.int32)
        args = (torch.zeros(4 * pt, 2, D), rs, rs.clone(), 2 * pt, pt)
        if ok:
            tk4.check_kernel_args(*args)
        else:
            with pytest.raises(ValueError, match="multiple of it"):
                tk4.check_kernel_args(*args)


def _past_1024_calls():
    lv = torch.zeros(2, 1, 64, PAST, dtype=BF16)
    m = torch.zeros(2, 1, 64, 1)
    rs = torch.zeros(256, dtype=torch.int32)
    params = GroupedFFWParams(torch.zeros(2, PAST, 128), torch.zeros(2, 128),
                              torch.zeros(2, 128, PAST), torch.zeros(2, PAST))
    return {
        "loop_supported": lambda: loop_supported(12, 8, 256, PAST, 4 * PAST, 2, 7, 256,
                                                 remat=True),
        "resolve_vjp_path": lambda: resolve_vjp_path(
            GlomConfig(**dict(POD, dim=PAST)), 2, 7, use_pallas=True, device="cuda"),
        "k2_bwd_instance_bf16": lambda: tk2.k2_bwd_instance(BF16, 256, PAST),
        "k2_bwd_instance_f32": lambda: tk2.k2_bwd_instance(F32, 256, PAST),
        "k2_check_kernel_args": lambda: tk2.check_kernel_args(
            lv, lv.clone(), lv[:1].clone(), torch.empty_like(lv), side=8, radius=0.0),
        "k2_bwd_args": lambda: tk2._check_bwd_args(lv, lv.clone(), m, m.clone(), 8, 0.0),
        "k4_instance": lambda: tk4.k4_instance(BF16, 64, 1152),
        "k4_check_kernel_args": lambda: tk4.check_kernel_args(
            torch.zeros(256, 2, 1152, dtype=BF16), rs, rs.clone(), 128, 64),
        "k1_check_kernel_args": lambda: tk1.check_kernel_args(
            params, torch.zeros(2, 64, PAST), None),
    }


PAST_1024_ENTRIES = ["k1_check_kernel_args", "k2_bwd_args", "k2_bwd_instance_bf16",
                     "k2_bwd_instance_f32", "k2_check_kernel_args", "k4_check_kernel_args",
                     "k4_instance", "loop_supported", "resolve_vjp_path"]


@pytest.mark.parametrize("entry", PAST_1024_ENTRIES)
def test_every_entry_raises_past_1024(on_card, entry):
    """Past the kernels' widest row no route runs: each entry raises a
    ValueError that names the limit (nothing falls back to a plain op)."""
    with pytest.raises(ValueError, match="1024"):
        _past_1024_calls()[entry]()


def test_pod_preset_matches_glom_tpu():
    """The port's imagenet224-pod preset is glom_tpu's, field by field, at
    the width both packages' kernels take."""
    ours, ref = presets.get_preset("imagenet224-pod"), jpresets.get_preset("imagenet224-pod")
    for part in ("model", "train", "mesh"):
        mine, theirs = dataclasses.asdict(getattr(ours, part)), dataclasses.asdict(
            getattr(ref, part))
        assert mine.keys() == theirs.keys(), part
        for key in theirs:
            assert mine[key] == theirs[key], (part, key)
    assert (ours.model.dim, ours.model.levels, ours.model.num_patches) == (D, 12, 256)
    assert ours.train.compute_dtype == "bfloat16" and ours.train.use_pallas and ours.train.remat
    assert ours.model.dim <= tk2.MAX_D == tk4.MAX_DIM == tk1.MAX_D


# -- parity with glom_tpu at d = 1024 on a small row -------------------------------


def _k2_inputs(seed, L=3, B=1, side=8, d=D):
    rng = np.random.default_rng(seed)
    n = side * side
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s, scale in (
        ((L, B, n, d), 2.0), ((L, B, n, d), 1.0), ((L - 1, B, n, d), 1.0), ((L, B, n, d), 1.0),
    )]


@pytest.mark.parametrize("radius,attend_self", [(0.0, False), (2.0, True)])
def test_k2_plain_matches_pallas_interpret(radius, attend_self):
    lv, bu, td, _ = _k2_inputs(0)
    kw = dict(side=8, radius=radius, attend_self=attend_self)
    want = jax_k2(*map(jnp.asarray, (lv, bu, td)), interpret=True, bwd_impl="blockwise", **kw)
    got = tk2.fused_consensus_update(*map(torch.from_numpy, (lv, bu, td)), **kw)
    _close(got, want, K2_RTOL, K2_ATOL)


@pytest.mark.parametrize("radius,attend_self", [(0.0, False), (2.0, True)])
def test_k2_vjp_matches_pallas_vjp(radius, attend_self):
    lv, bu, td, g = _k2_inputs(1)
    kw = dict(side=8, radius=radius, attend_self=attend_self)

    def f(lv_, bu_, td_):
        out = jax_k2(lv_, bu_, td_, interpret=True, bwd_impl="blockwise", **kw)
        return jnp.sum(out * g)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (lv, bu, td)))
    ts = [torch.from_numpy(t).requires_grad_() for t in (lv, bu, td)]
    tk2.consensus_update_vjp(*ts, **kw).backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        _close(t.grad, w, VJP_RTOL, VJP_ATOL)


@pytest.mark.parametrize("attend_self", [False, True])
def test_k4_plain_matches_pallas_interpret(attend_self):
    """Rows of 64, 37, 1 and 16 patches on pages of 16 (intra-row pads, an
    unused trailing page), one full row's window, 3 levels at d = 1024."""
    pt, counts, window = 16, [64, 37, 1, 16], 64
    pages = [-(-c // pt) for c in counts]
    T = (sum(pages) + 1) * pt
    rs, rl = np.zeros(T, np.int32), np.zeros(T, np.int32)
    spans, off = [], 0
    for c, k in zip(counts, pages):
        rs[off * pt:(off + k) * pt], rl[off * pt:(off + k) * pt] = off * pt, c
        spans.append((off * pt, (off + k) * pt))
        off += k
    rs[off * pt:] = off * pt
    lv = np.random.default_rng(2).standard_normal((T, 3, D)).astype(np.float32)
    kw = dict(window=window, page_tokens=pt, attend_self=attend_self)
    want = np.asarray(jax_k4(jnp.asarray(lv), row_start=jnp.asarray(rs),
                             row_len=jnp.asarray(rl), interpret=True, **kw))
    got = tk4.banded_ragged_consensus(torch.from_numpy(lv), row_start=torch.from_numpy(rs),
                                      row_len=torch.from_numpy(rl), **kw)
    for s, e in spans:
        _close(got[s:e], want[s:e], K4_BAR, K4_BAR)
    assert bool(torch.isfinite(got[spans[-1][1]:]).all())


def test_per_iteration_train_step_matches_glom_tpu(on_card):
    """One step of Glom(dim=1024, levels=3) on the per-iteration route (the
    card's rule: batch 1 < 8), through the K1 and K2 autograd Functions'
    plain versions, against glom_tpu's train step on the same weights
    (noise_std 0, so no draw differs)."""
    kw = dict(dim=D, levels=3, image_size=32, patch_size=4)  # n = 64
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
    tkw = dict(batch_size=1, learning_rate=3e-4, noise_std=0.0, iters=4)
    img = np.random.default_rng(5).standard_normal((1, 3, 32, 32)).astype(np.float32)

    jt = jconfig.TrainConfig(**tkw)
    jstate, jopt = jtrainer.create_train_state(jax.random.PRNGKey(0), jcfg, jt)
    jstate = jstate._replace(params=jp, opt_state=jopt.init(jp))
    jstate, jm = jax.jit(jtrainer.make_train_step(jcfg, jt, jopt))(
        jstate, jnp.asarray(img), jax.random.PRNGKey(1))

    tcfg = TrainConfig(use_pallas=True, **tkw)
    step = make_train_step(cfg, tcfg, device="cpu")
    assert step.vjp_path == "scan_blockwise"
    state, _ = create_train_state(cfg, tcfg, params=params_from_numpy(flat), device="cpu")
    state, m = step(state, torch.from_numpy(img), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    for got, want in zip(param_leaves(state.params), jax.tree_util.tree_leaves(jstate.params)):
        _close(got, want, PARAM_RTOL, PARAM_ATOL)
