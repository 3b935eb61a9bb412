"""The port's GLOM forward and `Glom` against glom_tpu's, at f32.

Weights come from glom_tpu's `init_glom` and are carried across with
`params_from_numpy`; images and carried-in levels come from
np.random.default_rng. Tolerance rtol 2e-3 / atol 2e-4, the bar
tests/test_model.py:43 holds glom_tpu's own routes to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu.models import api as japi
from glom_tpu.models import core as jcore
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import Glom, GlomConfig, glom_forward, params_from_numpy
from glom_tpu_torch.models import core as tcore
from glom_tpu_torch.models.transplant import PARAM_KEYS

RTOL, ATOL = 2e-3, 2e-4
TINY = {"dim": 32, "levels": 3, "image_size": 16, "patch_size": 4}
CONFIGS = {
    "global": {},
    "self": {"consensus_self": True},
    "local": {"local_consensus_radius": 1},
}


def flatten(params) -> dict:
    """glom_tpu GlomParams -> {dotted path: numpy array}."""
    out = {}
    for name in params._fields:
        v = getattr(params, name)
        if hasattr(v, "_fields"):
            for sub in v._fields:
                out[f"{name}.{sub}"] = np.asarray(getattr(v, sub))
        else:
            out[name] = np.asarray(v)
    return out


def setup(extra=None, seed=0, batch=2):
    kw = dict(TINY, **(extra or {}))
    jcfg, tcfg = jconfig.GlomConfig(**kw), GlomConfig(**kw)
    jp = jcore.init_glom(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(flatten(jp), device="cpu")
    img = np.random.default_rng(seed).standard_normal((batch, 3, 16, 16)).astype(np.float32)
    return jcfg, tcfg, jp, tp, img


def close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_default_iters(name, use_pallas):
    jcfg, tcfg, jp, tp, img = setup(CONFIGS[name])
    want = jcore.glom_forward(jp, jnp.asarray(img), jcfg, use_pallas=use_pallas)
    got = glom_forward(tp, torch.from_numpy(img), tcfg, use_pallas=use_pallas)
    assert got.shape == (2, 16, 3, 32)
    close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_explicit_iters(use_pallas):
    jcfg, tcfg, jp, tp, img = setup()
    want = jcore.glom_forward(jp, jnp.asarray(img), jcfg, iters=3, use_pallas=use_pallas)
    got = glom_forward(tp, torch.from_numpy(img), tcfg, iters=3, use_pallas=use_pallas)
    close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_return_all(use_pallas):
    jcfg, tcfg, jp, tp, img = setup({"local_consensus_radius": 1})
    want = jcore.glom_forward(
        jp, jnp.asarray(img), jcfg, iters=4, return_all=True, use_pallas=use_pallas
    )
    got = glom_forward(
        tp, torch.from_numpy(img), tcfg, iters=4, return_all=True, use_pallas=use_pallas
    )
    assert got.shape == (5, 2, 16, 3, 32)
    close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_levels_carry_in(use_pallas):
    jcfg, tcfg, jp, tp, img = setup({"consensus_self": True})
    lv = np.random.default_rng(7).standard_normal((2, 16, 3, 32)).astype(np.float32)
    want = jcore.glom_forward(
        jp, jnp.asarray(img), jcfg, iters=2, levels=jnp.asarray(lv), use_pallas=use_pallas
    )
    got = glom_forward(
        tp, torch.from_numpy(img), tcfg, iters=2, levels=torch.from_numpy(lv),
        use_pallas=use_pallas,
    )
    close(got, want)


def test_fused_route_matches_reference_route():
    _, tcfg, _, tp, img = setup({"local_consensus_radius": 1})
    x = torch.from_numpy(img)
    close(glom_forward(tp, x, tcfg, use_pallas=True), glom_forward(tp, x, tcfg))


def test_bf16_fused_route_stays_near_f32():
    _, tcfg, _, tp, img = setup()
    x = torch.from_numpy(img)
    got = glom_forward(tp, x, tcfg, use_pallas=True, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    want = glom_forward(tp, x, tcfg)
    assert float((got.float() - want).abs().max()) < 0.1


@pytest.mark.parametrize("use_pallas", [False, True])
def test_glom_module_matches_reference(use_pallas):
    jcfg, tcfg, jp, tp, img = setup()
    jm = japi.Glom(**TINY, params=jp, use_pallas=use_pallas)
    tm = Glom(**TINY, params=tp, use_pallas=use_pallas, device="cpu")
    close(tm(torch.from_numpy(img)), jm(jnp.asarray(img)))
    close(tm(img, iters=2, return_all=True), jm(jnp.asarray(img), iters=2, return_all=True))


def test_glom_unported_routes_raise():
    """iters="auto" is ported (test_torch_port_serve_engine); with
    return_all it is refused, as glom_tpu refuses it. Meshes are ported
    (test_torch_port_serve_mesh); one without the 'data' and 'seq' axes
    raises, where glom_tpu falls back to its GSPMD forward."""
    m = Glom(**TINY, device="cpu")
    with pytest.raises(ValueError, match="return_all"):
        m(torch.zeros(1, 3, 16, 16), iters="auto", return_all=True)
    with pytest.raises(ValueError, match="'data' and 'seq'"):
        Glom(**TINY, device="cpu", mesh=object())


def test_pallas_with_a_custom_consensus_fn_matches_glom_tpu():
    """glom_forward(use_pallas=True, consensus_fn=...): the reference layout
    with K1 (its plain version on the CPU) for the FFWs, as glom_tpu runs a
    sharded rank's body; against glom_tpu's at the f32 bar, its gradient
    through K1's autograd Function against the plain route's."""
    from functools import partial

    from glom_tpu.ops.consensus import consensus_attention as j_consensus
    from glom_tpu_torch.ops.consensus import consensus_attention

    jcfg, tcfg, jp, tp, img = setup()
    jout = jcore.glom_forward(jp, jnp.asarray(img), jcfg, iters=2, use_pallas=True,
                              consensus_fn=partial(j_consensus, attend_self=False))
    fn = partial(consensus_attention, attend_self=False)
    x = torch.from_numpy(img)
    out = tcore.glom_forward(tp, x, tcfg, iters=2, use_pallas=True, consensus_fn=fn)
    close(out, jout)
    leaves = [t.clone().requires_grad_() for t in tcore.param_leaves(tp)]
    grads = {}
    for pallas in (True, False):
        p = tcore.unflatten_params(tp, leaves)
        y = tcore.glom_forward(p, x, tcfg, iters=2, use_pallas=pallas, consensus_fn=fn)
        grads[pallas] = torch.autograd.grad(y.square().sum(), leaves)
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4)


def test_init_glom_shapes_and_determinism():
    jcfg, tcfg, jp, _, _ = setup()
    a = tcore.init_glom(tcfg, generator=torch.Generator().manual_seed(3))
    b = tcore.init_glom(tcfg, generator=torch.Generator().manual_seed(3))
    flat_a, flat_b, flat_j = (
        dict(zip(PARAM_KEYS, tensors)) for tensors in (
            [*a.token_embed, a.pos_emb, a.init_levels, *a.bottom_up, *a.top_down],
            [*b.token_embed, b.pos_emb, b.init_levels, *b.bottom_up, *b.top_down],
            [flatten(jp)[k] for k in PARAM_KEYS],
        )
    )
    for k in PARAM_KEYS:
        assert tuple(flat_a[k].shape) == tuple(flat_j[k].shape), k
        torch.testing.assert_close(flat_a[k], flat_b[k], rtol=0, atol=0)


def test_contribution_divisor():
    np.testing.assert_array_equal(
        tcore.contribution_divisor(5).numpy(), np.asarray(jcore.contribution_divisor(5))
    )


def test_params_from_numpy_checks_keys():
    arrays = flatten(setup()[2])
    del arrays["pos_emb"]
    with pytest.raises(KeyError, match="pos_emb"):
        params_from_numpy(arrays)
