"""glom_tpu_torch ops and helpers against their glom_tpu twins, at f32.

The same numpy inputs (np.random.default_rng) go through both packages;
tolerance rtol 1e-5 / atol 1e-6 (one framework's f32 reduction order
against the other's).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu.ops import consensus as jcons
from glom_tpu.ops import ffw as jffw
from glom_tpu.ops import patch as jpatch
from glom_tpu.utils import config as jconfig
from glom_tpu.utils import helpers as jhelpers
from glom_tpu_torch.ops import consensus as tcons
from glom_tpu_torch.ops import ffw as tffw
from glom_tpu_torch.ops import patch as tpatch
from glom_tpu_torch.utils import config as tconfig
from glom_tpu_torch.utils import helpers as thelpers

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL
    )


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ffw_params(rng, G, d, f):
    arrs = [_normal(rng, G, d, f) * 0.1, _normal(rng, G, f) * 0.1,
            _normal(rng, G, f, d) * 0.05, _normal(rng, G, d) * 0.1]
    return (jffw.GroupedFFWParams(*map(jnp.asarray, arrs)),
            tffw.GroupedFFWParams(*map(torch.from_numpy, arrs)))


class TestHelpersAndConfig:
    def test_constants(self):
        assert thelpers.TOKEN_ATTEND_SELF_VALUE == jhelpers.TOKEN_ATTEND_SELF_VALUE
        assert thelpers.max_neg_value(torch.float32) == float(
            jhelpers.max_neg_value(jnp.float32)
        )

    def test_l2norm(self):
        x = _normal(np.random.default_rng(0), 4, 7, 32)
        x[0, 0] = 0.0  # the eps floor
        _close(thelpers.l2norm(torch.from_numpy(x)), jhelpers.l2norm(jnp.asarray(x)))

    def test_glom_config_matches_reference(self):
        fields = [(f.name, f.default) for f in dataclasses.fields(jconfig.GlomConfig)]
        assert [(f.name, f.default) for f in dataclasses.fields(tconfig.GlomConfig)] == fields
        for kw in ({}, {"dim": 32, "levels": 3, "image_size": 16, "patch_size": 4}):
            j, t = jconfig.GlomConfig(**kw), tconfig.GlomConfig(**kw)
            for prop in ("num_patches_side", "num_patches", "patch_dim", "default_iters"):
                assert getattr(t, prop) == getattr(j, prop)
        with pytest.raises(ValueError):
            tconfig.GlomConfig(image_size=15, patch_size=4)

    def test_serve_config_fields_match_reference(self):
        ref = {f.name: f.default for f in dataclasses.fields(jconfig.ServeConfig)}
        for f in dataclasses.fields(tconfig.ServeConfig):
            assert ref[f.name] == f.default, f.name

    def test_serve_config_host_stack_fields_and_checks(self):
        """The host stack's fields are there, with glom_tpu's defaults, and
        every bad value is refused with glom_tpu's message."""
        names = {f.name for f in dataclasses.fields(tconfig.ServeConfig)}
        assert names >= {
            "max_delay_ms", "queue_depth", "ladder", "degraded_iters", "degraded_max_batch",
            "ladder_high_water", "ladder_low_water", "column_cache_bytes",
            "column_cache_ttl_s", "page_gather", "rejoin_threshold", "rejoin_interval_ms",
            "trace_requests", "slo_classes", "slo_default_class", "slo_shed_order",
            "slo_starvation_floor",
        }
        assert not names & {"min_engines", "max_engines", "husk_max", "warm_pool",
                            "mesh_data", "mesh_seq", "elastic"}
        for bad in (dict(queue_depth=0), dict(max_delay_ms=-1.0), dict(degraded_iters=0),
                    dict(degraded_max_batch=0), dict(ladder_low_water=0.8),
                    dict(ladder_high_water=1.5), dict(column_cache_bytes=-1),
                    dict(column_cache_ttl_s=0.0), dict(page_gather="some"),
                    dict(rejoin_threshold=-1), dict(rejoin_interval_ms=0.0),
                    dict(slo_starvation_floor=1.0), dict(slo_shed_order=("a",)),
                    dict(slo_classes=("a:weight=0",))):
            with pytest.raises(ValueError) as want:
                jconfig.ServeConfig(**bad)
            with pytest.raises(ValueError) as got:
                tconfig.ServeConfig(**bad)
            assert str(got.value) == str(want.value), bad

    def test_train_config_matches_reference(self):
        ref = [(f.name, f.default) for f in dataclasses.fields(jconfig.TrainConfig)]
        assert [(f.name, f.default) for f in dataclasses.fields(tconfig.TrainConfig)] == ref

    def test_mesh_config_matches_reference(self):
        ref = [(f.name, f.default) for f in dataclasses.fields(jconfig.MeshConfig)]
        assert [(f.name, f.default) for f in dataclasses.fields(tconfig.MeshConfig)] == ref
        for kw in ({}, {"data": 8}, {"data": 64, "seq": 2, "model": 2, "num_slices": 4}):
            j, t = jconfig.MeshConfig(**kw), tconfig.MeshConfig(**kw)
            for prop in ("axis_names", "shape", "num_devices"):
                assert getattr(t, prop) == getattr(j, prop)
        with pytest.raises(ValueError):
            tconfig.MeshConfig(data=6, num_slices=4)

    def test_halo_supported(self):
        for seq, side, radius in ((2, 8, 7), (4, 32, 7), (4, 32, 0), (3, 32, 2), (2, 16, 8.5)):
            assert thelpers.halo_supported(seq, side, radius) == jhelpers.halo_supported(
                seq, side, radius)


class TestPatch:
    def test_patchify_unpatchify(self):
        img = _normal(np.random.default_rng(1), 2, 3, 16, 16)
        got = tpatch.patchify(torch.from_numpy(img), 4)
        _close(got, jpatch.patchify(jnp.asarray(img), 4))
        _close(tpatch.unpatchify(got, 4, 16), img)

    def test_tokens_roundtrip(self):
        rng = np.random.default_rng(2)
        img = _normal(rng, 2, 3, 16, 16)
        w, b = _normal(rng, 48, 32) * 0.1, _normal(rng, 32)
        w2, b2 = _normal(rng, 32, 48) * 0.1, _normal(rng, 48)
        tok = tpatch.image_to_tokens(
            tpatch.LinearParams(torch.from_numpy(w), torch.from_numpy(b)),
            torch.from_numpy(img), 4,
        )
        jtok = jpatch.image_to_tokens(
            jpatch.LinearParams(jnp.asarray(w), jnp.asarray(b)), jnp.asarray(img), 4
        )
        _close(tok, jtok)
        back = tpatch.tokens_to_image(
            tpatch.LinearParams(torch.from_numpy(w2), torch.from_numpy(b2)), tok, 4, 16
        )
        jback = jpatch.tokens_to_image(
            jpatch.LinearParams(jnp.asarray(w2), jnp.asarray(b2)), jtok, 4, 16
        )
        _close(back, jback)

    def test_init_linear_family(self):
        p = tpatch.init_linear(48, 32, generator=torch.Generator().manual_seed(0))
        assert p.w.shape == (48, 32) and p.b.shape == (32,)
        assert float(p.w.abs().max()) <= 48 ** -0.5


class TestFFW:
    def test_grouped_ffw(self):
        rng = np.random.default_rng(3)
        jp, tp = _ffw_params(rng, 3, 32, 128)
        x = _normal(rng, 2, 16, 3, 32)
        _close(tffw.grouped_ffw(tp, torch.from_numpy(x)), jffw.grouped_ffw(jp, jnp.asarray(x)))

    def test_grouped_ffw_lm(self):
        rng = np.random.default_rng(4)
        jp, tp = _ffw_params(rng, 3, 32, 128)
        x = _normal(rng, 3, 40, 32)
        _close(
            tffw.grouped_ffw_lm(tp, torch.from_numpy(x)),
            jffw.grouped_ffw_lm(jp, jnp.asarray(x)),
        )

    def test_init_shapes_match_reference(self):
        import jax

        j = jffw.init_grouped_ffw(jax.random.PRNGKey(0), 3, 32, 4)
        t = tffw.init_grouped_ffw(3, 32, 4, generator=torch.Generator().manual_seed(0))
        assert [tuple(a.shape) for a in t] == [tuple(a.shape) for a in j]


class TestConsensus:
    @pytest.mark.parametrize("radius", [0.0, 1.5, 2.0])
    @pytest.mark.parametrize("attend_self", [False, True])
    def test_consensus_attention(self, radius, attend_self):
        side = 4
        x = _normal(np.random.default_rng(5), 2, side * side, 3, 32)
        got = tcons.consensus_attention(
            torch.from_numpy(x), attend_self=attend_self,
            local_mask=tcons.build_local_mask(side, radius),
        )
        want = jcons.consensus_attention(
            jnp.asarray(x), attend_self=attend_self,
            local_mask=jcons.build_local_mask(side, radius),
        )
        _close(got, want)

    def test_side_radius_builds_the_same_mask(self):
        side = 4
        x = torch.from_numpy(_normal(np.random.default_rng(6), 2, side * side, 3, 32))
        got = tcons.consensus_attention(x, side=side, radius=1.5)
        want = tcons.consensus_attention(x, local_mask=tcons.build_local_mask(side, 1.5))
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    @pytest.mark.parametrize("radius", [0, 1, 1.5, 2, 3])
    def test_build_local_mask(self, radius):
        got, want = tcons.build_local_mask(5, radius), jcons.build_local_mask(5, radius)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                tcons.iota_local_mask(25, 5, radius).numpy(),
                np.asarray(jcons.iota_local_mask(25, 5, radius)),
            )
