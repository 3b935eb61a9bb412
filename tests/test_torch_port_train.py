"""The port's single-device trainer against glom_tpu's, at f32 on the CPU.

glom_tpu's parameters are carried across with `params_from_numpy`; images
and noise come from np.random.default_rng, so both packages see the same
data. Losses are held at rtol 5e-4 over Adam steps and gradients at rtol
2e-3 / atol 1e-5, as tests/test_torch_parity.py:70-102 and
tests/test_kernels.py:38-43 hold glom_tpu. On the CPU the port's fused
route runs the kernels' plain versions through the same autograd
Functions the card runs; tests/test_torch_port_gpu.py and chip_smoke.py
train on the card.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glom_tpu.data import synthetic as jsynthetic
from glom_tpu.train import objectives as jobj
from glom_tpu.train import trainer as jtrainer
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import GlomConfig, TrainConfig, Trainer, params_from_numpy
from glom_tpu_torch.data import gaussian_dataset, prefetch_to_device, shapes_dataset
from glom_tpu_torch.models.core import param_leaves, resolve_vjp_path, unflatten_params
from glom_tpu_torch.train import (
    DenoiseParams,
    accumulate_grads,
    create_train_state,
    denoise_loss,
    fit_loop,
    init_denoise,
    make_lr_schedule,
    make_train_step,
    reconstruct,
    resolve_training_route,
)

TINY = {"dim": 16, "levels": 3, "image_size": 8, "patch_size": 4}  # n = 4 patches
LOSS_RTOL = 5e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5


def flatten(params) -> dict:
    """glom_tpu DenoiseParams -> {dotted path: numpy array}, with the GLOM
    leaves at the top level as params_from_numpy takes them."""
    out = {}
    for name in params.glom._fields:
        v = getattr(params.glom, name)
        for sub in getattr(v, "_fields", ()):
            out[f"{name}.{sub}"] = np.asarray(getattr(v, sub))
        if not hasattr(v, "_fields"):
            out[name] = np.asarray(v)
    out["to_pixels.w"] = np.asarray(params.to_pixels.w)
    out["to_pixels.b"] = np.asarray(params.to_pixels.b)
    return out


def setup(extra=None, seed=0, batch=2):
    kw = dict(TINY, **(extra or {}))
    jcfg, cfg = jconfig.GlomConfig(**kw), GlomConfig(**kw)
    jp = jobj.init_denoise(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 100)
    shape = (batch, 3, cfg.image_size, cfg.image_size)
    img, noise = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return jcfg, cfg, jp, params_from_numpy(flatten(jp)), img, noise


def leaves_requiring_grad(params):
    leaves = [t.clone().requires_grad_() for t in param_leaves(params)]
    return unflatten_params(params, leaves), leaves


def jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if torch.is_tensor(got) else got, np.float32),
        np.asarray(want, np.float32), rtol=rtol, atol=atol,
    )


class TestDenoiseLoss:
    @pytest.mark.parametrize("extra", [{}, {"local_consensus_radius": 1}, {"consensus_self": True}],
                             ids=["global", "local", "self"])
    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_value_and_grads_match_reference(self, extra, use_pallas):
        jcfg, cfg, jp, tp, img, noise = setup(extra)
        jloss, jgrads = jax.value_and_grad(jobj.denoise_loss)(
            jp, jnp.asarray(img), jnp.asarray(noise), jcfg)
        pp, leaves = leaves_requiring_grad(tp)
        loss = denoise_loss(pp, torch.from_numpy(img), torch.from_numpy(noise), cfg,
                            use_pallas=use_pallas)
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
        # jax flattens (glom, to_pixels) in field order, as param_leaves does
        for got, want in zip(grads, jax_leaves(jgrads)):
            close(got, want)

    def test_fused_route_and_remat_give_the_reference_route_grads(self):
        _, cfg, _, tp, img, noise = setup({"local_consensus_radius": 1})
        results = []
        for use_pallas, remat in ((False, False), (False, True), (True, False), (True, True)):
            pp, leaves = leaves_requiring_grad(tp)
            loss = denoise_loss(pp, torch.from_numpy(img), torch.from_numpy(noise), cfg,
                                use_pallas=use_pallas, remat=remat)
            results.append((loss, torch.autograd.grad(loss, leaves)))
        for loss, grads in results[1:]:
            torch.testing.assert_close(loss, results[0][0])
            for got, want in zip(grads, results[0][1]):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
        assert all(float(g.abs().max()) > 0 for g in results[2][1])  # every leaf moves

    def test_recon_index_and_reconstruct(self):
        jcfg, cfg, jp, tp, img, _ = setup()
        with pytest.raises(ValueError, match="recon_index"):
            denoise_loss(tp, torch.from_numpy(img), torch.zeros(1), cfg, recon_index=0)
        want = jobj.reconstruct(jp, jnp.asarray(img), jcfg)
        with torch.no_grad():
            got = reconstruct(tp, torch.from_numpy(img), cfg)
        close(got, want, rtol=2e-3, atol=2e-4)

    def test_params_from_numpy_builds_denoise_params(self):
        _, cfg, jp, tp, _, _ = setup()
        assert isinstance(tp, DenoiseParams)
        arrays = flatten(jp)
        for key in ("to_pixels.w", "to_pixels.b"):
            arrays.pop(key)
        assert not isinstance(params_from_numpy(arrays), DenoiseParams)
        arrays["to_pixels.w"] = np.zeros((cfg.dim, cfg.patch_dim), np.float32)
        with pytest.raises(KeyError, match="to_pixels.b"):
            params_from_numpy(arrays)

    def test_init_denoise_shapes(self):
        cfg = GlomConfig(**TINY)
        p = init_denoise(cfg, generator=torch.Generator().manual_seed(0))
        assert p.to_pixels.w.shape == (cfg.dim, cfg.patch_dim)
        assert p.to_pixels.b.shape == (cfg.patch_dim,)


class TestAdamParity:
    def test_five_adam_steps_match_reference(self):
        """Five Adam steps on identical weights, images and noise: the port's
        objective and default optimizer against glom_tpu's and optax.adam."""
        steps, lr = 5, 1e-3
        jcfg, cfg, jp, tp, _, _ = setup()
        rng = np.random.default_rng(7)
        shape = (2, 3, cfg.image_size, cfg.image_size)
        data = [(rng.standard_normal(shape).astype(np.float32),
                 rng.standard_normal(shape).astype(np.float32)) for _ in range(steps)]

        opt = optax.adam(lr)
        opt_state = opt.init(jp)

        @jax.jit
        def jstep(params, opt_state, img, noise):
            loss, grads = jax.value_and_grad(jobj.denoise_loss)(params, img, noise, jcfg)
            updates, opt_state = opt.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        jlosses = []
        for img, noise in data:
            jp, opt_state, loss = jstep(jp, opt_state, jnp.asarray(img), jnp.asarray(noise))
            jlosses.append(float(loss))

        tcfg = TrainConfig(learning_rate=lr, batch_size=2, use_pallas=True)
        state, _ = create_train_state(cfg, tcfg, params=tp, device="cpu")
        losses = []
        for img, noise in data:
            loss, grads = accumulate_grads(
                lambda p, i, n: denoise_loss(p, i, n, cfg, use_pallas=True),
                state.params, torch.from_numpy(img), torch.from_numpy(noise), 1)
            for p, g in zip(param_leaves(state.params), grads):
                p.grad = g
            state.optimizer.step()
            losses.append(float(loss))
        np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
        for got, want in zip(param_leaves(state.params), jax_leaves(jp)):
            close(got, want, rtol=1e-3, atol=1e-5)

    @pytest.mark.parametrize("weight_decay,schedule", [(0.0, "constant"), (0.05, "warmup_cosine")])
    def test_train_step_matches_reference(self, weight_decay, schedule):
        """The whole step (optimizer, schedule, telemetry scalars) against
        glom_tpu's make_train_step, with noise_std 0 so no random draw
        differs between the two."""
        jcfg, cfg, jp, tp, _, _ = setup()
        kw = dict(batch_size=2, learning_rate=3e-3, weight_decay=weight_decay,
                  lr_schedule=schedule, warmup_steps=1, schedule_steps=4, noise_std=0.0,
                  telemetry_level="scalars")
        jt = jconfig.TrainConfig(**kw)
        jstate, jopt = jtrainer.create_train_state(jax.random.PRNGKey(0), jcfg, jt)
        jstate = jstate._replace(params=jp, opt_state=jopt.init(jp))
        jstep = jax.jit(jtrainer.make_train_step(jcfg, jt, jopt))

        tcfg = TrainConfig(**kw)
        state, _ = create_train_state(cfg, tcfg, params=tp, device="cpu")
        step = make_train_step(cfg, tcfg, device="cpu")
        gen = torch.Generator().manual_seed(0)
        rng = np.random.default_rng(3)
        for _ in range(3):
            img = rng.standard_normal((2, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
            jstate, jm = jstep(jstate, jnp.asarray(img), jax.random.PRNGKey(1))
            state, m = step(state, torch.from_numpy(img), gen)
            for key in ("loss", "grad_norm", "update_norm", "param_norm"):
                np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-3, err_msg=key)
            assert int(m["nonfinite_step"]) == int(jm["nonfinite_step"]) == 0
        assert state.step == int(jstate.step) == 3
        for got, want in zip(param_leaves(state.params), jax_leaves(jstate.params)):
            close(got, want, rtol=1e-3, atol=1e-5)


class TestTrainerPieces:
    def test_accumulate_grads_equals_full_batch(self):
        _, cfg, _, tp, _, _ = setup(batch=4)
        rng = np.random.default_rng(5)
        img, noise = (torch.from_numpy(rng.standard_normal((4, 3, 8, 8)).astype(np.float32))
                      for _ in range(2))

        def loss_fn(p, i, n):
            return denoise_loss(p, i, n, cfg, use_pallas=True)

        pp, _ = leaves_requiring_grad(tp)
        full_loss, full = accumulate_grads(loss_fn, pp, img, noise, 1)
        loss2, accum2 = accumulate_grads(loss_fn, pp, img, noise, 2)
        torch.testing.assert_close(loss2, full_loss, rtol=1e-6, atol=1e-7)
        for got, want in zip(accum2, full):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)

    @pytest.mark.parametrize("kw", [
        {"lr_schedule": "constant"},
        {"lr_schedule": "cosine", "schedule_steps": 10, "lr_final_fraction": 0.1},
        {"lr_schedule": "warmup_cosine", "warmup_steps": 3, "schedule_steps": 10,
         "lr_final_fraction": 0.05},
    ], ids=lambda kw: kw["lr_schedule"])
    def test_lr_schedule_matches_optax(self, kw):
        kw = dict(kw, learning_rate=2e-3)
        want = jtrainer.make_lr_schedule(jconfig.TrainConfig(**kw))
        got = make_lr_schedule(TrainConfig(**kw))
        for count in (0, 1, 2, 3, 5, 9, 10, 14):
            w = want(count) if callable(want) else want
            g = got(count) if callable(got) else got
            np.testing.assert_allclose(g, float(w), rtol=1e-6, err_msg=str(count))

    def test_lr_schedule_rejects(self):
        with pytest.raises(ValueError, match="schedule_steps"):
            make_lr_schedule(TrainConfig(lr_schedule="warmup_cosine", warmup_steps=5,
                                         schedule_steps=5))
        with pytest.raises(ValueError, match="lr_schedule"):
            make_lr_schedule(TrainConfig(lr_schedule="linear"))

    @pytest.mark.parametrize("policy", ["skip", "warn"])
    def test_nonfinite_guard(self, policy):
        _, cfg, _, tp, _, _ = setup()
        tcfg = TrainConfig(batch_size=2, learning_rate=1e-2, telemetry_level="scalars",
                           nonfinite_policy=policy, use_pallas=True)
        state, _ = create_train_state(cfg, tcfg, params=tp, device="cpu")
        step = make_train_step(cfg, tcfg, device="cpu")
        gen = torch.Generator().manual_seed(0)
        img = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, 3, 8, 8)).astype(np.float32))
        state, m = step(state, img, gen)  # a healthy step first: Adam state exists
        assert int(m["nonfinite_step"]) == 0
        before = [t.detach().clone() for t in param_leaves(state.params)]
        opt_before = {k: v.clone() for p in param_leaves(state.params)
                      for k, v in state.optimizer.state[p].items()}
        bad = img.clone()
        bad[0, 0, 0, 0] = float("nan")
        state, m = step(state, bad, gen)
        assert int(m["nonfinite_step"]) == 1 and state.step == 2
        after = param_leaves(state.params)
        if policy == "skip":
            assert int(m["skipped_nonfinite"]) == 1
            for a, b in zip(after, before):
                assert torch.equal(a, b)
            opt_after = {k: v for p in after for k, v in state.optimizer.state[p].items()}
            assert all(torch.equal(opt_after[k], v) for k, v in opt_before.items())
            state, m = step(state, img, gen)  # and training goes on
            assert int(m["nonfinite_step"]) == 0 and torch.isfinite(m["loss"])
        else:
            assert "skipped_nonfinite" not in m
            assert not all(bool(torch.isfinite(a).all()) for a in after)

    def test_nonfinite_guard_on_the_first_step(self):
        _, cfg, _, tp, _, _ = setup()
        tcfg = TrainConfig(batch_size=2, telemetry_level="scalars")
        state, _ = create_train_state(cfg, tcfg, params=tp, device="cpu")
        before = [t.detach().clone() for t in param_leaves(state.params)]
        img = torch.full((2, 3, 8, 8), float("nan"))
        state, m = make_train_step(cfg, tcfg, device="cpu")(state, img, torch.Generator())
        assert int(m["skipped_nonfinite"]) == 1
        for a, b in zip(param_leaves(state.params), before):
            assert torch.equal(a, b)
        assert all(float(v.abs().max()) == 0 for s in state.optimizer.state.values()
                   for v in s.values())  # Adam's fresh state

    def test_routes(self):
        cfg = GlomConfig()  # the flagship; k = 7 loss iterations
        assert resolve_vjp_path(cfg, 4, 7, use_pallas=True, device="cuda") == "scan_blockwise"
        assert resolve_vjp_path(cfg, 4, 7, use_pallas=True, device="cuda:0") == "scan_blockwise"
        assert resolve_vjp_path(cfg, 8, 7, use_pallas=True, device="cpu") == "scan_dense"
        assert resolve_vjp_path(cfg, 8, 7, use_pallas=False, device="cuda") == "scan_dense"
        assert resolve_vjp_path(cfg, 8, 7, use_pallas=True, custom_consensus=True,
                                device="cuda") == "scan_dense"
        # Batch 64 reaches the whole-loop VJP, as glom_tpu's does.
        tcfg = TrainConfig(batch_size=64, use_pallas=True, compute_dtype="bfloat16")
        assert resolve_training_route(cfg, tcfg, device="cuda") == (1, "fused_loop")
        tcfg = dataclasses.replace(tcfg, grad_accum=4)
        assert resolve_training_route(cfg, tcfg, device="cuda") == (4, "fused_loop")
        with pytest.raises(ValueError, match="grad_accum"):
            resolve_training_route(cfg, dataclasses.replace(tcfg, grad_accum=0))

    @pytest.mark.parametrize("kw", [
        {"zero_stage": 1}, {"quantized_reduce": True}, {"telemetry_level": "full"},
        {"collective_timing": "sampled"},
    ], ids=lambda kw: next(iter(kw)))
    def test_unported_options_raise(self, kw):
        """Every one of these options is ported, and on one device the step
        runs it as glom_tpu's Trainer does: ZeRO and the quantized reduce
        (parallel/manual.py) as stage 0 without the hop, the collective
        timing ignored (one device has no collective), telemetry "full" as
        the "scalars" update with the per-level agreement beside it. Each
        gives the same update as the step without it, bit for bit."""
        name = next(iter(kw))
        cfg = GlomConfig(**TINY)
        if name in ("zero_stage", "quantized_reduce"):
            jt = jconfig.TrainConfig(batch_size=2, **kw)
            assert (jtrainer.resolve_zero_stage(jt, 1), jtrainer.resolve_quantized_reduce(jt, 1)
                    ) == (0, False)
        base = {"telemetry_level": "scalars"} if name == "telemetry_level" else {}
        _, _, _, tp, img, _ = setup()
        results = []
        for tk in (dict(batch_size=2, **kw), dict(batch_size=2, **base)):
            state, _ = create_train_state(cfg, TrainConfig(**tk), params=tp, device="cpu")
            step = make_train_step(cfg, TrainConfig(**tk), zero_stage=tk.get("zero_stage", 0),
                                   device="cpu")
            state, m = step(state, torch.from_numpy(img), torch.Generator().manual_seed(0))
            results.append((float(m["loss"]), param_leaves(state.params), m))
        assert results[0][0] == results[1][0]
        for a, b in zip(results[0][1], results[1][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        agreement = results[0][2].get("level_agreement")
        assert (agreement is not None) == (name == "telemetry_level")
        if agreement is not None:
            assert agreement.shape == (cfg.levels,) and bool(agreement.isfinite().all())

    def test_zero_shardings_has_no_counterpart(self):
        with pytest.raises(NotImplementedError, match="parallel/manual.py"):
            make_train_step(GlomConfig(**TINY), TrainConfig(), zero_shardings=object(),
                            device="cpu")
        with pytest.raises(ValueError, match="zero_stage"):
            make_train_step(GlomConfig(**TINY), TrainConfig(zero_stage=3), device="cpu")

    def test_config_validation(self):
        cfg = GlomConfig(**TINY)
        with pytest.raises(ValueError, match="compute_dtype"):
            make_train_step(cfg, TrainConfig(compute_dtype="float16"), device="cpu")
        with pytest.raises(ValueError, match="divide"):
            make_train_step(cfg, TrainConfig(batch_size=6, grad_accum=4), device="cpu")
        with pytest.raises(ValueError, match="telemetry_level"):
            make_train_step(cfg, TrainConfig(telemetry_level="all"), device="cpu")
        with pytest.raises(ValueError, match="nonfinite_policy"):
            make_train_step(cfg, TrainConfig(nonfinite_policy="stop"), device="cpu")


class TestTrainerAndData:
    def test_fit_records(self):
        cfg = GlomConfig(**TINY)
        tr = Trainer(cfg, TrainConfig(batch_size=4, use_pallas=True, learning_rate=1e-3,
                                      grad_accum=2), device="cpu")
        hist = tr.fit(shapes_dataset(4, cfg.image_size), 5, log_every=2, prefetch=2)
        assert [r["step"] for r in hist] == [1, 3, 4]
        for r in hist:
            assert r["vjp_path"] == "scan_dense" and r["grad_accum"] == 2
            assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
            assert r["steps_per_sec"] > 0
        assert hist[-1]["steps_timed"] == 3 and hist[-1]["step_time_p50_ms"] > 0
        assert tr.state.step == 5

    def test_trainer_refuses_unported(self, monkeypatch, tmp_path):
        """fit_loop's hooks are ported: Trainer.fit profiles its trace
        capture's window (the notes and one trace file), and fit_loop merges
        the memory probe's fields into each logging record and writes the
        aux records after it. The Trainer still needs the card unless the
        caller names the CPU."""
        from glom_tpu_torch.telemetry import schema
        from glom_tpu_torch.tracing.capture import TraceCapture

        class Writer:
            def __init__(self):
                self.records = []

            def write(self, rec):
                self.records.append(rec)

        cfg = GlomConfig(**TINY)
        w = Writer()
        tr = Trainer(cfg, TrainConfig(batch_size=2), device="cpu", metrics_writer=w)
        cap = TraceCapture.parse("1:1", str(tmp_path), writer=w)
        tr.fit(gaussian_dataset(2, 8), 3, log_every=1, trace_capture=cap)
        notes = [r for r in w.records if r["kind"] == "note"]
        assert [(r["note"], r.get("first_step"), r.get("last_step")) for r in notes] == [
            ("xla-trace-start", 1, None), ("xla-trace-stop", None, 1)]
        assert [cap.path] == [str(tmp_path / f) for f in os.listdir(tmp_path)]
        aux = schema.stamp({"site": "s", "wall_ms": 1.0}, kind="collective_time")
        w2 = Writer()
        hist = fit_loop(tr.step, gaussian_dataset(2, 8), 2, log_every=1, metrics_writer=w2,
                        memory_probe=lambda: {"hbm_bytes_in_use": 7},
                        aux_records_probe=lambda: [aux])
        assert [r["hbm_bytes_in_use"] for r in hist] == [7, 7]
        kinds = [r["kind"] for r in w2.records]
        assert kinds.count("collective_time") == 2 and kinds[-1] == "collective_time"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg, TrainConfig())

    def test_synthetic_data_matches_reference(self):
        for ours, ref in ((shapes_dataset(3, 16, seed=4), jsynthetic.shapes_dataset(3, 16, seed=4)),
                          (gaussian_dataset(3, 16, seed=4), jsynthetic.gaussian_dataset(3, 16, seed=4))):
            for _ in range(2):
                got, want = next(ours), next(ref)
                assert got.dtype == np.float32 and got.shape == (3, 3, 16, 16)
                np.testing.assert_array_equal(got, np.asarray(want, np.float32))
        assert len(list(shapes_dataset(2, 8, num_batches=3))) == 3

    def test_prefetch_keeps_order_and_relays_errors(self):
        batches = [np.full((1, 2), i, np.float32) for i in range(5)]
        got = [int(b[0, 0]) for b in prefetch_to_device(iter(batches), size=2, device="cpu")]
        assert got == list(range(5))

        def broken():
            yield np.zeros((1,), np.float32)
            raise OSError("disk")

        it = prefetch_to_device(broken(), size=1, device="cpu")
        next(it)
        with pytest.raises(OSError, match="disk"):
            next(it)
        with pytest.raises(ValueError, match="size"):
            prefetch_to_device(iter(batches), size=0, device="cpu")
        it = prefetch_to_device(gaussian_dataset(1, 4), size=2, device="cpu")
        next(it)
        it.close()  # stops the worker on an infinite source
