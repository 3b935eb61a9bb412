"""The single-device denoising trainer.

Counterpart of `glom_tpu/train/trainer.py`, single device. A step draws
the noise on the device from an explicit `torch.Generator`, runs the
denoising loss forward and backward (on the card through the K1/K2 forward
and backward kernels when `use_pallas`), and applies Adam or AdamW with the
configured learning-rate schedule. Under `telemetry_level != "off"` it also
computes the grad/update/param norms and the NaN/Inf guard; the "skip"
policy keeps parameters and optimizer state bit-identical on a non-finite
step.

Every record names the backward it ran (`vjp_path`, from
`resolve_vjp_path`) and the microbatch count (`grad_accum`), both from
`resolve_training_route`, glom_tpu's rule: on the card a batch of 8 or more
at the flagship trains through the whole-loop VJP ("fused_loop"), and with
`grad_accum=None` a batch that misses it is split into the fewest
power-of-two microbatches that reach it. `fit_loop` writes glom_tpu's
record stream: schema-stamped "train_step" records, the host span rollups
and the anomaly records, to a metrics writer or the flight recorder; at
each logging step it also stamps the memory probe's fields, writes the
aux records (the distributed trainer's collective timing) and, with a
`tracing.capture.TraceCapture`, profiles its step window. Under
`telemetry_level="full"` the step also returns the per-level consensus
agreement of the loss's final state (`telemetry/diagnostics.level_agreement`;
the mean over microbatches under accumulation), which the records carry as
`consensus_agreement_l0..l{L-1}`.

One device has no replica to shard over: `resolve_zero_stage` and
`resolve_quantized_reduce` (glom_tpu's single resolution sources) give 0
and off at dp = 1, so a single-device step runs them as stage 0 without
the quantized hop, as glom_tpu's does. The ZeRO stages and the quantized
reduce run across ranks in `parallel/manual.py`. glom_tpu's GSPMD
`zero_shardings` has no counterpart (there is no GSPMD here) and raises.
`collective_timing` has no site to time on one device and is ignored, as
glom_tpu's Trainer ignores it.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from glom_tpu_torch.data.prefetch import prefetch_to_device
from glom_tpu_torch.models.core import (
    ConsensusFn,
    param_leaves,
    resolve_vjp_path,
    unflatten_params,
)
from glom_tpu_torch.telemetry import diagnostics as diag
from glom_tpu_torch.telemetry import schema
from glom_tpu_torch.telemetry.sinks import StepTimeStats
from glom_tpu_torch.telemetry.watchdog import get_global_watchdog
from glom_tpu_torch.tracing import flight
from glom_tpu_torch.tracing.memory import memory_record, model_live_bytes_total
from glom_tpu_torch.tracing.spans import SpanAggregator, span
from glom_tpu_torch.train.objectives import (
    DenoiseParams,
    default_recon_index,
    denoise_loss,
    init_denoise,
)
from glom_tpu_torch.utils.config import GlomConfig, TrainConfig
from glom_tpu_torch.utils.helpers import resolve_device
from glom_tpu_torch.utils.metrics import live_bytes_model

Optimizer = Callable[[DenoiseParams], torch.optim.Optimizer]


class TrainState(NamedTuple):
    params: DenoiseParams  # leaf tensors that require grad
    optimizer: torch.optim.Optimizer  # holds the moment state
    step: int


def make_lr_schedule(tcfg: TrainConfig):
    """The learning rate from the config: a float (constant) or a function
    of the update count, with optax's semantics. Cosine decays to
    lr_final_fraction * lr; for warmup_cosine, schedule_steps is the TOTAL
    length including the linear warmup from 0."""
    lr, final = tcfg.learning_rate, tcfg.learning_rate * tcfg.lr_final_fraction

    def cosine(count, init, steps, end):
        frac = min(count, steps) / steps
        alpha = end / init if init else 0.0
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    if tcfg.lr_schedule == "constant":
        return lr
    if tcfg.lr_schedule == "cosine":
        return lambda count: cosine(count, lr, tcfg.schedule_steps, final)
    if tcfg.lr_schedule == "warmup_cosine":
        warm = tcfg.warmup_steps
        if not 0 <= warm < tcfg.schedule_steps:
            raise ValueError(
                f"warmup_steps={warm} must be < schedule_steps={tcfg.schedule_steps} "
                "(schedule_steps is the TOTAL length including warmup)"
            )

        def warmup_cosine(count):
            if count < warm:
                return lr * count / warm
            return cosine(count - warm, lr, tcfg.schedule_steps - warm, final)

        return warmup_cosine
    raise ValueError(
        f"lr_schedule={tcfg.lr_schedule!r}: one of 'constant', 'cosine', 'warmup_cosine'"
    )


def default_optimizer(tcfg: TrainConfig) -> Optimizer:
    """Adam (AdamW with weight decay) as a factory over the params.
    torch's Adam matches optax.adam (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root); AdamW's decay is decoupled and scaled by the learning
    rate, as optax.adamw's. The step sets the scheduled rate."""

    def build(params: DenoiseParams) -> torch.optim.Optimizer:
        leaves = param_leaves(params)
        if tcfg.weight_decay > 0:
            return torch.optim.AdamW(
                leaves, lr=tcfg.learning_rate, weight_decay=tcfg.weight_decay, eps=1e-8
            )
        return torch.optim.Adam(leaves, lr=tcfg.learning_rate, eps=1e-8)

    return build


def create_train_state(
    cfg: GlomConfig,
    tcfg: TrainConfig,
    optimizer: Optional[Optimizer] = None,
    *,
    params: Optional[DenoiseParams] = None,
    device="cuda",
) -> Tuple[TrainState, Optimizer]:
    """Params (seeded from tcfg.seed unless given) on `device`, made leaves
    that require grad, and the optimizer built over them."""
    device = resolve_device(device)
    optimizer = optimizer if optimizer is not None else default_optimizer(tcfg)
    if params is None:
        params = init_denoise(cfg, generator=torch.Generator().manual_seed(tcfg.seed))
    params = unflatten_params(
        params, [t.detach().to(device).clone().requires_grad_() for t in param_leaves(params)]
    )
    return TrainState(params=params, optimizer=optimizer(params), step=0), optimizer


def pinned_grad_accum(tcfg: TrainConfig) -> int:
    """The microbatch count an explicit grad_accum pins, or 1 for None."""
    accum = 1 if tcfg.grad_accum is None else tcfg.grad_accum
    if accum < 1:
        raise ValueError(f"grad_accum={tcfg.grad_accum} must be >= 1 or None")
    return accum


def accumulate_grads(loss_fn, params, img, noise, accum: int, grad_transform=None,
                     has_aux: bool = False):
    """Exact microbatch gradient accumulation with glom_tpu's STRIDED split
    (microbatch i takes rows i, i + accum, ...): the mean of the
    microbatch means equals the full-batch loss and gradient. Returns
    (loss, grads) with grads in `param_leaves(params)` order.
    `grad_transform` (glom_tpu's ZeRO stage-2 hook) maps each
    microbatch's gradient list before it is accumulated, so the
    accumulator holds only what it returns (the rank's shards).
    has_aux=True: loss_fn returns (loss, aux dict of tensors) and the call
    returns ((loss, aux mean over microbatches), grads), as glom_tpu's."""
    leaves = param_leaves(params)
    imgs = img.reshape(-1, accum, *img.shape[1:]).transpose(0, 1)
    noises = noise.reshape(-1, accum, *noise.shape[1:]).transpose(0, 1)
    loss_sum, aux_sum, grads = None, None, None
    for mi, mn in zip(imgs, noises):
        loss = loss_fn(params, mi.contiguous(), mn.contiguous())
        if has_aux:
            loss, aux = loss
            aux_sum = aux if aux_sum is None else {k: aux_sum[k] + v for k, v in aux.items()}
        g = torch.autograd.grad(loss, leaves)
        if grad_transform is not None:
            g = grad_transform(list(g))
        grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
        loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
    if accum > 1:
        loss_sum, grads = loss_sum / accum, [g / accum for g in grads]
        if has_aux:
            aux_sum = {k: v / accum for k, v in aux_sum.items()}
    if has_aux:
        return (loss_sum, aux_sum), grads
    return loss_sum, grads


def resolve_route_keys(cfg: GlomConfig, tcfg: TrainConfig) -> Tuple[int, int]:
    """(loss iterations k, compute itemsize) for the route resolution: the
    one copy of the T/k defaulting and the dtype prologue (glom_tpu's
    resolve_route_keys)."""
    T = tcfg.iters if tcfg.iters is not None else cfg.default_iters
    k = tcfg.recon_iter_index if tcfg.recon_iter_index is not None else default_recon_index(T)
    return k, 2 if tcfg.compute_dtype == "bfloat16" else 4


def resolve_training_route(
    cfg: GlomConfig,
    tcfg: TrainConfig,
    *,
    custom_consensus: bool = False,
    scan_only: bool = False,
    device="cuda",
) -> Tuple[int, str]:
    """(grad_accum, vjp_path) for this config (glom_tpu's rule). With
    grad_accum None (auto), a batch whose full-batch route misses the
    whole-loop VJP tries power-of-two microbatch splits (2 to 16, each
    microbatch >= 8) and takes the first that reaches it: the accumulation
    is exact, so this changes the schedule, not the math. An explicit
    grad_accum, 1 included, is honored. scan_only excludes the loop and the
    split that exists only to reach it."""
    k, itemsize = resolve_route_keys(cfg, tcfg)
    kw = dict(
        remat=tcfg.remat, use_pallas=tcfg.use_pallas, itemsize=itemsize,
        custom_consensus=custom_consensus, scan_only=scan_only, device=device,
    )
    accum = pinned_grad_accum(tcfg)
    path = resolve_vjp_path(cfg, tcfg.batch_size // accum, k, **kw)
    if tcfg.grad_accum is None and not scan_only and path != "fused_loop":
        a = 2
        while a <= 16 and tcfg.batch_size % a == 0 and tcfg.batch_size // a >= 8:
            if resolve_vjp_path(cfg, tcfg.batch_size // a, k, **kw) == "fused_loop":
                return a, "fused_loop"
            a *= 2
    return accum, path


def resolve_zero_stage(tcfg: TrainConfig, dp: int) -> int:
    """The effective ZeRO stage (glom_tpu's single resolution source, which
    every trainer stamps): dp == 1 has nothing to shard and resolves to 0
    silently."""
    if tcfg.zero_stage not in (0, 1, 2):
        raise ValueError(
            f"zero_stage={tcfg.zero_stage!r}: must be 0 (replicated), "
            "1 (sharded optimizer state), or 2 (+ sharded grad accumulator)"
        )
    return 0 if dp <= 1 else tcfg.zero_stage


def resolve_quantized_reduce(tcfg: TrainConfig, dp: int) -> bool:
    """The effective quantized-reduce flag: dp == 1 has no cross-replica
    reduction to carry the wire hop, so it resolves off (glom_tpu's)."""
    return bool(tcfg.quantized_reduce) and dp > 1


def _refuse_unported(tcfg: TrainConfig, **kw) -> None:
    if kw.get("zero_shardings") is not None:
        raise NotImplementedError(
            "zero_shardings (glom_tpu's GSPMD ZeroShardings) has no counterpart: "
            "the port's ZeRO stages run across ranks in parallel/manual.py "
            "(DistributedTrainer)"
        )


def apply_update(
    state: TrainState,
    leaves: list,
    grads: list,
    metrics: dict,
    *,
    lr,
    level: str,
    tcfg: TrainConfig,
    with_grad_norm: bool,
    norm=diag.global_norm,
) -> dict:
    """One optimizer update of `leaves` (the optimizer's parameters) by
    `grads` at the scheduled rate, in place, with the grad norm and, under
    telemetry, the scalar taps and the NaN/Inf guard; returns `metrics`
    with those added. `norm` computes a global norm of a list shaped like
    `leaves` (the distributed step passes one that sums over the shards
    of the tensor-parallel leaves)."""
    loss = metrics["loss"]
    grad_norm = norm(grads) if with_grad_norm or level != "off" else None
    if with_grad_norm:
        metrics["grad_norm"] = grad_norm
    opt = state.optimizer
    if level != "off":
        old = [t.detach().clone() for t in leaves]
        old_state = [t.clone() for t in _state_tensors(opt)]
    for p, g in zip(leaves, grads):
        p.grad = g
    for group in opt.param_groups:
        group["lr"] = lr(state.step) if callable(lr) else lr
    opt.step()
    opt.zero_grad(set_to_none=True)
    if level != "off":
        with torch.no_grad():
            new = [t.detach() for t in leaves]
            taps = diag.scalar_taps(loss=loss, grad_norm=grad_norm,
                                    updates=[n - o for n, o in zip(new, old)], params=new,
                                    norm=norm)
            nonfinite = taps.pop("nonfinite")
            if tcfg.nonfinite_policy == "skip":
                for t, v in zip(new, diag.guard_update(nonfinite, new, old)):
                    t.copy_(v)
                cur = _state_tensors(opt)
                if not old_state:  # the first step made the state: its
                    # "before" is all zeros, which Adam reads as fresh
                    old_state = [torch.zeros_like(t) for t in cur]
                for t, v in zip(cur, diag.guard_update(nonfinite, cur, old_state)):
                    t.copy_(v)
                metrics["skipped_nonfinite"] = nonfinite.to(torch.int32)
            metrics.update(taps)
            metrics["nonfinite_step"] = nonfinite.to(torch.int32)
    return metrics


def make_train_step(
    cfg: GlomConfig,
    tcfg: TrainConfig,
    *,
    consensus_fn: Optional[ConsensusFn] = None,
    with_grad_norm: bool = True,
    zero_stage: int = 0,
    zero_shardings=None,
    quantized_reduce: Optional[bool] = None,
    scan_only: bool = False,
    device="cuda",
) -> Callable[[TrainState, torch.Tensor, torch.Generator], Tuple[TrainState, dict]]:
    """The train step: (state, img, generator) -> (state, metrics). The
    noise is drawn on the image's device from `generator`. Parameters and
    optimizer state update in place; the returned state carries step + 1.
    The returned function carries `.grad_accum` and `.vjp_path`.
    scan_only=True keeps the step off the whole-loop VJP (glom_tpu's
    argument), so its backward is the per-iteration kernels' at any batch."""
    _refuse_unported(tcfg, zero_shardings=zero_shardings)
    # One device: the stage resolves to 0 and the quantized reduce off, as
    # glom_tpu's Trainer resolves them (the resolution validates the stage).
    resolve_zero_stage(tcfg, 1)
    if tcfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"compute_dtype={tcfg.compute_dtype!r}: must be 'float32' or 'bfloat16'"
        )
    grad_accum, vjp_path = resolve_training_route(
        cfg, tcfg, custom_consensus=consensus_fn is not None, scan_only=scan_only,
        device=device,
    )
    if tcfg.batch_size % grad_accum:
        raise ValueError(
            f"grad_accum={tcfg.grad_accum} must divide batch_size={tcfg.batch_size}"
        )
    level = diag.resolve_telemetry_level(tcfg)
    full = level == "full"
    compute_dtype = torch.bfloat16 if tcfg.compute_dtype == "bfloat16" else None
    lr = make_lr_schedule(tcfg)

    def loss_of(params, img, noise):
        return denoise_loss(
            params, img, noise, cfg, recon_index=tcfg.recon_iter_index, iters=tcfg.iters,
            remat=tcfg.remat, compute_dtype=compute_dtype, consensus_fn=consensus_fn,
            use_pallas=tcfg.use_pallas, scan_only=scan_only, with_diagnostics=full,
        )

    def train_step(state: TrainState, img: torch.Tensor, generator: torch.Generator):
        noise = tcfg.noise_std * torch.randn(
            img.shape, generator=generator, device=img.device, dtype=img.dtype
        )
        loss, grads = accumulate_grads(loss_of, state.params, img, noise, grad_accum,
                                       has_aux=full)
        aux = None
        if full:
            loss, aux = loss
        metrics = apply_update(
            state, param_leaves(state.params), grads, {"loss": loss, "step": state.step},
            lr=lr, level=level, tcfg=tcfg, with_grad_norm=with_grad_norm,
        )
        if aux is not None:
            metrics["level_agreement"] = aux["level_agreement"]
        return state._replace(step=state.step + 1), metrics

    train_step.grad_accum = grad_accum
    train_step.vjp_path = vjp_path
    return train_step


def _state_tensors(opt: torch.optim.Optimizer) -> list:
    """Every tensor of the optimizer's state, in a fixed order."""
    return [
        v for p in (p for g in opt.param_groups for p in g["params"])
        for _, v in sorted(opt.state.get(p, {}).items()) if torch.is_tensor(v)
    ]


def optimizer_state_layout(opt: torch.optim.Optimizer) -> list:
    """The tensors the optimizer's state holds: its own once its first
    step made them; before that, for torch's Adam and AdamW, two moments
    shaped like each parameter and a scalar step, as meta tensors (for the
    live-bytes model; nothing is allocated)."""
    if opt.state or not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        return _state_tensors(opt)
    return [
        (torch.empty_like(p, device="meta"), torch.empty_like(p, device="meta"),
         torch.empty((), device="meta"))
        for group in opt.param_groups for p in group["params"]
    ]


def _scalar(v):
    """A metrics value as a JSON scalar (tensors are fetched)."""
    if v is None or isinstance(v, (str, bool, int)):
        return v
    return float(v)


def fit_loop(
    step: Callable[[Any], dict],
    data: Iterator,
    num_steps: int,
    *,
    log_every: int = 10,
    metrics_writer=None,
    step_fast: Optional[Callable[[Any], dict]] = None,
    compile_tracker: Optional[set] = None,
    trace_capture=None,
    memory_probe=None,
    aux_records_probe=None,
) -> list:
    """Pull batches, step, and log every `log_every` steps (and the last):
    glom_tpu's fit loop. step_fast, when given, runs the non-logging steps.
    Each step ends in a device synchronize, so its host-clock time is the
    step's device time; the first call of each variant (kernel builds,
    allocator warm-up) is kept out of the percentiles, as glom_tpu keeps
    its compiles out (pass a persistent `compile_tracker` across calls).

    Every logging record is a schema-stamped "train_step" event: the step's
    metrics, vjp_path and grad_accum (from the metrics or the step
    function's attributes), steps_per_sec and the step-time histogram. At
    each log boundary the host spans (host_data_next, host_step_dispatch,
    host_log_fetch) are drained as one "span" record per phase, and a step
    the NaN/Inf guard flagged since the last boundary emits an "anomaly"
    record. Records go to `metrics_writer`, or to the flight recorder when
    there is none; the returned history holds the train_step records only.
    An unhandled exception dumps the flight recorder before re-raising.

    The observability hooks (glom_tpu's):
      * trace_capture -- a tracing.capture.TraceCapture whose [A, B] step
        window wraps each step in its `unit()`; its counter is global to
        the run, so a window spans fit() calls;
      * memory_probe -- called at logging steps; its dict (the card's
        allocator watermarks and the model drift, tracing.memory) rides the
        record;
      * aux_records_probe -- called at logging steps; returns stamped
        records of their own kinds (the distributed trainer's
        "collective_time" rows), written after the step's span records."""

    def emit(rec):
        flight.write_or_observe(metrics_writer, rec)

    history = []
    stats = StepTimeStats()
    spans = SpanAggregator()
    seen = compile_tracker if compile_tracker is not None else set()
    pending_flags = []  # (iteration, device-scalar nonfinite flag)
    t0 = time.perf_counter()
    i = -1
    try:
        for i in range(num_steps):
            logging_step = (i + 1) % log_every == 0 or i == num_steps - 1
            use_full = logging_step or step_fast is None
            fn, key = (step, "step") if use_full else (step_fast, "step_fast")
            first = key not in seen
            seen.add(key)
            with span("host_data_next", aggregator=spans):
                batch = next(data)
            t_step = time.perf_counter()
            with span("host_step_dispatch", aggregator=spans):
                with (trace_capture.unit() if trace_capture is not None
                      else contextlib.nullcontext()):
                    metrics = fn(batch)
                    _synchronize(metrics)
            stats.observe(time.perf_counter() - t_step, is_compile=first)
            if "nonfinite_step" in metrics and not logging_step:
                pending_flags.append((i, metrics["nonfinite_step"]))
            if not logging_step:
                continue
            with span("host_log_fetch", aggregator=spans):
                rec = {k: _scalar(v) for k, v in diag.split_level_agreement(metrics).items()}
            for k in ("vjp_path", "grad_accum"):
                rec.setdefault(k, getattr(fn, k, None))
            rec["steps_per_sec"] = (i + 1) / (time.perf_counter() - t0)
            rec.update(stats.summary())
            if memory_probe is not None:
                rec.update(memory_probe() or {})
            rec = schema.stamp(rec, kind="train_step")
            history.append(rec)
            emit(rec)
            for srec in spans.records(extra={"step": rec.get("step", float(i))}):
                emit(srec)
            if aux_records_probe is not None:
                for arec in aux_records_probe() or []:
                    emit(arec)
            flagged = [k for k, v in pending_flags if float(v)]
            pending_flags = []
            if rec.get("nonfinite_step"):
                flagged.append(i)
            if flagged:
                emit(schema.stamp({
                    "step": rec.get("step", float(i)),
                    "reason": "nonfinite_loss_or_grad",
                    "policy": "skip" if "skipped_nonfinite" in rec else "warn",
                    "count": len(flagged),
                    "flagged_iterations": flagged,
                    "loss": rec.get("loss"),
                    "grad_norm": rec.get("grad_norm"),
                }, kind="anomaly"))
    except BaseException as e:
        flight.dump_flight_recorder(
            "fit-loop-exception",
            context={"exception": f"{type(e).__name__}: {e}"[:300], "at_iteration": i},
        )
        raise
    return history


def backend_fields() -> dict:
    """The backend-state fields of a step record: the global watchdog's
    when one is registered, else "up" (a trainer mid-step is the proof its
    device is up: glom_tpu's backend_record with a live backend)."""
    wd = get_global_watchdog()
    return wd.record() if wd is not None else {"backend_state": "up"}


def _synchronize(metrics: dict) -> None:
    loss = metrics.get("loss")
    if torch.is_tensor(loss) and loss.device.type == "cuda":
        torch.cuda.synchronize(loss.device)


class Trainer:
    """Single-device wrapper: state, noise generator, steps, the fit loop.
    Runs on the card unless the caller passes device="cpu"."""

    def __init__(
        self,
        cfg: GlomConfig,
        tcfg: TrainConfig,
        *,
        optimizer: Optional[Optimizer] = None,
        consensus_fn: Optional[ConsensusFn] = None,
        metrics_writer=None,
        params: Optional[DenoiseParams] = None,
        device="cuda",
    ):
        self.cfg, self.tcfg = cfg, tcfg
        self.metrics_writer = metrics_writer
        self.device = resolve_device(device)
        self.state, self.optimizer = create_train_state(
            cfg, tcfg, optimizer, params=params, device=self.device
        )
        self.generator = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.telemetry_level = diag.resolve_telemetry_level(tcfg)
        self._step = make_train_step(
            cfg, tcfg, consensus_fn=consensus_fn, device=self.device
        )
        self._step_fast = make_train_step(
            cfg, tcfg, consensus_fn=consensus_fn, with_grad_norm=False, device=self.device
        )
        self.vjp_path = self._step.vjp_path
        self.grad_accum = self._step.grad_accum
        # glom_tpu's static record fields. One device: ZeRO resolves to 0,
        # the quantized reduce off, and no collective moves a byte.
        self._static_record = {
            "zero_stage": 0,
            "quantized_reduce": False,
            "telemetry_level": self.telemetry_level,
            **live_bytes_model(self.state.params, optimizer_state_layout(self.state.optimizer)),
            "comm_reduce_bytes_per_step": 0,
            "comm_gather_bytes_per_step": 0,
            "comm_bytes_per_step": 0,
        }
        self._model_live_bytes = model_live_bytes_total(self._static_record)
        # Persistent across fit() calls: span 2+ of a checkpointed run is
        # warm, and its first steps are steady-state samples.
        self._compile_tracker: set = set()

    def _run(self, fn, batch) -> dict:
        img = torch.as_tensor(
            np.asarray(batch) if not torch.is_tensor(batch) else batch,
            dtype=torch.float32, device=self.device,
        )
        # The parameters and optimizer state change in place inside the
        # step: a SIGTERM that lands here is deferred to the step's end,
        # so the preemption save copies a whole step (tracing/flight.py).
        with flight.optimizer_step():
            self.state, metrics = fn(self.state, img, self.generator)
        metrics["vjp_path"] = self.vjp_path
        metrics["grad_accum"] = self.grad_accum
        metrics.update(self._static_record)
        metrics.update(backend_fields())
        return metrics

    def step(self, batch) -> dict:
        return self._run(self._step, batch)

    def step_fast(self, batch) -> dict:
        """The step without the grad-norm sweep (fit runs it on the
        non-logging steps)."""
        return self._run(self._step_fast, batch)

    def _memory_record(self) -> dict:
        """The card's allocator watermarks reconciled against the analytic
        live bytes (tracing/memory.py); {} on the CPU. fit_loop stamps it
        on every logging record."""
        return memory_record(self._model_live_bytes, self.device)

    def fit(
        self,
        data: Iterator,
        num_steps: int,
        *,
        log_every: int = 10,
        prefetch: int = 0,
        trace_capture=None,
    ) -> list:
        """Run `num_steps` updates over [b, c, H, W] batches from `data`.
        prefetch > 0 stages that many batches ahead (pinned host memory and
        a side CUDA stream on the card). It wraps `data` per call: a loop of
        fit calls over one iterator (checkpoint spans) wraps it once itself
        with data.prefetch_to_device and passes prefetch=0, as the CLI
        does."""
        if prefetch > 0:
            data = prefetch_to_device(data, size=prefetch, device=self.device)
        return fit_loop(
            self.step, iter(data), num_steps, log_every=log_every,
            metrics_writer=self.metrics_writer, step_fast=self.step_fast,
            compile_tracker=self._compile_tracker, trace_capture=trace_capture,
            memory_probe=self._memory_record,
        )
