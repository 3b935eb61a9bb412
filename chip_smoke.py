#!/usr/bin/env python3
"""Drive the PyTorch port (glom_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from glom_tpu_torch/csrc/ (one nvcc per source, in
parallel, into build/glom_tpu_torch/), holds each kernel against its plain
PyTorch version at the flagship shapes, times both, serves the flagship
model (ImageNet-224, patch 14, L = 6, d = 512, bf16, random weights from a
seed) at every bucket through InferenceEngine, checks the kernel launch
counts of that run, its float32 parity with the plain path and the bf16
answer's distance from that path, and prints one JSON line per phase. The
last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed phase raises, and the script exits nonzero without that line.
It also exits nonzero, printing no result, when no CUDA device is present.
Bounds use the H100 SXM's published peaks: 989 TFLOP/s bf16 tensor, 67
TFLOP/s f32, 3.35 TB/s HBM.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
SEED = 0
# Max abs gap allowed between the bf16 served levels and the plain f32
# path at bucket 2 (the flagship, T = 12, seed-0 weights).
BF16_SERVE_ATOL = 1e-2


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import glom_tpu_torch.kernels.consensus_update as k2
    import glom_tpu_torch.kernels.grouped_mlp as k1
    from glom_tpu_torch import GlomConfig, InferenceEngine, ServeConfig, entry, glom_forward
    from glom_tpu_torch.kernels import _build
    from glom_tpu_torch.models.core import init_glom, map_params
    from glom_tpu_torch.ops.ffw import GroupedFFWParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.prebuild(["grouped_mlp", "consensus_update"])
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in logs.items()
    }
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # -- device --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi, flush=True)
    emit("device", name=name, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape, dtype=f32, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def compare(got, want, rtol, atol):
        """(ok, max abs err, max rel err, largest err / bar: ok iff <= 1)."""
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        ratio = float((diff / (atol + rtol * want.abs())).max())
        rel = float((diff / want.abs().clamp_min(1e-6)).max())
        return ratio <= 1.0, float(diff.max()), rel, ratio

    # (rtol, atol). f32: glom_tpu's kernel bars. bf16: about 1-2 bf16 ulps
    # of the output (one ulp is 2^-8 to 2^-7 of the value), tight enough
    # that a dropped bias term or softmax rescale fails on the inputs below.
    bars = {bf16: (1e-2, 1.6e-2), f32: (1e-4, 1e-5)}
    cons_bars = {bf16: (1e-2, 1.6e-2), f32: (2e-4, 2e-5)}
    failures = []

    # -- K1 vs plain -----------------------------------------------------------
    L, n, d, f = 6, 256, 512, 2048
    M8 = 8 * n

    def ffw_params(G):
        # Biases at 0.1, so b1 and b2 move the output by many ulps.
        def rn(*shape, scale):
            return torch.randn(*shape, generator=gen) * scale
        return GroupedFFWParams(rn(G, d, f, scale=d ** -0.5), rn(G, f, scale=0.1),
                                rn(G, f, d, scale=f ** -0.5), rn(G, d, scale=0.1))

    ffw = {"bottom_up": ffw_params(L), "top_down": ffw_params(L - 1)}
    pos = torch.randn(n, d, generator=gen)
    k1_err = {}
    for dtype in (bf16, f32):
        for which, G in (("bottom_up", L), ("top_down", L - 1)):
            params = type(ffw[which])(*(t.to(dev, dtype) for t in ffw[which]))
            x = randn(G, M8, d, dtype=dtype)
            add = pos.to(dev, dtype) if which == "top_down" else None
            got = k1.fused_grouped_ffw_lm(params, x, add=add)
            torch.cuda.synchronize()
            want = k1.grouped_mlp_plain(params, x, add)
            rtol, atol = bars[dtype]
            ok, abs_err, rel_err, ratio = compare(got, want, rtol, atol)
            if dtype == bf16:
                k1_err[which] = abs_err
            emit("k1_vs_plain", which=which, shape=[G, M8, d], dtype=str(dtype),
                 max_abs_err=abs_err, max_rel_err=rel_err, rtol=rtol, atol=atol,
                 bar_ratio=ratio, ok=ok)
            if not ok:
                failures.append(f"K1 {which} {dtype}")

    # -- K2 vs plain -----------------------------------------------------------
    def consensus_inputs(shape, dtype, rank=4, rms=8.0):
        """Levels of rank `rank` and rms `rms`: scores spread with std about
        rms / sqrt(rank) = 4, so the softmax is peaked and its running max
        moves between j tiles. bu = -(levels + pad(td)) cancels the other
        terms of the mean, so out = cons / div: the consensus term is what
        the check sees, while bu and td are still read."""
        Lc, B, nc, dc = shape
        coef = torch.randn(Lc, B, nc, rank, generator=gen)
        basis = torch.randn(Lc, B, rank, dc, generator=gen) / rank ** 0.5
        lv = (rms * (coef @ basis)).to(dev, dtype)
        td = randn(Lc - 1, B, nc, dc, dtype=dtype)
        td_pad = torch.cat([td.float(), torch.zeros_like(lv[:1], dtype=f32)])
        return lv, (-(lv.float() + td_pad)).to(dtype), td

    side = 16
    k2_err = None
    cases = [
        ((L, 8, n, d), side, 0.0, False),
        ((L, 8, n, d), side, 0.0, True),
        ((L, 8, n, d), side, 3.0, False),
    ]
    for dtype in (bf16, f32):
        for shape, sd, radius, attend_self in cases + (
            [((2, 1, 4096, d), 64, 0.0, False)] if dtype == bf16 else []
        ):
            lv, bu, td = consensus_inputs(shape, dtype)
            got = k2.fused_consensus_update(lv, bu, td, side=sd, radius=radius,
                                            attend_self=attend_self)
            torch.cuda.synchronize()
            want = k2.consensus_update_plain(lv, bu, td, side=sd, radius=radius,
                                             attend_self=attend_self)
            rtol, atol = cons_bars[dtype]
            ok, abs_err, rel_err, ratio = compare(got, want, rtol, atol)
            if dtype == bf16 and shape == (L, 8, n, d) and radius == 0 and not attend_self:
                k2_err = abs_err
            emit("k2_vs_plain", shape=list(shape), dtype=str(dtype), radius=radius,
                 attend_self=attend_self, max_abs_err=abs_err, max_rel_err=rel_err,
                 rtol=rtol, atol=atol, bar_ratio=ratio, ok=ok)
            if not ok:
                failures.append(f"K2 {shape} {dtype} r={radius} self={attend_self}")
    if failures:
        raise AssertionError(f"kernel/plain mismatch: {failures}")

    # -- timing ----------------------------------------------------------------
    def time_ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def bound(ops, nbytes, peak_ops):
        t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    timings = {}
    for label, which, G, M in (
        ("k1_bottom_up_b8", "bottom_up", L, M8),
        ("k1_top_down_b8", "top_down", L - 1, M8),
        ("k1_bottom_up_b1", "bottom_up", L, n),
    ):
        params = type(ffw[which])(*(t.to(dev, bf16) for t in ffw[which]))
        x = randn(G, M, d, dtype=bf16)
        add = pos.to(dev, bf16) if which == "top_down" else None
        ms = time_ms(lambda: k1.fused_grouped_ffw_lm(params, x, add=add))
        plain_ms = time_ms(lambda: k1.grouped_mlp_plain(params, x, add))
        nbytes = 2 * (2 * G * M * d + 2 * G * d * f + G * (f + d) + (n * d if add is not None else 0))
        b_ms, b_by = bound(4 * G * M * d * f, nbytes, PEAK_BF16)
        timings[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        emit("timing", kernel=label, shape=[G, M, d], dtype="bfloat16", ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, ratio_to_bound=ms / b_ms)
    # K2 at bucket 8, and one long row (the TPU's streamed kernel's regime).
    for label, (Lc, B, nc), sd in (("k2_b8", (L, 8, n), side), ("k2_long_row", (2, 1, 4096), 64)):
        lv = randn(Lc, B, nc, d, dtype=bf16)
        bu = randn(Lc, B, nc, d, dtype=bf16)
        td = randn(Lc - 1, B, nc, d, dtype=bf16)
        ms = time_ms(lambda: k2.fused_consensus_update(lv, bu, td, side=sd))
        plain_ms = time_ms(lambda: k2.consensus_update_plain(lv, bu, td, side=sd))
        b_ms, b_by = bound(4 * Lc * B * nc * nc * d, 2 * (4 * Lc - 1) * B * nc * d, PEAK_BF16)
        timings[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        emit("timing", kernel=label, shape=[Lc, B, nc, d], dtype="bfloat16", ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, ratio_to_bound=ms / b_ms)

    # -- serve: the main path ----------------------------------------------------
    cfg = GlomConfig()  # flagship: dim 512, L 6, 224 px, patch 14
    T = cfg.default_iters
    params = init_glom(cfg, generator=torch.Generator().manual_seed(SEED))
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    if tuple(out.shape) != (4, 256, 6, 512) or not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"entry(): shape {tuple(out.shape)} or non-finite values")
    emit("entry", shape=list(out.shape), dtype=str(out.dtype))

    scfg = ServeConfig(buckets=(1, 2, 4, 8), compute_dtype="bfloat16", use_pallas=True)
    engine = InferenceEngine(cfg, scfg, params=params, device="cuda")
    warm = engine.warmup()
    emit("warmup", seconds={str(b): s for b, s in warm.items()})

    requests = [1, 2, 3, 4, 5, 8, 1, 2, 4, 7, 8, 1, 2, 4, 8]
    k1.LAUNCHES = k1.LAUNCHES_ADD = k2.LAUNCHES = 0
    lat: dict = {}
    n_served = 0
    for n_req in requests:
        b = engine.pick_bucket(n_req)
        imgs = torch.randn(b, 3, 224, 224, generator=gen)
        imgs[n_req:] = 0.0
        before = (k1.LAUNCHES, k1.LAUNCHES_ADD, k2.LAUNCHES)
        res = engine.infer(imgs, n_valid=n_req)
        got = (k1.LAUNCHES - before[0], k1.LAUNCHES_ADD - before[1], k2.LAUNCHES - before[2])
        if got != (2 * T, T, T):
            raise AssertionError(f"bucket {b}: launches (K1, K1 add, K2) {got} != {(2 * T, T, T)}")
        lv_out = res.levels[:n_req].float()
        if tuple(res.levels.shape) != (b, 256, 6, 512) or not bool(torch.isfinite(lv_out).all()):
            raise AssertionError(f"bucket {b}: bad result shape or non-finite values")
        lat.setdefault(b, []).append(res.latency_s)
        n_served += n_req
    launches = {"grouped_mlp_fwd": k1.LAUNCHES - k1.LAUNCHES_ADD,
                "grouped_mlp_fwd_add": k1.LAUNCHES_ADD,
                "consensus_update_fwd": k2.LAUNCHES}
    if set(lat) != set(scfg.buckets) or min(launches.values()) == 0:
        raise AssertionError(f"buckets served {sorted(lat)}, launches {launches}")
    for b in sorted(lat):
        xs = sorted(lat[b])
        p50 = xs[len(xs) // 2]
        emit("serve", bucket=b, dispatches=len(xs), p50_ms=1e3 * p50, min_ms=1e3 * xs[0],
             column_iters_per_s=b * T / p50, launches_per_dispatch={"K1": 2 * T, "K2": T})
    emit("serve_total", requests=n_served, dispatches=len(requests), launches=launches)

    # Where one bucket-8 dispatch spends its device time (torch.profiler).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    imgs8 = torch.randn(8, 3, 224, 224, generator=gen)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = 1e3 * engine.infer(imgs8).latency_s
    kernel_us: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            key = evt.name if len(evt.name) < 60 else evt.name[:57] + "..."
            kernel_us[key] = kernel_us.get(key, 0.0) + evt.time_range.elapsed_us()
    busy_ms = sum(kernel_us.values()) / 1e3
    emit("serve_profile", bucket=8, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms if busy_ms else None,
         p50_unprofiled_ms=1e3 * sorted(lat[8])[len(lat[8]) // 2],
         kernel_ms={k: v / 1e3 for k, v in sorted(kernel_us.items(), key=lambda kv: -kv[1])})

    # f32 end-to-end parity on the card: fused kernels vs the plain path.
    img2 = torch.randn(2, 3, 224, 224, generator=gen)
    f32_engine = InferenceEngine(
        cfg, ServeConfig(buckets=(2,), compute_dtype="float32", use_pallas=True),
        params=params, device="cuda",
    )
    fused32 = f32_engine.infer(img2).levels.float()
    with torch.inference_mode():
        plain32 = glom_forward(map_params(lambda t: t.to(dev), params), img2.to(dev),
                               cfg, use_pallas=False)
    ok, abs_err, rel_err, _ = compare(fused32, plain32, 2e-3, 2e-4)
    # The bf16 served answer (the main path) against the same f32 answer.
    bf16_ok, bf16_err, _, _ = compare(engine.infer(img2).levels, plain32, 0.0, BF16_SERVE_ATOL)
    emit("serve_parity_f32", bucket=2, max_abs_err=abs_err, max_rel_err=rel_err,
         rtol=2e-3, atol=2e-4, ok=ok, bf16_vs_f32_max_abs_err=bf16_err,
         bf16_atol=BF16_SERVE_ATOL, bf16_ok=bf16_ok)
    if not ok:
        raise AssertionError("f32 fused serve path disagrees with the plain path")
    if not bf16_ok:
        raise AssertionError("bf16 served levels are too far from the plain f32 path")

    # -- kernels -----------------------------------------------------------------
    kernels = []
    for kname, replaces, err, tkey in (
        ("grouped_mlp_fwd", "glom_tpu/kernels/grouped_mlp.py:88", k1_err["bottom_up"],
         "k1_bottom_up_b8"),
        ("grouped_mlp_fwd_add", "glom_tpu/kernels/grouped_mlp.py:127", k1_err["top_down"],
         "k1_top_down_b8"),
        ("consensus_update_fwd", "glom_tpu/kernels/consensus_update.py:115", k2_err, "k2_b8"),
    ):
        src = ("glom_tpu_torch/csrc/grouped_mlp.cu" if kname.startswith("grouped")
               else "glom_tpu_torch/csrc/consensus_update.cu")
        kernels.append(dict(name=kname, route="cuda", source=src, replaces=replaces,
                            launches=launches[kname], max_abs_err=err,
                            **timings[tkey], library_ms=None))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
