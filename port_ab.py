#!/usr/bin/env python3
"""Time the port's K1/K2 kernels and its serving path for several checkouts
on one NVIDIA GPU, in one run.

    python3 port_ab.py TREE [TREE ...] [--dispatches N]

Each TREE is the root of a checkout that holds `glom_tpu_torch/` ("." is
this one; unpack another commit's package with `git archive COMMIT
glom_tpu_torch | tar -x -C DIR`). The trees run in the order given, each in
a fresh process that imports that checkout's package and builds its kernels
into that checkout's `build/`, so give two versions as A B B A to see the
drift of the card between runs. Per tree it prints one JSON line:

  * the K1 forward at the flagship bucket-8 shapes in bf16 (bottom-up
    [6, 2048, 512], top-down [5, 2048, 512] with the positional addend),
    without and, where the tree has it, with the saved pre-activation; and
    bottom-up at bucket 1 ([6, 256, 512]), with the host's time a call
    there (`k1_host_us_b1`: calls enqueued back to back, the median of
    nine batches of 20);
  * the K1 backward from the saved pre at the same shapes, where the tree
    has it, with one bottom-up call's own peak memory
    (`k1_bwd_call_b8_peak_mib`: its outputs and scratch), and the loop's
    combined 11-group grid in accumulate mode (`k1_bwd_acc_cat_ms`, and
    its call's own peak `k1_bwd_acc_cat_call_peak_mib`);
  * the K2 forward at [6, 8, 256, 512] and at bucket 1 ([6, 1, 256, 512]),
    with the host's time a call at both (`k2_host_us_b1`, `k2_host_us_b8`)
    and what one bucket-8 call adds to the allocated memory at its peak
    (`k2_call_b8_peak_mib`: its output and any scratch), and its whole
    backward (both passes) where the tree has it, with one backward call's
    own peak (`k2_bwd_call_b8_peak_mib`), its combine mode with the two
    streams (`k2_bwd_combine_ms`) and the one-sweep backward at the long
    row [6, 2, 4096, 512] (`k2_bwd_onesweep_longrow_ms`, five launches);
  * K4 (the banded ragged consensus) at the flagship's largest ragged
    signature in bf16 ([2048, 6, 512]: 32 pages of 64 tokens, window 256,
    every band full), with the host's time a call (`k4_host_us_r32`);
  * a SHA-256 of the flagship K2 bucket-8 output, of K2's backward there
    (dlevels and dmean of the pair and of the combine with its two streams:
    `k2_bwd_b8_sha256`, `k2_bwd_combine_b8_sha256`) and of the K4 32-page
    output on these seed-0 inputs (`k2_b8_sha256`, `k4_r32_sha256`), so two
    trees' flagship kernels can be shown bit for bit equal;
  * a SHA-256 of the flagship's K1 outputs: the bucket-8 forward's out and
    saved pre (bottom-up) and out (top-down), the bottom-up backward's dx
    and weight gradients, and the combined grid's accumulating backward
    (dx, the totals, da) from zeroed totals (`k1_fwd_b8_sha256`,
    `k1_bwd_b8_sha256`, `k1_bwd_acc_cat_b8_sha256`);
  * K1 at the imagenet224-pod width (d = 1024, f = 4096): the serving
    forward and the plain backward at [12, 2048, 1024] (`k1_pod_b8_ms`,
    `k1_bwd_pod_b8_ms`), the loop's combined grid [23, 2048, 1024] with
    the saved pre, pre-only and accumulating (`k1_fwd_cat_pod_b8_ms`,
    `k1_pre_cat_pod_b8_ms`, `k1_bwd_acc_cat_pod_b8_ms`), each with its
    device time by pass (`*_passes`, ms: hidden, out, addend; dh, dx, dw,
    da_reduce) and the library's time (`*_seq_ms`, `*_seq_bwd_ms`,
    `*_baddbmm_ms`), and a SHA-256 of its outputs (`*_sha256`);
  * the imagenet224-pod width (d = 1024, L = 12), the wide instances: K2's
    forward at [12, 8, 256, 1024] alone and with the softmax statistics
    (`k2_pod_b8_ms`, `k2_pod_b8_stats_ms`), K2's backward ("wgmma_wide")
    as the per-iteration step calls it at [12, 2, 256, 1024]
    (`k2_bwd_pod_b2_ms`), as the loop calls it with its two streams at
    [12, 8, 256, 1024] (`k2_bwd_combine_pod_b8_ms`, and that call's own
    peak `k2_bwd_combine_pod_b8_call_peak_mib`: outputs and scratch) and
    the one-sweep at [2, 1, 1024, 1024] (`k2_bwd_onesweep_pod_width_ms`),
    K4 at 32 full pages [2048, 12, 1024] (`k4_pod_ragged32_ms`), and the
    imagenet224-pod preset served in bf16 at 12 iterations from seed-0
    weights: bucket 8 (`serve_pod_b8_*`) and 32 pages of eight rows
    (`serve_pod_ragged32_*`), p50 and min over N dispatches; where the tree
    has the trainer, the preset's bf16 training step with remat at 12
    iterations, batch 8 on the loop (`train_pod_b8_*`) and batch 2 on the
    per-iteration route (`train_pod_b2_*`): p50 and min over N steps after
    two warm-up steps, and the peak device memory of one step;
  * the flagship served in bf16 through InferenceEngine at bucket 8: p50 and
    min over N dispatches (host clock ending in a synchronize), and the peak
    device memory of one dispatch (`serve_b8_peak_mib`);
  * the same eight 224-px images as one ragged dispatch of 32 pages
    (`infer_ragged`, K1 and K4): p50 and min over N dispatches and the peak
    device memory of one (`serve_ragged32_*`);
  * where the tree has the trainer, the flagship's bf16 training step at
    batch 8 (`make_train_step` without the grad norm, the route the tree
    resolves, named in `train_b8_vjp_path`): p50 and min over N steps after
    two warm-up steps (host clock ending in a synchronize), the same with
    remat (`train_b8_remat_*`) and at batch 4 (`train_b4_*`, the
    per-iteration route), each with the peak device memory of one step
    (`*_peak_mib`);
  * where the tree has the trainer, the long-row training step: the
    flagship widths at 896 px (n = 4096, global consensus), batch 2, k = 7,
    the route the tree resolves (`train_longrow_vjp_path`): p50 and min over
    three steps after one untimed step, and its peak device memory.

Peak memory is `torch.cuda.max_memory_allocated()` after
`reset_peak_memory_stats()`, in MiB, the weights and optimizer state
included.

Kernel times are CUDA events over 50 launches after 3 warm-up launches (L2
warm); host times are chip_timing.host_us (the median of nine batches of 20
calls, each started on an idle card). The last line gives, per tree, the
median of its runs, and, given two or more distinct trees, `host_pairs`:
the host times of K2 (buckets 1 and 8), K1 (bucket 1) and K4 (32 pages) with every tree
loaded in one process and measured in turns, --host-rounds times (default
30), with the median of the paired differences against the first tree. Inputs and
weights come from seed 0. It needs one card and exits nonzero without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
import time


def child(tree: str, dispatches: int) -> dict:
    import torch
    from chip_timing import host_us
    from chip_timing import time_ms as _time_ms  # this script's, whatever the tree holds

    def time_ms(fn):
        return _time_ms(fn, reps=50)

    root = os.path.abspath(tree)
    sys.path.insert(0, root)

    import glom_tpu_torch
    import glom_tpu_torch.kernels.banded_consensus as k4
    import glom_tpu_torch.kernels.consensus_update as k2
    import glom_tpu_torch.kernels.grouped_mlp as k1
    from glom_tpu_torch import GlomConfig, InferenceEngine, ServeConfig
    from glom_tpu_torch.kernels import _build
    from glom_tpu_torch.models.core import init_glom
    from glom_tpu_torch.ops.ffw import GroupedFFWParams
    from glom_tpu_torch.serve import pack_ragged

    if not os.path.abspath(glom_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {glom_tpu_torch.__file__}, not the one under {root}")
    has_bwd = hasattr(k1, "grouped_mlp_bwd")
    _build.prebuild([src.stem for src in sorted(_build.CSRC.glob("*.cu"))])
    save_pre = "save_pre" in inspect.signature(k1.fused_grouped_ffw_lm).parameters

    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, bf16)

    L, n, d, f = 6, 256, 512, 2048
    M = 8 * n
    out = {"tree": tree}
    for which, G in (("bottom_up", L), ("top_down", L - 1)):
        params = GroupedFFWParams(randn(G, d, f, scale=d ** -0.5), randn(G, f, scale=0.1),
                                  randn(G, f, d, scale=f ** -0.5), randn(G, d, scale=0.1))
        x = randn(G, M, d)
        add = randn(n, d) if which == "top_down" else None
        out[f"k1_fwd_{which}_ms"] = time_ms(lambda: k1.fused_grouped_ffw_lm(params, x, add=add))
        if save_pre:
            out[f"k1_fwd_save_pre_{which}_ms"] = time_ms(
                lambda: k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True))
        if has_bwd:
            pre = k1.fused_grouped_ffw_lm(params, x, add=add, save_pre=True)[1]
            g = randn(G, M, d)
            out[f"k1_bwd_{which}_ms"] = time_ms(
                lambda: k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre))
            if which == "bottom_up":
                pre_bu = pre
        if which == "bottom_up":
            bu_params, bu_x, bu_g = params, x, (g if has_bwd else None)
        else:
            td_params, pos = params, add
    if has_bwd:
        torch.cuda.synchronize()  # one bottom-up backward call's own peak: outputs, scratch
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        k1.grouped_mlp_bwd(bu_params, bu_x, bu_g, pre=pre_bu)
        torch.cuda.synchronize()
        out["k1_bwd_call_b8_peak_mib"] = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        # The loop's combined grid (11 groups) in accumulate mode.
        wcat = k1.cat_params(td_params, bu_params)
        carry, dmean = randn(L + 1, M, d), randn(L, M, d)
        pre_cat = k1.fused_grouped_ffw_lm(wcat, carry, add=pos, save_pre=True, cat=True)[1]
        acc = GroupedFFWParams(*(torch.zeros(t.shape, device=dev) for t in wcat))
        da_in = torch.zeros(n, d, device=dev)

        def bwd_cat():
            return k1.grouped_mlp_bwd(wcat, carry, dmean, add=pos, pre=pre_cat, acc=acc,
                                      da_in=da_in, cat=True)
        out["k1_bwd_acc_cat_ms"] = time_ms(bwd_cat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        bwd_cat()
        torch.cuda.synchronize()
        out["k1_bwd_acc_cat_call_peak_mib"] = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    if has_bwd:  # the flagship's K1 outputs, for bit-for-bit comparison across trees
        out["k1_fwd_b8_sha256"] = sha256(torch.cat([
            t.flatten() for t in (*k1.fused_grouped_ffw_lm(bu_params, bu_x, save_pre=True),
                                  k1.fused_grouped_ffw_lm(td_params, bu_x[:L - 1], add=pos))]))
        out["k1_bwd_b8_sha256"] = sha256(torch.cat([
            t.flatten().float() for t in (lambda r: (r[0], *r[1]))(
                k1.grouped_mlp_bwd(bu_params, bu_x, bu_g, pre=pre_bu))]))
        acc.w1.zero_(), acc.b1.zero_(), acc.w2.zero_(), acc.b2.zero_(), da_in.zero_()
        dx_cat = bwd_cat()[0]
        out["k1_bwd_acc_cat_b8_sha256"] = sha256(torch.cat(
            [dx_cat.flatten().float(), *(t.flatten() for t in acc), da_in.flatten()]))
    x1 = randn(L, n, d)
    out["k1_fwd_bottom_up_b1_ms"] = time_ms(lambda: k1.fused_grouped_ffw_lm(bu_params, x1))
    out["k1_host_us_b1"] = host_us(lambda: k1.fused_grouped_ffw_lm(bu_params, x1))
    for B in (1, 8):
        lv, bu, td = randn(L, B, n, d), randn(L, B, n, d), randn(L - 1, B, n, d)
        out["k2_fwd_ms" if B == 8 else "k2_fwd_b1_ms"] = time_ms(
            lambda: k2.fused_consensus_update(lv, bu, td, side=16))
        out[f"k2_host_us_b{B}"] = host_us(lambda: k2.fused_consensus_update(lv, bu, td, side=16))
    torch.cuda.synchronize()  # one bucket-8 call's own peak: its output and scratch
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    k2.fused_consensus_update(lv, bu, td, side=16)
    torch.cuda.synchronize()
    out["k2_call_b8_peak_mib"] = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    if has_bwd:
        _, m, l = k2.fused_consensus_update(lv, bu, td, side=16, stats=True)
        g = randn(L, 8, n, d)
        out["k2_bwd_ms"] = time_ms(lambda: k2.consensus_update_bwd(lv, g, m, l, side=16))
        torch.cuda.synchronize()  # one bucket-8 backward call's own peak
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        k2.consensus_update_bwd(lv, g, m, l, side=16)
        torch.cuda.synchronize()
        out["k2_bwd_call_b8_peak_mib"] = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        if hasattr(k2, "consensus_bwd_onesweep"):
            streams = dict(dx_bu=randn(L, 8, n, d), dx_td=randn(L - 1, 8, n, d))
            out["k2_bwd_combine_ms"] = time_ms(lambda: k2.consensus_update_bwd(
                lv, g, m, l, side=16, combine=True, **streams))
            out["k2_bwd_b8_sha256"] = sha256(torch.cat(
                k2.consensus_update_bwd(lv, g, m, l, side=16)))
            out["k2_bwd_combine_b8_sha256"] = sha256(torch.cat(k2.consensus_update_bwd(
                lv, g, m, l, side=16, combine=True, **streams)))
            lr = randn(L, 2, 4096, d, scale=8.0)
            _, mr, lr_, cons = k2.fused_consensus_update(lr, lr, lr[1:], side=64, cons=True)
            gr = randn(L, 2, 4096, d)
            out["k2_bwd_onesweep_longrow_ms"] = _time_ms(
                lambda: k2.consensus_bwd_onesweep(lr, gr, mr, lr_, cons, side=64), reps=5)
            del lr, mr, lr_, cons, gr
    lv4, k4_kw = k4_inputs(randn)
    out["k4_fwd_ragged32_ms"] = time_ms(lambda: k4.banded_ragged_consensus(lv4, **k4_kw))
    out["k4_host_us_r32"] = host_us(lambda: k4.banded_ragged_consensus(lv4, **k4_kw))
    out["k2_b8_sha256"] = sha256(k2.fused_consensus_update(lv, bu, td, side=16))
    out["k4_r32_sha256"] = sha256(k4.banded_ragged_consensus(lv4, **k4_kw))
    del lv4

    # The imagenet224-pod width: K1 (d = 1024, f = 4096), the wide instances,
    # then the preset served.
    Lp, dp = 12, 1024
    if has_bwd:
        out.update(k1_pod(k1, GroupedFFWParams, randn, time_ms, torch, dev, n))
    lv, bu, td = randn(Lp, 8, n, dp), randn(Lp, 8, n, dp), randn(Lp - 1, 8, n, dp)
    out["k2_pod_b8_ms"] = time_ms(lambda: k2.fused_consensus_update(lv, bu, td, side=16))
    out["k2_pod_b8_stats_ms"] = time_ms(
        lambda: k2.fused_consensus_update(lv, bu, td, side=16, stats=True))
    del bu, td
    if has_bwd:
        for label, B in (("k2_bwd_pod_b2", 2), ("k2_bwd_combine_pod_b8", 8)):
            lv_b, g = lv[:, :B].contiguous(), randn(Lp, B, n, dp)
            _, m, l = k2.fused_consensus_update(lv_b, g, g[1:], side=16, stats=True)
            kw = dict(side=16)
            if B == 8:
                kw.update(combine=True, dx_bu=randn(Lp, B, n, dp), dx_td=randn(Lp - 1, B, n, dp))
            out[f"{label}_ms"] = time_ms(lambda: k2.consensus_update_bwd(lv_b, g, m, l, **kw))
        torch.cuda.synchronize()  # the combine call's own peak: outputs and scratch
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        k2.consensus_update_bwd(lv_b, g, m, l, **kw)
        torch.cuda.synchronize()
        out["k2_bwd_combine_pod_b8_call_peak_mib"] = (
            (torch.cuda.max_memory_allocated() - held) / 2 ** 20)
        del lv_b, g, m, l, kw
        lo = randn(2, 1, 1024, dp, scale=8.0)
        _, mo, lo_, cons = k2.fused_consensus_update(lo, lo, lo[1:], side=32, cons=True)
        go = randn(2, 1, 1024, dp)
        out["k2_bwd_onesweep_pod_width_ms"] = time_ms(
            lambda: k2.consensus_bwd_onesweep(lo, go, mo, lo_, cons, side=32))
        del lo, mo, lo_, cons, go
    del lv
    lv4, k4_kw = k4_inputs(randn, L=Lp, d=dp)
    out["k4_pod_ragged32_ms"] = time_ms(lambda: k4.banded_ragged_consensus(lv4, **k4_kw))
    del lv4
    out.update(serve_pod(dispatches, gen))

    cfg = GlomConfig()
    engine = InferenceEngine(
        cfg, ServeConfig(buckets=(8,), compute_dtype="bfloat16", use_pallas=True),
        params=init_glom(cfg, generator=torch.Generator().manual_seed(0)), device="cuda",
    )
    engine.warmup()
    lat = []
    for _ in range(dispatches):
        imgs = torch.randn(8, 3, cfg.image_size, cfg.image_size, generator=gen)
        lat.append(engine.infer(imgs).latency_s * 1e3)
    lat.sort()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.infer(imgs)
    out.update(serve_b8_p50_ms=lat[len(lat) // 2], serve_b8_min_ms=lat[0],
               serve_dispatches=dispatches,
               serve_b8_peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    ragged = InferenceEngine(
        cfg, ServeConfig(ragged=True, ragged_attention="banded-pallas", use_pallas=True,
                         compute_dtype="bfloat16", max_batch=8),
        params=engine.params, device="cuda")
    ragged.warmup_ragged()
    lat = []
    for _ in range(dispatches):
        imgs = torch.randn(8, 3, cfg.image_size, cfg.image_size, generator=gen)
        flat, n_p = pack_ragged(list(imgs.numpy()), cfg.patch_size, ragged.page_tokens, 32)
        lat.append(ragged.infer_ragged(flat, n_p).latency_s * 1e3)
    lat.sort()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ragged.infer_ragged(flat, n_p)
    out.update(serve_ragged32_p50_ms=lat[len(lat) // 2], serve_ragged32_min_ms=lat[0],
               serve_ragged32_peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)

    if importlib.util.find_spec("glom_tpu_torch.train") is not None:
        from glom_tpu_torch import TrainConfig
        from glom_tpu_torch.train import create_train_state, init_denoise, make_train_step

        for tag, batch, remat in (("b8", 8, False), ("b8_remat", 8, True), ("b4", 4, False)):
            tcfg = TrainConfig(batch_size=batch, compute_dtype="bfloat16", use_pallas=True,
                               remat=remat)
            step = make_train_step(cfg, tcfg, with_grad_norm=False, device="cuda")
            state, _ = create_train_state(
                cfg, tcfg, params=init_denoise(cfg, generator=torch.Generator().manual_seed(0)),
                device="cuda")
            noise_gen = torch.Generator(device=dev).manual_seed(0)
            imgs = torch.randn(batch, 3, cfg.image_size, cfg.image_size, generator=gen).to(dev)
            steps = []
            for i in range(dispatches + 2):  # the first two warm up
                torch.cuda.synchronize()
                if i == 1:
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, _ = step(state, imgs, noise_gen)
                torch.cuda.synchronize()
                if i == 1:
                    peak = torch.cuda.max_memory_allocated() / 2 ** 20
                if i >= 2:
                    steps.append(1e3 * (time.perf_counter() - t0))
            steps.sort()
            out.update({f"train_{tag}_p50_ms": steps[len(steps) // 2],
                        f"train_{tag}_min_ms": steps[0], f"train_{tag}_peak_mib": peak,
                        f"train_{tag}_vjp_path": step.vjp_path})
        out.update(train_steps=len(steps))
        out.update(train_pod(dispatches, gen, dev))

        cfg_long = GlomConfig(image_size=896)  # n = 4096
        tcfg = TrainConfig(batch_size=2, compute_dtype="bfloat16", use_pallas=True)
        step = make_train_step(cfg_long, tcfg, with_grad_norm=False, device="cuda")
        state, _ = create_train_state(
            cfg_long, tcfg,
            params=init_denoise(cfg_long, generator=torch.Generator().manual_seed(0)),
            device="cuda")
        noise_gen = torch.Generator(device=dev).manual_seed(0)
        imgs = torch.randn(2, 3, 896, 896, generator=gen).to(dev)
        steps = []
        for i in range(4):  # the first warms up
            torch.cuda.synchronize()
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, _ = step(state, imgs, noise_gen)
            torch.cuda.synchronize()
            if i == 1:
                peak = torch.cuda.max_memory_allocated() / 2 ** 20
            if i >= 1:
                steps.append(1e3 * (time.perf_counter() - t0))
        steps.sort()
        out.update(train_longrow_p50_ms=steps[len(steps) // 2], train_longrow_min_ms=steps[0],
                   train_longrow_peak_mib=peak, train_longrow_vjp_path=step.vjp_path)
    return out


def k1_pod(k1, GroupedFFWParams, randn, time_ms, torch, dev, n) -> dict:
    """K1 at the imagenet224-pod width (d = 1024, f = 4096): the serving
    forward and the plain backward at [12, 2048, 1024]; the loop's combined
    grid [23, 2048, 1024]: the forward with its saved pre, the pre-only
    launch and the accumulating backward. Each row's device time by pass
    (torch.profiler) beside the library's (`seq`: baddbmm, tanh GELU,
    baddbmm; `seq_bwd`: autograd through them; `baddbmm`: the pre-only's
    one call), and a SHA-256 of every output (out, pre, dx, the weight
    gradients, the totals, da). Times by pass are under `*_passes`, in ms."""
    from chip_timing import device_us_by_kernel

    Lp, dp, fp, M = 12, 1024, 4096, 2048
    res = {}

    def ffw(G):
        return GroupedFFWParams(randn(G, dp, fp, scale=dp ** -0.5), randn(G, fp, scale=0.1),
                                randn(G, fp, dp, scale=fp ** -0.5), randn(G, dp, scale=0.1))

    def by_pass(run):
        keys = ("hidden", "out", "addend", "dh_sm90", "dx_sm90", "dw_sm90", "da_reduce")
        us = device_us_by_kernel(run, calls=3, key=lambda name: next(
            (k for k in keys if k in name), "other"))
        return {k: v / 1e3 for k, v in us.items()}

    def seq(p, x_in):
        h = torch.nn.functional.gelu(torch.baddbmm(p.b1[:, None], x_in, p.w1), approximate="tanh")
        return torch.baddbmm(p.b2[:, None], h, p.w2)

    def seq_bwd_ms(p, x_in, g):
        leaves = [t.detach().clone().requires_grad_() for t in (x_in, *p)]
        y = seq(GroupedFFWParams(*leaves[1:]), leaves[0])
        return time_ms(lambda: torch.autograd.grad(y, leaves, grad_outputs=g, retain_graph=True))

    p12, p11, add = ffw(Lp), ffw(Lp - 1), randn(n, dp)
    x, g = randn(Lp, M, dp), randn(Lp, M, dp)
    pre = k1.fused_grouped_ffw_lm(p12, x, save_pre=True)[1]
    res["k1_pod_b8_ms"] = time_ms(lambda: k1.fused_grouped_ffw_lm(p12, x))
    res["k1_pod_b8_passes"] = by_pass(lambda: k1.fused_grouped_ffw_lm(p12, x))
    res["k1_pod_b8_seq_ms"] = time_ms(lambda: seq(p12, x))
    res["k1_bwd_pod_b8_ms"] = time_ms(lambda: k1.grouped_mlp_bwd(p12, x, g, pre=pre))
    res["k1_bwd_pod_b8_passes"] = by_pass(lambda: k1.grouped_mlp_bwd(p12, x, g, pre=pre))
    res["k1_bwd_pod_b8_seq_bwd_ms"] = seq_bwd_ms(p12, x, g)
    res["k1_pod_b8_sha256"] = sha256(torch.cat([
        t.flatten() for t in (*k1.fused_grouped_ffw_lm(p12, x, save_pre=True),
                              k1.fused_grouped_ffw_lm(p11, x[:Lp - 1], add=add))]))
    res["k1_bwd_pod_b8_sha256"] = sha256(torch.cat([
        t.flatten().float() for t in (lambda r: (r[0], *r[1]))(
            k1.grouped_mlp_bwd(p12, x, g, pre=pre))]))
    del x, g, pre
    wcat, carry, dmean = k1.cat_params(p11, p12), randn(Lp + 1, M, dp), randn(Lp, M, dp)
    x_cat = torch.cat([(carry[2:].view(Lp - 1, -1, n, dp) + add).view(Lp - 1, M, dp),
                       carry[:Lp]])
    pre = k1.fused_grouped_ffw_lm(wcat, carry, add=add, save_pre=True, cat=True)[1]
    acc = GroupedFFWParams(*(torch.zeros(t.shape, device=dev) for t in wcat))
    da_in = torch.zeros(n, dp, device=dev)

    def fwd():
        return k1.fused_grouped_ffw_lm(wcat, carry, add=add, save_pre=True, cat=True)

    def pre_only():
        return k1.grouped_mlp_pre(wcat, carry, add=add, cat=True)

    def bwd():
        return k1.grouped_mlp_bwd(wcat, carry, dmean, add=add, pre=pre, acc=acc, da_in=da_in,
                                  cat=True)

    for label, run in (("k1_fwd_cat_pod_b8", fwd), ("k1_pre_cat_pod_b8", pre_only),
                       ("k1_bwd_acc_cat_pod_b8", bwd)):
        res[f"{label}_ms"] = time_ms(run)
        res[f"{label}_passes"] = by_pass(run)
    res["k1_fwd_cat_pod_b8_seq_ms"] = time_ms(lambda: seq(wcat, x_cat))
    res["k1_pre_cat_pod_b8_baddbmm_ms"] = time_ms(
        lambda: torch.baddbmm(wcat.b1[:, None], x_cat, wcat.w1))
    res["k1_bwd_acc_cat_pod_b8_seq_bwd_ms"] = seq_bwd_ms(
        wcat, x_cat, torch.cat([dmean[:Lp - 1], dmean]))
    res["k1_fwd_cat_pod_b8_sha256"] = sha256(torch.cat([t.flatten() for t in (*fwd(), pre_only())]))
    for t in (*acc, da_in):
        t.zero_()
    dx = bwd()[0]
    res["k1_bwd_acc_cat_pod_b8_sha256"] = sha256(torch.cat(
        [dx.flatten().float(), *(t.flatten() for t in acc), da_in.flatten()]))
    return res


def k4_inputs(randn, L=6, d=512):
    """K4's bf16 levels at the flagship's largest ragged signature (32 pages
    of 64 tokens, eight full-resolution rows: every band full) and the
    wrapper's keywords, on the card."""
    import torch

    pt, P = 64, 32
    rs = (torch.arange(P * pt, dtype=torch.int32) // 256 * 256).to("cuda")
    rl = torch.full((P * pt,), 256, dtype=torch.int32, device="cuda")
    return randn(P * pt, L, d, scale=2.0), dict(row_start=rs, row_len=rl, window=256,
                                                 page_tokens=pt)


def sha256(t) -> str:
    """The SHA-256 of a tensor's bytes (its bits, not its values)."""
    import hashlib

    import torch

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def serve_pod(dispatches: int, gen) -> dict:
    """The imagenet224-pod preset (L = 12, d = 1024) served in bf16 at 12
    iterations from seed-0 weights: bucket 8 through K2's wide forward and
    32 pages of eight full rows through K4's wide instance, p50 and min over
    `dispatches` each (host clock ending in a synchronize)."""
    import torch
    from glom_tpu_torch import InferenceEngine, ServeConfig
    from glom_tpu_torch.models.core import init_glom
    from glom_tpu_torch.serve import pack_ragged
    from glom_tpu_torch.utils.presets import get_preset

    cfg = get_preset("imagenet224-pod").model
    params = init_glom(cfg, generator=torch.Generator().manual_seed(0))
    out = {}
    engine = InferenceEngine(cfg, ServeConfig(buckets=(8,), max_batch=8, iters=12,
                                              compute_dtype="bfloat16", use_pallas=True),
                             params=params, device="cuda")
    engine.warmup()
    lat = sorted(engine.infer(torch.randn(8, 3, 224, 224, generator=gen)).latency_s * 1e3
                 for _ in range(dispatches))
    out.update(serve_pod_b8_p50_ms=lat[len(lat) // 2], serve_pod_b8_min_ms=lat[0])
    del engine
    ragged = InferenceEngine(
        cfg, ServeConfig(ragged=True, ragged_attention="banded-pallas", use_pallas=True,
                         compute_dtype="bfloat16", max_batch=8, iters=12),
        params=params, device="cuda")
    ragged.warmup_ragged()
    lat = []
    for _ in range(dispatches):
        imgs = torch.randn(8, 3, 224, 224, generator=gen)
        flat, n_p = pack_ragged(list(imgs.numpy()), cfg.patch_size, ragged.page_tokens, 32)
        lat.append(ragged.infer_ragged(flat, n_p).latency_s * 1e3)
    lat.sort()
    out.update(serve_pod_ragged32_p50_ms=lat[len(lat) // 2], serve_pod_ragged32_min_ms=lat[0])
    return out


def train_pod(steps_n: int, gen, dev) -> dict:
    """The imagenet224-pod preset's bf16 training step with remat at 12
    iterations (`make_train_step` without the grad norm): batch 8 on the
    whole-loop VJP and batch 2 on the per-iteration route, p50 and min over
    `steps_n` steps after two warm-up steps (host clock ending in a
    synchronize), and the peak device memory of one step."""
    import torch
    from glom_tpu_torch import TrainConfig
    from glom_tpu_torch.train import create_train_state, init_denoise, make_train_step
    from glom_tpu_torch.utils.presets import get_preset

    pod = get_preset("imagenet224-pod")
    cfg = pod.model
    params = init_denoise(cfg, generator=torch.Generator().manual_seed(0))
    out = {}
    for tag, batch in (("b8", 8), ("b2", 2)):
        tcfg = TrainConfig(batch_size=batch, compute_dtype="bfloat16", use_pallas=True,
                           remat=True, iters=12, learning_rate=pod.train.learning_rate,
                           noise_std=pod.train.noise_std)
        step = make_train_step(cfg, tcfg, with_grad_norm=False, device="cuda")
        state, _ = create_train_state(cfg, tcfg, params=params, device="cuda")
        noise_gen = torch.Generator(device=dev).manual_seed(0)
        imgs = torch.randn(batch, 3, cfg.image_size, cfg.image_size, generator=gen).to(dev)
        steps = []
        for i in range(steps_n + 2):  # the first two warm up
            torch.cuda.synchronize()
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, _ = step(state, imgs, noise_gen)
            torch.cuda.synchronize()
            if i == 1:
                peak = torch.cuda.max_memory_allocated() / 2 ** 20
            if i >= 2:
                steps.append(1e3 * (time.perf_counter() - t0))
        steps.sort()
        out.update({f"train_pod_{tag}_p50_ms": steps[len(steps) // 2],
                    f"train_pod_{tag}_min_ms": steps[0], f"train_pod_{tag}_peak_mib": peak,
                    f"train_pod_{tag}_vjp_path": step.vjp_path})
        del state, step
    return out


def host_pairs(trees: list, rounds: int) -> dict:
    """The host's time a call (chip_timing.host_us) of K2's forward at
    buckets 1 and 8, K1's at bucket 1 and K4's at 32 pages for every tree,
    all loaded in one process and measured in turns, `rounds` times: per
    tree the median over rounds, and against the first tree the median of
    the rounds' paired differences, so the host's drift between runs
    cancels."""
    import torch
    from chip_timing import host_us

    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", torch.bfloat16)

    L, n, d, f = 6, 256, 512, 2048
    ins = {B: (randn(L, B, n, d), randn(L, B, n, d), randn(L - 1, B, n, d)) for B in (1, 8)}
    lv4, k4_kw = k4_inputs(randn)
    w, x1 = (randn(L, d, f, scale=d ** -0.5), randn(L, f, scale=0.1),
             randn(L, f, d, scale=f ** -0.5), randn(L, d, scale=0.1)), randn(L, n, d)
    calls = {}
    for tree in trees:  # each tree's package, imported afresh; its functions keep their modules
        root = os.path.abspath(tree)
        for name in [m for m in sys.modules if m.split(".")[0] == "glom_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, root)
        import glom_tpu_torch.kernels.banded_consensus as k4
        import glom_tpu_torch.kernels.consensus_update as k2
        import glom_tpu_torch.kernels.grouped_mlp as k1
        from glom_tpu_torch.ops.ffw import GroupedFFWParams
        sys.path.remove(root)
        if not k2.__file__.startswith(root + os.sep):
            raise RuntimeError(f"imported {k2.__file__}, not the one under {root}")
        params = GroupedFFWParams(*w)
        calls[tree] = {
            "k2_host_us_b1": lambda k2=k2: k2.fused_consensus_update(*ins[1], side=16),
            "k2_host_us_b8": lambda k2=k2: k2.fused_consensus_update(*ins[8], side=16),
            "k1_host_us_b1": lambda k1=k1, p=params: k1.fused_grouped_ffw_lm(p, x1),
            "k4_host_us_r32": lambda k4=k4: k4.banded_ragged_consensus(lv4, **k4_kw),
        }
    seen = {tree: {key: [] for key in calls[tree]} for tree in trees}
    for _ in range(rounds):
        for key in calls[trees[0]]:
            for tree in trees:
                seen[tree][key].append(host_us(calls[tree][key]))
    base = trees[0]
    return {"rounds": rounds, "median_by_tree": {
        tree: {key: statistics.median(v) for key, v in seen[tree].items()} for tree in trees},
        "paired_diff_median_vs_" + base: {
            tree: {key: statistics.median(a - b for a, b in zip(v, seen[base][key]))
                   for key, v in seen[tree].items()} for tree in trees[1:]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--dispatches", type=int, default=30)
    ap.add_argument("--host-rounds", type=int, default=30)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--pairs", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.dispatches)), flush=True)
        return 0
    if args.pairs:
        print(json.dumps(host_pairs(args.trees, args.host_rounds)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.trees:
        print("port_ab: needs a CUDA device and at least one tree", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs: dict = {}
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--dispatches", str(args.dispatches)],
            capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        runs.setdefault(tree, []).append(rec)
    summary = {
        tree: {key: statistics.median(r[key] for r in recs)
               for key in recs[0]
               if key.endswith(("_ms", "_mib", "_us_b1", "_us_b8", "_us_r32"))}
        for tree, recs in runs.items()
    }
    trees = list(dict.fromkeys(args.trees))
    pairs = None
    if len(trees) > 1:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--pairs", *trees,
             "--host-rounds", str(args.host_rounds)],
            capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        pairs = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"host_pairs": pairs}), flush=True)
    print(json.dumps({"device": smi, "median_by_tree": summary, "host_pairs": pairs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
