#!/usr/bin/env python3
"""Build, check and time one of the port's bf16 kernels on one NVIDIA GPU,
quickly.

    python3 kernel_probe.py k1|k1bwd|k2|k2bwd|k4|k4f32|pair [ROOT ...]

Each ROOT (default ".") holds a `glom_tpu_torch/` to probe, so a copy of the
package with one change can be held against this one in one run on the
card; the roots run in turn, each in a fresh process. Per root it builds the
kernel's source (printing ptxas' registers and spills), then:

  * k1 (`csrc/grouped_mlp.cu`): a structured check of the pre-only launch
    (x = identity rows, w1[k, n] = (k % 16) * 16 + n % 16, b1 = 0, so pre
    must equal w1 element for element; a wrong operand layout shows which
    element landed where); device times of the forward, the pre-only launch
    and `torch.baddbmm` at bucket 8 (bottom-up [6, 2048, 512], top-down
    [5, 2048, 512] with the addend), of the forward at bucket 1 and of the
    combined 11-group grid; the host's time a call at bucket 1; device time
    by kernel of the bucket-8 forward and the combined grid; then at the
    imagenet224-pod width (d = 1024, f = 4096) the serving forward [12,
    2048, 1024] with and without the saved pre and the combined grid [23,
    2048, 1024] with the saved pre and pre-only, each by pass (hidden, out,
    addend) beside the seq forward (baddbmm, tanh GELU, baddbmm) and
    `torch.baddbmm`; then, from a copy of ROOT's package built under
    ROOT/build/ with the GEMM mainloop stamped (GEMM_STAMPS: thread 0 of
    each consumer writes clock64() at each tile's start, after its K loop
    and after its epilogue, and sums its waits on `full`; each producer
    sums its waits on `empty`), the serving forward's two passes by tile
    in cycles (`gemm_phases`);
  * k1bwd (`csrc/grouped_mlp_bwd.cu`, with the forward for the saved
    pre): a structured check of the bf16 saved-pre backward's operand
    orders at G = 1, M = d = 128, f = 256 (x and g identity rows, w2[n, k]
    = (k % 16) * 16 + n % 16, w1 = identity columns, pre = 16 + (r % 16) *
    8 + c % 8, where GELU is the identity and GELU' 1 in f32), so dx = dw1
    = dpre = g . w2^T (w2 read K-major by the dh pass, w1 K-major by the
    dx pass, x MN-major by dw1) and dw2 = pre^T (h read MN-major): every
    output is a pattern of small integers, exact in bf16 and f32, and a
    wrong descriptor shows which element landed where; then device times
    of the five bucket-8 rows (the per-op backward bottom-up [6, 2048,
    512] and top-down [5, 2048, 512] with the addend, both in accumulate
    mode, and the 11-group combined grid) beside autograd through
    baddbmm, tanh GELU and baddbmm, each by kernel, with the host's time a
    call; then at the pod width the plain backward [12, 2048, 1024] and
    the combined grid's accumulating backward [23, 2048, 1024] by pass
    beside the seq backward, and the stamped copy's dh, dx and weight
    passes of the accumulating backward by tile in cycles;
  * k2 (`csrc/consensus_update.cu`): the largest distance of out and cons
    from the plain version over the bf16 cases of the `-m gpu` tests
    (K2_CASES, K2_WIDTHS) and seeds 0-7, in units of K2_BARS and as the
    atol each would need at K2_BARS's rtol (what the tests' bars are set
    from; a faulty copy shows what they catch); device times of the
    forward at
    [6, 1, 256, 512], [6, 8, 256, 512], [2, 1, 4096, 512] and
    [6, 2, 4096, 512] (with cons), each beside
    scaled_dot_product_attention on the same q, normalised k, v; the
    device time of the k pre-pass and of the main kernel; and the host's
    time a call, whole and in its parts: the argument checks, the
    allocations (out, statistics, cons, the k scratch) and the bare C call
    on buffers allocated beforehand;
  * k2bwd (`csrc/consensus_update_bwd.cu`, with the forward for m and l):
    K2's bf16 backward ("wgmma": a pre-pass, the dq pass, the dv and dk
    passes): the largest err / max |want| of each output over the card
    tests' cases (K2_BWD_WGMMA_CASES), forms (the pair, the combine, the
    one-sweep), both attend_self and seeds 0-7, in units of K2_BWD_BARS;
    then device times of the pair, its passes and the combine at [6, 8,
    256, 512] and of the one-sweep at [6, 2, 4096, 512], each by kernel and
    beside the backward of scaled_dot_product_attention on the same q,
    normalised k, v (with the kernels that ran it), and the host's time a
    call; then the same for "wgmma_wide" (past d = 640: each pass a
    two-block cluster for each 64 rows): the readings over the card tests'
    wide cases (K2_BWD_WIDE_CASES), forms and seeds 0-7, device times by
    kernel of the pair at [12, 2, 256, 1024], the combine at [12, 8, 256,
    1024] and the one-sweep at [2, 1, 1024, 1024], each beside SDPA's
    backward; then, from a copy of ROOT's package built under ROOT/build/
    with thread 0 of every block writing clock64() at each wide pass's phase
    boundaries, the median over the combine's 768 blocks of each pass's
    phases in cycles: the set-up, per tile (the first four that accumulate)
    the score product, the exchange (the pair's and the warpgroups' swap,
    p and ds) and the accumulating product with the refill, the loop, and
    the epilogue (the dk pass's: the norm sums across the pair, dxn, its
    staging, the rows of dlevels and dmean).
    A tree without the cluster passes gives times only;
  * k4 (`csrc/banded_consensus.cu`): the same readings for K4 over the
    cases of the `-m gpu` tests (K4_CASES, flat and peaked inputs, both
    attend_self, seeds 0-7), per instance, over the row spans and the
    unused trailing pages; device times at the largest flagship ragged
    signature (32 pages of 64 tokens, window 256, [2048, 6, 512]) with
    every band full and with the test's row mix, and at pages of 128, each
    by kernel (k pre-pass, attention) and beside
    scaled_dot_product_attention on the band gathered beforehand, in f32
    and in bf16; and the host's time a call, whole and in its parts;
  * k4f32 (`csrc/banded_consensus.cu`): K4's f32 "fma" instance and its
    plain version on peaked levels (rank 4 a level, as chip_smoke.py's
    k4_vs_plain) at the flagship's ragged signature ([2048, 6, 512]) and
    the imagenet224-pod width's ([2048, 12, 1024]), pages of 64, and at
    pages of 16 ([192, 3, 1024]), attend_self both ways: the kernel
    against the plain version, and each against an f64 form of the plain
    version, as the largest error over K4's f32 bar (rtol 2e-4, atol
    2e-5), and the largest absolute error. Where the kernel refuses the
    shape (a tree before d = 1024 was taken) it says so;
  * pair (`csrc/consensus_update.cu`, `csrc/banded_consensus.cu`): the
    wide forms past d = 640 / 512 (`csrc/sm90_attn.cuh`'s two-block
    cluster, `attn_pair_loop`): device times of K2's forward at [12, 8,
    256, 1024] and K4's at 32 full pages [2048, 12, 1024], each by kernel
    (k pre-pass, attention) and beside scaled_dot_product_attention on the
    same q, normalised k, v ([96, 1, 256, 1024]; K4 on the band gathered
    beforehand); then, from a copy of ROOT's package built under
    ROOT/build/ with thread 0 of every block writing clock64() at the
    loop's phase boundaries (the original is not touched), the median over
    K2's 768 blocks of each phase's cycles: the Q load, and per key tile
    the scores (S), the exchange with the peer block, the softmax's step,
    P . V; then the epilogue. A tree without the wide pair loop says so.

Device times are CUDA events (chip_timing.time_ms, L2 warm), host times the
median of batches started on an idle card (chip_timing.host_us). The
kernels' comparisons with their plain versions are the `-m gpu` tests
(tests/test_torch_port_gpu.py) and chip_smoke.py. Inputs come from seed 0.
It exits nonzero without a card or on a failed check.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

SOURCES = {"k1": ["grouped_mlp"], "k1bwd": ["grouped_mlp", "grouped_mlp_bwd"],
           "k2": ["consensus_update"],
           "k2bwd": ["consensus_update", "consensus_update_bwd"], "k4": ["banded_consensus"],
           "k4f32": ["banded_consensus"], "pair": ["consensus_update", "banded_consensus"]}

# The pair probe's instrumentation: (source, anchor, code put before it
# ("<") or after it (">")).
# Stamp i of a block is clock64() at a phase boundary, read back through
# `probe_read` (phases: 0 before the Q wait, 1 after it; tile it's 2 + 4 it
# at its start, 3 + 4 it after its scores, 4 + 4 it after the exchange, 5 +
# 4 it before P . V; 18 the loop's end; 19 the epilogue's end).
PAIR_STAMPS = [
    ("sm90_attn.cuh", ">", "namespace sm90 {\n",
     "__device__ long long g_probe[2048][24];\n"
     "__device__ __forceinline__ void stamp(int i) {\n"
     "  const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
     "  if (threadIdx.x == 0 && blk < 2048) g_probe[blk][i] = clock64();\n}\n"),
    ("sm90_attn.cuh", ">", "  cluster_sync();  // both blocks' barriers are set up\n",
     "  stamp(0);\n"),
    ("sm90_attn.cuh", ">",
     "  for (int it = 0; it < tiles; ++it) {\n    const bool refill = loader && it + 1 < tiles;\n",
     "    if (it == 0) stamp(1);\n    if (it < 4) stamp(2 + 4 * it);\n"),
    ("sm90_attn.cuh", ">", "      tail_k(ks, e_full);\n    }\n", "    if (it < 4) stamp(3 + 4 * it);\n"),
    ("sm90_attn.cuh", ">",
     "    pair_exchange(s, xs, xs_peer, s_full, s_full_peer, s_empty, it, rank, loader);\n",
     "    if (it < 4) stamp(4 + 4 * it);\n"),
    ("sm90_attn.cuh", "<",
     "    mbar_wait(v_full, it & 1);\n#pragma unroll\n    for (int c = 0; c < ATTN_NC; ++c) "
     "fence_acc(o[c]);\n    wgmma_fence();\n#pragma unroll\n    for (int c = 0; c < ATTN_NC; ++c)\n"
     "#pragma unroll\n", "    if (it < 4) stamp(5 + 4 * it);\n"),
    ("sm90_attn.cuh", ">", "      tail_v(vs, e_full + 1);\n    }\n  }\n", "  stamp(18);\n"),
    ("consensus_update.cu", ">", "    __syncwarp();\n  }\n", "  if constexpr (WIDE) sm90::stamp(19);\n"),
    ("consensus_update.cu", ">", 'extern "C" {\n',
     "int probe_read(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, sm90::g_probe, sizeof(sm90::g_probe));\n}\n"),
]


# The k2bwd probe's instrumentation of the wide backward passes
# (csrc/consensus_update_bwd.cu:wide_pass; pass 0 dq, 1 dv, 2 dk). Stamp i
# of a block: 0 after the cluster's set-up, 1 after the resident operands
# landed; for the v-th tile that accumulates (v < 4) 2 + 3 v at its start,
# 3 + 3 v after its score product, 4 + 3 v before its accumulating product;
# 14 at the loop's end; 15 after the epilogue; in the dk pass 16 after the
# pair's norm sums, 17 after dxn, 18 after dxn is staged (the row loop
# follows).
BWD_WIDE_STAMPS = [
    ("consensus_update_bwd.cu", ">", "enum WidePass { PASS_DQ, PASS_DV, PASS_DK };\n",
     "__device__ long long g_bwd_probe[3][2048][24];\n"
     "__device__ __forceinline__ void bwd_stamp(int pass, int i) {\n"
     "  const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
     "  if (threadIdx.x == 0 && blk < 2048) g_bwd_probe[pass][blk][i] = clock64();\n}\n"),
    ("consensus_update_bwd.cu", ">",
     "  sm90::cluster_sync();  // both blocks' barriers are set up\n", "  bwd_stamp(PASS, 0);\n"),
    ("consensus_update_bwd.cu", ">", "  sm90::mbar_wait(a_full, 0);\n", "  bwd_stamp(PASS, 1);\n"),
    ("consensus_update_bwd.cu", ">",
     "    const bool acc_tile = u >= first_acc, last = u + 1 == total;\n",
     "    const int v_ = u - first_acc;\n"
     "    if (v_ >= 0 && v_ < 4) bwd_stamp(PASS, 2 + 3 * v_);\n"),
    ("consensus_update_bwd.cu", "<",
     "    uint32_t a[NT / 4];  // the accumulating product's A: ds or p^T, rounded\n",
     "    if (v_ >= 0 && v_ < 4) bwd_stamp(PASS, 3 + 3 * v_);\n"),
    ("consensus_update_bwd.cu", "<",
     "    // dq += ds . k, dk += ds^T . Q (B1) or dv += p^T . dcons (B2) over the\n",
     "    if (v_ < 4) bwd_stamp(PASS, 4 + 3 * v_);\n"),
    ("consensus_update_bwd.cu", "<",
     "  if constexpr (DQ) {\n    if (!onesweep && rank == 0 && w == 0 && t % 4 == 0) {\n",
     "  bwd_stamp(PASS, 14);\n"),
    ("consensus_update_bwd.cu", "<", "    return;\n  }\n  if constexpr (DV) {\n",
     "    bwd_stamp(PASS, 15);\n"),
    ("consensus_update_bwd.cu", "<", "    return;\n  }\n\n  // The dk pass's epilogue.",
     "    bwd_stamp(PASS, 15);\n"),
    ("consensus_update_bwd.cu", ">",
     "  sm90::cluster_sync();  // the peer has read this block's halves\n",
     "  bwd_stamp(PASS, 16);\n"),
    ("consensus_update_bwd.cu", "<",
     "  // dxn staged as [64][STAGE_PITCH] f32 over A1, A2 and B1 (free: every\n",
     "  bwd_stamp(PASS, 17);\n"),
    ("consensus_update_bwd.cu", "<",
     "  const float div = g == L - 1 ? 3.0f : 4.0f;\n"
     "  const float inv_div = __fdiv_rn(1.0f, div);\n  constexpr int SEGS = 4;\n",
     "  bwd_stamp(PASS, 18);\n"),
    ("consensus_update_bwd.cu", "<", "}\n\n// The wide passes, named apart for the profiles.",
     "  bwd_stamp(PASS, 15);\n"),
    ("consensus_update_bwd.cu", ">", 'extern "C" {\n',
     "int bwd_probe_read(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, g_bwd_probe, sizeof(g_bwd_probe));\n}\n"),
]


# The k1 / k1bwd probes' instrumentation of the GEMM mainloop
# (csrc/sm90_gemm.cuh:gemm_problems). Thread 0 of each consumer warpgroup
# writes, for each of its first 64 tiles, clock64() at the tile's start, the
# cycles it spent in the K loop's waits on `full`, clock64() after the K
# loop's last wgmma retired and after the tile's epilogue; the producer
# thread of each ring the cycles it spent waiting on `empty` over the
# launch. A launch's slot: 2 for a two-problem launch (the weight pass), 0
# where K < N (dh, the forward's pass 1), else 1 (dx, pass 2). Both
# libraries (grouped_mlp, grouped_mlp_bwd) read theirs with
# `gemm_probe_read`.
GEMM_STAMPS = [
    ("sm90_gemm.cuh", ">", "namespace sm90 {\n",
     "__device__ long long g_gemm_probe[3][132][2][64][4];\n"
     "__device__ long long g_gemm_empty[3][132][2];\n"
     "__device__ int g_gemm_tiles[3][132][2];\n"),
    ("sm90_gemm.cuh", ">", "  const int t = producer ? threadIdx.x % 32 : threadIdx.x % 128;\n",
     "  const int probe_pass = P == 2 ? 2 : (ops[0].shape.K < ops[0].shape.N ? 0 : 1);\n"
     "  const bool probe_on = blockIdx.x < 132 && t == 0 && ring < CONSUMERS;\n"
     "  int probe_tile = 0;\n  long long probe_fw = 0, probe_ew = 0;\n"),
    ("sm90_gemm.cuh", ">", "        const int s = it % STAGES;\n",
     "        const long long probe_e0 = clock64();\n"),
    ("sm90_gemm.cuh", "<", "        mbar_expect_tx(full + s, bytes);\n",
     "        probe_ew += clock64() - probe_e0;\n"),
    ("sm90_gemm.cuh", "<", "    return;\n  }\n\n  asm volatile(\"setmaxnreg.inc",
     "    if (probe_on) g_gemm_empty[probe_pass][blockIdx.x][ring] = probe_ew;\n"),
    ("sm90_gemm.cuh", "<",
     "    if constexpr (has_prefetch<Epilogue>::value) epi.prefetch(",
     "    const long long probe_s0 = clock64();\n    probe_fw = 0;\n"),
    ("sm90_gemm.cuh", "<", "      mbar_wait(full + s, (it / STAGES) & 1);\n",
     "      const long long probe_w0 = clock64();\n"),
    ("sm90_gemm.cuh", ">", "      mbar_wait(full + s, (it / STAGES) & 1);\n",
     "      probe_fw += clock64() - probe_w0;\n"),
    ("sm90_gemm.cuh", ">", "    wgmma_wait<0>();\n", "    const long long probe_k = clock64();\n"),
    ("sm90_gemm.cuh", "<",
     ("  }\n  // PAIR: the epilogues' TMA stores have completed before the block exits.\n",
      "  }\n}\n\n// One problem (the forward's passes)"),
     "    if (probe_on && probe_tile < 64) {\n"
     "      long long* q = g_gemm_probe[probe_pass][blockIdx.x][ring][probe_tile];\n"
     "      q[0] = probe_s0; q[1] = probe_fw; q[2] = probe_k; q[3] = clock64();\n    }\n"
     "    ++probe_tile;\n"),
    ("sm90_gemm.cuh", "<", "}\n\n// One problem (the forward's passes)",
     "  if (probe_on) g_gemm_tiles[probe_pass][blockIdx.x][ring] = probe_tile;\n"),
    *((src, ">", 'extern "C" {\n',
       "int gemm_probe_read(void* tiles, void* empty, void* counts) {\n"
       "  cudaError_t e = cudaMemcpyFromSymbol(tiles, sm90::g_gemm_probe, sizeof(sm90::g_gemm_probe));\n"
       "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(empty, sm90::g_gemm_empty, sizeof(sm90::g_gemm_empty));\n"
       "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(counts, sm90::g_gemm_tiles, sizeof(sm90::g_gemm_tiles));\n"
       "  return (int)e;\n}\n") for src in ("grouped_mlp.cu", "grouped_mlp_bwd.cu")),
]


def instrument(root: str, stamps=None, marker="attn_pair_loop", path="sm90_attn.cuh",
               name="kernel_probe_pair"):
    """A copy of ROOT's package under ROOT/build/NAME with `stamps` (the
    pair probe's by default), or None where ROOT's csrc/PATH lacks MARKER."""
    import shutil

    stamps = PAIR_STAMPS if stamps is None else stamps
    src = os.path.join(root, "glom_tpu_torch")
    attn = os.path.join(src, "csrc", path)
    if not os.path.exists(attn) or marker not in open(attn).read():
        return None
    dst = os.path.join(root, "build", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, os.path.join(dst, "glom_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, where, anchor, code in stamps:
        path = os.path.join(dst, "glom_tpu_torch", "csrc", name)
        text = open(path).read()
        if isinstance(anchor, tuple):  # alternatives: this tree's form, an older tree's
            anchor = next((a for a in anchor if a in text), anchor[0])
        if text.count(anchor) != 1:
            raise RuntimeError(f"pair probe: anchor not found once in {name}: {anchor!r}")
        open(path, "w").write(text.replace(anchor, code + anchor if where == "<" else anchor + code))
    return dst


def probe(kernel: str, root: str) -> int:
    import torch

    from chip_timing import device_us_by_kernel, host_us, time_ms

    sys.path.insert(0, root)
    from glom_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device is available", file=sys.stderr)
        return 1
    assert _build.__file__.startswith(root), _build.__file__
    t0 = time.perf_counter()
    logs = _build.prebuild(SOURCES[kernel])
    print("build_s", round(time.perf_counter() - t0, 2), flush=True)
    for ln in logs[SOURCES[kernel][-1]].splitlines():
        if any(k in ln for k in ("registers", "spill", "error", "warning", "Function properties",
                                 "bytes stack", "C7508", "Compiling entry")):
            print("  ", ln.strip())
    gen = torch.Generator().manual_seed(0)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", torch.bfloat16)

    tools = dict(rn=rn, time_ms=time_ms, host_us=host_us, device_us=device_us_by_kernel)
    return {"k1": probe_k1, "k1bwd": probe_k1bwd, "k2": probe_k2, "k2bwd": probe_k2bwd,
            "k4": probe_k4, "k4f32": probe_k4f32, "pair": probe_pair}[kernel](torch, **tools)


def probe_k1(torch, rn, time_ms, host_us, device_us) -> int:
    import glom_tpu_torch.kernels.grouped_mlp as k1
    from glom_tpu_torch.ops.ffw import GroupedFFWParams

    if hasattr(k1._lib(), "gemm_probe_read"):  # the stamped copy: phases only
        x, p12 = rn(12, 2048, 1024), pod_ffw(rn, GroupedFFWParams, 12)
        k1.fused_grouped_ffw_lm(p12, x, save_pre=True)
        return gemm_phases(torch, k1._lib(), "k1_fwd_pod_b8", ("hidden", "out"))
    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    G, M, d, f = 1, 128, 128, 256
    x = torch.zeros(G, M, d)
    x[0, torch.arange(M), torch.arange(M) % d] = 1.0
    w1 = ((torch.arange(d)[:, None] % 16) * 16 + torch.arange(f)[None, :] % 16).float()[None]
    params = GroupedFFWParams(w1.to(dev, bf16), torch.zeros(G, f, device=dev, dtype=bf16),
                              rn(G, f, d, scale=f ** -0.5), torch.zeros(G, d, device=dev, dtype=bf16))
    pre = k1.grouped_mlp_pre(params, x.to(dev, bf16)).float()
    bad = pre != k1.grouped_mlp_pre_plain(params, x.to(dev, bf16)).float()
    print(json.dumps(dict(check="identity_pre", mismatches=int(bad.sum()), of=bad.numel())),
          flush=True)
    if bad.any():
        print("got rows 0..9, 64, 65, 72, cols 0..17 (value = (k%16)*16 + n%16):")
        for r in list(range(10)) + [64, 65, 72]:
            print(r, [int(v) for v in pre[0, r, :18].cpu()])
        return 1

    def ffw(G):
        return GroupedFFWParams(rn(G, d, f, scale=d ** -0.5), rn(G, f, scale=0.1),
                                rn(G, f, d, scale=f ** -0.5), rn(G, d, scale=0.1))

    L, n, d, f = 6, 256, 512, 2048
    p6, p5 = ffw(L), ffw(L - 1)
    add = rn(n, d)
    for which, p, x8, a in (("bottom_up", p6, rn(L, 8 * n, d), None),
                            ("top_down", p5, rn(L - 1, 8 * n, d), add)):
        print(json.dumps(dict(
            timing=which, shape=list(x8.shape),
            fwd_ms=time_ms(lambda: k1.fused_grouped_ffw_lm(p, x8, add=a)),
            pre_ms=time_ms(lambda: k1.grouped_mlp_pre(p, x8, add=a)),
            baddbmm_ms=time_ms(lambda: torch.baddbmm(p.b1[:, None], x8, p.w1)),
            device_us=device_us(lambda: k1.fused_grouped_ffw_lm(p, x8, add=a)))), flush=True)
    x1 = rn(L, n, d)
    print(json.dumps(dict(timing="bottom_up_b1", shape=list(x1.shape),
                          fwd_ms=time_ms(lambda: k1.fused_grouped_ffw_lm(p6, x1)),
                          host_us=host_us(lambda: k1.fused_grouped_ffw_lm(p6, x1)))), flush=True)
    wcat, carry = k1.cat_params(p5, p6), rn(L + 1, 8 * n, d)

    def cat_fwd():
        return k1.fused_grouped_ffw_lm(wcat, carry, add=add, save_pre=True, cat=True)

    print(json.dumps(dict(
        timing="cat_grid", shape=list(carry.shape), fwd_save_pre_ms=time_ms(cat_fwd),
        pre_ms=time_ms(lambda: k1.grouped_mlp_pre(wcat, carry, add=add, cat=True)),
        device_us=device_us(cat_fwd))), flush=True)
    del p6, p5, wcat, carry

    # The imagenet224-pod width (d = 1024, f = 4096): the serving forward
    # [12, 2048, 1024] and the loop's combined grid [23, 2048, 1024], by pass.
    def pass_key(name):
        return next((k for k in ("hidden", "out", "addend") if f"mlp_fwd_{k}" in name), "other")

    def seq(p, x_in):
        h = torch.nn.functional.gelu(torch.baddbmm(p.b1[:, None], x_in, p.w1), approximate="tanh")
        return torch.baddbmm(p.b2[:, None], h, p.w2)

    Lp, n, dp, fp = 12, 256, 1024, 4096
    p12, p11, add_p = (pod_ffw(rn, GroupedFFWParams, 12), pod_ffw(rn, GroupedFFWParams, 11),
                       rn(n, dp))
    x12 = rn(Lp, 8 * n, dp)
    print(json.dumps(dict(
        timing="k1_pod_b8", shape=list(x12.shape), f=fp,
        fwd_ms=time_ms(lambda: k1.fused_grouped_ffw_lm(p12, x12)),
        fwd_save_pre_ms=time_ms(lambda: k1.fused_grouped_ffw_lm(p12, x12, save_pre=True)),
        seq_ms=time_ms(lambda: seq(p12, x12)),
        device_us=device_us(lambda: k1.fused_grouped_ffw_lm(p12, x12), key=pass_key))),
        flush=True)
    wcat, carry = k1.cat_params(p11, p12), rn(Lp + 1, 8 * n, dp)
    x_cat = torch.cat([(carry[2:].view(Lp - 1, -1, n, dp) + add_p).view(Lp - 1, 8 * n, dp),
                       carry[:Lp]])

    def cat_fwd():
        return k1.fused_grouped_ffw_lm(wcat, carry, add=add_p, save_pre=True, cat=True)

    def cat_pre():
        return k1.grouped_mlp_pre(wcat, carry, add=add_p, cat=True)

    print(json.dumps(dict(
        timing="k1_cat_pod_b8", shape=[2 * Lp - 1, 8 * n, dp], f=fp,
        fwd_save_pre_ms=time_ms(cat_fwd), pre_ms=time_ms(cat_pre),
        seq_ms=time_ms(lambda: seq(wcat, x_cat)),
        baddbmm_ms=time_ms(lambda: torch.baddbmm(wcat.b1[:, None], x_cat, wcat.w1)),
        fwd_device_us=device_us(cat_fwd, key=pass_key),
        pre_device_us=device_us(cat_pre, key=pass_key))), flush=True)
    return 0


def pod_ffw(rn, GroupedFFWParams, G, d=1024, f=4096):
    """Random bf16 weights of G groups at the imagenet224-pod width."""
    return GroupedFFWParams(rn(G, d, f, scale=d ** -0.5), rn(G, f, scale=0.1),
                            rn(G, f, d, scale=f ** -0.5), rn(G, d, scale=0.1))


def gemm_phases(torch, lib, case, names) -> int:
    """The stamped copy's readings of the GEMM mainloop after one call
    (GEMM_STAMPS; `names` are the call's launch slots 0, 1, 2), per launch:
    the median over all tiles of a consumer's K loop, its waits on `full`
    inside it and its epilogue, in cycles (the first tile of each consumer
    apart, since it waits for the ring's first fills); each block's span
    from its first tile's start to its last epilogue's end; the share of the
    span in which neither consumer is in a K loop (both in epilogues, or
    one done and the other in an epilogue), and the share of the consumers'
    K-loop cycles spent waiting on `full`; the producers' waits on `empty`
    as a share of the span."""
    import numpy as np

    torch.cuda.synchronize()
    tiles = np.zeros((3, 132, 2, 64, 4), np.int64)
    empty = np.zeros((3, 132, 2), np.int64)
    counts = np.zeros((3, 132, 2), np.int32)
    lib.gemm_probe_read.argtypes = [ctypes.c_void_p] * 3
    if lib.gemm_probe_read(tiles.ctypes.data, empty.ctypes.data, counts.ctypes.data) != 0:
        print("gemm_probe_read failed", flush=True)
        return 1
    for slot, name in enumerate(names):
        kl, fw, ep, first, idle, wait_share, empty_share, spans = [], [], [], [], [], [], [], []
        for b in range(132):
            n_t = [min(int(counts[slot, b, c]), 64) for c in range(2)]
            if min(n_t) == 0:
                continue
            rows = [tiles[slot, b, c, :n_t[c]] for c in range(2)]
            start = min(int(r[0, 0]) for r in rows)
            end = max(int(r[-1, 3]) for r in rows)
            spans.append(end - start)
            loops = sorted((int(q[0]), int(q[2])) for r in rows for q in r)
            busy, cur_s, cur_e = 0, None, None
            for s_, e_ in loops:
                if cur_e is None or s_ > cur_e:
                    busy += 0 if cur_e is None else cur_e - cur_s
                    cur_s, cur_e = s_, e_
                else:
                    cur_e = max(cur_e, e_)
            busy += cur_e - cur_s
            idle.append(1.0 - busy / (end - start))
            loop_cycles = sum(int(q[2] - q[0]) for r in rows for q in r)
            wait_share.append(sum(int(q[1]) for r in rows for q in r) / loop_cycles)
            empty_share.append(float(empty[slot, b].sum()) / 2 / (end - start))
            for r in rows:
                first.append(int(r[0, 2] - r[0, 0]))
                kl += [int(q[2] - q[0]) for q in r[1:]]
                fw += [int(q[1]) for q in r[1:]]
                ep += [int(q[3] - q[2]) for q in r]
        if not spans:
            continue
        print(json.dumps(dict(
            case=f"{case}_{name}_cycles", blocks=len(spans),
            tiles_a_consumer=float(np.median(counts[slot][counts[slot] > 0])),
            k_loop=float(np.median(kl)) if kl else None,
            full_wait_in_k_loop=float(np.median(fw)) if fw else None,
            epilogue=float(np.median(ep)), first_tile_k_loop=float(np.median(first)),
            block_span=float(np.median(spans)),
            share_no_k_loop=float(np.median(idle)),
            share_k_loop_waiting_full=float(np.median(wait_share)),
            producer_empty_wait_share=float(np.median(empty_share)))), flush=True)
    return 0


def probe_k1bwd(torch, rn, time_ms, host_us, device_us) -> int:
    import glom_tpu_torch.kernels.grouped_mlp as k1
    from glom_tpu_torch.ops.ffw import GroupedFFWParams

    dev, bf16, f32 = torch.device("cuda", 0), torch.bfloat16, torch.float32
    Lp, n, dp, fp = 12, 256, 1024, 4096
    if hasattr(k1._bwd_lib(), "gemm_probe_read"):  # the stamped copy: phases only
        wcat = k1.cat_params(pod_ffw(rn, GroupedFFWParams, Lp - 1), pod_ffw(rn, GroupedFFWParams, Lp))
        carry, dmean, add_p = rn(Lp + 1, 8 * n, dp), rn(Lp, 8 * n, dp), rn(n, dp)
        pre = k1.fused_grouped_ffw_lm(wcat, carry, add=add_p, save_pre=True, cat=True)[1]
        acc = GroupedFFWParams(*(torch.zeros(t.shape, device=dev) for t in wcat))
        k1.grouped_mlp_bwd(wcat, carry, dmean, add=add_p, pre=pre, acc=acc,
                           da_in=torch.zeros(n, dp, device=dev), cat=True)
        return gemm_phases(torch, k1._bwd_lib(), "k1_bwd_acc_cat_pod_b8", ("dh", "dx", "dw"))
    G, M, d, f = 1, 128, 128, 256
    r = torch.arange(M)[:, None]
    eye = torch.eye(M, d)[None]
    w2 = ((torch.arange(d)[None, :] % 16) * 16 + torch.arange(f)[:, None] % 16).float()[None]
    w1 = torch.eye(d, f)[None]
    pre = (16 + (r % 16) * 8 + torch.arange(f)[None, :] % 8).float()[None]
    params = GroupedFFWParams(w1.to(dev, bf16), torch.zeros(G, f, device=dev, dtype=bf16),
                              w2.to(dev, bf16), torch.zeros(G, d, device=dev, dtype=bf16))
    x, g, pre = eye.to(dev, bf16), eye.to(dev, bf16), pre.to(dev, bf16)
    fail = 0
    for mode in ("grads", "accumulate"):
        acc = None
        if mode == "accumulate":
            acc = GroupedFFWParams(*(torch.zeros(t.shape, device=dev) for t in params))
        got = k1.grouped_mlp_bwd(params, x, g, pre=pre, acc=acc)
        want = k1.grouped_mlp_bwd_plain(
            params, x, g, None, pre,
            None if acc is None else GroupedFFWParams(*(torch.zeros_like(t) for t in acc)))
        for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), (got[0], *got[1]),
                              (want[0], *want[1])):
            bad = a.float() != b.float()
            print(json.dumps(dict(check="identity_bwd", mode=mode, output=name,
                                  mismatches=int(bad.sum()), of=bad.numel())), flush=True)
            if bad.any():
                fail = 1
                a2, b2 = a.float().reshape(-1, a.shape[-1]), b.float().reshape(-1, b.shape[-1])
                for row in sorted({0, 1, 2, 8, 15, 16, 63, 64, 65, a2.shape[0] - 1}):
                    if row < a2.shape[0]:
                        print(name, row, "got", [int(v) for v in a2[row, :18].cpu()],
                              "want", [int(v) for v in b2[row, :18].cpu()])
    if fail:
        return 1

    def ffw(G):
        return GroupedFFWParams(rn(G, d, f, scale=d ** -0.5), rn(G, f, scale=0.1),
                                rn(G, f, d, scale=f ** -0.5), rn(G, d, scale=0.1))

    def seq_bwd_ms(p, x_in, g):
        leaves = [t.detach().clone().requires_grad_() for t in (x_in, *p)]
        h = torch.nn.functional.gelu(torch.baddbmm(leaves[2][:, None], leaves[0], leaves[1]),
                                     approximate="tanh")
        out = torch.baddbmm(leaves[4][:, None], h, leaves[3])
        return time_ms(lambda: torch.autograd.grad(out, leaves, grad_outputs=g,
                                                   retain_graph=True))

    def kernel_key(name):
        for part in ("mlp_bwd_dh_sm90", "mlp_bwd_dx_sm90", "mlp_bwd_dw_sm90",
                     "mlp_bwd_addend_bf16", "da_reduce", "mlp_bwd_rows_bf16",
                     "mlp_bwd_weights_bf16"):
            if part in name:
                return part
        return "other"

    L, n, d, f = 6, 256, 512, 2048
    M8 = 8 * n
    p6, p5 = ffw(L), ffw(L - 1)
    add = rn(n, d)
    rows = []
    for label, p, G, a, accumulate in (("k1_bwd_b8", p6, L, None, False),
                                       ("k1_bwd_add_b8", p5, L - 1, add, False),
                                       ("k1_bwd_acc_b8", p6, L, None, True),
                                       ("k1_bwd_acc_add_b8", p5, L - 1, add, True)):
        x8, g8 = rn(G, M8, d), rn(G, M8, d)
        pre8 = k1.fused_grouped_ffw_lm(p, x8, add=a, save_pre=True)[1]
        acc = da_in = None
        if accumulate:
            acc = GroupedFFWParams(*(torch.zeros(t.shape, device=dev) for t in p))
            da_in = torch.zeros(n, d, device=dev) if a is not None else None
        x_in = x8 if a is None else (x8.view(G, -1, n, d) + a).view(G, M8, d)
        rows.append((label, [G, M8, d], lambda p=p, x8=x8, g8=g8, a=a, pre8=pre8, acc=acc,
                     da_in=da_in: k1.grouped_mlp_bwd(p, x8, g8, add=a, pre=pre8, acc=acc,
                                                     da_in=da_in),
                     seq_bwd_ms(p, x_in, g8)))
    wcat, carry, dmean = k1.cat_params(p5, p6), rn(L + 1, M8, d), rn(L, M8, d)
    pre_cat = k1.fused_grouped_ffw_lm(wcat, carry, add=add, save_pre=True, cat=True)[1]
    acc_cat = GroupedFFWParams(*(torch.zeros(t.shape, device=dev) for t in wcat))
    da_cat = torch.zeros(n, d, device=dev)
    x_cat = torch.cat([(carry[2:].view(L - 1, -1, n, d) + add).view(L - 1, M8, d), carry[:L]])
    rows.append(("k1_bwd_acc_cat_b8", [2 * L - 1, M8, d],
                 lambda: k1.grouped_mlp_bwd(wcat, carry, dmean, add=add, pre=pre_cat,
                                            acc=acc_cat, da_in=da_cat, cat=True),
                 seq_bwd_ms(wcat, x_cat, torch.cat([dmean[:L - 1], dmean]))))
    for label, shape, run, seq_ms in rows:
        ms = time_ms(run)
        print(json.dumps(dict(timing=label, shape=shape, ms=ms, seq_bwd_ms=seq_ms,
                              tflops=8 * shape[0] * shape[1] * d * f / ms / 1e9,
                              device_us=device_us(run, key=kernel_key),
                              host_us=host_us(run))), flush=True)
    del rows, p6, p5, wcat, carry, dmean, pre_cat, acc_cat

    # The imagenet224-pod width (d = 1024, f = 4096): the plain backward
    # [12, 2048, 1024] and the loop's accumulating combined grid [23, 2048,
    # 1024], by pass.
    p12, p11, add_p = (pod_ffw(rn, GroupedFFWParams, Lp), pod_ffw(rn, GroupedFFWParams, Lp - 1),
                       rn(n, dp))
    x12, g12 = rn(Lp, 8 * n, dp), rn(Lp, 8 * n, dp)
    pre12 = k1.fused_grouped_ffw_lm(p12, x12, save_pre=True)[1]
    wcat = k1.cat_params(p11, p12)
    carry, dmean = rn(Lp + 1, 8 * n, dp), rn(Lp, 8 * n, dp)
    pre_cat = k1.fused_grouped_ffw_lm(wcat, carry, add=add_p, save_pre=True, cat=True)[1]
    acc_cat = GroupedFFWParams(*(torch.zeros(t.shape, device=dev) for t in wcat))
    da_cat = torch.zeros(n, dp, device=dev)
    x_cat = torch.cat([(carry[2:].view(Lp - 1, -1, n, dp) + add_p).view(Lp - 1, 8 * n, dp),
                       carry[:Lp]])
    for label, shape, run, seq_ms in (
            ("k1_bwd_pod_b8", [Lp, 8 * n, dp],
             lambda: k1.grouped_mlp_bwd(p12, x12, g12, pre=pre12), seq_bwd_ms(p12, x12, g12)),
            ("k1_bwd_acc_cat_pod_b8", [2 * Lp - 1, 8 * n, dp],
             lambda: k1.grouped_mlp_bwd(wcat, carry, dmean, add=add_p, pre=pre_cat, acc=acc_cat,
                                        da_in=da_cat, cat=True),
             seq_bwd_ms(wcat, x_cat, torch.cat([dmean[:Lp - 1], dmean])))):
        ms = time_ms(run)
        print(json.dumps(dict(timing=label, shape=shape, f=fp, ms=ms, seq_bwd_ms=seq_ms,
                              tflops=8 * shape[0] * shape[1] * dp * fp / ms / 1e9,
                              device_us=device_us(run, key=kernel_key))), flush=True)
    return 0


def probe_k2(torch, rn, time_ms, host_us, device_us) -> int:
    import glom_tpu_torch.kernels.consensus_update as k2

    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = k2._lib()

    def kernel_key(name):
        return "khat" if "khat" in name else "main" if "consensus_update" in name else "other"

    # Readings behind the card tests' bars, over their bf16 cases, both
    # attend_self and seeds 0-7: the largest |got - want| / (atol + rtol
    # |want|) of out and cons at K2_BARS, and the atol each would need at
    # K2_BARS's rtol, max(|got - want| - rtol |want|).
    import numpy as np

    cards = card_tests()
    cases = [c[1:] for c in cards.K2_CASES if c[0] == torch.bfloat16]
    cases += [(3, 2, 96, 1, d, 0.0) for d in cards.K2_WIDTHS]
    rtol, atol = cards.K2_BARS[torch.bfloat16]
    worst = {}
    for L, B, n, side, d, radius in cases:
        for attend_self in (False, True):
            kw = dict(side=side, radius=radius, attend_self=attend_self, cons=True)
            for seed in range(8):
                lv, bu, td = (t.to("cuda") for t in cards._consensus_inputs(
                    np.random.default_rng(seed), L, B, n, d, torch.bfloat16))
                got = k2.fused_consensus_update(lv, bu, td, **kw)
                want = k2.consensus_update_plain(lv, bu, td, **kw)
                for name, i in (("out", 0), ("cons", 3)):
                    diff = (got[i].float() - want[i].float()).abs()
                    scale = rtol * want[i].float().abs()
                    key = (name, L, B, n, d, side, radius, attend_self)
                    ratio = float((diff / (atol + scale)).max())
                    need = float((diff - scale).max())
                    old = worst.get(key, (0.0, 0.0))
                    worst[key] = (max(old[0], ratio), max(old[1], need))
    for name in ("out", "cons"):
        rows = sorted(((v, k) for k, v in worst.items() if k[0] == name), reverse=True)
        print(json.dumps(dict(
            reading=name, bars=[rtol, atol], seeds=8, max_ratio=rows[0][0][0],
            max_atol_needed=max(v[1] for v, _ in rows),
            worst_cases=[dict(ratio=v[0], atol_needed=v[1], case=k[1:]) for v, k in rows[:4]])),
            flush=True)

    for label, (L, B, n), side, cons in (
            ("k2_b1", (6, 1, 256), 16, False), ("k2_b8", (6, 8, 256), 16, False),
            ("k2_long_row", (2, 1, 4096), 64, False),
            ("k2_fwd_cons_longrow", (6, 2, 4096), 64, True)):
        d, reps = 512, 5 if cons else 20
        lv, bu, td = rn(L, B, n, d, scale=8.0), rn(L, B, n, d), rn(L - 1, B, n, d)
        kw = dict(side=side, stats=cons, cons=cons)

        def call():
            return k2.fused_consensus_update(lv, bu, td, **kw)

        def allocs():
            return (torch.empty_like(lv), lv.new_empty((L, B, n, 1), dtype=torch.float32),
                    lv.new_empty((L, B, n, 1), dtype=torch.float32),
                    torch.empty_like(lv) if cons else None, k2.khat_scratch(lv))

        out, m, l, att, khat = allocs()
        stream = torch.cuda.current_stream().cuda_stream

        def bare():
            err = lib.consensus_update_fwd(
                lv.data_ptr(), bu.data_ptr(), td.data_ptr(), out.data_ptr(), m.data_ptr(),
                l.data_ptr(), att.data_ptr() if cons else None, khat.data_ptr(), L, B, n, d,
                side, 0.0, 0, 1, stream)
            assert err == 0, err

        q = lv.reshape(L * B, 1, n, d)
        kh = k2._normalized_k(lv).to(torch.bfloat16).reshape(L * B, 1, n, d)
        ms = time_ms(call, reps)
        print(json.dumps(dict(
            timing=label, shape=[L, B, n, d], ms=ms, sdpa_ms=time_ms(lambda: sdpa(q, kh, q), reps),
            tflops=4 * L * B * n * n * d / ms / 1e9, device_us=device_us(call, key=kernel_key),
            host_us=dict(call=host_us(call),
                         checks=host_us(lambda: k2.check_kernel_args(lv, bu, td, out, side=side,
                                                                     radius=0.0)),
                         allocs=host_us(allocs), bare_c_call=host_us(bare)))), flush=True)
    return 0


def probe_k2bwd(torch, rn, time_ms, host_us, device_us) -> int:
    import numpy as np

    import glom_tpu_torch.kernels.consensus_update as k2

    if hasattr(k2._bwd_lib(), "bwd_probe_read"):  # the stamped copy: phases only
        return wide_bwd_phases(torch, rn, np, k2)
    cards = card_tests()
    bar = cards.K2_BWD_BARS[torch.bfloat16]

    def rel(got, want):
        got, want = got.float(), want.float()
        return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))

    worst = {}
    for form in cards.K2_BWD_FORMS:
        for case in cards.K2_BWD_WGMMA_CASES:
            here = {}
            for attend_self in (False, True):
                for seed in range(8):
                    res = cards._k2_bwd_case(np.random.default_rng(seed), *case, attend_self,
                                             form)
                    for name, (got, want) in res.items():
                        here[name] = max(here.get(name, 0.0), rel(got, want) / bar)
            print(json.dumps(dict(reading="k2_bwd_bf16_case", form=form, case=list(case),
                                  bar=bar, max_bar_ratio=here)), flush=True)
            for name, r in here.items():
                if r >= worst.get((form, name), (-1.0,))[0]:
                    worst[(form, name)] = (r, list(case))
    for (form, name), (r, case) in sorted(worst.items()):
        print(json.dumps(dict(reading="k2_bwd_bf16", form=form, output=name, bar=bar, seeds=8,
                              max_bar_ratio=r, worst_case=case)), flush=True)
    fail = max(v[0] for v in worst.values()) > 1.0

    def kernel_key(name):
        for part in ("prepass", "dq_sm90", "dv_sm90", "dk_sm90", "khat"):
            if part in name:
                return part
        return "other"

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_bwd(lv, g):
        """SDPA's backward on q = levels, normalised k, v = levels (bf16,
        attend_self): its time and the kernels that ran it."""
        Lc, B, n, d = lv.shape
        q = lv.reshape(Lc * B, 1, n, d).clone().requires_grad_()
        kh = k2._normalized_k(lv).to(lv.dtype).reshape(Lc * B, 1, n, d).requires_grad_()
        v = lv.reshape(Lc * B, 1, n, d).clone().requires_grad_()
        att = sdpa(q, kh, v)
        go = g.reshape(Lc * B, 1, n, d)

        def run():
            return torch.autograd.grad(att, (q, kh, v), grad_outputs=go, retain_graph=True)

        return time_ms(run, reps=5 if n > 1024 else 20), list(device_us(run, calls=2))[:4]

    L, n, d, side = 6, 256, 512, 16
    lv, g = rn(L, 8, n, d, scale=8.0), rn(L, 8, n, d)
    _, m, l = k2.fused_consensus_update(lv, lv, lv[1:], side=side, stats=True)
    streams = dict(dx_bu=rn(L, 8, n, d), dx_td=rn(L - 1, 8, n, d))
    dq, dd, dcons = k2.consensus_bwd_dq(lv, g, m, l, side=side)
    lib_ms, lib_kernels = sdpa_bwd(lv, g)
    for label, run in (
            ("k2_bwd_dq_b8", lambda: k2.consensus_bwd_dq(lv, g, m, l, side=side)),
            ("k2_bwd_dkv_b8", lambda: k2.consensus_bwd_dkv(lv, g, m, l, dq, dd, dcons,
                                                             side=side)),
            ("k2_bwd_b8", lambda: k2.consensus_update_bwd(lv, g, m, l, side=side)),
            ("k2_bwd_combine_b8", lambda: k2.consensus_update_bwd(lv, g, m, l, side=side,
                                                                  combine=True, **streams))):
        ms = time_ms(run)
        print(json.dumps(dict(timing=label, shape=[L, 8, n, d], ms=ms, sdpa_bwd_ms=lib_ms,
                              sdpa_bwd_kernels=lib_kernels,
                              tflops_5_products=10 * L * 8 * n * n * d / ms / 1e9,
                              device_us=device_us(run, key=kernel_key),
                              host_us=host_us(run))), flush=True)
    Lr, Br, nr = 6, 2, 4096
    lv, g = rn(Lr, Br, nr, d, scale=8.0), rn(Lr, Br, nr, d)
    _, m, l, cons = k2.fused_consensus_update(lv, lv, lv[1:], side=64, cons=True)

    def onesweep():
        return k2.consensus_bwd_onesweep(lv, g, m, l, cons, side=64)

    ms = time_ms(onesweep, reps=5)
    lib_ms, lib_kernels = sdpa_bwd(lv, g)
    print(json.dumps(dict(timing="k2_bwd_onesweep_longrow", shape=[Lr, Br, nr, d], ms=ms,
                          sdpa_bwd_ms=lib_ms, sdpa_bwd_kernels=lib_kernels,
                          tflops_5_products=10 * Lr * Br * nr * nr * d / ms / 1e9,
                          device_us=device_us(onesweep, calls=2, key=kernel_key),
                          host_us=host_us(onesweep, batches=3, calls=3))), flush=True)
    return int(fail) | probe_k2bwd_wide(torch, rn, time_ms, device_us, np, k2, cards, rel,
                                        sdpa_bwd)


def probe_k2bwd_wide(torch, rn, time_ms, device_us, np, k2, cards, rel, sdpa_bwd) -> int:
    """k2bwd's "wgmma_wide" part: readings over the wide cases, then device
    times by kernel at the imagenet224-pod width beside SDPA's backward."""
    bar = cards.K2_BWD_BARS[torch.bfloat16]
    worst = {}
    for form in cards.K2_BWD_FORMS:
        for case in cards.K2_BWD_WIDE_CASES:
            for attend_self in (False, True):
                for seed in range(8):
                    res = cards._k2_bwd_case(np.random.default_rng(seed), *case, attend_self,
                                             form)
                    for name, (got, want) in res.items():
                        r = rel(got, want) / bar
                        if r >= worst.get((form, name), (-1.0,))[0]:
                            worst[(form, name)] = (r, list(case))
    for (form, name), (r, case) in sorted(worst.items()):
        print(json.dumps(dict(reading="k2_bwd_bf16_wide", form=form, output=name, bar=bar,
                              seeds=8, max_bar_ratio=r, worst_case=case)), flush=True)
    fail = max(v[0] for v in worst.values()) > 1.0

    def kernel_key(name):
        for part in ("prepass", "dq_wide", "dv_wide", "dk_wide", "finish_wide", "khat"):
            if part in name:
                return part
        return "other"

    d = 1024
    for label, (L, B, n), side, form in (
            ("k2_bwd_pod_b2", (12, 2, 256), 16, "pair"),
            ("k2_bwd_combine_pod_b8", (12, 8, 256), 16, "combine"),
            ("k2_bwd_onesweep_pod_width", (2, 1, 1024), 32, "onesweep")):
        lv, g = rn(L, B, n, d, scale=8.0), rn(L, B, n, d)
        if form == "onesweep":
            _, m, l, cons = k2.fused_consensus_update(lv, lv, lv[1:], side=side, cons=True)

            def run():
                return k2.consensus_bwd_onesweep(lv, g, m, l, cons, side=side)
        else:
            _, m, l = k2.fused_consensus_update(lv, lv, lv[1:], side=side, stats=True)
            kw = dict(side=side)
            if form == "combine":
                kw.update(combine=True, dx_bu=rn(L, B, n, d), dx_td=rn(L - 1, B, n, d))

            def run(kw=kw):
                return k2.consensus_update_bwd(lv, g, m, l, **kw)
        lib_ms, lib_kernels = sdpa_bwd(lv, g)
        ms = time_ms(run)
        print(json.dumps(dict(timing=label, shape=[L, B, n, d], ms=ms, sdpa_bwd_ms=lib_ms,
                              sdpa_bwd_kernels=lib_kernels,
                              tflops_5_products=10 * L * B * n * n * d / ms / 1e9,
                              device_us=device_us(run, key=kernel_key))), flush=True)
    return int(fail)


def wide_bwd_phases(torch, rn, np, k2) -> int:
    """The stamped copy's phases of the wide passes in cycles (median over
    the combine's blocks at [12, 8, 256, 1024])."""
    L, B, n, d = 12, 8, 256, 1024
    lv, g = rn(L, B, n, d, scale=8.0), rn(L, B, n, d)
    _, m, l = k2.fused_consensus_update(lv, lv, lv[1:], side=16, stats=True)
    k2.consensus_update_bwd(lv, g, m, l, side=16, combine=True, dx_bu=rn(L, B, n, d),
                            dx_td=rn(L - 1, B, n, d))
    torch.cuda.synchronize()
    stamps = np.zeros((3, 2048, 24), np.int64)
    lib = k2._bwd_lib()
    lib.bwd_probe_read.argtypes = [ctypes.c_void_p]
    if lib.bwd_probe_read(stamps.ctypes.data) != 0:
        print("k2bwd: bwd_probe_read failed", flush=True)
        return 1
    blocks = 4 * 2 * L * B
    for p, name in enumerate(("dq", "dv", "dk")):
        st = stamps[p, :blocks]
        phases = {"setup": np.median(st[:, 1] - st[:, 0])}
        for v in range(4):
            b = 2 + 3 * v
            nxt = st[:, b + 3] if v < 3 else st[:, 14]
            phases[f"tile{v}_scores"] = np.median(st[:, b + 1] - st[:, b])
            phases[f"tile{v}_exchange"] = np.median(st[:, b + 2] - st[:, b + 1])
            phases[f"tile{v}_accumulate"] = np.median(nxt - st[:, b + 2])
        phases["loop"] = np.median(st[:, 14] - st[:, 1])
        phases["epilogue"] = np.median(st[:, 15] - st[:, 14])
        if name == "dk":
            for key, a, b in (("norm_sums", 14, 16), ("dxn", 16, 17), ("stage", 17, 18),
                              ("rows", 18, 15)):
                phases[f"epilogue_{key}"] = np.median(st[:, b] - st[:, a])
        phases["block"] = np.median(st[:, 15] - st[:, 0])
        print(json.dumps({"case": f"k2_bwd_combine_pod_b8_{name}_phases_cycles",
                          **{k_: float(v_) for k_, v_ in phases.items()}}), flush=True)
    return 0


def card_tests():
    """tests/test_torch_port_gpu.py as a module: its cases, bars and inputs."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "card_cases", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                   "test_torch_port_gpu.py"))
    cards = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cards)
    return cards


def probe_k4(torch, rn, time_ms, host_us, device_us) -> int:
    import numpy as np

    import glom_tpu_torch.kernels.banded_consensus as k4

    f32, bf16 = torch.float32, torch.bfloat16
    cards = card_tests()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel_key(name):
        return "khat" if "khat" in name else "main" if "banded_consensus" in name else "other"

    # Readings behind the card tests' bf16 bars: per instance and input kind,
    # over every row span and the unused pages, seeds 0-7, both attend_self,
    # at K4_BARS (the largest ratio, and the atol each needs at its rtol) and
    # at the bar the tests hold the case to (k4_bars).
    rtol, atol = cards.K4_BARS[bf16]
    worst, worst_bar = {}, {}
    for pt, d, counts, pages in cards.K4_CASES:
        for inputs in cards.K4_INPUTS:
            for attend_self in (False, True):
                for seed in range(8):
                    lv, kw, spans, used = cards._k4_case(np.random.default_rng(seed), bf16, pt,
                                                         d, counts, pages, inputs, attend_self)
                    got = k4.banded_ragged_consensus(lv, **kw).float()
                    want = k4.banded_ragged_consensus_plain(lv, **kw).float()
                    for part, (a, b) in [("rows", ab) for ab in spans] + [
                            ("unused", (used, lv.shape[0]))]:
                        diff = (got[a:b] - want[a:b]).abs()
                        scale = rtol * want[a:b].abs()
                        key = (k4.k4_instance(bf16, pt, d), inputs, part, pt, attend_self)
                        bar = cards.k4_bars(bf16, pt, inputs)
                        worst_bar[key] = max(worst_bar.get(key, 0.0), float(
                            (diff / (bar[1] + bar[0] * want[a:b].abs())).max()))
                        ratio = float((diff / (atol + scale)).max())
                        need = float((diff - scale).max())
                        old = worst.get(key, (0.0, 0.0))
                        worst[key] = (max(old[0], ratio), max(old[1], need))
    for key, (ratio, need) in sorted(worst.items()):
        print(json.dumps(dict(reading="k4_bf16", instance=key[0], inputs=key[1], part=key[2],
                              page_tokens=key[3], attend_self=key[4], bars=[rtol, atol], seeds=8,
                              max_ratio=ratio, max_atol_needed=need,
                              test_bars=list(cards.k4_bars(bf16, key[3], key[1])),
                              max_ratio_test_bars=worst_bar[key])), flush=True)
    fail = max(worst_bar.values()) > 1.0

    lib = k4._lib()
    L, d, window = 6, 512, 256
    for label, pt, P, counts in (
            ("k4_ragged32_full", 64, 32, [256] * 8),
            ("k4_ragged32_mixed", 64, 32, [256, 144, 64, 16, 256, 49, 0, 256, 144, 64, 16, 256,
                                           49, 100, 16]),
            ("k4_pt128_full", 128, 16, [256] * 8)):
        rs, rl, _, used = cards._ragged_maps(counts, P, pt)
        lv = rn(P * pt, L, d, scale=2.0)
        kw = dict(row_start=rs.cuda(), row_len=rl.cuda(), window=window, page_tokens=pt)

        def call():
            return k4.banded_ragged_consensus(lv, **kw)

        out, khat = torch.empty_like(lv), k4.khat_scratch(lv, pt)
        inst = k4.K4_INSTANCES.index(k4.k4_instance(lv.dtype, pt, d))
        stream = torch.cuda.current_stream().cuda_stream

        def bare():
            err = lib.banded_consensus_fwd(lv.data_ptr(), out.data_ptr(), k4._ptr(khat),
                                           kw["row_start"].data_ptr(), kw["row_len"].data_ptr(),
                                           P, pt, L, d, window // pt, 0, 1, stream)
            assert err == 0, err

        # SDPA on the band gathered beforehand (attend_self, an additive
        # length mask), in f32 and in bf16.
        band0, len_page = k4.page_maps(kw["row_start"], kw["row_len"], pt)
        pages = (band0[:, None].long() + torch.arange(window // pt, device="cuda")).clamp(
            max=P - 1)
        kv = lv.float().view(P, pt, L, d)
        kn = kv / torch.linalg.vector_norm(kv, dim=-1, keepdim=True).clamp_min(1e-12)
        q_b = kv.permute(0, 2, 1, 3).contiguous()
        k_b = kn[pages].reshape(P, window, L, d).permute(0, 2, 1, 3).contiguous()
        v_b = kv[pages].reshape(P, window, L, d).permute(0, 2, 1, 3).contiguous()
        past = torch.arange(window, device="cuda")[None, :] >= len_page[:, None]
        mask = torch.zeros(P, 1, 1, window, device="cuda").masked_fill(
            past[:, None, None, :], float(torch.finfo(f32).min))
        qh, kh, vh = (t.to(bf16) for t in (q_b, k_b, v_b))
        mh = mask.clamp_min(torch.finfo(bf16).min).to(bf16)  # finite in bf16
        ms = time_ms(call)
        print(json.dumps(dict(
            timing=label, shape=[P * pt, L, d], page_tokens=pt, rows=counts,
            instance=k4.K4_INSTANCES[inst], ms=ms,
            sdpa_f32_ms=time_ms(lambda: sdpa(q_b, k_b, v_b, attn_mask=mask)),
            sdpa_bf16_ms=time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mh)),
            tflops=4 * P * pt * L * window * d / ms / 1e9,
            device_us=device_us(call, key=kernel_key),
            host_us=dict(call=host_us(call),
                         checks=host_us(lambda: k4.check_kernel_args(
                             lv, kw["row_start"], kw["row_len"], window, pt)),
                         allocs=host_us(lambda: (torch.empty_like(lv), k4.khat_scratch(lv, pt))),
                         bare_c_call=host_us(bare)))), flush=True)
    return int(fail)


def probe_k4f32(torch, rn, time_ms, host_us, device_us) -> int:
    import glom_tpu_torch.kernels.banded_consensus as k4
    from glom_tpu_torch.utils.helpers import TOKEN_ATTEND_SELF_VALUE

    f32, f64 = torch.float32, torch.float64
    rtol, atol = 2e-4, 2e-5  # K4's f32 bar (chip_smoke.py's k4_bars, the -m gpu tests')

    def plain64(levels, row_start, row_len, window, page_tokens, attend_self):
        """banded_ragged_consensus_plain with every step in f64."""
        T, L, d = levels.shape
        pt = page_tokens
        P, n_band = T // pt, window // pt
        band0, len_page = k4.page_maps(row_start, row_len, pt)
        kv = levels.to(f64)
        k = kv / torch.linalg.vector_norm(kv, dim=-1, keepdim=True).clamp_min(1e-12)
        raw = band0[:, None] + torch.arange(n_band, device="cuda", dtype=torch.int32)
        band = raw.clamp(max=P - 1).long()
        q = kv.view(P, pt, L, d)
        kb = k.view(P, pt, L, d)[band].reshape(P, window, L, d)
        vb = q[band].reshape(P, window, L, d)
        s = torch.einsum("pqld,pwld->pqlw", q, kb) * d ** -0.5
        if not attend_self:
            u = torch.arange(pt, device="cuda", dtype=torch.int32)
            slot = (raw[:, :, None] * pt + u).reshape(P, 1, window)
            tok = torch.arange(T, device="cuda", dtype=torch.int32).view(P, pt, 1)
            s = s.masked_fill((slot == tok)[:, :, None, :], TOKEN_ATTEND_SELF_VALUE)
        w = torch.arange(window, device="cuda", dtype=torch.int32)
        s = s.masked_fill((w[None, :] >= len_page[:, None])[:, None, None, :],
                          float(torch.finfo(f32).min))
        return torch.einsum("pqlw,pwld->pqld", torch.softmax(s, dim=-1), vb).reshape(T, L, d)

    def ratio(a, b):
        return float(((a - b).abs() / (atol + rtol * b.abs())).max())

    mix = [256, 144, 64, 16, 256, 49, 0, 256, 144, 64, 16, 256, 49, 100, 16]
    fail = False
    for label, pt, pages, counts, L, d in (("flagship", 64, 32, mix, 6, 512),
                                           ("pod", 64, 32, mix, 12, 1024),
                                           ("pod_pages16", 16, 12, [64, 37, 1, 16], 3, 1024)):
        T = pages * pt
        rs, rl = torch.zeros(T, dtype=torch.int32), torch.zeros(T, dtype=torch.int32)
        off = 0
        for c in counts:
            k_ = -(-c // pt)
            rs[off * pt:(off + k_) * pt], rl[off * pt:(off + k_) * pt] = off * pt, c
            off += k_
        rs[off * pt:] = off * pt
        gen = torch.Generator().manual_seed(3)
        coef, basis = torch.randn(T, L, 4, generator=gen), torch.randn(L, 4, d, generator=gen)
        lv = (4.0 * torch.einsum("tlr,lrd->tld", coef, basis)).contiguous().to("cuda")
        window = 256 if pt == 64 else 64
        for attend_self in (False, True):
            kw = dict(row_start=rs.cuda(), row_len=rl.cuda(), window=window, page_tokens=pt,
                      attend_self=attend_self)
            want64 = plain64(lv, **kw)
            p32 = k4.banded_ragged_consensus_plain(lv, **kw).to(f64)
            row = dict(reading="k4_f32_noise", shape=[T, L, d], page_tokens=pt,
                       attend_self=attend_self, bar=[rtol, atol],
                       plain_vs_f64_bar_ratio=ratio(p32, want64),
                       plain_vs_f64_max_abs=float((p32 - want64).abs().max()))
            try:
                got = k4.banded_ragged_consensus(lv, **kw).to(f64)
            except ValueError as e:
                row["kernel"] = f"refused: {e}"
            else:
                row.update(kernel_vs_plain_bar_ratio=ratio(got, p32),
                           kernel_vs_f64_bar_ratio=ratio(got, want64),
                           kernel_vs_f64_max_abs=float((got - want64).abs().max()))
                fail |= row["kernel_vs_plain_bar_ratio"] > 1.0
            print(json.dumps(dict(row, case=label)), flush=True)
    return int(fail)


def probe_pair(torch, rn, time_ms, host_us, device_us) -> int:
    import numpy as np

    import glom_tpu_torch.kernels.banded_consensus as k4
    import glom_tpu_torch.kernels.consensus_update as k2

    sdpa = torch.nn.functional.scaled_dot_product_attention
    key = (lambda name: "khat" if "khat" in name else "attention" if "_kernel" in name
           else "other")
    lv, bu, td = rn(12, 8, 256, 1024), rn(12, 8, 256, 1024), rn(11, 8, 256, 1024)
    q = lv.reshape(96, 1, 256, 1024)
    k = k2._normalized_k(lv).to(lv.dtype).reshape(96, 1, 256, 1024)

    def k2_call():
        return k2.fused_consensus_update(lv, bu, td, side=16)
    print(json.dumps({"case": "k2_pod_b8", "ms": time_ms(k2_call), "sdpa_ms": time_ms(
        lambda: sdpa(q, k, q)), "by_kernel_us": device_us(k2_call, key=key)}), flush=True)
    pt, P = 64, 32
    rs = (torch.arange(P * pt, dtype=torch.int32) // 256 * 256).to("cuda")
    rl = torch.full((P * pt,), 256, dtype=torch.int32, device="cuda")
    lv4 = rn(P * pt, 12, 1024, scale=2.0)
    kw = dict(row_start=rs, row_len=rl, window=256, page_tokens=pt)
    band = lv4.view(P // 4, 4 * pt, 12, 1024).permute(0, 2, 1, 3)  # each row's band: its pages
    kb = (band.float() / band.float().norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(lv4.dtype)
    print(json.dumps({"case": "k4_pod_ragged32_full", "ms": time_ms(
        lambda: k4.banded_ragged_consensus(lv4, **kw)), "sdpa_ms": time_ms(
        lambda: sdpa(band, kb, band)), "by_kernel_us": device_us(
        lambda: k4.banded_ragged_consensus(lv4, **kw), key=key)}), flush=True)
    lib = k2._lib()
    if not hasattr(lib, "probe_read"):  # the package as it stands: times only
        return 0
    k2_call()
    torch.cuda.synchronize()
    stamps = np.zeros((2048, 24), np.int64)
    lib.probe_read.argtypes = [ctypes.c_void_p]
    if lib.probe_read(stamps.ctypes.data) != 0:
        print("pair: probe_read failed", flush=True)
        return 1
    blocks = stamps[:768]
    phases = {"q_load": np.median(blocks[:, 1] - blocks[:, 0])}
    for it in range(4):
        b = 2 + 4 * it
        nxt = blocks[:, b + 4] if it < 3 else blocks[:, 18]
        for j, nm in enumerate(("scores", "exchange", "softmax", "pv")):
            end = blocks[:, b + j + 1] if j < 3 else nxt
            phases[f"tile{it}_{nm}"] = np.median(end - blocks[:, b + j])
    phases["epilogue"] = np.median(blocks[:, 19] - blocks[:, 18])
    phases["block"] = np.median(blocks[:, 19] - blocks[:, 0])
    print(json.dumps({"case": "k2_pod_b8_phases_cycles",
                      **{k_: float(v) for k_, v in phases.items()}}), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        return probe(sys.argv[2], os.path.abspath(sys.argv[3]))
    if len(sys.argv) < 2 or sys.argv[1] not in SOURCES:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    rc = 0
    for root in sys.argv[2:] or ["."]:
        print("== root", root, flush=True)
        if sys.argv[1] in ("pair", "k2bwd", "k1", "k1bwd"):  # times, then the stamped phases
            cmd = [sys.executable, os.path.abspath(__file__), "--child", sys.argv[1], root]
            rc |= subprocess.run(cmd, timeout=900).returncode
            stamped = {"pair": (PAIR_STAMPS, "attn_pair_loop", "sm90_attn.cuh"),
                       "k2bwd": (BWD_WIDE_STAMPS, "wide_pass", "consensus_update_bwd.cu"),
                       "k1": (GEMM_STAMPS, "gemm_problems", "sm90_gemm.cuh"),
                       "k1bwd": (GEMM_STAMPS, "gemm_problems", "sm90_gemm.cuh")}[sys.argv[1]]
            root = instrument(os.path.abspath(root), *stamped, f"kernel_probe_{sys.argv[1]}")
            if root is None:
                continue
        cmd = [sys.executable, os.path.abspath(__file__), "--child", sys.argv[1], root]
        rc |= subprocess.run(cmd, timeout=900).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
