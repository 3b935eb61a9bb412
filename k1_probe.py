#!/usr/bin/env python3
"""Check and time the port's bf16 K1 forward on one NVIDIA GPU, quickly.

    python3 k1_probe.py [ROOT]

ROOT (default ".") holds the `glom_tpu_torch/` to probe, so a copy of the
package with one change can be held against this one in one run on the card.
It builds `csrc/grouped_mlp.cu` (printing ptxas' registers and spills),
then:

  * a structured check: x = identity rows, w1[k, n] = (k % 16) * 16 + n % 16,
    b1 = 0, so the pre-only output must equal w1 element for element (a
    wrong operand layout shows which element landed where);
  * the forward (out and the saved pre) against the plain version at the
    bf16 bars (rtol 1e-2, atol 1.6e-2), with and without the addend, at
    small, edge (M not a multiple of 128, d = 64, f = 192) and flagship
    shapes; out with and without the pre store, and the pre-only launch
    against the saved pre, bit for bit;
  * CUDA-event times (20 launches after 3, L2 warm) of the forward, the
    pre-only launch and `torch.baddbmm` at bucket 8 (bottom-up [6, 2048,
    512], top-down [5, 2048, 512] with the addend), of the forward at bucket
    1, and of the combined 11-group grid (forward with the saved pre, and
    pre-only);
  * device time by kernel (torch.profiler, 10 launches) of the bucket-8
    bottom-up forward and the combined forward with the saved pre.

Inputs come from seed 0. It exits nonzero without a card.
"""
import json
import os
import sys
import time

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, root)
import torch  # noqa: E402

import glom_tpu_torch.kernels.grouped_mlp as k1  # noqa: E402
from glom_tpu_torch.kernels import _build  # noqa: E402
from glom_tpu_torch.ops.ffw import GroupedFFWParams  # noqa: E402

if not torch.cuda.is_available():
    print("k1_probe: no CUDA device is available", file=sys.stderr)
    sys.exit(1)
assert k1.__file__.startswith(root), k1.__file__
t0 = time.perf_counter()
logs = _build.prebuild(["grouped_mlp"])
print("build_s", time.perf_counter() - t0, flush=True)
for ln in logs["grouped_mlp"].splitlines():
    if any(k in ln for k in ("registers", "spill", "error", "warning", "Function properties", "bytes stack")):
        print("  ", ln.strip())
dev, bf16 = torch.device("cuda", 0), torch.bfloat16
gen = torch.Generator().manual_seed(0)


def rn(*s, scale=1.0):
    return (torch.randn(*s, generator=gen) * scale)


# 1. structured: x = identity rows, w1[k, n] = (k%16)*16 + n%16, b1 = 0.
G, M, d, f = 1, 128, 128, 256
x = torch.zeros(G, M, d)
for r in range(M):
    x[0, r, r % d] = 1.0
kk = torch.arange(d)[:, None] % 16
nn = torch.arange(f)[None, :] % 16
w1 = (kk * 16 + nn).float()[None].clone()
params = GroupedFFWParams(w1.to(dev, bf16), torch.zeros(G, f, device=dev, dtype=bf16),
                          rn(G, f, d, scale=f ** -0.5).to(dev, bf16),
                          torch.zeros(G, d, device=dev, dtype=bf16))
xd = x.to(dev, bf16)
try:
    pre = k1.grouped_mlp_pre(params, xd)
    torch.cuda.synchronize()
    want = k1.grouped_mlp_pre_plain(params, xd)
    bad = (pre.float() != want.float())
    print("identity pre: mismatches", int(bad.sum()), "of", bad.numel(), flush=True)
    if bad.any():
        g = pre[0].float().cpu()
        print("got rows 0..9 cols 0..17 (value = (k%16)*16 + n%16):")
        for r in list(range(10)) + [64, 65, 72]:
            print(r, [int(v) for v in g[r, :18]])
        print("cols 60..70 of row 0:", [int(v) for v in g[0, 60:70]])
        print("row 0 col 128..136:", [int(v) for v in g[0, 128:136]])
except Exception as e:  # noqa: BLE001
    print("identity pre raised", repr(e), flush=True)
    raise

# 2. random shapes: fwd + pre vs plain, both with and without the addend.
bars = (1e-2, 1.6e-2)


def check(tag, G, M, d, f, n, add_on, cat=False):
    p = GroupedFFWParams(rn(G, d, f, scale=d ** -0.5), rn(G, f, scale=0.1),
                         rn(G, f, d, scale=f ** -0.5), rn(G, d, scale=0.1))
    p = GroupedFFWParams(*(t.to(dev, bf16) for t in p))
    x = rn(G, M, d).to(dev, bf16)
    add = rn(n, d).to(dev, bf16) if add_on else None
    out, pre = k1.fused_grouped_ffw_lm(p, x, add=add, save_pre=True)
    out2 = k1.fused_grouped_ffw_lm(p, x, add=add)
    po = k1.grouped_mlp_pre(p, x, add=add)
    torch.cuda.synchronize()
    want_out, want_pre = k1.grouped_mlp_plain(p, x, add, save_pre=True)
    res = {}
    for name, got, want in (("out", out, want_out), ("pre", pre, want_pre)):
        diff = (got.float() - want.float()).abs()
        ratio = float((diff / (bars[1] + bars[0] * want.float().abs())).max())
        res[name] = dict(max_abs=float(diff.max()), ratio=ratio)
        if ratio > 1:
            bad = diff > (bars[1] + bars[0] * want.float().abs())
            idx = bad.nonzero()[:5].tolist()
            res[name]["first_bad"] = idx
            rows = bad.any(dim=2).any(dim=0).nonzero().flatten()
            cols = bad.any(dim=1).any(dim=0).nonzero().flatten()
            res[name]["bad_rows"] = [int(rows.min()), int(rows.max()), int(rows.numel())]
            res[name]["bad_cols"] = [int(cols.min()), int(cols.max()), int(cols.numel())]
    res["out_equal_nosave"] = bool(torch.equal(out, out2))
    res["pre_only_equal"] = bool(torch.equal(po, pre))
    print(tag, json.dumps(res), flush=True)


for args in [("small", 3, 256, 128, 512, 64, False), ("small_add", 3, 256, 128, 512, 64, True),
             ("edge_2080", 2, 2080, 64, 192, 32, False), ("edge_2112_add", 2, 2112, 64, 192, 64, True),
             ("flag_bu", 6, 2048, 512, 2048, 256, False), ("flag_td", 5, 2048, 512, 2048, 256, True),
             ("d64f256", 3, 64, 64, 256, 64, True)]:
    try:
        check(*args)
    except Exception as e:  # noqa: BLE001
        print(args[0], "raised", repr(e), flush=True)

# 3. timing at the flagship


def time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


L, n, d, f = 6, 256, 512, 2048
for which, G, addon in (("bu", L, False), ("td", L - 1, True)):
    p = GroupedFFWParams(*(t.to(dev, bf16) for t in (rn(G, d, f, scale=d ** -0.5), rn(G, f, scale=0.1),
                                                     rn(G, f, d, scale=f ** -0.5), rn(G, d, scale=0.1))))
    x = rn(G, 2048, d).to(dev, bf16)
    add = rn(n, d).to(dev, bf16) if addon else None
    print(which, "fwd_ms", time_ms(lambda: k1.fused_grouped_ffw_lm(p, x, add=add)),
          "pre_ms", time_ms(lambda: k1.grouped_mlp_pre(p, x, add=add)),
          "baddbmm_ms", time_ms(lambda: torch.baddbmm(p.b1[:, None], x, p.w1)), flush=True)

# b1 and the cat grid
p6 = GroupedFFWParams(*(t.to(dev, bf16) for t in (rn(6, d, f, scale=d ** -0.5), rn(6, f, scale=0.1),
                                                  rn(6, f, d, scale=f ** -0.5), rn(6, d, scale=0.1))))
p5 = GroupedFFWParams(*(t.to(dev, bf16) for t in (rn(5, d, f, scale=d ** -0.5), rn(5, f, scale=0.1),
                                                  rn(5, f, d, scale=f ** -0.5), rn(5, d, scale=0.1))))
x1 = rn(6, 256, d).to(dev, bf16)
print("b1 fwd_ms", time_ms(lambda: k1.fused_grouped_ffw_lm(p6, x1)), flush=True)
wcat = k1.cat_params(p5, p6)
carry = rn(7, 2048, d).to(dev, bf16)
add = rn(n, d).to(dev, bf16)
print("cat fwd_save_pre_ms", time_ms(lambda: k1.fused_grouped_ffw_lm(wcat, carry, add=add, save_pre=True, cat=True)),
      "cat pre_ms", time_ms(lambda: k1.grouped_mlp_pre(wcat, carry, add=add, cat=True)), flush=True)

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

x8 = rn(6, 2048, d).to(dev, bf16)
for tag, fn in (("bu", lambda: k1.fused_grouped_ffw_lm(p6, x8)),
                ("cat_save_pre", lambda: k1.fused_grouped_ffw_lm(wcat, carry, add=add, save_pre=True, cat=True))):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    us = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            key = evt.name[:60]
            us[key] = us.get(key, 0.0) + evt.time_range.elapsed_us() / 10
    print("profile", tag, json.dumps({k: round(v, 1) for k, v in us.items()}), flush=True)
