"""Timing helpers shared by chip_smoke.py, port_ab.py and kernel_probe.py,
so the three read a kernel's device and host time the same way. Each needs
a CUDA device; the scripts call them only after checking for one.
"""

from __future__ import annotations

import statistics
import time

import torch


def time_ms(fn, reps: int = 20) -> float:
    """Device time a call in ms: CUDA events around `reps` calls enqueued
    back to back, after 3 warm-up calls (L2 warm)."""
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


def host_us(fn, batches: int = 9, calls: int = 20) -> float:
    """The host's time a call in us: `calls` calls enqueued back to back,
    far fewer than the launch queue holds; the median over `batches`
    batches, each started on an idle card."""
    fn()
    per_call = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def device_us_by_kernel(fn, calls: int = 5, key=None) -> dict:
    """Device time a call in us of each kernel `fn` launches
    (torch.profiler), by `key(kernel name)` (default: the name cut to 60
    characters), largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    key = key or (lambda name: name if len(name) <= 60 else name[:57] + "...")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            k = key(evt.name)
            us[k] = us.get(k, 0.0) + evt.time_range.elapsed_us() / calls
    return dict(sorted(us.items(), key=lambda kv: -kv[1]))
