"""Timing helpers for chained device work.

Counterpart of `glom_tpu/utils/timing.py`. Each timed call ends in
`torch.cuda.synchronize()` when its result lies on a CUDA device (PyTorch
returns before the device finishes, so a host clock without it measures the
enqueue), and in nothing when it lies on the CPU. A fixed per-call cost
(launch, synchronise) is not device throughput, so `calibrated_chain_time`
times K ops chained inside one call (each op reading the last one's result,
so none can be skipped or overlapped) and computes

    per_op = (t_chain - t_rtt) / K

with t_rtt measured on a trivial op just before the chain.
"""

from __future__ import annotations

import math
import time

import torch


def _sync(out) -> None:
    if torch.is_tensor(out) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def _check_finite(out) -> None:
    value = float(out)
    if not math.isfinite(value):
        raise RuntimeError(f"non-finite benchmark output: {value}")


def best_fetch_time(fn, *args, repeats: int = 6) -> float:
    """Min wall time of `fn(*args)` (a scalar tensor or number) over
    `repeats`, each ending in the device synchronise, after a warm call.
    Min, not mean: jitter and throttling only ever slow things down. Every
    result is checked finite outside the timed region."""
    warm = fn(*args)
    _sync(warm)
    _check_finite(warm)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        times.append(time.perf_counter() - t0)
        _check_finite(out)
    return min(times)


def measure_rtt(example: torch.Tensor, repeats: int = 6) -> float:
    """Fixed launch + synchronise cost of one call: a trivial scalar
    derived from `example` (data-dependent, so nothing can skip it)."""
    return best_fetch_time(lambda x: x.sum() * 1e-30 + 1.0, example, repeats=repeats)


def calibrated_chain_time(
    chain,
    rtt_example: torch.Tensor,
    *,
    repeats: int = 6,
    calib_k: int = 32,
    target_s: float = 1.0,
    max_k: int = 50_000,
) -> float:
    """Per-iteration time of `chain(k) -> scalar`: estimate the per-op cost
    from a short calibration chain, size k to put about target_s of work in
    the measured chain, and return (t_chain - rtt) / k, with the RTT
    measured again right before the measured chain."""

    def best(k):
        return best_fetch_time(chain, k, repeats=repeats)

    rtt0 = measure_rtt(rtt_example, repeats=repeats)
    t_calib = best(calib_k)
    per_est = max((t_calib - rtt0) / calib_k, 1e-7)
    k = int(min(max(target_s / per_est, calib_k), max_k))
    rtt = measure_rtt(rtt_example, repeats=repeats)
    per = (best(k) - rtt) / k
    if per <= 0:
        raise RuntimeError(f"degenerate chain timing: k={k} rtt={rtt:.4f}")
    return per
