"""Perf reporting: the MFU rollup and the rolling step timer.

Counterpart of `glom_tpu/tracing/report.py`, on the analytic FLOP model
and the card peaks of utils/metrics.py.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from glom_tpu_torch.utils.config import GlomConfig
from glom_tpu_torch.utils.metrics import flops_per_column_iter, mfu


def perf_report(
    cfg: GlomConfig,
    *,
    column_iters_per_sec: float,
    chip: Optional[str] = "h100-sxm",
    num_chips: int = 1,
    backward: bool = False,
) -> dict:
    """The north-star metrics dict from a measured rate (mfu None for a
    chip with no published peak)."""
    return {
        "column_iters_per_sec_per_chip": column_iters_per_sec / num_chips,
        "flops_per_column_iter": flops_per_column_iter(cfg),
        "mfu": mfu(cfg, column_iters_per_sec / num_chips, chip=chip, backward=backward),
        "chip": chip,
        "num_chips": num_chips,
    }


class StepTimer:
    """Rolling wall-clock step timer. `stop(sync)` first waits for the
    device that `sync` (a tensor) lies on, when that is a CUDA device."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.history: list[float] = []

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync=None) -> float:
        if torch.is_tensor(sync) and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        dt = time.perf_counter() - self._t0
        self.history.append(dt)
        return dt

    @property
    def best(self) -> float:
        return min(self.history)
