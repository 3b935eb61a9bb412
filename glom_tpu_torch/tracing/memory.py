"""Device-memory accounting: the card's allocator watermarks reconciled
against the analytic live-bytes model.

Counterpart of `glom_tpu/tracing/memory.py`. `utils/metrics.live_bytes_model`
prices the train state's live bytes from shapes; this module reads the
other side, PyTorch's CUDA caching allocator (`torch.cuda.memory_stats`:
`allocated_bytes.all.current` and `.peak`, and the card's `total_memory` as
the limit), and stamps the reconciliation on every logging record:

    hbm_model_drift = (hbm_bytes_in_use - model_live_bytes) / model_live_bytes

Between steps the drift is the allocator's other tenants (scratch, cached
kernels' workspaces, the data pipeline's staged batches); the gap to
`hbm_peak_bytes` during a step is the activation working set. A drift that
grows step over step is a leak; a peak near `hbm_bytes_limit` explains the
next out-of-memory before it happens.

A CPU device has no allocator stats and gives {}. On the card a failed read
raises: glom_tpu swallows every exception here, but a card whose
allocator cannot be read is a fault to surface, not a record to drop.
"""

from __future__ import annotations

from typing import Optional

import torch

# memory_stats key -> stamped record field.
_STAT_FIELDS = (
    ("allocated_bytes.all.current", "hbm_bytes_in_use"),
    ("allocated_bytes.all.peak", "hbm_peak_bytes"),
)


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_memory_stats(device=None) -> Optional[dict]:
    """The allocator's stats for `device` (default: the current card), or
    None for a CPU device."""
    device = _device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device)


def hbm_watermarks(device=None) -> dict:
    """The stamped watermark fields that exist, with the card's memory as
    the limit; {} for a CPU device."""
    device = _device(device)
    stats = device_memory_stats(device)
    if stats is None:
        return {}
    out = {dst: int(stats[src]) for src, dst in _STAT_FIELDS if src in stats}
    out["hbm_bytes_limit"] = int(torch.cuda.get_device_properties(device).total_memory)
    return out


def memory_record(model_live_bytes: Optional[int] = None, device=None) -> dict:
    """Watermarks + the model reconciliation for a metrics record; {} for
    a CPU device."""
    out = hbm_watermarks(device)
    if model_live_bytes and model_live_bytes > 0 and "hbm_bytes_in_use" in out:
        out["hbm_model_live_bytes"] = int(model_live_bytes)
        out["hbm_model_drift"] = round(
            (out["hbm_bytes_in_use"] - model_live_bytes) / model_live_bytes, 6)
    return out


def model_live_bytes_total(static_record: dict) -> int:
    """The analytic live-bytes total the drift reconciles against: the
    three train-state tenants the trainers stamp (live_bytes_model's keys)."""
    return int(
        static_record.get("params_bytes_per_replica", 0)
        + static_record.get("grads_bytes_per_replica", 0)
        + static_record.get("opt_bytes_per_replica", 0)
    )
