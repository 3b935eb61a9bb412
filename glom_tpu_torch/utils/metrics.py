"""Metrics: the analytic FLOP model, MFU against the card's peak, the
live-bytes model, and the JSONL metrics writer.

Counterpart of `glom_tpu/utils/metrics.py`. The FLOP model is glom_tpu's:

  per column-update iteration, per image:
    bottom-up MLP : 2 matmuls over L groups   = 2 * n * L * d * (d*mult) * 2
    top-down  MLP : same over L-1 groups
    consensus     : 2 products, O(L * n^2 * d) = 2 * L * n * n * d * 2

A "column-iter" is one iteration's update of all n*L level vectors of one
image. MFU divides the model's FLOP rate by the card's published bf16
dense peak (NVIDIA's H100 data sheet); a card not in PEAK_FLOPS gives None.
The sharded per-replica byte counts (`tree_bytes_per_replica`) and the
gradient / update path's collective-traffic model (`comm_volume_model`)
are glom_tpu's analytics over the port's leaf names; the distributed
trainer stamps them beside its measured counters. `probe_device_count` is
the backend watchdog's probe (telemetry/watchdog.py).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path
from typing import Optional

from glom_tpu_torch.utils.config import GlomConfig


def flops_per_column_iter(cfg: GlomConfig) -> float:
    """FLOPs for one column-update iteration of ONE image (forward only)."""
    n, L, d, m = cfg.num_patches, cfg.levels, cfg.dim, cfg.mult
    ffw = lambda groups: 2 * 2 * n * groups * d * (d * m)  # two matmuls, MACs*2
    bottom_up = ffw(L)
    top_down = ffw(L - 1)
    consensus = 2 * 2 * L * n * n * d  # q k^T and attn @ v
    return float(bottom_up + top_down + consensus)


def tokens_flops(cfg: GlomConfig) -> float:
    """Patch embedding FLOPs per image (outside the loop)."""
    return float(2 * cfg.num_patches * cfg.patch_dim * cfg.dim)


# Published bf16 dense tensor-core peaks, FLOP/s per card (NVIDIA's H100
# data sheet, without sparsity, at the full power limit).
PEAK_FLOPS = {
    "h100-sxm": 989e12,
    "h100-pcie": 756e12,
    "h100-nvl": 835e12,
}


def detect_chip(device=None) -> Optional[str]:
    """The PEAK_FLOPS key of a CUDA device from its name; "cpu" for the
    CPU; None for a card the table does not know."""
    import torch

    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device).lower()
    if "h100" not in name:
        return None
    if "pcie" in name:
        return "h100-pcie"
    if "nvl" in name:
        return "h100-nvl"
    return "h100-sxm"  # "NVIDIA H100 80GB HBM3" is the SXM part


def mfu(
    cfg: GlomConfig,
    column_iters_per_sec: float,
    *,
    chip: Optional[str] = "h100-sxm",
    backward: bool = False,
) -> Optional[float]:
    """Model FLOP utilization from measured column-iters/sec per card, or
    None for a chip with no published peak here (the CPU included)."""
    peak = PEAK_FLOPS.get(chip)
    if peak is None:
        return None
    f = flops_per_column_iter(cfg)
    if backward:
        f *= 3.0  # fwd + ~2x bwd
    return column_iters_per_sec * f / peak


def tree_bytes(tree) -> int:
    """Bytes of every tensor or array in a nested structure of tuples,
    lists and dicts (meta tensors count by shape and dtype)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if hasattr(tree, "element_size"):  # a torch.Tensor
        return tree.nelement() * tree.element_size()
    if hasattr(tree, "nbytes"):  # a numpy array or scalar
        return int(tree.nbytes)
    return 0


def _spec_divisor(spec, axis_sizes: dict) -> int:
    """How many ways a spec (a tuple of axis names or None) splits a leaf."""
    div = 1
    for entry in spec or ():
        if entry is not None:
            div *= int(axis_sizes.get(entry, 1))
    return div


def tree_bytes_per_replica(tree, spec_tree, axis_sizes: dict) -> int:
    """Live bytes of a tree PER REPLICA under a spec tree: each leaf's
    global bytes divided by the ways its spec splits it. `tree` nests
    dicts keyed like `spec_tree` (the port's dotted leaf names, and
    sharding.opt_state_specs' per-leaf entries) over tensors, meta tensors
    included; `spec_tree=None` is fully replicated. Pure analytics: no
    device needed."""
    if isinstance(tree, dict):
        return sum(
            tree_bytes_per_replica(v, None if spec_tree is None else spec_tree[k], axis_sizes)
            for k, v in tree.items()
        )
    return tree_bytes(tree) // _spec_divisor(spec_tree, axis_sizes)


def live_bytes_model(
    params, opt_state, *, axis_sizes=None, param_specs=None, opt_specs=None, grad_specs=None
) -> dict:
    """Live bytes of the three train-state tenants a replica holds: the
    params, the gradient buffer (one per param), and the optimizer state
    (glom_tpu's fields). On one device (no `axis_sizes`) a replica holds
    everything; across ranks each tenant divides by its spec tree (the
    same specs the distributed trainer shards with): params by the TP
    layout, the gradient buffer by the ZeRO layout at stage 2, the
    optimizer moments by it from stage 1."""
    if axis_sizes is None:
        params_bytes = tree_bytes(params)
        return {
            "params_bytes_per_replica": params_bytes,
            "grads_bytes_per_replica": params_bytes,
            "opt_bytes_per_replica": tree_bytes(opt_state),
        }
    return {
        "params_bytes_per_replica": tree_bytes_per_replica(params, param_specs, axis_sizes),
        "grads_bytes_per_replica": tree_bytes_per_replica(params, grad_specs, axis_sizes),
        "opt_bytes_per_replica": tree_bytes_per_replica(opt_state, opt_specs, axis_sizes),
    }


def comm_volume_model(
    grad_bytes: int,
    param_bytes: int,
    dp: int,
    zero_stage: int,
    *,
    quantized: bool = False,
    grad_accum: int = 1,
) -> dict:
    """Per-replica per-step collective wire bytes of the gradient / update
    path (ring-algorithm costs; SP and TP collectives are not priced here):

      stage 0 -- one all-reduce of the full gradient: 2*(dp-1)/dp * G
      stage 1 -- reduce-scatter G + all-gather P: (dp-1)/dp * (G + P)
      stage 2 -- the reduce-scatter runs once PER MICROBATCH (that keeps
                 the accumulator sharded): (dp-1)/dp * (accum * G + P)

    The quantized reduce carries the gradient as int8 + block scales
    (G/4 + G/512); the param all-gather stays f32."""
    from glom_tpu_torch.parallel.quantized import DEFAULT_BLOCK

    if dp <= 1:
        return {"comm_reduce_bytes_per_step": 0, "comm_gather_bytes_per_step": 0,
                "comm_bytes_per_step": 0}
    frac = (dp - 1) / dp
    wire_grad = grad_bytes
    if quantized:
        elems = grad_bytes // 4
        wire_grad = elems + (-(-elems // DEFAULT_BLOCK)) * 4
    if zero_stage == 0:
        reduce_bytes = int(2 * frac * wire_grad)
        gather_bytes = 0
    else:
        n_scatters = grad_accum if zero_stage >= 2 else 1
        reduce_bytes = int(frac * wire_grad * n_scatters)
        gather_bytes = int(frac * param_bytes)
    return {
        "comm_reduce_bytes_per_step": reduce_bytes,
        "comm_gather_bytes_per_step": gather_bytes,
        "comm_bytes_per_step": reduce_bytes + gather_bytes,
    }


# The probe's child: the device count of one device type, printed.
_PROBE_CODE = {
    "cuda": "import torch\nprint('DEVCOUNT=%d' % torch.cuda.device_count())",
    "cpu": "print('DEVCOUNT=1')",
}


def probe_device_count(timeout: float = 120.0, device_type: str = "cuda") -> Optional[int]:
    """The visible device count of `device_type` ("cuda": the CUDA devices,
    "cpu": 1) from a THROWAWAY subprocess, or None when it fails or hangs
    past `timeout` (glom_tpu's probe). Nothing touches a device in the
    calling process: a wedged driver hangs the child, which the timeout
    kills, never the caller."""
    import subprocess

    if device_type not in _PROBE_CODE:
        raise ValueError(f"device_type={device_type!r}: one of {sorted(_PROBE_CODE)}")
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE_CODE[device_type]],
                              capture_output=True, text=True, timeout=timeout)
    except (subprocess.TimeoutExpired, OSError):
        return None
    if proc.returncode != 0:
        return None
    for line in proc.stdout.splitlines():
        if line.startswith("DEVCOUNT="):
            return int(line.split("=", 1)[1])
    return None


class MetricsWriter:
    """Append-only JSONL metrics log, one stamped dict per line, with wall
    time.

    Every record is stamped with the versioned event schema
    (telemetry/schema.py: schema_version + kind, inferred when the caller
    did not stamp) and fed to the crash flight recorder's ring.
    `tensorboard_dir` also mirrors numeric scalars to TensorBoard through
    torch.utils.tensorboard; records carrying a `step` key are written at
    that step, others at an internal counter. The JSONL file stays the
    artifact of record."""

    def __init__(
        self,
        path: Optional[str] = None,
        echo: bool = True,
        tensorboard_dir: Optional[str] = None,
    ):
        self.path = Path(path) if path else None
        self.echo = echo
        self._t0 = time.time()
        self._seq = 0
        # Several threads may write into one stream (the fit loop, the
        # prefetch worker's rollups, a SIGTERM hook's records): no JSONL
        # row may interleave mid-line.
        self._lock = threading.Lock()
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter  # deferred: heavy import
            except ImportError as e:
                raise ImportError(
                    "tensorboard_dir requires the optional `tensorboard` "
                    "package; JSONL metrics work without it"
                ) from e
            self._tb = SummaryWriter(tensorboard_dir)
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")
        else:
            self._fh = None

    def write(self, metrics: dict):
        from glom_tpu_torch.telemetry import schema
        from glom_tpu_torch.tracing.flight import observe_event

        rec = schema.stamp({"wall_time": round(time.time() - self._t0, 3), **metrics})
        observe_event(rec)
        line = json.dumps(rec)
        with self._lock:
            if self._fh:
                self._fh.write(line + "\n")
                self._fh.flush()
            if self.echo:
                sys.stdout.write(line + "\n")
                sys.stdout.flush()
        # The tensorboard writer is tested under the lock: close() clears it
        # under the same lock, so a write racing a close skips the mirror.
        with self._lock:
            if self._tb is None:
                return
            scalars = {
                k: float(v)
                for k, v in rec.items()
                if isinstance(v, (int, float))
                and not isinstance(v, bool)
                and k != "schema_version"  # constant stamp, not a signal
            }
            step = int(scalars.pop("step", self._seq))
            self._seq = step + 1
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None
            if self._tb is not None:
                self._tb.close()
                self._tb = None
