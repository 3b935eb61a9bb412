"""The inference engine: params plus one forward per batch bucket.

Counterpart of `glom_tpu/serve/engine.py` `InferenceEngine`, fixed
iteration route only. Callers pad each batch to a bucket size; `warmup`
runs every bucket once before traffic (on the card that builds the kernels
and the allocator's pools), and `infer` answers one padded batch. Every
row of a fixed-route dispatch is "converged" with `row_iters` = T, as in
the reference (engine.py:494-500).

Not ported yet (ROADMAP queue A item 7): the early-exit route
(`iters="auto"`), warm continuation budgets, paged and ragged state,
retry and telemetry; meshes are item 8. Asking for any of them raises
NotImplementedError.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from glom_tpu_torch.models.core import GlomParams, glom_forward, init_glom, map_params
from glom_tpu_torch.utils.config import GlomConfig, ServeConfig
from glom_tpu_torch.utils.helpers import resolve_device, resolve_dtype

_NOT_PORTED = "is not ported yet: ROADMAP queue A item 7"


class ServeResult(NamedTuple):
    """One dispatched batch's outcome. `levels` is the full padded
    [bucket, n, L, d] state on the engine's device (callers slice their
    valid rows); `iters_run` is the fixed budget; `latency_s` is the
    dispatch-to-result wall time, ending in a device synchronize.
    `compiled` is True on the signature's first dispatch (the one that paid
    the kernel build when warmup did not). The fixed route marks every row
    converged at `iters_run`."""

    levels: torch.Tensor
    iters_run: int
    latency_s: float
    bucket: int
    compiled: bool
    row_converged: Optional[np.ndarray] = None
    row_iters: Optional[np.ndarray] = None
    levels0_h2d_bytes: int = 0
    phases: Optional[dict] = None


class InferenceEngine:
    """Owns params and answers padded bucket batches on one device."""

    def __init__(
        self,
        cfg: GlomConfig,
        scfg: Optional[ServeConfig] = None,
        *,
        params: Optional[GlomParams] = None,
        generator: Optional[torch.Generator] = None,
        device="cuda",
        name: str = "engine0",
        writer=None,
        retry=None,
        fault_hook=None,
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "InferenceEngine(mesh=...) is not ported yet: ROADMAP queue A item 8"
            )
        for what, val in (("writer", writer), ("retry", retry), ("fault_hook", fault_hook)):
            if val is not None:
                raise NotImplementedError(f"InferenceEngine({what}=...) {_NOT_PORTED}")
        self.cfg = cfg
        self.scfg = scfg = scfg if scfg is not None else ServeConfig()
        if scfg.iters == "auto":
            raise NotImplementedError(f"ServeConfig(iters='auto') {_NOT_PORTED}")
        self.name = name
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = init_glom(cfg, generator=generator)
        self.params = map_params(lambda t: t.to(self.device), params)
        self._compute_dtype = resolve_dtype(scfg.compute_dtype)
        self._seen: set = set()
        self._cold_levels: Optional[torch.Tensor] = None

    # -- signatures --------------------------------------------------------

    @property
    def iters_key(self) -> int:
        """The resolved fixed iteration count."""
        return self.scfg.iters if self.scfg.iters is not None else self.cfg.default_iters

    def signature(self, bucket, iters_override: Optional[int] = None, *, warm=False) -> Tuple:
        route = iters_override if iters_override is not None else self.iters_key
        return (bucket, route, self.scfg.use_pallas, warm)

    def cold_levels(self) -> torch.Tensor:
        """The cold-start column state for ONE row: `init_levels` broadcast
        to [n_patches, L, d] in the serving dtype, exactly the init the
        forward builds when no `levels0` is carried. A CPU tensor (numpy
        has no bfloat16), memoized; callers copy it."""
        if self._cold_levels is None:
            init = self.params.init_levels.to("cpu", self._compute_dtype)
            self._cold_levels = init[None].expand(self.cfg.num_patches, *init.shape).contiguous()
        return self._cold_levels

    def pick_bucket(self, n: int) -> int:
        """Smallest bucket admitting n requests."""
        if n < 1:
            raise ValueError(f"n={n} must be >= 1")
        for b in self.scfg.buckets:
            if n <= b:
                return b
        raise ValueError(f"n={n} exceeds the largest bucket {max(self.scfg.buckets)}")

    # -- dispatch ----------------------------------------------------------

    def _forward(self, img, iters, levels0):
        with torch.inference_mode():
            out = glom_forward(
                self.params, img, self.cfg, iters=iters, levels=levels0,
                compute_dtype=self._compute_dtype, use_pallas=self.scfg.use_pallas,
            )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def warmup(
        self,
        buckets: Optional[Tuple[int, ...]] = None,
        *,
        iters_override: Optional[int] = None,
        warm: bool = False,
    ) -> dict:
        """Run every bucket signature once before traffic (zero images).
        Returns {bucket: seconds}; already-warm signatures report 0.0."""
        cfg = self.cfg
        out = {}
        for b in buckets if buckets is not None else self.scfg.buckets:
            sig = self.signature(b, iters_override, warm=warm)
            if sig in self._seen:
                out[b] = 0.0
                continue
            img = torch.zeros(
                (b, cfg.channels, cfg.image_size, cfg.image_size), device=self.device
            )
            levels0 = None
            if warm:
                levels0 = self.cold_levels().to(self.device)[None].expand(b, -1, -1, -1)
            t0 = time.perf_counter()
            self._forward(img, iters_override or self.iters_key, levels0)
            out[b] = time.perf_counter() - t0
            self._seen.add(sig)
        return out

    def infer(
        self,
        imgs,
        n_valid: Optional[int] = None,
        *,
        iters_override: Optional[int] = None,
        levels0=None,
        auto_budget: Optional[int] = None,
        page_rows=None,
        support_rows=None,
    ) -> ServeResult:
        """Run one padded batch. `imgs` is [b, c, H, W] (numpy or tensor)
        with b a bucket size; `n_valid` marks how many leading rows are real
        requests (pad rows are harmless on the fixed route). iters_override
        pins a fixed budget for this dispatch; levels0 [b, n, L, d] carries
        warm column state in."""
        for what, val in (("auto_budget", auto_budget), ("page_rows", page_rows),
                          ("support_rows", support_rows)):
            if val is not None:
                raise NotImplementedError(f"infer({what}=...) {_NOT_PORTED}")
        if iters_override is not None and (
            not isinstance(iters_override, int) or iters_override < 1
        ):
            raise ValueError(f"iters_override={iters_override!r}: an int >= 1 or None")
        b = np.shape(imgs)[0]
        if b not in self.scfg.buckets:
            raise ValueError(
                f"batch {b} is not a bucket shape {self.scfg.buckets}; pad "
                "to a bucket (DynamicBatcher does) or add the bucket"
            )
        n_valid = b if n_valid is None else n_valid
        if not 1 <= n_valid <= b:
            raise ValueError(f"n_valid={n_valid} outside 1..{b}")
        warm = levels0 is not None
        if warm and np.shape(levels0)[0] != b:
            raise ValueError(f"levels0 batch {np.shape(levels0)[0]} != bucket {b}")
        sig = self.signature(b, iters_override, warm=warm)
        first = sig not in self._seen
        iters = iters_override if iters_override is not None else self.iters_key

        t0 = time.perf_counter()
        img = torch.as_tensor(imgs, dtype=torch.float32, device=self.device)
        levels0_bytes = 0
        if warm:
            on_device = isinstance(levels0, torch.Tensor) and levels0.device == self.device
            levels0 = torch.as_tensor(levels0, device=self.device)
            if not on_device:
                levels0_bytes = levels0.nelement() * levels0.element_size()
        levels = self._forward(img, iters, levels0)
        dt = time.perf_counter() - t0
        self._seen.add(sig)
        return ServeResult(
            levels=levels,
            iters_run=iters,
            latency_s=dt,
            bucket=b,
            compiled=first,
            row_converged=np.ones((b,), bool),
            row_iters=np.full((b,), iters, np.int32),
            levels0_h2d_bytes=levels0_bytes,
        )

    def infer_ragged(self, *args, **kwargs):
        raise NotImplementedError(f"infer_ragged {_NOT_PORTED}")

    def warmup_ragged(self, *args, **kwargs):
        raise NotImplementedError(f"warmup_ragged {_NOT_PORTED}")
