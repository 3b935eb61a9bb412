"""The inference engine: params plus one forward per dispatch signature.

Counterpart of `glom_tpu/serve/engine.py` `InferenceEngine`. Two routes:

  * the bucket route: callers pad each batch to a bucket size and `infer`
    answers it, on a fixed iteration budget or, with `iters="auto"`, on the
    early-exit route (`serve/early_exit.glom_forward_tiered`: per-row
    witness, quorum exit, pad rows masked out of the vote);
  * the ragged route (`ServeConfig.ragged`): `infer_ragged` answers rows of
    differing patch counts packed page-aligned on one flat token axis
    (`serve/batcher.pack_ragged`), at a page count from the ragged ladder
    (`serve/early_exit.glom_forward_ragged`), cold or with a continuation's
    flat `levels0`.

`warmup`/`warmup_ragged` run every signature once before traffic (on the
card that builds the kernels and the allocator's pools). PyTorch runs
eagerly, so a signature is a shape the engine has run, not a compiled
program. Every dispatch ends in a device synchronize.

Not ported yet (ROADMAP queue A item 7): the device page pool (page_rows,
page_idx, page_pool_pages > 0), the incremental route (support_rows), the
batcher's continuation hops (max_continuations > 0), retry and telemetry;
meshes are item 8. Asking for any of them raises
NotImplementedError.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from glom_tpu_torch.models.core import GlomParams, glom_forward, init_glom, map_params
from glom_tpu_torch.serve.early_exit import glom_forward_ragged, glom_forward_tiered
from glom_tpu_torch.serve.paged_columns import pages_for_tokens, resolve_page_tokens
from glom_tpu_torch.utils.config import GlomConfig, ServeConfig
from glom_tpu_torch.utils.helpers import resolve_device, resolve_dtype

_NOT_PORTED = "is not ported yet: ROADMAP queue A item 7"


class ServeResult(NamedTuple):
    """One dispatched batch's outcome. `levels` is the full padded
    [bucket, n, L, d] state on the engine's device (callers slice their
    valid rows); `iters_run` is the updates executed (the fixed budget, or
    the auto route's exit count); `latency_s` is the dispatch-to-result wall
    time, ending in a device synchronize. `compiled` is True on the
    signature's first dispatch. `row_converged`/`row_iters` are the per-row
    exit outcome ([bucket] host arrays); the fixed route marks every row
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


class RaggedServeResult(NamedTuple):
    """One ragged dispatch's outcome. `levels` is the flat page-aligned
    [T, L, d] state on the engine's device (row r's columns at [start_r,
    start_r + n_patches[r]), serve/early_exit.ragged_row_layout); `pages`
    is the ladder entry the dispatch ran at."""

    levels: torch.Tensor
    iters_run: int
    latency_s: float
    pages: int
    compiled: bool
    row_converged: np.ndarray
    row_iters: np.ndarray
    levels0_h2d_bytes: int = 0


class InferenceEngine:
    """Owns params and answers bucket and ragged dispatches on one device."""

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
        if scfg.page_pool_pages > 0:
            raise NotImplementedError(f"ServeConfig(page_pool_pages > 0): the page pool {_NOT_PORTED}")
        if scfg.max_continuations > 0:
            raise NotImplementedError(
                f"ServeConfig(max_continuations > 0): the batcher's continuation hops {_NOT_PORTED}"
            )
        if scfg.ragged:
            if cfg.local_consensus_radius > 0:
                raise ValueError("ragged admission requires local_consensus_radius == 0")
            ppr = pages_for_tokens(cfg.num_patches, resolve_page_tokens(cfg, scfg))
            if scfg.ragged_pages and max(scfg.ragged_pages) < ppr:
                raise ValueError(
                    f"ragged_pages top {max(scfg.ragged_pages)} is below "
                    f"one full-resolution row's {ppr} pages: every "
                    "full-size request would fail at dispatch"
                )
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
    def iters_key(self):
        """The route of every signature: "auto" or the fixed iteration count."""
        if self.scfg.iters == "auto":
            return "auto"
        return self.scfg.iters if self.scfg.iters is not None else self.cfg.default_iters

    @property
    def auto_budget(self) -> int:
        """The auto route's full iteration budget per request."""
        if self.scfg.max_auto_iters is not None:
            return self.scfg.max_auto_iters
        return self.cfg.default_iters

    def signature(
        self, bucket, iters_override: Optional[int] = None, *,
        auto_budget: Optional[int] = None, warm=False,
    ) -> Tuple:
        if iters_override is not None:
            route = iters_override
        elif auto_budget is not None and self.iters_key == "auto":
            route = f"auto:{auto_budget}"
        else:
            route = self.iters_key
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

    @property
    def page_tokens(self) -> int:
        return resolve_page_tokens(self.cfg, self.scfg)

    @property
    def ragged_rows(self) -> int:
        """Row capacity of every ragged dispatch (slots past the rows given
        are unused, n_patches 0)."""
        return self.scfg.max_batch

    @property
    def ragged_page_buckets(self) -> Tuple[int, ...]:
        """The ascending page-count ladder of the ragged route:
        `ServeConfig.ragged_pages` when set, else strides of full-row pages
        from one full-resolution row up to max_batch rows (at most about 8
        entries)."""
        if self.scfg.ragged_pages:
            return tuple(self.scfg.ragged_pages)
        ppr = pages_for_tokens(self.cfg.num_patches, self.page_tokens)
        top = self.scfg.max_batch * ppr
        stride = ppr * max(1, -(-self.scfg.max_batch // 8))
        return tuple(range(stride, top + 1, stride))

    def pick_pages(self, n_pages: int) -> int:
        """Smallest ragged ladder entry admitting n_pages pages."""
        if n_pages < 1:
            raise ValueError(f"n_pages={n_pages} must be >= 1")
        for p in self.ragged_page_buckets:
            if n_pages <= p:
                return p
        raise ValueError(
            f"n_pages={n_pages} exceeds the largest ragged signature "
            f"{max(self.ragged_page_buckets)}"
        )

    def _ragged_key(self, pages: int) -> str:
        """The ragged signature's bucket key; the consensus gather rides it
        when it is not the default windowed one."""
        mode = self.scfg.ragged_attention
        return f"ragged{pages}" if mode == "windowed" else f"ragged{pages}:{mode}"

    # -- dispatch ----------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _route(self, iters_override, auto_budget):
        """(auto, budget) of one dispatch."""
        if iters_override is None and self.iters_key == "auto":
            return True, auto_budget if auto_budget is not None else self.auto_budget
        return False, iters_override if iters_override is not None else self.iters_key

    def _forward(self, img, mask, levels0, iters_override=None, auto_budget=None):
        """(levels, iters_run, row_converged, row_iters) of one bucket dispatch,
        synchronized."""
        auto, budget = self._route(iters_override, auto_budget)
        scfg = self.scfg
        with torch.inference_mode():
            if auto:
                res = glom_forward_tiered(
                    self.params, img, self.cfg, max_iters=budget,
                    threshold=scfg.exit_threshold, min_iters=min(scfg.min_iters, budget),
                    quorum=scfg.exit_quorum, levels=levels0, valid_mask=mask,
                    compute_dtype=self._compute_dtype, use_pallas=scfg.use_pallas,
                )
                out = (res.levels, res.iters_run, res.row_converged.cpu().numpy(),
                       res.row_iters.cpu().numpy())
            else:
                levels = glom_forward(
                    self.params, img, self.cfg, iters=budget, levels=levels0,
                    compute_dtype=self._compute_dtype, use_pallas=scfg.use_pallas,
                )
                b = levels.shape[0]
                out = (levels, budget, np.ones((b,), bool), np.full((b,), budget, np.int32))
        self._sync()
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
            mask = torch.ones((b,), dtype=torch.bool, device=self.device)
            levels0 = None
            if warm:
                levels0 = self.cold_levels().to(self.device)[None].expand(b, -1, -1, -1)
            t0 = time.perf_counter()
            self._forward(img, mask, levels0, iters_override)
            out[b] = time.perf_counter() - t0
            self._seen.add(sig)
        return out

    def _device_levels(self, levels0) -> Tuple[torch.Tensor, int]:
        """levels0 on the engine's device in the serving dtype, and the
        bytes that crossed from the host (0 when it was already there)."""
        on_device = isinstance(levels0, torch.Tensor) and levels0.device == self.device
        lv = torch.as_tensor(levels0)
        if self._compute_dtype is not None:
            lv = lv.to(self._compute_dtype)
        return lv.to(self.device), 0 if on_device else lv.nelement() * lv.element_size()

    @staticmethod
    def _check_budget_args(iters_override, auto_budget) -> None:
        if iters_override is not None and (
            not isinstance(iters_override, int) or iters_override < 1
        ):
            raise ValueError(f"iters_override={iters_override!r}: an int >= 1 or None")
        if auto_budget is not None:
            if not isinstance(auto_budget, int) or auto_budget < 1:
                raise ValueError(f"auto_budget={auto_budget!r}: an int >= 1 or None")
            if iters_override is not None:
                raise ValueError(
                    "auto_budget composes with the auto route only, not "
                    "with a fixed iters_override"
                )

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
        requests (the auto route masks the rest out of its exit vote).
        iters_override pins a fixed budget for this dispatch; levels0
        [b, n, L, d] carries warm column state in; auto_budget caps the auto
        route's budget (a continuation's remaining iterations)."""
        for what, val in (("page_rows", page_rows), ("support_rows", support_rows)):
            if val is not None:
                raise NotImplementedError(f"infer({what}=...) {_NOT_PORTED}")
        self._check_budget_args(iters_override, auto_budget)
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
        sig = self.signature(b, iters_override, auto_budget=auto_budget, warm=warm)
        first = sig not in self._seen

        t0 = time.perf_counter()
        img = torch.as_tensor(imgs, dtype=torch.float32, device=self.device)
        mask = torch.arange(b, device=self.device) < n_valid
        levels0_bytes = 0
        if warm:
            levels0, levels0_bytes = self._device_levels(levels0)
        levels, iters_run, conv, row_iters = self._forward(
            img, mask, levels0, iters_override, auto_budget
        )
        dt = time.perf_counter() - t0
        self._seen.add(sig)
        return ServeResult(
            levels=levels,
            iters_run=iters_run,
            latency_s=dt,
            bucket=b,
            compiled=first,
            row_converged=conv,
            row_iters=row_iters,
            levels0_h2d_bytes=levels0_bytes,
        )

    # -- the ragged route --------------------------------------------------

    def _ragged_forward(self, patches, n_patches, levels0, iters_override, auto_budget):
        auto, budget = self._route(iters_override, auto_budget)
        scfg = self.scfg
        with torch.inference_mode():
            res = glom_forward_ragged(
                self.params, patches, self.cfg, n_patches=n_patches,
                page_tokens=self.page_tokens, route="auto" if auto else budget,
                max_iters=budget if auto else None, threshold=scfg.exit_threshold,
                min_iters=min(scfg.min_iters, budget), quorum=scfg.exit_quorum,
                levels0=levels0, compute_dtype=self._compute_dtype,
                use_pallas=scfg.use_pallas, ragged_attention=scfg.ragged_attention,
            )
            out = (res.levels, res.iters_run, res.row_converged.cpu().numpy(),
                   res.row_iters.cpu().numpy())
        self._sync()
        return out

    def warmup_ragged(self, pages: Optional[Tuple[int, ...]] = None) -> dict:
        """Run every ragged ladder entry once before traffic (zero patches,
        no rows). Returns {page_count: seconds}; already-warm entries report
        0.0."""
        cfg = self.cfg
        out = {}
        for p in pages if pages is not None else self.ragged_page_buckets:
            sig = self.signature(self._ragged_key(p), warm="ragged")
            if sig in self._seen:
                out[p] = 0.0
                continue
            patches = torch.zeros((p * self.page_tokens, cfg.patch_dim), device=self.device)
            n_dev = torch.zeros((self.ragged_rows,), dtype=torch.int32, device=self.device)
            t0 = time.perf_counter()
            self._ragged_forward(patches, n_dev, None, None, None)
            out[p] = time.perf_counter() - t0
            self._seen.add(sig)
        return out

    def infer_ragged(
        self,
        patches,
        n_patches,
        *,
        page_idx=None,
        levels0=None,
        auto_budget: Optional[int] = None,
        iters_override: Optional[int] = None,
    ) -> RaggedServeResult:
        """Run one ragged dispatch: rows of differing patch counts packed
        page-aligned on a flat token axis.

        patches: [T, patch_dim] host-patchified rows in row order, page
        padded (T = P x page_tokens with P a ladder entry; pack_ragged
        lays them out as the forward derives them). n_patches: per-row
        patch counts (at most `ragged_rows`; padded with 0). levels0
        [T, L, d], flat and row-packed like patches, carries a
        continuation's mid-flight columns in; its host-to-device bytes are
        reported. page_idx (pool-resident warm pages) is not ported yet."""
        if page_idx is not None:
            raise NotImplementedError(f"infer_ragged(page_idx=...): the page pool {_NOT_PORTED}")
        self._check_budget_args(iters_override, auto_budget)
        pt = self.page_tokens
        patches = np.asarray(patches, np.float32) if not isinstance(patches, torch.Tensor) else patches
        T = patches.shape[0]
        if T % pt != 0:
            raise ValueError(f"T={T} is not a multiple of page_tokens {pt}")
        P = T // pt
        if P not in self.ragged_page_buckets:
            raise ValueError(
                f"{P} pages is not a ragged signature "
                f"{self.ragged_page_buckets}; pack to a ladder entry "
                "(DynamicBatcher does)"
            )
        n_list = [int(n) for n in np.asarray(n_patches).reshape(-1)]
        R = self.ragged_rows
        if len(n_list) > R:
            raise ValueError(f"{len(n_list)} rows exceed ragged_rows {R}")
        if any(n < 0 or n > self.cfg.num_patches for n in n_list):
            raise ValueError(
                f"n_patches {n_list}: each row needs 0..{self.cfg.num_patches}"
                " patches (the pos table bounds the row length)"
            )
        need = sum(pages_for_tokens(n, pt) for n in n_list if n > 0)
        if need > P:
            raise ValueError(f"rows need {need} pages > dispatch size {P}")
        n_host = np.zeros((R,), np.int32)
        n_host[: len(n_list)] = n_list
        cont = levels0 is not None
        if cont and tuple(np.shape(levels0)) != (T, self.cfg.levels, self.cfg.dim):
            raise ValueError(
                f"levels0 shape {tuple(np.shape(levels0))} != "
                f"({T}, {self.cfg.levels}, {self.cfg.dim}) (flat "
                "row-packed, page padded like patches)"
            )
        sig = self.signature(self._ragged_key(P), iters_override,
                             auto_budget=auto_budget, warm="cont" if cont else "ragged")
        first = sig not in self._seen

        t0 = time.perf_counter()
        patches_dev = torch.as_tensor(patches, dtype=torch.float32, device=self.device)
        n_dev = torch.as_tensor(n_host, device=self.device)
        levels0_bytes = 0
        if cont:
            levels0, levels0_bytes = self._device_levels(levels0)
        levels, iters_run, conv, row_iters = self._ragged_forward(
            patches_dev, n_dev, levels0, iters_override, auto_budget
        )
        dt = time.perf_counter() - t0
        self._seen.add(sig)
        return RaggedServeResult(
            levels=levels,
            iters_run=iters_run,
            latency_s=dt,
            pages=P,
            compiled=first,
            row_converged=conv,
            row_iters=row_iters,
            levels0_h2d_bytes=levels0_bytes,
        )
