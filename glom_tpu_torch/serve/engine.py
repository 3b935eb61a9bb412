"""The inference engine: params plus one forward per dispatch signature.

Counterpart of `glom_tpu/serve/engine.py` `InferenceEngine`. Two routes:

  * the bucket route: callers pad each batch to a bucket size and `infer`
    answers it, on a fixed iteration budget or, with `iters="auto"`, on the
    early-exit route (`serve/early_exit.glom_forward_tiered`: per-row
    witness, quorum exit, pad rows masked out of the vote). Warm column
    state arrives from the host (`levels0`) or from the engine's device
    page pool (`page_rows`: `take_pages` gathers it by page index, and no
    column state crosses from the host), and with `support_rows` a paged
    dispatch runs the incremental route
    (`serve/early_exit.glom_forward_incremental`);
  * the ragged route (`ServeConfig.ragged`): `infer_ragged` answers rows of
    differing patch counts packed page-aligned on one flat token axis
    (`serve/batcher.pack_ragged`), at a page count from the ragged ladder
    (`serve/early_exit.glom_forward_ragged`), cold, warm from pool pages
    (`page_idx`), or with a continuation's flat `levels0`.

`warmup`/`warmup_ragged` run every signature once before traffic (on the
card that builds the kernels and the allocator's pools). PyTorch runs
eagerly, so a signature is a shape the engine has run, not a compiled
program, and the first dispatch of a signature is its warm-up: its time
is the signature's `compile_time_s`, and a "warmup" event is stamped.
Every dispatch ends in a device synchronize, runs on the device's current
stream (as every pool operation does, serve/paged_columns.py) and holds a
read pin on the pool from before its gather until that synchronize.

Transient dispatch failures retry under a `RetryPolicy`
(resilience/retry.py; `ServeConfig.dispatch_retries`, 2 by default): a
failed attempt against a backend that is up or flapping backs off and
dispatches again, a backend that is down fails fast, and a kernel that
fails to build or launch (`kernels/_build.KernelError`) raises on the
first attempt. `fault_hook` is called once per attempt (the chaos seam,
resilience/faults.dispatch_fault). Latency accounting rides
telemetry/sinks.StepTimeStats per signature, drained by `stats_records()`
into stamped "serve" records.

Continuation hops (`ServeConfig.max_continuations > 0`) are the
batcher's (serve/batcher.DynamicBatcher): the engine answers each hop as a
warm dispatch with the remaining `auto_budget`. Not ported yet: meshes
(ROADMAP queue A item 8b); asking for one raises NotImplementedError.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from glom_tpu_torch.models.core import GlomParams, glom_forward, init_glom, map_params
from glom_tpu_torch.serve.early_exit import (
    glom_forward_incremental,
    glom_forward_ragged,
    glom_forward_tiered,
)
from glom_tpu_torch.serve.paged_columns import (
    pages_for_tokens,
    resolve_page_pool,
    resolve_page_tokens,
)
from glom_tpu_torch.telemetry import schema
from glom_tpu_torch.telemetry.sinks import StepTimeStats
from glom_tpu_torch.utils.config import GlomConfig, ServeConfig
from glom_tpu_torch.utils.helpers import resolve_device, resolve_dtype


class ServeResult(NamedTuple):
    """One dispatched batch's outcome. `levels` is the full padded
    [bucket, n, L, d] state on the engine's device (callers slice their
    valid rows); `iters_run` is the updates executed (the fixed budget, or
    the auto route's exit count); `latency_s` is the dispatch-to-result wall
    time, inputs' upload included, ending in a device synchronize.
    `compiled` is True on the signature's first dispatch.
    `row_converged`/`row_iters` are the per-row exit outcome ([bucket] host
    arrays); the fixed route marks every row converged at `iters_run`.
    `levels0_h2d_bytes` is the warm column state uploaded from the host (0
    on the cold and paged routes). `phases` is {"h2d_ms", "resolve_ms"}
    with ServeConfig.phase_split, summed over retry attempts."""

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
    phases: Optional[dict] = None


def _to_host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class InferenceEngine:
    """Owns params, an optional device page pool, and answers bucket and
    ragged dispatches on one device."""

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
                "InferenceEngine(mesh=...) is not ported yet: ROADMAP queue A item 8b"
            )
        self.cfg = cfg
        self.scfg = scfg = scfg if scfg is not None else ServeConfig()
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
        if scfg.donate:
            warnings.warn(
                "ServeConfig.donate: eager PyTorch donates no input buffer; "
                "resolving to False", stacklevel=2,
            )
        # A single-device engine has no collectives to time: any mode
        # resolves to "off", with glom_tpu's warning.
        if scfg.collective_timing != "off":
            warnings.warn(
                "collective_timing has no sites on a single-device engine "
                "(no collectives): resolving 'off'", stacklevel=2,
            )
        self.collective_timing = "off"
        self.name = name
        self.writer = writer
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = init_glom(cfg, generator=generator)
        self.params = map_params(lambda t: t.to(self.device), params)
        self._compute_dtype = resolve_dtype(scfg.compute_dtype)
        self._seen: set = set()
        self._stats: Dict[Tuple, StepTimeStats] = {}
        self._cold_levels: Optional[torch.Tensor] = None
        # The latency split's engine half: a plain attribute, so an A/B can
        # flip it per arm on one engine.
        self.phase_split = bool(scfg.phase_split)
        # The device page pool (page_pool_pages > 0): warm column state in
        # device pages, gathered by page index on the paged dispatches.
        self.pool = resolve_page_pool(cfg, scfg, writer=writer, name=name, device=self.device)
        # Warm column state this engine uploaded from the host, in bytes:
        # zero on the paged warm path.
        self.levels0_h2d_bytes_total = 0
        if retry is None and scfg.dispatch_retries > 0:
            from glom_tpu_torch.resilience.retry import RetryPolicy

            retry = RetryPolicy(
                retries=scfg.dispatch_retries,
                backoff_s=scfg.retry_backoff_ms / 1e3,
                writer=writer,
                site=f"{name}-dispatch",
            )
        self.retry = retry
        # Called once per dispatch attempt with {bucket, n_valid, attempt};
        # a raise there is a transient backend failure to the retry policy.
        self._fault_hook = fault_hook
        # Set by release(): the engine keeps its records but serves no more.
        self.released = False

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
    def pages_per_row(self) -> int:
        """Pages of one full-resolution row (the width of `page_rows`)."""
        return self.cfg.num_patches // self.page_tokens

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

    def _ragged_warm(self) -> str:
        """The warm key of a cold or page-warm ragged signature: one form
        serves both when the engine owns a pool (cold pages are -1)."""
        return "pool" if self.pool is not None else "ragged"

    # -- dispatch ----------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_live(self) -> None:
        if self.released:
            raise RuntimeError(
                f"engine {self.name!r} was released: it serves no more dispatches"
            )

    def _route(self, iters_override, auto_budget):
        """(auto, budget) of one dispatch."""
        if iters_override is None and self.iters_key == "auto":
            return True, auto_budget if auto_budget is not None else self.auto_budget
        return False, iters_override if iters_override is not None else self.iters_key

    def take_pages(self, pool: torch.Tensor, page_idx: torch.Tensor, b: int) -> torch.Tensor:
        """levels0 [b, n, L, d] gathered from pool pages: page_idx [b,
        pages_per_row] int on the device; a -1 page takes the cold init
        (`init_levels` broadcast and cast to the pool's dtype), so a cold
        row equals the cold dispatch's init bit for bit."""
        cfg = self.cfg
        pages = pool[page_idx.clamp(0, pool.shape[0] - 1).long()]  # [b, ppr, pt, L, d]
        init = self.params.init_levels.to(pool.dtype)
        pages = torch.where((page_idx >= 0)[..., None, None, None], pages, init)
        return pages.reshape(b, cfg.num_patches, cfg.levels, cfg.dim)

    def _forward(self, img, mask, warm, levels0=None, page_idx=None, support=None,
                 iters_override=None, auto_budget=None):
        """(levels, iters_run, row_converged, row_iters) of one bucket
        dispatch, synchronized; the per-row outcome as device tensors on
        the auto routes. A paged dispatch holds a read pin on the pool from
        its gather until the synchronize."""
        auto, budget = self._route(iters_override, auto_budget)
        scfg = self.scfg
        paged = warm in ("paged", "paged-inc")
        pool = self.pool.acquire_read() if paged else None
        try:
            with torch.inference_mode():
                if paged:
                    levels0 = self.take_pages(pool, page_idx, img.shape[0])
                if auto:
                    kw = dict(
                        max_iters=budget, threshold=scfg.exit_threshold,
                        min_iters=min(scfg.min_iters, budget), quorum=scfg.exit_quorum,
                        levels=levels0, valid_mask=mask, compute_dtype=self._compute_dtype,
                        use_pallas=scfg.use_pallas,
                    )
                    if warm == "paged-inc":
                        support_tok = support.repeat_interleave(self.page_tokens, dim=1)
                        res = glom_forward_incremental(
                            self.params, img, self.cfg, support_mask=support_tok, **kw)
                    else:
                        res = glom_forward_tiered(self.params, img, self.cfg, **kw)
                    out = (res.levels, res.iters_run, res.row_converged, res.row_iters)
                else:
                    levels = glom_forward(
                        self.params, img, self.cfg, iters=budget, levels=levels0,
                        compute_dtype=self._compute_dtype, use_pallas=scfg.use_pallas,
                    )
                    b = levels.shape[0]
                    out = (levels, budget, np.ones((b,), bool),
                           np.full((b,), budget, np.int32))
            self._sync()
        finally:
            if paged:
                self.pool.release_read()
        return out

    def _observe(self, sig, dt: float, first: bool, iters_override) -> None:
        """Per-signature latency stats; a signature's first dispatch is its
        warm-up, stamped as glom_tpu stamps a compile."""
        self._stats.setdefault(sig, StepTimeStats()).observe(dt, is_compile=first)
        if first:
            self._emit(
                {
                    "event": "warmup",
                    "bucket": sig[0],
                    "iters": sig[1],
                    "warm_state": sig[3],
                    "degraded": iters_override is not None,
                    "sharded": False,
                    "use_pallas": self.scfg.use_pallas,
                    "compile_time_s": round(dt, 4),
                }
            )
        self._seen.add(sig)

    def warmup(
        self,
        buckets: Optional[Tuple[int, ...]] = None,
        *,
        iters_override: Optional[int] = None,
        warm=False,
    ) -> dict:
        """Run every bucket signature once before traffic (zero images).
        warm=True warms the host-carried levels0 form, "paged" the pool
        form (every page cold), "paged-inc" the incremental form (no
        support). Returns {bucket: seconds}; already-warm signatures report
        0.0."""
        self._check_live()
        cfg = self.cfg
        if warm in ("paged", "paged-inc") and self.pool is None:
            raise ValueError("paged warmups need a page pool (ServeConfig.page_pool_pages > 0)")
        if warm == "paged-inc" and (self.iters_key != "auto" or iters_override is not None):
            raise ValueError("the incremental route needs iters='auto' (a fixed budget "
                             "has no early exit to seed)")
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
            kw = {}
            if warm is True:
                kw["levels0"] = self.cold_levels().to(self.device)[None].expand(b, -1, -1, -1)
            elif warm in ("paged", "paged-inc"):
                kw["page_idx"] = torch.full((b, self.pages_per_row), -1, dtype=torch.int32,
                                            device=self.device)
                kw["support"] = torch.zeros((b, self.pages_per_row), dtype=torch.bool,
                                            device=self.device)
            t0 = time.perf_counter()
            self._forward(img, mask, warm, iters_override=iters_override, **kw)
            out[b] = time.perf_counter() - t0
            self._observe(sig, out[b], True, iters_override)
        return out

    def _device_levels(self, levels0) -> Tuple[torch.Tensor, int]:
        """levels0 on the engine's device in the serving dtype, and the
        bytes carried from the host: 0 when it is already a tensor on the
        card, its bytes when it is host memory (numpy or a CPU tensor, on
        a CPU engine too, as glom_tpu counts any carried levels0)."""
        on_device = (isinstance(levels0, torch.Tensor) and levels0.device.type != "cpu"
                     and levels0.device == self.device)
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

    def _run_attempts(self, attempt, ph: dict, split: bool, **context):
        """Run one dispatch's attempt under the retry policy, timing the
        host reads of its outcome as the resolve phase."""

        def timed():
            levels, iters_run, conv, row_iters = attempt()
            t_r = time.perf_counter()
            out = (levels, int(iters_run), _to_host(conv), _to_host(row_iters))
            if split:
                ph["resolve_s"] += time.perf_counter() - t_r
            return out

        if self.retry is not None:
            return self.retry.run(timed, **context)
        return timed()

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
        iters_override pins a fixed budget for this dispatch; auto_budget
        caps the auto route's budget (a continuation's remaining
        iterations). Warm state: levels0 [b, n, L, d] from the host, or
        page_rows [b, pages_per_row] int32 pool pages (-1 rows take the cold
        init; no levels0 crosses from the host). support_rows [b,
        pages_per_row] bool, with page_rows on the auto route, runs the
        incremental forward: rows with no support start converged.
        Transient failures retry per the engine's RetryPolicy."""
        self._check_live()
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
        if page_rows is not None:
            if self.pool is None:
                raise ValueError("page_rows needs a page pool (ServeConfig.page_pool_pages > 0)")
            if levels0 is not None:
                raise ValueError("pass levels0 OR page_rows, not both")
            page_rows = np.asarray(page_rows, np.int32)
            if page_rows.shape != (b, self.pages_per_row):
                raise ValueError(
                    f"page_rows shape {page_rows.shape} != ({b}, {self.pages_per_row})"
                )
        if support_rows is not None:
            if page_rows is None:
                raise ValueError(
                    "support_rows rides page_rows (the incremental route is a paged dispatch)"
                )
            if self.iters_key != "auto" or iters_override is not None:
                raise ValueError(
                    "support_rows needs the iters='auto' route (a fixed "
                    "budget has no early exit to seed)"
                )
            support_rows = np.asarray(support_rows, bool)
            if support_rows.shape != page_rows.shape:
                raise ValueError(f"support_rows shape {support_rows.shape} != {page_rows.shape}")
        if page_rows is not None:
            warm = "paged-inc" if support_rows is not None else "paged"
        else:
            warm = levels0 is not None
        if warm is True and np.shape(levels0)[0] != b:
            raise ValueError(f"levels0 batch {np.shape(levels0)[0]} != bucket {b}")
        sig = self.signature(b, iters_override, auto_budget=auto_budget, warm=warm)
        first = sig not in self._seen
        split = self.phase_split
        ph = {"h2d_s": 0.0, "resolve_s": 0.0}

        t0 = time.perf_counter()
        img = torch.as_tensor(imgs, dtype=torch.float32, device=self.device)
        mask = torch.arange(b, device=self.device) < n_valid
        kw = {}
        levels0_bytes = 0
        if warm is True:
            kw["levels0"], levels0_bytes = self._device_levels(levels0)
        elif page_rows is not None:
            # Only the int32 page map (and the bool support map) crosses.
            kw["page_idx"] = torch.as_tensor(page_rows, device=self.device)
            if support_rows is not None:
                kw["support"] = torch.as_tensor(support_rows, device=self.device)
        if split:
            self._sync()
            ph["h2d_s"] += time.perf_counter() - t0
        attempts = [0]

        def attempt():
            attempts[0] += 1
            if self._fault_hook is not None:
                self._fault_hook({"bucket": b, "n_valid": n_valid, "attempt": attempts[0]})
            return self._forward(img, mask, warm, iters_override=iters_override,
                                 auto_budget=auto_budget, **kw)

        levels, iters_run, conv, row_iters = self._run_attempts(
            attempt, ph, split, bucket=b, n_valid=n_valid)
        dt = time.perf_counter() - t0
        self._observe(sig, dt, first, iters_override)
        self.levels0_h2d_bytes_total += levels0_bytes
        return ServeResult(
            levels=levels,
            iters_run=iters_run,
            latency_s=dt,
            bucket=b,
            compiled=first,
            row_converged=conv,
            row_iters=row_iters,
            levels0_h2d_bytes=levels0_bytes,
            phases=({"h2d_ms": 1e3 * ph["h2d_s"], "resolve_ms": 1e3 * ph["resolve_s"]}
                    if split else None),
        )

    # -- the ragged route --------------------------------------------------

    def _ragged_forward(self, patches, n_patches, levels0=None, page_idx=None,
                        iters_override=None, auto_budget=None):
        """(levels, iters_run, row_converged, row_iters) of one ragged
        dispatch, synchronized; with a pool (and no levels0) the pool is
        read-pinned from its gather until the synchronize."""
        auto, budget = self._route(iters_override, auto_budget)
        scfg = self.scfg
        pooled = page_idx is not None
        pool = self.pool.acquire_read() if pooled else None
        try:
            with torch.inference_mode():
                res = glom_forward_ragged(
                    self.params, patches, self.cfg, n_patches=n_patches,
                    page_tokens=self.page_tokens, route="auto" if auto else budget,
                    max_iters=budget if auto else None, threshold=scfg.exit_threshold,
                    min_iters=min(scfg.min_iters, budget), quorum=scfg.exit_quorum,
                    levels0=levels0, pool=pool, page_idx=page_idx,
                    compute_dtype=self._compute_dtype, use_pallas=scfg.use_pallas,
                    ragged_attention=scfg.ragged_attention,
                )
            self._sync()
        finally:
            if pooled:
                self.pool.release_read()
        return res.levels, res.iters_run, res.row_converged, res.row_iters

    def warmup_ragged(self, pages: Optional[Tuple[int, ...]] = None) -> dict:
        """Run every ragged ladder entry once before traffic (zero patches,
        no rows; with a pool, through it, every page cold). Returns
        {page_count: seconds}; already-warm entries report 0.0."""
        self._check_live()
        cfg = self.cfg
        out = {}
        for p in pages if pages is not None else self.ragged_page_buckets:
            sig = self.signature(self._ragged_key(p), warm=self._ragged_warm())
            if sig in self._seen:
                out[p] = 0.0
                continue
            patches = torch.zeros((p * self.page_tokens, cfg.patch_dim), device=self.device)
            n_dev = torch.zeros((self.ragged_rows,), dtype=torch.int32, device=self.device)
            pidx = (torch.full((p,), -1, dtype=torch.int32, device=self.device)
                    if self.pool is not None else None)
            t0 = time.perf_counter()
            self._ragged_forward(patches, n_dev, page_idx=pidx)
            out[p] = time.perf_counter() - t0
            self._observe(sig, out[p], True, None)
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
        patch counts (at most `ragged_rows`; padded with 0). page_idx: [P]
        int32 pool pages per dispatch page, -1 cold (needs the engine's
        pool; None is all cold): warm state rides the pool only, and no
        levels0 crosses from the host. levels0 [T, L, d], flat and
        row-packed like patches, carries a continuation's mid-flight
        columns in instead (not with page_idx); its bytes are reported."""
        self._check_live()
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
        if page_idx is not None and self.pool is None:
            raise ValueError("page_idx needs a page pool (ServeConfig.page_pool_pages)")
        cont = levels0 is not None
        if cont:
            if page_idx is not None:
                raise ValueError(
                    "levels0 OR page_idx: a continuation's columns are "
                    "mid-flight, not pool-resident"
                )
            if tuple(np.shape(levels0)) != (T, self.cfg.levels, self.cfg.dim):
                raise ValueError(
                    f"levels0 shape {tuple(np.shape(levels0))} != "
                    f"({T}, {self.cfg.levels}, {self.cfg.dim}) (flat "
                    "row-packed, page padded like patches)"
                )
        pidx_host = None
        if self.pool is not None and not cont:
            pidx_host = (np.full((P,), -1, np.int32) if page_idx is None
                         else np.asarray(page_idx, np.int32))
            if pidx_host.shape != (P,):
                raise ValueError(f"page_idx shape {pidx_host.shape} != ({P},)")
        warm = "cont" if cont else self._ragged_warm()
        sig = self.signature(self._ragged_key(P), iters_override,
                             auto_budget=auto_budget, warm=warm)
        first = sig not in self._seen
        split = self.phase_split
        ph = {"h2d_s": 0.0, "resolve_s": 0.0}
        n_rows = sum(1 for n in n_list if n > 0)

        t0 = time.perf_counter()
        patches_dev = torch.as_tensor(patches, dtype=torch.float32, device=self.device)
        kw = dict(n_patches=torch.as_tensor(n_host, device=self.device))
        levels0_bytes = 0
        if cont:
            kw["levels0"], levels0_bytes = self._device_levels(levels0)
        elif pidx_host is not None:
            kw["page_idx"] = torch.as_tensor(pidx_host, device=self.device)
        if split:
            self._sync()
            ph["h2d_s"] += time.perf_counter() - t0
        attempts = [0]

        def attempt():
            attempts[0] += 1
            if self._fault_hook is not None:
                self._fault_hook({"bucket": self._ragged_key(P), "n_valid": n_rows,
                                  "attempt": attempts[0]})
            return self._ragged_forward(patches_dev, iters_override=iters_override,
                                        auto_budget=auto_budget, **kw)

        levels, iters_run, conv, row_iters = self._run_attempts(
            attempt, ph, split, bucket=self._ragged_key(P), n_valid=n_rows)
        dt = time.perf_counter() - t0
        self._observe(sig, dt, first, iters_override)
        self.levels0_h2d_bytes_total += levels0_bytes
        return RaggedServeResult(
            levels=levels,
            iters_run=iters_run,
            latency_s=dt,
            pages=P,
            compiled=first,
            row_converged=conv,
            row_iters=row_iters,
            levels0_h2d_bytes=levels0_bytes,
            phases=({"h2d_ms": 1e3 * ph["h2d_s"], "resolve_ms": 1e3 * ph["resolve_s"]}
                    if split else None),
        )

    # -- lifecycle and telemetry -------------------------------------------

    def release(self) -> None:
        """Free this engine's device state after a graceful drain: the
        signature memo, the cold-init cache and the page pool's buffer and
        table (the device memory a drained replica held). The engine stays
        a valid husk for its records (name, stats_records) but refuses
        every later dispatch: glom_tpu's contract says it can no longer
        serve, and here no route can, pooled or not."""
        self._seen.clear()
        self._cold_levels = None
        self.released = True
        if self.pool is not None:
            self.pool.release()
        self._emit({"event": "engine_release"})

    def _emit(self, rec: dict) -> None:
        from glom_tpu_torch.serve.events import emit_serve

        emit_serve(self.writer, dict(rec, engine=self.name))

    def stats_records(self) -> list:
        """One stamped "serve" record per signature with its latency
        histogram (p50/p95/p99/max, the warm-up split out)."""
        out = []
        for sig, stats in sorted(self._stats.items(), key=lambda kv: str(kv[0])):
            bucket, iters_key, pallas, warm = sig
            rec = {
                "event": "bucket_stats",
                "engine": self.name,
                "bucket": bucket,
                "iters": iters_key,
                "warm_state": warm,
                "use_pallas": pallas,
                **stats.summary(),
            }
            out.append(schema.stamp(rec, kind="serve"))
        return out
