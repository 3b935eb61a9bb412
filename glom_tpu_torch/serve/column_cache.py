"""Session-keyed warm-start column cache: carry converged columns across
the frames of a stream.

The port's copy of `glom_tpu/serve/column_cache.py`. A request that starts
from the previous frame's converged column state exits the `iters="auto"`
route in a fraction of the cold budget. The cached unit is one session's
`[n, L, d]` column state, written back after every resolved request that
carries a `session_id` and read at the next dispatch as the warm start.

Two modes:

  * host mode (no pools): an entry is a CPU tensor in the serving dtype
    (numpy has no bfloat16), so a warm start carries exactly the bits a
    direct warm dispatch would; the batcher uploads it as `levels0`;
  * pages mode (`pools={engine name: PagedColumnPool}`): an entry is a
    page-table reference into the engine's device pool; store() writes the
    row device-to-device, lookup() returns a `PageHit` and the dispatch
    gathers the pages on the device (no levels0 crosses from the host).

Residency: entries are priced (`column_state_bytes`, or the pool pages
they hold) and evicted LRU-first under `ServeConfig.column_cache_bytes`,
which resident bytes never exceed; `column_cache_ttl_s` expires an entry
at lookup (and under eviction pressure); `invalidate_engine` drops every
entry an engine wrote the moment a dispatch on it fails. Counters roll up
in `record()`, and every eviction, expiry, rejection and invalidation is a
stamped "serve" event. One lock guards the LRU map and the counters
(events are emitted outside it); the cache lock is taken before any pool
lock, never the reverse.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import TYPE_CHECKING, Dict, List, NamedTuple, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from glom_tpu_torch.serve.paged_columns import PagedColumnPool


class PageHit(NamedTuple):
    """A PAGES-mode cache hit (serve/paged_columns.py): the warm state is
    device-resident — the dispatch carries these page indices into the
    engine's paged signature instead of a host array. `engine` names the
    pool (and the session-affinity routing target); the hit arrives
    PINNED when looked up with pin=True — the caller unpins after the
    dispatch snapshot (ColumnCache.unpin)."""

    engine: str
    pages: List[int]
    n_tokens: int


def _nbytes(t) -> int:
    return int(t.nelement() * t.element_size())


def column_state_bytes(cfg, scfg) -> int:
    """The live-bytes price of ONE session's cached column state: the
    `[num_patches, levels, dim]` tensor in the serving compute dtype —
    the same analytic form the HBM accounting prices the warm `levels0`
    staging buffer with. This is what `ServeConfig.column_cache_bytes`
    is divided by when sizing a deployment (docs/SERVING.md,
    "Streaming")."""
    itemsize = 2 if scfg.compute_dtype == "bfloat16" else 4
    return cfg.num_patches * cfg.levels * cfg.dim * itemsize


class _Entry:
    __slots__ = (
        "levels", "nbytes", "engine", "t_write", "n_tokens", "prev_input",
    )

    def __init__(
        self,
        levels: Optional[torch.Tensor],
        engine: str,
        t_write: float,
        *,
        nbytes: Optional[int] = None,
        n_tokens: int = 0,
    ):
        self.levels = levels  # host tensor, or None in PAGES mode
        self.nbytes = int(nbytes if nbytes is not None else _nbytes(levels))
        self.engine = engine
        self.t_write = t_write
        self.n_tokens = n_tokens
        # DELTA mode: the previous frame's host-patchified input
        # [n, patch_dim] — the reference the next frame's INPUT delta
        # support is computed against (input_support; host RAM, never
        # HBM, and only retained when delta streaming is on).
        self.prev_input: Optional[np.ndarray] = None


class ColumnCache:
    """LRU column-state cache keyed by session id, bounded in bytes.

    `budget_bytes` is the hard residency ceiling (HBM-priced via
    column_state_bytes); `ttl_s=None` disables expiry. The clock is
    injectable so TTL tests never sleep.

    PAGES MODE (`pools={engine_name: PagedColumnPool}`): entries become
    PAGE-TABLE REFERENCES — store() writes the converged columns
    device-to-device into the named engine's pool and lookup() returns a
    `PageHit` (engine + page indices) instead of a host array; eviction,
    TTL expiry, and invalidation FREE PAGES instead of dropping host
    arrays. The residency policy (LRU under the byte budget, TTL, engine
    invalidation) is unchanged — each entry is priced at its allocated
    pages x page_state_bytes, and pool exhaustion reads as eviction
    pressure exactly like the byte budget does. LOCK ORDER: the cache
    lock is taken BEFORE any pool lock, never the reverse (pools never
    call back into the cache)."""

    def __init__(
        self,
        budget_bytes: int,
        *,
        ttl_s: Optional[float] = None,
        writer=None,
        clock=time.monotonic,
        pools: Optional[Dict[str, "PagedColumnPool"]] = None,
    ):
        if budget_bytes < 1:
            raise ValueError(f"budget_bytes {budget_bytes} must be >= 1")
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError(f"ttl_s {ttl_s} must be > 0 or None")
        self.budget_bytes = int(budget_bytes)
        self.ttl_s = ttl_s
        self.writer = writer
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self.pools = dict(pools) if pools else None
        # DELTA mode (docs/SERVING.md, "Delta streaming"): pools built
        # from a delta_streaming config store base+delta chains instead
        # of whole-row blocks; the cache's byte accounting then prices
        # ACTUAL pool pages (shared bases counted once, chains at their
        # real sparse size) — the "several-fold more live streams in the
        # same budget" claim is this recount, not an estimate.
        self.delta = bool(self.pools) and any(
            getattr(p, "delta", False) for p in self.pools.values()
        )
        self._bytes = 0
        self._peak_bytes = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_writes = 0
        self.n_evictions = 0
        self.n_expirations = 0
        self.n_invalidations = 0
        self.n_rejects = 0

    # -- the request path --------------------------------------------------

    def engine_of(self, session_id: str) -> Optional[str]:
        """Which engine's pool holds the session's pages (None when
        absent or the cache is in host mode) — the SESSION-AFFINITY
        routing read (serve/batcher.py routes a stream to the engine
        holding its pages). A peek: no LRU touch, no counters."""
        with self._lock:
            if self.pools is None:
                return None
            entry = self._entries.get(session_id)
            return entry.engine if entry is not None else None

    def lookup(self, session_id: str, *, pin: bool = False):
        """The session's cached column state (freshest-first LRU touch),
        or None on miss: the host [n, L, d] array, or a `PageHit` in
        pages mode. An entry past its TTL is dropped HERE — an expired
        stream must never warm-start a request — and counts as one
        expiration plus the miss. pin=True (pages mode) read-pins the
        block so eviction cannot re-issue its pages while the dispatch
        reads them — callers unpin() after the dispatch."""
        events: List[dict] = []
        with self._lock:
            entry = self._entries.get(session_id)
            if entry is None:
                self.n_misses += 1
                return None
            if (
                self.ttl_s is not None
                and self._clock() - entry.t_write > self.ttl_s
            ):
                self._drop(session_id, entry)
                self.n_expirations += 1
                self.n_misses += 1
                events.append(
                    {
                        "event": "cache_expire",
                        "session": session_id,
                        "bytes": entry.nbytes,
                        "age_s": round(self._clock() - entry.t_write, 3),
                    }
                )
                out = None
            else:
                self._entries.move_to_end(session_id)
                self.n_hits += 1
                if self.pools is not None:
                    got = self.pools[entry.engine].lookup(
                        session_id, pin=pin
                    )
                    if got is None:  # pool lost the block (force-free)
                        self._drop(session_id, entry)
                        self.n_hits -= 1
                        self.n_misses += 1
                        out = None
                    else:
                        out = PageHit(entry.engine, got[0], got[1])
                else:
                    out = entry.levels
        self._flush(events)
        return out

    def unpin(self, session_id: str) -> None:
        """Release a pin taken by lookup(pin=True) (pages mode no-op
        otherwise)."""
        with self._lock:
            if self.pools is None:
                return
            entry = self._entries.get(session_id)
            pool = (
                self.pools.get(entry.engine) if entry is not None else None
            )
        if pool is not None:
            pool.unpin(session_id)

    def _sweep_expired_locked(self, events: List[dict]) -> int:
        """Drop EVERY expired entry (caller holds the lock) — the
        eviction-pressure sweep: TTL otherwise fires only at lookup, so
        a dead session's bytes (pages) stay pinned until someone touches
        the key. Under pressure the sweep reclaims them FIRST, before
        any live LRU victim pays (stamped cache_expire like the lookup
        path — one leak, one event vocabulary)."""
        if self.ttl_s is None:
            return 0
        now = self._clock()
        expired = [
            (sid, e)
            for sid, e in self._entries.items()
            if now - e.t_write > self.ttl_s
        ]
        for sid, entry in expired:
            self._drop(sid, entry)
            self.n_expirations += 1
            events.append(
                {
                    "event": "cache_expire",
                    "session": sid,
                    "bytes": entry.nbytes,
                    "age_s": round(now - entry.t_write, 3),
                    "swept": True,
                }
            )
        return len(expired)

    def _evict_lru_locked(self, events: List[dict], *, skip=()) -> bool:
        """Evict the least-recently-used UNPINNED entry (caller holds
        the lock). False when nothing evictable remains."""
        for victim_id, victim in self._entries.items():
            if victim_id in skip:
                continue
            if (
                self.pools is not None
                and self.pools[victim.engine].is_pinned(victim_id)
            ):
                continue  # an in-flight dispatch is reading these pages
            self._drop(victim_id, victim)
            self.n_evictions += 1
            events.append(
                {
                    "event": "cache_evict",
                    "session": victim_id,
                    "bytes": victim.nbytes,
                    "bytes_in_use": self._bytes,
                    "budget_bytes": self.budget_bytes,
                }
            )
            return True
        return False

    def store(
        self,
        session_id: str,
        levels,
        *,
        engine: str,
        n_tokens: Optional[int] = None,
        patches: Optional[np.ndarray] = None,
        content_hash: Optional[str] = None,
    ) -> bool:
        """Write one resolved request's converged columns back under its
        session key (the warm init for the stream's NEXT frame), evicting
        LRU entries until the byte budget holds. Returns False when the
        entry alone exceeds the whole budget (rejected, stamped — the
        budget is a ceiling, never overcommitted).

        PAGES mode: `levels` is the DEVICE row slice and `n_tokens` its
        patch count — the columns go device-to-device into the engine's
        pool (never the host). Eviction pressure (byte budget OR pool
        exhaustion) first SWEEPS expired entries, then evicts live LRU
        victims; pinned blocks (in-flight readers) are skipped."""
        now = self._clock()
        events: List[dict] = []
        with self._lock:
            pages_mode = self.pools is not None
            pool = self.pools[engine] if pages_mode else None
        if pages_mode:
            if n_tokens is None:
                raise ValueError("pages mode store() needs n_tokens")
            if self.delta and getattr(pool, "delta", False):
                return self._store_delta(
                    session_id, levels, engine, n_tokens, pool, now,
                    patches=patches, content_hash=content_hash,
                )
            from glom_tpu_torch.serve.paged_columns import pages_for_tokens

            need_pages = pages_for_tokens(n_tokens, pool.page_tokens)
            nbytes = need_pages * pool.page_bytes
            with self._lock:
                if (
                    nbytes > self.budget_bytes
                    or need_pages > pool.n_pages
                ):
                    self.n_rejects += 1
                    events.append(
                        {
                            "event": "cache_reject",
                            "session": session_id,
                            "bytes": nbytes,
                            "budget_bytes": min(
                                self.budget_bytes,
                                pool.n_pages * pool.page_bytes,
                            ),
                        }
                    )
                    self._flush(events)
                    return False
                old = self._entries.pop(session_id, None)
                if old is not None:
                    self._bytes -= old.nbytes
                    if old.engine != engine:
                        # The stream moved engines (failover): its old
                        # pages live in the OLD pool — free them there.
                        self.pools[old.engine].free(
                            session_id, reason="moved"
                        )
                # Byte-budget pressure: sweep expired first, then LRU.
                swept = False
                while self._bytes + nbytes > self.budget_bytes:
                    if not swept:
                        swept = True
                        if self._sweep_expired_locked(events):
                            continue
                    if not self._evict_lru_locked(
                        events, skip=(session_id,)
                    ):
                        break
                # Pool pressure: the write-back allocates; exhaustion is
                # eviction pressure too (same sweep-then-LRU order; only
                # victims in THIS pool free the pages we need).
                stored = pool.write_back(session_id, levels, n_tokens)
                while not stored:
                    if not swept:
                        swept = True
                        if self._sweep_expired_locked(events):
                            stored = pool.write_back(
                                session_id, levels, n_tokens
                            )
                            continue
                    evicted = False
                    for vid, victim in list(self._entries.items()):
                        if vid == session_id or victim.engine != engine:
                            continue
                        if pool.is_pinned(vid):
                            continue
                        self._drop(vid, victim)
                        self.n_evictions += 1
                        events.append(
                            {
                                "event": "cache_evict",
                                "session": vid,
                                "bytes": victim.nbytes,
                                "bytes_in_use": self._bytes,
                                "budget_bytes": self.budget_bytes,
                            }
                        )
                        evicted = True
                        break
                    if not evicted:
                        break
                    stored = pool.write_back(session_id, levels, n_tokens)
                if not stored:
                    self.n_rejects += 1
                    events.append(
                        {
                            "event": "cache_reject",
                            "session": session_id,
                            "bytes": nbytes,
                            "budget_bytes": self.budget_bytes,
                            "reason": "pool-exhausted",
                        }
                    )
                else:
                    entry = _Entry(
                        None, engine, now, nbytes=nbytes, n_tokens=n_tokens
                    )
                    self._entries[session_id] = entry
                    self._bytes += entry.nbytes
                    self.n_writes += 1
                    self._peak_bytes = max(self._peak_bytes, self._bytes)
            self._flush(events)
            return stored
        levels = torch.as_tensor(levels).detach().cpu()
        with self._lock:
            if _nbytes(levels) > self.budget_bytes:
                self.n_rejects += 1
                events.append(
                    {
                        "event": "cache_reject",
                        "session": session_id,
                        "bytes": _nbytes(levels),
                        "budget_bytes": self.budget_bytes,
                    }
                )
                stored = False
            else:
                old = self._entries.pop(session_id, None)
                if old is not None:
                    self._bytes -= old.nbytes
                entry = _Entry(levels, engine, now)
                self._entries[session_id] = entry
                self._bytes += entry.nbytes
                self.n_writes += 1
                swept = False
                while self._bytes > self.budget_bytes:
                    # Eviction pressure: reclaim EXPIRED entries first
                    # (the TTL-at-lookup-only leak — a dead session's
                    # bytes stay pinned until someone touches the key),
                    # then live LRU victims.
                    if not swept:
                        swept = True
                        if self._sweep_expired_locked(events):
                            continue
                    if not self._evict_lru_locked(
                        events, skip=(session_id,)
                    ):
                        break
                self._peak_bytes = max(self._peak_bytes, self._bytes)
                stored = True
        self._flush(events)
        return stored

    def _store_delta(
        self,
        session_id: str,
        levels,
        engine: str,
        n_tokens: int,
        pool,
        now: float,
        *,
        patches: Optional[np.ndarray] = None,
        content_hash: Optional[str] = None,
    ) -> bool:
        """The DELTA-mode store: the pool lays down a base / appends a
        sparse delta / folds the chain (write_back_stream); the cache
        keeps residency policy — sweep-then-LRU under pool exhaustion AND
        under the byte budget, both priced on the pools' ACTUAL pages.
        Every outcome is a stamped event: cache_delta (base or sparse
        append, with the explicit atol the compare gate reads),
        cache_compact (chain folded), cache_share (base aliased)."""
        events: List[dict] = []
        with self._lock:
            old = self._entries.pop(session_id, None)
            if old is not None:
                self._bytes -= old.nbytes
                if old.engine != engine:
                    self.pools[old.engine].free(session_id, reason="moved")
            swept = False
            info = pool.write_back_stream(
                session_id, levels, n_tokens, content_hash=content_hash
            )
            while info is None:
                if not swept:
                    swept = True
                    if self._sweep_expired_locked(events):
                        info = pool.write_back_stream(
                            session_id, levels, n_tokens,
                            content_hash=content_hash,
                        )
                        continue
                evicted = False
                for vid, victim in list(self._entries.items()):
                    if vid == session_id or victim.engine != engine:
                        continue
                    if pool.is_pinned(vid):
                        continue
                    self._drop(vid, victim)
                    self.n_evictions += 1
                    events.append(
                        {
                            "event": "cache_evict",
                            "session": vid,
                            "bytes": victim.nbytes,
                            "bytes_in_use": self._bytes,
                            "budget_bytes": self.budget_bytes,
                        }
                    )
                    evicted = True
                    break
                if not evicted:
                    break
                info = pool.write_back_stream(
                    session_id, levels, n_tokens, content_hash=content_hash
                )
            if info is None:
                from glom_tpu_torch.serve.paged_columns import pages_for_tokens

                self.n_rejects += 1
                events.append(
                    {
                        "event": "cache_reject",
                        "session": session_id,
                        "bytes": pages_for_tokens(n_tokens, pool.page_tokens)
                        * pool.page_bytes,
                        "budget_bytes": self.budget_bytes,
                        "reason": "pool-exhausted",
                    }
                )
                if old is not None and old.engine == engine:
                    # The failed append rolled nothing forward — the pool
                    # still holds the session's PREVIOUS state. Reinstate
                    # the entry so that block stays reachable (lookups
                    # serve the old frame's warmth) and EVICTABLE —
                    # popping it while the pool kept the pages would
                    # strand them outside every eviction walk.
                    self._entries[session_id] = old
                self._recount_locked()
                self._flush(events)
                return False
            nbytes = info["session_pages"] * pool.page_bytes
            entry = _Entry(
                None, engine, now, nbytes=nbytes, n_tokens=n_tokens
            )
            if patches is not None:
                entry.prev_input = np.ascontiguousarray(
                    np.asarray(patches, np.float32)
                )
            self._entries[session_id] = entry
            self.n_writes += 1
            self._recount_locked()
            # Budget pressure on ACTUAL bytes (shared bases counted once,
            # chains at their sparse size): sweep expired first, then LRU.
            while self._bytes > self.budget_bytes:
                if not swept:
                    swept = True
                    if self._sweep_expired_locked(events):
                        continue
                if not self._evict_lru_locked(events, skip=(session_id,)):
                    break
            event = {
                "base": "cache_delta",
                "delta": "cache_delta",
                "share": "cache_share",
                "compact": "cache_compact",
            }[info["kind"]]
            events.append(
                {
                    "event": event,
                    "session": session_id,
                    "kind": info["kind"],
                    "pages_written": info["pages_written"],
                    "chain_len": info["chain_len"],
                    "base_refs": info.get("base_refs"),
                    "bytes": nbytes,
                    "bytes_in_use": self._bytes,
                    "delta_page_atol": pool.delta_page_atol,
                    **(
                        {"empty": True} if info.get("empty") else {}
                    ),
                    **(
                        {"compact_deferred": True}
                        if info.get("compact_deferred")
                        else {}
                    ),
                }
            )
        self._flush(events)
        return True

    def input_support(
        self, session_id: str, patches: np.ndarray, page_tokens: int
    ) -> np.ndarray:
        """[n_pages] bool — which INPUT pages of this frame changed vs
        the session's previous frame (bitwise: a hold frame is empty
        support, a moving region is exactly its pages). No previous
        frame, or a resolution change, marks every page changed — the
        conservative seed (the row behaves like plain tiered exit). This
        is the support `glom_forward_incremental` seeds the witness
        from; pre-converged rows still pay the min_iters floor."""
        with self._lock:
            entry = self._entries.get(session_id)
            prev = entry.prev_input if entry is not None else None
        patches = np.asarray(patches, np.float32)
        n = patches.shape[0]
        n_pages = -(-n // page_tokens)
        if prev is None or prev.shape != patches.shape:
            return np.ones((n_pages,), bool)
        same = (
            patches.view(np.int32) == prev.view(np.int32)
        )  # bitcast compare: -0.0 vs 0.0 is a CHANGE
        out = np.zeros((n_pages,), bool)
        for k in range(n_pages):
            out[k] = not bool(
                same[k * page_tokens:(k + 1) * page_tokens].all()
            )
        return out

    # -- invalidation ------------------------------------------------------

    def invalidate(self, session_id: str, *, reason: str = "explicit") -> bool:
        """Drop one session's entry (stream ended, client reset)."""
        events: List[dict] = []
        with self._lock:
            entry = self._entries.get(session_id)
            if entry is None:
                return False
            self._drop(session_id, entry)
            self.n_invalidations += 1
            events.append(
                {
                    "event": "cache_invalidate",
                    "session": session_id,
                    "reason": reason,
                    "bytes": entry.nbytes,
                }
            )
        self._flush(events)
        return True

    def invalidate_engine(self, engine: str, *, reason: str = "engine-failover") -> int:
        """Drop EVERY entry the named engine wrote — called by the
        batcher on a dispatch failure / engine death, so state produced
        near the failure can never warm-start a request. Returns how many
        entries were dropped."""
        events: List[dict] = []
        with self._lock:
            victims = [
                (sid, e) for sid, e in self._entries.items()
                if e.engine == engine
            ]
            for sid, entry in victims:
                self._drop(sid, entry)
                self.n_invalidations += 1
            if victims:
                events.append(
                    {
                        "event": "cache_invalidate",
                        "engine": engine,
                        "reason": reason,
                        "n_entries": len(victims),
                        "bytes": sum(e.nbytes for _, e in victims),
                    }
                )
        self._flush(events)
        return len(victims)

    # -- internals ---------------------------------------------------------

    def _drop(self, session_id: str, entry: _Entry) -> None:
        # Caller holds the lock. In pages mode the entry's pages return
        # to its pool's free list (cache lock -> pool lock, the
        # documented order; the pool stamps its own page_free).
        self._entries.pop(session_id, None)
        self._bytes -= entry.nbytes
        if self.pools is not None:
            self.pools[entry.engine].free(session_id)
        if self.delta:
            # A dropped session may have been the charged owner of a
            # still-shared base, or an un-charged aliaser of one — the
            # per-entry nbytes cannot know which at drop time. Recount
            # from the pools' ACTUAL page occupancy instead.
            self._recount_locked()

    def _recount_locked(self) -> None:
        """DELTA mode: _bytes mirrors the pools' actual page occupancy
        (caller holds the cache lock; pool locks nest inside — the
        documented order)."""
        self._bytes = sum(p.bytes_in_use() for p in self.pools.values())
        self._peak_bytes = max(self._peak_bytes, self._bytes)

    def _flush(self, events: List[dict]) -> None:
        from glom_tpu_torch.serve.events import emit_serve

        for rec in events:
            emit_serve(self.writer, rec)

    # -- observability -----------------------------------------------------

    def bytes_in_use(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def record(self) -> dict:
        """The cache rollup the batcher nests under its summary record:
        counters plus live/peak bytes against the budget — the numbers
        the temporal bench's acceptance reads (`bytes_peak` must never
        exceed `budget_bytes`)."""
        with self._lock:
            rec = {
                "n_sessions": len(self._entries),
                "bytes_in_use": self._bytes,
                "bytes_peak": self._peak_bytes,
                "budget_bytes": self.budget_bytes,
                "ttl_s": self.ttl_s,
                "n_hits": self.n_hits,
                "n_misses": self.n_misses,
                "n_writes": self.n_writes,
                "n_evictions": self.n_evictions,
                "n_expirations": self.n_expirations,
                "n_invalidations": self.n_invalidations,
                "n_rejects": self.n_rejects,
            }
            if self.delta:
                # The cache-delta nest (docs/OBSERVABILITY.md): bytes and
                # chain length are COSTS the compare gate flattens as
                # serve_cache_delta.* rows; the atol is the explicit
                # tolerance stamp (0.0 = bitwise reconstruction).
                n_sessions = len(self._entries)
                agg: dict = {
                    "bytes_per_stream": (
                        round(self._bytes / n_sessions, 1)
                        if n_sessions
                        else None
                    ),
                }
                for p in self.pools.values():
                    sub = p.record().get("delta")
                    if not sub:
                        continue
                    agg.setdefault(
                        "delta_page_atol", sub["delta_page_atol"]
                    )
                    agg.setdefault(
                        "delta_chain_cap", sub["delta_chain_cap"]
                    )
                    agg["delta_chain_len_max"] = max(
                        agg.get("delta_chain_len_max", 0),
                        sub["delta_chain_len_max"],
                    )
                    for k in (
                        "n_delta_writes", "n_delta_pages", "n_delta_empty",
                        "n_compactions", "n_compact_deferred",
                        "n_base_shares",
                    ):
                        agg[k] = agg.get(k, 0) + sub[k]
                rec["delta"] = agg
            return rec


def resolve_column_cache(scfg, *, writer=None, pools=None) -> Optional[ColumnCache]:
    """The one config -> cache resolution: `column_cache_bytes > 0`
    builds the cache with the configured TTL, 0 disables streaming
    warm-start entirely (every request cold-starts). `pools` (engine name -> PagedColumnPool, resolved by the
    batcher from the engines' page pools) switches the cache to PAGES
    mode: entries are page-table references and the warm path is
    device-resident (docs/SERVING.md, "Paged column memory")."""
    if getattr(scfg, "column_cache_bytes", 0) <= 0:
        return None
    return ColumnCache(
        scfg.column_cache_bytes,
        ttl_s=scfg.column_cache_ttl_s,
        writer=writer,
        pools=pools or None,
    )
