"""Device-resident paged column memory: the page pool behind the warm
serving path and ragged admission.

Counterpart of `glom_tpu/serve/paged_columns.py`. Warm column state stays
where it is used:

  * ONE preallocated device buffer of `[n_pages, page_tokens, L, d]` per
    engine (the pool), one `torch.zeros` on the engine's device, sized by
    `ServeConfig.page_pool_pages`;
  * a host-side page table mapping a session to its page indices:
    allocation hands out free pages (no contiguity needed: the dispatch
    gathers by index), free returns them, and `defrag()` compacts
    allocated pages toward low indices;
  * write-back copies a resolved row's columns device-to-device into the
    session's pages (`write_back`), and the warm dispatch assembles
    `levels0` from the pool by a page-index gather
    (serve/engine.InferenceEngine.take_pages): no column state crosses
    from the host on the warm path;
  * pages are pinned while a dispatch reads them (`pin`/`unpin` through
    `lookup(pin=True)`), and engine death force-frees.

Write-backs are copy-on-write by default: `clone()` of the whole pool,
`index_copy_` of the written pages, and the reference swapped under the
lock. In-flight dispatches keep reading the buffer they took, and
`cow_bytes_moved` counts the whole pool a write, which is what the copy
moves. With `ServeConfig.pool_aliasing` a write-back is an `index_copy_`
in place on the live buffer, taken only when no read pin is live
(`acquire_read`/`release_read`: the engine holds one around every pool
dispatch until its synchronize); it advances the pool epoch, and a write
that finds a pin falls back to copy-on-write, stamped `alias_fallback`
and counted. Chain compaction and defrag stay copy-on-write (their source
and destination pages can overlap). The page table never aliases; only
the buffer update does.

Ordering: PyTorch's arrays are mutable where glom_tpu's are not, so the
pin gate alone would not keep an in-place write from overtaking a gather
queued before it on another stream. Every pool operation and every
dispatch runs on one stream, the device's current stream, so a gather
enqueued before a write-back reads the old pages. Callers that move work
onto other streams must synchronize before they touch the pool.

Delta streaming (`write_back_stream`): a session keeps a refcounted base
plus a chain of deltas holding only the pages whose residual exceeds
`delta_page_atol` (0.0 compares bits, so -0.0 against 0.0 is a change);
the chain folds into the base at `delta_chain_cap`, superseded chain
pages return to the pool at once, and content-identical bases
(`content_hash`) share pages.

Accounting: every alloc, free, alias and defrag is a stamped "serve"
event (`page_alloc`, `page_free`, `alias_fallback`, `page_alias`,
`page_defrag`) through serve/events.emit_serve, and `record()` rolls
pages, bytes and churn up in glom_tpu's fields.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from glom_tpu_torch.utils.helpers import resolve_device


def resolve_page_tokens(cfg, scfg) -> int:
    """The page granularity in patch tokens. An explicit
    `ServeConfig.page_tokens` must tile the full-resolution row; 0
    resolves to the largest divisor of `num_patches` that is at most
    min(64, num_patches // 4): at least four pages per full-resolution
    row, at most 64 tokens a page (flagship: 256 patches -> 64)."""
    n = cfg.num_patches
    if scfg.page_tokens > 0:
        if n % scfg.page_tokens != 0:
            raise ValueError(
                f"page_tokens {scfg.page_tokens} does not divide "
                f"num_patches {n} (pages must tile the full-resolution row)"
            )
        return scfg.page_tokens
    for cand in range(max(1, min(64, n // 4)), 0, -1):
        if n % cand == 0:
            return cand
    return n  # pragma: no cover: cand = 1 always divides


def pages_for_tokens(n_tokens: int, page_tokens: int) -> int:
    """ceil(n_tokens / page_tokens): the pages one row's columns occupy."""
    if n_tokens < 1:
        raise ValueError(f"n_tokens {n_tokens} must be >= 1")
    return -(-n_tokens // page_tokens)


def page_state_bytes(cfg, scfg, page_tokens: Optional[int] = None) -> int:
    """The bytes of ONE page: page_tokens x levels x dim in the serving
    dtype."""
    pt = page_tokens if page_tokens is not None else resolve_page_tokens(cfg, scfg)
    itemsize = 2 if scfg.compute_dtype == "bfloat16" else 4
    return pt * cfg.levels * cfg.dim * itemsize


def content_hash(levels_row) -> str:
    """sha256 over the exact bytes of one row's columns, the key of base
    sharing in `write_back_stream`: glom_tpu's batcher hashes the host
    copy of the row in the serving dtype, and these are the same bytes
    (little-endian f32, or bf16's raw 16 bits)."""
    row = torch.as_tensor(levels_row).detach().contiguous().cpu()
    return hashlib.sha256(row.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


class _Block:
    """One session's page-table entry: the ordered page indices holding
    its column state (block ordinal k covers tokens [k*pt, (k+1)*pt))."""

    __slots__ = ("pages", "n_tokens", "pins")

    def __init__(self, pages: List[int], n_tokens: int):
        self.pages = pages
        self.n_tokens = n_tokens
        self.pins = 0


class _BaseBlock:
    """A delta-mode base: a whole-row page set, refcounted so sessions
    with content-identical bases share the same read-only pool pages.
    Its pages free only when the last referencing session drops."""

    __slots__ = ("pages", "n_tokens", "refs", "hkey")

    def __init__(self, pages: List[int], n_tokens: int, hkey=None):
        self.pages = pages
        self.n_tokens = n_tokens
        self.refs = 1
        self.hkey = hkey


class _DeltaBlock:
    """A delta-mode session entry: a (possibly shared) base plus a chain
    of deltas, each a {block ordinal -> page index} map of only the pages
    whose residual exceeded `delta_page_atol`. The effective page map is
    the base overridden by the chain, newest last, so reconstruction is
    the same page-index gather every paged dispatch uses."""

    __slots__ = ("base", "deltas", "n_tokens", "pins")

    def __init__(self, base: _BaseBlock, n_tokens: int):
        self.base = base
        self.deltas: List[Dict[int, int]] = []
        self.n_tokens = n_tokens
        self.pins = 0

    def effective(self) -> List[int]:
        pages = list(self.base.pages)
        for d in self.deltas:
            for ordinal, page in d.items():
                pages[ordinal] = page
        return pages

    def delta_pages(self) -> List[int]:
        return [p for d in self.deltas for p in d.values()]


class PagedColumnPool:
    """Fixed-size device page pool and host page table for one engine.

    `device` is the engine's (the buffer lives there); the injectable
    `writer` receives the stamped page events through the writer-else-
    flight path. glom_tpu's `pool_sharding` (a pool sharded over a mesh)
    comes with the meshes, ROADMAP queue A item 8b."""

    def __init__(self, cfg, scfg, *, writer=None, name: str = "engine0", device="cuda"):
        if scfg.page_pool_pages < 1:
            raise ValueError(
                f"page_pool_pages {scfg.page_pool_pages} must be >= 1 to "
                "build a pool (0 disables paged columns: resolve first)"
            )
        self.cfg = cfg
        self.scfg = scfg
        self.name = name
        self.writer = writer
        self.device = resolve_device(device)
        self.page_tokens = resolve_page_tokens(cfg, scfg)
        self.n_pages = int(scfg.page_pool_pages)
        self.page_bytes = page_state_bytes(cfg, scfg, self.page_tokens)
        self.pool_bytes = self.n_pages * self.page_bytes
        self._dtype = torch.bfloat16 if scfg.compute_dtype == "bfloat16" else torch.float32
        self._lock = threading.Lock()
        self._table: Dict[str, object] = {}
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self.n_allocs = 0
        self.n_frees = 0
        self.n_alloc_fails = 0
        self.n_writebacks = 0
        self.n_defrag_moves = 0
        self._pages_peak = 0
        # Delta streaming: sessions written through write_back_stream hold
        # a refcounted base plus a chain of sparse deltas.
        self.delta = bool(scfg.delta_streaming)
        self.delta_page_atol = float(scfg.delta_page_atol)
        self.delta_chain_cap = int(scfg.delta_chain_cap)
        self._share = bool(scfg.delta_base_share)
        self._hash_index: Dict[str, _BaseBlock] = {}
        self.n_delta_writes = 0
        self.n_delta_pages = 0
        self.n_delta_empty = 0
        self.n_compactions = 0
        self.n_compact_deferred = 0
        self.n_base_shares = 0
        self.n_superseded = 0
        # In-place aliasing: writes in place gated by the read-pin count;
        # the epoch counts buffer identities (an in-place write retires the
        # snapshot before it). The bytes-moved counters price the two
        # arms: a CoW write copies the whole pool, an aliased write only
        # the pages written.
        self.aliasing = bool(scfg.pool_aliasing)
        self._epoch = 0
        self._read_pins = 0
        self.n_alias_writes = 0
        self.n_alias_fallbacks = 0
        self.alias_bytes_moved = 0
        self.cow_bytes_moved = 0
        # The preallocated buffer, zeros; warm traffic never grows it.
        self._buffer: Optional[torch.Tensor] = torch.zeros(
            (self.n_pages, self.page_tokens, cfg.levels, cfg.dim),
            dtype=self._dtype, device=self.device,
        )

    # -- the page table ----------------------------------------------------

    def buffer(self) -> Optional[torch.Tensor]:
        """The current pool buffer (a snapshot). Under aliasing an in-place
        write-back changes an unpinned snapshot's pages; the dispatch path
        takes `acquire_read()` instead."""
        with self._lock:
            return self._buffer

    def acquire_read(self) -> torch.Tensor:
        """Pin the current buffer for one dispatch and return it. While any
        read pin is live, write-backs do not write in place (they fall
        back to copy-on-write, stamped `alias_fallback`), so the returned
        buffer keeps its pages for the dispatch's lifetime, through its
        synchronize. Pair with `release_read()` in a finally."""
        with self._lock:
            if self._buffer is None:
                raise RuntimeError(
                    f"pool {self.name!r} released: dispatch against a "
                    "drained replica is a fleet-bookkeeping bug"
                )
            self._read_pins += 1
            return self._buffer

    def release_read(self) -> None:
        """Drop one dispatch's read pin (the `acquire_read` pair)."""
        with self._lock:
            if self._read_pins <= 0:
                raise RuntimeError("release_read without a matching acquire_read")
            self._read_pins -= 1

    def read_pins(self) -> int:
        with self._lock:
            return self._read_pins

    def epoch(self) -> int:
        """Buffer-identity counter: advances on every in-place write-back.
        Copy-on-write swaps keep the epoch: the old snapshot stays
        readable."""
        with self._lock:
            return self._epoch

    def pages_used(self) -> int:
        with self._lock:
            return self.n_pages - len(self._free)

    def bytes_in_use(self) -> int:
        return self.pages_used() * self.page_bytes

    def holds(self, session_id: str) -> bool:
        with self._lock:
            return session_id in self._table

    def lookup(self, session_id: str, *, pin: bool = False):
        """(pages, n_tokens) for the session, or None. pin=True takes a
        read pin on the block (the dispatch path): it survives eviction
        until the matching unpin. A delta block answers its effective map
        (base overridden by the chain)."""
        with self._lock:
            blk = self._table.get(session_id)
            if blk is None:
                return None
            if pin:
                blk.pins += 1
            if isinstance(blk, _DeltaBlock):
                return blk.effective(), blk.n_tokens
            return list(blk.pages), blk.n_tokens

    def unpin(self, session_id: str) -> None:
        with self._lock:
            blk = self._table.get(session_id)
            if blk is not None and blk.pins > 0:
                blk.pins -= 1

    def is_pinned(self, session_id: str) -> bool:
        with self._lock:
            blk = self._table.get(session_id)
            return blk is not None and blk.pins > 0

    def alloc(self, session_id: str, n_tokens: int) -> Optional[List[int]]:
        """Own ceil(n_tokens / page_tokens) pages under the session key.
        A block of the right size is reused (a stream's frames share a
        resolution); a resized session frees and re-allocates. None when
        the pool lacks free pages (the caller evicts)."""
        need = pages_for_tokens(n_tokens, self.page_tokens)
        events = []
        with self._lock:
            blk = self._table.get(session_id)
            if isinstance(blk, _DeltaBlock):
                raise ValueError(
                    f"session {session_id!r} holds a delta-chain block; "
                    "whole-state alloc() does not compose with "
                    "write_back_stream on one key"
                )
            if blk is not None:
                if len(blk.pages) == need:
                    blk.n_tokens = n_tokens
                    return list(blk.pages)
                events.append(self._free_locked(session_id, blk, "resize"))
            if len(self._free) < need:
                self.n_alloc_fails += 1
                self._flush(events)
                return None
            pages = [self._free.pop() for _ in range(need)]
            self._table[session_id] = _Block(pages, n_tokens)
            self.n_allocs += 1
            used = self.n_pages - len(self._free)
            self._pages_peak = max(self._pages_peak, used)
            events.append(
                {
                    "event": "page_alloc",
                    "session": session_id,
                    "n_pages": need,
                    "n_tokens": n_tokens,
                    "pages_used": used,
                    "pages_total": self.n_pages,
                    "bytes_in_use": used * self.page_bytes,
                }
            )
        self._flush(events)
        return list(pages)

    def free(self, session_id: str, *, reason: str = "evict") -> int:
        """Return the session's pages to the free list. Returns the pages
        freed (0 when absent). Force-frees pinned blocks too: the only
        force callers are death and invalidation paths."""
        with self._lock:
            blk = self._table.get(session_id)
            if blk is None:
                return 0
            ev = self._free_locked(session_id, blk, reason)
            n = ev["n_pages"]
        self._flush([ev])
        return n

    def free_all(self, *, reason: str = "engine-death") -> int:
        """Drop every block (the engine died: its pool state is
        unreachable). One stamped page_free with the totals."""
        with self._lock:
            n = self.n_pages - len(self._free)
            sessions = len(self._table)
            if not sessions:
                return 0
            self._table.clear()
            self._hash_index.clear()
            self._free = list(range(self.n_pages - 1, -1, -1))
            self.n_frees += sessions
            ev = {
                "event": "page_free",
                "reason": reason,
                "n_sessions": sessions,
                "n_pages": n,
                "pages_used": 0,
                "bytes_in_use": 0,
            }
        self._flush([ev])
        return n

    def _free_locked(self, session_id: str, blk, reason: str) -> dict:
        # Caller holds the lock. A delta block frees its chain pages and
        # drops a reference to its base, whose pages return only when the
        # last sharing session drops.
        self._table.pop(session_id, None)
        if isinstance(blk, _DeltaBlock):
            freed = blk.delta_pages()
            blk.base.refs -= 1
            if blk.base.refs == 0:
                freed = freed + blk.base.pages
                if blk.base.hkey is not None:
                    stored = self._hash_index.get(blk.base.hkey)
                    if stored is blk.base:
                        del self._hash_index[blk.base.hkey]
        else:
            freed = blk.pages
        self._free.extend(reversed(freed))
        self.n_frees += 1
        used = self.n_pages - len(self._free)
        return {
            "event": "page_free",
            "session": session_id,
            "reason": reason,
            "n_pages": len(freed),
            "pages_used": used,
            "bytes_in_use": used * self.page_bytes,
        }

    # -- device-side data movement ------------------------------------------

    def _idx(self, pages) -> torch.Tensor:
        return torch.tensor(list(pages), dtype=torch.long, device=self.device)

    def _row_pages(self, levels_row, k: int, n: int) -> torch.Tensor:
        """One row's [n, L, d] columns in the pool's dtype, zero-padded to
        whole pages: [k, page_tokens, L, d]."""
        row = torch.as_tensor(levels_row).to(self.device, self._dtype)
        flat = F.pad(row, (0, 0, 0, 0, 0, k * self.page_tokens - n))
        return flat.reshape(k, self.page_tokens, *row.shape[1:])

    def _scatter_locked(
        self,
        idx: torch.Tensor,
        pages: torch.Tensor,
        *,
        pages_written: int,
        session_id: Optional[str],
        events: List[dict],
    ) -> None:
        """The one write seam (caller holds the lock): `pages` into the
        pool at `idx`. In place when aliasing is on and no dispatch holds
        a read pin (the epoch advances, `page_alias` stamps what moved);
        any live pin forces the copy-on-write fallback, stamped and
        counted."""
        if self.aliasing and self._read_pins == 0:
            self._buffer.index_copy_(0, idx, pages)
            self._epoch += 1
            self.n_alias_writes += 1
            self.alias_bytes_moved += pages_written * self.page_bytes
            events.append(
                {
                    "event": "page_alias",
                    "session": session_id,
                    "n_pages": pages_written,
                    "epoch": self._epoch,
                    "bytes_moved": pages_written * self.page_bytes,
                }
            )
        else:
            self._buffer = self._buffer.clone().index_copy_(0, idx, pages)
            self.cow_bytes_moved += self.pool_bytes
            if self.aliasing:
                self.n_alias_fallbacks += 1
                events.append(
                    {
                        "event": "alias_fallback",
                        "session": session_id,
                        "n_pages": pages_written,
                        "read_pins": self._read_pins,
                        "bytes_moved": self.pool_bytes,
                    }
                )

    def _copy_pages_locked(self, src: List[int], dst: List[int]) -> None:
        """Copy-on-write page copy: the next buffer holds src's pages at
        dst, read from the buffer before the move, so overlapping ranges
        read original values."""
        buf = self._buffer
        moved = buf.index_select(0, self._idx(src))
        self._buffer = buf.clone().index_copy_(0, self._idx(dst), moved)

    def write_back(self, session_id: str, levels_row, n_tokens: int) -> bool:
        """Copy one resolved row's columns ([n_tokens, L, d], on the device:
        a slice of the dispatch's output) into the session's pages,
        allocating on first write. False when allocation failed (pool
        full: the caller evicts and retries)."""
        pages = self.alloc(session_id, n_tokens)
        if pages is None:
            return False
        k = len(pages)
        events: List[dict] = []
        with self._lock:
            # Under the lock: buffer swaps serialize, and the read-pin
            # check that gates the in-place write is atomic with it.
            self._scatter_locked(
                self._idx(pages), self._row_pages(levels_row, k, n_tokens),
                pages_written=k, session_id=session_id, events=events,
            )
            self.n_writebacks += 1
        self._flush(events)
        return True

    # -- delta streaming ----------------------------------------------------

    def _alloc_raw_locked(self, need: int) -> Optional[List[int]]:
        """Pop `need` free pages (caller holds the lock), or None."""
        if len(self._free) < need:
            self.n_alloc_fails += 1
            return None
        return [self._free.pop() for _ in range(need)]

    def _residual(self, eff: List[int], rows: torch.Tensor):
        """Per-page residual of one row's new pages against its effective
        pages: ([k] any bit differs, [k] max abs f32) on the host. The
        bits compare through an integer view of the same width, so 0.0
        against -0.0 reads as a change."""
        cur = self._buffer.index_select(0, self._idx(eff))
        int_t = torch.int16 if self._dtype == torch.bfloat16 else torch.int32
        bits = (cur.view(int_t) != rows.view(int_t)).flatten(1).any(dim=1)
        diff = (cur.float() - rows.float()).abs().flatten(1).amax(dim=1)
        return bits.cpu().numpy(), diff.cpu().numpy()

    def delta_chain_len(self, session_id: str) -> Optional[int]:
        with self._lock:
            blk = self._table.get(session_id)
            if not isinstance(blk, _DeltaBlock):
                return None
            return len(blk.deltas)

    def base_refs(self, session_id: str) -> Optional[int]:
        with self._lock:
            blk = self._table.get(session_id)
            if not isinstance(blk, _DeltaBlock):
                return None
            return blk.base.refs

    def _compact_locked(self, session_id: str, blk: _DeltaBlock, events) -> bool:
        """Fold base + deltas into one base on the device. A pinned
        session defers (an in-flight dispatch took its chain's page
        indices); a sole-owner base compacts in place (only overridden
        ordinals copy); a shared base copies into fresh pages so the
        sharing sessions keep theirs bit for bit. True when the chain
        folded."""
        if blk.pins > 0:
            self.n_compact_deferred += 1
            return False
        overridden = sorted({o for d in blk.deltas for o in d.keys()})
        eff = blk.effective()
        chain_pages = blk.delta_pages()
        if blk.base.refs == 1:
            if overridden:
                self._copy_pages_locked(
                    [eff[o] for o in overridden], [blk.base.pages[o] for o in overridden]
                )
            if blk.base.hkey is not None:
                # The content changed: the registered hash no longer names
                # these pages.
                stored = self._hash_index.get(blk.base.hkey)
                if stored is blk.base:
                    del self._hash_index[blk.base.hkey]
                blk.base.hkey = None
        else:
            fresh = self._alloc_raw_locked(len(blk.base.pages))
            if fresh is None:
                # Too tight to copy a shared base: keep the over-cap chain.
                self.n_compact_deferred += 1
                return False
            self._copy_pages_locked(eff, fresh)
            blk.base.refs -= 1
            blk.base = _BaseBlock(fresh, blk.n_tokens, hkey=None)
        blk.deltas = []
        if chain_pages:
            self._free.extend(reversed(chain_pages))
            used = self.n_pages - len(self._free)
            events.append(
                {
                    "event": "page_free",
                    "session": session_id,
                    "reason": "compact",
                    "n_pages": len(chain_pages),
                    "pages_used": used,
                    "bytes_in_use": used * self.page_bytes,
                }
            )
        self.n_compactions += 1
        return True

    def write_back_stream(
        self,
        session_id: str,
        levels_row,
        n_tokens: int,
        *,
        content_hash: Optional[str] = None,
    ) -> Optional[dict]:
        """The delta-mode write-back: the first store lays down (or
        shares) a base; every later store compares the row's pages with
        the session's effective pages and appends a delta holding only the
        pages past `delta_page_atol` (0.0: any changed bit). The chain
        folds at `delta_chain_cap`. `content_hash` (`content_hash(row)`)
        keys base sharing across sessions. Returns an info dict, or None
        when the pool lacks pages (the caller evicts and retries)."""
        need = pages_for_tokens(n_tokens, self.page_tokens)
        events: List[dict] = []
        info: Optional[dict] = None
        with self._lock:
            blk = self._table.get(session_id)
            if blk is not None and not isinstance(blk, _DeltaBlock):
                events.append(self._free_locked(session_id, blk, "delta-convert"))
                blk = None
            if blk is not None and blk.n_tokens != n_tokens:
                events.append(self._free_locked(session_id, blk, "resize"))
                blk = None
            if blk is None:
                shared = None
                if content_hash is not None and self._share:
                    cand = self._hash_index.get(content_hash)
                    if cand is not None and cand.n_tokens == n_tokens:
                        shared = cand
                if shared is not None:
                    shared.refs += 1
                    self._table[session_id] = _DeltaBlock(shared, n_tokens)
                    self.n_base_shares += 1
                    info = {
                        "kind": "share",
                        "pages_written": 0,
                        "chain_len": 0,
                        "base_refs": shared.refs,
                    }
                else:
                    pages = self._alloc_raw_locked(need)
                    if pages is None:
                        self._flush(events)
                        return None
                    self._scatter_locked(
                        self._idx(pages), self._row_pages(levels_row, need, n_tokens),
                        pages_written=need, session_id=session_id, events=events,
                    )
                    self.n_writebacks += 1
                    base = _BaseBlock(pages, n_tokens, hkey=content_hash)
                    if content_hash is not None and self._share:
                        self._hash_index[content_hash] = base
                    self._table[session_id] = _DeltaBlock(base, n_tokens)
                    self.n_allocs += 1
                    used = self.n_pages - len(self._free)
                    self._pages_peak = max(self._pages_peak, used)
                    events.append(
                        {
                            "event": "page_alloc",
                            "session": session_id,
                            "n_pages": need,
                            "n_tokens": n_tokens,
                            "delta_base": True,
                            "pages_used": used,
                            "pages_total": self.n_pages,
                            "bytes_in_use": used * self.page_bytes,
                        }
                    )
                    info = {
                        "kind": "base",
                        "pages_written": need,
                        "chain_len": 0,
                        "base_refs": 1,
                    }
            else:
                rows = self._row_pages(levels_row, need, n_tokens)
                bits, diff = self._residual(blk.effective(), rows)
                if self.delta_page_atol <= 0.0:
                    changed_mask = bits
                else:
                    changed_mask = diff > self.delta_page_atol
                ordinals = [int(o) for o in np.nonzero(changed_mask)[0]]
                if not ordinals:
                    self.n_delta_empty += 1
                    info = {
                        "kind": "delta",
                        "pages_written": 0,
                        "chain_len": len(blk.deltas),
                        "empty": True,
                    }
                else:
                    pages = self._alloc_raw_locked(len(ordinals))
                    if pages is None:
                        self._flush(events)
                        return None
                    self._scatter_locked(
                        self._idx(pages), rows.index_select(0, self._idx(ordinals)),
                        pages_written=len(ordinals), session_id=session_id, events=events,
                    )
                    blk.deltas.append(dict(zip(ordinals, pages)))
                    self.n_delta_writes += 1
                    self.n_delta_pages += len(ordinals)
                    self.n_writebacks += 1
                    # Superseded chain pages (unpinned blocks only): an
                    # ordinal overridden by a newer delta is never read
                    # again, so its page returns to the pool now. Pinned
                    # blocks defer: a dispatch took those indices.
                    if blk.pins == 0 and len(blk.deltas) > 1:
                        covered = set(blk.deltas[-1].keys())
                        kept = [blk.deltas[-1]]
                        superseded: List[int] = []
                        for d in reversed(blk.deltas[:-1]):
                            for o in [o for o in d if o in covered]:
                                superseded.append(d.pop(o))
                            if d:
                                covered |= set(d.keys())
                                kept.append(d)
                        kept.reverse()
                        blk.deltas = kept
                        if superseded:
                            self._free.extend(reversed(superseded))
                            self.n_superseded += len(superseded)
                            used = self.n_pages - len(self._free)
                            events.append(
                                {
                                    "event": "page_free",
                                    "session": session_id,
                                    "reason": "superseded",
                                    "n_pages": len(superseded),
                                    "pages_used": used,
                                    "bytes_in_use": used * self.page_bytes,
                                }
                            )
                    used = self.n_pages - len(self._free)
                    self._pages_peak = max(self._pages_peak, used)
                    events.append(
                        {
                            "event": "page_alloc",
                            "session": session_id,
                            "n_pages": len(ordinals),
                            "n_tokens": n_tokens,
                            "delta": True,
                            "chain_len": len(blk.deltas),
                            "pages_used": used,
                            "pages_total": self.n_pages,
                            "bytes_in_use": used * self.page_bytes,
                        }
                    )
                    info = {
                        "kind": "delta",
                        "pages_written": len(ordinals),
                        "chain_len": len(blk.deltas),
                    }
                    if len(blk.deltas) >= self.delta_chain_cap:
                        if self._compact_locked(session_id, blk, events):
                            info["kind"] = "compact"
                            info["chain_len"] = 0
                        else:
                            info["compact_deferred"] = True
            if info is not None:
                blk = self._table[session_id]
                info["session_pages"] = len(blk.delta_pages()) + (
                    len(blk.base.pages) if blk.base.refs == 1 else 0
                )
                info["base_pages"] = len(blk.base.pages)
                info["base_refs"] = blk.base.refs
        self._flush(events)
        return info

    def read_block(
        self, session_id: str, *, on_device: bool = False
    ) -> Optional[torch.Tensor]:
        """One session's [n_tokens, L, d] columns: a host copy (a CPU
        tensor: numpy has no bfloat16) for the tests' window and the cold
        path's fallback, or with on_device=True a fresh tensor on the
        pool's device (the drain migration's device-to-device copy, on the
        device's current stream, after every earlier pool write)."""
        got = self.lookup(session_id)
        if got is None:
            return None
        pages, n_tokens = got
        # The gather runs outside the lock but under a read pin, so an
        # in-place write-back cannot change the pages mid-gather.
        buf = self.acquire_read()
        try:
            flat = buf.index_select(0, self._idx(pages)).reshape(-1, *buf.shape[2:])
            return flat[:n_tokens] if on_device else flat[:n_tokens].cpu()
        finally:
            self.release_read()

    def defrag(self) -> int:
        """Compact allocated, unpinned pages toward low indices (one
        gather and scatter from the buffer before the move). Returns the
        pages moved; stamps page_defrag. Allocation never needs it (the
        gather is index-addressed): a locality pass for long-lived pools.
        Skipped in delta mode, where blocks interleave shared bases and
        chain pages."""
        if self.delta:
            return 0
        with self._lock:
            blocks = sorted(
                ((sid, blk) for sid, blk in self._table.items() if blk.pins == 0),
                key=lambda kv: min(kv[1].pages),
            )
            pinned_pages = {
                p for blk in self._table.values() if blk.pins > 0 for p in blk.pages
            }
            # Targets: the lowest indices not owned by pinned blocks.
            targets = iter(i for i in range(self.n_pages) if i not in pinned_pages)
            src: List[int] = []
            dst: List[int] = []
            for sid, blk in blocks:
                new_pages = []
                for p in blk.pages:
                    t = next(targets)
                    new_pages.append(t)
                    if t != p:
                        src.append(p)
                        dst.append(t)
                blk.pages = new_pages
            if not src:
                return 0
            used_pages = {p for blk in self._table.values() for p in blk.pages}
            self._free = sorted(
                (i for i in range(self.n_pages) if i not in used_pages), reverse=True
            )
            self._copy_pages_locked(src, dst)
            self.n_defrag_moves += len(src)
            ev = {
                "event": "page_defrag",
                "n_moved": len(src),
                "pages_used": self.n_pages - len(self._free),
                "pages_total": self.n_pages,
            }
        self._flush([ev])
        return len(src)

    def release(self) -> None:
        """A drained engine's device release: free every block (one
        stamped page_free with the totals), then drop the buffer itself,
        the device memory the replica held. `record()` keeps working; any
        further read or write fails loudly on the released buffer."""
        self.free_all(reason="drain-release")
        with self._lock:
            self._buffer = None

    # -- observability -------------------------------------------------------

    def _flush(self, events) -> None:
        from glom_tpu_torch.serve.events import emit_serve

        for rec in events:
            if rec:
                emit_serve(self.writer, dict(rec, engine=self.name))

    def record(self) -> dict:
        """The pool rollup: capacity and churn in pages and bytes, with the
        conservation pair (pages_used + pages_free == pages_total)."""
        with self._lock:
            used = self.n_pages - len(self._free)
            rec = {
                "page_tokens": self.page_tokens,
                "page_bytes": self.page_bytes,
                "pages_total": self.n_pages,
                "pages_used": used,
                "pages_free": len(self._free),
                "pages_peak": self._pages_peak,
                "pool_bytes": self.pool_bytes,
                "bytes_in_use": used * self.page_bytes,
                "n_sessions": len(self._table),
                "n_allocs": self.n_allocs,
                "n_frees": self.n_frees,
                "n_alloc_fails": self.n_alloc_fails,
                "n_writebacks": self.n_writebacks,
                "n_defrag_moves": self.n_defrag_moves,
                # The copy-on-write arm's traffic, present with aliasing
                # off so the comparison has both arms.
                "cow_bytes_moved": self.cow_bytes_moved,
            }
            if self.aliasing:
                writes = self.n_alias_writes + self.n_alias_fallbacks
                rec["alias"] = {
                    "epoch": self._epoch,
                    "n_alias_writes": self.n_alias_writes,
                    "n_alias_fallbacks": self.n_alias_fallbacks,
                    "alias_bytes_moved": self.alias_bytes_moved,
                    "alias_rate": (
                        round(self.n_alias_writes / writes, 4) if writes else None
                    ),
                }
            if self.delta:
                chains = [
                    len(b.deltas) for b in self._table.values() if isinstance(b, _DeltaBlock)
                ]
                rec["delta"] = {
                    "delta_page_atol": self.delta_page_atol,
                    "delta_chain_cap": self.delta_chain_cap,
                    "bytes_per_stream": (
                        round(used * self.page_bytes / len(self._table), 1)
                        if self._table else None
                    ),
                    "delta_chain_len_mean": (
                        round(sum(chains) / len(chains), 3) if chains else 0.0
                    ),
                    "delta_chain_len_max": max(chains) if chains else 0,
                    "n_delta_writes": self.n_delta_writes,
                    "n_delta_pages": self.n_delta_pages,
                    "n_delta_empty": self.n_delta_empty,
                    "n_compactions": self.n_compactions,
                    "n_compact_deferred": self.n_compact_deferred,
                    "n_base_shares": self.n_base_shares,
                    "n_superseded": self.n_superseded,
                }
            return rec


def resolve_page_pool(
    cfg, scfg, *, writer=None, name: str = "engine0", device="cuda"
) -> Optional[PagedColumnPool]:
    """The one config -> pool resolution: `page_pool_pages > 0` builds the
    device pool, 0 builds none."""
    if scfg.page_pool_pages <= 0:
        return None
    return PagedColumnPool(cfg, scfg, writer=writer, name=name, device=device)
