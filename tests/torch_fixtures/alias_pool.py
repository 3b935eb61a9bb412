"""Torch twin of tests/fixtures/alias_pool.py, line for line, for the port's
donation-safety aliased-pool pinning rule (analysis/donation.py): with
in-place pool aliasing the pool's write-back writes the shared buffer's
pages IN PLACE, so any dispatch still reading it must hold a read pin —
`acquire_read()` / `release_read()` — to force the write-back onto the
copy-on-write fallback.

LeakyPoolEngine feeds a bare `pool.buffer()` into its dispatch (both the
bound-name and the inline-call shapes) — on an aliasing pool a concurrent
write-back changes that buffer's pages mid-dispatch, a race no CPU test
reproduces. SafePoolEngine pins through acquire_read()/release_read()
around the same dispatch and must scan clean; so must its warm-up
`pool.buffer().dtype` probe (a read that never reaches a dispatch — the
engine's real warmup shape).

NOT imported: the tests run the checker over this file and assert the
unpinned dispatches are flagged at file:line on the leaky class only.
"""

import functools


class LeakyPoolEngine:
    """Bare buffer() into a dispatch — flagged twice (named and inline),
    the exact hazard pool aliasing's read-pin seam exists for."""

    def __init__(self, pool):
        self.pool = pool
        self._compiled = {}

    def _fwd(self, params, buf, idx):
        return buf[idx] * 2

    def _compile(self, sig, abstract):  # noqa: ARG002 — the jax twin's shape
        if sig in self._compiled:
            return self._compiled[sig]
        compiled = functools.partial(  # the signature's eager forward
            self._fwd,
        )
        self._compiled[sig] = compiled
        return compiled

    def infer(self, sig, abstract, params, idx):
        fn = self._compile(sig, abstract)
        buf = self.pool.buffer()  # BUG: no read pin
        return fn(params, buf, idx)

    def infer_inline(self, sig, abstract, params, idx):
        fn = self._compile(sig, abstract)
        return fn(params, self.pool.buffer(), idx)  # BUG: no read pin


class SafePoolEngine:
    """Same dispatch, pinned reads: acquire_read() holds the pool's CoW
    fallback open for the dispatch's lifetime."""

    def __init__(self, pool):
        self.pool = pool
        self._compiled = {}

    def _fwd(self, params, buf, idx):
        return buf[idx] * 2

    def _compile(self, sig, abstract):  # noqa: ARG002 — the jax twin's shape
        if sig in self._compiled:
            return self._compiled[sig]
        compiled = functools.partial(  # the signature's eager forward
            self._fwd,
        )
        self._compiled[sig] = compiled
        return compiled

    def infer(self, sig, abstract, params, idx):
        fn = self._compile(sig, abstract)
        buf = self.pool.acquire_read()
        try:
            return fn(params, buf, idx)
        finally:
            self.pool.release_read()

    def probe_dtype(self, sig):
        # Compile-time probe: a bare buffer() read that never reaches a
        # dispatch stays clean.
        return self.pool.buffer().dtype
