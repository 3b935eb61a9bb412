"""The port's session column cache (`serve/column_cache.py`) against
glom_tpu's, on the same call sequences: host mode (LRU under the byte
budget, TTL on an injected clock, rejections, invalidation by session and
by engine) and pages mode over each package's `PagedColumnPool` (plain and
delta). After each step the counters (`record()`), the stamped events (all
fields but the backend state, which each package reads from its own
runtime) and the entries' bits must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu.serve import column_cache as jcc
from glom_tpu.serve import paged_columns as jpaged
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import GlomConfig, ServeConfig
from glom_tpu_torch.serve import column_cache as tcc
from glom_tpu_torch.serve import paged_columns as tpaged
from test_torch_port_model import TINY

PT = 4
L, D, N = TINY["levels"], TINY["dim"], 16
ROW_BYTES = N * L * D * 4


class ListWriter:
    def __init__(self):
        self.recs = []

    def write(self, rec):
        self.recs.append(rec)


def _events(recs):
    return [{k: v for k, v in r.items() if k != "backend_state"} for r in recs]


def _rows(seed, count, n=N):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, L, D)).astype(np.float32) for _ in range(count)]


class Pair:
    """One cache per package on one clock; `do` calls a method on both and
    holds their answers, records and events equal."""

    def __init__(self, budget, ttl=None, pools=None):
        self.t = [0.0]
        clock = lambda: self.t[0]  # noqa: E731
        self.jw, self.tw = ListWriter(), ListWriter()
        jpools = tpools = None
        if pools is not None:
            kw = dict(page_pool_pages=pools.pop("pages"), page_tokens=PT, **pools)
            jpools = {e: jpaged.PagedColumnPool(jconfig.GlomConfig(**TINY),
                                                jconfig.ServeConfig(**kw), writer=self.jw,
                                                name=e) for e in ("e0", "e1")}
            tpools = {e: tpaged.PagedColumnPool(GlomConfig(**TINY), ServeConfig(**kw),
                                                writer=self.tw, name=e, device="cpu")
                      for e in ("e0", "e1")}
        self.j = jcc.ColumnCache(budget, ttl_s=ttl, writer=self.jw, clock=clock, pools=jpools)
        self.p = tcc.ColumnCache(budget, ttl_s=ttl, writer=self.tw, clock=clock, pools=tpools)

    def do(self, method, *args, **kw):
        targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) and self.j.pools else a
                 for a in args]
        got = getattr(self.p, method)(*targs, **kw)
        want = getattr(self.j, method)(*jargs, **kw)
        if isinstance(want, (np.ndarray, jnp.ndarray)):
            if want.dtype != bool:  # a host entry: a CPU tensor in the port
                assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        else:
            assert got == want, (method, got, want)
        self.check()
        return got

    def check(self):
        assert self.p.record() == self.j.record()
        assert len(self.p) == len(self.j) and self.p.bytes_in_use() == self.j.bytes_in_use()
        assert _events(self.tw.recs) == _events(self.jw.recs)
        assert self.p.bytes_in_use() <= self.p.budget_bytes


def test_column_state_bytes():
    for dtype in ("float32", "bfloat16"):
        assert tcc.column_state_bytes(GlomConfig(**TINY), ServeConfig(compute_dtype=dtype)) == (
            jcc.column_state_bytes(jconfig.GlomConfig(**TINY),
                                   jconfig.ServeConfig(compute_dtype=dtype)))


def test_host_mode_lru_budget_and_invalidation():
    c = Pair(budget=3 * ROW_BYTES)
    rows = _rows(0, 5)
    for k in range(3):
        assert c.do("store", f"s{k}", rows[k], engine="e0")
    c.do("lookup", "s0")  # s0 becomes the most recent
    assert c.do("store", "s3", rows[3], engine="e1")  # evicts s1, the LRU
    assert c.do("lookup", "s1") is None
    c.do("lookup", "s0")
    assert not c.do("store", "big", np.zeros((4 * N, L, D), np.float32), engine="e0")
    assert c.do("invalidate", "s2") and not c.do("invalidate", "s2")
    assert c.do("invalidate_engine", "e0") == 1  # s0
    assert c.do("invalidate_engine", "e1") == 1
    assert len(c.p) == 0 and c.p.record()["n_evictions"] == 1


def test_host_mode_ttl_and_the_sweep():
    c = Pair(budget=2 * ROW_BYTES, ttl=10.0)
    rows = _rows(1, 4)
    c.do("store", "a", rows[0], engine="e0")
    c.t[0] = 5.0
    c.do("store", "b", rows[1], engine="e0")
    c.t[0] = 12.0
    assert c.do("lookup", "a") is None  # expired at lookup
    c.do("lookup", "b")
    c.t[0] = 16.0
    c.do("store", "c", rows[2], engine="e0")
    c.do("store", "d", rows[3], engine="e0")  # pressure sweeps b first
    assert c.p.record()["n_expirations"] == 2


@pytest.mark.parametrize("delta", [False, True])
def test_pages_mode(delta):
    """Write-backs land in the named engine's pool, lookups return pinned
    PageHits, eviction and invalidation free pages; in delta mode the pool
    stores base + delta chains and the cache prices its actual pages."""
    extra = dict(delta_streaming=True, delta_chain_cap=2) if delta else {}
    c = Pair(budget=12 * PT * L * D * 4, pools=dict(pages=12, **extra))
    a, b, x = _rows(2, 3)
    patches = np.random.default_rng(3).standard_normal((N, 48)).astype(np.float32)
    kw = dict(patches=patches) if delta else {}
    assert c.do("store", "a", a, engine="e0", n_tokens=N, **kw)
    assert c.do("store", "b", b[:10], engine="e0", n_tokens=10)
    hit = c.do("lookup", "a", pin=True)
    assert hit.engine == "e0" and len(hit.pages) == 4
    assert c.do("engine_of", "a") == "e0"
    bumped = a.copy()
    bumped[:PT] += 1.0  # one changed page: a sparse delta in delta mode
    assert c.do("store", "a", bumped, engine="e0", n_tokens=N, **kw)
    c.do("unpin", "a")
    if delta:
        same = c.do("input_support", "a", patches, PT)
        assert not same.any()
        moved = patches.copy()
        moved[PT] += 1.0
        assert c.do("input_support", "a", moved, PT).tolist() == [False, True, False, False]
    assert c.do("store", "x", x, engine="e1", n_tokens=N)
    c.do("store", "b", b, engine="e1", n_tokens=N)  # moved engines: e0's pages freed
    assert c.do("invalidate_engine", "e1") == 2
    assert c.do("lookup", "b") is None
    c.do("lookup", "a")
    assert c.p.record()["n_invalidations"] == 2
