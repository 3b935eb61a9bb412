"""The port's device page pool and paged dispatches against glom_tpu's, on
the CPU.

The same sequence of pool operations runs through
`glom_tpu.serve.paged_columns.PagedColumnPool` and the port's, on rows made
from one numpy seed: after each step the page tables, the free lists,
every counter, `record()`, the stamped events (all fields but the backend
state, which each package reads from its own runtime) and the buffer's
bits must be equal. Then the engine's paged routes: within the port the
paged warm dispatch equals the host-carried one bit for bit, and
`glom_forward_ragged(pool=, page_idx=)` its `levels0` form; against
glom_tpu's engine at f32 rtol 2e-3 / atol 2e-4 (tests/test_torch_port_model.py).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu.models import core as jcore
from glom_tpu.serve import engine as jengine
from glom_tpu.serve import paged_columns as jpaged
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import GlomConfig, InferenceEngine, ServeConfig, params_from_numpy
from glom_tpu_torch.serve import early_exit as tee
from glom_tpu_torch.serve import paged_columns as tpaged
from test_torch_port_model import ATOL, RTOL, TINY, flatten

PT = 4  # page tokens: 4 pages a 16-patch row
L, D, N = TINY["levels"], TINY["dim"], 16


class ListWriter:
    def __init__(self):
        self.recs = []

    def write(self, rec):
        self.recs.append(rec)


def _pools(n_pages=10, **over):
    kw = dict(page_pool_pages=n_pages, page_tokens=PT, **over)
    jw, tw = ListWriter(), ListWriter()
    jp = jpaged.PagedColumnPool(jconfig.GlomConfig(**TINY), jconfig.ServeConfig(**kw), writer=jw)
    tp = tpaged.PagedColumnPool(GlomConfig(**TINY), ServeConfig(**kw), writer=tw, device="cpu")
    return jp, tp, jw, tw


def _rows(seed, n=N, count=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, L, D)).astype(np.float32) for _ in range(count)]


def _events(recs):
    return [{k: v for k, v in r.items() if k != "backend_state"} for r in recs]


def _assert_same(jp, tp, jw, tw, sessions=()):
    """Page tables, free lists, counters, record(), events and buffer bits."""
    assert tp._free == jp._free
    for s in sessions:
        assert tp.lookup(s) == jp.lookup(s), s
        assert tp.is_pinned(s) == jp.is_pinned(s), s
        assert tp.delta_chain_len(s) == jp.delta_chain_len(s), s
        assert tp.base_refs(s) == jp.base_refs(s), s
    assert tp.record() == jp.record()
    assert (tp.epoch(), tp.read_pins()) == (jp.epoch(), jp.read_pins())
    assert _events(tw.recs) == _events(jw.recs)
    jbuf = jp.buffer()
    if jbuf is None:
        assert tp.buffer() is None
    else:
        np.testing.assert_array_equal(
            tp.buffer().numpy().view(np.uint32), np.asarray(jbuf).view(np.uint32))


def _both(jp, tp, method, *args, **kw):
    """Call one pool method on both, port rows as tensors; equal answers."""
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    got, want = getattr(tp, method)(*targs, **kw), getattr(jp, method)(*jargs, **kw)
    assert got == want, (method, got, want)
    return got


class TestPoolParity:
    def test_page_table_sequence(self):
        jp, tp, jw, tw = _pools(n_pages=10)
        a, b, c = _rows(0, count=3)
        assert tp.page_bytes == jp.page_bytes == PT * L * D * 4
        assert _both(jp, tp, "alloc", "a", 16) == [0, 1, 2, 3]
        _both(jp, tp, "alloc", "b", 10)
        assert _both(jp, tp, "alloc", "c", 16) is None  # pool full
        _assert_same(jp, tp, jw, tw, "abc")
        _both(jp, tp, "write_back", "a", a, 16)
        _both(jp, tp, "write_back", "b", b[:10], 10)
        _assert_same(jp, tp, jw, tw, "abc")
        _both(jp, tp, "lookup", "b", pin=True)
        _both(jp, tp, "is_pinned", "b")
        _assert_same(jp, tp, jw, tw, "abc")
        _both(jp, tp, "free", "a")
        _both(jp, tp, "write_back", "c", c[:7], 7)  # 2 pages off the freed ones
        _assert_same(jp, tp, jw, tw, "abc")
        _both(jp, tp, "defrag")  # b is pinned and stays where it is
        _assert_same(jp, tp, jw, tw, "abc")
        np.testing.assert_array_equal(tp.read_block("c").numpy(), np.asarray(jp.read_block("c")))
        _both(jp, tp, "unpin", "b")
        _both(jp, tp, "defrag")
        _assert_same(jp, tp, jw, tw, "abc")
        _both(jp, tp, "write_back", "a", a, 16)  # resize to a different count
        _both(jp, tp, "write_back", "a", a[:5], 5)
        _assert_same(jp, tp, jw, tw, "abc")
        _both(jp, tp, "free_all")
        _assert_same(jp, tp, jw, tw, "abc")
        _both(jp, tp, "write_back", "b", b, 16)
        _both(jp, tp, "release")
        _assert_same(jp, tp, jw, tw, "ab")
        for pool in (tp, jp):
            with pytest.raises(RuntimeError, match="released"):
                pool.acquire_read()

    @pytest.mark.parametrize("atol", [0.0, 0.05])
    def test_delta_streaming(self, atol):
        jp, tp, jw, tw = _pools(n_pages=24, delta_streaming=True, delta_page_atol=atol,
                                delta_chain_cap=3)
        (row0,) = _rows(1)
        row0[5] = 0.0  # page 1
        h0 = tpaged.content_hash(torch.from_numpy(row0))
        assert h0 == hashlib.sha256(np.ascontiguousarray(row0).tobytes()).hexdigest()

        def step(r, s="s", **kw):
            _both(jp, tp, "write_back_stream", s, r, N, **kw)
            _assert_same(jp, tp, jw, tw, ("s", "t"))

        step(row0, content_hash=h0)
        step(row0.copy())  # unchanged: an empty delta
        row1 = row0.copy()
        row1[5] = -0.0  # page 1: a changed bit, no changed value
        row1[9] += 0.5  # page 2
        step(row1)
        row2 = row1.copy()
        row2[9] += 0.5  # page 2 again: supersedes the last delta's page
        row2[13] -= 0.5  # page 3
        step(row2)
        row3 = row2.copy()
        row3[1] += 0.5  # page 0: at atol 0 the chain reaches the cap and folds
        step(row3)
        assert tp.delta_chain_len("s") == (0 if atol == 0 else 2)
        row4 = row3.copy()
        row4[7] += 0.5  # page 1: at atol 0.05 the chain folds now
        step(row4)
        assert tp.record()["delta"]["n_compactions"] == 1
        # The fold changed the base's content, so its hash no longer names
        # it: a second stream with the same hash lays down a base of its own.
        step(row0, s="t", content_hash=h0)
        assert tp.base_refs("t") == 1
        t_row = row0.copy()
        t_row[2] += 1.0
        for _ in range(3):
            t_row = t_row.copy()
            t_row[3] += 1.0
            step(t_row, s="t")
        for s in ("s", "t"):
            np.testing.assert_array_equal(tp.read_block(s).numpy(), np.asarray(jp.read_block(s)))
        np.testing.assert_array_equal(tp.read_block("s").numpy(), row4)
        np.testing.assert_array_equal(tp.read_block("t").numpy(), t_row)
        assert _both(jp, tp, "defrag") == 0  # delta mode skips it
        _both(jp, tp, "free", "s")
        _assert_same(jp, tp, jw, tw, ("s", "t"))

    def test_base_sharing(self):
        jp, tp, jw, tw = _pools(n_pages=24, delta_streaming=True, delta_chain_cap=2)
        (row,) = _rows(2)
        h = tpaged.content_hash(torch.from_numpy(row))
        for s in ("a", "b", "c"):
            _both(jp, tp, "write_back_stream", s, row, N, content_hash=h)
        assert tp.base_refs("a") == 3 and tp.record()["delta"]["n_base_shares"] == 2
        _assert_same(jp, tp, jw, tw, "abc")
        # Compacting a shared base copies it into fresh pages for "b".
        r = row.copy()
        for k in range(2):
            r = r.copy()
            r[4 * k] += 1.0
            _both(jp, tp, "write_back_stream", "b", r, N)
            _assert_same(jp, tp, jw, tw, "abc")
        assert tp.base_refs("a") == 2 and tp.base_refs("b") == 1
        np.testing.assert_array_equal(tp.read_block("a").numpy(), row)
        for s in "abc":
            _both(jp, tp, "free", s)
            _assert_same(jp, tp, jw, tw, "abc")
        assert tp.pages_used() == 0

    def test_aliasing(self):
        jp, tp, jw, tw = _pools(n_pages=12, pool_aliasing=True)
        a, b = _rows(3, count=2)
        _both(jp, tp, "write_back", "a", a, 16)  # in place: epoch 1
        _assert_same(jp, tp, jw, tw, "ab")
        buf = tp.acquire_read()
        jp.acquire_read()
        _both(jp, tp, "write_back", "b", b, 16)  # pinned: one CoW fallback
        _assert_same(jp, tp, jw, tw, "ab")
        assert buf is not tp.buffer() and not buf[4:8].any()  # the snapshot kept its pages
        tp.release_read()
        jp.release_read()
        _both(jp, tp, "write_back", "b", a, 16)  # in place again
        _assert_same(jp, tp, jw, tw, "ab")
        alias = tp.record()["alias"]
        assert (alias["epoch"], alias["n_alias_writes"], alias["n_alias_fallbacks"]) == (2, 2, 1)
        assert alias["alias_bytes_moved"] == 8 * tp.page_bytes
        assert tp.record()["cow_bytes_moved"] == tp.pool_bytes
        with pytest.raises(RuntimeError, match="without a matching"):
            tp.release_read()

    def test_bf16_pool_and_hash(self):
        kw = dict(page_pool_pages=4, page_tokens=PT, compute_dtype="bfloat16")
        pool = tpaged.PagedColumnPool(GlomConfig(**TINY), ServeConfig(**kw), device="cpu")
        (row,) = _rows(4)
        jrow = jnp.asarray(row, jnp.bfloat16)
        trow = torch.from_numpy(row).to(torch.bfloat16)
        assert tpaged.content_hash(trow) == hashlib.sha256(
            np.ascontiguousarray(np.asarray(jrow)).tobytes()).hexdigest()
        assert pool.write_back("a", trow, 16)
        assert pool.buffer().dtype == torch.bfloat16
        assert torch.equal(pool.read_block("a"), trow)
        assert tpaged.resolve_page_pool(GlomConfig(**TINY), ServeConfig(), device="cpu") is None

    def test_delta_bits_see_signed_zero_in_bf16(self):
        kw = dict(page_pool_pages=8, page_tokens=PT, compute_dtype="bfloat16",
                  delta_streaming=True)
        pool = tpaged.PagedColumnPool(GlomConfig(**TINY), ServeConfig(**kw), device="cpu")
        row = torch.zeros(N, L, D, dtype=torch.bfloat16)
        pool.write_back_stream("s", row, N)
        neg = row.clone()
        neg[6, 0, 0] = -0.0
        info = pool.write_back_stream("s", neg, N)
        assert info["pages_written"] == 1 and pool.lookup("s")[0][1] == 4


# -- the engine's paged routes ---------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jconfig.GlomConfig(**TINY), GlomConfig(**TINY)
    jp = jcore.init_glom(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(flatten(jp), device="cpu")


def _images(seed, b):
    return np.random.default_rng(seed).standard_normal((b, 3, 16, 16)).astype(np.float32)


class TestPagedBucketRoute:
    @pytest.fixture(scope="class")
    def engines(self, model):
        jcfg, tcfg, jp, tp = model
        kw = dict(buckets=(1, 2, 4), max_batch=4, page_pool_pages=16, page_tokens=PT)
        ref = jengine.InferenceEngine(jcfg, jconfig.ServeConfig(**kw), params=jp)
        port = {up: InferenceEngine(tcfg, ServeConfig(**kw, use_pallas=up), params=tp,
                                    device="cpu") for up in (False, True)}
        return ref, port

    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_paged_warm_equals_host_carry_and_reference(self, engines, use_pallas):
        ref, port = engines
        eng = port[use_pallas]
        imgs = _images(20, 2)
        # Both pools hold the reference's cold answer, so the warm
        # dispatches start from the same columns.
        rows = np.array(ref.infer(imgs).levels)
        for pool in (eng.pool, ref.pool):
            pool.free_all()
        for i, s in enumerate(("r0", "r1")):
            assert eng.pool.write_back(s, torch.from_numpy(rows[i]), N)
            assert ref.pool.write_back(s, jnp.asarray(rows[i]), N)
        # Row 1 cold (-1 pages), row 0 warm from its pages.
        page_rows = np.array([eng.pool.lookup("r0")[0], [-1] * 4], np.int32)
        assert page_rows.tolist() == [[0, 1, 2, 3], [-1] * 4]
        assert ref.pool.lookup("r0")[0] == [0, 1, 2, 3]
        got = eng.infer(imgs, page_rows=page_rows)
        carry = torch.stack([torch.from_numpy(rows[0]), eng.cold_levels()])
        host = eng.infer(imgs, levels0=carry.numpy())
        assert torch.equal(got.levels, host.levels)
        assert got.levels0_h2d_bytes == 0 and host.levels0_h2d_bytes == carry.numel() * 4
        assert set(got.phases) == {"h2d_ms", "resolve_ms"}
        want = ref.infer(imgs, page_rows=page_rows)
        assert got.iters_run == want.iters_run
        np.testing.assert_allclose(got.levels.numpy(), np.asarray(want.levels),
                                   rtol=RTOL, atol=ATOL)

    def test_paged_auto_route_and_warmups(self, model):
        jcfg, tcfg, jp, tp = model
        kw = dict(buckets=(2,), max_batch=2, page_pool_pages=8, page_tokens=PT, iters="auto",
                  exit_threshold=0.0, max_auto_iters=3)
        eng = InferenceEngine(tcfg, ServeConfig(**kw), params=tp, device="cpu")
        ref = jengine.InferenceEngine(jcfg, jconfig.ServeConfig(**kw), params=jp)
        for e in (eng, ref):
            assert set(e.warmup(warm="paged")) == {2}
        assert eng.warmup(warm="paged") == {2: 0.0}
        assert eng.warmup(warm="paged-inc")[2] > 0
        imgs = _images(21, 2)
        lv = _rows(22)[0]
        assert eng.pool.write_back("a", torch.from_numpy(lv), N)
        assert ref.pool.write_back("a", jnp.asarray(lv), N)
        page_rows = np.array([[-1] * 4, [0, 1, 2, 3]], np.int32)
        got, want = eng.infer(imgs, page_rows=page_rows), ref.infer(imgs, page_rows=page_rows)
        assert got.iters_run == want.iters_run == 3 and not got.compiled
        np.testing.assert_array_equal(got.row_iters, want.row_iters)
        np.testing.assert_allclose(got.levels.numpy(), np.asarray(want.levels),
                                   rtol=RTOL, atol=ATOL)

    def test_paged_validation_matches_reference(self, engines):
        ref, port = engines
        imgs = _images(23, 2)
        good = np.full((2, 4), -1, np.int32)
        for kw in ({"page_rows": np.zeros((2, 3), np.int32)},
                   {"page_rows": good, "levels0": np.zeros((2, 16, 3, 32), np.float32)},
                   {"page_rows": good, "support_rows": np.zeros((2, 4), bool)}):
            for eng in (ref, port[True]):
                with pytest.raises(ValueError):
                    eng.infer(imgs, **kw)


class TestPagedRaggedRoute:
    MIX = [16, 5, 3, 1]  # 4 + 2 + 1 + 1 pages, dispatched at 8

    @pytest.fixture(scope="class")
    def engines(self, model):
        jcfg, tcfg, jp, tp = model

        def pair(attention):
            kw = dict(buckets=(1, 2, 4), max_batch=4, page_tokens=PT, ragged=True,
                      page_pool_pages=16, ragged_attention=attention)
            return (jengine.InferenceEngine(jcfg, jconfig.ServeConfig(**kw, dispatch_retries=0),
                                            params=jp),
                    InferenceEngine(tcfg, ServeConfig(**kw, use_pallas=True), params=tp,
                                    device="cpu"))

        return {a: pair(a) for a in ("windowed", "banded-pallas")}

    @pytest.mark.parametrize("attention", ["windowed", "banded-pallas"])
    def test_mixed_cold_and_warm_pages_match_reference(self, engines, attention):
        ref, port = engines[attention]
        rng = np.random.default_rng(30)
        flat = np.zeros((32, 48), np.float32)
        spans, off = [], 0
        for c in self.MIX:
            k = -(-c // PT)
            flat[off * PT:off * PT + c] = rng.standard_normal((c, 48))
            spans.append((off * PT, off * PT + k * PT))
            off += k
        warm0, warm2 = _rows(31)[0], _rows(32, n=3)[0]
        for eng, conv in ((port, torch.from_numpy), (ref, jnp.asarray)):
            eng.pool.free_all()
            assert eng.pool.write_back("row0", conv(warm0), 16)
            assert eng.pool.write_back("row2", conv(warm2), 3)
        page_idx = np.array([0, 1, 2, 3, -1, -1, 4, -1], np.int32)
        got = port.infer_ragged(flat, self.MIX, page_idx=page_idx)
        want = ref.infer_ragged(flat, self.MIX, page_idx=page_idx)
        assert got.levels0_h2d_bytes == want.levels0_h2d_bytes == 0
        assert got.iters_run == want.iters_run
        for s, e in spans:
            np.testing.assert_allclose(got.levels.numpy()[s:e], np.asarray(want.levels)[s:e],
                                       rtol=RTOL, atol=ATOL)
        cold = port.infer_ragged(flat, self.MIX)  # no page_idx: every page cold
        assert torch.equal(cold.levels, port.infer_ragged(
            flat, self.MIX, page_idx=np.full(8, -1, np.int32)).levels)

    @pytest.mark.parametrize("attention", ["windowed", "banded-pallas"])
    @pytest.mark.parametrize("dtype", [None, torch.bfloat16])
    def test_pool_form_equals_levels0_form(self, model, attention, dtype):
        _, tcfg, _, tp = model
        flat = torch.from_numpy(np.random.default_rng(33).standard_normal((32, 48))
                                .astype(np.float32))
        n = torch.tensor(self.MIX, dtype=torch.int32)
        pool = torch.from_numpy(np.random.default_rng(34).standard_normal((6, PT, L, D))
                                .astype(np.float32)).to(dtype or torch.float32)
        page_idx = torch.tensor([5, 0, 3, -1, 2, -1, 1, 4], dtype=torch.int32)
        lv0 = pool[page_idx.clamp(min=0).long()].reshape(32, L, D).clone()
        init = tp.init_levels.to(dtype or torch.float32)
        for p in (3, 5):
            lv0[p * PT:(p + 1) * PT] = init
        kw = dict(n_patches=n, page_tokens=PT, route=3, use_pallas=True,
                  ragged_attention=attention, compute_dtype=dtype)
        a = tee.glom_forward_ragged(tp, flat, tcfg, pool=pool, page_idx=page_idx, **kw)
        b = tee.glom_forward_ragged(tp, flat, tcfg, levels0=lv0, **kw)
        assert torch.equal(a.levels, b.levels)
