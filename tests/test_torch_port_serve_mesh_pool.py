"""The sharded engine's page pool against glom_tpu's, on the CPU over gloo.

glom_tpu's sharded pool is its ordinary `PagedColumnPool` with
`pool_sharding` (the page axis split over 'data' on its 8-device virtual
mesh), so every pool method runs on it. The port's `ShardedColumnPool`
keeps the table on the engine's leader and sends each device seam to the
group as an op (a write, a delta stream's residual, a compaction's or
defrag's page copy, a read-back). The same scripts of pool operations, on
rows made from one numpy seed, run through both: after every op the
answers, page tables, free lists, pins, chain lengths and base refs,
counters, `record()`, the stamped events (all fields but the backend
state) and the bits of every page (read from its owner) must be equal, and
the leader's and each follower's own shard must hold glom_tpu's slice of
the pool bit for bit. Spawns: 2 ranks (data 2) for every script; 4 ranks
for data 2 x seq 2 (the seq replicas of a shard) and for two engines held by
global rank 0, the second outside its group.

One reference caveat: glom_tpu's sharded pool is not bit-exact where a page
holds -0.0. Its delta write, its compaction copy and its read-back under
`pool_sharding` give +0.0 (a sum with the non-owners' zeros), so from there
its answers and tables part from its own single-device pool's. The port moves pages as integer
words and keeps every bit, so the scripts with a signed zero
(`SIGNED_ZERO`) are held to glom_tpu's single-device pool, which the
sharded pool is meant to equal, and a test pins glom_tpu's difference.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_dist_ranks as ranks
from glom_tpu.parallel import mesh as jmesh
from glom_tpu.serve import paged_columns as jpaged
from glom_tpu.utils import config as jconfig
from test_torch_port_model import TINY

PT = 4  # page tokens: 4 pages a 16-patch row
L, D, N = TINY["levels"], TINY["dim"], 16
BASE = dict(buckets=(2,), max_batch=2, page_tokens=PT, dispatch_retries=0)


def _rows(seed, n=N, count=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, L, D)).astype(np.float32) for _ in range(count)]


def _table_script():
    a, b, c = _rows(0, count=3)
    return [("alloc", ["a", 16], {}), ("alloc", ["b", 10], {}), ("alloc", ["c", 16], {}),
            ("write_back", ["a", a, 16], {}), ("write_back", ["b", b[:10], 10], {}),
            ("lookup", ["b"], {"pin": True}), ("free", ["a"], {}),
            ("write_back", ["c", c[:7], 7], {}),
            ("defrag", [], {}),  # b is pinned and stays where it is
            ("read_block", ["c"], {}), ("read_block", ["b"], {"on_device": True}),
            ("unpin", ["b"], {}), ("defrag", [], {}), ("read_block", ["b"], {}),
            ("write_back", ["a", a, 16], {}), ("write_back", ["a", a[:5], 5], {}),
            ("read_block", ["a"], {}), ("free_all", [], {}), ("write_back", ["b", b, 16], {}),
            ("release", [], {})]


def _delta_script():
    """glom_tpu's delta cases: an empty delta, a signed-zero change, a
    superseded page, the chain folding at the cap, a hash that no longer
    names a folded base, and a second stream."""
    (row0,) = _rows(1)
    row0[5] = 0.0  # page 1
    h0 = hashlib.sha256(np.ascontiguousarray(row0).tobytes()).hexdigest()
    row1 = row0.copy()
    row1[5] = -0.0  # page 1: a changed bit, no changed value
    row1[9] += 0.5  # page 2
    row2 = row1.copy()
    row2[9] += 0.5  # page 2 again: supersedes the last delta's page
    row2[13] -= 0.5  # page 3
    row3 = row2.copy()
    row3[1] += 0.5  # page 0
    row4 = row3.copy()
    row4[7] += 0.5  # page 1
    out = [("write_back_stream", ["s", row0, N], {"content_hash": h0})]
    out += [("write_back_stream", ["s", r, N], {}) for r in (row0.copy(), row1, row2, row3, row4)]
    out.append(("write_back_stream", ["t", row0, N], {"content_hash": h0}))
    t_row = row0.copy()
    t_row[2] += 1.0
    for _ in range(3):
        t_row = t_row.copy()
        t_row[3] += 1.0
        out.append(("write_back_stream", ["t", t_row, N], {}))
    out += [("read_block", ["s"], {}), ("read_block", ["t"], {"on_device": True}),
            ("defrag", [], {}), ("free", ["s"], {}), ("read_block", ["t"], {})]
    return out


def _share_script():
    """Three sessions share one base; compacting "b" copies the shared
    base into fresh pages (pages that cross shards)."""
    (row,) = _rows(2)
    h = hashlib.sha256(np.ascontiguousarray(row).tobytes()).hexdigest()
    out = [("write_back_stream", [s, row, N], {"content_hash": h}) for s in "abc"]
    r = row
    for k in range(2):
        r = r.copy()
        r[4 * k] += 1.0
        out.append(("write_back_stream", ["b", r, N], {}))
    out += [("read_block", [s], {}) for s in "abc"]
    out += [("free", [s], {}) for s in "abc"]
    return out


def _alias_script():
    a, b = _rows(3, count=2)
    return [("write_back", ["a", a, 16], {}), ("acquire_read", [], {}),
            ("write_back", ["b", b, 16], {}),  # pinned: one copy-on-write fallback
            ("release_read", [], {}), ("write_back", ["b", a, 16], {}),
            ("read_block", ["b"], {})]


def _bf16_script():
    (row,) = _rows(4)
    neg = np.zeros((N, L, D), np.float32)
    neg2 = neg.copy()
    neg2[6, 0, 0] = -0.0
    return [("write_back_stream", ["s", neg, N], {}), ("write_back_stream", ["s", neg2, N], {}),
            ("write_back_stream", ["t", row, N], {}), ("read_block", ["t"], {}),
            ("read_block", ["s"], {"on_device": True})]


SESSIONS = ("a", "b", "c", "s", "t")
# name: (scfg overrides, script)
SCRIPTS = {
    "table": (dict(page_pool_pages=10), _table_script()),
    "delta_bits": (dict(page_pool_pages=24, delta_streaming=True, delta_chain_cap=3),
                   _delta_script()),
    "delta_atol": (dict(page_pool_pages=24, delta_streaming=True, delta_page_atol=0.05,
                        delta_chain_cap=3), _delta_script()),
    "share": (dict(page_pool_pages=24, delta_streaming=True, delta_chain_cap=2),
              _share_script()),
    "alias": (dict(page_pool_pages=12, pool_aliasing=True), _alias_script()),
    "bf16": (dict(page_pool_pages=8, delta_streaming=True, compute_dtype="bfloat16"),
             _bf16_script()),
}
# The scripts where glom_tpu's sharded pool loses a -0.0 (see above): held
# to its single-device pool.
SIGNED_ZERO = ("delta_bits", "delta_atol", "bf16")
# 4 ranks: (name, script, mesh kwargs, engines, leader)
FOUR = [("data2xseq2", "delta_bits", dict(mesh_data=2, mesh_seq=2), 1, None),
        ("outside", "share", dict(mesh_data=2), 2, 0),
        ("outside_table", "table", dict(mesh_data=2), 2, 0)]


def _case(name, mesh_kw, engines=1, leader=None):
    over, script = SCRIPTS[name]
    return ("sharded_pool", dict(cfg_kw=TINY, scfg_kw=dict(BASE, **over, **mesh_kw),
                                 script=script, sessions=SESSIONS, engines=engines,
                                 leader=leader))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pool")
    two = ranks.run(2, [_case(n, dict(mesh_data=2)) for n in SCRIPTS], tmp)
    four = ranks.run(4, [_case(s, kw, e, ld) for _, s, kw, e, ld in FOUR], tmp)
    return two, four


class _Writer:
    def __init__(self):
        self.recs = []

    def write(self, rec):
        self.recs.append(rec)


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype == jnp.bfloat16 else np.int32)


def _jax_run(name, data=2):
    """The script on glom_tpu's pool, with its page axis sharded over a
    `data`-device mesh (data 1: one device): [(answer, state)] as the rank
    case returns them."""
    over, script = SCRIPTS[name]
    scfg = jconfig.ServeConfig(**dict(BASE, **over))
    sharding = None
    if data > 1:
        mesh = jmesh.make_mesh(jconfig.MeshConfig(data=data), jax.devices()[:data])
        sharding = NamedSharding(mesh, P("data"))
    w = _Writer()
    pool = jpaged.PagedColumnPool(jconfig.GlomConfig(**TINY), scfg, writer=w,
                                  pool_sharding=sharding)
    dtype = jnp.bfloat16 if scfg.compute_dtype == "bfloat16" else jnp.float32
    out = []
    for method, args, kw in script:
        args = [jnp.asarray(a, dtype) if isinstance(a, np.ndarray) else a for a in args]
        # glom_tpu's read-back answers on the host only
        kw = {k: v for k, v in kw.items() if k != "on_device"}
        got = getattr(pool, method)(*args, **kw)
        if isinstance(got, (jax.Array, np.ndarray)):
            got = {"bits": _jbits(got)}
        state = {"free": list(pool._free), "record": pool.record(), "epoch": pool.epoch(),
                 "read_pins": pool.read_pins(),
                 "events": [{k: v for k, v in r.items() if k != "backend_state"}
                            for r in w.recs],
                 "sessions": {s: (pool.lookup(s), pool.is_pinned(s), pool.delta_chain_len(s),
                                  pool.base_refs(s)) for s in SESSIONS}}
        w.recs.clear()
        if pool.buffer() is not None:
            state["pages"] = _jbits(pool.buffer())
        out.append((got, state))
    return out


def _reference(name):
    """glom_tpu's answer for a script: its sharded pool, or its single-device
    pool for the SIGNED_ZERO scripts."""
    return _jax_run(name, data=1 if name in SIGNED_ZERO else 2)


def _final_pages(jax_run):
    """The pool's last bits (a released pool keeps the followers' shards
    as they were: only the engine's release drops them)."""
    return [st["pages"] for _, st in jax_run if "pages" in st][-1]


def _assert_same(port_run, jax_run, method_names, lo, pps):
    assert len(port_run) == len(jax_run)
    for step, ((got, state), (want, jstate), method) in enumerate(
            zip(port_run, jax_run, method_names)):
        where = f"step {step} ({method})"
        if isinstance(want, dict) and "bits" in want:
            if method == "acquire_read":  # the leader's shard against the whole pool
                assert got["bits"].shape[0] == pps, where
            else:
                np.testing.assert_array_equal(got["bits"], want["bits"], err_msg=where)
        else:
            assert got == want, where
        for key in ("free", "record", "epoch", "read_pins", "events", "sessions"):
            assert state[key] == jstate[key], f"{where}: {key}"
        assert ("pages" in state) == ("pages" in jstate), where
        if "pages" in jstate:
            np.testing.assert_array_equal(state["pages"], jstate["pages"], err_msg=where)
            np.testing.assert_array_equal(state["own"], jstate["pages"][lo:lo + pps],
                                          err_msg=where)


def _methods(name):
    return [m for m, _, _ in SCRIPTS[name][1]]


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_sharded_pool_matches_glom_tpus(runs, name):
    """Data 2: every op's answer and state, and both ranks' shards."""
    two, _ = runs
    i = list(SCRIPTS).index(name)
    want = _reference(name)
    pps = SCRIPTS[name][0]["page_pool_pages"] // 2
    (port_run,) = two[0][i]
    _assert_same(port_run, want, _methods(name), 0, pps)
    follower = two[1][i]
    assert follower["lo"] == pps
    np.testing.assert_array_equal(follower["bits"], _final_pages(want)[pps:])


@pytest.mark.parametrize("case", FOUR, ids=lambda c: c[0])
def test_sharded_pool_seq_replicas_and_a_leader_outside(runs, case):
    """Data 2 x seq 2 (each shard held by two ranks, read from one) and a
    second engine whose leader holds no shard: the same answers and
    states, and every rank's shard is glom_tpu's slice."""
    _, four = runs
    i = FOUR.index(case)
    _, name, mesh_kw, engines, _ = case
    want = _reference(name)
    pps = SCRIPTS[name][0]["page_pool_pages"] // 2
    runs_by_engine = four[0][i]
    assert len(runs_by_engine) == engines
    final = _final_pages(want)
    for e, port_run in enumerate(runs_by_engine):
        inside = e == 0
        if inside:
            _assert_same(port_run, want, _methods(name), 0, pps)
        else:  # the leader holds no shard: compare the pages only
            for (got, state), (_, jstate) in zip(port_run, want):
                if "own" in state:
                    np.testing.assert_array_equal(state["own"], jstate["pages"][:0])
                    state["own"] = jstate["pages"][:pps]
            _assert_same(port_run, want, _methods(name), 0, pps)
    if mesh_kw.get("mesh_seq") == 2:
        # group [0, 1, 2, 3]: data index 0 = ranks 0, 1; data index 1 = ranks 2, 3
        shards = {r: four[r][i] for r in (1, 2, 3)}
        assert [shards[r]["lo"] for r in (1, 2, 3)] == [0, pps, pps]
        np.testing.assert_array_equal(shards[1]["bits"], final[:pps])
        for r in (2, 3):
            np.testing.assert_array_equal(shards[r]["bits"], final[pps:])
    else:
        # engine 0 = ranks [0, 1], engine 1 = ranks [2, 3], both held by rank 0
        for r, lo in ((1, pps), (2, 0), (3, pps)):
            got = four[r][i]
            assert got["lo"] == lo
            np.testing.assert_array_equal(got["bits"], final[lo:lo + pps])


def _same_step(a, b) -> bool:
    (ga, sa), (gb, sb) = a, b
    if isinstance(gb, dict) and "bits" in gb:
        answers = np.array_equal(ga["bits"], gb["bits"])
    else:
        answers = ga == gb
    return (answers and sa["events"] == sb["events"] and sa["sessions"] == sb["sessions"]
            and np.array_equal(sa.get("pages"), sb.get("pages")))


@pytest.mark.parametrize("name,first", [("delta_bits", 3), ("delta_atol", 5), ("bf16", 4)])
def test_glom_tpus_sharded_pool_loses_negative_zero(runs, name, first):
    """The caveat: glom_tpu's sharded pool equals its single-device pool
    until a delta write (atol 0), a compaction copy (atol 0.05) or a bf16
    read-back turns a -0.0 into +0.0; the port's sharded pool is the
    single-device pool's there too."""
    two, _ = runs
    sharded, single = _jax_run(name, data=2), _jax_run(name, data=1)
    assert all(_same_step(a, b) for a, b in zip(sharded[:first], single[:first]))
    assert not _same_step(sharded[first], single[first])
    (port_run,) = two[0][list(SCRIPTS).index(name)]
    assert _same_step(port_run[first], single[first])
    assert not _same_step(port_run[first], sharded[first])


def test_a_delta_engine_builds_on_a_mesh():
    """glom_tpu's refusals of ragged admission and an indivisible pool on
    a mesh stay (test_torch_port_serve_mesh); delta streams pass the
    engine's checks now."""
    from glom_tpu_torch.serve.engine import _check_mesh_shape
    from glom_tpu_torch.utils.config import GlomConfig, ServeConfig

    _check_mesh_shape(GlomConfig(**TINY), ServeConfig(**dict(
        BASE, page_pool_pages=8, delta_streaming=True, mesh_data=2)), 2, 1)
