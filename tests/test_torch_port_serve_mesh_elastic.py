"""An elastic fleet of sharded engines on rank groups, on the CPU over gloo.

glom_tpu's serve CLI spawns each elastic replica on the next device group
of its one controller (`glom_tpu/serve/cli.py`, `engine_mesh_for`). The
port runs one process a rank: every rank builds every group's process
groups at start, rank 0 holds the engines and a `RankGroupFleet`, and the
followers of a group wait on the `torch.distributed` store between two
engines (`mesh_follower.follow_engines`). One spawn of 6 gloo ranks (data 2:
three groups) runs, in order:

  * a scripted policy over a real DynamicBatcher and Autoscaler
    (tests/torch_dist_ranks.elastic_fleet): a warm spare, its promotion, a
    cold spawn on a group that waited past its collectives' timeout, a
    spawn past the last group (rolled back), a drain that migrates two
    sessions and demotes, a drain that releases (the group waits again),
    warm next frames, a cold spawn on the released group's next generation
    that breaks (the group is retired), and a spawn with no waiting group
    (rolled back). The tickets are held to glom_tpu's engine at
    `serve_parity_f32`'s bars (tests/test_model.py: rtol 2e-3, atol 2e-4);
    the migrated pages bit for bit;
  * `python -m glom_tpu_torch.serve --mesh-data 2 --elastic` on the six
    ranks: every request served, every rank exits 0, the stream lints and
    audits clean.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import torch_dist_ranks as ranks
from glom_tpu.models.core import init_glom as j_init_glom
from glom_tpu.serve.engine import InferenceEngine as JEngine
from glom_tpu.utils import config as jconfig
from glom_tpu_torch.serve.column_cache import column_state_bytes
from glom_tpu_torch.utils.config import GlomConfig, ServeConfig

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-3, 2e-4
CFG_KW = dict(dim=32, levels=3, image_size=28, patch_size=7)  # n = 16
AUTO = dict(iters="auto", exit_threshold=0.0, max_auto_iters=3)
SCFG = dict(buckets=(2,), max_batch=2, page_pool_pages=16, page_tokens=4, dispatch_retries=0,
            mesh_data=2, column_cache_bytes=8 * column_state_bytes(GlomConfig(**CFG_KW),
                                                                   ServeConfig()), **AUTO)
# Past the groups' collective timeout: group 2's followers wait this long
# on the store before their first engine.
GROUP_TIMEOUT_S, WAIT_S = 5, 6.0
SESSIONS = ("s0", "s1")
CLI_ARGV = ["--preset", "mnist", "--device", "cpu", "--iters", "12", "--buckets", "2,4",
            "--max-batch", "4", "--mesh-data", "2", "--dist-backend", "gloo",
            "--queue-depth", "512", "--elastic", "--min-engines", "1", "--max-engines", "3",
            "--warm-pool", "1", "--ramp", "4x20,40x0,8x20", "--elastic-p99-ms", "1",
            "--elastic-window", "0.5", "--elastic-dwell", "0.05", "--elastic-cooldown", "0.3",
            "--elastic-interval", "0.02", "--elastic-settle", "30"]


def _jparams():
    return j_init_glom(jax.random.PRNGKey(1), jconfig.GlomConfig(**CFG_KW))


def _arrays(params) -> dict:
    out = {}
    for name in params._fields:
        v = getattr(params, name)
        if hasattr(v, "_fields"):
            for sub in v._fields:
                out[f"{name}.{sub}"] = np.asarray(getattr(v, sub))
        else:
            out[name] = np.asarray(v)
    return out


def _rounds():
    rng = np.random.default_rng(7)
    base = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    step = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    return [[(base[i], SESSIONS[i]) for i in range(2)],
            [(base[i] + 0.05 * step[i], SESSIONS[i]) for i in range(2)]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    out = str(tmp / "serve.jsonl")
    res = ranks.run(6, [
        ("elastic_fleet", dict(cfg_kw=CFG_KW, scfg_kw=SCFG, arrays=_arrays(_jparams()),
                               rounds=_rounds(), wait_s=WAIT_S,
                               group_timeout_s=GROUP_TIMEOUT_S)),
        ("serve_cli", dict(argv=CLI_ARGV, out=out)),
    ], tmp)
    return res, out


def _events(recs, name):
    return [r for r in recs if r.get("event") == name]


def test_tickets_match_glom_tpus_engine(runs):
    """Round 0 cold, round 1 warm from the pages the first round wrote
    (moved by the drain): glom_tpu's engine from the same rows."""
    res, _ = runs
    lead = res[0][0]
    jeng = JEngine(jconfig.GlomConfig(**CFG_KW), jconfig.ServeConfig(
        **{k: v for k, v in SCFG.items() if k not in ("mesh_data",)}), params=_jparams())
    rounds = _rounds()
    imgs0 = np.stack([img for img, _ in rounds[0]])
    want0 = jeng.infer(imgs0)
    got = lead["tickets"]
    for i in range(2):
        np.testing.assert_allclose(got[i]["levels"], np.asarray(want0.levels[i]), rtol=RTOL,
                                   atol=ATOL)
    imgs1 = np.stack([img for img, _ in rounds[1]])
    prev = np.stack([got[i]["levels"] for i in range(2)])
    want1 = jeng.infer(imgs1, levels0=prev)
    for i in range(2):
        np.testing.assert_allclose(got[2 + i]["levels"], np.asarray(want1.levels[i]),
                                   rtol=RTOL, atol=ATOL)
    assert [t["iters"] for t in got] == [3, 3, 3, 3]
    # round 1 read its columns from the pool: no levels0 from the host
    disp = _events(lead["records"], "dispatch")
    assert disp[-1]["n_page_warm"] == 2 and disp[-1]["levels0_h2d_bytes"] == 0


def test_the_fleet_grows_and_shrinks_on_rank_groups(runs):
    """Each decision's chain in order, the spawns past the groups rolled
    back loudly, the groups' states in order, a broken group retired."""
    res, _ = runs
    lead = res[0][0]
    recs = lead["records"]
    kinds = [r["event"] for r in recs if r.get("event") in (
        "spare_spawn", "spare_promote", "scale_out", "spawn_rollback", "drain_release",
        "spare_demote")]
    assert kinds == ["spare_spawn", "spare_promote", "scale_out", "spawn_rollback",
                     "drain_release", "spare_demote", "drain_release", "spare_promote",
                     "scale_out", "spawn_rollback"]
    rollbacks = _events(recs, "spawn_rollback")
    assert all("no waiting rank group" in r["exception"] for r in rollbacks)
    assert "1 retired" in rollbacks[-1]["exception"]
    groups = [(r["group"], r["state"], r["generation"]) for r in _events(recs, "rank_group")]
    # ... and at shutdown the closed engines give groups 0 and 1 back
    assert groups == [(0, "serving", 0), (1, "serving", 0), (2, "serving", 0),
                      (2, "waiting", 1), (2, "serving", 1), (2, "retired", 2),
                      (0, "waiting", 1), (1, "waiting", 1)]
    released = [r for r in _events(recs, "drain_release") if not r["demoted"]]
    assert [r["engine"] for r in released] == ["engine2"]
    (rel,) = _events(recs, "engine_release")
    assert sorted(rel["freed_bytes_by_rank"]) == ["0", "4", "5"]  # 0 bytes on the CPU
    assert lead["broken_error"] == "CollectiveError"
    assert lead["fleet"] == ["serving", "serving", "retired"]
    assert lead["fleet_closed"] == ["closed", "closed", "retired"]
    el = lead["elastic"]
    assert (el["n_promotions"], el["n_demotions"], el["n_scale_outs"], el["n_scale_ins"],
            el["n_spawn_failures"]) == (2, 1, 2, 2, 2)
    assert el["n_migrated_sessions"] >= 2
    # every decision's events follow it, before the next decision
    last = 0
    for r in recs:
        if r.get("kind") == "decision":
            assert r["decision_id"] == last + 1 and r["prev_decision_id"] == (last or None)
            last = r["decision_id"]
        elif r.get("decision_id") is not None:
            assert r["decision_id"] == last, r
    assert last == 8


def test_migrated_sessions_are_bit_for_bit(runs):
    """The drained engine's pages, read through its group, equal the
    destination's, read through its group."""
    res, _ = runs
    lead = res[0][0]
    for sid in SESSIONS:
        dst, bits = lead["after"][sid]
        assert dst in ("engine1", "engine2")
        np.testing.assert_array_equal(bits, lead["before"][sid])


def test_followers_wait_between_engines(runs):
    """Group 0 and 1 served one engine each; group 2 waited past its
    collectives' timeout, served engine2 to its release (a second
    generation), and its ranks raised CollectiveError when engine3's
    collective broke."""
    res, _ = runs
    got = {r: res[r][0] for r in range(1, 6)}
    assert got[1]["group"] == 0 and len(got[1]["lives"]) == 1
    assert got[1]["lives"][0]["ops"]["stop"] == 1
    for r in (2, 3):
        assert got[r]["group"] == 1 and len(got[r]["lives"]) == 1
    for r in (4, 5):
        assert got[r] == {"error": "CollectiveError", "group": 2}


def test_serve_cli_elastic_on_a_mesh(runs):
    """`--mesh-data 2 --elastic` on six ranks: every request served once,
    the warm spare built on its own group, every follower exits 0, and the
    stream lints and audits clean."""
    from glom_tpu_torch.telemetry import schema

    res, out = runs
    cli = [res[r][1] for r in range(6)]
    assert [c["rc"] for c in cli] == [0] * 6
    recs = cli[0]["records"]
    (summary,) = [r for r in recs if r.get("event") == "summary"]
    assert summary["n_served"] == summary["n_requests"] == 52
    ok = [r["id"] for r in recs if r.get("event") == "response" and r["ok"]]
    assert sorted(ok) == list(range(52))
    assert summary["elastic"]["n_promotions"] >= 1
    states = [(r["group"], r["state"]) for r in recs if r.get("event") == "rank_group"]
    assert states[:2] == [(0, "serving"), (1, "serving")]
    assert schema.main([out]) == 0
    audit = subprocess.run([sys.executable, "-m", "glom_tpu_torch.telemetry", "audit", out],
                           cwd=REPO, capture_output=True, text=True, timeout=120)
    assert audit.returncode == 0, audit.stderr[-2000:]
    assert json.loads(json.dumps(summary))  # the summary is plain JSON
