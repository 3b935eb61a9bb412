"""The port's pod coordinator (glom_tpu_torch/resilience/coordinator.py)
against glom_tpu's, on the CPU: the two-phase preemption save barrier over
both transports (a shared directory, and a loopback TCPStore), its fault
injectors, a mixed glom_tpu / port gang over one directory, pod restore
reconciliation, the pod-mode grace save, and gang-supervised recovery
through fit_supervised.

Hosts are threads. Every deadline runs on a clock the test drives
(PodCoordinator(clock=, sleep=)): a round that must abort reaches its
deadline on a clock that advances with each poll, and one that must commit
waits on a clock that never reaches it, so no outcome depends on how fast
the threads run.
"""

import itertools
import json
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from glom_tpu import resilience as jres
from glom_tpu.utils import checkpoint as jckpt
from glom_tpu_torch import GlomConfig, TrainConfig, Trainer
from glom_tpu_torch.data import shapes_dataset
from glom_tpu_torch.models.core import param_leaves
from glom_tpu_torch.resilience import (
    BarrierAbort,
    DirectoryTransport,
    FaultPlan,
    InjectedFault,
    PodCoordinator,
    StoreTransport,
    barrier_delay,
    message_loss,
    peer_host_dirs,
    pod_preemption_save,
    read_pod_commit,
)
from glom_tpu_torch.resilience.coordinator import GANG_DONE_ROUND, POD_COMMIT_PHASE
from glom_tpu_torch.telemetry import schema
from glom_tpu_torch.train import TrainSupervisor, fit_supervised
from glom_tpu_torch.utils import checkpoint as ckpt

TINY = {"dim": 16, "levels": 3, "image_size": 8, "patch_size": 4}
POLL = 0.01


class ListWriter:
    def __init__(self):
        self.records = []
        self._lock = threading.Lock()

    def write(self, rec):
        with self._lock:
            self.records.append(rec)

    def all(self):
        with self._lock:
            return list(self.records)


class Ticking:
    """A clock that advances only when its host polls: a deadline of D
    seconds passes after D / poll_s polls, however fast the threads run."""

    def __init__(self):
        self.now = 0.0

    def clock(self):
        return self.now

    def sleep(self, s):
        self.now += s
        time.sleep(0.001)  # let the other hosts run


def never():
    """A clock that never reaches a deadline: the round waits for every host."""
    return 0.0


def _run_hosts(n, fn, timeout=60.0):
    """Run fn(host) on n threads; {host: exception} of those that raised."""
    errs = {}

    def wrap(h):
        try:
            fn(h)
        except BaseException as e:  # noqa: BLE001 - returned to the test
            errs[h] = e

    threads = [threading.Thread(target=wrap, args=(h,), daemon=True) for h in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), "a simulated host hung past its deadline"
    return errs


@pytest.fixture(scope="module")
def tcp_master():
    """A loopback TCPStore server for the module; each transport gets its
    own client, wrapped in a PrefixStore of its test's own (as the
    training CLI wraps the process group's store)."""
    master = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    yield master


_PREFIXES = itertools.count()


class Transports:
    """make(host, n, hook=None) -> a fresh transport of one kind, over one
    shared root (a directory, or a prefix of the loopback store)."""

    def __init__(self, kind, tmp_path, master=None):
        self.kind = kind
        self.root = tmp_path / "coord"
        self.prefix = f"t{next(_PREFIXES)}/"
        self.port = None if master is None else master.port

    def make(self, host, n, hook=None):
        if self.kind == "dir":
            return DirectoryTransport(self.root, host, n, fault_hook=hook)
        return StoreTransport(self._store(), host, n, fault_hook=hook)

    def _store(self):
        return dist.PrefixStore(self.prefix,
                                dist.TCPStore("127.0.0.1", self.port, is_master=False))

    def commit(self):
        """The pod commit marker (None when no round completed)."""
        if self.kind == "dir":
            return read_pod_commit(self.root)
        store = self._store()
        key = f"glom/rounds/preempt-g0/{POD_COMMIT_PHASE}_0"
        return json.loads(store.get(key)) if store.check([key]) else None


@pytest.fixture(params=["dir", "store"])
def transports(request, tmp_path, tcp_master):
    return Transports(request.param, tmp_path, tcp_master if request.param == "store" else None)


def _coord(transports, h, n, writer=None, hook=None, clock=never, sleep=time.sleep):
    return PodCoordinator(transports.make(h, n, hook), writer=writer, poll_s=POLL,
                          clock=clock, sleep=sleep)


class TestTransports:
    def test_post_and_read_roundtrip(self, transports):
        a, b = transports.make(0, 2), transports.make(1, 2)
        assert a.post("r1", "propose", {"step": 3})
        assert b.post("r1", "propose", {"step": 5})
        assert a.read_all("r1", "propose") == {0: {"host": 0, "step": 3},
                                                1: {"host": 1, "step": 5}}
        assert a.read_all("r2", "propose") == {}  # rounds are disjoint

    def test_fault_hook_drops_the_message(self, transports):
        plan = FaultPlan(seed=0).register("barrier-msg", at=(0,), fault="barrier-message-loss")
        t = transports.make(0, 1, message_loss(plan))
        assert not t.post("r1", "propose", {"step": 3})
        assert t.read_all("r1", "propose") == {}
        assert t.post("r1", "saved", {"step": 3})
        assert [e["fault"] for e in plan.events()] == ["barrier-message-loss"]

    def test_post_is_visible_to_a_peer_when_it_returns(self, transports):
        """A message is readable by another host as soon as post returns.
        Over a TCPStore each host has its own connection, and a set is not
        yet applied when the client returns from it: before post waited for
        a round trip, a peer reading at once could miss it (the gang-stop
        flag, read right after it was posted)."""
        a, b = transports.make(0, 2), transports.make(1, 2)
        missed = [i for i in range(500)
                  if not (a.post(f"v{i}", "stop", {"i": i})
                          and b.read_all(f"v{i}", "stop") == {0: {"host": 0, "i": i}})]
        assert missed == []

    def test_bad_host_rejected(self, tmp_path):
        with pytest.raises(ValueError):
            DirectoryTransport(tmp_path, 2, 2)
        with pytest.raises(ValueError):
            StoreTransport(dist.HashStore(), 0, 0)

    def test_directory_layout_is_glom_tpus(self, tmp_path):
        """One directory serves both packages: each reads the other's posts."""
        ours = DirectoryTransport(tmp_path, 1, 2)
        ref = jres.DirectoryTransport(tmp_path, 0, 2)
        ours.post("r", "propose", {"step": 4})
        ref.post("r", "propose", {"step": 2})
        assert ours.read_all("r", "propose") == ref.read_all("r", "propose") == {
            0: {"host": 0, "step": 2}, 1: {"host": 1, "step": 4}}
        assert (tmp_path / "rounds" / "r" / "propose_1.json").is_file()

    def test_store_purge_keeps_peers_and_markers(self):
        store = dist.HashStore()
        a, b = StoreTransport(store, 0, 2), StoreTransport(store, 1, 2)
        a.post("r", "propose", {"step": 1})
        a.post("r", POD_COMMIT_PHASE, {"step": 1})
        a.post(GANG_DONE_ROUND, "done", {"steps": 4})
        b.post("r", "propose", {"step": 2})
        StoreTransport(store, 0, 2)  # host 0 relaunched
        assert b.read_all("r", "propose") == {1: {"host": 1, "step": 2}}
        assert b.read_all(GANG_DONE_ROUND, "done") == {}
        assert b.read_all("r", POD_COMMIT_PHASE) == {0: {"host": 0, "step": 1}}


class TestPreemptionBarrier:
    def test_commits_the_min_proposal_on_every_host(self, transports):
        w = ListWriter()
        proposals = {0: 5, 1: 3, 2: 4}
        results, saves = {}, {}

        def host(h):
            c = _coord(transports, h, 3, writer=w)
            results[h] = c.preemption_barrier(
                "preempt-g0", proposals[h], lambda commit: saves.__setitem__(h, commit),
                deadline_s=10.0)

        assert _run_hosts(3, host) == {}
        assert results == saves == {0: 3, 1: 3, 2: 3}
        marker = transports.commit()
        assert marker["step"] == 3 and marker["n_hosts"] == 3
        assert marker["proposals"] == {"0": 5, "1": 3, "2": 4}
        recs = w.all()
        assert all(schema.validate_record(r) == [] for r in recs)
        phases = {(r["host"], r["phase"]) for r in recs if r["kind"] == "barrier"}
        for h in range(3):
            assert {(h, "propose"), (h, "commit"), (h, "saved"), (h, "complete")} <= phases
        assert {r["step"] for r in recs if r.get("phase") == "commit"} == {3}

    def test_message_loss_aborts_loudly_on_every_host(self, transports):
        """Host 1's propose is dropped: both hosts reach the deadline short
        of it and abort, stamped, with no commit marker."""
        w = ListWriter()
        plan = FaultPlan(seed=0, writer=w).register("barrier-msg", at=(0,),
                                                    fault="barrier-message-loss")
        errs = {}

        def host(h):
            tick = Ticking()
            c = _coord(transports, h, 2, writer=w, hook=message_loss(plan) if h == 1 else None,
                       clock=tick.clock, sleep=tick.sleep)
            try:
                c.preemption_barrier("preempt-g0", 3, lambda s: None, deadline_s=0.4)
            except BarrierAbort as e:
                errs[h] = e

        _run_hosts(2, host)
        assert set(errs) == {0, 1}
        assert transports.commit() is None
        recs = w.all()
        assert [r["fault"] for r in recs if r["kind"] == "fault"] == ["barrier-message-loss"]
        aborts = [r for r in recs if r["kind"] == "barrier" and r["phase"] == "abort"]
        assert {r["host"] for r in aborts} == {0, 1}
        assert all("deadline" in r["reason"] or "abort" in r["reason"] for r in aborts)

    def test_deadline_overrun_aborts_and_writes_no_marker(self, transports):
        """Host 1's 'saved' lands only after host 0 aborted at its
        deadline: host 1, limping in late, must not complete the round."""
        plan = FaultPlan(seed=0).register("barrier-delay", at=(1,), fault="deadline-overrun")
        host0_aborted = threading.Event()

        def late(_):
            assert host0_aborted.wait(30.0)

        errs = {}

        def host(h):
            tick = Ticking()
            hook = barrier_delay(plan, delay_s=1.0, sleep=late) if h == 1 else None
            c = _coord(transports, h, 2, hook=hook, clock=tick.clock if h == 0 else never,
                       sleep=tick.sleep)
            try:
                c.preemption_barrier("preempt-g0", 3, lambda s: None, deadline_s=0.4)
            except BarrierAbort as e:
                errs[h] = e
                if h == 0:
                    host0_aborted.set()

        _run_hosts(2, host)
        assert set(errs) == {0, 1}, errs
        assert "peer host 0 aborted" in str(errs[1])
        assert transports.commit() is None

    def test_failed_save_aborts_the_whole_round(self, transports):
        errs = {}

        def host(h):
            def save_fn(commit):
                if h == 1:
                    raise InjectedFault("disk full")

            try:
                _coord(transports, h, 2).preemption_barrier("preempt-g0", 3, save_fn,
                                                            deadline_s=5.0)
            except BarrierAbort as e:
                errs[h] = e

        _run_hosts(2, host)
        assert set(errs) == {0, 1}
        assert "disk full" in str(errs[1])
        assert transports.commit() is None

    def test_sub_deadline_delay_still_commits(self, transports):
        """A slow-but-alive host is not an abort: the round waits."""
        plan = FaultPlan(seed=0).register("barrier-delay", at=(0,), fault="slow-host")
        results = {}

        def host(h):
            hook = barrier_delay(plan, delay_s=0.1) if h == 1 else None
            results[h] = _coord(transports, h, 2, hook=hook).preemption_barrier(
                "preempt-g0", 3 + h, lambda s: None, deadline_s=10.0)

        assert _run_hosts(2, host) == {}
        assert results == {0: 3, 1: 3}
        assert transports.commit()["step"] == 3
        assert [e["fault"] for e in plan.events()] == ["slow-host"]

    def test_relaunch_purges_stale_round_messages(self, transports):
        """A relaunch reuses the round id: the previous lifetime's abort,
        propose and saved must neither poison nor complete the new round."""
        old0, old1 = transports.make(0, 2), transports.make(1, 2)
        old0.post("preempt-g0", "propose", {"step": 9})
        old1.post("preempt-g0", "propose", {"step": 9})
        old1.post("preempt-g0", "saved", {"step": 9})
        old1.post("preempt-g0", "abort", {"reason": "deadline passed"})
        # The relaunch: both processes start (each purging its own
        # messages) before either round begins.
        coords = {h: _coord(transports, h, 2) for h in range(2)}
        results = {}

        def host(h):
            results[h] = coords[h].preemption_barrier(
                "preempt-g0", 3 + h, lambda s: None, deadline_s=10.0)

        assert _run_hosts(2, host) == {}
        assert results == {0: 3, 1: 3}  # the min of the NEW proposals, not 9
        assert transports.commit()["step"] == 3

    def test_launch_epoch_ignores_an_earlier_lifetimes_arrivals(self, transports):
        """The pod CLI's resume rendezvous: a launch's rounds are keyed on
        every host's fresh nonce, so a peer's arrivals from an earlier
        lifetime (a launch that ended without a new commit marker) neither
        complete a relaunched host's round nor fill its "reconciled" one."""
        def launch(coords):
            epochs = {}

            def host(h):
                epochs[h] = coords[h].launch_epoch(deadline_s=10.0)
                coords[h].gang_barrier("reconciled", epochs[h], deadline_s=10.0)

            assert _run_hosts(2, host) == {}
            assert epochs[0] == epochs[1]
            return epochs[0]

        first = launch({h: _coord(transports, h, 2) for h in range(2)})
        # Host 0 is relaunched; host 1's arrivals of the first launch stay.
        tick = Ticking()
        alone = _coord(transports, 0, 2, clock=tick.clock, sleep=tick.sleep)
        with pytest.raises(BarrierAbort, match="deadline") as err:
            alone.launch_epoch(deadline_s=0.3)
        assert err.value.detail["missing"] == [1]
        # Both are relaunched, host 1 after host 0 has read its old nonce.
        coords = {0: _coord(transports, 0, 2)}
        epochs = {}

        def host0():
            epochs[0] = coords[0].launch_epoch(deadline_s=10.0)

        t = threading.Thread(target=host0, daemon=True)
        t.start()
        time.sleep(0.2)
        coords[1] = _coord(transports, 1, 2)
        epochs[1] = coords[1].launch_epoch(deadline_s=10.0)
        t.join(timeout=30)
        assert epochs[0] == epochs[1] != first

    def test_gang_barrier_excuses_a_done_member(self, transports):
        done = _coord(transports, 1, 2)
        done.signal_gang_done(8)
        _coord(transports, 0, 2).gang_barrier("restart", 2, deadline_s=5.0)
        tick = Ticking()
        lone = _coord(transports, 1, 2, clock=tick.clock, sleep=tick.sleep)
        with pytest.raises(BarrierAbort, match="deadline"):
            # the only live member (host 0) never arrives at THIS epoch
            lone.gang_barrier("restart", 3, deadline_s=0.3)

    def test_gang_stop_flags(self, transports):
        w = ListWriter()
        a, b = _coord(transports, 0, 2, writer=w), _coord(transports, 1, 2)
        assert not b.gang_stop_requested(1)
        a.signal_gang_stop(1, "InjectedFault: boom")
        assert b.gang_stop_requested(1) and not b.gang_stop_requested(2)
        (rec,) = w.all()
        assert (rec["kind"], rec["action"], rec["epoch"], rec["host"]) == (
            "recovery", "gang-stop", 1, 0)


# -- a mixed glom_tpu / port gang over one directory --------------------------


def _barrier_view(recs):
    return [{k: v for k, v in r.items() if k != "wall_time_s"} for r in recs
            if r["kind"] == "barrier"]


def _mixed_round(tmp_path, packages, proposals):
    """One barrier round, host h running packages[h]'s coordinator over one
    directory; (results, {host: records})."""
    writers = {h: ListWriter() for h in range(len(packages))}
    results = {}

    def host(h):
        mod = jres if packages[h] == "glom_tpu" else None
        transport = (jres.DirectoryTransport(tmp_path, h, len(packages)) if mod
                     else DirectoryTransport(tmp_path, h, len(packages)))
        coord = (jres.PodCoordinator if mod else PodCoordinator)(
            transport, writer=writers[h], poll_s=POLL, clock=never)
        results[h] = coord.preemption_barrier("preempt-g0", proposals[h], lambda s: "saved",
                                              deadline_s=10.0)

    assert _run_hosts(len(packages), host) == {}
    return results, {h: w.all() for h, w in writers.items()}


class TestMixedGang:
    def test_commits_one_step_and_writes_glom_tpus_marker(self, tmp_path):
        results, recs = _mixed_round(tmp_path / "mixed", ["glom_tpu", "port"], {0: 6, 1: 4})
        assert results == {0: 4, 1: 4}
        markers = sorted(p.name for p in (tmp_path / "mixed").glob("pod_commit_*.json"))
        assert markers == ["pod_commit_4.json"]
        ours, ref = read_pod_commit(tmp_path / "mixed"), jres.read_pod_commit(tmp_path / "mixed")
        assert ours == ref and ours["proposals"] == {"0": 6, "1": 4}

    def test_stamped_phases_match_glom_tpus(self, tmp_path):
        """The port's gang stamps what glom_tpu's does, host for host."""
        proposals = {0: 6, 1: 4}
        _, ours = _mixed_round(tmp_path / "port", ["port", "port"], proposals)
        _, ref = _mixed_round(tmp_path / "ref", ["glom_tpu", "glom_tpu"], proposals)
        for h in (0, 1):
            assert _barrier_view(ours[h]) == _barrier_view(ref[h])
            assert [r["phase"] for r in _barrier_view(ours[h])] == [
                "propose", "commit", "saved", "complete"]


# -- pod restore reconciliation ------------------------------------------------


def tiny_trainer():
    return Trainer(GlomConfig(**TINY), TrainConfig(batch_size=2), device="cpu")


def _port_pod(root, layout, torn=()):
    """Per-host steps saved by the port, then `torn` (host, step) truncated."""
    tr = tiny_trainer()
    dirs = {}
    for h, steps in layout.items():
        d = root / f"host_{h}"
        mgr = ckpt.CheckpointManager(str(d), async_save=False, max_to_keep=10)
        for s in steps:
            assert mgr.save(s, tr.state)
        mgr.close()
        dirs[h] = d
    for h, s in torn:
        target = dirs[h] / str(s) / ckpt.STATE_FILE
        target.write_bytes(target.read_bytes()[:100])
    return dirs


def _ref_pod(root, layout, torn=()):
    dirs = {}
    for h, steps in layout.items():
        d = root / f"host_{h}"
        mgr = jckpt.CheckpointManager(str(d), async_save=False, max_to_keep=10)
        for s in steps:
            assert mgr.save(s, {"w": np.full(8, float(s), np.float32)})
        mgr.close()
        dirs[h] = d
    for h, s in torn:
        files = sorted((p for p in (dirs[h] / str(s)).rglob("*") if p.is_file()),
                       key=lambda p: p.stat().st_size)
        files[-1].write_bytes(files[-1].read_bytes()[:max(1, files[-1].stat().st_size // 2)])
    return dirs


def _decisions(recs, dirs):
    """Recovery records with host dirs named by host and quarantine paths
    reduced to whether they moved."""
    names = {str(d): f"host_{h}" for h, d in dirs.items()}
    out = []
    for r in recs:
        if r.get("kind") != "recovery":
            continue
        row = {"action": r["action"], "step": r["step"]}
        if "invalid_hosts" in r:
            row["invalid_hosts"] = sorted(names[p] for p in r["invalid_hosts"])
        q = r.get("quarantined")
        row["quarantined"] = ({names.get(k, k): v is not None for k, v in q.items()}
                              if isinstance(q, dict) else q is not None)
        if "peer_quarantined" in r:
            row["peer_quarantined"] = {names[k]: v is not None
                                       for k, v in r["peer_quarantined"].items()}
        out.append(row)
    return out


LAYOUTS = {
    # host 1 never committed step 3: a half-committed step
    "absent_on_peer": ({0: [1, 2, 3], 1: [1, 2]}, ()),
    # host 1's step 3 is torn (its manifest no longer verifies)
    "torn_on_peer": ({0: [1, 2, 3], 1: [1, 2, 3]}, ((1, 3),)),
    # host 0's own newest step is torn
    "torn_here": ({0: [1, 2, 3], 1: [1, 2, 3]}, ((0, 3),)),
    # two half-committed steps in a row
    "two_half_steps": ({0: [1, 2, 3, 4], 1: [1, 2]}, ()),
}


class TestPodRestore:
    @pytest.mark.parametrize("name", sorted(LAYOUTS))
    def test_quarantine_decisions_match_glom_tpu(self, tmp_path, name):
        layout, torn = LAYOUTS[name]
        ours_dirs = _port_pod(tmp_path / "port", layout, torn)
        ref_dirs = _ref_pod(tmp_path / "ref", layout, torn)
        w, jw = ListWriter(), ListWriter()
        mgr = ckpt.CheckpointManager(str(ours_dirs[0]), metrics_writer=w,
                                     pod_peers=[str(ours_dirs[1])])
        jmgr = jckpt.CheckpointManager(str(ref_dirs[0]), metrics_writer=jw,
                                       pod_peers=[str(ref_dirs[1])])
        assert mgr.latest_step() == jmgr.latest_step() == 2
        step, _ = mgr.restore(state=tiny_trainer().state)
        jstep, _ = jmgr.restore(abstract_state=jckpt.abstract_like(
            {"w": np.zeros(8, np.float32)}))
        jmgr.close()
        assert step == jstep == 2
        assert _decisions(w.records, ours_dirs) == _decisions(jw.all(), ref_dirs)
        assert _decisions(w.records, ours_dirs)  # the layout was torn
        for h in (0, 1):  # the half steps left both hosts' step namespaces
            assert max(int(p.name) for p in ours_dirs[h].iterdir() if p.name.isdigit()) == 2
            assert ckpt.step_valid_in_dir(ours_dirs[h], 2)

    def test_step_valid_in_dir_matches_the_manager(self, tmp_path):
        dirs = _port_pod(tmp_path, {0: [1, 2, 3]}, torn=((0, 3),))
        mgr = ckpt.CheckpointManager(str(dirs[0]))
        for s in (1, 2, 3, 4):
            assert ckpt.step_valid_in_dir(dirs[0], s) == mgr.verify_step(s) == (s < 3)
        assert ckpt.quarantine_step_in_dir(dirs[0], 1) is not None
        assert ckpt.quarantine_step_in_dir(dirs[0], 1) is None  # already gone
        assert not ckpt.step_valid_in_dir(dirs[0], 1)


# -- the pod-mode grace save ----------------------------------------------------


def _state_at(step):
    """A tiny TrainState whose params and step say `step`."""
    tr = tiny_trainer()
    with torch.no_grad():
        for t in param_leaves(tr.state.params):
            t.fill_(float(step))
    return tr.state._replace(step=step)


class TestPodPreemptionSave:
    def _pod(self, tmp_path, ahead_steps):
        coord = tmp_path / "coord"
        dirs = {h: tmp_path / "ckpt" / f"host_{h}" for h in range(2)}
        for d in dirs.values():
            d.mkdir(parents=True)
        mgr = ckpt.CheckpointManager(str(dirs[1]), async_save=False, max_to_keep=10)
        for s in ahead_steps:
            assert mgr.save(s, _state_at(s))
        mgr.close()
        return coord, dirs

    def _round(self, coord, dirs, deadline_s):
        results, errs = {}, {}

        def host(h):
            c = PodCoordinator(DirectoryTransport(coord, h, 2), poll_s=POLL, clock=never)
            step = 2 if h == 0 else 4
            try:
                results[h] = pod_preemption_save(c, dirs[h], _state_at(step), step,
                                                 deadline_s=deadline_s, round_id="preempt-g0")
            except BarrierAbort as e:
                errs[h] = e

        assert _run_hosts(2, host) == {}
        return results, errs

    def test_min_host_grace_saves_ahead_host_proves_retention(self, tmp_path):
        coord, dirs = self._pod(tmp_path, [1, 2, 3, 4])
        results, errs = self._round(coord, dirs, 20.0)
        assert errs == {}
        for h in (0, 1):
            assert results[h]["step"] == 2 and results[h]["pod"] is True
            assert ckpt.step_valid_in_dir(dirs[h], 2)
        assert (results[0]["proposed_step"], results[1]["proposed_step"]) == (2, 4)
        assert read_pod_commit(coord)["step"] == 2
        tr = tiny_trainer()
        step, state = ckpt.CheckpointManager(str(dirs[0])).restore(state=tr.state)
        assert step == 2 and all(torch.equal(t, torch.full_like(t, 2.0))
                                 for t in param_leaves(state.params))

    def test_ahead_host_without_retention_aborts_the_round(self, tmp_path):
        """The ahead host polls a bounded slice of the budget (the step may
        be an async commit still landing), then aborts, and so does its
        peer: never a pod checkpoint with a hole in it."""
        coord, dirs = self._pod(tmp_path, [3, 4])  # step 2 NOT retained
        _, errs = self._round(coord, dirs, 3.0)
        assert set(errs) == {0, 1}
        assert "does not retain" in str(errs[1])
        assert read_pod_commit(coord) is None

    def test_ahead_host_waits_for_an_in_flight_commit(self, tmp_path):
        """The committed step lands on the ahead host while it looks (the
        loop's asynchronous save racing the signal): the round commits."""
        coord, dirs = self._pod(tmp_path, [3, 4])

        def land():
            time.sleep(0.3)
            mgr = ckpt.CheckpointManager(str(dirs[1]), async_save=False, max_to_keep=10)
            # the step namespace is past 2: write it as its own commit
            mgr._write_step(2, ckpt.state_payload(_state_at(2)), None)
            mgr.close()

        threading.Thread(target=land, daemon=True).start()
        results, errs = self._round(coord, dirs, 20.0)
        assert errs == {} and results[0]["step"] == results[1]["step"] == 2
        assert read_pod_commit(coord)["step"] == 2


class TestPeerHostDirs:
    def test_convention_and_loud_mismatch(self, tmp_path):
        d = tmp_path / "pod" / "host_1"
        assert peer_host_dirs(d, 1, 3) == jres.peer_host_dirs(d, 1, 3) == [
            str(tmp_path / "pod" / "host_0"), str(tmp_path / "pod" / "host_2")]
        with pytest.raises(ValueError, match="host_0"):
            peer_host_dirs(tmp_path / "pod" / "ckpt", 0, 2)


# -- gang-supervised recovery ------------------------------------------------------


def _data(host):
    def make():
        return shapes_dataset(2, 8, seed=100 + host)

    return make


def _snapshot(trainer):
    opt = trainer.state.optimizer.state_dict()["state"]
    return ([t.detach().clone() for t in param_leaves(trainer.state.params)],
            [v.clone() for st in opt.values() for v in st.values()],
            trainer.generator.get_state().clone())


class TestGangSupervisedRecovery:
    STEPS = 8

    def test_one_crash_restarts_the_gang_from_the_common_step(self, tmp_path, transports):
        """Host 0 crashes at its step 3 once host 1 committed step 2; host
        1 holds at step 4 until the stop is posted. Both resume from the
        common step 2, and each host's final state is bit for bit its
        uninterrupted run's."""
        dirs = {h: tmp_path / "ckpt" / f"host_{h}" for h in range(2)}
        w = {h: ListWriter() for h in range(2)}
        results, finals = {}, {}
        stop_posted = threading.Event()

        def host(h):
            coord = PodCoordinator(transports.make(h, 2), writer=w[h], poll_s=POLL)
            attempts = []

            def make_data():
                first = not attempts
                attempts.append(1)
                for i, b in enumerate(_data(h)()):
                    if first and h == 0 and i == 3:
                        deadline = time.monotonic() + 30.0
                        while not ckpt.step_valid_in_dir(dirs[1], 2):
                            assert time.monotonic() < deadline, "peer never committed 2"
                            time.sleep(0.01)
                        raise InjectedFault("injected gang-member crash")
                    if first and h == 1 and i == 4:
                        assert stop_posted.wait(30.0), "host 0 never signalled the stop"
                        while not coord.gang_stop_requested(1):
                            time.sleep(0.01)
                    yield b

            trainers = []

            def make_trainer():
                trainers.append(tiny_trainer())
                return trainers[-1]

            if h == 0:
                orig = coord.signal_gang_stop

                def signal_gang_stop(epoch, reason):
                    orig(epoch, reason)
                    stop_posted.set()

                coord.signal_gang_stop = signal_gang_stop
            results[h] = fit_supervised(
                make_trainer, make_data, self.STEPS, checkpoint_dir=str(dirs[h]),
                checkpoint_every=2, log_every=1,
                supervisor=TrainSupervisor(max_restarts=2, backoff_s=0.0, writer=w[h]),
                metrics_writer=w[h], gang=coord, pod_peers=peer_host_dirs(dirs[h], h, 2),
                gang_barrier_deadline_s=30.0)
            finals[h] = _snapshot(trainers[-1])

        assert _run_hosts(2, host, timeout=120.0) == {}
        for h in (0, 1):
            resumes = [r for r in w[h].all() if r.get("action") == "resume-from-checkpoint"]
            assert {r["step"] for r in resumes} == {2}, h
            arrivals = [r["round"] for r in w[h].all()
                        if r["kind"] == "barrier" and r["phase"] == "arrive"]
            assert "restart-e2" in arrivals
            assert all(schema.validate_record(r) == [] for r in w[h].all())
            clean = tiny_trainer()
            clean.fit(_data(h)(), self.STEPS, log_every=1)
            assert all(all(torch.equal(a, b) for a, b in zip(xs, ys))
                       for xs, ys in zip(_snapshot(clean)[:2], finals[h][:2]))
            assert torch.equal(_snapshot(clean)[2], finals[h][2])
        stops = [r for r in w[0].all() if r.get("action") == "gang-stop"]
        assert stops and stops[0]["host"] == 0
        restarts = [r for r in w[1].all() if r.get("action") == "restart"]
        assert restarts and "GangRestart" in restarts[0]["exception"]

    def test_pod_peers_need_a_gang(self, tmp_path):
        with pytest.raises(ValueError, match="pod_peers"):
            fit_supervised(tiny_trainer, _data(0), 1, checkpoint_dir=str(tmp_path),
                           pod_peers=[str(tmp_path)])
