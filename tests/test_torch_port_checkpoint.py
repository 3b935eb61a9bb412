"""The port's manifest-verified checkpoints and restart supervisor against
glom_tpu's, on the CPU with tiny Trainers.

glom_tpu's side runs its Orbax-backed CheckpointManager and its
fit_supervised on the same kind of run; the port must give the same
manifests, the same verification verdicts, the same recovery records
(action, step, note; attempt and backoff for the supervisor), and a
restored state whose next step equals the uninterrupted run's bit for bit.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from glom_tpu.data import synthetic as jsynthetic
from glom_tpu.resilience import FaultPlan as JFaultPlan
from glom_tpu.resilience import InjectedFault as JInjectedFault
from glom_tpu.resilience import truncate_newest_checkpoint as jtruncate
from glom_tpu.train import supervise as jsupervise
from glom_tpu.train import trainer as jtrainer
from glom_tpu.utils import checkpoint as jckpt
from glom_tpu.utils import config as jconfig
from glom_tpu_torch import GlomConfig, TrainConfig, Trainer
from glom_tpu_torch.data import shapes_dataset
from glom_tpu_torch.models.core import param_leaves
from glom_tpu_torch.resilience import (
    DirectoryTransport,
    FaultPlan,
    InjectedFault,
    PodCoordinator,
    truncate_newest_checkpoint,
)
from glom_tpu_torch.resilience.coordinator import GANG_DONE_ROUND
from glom_tpu_torch.telemetry import schema
from glom_tpu_torch.tracing import flight
from glom_tpu_torch.train import TrainSupervisor, fit_supervised
from glom_tpu_torch.utils import checkpoint as ckpt

TINY = {"dim": 16, "levels": 3, "image_size": 8, "patch_size": 4}


class ListWriter:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)

    def recoveries(self):
        return [r for r in self.records if r.get("kind") == "recovery"]


def tiny_trainer(**tkw):
    return Trainer(GlomConfig(**TINY), TrainConfig(batch_size=2, **tkw), device="cpu")


def batches(n, seed=0):
    it = shapes_dataset(2, 8, seed=seed)
    return [next(it) for _ in range(n)]


def snapshot(trainer):
    """Every tensor a step reads or writes: params, optimizer state, the
    noise generator's state."""
    opt = trainer.state.optimizer.state_dict()["state"]
    return ([t.detach().clone() for t in param_leaves(trainer.state.params)],
            [v.clone() for st in opt.values() for v in st.values()],
            trainer.generator.get_state().clone())


def assert_same(a, b):
    for xs, ys in zip(a, b):
        xs, ys = (xs, ys) if isinstance(xs, list) else ([xs], [ys])
        assert len(xs) == len(ys)
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))


# -- manifests -------------------------------------------------------------------


class TestManifests:
    def _tree(self, root):
        (root / "sub").mkdir(parents=True)
        (root / "a.bin").write_bytes(os.urandom(3000))
        (root / "sub" / "b.bin").write_bytes(b"x" * 100)
        (root / "sub" / "empty").write_bytes(b"")
        return root

    def test_build_matches_glom_tpu(self, tmp_path):
        d = self._tree(tmp_path / "step")
        ours, ref = ckpt.build_manifest(d), jckpt.build_manifest(d)
        ours.pop("wall_time_s"), ref.pop("wall_time_s")
        assert ours == ref and ours["n_files"] == 3

    @pytest.mark.parametrize("damage", ["truncate", "flip", "delete", "extra", "none"])
    def test_verify_matches_glom_tpu(self, tmp_path, damage):
        d = self._tree(tmp_path / "step")
        manifest = ckpt.build_manifest(d)
        target = d / "a.bin"
        if damage == "truncate":
            with open(target, "r+b") as fh:
                fh.truncate(1500)
        elif damage == "flip":
            data = bytearray(target.read_bytes())
            data[7] ^= 1
            target.write_bytes(bytes(data))
        elif damage == "delete":
            (d / "sub" / "b.bin").unlink()
        elif damage == "extra":
            (d / "new.bin").write_bytes(b"tolerated")
        errs = ckpt.verify_manifest(d, manifest)
        assert errs == jckpt.verify_manifest(d, manifest)
        assert bool(errs) == (damage in ("truncate", "flip", "delete"))

    def test_atomic_write_json(self, tmp_path):
        path = tmp_path / "m.json"
        ckpt.atomic_write_json(path, {"b": 1, "a": [2]})
        assert json.loads(path.read_text()) == {"a": [2], "b": 1}
        assert sorted(os.listdir(tmp_path)) == ["m.json"]  # no temp file left


# -- the manager ------------------------------------------------------------------


def _glom_tpu_torn_recovery(tmp_path, drop_manifest):
    """glom_tpu's recovery record for a truncated newest step (steps 1, 2)."""
    state = {"w": np.arange(32, dtype=np.float32), "step": np.zeros((), np.int32)}
    w = ListWriter()
    mgr = jckpt.CheckpointManager(str(tmp_path), async_save=False, metrics_writer=w)
    for s in (1, 2):
        mgr.save(s, {"w": state["w"] + s, "step": np.asarray(s, np.int32)})
    if drop_manifest:
        (tmp_path / "manifest_2.json").unlink()
        for p in (tmp_path / "2").rglob("*"):
            if p.is_file():
                with open(p, "r+b") as fh:
                    fh.truncate(1)
    else:
        jtruncate(tmp_path)
    step, _ = mgr.restore(abstract_state=jckpt.abstract_like(state))
    mgr.close()
    return step, w.recoveries()


class TestManager:
    def _saved(self, directory, steps=(1, 2, 3), **kw):
        tr = tiny_trainer()
        w = ListWriter()
        mgr = ckpt.CheckpointManager(str(directory), metrics_writer=w, **kw)
        for s, b in zip(steps, batches(len(steps))):
            tr.step(b)
            assert mgr.save(s, tr.state, generator=tr.generator)
        mgr.wait()
        return tr, mgr, w

    @pytest.mark.parametrize("async_save", [True, False])
    def test_every_save_lands_a_manifest(self, tmp_path, async_save):
        _, mgr, w = self._saved(tmp_path, async_save=async_save)
        assert mgr.valid_steps() == [1, 2, 3] and mgr.latest_step() == 3
        for s in (1, 2, 3):
            assert (tmp_path / f"manifest_{s}.json").is_file() and mgr.verify_step(s)
            assert sorted(os.listdir(tmp_path / str(s))) == [ckpt.STATE_FILE]
        names = [r["name"] for r in w.records if r.get("kind") == "span"]
        assert names.count("host_checkpoint_save") == 3
        assert names.count("host_checkpoint_write") == 3
        assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp")]

    @pytest.mark.parametrize("drop_manifest", [False, True])
    def test_torn_newest_restores_previous_like_glom_tpu(self, tmp_path, drop_manifest):
        want_step, want = _glom_tpu_torn_recovery(tmp_path / "ref", drop_manifest)
        tr, mgr, w = self._saved(tmp_path / "ours", steps=(1, 2))
        if drop_manifest:
            (tmp_path / "ours" / "manifest_2.json").unlink()
            for p in (tmp_path / "ours" / "2").rglob("*"):
                with open(p, "r+b") as fh:
                    fh.truncate(1)
            assert 2 in mgr.valid_steps()  # unverifiable, accepted on the commit
        else:
            assert truncate_newest_checkpoint(tmp_path / "ours")[0] == 2
            assert mgr.latest_step() == 1
        step, _ = mgr.restore(state=tiny_trainer().state)
        got = w.recoveries()
        assert step == want_step == 1
        assert [sorted(r) for r in got] == [sorted(r) for r in want]
        for g, r in zip(got, want):
            assert (g["action"], g["step"]) == (r["action"], r["step"])
            assert g["quarantined"].split("/")[-2:][0] == ".quarantine"
            assert os.path.basename(g["quarantined"]).startswith("2_")
            if not drop_manifest:
                assert g["note"] == r["note"]
        assert mgr.all_steps() == [1]  # the torn step left the namespace
        assert mgr.save(2, tr.state)  # and no longer declines a save

    def test_explicit_corrupt_step_raises(self, tmp_path):
        _, mgr, _ = self._saved(tmp_path, steps=(1, 2))
        truncate_newest_checkpoint(tmp_path)
        with pytest.raises(ckpt.CheckpointCorruptError):
            mgr.restore(2, state=tiny_trainer().state)
        assert mgr.restore(1, state=tiny_trainer().state)[0] == 1
        with pytest.raises(FileNotFoundError):
            ckpt.CheckpointManager(str(tmp_path / "empty")).restore(state=tiny_trainer().state)

    def test_retention_and_declined_saves(self, tmp_path):
        tr, mgr, _ = self._saved(tmp_path, steps=(1, 2, 3, 4), max_to_keep=2)
        assert mgr.all_steps() == [3, 4]
        assert sorted(p for p in os.listdir(tmp_path) if p.startswith("manifest")) == [
            "manifest_3.json", "manifest_4.json"]
        assert not mgr.save(4, tr.state) and not mgr.save(2, tr.state)
        with pytest.raises(ValueError):
            ckpt.CheckpointManager(str(tmp_path), max_to_keep=0)
        # Pod mode: a step counts only where every peer holds it too.
        peer = tmp_path.parent / f"{tmp_path.name}_peer"
        pod = ckpt.CheckpointManager(str(tmp_path), pod_peers=[str(peer)])
        assert pod.valid_steps() == [] and pod.latest_step() is None
        ckpt.CheckpointManager(str(peer), async_save=False).save(4, tr.state)
        assert pod.valid_steps() == [4]

    @pytest.mark.parametrize("async_save", [True, False])
    def test_write_failure_leaves_previous_steps_valid(self, tmp_path, monkeypatch,
                                                       async_save):
        tr, mgr, _ = self._saved(tmp_path, steps=(1,), async_save=async_save)
        real_save = torch.save
        plan = FaultPlan(seed=0).register("ckpt-write", at=(0,))
        monkeypatch.setattr(torch, "save", plan.wrap(real_save, "ckpt-write",
                                                     exc=lambda: OSError("injected ENOSPC")))
        with pytest.raises(OSError, match="ENOSPC"):
            mgr.save(2, tr.state)
            mgr.wait()  # the async writer's error surfaces here
        assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
        assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp")]
        assert mgr.save(2, tr.state)
        mgr.wait()
        assert mgr.latest_step() == 2

    @pytest.mark.parametrize("tkw", [{}, {"telemetry_level": "scalars", "lr_schedule": "cosine",
                                          "weight_decay": 0.1}])
    def test_restored_step_equals_uninterrupted(self, tmp_path, tkw):
        data = batches(5)
        ref = tiny_trainer(**tkw)
        for b in data[:3]:
            ref.step(b)
        mgr = ckpt.CheckpointManager(str(tmp_path))
        mgr.save(3, ref.state, generator=ref.generator)
        want_loss = [float(ref.step(b)["loss"]) for b in data[3:]]
        want = snapshot(ref)
        fresh = tiny_trainer(**tkw)
        step, fresh.state = mgr.restore(state=fresh.state, generator=fresh.generator)
        assert step == fresh.state.step == 3
        got_loss = [float(fresh.step(b)["loss"]) for b in data[3:]]
        assert got_loss == want_loss
        assert_same(snapshot(fresh), want)

    def test_levels_ride_along(self, tmp_path):
        tr = tiny_trainer()
        levels = torch.randn(2, 4, 3, 16)
        mgr = ckpt.CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, tr.state, levels=levels)
        assert sorted(os.listdir(tmp_path / "1")) == [ckpt.LEVELS_FILE, ckpt.STATE_FILE]
        step, (state, got) = mgr.restore(state=tiny_trainer().state, with_levels=True)
        assert step == 1 and torch.equal(got, levels)
        levels.add_(1)  # the saved copy does not alias the caller's tensor
        assert not torch.equal(got, levels)

    def test_mismatched_state_raises_before_writing(self, tmp_path):
        tr = tiny_trainer()
        ckpt.CheckpointManager(str(tmp_path), async_save=False).save(1, tr.state)
        other = Trainer(GlomConfig(dim=16, levels=4, image_size=8, patch_size=4),
                        TrainConfig(batch_size=2), device="cpu")
        before = [t.clone() for t in param_leaves(other.state.params)]
        with pytest.raises(ValueError, match="do not match"):
            ckpt.CheckpointManager(str(tmp_path)).restore(state=other.state)
        assert all(torch.equal(a, b) for a, b in zip(before, param_leaves(other.state.params)))

    def test_preemption_save(self, tmp_path):
        tr = tiny_trainer()
        tr.step(batches(1)[0])
        assert ckpt.preemption_save(str(tmp_path), tr.state, 1, generator=tr.generator) == 1
        assert ckpt.preemption_save(str(tmp_path), tr.state, 1) == 1  # already committed
        with pytest.raises(RuntimeError, match="declined"):
            ckpt.preemption_save(str(tmp_path), tr.state, 0)
        mgr = ckpt.CheckpointManager(str(tmp_path))
        assert mgr.valid_steps() == [1]


# -- a SIGTERM inside an optimizer step -------------------------------------------


@pytest.fixture
def sigterm_recorder(tmp_path):
    """A flight recorder whose SIGTERM hook chains to a handler that only
    records the signal, so the process lives on; the handler before it is
    put back afterwards."""
    prev = signal.getsignal(signal.SIGTERM)
    delivered = []
    signal.signal(signal.SIGTERM, lambda signum, frame: delivered.append(signum))
    fr = flight.FlightRecorder(str(tmp_path / "fr")).install_process_hooks(on_exit=False)
    flight.set_global_flight_recorder(fr)
    try:
        yield delivered
    finally:
        flight.set_global_flight_recorder(None)
        signal.signal(signal.SIGTERM, prev)


def sigterm_inside_step(at):
    """SIGTERM this process from inside the `at`-th optimizer step (0-based),
    before its in-place update: Python runs the handler at the next
    bytecode, inside the step."""
    count = [0]

    def hook(opt, args, kwargs):
        if count[0] == at:
            os.kill(os.getpid(), signal.SIGTERM)
        count[0] += 1

    return register_optimizer_step_pre_hook(hook)


def preemption_records(fr_dir):
    """The preemption-checkpoint records of the SIGTERM dumps."""
    recs = []
    for name in sorted(os.listdir(fr_dir)):
        with open(os.path.join(fr_dir, name)) as fh:
            dump = [json.loads(ln) for ln in fh]
        if dump[0]["trigger"] == "sigterm":
            recs += dump[1:]
    return [r for r in recs if r.get("action") == "preemption-checkpoint"]


def payload_tensors(path):
    payload = torch.load(path, weights_only=True)
    opt = payload["optimizer"]["state"]
    return ([payload["params"][k] for k in sorted(payload["params"])],
            [v for i in sorted(opt) for k, v in sorted(opt[i].items())],
            payload["generator"], payload["step"])


class TestSigtermInsideAStep:
    """The parameters and Adam's moments update in place, so a save taken
    mid-step would mix two steps. A SIGTERM that lands inside a step is
    held to the step's end: the preemption save is ok and holds the state
    after that step, bit for bit the uninterrupted run's."""

    AT = 2  # the signal lands in the third step; the save holds step 3

    def _check(self, tmp_path, saved_dir, clean_dir, fr_dir="fr"):
        (rec,) = preemption_records(tmp_path / fr_dir)
        assert rec["ok"] is True, rec
        assert rec["step"] == self.AT + 1 and rec["deferred_s"] >= 0
        assert schema.validate_record(rec) == []
        got = payload_tensors(saved_dir / str(self.AT + 1) / ckpt.STATE_FILE)
        want = payload_tensors(clean_dir / str(self.AT + 1) / ckpt.STATE_FILE)
        assert got[3] == want[3] == self.AT + 1
        assert_same(got[:3], want[:3])

    def test_fit_supervised(self, tmp_path, sigterm_recorder):
        handle = sigterm_inside_step(self.AT)
        try:
            fit_supervised(tiny_trainer, lambda: iter(batches(4)), 4,
                           checkpoint_dir=str(tmp_path / "a"), checkpoint_every=4, log_every=1)
        finally:
            handle.remove()
        assert sigterm_recorder == [signal.SIGTERM]  # the chained handler ran
        fit_supervised(tiny_trainer, lambda: iter(batches(4)), self.AT + 1,
                       checkpoint_dir=str(tmp_path / "b"), checkpoint_every=self.AT + 1,
                       log_every=1)
        self._check(tmp_path, tmp_path / "a", tmp_path / "b")
        assert ckpt.CheckpointManager(str(tmp_path / "a")).valid_steps() == [3, 4]

    def test_training_cli(self, tmp_path, sigterm_recorder):
        from glom_tpu_torch.train import cli

        base = ["--preset", "mnist", "--device", "cpu", "--batch-size", "4", "--log-every", "1",
                "--prefetch", "0"]
        handle = sigterm_inside_step(self.AT)
        try:
            assert cli.main(base + ["--steps", "4", "--checkpoint-every", "4",
                                    "--checkpoint-dir", str(tmp_path / "a"),
                                    "--flight-recorder", str(tmp_path / "cli_fr")]) == 0
        finally:
            handle.remove()
        assert sigterm_recorder == [signal.SIGTERM]
        assert cli.main(base + ["--steps", str(self.AT + 1), "--checkpoint-every",
                                str(self.AT + 1), "--checkpoint-dir", str(tmp_path / "b")]) == 0
        self._check(tmp_path, tmp_path / "a", tmp_path / "b", fr_dir="cli_fr")

    def test_a_step_that_raises_saves_nothing(self, tmp_path, sigterm_recorder):
        """The step the signal landed in raised: no whole state exists, so
        the hook is not run and the record says why."""
        tr = tiny_trainer()
        fr = flight.get_global_flight_recorder()
        saved = []
        fr.set_checkpoint_hook(lambda: saved.append(1))
        handle = sigterm_inside_step(0)

        def raising(opt, args, kwargs):
            raise InjectedFault("the update failed")

        bad = register_optimizer_step_pre_hook(raising)
        try:
            with pytest.raises(InjectedFault):
                tr.step(batches(1)[0])
        finally:
            handle.remove()
            bad.remove()
            fr.set_checkpoint_hook(None)
        (rec,) = preemption_records(tmp_path / "fr")
        assert rec["ok"] is False and "raised (InjectedFault)" in rec["note"] and not saved
        assert sigterm_recorder == [signal.SIGTERM]


# -- the restart supervisor --------------------------------------------------------


def _faulty(make, plan, exc):
    """A data factory whose stream raises where the plan fires."""

    def factory():
        def gen():
            for batch in make():
                if plan.fires("train-step"):
                    raise exc("injected trainer crash")
                yield batch
        return gen()

    return factory


def _recovery_shape(records):
    return [(r["action"], r.get("attempt"), r.get("step"), r.get("backoff_s"))
            for r in records if r.get("kind") == "recovery"]


class TestSupervisor:
    KW = dict(checkpoint_every=2, log_every=1)  # one step variant: one compile an attempt

    def _ours(self, tmp_path, at, steps=6, max_restarts=2):
        w = ListWriter()
        plan = FaultPlan(seed=1)
        if at is not None:
            plan.register("train-step", at=at, fault="trainer-crash")
        trainers = []

        def make_trainer():
            trainers.append(Trainer(GlomConfig(**TINY), TrainConfig(batch_size=2),
                                    metrics_writer=w, device="cpu"))
            return trainers[-1]

        hist = fit_supervised(
            make_trainer, _faulty(lambda: shapes_dataset(2, 8), plan, InjectedFault), steps,
            checkpoint_dir=str(tmp_path), metrics_writer=w,
            supervisor=TrainSupervisor(max_restarts=max_restarts, backoff_s=0.25,
                                       writer=w, sleep=lambda s: None), **self.KW)
        return hist, w, trainers[-1]

    def test_recovery_sequence_matches_glom_tpu(self, tmp_path):
        w = ListWriter()
        plan = JFaultPlan(seed=1).register("train-step", at=(3,), fault="trainer-crash")
        jsupervise.fit_supervised(
            lambda: jtrainer.Trainer(jconfig.GlomConfig(**TINY),
                                     jconfig.TrainConfig(batch_size=2), metrics_writer=w),
            _faulty(lambda: jsynthetic.shapes_dataset(2, 8), plan, JInjectedFault), 6,
            checkpoint_dir=str(tmp_path / "ref"), metrics_writer=w,
            supervisor=jsupervise.TrainSupervisor(max_restarts=2, backoff_s=0.25, writer=w,
                                                  sleep=lambda s: None), **self.KW)
        hist, ours, _ = self._ours(tmp_path / "ours", at=(3,))
        want = _recovery_shape(w.records)
        assert _recovery_shape(ours.records) == want
        assert want == [("restart", 1, None, 0.25), ("resume-from-checkpoint", 2, 2, None)]
        assert sorted({int(h["step"]) for h in hist}) == list(range(6))

    def test_restart_is_bit_exact(self, tmp_path):
        _, _, faulted = self._ours(tmp_path / "a", at=(3,))
        _, _, clean = self._ours(tmp_path / "b", at=None)
        assert faulted.state.step == clean.state.step == 6
        assert_same(snapshot(faulted), snapshot(clean))

    def test_a_factory_that_takes_start_is_asked_for_it(self, tmp_path):
        """A make_data with a `start` parameter gets the restored step and
        is not replayed; the run ends bit for bit on the uninterrupted one."""
        starts, trainers = [], []

        def make_data(start):
            starts.append(start)

            def gen():
                for i, batch in enumerate(shapes_dataset(2, 8, start=start)):
                    if start == 0 and i == 3:
                        raise InjectedFault("injected trainer crash")
                    yield batch
            return gen()

        def make_trainer():
            trainers.append(Trainer(GlomConfig(**TINY), TrainConfig(batch_size=2),
                                    device="cpu"))
            return trainers[-1]

        fit_supervised(make_trainer, make_data, 6, checkpoint_dir=str(tmp_path / "a"),
                       supervisor=TrainSupervisor(max_restarts=2, backoff_s=0.25,
                                                  sleep=lambda s: None), **self.KW)
        _, _, clean = self._ours(tmp_path / "b", at=None)
        assert starts == [0, 2] and trainers[-1].state.step == 6
        assert_same(snapshot(trainers[-1]), snapshot(clean))

    def test_gives_up_and_reraises(self, tmp_path):
        with pytest.raises(InjectedFault):
            self._ours(tmp_path, at=tuple(range(100)), max_restarts=1)

    def test_already_complete_returns_and_gang_refused(self, tmp_path):
        """A complete checkpoint returns at once; in a gang the member first
        meets the restart barrier and then posts its done flag, as
        glom_tpu's does."""
        self._ours(tmp_path, at=None, steps=2)
        hist, w, _ = self._ours(tmp_path, at=None, steps=2)
        assert hist == [] and _recovery_shape(w.records) == [
            ("resume-from-checkpoint", 1, 2, None)]
        gw = ListWriter()
        gang = PodCoordinator(DirectoryTransport(tmp_path / "coord", 0, 1), writer=gw)
        assert fit_supervised(tiny_trainer, lambda: iter([]), 2, checkpoint_dir=str(tmp_path),
                              gang=gang, metrics_writer=gw) == []
        assert gang.transport.read_all(GANG_DONE_ROUND, "done") == {0: {"host": 0, "steps": 2}}
        assert [(r["kind"], r.get("phase") or r.get("action")) for r in gw.records
                if r["kind"] in ("barrier", "recovery")] == [
            ("barrier", "arrive"), ("barrier", "complete"),
            ("recovery", "resume-from-checkpoint"), ("barrier", "done")]

    def test_backoff_matches_glom_tpu(self):
        kw = dict(max_restarts=4, backoff_s=0.5, backoff_factor=3.0, backoff_max_s=5.0,
                  sleep=lambda s: None)
        ours, ref = TrainSupervisor(**kw), jsupervise.TrainSupervisor(**kw)
        err = RuntimeError("x")
        got = [ours.on_failure(err) for _ in range(5)]
        assert got == [ref.on_failure(err) for _ in range(5)] == [0.5, 1.5, 4.5, 5.0, None]
        assert ours.record() == ref.record()
        with pytest.raises(ValueError):
            TrainSupervisor(backoff_factor=0.5)
