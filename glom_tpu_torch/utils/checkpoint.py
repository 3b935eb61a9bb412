"""Checkpoint / resume on torch.save, manifest-verified.

Counterpart of `glom_tpu/utils/checkpoint.py`, with its contract. A step
saves the full training state as plain containers of tensors and numbers
(`torch.load(weights_only=True)` reads them back): the params as a flat
dict of tensors keyed by their dotted paths, the optimizer's `state_dict`,
the step, the trainer's noise generator state (glom_tpu saves the host rng
key), and optionally the carried `levels` of a temporal run.

Layout under `directory`:

    <step>/state.pt            the state (levels.pt beside it, if saved)
    manifest_<step>.json       per-file size + sha256 of <step>/
    .quarantine/<step>_<ts>/   torn steps moved out of the step namespace

A step is written into a hidden temporary directory, each file fsynced,
and committed by renaming that directory to `<step>` (the atomic commit);
the manifest is written after the commit, temp file -> fsync ->
os.replace. The read side (`latest_step`, `valid_steps`,
`restore(step=None)`) hands out only steps that VERIFY: a torn or
checksum-failed step is skipped with a stamped "recovery" event (action
"skip-torn-checkpoint"), moved to `.quarantine/`, and the previous valid
step restores instead. A step with no manifest (a kill between the commit
and the manifest write) is accepted on its committed directory alone; if
it then fails to load, the restore walk skips it the same way. A step
named explicitly that fails verification raises CheckpointCorruptError.

Saves are asynchronous by default. The parameters and Adam's moments are
updated in place by the next optimizer step, so `save()` copies them to
the host before it returns (a device-to-host copy waits for the work
queued before it); only the file writes, the commit and the manifest run
on the writer thread. `wait()` and `close()` drain it, and so do the next
save and every read.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

STATE_FILE = "state.pt"
LEVELS_FILE = "levels.pt"


class CheckpointCorruptError(RuntimeError):
    """An EXPLICITLY requested step failed manifest verification. The
    step=None path never raises this: it skips to the previous valid
    step."""


def _fsync_dir(path: Path) -> None:
    """fsync the directory entry so a rename into it is durable."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # a file system without directory open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: Path, obj: Any) -> None:
    """Temp path in the SAME directory + flush + fsync + os.replace: a
    reader (or a crash) sees either the old file or the complete new one,
    never a torn write."""
    path = Path(path)
    fd, tmp = tempfile.mkstemp(prefix=f".{path.name}.", suffix=".tmp", dir=path.parent)
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(obj, fh, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(path.parent)


def _file_sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def build_manifest(step_dir: Path) -> Dict[str, Any]:
    """Per-file size + sha256 over everything under one committed step."""
    files: Dict[str, Dict[str, Any]] = {}
    for p in sorted(Path(step_dir).rglob("*")):
        if p.is_file():
            files[str(p.relative_to(step_dir))] = {
                "size": p.stat().st_size,
                "sha256": _file_sha256(p),
            }
    return {
        "manifest_version": 1,
        "wall_time_s": round(time.time(), 3),
        "n_files": len(files),
        "files": files,
    }


def verify_manifest(step_dir: Path, manifest: Dict[str, Any]) -> List[str]:
    """Mismatches between a step dir and its manifest; empty = verified.
    Extra files are tolerated; a missing, resized, or checksum-failed
    manifested file is corruption."""
    errs: List[str] = []
    step_dir = Path(step_dir)
    for rel, meta in manifest.get("files", {}).items():
        p = step_dir / rel
        if not p.is_file():
            errs.append(f"{rel}: missing")
            continue
        size = p.stat().st_size
        if size != meta.get("size"):
            errs.append(f"{rel}: size {size} != manifest {meta.get('size')}")
            continue
        if _file_sha256(p) != meta.get("sha256"):
            errs.append(f"{rel}: sha256 mismatch")
    return errs


# -- the state as plain containers -------------------------------------------


def named_leaves(params) -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf of nested NamedTuples of tensors,
    in field order."""
    if torch.is_tensor(params):
        return [("", params)]
    out = []
    for field in params._fields:
        for sub, t in named_leaves(getattr(params, field)):
            out.append((f"{field}.{sub}" if sub else field, t))
    return out


def _to_host(obj):
    """A copy of `obj` with every tensor copied to the CPU (a fresh copy
    for CPU tensors too: the originals are updated in place next step)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_host(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_to_host(v) for v in obj)
    return obj


def state_payload(state, generator: Optional[torch.Generator] = None) -> dict:
    """The TrainState (and noise generator) as plain containers on the
    host."""
    return {
        "params": {name: _to_host(t) for name, t in named_leaves(state.params)},
        "optimizer": _to_host(state.optimizer.state_dict()),
        "step": int(state.step),
        "generator": None if generator is None else generator.get_state().clone(),
    }


def load_payload(state, payload: dict, generator: Optional[torch.Generator] = None):
    """Write a payload into `state` in place (the params keep their
    identity, so the optimizer built over them stays bound) and into
    `generator`; return the state with the saved step. A payload whose
    params do not match the state's names and shapes raises ValueError
    before anything is written."""
    leaves = named_leaves(state.params)
    saved = payload["params"]
    want = {name: tuple(t.shape) for name, t in leaves}
    got = {name: tuple(t.shape) for name, t in saved.items()}
    if want != got:
        raise ValueError(f"checkpoint params {got} do not match the trainer's {want}")
    with torch.no_grad():
        for name, t in leaves:
            t.copy_(saved[name])
    state.optimizer.load_state_dict(payload["optimizer"])
    if generator is not None and payload.get("generator") is not None:
        generator.set_state(payload["generator"].cpu())
    return state._replace(step=int(payload["step"]))


# -- pure-file pod helpers: these judge and move PEER hosts' steps, whose
# managers live in other processes ------------------------------------------

# step_valid_in_dir results keyed by the manifest's (mtime_ns, size), held at
# module level because the pod read side sweeps peer dirs on every
# reconcile. The manifest-absent fallback is never cached (one is_dir()), so
# the preemption retention poll stays live while an async commit lands.
_step_valid_cache: Dict[Tuple[str, int], Tuple[Tuple[int, int], bool]] = {}


def step_valid_in_dir(directory, step: int) -> bool:
    """True when `step` is safe to restore from `directory`, judged from
    files alone: a present manifest must verify bit for bit; an absent
    manifest falls back to the committed step directory (the contract of
    CheckpointManager.verify_step, manager-free so it can judge a PEER
    host's directory)."""
    directory = Path(directory)
    step_dir = directory / str(int(step))
    mpath = directory / f"manifest_{int(step)}.json"
    try:
        st = mpath.stat()
    except OSError:
        return step_dir.is_dir()
    sig = (st.st_mtime_ns, st.st_size)
    key = (str(directory), int(step))
    cached = _step_valid_cache.get(key)
    if cached is not None and cached[0] == sig:
        return cached[1]
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except (OSError, json.JSONDecodeError):
        ok = False
    else:
        ok = not verify_manifest(step_dir, manifest)
    _step_valid_cache[key] = (sig, ok)
    return ok


def quarantine_step_in_dir(directory, step: int) -> Optional[str]:
    """Move one step OUT of a host directory's step namespace (to the hidden
    `.quarantine/<step>_<ts>`) and drop its manifest: the pure-file half of
    the manager's quarantine, callable against PEER directories. Tolerant of
    races (relaunched hosts reconcile concurrently over shared storage; the
    one that moved the directory first wins). Returns the quarantine path
    (None when already gone)."""
    directory = Path(directory)
    step = int(step)
    step_dir = directory / str(step)
    dest: Optional[Path] = None
    if step_dir.is_dir():
        qdir = directory / ".quarantine"
        try:
            qdir.mkdir(exist_ok=True)
            dest = qdir / f"{step}_{time.strftime('%Y%m%d_%H%M%S')}"
            step_dir.rename(dest)
        except OSError:
            dest = None
        if dest is None and step_dir.is_dir():
            # The rename failed with the step still in place: keep the
            # manifest, the evidence that marks the step invalid (without
            # it the absent-manifest fallback would call the step valid).
            return None
    try:
        (directory / f"manifest_{step}.json").unlink()
    except OSError:
        pass
    return str(dest) if dest is not None else None


class _SpanSink:
    """Writer shim for the checkpoint spans: forwards to the manager's
    metrics_writer when one is attached, else to the flight recorder."""

    def __init__(self, mgr: "CheckpointManager"):
        self._mgr = mgr

    def write(self, rec: dict) -> None:
        from glom_tpu_torch.tracing.flight import write_or_observe

        write_or_observe(self._mgr.metrics_writer, rec)


class CheckpointManager:
    """Manifest-verified checkpoints of a TrainState, one directory a step.

    save() and wait() are span-covered (host_checkpoint_save: the host
    copy and the hand-off; host_checkpoint_wait: the drain) and the writer
    thread's file writes, commit and manifest are one host_checkpoint_write
    span, each with its step; with `metrics_writer` they land in the run's
    metrics stream. A save at a step at or below the newest committed one
    is declined (returns False), as Orbax declines it. `max_to_keep`
    newest steps are kept. `pod_peers` names the sibling hosts' directories
    (pod mode: the read side reconciles to steps valid on every host); a
    distributed run's checkpoint is the global state
    (DistributedTrainer.save_checkpoint)."""

    def __init__(
        self,
        directory: str,
        *,
        max_to_keep: int = 3,
        async_save: bool = True,
        metrics_writer=None,
        pod_peers=None,
    ):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep {max_to_keep} must be >= 1")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        # None: the single-host contract, unchanged.
        self.pod_peers: List[Path] = [Path(p) for p in (pod_peers or [])]
        self.max_to_keep = max_to_keep
        self._async = async_save
        self.metrics_writer = metrics_writer
        # Every manager operation rides this lock, so a preemption hook's
        # thread and the training loop serialize (the SIGTERM grace path
        # uses its own manager: see preemption_save).
        self._op_lock = threading.RLock()
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        # verify_step results keyed by the manifest's (mtime_ns, size): the
        # resume path asks about one step more than once, and re-hashing
        # a multi-GB step per ask is dead time on the recovery path.
        self._verify_cache: Dict[int, Tuple[Tuple[int, int], bool]] = {}
        from glom_tpu_torch.tracing.spans import spanned

        self._sink = _SpanSink(self)
        self.save = spanned("host_checkpoint_save", writer=self._sink)(self.save)
        self.wait = spanned("host_checkpoint_wait", writer=self._sink)(self.wait)

    # -- layout ------------------------------------------------------------

    def _manifest_path(self, step: int) -> Path:
        return self.directory / f"manifest_{int(step)}.json"

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(int(step))

    def all_steps(self) -> List[int]:
        """Ascending committed steps (verified or not)."""
        return sorted(
            int(p.name) for p in self.directory.iterdir() if p.is_dir() and p.name.isdigit()
        )

    def _emit_recovery(self, rec: dict) -> None:
        from glom_tpu_torch.resilience.faults import emit_recovery

        emit_recovery(self.metrics_writer, rec)

    # -- the writer thread -------------------------------------------------

    def _drain(self) -> None:
        """Wait for the writer thread; re-raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_error is not None:
            err, self._writer_error = self._writer_error, None
            raise err

    def _write_step(self, step: int, payload: dict, levels) -> None:
        """Write, commit (the rename), manifest, retention."""
        from glom_tpu_torch.telemetry import schema

        t0 = time.perf_counter()
        step_dir = self._step_dir(step)
        tmp = self.directory / f".tmp-{step}-{uuid.uuid4().hex}"
        tmp.mkdir()
        try:
            files = {STATE_FILE: payload}
            if levels is not None:
                files[LEVELS_FILE] = levels
            for name, obj in files.items():
                with open(tmp / name, "wb") as fh:
                    torch.save(obj, fh)
                    fh.flush()
                    os.fsync(fh.fileno())
            _fsync_dir(tmp)
            os.rename(tmp, step_dir)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _fsync_dir(self.directory)
        manifest = build_manifest(step_dir)
        atomic_write_json(self._manifest_path(step), manifest)
        self._retire_old_steps()
        self._sink.write(schema.stamp({
            "name": "host_checkpoint_write",
            "dur_s": round(time.perf_counter() - t0, 6),
            "step": int(step),
            "bytes": sum(f["size"] for f in manifest["files"].values()),
        }, kind="span"))

    def _write_async(self, step: int, payload: dict, levels) -> None:
        try:
            self._write_step(step, payload, levels)
        except BaseException as e:  # noqa: BLE001 - relayed at the next drain
            # glom-lint: ok[lockset] read only by _drain, after its join() of this thread
            self._writer_error = e

    def _retire_old_steps(self) -> None:
        """Keep the max_to_keep newest steps: an old step leaves the step
        namespace by one rename, then its files and manifest go."""
        for step in self.all_steps()[:-self.max_to_keep]:
            gone = self.directory / f".tmp-retire-{step}-{uuid.uuid4().hex}"
            try:
                os.rename(self._step_dir(step), gone)
            except OSError:
                continue
            shutil.rmtree(gone, ignore_errors=True)
            try:
                self._manifest_path(step).unlink()
            except OSError:
                pass
            # The writer thread may not take _op_lock (the caller holds it
            # while joining the writer). An entry is only used after
            # verify_step stats its manifest, unlinked above before this
            # pop: a verify racing the retirement finds no manifest and
            # drops the entry itself.
            # glom-lint: ok[lockset] the manifest's unlink above orders this before any use
            self._verify_cache.pop(step, None)

    def _quarantine_torn(self, step: int) -> Optional[str]:
        """Move a torn step OUT of the step namespace (to the hidden
        `.quarantine/<step>_<ts>`, kept for postmortems) and drop its
        manifest: a torn newest step left in place would keep declining
        every later save at or below it. Returns the quarantine path
        (None when the directory was already gone)."""
        step = int(step)
        step_dir = self._step_dir(step)
        dest: Optional[Path] = None
        if step_dir.is_dir():
            qdir = self.directory / ".quarantine"
            try:
                qdir.mkdir(exist_ok=True)
                dest = qdir / f"{step}_{time.strftime('%Y%m%d_%H%M%S')}"
                step_dir.rename(dest)
            except OSError:
                dest = None
        try:
            self._manifest_path(step).unlink()
        except OSError:
            pass
        self._verify_cache.pop(step, None)
        return str(dest) if dest is not None else None

    # -- verification --------------------------------------------------------

    def verify_step(self, step: int) -> bool:
        """True when `step` is safe to restore: a present manifest must
        verify bit for bit; an absent manifest falls back to the committed
        step directory."""
        with self._op_lock:
            mpath = self._manifest_path(step)
            try:
                st = mpath.stat()
            except OSError:
                self._verify_cache.pop(int(step), None)
                return self._step_dir(step).is_dir()
            sig = (st.st_mtime_ns, st.st_size)
            cached = self._verify_cache.get(int(step))
            if cached is not None and cached[0] == sig:
                return cached[1]
            try:
                with open(mpath) as fh:
                    manifest = json.load(fh)
            except (OSError, json.JSONDecodeError):
                ok = False  # a manifest that cannot be read certifies nothing
            else:
                ok = not verify_manifest(self._step_dir(step), manifest)
            self._verify_cache[int(step)] = (sig, ok)
            return ok

    def valid_steps(self) -> List[int]:
        """Ascending steps that pass verification: the only steps the
        restore path hands out. In pod mode a step must verify on EVERY
        host, so latest_step() is the newest COMMON step."""
        with self._op_lock:
            self._drain()
            return [s for s in self.all_steps() if self.verify_step(s)
                    and all(step_valid_in_dir(p, s) for p in self.pod_peers)]

    def latest_step(self) -> Optional[int]:
        """Newest verified step (None when nothing valid exists)."""
        steps = self.valid_steps()
        return steps[-1] if steps else None

    # -- save / restore ------------------------------------------------------

    def save(
        self,
        step: int,
        state: Any,
        *,
        generator: Optional[torch.Generator] = None,
        levels: Optional[torch.Tensor] = None,
    ) -> bool:
        """Save `state` (a TrainState), the noise `generator`'s state and
        optionally the carried temporal `levels` at `step`. Returns False
        when the step is declined (at or below the newest committed step)."""
        with self._op_lock:
            self._drain()
            steps = self.all_steps()
            if steps and int(step) <= steps[-1]:
                return False
            payload = state_payload(state, generator)
            host_levels = None if levels is None else _to_host(levels)
            if self._async:
                self._writer = threading.Thread(
                    target=self._write_async, args=(int(step), payload, host_levels),
                    name="glom-checkpoint-writer", daemon=True,
                )
                self._writer.start()
            else:
                self._write_step(int(step), payload, host_levels)
            return True

    def restore(
        self,
        step: Optional[int] = None,
        *,
        state: Any,
        generator: Optional[torch.Generator] = None,
        with_levels: bool = False,
    ):
        """Restore the newest VALID (or a named) step into `state` (the
        trainer's TrainState, written in place on its parameters' device;
        `levels` load onto that device) and `generator`.

        step=None walks the committed steps newest first: a step that
        fails verification, or that verifies (no manifest) but fails to
        load, is skipped with a stamped "recovery" event and quarantined,
        and the previous one restores. A named step that fails
        verification raises CheckpointCorruptError. In pod mode step=None
        also requires the candidate to be valid on every peer: a
        half-committed step is quarantined on EVERY host ("quarantine-
        half-step"), and a step torn here is quarantined on the peers too.
        Returns (step, state), or (step, (state, levels)) with
        with_levels."""
        with self._op_lock:
            self._drain()
            if step is not None:
                if not self.verify_step(step):
                    raise CheckpointCorruptError(
                        f"checkpoint step {step} in {self.directory} failed "
                        "manifest verification (torn or corrupted)"
                    )
                candidates = [int(step)]
            else:
                candidates = sorted(self.all_steps(), reverse=True)
            device = named_leaves(state.params)[0][1].device
            last_exc: Optional[BaseException] = None
            for s in candidates:
                if step is None and not self.verify_step(s):
                    rec = {
                        "action": "skip-torn-checkpoint",
                        "step": int(s),
                        "note": "manifest verification failed",
                        "quarantined": self._quarantine_torn(s),
                    }
                    if self.pod_peers:
                        # A step torn HERE is half-committed for the pod:
                        # the peers' copies go with it.
                        rec["peer_quarantined"] = {
                            str(p): quarantine_step_in_dir(p, s) for p in self.pod_peers}
                    self._emit_recovery(rec)
                    continue
                if step is None and self.pod_peers:
                    invalid = [str(p) for p in self.pod_peers if not step_valid_in_dir(p, s)]
                    if invalid:
                        # Valid here, torn or absent on a peer: quarantine it
                        # on EVERY host and fall back to the previous one.
                        self._emit_recovery({
                            "action": "quarantine-half-step",
                            "step": int(s),
                            "invalid_hosts": invalid,
                            "quarantined": {
                                "self": self._quarantine_torn(s),
                                **{str(p): quarantine_step_in_dir(p, s)
                                   for p in self.pod_peers},
                            },
                        })
                        continue
                try:
                    # The state loads to the host: the params are copied into
                    # the trainer's tensors, and the optimizer's load moves
                    # the moments to their params' device and keeps Adam's
                    # step counters on the host, where a fresh run keeps them.
                    payload = torch.load(self._step_dir(s) / STATE_FILE,
                                         map_location="cpu", weights_only=True)
                    levels = (torch.load(self._step_dir(s) / LEVELS_FILE,
                                         map_location=device, weights_only=True)
                              if with_levels else None)
                except Exception as e:  # noqa: BLE001 - any torn step skips
                    if step is not None:
                        raise
                    last_exc = e
                    self._emit_recovery({
                        "action": "skip-torn-checkpoint",
                        "step": s,
                        "note": f"{type(e).__name__}: {e}"[:300],
                        "quarantined": self._quarantine_torn(s),
                    })
                    continue
                restored = load_payload(state, payload, generator)
                return s, ((restored, levels) if with_levels else restored)
            if last_exc is not None:
                raise FileNotFoundError(
                    f"no restorable checkpoint in {self.directory} (every "
                    f"candidate failed; last: {last_exc})"
                )
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")

    def wait(self):
        """Block until an in-flight save has committed with its manifest."""
        with self._op_lock:
            self._drain()

    def close(self):
        self.wait()


def preemption_save(
    checkpoint_dir, state: Any, step: int, *, generator=None, metrics_writer=None
) -> int:
    """The SIGTERM grace-window save (tracing/flight.set_checkpoint_hook
    plugs it in through a closure over the live trainer): save `state` at
    `step` through a THROWAWAY synchronous manager, not the training
    loop's, whose lock the paused main thread may hold. Per-step
    directories and the rename commit make two managers safe side by side;
    a step already committed (the loop's own save) counts as success.
    Returns the step; raises when no save landed (the hook stamps the
    failure on the recovery record)."""
    mgr = CheckpointManager(checkpoint_dir, async_save=False, metrics_writer=metrics_writer)
    try:
        if mgr.verify_step(step):
            return step
        try:
            saved = mgr.save(step, state, generator=generator)
        except Exception:
            if not mgr.verify_step(step):
                raise
            saved = True
        if not saved and not mgr.verify_step(step):
            raise RuntimeError(
                f"the save for step {step} was declined and no committed "
                "step exists (a torn later step may own the step namespace)"
            )
        return step
    finally:
        mgr.close()
