"""Pod-coordinated preemption: the save barrier, gang supervision, and the
cross-host plumbing they share.

Counterpart of `glom_tpu/resilience/coordinator.py`, with its names,
stamped records and errors. The SIGTERM grace-window checkpoint
(tracing/flight.set_checkpoint_hook -> utils/checkpoint.preemption_save)
saves ONE host's state. On a pod, an uncoordinated grace save leaves hosts
committed at different steps, and each host's resume would restore its own
newest step. Three pieces close that gap:

  * THE TWO-PHASE PREEMPTION SAVE BARRIER (PodCoordinator.
    preemption_barrier): on SIGTERM every host proposes its highest
    dispatchable step, the round commits the MIN over the proposals, and
    every host lands exactly that step inside the grace deadline: the host
    AT the min grace-saves its live state, a host PAST it proves the step
    is still retained on disk. A host that misses the deadline, or whose
    save fails, aborts the round loudly (a stamped "barrier" abort, no pod
    commit marker). Every phase of every round is a stamped "barrier"
    event.

  * CROSS-HOST RESTORE RECONCILIATION: utils/checkpoint.CheckpointManager
    (pod_peers=[...]) hands out only steps valid on EVERY host, and
    quarantines a half-committed step on every host (recovery action
    "quarantine-half-step").

  * GANG SUPERVISION (signal_gang_stop / gang_stop_requested /
    gang_barrier, wired through train/supervise.fit_supervised's `gang=`):
    one member's failure signals a gang-wide stop; every member raises
    GangRestart at its next checkpoint-span boundary, the gang meets at
    the restart barrier, and every member resumes from the reconciled
    common step.

TRANSPORTS share three members (`host`, `n_hosts`, `post`, `read_all`):

  * DirectoryTransport: one atomically written JSON file a message,
    `<root>/rounds/<round>/<phase>_<host>.json`, glom_tpu's layout, so a
    glom_tpu host and a port host can share one round.
  * StoreTransport: the same messages as keys of a `torch.distributed`
    Store (a TCPStore, or a PrefixStore over the process group's store):
    the counterpart of glom_tpu's JaxDistributedTransport, for ranks that
    share no file system. The training CLI makes each rank of
    `--distributed --supervise` a gang member over it.

Step-drift contract: "highest dispatchable step" is the step a host's live
state can commit now. Between independent processes (the chaos harness)
drift is bounded by per-step checkpoints and retention: a host past the
committed min that no longer RETAINS that step cannot satisfy the round and
aborts it loudly (raise --checkpoint-keep).
"""

from __future__ import annotations

import hashlib
import json
import time
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from glom_tpu_torch.telemetry import schema

# The persistent per-lifetime "this member finished every step" flag:
# gang-restart barriers excuse done hosts from arrival (a finished member
# never rendezvous again). A relaunched host's own stale flag is purged by
# the transport's construction-time cleanup.
GANG_DONE_ROUND = "gang-done"
# The phase whose messages survive a relaunch's purge: a rootless
# transport's pod commit marker, the counterpart of DirectoryTransport's
# `pod_commit_<step>.json` at the root.
POD_COMMIT_PHASE = "pod-commit"
# The round where each host of a launch posts a fresh nonce (the port's
# own: PodCoordinator.launch_epoch).
LAUNCH_ROUND = "launch"


class BarrierAbort(RuntimeError):
    """A coordination round could not complete: the deadline passed with
    hosts missing, a peer aborted, or this host's own save failed. The
    abort is stamped BEFORE this raises."""

    def __init__(self, message: str, **detail):
        super().__init__(message)
        self.detail = detail


class GangRestart(RuntimeError):
    """Raised inside a gang member's training loop when a peer signalled a
    gang-wide stop: the supervisor treats it like any failure (restart +
    backoff), so the whole gang falls back to the restart barrier and
    resumes from the reconciled common step together."""


def _emit_barrier(writer, rec: dict) -> dict:
    """Stamp one "barrier" event and deliver writer-else-flight."""
    from glom_tpu_torch.tracing.flight import write_or_observe

    stamped = schema.stamp(rec, kind="barrier")
    write_or_observe(writer, stamped)
    return stamped


def _check_hosts(host: int, n_hosts: int) -> None:
    if n_hosts < 1:
        raise ValueError(f"n_hosts {n_hosts} must be >= 1")
    if not 0 <= host < n_hosts:
        raise ValueError(f"host {host} outside 0..{n_hosts - 1}")


class DirectoryTransport:
    """Rendezvous over a shared directory: one message = one atomically
    renamed JSON file `<root>/rounds/<round>/<phase>_<host>.json`.

    Posts are atomic (temp + fsync + rename, utils/checkpoint.
    atomic_write_json), so a reader never sees a torn message; reads are
    lock-free directory scans. The `fault_hook` seam injects
    barrier-message loss (the hook returns True: the message is dropped)
    and deadline overrun (the hook stalls before the write)."""

    def __init__(
        self,
        root,
        host: int,
        n_hosts: int,
        *,
        fault_hook: Optional[Callable[[dict], bool]] = None,
    ):
        _check_hosts(host, n_hosts)
        self.root = Path(root)
        self.host = host
        self.n_hosts = n_hosts
        self.fault_hook = fault_hook
        (self.root / "rounds").mkdir(parents=True, exist_ok=True)
        # Round ids derive from the RESUME step, the one value hosts agree
        # on without communicating, so a relaunch after an aborted round
        # reuses the id. A fresh process must never own stale messages:
        # each host deletes ITS OWN messages at construction (= process
        # start, before any round). The pod_commit markers live at the
        # root and are kept.
        for stale in (self.root / "rounds").glob(f"*/*_{host}.json"):
            try:
                stale.unlink()
            except OSError:
                pass

    def _round_dir(self, round_id: str) -> Path:
        return self.root / "rounds" / round_id

    def post(self, round_id: str, phase: str, payload: dict) -> bool:
        """Post this host's message for (round, phase); False when the
        fault hook dropped it (the poster, like a sender over a lossy link,
        is not told)."""
        if self.fault_hook is not None and self.fault_hook(
            {"op": "post", "round": round_id, "phase": phase, "host": self.host}
        ):
            return False
        from glom_tpu_torch.utils.checkpoint import atomic_write_json

        rdir = self._round_dir(round_id)
        rdir.mkdir(parents=True, exist_ok=True)
        atomic_write_json(rdir / f"{phase}_{self.host}.json", {"host": self.host, **payload})
        return True

    def read_all(self, round_id: str, phase: str) -> Dict[int, dict]:
        """{host: payload} for every message posted so far; a message
        mid-rename is simply not there yet."""
        out: Dict[int, dict] = {}
        rdir = self._round_dir(round_id)
        if not rdir.is_dir():
            return out
        for p in rdir.glob(f"{phase}_*.json"):
            try:
                host = int(p.stem.rsplit("_", 1)[1])
                with open(p) as fh:
                    out[host] = json.load(fh)
            except (ValueError, OSError, json.JSONDecodeError):
                continue
        return out


class StoreTransport:
    """The same three members over a `torch.distributed` Store: one message
    = one key `glom/rounds/<round>/<phase>_<host>` holding its JSON (the
    `glom/` namespace is JaxDistributedTransport's).

    A Store's `get` blocks until its timeout for an absent key, so
    `read_all` asks `check` first. A TCPStore cannot list its keys, so each
    host appends the keys it posts to its own index key
    (`glom/index/<host>`); construction (= process start, before any
    round) deletes every key in this host's index, as DirectoryTransport
    deletes its files, and keeps the pod commit markers. Launches that
    share one store are kept apart by the caller's `dist.PrefixStore`: the
    training CLI puts torch.distributed.run's restart count in it, since a
    relaunch under the same agent reuses the agent's store."""

    def __init__(
        self,
        store,
        host: int,
        n_hosts: int,
        *,
        fault_hook: Optional[Callable[[dict], bool]] = None,
    ):
        _check_hosts(host, n_hosts)
        self.store = store
        self.host = host
        self.n_hosts = n_hosts
        self.fault_hook = fault_hook
        index = self._index_key(host)
        if store.check([index]):
            for key in store.get(index).decode().split("\n"):
                if key:
                    store.delete_key(key)
            store.delete_key(index)

    def _index_key(self, host: int) -> str:
        return f"glom/index/{host}"

    def _key(self, round_id: str, phase: str, host: int) -> str:
        return f"glom/rounds/{round_id}/{phase}_{host}"

    def post(self, round_id: str, phase: str, payload: dict) -> bool:
        """Post this host's message for (round, phase); False when the
        fault hook dropped it."""
        if self.fault_hook is not None and self.fault_hook(
            {"op": "post", "round": round_id, "phase": phase, "host": self.host}
        ):
            return False
        key = self._key(round_id, phase, self.host)
        if phase != POD_COMMIT_PHASE:
            self.store.append(self._index_key(self.host), key + "\n")
        self.store.set(key, json.dumps({"host": self.host, **payload}))
        return True

    def read_all(self, round_id: str, phase: str) -> Dict[int, dict]:
        """{host: payload} for every message posted so far."""
        out: Dict[int, dict] = {}
        for h in range(self.n_hosts):
            key = self._key(round_id, phase, h)
            if not self.store.check([key]):
                continue
            try:
                out[h] = json.loads(self.store.get(key))
            except (RuntimeError, TypeError, ValueError):
                continue
        return out


class PodCoordinator:
    """Host-side coordination over a transport: the preemption save barrier
    plus the gang-stop and rendezvous primitives fit_supervised's gang mode
    rides. Every decision is a stamped event ("barrier" for round phases,
    "recovery" for gang stops), delivered writer-else-flight so a dying
    process still leaves the round's story in its flight dump. `clock` and
    `sleep` drive every deadline (tests pass their own)."""

    def __init__(
        self,
        transport,
        *,
        writer=None,
        poll_s: float = 0.05,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if poll_s <= 0:
            raise ValueError(f"poll_s {poll_s} must be > 0")
        self.transport = transport
        self.host = transport.host
        self.n_hosts = transport.n_hosts
        self.writer = writer
        self.poll_s = poll_s
        self._clock = clock
        self._sleep = sleep

    # -- stamping ----------------------------------------------------------

    def _emit(self, phase: str, round_id: str, **detail) -> dict:
        return _emit_barrier(
            self.writer,
            {
                "phase": phase,
                "round": round_id,
                "host": self.host,
                "n_hosts": self.n_hosts,
                "wall_time_s": round(time.time(), 3),
                **detail,
            },
        )

    # -- barrier plumbing --------------------------------------------------

    def _abort(self, round_id: str, reason: str, **detail) -> BarrierAbort:
        """Post + stamp the abort, return the exception for the caller to
        raise. The post is best effort (the transport may be what failed);
        the stamp always lands locally."""
        try:
            self.transport.post(round_id, "abort", {"reason": reason, **detail})
        except Exception:  # noqa: BLE001 - the stamp still records it
            pass
        self._emit("abort", round_id, reason=reason, **detail)
        return BarrierAbort(
            f"barrier round {round_id} aborted on host {self.host}: {reason}",
            round=round_id, reason=reason, **detail,
        )

    def _wait_all(
        self,
        round_id: str,
        phase: str,
        deadline: float,
        *,
        honor_done: bool = False,
    ) -> Dict[int, dict]:
        """Block until all n_hosts posted (round, phase); raise BarrierAbort
        on a peer abort or on the deadline, stamping which hosts were
        missing. With honor_done (the gang-restart barriers), a host that
        posted the persistent gang-done flag counts as arrived."""
        while True:
            # Aborts are read FIRST: a host that limped in late must not
            # declare a round complete that a peer already aborted.
            aborts = self.transport.read_all(round_id, "abort")
            peer_aborts = {h: a for h, a in aborts.items() if h != self.host}
            msgs = self.transport.read_all(round_id, phase)
            required = set(range(self.n_hosts))
            if honor_done:
                required -= set(self.transport.read_all(GANG_DONE_ROUND, "done"))
                required.add(self.host)  # our own arrival is never excused
            if not peer_aborts and required <= set(msgs):
                return msgs
            if peer_aborts:
                h, a = sorted(peer_aborts.items())[0]
                raise self._abort(
                    round_id,
                    f"peer host {h} aborted: {a.get('reason', '?')}",
                    peer=h, waiting_for=phase,
                )
            if self._clock() >= deadline:
                missing = sorted(required - set(msgs))
                raise self._abort(
                    round_id,
                    f"deadline passed waiting for {phase}",
                    waiting_for=phase, missing=missing,
                )
            self._sleep(self.poll_s)

    # -- the two-phase preemption save barrier -----------------------------

    def preemption_barrier(
        self,
        round_id: str,
        proposal_step: int,
        save_fn: Callable[[int], Any],
        *,
        deadline_s: float = 30.0,
    ) -> int:
        """Run one coordinated grace-save round; returns the committed
        common step. Phase 1: propose `proposal_step` and wait for every
        host's proposal; the round commits the MIN. Phase 2: `save_fn
        (commit)` must land exactly that step on this host, then every host
        acks and, on full acknowledgment, host 0 writes the pod commit
        marker `pod_commit_<step>.json` (a POD_COMMIT_PHASE message on a
        rootless transport). Any miss raises BarrierAbort with the abort
        already stamped and NO commit marker written."""
        deadline = self._clock() + deadline_s
        proposal_step = int(proposal_step)
        self.transport.post(round_id, "propose", {"step": proposal_step})
        self._emit("propose", round_id, step=proposal_step, deadline_s=deadline_s)
        proposals = self._wait_all(round_id, "propose", deadline)
        commit = min(int(p["step"]) for p in proposals.values())
        self._emit(
            "commit", round_id, step=commit,
            proposals={str(h): int(p["step"]) for h, p in sorted(proposals.items())},
        )
        try:
            note = save_fn(commit)
        except BaseException as e:  # noqa: BLE001 - aborts the round loudly
            raise self._abort(
                round_id,
                f"save of committed step {commit} failed: {type(e).__name__}: {e}"[:300],
                step=commit,
            ) from e
        self.transport.post(round_id, "saved", {"step": commit})
        self._emit("saved", round_id, step=commit, note=str(note or "saved"))
        self._wait_all(round_id, "saved", deadline)
        if self.host == 0:
            marker = {
                "step": commit,
                "round": round_id,
                "n_hosts": self.n_hosts,
                "proposals": {str(h): int(p["step"]) for h, p in sorted(proposals.items())},
                "wall_time_s": round(time.time(), 3),
            }
            root = getattr(self.transport, "root", None)
            if root is not None:
                from glom_tpu_torch.utils.checkpoint import atomic_write_json

                atomic_write_json(Path(root) / f"pod_commit_{commit}.json", marker)
            else:
                # Rootless transports carry the marker as a round message;
                # peers read it with read_all(round, POD_COMMIT_PHASE).
                self.transport.post(round_id, POD_COMMIT_PHASE, marker)
        self._emit("complete", round_id, step=commit)
        return commit

    # -- gang supervision --------------------------------------------------

    def _gang_round(self, epoch: int) -> str:
        return f"gang-e{int(epoch)}"

    def signal_gang_stop(self, epoch: int, reason: str) -> None:
        """One host's failure becomes the gang's restart: post the stop flag
        for this epoch (peers poll it between checkpoint spans) and stamp
        the decision as a recovery event."""
        from glom_tpu_torch.resilience.faults import emit_recovery

        self.transport.post(self._gang_round(epoch), "stop", {"reason": str(reason)[:300]})
        emit_recovery(
            self.writer,
            {
                "action": "gang-stop",
                "epoch": int(epoch),
                "host": self.host,
                "reason": str(reason)[:300],
            },
        )

    def gang_stop_requested(self, epoch: int) -> bool:
        return bool(self.transport.read_all(self._gang_round(epoch), "stop"))

    def signal_gang_done(self, steps: int) -> None:
        """This member finished every step and is leaving the gang: post the
        persistent done flag so restart barriers stop waiting for a host
        that will never rendezvous again."""
        self.transport.post(GANG_DONE_ROUND, "done", {"steps": int(steps)})
        self._emit("done", GANG_DONE_ROUND, steps=int(steps))

    def launch_epoch(self, *, deadline_s: float = 30.0) -> int:
        """The port's own rendezvous: meet every host of THIS launch, and
        return an epoch that no earlier launch can have used, for
        gang_barrier rounds that must not count an earlier lifetime's
        arrivals (glom_tpu keys its rounds on values an earlier lifetime
        may share).

        Each host posts a fresh random nonce (LAUNCH_ROUND, "hello"); the
        epoch hashes every host's nonce, and the round "launch-e<epoch>"
        completes when every host arrived in it, i.e. when every host has
        read every other host's nonce of this launch. A peer's nonce read
        before its relaunch purged its old messages names a round that
        peer never joins: the host rereads the nonces each poll and moves
        to the round they name. A host that is not relaunched never posts,
        and the deadline aborts the round loudly."""
        nonce = uuid.uuid4().hex
        self.transport.post(LAUNCH_ROUND, "hello", {"nonce": nonce})
        deadline = self._clock() + deadline_s
        round_id = None
        while True:
            hellos = self.transport.read_all(LAUNCH_ROUND, "hello")
            if (len(hellos) == self.n_hosts
                    and hellos.get(self.host, {}).get("nonce") == nonce):
                key = " ".join(str(hellos[h].get("nonce")) for h in range(self.n_hosts))
                epoch = int(hashlib.sha256(key.encode()).hexdigest()[:12], 16)
                if round_id != f"launch-e{epoch}":
                    round_id = f"launch-e{epoch}"
                    self.transport.post(round_id, "arrive", {})
                    self._emit("arrive", round_id, epoch=epoch)
                arrived = self.transport.read_all(round_id, "arrive")
                if len(arrived) == self.n_hosts:
                    self._emit("complete", round_id, epoch=epoch)
                    return epoch
            if self._clock() >= deadline:
                seen = self.transport.read_all(round_id, "arrive") if round_id else hellos
                raise self._abort(
                    round_id or LAUNCH_ROUND,
                    "deadline passed waiting for this launch's hosts",
                    waiting_for="arrive" if round_id else "hello",
                    missing=sorted(set(range(self.n_hosts)) - set(seen)),
                )
            self._sleep(self.poll_s)

    def gang_barrier(self, name: str, epoch: int, *, deadline_s: float = 30.0) -> None:
        """Rendezvous: every gang member posts arrival for (name, epoch) and
        blocks until all arrived. Messages persist, so a late member sails
        through an already-full barrier, and a member that posted gang-done
        is excused. A member that never arrives inside the deadline aborts
        the round loudly (the supervisor's restart budget then decides)."""
        round_id = f"{name}-e{int(epoch)}"
        deadline = self._clock() + deadline_s
        self.transport.post(round_id, "arrive", {})
        self._emit("arrive", round_id, epoch=int(epoch))
        self._wait_all(round_id, "arrive", deadline, honor_done=True)
        self._emit("complete", round_id, epoch=int(epoch))


# -- pod helpers -------------------------------------------------------------


def peer_host_dirs(checkpoint_dir, host: int, n_hosts: int) -> List[str]:
    """Sibling host checkpoint dirs under the pod layout convention
    `<root>/host_<k>`: the one naming contract the CLI, the chaos harness
    and restore reconciliation share. Loud on a mismatch."""
    checkpoint_dir = Path(checkpoint_dir)
    if checkpoint_dir.name != f"host_{host}":
        raise ValueError(
            f"pod checkpoint dir {checkpoint_dir} must be named host_{host} (the "
            "<root>/host_<k> pod layout)"
        )
    return [str(checkpoint_dir.parent / f"host_{k}") for k in range(n_hosts) if k != host]


def read_pod_commit(coord_root) -> Optional[dict]:
    """Newest pod commit marker under the coordination root (None when no
    round ever completed)."""
    markers = []
    for p in Path(coord_root).glob("pod_commit_*.json"):
        try:
            with open(p) as fh:
                markers.append(json.load(fh))
        except (OSError, json.JSONDecodeError):
            continue
    if not markers:
        return None
    return max(markers, key=lambda m: m.get("step", -1))


def pod_preemption_save(
    coordinator: PodCoordinator,
    checkpoint_dir,
    state: Any,
    step: int,
    *,
    deadline_s: float = 30.0,
    round_id: str = "preempt-g0",
    metrics_writer=None,
    generator=None,
) -> dict:
    """The pod-mode SIGTERM checkpoint hook body (train/cli.py and
    fit_supervised plug it into tracing/flight.set_checkpoint_hook instead
    of the single-host preemption_save): propose this host's current step,
    let the barrier commit the gang min, and land exactly that step, by
    grace-saving the live state (and the noise `generator`) when this host
    IS the min, or by verifying the committed step is still retained when
    this host ran past it. Returns the dict the flight recorder merges into
    the stamped "preemption-checkpoint" recovery record."""
    step = int(step)

    def save_fn(commit: int) -> str:
        if commit >= step:
            # This host IS the min (the min never exceeds our proposal).
            from glom_tpu_torch.utils.checkpoint import preemption_save

            preemption_save(checkpoint_dir, state, commit, generator=generator,
                            metrics_writer=metrics_writer)
            return "grace-saved"
        # Past the committed step: satisfiable only if that step is on disk
        # and verifies. The loop's asynchronous save of it may still be in
        # flight (its writer thread is not paused by the signal handler), so
        # poll for a bounded slice of the grace budget.
        from glom_tpu_torch.utils.checkpoint import step_valid_in_dir

        wait_until = time.monotonic() + max(1.0, deadline_s * 0.25)
        while not step_valid_in_dir(checkpoint_dir, commit):
            if time.monotonic() >= wait_until:
                raise RuntimeError(
                    f"host {coordinator.host} is at step {step}, past the committed step "
                    f"{commit}, and does not retain it — the pod round cannot complete "
                    "(raise --checkpoint-keep or lower --checkpoint-every)"
                )
            time.sleep(0.1)
        return "already-committed"

    commit = coordinator.preemption_barrier(round_id, step, save_fn, deadline_s=deadline_s)
    return {
        "step": commit,
        "pod": True,
        "round": round_id,
        "n_hosts": coordinator.n_hosts,
        "proposed_step": step,
    }
