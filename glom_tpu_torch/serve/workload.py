"""Workload capture and deterministic replay.

The port's copy of `glom_tpu/serve/workload.py`. One artifact: a
schema-v9 "workload" JSONL stream, one record per offered request, with
its arrival time `t` (seconds, run-relative), shape `signature`
("bucket:CxHxW" | "ragged:<N>p" | "delta:CxHxW"), `session`, SLO class and
`outcome` ("served" | "shed" | "failed" | "unresolved" | "offered").

  * `WorkloadRecorder` rides the batcher's event tap and stitches the
    per-request admission ("admit"), shed and terminal ("settle" /
    "resolve") events into the artifact.
  * The scenario generators (`gen_diurnal`, `gen_flash_crowd`,
    `gen_rolling_outage`, through `generate`) synthesize the same artifact
    from a seed, pure stdlib, outcome "offered": the same arguments give
    the same records as glom_tpu's.
  * `replay()` re-offers any artifact with its inter-arrival pacing and
    session structure (`python -m glom_tpu_torch.serve --replay`); clock
    and sleep are injectable.

The artifact lints like any other stream (`python -m
glom_tpu_torch.telemetry FILE`): a "note" header names the source, the
"workload" body carries the requests, a "summary" trailer the counts.
"""

from __future__ import annotations

import json
import math
import random
import threading
import time
import zlib
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from glom_tpu_torch.telemetry import schema

OUTCOMES = ("served", "shed", "failed", "unresolved", "offered")


# -- capture ---------------------------------------------------------------


class WorkloadRecorder:
    """Stitch the batcher's per-request evidence into a workload artifact.

    attach() arms the batcher's admission events
    (enable_admission_events) and subscribes this recorder as an event
    tap; from then on every submit lands one entry ("unresolved" until
    its terminal arrives), every shed/settle flips the entry's outcome.
    Thread-safe: taps fire from submit AND worker threads concurrently,
    and records() snapshots under the same lock, so a mid-traffic
    snapshot still satisfies conservation over what it saw."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_rid: dict = {}   # request_id -> mutable entry
        self._order: list = []    # request_ids in admission order
        self._t_first: Optional[float] = None

    def attach(self, batcher) -> "WorkloadRecorder":
        batcher.enable_admission_events()
        batcher.add_event_tap(self.observe)
        return self

    def observe(self, rec: dict) -> None:
        """The event tap: consumes the stamped batcher stream; ignores
        everything that is not per-request evidence."""
        if rec.get("kind") != "serve":
            return
        event = rec.get("event")
        rid = rec.get("request_id")
        if rid is None:
            return
        with self._lock:
            if event == "admit":
                if self._t_first is None:
                    self._t_first = float(rec["t"])
                if rid not in self._by_rid:
                    self._order.append(rid)
                self._by_rid[rid] = {
                    "t": float(rec["t"]),
                    "signature": rec.get("signature"),
                    "shape": rec.get("shape"),
                    "session": rec.get("session"),
                    "slo_class": rec.get("slo_class"),
                    "outcome": "unresolved",
                }
            elif event == "shed":
                entry = self._by_rid.get(rid)
                if entry is not None:
                    entry["outcome"] = "shed"
                    entry["reason"] = rec.get("reason")
            elif event == "settle":
                entry = self._by_rid.get(rid)
                if entry is not None and entry["outcome"] == "unresolved":
                    entry["outcome"] = rec.get("outcome", "served")
            elif event == "resolve":
                # Traced runs mint a resolve leaf too — same terminal,
                # idempotent with the settle event either order.
                entry = self._by_rid.get(rid)
                if entry is not None and entry["outcome"] == "unresolved":
                    entry["outcome"] = "served"

    @property
    def n_offered(self) -> int:
        with self._lock:
            return len(self._order)

    def records(self) -> List[dict]:
        """The artifact body: stamped "workload" records in admission
        order, arrival times normalized run-relative (t=0 at the first
        admission) so a replay needs no epoch arithmetic."""
        with self._lock:
            t0 = self._t_first or 0.0
            out = []
            for i, rid in enumerate(self._order):
                e = self._by_rid[rid]
                rec = {
                    "t": round(e["t"] - t0, 6),
                    "signature": e["signature"],
                    "outcome": e["outcome"],
                    "request_id": rid,
                    "seed": i,
                    "session": e["session"],
                    "shape": e["shape"],
                    # v11: the class key is PRESENT on every workload
                    # record (null = classless) so a replay re-offers
                    # each request under ITS tenant.
                    "slo_class": e.get("slo_class"),
                }
                if e.get("reason") is not None:
                    rec["reason"] = e["reason"]
                out.append(schema.stamp(rec, kind="workload"))
            return out

    def summary(self) -> dict:
        """Outcome counts over what was captured — the artifact's
        conservation trailer (offered == served + shed + failed +
        unresolved, exactly)."""
        with self._lock:
            counts = {k: 0 for k in OUTCOMES}
            for e in self._by_rid.values():
                counts[e["outcome"]] = counts.get(e["outcome"], 0) + 1
            counts["n_offered"] = len(self._order)
            return counts

    def write(self, path: str, *, source: str = "recorder") -> int:
        """Write the full artifact (note header + body + summary
        trailer); returns how many workload records landed."""
        recs = self.records()
        write_workload(path, recs, source=source, summary=self.summary())
        return len(recs)


def write_workload(
    path: str,
    records: Sequence[dict],
    *,
    source: str,
    summary: Optional[dict] = None,
) -> None:
    """One lintable artifact: "note" header (provenance), "workload"
    body, "summary" trailer (outcome conservation)."""
    with open(path, "w") as fh:
        header = schema.stamp(
            {"note": f"workload artifact: {source}", "n_requests": len(records)},
            kind="note",
        )
        fh.write(json.dumps(header) + "\n")
        for rec in records:
            fh.write(json.dumps(schema.stamp(rec, kind="workload")) + "\n")
        trailer = dict(summary) if summary is not None else _count(records)
        fh.write(
            json.dumps(schema.stamp(trailer, kind="summary")) + "\n"
        )


def _count(records: Sequence[dict]) -> dict:
    counts = {k: 0 for k in OUTCOMES}
    for r in records:
        counts[r.get("outcome", "offered")] = (
            counts.get(r.get("outcome", "offered"), 0) + 1
        )
    counts["n_offered"] = len(records)
    return counts


# -- replay ----------------------------------------------------------------


def load_workload(path: str) -> List[dict]:
    """The replayable body of an artifact: its "workload" records in
    arrival order. Loud on an artifact with none — replaying an empty
    workload silently "passing" is the failure mode this observatory
    exists to kill."""
    with open(path) as fh:
        recs = [
            r for _, r in schema.iter_json_lines(fh)
            if r.get("kind") == "workload"
        ]
    for r in recs:
        errs = schema.validate_record(r)
        if errs:
            raise ValueError(f"workload record invalid: {errs[0]}")
    if not recs:
        raise ValueError(f"{path}: no workload records to replay")
    recs.sort(key=lambda r: float(r["t"]))
    return recs


def _shape_of(rec: dict) -> Tuple[int, ...]:
    """The input shape to synthesize: the explicit `shape` field when
    recorded, else parsed from a bucket/delta signature. A ragged record
    without `shape` is unreplayable (the page count alone does not pick
    H x W) — loud, not guessed."""
    shape = rec.get("shape")
    if shape:
        return tuple(int(d) for d in shape)
    sig = str(rec.get("signature") or "")
    mode, _, dims = sig.partition(":")
    if mode in ("bucket", "delta") and dims:
        return tuple(int(d) for d in dims.split("x"))
    raise ValueError(
        f"workload record t={rec.get('t')} signature={sig!r} carries no "
        "replayable shape (ragged signatures need the recorded `shape`)"
    )


def synth_input(rec: dict, index: int = 0) -> np.ndarray:
    """Deterministic input synthesis for one workload record: stateless
    requests are pure seeded gaussians; a session's frames are small
    perturbations of ITS base image (the temporal-coherence assumption
    the column cache exploits) — the same construction as the serve
    CLI's frame_img, so a replayed stream exercises the warm path the
    original did."""
    shape = _shape_of(rec)
    seed = int(rec.get("seed", index))

    def rng(s: int) -> np.ndarray:
        return np.random.default_rng(s).normal(size=shape).astype(np.float32)

    session = rec.get("session")
    if session is None:
        return rng(seed)
    base = rng(zlib.crc32(str(session).encode()) & 0x7FFFFFFF)
    return base + 0.05 * rng((1 << 20) + seed)


def replay(
    records: Sequence[dict],
    submit: Callable[[dict, int], object],
    *,
    time_scale: float = 1.0,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
) -> dict:
    """Re-offer a workload with faithful inter-arrival pacing.

    `submit(rec, index)` offers one request (bench/CLI wrap
    batcher.submit(synth_input(rec, i), session_id=rec["session"]));
    a raise from submit counts as shed-at-admission — the replay
    drives ON through it, because the original traffic did not stop
    for a shed either. time_scale stretches (>1) or compresses (<1)
    the recorded gaps; clock/sleep are injectable so tests replay on a
    fake clock with zero wall time.

    Returns pacing evidence: n_offered / n_submitted / n_shed, plus
    the max and mean scheduling lag (how late each offer fired vs its
    recorded arrival, in ms) — the "pacing within tolerance" number
    the round-trip test asserts on."""
    if time_scale <= 0:
        raise ValueError(f"time_scale {time_scale} must be > 0")
    records = list(records)
    t_wall0 = clock()
    t_rec0 = float(records[0]["t"]) if records else 0.0
    n_offered = n_submitted = n_shed = 0
    lag_sum = lag_max = 0.0
    for i, rec in enumerate(records):
        target = (float(rec["t"]) - t_rec0) * time_scale
        now = clock() - t_wall0
        if target > now:
            sleep(target - now)
        lag = max(0.0, (clock() - t_wall0) - target)
        lag_sum += lag
        lag_max = max(lag_max, lag)
        n_offered += 1
        try:
            submit(rec, i)
            n_submitted += 1
        except Exception:  # noqa: BLE001 — a shed is data, not a stop
            n_shed += 1
    return {
        "n_offered": n_offered,
        "n_submitted": n_submitted,
        "n_shed": n_shed,
        "pacing_lag_mean_ms": round(
            1e3 * lag_sum / n_offered, 3
        ) if n_offered else 0.0,
        "pacing_lag_max_ms": round(1e3 * lag_max, 3),
        "duration_s": round(clock() - t_wall0, 6),
    }


# -- scenario generators (pure stdlib) -------------------------------------


def parse_class_mix(spec) -> Optional[dict]:
    """'premium=0.2,batch=0.5' -> {"premium": 0.2, "batch": 0.5}: the
    --class-mix knob. Fractions are per-class probabilities; they must
    sum to <= 1 and the remainder is UNCLASSED traffic (slo_class null
    — the server's default class catches it). None/empty spec = a
    classless scenario, byte-identical to the pre-v11 generators."""
    if spec is None or (isinstance(spec, str) and not spec.strip()):
        return None
    if isinstance(spec, dict):
        mix = {str(k): float(v) for k, v in spec.items()}
    else:
        mix = {}
        for part in str(spec).split(","):
            name, eq, val = part.partition("=")
            name = name.strip()
            if not name or not eq:
                raise ValueError(
                    f"class mix entry {part!r}: expected NAME=FRACTION"
                )
            try:
                mix[name] = mix.get(name, 0.0) + float(val)
            except ValueError:
                raise ValueError(
                    f"class mix entry {part!r}: fraction {val!r} is not "
                    "a number"
                ) from None
    for name, f in mix.items():
        if not 0.0 <= f <= 1.0:
            raise ValueError(
                f"class mix {name}={f}: fraction must be in [0, 1]"
            )
    if sum(mix.values()) > 1.0 + 1e-9:
        raise ValueError(
            f"class mix fractions sum to {sum(mix.values()):.4f} > 1"
        )
    return mix


def _deal_class(class_mix: Optional[dict], rng: random.Random):
    """One deterministic class draw (sorted names, cumulative walk) —
    None both for classless scenarios and for the unclassed remainder."""
    if not class_mix:
        return None
    u = rng.random()
    acc = 0.0
    for name in sorted(class_mix):
        acc += class_mix[name]
        if u < acc:
            return name
    return None


def _signature_for(
    shape: Tuple[int, ...],
    session: Optional[str],
    *,
    mode: str,
    patch_size: Optional[int] = None,
    page_tokens: Optional[int] = None,
) -> str:
    dims = "x".join(str(int(d)) for d in shape)
    if mode == "ragged":
        if not (patch_size and page_tokens):
            raise ValueError(
                "ragged scenarios need patch_size= and page_tokens= to "
                "price the page signature"
            )
        c, h, w = shape
        tokens = (h // patch_size) * (w // patch_size)
        pages = max(1, math.ceil(tokens / page_tokens))
        return f"ragged:{pages}p"
    if mode == "delta" and session is not None:
        return f"delta:{dims}"
    return f"bucket:{dims}"


def _arrivals(
    rate_fn: Callable[[float], float],
    duration_s: float,
    rate_max: float,
    rng: random.Random,
) -> List[float]:
    """Nonhomogeneous Poisson arrivals by Lewis thinning: candidates at
    the peak rate, kept with probability rate(t)/rate_max — exact for
    any bounded intensity curve, and deterministic per seed."""
    ts: List[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate_max)
        if t >= duration_s:
            return ts
        if rng.random() * rate_max < rate_fn(t):
            ts.append(t)


def _materialize(
    ts: Iterable[float],
    *,
    streams: int,
    shapes: Sequence[Tuple[int, ...]],
    mode: str,
    rng: random.Random,
    patch_size: Optional[int],
    page_tokens: Optional[int],
    keep: Callable[[float, Optional[str]], bool] = lambda t, s: True,
    class_mix: Optional[dict] = None,
) -> List[dict]:
    """Arrival times -> stamped "workload" records: sessions dealt
    round-robin (the serve CLI's stream convention), shapes drawn per
    request (mixed-resolution ragged traffic needs more than one),
    SLO classes dealt per the --class-mix fractions (parse_class_mix;
    the unclassed remainder stays null), and a keep() predicate for
    scenarios that silence part of the traffic."""
    out: List[dict] = []
    i = 0
    for t in ts:
        session = f"s{i % streams}" if streams > 0 else None
        shape = shapes[rng.randrange(len(shapes))] if len(shapes) > 1 else (
            shapes[0]
        )
        slo_class = _deal_class(class_mix, rng)
        i += 1
        if not keep(t, session):
            continue
        out.append(
            schema.stamp(
                {
                    "t": round(t, 6),
                    "signature": _signature_for(
                        shape, session, mode=mode,
                        patch_size=patch_size, page_tokens=page_tokens,
                    ),
                    "outcome": "offered",
                    "seed": len(out),
                    "session": session,
                    "shape": list(shape),
                    "slo_class": slo_class,
                },
                kind="workload",
            )
        )
    return out


def gen_diurnal(
    duration_s: float = 10.0,
    *,
    base_rps: float = 5.0,
    peak_rps: float = 30.0,
    period_s: Optional[float] = None,
    seed: int = 0,
    streams: int = 4,
    shapes: Sequence[Tuple[int, ...]] = ((1, 28, 28),),
    mode: str = "bucket",
    patch_size: Optional[int] = None,
    page_tokens: Optional[int] = None,
    class_mix: Optional[dict] = None,
) -> List[dict]:
    """The daily curve, compressed: arrival rate swings sinusoidally
    base -> peak -> base over period_s (default: the whole duration is
    one period). The forecast's seasonality component exists for exactly
    this shape."""
    if peak_rps < base_rps:
        raise ValueError(f"peak_rps {peak_rps} < base_rps {base_rps}")
    period = period_s if period_s is not None else duration_s
    rng = random.Random(seed)

    def rate(t: float) -> float:
        phase = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / period))
        return base_rps + (peak_rps - base_rps) * phase

    ts = _arrivals(rate, duration_s, peak_rps, rng)
    return _materialize(
        ts, streams=streams, shapes=shapes, mode=mode, rng=rng,
        patch_size=patch_size, page_tokens=page_tokens,
        class_mix=parse_class_mix(class_mix),
    )


def gen_flash_crowd(
    duration_s: float = 10.0,
    *,
    base_rps: float = 5.0,
    crowd_rps: float = 50.0,
    t_start: Optional[float] = None,
    crowd_s: Optional[float] = None,
    seed: int = 0,
    streams: int = 4,
    shapes: Sequence[Tuple[int, ...]] = ((1, 28, 28),),
    mode: str = "bucket",
    patch_size: Optional[int] = None,
    page_tokens: Optional[int] = None,
    class_mix: Optional[dict] = None,
) -> List[dict]:
    """The step the autoscaler dreads: steady base load, then a crowd
    arrives all at once for crowd_s seconds (default: the middle third
    of the run) — the no-warning shape where spawn lead time IS the
    outage window."""
    if crowd_rps < base_rps:
        raise ValueError(f"crowd_rps {crowd_rps} < base_rps {base_rps}")
    start = t_start if t_start is not None else duration_s / 3.0
    width = crowd_s if crowd_s is not None else duration_s / 3.0
    rng = random.Random(seed)

    def rate(t: float) -> float:
        return crowd_rps if start <= t < start + width else base_rps

    ts = _arrivals(rate, duration_s, crowd_rps, rng)
    return _materialize(
        ts, streams=streams, shapes=shapes, mode=mode, rng=rng,
        patch_size=patch_size, page_tokens=page_tokens,
        class_mix=parse_class_mix(class_mix),
    )


def gen_rolling_outage(
    duration_s: float = 10.0,
    *,
    rps: float = 20.0,
    outage_start: Optional[float] = None,
    outage_s: Optional[float] = None,
    seed: int = 0,
    streams: int = 4,
    shapes: Sequence[Tuple[int, ...]] = ((1, 28, 28),),
    mode: str = "bucket",
    patch_size: Optional[int] = None,
    page_tokens: Optional[int] = None,
    class_mix: Optional[dict] = None,
) -> List[dict]:
    """A partial outage ROLLS across the stream population: each session
    group goes dark for its own slice of the outage window (group k
    silent during the k-th sub-window), then returns — the
    partially-correlated dip that fools a naive trend fit and the shape
    scale-in must NOT chase."""
    if streams < 1:
        raise ValueError("gen_rolling_outage needs streams >= 1")
    start = outage_start if outage_start is not None else duration_s / 4.0
    width = outage_s if outage_s is not None else duration_s / 2.0
    slice_s = width / streams
    rng = random.Random(seed)

    def keep(t: float, session: Optional[str]) -> bool:
        if session is None or not (start <= t < start + width):
            return True
        k = int(session[1:]) % streams
        return not (
            start + k * slice_s <= t < start + (k + 1) * slice_s
        )

    ts = _arrivals(lambda t: rps, duration_s, rps, rng)
    return _materialize(
        ts, streams=streams, shapes=shapes, mode=mode, rng=rng,
        patch_size=patch_size, page_tokens=page_tokens, keep=keep,
        class_mix=parse_class_mix(class_mix),
    )


SCENARIOS = {
    "diurnal": gen_diurnal,
    "flash-crowd": gen_flash_crowd,
    "rolling-outage": gen_rolling_outage,
}


def generate(name: str, duration_s: float = 10.0, *, seed: int = 0, **kw):
    """Scenario library entry point: `generate("flash-crowd", 8.0,
    seed=3)` -> stamped workload records, identical for identical
    arguments (the whole point)."""
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}"
        ) from None
    return fn(duration_s, seed=seed, **kw)
