"""Multi-tenant QoS: named SLO classes and the weighted-fair admission lane.

The port's copy of `glom_tpu/serve/qos.py`. A request carries an SLO class
declared in `ServeConfig.slo_classes`, and the class rides every record it
leaves: admission, degradation, shedding. Three pieces live here:

  * `SLOClass` / `QosSpec`: the parsed, validated class table (per-class
    weight, optional p99 and shed-rate targets, per-class queue depth, the
    shed order and the starvation floor). `resolve_slo_classes` builds it
    from a ServeConfig; ServeConfig.__post_init__ calls it too, so a
    typo'd class table fails at construction.
  * `ClassQueues`: the deficit-weighted-fair admission scheduler, a
    drop-in for the batcher's shared `queue.Queue` (get / get_nowait /
    put_nowait / qsize / empty / maxsize) over per-class bounded lanes.
    Picks are strict-priority (highest weight first) except that every
    lower backlogged class banks `starvation_floor` credit a pick and
    preempts once it is owed a whole pick.
  * per-class ladder gates (resilience/ladder.class_rungs): the first
    class in the shed order degrades and sheds a rung early, the last
    holds its full route one rung longer.

Pure stdlib. A config without `slo_classes` never touches this module:
the batcher keeps its plain shared `queue.Queue`.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = [
    "SLOClass",
    "QosSpec",
    "ClassQueues",
    "parse_slo_class",
    "resolve_slo_classes",
    "class_slo_rules",
]

# Spec keys a class declaration may carry ("name:key=value,key=value").
_CLASS_KEYS = ("weight", "p99_ms", "shed_rate", "queue_depth")

# Credit never banks more than this many whole picks: a class that idled
# for an hour must not monopolize the lane when its backlog returns —
# the floor bounds the RATE, not an unbounded debt.
_CREDIT_CAP = 2.0


@dataclass(frozen=True)
class SLOClass:
    """One named SLO class: scheduling weight + its own targets."""

    name: str
    weight: float = 1.0
    # Per-class SLO targets: armed as class-scoped monitor rules
    # ("p99_ms[premium]=X" — telemetry/aggregate.parse_slo) when set.
    p99_ms: Optional[float] = None
    shed_rate: Optional[float] = None
    # Per-class admission lane depth; None = the shared queue_depth.
    queue_depth: Optional[int] = None


def parse_slo_class(spec: str) -> SLOClass:
    """'premium:weight=8,p99_ms=150' -> SLOClass. Loud on malformed
    specs (a typo'd class table that silently serves FIFO is worse than
    none)."""
    name, sep, rest = spec.partition(":")
    name = name.strip()
    if not name:
        raise ValueError(f"slo_classes entry {spec!r}: empty class name")
    kw: Dict[str, float] = {}
    if sep and rest.strip():
        for part in rest.split(","):
            key, eq, val = part.partition("=")
            key = key.strip()
            if not eq or key not in _CLASS_KEYS:
                raise ValueError(
                    f"slo_classes entry {spec!r}: expected KEY=VALUE with "
                    f"KEY one of {_CLASS_KEYS}, got {part!r}"
                )
            try:
                kw[key] = float(val)
            except ValueError:
                raise ValueError(
                    f"slo_classes entry {spec!r}: {key} value {val!r} is "
                    "not a number"
                ) from None
    weight = kw.pop("weight", 1.0)
    if weight <= 0:
        raise ValueError(f"slo_classes entry {spec!r}: weight must be > 0")
    depth = kw.pop("queue_depth", None)
    if depth is not None:
        if depth != int(depth) or depth < 1:
            raise ValueError(
                f"slo_classes entry {spec!r}: queue_depth must be an "
                "int >= 1"
            )
        depth = int(depth)
    p99 = kw.pop("p99_ms", None)
    if p99 is not None and p99 <= 0:
        raise ValueError(f"slo_classes entry {spec!r}: p99_ms must be > 0")
    shed = kw.pop("shed_rate", None)
    if shed is not None and not 0.0 <= shed <= 1.0:
        raise ValueError(
            f"slo_classes entry {spec!r}: shed_rate must be in [0, 1]"
        )
    return SLOClass(
        name=name, weight=weight, p99_ms=p99, shed_rate=shed,
        queue_depth=depth,
    )


@dataclass(frozen=True)
class QosSpec:
    """The validated class table. `classes` is PRIORITY order (highest
    weight first — the strict-preference order); `shed_order` is the
    reverse story: its FIRST entry degrades and sheds first, its LAST
    holds out longest."""

    classes: Tuple[SLOClass, ...]
    shed_order: Tuple[str, ...]
    default_class: str
    starvation_floor: float

    def __post_init__(self):
        object.__setattr__(
            self, "_by_name", {c.name: c for c in self.classes}
        )

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.classes)

    def class_of(self, name: str) -> SLOClass:
        return self._by_name[name]

    def weights(self) -> Dict[str, float]:
        return {c.name: c.weight for c in self.classes}

    def resolve(self, slo_class: Optional[str]) -> str:
        """Admission-time class resolution: None takes the default; an
        UNDECLARED name is a caller bug, rejected loudly before any
        counter moves."""
        if slo_class is None:
            return self.default_class
        if slo_class not in self._by_name:
            raise ValueError(
                f"slo_class {slo_class!r} is not declared; "
                f"slo_classes = {list(self.names)}"
            )
        return slo_class

    def shed_position(self, name: str) -> int:
        """0 = first to shed/degrade; len-1 = the premium end."""
        return self.shed_order.index(name)

    def _gates(self, name: str) -> Tuple[int, int]:
        from glom_tpu_torch.resilience.ladder import class_rungs

        return class_rungs(self.shed_position(name), len(self.classes))

    def degrade_rung(self, name: str) -> int:
        """The ladder rung at which this class's dispatches take the
        capped-iters route (the premium end holds its full route one
        rung longer — resilience/ladder.class_rungs)."""
        return self._gates(name)[0]

    def shed_rung(self, name: str) -> int:
        """The ladder rung at which admission sheds this class (the
        first class in the shed order sheds a rung EARLY — load drops
        tenant-by-tenant, batch first)."""
        return self._gates(name)[1]

    def low_classes(self) -> frozenset:
        """Classes whose SLO breaches are NON-BINDING for the elastic
        policy (the first entry of the shed order): batch-only pressure
        must not force a scale-out nor veto an earned scale-in — those
        calls belong to the classes the fleet actually protects."""
        if len(self.shed_order) < 2:
            return frozenset()
        return frozenset({self.shed_order[0]})


def resolve_slo_classes(scfg) -> Optional[QosSpec]:
    """The ONE ServeConfig -> QosSpec resolution (None when the config
    declares no classes — the classless bit-parity path). Loud on every
    inconsistency: duplicate names, an unknown default or shed-order
    name, a floor the class count cannot satisfy."""
    specs = getattr(scfg, "slo_classes", None)
    if not specs:
        return None
    parsed = [parse_slo_class(s) for s in specs]
    names = [c.name for c in parsed]
    if len(set(names)) != len(names):
        raise ValueError(f"slo_classes {names}: duplicate class names")
    # Priority = descending weight; declaration order breaks ties (so
    # ("premium:weight=4", "standard", "batch") reads top-down).
    order = sorted(
        range(len(parsed)), key=lambda i: (-parsed[i].weight, i)
    )
    classes = tuple(parsed[i] for i in order)
    shed_order = getattr(scfg, "slo_shed_order", None)
    if shed_order:
        if sorted(shed_order) != sorted(names):
            raise ValueError(
                f"slo_shed_order {list(shed_order)} must be a permutation "
                f"of the declared classes {sorted(names)}"
            )
        shed_order = tuple(shed_order)
    else:
        # Default shed order: ascending priority — the lightest-weight
        # class sheds first, the heaviest holds out longest.
        shed_order = tuple(c.name for c in reversed(classes))
    default = getattr(scfg, "slo_default_class", None)
    if default is None:
        default = "standard" if "standard" in names else classes[0].name
    elif default not in names:
        raise ValueError(
            f"slo_default_class {default!r} is not a declared class "
            f"{sorted(names)}"
        )
    floor = float(getattr(scfg, "slo_starvation_floor", 0.05))
    if not 0.0 <= floor < 1.0:
        raise ValueError(
            f"slo_starvation_floor {floor} must be in [0, 1)"
        )
    if len(classes) > 1 and (len(classes) - 1) * floor >= 1.0:
        raise ValueError(
            f"slo_starvation_floor {floor} x {len(classes) - 1} lower "
            "classes leaves the top class no capacity — the floor must "
            "satisfy (n_classes - 1) * floor < 1"
        )
    return QosSpec(
        classes=classes, shed_order=shed_order, default_class=default,
        starvation_floor=floor,
    )


def class_slo_rules(spec: QosSpec) -> Dict[str, float]:
    """Class-scoped monitor rules from the per-class targets:
    {"p99_ms[premium]": 150.0, "shed_rate[batch]": 0.2, ...} — the
    vocabulary telemetry/aggregate.parse_slo speaks and the elastic
    loop arms (docs/OBSERVABILITY.md)."""
    rules: Dict[str, float] = {}
    for c in spec.classes:
        if c.p99_ms is not None:
            rules[f"p99_ms[{c.name}]"] = c.p99_ms
        if c.shed_rate is not None:
            rules[f"shed_rate[{c.name}]"] = c.shed_rate
    return rules


class ClassQueues:
    """The deficit-weighted-fair admission lane: a drop-in for the
    batcher's shared `queue.Queue` backed by one BOUNDED deque per
    class.

    Scheduling contract (docs/SERVING.md "SLO classes"):

      * put_nowait(item) routes by `item.slo_class` into that class's
        lane and raises `queue.Full` when THAT lane is at capacity —
        per-class backpressure, so a batch flood can never occupy
        premium's admission slots;
      * get()/get_nowait() pick STRICT-PRIORITY (highest weight first)
        — except the starvation floor: every non-top backlogged class
        banks `starvation_floor` credit per pick and preempts the
        moment it is owed a whole pick (lowest class checked first).
        Under sustained all-class overload every class's pick share is
        therefore >= the floor, premium takes the remainder — the
        bound tests/test_qos.py pins;
      * qsize()/empty()/maxsize read the TOTAL across lanes (the shape
        the ladder's queue-fill signal and the capacity records expect).

    Thread-safe under one condition variable; `record()` exposes the
    per-class pick/occupancy evidence the summary nests."""

    def __init__(self, spec: QosSpec, *, default_depth: int):
        if default_depth < 1:
            raise ValueError(f"default_depth {default_depth} must be >= 1")
        self.spec = spec
        self._order: List[str] = list(spec.names)  # priority, highest 1st
        self._lanes: Dict[str, deque] = {n: deque() for n in self._order}
        self._depth: Dict[str, int] = {
            c.name: (
                c.queue_depth if c.queue_depth is not None else default_depth
            )
            for c in spec.classes
        }
        self.maxsize = sum(self._depth.values())
        self._cv = threading.Condition()
        self._size = 0
        self._n_picks = 0
        self._picks: Dict[str, int] = {n: 0 for n in self._order}
        self._credit: Dict[str, float] = {n: 0.0 for n in self._order}
        self.n_floor_picks = 0
        self.n_full: Dict[str, int] = {n: 0 for n in self._order}

    # -- queue.Queue facade -------------------------------------------------

    def qsize(self) -> int:
        with self._cv:
            return self._size

    def empty(self) -> bool:
        return self.qsize() == 0

    def put_nowait(self, item) -> None:
        cls = getattr(item, "slo_class", None) or self.spec.default_class
        lane = self._lanes.get(cls)
        if lane is None:
            # submit() resolves classes before enqueue; an unknown class
            # here is a requeue of a pre-reconfiguration item — route it
            # to the default lane rather than strand the ticket.
            cls = self.spec.default_class
            lane = self._lanes[cls]
        with self._cv:
            if len(lane) >= self._depth[cls]:
                self.n_full[cls] += 1
                raise queue.Full
            lane.append(item)
            self._size += 1
            self._cv.notify()

    def get_nowait(self):
        return self.get(timeout=0.0)

    def get(self, timeout: Optional[float] = None):
        with self._cv:
            if timeout is None:
                while self._size == 0:
                    self._cv.wait()
            elif self._size == 0 and timeout > 0:
                self._cv.wait_for(lambda: self._size > 0, timeout)
            if self._size == 0:
                raise queue.Empty
            cls = self._pick_locked()
            item = self._lanes[cls].popleft()
            self._size -= 1
            return item

    # -- the deficit-weighted-fair pick -------------------------------------

    def _pick_locked(self) -> str:
        backlogged = [c for c in self._order if self._lanes[c]]
        top = self._order[0]
        chosen = None
        floor_pick = False
        # The starvation floor first, LOWEST priority first: a class
        # that has banked a whole owed pick takes this slot regardless
        # of what premium has queued.
        for c in reversed(self._order):
            if c != top and self._lanes[c] and self._credit[c] >= 1.0:
                chosen, floor_pick = c, True
                break
        if chosen is None:
            chosen = backlogged[0]  # strict preference
        # Every OTHER backlogged non-top class banks its floor credit
        # for this pick; the chosen class pays a whole pick down.
        floor = self.spec.starvation_floor
        for c in backlogged:
            if c != top and c != chosen:
                self._credit[c] = min(
                    _CREDIT_CAP, self._credit[c] + floor
                )
        if chosen != top:
            self._credit[chosen] = max(
                0.0, self._credit[chosen] + floor - 1.0
            )
        self._n_picks += 1
        self._picks[chosen] += 1
        if floor_pick:
            self.n_floor_picks += 1
        return chosen

    # -- evidence -----------------------------------------------------------

    def class_fill(self) -> Dict[str, Dict[str, int]]:
        """{class: {"depth": queued, "capacity": lane bound}} — the
        per-class pressure the shed details and capacity records carry."""
        with self._cv:
            return {
                n: {"depth": len(self._lanes[n]), "capacity": self._depth[n]}
                for n in self._order
            }

    def record(self) -> dict:
        """The scheduler rollup the batcher summary nests: per-class
        picks, the floor-preemption count, and rejected-at-lane-full
        counts (conservation: picks sum to every get() that returned)."""
        with self._cv:
            return {
                "starvation_floor": self.spec.starvation_floor,
                "n_picks": self._n_picks,
                "n_floor_picks": self.n_floor_picks,
                "picks": dict(self._picks),
                "lane_full": {
                    n: v for n, v in self.n_full.items() if v
                },
            }
