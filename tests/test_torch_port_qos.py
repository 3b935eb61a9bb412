"""The port's SLO classes (`serve/qos.py`) and class ladder gates against
glom_tpu's, on the same inputs: parsed classes, resolved tables, the
weighted-fair pick order with its starvation floor, and `class_rungs`."""

import dataclasses
import queue

import pytest

from glom_tpu.resilience import ladder as jladder
from glom_tpu.serve import qos as jqos
from glom_tpu.utils import config as jconfig
from glom_tpu_torch.resilience import ladder as tladder
from glom_tpu_torch.serve import qos as tqos
from glom_tpu_torch.utils import config as tconfig

SPECS = ("premium:weight=8,p99_ms=150", "standard:weight=3,queue_depth=4",
         "batch:weight=1,shed_rate=0.5")


@pytest.mark.parametrize("spec", [
    "premium", "premium:weight=8,p99_ms=150", "batch:weight=1,shed_rate=0.5,queue_depth=3",
    " standard :weight=2.5", "x:", "", ":weight=1", "a:weight=0", "a:weight=abc",
    "a:depth=3", "a:queue_depth=1.5", "a:p99_ms=-1", "a:shed_rate=2",
])
def test_parse_slo_class(spec):
    try:
        want = dataclasses.asdict(jqos.parse_slo_class(spec))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tqos.parse_slo_class(spec)
        assert str(got.value) == str(e)
        return
    assert dataclasses.asdict(tqos.parse_slo_class(spec)) == want


@pytest.mark.parametrize("kw", [
    dict(slo_classes=SPECS),
    dict(slo_classes=SPECS, slo_default_class="batch", slo_starvation_floor=0.1),
    dict(slo_classes=SPECS, slo_shed_order=("standard", "batch", "premium")),
    dict(slo_classes=("a:weight=2", "b:weight=2", "c")),
    dict(slo_classes=("a", "a")),
    dict(slo_classes=SPECS, slo_default_class="gold"),
    dict(slo_classes=SPECS, slo_shed_order=("batch", "premium")),
    dict(slo_classes=("a", "b", "c"), slo_starvation_floor=0.5),
    dict(slo_shed_order=("a",)),
])
def test_resolve_slo_classes(kw):
    """The resolved table and every refusal, through each package's
    ServeConfig (whose __post_init__ resolves the classes)."""
    try:
        jcfg = jconfig.ServeConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tconfig.ServeConfig(**kw)
        assert str(got.value) == str(e)
        return
    want, got = jqos.resolve_slo_classes(jcfg), tqos.resolve_slo_classes(tconfig.ServeConfig(**kw))
    assert got.names == want.names and got.shed_order == want.shed_order
    assert got.default_class == want.default_class
    assert got.starvation_floor == want.starvation_floor
    assert [dataclasses.asdict(c) for c in got.classes] == [
        dataclasses.asdict(c) for c in want.classes]
    for name in want.names:
        assert (got.degrade_rung(name), got.shed_rung(name)) == (
            want.degrade_rung(name), want.shed_rung(name))
    assert got.low_classes() == want.low_classes()
    assert tqos.class_slo_rules(got) == jqos.class_slo_rules(want)
    assert got.resolve(None) == want.resolve(None)
    with pytest.raises(ValueError, match="not declared"):
        got.resolve("nope")


class _Req:
    def __init__(self, cls, k):
        self.slo_class, self.k = cls, k


def _drive(qos, mod, floor, plan):
    """Put each (class, count) of `plan`, then drain: the pick order, the
    lane-full rejections and the scheduler's record."""
    spec = qos.resolve_slo_classes(mod.ServeConfig(slo_classes=SPECS,
                                                   slo_starvation_floor=floor))
    q = qos.ClassQueues(spec, default_depth=40)
    full = []
    for cls, n in plan:
        for k in range(n):
            try:
                q.put_nowait(_Req(cls, k))
            except queue.Full:
                full.append((cls, k))
    order = []
    while True:
        try:
            r = q.get_nowait()
        except queue.Empty:
            break
        order.append((r.slo_class, r.k))
    return order, full, q.record(), q.maxsize, q.class_fill()


@pytest.mark.parametrize("floor", [0.0, 0.05, 0.25])
def test_class_queues_order_and_starvation_floor(floor):
    plan = [("batch", 30), ("premium", 30), ("standard", 6), (None, 2), ("premium", 12)]
    want = _drive(jqos, jconfig, floor, plan)
    got = _drive(tqos, tconfig, floor, plan)
    assert got == want
    order, full, rec = got[0], got[1], got[2]
    assert order[0][0] == "premium" and ("standard", 4) in full  # its lane holds 4
    n_batch = sum(1 for c, _ in order[:40] if c == "batch")
    if floor == 0.25:
        assert rec["n_floor_picks"] > 0 and n_batch >= 5
    if floor == 0.0:
        assert n_batch == 0  # strict priority with no floor


def test_get_blocks_until_a_put():
    spec = tqos.resolve_slo_classes(tconfig.ServeConfig(slo_classes=SPECS))
    q = tqos.ClassQueues(spec, default_depth=2)
    with pytest.raises(queue.Empty):
        q.get(timeout=0.01)
    q.put_nowait(_Req("batch", 0))
    assert q.get(timeout=1.0).slo_class == "batch" and q.empty()


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_class_rungs(n):
    for pos in range(n):
        assert tladder.class_rungs(pos, n) == jladder.class_rungs(pos, n)
    for bad in (-1, n):
        with pytest.raises(ValueError):
            tladder.class_rungs(bad, n)
    assert tladder.RUNGS == jladder.RUNGS
