"""The port's workload module (`serve/workload.py`) against glom_tpu's: the
scenario generators give the same records for the same seed, class mixes
parse alike, synthesized inputs are the same arrays, and an artifact
written, loaded and replayed on a fake clock round-trips with its pacing.
The recorder rides the port's batcher on a CPU engine."""

import numpy as np
import pytest

from glom_tpu.serve import workload as jwl
from glom_tpu_torch import GlomConfig, InferenceEngine, ServeConfig
from glom_tpu_torch.serve import DynamicBatcher, QueueFullError
from glom_tpu_torch.serve import workload as twl
from glom_tpu_torch.telemetry import schema
from test_torch_port_model import TINY

SHAPES = ((3, 16, 16), (3, 8, 8))


@pytest.mark.parametrize("name", sorted(jwl.SCENARIOS))
@pytest.mark.parametrize("kw", [
    dict(seed=0),
    dict(seed=3, streams=2, shapes=SHAPES, class_mix="premium=0.2,batch=0.5"),
    dict(seed=7, shapes=SHAPES, mode="ragged", patch_size=4, page_tokens=4, streams=0),
    dict(seed=1, mode="delta", streams=3),
])
def test_generate_matches_reference(name, kw):
    try:
        want = jwl.generate(name, 4.0, **kw)
    except ValueError as e:  # the rolling outage needs streams
        with pytest.raises(ValueError, match=str(e)):
            twl.generate(name, 4.0, **kw)
        return
    got = twl.generate(name, 4.0, **kw)
    assert got == want
    assert got and all(not schema.validate_record(r) for r in got)


@pytest.mark.parametrize("spec", [None, "", "a=0.5", "a=0.2,b=0.3,a=0.1",
                                  {"x": 0.25}, "a", "a=x", "a=1.5", "a=0.6,b=0.6"])
def test_parse_class_mix(spec):
    try:
        want = jwl.parse_class_mix(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            twl.parse_class_mix(spec)
        assert str(got.value) == str(e)
        return
    assert twl.parse_class_mix(spec) == want


def test_unknown_scenario_and_bad_args():
    with pytest.raises(ValueError, match="unknown scenario"):
        twl.generate("nope")
    with pytest.raises(ValueError, match="peak_rps"):
        twl.gen_diurnal(base_rps=5.0, peak_rps=1.0)
    with pytest.raises(ValueError, match="ragged scenarios"):
        twl.gen_flash_crowd(2.0, mode="ragged")


def test_synth_input_matches_reference():
    for rec in twl.generate("diurnal", 2.0, seed=2, streams=2, shapes=SHAPES)[:6]:
        np.testing.assert_array_equal(twl.synth_input(rec), jwl.synth_input(rec))
    rec = {"t": 0.0, "signature": "bucket:3x8x8", "outcome": "offered", "session": None}
    np.testing.assert_array_equal(twl.synth_input(rec, 4), jwl.synth_input(rec, 4))
    with pytest.raises(ValueError, match="replayable shape"):
        twl.synth_input({"t": 0.0, "signature": "ragged:4p"})


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def test_write_load_replay_round_trip(tmp_path):
    recs = twl.generate("flash-crowd", 3.0, seed=5, streams=2)
    path = tmp_path / "w.jsonl"
    twl.write_workload(str(path), recs, source="test")
    assert schema.main([str(path)]) == 0
    loaded = twl.load_workload(str(path))
    assert [r["t"] for r in loaded] == [r["t"] for r in recs]
    assert loaded == jwl.load_workload(str(path))
    clock, offered = FakeClock(), []

    def submit(rec, i):
        offered.append((clock.t, rec["session"]))
        if i == 2:
            raise RuntimeError("shed")

    stats = twl.replay(loaded, submit, time_scale=2.0, clock=clock, sleep=clock.sleep)
    t0 = loaded[0]["t"]
    assert [t for t, _ in offered] == pytest.approx([2.0 * (r["t"] - t0) for r in loaded])
    assert stats["n_offered"] == len(loaded) and stats["n_shed"] == 1
    assert stats["pacing_lag_max_ms"] == 0.0
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(ValueError, match="no workload records"):
        twl.load_workload(str(empty))


def test_recorder_rides_the_batcher(tmp_path):
    """Every offered request lands once with its outcome; the artifact
    lints and replays."""
    cfg = GlomConfig(**TINY)
    eng = InferenceEngine(cfg, ServeConfig(buckets=(1, 2), max_batch=2, iters=2,
                                           queue_depth=2), device="cpu")
    b = DynamicBatcher(eng, max_delay_ms=5000.0)
    rec = twl.WorkloadRecorder().attach(b)
    img = np.zeros((3, 16, 16), np.float32)
    ts = [b.submit(img, session_id="s0"), b.submit(img)]
    with pytest.raises(QueueFullError):
        b.submit(img)  # the queue holds 2: shed
    b.start()
    for t in ts:
        t.result(timeout=60)
    b.stop()
    summary = rec.summary()
    assert summary["n_offered"] == 3 and summary["served"] == 2 and summary["shed"] == 1
    path = tmp_path / "rec.jsonl"
    assert rec.write(str(path)) == 3
    assert schema.main([str(path)]) == 0
    loaded = twl.load_workload(str(path))
    assert [r["signature"] for r in loaded] == ["bucket:3x16x16"] * 3
    assert [r["session"] for r in loaded] == ["s0", None, None]
