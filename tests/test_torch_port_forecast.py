"""The port's load forecast (`glom_tpu_torch/telemetry/forecast.py`) against
glom_tpu's, on the CPU.

Both are pure Python, so the same inputs must give equal outputs: the same
sample series (seeded numpy draws) through `LoadForecaster`, the same spawn
latencies through `SpawnLeadTimeModel`, and the same tap stream under the
same fake clock through `ForecastEmitter`, record for record. The invalid
arguments raise the same messages.
"""

import numpy as np
import pytest

from glom_tpu.telemetry import forecast as jforecast
from glom_tpu_torch.telemetry import forecast as tforecast
from glom_tpu_torch.telemetry import schema


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


FORECASTER_CASES = [
    dict(window_s=10.0, horizon_s=2.0),
    dict(window_s=3.0, horizon_s=0.5, min_samples=2),
    dict(window_s=20.0, horizon_s=1.0, season_s=4.0, season_buckets=4),
    dict(window_s=5.0, horizon_s=5.0, season_s=2.5, season_buckets=8, min_samples=5),
]


def _series(seed, n=80):
    """(t, value) samples: a trend, a seasonal swing, noise and bursts of
    equal timestamps (the zero-span degenerate)."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.choice([0.0, 0.1, 0.25, 0.5], size=n, p=[0.1, 0.3, 0.4, 0.2]))
    v = 20 + 3 * t + 5 * np.sin(t) + rng.normal(scale=2.0, size=n)
    return [(float(a), float(b)) for a, b in zip(t, v)]


@pytest.mark.parametrize("kw", FORECASTER_CASES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_forecaster_equals_reference(kw, seed):
    j = jforecast.LoadForecaster("arrival_rate_rps", **kw)
    t = tforecast.LoadForecaster("arrival_rate_rps", **kw)
    recs = []
    for i, (ts, v) in enumerate(_series(seed)):
        j.observe(ts, v)
        t.observe(ts, v)
        if i % 3 == 0:
            want, got = j.forecast(ts), t.forecast(ts)
            assert got == want
            recs.append(got)
    assert any(r["forecast_abs_err"] is not None for r in recs)
    for r in recs:
        assert schema.validate_record(r) == []


def test_load_forecaster_degenerate_reasons_equal():
    """Empty, thin and zero-span windows pin null with the same reason."""
    for pts in ([], [(1.0, 3.0)], [(1.0, 3.0), (1.0, 4.0), (1.0, 5.0)]):
        j = jforecast.LoadForecaster("m", min_samples=3)
        t = tforecast.LoadForecaster("m", min_samples=3)
        for ts, v in pts:
            j.observe(ts, v)
            t.observe(ts, v)
        want, got = j.forecast(2.0), t.forecast(2.0)
        assert got == want and got["predicted"] is None and "reason" in got


@pytest.mark.parametrize("quantile,max_samples", [(0.9, 256), (0.5, 4), (1.0, 1)])
def test_spawn_lead_time_model_equals_reference(quantile, max_samples):
    rng = np.random.default_rng(7)
    j = jforecast.SpawnLeadTimeModel(quantile=quantile, max_samples=max_samples)
    t = tforecast.SpawnLeadTimeModel(quantile=quantile, max_samples=max_samples)
    assert t.record() == j.record()
    for ms in rng.gamma(4.0, 250.0, size=20):
        j.observe(float(ms))
        t.observe(float(ms))
        assert t.lead_time_ms() == j.lead_time_ms()
        assert t.record() == j.record()


def _taps(seed, n=200):
    """A tap stream: admits (some classed), scale-outs and spare spawns
    with spawn_ms, and unrelated records, at seeded gaps."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        u = rng.random()
        if u < 0.8:
            rec = {"kind": "serve", "event": "admit", "request_id": i}
            if rng.random() < 0.4:
                rec["slo_class"] = str(rng.choice(["premium", "batch"]))
        elif u < 0.85:
            rec = {"kind": "serve", "event": "scale_out", "spawn_ms": float(rng.gamma(3, 100))}
        elif u < 0.9:
            rec = {"kind": "serve", "event": "spare_spawn", "spawn_ms": float(rng.gamma(3, 100))}
        else:
            rec = {"kind": "capacity", "engine": "engine0", "headroom": 0.5}
        out.append((float(rng.choice([0.0, 0.01, 0.05, 0.2])), rec))
    return out


@pytest.mark.parametrize("kw", [
    dict(interval_s=0.5, window_s=5.0, horizon_s=1.0),
    dict(interval_s=0.2, window_s=2.0, horizon_s=0.4, season_s=1.0),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_forecast_emitter_equals_reference(kw, seed):
    jclk, tclk = FakeClock(), FakeClock()
    jout, tout = [], []
    j = jforecast.ForecastEmitter(jout.append, clock=jclk, **kw)
    t = tforecast.ForecastEmitter(tout.append, clock=tclk, **kw)
    for dt, rec in _taps(seed):
        jclk.advance(dt)
        tclk.advance(dt)
        j.tap(dict(rec))
        t.tap(dict(rec))
        assert t.latest_forecast() == j.latest_forecast()
    j.close()
    t.close()
    assert tout == jout
    assert t.n_windows == j.n_windows > 2
    assert any("by_class" in r for r in tout)
    assert any(r.get("metric") == "spawn_lead_time" and r["n_samples"] for r in tout)
    for r in tout:
        assert schema.validate_record(r) == []


@pytest.mark.parametrize("cls,kw", [
    ("LoadForecaster", dict(window_s=0.0)),
    ("LoadForecaster", dict(horizon_s=-1.0)),
    ("LoadForecaster", dict(season_s=0.0)),
    ("LoadForecaster", dict(season_buckets=1)),
    ("LoadForecaster", dict(min_samples=1)),
    ("SpawnLeadTimeModel", dict(quantile=0.0)),
    ("SpawnLeadTimeModel", dict(max_samples=0)),
    ("ForecastEmitter", dict(interval_s=0.0)),
])
def test_validation_messages_equal(cls, kw):
    args = {"LoadForecaster": ("m",), "SpawnLeadTimeModel": (),
            "ForecastEmitter": (lambda r: None,)}[cls]
    with pytest.raises(ValueError) as want:
        getattr(jforecast, cls)(*args, **kw)
    with pytest.raises(ValueError) as got:
        getattr(tforecast, cls)(*args, **kw)
    assert str(got.value) == str(want.value)
