"""Short-horizon load forecasting, scored against what then happened.

The port's copy of `glom_tpu/telemetry/forecast.py`. The autoscaler
(serve/elastic.py) reacts after a breach; acting at `now + lead_time`
needs a load forecast over the capacity window and a spawn-lead-time model
fitted to the stamped spawn_ms evidence. This module fits both and stamps
schema-v9 "forecast" records whose predicted-vs-realized error
(`forecast_abs_err`) is carried on every record: null while nothing has
matured, never absent (the schema linter rejects an unscored emitter).
The anticipatory policy (serve/elastic.py with `elastic_anticipatory`)
reads the numbers; nothing here changes a scaling decision by itself.

Pure stdlib. The clock never appears: callers pass `t` explicitly, so
tests drive a fake clock and replayed artifacts re-score
deterministically. On the card the lead-time model fits this port's own
spawn times (an engine build plus its warmup), never the reference's.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Deque, List, Optional, Tuple

from glom_tpu_torch.telemetry import schema


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


class LoadForecaster:
    """Windowed trend (+ optional seasonality) over one metric series.

    observe(t, value) feeds one measured sample (arrival rate, service
    rate — any rps-ish series); forecast(t) fits the trailing window_s of
    samples and predicts the value at t + horizon_s. Every prediction is
    queued until the series passes its target time, then SCORED against
    the realized (interpolated) value — the resulting absolute error
    rides the next records as `forecast_abs_err` (and the running mean as
    `forecast_mae`), so `telemetry compare`/`watch` gate forecast quality
    like any other cost.

    Seasonality (season_s) folds samples into season_buckets phase bins;
    the seasonal deviation (bin mean - global mean) joins the trend
    extrapolation only once the series spans >= 2 full seasons —
    before that the component pins to None with the reason stamped
    (never a half-fit pretending to be a fit).

    Degenerate windows — fewer than min_samples samples, or zero time
    span — emit `predicted: null` with a `reason`, still carrying the
    forecast_abs_err key (the v9 presence contract).
    """

    def __init__(
        self,
        metric: str,
        *,
        window_s: float = 10.0,
        horizon_s: float = 2.0,
        season_s: Optional[float] = None,
        season_buckets: int = 8,
        min_samples: int = 3,
    ):
        if window_s <= 0 or horizon_s <= 0:
            raise ValueError(
                f"window_s {window_s} and horizon_s {horizon_s} must be > 0"
            )
        if season_s is not None and season_s <= 0:
            raise ValueError(f"season_s {season_s} must be > 0 or None")
        if season_buckets < 2:
            raise ValueError(f"season_buckets {season_buckets} must be >= 2")
        if min_samples < 2:
            raise ValueError(f"min_samples {min_samples} must be >= 2")
        self.metric = metric
        self.window_s = float(window_s)
        self.horizon_s = float(horizon_s)
        self.season_s = season_s
        self.season_buckets = season_buckets
        self.min_samples = min_samples
        self._samples: Deque[Tuple[float, float]] = deque()  # (t, value)
        # Seasonal phase bins accumulate over the WHOLE run (seasonality
        # is the long-period structure the trailing window cannot see).
        self._season_sum = [0.0] * season_buckets
        self._season_n = [0] * season_buckets
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        # Predictions waiting to mature: (t_target, predicted).
        self._pending: Deque[Tuple[float, float]] = deque()
        self._last_abs_err: Optional[float] = None
        self._last_realized: Optional[float] = None
        self._err_sum = 0.0
        self._n_scored = 0

    # -- ingest ------------------------------------------------------------

    def observe(self, t: float, value: float) -> None:
        """One measured sample of the series at time t (monotone t —
        replayed artifacts and live clocks both qualify)."""
        t, value = float(t), float(value)
        self._samples.append((t, value))
        if self._t_first is None:
            self._t_first = t
        self._t_last = t
        if self.season_s is not None:
            b = int((t % self.season_s) / self.season_s * self.season_buckets)
            b = min(b, self.season_buckets - 1)
            self._season_sum[b] += value
            self._season_n[b] += 1
        self._mature(t)
        self._prune(t)

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    def _mature(self, now: float) -> None:
        """Score every pending prediction whose target time has passed,
        against the realized value interpolated at the target."""
        while self._pending and self._pending[0][0] <= now:
            t_target, predicted = self._pending.popleft()
            realized = self._value_at(t_target)
            if realized is None:
                continue  # the series went dark over the target: unscorable
            self._last_realized = realized
            self._last_abs_err = abs(predicted - realized)
            self._err_sum += self._last_abs_err
            self._n_scored += 1

    def _value_at(self, t: float) -> Optional[float]:
        """Linear interpolation of the sample series at t (nearest sample
        when t falls outside the retained span)."""
        if not self._samples:
            return None
        before = after = None
        for ts, v in self._samples:
            if ts <= t:
                before = (ts, v)
            if ts >= t and after is None:
                after = (ts, v)
        if before is None:
            return after[1]
        if after is None:
            return before[1]
        if after[0] == before[0]:
            return before[1]
        frac = (t - before[0]) / (after[0] - before[0])
        return before[1] + frac * (after[1] - before[1])

    # -- the fit -----------------------------------------------------------

    def _trend(self) -> Optional[Tuple[float, float]]:
        """(slope per second, value at the window's last sample) from a
        least-squares line over the retained window; None when the window
        is degenerate (too few samples, zero time span)."""
        pts = list(self._samples)
        if len(pts) < self.min_samples:
            return None
        t0 = pts[0][0]
        xs = [t - t0 for t, _ in pts]
        ys = [v for _, v in pts]
        n = len(pts)
        if xs[-1] - xs[0] <= 0:
            return None
        mx = sum(xs) / n
        my = sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        if sxx <= 0:
            return None
        slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
        return slope, my + slope * (xs[-1] - mx)

    def _seasonal(self, t_target: float) -> Tuple[Optional[float], Optional[str]]:
        """(deviation at t_target's phase, degenerate reason). The
        component needs >= 2 full observed seasons — one season cannot
        distinguish seasonality from trend."""
        if self.season_s is None:
            return None, None
        if (
            self._t_first is None
            or self._t_last is None
            or self._t_last - self._t_first < 2 * self.season_s
        ):
            return None, "season-immature"
        filled = [
            (s / n) for s, n in zip(self._season_sum, self._season_n) if n
        ]
        if len(filled) < 2:
            return None, "season-immature"
        grand = sum(filled) / len(filled)
        b = int(
            (t_target % self.season_s) / self.season_s * self.season_buckets
        )
        b = min(b, self.season_buckets - 1)
        if not self._season_n[b]:
            return None, "season-phase-unseen"
        return self._season_sum[b] / self._season_n[b] - grand, None

    def forecast(self, t: float) -> dict:
        """One stamped "forecast" record predicting the series at
        t + horizon_s. Degenerate fits stamp predicted null + the reason;
        the forecast_abs_err key is ALWAYS present (the v9 contract)."""
        t = float(t)
        self._mature(t)
        self._prune(t)
        t_target = t + self.horizon_s
        fit = self._trend()
        reason = None
        predicted = trend_per_s = seasonal = None
        if fit is None:
            reason = (
                "insufficient-samples"
                if len(self._samples) < self.min_samples
                else "zero-time-span"
            )
        else:
            trend_per_s, last = fit
            t_last = self._samples[-1][0]
            predicted = last + trend_per_s * (t_target - t_last)
            seasonal, season_reason = self._seasonal(t_target)
            if seasonal is not None:
                predicted += seasonal
            elif season_reason is not None:
                reason = season_reason  # trend-only fit, honestly labelled
            self._pending.append((t_target, predicted))
        rec = {
            "metric": self.metric,
            "horizon_s": self.horizon_s,
            "t": round(t, 3),
            "predicted": (
                round(predicted, 4) if predicted is not None else None
            ),
            "realized": (
                round(self._last_realized, 4)
                if self._last_realized is not None else None
            ),
            # The contract key: null until a prediction matures, never
            # absent (schema.validate_record enforces presence at v9).
            "forecast_abs_err": (
                round(self._last_abs_err, 4)
                if self._last_abs_err is not None else None
            ),
            "forecast_mae": (
                round(self._err_sum / self._n_scored, 4)
                if self._n_scored else None
            ),
            "n_scored": self._n_scored,
            "trend_per_s": (
                round(trend_per_s, 6) if trend_per_s is not None else None
            ),
            "seasonal": (
                round(seasonal, 4) if seasonal is not None else None
            ),
            "n_samples": len(self._samples),
            "window_s": self.window_s,
        }
        if reason is not None:
            rec["reason"] = reason
        return schema.stamp(rec, kind="forecast")


class SpawnLeadTimeModel:
    """How long a scale-out takes, from the stamped spawn_ms evidence.

    Each observed spawn latency first SCORES the model's prior estimate
    (|previous lead_time_ms - realized spawn_ms| — the same predicted-vs-
    realized discipline as the load forecast), then joins the sample set.
    lead_time_ms() is the `quantile` nearest-rank percentile — the lead
    the anticipatory policy must act ahead by so `quantile` of
    spawns complete in time. No evidence pins to None, never a guess.
    """

    def __init__(self, *, quantile: float = 0.9, max_samples: int = 256):
        if not 0.0 < quantile <= 1.0:
            raise ValueError(f"quantile {quantile} outside (0, 1]")
        if max_samples < 1:
            raise ValueError(f"max_samples {max_samples} must be >= 1")
        self.quantile = quantile
        self._samples: Deque[float] = deque(maxlen=max_samples)
        self._last_abs_err: Optional[float] = None
        self._err_sum = 0.0
        self._n_scored = 0

    def observe(self, spawn_ms: float) -> None:
        prior = self.lead_time_ms()
        if prior is not None:
            self._last_abs_err = abs(prior - float(spawn_ms))
            self._err_sum += self._last_abs_err
            self._n_scored += 1
        self._samples.append(float(spawn_ms))

    def lead_time_ms(self) -> Optional[float]:
        if not self._samples:
            return None
        return round(_percentile(sorted(self._samples), self.quantile), 3)

    def record(self) -> dict:
        """One stamped "forecast" record of the current lead-time model
        (metric "spawn_lead_time"); degenerate (no spawns yet) pins
        lead_time_ms null with the reason stamped."""
        lead = self.lead_time_ms()
        rec = {
            "metric": "spawn_lead_time",
            # The lead time IS the horizon this model predicts over.
            "horizon_s": round(lead / 1e3, 4) if lead is not None else 0.0,
            "lead_time_ms": lead,
            "quantile": self.quantile,
            "forecast_abs_err": (
                round(self._last_abs_err, 4)
                if self._last_abs_err is not None else None
            ),
            "forecast_mae": (
                round(self._err_sum / self._n_scored, 4)
                if self._n_scored else None
            ),
            "n_scored": self._n_scored,
            "n_samples": len(self._samples),
        }
        if lead is None:
            rec["reason"] = "no-spawn-evidence"
        return schema.stamp(rec, kind="forecast")


class ForecastEmitter:
    """Live glue: a batcher event tap that closes a forecast window every
    interval_s of tap activity and emits ONE scored arrival-rate forecast
    record per window (plus a spawn-lead-time record per scale-out).

    Rides DynamicBatcher.add_event_tap next to the autoscaler's SLO
    monitor; arrivals come from the per-request "admit" events
    (batcher.enable_admission_events() arms them — the same stream the
    WorkloadRecorder captures), spawn evidence from the autoscaler's
    "scale_out" records. Thread-safe: taps fire from worker AND submit
    threads. emit(record) is the caller's sink (MetricsWriter.write,
    telemetry.sinks.emit, a list.append in tests). Windows only close on
    tap activity — an idle stream forecasts nothing, which is the honest
    reading (no traffic, no load to predict)."""

    def __init__(
        self,
        emit,
        *,
        interval_s: float = 0.5,
        window_s: float = 5.0,
        horizon_s: float = 1.0,
        season_s: Optional[float] = None,
        clock=None,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s {interval_s} must be > 0")
        import time

        self._emit = emit
        self.interval_s = float(interval_s)
        self._clock = clock if clock is not None else time.monotonic
        self.forecaster = LoadForecaster(
            "arrival_rate_rps",
            window_s=window_s,
            horizon_s=horizon_s,
            season_s=season_s,
        )
        self.lead_model = SpawnLeadTimeModel()
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._window_start: Optional[float] = None
        self._window_arrivals = 0
        # Per-SLO-class arrivals inside the open window (v11): the admit
        # events' slo_class stamps, counted only when classed — a
        # classless stream keeps its forecast records byte-identical.
        self._window_by_class: dict = {}
        self.n_windows = 0
        self._last_forecast: Optional[dict] = None

    def tap(self, rec: dict) -> None:
        out: List[dict] = []
        with self._lock:
            now = self._clock()
            if self._t0 is None:
                self._t0 = self._window_start = now
            if rec.get("kind") == "serve":
                event = rec.get("event")
                if event == "admit":
                    self._window_arrivals += 1
                    cls = rec.get("slo_class")
                    if isinstance(cls, str) and cls:
                        self._window_by_class[cls] = (
                            self._window_by_class.get(cls, 0) + 1
                        )
                elif event in ("scale_out", "spare_spawn") and isinstance(
                    rec.get("spawn_ms"), (int, float)
                ):
                    # Warm-pool spare pre-spawns are REAL spawn evidence
                    # (same factory, same warmup) — they bootstrap the
                    # lead-time model before the first live scale-out,
                    # which is exactly when the anticipatory policy
                    # needs a lead to act ahead of.
                    self.lead_model.observe(float(rec["spawn_ms"]))
                    out.append(self.lead_model.record())
            if now - self._window_start >= self.interval_s:
                out.append(self._close_window(now))
        for r in out:
            self._emit(r)

    def latest_forecast(self) -> Optional[dict]:
        """The most recent closed-window arrival-rate forecast record
        (a copy), or None before any window has closed. The autoscaler
        reads this each tick to stamp the forecast it believed into the
        decision's evidence bundle."""
        with self._lock:
            return dict(self._last_forecast) if self._last_forecast else None

    def _close_window(self, now: float) -> dict:
        """Observe the realized window rate, score, and forecast — caller
        holds the lock."""
        span = max(now - self._window_start, 1e-9)
        rate = self._window_arrivals / span
        by_class = self._window_by_class
        t_rel = now - self._t0
        self.forecaster.observe(t_rel, rate)
        self._window_arrivals = 0
        self._window_by_class = {}
        self._window_start = now
        self.n_windows += 1
        rec = self.forecaster.forecast(t_rel)
        rec["observed_rate_rps"] = round(rate, 4)
        if by_class:
            # Tenant mix of the closed window (v11): per-class arrival
            # counts, stamped only when any admit carried a class.
            rec["by_class"] = {
                cls: by_class[cls] for cls in sorted(by_class)
            }
        self._last_forecast = rec
        return rec

    def close(self) -> None:
        """Flush the final partial window (end-of-run): the run's last
        traffic still scores the forecast before the stream ends."""
        out = []
        with self._lock:
            if self._window_start is not None and (
                self._window_arrivals or self.forecaster._pending
            ):
                out.append(self._close_window(self._clock()))
            out.append(self.lead_model.record())
        for r in out:
            self._emit(r)
