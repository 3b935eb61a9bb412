"""Bench-trajectory regression gate: `python -m glom_tpu_torch.telemetry compare`.

The port's copy of `glom_tpu/telemetry/compare.py`. An UNMEASURED row
written as `value: 0.0` reads, in a naive base-vs-new diff, as a 100%
regression (or a recovery *from* zero as an infinite speedup). This gate
compares two bench logs the way the trajectory should be read:

  * records match by their full `metric` label (the label names the regime
    — config, chip, path — so cross-regime rows never compare);
  * repeated measurements of one metric collapse to the BEST value on each
    side (min-of-noise on both sides, the same convention the benches'
    min-over-repeats timing uses), so run-to-run jitter cannot
    manufacture a regression by itself;
  * direction comes from the unit: rates ("/s", "x") regress DOWN, costs
    ("ms", "percent", "bytes", seconds) regress UP;
  * UNMEASURED rows — kind "error", `value: null`, or a non-numeric value
    — are MISSING, never zero: reported, excluded from the verdict;
  * the verdict is noise-aware: only a relative change beyond --threshold
    (default 5%, glom_tpu's) in the regressing direction fails the gate.

Exit code: 1 when any regression beyond threshold survives, else 0, so a
slow row cannot land silently. The module imports only the standard
library and the schema, like the linter, and touches no device.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

from glom_tpu_torch.telemetry import schema

# Unit substrings that mark a LOWER-is-better (cost) metric; anything else
# — including the north-star "column-iters/s/chip" and speedup ratios "x"
# — is a rate, where lower is the regression. "iters" covers the serving
# early-exit rows ("iters/request": column updates spent per request); the
# rate check runs FIRST, so "column-iters/s/chip" still reads as a rate.
_COST_UNIT_TOKENS = ("ms", "percent", "bytes", "second", "iters")
# Failure-ish count names regress UP (more retries/failures/sheds is
# worse); everything else counted (dispatches, rejoins, alive) is a
# rate, where LOWER is the regression — a dead engine's dispatches
# dropping to zero must gate, not vanish.
_COST_METRIC_TOKENS = (
    "overhead", "time", "latency", "retries", "failures", "gave_up",
    "fast_failed", "shed", "evictions", "rejects", "expirations",
    # Ladder churn regresses UP too: restores track degrades 1:1, so a
    # run that never degraded improves on BOTH, and one that bounced
    # more regresses on both — rate-classifying restores would gate the
    # calm run for restoring less.
    "degrades", "restores", "deaths", "failovers",
    # Pad waste is a COST: a serve change that pads more —
    # higher pad_fraction_mean, more pad bytes, or warm levels0 bytes
    # creeping back onto the host->device path — regresses UP.
    "pad", "h2d",
    # Delta-cache depth is a COST: longer chains mean more
    # pages per stream and deeper reconstruction; compactions deferred
    # under pins are pressure evidence. bytes_per_stream rides the
    # "bytes" unit token.
    "chain", "compact_deferred",
    # Capacity-observatory pressure rows: occupancy creeping
    # up regresses even when latency holds (headroom is the matching
    # BENEFIT token below; collective_time.* wall_ms and the
    # serve_latency.* phase rows ride the "ms" unit token).
    "utilization", "fill", "wait",
    # Elastic-serving damage rows: a drain that INVALIDATES
    # sessions (no sibling page budget) lost warmth a migration would
    # have kept; spawn rollbacks are failed scale-outs. spawn_ms and
    # migrated_bytes ride the "ms"/"bytes" unit tokens.
    "invalidated", "spawn_failures",
    # Banded-consensus + pool-aliasing rows: the duplicated
    # k/v working set regresses UP (peak_window_bytes rides the "bytes"
    # unit token too — the name token keeps intent explicit), and
    # alias fallbacks are pinned writes that fell back to full-pool
    # copy-on-write — more of them is more bytes moved.
    # serve_ragged_max_signature_pages has NEITHER token: it rate-
    # classifies, so the admission ceiling SHRINKING is the regression.
    "peak_window", "alias_fallback",
    # Workload-observatory rows: forecast error growing is a
    # worse forecast, and a longer spawn lead time means the
    # anticipatory policy must act earlier — both regress UP
    # (lead_time_ms also rides the "ms" unit token; the name token
    # covers the flattened forecast.*.lead_time rows).
    "forecast_abs_err", "lead_time",
    # Decision-observatory rows: REGRET is failure evidence
    # inside a decision's cover window, decisions_late counts scale-outs
    # taken only after the SLO already broke, and spawn_lead_violations
    # counts spawns slower than the lead their decision believed — every
    # one regresses UP ("violation" also covers the flattened
    # serve_elastic.spawn_lead_violations row).
    "regret", "decisions_late", "violation",
    # Per-class QoS rows: a tenant's failed/degraded/shed
    # counts regress UP wherever they surface ("shed" already rides the
    # list; "failed" covers serve_class.*.n_failed, "degraded" the
    # per-class degrade counters — a change that degrades premium more
    # is a regression even when totals hold).
    "failed", "degraded",
)
# Metric-name tokens that mark a HIGHER-is-better row regardless of the
# cost heuristics: headroom is capacity LEFT — a serving change that
# erodes it regresses DOWN, exactly opposite to the occupancy costs.
# served_fraction is the starvation-floor contract made a gate: the
# batch tenant's served share dropping IS the regression.
_BENEFIT_METRIC_TOKENS = ("headroom", "served_fraction")


def lower_is_better(metric: str, unit: str) -> bool:
    unit = unit.lower()
    if any(tok in metric.lower() for tok in _BENEFIT_METRIC_TOKENS):
        return False
    if "/s" in unit or unit == "x":
        return False
    if any(tok in unit for tok in _COST_UNIT_TOKENS) or unit == "s":
        return True
    return any(tok in metric.lower() for tok in _COST_METRIC_TOKENS)


def _is_measured(rec: dict) -> bool:
    v = rec.get("value")
    return (
        rec.get("kind") != "error"
        and isinstance(v, (int, float))
        and not isinstance(v, bool)
    )


def flatten_engine_metrics(rec: dict) -> List[dict]:
    """Synthetic bench-shaped rows from one serve summary's per-engine
    nest, so multi-engine rollups GATE instead of vanishing: the summary
    nests dispatches / rejoins / ladder / retry counters under
    `engines[name]` (flat on a single-engine summary — those fields ride
    the record itself and were never per-engine), and the compare gate
    only ingests `metric` rows. Numeric leaves (bools as 0/1 — an engine
    going alive=1 -> 0 IS the regression kill-serve hunts) flatten to
    `serve_engine.<name>.<dotted.path> (<config>)`, unit "count"; the
    direction comes from _COST_METRIC_TOKENS (retries/failures regress
    UP, dispatches/alive regress DOWN)."""
    engines = rec.get("engines")
    if not isinstance(engines, dict):
        return []
    cfg = rec.get("config")
    suffix = f" ({cfg})" if isinstance(cfg, str) and cfg else ""
    rows: List[dict] = []

    def walk(prefix: str, obj: dict, out: Dict[str, float]) -> None:
        for k, v in obj.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v, out)
            elif isinstance(v, (int, float)):
                # bool is an int subclass: alive flattens as 0/1.
                out[f"{prefix}{k}"] = float(v)

    for name in sorted(engines):
        st = engines[name]
        if not isinstance(st, dict):
            continue
        flat: Dict[str, float] = {}
        walk("", st, flat)
        for key, value in sorted(flat.items()):
            rows.append(
                {
                    "metric": f"serve_engine.{name}.{key}{suffix}",
                    "value": value,
                    "unit": "count",
                    "kind": "bench",
                }
            )
    # Pad-tax rollup rows: the summary's aggregated pad waste
    # and warm-path upload bytes gate as COSTS — a serving change that
    # re-grows the pad fraction or puts levels0 back on the PCIe path
    # regresses, whatever it did to latency. Units make the direction
    # ("fraction"/"bytes" carry the pad/h2d cost tokens in the metric).
    for key, unit in (
        ("pad_fraction_mean", "fraction"),
        ("pad_bytes_wasted", "bytes"),
        ("levels0_h2d_bytes", "bytes"),
    ):
        v = rec.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            rows.append(
                {
                    "metric": f"serve_pad.{key}{suffix}",
                    "value": float(v),
                    "unit": unit,
                    "kind": "bench",
                }
            )
    # The cache-delta nest: bytes_per_stream and chain length
    # gate as COSTS — a storage change that re-grows per-stream pages or
    # deepens chains regresses even when latency holds. Counters
    # (n_delta_writes, n_base_shares, ...) flatten too; direction comes
    # from _COST_METRIC_TOKENS ("chain"/"compact_deferred" up, shares as
    # a rate down).
    delta = (rec.get("column_cache") or {}).get("delta")
    if isinstance(delta, dict):
        for key in sorted(delta):
            v = delta[key]
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            unit = "bytes" if "bytes" in key else "count"
            rows.append(
                {
                    "metric": f"serve_cache_delta.{key}{suffix}",
                    "value": float(v),
                    "unit": unit,
                    "kind": "bench",
                }
            )
    # The latency decomposition rollup: the summary's mean
    # per-dispatch phase split gates as serve_latency.* COSTS ("ms" unit)
    # — a change that moves time into queue_wait or h2d regresses even
    # when total latency holds inside noise.
    phases = rec.get("latency_phases")
    if isinstance(phases, dict):
        for key in sorted(phases):
            v = phases[key]
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                rows.append(
                    {
                        "metric": f"serve_latency.{key}{suffix}",
                        "value": float(v),
                        "unit": "ms",
                        "kind": "bench",
                    }
                )
    # The capacity nest: headroom gates as a BENEFIT (the
    # _BENEFIT_METRIC_TOKENS row — less capacity left is the
    # regression), utilization as a cost, service rate by its "/s" unit.
    capacity = rec.get("capacity")
    if isinstance(capacity, dict):
        for name in sorted(capacity):
            st = capacity[name]
            if not isinstance(st, dict):
                continue
            for key, unit in (
                ("headroom", "fraction"),
                ("utilization", "fraction"),
                ("service_rate_rps", "req/s"),
            ):
                v = st.get(key)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    rows.append(
                        {
                            "metric": (
                                f"serve_capacity.{name}.{key}{suffix}"
                            ),
                            "value": float(v),
                            "unit": unit,
                            "kind": "bench",
                        }
                    )
    # The elastic nest: the autoscaler's rollup flattens as
    # serve_elastic.* rows — spawn latency ("ms") and migration bytes
    # ("bytes") gate as COSTS by unit; spawn failures and invalidated
    # sessions by the failure-ish metric tokens; scale counts ride as
    # plain counts (how often the loop acts is workload, not quality).
    elastic = rec.get("elastic")
    if isinstance(elastic, dict):
        for key in sorted(elastic):
            v = elastic[key]
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue  # the timeline list is perfetto's, not a row
            unit = (
                "ms" if "_ms" in key
                else "bytes" if "bytes" in key
                else "count"
            )
            rows.append(
                {
                    "metric": f"serve_elastic.{key}{suffix}",
                    "value": float(v),
                    "unit": unit,
                    "kind": "bench",
                }
            )
    # The per-class QoS nest: each SLO class's counters gate
    # as serve_class.<class>.* rows — premium sheds/fails/degrades are
    # COSTS (the failure-ish metric tokens), each class's
    # served_fraction a BENEFIT (the starvation floor made a gate: the
    # batch tenant's served share dropping below the floor regresses
    # even while fleet totals hold).
    classes = rec.get("classes")
    if isinstance(classes, dict):
        for cls in sorted(classes):
            st = classes[cls]
            if not isinstance(st, dict):
                continue
            for key in sorted(st):
                v = st[key]
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    continue
                unit = "fraction" if "fraction" in key else "count"
                rows.append(
                    {
                        "metric": f"serve_class.{cls}.{key}{suffix}",
                        "value": float(v),
                        "unit": unit,
                        "kind": "bench",
                    }
                )
    # Per-lane admission rejections from the class scheduler's record: a
    # full premium lane is shed-at-the-door evidence ("rejects" token —
    # regresses UP). Scheduler pick counters are workload, not quality —
    # they never gate.
    sched = rec.get("class_scheduler")
    if isinstance(sched, dict) and isinstance(sched.get("lane_full"), dict):
        lane_full = sched["lane_full"]
        for cls in sorted(lane_full):
            v = lane_full[cls]
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                rows.append(
                    {
                        "metric": (
                            f"serve_class.{cls}.lane_full_rejects{suffix}"
                        ),
                        "value": float(v),
                        "unit": "count",
                        "kind": "bench",
                    }
                )
    return rows


def load_bench_records(lines) -> Tuple[Dict[str, dict], Dict[str, dict]]:
    """(measured, unmeasured) bench rows keyed by metric label. Repeated
    measured rows keep EVERY value (collapsed to best at compare time);
    shell noise and non-bench kinds are skipped like the linter skips
    them. Legacy `value: 0.0` rows carrying an `error` field are dead
    zeros — classified unmeasured, never ingested. Serve
    SUMMARY records contribute their per-engine nest as synthetic
    `serve_engine.*` rows (flatten_engine_metrics), so a fan-out
    regression confined to one engine still gates."""
    measured: Dict[str, dict] = {}
    unmeasured: Dict[str, dict] = {}

    def ingest(rec: dict) -> None:
        metric = rec.get("metric")
        if not isinstance(metric, str):
            return
        kind = rec.get("kind", schema.infer_kind(rec))
        if kind not in ("bench", "error"):
            return
        dead_zero = rec.get("value") in (0, 0.0) and "error" in rec
        if _is_measured(rec) and not dead_zero:
            slot = measured.setdefault(metric, {"rec": rec, "values": []})
            slot["values"].append(float(rec["value"]))
        else:
            unmeasured[metric] = rec

    for _, rec in schema.iter_json_lines(lines):
        if rec.get("kind") == "serve" and rec.get("event") == "summary":
            for row in flatten_engine_metrics(rec):
                ingest(row)
            continue
        if rec.get("kind") == "collective_time" and isinstance(
            rec.get("site"), str
        ):
            # Per-collective wall-time rows: wall_ms gates as
            # a cost by its "ms" unit — a schedule change that slows one
            # site regresses even when totals hide it. The path (trainer
            # route or engine name) keys the regime like a config label.
            v = rec.get("wall_ms")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                ingest(
                    {
                        "metric": (
                            f"collective_time.{rec.get('path', '?')}."
                            f"{rec['site']} wall_ms"
                        ),
                        "value": float(v),
                        "unit": "ms",
                        "kind": "bench",
                    }
                )
            continue
        if rec.get("kind") == "capacity" and isinstance(
            rec.get("engine"), str
        ):
            h = rec.get("headroom")
            if isinstance(h, (int, float)) and not isinstance(h, bool):
                ingest(
                    {
                        "metric": f"capacity.{rec['engine']}.headroom",
                        "value": float(h),
                        "unit": "fraction",
                        "kind": "bench",
                    }
                )
            continue
        if rec.get("kind") == "forecast" and isinstance(
            rec.get("metric"), str
        ):
            # Forecast-quality rows: the matured
            # predicted-vs-realized error and the spawn lead time gate
            # as COSTS (forecast_abs_err/lead_time name tokens) — a
            # change that makes the forecast worse, or the fleet slower
            # to spawn, regresses even though both live on "forecast"
            # records, not bench rows. Unmatured windows (null error)
            # are honest gaps, not zeros — skipped, never ingested.
            series = rec["metric"]
            err = rec.get("forecast_abs_err")
            if isinstance(err, (int, float)) and not isinstance(err, bool):
                ingest(
                    {
                        "metric": f"forecast.{series}.forecast_abs_err",
                        "value": float(err),
                        "unit": "count",
                        "kind": "bench",
                    }
                )
            lead = rec.get("lead_time_ms")
            if isinstance(lead, (int, float)) and not isinstance(
                lead, bool
            ):
                ingest(
                    {
                        "metric": f"forecast.{series}.lead_time_ms",
                        "value": float(lead),
                        "unit": "ms",
                        "kind": "bench",
                    }
                )
            continue
        if rec.get("kind") == "decision":
            # Forecast-AT-DECISION rows: the error the policy BELIEVED when it acted gates
            # like the live forecast error — a change that makes the
            # fleet act on worse-scored predictions regresses UP even if
            # every window's live score held. Unmatured evidence (null
            # error) is an honest gap, skipped.
            evidence = rec.get("evidence")
            fc = (
                evidence.get("forecast")
                if isinstance(evidence, dict) else None
            )
            fleet = rec.get("fleet", "fleet0")
            if isinstance(fc, dict):
                err = fc.get("forecast_abs_err")
                if isinstance(err, (int, float)) and not isinstance(
                    err, bool
                ):
                    ingest(
                        {
                            "metric": (
                                f"decision.{fleet}.forecast_abs_err"
                            ),
                            "value": float(err),
                            "unit": "count",
                            "kind": "bench",
                        }
                    )
            if isinstance(evidence, dict):
                lead = evidence.get("lead_time_ms")
                if isinstance(lead, (int, float)) and not isinstance(
                    lead, bool
                ):
                    ingest(
                        {
                            "metric": f"decision.{fleet}.lead_time_ms",
                            "value": float(lead),
                            "unit": "ms",
                            "kind": "bench",
                        }
                    )
            continue
        ingest(rec)
    return measured, unmeasured


def _best(values: List[float], lower_better: bool) -> float:
    return min(values) if lower_better else max(values)


def compare_records(
    base_measured: Dict[str, dict],
    base_unmeasured: Dict[str, dict],
    new_measured: Dict[str, dict],
    new_unmeasured: Dict[str, dict],
    *,
    threshold: float = 0.05,
) -> List[dict]:
    """One result dict per metric seen on either side, worst first."""
    results = []
    for metric in sorted(set(base_measured) | set(base_unmeasured)):
        base = base_measured.get(metric)
        if base is None:
            # Unmeasured in BASE: nothing to regress against.
            status = (
                "unmeasured-both" if metric not in new_measured else "recovered"
            )
            rec = new_measured.get(metric)
            new_v = None
            if rec is not None:
                lb = lower_is_better(metric, rec["rec"].get("unit", ""))
                new_v = _best(rec["values"], lb)
            results.append(
                {"metric": metric, "status": status, "new": new_v}
            )
            continue
        unit = base["rec"].get("unit", "")
        lb = lower_is_better(metric, unit)
        base_v = _best(base["values"], lb)
        new = new_measured.get(metric)
        if new is None:
            results.append(
                {
                    "metric": metric,
                    "status": (
                        "unmeasured-in-new"
                        if metric in new_unmeasured
                        else "missing-in-new"
                    ),
                    "base": base_v,
                    "error": new_unmeasured.get(metric, {}).get("error"),
                }
            )
            continue
        new_v = _best(new["values"], lb)
        if base_v == 0:
            rel = 0.0 if new_v == 0 else float("inf")
        else:
            rel = (new_v - base_v) / abs(base_v)
        regressed = rel > threshold if lb else rel < -threshold
        improved = rel < -threshold if lb else rel > threshold
        results.append(
            {
                "metric": metric,
                "status": (
                    "regression"
                    if regressed
                    else "improvement" if improved else "ok"
                ),
                "base": base_v,
                "new": new_v,
                "rel_change": round(rel, 4) if rel != float("inf") else 1e9,
                "unit": unit,
                "lower_is_better": lb,
            }
        )
    for metric in sorted(set(new_measured) - set(base_measured) - set(base_unmeasured)):
        rec = new_measured[metric]
        lb = lower_is_better(metric, rec["rec"].get("unit", ""))
        results.append(
            {
                "metric": metric,
                "status": "new-metric",
                "new": _best(rec["values"], lb),
            }
        )
    # A brand-new metric that ALSO failed to measure (first run of a new
    # bench OOMing, say) must still appear in the report — omitting it
    # would hide that a measurement was attempted at all.
    for metric in sorted(
        set(new_unmeasured)
        - set(base_measured) - set(base_unmeasured) - set(new_measured)
    ):
        results.append(
            {
                "metric": metric,
                "status": "unmeasured-new-only",
                "error": new_unmeasured[metric].get("error"),
            }
        )
    order = {"regression": 0, "missing-in-new": 1, "unmeasured-in-new": 2}
    results.sort(key=lambda r: (order.get(r["status"], 3), r["metric"]))
    return results


class SchemaArtifactError(ValueError):
    pass


def artifact_lines(path: str) -> List[str]:
    """The bench JSONL lines inside one bench artifact (a single JSON
    object whose "tail" field carries the bench's final stdout lines, and
    "parsed" its last record). Legacy value-0.0 dead zeros are
    classified unmeasured by load_bench_records like any other stream —
    the artifact is just a different container for the same rows."""
    with open(path) as fh:
        obj = json.load(fh)
    if not isinstance(obj, dict):
        raise SchemaArtifactError(f"{path}: not a bench artifact object")
    tail = obj.get("tail") or ""
    lines = [l for l in tail.splitlines() if l.strip()]
    parsed = obj.get("parsed")
    if not lines and isinstance(parsed, dict):
        lines = [json.dumps(parsed)]
    return lines


def compare_files(
    base_path: str,
    new_path: str,
    *,
    threshold: float = 0.05,
    artifacts: bool = False,
):
    if artifacts:
        bm, bu = load_bench_records(artifact_lines(base_path))
        nm, nu = load_bench_records(artifact_lines(new_path))
    else:
        with open(base_path) as fh:
            bm, bu = load_bench_records(fh)
        with open(new_path) as fh:
            nm, nu = load_bench_records(fh)
    return compare_records(bm, bu, nm, nu, threshold=threshold)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m glom_tpu_torch.telemetry compare",
        description="Noise-aware bench-trajectory regression gate "
        "(UNMEASURED rows are missing, never zero)",
    )
    ap.add_argument("base", help="baseline bench JSONL/log")
    ap.add_argument("new", help="candidate bench JSONL/log")
    ap.add_argument(
        "--threshold", type=float, default=0.05, metavar="FRAC",
        help="relative change beyond which a move in the regressing "
        "direction fails the gate (default 0.05)",
    )
    ap.add_argument(
        "--fail-on-missing", action="store_true",
        help="also exit nonzero when a baseline metric is absent from NEW "
        "entirely (UNMEASURED rows still only warn — they are missing by "
        "design, not silently dropped)",
    )
    ap.add_argument(
        "--bench-artifact", action="store_true",
        help="BASE/NEW are bench artifacts (one JSON object whose 'tail' "
        "carries the bench rows) instead of raw JSONL",
    )
    args = ap.parse_args(argv)
    results = compare_files(
        args.base, args.new,
        threshold=args.threshold, artifacts=args.bench_artifact,
    )

    counts: Dict[str, int] = {}
    for r in results:
        counts[r["status"]] = counts.get(r["status"], 0) + 1
        tag = r["status"].upper().replace("-", "_")
        if r["status"] in ("regression", "improvement", "ok"):
            arrow = f"{r['base']:g} -> {r['new']:g} ({100 * r['rel_change']:+.1f}%)"
            print(f"{tag:<16} {r['metric']}: {arrow}", file=sys.stderr)
        else:
            detail = r.get("error") or ""
            print(f"{tag:<16} {r['metric']} {detail}".rstrip(), file=sys.stderr)

    summary = schema.stamp(
        {
            "summary": True,
            "comparison": {"base": args.base, "new": args.new},
            "threshold": args.threshold,
            "metrics_compared": counts.get("regression", 0)
            + counts.get("improvement", 0)
            + counts.get("ok", 0),
            **{f"n_{k.replace('-', '_')}": v for k, v in sorted(counts.items())},
        },
        kind="summary",
    )
    print(json.dumps(summary))
    failed = counts.get("regression", 0) > 0 or (
        args.fail_on_missing and counts.get("missing-in-new", 0) > 0
    )
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
