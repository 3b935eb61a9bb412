"""Decision-chain audit: replay every autoscaling decision from JSONL alone.

The port's copy of `glom_tpu/telemetry/audit.py`. Every
`ElasticPolicy.decide()` that acts stamps a schema-v10 "decision" record
carrying the full evidence bundle it believed (forecast window,
`forecast_abs_err` at decision time, lead-time quantile, headroom and
dwell inputs, breach set) plus the `decision_id` chain it extends. This
module is both halves of that contract:

  * The pure policy function. `policy_action(evidence)` maps one stamped
    evidence bundle to "scale_out" / "scale_in" / None, and
    `anticipated_deficit(evidence)` computes the predicted load excess at
    `now + lead_time_ms` over the fleet's target-utilization capacity.
    serve/elastic.py calls these functions on the very dict it stamps, so
    the audit below can re-run them on the JSONL and demand bit-for-bit
    agreement: a decision whose stamped inputs do not reproduce its
    action is corrupted evidence, not a judgment call.

  * The audit. `audit_records()` reconstructs the per-fleet decision
    chain (contiguous decision_ids, each linking its predecessor via
    `prev_decision_id`), checks evidence conservation (replayed action ==
    stamped action), checks action coverage (every spawn, drain,
    rollback and spare promotion traces to a stamped decision of the
    right family, and every decision actuated something), and scores
    per-decision regret: the failure evidence (sheds, failed settles, SLO
    breaches) that landed inside the decision's cover window, the
    interval the spawn was supposed to beat. `python -m
    glom_tpu_torch.telemetry audit FILE... [--strict] [--baseline FILE]`
    is the CLI.

Pure stdlib. No clock appears anywhere: every timestamp comes off the
records, so replayed artifacts audit deterministically.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from glom_tpu_torch.telemetry import schema


def _num(v: object) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


# ---------------------------------------------------------------------------
# The pure policy function (serve/elastic.py ElasticPolicy.decide() calls
# these on the evidence bundle it stamps — keep them dependency-free).
# ---------------------------------------------------------------------------

def rule_class(rule: str) -> Optional[str]:
    """The SLO class a composite rule name is scoped to, or None for a
    fleet-level rule: "p99_ms[premium]" -> "premium", "p99_ms" -> None.
    Mirrors telemetry/aggregate.split_slo_rule, re-derived here so the
    audit stays import-light (the stdlib-only contract); a malformed
    scope is treated as fleet-level rather than raising — the audit
    reads hostile JSONL."""
    base, bracket, rest = str(rule).partition("[")
    if not bracket or not rest.endswith("]") or not base:
        return None
    cls = rest[:-1]
    return cls if cls else None


def binding_breaches(evidence: dict) -> list:
    """The breaches that BIND the policy: every stamped breach whose
    rule is not scoped to one of the evidence's `low_classes`. A bundle
    without `low_classes` (classless, or pre-v11) binds on everything —
    the classless semantics bit-for-bit."""
    breaches = evidence.get("breaches") or []
    low = evidence.get("low_classes")
    if not low:
        return list(breaches)
    low_set = {str(c) for c in low}
    return [r for r in breaches if rule_class(r) not in low_set]


def anticipated_deficit(evidence: dict) -> Optional[float]:
    """Predicted load excess (rps) at `now + lead_time_ms` over the
    fleet's usable capacity, or None when the anticipatory inputs are
    not all present and matured.

    The maturity gate is deliberate: `predicted` null (degenerate fit),
    `forecast_abs_err` null (no prediction has matured — the model has
    never been scored against reality), `lead_time_ms` null (no spawn
    evidence), or a non-positive measured service rate each pin the
    deficit to None, and None means REACTIVE SEMANTICS BIT-FOR-BIT — an
    unproven forecast never spends hardware."""
    if not evidence.get("anticipatory"):
        return None
    fc = evidence.get("forecast")
    if not isinstance(fc, dict):
        return None
    predicted = fc.get("predicted")
    abs_err = fc.get("forecast_abs_err")
    lead_ms = evidence.get("lead_time_ms")
    rate = evidence.get("fleet_service_rate_rps")
    if not (_num(predicted) and _num(abs_err) and _num(lead_ms) and _num(rate)):
        return None
    if rate <= 0:
        return None
    horizon_s = fc.get("horizon_s")
    horizon_s = float(horizon_s) if _num(horizon_s) else 0.0
    trend = fc.get("trend_per_s")
    trend = float(trend) if _num(trend) else 0.0
    # The forecast already looks horizon_s ahead; extrapolate the fitted
    # trend over the REMAINING gap to the spawn-lead instant (never
    # backwards — a lead shorter than the horizon keeps the forecast).
    lead_s = float(lead_ms) / 1e3
    predicted_at_lead = float(predicted) + trend * max(0.0, lead_s - horizon_s)
    target = evidence.get("target_utilization")
    target = float(target) if _num(target) and target > 0 else 1.0
    capacity = float(rate) * target
    return round(predicted_at_lead - capacity, 6)


def policy_action(evidence: dict) -> Optional[str]:
    """The pure decision: one stamped evidence bundle -> "scale_out" /
    "scale_in" / None. This IS the policy — ElasticPolicy.decide() calls
    it on the bundle it is about to stamp, so the audit's replay of the
    same bundle must reproduce the action bit-for-bit.

    Reactive semantics (breach precedence, dwell hysteresis, min/max
    clamps) are the reactive contract verbatim; the anticipatory extension
    adds exactly one signal — a positive `anticipated_deficit` arms
    scale-out AND vetoes scale-in (predicted pressure is treated like a
    live breach), and a None deficit changes nothing.

    The QoS extension (evidence key `low_classes`, stamped only when
    SLO classes are declared): breaches scoped to a low class are
    NON-BINDING — they neither force scale-out nor veto an earned
    scale-in. Batch-tenant pressure alone never moves the fleet."""
    n = evidence.get("n_engines")
    if not _num(n):
        return None
    breaches = binding_breaches(evidence)
    dwell_s = evidence.get("dwell_s")
    dwell_s = float(dwell_s) if _num(dwell_s) else 0.0
    held = evidence.get("below_held_s")
    below = _num(held) and held >= dwell_s
    held = evidence.get("above_held_s")
    above = _num(held) and held >= dwell_s
    deficit = anticipated_deficit(evidence)
    anticipated = deficit is not None and deficit > 0
    max_engines = evidence.get("max_engines")
    min_engines = evidence.get("min_engines")
    if (
        (breaches or below or anticipated)
        and _num(max_engines)
        and n < max_engines
    ):
        return "scale_out"
    if breaches or anticipated:
        # Breach precedence, extended: capacity is never removed from a
        # fleet that is failing its SLO — or PREDICTED to, inside the
        # spawn lead the removal could not be undone within.
        return None
    if above and _num(min_engines) and n > min_engines:
        return "scale_in"
    return None


# ---------------------------------------------------------------------------
# The audit: chain + conservation + coverage + regret from JSONL alone.
# ---------------------------------------------------------------------------

# Serve events that belong to a scale-OUT decision's actuation chain vs a
# scale-IN decision's (serve/elastic.py SCALE_EVENTS + the batcher's
# detail-stamped drain/add events). An event outside both families that
# carries a decision_id only needs the decision to EXIST (cache_migrate
# rides the drain detail).
OUT_CHAIN_EVENTS = (
    "scale_out_decision",
    "scale_out",
    "admission_open",
    "spawn_rollback",
    "spare_promote",
    "engine_add",
)
IN_CHAIN_EVENTS = (
    "scale_in_decision",
    "drain_begin",
    "drain_flush",
    "drain_migrate",
    "drain_release",
    "drain_abort",
    "spare_demote",
)

# Events whose presence REQUIRES a stamped decision: the actuations. (The
# acceptance contract: every spawn/drain traces to a decision whose
# inputs reproduce its action.)
ACTUATION_EVENTS = (
    "scale_out",
    "spawn_rollback",
    "spare_promote",
    "drain_release",
    "drain_abort",
    "spare_demote",
)

# Failure evidence for the regret score: what the spawn was supposed to
# prevent, had it landed in time.
_FAILED_OUTCOMES = ("failed", "shed")


def _failure_class(rec: dict) -> Optional[str]:
    """The SLO class one failure record charges: the v11 `slo_class`
    stamp on sheds/settles/breaches, falling back to the breach rule's
    scope. None = classless (weight 1.0)."""
    cls = rec.get("slo_class")
    if isinstance(cls, str) and cls:
        return cls
    rule = rec.get("rule")
    if isinstance(rule, str):
        return rule_class(rule)
    return None


def _ts(rec: dict) -> Optional[float]:
    """The record's run-relative timestamp: `wall_time` (MetricsWriter's
    one clock per stream) first, the record's own `t` otherwise."""
    for key in ("wall_time", "t"):
        if _num(rec.get(key)):
            return float(rec[key])
    return None


def _fleet(rec: dict) -> str:
    f = rec.get("fleet")
    return f if isinstance(f, str) and f else "fleet0"


def audit_records(
    records: Iterable[dict],
    *,
    default_cover_s: float = 1.0,
) -> dict:
    """Audit one record stream (ONE fleet run per fleet label — do not
    concatenate two runs of the same fleet into one stream; their
    decision chains would collide). Returns the report dict; `errors`
    non-empty means the evidence is structurally broken, `warnings`
    flags suspicious-but-survivable shapes (--strict fails them too)."""
    decisions: Dict[Tuple[str, int], dict] = {}
    chain_events: List[dict] = []
    # (t, slo_class-or-None): v11 failure evidence carries the tenant
    # class, so regret can be scored class-weighted. Classless records
    # land with None and weight 1.0 — the raw count is unchanged.
    failures: List[Tuple[float, Optional[str]]] = []
    errors: List[str] = []
    warnings: List[str] = []
    n_records = 0
    for rec in records:
        if not isinstance(rec, dict):
            continue
        n_records += 1
        kind = rec.get("kind")
        if kind == "decision":
            did = rec.get("decision_id")
            if not isinstance(did, int) or isinstance(did, bool):
                errors.append(
                    f"decision record with non-int decision_id {did!r}"
                )
                continue
            key = (_fleet(rec), did)
            if key in decisions:
                errors.append(
                    f"duplicate decision_id {did} in fleet {key[0]!r}"
                )
                continue
            decisions[key] = rec
        elif kind == "serve":
            event = rec.get("event")
            if "decision_id" in rec and rec.get("decision_id") is not None:
                chain_events.append(rec)
            elif event in ACTUATION_EVENTS:
                errors.append(
                    f"serve.{event} carries no decision_id — an actuation "
                    "outside the decision chain"
                )
            if event == "shed" or (
                event == "settle" and rec.get("outcome") in _FAILED_OUTCOMES
            ):
                t = _ts(rec)
                if t is not None:
                    failures.append((t, _failure_class(rec)))
        elif kind == "slo_breach":
            t = _ts(rec)
            if t is not None:
                failures.append((t, _failure_class(rec)))
    failures.sort(key=lambda f: f[0])

    # -- chain: per fleet, contiguous ids, each linking its predecessor --
    fleets = sorted({f for f, _ in decisions})
    for fleet in fleets:
        ids = sorted(i for f, i in decisions if f == fleet)
        prev = None
        for i in ids:
            rec = decisions[(fleet, i)]
            if prev is not None and i != prev + 1:
                errors.append(
                    f"fleet {fleet!r} decision chain gap: {prev} -> {i}"
                )
            stamped_prev = rec.get("prev_decision_id")
            if stamped_prev != prev:
                errors.append(
                    f"fleet {fleet!r} decision {i} stamps "
                    f"prev_decision_id {stamped_prev!r}, expected {prev!r}"
                )
            prev = i

    # -- conservation: the stamped inputs must reproduce the action -----
    n_conserved = 0
    for (fleet, did), rec in sorted(decisions.items()):
        action = rec.get("action")
        evidence = rec.get("evidence")
        if not isinstance(evidence, dict):
            errors.append(
                f"fleet {fleet!r} decision {did} carries no evidence bundle"
            )
            continue
        replayed = policy_action(evidence)
        if replayed != action:
            errors.append(
                f"fleet {fleet!r} decision {did}: stamped action "
                f"{action!r} but the evidence replays to {replayed!r}"
            )
        else:
            n_conserved += 1

    # -- coverage: every actuation traces to a decision of its family ---
    actuated: Dict[Tuple[str, int], int] = {}
    for rec in chain_events:
        did = rec.get("decision_id")
        if not isinstance(did, int) or isinstance(did, bool):
            errors.append(
                f"serve.{rec.get('event')} carries non-int decision_id "
                f"{did!r}"
            )
            continue
        key = (_fleet(rec), did)
        dec = decisions.get(key)
        if dec is None:
            errors.append(
                f"serve.{rec.get('event')} references decision_id {did} "
                f"(fleet {key[0]!r}) but no decision record stamps it"
            )
            continue
        actuated[key] = actuated.get(key, 0) + 1
        event = rec.get("event")
        if event in OUT_CHAIN_EVENTS and dec.get("action") != "scale_out":
            errors.append(
                f"serve.{event} chains to decision {did} whose action is "
                f"{dec.get('action')!r}, not scale_out"
            )
        elif event in IN_CHAIN_EVENTS and dec.get("action") != "scale_in":
            errors.append(
                f"serve.{event} chains to decision {did} whose action is "
                f"{dec.get('action')!r}, not scale_in"
            )
    for key, rec in sorted(decisions.items()):
        if key not in actuated:
            warnings.append(
                f"fleet {key[0]!r} decision {key[1]} actuated no serve "
                "event (truncated stream?)"
            )

    # -- regret: failure evidence inside each scale-out's cover window --
    spawn_ms_by_decision: Dict[Tuple[str, int], float] = {}
    for rec in chain_events:
        if rec.get("event") in ("scale_out", "spare_promote"):
            ms = rec.get("spawn_ms")
            if not _num(ms):
                ms = rec.get("promote_ms")
            if _num(ms):
                key = (_fleet(rec), rec.get("decision_id"))
                spawn_ms_by_decision[key] = float(ms)
    regret_total = 0
    regret_weighted_total = 0.0
    decisions_late = 0
    lead_violations = 0
    per_decision: List[dict] = []
    for key, rec in sorted(decisions.items()):
        if rec.get("action") != "scale_out":
            continue
        evidence = rec.get("evidence") or {}
        late = bool(binding_breaches(evidence))
        if late:
            # Scaled AFTER the SLO already broke: the reactive failure
            # mode the anticipatory policy exists to avoid. A breach
            # scoped to a low class is not "late" — it could not have
            # driven the decision.
            decisions_late += 1
        lead_ms = evidence.get("lead_time_ms")
        spawn_ms = spawn_ms_by_decision.get(key)
        if _num(lead_ms) and _num(spawn_ms) and spawn_ms > lead_ms:
            lead_violations += 1
        if _num(lead_ms):
            cover_s = float(lead_ms) / 1e3
        elif _num(spawn_ms):
            cover_s = float(spawn_ms) / 1e3
        else:
            cover_s = default_cover_s
        t = _ts(rec)
        if t is not None:
            covered = [
                cls for ft, cls in failures if t <= ft <= t + cover_s
            ]
            regret = len(covered)
            # Class-weighted regret: each covered failure charges its
            # class's stamped weight (the decision's own evidence — the
            # audit invents nothing), classless failures charge 1.0.
            weights = evidence.get("class_weights") or {}
            regret_weighted = round(
                sum(
                    float(weights.get(cls, 1.0)) if cls else 1.0
                    for cls in covered
                ),
                6,
            )
        else:
            regret = None
            regret_weighted = None
        if regret is not None:
            regret_total += regret
            regret_weighted_total += regret_weighted
        per_decision.append(
            {
                "fleet": key[0],
                "decision_id": key[1],
                "regret": regret,
                "regret_weighted": regret_weighted,
                "cover_s": round(cover_s, 6),
                "late": late,
            }
        )

    return {
        "n_records": n_records,
        "fleets": fleets,
        "n_decisions": len(decisions),
        "n_conserved": n_conserved,
        "n_chain_events": len(chain_events),
        "n_failure_signals": len(failures),
        "regret_total": regret_total,
        "regret_weighted": round(regret_weighted_total, 6),
        "regret_per_decision": per_decision,
        "decisions_late": decisions_late,
        "spawn_lead_violations": lead_violations,
        "errors": errors,
        "warnings": warnings,
    }


def load_records(path: str) -> List[dict]:
    with open(path) as fh:
        return [rec for _, rec in schema.iter_json_lines(fh)]


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m glom_tpu_torch.telemetry audit",
        description=(
            "Reconstruct the elastic fleet's decision chain from JSONL "
            "evidence: chain integrity, evidence conservation (stamped "
            "inputs replay to the stamped action through the pure policy "
            "function), actuation coverage, and per-decision regret."
        ),
    )
    ap.add_argument("paths", nargs="+", help="JSONL evidence streams")
    ap.add_argument(
        "--strict", action="store_true",
        help="fail on warnings too (un-actuated decisions)",
    )
    ap.add_argument(
        "--baseline", default=None,
        help="a second stream (e.g. the reactive arm of the same replay) "
        "to audit and diff regret against — the counterfactual",
    )
    ap.add_argument(
        "--default-cover-s", type=float, default=1.0,
        help="regret cover window when a decision stamps no lead time "
        "and no spawn latency landed (default 1.0)",
    )
    args = ap.parse_args(argv)

    rc = 0
    totals = {"regret_total": 0, "regret_weighted": 0.0,
              "decisions_late": 0, "spawn_lead_violations": 0,
              "n_decisions": 0}
    for path in args.paths:
        report = audit_records(
            load_records(path), default_cover_s=args.default_cover_s
        )
        for e in report["errors"]:
            print(f"{path}: ERROR: {e}", file=sys.stderr)
        for w in report["warnings"]:
            print(f"{path}: WARNING: {w}", file=sys.stderr)
        if report["errors"] or (args.strict and report["warnings"]):
            rc = 1
        for k in totals:
            totals[k] += report[k]
        summary = {
            "audit": path,
            "ok": not report["errors"],
            **{
                k: report[k]
                for k in (
                    "n_records", "fleets", "n_decisions", "n_conserved",
                    "n_chain_events", "n_failure_signals", "regret_total",
                    "regret_weighted", "decisions_late",
                    "spawn_lead_violations",
                )
            },
            "n_errors": len(report["errors"]),
            "n_warnings": len(report["warnings"]),
        }
        print(json.dumps(schema.stamp(summary, kind="summary")))
    if args.baseline is not None:
        base = audit_records(
            load_records(args.baseline),
            default_cover_s=args.default_cover_s,
        )
        delta = {
            "audit": "baseline-delta",
            "baseline": args.baseline,
            "baseline_regret_total": base["regret_total"],
            "regret_total": totals["regret_total"],
            # Negative = the audited streams beat the counterfactual.
            "regret_delta": totals["regret_total"] - base["regret_total"],
            "regret_weighted_delta": round(
                totals["regret_weighted"] - base["regret_weighted"], 6
            ),
            "decisions_late_delta": (
                totals["decisions_late"] - base["decisions_late"]
            ),
        }
        print(json.dumps(schema.stamp(delta, kind="summary")))
    return rc


if __name__ == "__main__":
    sys.exit(main())
