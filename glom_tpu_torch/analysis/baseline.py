"""Reviewed-suppression baseline: the ratchet that lets the pass gate CI.

A baseline maps finding FINGERPRINTS (checker :: file :: enclosing symbol
:: rule key — deliberately line-free, so edits above a site don't churn
it) to accepted counts. The CI contract is exit-1-on-NEW-finding: a run
fails iff some fingerprint occurs more times than the baseline allows.
Stale entries (baselined findings that no longer occur) are reported as
warnings so the file ratchets DOWN over time; they never fail the run —
deleting dead suppressions must not block the fix that killed them.

Every entry carries the finding's message and a `reviewed` note field the
committer fills in — an unexplained baseline entry is exactly the silent
drift this pass exists to prevent, so __main__ refuses to accept entries
whose note is empty.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

from glom_tpu_torch.analysis.core import Finding

BASELINE_VERSION = 1


def load(path: str) -> dict:
    with open(path) as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or "suppressions" not in data:
        raise ValueError(f"{path}: not a glom-lint baseline (no 'suppressions')")
    return data


def counts(baseline: dict) -> Counter:
    out: Counter = Counter()
    for fp, entry in baseline.get("suppressions", {}).items():
        out[fp] = int(entry.get("count", 1)) if isinstance(entry, dict) else int(entry)
    return out


def unreviewed(baseline: dict) -> List[str]:
    """Fingerprints whose entry has no non-empty `reviewed` note."""
    bad = []
    for fp, entry in baseline.get("suppressions", {}).items():
        if not (isinstance(entry, dict) and str(entry.get("reviewed", "")).strip()):
            bad.append(fp)
    return sorted(bad)


def apply(
    findings: List[Finding], baseline: dict
) -> Tuple[List[Finding], List[str]]:
    """(new_findings, stale_fingerprints): findings beyond the baselined
    count per fingerprint are new; baselined fingerprints with no
    occurrences at all are stale."""
    allowed = counts(baseline)
    seen: Counter = Counter()
    new: List[Finding] = []
    for f in findings:
        seen[f.fingerprint] += 1
        if seen[f.fingerprint] > allowed.get(f.fingerprint, 0):
            new.append(f)
    stale = sorted(fp for fp in allowed if seen[fp] == 0)
    return new, stale


def prune(
    baseline: dict, findings: List[Finding]
) -> Tuple[dict, List[str]]:
    """(pruned_baseline, removed_fingerprints): drop suppressions whose
    fingerprint no longer occurs in `findings` AT ALL — the stale
    entries the apply() warnings have been nagging about. Entries with
    some occurrences keep their full count (count ratcheting is a
    manual review decision, not an automated one)."""
    seen = Counter(f.fingerprint for f in findings)
    supp = baseline.get("suppressions", {})
    removed = sorted(fp for fp in supp if seen[fp] == 0)
    out = dict(baseline)
    out["suppressions"] = {
        fp: entry for fp, entry in supp.items() if seen[fp] > 0
    }
    return out, removed


def build(findings: List[Finding], *, reviewed: str = "") -> dict:
    """Baseline dict accepting exactly the given findings. `reviewed` is
    written into every entry; entries with an empty note are rejected at
    load-enforcement time, so --write-baseline output must be annotated
    before it can gate CI."""
    supp: Dict[str, dict] = {}
    for f in findings:
        entry = supp.setdefault(
            f.fingerprint,
            {"count": 0, "message": f.message, "reviewed": reviewed},
        )
        entry["count"] += 1
    return {"version": BASELINE_VERSION, "suppressions": supp}


def write(findings: List[Finding], path: str, *, reviewed: str = "") -> dict:
    data = build(findings, reviewed=reviewed)
    Path(path).write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    return data
