"""CLI: python -m glom_tpu_torch.analysis [PATHS] [--baseline FILE].

The default path is the package, and the default baseline is the port's
own file beside it, `glom_tpu_torch/analysis_baseline.json`: the root
`analysis_baseline.json` is glom_tpu's, and its entries name glom_tpu's
files. Exit codes: 0 clean (or fully covered by the baseline), 1 new findings
(or an unreviewed baseline entry), 2 usage errors. Stale baseline
entries and unused pragmas are warnings — the ratchet tightens without
blocking the fix that made an entry stale.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional

from glom_tpu_torch.analysis import baseline as baseline_mod
from glom_tpu_torch.analysis.core import default_checkers, run

DEFAULT_BASELINE = str(Path(__file__).resolve().parent.parent / "analysis_baseline.json")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m glom_tpu_torch.analysis",
        description="glom-lint: static analysis over the port",
    )
    ap.add_argument(
        "paths", nargs="*", default=[str(Path(__file__).resolve().parent.parent)],
        help="files/directories to lint (default: glom_tpu_torch)",
    )
    ap.add_argument(
        "--baseline", default=None,
        help="reviewed-suppression file (default: the port's "
        "glom_tpu_torch/analysis_baseline.json)",
    )
    ap.add_argument(
        "--no-baseline", action="store_true",
        help="ignore any baseline file: report every finding",
    )
    ap.add_argument(
        "--write-baseline", metavar="FILE", default=None,
        help="accept the current findings into FILE and exit 0 (annotate "
        "every entry's 'reviewed' note before committing — enforcement "
        "refuses unreviewed entries)",
    )
    ap.add_argument(
        "--prune-baseline", action="store_true",
        help="drop baseline entries that no longer fire. DRY RUN by "
        "default (prints what would be removed); add --apply to rewrite "
        "the baseline and leave a stamped removal list next to it",
    )
    ap.add_argument(
        "--apply", action="store_true",
        help="with --prune-baseline: actually rewrite the baseline file",
    )
    ap.add_argument(
        "--cache", metavar="FILE", default=None,
        help="per-file content-fingerprint cache: files whose import "
        "closure is unchanged reuse their stored findings (cross-module "
        "edits invalidate importers; corruption falls back to a full "
        "pass, loudly)",
    )
    ap.add_argument(
        "--select", default=None,
        help="comma-separated checker names to run (default: all)",
    )
    ap.add_argument(
        "--list-checkers", action="store_true",
        help="print the checker catalog and exit",
    )
    args = ap.parse_args(argv)

    if args.list_checkers:
        for c in default_checkers():
            print(f"{c.name:22s} {c.description}")
        return 0

    select = (
        [s.strip() for s in args.select.split(",") if s.strip()]
        if args.select
        else None
    )
    cache = None
    if args.cache:
        from glom_tpu_torch.analysis.cache import AnalysisCache

        cache = AnalysisCache(args.cache)
    warnings: List[str] = []
    try:
        findings = run(
            args.paths, select=select, warnings=warnings, cache=cache
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for w in warnings:
        print(f"warning: {w}")
    if cache is not None:
        print(cache.stats())

    if args.prune_baseline:
        if select is not None:
            print(
                "error: --prune-baseline needs a full run — a partial "
                "--select cannot judge staleness",
                file=sys.stderr,
            )
            return 2
        return _prune_baseline(args, findings)

    if args.write_baseline:
        baseline_mod.write(findings, args.write_baseline)
        print(
            f"wrote {len(findings)} finding(s) to {args.write_baseline}; "
            "fill in every entry's 'reviewed' note before committing"
        )
        return 0

    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline:
        if Path(DEFAULT_BASELINE).exists():
            baseline_path = DEFAULT_BASELINE
    rc = 0
    if baseline_path and not args.no_baseline:
        try:
            data = baseline_mod.load(baseline_path)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        bad = baseline_mod.unreviewed(data)
        if bad:
            rc = 1
            for fp in bad:
                print(
                    f"baseline entry without a 'reviewed' note: {fp}",
                    file=sys.stderr,
                )
        new, stale = baseline_mod.apply(findings, data)
        for fp in stale:
            print(f"warning: stale baseline entry (no longer fires): {fp}")
        n_suppressed = len(findings) - len(new)
        findings = new
        if n_suppressed:
            print(
                f"{n_suppressed} finding(s) suppressed by {baseline_path}"
            )

    for f in findings:
        print(f.render())
    if findings:
        print(
            f"\n{len(findings)} new finding(s). Fix them, pragma them "
            "(# glom-lint: ok[checker] reason), or review them into the "
            "baseline (--write-baseline, then a 'reviewed' note each).",
            file=sys.stderr,
        )
        rc = 1
    else:
        print("glom-lint: clean")
    return rc


def _prune_baseline(args, findings) -> int:
    """--prune-baseline: drop suppressions that no longer fire. Dry run
    unless --apply; --apply rewrites the baseline and writes
    <baseline>.removed.json — the stamped record of what was dropped and
    why it was once accepted (the entries keep their reviewed notes)."""
    import datetime
    import json

    baseline_path = args.baseline or DEFAULT_BASELINE
    try:
        data = baseline_mod.load(baseline_path)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    pruned, removed = baseline_mod.prune(data, findings)
    if not removed:
        print(f"{baseline_path}: no stale entries — nothing to prune")
        return 0
    for fp in removed:
        print(f"stale: {fp}")
    if not args.apply:
        print(
            f"dry run: {len(removed)} stale entr"
            f"{'y' if len(removed) == 1 else 'ies'} in {baseline_path}; "
            "re-run with --apply to rewrite it"
        )
        return 0
    removal_list = {
        "pruned_at": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"
        ),
        "baseline": baseline_path,
        "removed": {
            fp: data.get("suppressions", {}).get(fp) for fp in removed
        },
    }
    Path(baseline_path).write_text(
        json.dumps(pruned, indent=2, sort_keys=True) + "\n"
    )
    removal_path = f"{baseline_path}.removed.json"
    Path(removal_path).write_text(
        json.dumps(removal_list, indent=2, sort_keys=True) + "\n"
    )
    print(
        f"pruned {len(removed)} entr{'y' if len(removed) == 1 else 'ies'} "
        f"from {baseline_path}; removal list stamped at {removal_path}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
