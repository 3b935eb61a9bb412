"""Per-file content-fingerprint cache for the whole-program pass.

The port's copy of `glom_tpu/analysis/cache.py`. The project graph made
every checker's result a function of MORE than its own file: lock-order
composes acquisition graphs from several classes' modules through typed
receivers, and signal-safety follows a handler's calls into a module's
imports. A naive mtime cache
would happily serve stale findings across any of those edges, so the
key here is structural:

    entry(file) valid  iff  sha256(file) unchanged
                        AND sha256 of every file in dep_closure(file)
                            unchanged (project.ProjectGraph.dep_closure:
                            the import closure of the whole importer
                            cone — both directions, transitively)
                        AND the context fingerprint unchanged (analyzer
                            version, active checker set, the analyzed
                            file SET itself — adding a file can create
                            new cross-module reach without editing any
                            existing one)

What is cached is the FINAL per-file result — pragma-filtered findings
plus the unused-pragma warnings — so a hit skips the checkers entirely.
Corruption is never silent: an unreadable/mismatched cache file prints a
loud warning to stderr and the run degrades to a full pass (then
rewrites the cache). `stats()` reports hits/misses for the CLI line CI's
cold+warm timing assertion greps.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from glom_tpu_torch.analysis.core import Checker, Context, Finding, SourceModule

CACHE_VERSION = 1

_FINDING_FIELDS = ("checker", "path", "line", "col", "message", "symbol", "key")


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


class AnalysisCache:
    """One --cache FILE: load on construction, consult per module during
    run(), write back on finish(). Deliberately inert when the run is
    partial (--select) — a partial pass must never overwrite full-pass
    entries."""

    def __init__(self, path: str):
        self.path = Path(path)
        self.enabled = True
        self.hits = 0
        self.misses = 0
        self.reused_files: List[str] = []
        self._old_entries: Dict[str, dict] = {}
        self._new_entries: Dict[str, dict] = {}
        self._dep_hash: Dict[str, str] = {}
        self._context_key = ""
        self._load_error: Optional[str] = None
        if self.path.exists():
            try:
                data = json.loads(self.path.read_text())
                if (
                    not isinstance(data, dict)
                    or data.get("version") != CACHE_VERSION
                    or not isinstance(data.get("entries"), dict)
                ):
                    raise ValueError("not a glom-lint cache (or wrong version)")
                self._old_entries = data["entries"]
                self._old_context = data.get("context", "")
            except (OSError, ValueError, json.JSONDecodeError) as e:
                self._load_error = str(e)
                self._old_entries = {}
                self._old_context = ""
                print(
                    f"warning: analysis cache {path} is unreadable ({e}) — "
                    "falling back to a FULL pass and rewriting it",
                    file=sys.stderr,
                )
        else:
            self._old_context = ""

    # -- run() hooks ----------------------------------------------------------

    def begin(
        self,
        ctx: Context,
        active: List[Checker],
        *,
        select=None,
    ) -> None:
        if select is not None:
            self.enabled = False
            return
        shas = {
            m.relpath: _sha(m.text) for m in ctx.modules
        }
        self._context_key = _sha(
            json.dumps(
                {
                    "cache_version": CACHE_VERSION,
                    "checkers": sorted(c.name for c in active),
                    "files": sorted(shas),  # the SET, not the contents
                },
                sort_keys=True,
            )
        )
        project = ctx.project
        for m in ctx.modules:
            closure = sorted(project.dep_closure(m.relpath))
            self._dep_hash[m.relpath] = _sha(
                json.dumps([[c, shas.get(c, "")] for c in closure])
            )
        if self._old_context != self._context_key:
            self._old_entries = {}

    def lookup(
        self, mod: SourceModule
    ) -> Optional[Tuple[List[Finding], List[str]]]:
        if not self.enabled:
            return None
        entry = self._old_entries.get(mod.relpath)
        dep = self._dep_hash.get(mod.relpath)
        if (
            entry is None
            or dep is None
            or entry.get("dep_hash") != dep
        ):
            self.misses += 1
            return None
        try:
            findings = [
                Finding(**{k: f[k] for k in _FINDING_FIELDS})
                for f in entry["findings"]
            ]
            warnings = [str(w) for w in entry.get("warnings", [])]
        except (KeyError, TypeError) as e:
            # A structurally-broken entry is corruption, not a miss to
            # hide: say so, re-analyze the file.
            print(
                f"warning: analysis cache entry for {mod.relpath} is "
                f"malformed ({e}) — re-analyzing",
                file=sys.stderr,
            )
            self.misses += 1
            return None
        self.hits += 1
        self.reused_files.append(mod.relpath)
        self._new_entries[mod.relpath] = entry
        return findings, warnings

    def store(
        self, mod: SourceModule, findings: List[Finding], warnings: List[str]
    ) -> None:
        if not self.enabled:
            return
        dep = self._dep_hash.get(mod.relpath)
        if dep is None:
            return
        self._new_entries[mod.relpath] = {
            "dep_hash": dep,
            "findings": [
                {k: getattr(f, k) for k in _FINDING_FIELDS} for f in findings
            ],
            "warnings": list(warnings),
        }

    def finish(self) -> None:
        if not self.enabled:
            return
        data = {
            "version": CACHE_VERSION,
            "context": self._context_key,
            "entries": self._new_entries,
        }
        try:
            self.path.write_text(json.dumps(data, sort_keys=True) + "\n")
        except OSError as e:  # pragma: no cover - disk-full/readonly paths
            print(
                f"warning: could not write analysis cache {self.path}: {e}",
                file=sys.stderr,
            )

    def stats(self) -> str:
        total = self.hits + self.misses
        kind = (
            "disabled (--select runs never cache)"
            if not self.enabled
            else "warm"
            if self.misses == 0 and total
            else "cold"
            if self.hits == 0
            else "mixed"
        )
        return f"cache: {self.hits}/{total} files reused ({kind})"
