"""glom-lint core: findings, parsed modules, pragmas, and the run engine.

The port's copy of `glom_tpu/analysis/core.py`. Pure stdlib (the pass reads
source only, so it runs before anything touches a device), every finding
machine-readable, and suppression is an AUDITED act — either an inline
pragma carrying a reason, or an entry in the reviewed baseline file
(`glom_tpu_torch/analysis_baseline.json`). Checkers are small classes over
`SourceModule`s; `run()` wires them together and applies the pragma
filter. Exit-code policy lives in __main__.

Pragma syntax (the reason is mandatory — an unexplained suppression is
itself a finding):

    self._err = e  # glom-lint: ok[lockset] read only after join()

    # glom-lint: ok[lockset] written before the thread starts
    self._x = None

A pragma on its own line suppresses the NEXT line; a trailing pragma
suppresses its own line. `ok[*]` suppresses every checker on that line.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from glom_tpu_torch.analysis.astutil import ModuleIndex, build_parent_map

_PRAGMA_RE = re.compile(r"#\s*glom-lint:\s*ok\[([\w*,\- ]+)\]\s*(.*)")


@dataclass
class Finding:
    """One violation. `key` is the rule-stable part of the fingerprint
    (no line numbers — baselines must survive unrelated edits above the
    site); `symbol` is the enclosing function qualname."""

    checker: str
    path: str  # repo-relative, '/'-separated
    line: int
    col: int
    message: str
    symbol: str = "<module>"
    key: str = ""

    @property
    def fingerprint(self) -> str:
        return f"{self.checker}::{self.path}::{self.symbol}::{self.key or self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.checker}] {self.message}"


@dataclass
class Pragma:
    line: int
    checkers: Set[str]
    reason: str
    own_line: bool  # comment-only line: applies to the NEXT line
    used: bool = False


class SourceModule:
    """One parsed file: AST + parents + scope index + pragmas."""

    def __init__(self, path: Path, relpath: str, text: str):
        self.path = path
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text)
        self.parents = build_parent_map(self.tree)
        self.index = ModuleIndex(self.tree)
        self.pragmas: List[Pragma] = self._parse_pragmas()

    def _parse_pragmas(self) -> List[Pragma]:
        """Pragmas come from REAL comment tokens only — a pragma-shaped
        string inside a docstring (this framework documents its own
        syntax) must not register as a live suppression."""
        out = []
        try:
            tokens = list(
                tokenize.generate_tokens(io.StringIO(self.text).readline)
            )
        except (tokenize.TokenError, IndentationError):  # pragma: no cover
            return out  # ast.parse succeeded, so this is near-unreachable
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if not m:
                continue
            i = tok.start[0]
            checkers = {c.strip() for c in m.group(1).split(",") if c.strip()}
            out.append(
                Pragma(
                    line=i,
                    checkers=checkers,
                    reason=m.group(2).strip(),
                    own_line=self.lines[i - 1].strip().startswith("#"),
                )
            )
        return out

    def suppressed(self, finding: Finding) -> bool:
        for p in self.pragmas:
            target = p.line + 1 if p.own_line else p.line
            if finding.line == target and (
                "*" in p.checkers or finding.checker in p.checkers
            ):
                p.used = True
                return True
        return False


@dataclass
class Context:
    """Cross-module facts the checkers share (built once per run)."""

    modules: List[SourceModule] = field(default_factory=list)
    # The whole-program layer (analysis/project.py): import graph,
    # cross-module symbol/call resolution, the type layer. Built once in
    # run() over the analyzed set; checkers that compute project-wide
    # results cache them keyed by id(self) (one Context = one run).
    project: Optional[object] = None
    # Scratch channel for project-wide per-checker caches and the
    # evidence the tests read (the lock-order acquisition edges, the
    # axis-environment attestation trail).
    scratch: dict = field(default_factory=dict)
    # Mesh-axis vocabulary: values of module-level *_AXIS string constants
    # across the scanned tree, plus the MeshConfig.axis_names convention.
    axis_vocab: Set[str] = field(default_factory=lambda: {"data", "seq", "model"})
    # Modules (matched by relpath suffix) where every wire-moving
    # collective must be registered with telemetry.counters.
    registration_modules: Sequence[str] = (
        "parallel/manual.py",
        "parallel/quantized.py",
        "parallel/serve_mesh.py",
    )
    # kind registry for the schema-emit checker (filled by the checker on
    # first use: schema.py import, else AST fallback).
    kinds: Optional[Set[str]] = None


class Checker:
    """Base: subclasses set `name` and implement check(module, ctx)."""

    name = "base"
    description = ""

    def check(self, module: SourceModule, ctx: Context) -> List[Finding]:
        raise NotImplementedError


def collect_files(paths: Iterable[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(
                f
                for f in sorted(path.rglob("*.py"))
                if "__pycache__" not in f.parts
            )
        elif path.suffix == ".py":
            files.append(path)
    return files


def _relpath(path: Path) -> str:
    try:
        rel = path.resolve().relative_to(Path.cwd())
    except ValueError:
        rel = path
    return str(rel).replace("\\", "/")


def load_modules(
    paths: Iterable[str],
) -> Tuple[List[SourceModule], List[Finding]]:
    modules, errors = [], []
    for f in collect_files(paths):
        rel = _relpath(f)
        try:
            text = f.read_text()
            modules.append(SourceModule(f, rel, text))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            lineno = getattr(e, "lineno", 0) or 0
            errors.append(
                Finding(
                    checker="parse",
                    path=rel,
                    line=lineno,
                    col=0,
                    message=f"cannot parse: {e}",
                    key="parse-error",
                )
            )
    return modules, errors


def _collect_axis_vocab(modules: List[SourceModule], ctx: Context) -> None:
    for mod in modules:
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                if (
                    isinstance(target, ast.Name)
                    and target.id.endswith("_AXIS")
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)
                ):
                    ctx.axis_vocab.add(node.value.value)


def default_checkers() -> List[Checker]:
    from glom_tpu_torch.analysis.axisenv import AxisEnvironment
    from glom_tpu_torch.analysis.collectives import CollectiveCoverage
    from glom_tpu_torch.analysis.donation import DonationSafety
    from glom_tpu_torch.analysis.lockset import LockOrder, Lockset
    from glom_tpu_torch.analysis.purity import TracePurity
    from glom_tpu_torch.analysis.schema_emit import SchemaEmit
    from glom_tpu_torch.analysis.sighandler import SignalSafety

    return [
        CollectiveCoverage(),
        AxisEnvironment(),
        TracePurity(),
        DonationSafety(),
        SchemaEmit(),
        Lockset(),
        LockOrder(),
        SignalSafety(),
    ]


def run(
    paths: Iterable[str],
    *,
    select: Optional[Iterable[str]] = None,
    checkers: Optional[List[Checker]] = None,
    warnings: Optional[List[str]] = None,
    cache: Optional[object] = None,
    scratch: Optional[dict] = None,
) -> List[Finding]:
    """Run the pass; returns findings NOT suppressed by inline pragmas
    (baseline filtering is the caller's job — see baseline.apply).
    Includes a framework finding for any pragma without a reason, and for
    unparseable files. When `warnings` is given (and every checker ran —
    a partial --select can't judge), pragmas that suppressed nothing are
    reported into it so fixed-and-forgotten suppressions rot visibly,
    mirroring the baseline's stale-entry warnings.

    `cache` is an analysis/cache.py AnalysisCache: every file is still
    PARSED (the project graph needs the whole analyzed set), but files
    whose content-fingerprint closure is unchanged reuse their stored
    findings/warnings instead of re-running the checkers.

    `scratch`, when given, is used as the Context's scratch dict so
    callers (tests, tooling) can inspect the project-wide evidence the
    checkers record there — the lock-order acquisition edges, the
    axis-environment attestation trail."""
    from glom_tpu_torch.analysis.project import ProjectGraph

    modules, findings = load_modules(paths)
    ctx = Context(modules=modules)
    if scratch is not None:
        ctx.scratch = scratch
    ctx.project = ProjectGraph(modules)
    _collect_axis_vocab(modules, ctx)
    active = checkers if checkers is not None else default_checkers()
    if select is not None:
        wanted = set(select)
        unknown = wanted - {c.name for c in active}
        if unknown:
            raise ValueError(f"unknown checkers: {sorted(unknown)}")
        active = [c for c in active if c.name in wanted]
    if cache is not None:
        cache.begin(ctx, active, select=select)
    for mod in modules:
        if cache is not None:
            hit = cache.lookup(mod)
            if hit is not None:
                mod_findings, mod_warnings = hit
                findings.extend(mod_findings)
                if warnings is not None:
                    warnings.extend(mod_warnings)
                continue
        mod_findings: List[Finding] = []
        mod_warnings: List[str] = []
        for checker in active:
            for f in checker.check(mod, ctx):
                if not mod.suppressed(f):
                    mod_findings.append(f)
        for p in mod.pragmas:
            if not p.reason:
                mod_findings.append(
                    Finding(
                        checker="pragma",
                        path=mod.relpath,
                        line=p.line,
                        col=0,
                        message="suppression without a reason (pragmas are "
                        "reviewed artifacts: say WHY the site is ok)",
                        key="missing-reason",
                    )
                )
            elif select is None and not p.used:
                mod_warnings.append(
                    f"{mod.relpath}:{p.line}: unused pragma "
                    f"ok[{','.join(sorted(p.checkers))}] — the finding it "
                    "suppressed no longer fires; delete it"
                )
        findings.extend(mod_findings)
        if warnings is not None:
            warnings.extend(mod_warnings)
        if cache is not None:
            cache.store(mod, mod_findings, mod_warnings)
    if cache is not None:
        cache.finish()
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.checker))
    return findings
