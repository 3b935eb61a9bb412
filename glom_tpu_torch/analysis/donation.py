"""donation-safety: no dispatch reads the page pool through an unpinned
snapshot.

The torch form of `glom_tpu/analysis/donation.py`, which has two halves.

What has no torch counterpart: glom_tpu's use-after-donation rules.
`jax.jit(..., donate_argnums=...)` lets XLA reuse an input's buffer for an
output, so the caller's array is dead once the dispatch is enqueued, and
glom_tpu flags a later read of it — through local jit handles, the
`.lower().compile()` chain, memoized handles behind provider methods and
typed receivers, and a `*`-splat at a donating call
(`splat-at-donating-call`). Eager PyTorch donates no buffer: a tensor
passed to a function stays valid, and the port resolves
`ServeConfig.donate` to False with a warning (serve/engine.py). So none
of those rules is carried over.

What carries over: the aliased-pool pinning rule (`alias-unpinned-
dispatch`). With `ServeConfig.pool_aliasing` the pool's write-back writes
pool pages IN PLACE (serve/paged_columns.py), so a dispatch still reading
the buffer must hold a read pin — `PagedColumnPool.acquire_read()` /
`release_read()` — which sends the write-back onto its copy-on-write
fallback for the dispatch's lifetime. `pool.buffer()` returns an UNPINNED
snapshot whose pages an in-place write-back can change mid-dispatch. The
static form: a value obtained from a bare `.buffer()` call that reaches a
dispatch is a finding. A dispatch is any use other than a metadata read
(`.dtype`, `.shape`, `.device`, `.size()`, ...): an argument of a call
(a kernel wrapper, a forward), a subscript, or a method call on it. The
value is tracked through:

  * local names, in statement order — the latest binding decides, so a
    rebind through `acquire_read()` (whose value this rule deliberately
    does not taint) before the dispatch clears the hazard;
  * PROVIDER METHODS — methods that return a bare `.buffer()` value
    (directly or through a local), so `buf = self.snapshot()` taints
    `buf` in the same class;
  * typed receivers across modules (the project graph's type layer): a
    provider of a class defined in another analyzed module, called on an
    annotated parameter, a constructor result or a typed `self.attr`
    (`buf = eng.snapshot()` where `eng: Engine`).

Kernel scratch gets no rule: the port's kernel wrappers allocate their
scratch per call and hold it until the launch is enqueued, and glom_tpu's
checker has none.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from glom_tpu_torch.analysis.astutil import FuncInfo, dotted
from glom_tpu_torch.analysis.core import Checker, Context, Finding, SourceModule
from glom_tpu_torch.analysis.purity import METADATA_ATTRS


def _method_class(info: FuncInfo) -> Optional[str]:
    """The class name when `info` is a method (qualname 'Cls.method',
    first parameter 'self'); None otherwise."""
    parts = info.qualname.split(".")
    if len(parts) < 2:
        return None
    params = info.params
    if not params or params[0] != "self":
        return None
    return parts[-2]


def _is_bare_buffer(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "buffer"
    )


def _ordered(nodes) -> List[ast.AST]:
    return sorted(nodes, key=lambda n: getattr(n, "lineno", 0))


class DonationSafety(Checker):
    name = "donation-safety"
    description = "no dispatch reads the page pool through an unpinned buffer()"

    def check(self, module: SourceModule, ctx: Context) -> List[Finding]:
        providers = self._providers(module)
        xproviders = self._project_tables(ctx)
        findings: List[Finding] = []
        for info in module.index.functions.values():
            findings.extend(
                self._check_function(
                    module, info, providers, ctx.project, xproviders
                )
            )
        findings.sort(key=lambda f: (f.line, f.col))
        return findings

    def _project_tables(self, ctx: Context) -> Set[Tuple[str, str]]:
        """(class_key, method) for every provider over the analyzed
        modules, computed once per run — the cross-module half."""
        key = "donation-safety:providers"
        if key in ctx.scratch:
            return ctx.scratch[key]
        xproviders: Set[Tuple[str, str]] = set()
        project = ctx.project
        if project is not None:
            for mod in ctx.modules:
                minfo = project.info_of(mod)
                for cls, meth in self._providers(mod):
                    if cls in minfo.classes:
                        xproviders.add((project.class_key(minfo, cls), meth))
        ctx.scratch[key] = xproviders
        return xproviders

    def _providers(self, module: SourceModule) -> Set[Tuple[str, str]]:
        """(class, method) for methods that RETURN a bare buffer() value
        (directly, or a local bound from one and not rebound since)."""
        providers: Set[Tuple[str, str]] = set()
        for info in module.index.functions.values():
            cls = _method_class(info)
            if cls is None:
                continue
            bare: Dict[str, bool] = {}
            for stmt in _ordered(
                n
                for n in info.body_nodes()
                if isinstance(n, (ast.Assign, ast.Return))
            ):
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            bare[t.id] = _is_bare_buffer(stmt.value)
                    continue
                value = stmt.value
                if _is_bare_buffer(value) or (
                    isinstance(value, ast.Name) and bare.get(value.id)
                ):
                    providers.add((cls, info.qualname.split(".")[-1]))
        return providers

    def _unpinned(self, value, cls, providers, rtype, xproviders) -> Optional[str]:
        """What makes `value` an unpinned snapshot ('buffer()', or the
        provider call), or None."""
        if _is_bare_buffer(value):
            return "buffer()"
        if not (isinstance(value, ast.Call) and isinstance(value.func, ast.Attribute)):
            return None
        recv, meth = value.func.value, value.func.attr
        if (
            cls is not None
            and isinstance(recv, ast.Name)
            and recv.id == "self"
            and (cls, meth) in providers
        ):
            return f"self.{meth}()"
        if rtype is not None:
            t = rtype(recv)
            if t is not None and t.cls is not None and (t.cls, meth) in xproviders:
                return f"{dotted(value.func) or meth}()"
        return None

    def _check_function(
        self, module, info, providers, project, xproviders
    ) -> List[Finding]:
        cls = _method_class(info)
        rtype = None
        if project is not None and xproviders:
            rtype = project.receiver_resolver(module, info)
        parents = module.parents
        # Lines where a name was bound from an unpinned snapshot (and what
        # made it one), compared against the LATEST binding at each
        # dispatch, so a rebind through acquire_read() clears the hazard.
        snap_lines: Dict[str, Dict[int, str]] = {}
        rebinds: Dict[str, List[int]] = {}
        nodes = list(info.body_nodes())
        for node in nodes:
            if isinstance(node, ast.Assign):
                what = self._unpinned(node.value, cls, providers, rtype, xproviders)
                if what is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            snap_lines.setdefault(t.id, {})[node.lineno] = what
            elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                rebinds.setdefault(node.id, []).append(node.lineno)
        findings: List[Finding] = []

        def add(site, node, what: str) -> None:
            findings.append(
                Finding(
                    checker=self.name,
                    path=module.relpath,
                    line=site.lineno,
                    col=node.col_offset,
                    message=(
                        f"{what}, an unpinned pool snapshot, reaches a "
                        f"dispatch ({self._describe(site)}) without a read "
                        "pin — under pool aliasing an in-place write-back "
                        "can change its pages mid-dispatch; take it "
                        "through acquire_read()/release_read() so the "
                        "write-back falls back to copy-on-write"
                    ),
                    symbol=info.qualname,
                    key="alias-unpinned-dispatch",
                )
            )

        for node in nodes:
            if isinstance(node, ast.Call):
                # an inline snapshot handed straight to a dispatch
                what = self._unpinned(node, cls, providers, rtype, xproviders)
                site = self._dispatch_site(node, parents) if what else None
                if site is not None:
                    add(site, node, what)
            elif (
                isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and node.id in snap_lines
            ):
                site = self._dispatch_site(node, parents)
                if site is None:
                    continue
                binds = [r for r in rebinds.get(node.id, []) if r <= site.lineno]
                what = snap_lines[node.id].get(max(binds)) if binds else None
                if what is not None:
                    add(site, node, f"{node.id!r} (from {what})")
        return findings

    @staticmethod
    def _dispatch_site(node: ast.AST, parents) -> Optional[ast.AST]:
        """The call or subscript that dispatches on `node`'s value, or None
        for a metadata read or a plain binding/return of it."""
        parent = parents.get(id(node))
        if isinstance(parent, ast.Starred):
            node, parent = parent, parents.get(id(parent))
        if isinstance(parent, ast.keyword):
            node, parent = parent, parents.get(id(parent))
        if isinstance(parent, ast.Call) and parent.func is not node:
            return parent
        if isinstance(parent, ast.Subscript) and parent.value is node:
            return parent
        if isinstance(parent, ast.Attribute) and parent.attr not in METADATA_ATTRS:
            grand = parents.get(id(parent))
            if isinstance(grand, ast.Call) and grand.func is parent:
                return grand
        return None

    @staticmethod
    def _describe(site: ast.AST) -> str:
        if isinstance(site, ast.Subscript):
            return "a subscript"
        return f"{dotted(site.func) or 'a call'}(...)"
