"""project: the whole-program layer under the cross-module checkers.

The port's copy of `glom_tpu/analysis/project.py`. A checker that
analyzes ONE module at a time cannot see across an import boundary. This
module is the shared fix — a project graph over the ANALYZED paths
(whole-program means "whole analyzed set": lint one file and you get
exactly the old per-module pass):

  * module naming + import tables: each parsed file becomes a dotted
    module name (the longest identifier suffix of its relpath, so the
    same file resolves whether the pass runs from the repo root or over
    a tmp fixture dir); `import x.y as z`, `from x import y as z`, and
    `from pkg import submodule` all land in per-module alias tables;
  * cross-module symbol resolution with RE-EXPORT chasing: resolving
    `trace` through `utils/profiling.py` (a pure `from tracing.capture
    import trace` shim) lands on the defining module, bounded and
    cycle-guarded;
  * a cross-module call graph: `resolve_call` takes a Call node and
    returns the (module, FuncInfo) it names — lexical scope first (the
    old intra-module behavior, unchanged), then the import tables for
    bare `from x import f` names and dotted `mod.f` references; a
    reverse index (`callers_of`) gives every analyzed call site of a
    function (glom_tpu's axis-environment follows a mesh through it);
  * a light TYPE layer for first-order object references: parameter /
    return annotations (`-> Optional[ColumnCache]`), constructor calls,
    statement-order local flow, `self.attr` types inferred from
    `__init__`, and dict value types (`Dict[str, "PagedColumnPool"]`,
    `dict(pools)`, `self.pools[k]`) — enough to resolve the real
    batcher -> cache -> pool acquisition chain and the engine handle
    dispatched from the batcher, and nothing fancier: unresolvable
    stays None, the precision stance everywhere in this package.

Both directions of the import graph matter downstream: lock-order and
signal-safety facts flow from a module's IMPORTS (callee bodies), while
glom_tpu's axis-environment attestation flows from its IMPORTERS.
`dep_closure` therefore hashes a file together with the import closures of
its whole importer cone — the soundness contract the fingerprint cache
(analysis/cache.py) is built on. Pure stdlib.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from glom_tpu_torch.analysis.astutil import FuncInfo, call_name
from glom_tpu_torch.analysis.core import SourceModule

# Bound on cross-module hops (symbol re-export chains, caller recursion,
# call-graph reach). Deep enough for every real chain in the repo
# (runtime -> manual -> helper is 2), small enough that a pathological
# import cycle can't wedge the pass.
MAX_DEPTH = 6


def module_name_of(relpath: str) -> str:
    """Dotted module name from a '/'-separated relpath: the LONGEST
    trailing run of identifier-shaped parts, so
    'glom_tpu_torch/serve/engine.py' is 'glom_tpu_torch.serve.engine' from
    the repo root and a tmp-dir fixture
    ('/tmp/pytest-123/t0/xmod_util.py') still gets a resolvable suffix."""
    path = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = path.replace("\\", "/").split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    kept: List[str] = []
    for part in reversed(parts):
        if part.isidentifier():
            kept.append(part)
        else:
            break
    return ".".join(reversed(kept)) if kept else "<unnamed>"


@dataclass
class TypeRef:
    """A statically-inferred object type: `cls` is a class key
    ('module.name:ClassName'); `dict_value` is the class key of a dict's
    VALUE type (the `self.pools[engine]` shape). Exactly one is set."""

    cls: Optional[str] = None
    dict_value: Optional[str] = None


class ModuleInfo:
    """One module's name + import tables + top-level class table."""

    def __init__(self, module: SourceModule):
        self.module = module
        self.name = module_name_of(module.relpath)
        # local alias -> module name as written ('import x.y as z')
        self.module_aliases: Dict[str, str] = {}
        # local name -> (module as written, original symbol)
        self.symbol_imports: Dict[str, Tuple[str, str]] = {}
        self.classes: Dict[str, ast.ClassDef] = {
            n.name: n
            for n in module.tree.body
            if isinstance(n, ast.ClassDef)
        }
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.module_aliases[a.asname or a.name] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                # Relative imports (level > 0) don't occur in this repo;
                # treating them as opaque keeps resolution honest.
                if node.level:
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.symbol_imports[a.asname or a.name] = (
                        node.module,
                        a.name,
                    )


class ProjectGraph:
    """Whole-program tables over the analyzed modules. Built once per
    run (core.run) and shared through Context.project."""

    def __init__(self, modules: List[SourceModule]):
        self.infos: Dict[str, ModuleInfo] = {}
        self.by_name: Dict[str, ModuleInfo] = {}
        for m in modules:
            info = ModuleInfo(m)
            self.infos[m.relpath] = info
            self.by_name.setdefault(info.name, info)
        self._imports: Dict[str, Set[str]] = {}
        self._importers: Dict[str, Set[str]] = {}
        self._build_import_edges()
        self._callers: Optional[Dict[int, List[Tuple[ModuleInfo, Optional[FuncInfo], ast.Call]]]] = None

    # -- module resolution ---------------------------------------------------

    def info_of(self, module: SourceModule) -> ModuleInfo:
        return self.infos[module.relpath]

    def resolve_module_name(self, written: str) -> Optional[ModuleInfo]:
        """Analyzed module for an import name as written. Exact dotted
        match first; else a unique suffix match in either direction (the
        analyzed names carry tmp-dir prefixes, or the written name
        carries package parts the analyzed root stripped). Ambiguity
        resolves to None — never guess."""
        info = self.by_name.get(written)
        if info is not None:
            return info
        cands = [
            i
            for i in self.by_name.values()
            if i.name.endswith("." + written) or written.endswith("." + i.name)
        ]
        return cands[0] if len(cands) == 1 else None

    # -- import graph --------------------------------------------------------

    def _build_import_edges(self) -> None:
        for rel, info in self.infos.items():
            edges: Set[str] = set()
            for written in info.module_aliases.values():
                target = self.resolve_module_name(written)
                if target is not None:
                    edges.add(target.module.relpath)
            for mod_written, sym in info.symbol_imports.values():
                target = self.resolve_module_name(mod_written)
                if target is None:
                    # `from pkg import submodule`
                    target = self.resolve_module_name(f"{mod_written}.{sym}")
                if target is not None:
                    edges.add(target.module.relpath)
            edges.discard(rel)
            self._imports[rel] = edges
            for e in edges:
                self._importers.setdefault(e, set()).add(rel)

    def imports_of(self, relpath: str) -> Set[str]:
        return self._imports.get(relpath, set())

    def importers_of(self, relpath: str) -> Set[str]:
        return self._importers.get(relpath, set())

    def _transitive(self, start: str, edges: Dict[str, Set[str]]) -> Set[str]:
        seen = {start}
        frontier = [start]
        while frontier:
            n = frontier.pop()
            for nxt in edges.get(n, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return seen

    def dep_closure(self, relpath: str) -> Set[str]:
        """Every analyzed file whose content can influence THIS file's
        findings: the import closure of every module in this file's
        importer cone (itself included). Downstream facts (purity
        reachability, donation handles, lock acquisitions) flow along
        imports; attestation (axis-environment) flows from importers —
        and an importer's OWN resolution context is its import closure,
        hence the composed shape. This is the cache's soundness
        contract (analysis/cache.py)."""
        out: Set[str] = set()
        for up in self._transitive(relpath, self._importers):
            out |= self._transitive(up, self._imports)
        return out

    # -- symbol / function / class resolution --------------------------------

    def resolve_symbol(
        self, info: ModuleInfo, symbol: str, depth: int = MAX_DEPTH
    ) -> Optional[Tuple[ModuleInfo, str]]:
        """(defining module, name) for a top-level function/class symbol,
        chasing `from x import y [as z]` re-export shims (the
        utils/profiling.py shape), bounded and cycle-guarded."""
        seen: Set[Tuple[str, str]] = set()
        while depth > 0:
            key = (info.module.relpath, symbol)
            if key in seen:
                return None
            seen.add(key)
            if (
                symbol in info.module.index.module_scope.functions
                or symbol in info.classes
            ):
                return (info, symbol)
            imp = info.symbol_imports.get(symbol)
            if imp is None:
                return None
            target = self.resolve_module_name(imp[0])
            if target is None:
                return None
            info, symbol = target, imp[1]
            depth -= 1
        return None

    def resolve_function(
        self, module: SourceModule, dotted_name: str
    ) -> Optional[Tuple[ModuleInfo, FuncInfo]]:
        """(module, FuncInfo) for a bare imported name ('helper') or a
        module-qualified reference ('counters.timed_collective',
        'glom_tpu_torch.tracing.capture.trace'); None for anything it cannot
        prove — locals, methods, third-party namespaces."""
        info = self.infos.get(module.relpath)
        if info is None:
            return None
        parts = dotted_name.split(".")
        if len(parts) == 1:
            resolved = self.resolve_symbol(info, parts[0])
        else:
            resolved = self._resolve_qualified(info, parts)
        if resolved is None:
            return None
        target, symbol = resolved
        fn = target.module.index.module_scope.functions.get(symbol)
        return (target, fn) if fn is not None else None

    def resolve_class(
        self, module: SourceModule, dotted_name: str
    ) -> Optional[Tuple[ModuleInfo, ast.ClassDef]]:
        info = self.infos.get(module.relpath)
        if info is None:
            return None
        parts = dotted_name.split(".")
        if len(parts) == 1:
            resolved = self.resolve_symbol(info, parts[0])
        else:
            resolved = self._resolve_qualified(info, parts)
        if resolved is None:
            return None
        target, symbol = resolved
        cls = target.classes.get(symbol)
        return (target, cls) if cls is not None else None

    def class_key(self, info: ModuleInfo, cls_name: str) -> str:
        return f"{info.name}:{cls_name}"

    def _resolve_qualified(
        self, info: ModuleInfo, parts: List[str]
    ) -> Optional[Tuple[ModuleInfo, str]]:
        """'alias[.sub...].symbol' through the module-alias table
        (longest alias prefix wins), or `from pkg import submod` +
        'submod.symbol'."""
        for i in range(len(parts) - 1, 0, -1):
            prefix = ".".join(parts[:i])
            written = info.module_aliases.get(prefix)
            if written is None and i == 1:
                imp = info.symbol_imports.get(parts[0])
                if imp is not None:
                    written = f"{imp[0]}.{imp[1]}"
            if written is None:
                continue
            rest = parts[i:]
            # the tail may cross submodules: alias='glom_tpu_torch', rest =
            # ['telemetry', 'counters', 'record_collective']
            for j in range(len(rest) - 1, -1, -1):
                mod_written = ".".join([written] + rest[:j])
                target = self.resolve_module_name(mod_written)
                if target is not None and j == len(rest) - 1:
                    return self.resolve_symbol(target, rest[-1])
            return None
        return None

    # -- cross-module call graph ---------------------------------------------

    def resolve_call(
        self,
        module: SourceModule,
        caller: Optional[FuncInfo],
        call: ast.Call,
    ) -> Optional[Tuple[ModuleInfo, FuncInfo]]:
        """The analyzed function a Call names: lexical scope first (the
        unchanged intra-module rule), then the import tables."""
        name = call_name(call)
        if not name:
            return None
        if "." not in name:
            scope = (
                caller.scope if caller is not None else module.index.module_scope
            )
            intra = scope.resolve(name)
            if intra is not None:
                return (self.info_of(module), intra)
        if name.startswith("self."):
            return None  # method dispatch is the type layer's job
        return self.resolve_function(module, name)

    def callers_of(
        self, target: FuncInfo
    ) -> List[Tuple[ModuleInfo, Optional[FuncInfo], ast.Call]]:
        """Every analyzed call site resolving to `target`: (module,
        enclosing function or None for module level, the Call node)."""
        if self._callers is None:
            self._callers = {}
            for info in self.infos.values():
                mod = info.module
                for finfo in mod.index.functions.values():
                    for node in finfo.body_nodes():
                        if isinstance(node, ast.Call):
                            hit = self.resolve_call(mod, finfo, node)
                            if hit is not None:
                                self._callers.setdefault(
                                    id(hit[1].node), []
                                ).append((info, finfo, node))
                for node in self._module_level_nodes(mod):
                    if isinstance(node, ast.Call):
                        hit = self.resolve_call(mod, None, node)
                        if hit is not None:
                            self._callers.setdefault(
                                id(hit[1].node), []
                            ).append((info, None, node))
        return self._callers.get(id(target.node), [])

    @staticmethod
    def _module_level_nodes(mod: SourceModule):
        from glom_tpu_torch.analysis.astutil import SCOPE_NODES

        stack: List[ast.AST] = list(mod.tree.body)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, SCOPE_NODES):
                continue  # function/lambda bodies belong to their FuncInfo
            for child in ast.iter_child_nodes(node):
                stack.append(child)

    # -- the type layer -------------------------------------------------------

    def annotation_type(
        self, info: ModuleInfo, ann: Optional[ast.AST], depth: int = MAX_DEPTH
    ) -> Optional[TypeRef]:
        """TypeRef for an annotation expression: bare/imported class
        names, 'StringForward' constants, Optional/Final unwrap, Union
        with a single class member, Dict[...] value types."""
        if ann is None or depth <= 0:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
            return self.annotation_type(info, ann, depth - 1)
        if isinstance(ann, (ast.Name, ast.Attribute)):
            name = call_name(ast.Call(func=ann, args=[], keywords=[]))
            if name is None:
                return None
            hit = self.resolve_class(info.module, name)
            if hit is not None:
                return TypeRef(cls=self.class_key(hit[0], hit[1].name))
            return None
        if isinstance(ann, ast.Subscript):
            base = ann.value
            base_name = (
                base.attr if isinstance(base, ast.Attribute) else
                base.id if isinstance(base, ast.Name) else None
            )
            if base_name in ("Optional", "Final", "Annotated"):
                inner = ann.slice
                if base_name == "Annotated" and isinstance(inner, ast.Tuple):
                    inner = inner.elts[0] if inner.elts else None
                return self.annotation_type(info, inner, depth - 1)
            if base_name in ("Dict", "dict", "Mapping", "MutableMapping"):
                if isinstance(ann.slice, ast.Tuple) and len(ann.slice.elts) == 2:
                    value = self.annotation_type(
                        info, ann.slice.elts[1], depth - 1
                    )
                    if value is not None and value.cls is not None:
                        return TypeRef(dict_value=value.cls)
                return None
            if base_name == "Union":
                members = (
                    ann.slice.elts
                    if isinstance(ann.slice, ast.Tuple)
                    else [ann.slice]
                )
                hits = [
                    t
                    for t in (
                        self.annotation_type(info, m, depth - 1)
                        for m in members
                    )
                    if t is not None
                ]
                return hits[0] if len(hits) == 1 else None
        return None

    def expr_type(
        self,
        info: ModuleInfo,
        expr: Optional[ast.AST],
        local_types: Dict[str, TypeRef],
        depth: int = MAX_DEPTH,
    ) -> Optional[TypeRef]:
        """TypeRef of an expression under `local_types` (name -> type):
        constructor calls, calls of functions with class-resolving return
        annotations, `dict(x)` passthrough, conditional expressions with
        agreeing arms, `x[k]` on a dict-typed name."""
        if expr is None or depth <= 0:
            return None
        if isinstance(expr, ast.Name):
            return local_types.get(expr.id)
        if isinstance(expr, ast.IfExp):
            arms = [
                self.expr_type(info, a, local_types, depth - 1)
                for a in (expr.body, expr.orelse)
            ]
            arms = [a for a in arms if a is not None]
            if len(arms) == 1 or (len(arms) == 2 and arms[0] == arms[1]):
                return arms[0]
            return None
        if isinstance(expr, ast.BoolOp):
            arms = [
                self.expr_type(info, v, local_types, depth - 1)
                for v in expr.values
            ]
            arms = [a for a in arms if a is not None]
            return arms[0] if len(arms) == 1 else None
        if isinstance(expr, ast.Subscript):
            base = self.expr_type(info, expr.value, local_types, depth - 1)
            if base is not None and base.dict_value is not None:
                return TypeRef(cls=base.dict_value)
            return None
        if isinstance(expr, ast.Call):
            name = call_name(expr)
            if name is None:
                return None
            if name.split(".")[-1] == "dict" and len(expr.args) == 1:
                inner = self.expr_type(
                    info, expr.args[0], local_types, depth - 1
                )
                if inner is not None and inner.dict_value is not None:
                    return inner
                return None
            hit = self.resolve_class(info.module, name)
            if hit is not None:
                return TypeRef(cls=self.class_key(hit[0], hit[1].name))
            fn = self.resolve_function(info.module, name)
            if fn is not None:
                target_info, finfo = fn
                returns = getattr(finfo.node, "returns", None)
                return self.annotation_type(target_info, returns, depth - 1)
        return None

    def function_local_types(
        self, info: ModuleInfo, finfo: FuncInfo
    ) -> Dict[str, TypeRef]:
        """name -> TypeRef after one statement-order pass over a
        function: annotated parameters seed the map; assignments update
        it (unresolvable right-hand sides CLEAR the name — a rebind to
        an unknown must not keep the stale type)."""
        types: Dict[str, TypeRef] = {}
        node = finfo.node
        args = getattr(node, "args", None)
        if args is not None:
            for p in args.posonlyargs + args.args + args.kwonlyargs:
                t = self.annotation_type(info, p.annotation)
                if t is not None:
                    types[p.arg] = t
        stmts = [
            n
            for n in finfo.body_nodes()
            if isinstance(n, (ast.Assign, ast.AnnAssign))
        ]
        stmts.sort(key=lambda n: getattr(n, "lineno", 0))
        for stmt in stmts:
            if isinstance(stmt, ast.AnnAssign):
                targets = [stmt.target]
                t = self.annotation_type(info, stmt.annotation)
                if t is None:
                    t = self.expr_type(info, stmt.value, types)
            else:
                targets = stmt.targets
                t = self.expr_type(info, stmt.value, types)
            for target in targets:
                if isinstance(target, ast.Name):
                    if t is not None:
                        types[target.id] = t
                    else:
                        types.pop(target.id, None)
        return types

    def class_attr_types(
        self, info: ModuleInfo, cls: ast.ClassDef
    ) -> Dict[str, TypeRef]:
        """attr -> TypeRef for `self.attr = ...` assignments in
        __init__, with the ctor's annotated parameters and local flow in
        scope (the `self.cache = column_cache` shape, where
        column_cache was rebound from an annotated provider)."""
        init = next(
            (
                n
                for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__"
            ),
            None,
        )
        if init is None:
            return {}
        finfo = info.module.index.info_for(init)
        if finfo is None:
            return {}
        local_types = self.function_local_types(info, finfo)
        out: Dict[str, TypeRef] = {}
        stmts = [
            n for n in finfo.body_nodes() if isinstance(n, (ast.Assign, ast.AnnAssign))
        ]
        stmts.sort(key=lambda n: getattr(n, "lineno", 0))
        for stmt in stmts:
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            )
            for target in targets:
                if (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    t = None
                    if isinstance(stmt, ast.AnnAssign):
                        t = self.annotation_type(info, stmt.annotation)
                    if t is None:
                        t = self.expr_type(info, stmt.value, local_types)
                    if t is not None:
                        out.setdefault(target.attr, t)
        return out

    def receiver_resolver(self, module: SourceModule, finfo: FuncInfo):
        """A callable mapping a RECEIVER expression inside `finfo` to its
        TypeRef: annotated params and local flow, `self` as the enclosing
        class, typed `self.attr` from `__init__`, and dict subscripts
        (`self.pools[k]`). The shared resolution step under the
        cross-object donation and lock-order analyses."""
        minfo = self.info_of(module)
        local_types = self.function_local_types(minfo, finfo)
        own_cls = self.enclosing_class(module, finfo)
        self_types = (
            self.class_attr_types(minfo, own_cls)
            if own_cls is not None
            else {}
        )
        if own_cls is not None:
            local_types.setdefault(
                "self", TypeRef(cls=self.class_key(minfo, own_cls.name))
            )

        def rtype(expr: ast.AST) -> Optional[TypeRef]:
            t = self.expr_type(minfo, expr, local_types)
            if t is not None:
                return t
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
            ):
                return self_types.get(expr.attr)
            if isinstance(expr, ast.Subscript):
                base = rtype(expr.value)
                if base is not None and base.dict_value is not None:
                    return TypeRef(cls=base.dict_value)
            return None

        return rtype

    def enclosing_class(
        self, module: SourceModule, finfo: FuncInfo
    ) -> Optional[ast.ClassDef]:
        """The TOP-LEVEL class a function belongs to (methods and their
        nested defs — the qualname prefix), or None."""
        head = finfo.qualname.split(".")[0]
        info = self.infos.get(module.relpath)
        if info is None:
            return None
        return info.classes.get(head)
