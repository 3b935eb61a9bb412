"""Shared AST plumbing for the glom-lint checkers.

The port's copy of `glom_tpu/analysis/astutil.py`, with the import table
the collective checkers read in torch form (`imported_collective_aliases`
names the port's `parallel.collectives` and `torch.distributed`, where
glom_tpu's names `jax.lax`). Everything here is deliberately SIMPLE static
analysis: lexical scope chains, dotted-name rendering, statement-order
walks. The checkers trade soundness for zero-dependency CPU-cheap checks
that run before a card is touched — a miss is acceptable, a crash is not.
Pure stdlib.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional

FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
SCOPE_NODES = FUNC_NODES + (ast.Lambda,)


def dotted(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as 'a.b.c'; None for anything with a
    non-name root (calls, subscripts)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class Scope:
    """One lexical scope (module or function) with its directly-defined
    functions; `resolve` walks the chain outward, so a nested body can
    call a sibling nested def or a module-level helper and the checkers
    follow it."""

    def __init__(self, node: ast.AST, parent: Optional["Scope"], qualname: str):
        self.node = node
        self.parent = parent
        self.qualname = qualname
        self.functions: Dict[str, "FuncInfo"] = {}

    def resolve(self, name: str) -> Optional["FuncInfo"]:
        scope: Optional[Scope] = self
        while scope is not None:
            fn = scope.functions.get(name)
            if fn is not None:
                return fn
            scope = scope.parent
        return None


class FuncInfo:
    """A function (or lambda) definition with its enclosing scope chain."""

    def __init__(self, node: ast.AST, scope: Scope, qualname: str):
        self.node = node
        self.scope = scope  # the scope the function DEFINES (for its body)
        self.qualname = qualname

    @property
    def params(self) -> List[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names

    def body_nodes(self) -> Iterator[ast.AST]:
        """All nodes of this function's body, NOT descending into nested
        function/lambda bodies (those are their own FuncInfos)."""
        body = (
            [self.node.body]
            if isinstance(self.node, ast.Lambda)
            else list(self.node.body)
        )
        stack: List[ast.AST] = list(body)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, SCOPE_NODES):
                # A nested def/lambda statement is visible, its body is
                # its own scope — including when the def is a DIRECT
                # statement of this body (that case used to leak, which
                # surfaced the moment cross-module reach met the
                # io_callback host-half idiom in telemetry/counters.py).
                continue
            stack.extend(ast.iter_child_nodes(node))


class ModuleIndex:
    """Scope tree + function table for one parsed module."""

    def __init__(self, tree: ast.Module):
        self.module_scope = Scope(tree, None, "<module>")
        self.functions: Dict[int, FuncInfo] = {}  # id(node) -> info
        self._index(tree, self.module_scope, "")

    def _index(self, node: ast.AST, scope: Scope, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, SCOPE_NODES):
                name = getattr(child, "name", "<lambda>")
                qual = f"{prefix}{name}" if prefix else name
                info = FuncInfo(child, Scope(child, scope, qual), qual)
                self.functions[id(child)] = info
                if name != "<lambda>":
                    scope.functions[name] = info
                self._index(child, info.scope, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                self._index(child, scope, f"{prefix}{child.name}.")
            else:
                self._index(child, scope, prefix)

    def info_for(self, node: ast.AST) -> Optional[FuncInfo]:
        return self.functions.get(id(node))


def enclosing_function(
    parents: Dict[int, ast.AST], node: ast.AST
) -> Optional[ast.AST]:
    """Innermost FunctionDef/Lambda containing `node` (None at module
    level). `parents` comes from build_parent_map."""
    cur = parents.get(id(node))
    while cur is not None:
        if isinstance(cur, SCOPE_NODES):
            return cur
        cur = parents.get(id(cur))
    return None


def build_parent_map(tree: ast.AST) -> Dict[int, ast.AST]:
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


def qualname_at(
    parents: Dict[int, ast.AST], index: ModuleIndex, node: ast.AST
) -> str:
    """Stable scope label for a finding: the qualname of the innermost
    enclosing function, or '<module>'."""
    fn = enclosing_function(parents, node)
    if fn is None:
        return "<module>"
    info = index.info_for(fn)
    return info.qualname if info is not None else getattr(fn, "name", "<lambda>")


def names_in(node: ast.AST) -> Iterator[ast.Name]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub


def import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Map local name -> the dotted name it stands for, over every import
    of the module (`import torch.func as tf` -> 'torch.func', `from
    torch.func import vmap` -> 'torch.func.vmap'); `canonical` rewrites a
    call's dotted name through it."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
    return aliases


# The modules whose functions are collectives: the port's own wrappers
# (each over one mesh axis's process group) and torch.distributed itself.
COLLECTIVES_MODULE = "glom_tpu_torch.parallel.collectives"
DIST_MODULE = "torch.distributed"


def imported_collective_aliases(tree: ast.Module) -> Dict[str, str]:
    """The part of `import_aliases` that names a collective module or a
    function imported from one: `import torch.distributed as dist` ->
    'torch.distributed', `from glom_tpu_torch.parallel.collectives import
    all_gather` -> 'glom_tpu_torch.parallel.collectives.all_gather';
    `canonical` rewrites a call's dotted name through it."""
    modules = (COLLECTIVES_MODULE, DIST_MODULE)
    return {
        local: full
        for local, full in import_aliases(tree).items()
        if full in modules or full.rpartition(".")[0] in modules
    }


def canonical(name: Optional[str], aliases: Dict[str, str]) -> Optional[str]:
    """`name` with its first part replaced by what the import table says it
    stands for ('tf.vmap' -> 'torch.func.vmap'); unchanged otherwise."""
    if not name:
        return name
    head, _, rest = name.partition(".")
    full = aliases.get(head)
    if full is None:
        return name
    return f"{full}.{rest}" if rest else full
