"""trace-purity: no host side effects inside code torch will capture.

The torch form of `glom_tpu/analysis/purity.py`. A `time.perf_counter()`
or `print` inside a `torch.compile`d function runs at trace time (or
breaks the graph) and not as the code reads; under a CUDA graph's capture
it runs ONCE, at capture, and never on replay — the code looks like it
measures or logs per step, and the replayed program does neither. Worse
are `.item()`, `.cpu()` and Python `if` on tensor values, which sync the
device or raise inside a capture, or bake a capture-time constant into
the graph.

The checker finds TRACED ENTRIES — functions handed to `torch.compile`
(decorator or call), `torch.jit.script` / `trace`,
`torch.cuda.make_graphed_callables`, `torch.func.vmap` / `grad` /
`grad_and_value` / `jacrev` / `jacfwd` / `functional_call`,
`torch.export.export` or `torch.fx.symbolic_trace`, and the body of every
`with torch.cuda.graph(...):` block — walks the call graph reachable from
them, and inside that region flags:

  * host clocks (`time.*`), `print`, `open` / `input` / `breakpoint`,
    host RNG (`random.*`, `np.random.*`);
  * `.item()` / `.tolist()` / `.cpu()` / `.numpy()` and
    `torch.cuda.synchronize()` (device syncs);
  * `np.*` calls whose arguments reference function parameters (numpy on
    a tensor) — metadata reads (`x.shape`, `x.dtype`, `x.size()`,
    `x.dim()`, `x.numel()`, ...) are exempt: host math on static shape
    info is pure and idiomatic;
  * Python `if` / `while` on values produced by `torch.` calls (a branch
    on a tensor; `is None` config dispatch is exempt).

A custom `torch.autograd.Function` is NOT an entry, where glom_tpu's
`custom_vjp` is: PyTorch runs its `forward` and `backward` eagerly, op by
op, on every call, while JAX traces a `custom_vjp` once. So every kernel
wrapper's Function (which reads shapes, allocates scratch and launches on
the host) stays outside the region unless a traced entry reaches it.

Reachability is WHOLE-PROGRAM (the project graph): a call inside the
traced region whose name resolves to a function in another ANALYZED
module is followed into that module, bounded by XMOD_DEPTH module
crossings, and a violation is reported at the helper's own file:line.
Taint is call-site aware: an entry's parameters are all possible tensors,
a helper's only those its reached callers pass tainted values into.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from glom_tpu_torch.analysis.astutil import (
    SCOPE_NODES,
    FuncInfo,
    call_name,
    canonical,
    dotted,
    import_aliases,
    names_in,
)
from glom_tpu_torch.analysis.core import Checker, Context, Finding, SourceModule

# wrapper (canonical dotted name) -> positions of the traced-callable
# arguments
TRACED_ARG_POSITIONS = {
    "torch.compile": (0,),
    "torch.jit.script": (0,),
    "torch.jit.trace": (0,),
    "torch.cuda.make_graphed_callables": (0,),
    "torch.func.vmap": (0,),
    "torch.vmap": (0,),
    "torch.func.grad": (0,),
    "torch.func.grad_and_value": (0,),
    "torch.func.jacrev": (0,),
    "torch.func.jacfwd": (0,),
    "torch.func.functional_call": (0,),
    "torch.export.export": (0,),
    "torch.fx.symbolic_trace": (0,),
}
# keywords that carry the traced callable
TRACED_KEYWORDS = ("model", "func", "fn", "f", "obj", "mod", "root", "callables")
# context managers whose body is captured
CAPTURE_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}

BANNED_PREFIXES = {
    "time.": "host clock runs once at capture, not per replay",
    "random.": "host RNG is frozen at capture (use a torch.Generator)",
    "np.random.": "host RNG is frozen at capture (use a torch.Generator)",
    "numpy.random.": "host RNG is frozen at capture (use a torch.Generator)",
}
BANNED_NAMES = {
    "print": "runs at capture only, not per replay",
    "open": "host I/O inside a captured function",
    "input": "host I/O inside a captured function",
    "breakpoint": "host debugger inside a captured function",
}
BANNED_METHODS = {
    "item": "forces a device sync / breaks the capture",
    "tolist": "forces a device sync / breaks the capture",
    "cpu": "forces a device sync / breaks the capture",
    "numpy": "forces a device sync / breaks the capture",
}
# canonical name -> key suffix, for calls banned by their full name
BANNED_CALLS = {
    "torch.cuda.synchronize": ("synchronize", "host sync inside a captured function"),
}
METADATA_ATTRS = {
    "shape", "dtype", "ndim", "device", "size", "dim", "numel",
    "element_size", "stride", "is_cuda", "layout", "requires_grad",
}
# torch namespaces whose calls return host objects or wrap callables, not
# tensors — a boolean built from them is a legitimate Python branch.
HOST_NAMESPACES = (
    "torch.cuda.", "torch.backends.", "torch.distributed.", "torch.compiler.",
    "torch.jit.", "torch._dynamo.", "torch.fx.", "torch.export.", "torch.func.",
    "torch.utils.", "torch.autograd.", "torch.testing.",
)
# torch functions that return host metadata (dtypes, dtype lattice facts),
# not tensors.
METADATA_FUNCS = {
    "result_type", "promote_types", "can_cast", "is_floating_point",
    "is_complex", "is_tensor", "finfo", "iinfo", "get_default_dtype",
    "device", "dtype", "Size", "is_grad_enabled", "numel",
}

# Module-boundary crossings the reachability BFS will follow: the bound
# keeps a pathological call web from turning the pass O(repo²).
XMOD_DEPTH = 4


def _unguarded_names(node: ast.AST) -> Set[str]:
    """Name ids referenced in `node` OUTSIDE metadata attribute reads."""
    out: Set[str] = set()

    def scan(n: ast.AST) -> None:
        if isinstance(n, ast.Attribute) and n.attr in METADATA_ATTRS:
            return  # the whole subtree is a host metadata read
        if isinstance(n, ast.Name):
            out.add(n.id)
        for child in ast.iter_child_nodes(n):
            scan(child)

    scan(node)
    return out


class _Capture:
    """The body of one `with torch.cuda.graph(...):` block, walked like a
    function: it is captured, and its enclosing function is not."""

    def __init__(self, node: ast.With, info: FuncInfo):
        self.node = node
        self.scope = info.scope
        self.qualname = info.qualname
        self.params = [p for p in info.params if p not in ("self", "cls")]

    def body_nodes(self):
        stack: List[ast.AST] = list(self.node.body)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, SCOPE_NODES):
                continue
            stack.extend(ast.iter_child_nodes(node))


class TracePurity(Checker):
    name = "trace-purity"
    description = (
        "host side effects inside torch.compile / CUDA-graph / torch.func "
        "regions"
    )

    def check(self, module: SourceModule, ctx: Context) -> List[Finding]:
        results = self._project_results(ctx)
        return list(results.get(module.relpath, []))

    def _project_results(self, ctx: Context) -> Dict[str, List[Finding]]:
        """Whole-program reachability, computed once per run and sliced
        per module (findings land in the file that CONTAINS the impure
        site, which may not be the file that traces it)."""
        key = "trace-purity:results"
        if key in ctx.scratch:
            return ctx.scratch[key]
        reached: Dict[int, Tuple[SourceModule, object, int]] = {}
        taint_in: Dict[int, Set[str]] = {}
        queue: List[int] = []
        aliases = {id(m): import_aliases(m.tree) for m in ctx.modules}

        def enqueue(mod, info, depth: int, params: Set[str]) -> None:
            fid = id(info.node)
            if fid not in reached:
                reached[fid] = (mod, info, depth)
                taint_in[fid] = set(params)
                queue.append(fid)
                return
            cur_mod, cur_info, cur_depth = reached[fid]
            changed = False
            if depth < cur_depth:
                reached[fid] = (cur_mod, cur_info, depth)
                changed = True
            if not params <= taint_in[fid]:
                taint_in[fid] |= params
                changed = True
            if changed:
                queue.append(fid)

        def all_params(info) -> Set[str]:
            return {p for p in info.params if p not in ("self", "cls")}

        for mod in ctx.modules:
            for info in self._module_entries(mod, aliases[id(mod)]):
                enqueue(mod, info, 0, all_params(info))
        while queue:
            fid = queue.pop()
            mod, info, depth = reached[fid]
            mod_aliases = aliases[id(mod)]
            maybe, definite = self._taint(info, mod_aliases, taint_in[fid])
            tainted = maybe | definite
            for node in info.body_nodes():
                if not isinstance(node, ast.Call):
                    continue
                callee_mod, callee, cdepth = None, None, depth
                if isinstance(node.func, ast.Name):
                    callee = info.scope.resolve(node.func.id)
                    if callee is not None:
                        callee_mod = mod
                if callee is None and depth < XMOD_DEPTH and ctx.project is not None:
                    name = call_name(node)
                    if name and not name.startswith("self."):
                        hit = ctx.project.resolve_function(mod, name)
                        if hit is not None:
                            callee_mod, callee = hit[0].module, hit[1]
                            cdepth = depth + 1
                if callee is not None:
                    enqueue(
                        callee_mod,
                        callee,
                        cdepth,
                        self._call_taint(node, callee, tainted, mod_aliases),
                    )
                # nested traced wrappers inside a traced region: the
                # wrapped function is a fresh ENTRY (torch calls it), so its
                # params are all possible tensors.
                for target in self._traced_callables(node, mod_aliases):
                    rmod, resolved, rdepth = None, None, depth
                    if isinstance(target, ast.Name):
                        resolved = info.scope.resolve(target.id)
                        rmod = mod
                        if resolved is None and ctx.project is not None:
                            hit = ctx.project.resolve_function(mod, target.id)
                            if hit is not None:
                                rmod, resolved = hit[0].module, hit[1]
                                rdepth = depth + 1
                    elif isinstance(target, SCOPE_NODES):
                        resolved = mod.index.info_for(target)
                        rmod = mod
                    if resolved is not None:
                        enqueue(rmod, resolved, rdepth, all_params(resolved))
        results: Dict[str, List[Finding]] = {}
        seen = set()
        for fid, (mod, info, _depth) in reached.items():
            for f in self._check_function(
                mod, info, aliases[id(mod)], ctx, taint_in[fid]
            ):
                fp = (f.path, f.line, f.col, f.key)
                if fp not in seen:
                    seen.add(fp)
                    results.setdefault(mod.relpath, []).append(f)
        for findings in results.values():
            findings.sort(key=lambda f: (f.line, f.col))
        ctx.scratch[key] = results
        return results

    def _call_taint(
        self, call: ast.Call, callee: FuncInfo, caller_tainted: Set[str], aliases
    ) -> Set[str]:
        """Callee parameter names that receive a possibly-tensor value at
        this call site: arguments referencing a caller-tainted name outside
        metadata reads, or containing a tensor-producing torch call."""

        def arg_tainted(expr: ast.AST) -> bool:
            if any(
                isinstance(sub, ast.Call) and self._is_array_call(sub, aliases)
                for sub in ast.walk(expr)
            ):
                return True
            return bool(_unguarded_names(expr) & caller_tainted)

        a = callee.node.args
        pos = [p.arg for p in a.posonlyargs + a.args]
        out: Set[str] = set()
        i = 0
        for arg in call.args:
            if isinstance(arg, ast.Starred):
                if arg_tainted(arg):
                    # positions are unknowable from here on
                    out.update(pos[i:])
                    if a.vararg:
                        out.add(a.vararg.arg)
                i = len(pos)
                continue
            if arg_tainted(arg):
                if i < len(pos):
                    out.add(pos[i])
                elif a.vararg:
                    out.add(a.vararg.arg)
            i += 1
        kw_capable = set(pos) | {p.arg for p in a.kwonlyargs}
        for kw in call.keywords:
            if not arg_tainted(kw.value):
                continue
            if kw.arg is None:  # **splat: keys unknowable
                out.update(kw_capable)
                if a.kwarg:
                    out.add(a.kwarg.arg)
            elif kw.arg in kw_capable:
                out.add(kw.arg)
            elif a.kwarg:
                out.add(a.kwarg.arg)
        out.discard("self")
        out.discard("cls")
        return out

    # -- entry discovery ------------------------------------------------------

    @staticmethod
    def _traced_callables(call: ast.Call, aliases) -> List[ast.AST]:
        name = canonical(call_name(call), aliases)
        positions = TRACED_ARG_POSITIONS.get(name)
        if positions is None:
            return []
        out = []
        for idx in positions:
            if len(call.args) > idx:
                arg = call.args[idx]
                out.extend(arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg])
        for kw in call.keywords:
            if kw.arg in TRACED_KEYWORDS:
                out.append(kw.value)
        return out

    def _module_entries(self, module: SourceModule, aliases) -> List[object]:
        """TRACED ENTRIES of one module (decorator and call form, and the
        captured `with` blocks) — the BFS over what they reach lives in
        _project_results."""
        entries: List[object] = []

        def resolve_in(node: ast.AST, scope) -> Optional[FuncInfo]:
            if isinstance(node, ast.Name):
                return scope.resolve(node.id)
            if isinstance(node, SCOPE_NODES):
                return module.index.info_for(node)
            return None

        # decorator form: @torch.compile, @torch.compile(...),
        # @partial(torch.compile, ...)
        for info in module.index.functions.values():
            for dec in getattr(info.node, "decorator_list", []):
                target = dec.func if isinstance(dec, ast.Call) else dec
                name = canonical(dotted(target), aliases)
                if name in TRACED_ARG_POSITIONS:
                    entries.append(info)
                elif isinstance(dec, ast.Call) and name == "functools.partial":
                    inner = dec.args[0] if dec.args else None
                    iname = canonical(dotted(inner), aliases) if inner is not None else None
                    if iname in TRACED_ARG_POSITIONS:
                        entries.append(info)

        # call form, and the captured with-blocks
        scope_of: Dict[int, object] = {}
        owner: Dict[int, FuncInfo] = {}
        for info in module.index.functions.values():
            for node in info.body_nodes():
                scope_of[id(node)] = info.scope
                owner[id(node)] = info
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and id(node) in owner:
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call) and canonical(
                        call_name(expr), aliases
                    ) in CAPTURE_CONTEXTS:
                        entries.append(_Capture(node, owner[id(node)]))
                        break
            if not isinstance(node, ast.Call):
                continue
            scope = scope_of.get(id(node), module.index.module_scope)
            for target in self._traced_callables(node, aliases):
                resolved = resolve_in(target, scope)
                if resolved is not None:
                    entries.append(resolved)
        return entries

    # -- per-function effect scan --------------------------------------------

    @staticmethod
    def _is_array_call(sub: ast.Call, aliases) -> bool:
        name = canonical(call_name(sub), aliases) or ""
        if not name.startswith("torch.") or name.startswith(HOST_NAMESPACES):
            return False
        return name.split(".")[-1] not in METADATA_FUNCS

    def _taint(
        self, info, aliases, seed_params: Optional[Set[str]] = None
    ) -> Tuple[Set[str], Set[str]]:
        """(maybe_tensor, definite_tensor) name sets, one forward pass.
        maybe: tainted parameters (all of them by default; the propagated
        call-site set when the caller supplies one) and anything derived
        from them. definite: values produced by torch. calls (and
        arithmetic on them)."""
        if seed_params is None:
            maybe = {p for p in info.params if p not in ("self", "cls")}
        else:
            maybe = set(seed_params)
        definite: Set[str] = set()
        for node in info.body_nodes():
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = node.value
                if value is None:
                    continue
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                # Metadata reads (x.shape[0], x.dtype, ...) produce host
                # ints, not tensors — they must not propagate taint.
                rhs_names = _unguarded_names(value)
                rhs_calls_array = any(
                    isinstance(sub, ast.Call) and self._is_array_call(sub, aliases)
                    for sub in ast.walk(value)
                )
                tainted = bool(rhs_names & maybe) or rhs_calls_array
                definite_rhs = rhs_calls_array or bool(
                    self._definite_source_names(value, aliases) & definite
                )
                for t in targets:
                    for name in names_in(t):
                        if isinstance(name.ctx, ast.Store):
                            if tainted:
                                maybe.add(name.id)
                            if definite_rhs:
                                definite.add(name.id)
        return maybe, definite

    def _definite_source_names(self, node: ast.AST, aliases) -> Set[str]:
        """Names whose VALUE can flow into an assigned target as a tensor:
        everything outside metadata reads and outside the ARGUMENTS of
        non-tensor calls (a host helper handed a tensor returns whatever
        it returns — a routing boolean, a shape — not the tensor). Tensor
        METHODS (`x.float()`) keep flowing: the receiver sits in the
        call's func chain, not its arguments."""
        out: Set[str] = set()

        def scan(n: ast.AST) -> None:
            if isinstance(n, ast.Attribute) and n.attr in METADATA_ATTRS:
                return
            if isinstance(n, ast.Name):
                out.add(n.id)
                return
            if isinstance(n, ast.Call) and not self._is_array_call(n, aliases):
                scan(n.func)
                return
            for child in ast.iter_child_nodes(n):
                scan(child)

        scan(node)
        return out

    def _is_metadata_guarded(self, arg: ast.AST, tainted: Set[str]) -> bool:
        """True when every tainted Name in `arg` is only read through a
        metadata attribute (x.shape / x.dtype / x.size() / ...)."""

        def scan(node: ast.AST) -> bool:  # returns "has unguarded taint"
            if isinstance(node, ast.Attribute) and node.attr in METADATA_ATTRS:
                return False  # whole subtree is metadata access
            if isinstance(node, ast.Name):
                return node.id in tainted
            return any(scan(c) for c in ast.iter_child_nodes(node))

        return not scan(arg)

    def _check_function(
        self,
        module: SourceModule,
        info,
        aliases,
        ctx: Optional[Context] = None,
        tainted_params: Optional[Set[str]] = None,
    ) -> List[Finding]:
        findings: List[Finding] = []
        maybe, definite = self._taint(info, aliases, tainted_params)

        def resolve(name: str) -> Optional[FuncInfo]:
            hit = info.scope.resolve(name)
            if hit is not None:
                return hit
            if ctx is not None and ctx.project is not None:
                ph = ctx.project.resolve_function(module, name)
                if ph is not None:
                    return ph[1]
            return None

        def add(node, message, key):
            findings.append(
                Finding(
                    checker=self.name,
                    path=module.relpath,
                    line=node.lineno,
                    col=node.col_offset,
                    message=f"{message} (reachable from a traced entry)",
                    symbol=info.qualname,
                    key=key,
                )
            )

        for node in info.body_nodes():
            if isinstance(node, ast.Call):
                name = call_name(node) or ""
                full = canonical(name, aliases) or ""
                leaf = name.split(".")[-1]
                if name in BANNED_NAMES:
                    add(node, f"{name}(): {BANNED_NAMES[name]}", f"host-{name}")
                    continue
                if full in BANNED_CALLS:
                    suffix, why = BANNED_CALLS[full]
                    add(node, f"{name}(): {why}", f"host-{suffix}")
                    continue
                matched = False
                for prefix, why in BANNED_PREFIXES.items():
                    if name.startswith(prefix):
                        add(node, f"{name}(): {why}", f"host-{prefix[:-1]}")
                        matched = True
                        break
                if matched:
                    continue
                if leaf in BANNED_METHODS and isinstance(node.func, ast.Attribute):
                    add(
                        node,
                        f".{leaf}(): {BANNED_METHODS[leaf]}",
                        f"host-{leaf}",
                    )
                    continue
                if name.startswith(("np.", "numpy.")) and not name.startswith(
                    ("np.random.", "numpy.random.")
                ):
                    for arg in list(node.args) + [k.value for k in node.keywords]:
                        if not self._is_metadata_guarded(arg, maybe):
                            add(
                                node,
                                f"{name}() on a value derived from function "
                                "parameters — numpy cannot consume a "
                                "captured tensor",
                                "np-on-tracer",
                            )
                            break
            elif isinstance(node, (ast.If, ast.While)):
                test = node.test
                if self._is_none_check(test, resolve):
                    continue
                if _unguarded_names(test) & definite:
                    add(
                        node,
                        "Python branch on a torch-produced tensor — the "
                        "branch is decided ONCE at capture (use "
                        "torch.where, or keep the branch on the host)",
                        "tracer-branch",
                    )
        return findings

    @staticmethod
    def _is_none_check(test: ast.AST, resolve=None) -> bool:
        """`x is None` config dispatch, possibly spelled through a helper
        the repo defines (`if not exists(levels):` — utils' one-liner
        `def exists(x): return x is not None`). The helper is RESOLVED
        (lexically, then through the project graph) and its body checked,
        so only genuine none-check wrappers get the exemption."""
        if isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
        ):
            return True
        if isinstance(test, ast.BoolOp):
            return all(
                TracePurity._is_none_check(v, resolve) for v in test.values
            )
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return TracePurity._is_none_check(test.operand, resolve)
        if (
            isinstance(test, ast.Call)
            and isinstance(test.func, ast.Name)
            and resolve is not None
        ):
            helper = resolve(test.func.id)
            if helper is not None and TracePurity._returns_none_check(helper):
                return True
        return False

    @staticmethod
    def _returns_none_check(helper: FuncInfo) -> bool:
        node = helper.node
        if isinstance(node, ast.Lambda):
            body = node.body
        else:
            stmts = [
                s
                for s in node.body
                if not (
                    isinstance(s, ast.Expr)
                    and isinstance(s.value, ast.Constant)
                )
            ]
            if len(stmts) != 1 or not isinstance(stmts[0], ast.Return):
                return False
            body = stmts[0].value
        return (
            isinstance(body, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot)) for op in body.ops)
        )
