"""axis-environment: a collective's axis must exist in the mesh its Axis
comes from.

The torch form of `glom_tpu/analysis/axisenv.py`. The collective-coverage
checker (analysis/collectives.py) validates axis names against the GLOBAL
vocabulary — every `*_AXIS` constant in the scanned tree. That misses a
subtler bug: an all-reduce over 'model' on a rank whose mesh only sizes
('data', 'seq') uses a perfectly vocabulary-legal axis that its own mesh
never sizes. glom_tpu's shard_map then fails at trace time; the port's is
worse. `rank_axes` gives an axis the mesh does not name size 1, and the
serve mesh's `RankAxes` carries `Axis("model", None, 1, 0)`
(parallel/serve_mesh.py), and a collective over an axis of size 1 issues
nothing (parallel/collectives.py): a training collective copied onto
`axes.model` in a serve-mesh body returns unreduced values, silently. This
checker is what catches it on the CPU.

The port has no shard_map: each rank takes its Axis values from a mesh
value, and a collective's environment is the mesh its Axis argument
comes from. The Axis is resolved through local and enclosing-function
assignments (tuple assignments element-wise) to one of:

  * `mesh_axis(MESH, NAME)` — axis NAME of MESH;
  * `AXES.<data|seq|model>` — a field of a `RankAxes` value AXES:
    `rank_axes(MESH)`, a ServeMesh's `.axes`, a `self.axes` chased to
    `__init__`, or a parameter followed to its callers;
  * an `axis`-named parameter of a local helper: checked at the helper's
    call sites, where the argument resolves as above (the
    `_psum_wire(x, axes.seq, ...)` idiom).

The environment (the mesh's axes) must be ATTESTED, as in glom_tpu:

  * a literal `MeshConfig(data=..., seq=...)` in the mesh value (directly
    or via one assignment) — the keyword names are the sized-axis INTENT
    (a `make_mesh` DeviceMesh physically names all of cfg.axis_names, but
    a collective over an axis the config never sized is dead wire); a
    `ServeMesh(...)` construction sizes 'data' and 'seq' only;
  * or the value followed through the PROJECT-WIDE flow graph
    (analysis/project.py), any combination of these hops:
      - an opaque parameter, followed back to every analyzed caller — the
        UNION of the callers' attested axes, with ONE unresolvable caller
        poisoning the whole attestation (never guess);
      - a parameter or `self.attr` whose ANNOTATION resolves to
        MeshConfig (the full axis tuple {data, seq, model}) or to
        ServeMesh ({data, seq});
      - `self.attr`, chased to the enclosing class's `__init__`
        assignments (every assignment must attest; union; a tuple target
        `self.mesh, self.device = make_mesh(...)` binds the call);
      - `rank_axes(MESH)` / `mesh_axis(MESH, ...)` and `X.axes`, whose
        environment is MESH's / X's;
      - a factory call `make_mesh(cfg, ...)` whose callee's matched
        parameter is annotated MeshConfig — recurses into the argument
        at the call site — or whose callee returns a ServeMesh;
  * or, failing that, the MODULE-WIDE union of every MeshConfig axis
    keyword and ServeMesh construction in the file.

A collective with no attested environment is SKIPPED — this checker only
fires when it can prove the axis absent. Each environment's attestation
(source line, how, axes) is recorded in
ctx.scratch['axis-environment:attested'].
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from glom_tpu_torch.analysis.astutil import (
    call_name,
    const_str,
    enclosing_function,
    imported_collective_aliases,
)
from glom_tpu_torch.analysis.collectives import PORT_AXIS_ARG, _collective_of
from glom_tpu_torch.analysis.core import Checker, Context, Finding, SourceModule

# MeshConfig keyword names that declare axes (num_slices is a layout
# knob, not an axis — utils/config.py), and RankAxes' fields.
_MESH_AXIS_KW = {"data", "seq", "model"}
# The axes a ServeMesh sizes (its 'model' axis is a size-1 stand-in).
_SERVE_AXES = {"data", "seq"}
# Calls whose value lives on the mesh of their first argument.
_ENV_CALLS = {"rank_axes", "mesh_axis"}

# Mesh-flow hop budget (decremented at EVERY helper transition). Cycles
# are cut by the `seen` guards; this only bounds pathological non-cyclic
# chains.
_FLOW_DEPTH = 16


def _assignments(stmts) -> Dict[str, ast.AST]:
    """name -> assigned expression over `stmts`, the first binding kept."""
    out: Dict[str, ast.AST] = {}
    for node in stmts:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for name, value in _bind(t, node.value, _name_of):
                    out.setdefault(name, value)
    return out


def _local_assignments(fn_node: Optional[ast.AST], tree: ast.Module):
    """name -> assigned expression, function-local first then module
    level. A tuple target binds element-wise against a tuple value, else
    every name to the whole value (`mesh, device = make_mesh(cfg)`)."""
    out = _assignments(ast.iter_child_nodes(fn_node)) if fn_node is not None else {}
    for name, value in _assignments(tree.body).items():
        out.setdefault(name, value)
    return out


def _name_of(target: ast.AST) -> Optional[str]:
    return target.id if isinstance(target, ast.Name) else None


def _self_attr_of(target: ast.AST) -> Optional[str]:
    if (
        isinstance(target, ast.Attribute)
        and isinstance(target.value, ast.Name)
        and target.value.id == "self"
    ):
        return target.attr
    return None


def _bind(target: ast.AST, value: ast.AST, key):
    """(key(t), value) for each leaf target t of an assignment that `key`
    names: tuple targets element-wise against a tuple value, else each
    bound to the whole value."""
    if isinstance(target, (ast.Tuple, ast.List)):
        paired = (
            isinstance(value, (ast.Tuple, ast.List))
            and len(value.elts) == len(target.elts)
        )
        for i, elt in enumerate(target.elts):
            yield from _bind(elt, value.elts[i] if paired else value, key)
        return
    name = key(target)
    if name is not None:
        yield name, value


def _mesh_axes(node: Optional[ast.AST], assigns) -> Set[str]:
    """Axis names provable from a mesh value: a MeshConfig(...) call in
    the value's (or its assignment's) subtree declares its keyword names
    as axes; a ServeMesh(...) construction sizes 'data' and 'seq'."""
    if node is None:
        return set()
    if isinstance(node, ast.Name):
        node = assigns.get(node.id)
        if node is None:
            return set()
    axes: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = call_name(sub)
            leaf = name.split(".")[-1] if name else None
            if leaf == "MeshConfig":
                for kw in sub.keywords:
                    if kw.arg in _MESH_AXIS_KW:
                        axes.add(kw.arg)
            elif leaf == "ServeMesh":
                axes |= _SERVE_AXES
    return axes


class AxisEnvironment(Checker):
    name = "axis-environment"
    description = (
        "collectives use axes that exist in the mesh their Axis comes "
        "from (not just in the global vocabulary)"
    )

    def check(self, module: SourceModule, ctx: Context) -> List[Finding]:
        aliases = imported_collective_aliases(module.tree)
        consts: Dict[str, str] = {}
        for node in module.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    s = const_str(node.value)
                    if isinstance(t, ast.Name) and s is not None:
                        consts[t.id] = s
        # Module-wide attestation: every MeshConfig axis keyword and
        # ServeMesh construction in the file (the fallback environment
        # when a mesh value is opaque).
        module_mesh_axes = _mesh_axes(module.tree, {})
        envs: Dict[Tuple[int, int], Set[str]] = {}
        findings: List[Finding] = []
        seen = set()
        infos = sorted(
            module.index.functions.values(), key=lambda i: i.node.lineno
        )
        for info in infos:
            for sub in info.body_nodes():
                if not isinstance(sub, ast.Call):
                    continue
                for f in self._check_call(
                    module, sub, aliases, consts, info, ctx,
                    module_mesh_axes, envs,
                ):
                    fp = (f.line, f.col, f.key, f.message)
                    if fp not in seen:
                        seen.add(fp)
                        findings.append(f)
        findings.sort(key=lambda f: (f.line, f.col))
        return findings

    # -- one call -------------------------------------------------------------

    def _check_call(
        self, module, call, aliases, consts, info, ctx, module_mesh_axes, envs
    ) -> List[Finding]:
        out: List[Finding] = []

        def check(axis_expr, what: str) -> None:
            src = self._axis_source(axis_expr, module, info, consts, _FLOW_DEPTH)
            if src is None:
                return
            axis, env_expr, env_info = src
            env = self._environment(
                module, env_expr, env_info, ctx, module_mesh_axes, envs
            )
            if env and axis not in env:
                out.append(
                    Finding(
                        checker=self.name,
                        path=module.relpath,
                        line=call.lineno,
                        col=call.col_offset,
                        message=(
                            f"{what} uses axis {axis!r}, which is not in "
                            f"the mesh axes {sorted(env)} its Axis comes "
                            "from — an axis the mesh never sizes has size "
                            "1, and the collective silently issues nothing"
                        ),
                        symbol=info.qualname,
                        key=f"axis-env-{axis}",
                    )
                )

        coll = _collective_of(call, aliases)
        if coll is not None:
            if coll in PORT_AXIS_ARG:
                axis_expr = next(
                    (kw.value for kw in call.keywords if kw.arg == "axis"), None
                )
                idx = PORT_AXIS_ARG[coll]
                if axis_expr is None and len(call.args) > idx:
                    axis_expr = call.args[idx]
                if axis_expr is not None:
                    check(axis_expr, coll)
            return out
        # An Axis threaded through a local helper's *axis*-named parameter
        # (the registered-wrapper idiom: _psum_wire(x, axes.seq, ...)).
        name = call_name(call)
        if not name or "." in name:
            return out
        callee = info.scope.resolve(name)
        if callee is None:
            return out
        params = callee.params
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            if i < len(params) and "axis" in params[i]:
                check(arg, f"{name}({params[i]}=...)")
        for kw in call.keywords:
            if kw.arg and "axis" in kw.arg:
                check(kw.value, f"{name}({kw.arg}=...)")
        return out

    # -- where an Axis comes from ---------------------------------------------

    @staticmethod
    def _binder(module: SourceModule, finfo, name: str):
        """('assign', function info or None for module level, value) or
        ('param', function info, None) for the innermost scope of the
        chain from `finfo` outward that binds `name`; None when none does."""
        fn = finfo.node if finfo is not None else None
        while fn is not None:
            info = module.index.info_for(fn)
            if info is not None:
                local = _assignments(ast.iter_child_nodes(fn))
                if name in local:
                    return ("assign", info, local[name])
                if name in info.params:
                    return ("param", info, None)
            fn = enclosing_function(module.parents, fn)
        value = _assignments(module.tree.body).get(name)
        return ("assign", None, value) if value is not None else None

    def _axis_source(self, expr, module, finfo, consts, depth):
        """(axis name, mesh-valued expression, the function it is read
        in) for an Axis expression; None when it is not provable (a
        parameter, a hand-built Axis, anything else)."""
        if expr is None or depth <= 0:
            return None
        if isinstance(expr, ast.Call):
            name = call_name(expr)
            if name and name.split(".")[-1] == "mesh_axis" and expr.args:
                name_expr = next(
                    (kw.value for kw in expr.keywords if kw.arg == "axis_name"),
                    expr.args[1] if len(expr.args) > 1 else None,
                )
                axis = self._resolve_axis(name_expr, consts)
                if axis is not None:
                    return axis, expr.args[0], finfo
            return None
        if isinstance(expr, ast.Attribute) and expr.attr in _MESH_AXIS_KW:
            return expr.attr, expr.value, finfo
        if isinstance(expr, ast.Name):
            b = self._binder(module, finfo, expr.id)
            if b is not None and b[0] == "assign":
                return self._axis_source(b[2], module, b[1], consts, depth - 1)
        return None

    @staticmethod
    def _resolve_axis(node, consts: Dict[str, str]) -> Optional[str]:
        if node is None:
            return None
        s = const_str(node)
        if s is not None:
            return s
        if isinstance(node, ast.Name) and node.id in consts:
            return consts[node.id]
        return None

    def _environment(
        self, module, env_expr, env_info, ctx, module_mesh_axes, envs
    ) -> Set[str]:
        """The attested axes of one mesh value, computed (and recorded in
        the trail) once per expression."""
        key = (id(env_expr), id(env_info))
        if key in envs:
            return envs[key]
        assigns = _local_assignments(
            env_info.node if env_info is not None else None, module.tree
        )
        attested = _mesh_axes(env_expr, assigns)
        how = "ctor"
        if not attested:
            attested = self._attest_value(
                self._project(ctx, module), module, env_info, env_expr,
                _FLOW_DEPTH, set(),
            )
            how = "flow"
        if not attested:
            attested = module_mesh_axes
            how = "module-union"
        trail = ctx.scratch.setdefault("axis-environment:attested", [])
        trail.append(
            (
                module.relpath,
                env_expr.lineno,
                how if attested else "unattested",
                tuple(sorted(attested)),
            )
        )
        envs[key] = attested
        return attested

    # -- mesh-flow attestation (project-wide) --------------------------------

    @staticmethod
    def _project(ctx: Context, module: SourceModule):
        if ctx.project is not None:
            return ctx.project
        from glom_tpu_torch.analysis.project import ProjectGraph

        return ProjectGraph(ctx.modules or [module])

    @staticmethod
    def _typed_axes(tref) -> Set[str]:
        """The axes a value of this type carries: a MeshConfig all three
        (MeshConfig.axis_names is unconditionally ('data', 'seq',
        'model')), a ServeMesh 'data' and 'seq'."""
        if tref is None or tref.cls is None:
            return set()
        cls = tref.cls.split(":")[-1]
        if cls == "MeshConfig":
            return set(_MESH_AXIS_KW)
        if cls == "ServeMesh":
            return set(_SERVE_AXES)
        return set()

    def _attest_value(self, project, module, finfo, expr, depth, seen) -> Set[str]:
        """Axes provable for a mesh-valued EXPRESSION in the context of
        (module, finfo): literal MeshConfig keywords / ServeMesh first
        (intent), then assignment chasing through the enclosing
        functions, typed parameters, caller attestation for opaque
        parameters, `self.attr` via the enclosing class's __init__, the
        mesh of `rank_axes` / `mesh_axis` / `.axes`, and factory calls.
        Empty set = cannot prove."""
        if expr is None or depth <= 0:
            return set()
        assigns = _local_assignments(
            finfo.node if finfo is not None else None, module.tree
        )
        got = _mesh_axes(expr, assigns)
        if got:
            return got
        if isinstance(expr, ast.Name):
            b = self._binder(module, finfo, expr.id)
            if b is None:
                return set()
            kind, binfo, value = b
            if kind == "assign":
                key = ("v", module.relpath, id(value))
                if key in seen:
                    return set()
                seen.add(key)
                return self._attest_value(
                    project, module, binfo, value, depth - 1, seen
                )
            typed = self._param_axes(project, module, binfo, expr.id)
            if typed:
                return typed
            return self._attest_param(
                project, module, binfo, expr.id, depth - 1, seen
            )
        if isinstance(expr, ast.Subscript):
            return self._attest_value(
                project, module, finfo, expr.value, depth - 1, seen
            )
        if isinstance(expr, ast.Attribute):
            if (
                isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and finfo is not None
            ):
                return self._attest_self_attr(
                    project, module, finfo, expr.attr, depth - 1, seen
                )
            if expr.attr == "axes":
                return self._attest_value(
                    project, module, finfo, expr.value, depth - 1, seen
                )
            return set()
        if isinstance(expr, ast.Call):
            name = call_name(expr)
            if name and name.split(".")[-1] in _ENV_CALLS and expr.args:
                return self._attest_value(
                    project, module, finfo, expr.args[0], depth - 1, seen
                )
            return self._attest_factory(
                project, module, finfo, expr, depth - 1, seen
            )
        return set()

    def _param_axes(self, project, module, finfo, param: str) -> Set[str]:
        """The axes the parameter's own annotation attests (MeshConfig /
        ServeMesh; see _typed_axes), no ctor needed."""
        a = getattr(finfo.node, "args", None)
        if a is None:
            return set()
        minfo = project.info_of(module)
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.arg == param:
                return self._typed_axes(
                    project.annotation_type(minfo, p.annotation)
                )
        return set()

    @staticmethod
    def _bound_arg(call: ast.Call, param: str, pos_names: List[str]):
        """The argument expression `call` binds to `param`, or None (a
        default, or a position hidden behind a splat)."""
        for kw in call.keywords:
            if kw.arg == param:
                return kw.value
        if param in pos_names:
            idx = pos_names.index(param)
            if idx < len(call.args) and not any(
                isinstance(p, ast.Starred) for p in call.args[: idx + 1]
            ):
                return call.args[idx]
        return None

    def _attest_param(
        self, project, module, finfo, param: str, depth, seen
    ) -> Set[str]:
        """Axes provable by following an opaque PARAMETER back to every
        ANALYZED caller that binds it — cross-module, via the project call
        graph. Attests only when at least one caller is found AND every
        found caller's argument attests; any unresolvable caller returns
        the empty set."""
        if depth <= 0:
            return set()
        key = ("p", module.relpath, finfo.qualname, param)
        if key in seen:
            return set()  # recursion never adds evidence
        seen.add(key)
        a = getattr(finfo.node, "args", None)
        if a is None:
            return set()
        pos_names = [p.arg for p in a.posonlyargs + a.args]
        axes: Set[str] = set()
        found = False
        for cinfo, cfinfo, call in project.callers_of(finfo):
            if cfinfo is not None and cfinfo.node is finfo.node:
                continue  # self-recursion never adds evidence
            arg_expr = self._bound_arg(call, param, pos_names)
            if arg_expr is None:
                return set()  # splat / default binding: never guess
            got = self._attest_value(
                project, cinfo.module, cfinfo, arg_expr, depth - 1, seen
            )
            if not got:
                return set()  # one unattested caller poisons all
            found = True
            axes |= got
        return axes if found else set()

    def _attest_self_attr(
        self, project, module, finfo, attr: str, depth, seen
    ) -> Set[str]:
        """`self.attr`: every `self.attr = ...` assignment (a tuple
        target too) in the enclosing class's __init__ must attest
        (union); a MeshConfig- or ServeMesh-typed attribute attests its
        axes outright."""
        cls = project.enclosing_class(module, finfo)
        if cls is None or depth <= 0:
            return set()
        minfo = project.info_of(module)
        typed = self._typed_axes(project.class_attr_types(minfo, cls).get(attr))
        if typed:
            return typed
        init = next(
            (
                n
                for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__"
            ),
            None,
        )
        init_info = module.index.info_for(init) if init is not None else None
        if init_info is None:
            return set()
        values = []
        for stmt in init_info.body_nodes():
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            if stmt.value is None:
                continue
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            )
            for t in targets:
                for target, value in _bind(t, stmt.value, _self_attr_of):
                    if target == attr:
                        values.append(value)
        if not values:
            return set()
        axes: Set[str] = set()
        for value in values:
            key = ("v", module.relpath, id(value))
            if key in seen:
                return set()
            seen.add(key)
            got = self._attest_value(
                project, module, init_info, value, depth - 1, seen
            )
            if not got:
                return set()  # one opaque assignment poisons the attr
            axes |= got
        return axes

    def _attest_factory(
        self, project, module, finfo, call: ast.Call, depth, seen
    ) -> Set[str]:
        """A call whose resolvable callee returns a ServeMesh, or takes a
        MeshConfig-annotated parameter and builds its mesh FROM that config
        — recurse into the matched argument expression at this call site
        (the `make_mesh(mesh_cfg, devices)` shape). Every bound
        MeshConfig-annotated argument must attest; union."""
        if depth <= 0:
            return set()
        hit = project.resolve_call(module, finfo, call)
        if hit is None:
            return set()
        tminfo, tfinfo = hit
        returned = self._typed_axes(
            project.annotation_type(tminfo, getattr(tfinfo.node, "returns", None))
        )
        if returned == _SERVE_AXES:
            return returned
        a = getattr(tfinfo.node, "args", None)
        if a is None:
            return set()
        pos_names = [p.arg for p in a.posonlyargs + a.args]
        axes: Set[str] = set()
        found = False
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if self._typed_axes(
                project.annotation_type(tminfo, p.annotation)
            ) != _MESH_AXIS_KW:
                continue
            arg_expr = self._bound_arg(call, p.arg, pos_names)
            if arg_expr is None:
                continue  # defaulted config: no evidence either way
            got = self._attest_value(
                project, module, finfo, arg_expr, depth - 1, seen
            )
            if not got:
                return set()  # an opaque config argument poisons the call
            found = True
            axes |= got
        return axes if found else set()

