"""collective-coverage: every manual-path collective is axis-sound and
wire-accounted.

The torch form of `glom_tpu/analysis/collectives.py`. glom_tpu's
collectives are `lax` calls that NAME their axis; the port's take an `Axis`
(parallel/collectives.py: a mesh axis's name, process group, size and this
rank's index), so the axis is named where the Axis is made, not where it is
used. A collective here is a call of one of `glom_tpu_torch.parallel.
collectives`' functions (PORT_AXIS_ARG) or of a raw `torch.distributed`
collective (DIST_COLLECTIVES), imported bare or through a module alias.

Two rules, both static mirrors of runtime invariants:

  1. AXIS NAMES (all scanned files): at every site that names a mesh axis
     — `mesh_axis(mesh, NAME)`, `Axis(NAME, ...)`, `DeviceMesh.get_group(
     NAME)` / `.get_local_rank(NAME)` and the axis argument of
     `counters.timed_collective(site, AXIS, ...)` — the name must resolve
     to a declared mesh axis: a module-level `*_AXIS` string constant, a
     literal in the mesh vocabulary (MeshConfig.axis_names), a loop over a
     literal tuple of those, or an `axis`-named parameter threaded in by the
     caller (`axis_name`, or `axis.name` of an Axis parameter `axis`, whose
     name was checked where that Axis was made). A typo'd axis name fails
     at runtime only when that exact mesh shape is exercised.

  2. REGISTRATION (wire-accounted modules only — parallel/manual.py,
     parallel/quantized.py and parallel/serve_mesh.py): every wire-moving
     collective (WIRE_MOVING: the reductions, gathers and all-to-alls) is
     registered with telemetry.counters — it passes a non-None `site=` (the
     port's route into `counters.timed_collective`), or a function of its
     enclosing scope chain calls `record_collective` / `timed_collective`
     (the chain, so the lambda a wrapper takes counts). A registered chain
     that also times the collective by hand (`time.perf_counter` /
     `monotonic`, their `_ns` forms, or a `torch.cuda.Event(enable_timing=
     True)` and its `elapsed_time`) is a finding too: the one sanctioned
     timing route is `counters.timed_collective`. Scalar loss/metric
     collectives that are deliberately outside the wire model carry
     reviewed suppressions (glom_tpu_torch/analysis_baseline.json).

The registration rule covers the registration modules only, as
glom_tpu's does: the raw `torch.distributed` calls of serve/mesh_follower.py
(the leader/follower header, payload and status messages), parallel/
runtime.py, serve/elastic.py, telemetry/comm_time.py and train/cli.py are
outside it.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from glom_tpu_torch.analysis.astutil import (
    COLLECTIVES_MODULE,
    DIST_MODULE,
    call_name,
    canonical,
    enclosing_function,
    imported_collective_aliases,
    qualname_at,
)
from glom_tpu_torch.analysis.core import Checker, Context, Finding, SourceModule

# the port's collective -> positional index of its Axis argument
PORT_AXIS_ARG = {
    "all_reduce": 1,
    "all_reduce_tensors": 1,
    "reduce_scatter": 1,
    "all_gather": 1,
    "all_to_all": 1,
    "ring_shift": 1,
    "neighbor_exchange": 2,
    "copy_to_model": 1,
    "reduce_from_model": 1,
    "split_to_model": 1,
    "gather_from_model": 1,
    "halo_exchange": 1,
}
DIST_COLLECTIVES = {
    "all_reduce",
    "all_gather_into_tensor",
    "reduce_scatter_tensor",
    "all_to_all_single",
    "broadcast",
    "isend",
    "irecv",
    "batch_isend_irecv",
}
# the wire-moving subset that must be registered in the wire-accounted
# modules (glom_tpu's psum / psum_scatter / pmean / all_gather /
# all_to_all; the point-to-point shifts are its ppermute, outside it)
WIRE_MOVING = {
    "all_reduce",
    "all_reduce_tensors",
    "reduce_scatter",
    "all_gather",
    "all_to_all",
    "copy_to_model",
    "reduce_from_model",
    "split_to_model",
    "gather_from_model",
    "dist.all_reduce",
    "dist.all_gather_into_tensor",
    "dist.reduce_scatter_tensor",
    "dist.all_to_all_single",
}
# Functions that count as registering the enclosing site with the measured
# counters: record_collective (bytes only) or the shared timing wrapper
# timed_collective (bytes + site registry + optional event brackets).
_REGISTERING = {"record_collective", "timed_collective"}
# Host clocks and device-event timers that mark a HAND-ROLLED timing
# harness when they share a function chain with a wire-moving collective.
_TIMING_PRIMITIVES = {
    "perf_counter", "monotonic", "perf_counter_ns", "monotonic_ns",
    "elapsed_time",
}
# site leaf name -> positional index of the axis name, and the keyword
# that may carry it instead
AXIS_NAMING = {
    "mesh_axis": (1, "axis_name"),
    "Axis": (0, "name"),
    "get_group": (0, "mesh_dim"),
    "get_local_rank": (0, "mesh_dim"),
    "timed_collective": (1, "axis_name"),
}


def _collective_of(call: ast.Call, aliases: dict) -> Optional[str]:
    """The collective a call makes: the port function's name
    ('all_reduce'), 'dist.<name>' for a raw torch.distributed collective,
    or None. `aliases` is the module's `imported_collective_aliases`."""
    module, _, leaf = (canonical(call_name(call), aliases) or "").rpartition(".")
    if module == COLLECTIVES_MODULE and leaf in PORT_AXIS_ARG:
        return leaf
    if module == DIST_MODULE and leaf in DIST_COLLECTIVES:
        return f"dist.{leaf}"
    return None


def _is_timing_call(call: ast.Call) -> bool:
    name = call_name(call)
    leaf = name.split(".")[-1] if name else None
    if leaf in _TIMING_PRIMITIVES:
        return True
    return leaf == "Event" and any(
        kw.arg == "enable_timing"
        and not (isinstance(kw.value, ast.Constant) and not kw.value.value)
        for kw in call.keywords
    )


def _registered_by_site(call: ast.Call) -> bool:
    return any(
        kw.arg == "site"
        and not (isinstance(kw.value, ast.Constant) and kw.value.value is None)
        for kw in call.keywords
    )


class CollectiveCoverage(Checker):
    name = "collective-coverage"
    description = (
        "manual-path collectives use declared mesh axes and are "
        "registered with telemetry.counters"
    )

    def check(self, module: SourceModule, ctx: Context) -> List[Finding]:
        aliases = imported_collective_aliases(module.tree)
        findings: List[Finding] = []
        registered_scope = any(
            module.relpath.endswith(suffix)
            for suffix in ctx.registration_modules
        )
        # Pre-collect: per function node, does it call a registering
        # function (record_collective / timed_collective), a timing
        # primitive, or the shared wrapper specifically? The wrapper takes
        # the collective as a LAMBDA, so membership checks walk the whole
        # enclosing-scope CHAIN (lambda -> function -> ...), not just the
        # innermost scope.
        records_in: set = set()
        timing_in: set = set()
        wrapper_in: set = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                name = call_name(node)
                leaf = name.split(".")[-1] if name else None
                if leaf in _REGISTERING:
                    fn = enclosing_function(module.parents, node)
                    records_in.add(id(fn))
                    if leaf == "timed_collective":
                        wrapper_in.add(id(fn))
                if _is_timing_call(node):
                    fn = enclosing_function(module.parents, node)
                    timing_in.add(id(fn))

        def scope_chain(node):
            """Every enclosing function/lambda of `node`, innermost
            first (module level terminates the chain)."""
            fn = enclosing_function(module.parents, node)
            while fn is not None:
                yield fn
                fn = enclosing_function(module.parents, fn)

        # Module-level string constants (for axis-name resolution).
        consts = {}
        for node in module.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Name)
                        and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)
                    ):
                        consts[t.id] = node.value.value

        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            symbol = qualname_at(module.parents, module.index, node)
            findings.extend(
                self._check_naming_site(module, ctx, node, consts, symbol)
            )
            coll = _collective_of(node, aliases)
            if coll is None:
                continue
            if registered_scope and coll in WIRE_MOVING:
                chain = list(scope_chain(node))
                chain_ids = {id(fn) for fn in chain}
                if not _registered_by_site(node) and not chain_ids & records_in:
                    findings.append(
                        Finding(
                            checker=self.name,
                            path=module.relpath,
                            line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"{coll} site is not registered with "
                                "telemetry.counters (no site=, and no "
                                "record_collective / timed_collective in "
                                "its scope chain) — the measured wire "
                                "bytes (and comm_model_drift) silently "
                                "omit it"
                            ),
                            symbol=symbol,
                            key=f"unregistered-{coll}",
                        )
                    )
                if chain_ids & timing_in and not chain_ids & wrapper_in:
                    findings.append(
                        Finding(
                            checker=self.name,
                            path=module.relpath,
                            line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"{coll} site is timed with a hand-rolled "
                                "clock/event harness — route the timing "
                                "through counters.timed_collective (the "
                                "shared timing wrapper)"
                            ),
                            symbol=symbol,
                            key=f"hand-rolled-timing-{coll}",
                        )
                    )
        return findings

    # -- axis-name resolution -------------------------------------------------

    @staticmethod
    def _naming_site(call: ast.Call) -> Optional[Tuple[str, ast.AST]]:
        """(site leaf, axis-name expression) when `call` names a mesh
        axis; None otherwise, or when the name is not passed."""
        name = call_name(call)
        leaf = name.split(".")[-1] if name else None
        if leaf not in AXIS_NAMING:
            return None
        idx, kw_name = AXIS_NAMING[leaf]
        for kw in call.keywords:
            if kw.arg == kw_name:
                return leaf, kw.value
        if len(call.args) > idx and not any(
            isinstance(a, ast.Starred) for a in call.args[: idx + 1]
        ):
            return leaf, call.args[idx]
        return None

    def _loop_values(
        self, name: ast.Name, module: SourceModule
    ) -> Optional[List[ast.AST]]:
        """The values a for-loop or comprehension variable takes when it
        iterates a literal tuple/list (element-wise through a tuple
        target, `for name, lines in ((DATA_AXIS, ...), ...)`); None when
        `name` is no such variable."""
        cur = module.parents.get(id(name))
        while cur is not None:
            gens = []
            if isinstance(cur, (ast.For, ast.AsyncFor)):
                gens = [(cur.target, cur.iter)]
            elif isinstance(cur, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                                  ast.DictComp)):
                gens = [(g.target, g.iter) for g in cur.generators]
            for target, it in gens:
                values = self._bound_in(target, it, name.id)
                if values is not None:
                    return values
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return None
            cur = module.parents.get(id(cur))
        return None

    @staticmethod
    def _bound_in(target, it, name: str) -> Optional[List[ast.AST]]:
        if not isinstance(it, (ast.Tuple, ast.List)):
            return None
        if isinstance(target, ast.Name):
            return list(it.elts) if target.id == name else None
        if isinstance(target, ast.Tuple):
            for i, elt in enumerate(target.elts):
                if isinstance(elt, ast.Name) and elt.id == name:
                    out = []
                    for row in it.elts:
                        if not (isinstance(row, (ast.Tuple, ast.List))
                                and len(row.elts) == len(target.elts)):
                            return None
                        out.append(row.elts[i])
                    return out
        return None

    def _axis_ok(
        self,
        node: ast.AST,
        ctx: Context,
        consts: dict,
        module: SourceModule,
    ) -> Optional[str]:
        """None when the axis resolves to a declared name; else a short
        reason string for the finding."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value in ctx.axis_vocab:
                return None
            return (
                f"axis {node.value!r} is not a declared mesh axis "
                f"{sorted(ctx.axis_vocab)}"
            )
        if isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                reason = self._axis_ok(elt, ctx, consts, module)
                if reason:
                    return reason
            return None
        if isinstance(node, ast.Name):
            if node.id in consts:
                if consts[node.id] in ctx.axis_vocab:
                    return None
                return (
                    f"axis constant {node.id}={consts[node.id]!r} is not a "
                    f"declared mesh axis {sorted(ctx.axis_vocab)}"
                )
            values = self._loop_values(node, module)
            if values is not None:
                for value in values:
                    reason = self._axis_ok(value, ctx, consts, module)
                    if reason:
                        return reason
                return None
            # An axis threaded in by the caller: accept parameters whose
            # name says so (the call sites pass a checked axis).
            param = self._param_of(node.id, node, module)
            if param is not None:
                if "axis" in node.id:
                    return None
                return (
                    f"axis comes from parameter {node.id!r} — rename it "
                    "to carry 'axis' so call sites are checkable, or "
                    "pass a declared axis constant"
                )
            return f"axis name {node.id!r} is not statically resolvable"
        if (
            isinstance(node, ast.Attribute)
            and node.attr == "name"
            and isinstance(node.value, ast.Name)
            and "axis" in node.value.id
            and self._param_of(node.value.id, node, module) is not None
        ):
            # An Axis parameter's own name: checked where it was made.
            return None
        return "axis argument is not statically resolvable"

    @staticmethod
    def _param_of(name: str, node: ast.AST, module: SourceModule):
        fn = enclosing_function(module.parents, node)
        while fn is not None:
            info = module.index.info_for(fn)
            if info is not None and name in info.params:
                return info
            fn = enclosing_function(module.parents, fn)
        return None

    def _check_naming_site(
        self,
        module: SourceModule,
        ctx: Context,
        call: ast.Call,
        consts: dict,
        symbol: str,
    ) -> List[Finding]:
        site = self._naming_site(call)
        if site is None:
            return []
        leaf, axis = site
        reason = self._axis_ok(axis, ctx, consts, module)
        if reason is None:
            return []
        return [
            Finding(
                checker=self.name,
                path=module.relpath,
                line=call.lineno,
                col=call.col_offset,
                message=f"{leaf}: {reason}",
                symbol=symbol,
                key=f"axis-{leaf}",
            )
        ]
