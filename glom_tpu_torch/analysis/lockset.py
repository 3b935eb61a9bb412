"""lockset: shared mutable state in the threaded modules stays behind its
lock — and multi-lock classes acquire their locks in ONE order.

Four host-side threads share mutable objects with their callers —
DynamicBatcher's worker, BackendWatchdog's heartbeat loop, the prefetch
worker, the flight ring fed from every sink — and until this pass the
only guard was discipline. The checker infers, per class that OWNS a lock
(`self._lock = threading.Lock()/RLock()/Condition()` in __init__), which
attributes the lock protects, and flags the accesses that slip out:

  * INCONSISTENT GUARDING: an attribute accessed at least once inside a
    `with self.<lock>:` block must be accessed under it everywhere
    (outside __init__) — the one unlocked read of a counter the lock
    otherwise guards is the classic lost-update / torn-read site;
  * UNLOCKED SHARING: an attribute WRITTEN from thread-entry context (a
    method reachable from `threading.Thread(target=...)`) and accessed
    from non-entry (caller-facing) methods must be guarded somewhere —
    two threads, a mutation, and no lock is a race by construction.

Precision choices: attributes assigned only in __init__ are config
(exempt); attributes holding intrinsically thread-safe objects
(threading.Event/Lock/RLock/Condition/local, queue.Queue/SimpleQueue) are
exempt; a private method whose every intra-class call site is lock-held
inherits the held context (the watchdog's _record_transition pattern);
nested functions (the heartbeat `loop`) belong to their defining method.
This is the port's copy of glom_tpu's checker, finding for finding.

LOCK-ORDER CYCLES (the second checker here, `lock-order`): a class that
owns TWO OR MORE locks must acquire them in one global order — thread 1
holding A while waiting on B, thread 2 holding B while waiting on A, is a
deadlock by construction, and unlike a data race it hangs rather than
corrupts, so no runtime harness catches it until production does. The
checker builds the PROJECT's lock-acquisition graph over (class, lock)
nodes — an edge A -> B for every site that acquires B while holding A:
lexically, transitively through self-method calls, and through TYPED
receiver calls into other objects (the batcher holding its lock while
the cache it calls takes its own, which calls into the pool's — the
codebase's real three-class chain) — and flags every edge on a directed
cycle at its own acquisition site. The multi-engine DynamicBatcher
(serve/batcher.py) carries the first real two-lock pattern
(_engine_lock -> _counter_lock, documented at the top of that file);
this checker is what keeps a future edit from quietly adding the
reverse nesting, within a class or across the object graph. Remaining
blind spots: locks handed out through non-`with` acquire()/release()
pairs, and receivers the type layer cannot resolve. Self-edges
(re-acquiring a held lock) are not reported — RLock makes them legal
and the ctor-type distinction is one assignment away from invisible.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

from glom_tpu_torch.analysis.astutil import FUNC_NODES, call_name, dotted
from glom_tpu_torch.analysis.core import Checker, Context, Finding, SourceModule

LOCK_TYPES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
EXEMPT_TYPES = {
    "Event", "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue", "local",
    "Thread",
}
MUTATORS = {
    "append", "appendleft", "extend", "insert", "add", "update", "pop",
    "popleft", "remove", "discard", "clear", "setdefault", "set",
}


@dataclass
class Access:
    attr: str
    line: int
    col: int
    method: str  # display name ("start.loop" for nested funcs)
    unit: str    # ownership unit for entry analysis (the defining method)
    is_write: bool
    held: bool


class Lockset(Checker):
    name = "lockset"
    description = "shared attributes in threaded classes accessed under lock"

    def check(self, module: SourceModule, ctx: Context) -> List[Finding]:
        findings: List[Finding] = []
        for node in module.tree.body:
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(module, node))
        return findings

    # -- per-class analysis --------------------------------------------------

    def _check_class(
        self, module: SourceModule, cls: ast.ClassDef
    ) -> List[Finding]:
        methods = [n for n in cls.body if isinstance(n, FUNC_NODES)]
        init = next((m for m in methods if m.name == "__init__"), None)
        lock_attrs, exempt_attrs = self._classify_attrs(init)
        if not lock_attrs:
            return []  # a class that owns no lock has no lockset contract

        accesses: List[Access] = []
        entry_targets: Set[str] = set()   # units named as Thread targets
        calls: Dict[str, Set[str]] = {}   # unit -> self-methods it calls
        # method -> (caller unit, lexically lock-held) per call site; the
        # caller matters so heldness can propagate transitively (a method
        # called only from held methods is itself held)
        call_held: Dict[str, List[Tuple[str, bool]]] = {}

        for m in methods:
            self._scan_unit(
                m, m.name, m.name, lock_attrs, accesses, entry_targets,
                calls, call_held,
            )

        init_written = {a.attr for a in accesses if a.method == "__init__"}
        later_written = {
            a.attr
            for a in accesses
            if a.is_write and a.method != "__init__"
        }
        config_attrs = init_written - later_written

        # fixpoint: a private method whose every call site is lock-held —
        # lexically, or because the calling method is itself held —
        # inherits the held context (watchdog's _record_transition chain)
        held_methods: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for m in methods:
                name = m.name
                if name in held_methods or not name.startswith("_"):
                    continue
                if name in ("__init__",):
                    continue
                sites = call_held.get(name, [])
                if sites and all(
                    held or caller in held_methods for caller, held in sites
                ):
                    held_methods.add(name)
                    changed = True

        # entry-reachable units (thread side)
        entry_units: Set[str] = set(entry_targets)
        frontier = list(entry_targets)
        while frontier:
            unit = frontier.pop()
            for callee in calls.get(unit, ()):
                if callee not in entry_units:
                    entry_units.add(callee)
                    frontier.append(callee)

        findings: List[Finding] = []
        method_names = {m.name for m in methods}
        by_attr: Dict[str, List[Access]] = {}
        for a in accesses:
            if a.method == "__init__":
                continue
            if a.attr in lock_attrs or a.attr in exempt_attrs:
                continue
            if a.attr in config_attrs or a.attr in method_names:
                continue
            eff_held = a.held or a.method in held_methods
            by_attr.setdefault(a.attr, []).append(
                Access(a.attr, a.line, a.col, a.method, a.unit,
                       a.is_write, eff_held)
            )

        for attr, accs in sorted(by_attr.items()):
            guarded = any(a.held for a in accs)
            if guarded:
                for a in accs:
                    if not a.held:
                        findings.append(
                            Finding(
                                checker=self.name,
                                path=module.relpath,
                                line=a.line,
                                col=a.col,
                                message=(
                                    f"{cls.name}.{attr} is lock-guarded "
                                    "elsewhere but accessed without the "
                                    f"lock in {a.method}() — torn read / "
                                    "lost update"
                                ),
                                symbol=f"{cls.name}.{a.method}",
                                key=f"unguarded-{attr}",
                            )
                        )
            else:
                entry_writes = [
                    a for a in accs if a.is_write and a.unit in entry_units
                ]
                other_side = [a for a in accs if a.unit not in entry_units]
                if entry_writes and other_side:
                    a = entry_writes[0]
                    findings.append(
                        Finding(
                            checker=self.name,
                            path=module.relpath,
                            line=a.line,
                            col=a.col,
                            message=(
                                f"{cls.name}.{attr} is mutated from the "
                                f"worker thread ({a.method}()) and accessed "
                                "from caller-facing methods "
                                f"({', '.join(sorted({o.method for o in other_side}))}) "
                                "with no lock anywhere — unsynchronized "
                                "sharing"
                            ),
                            symbol=f"{cls.name}.{a.method}",
                            key=f"unlocked-shared-{attr}",
                        )
                    )
        return findings

    # -- helpers -------------------------------------------------------------

    def _classify_attrs(self, init) -> Tuple[Set[str], Set[str]]:
        lock_attrs: Set[str] = set()
        exempt: Set[str] = set()
        if init is None:
            return lock_attrs, exempt
        for node in ast.walk(init):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, ast.Call):
                continue
            ctor = (call_name(node.value) or "").split(".")[-1]
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    if ctor in LOCK_TYPES:
                        lock_attrs.add(t.attr)
                    elif ctor in EXEMPT_TYPES:
                        exempt.add(t.attr)
        return lock_attrs, exempt

    def _scan_unit(
        self,
        fn,
        display: str,
        unit: str,
        lock_attrs: Set[str],
        accesses: List[Access],
        entry_targets: Set[str],
        calls: Dict[str, Set[str]],
        call_held: Dict[str, List[Tuple[str, bool]]],
    ) -> None:
        """Collect accesses/calls in one function body; recurse into
        nested defs as their own display names but the same ownership
        unit handling (a nested func named as a Thread target becomes its
        own entry unit)."""

        def is_lock_with(item: ast.withitem) -> bool:
            d = dotted(item.context_expr)
            return bool(
                d
                and d.startswith("self.")
                and d.split(".")[1] in lock_attrs
            )

        def walk(node: ast.AST, held: bool) -> None:
            if isinstance(node, ast.With):
                now_held = held or any(is_lock_with(i) for i in node.items)
                for child in node.body:
                    walk(child, now_held)
                return
            if isinstance(node, FUNC_NODES) and node is not fn:
                nested_name = f"{display}.{node.name}"
                self._scan_unit(
                    node, nested_name, nested_name, lock_attrs, accesses,
                    entry_targets, calls, call_held,
                )
                # the nested unit is callable from its definer
                calls.setdefault(unit, set()).add(nested_name)
                return
            if isinstance(node, ast.Call):
                name = call_name(node) or ""
                leaf = name.split(".")[-1]
                if leaf == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target = dotted(kw.value)
                            if target and target.startswith("self."):
                                entry_targets.add(target.split(".", 1)[1])
                            elif target:
                                # nested function target: qualify with the
                                # defining unit's name
                                entry_targets.add(f"{display}.{target}")
                if name.startswith("self.") and name.count(".") == 1:
                    callee = name.split(".")[1]
                    calls.setdefault(unit, set()).add(callee)
                    call_held.setdefault(callee, []).append((unit, held))
                # mutation through an attribute: self.x.append(...) — ONE
                # write access; skip the func subtree so the inner
                # `self.x` Attribute isn't double-counted as a read, and
                # walk only the argument expressions
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in MUTATORS
                    and isinstance(node.func.value, ast.Attribute)
                    and isinstance(node.func.value.value, ast.Name)
                    and node.func.value.value.id == "self"
                ):
                    accesses.append(
                        Access(
                            node.func.value.attr, node.lineno,
                            node.col_offset, display, unit, True, held,
                        )
                    )
                    for child in list(node.args) + [
                        kw.value for kw in node.keywords
                    ]:
                        walk(child, held)
                    return
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                is_write = isinstance(node.ctx, (ast.Store, ast.Del))
                accesses.append(
                    Access(
                        node.attr, node.lineno, node.col_offset, display,
                        unit, is_write, held,
                    )
                )
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        for stmt in fn.body:
            walk(stmt, False)


class _ClassScan:
    """One lock-owning class's acquisition facts."""

    def __init__(self, module: SourceModule, cls: ast.ClassDef, ckey: str):
        self.module = module
        self.cls_name = cls.name
        self.ckey = ckey
        # unit -> [(held frozenset of own lock attrs, lock attr, line)]
        self.direct: Dict[str, List[Tuple[frozenset, str, int]]] = {}
        # unit -> [(callee unit, held, line)] for self-method calls
        self.intra_calls: Dict[str, List[Tuple[str, frozenset, int]]] = {}
        # unit -> [(callee class key, callee method, held, line)] for
        # typed-receiver calls into OTHER objects' methods
        self.ext_calls: Dict[str, List[Tuple[str, str, frozenset, int]]] = {}


class LockOrder(Checker):
    """Directed-cycle detection over the PROJECT's lock-acquisition graph.

    Nodes are (class, lock attribute) pairs across every analyzed module;
    edges are "acquires B while holding A" — lexically, transitively
    through self-method calls, and through TYPED receiver calls into
    other objects (`with self._lock: self.cache.lookup(...)` where
    lookup takes the cache's own lock adds the cross-OBJECT edge, and the
    cache's pool calls extend the chain). Single-lock classes
    participate: one lock cannot conflict with itself, but it can sit in
    the middle of a batcher -> cache -> pool chain. A cycle anywhere in
    the composed graph deadlocks the moment two threads interleave, and
    every edge on one is flagged at its own acquisition site's
    file:line. Remaining blind spots: locks handed out through
    non-`with` acquire()/release() pairs, and receivers the type layer
    cannot resolve (untyped dynamic dispatch). Self-edges (re-acquiring
    a held lock) are not reported — RLock makes them legal and the
    ctor-type distinction is one assignment away from invisible.
    """

    name = "lock-order"
    description = (
        "locks acquire in one global order across objects "
        "(a cycle in the acquisition graph is a deadlock by construction)"
    )

    def check(self, module: SourceModule, ctx: Context) -> List[Finding]:
        results = self._project_results(ctx)
        return list(results.get(module.relpath, []))

    def _project_results(self, ctx: Context) -> Dict[str, List[Finding]]:
        key = "lock-order:results"
        if key in ctx.scratch:
            return ctx.scratch[key]
        project = ctx.project
        if project is None:
            from glom_tpu_torch.analysis.project import ProjectGraph

            project = ProjectGraph(ctx.modules)
        scans: Dict[str, _ClassScan] = {}
        lock_attrs_of: Dict[str, Set[str]] = {}
        for mod in ctx.modules:
            minfo = project.info_of(mod)
            for node in mod.tree.body:
                if not isinstance(node, ast.ClassDef):
                    continue
                methods = [n for n in node.body if isinstance(n, FUNC_NODES)]
                init = next(
                    (m for m in methods if m.name == "__init__"), None
                )
                locks, _ = Lockset()._classify_attrs(init)
                if not locks:
                    continue
                ckey = project.class_key(minfo, node.name)
                lock_attrs_of[ckey] = locks
                scans[ckey] = self._scan_class(
                    mod, node, ckey, locks, project
                )
        # Global fixpoint: GA[(ckey, unit)] = every (class key, lock)
        # node the unit acquires — directly, through self-calls, or
        # through typed calls into other classes' methods.
        ga: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
        for ckey, scan in scans.items():
            units = (
                set(scan.direct) | set(scan.intra_calls) | set(scan.ext_calls)
            )
            for unit in units:
                ga[(ckey, unit)] = {
                    (ckey, lock)
                    for _, lock, _ in scan.direct.get(unit, ())
                }
        changed = True
        while changed:
            changed = False
            for ckey, scan in scans.items():
                for unit, sites in scan.intra_calls.items():
                    for callee, _, _ in sites:
                        s = ga.get((ckey, callee))
                        if s and not s <= ga[(ckey, unit)]:
                            ga[(ckey, unit)] |= s
                            changed = True
                for unit, sites in scan.ext_calls.items():
                    for dkey, meth, _, _ in sites:
                        s = ga.get((dkey, meth))
                        if s and not s <= ga[(ckey, unit)]:
                            ga[(ckey, unit)] |= s
                            changed = True
        # The acquisition graph over (class, lock) nodes, one witness
        # site per edge (first seen, deterministic scan order).
        Node = Tuple[str, str]
        edges: Dict[Tuple[Node, Node], Tuple[str, str, str, int]] = {}

        def add_edge(na: Node, nb: Node, scan: _ClassScan, unit: str, line: int) -> None:
            if na != nb:
                edges.setdefault(
                    (na, nb),
                    (scan.module.relpath, scan.cls_name, unit, line),
                )

        for ckey, scan in scans.items():
            for unit, sites in scan.direct.items():
                for held, lock, line in sites:
                    for a in sorted(held):
                        add_edge((ckey, a), (ckey, lock), scan, unit, line)
            for unit, sites in scan.intra_calls.items():
                for callee, held, line in sites:
                    if not held:
                        continue
                    for nb in sorted(ga.get((ckey, callee), ())):
                        for a in sorted(held):
                            add_edge((ckey, a), nb, scan, unit, line)
            for unit, sites in scan.ext_calls.items():
                for dkey, meth, held, line in sites:
                    if not held:
                        continue
                    for nb in sorted(ga.get((dkey, meth), ())):
                        for a in sorted(held):
                            add_edge((ckey, a), nb, scan, unit, line)

        adj: Dict[Node, Set[Node]] = {}
        for na, nb in edges:
            adj.setdefault(na, set()).add(nb)

        def reaches(src: Node, dst: Node) -> bool:
            seen, frontier = {src}, [src]
            while frontier:
                n = frontier.pop()
                for nxt in adj.get(n, ()):
                    if nxt == dst:
                        return True
                    if nxt not in seen:
                        seen.add(nxt)
                        frontier.append(nxt)
            return False

        cls_name_of = {ckey: s.cls_name for ckey, s in scans.items()}

        def render(node: Node, home: str) -> str:
            ckey, attr = node
            if ckey == home:
                return attr  # intra-class names (and fingerprints) stay bare
            return f"{cls_name_of.get(ckey, ckey)}.{attr}"

        results: Dict[str, List[Finding]] = {}
        for (na, nb), (relpath, cls_name, unit, line) in sorted(
            edges.items(), key=lambda kv: (kv[1][0], kv[1][3], kv[0])
        ):
            if not reaches(nb, na):
                continue
            home = na[0]
            ra, rb = render(na, home), render(nb, home)
            back = edges.get((nb, na))
            where = (
                f"the reverse order is taken in {back[1]}.{back[2]}() at "
                f"{back[0]}:{back[3]}" if back else
                "the reverse order is reachable through another edge"
            )
            results.setdefault(relpath, []).append(
                Finding(
                    checker=self.name,
                    path=relpath,
                    line=line,
                    col=0,
                    message=(
                        f"{cls_name} acquires {rb} while holding {ra} "
                        f"here, but {where} — a lock-order cycle "
                        "deadlocks the moment two threads interleave"
                    ),
                    symbol=f"{cls_name}.{unit}",
                    key=f"lock-order-{ra}-{rb}",
                )
            )
        # The attested graph, readable node names — what the tests (and
        # anyone debugging a chain) inspect.
        ctx.scratch["lock-order:edges"] = {
            (
                f"{cls_name_of.get(na[0], na[0])}.{na[1]}",
                f"{cls_name_of.get(nb[0], nb[0])}.{nb[1]}",
            ): (w[0], w[3])
            for (na, nb), w in edges.items()
        }
        ctx.scratch[key] = results
        return results

    def _scan_class(
        self,
        module: SourceModule,
        cls: ast.ClassDef,
        ckey: str,
        lock_attrs: Set[str],
        project,
    ) -> _ClassScan:
        scan = _ClassScan(module, cls, ckey)

        def scan_fn(fn, unit: str) -> None:
            scan.direct.setdefault(unit, [])
            scan.intra_calls.setdefault(unit, [])
            scan.ext_calls.setdefault(unit, [])
            finfo = module.index.info_for(fn)
            rtype = (
                project.receiver_resolver(module, finfo)
                if finfo is not None
                else None
            )

            def locks_of(with_node: ast.With) -> List[str]:
                out = []
                for item in with_node.items:
                    d = dotted(item.context_expr)
                    if d and d.startswith("self."):
                        attr = d.split(".")[1]
                        if attr in lock_attrs:
                            out.append(attr)
                return out

            def walk(node: ast.AST, held: frozenset) -> None:
                if isinstance(node, ast.With):
                    now = set(held)
                    for lock in locks_of(node):
                        if lock not in now:
                            scan.direct[unit].append(
                                (frozenset(now), lock, node.lineno)
                            )
                            now.add(lock)
                    for child in node.body:
                        walk(child, frozenset(now))
                    return
                if isinstance(node, FUNC_NODES) and node is not fn:
                    # Nested defs run later under an unknown held-set;
                    # scan them as their own unit reachable from here.
                    nested = f"{unit}.{node.name}"
                    scan_fn(node, nested)
                    scan.intra_calls[unit].append((nested, held, node.lineno))
                    return
                if isinstance(node, ast.Call):
                    name = call_name(node) or ""
                    if name.startswith("self.") and name.count(".") == 1:
                        scan.intra_calls[unit].append(
                            (name.split(".")[1], held, node.lineno)
                        )
                    elif rtype is not None and isinstance(
                        node.func, ast.Attribute
                    ):
                        # A method call on SOMETHING — resolve the
                        # receiver's type; an unresolvable receiver
                        # contributes nothing (precision stance).
                        t = rtype(node.func.value)
                        if t is not None and t.cls is not None:
                            scan.ext_calls[unit].append(
                                (t.cls, node.func.attr, held, node.lineno)
                            )
                for child in ast.iter_child_nodes(node):
                    walk(child, held)

            for stmt in fn.body:
                walk(stmt, frozenset())

        for m in cls.body:
            if isinstance(m, FUNC_NODES):
                scan_fn(m, m.name)
        return scan
