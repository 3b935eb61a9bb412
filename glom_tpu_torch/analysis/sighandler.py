"""signal-safety: code reachable from a signal handler must not acquire
non-reentrant locks or block.

The port's copy of glom_tpu's checker, and its preemption-save lesson
made static: a Python signal handler runs ON the main
thread, pausing it wherever it was — possibly inside a critical section,
HOLDING a lock. A handler path that then acquires that same
`threading.Lock` deadlocks the process at the exact moment (SIGTERM
grace window) it most needs to make progress; the measured instance was
the preemption save sharing the training loop's checkpoint-manager lock.
The shipped mitigations are the checker's exemption list:

  * `threading.RLock` is EXEMPT — the paused owner IS the handler's
    thread, so reacquisition succeeds (why tracing/flight.py's ring
    rides an RLock);
  * work moved to a spawned thread is NOT handler context — the checker
    does not follow `threading.Thread(target=...)` (the daemon-thread
    save is the sanctioned fix, not a violation) — but the handler's JOIN on
    that thread must be bounded: `.join()` with no timeout is flagged;
  * the blocking-IO denylist: `time.sleep`, `input`, `subprocess.*`,
    `socket.*`, and blocking `.get()`/`.put()` on queue-shaped
    receivers (`*_q` / `*queue*`) without a timeout/`block=False` —
    each an unbounded stall inside a bounded grace window. Plain local
    file writes are deliberately NOT listed: the flight dump must write
    its postmortem.

Handler discovery: functions registered via `signal.signal(SIG*, h)` —
`h` a local/nested function or a `self.<method>` — plus everything
reachable from them through intra-module calls (simple names via the
lexical scope chain, `self.<m>()` within the registering class).
Heuristic by design, like every checker here: cross-module calls are not
followed; the seeded fixture pair in tests/fixtures/signal_fixture.py
pins what IS caught.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from glom_tpu_torch.analysis.astutil import (
    SCOPE_NODES,
    FuncInfo,
    call_name,
    dotted,
)
from glom_tpu_torch.analysis.core import Checker, Context, Finding, SourceModule

# dotted-name prefixes that block unboundedly (or spawn blocking work)
BLOCKING_PREFIXES = {
    "subprocess.": "spawning/waiting on a subprocess blocks unboundedly",
    "socket.": "socket I/O blocks unboundedly",
}
BLOCKING_NAMES = {
    "time.sleep": "an unbounded stall inside a bounded grace window",
    "input": "blocks on stdin inside a signal handler",
}
_QUEUEISH_SUFFIXES = ("_q", "queue")


def _lock_kind(call: ast.Call) -> Optional[str]:
    """'lock' / 'rlock' when the call constructs a threading lock."""
    name = call_name(call) or ""
    leaf = name.split(".")[-1]
    if leaf == "Lock" and name in ("threading.Lock", "Lock"):
        return "lock"
    if leaf == "RLock" and name in ("threading.RLock", "RLock"):
        return "rlock"
    return None


def _queueish(receiver: Optional[str]) -> bool:
    """True when a dotted receiver looks like a queue (`self._q`,
    `work_queue`, ...) — the heuristic that keeps `.get()` on dicts and
    configs out of the findings."""
    if not receiver:
        return False
    leaf = receiver.split(".")[-1].lower()
    return leaf == "q" or any(leaf.endswith(s) for s in _QUEUEISH_SUFFIXES)


class SignalSafety(Checker):
    name = "signal-safety"
    description = (
        "no non-reentrant Lock acquisition or blocking IO reachable from "
        "a signal.signal-registered handler"
    )

    def check(self, module: SourceModule, ctx: Context) -> List[Finding]:
        handlers = self._handler_roots(module)
        if not handlers:
            return []
        locks = self._lock_table(module)
        methods = self._method_table(module)
        reached = self._reachable(module, handlers, methods)
        findings: List[Finding] = []
        for info in reached:
            findings.extend(self._check_function(module, info, locks))
        return findings

    # -- discovery -----------------------------------------------------------

    def _method_table(
        self, module: SourceModule
    ) -> Dict[Tuple[str, str], FuncInfo]:
        """(class qualname, method name) -> FuncInfo, for self-call
        resolution. Class qualname is the method qualname minus its leaf
        ('FlightRecorder.dump' -> 'FlightRecorder')."""
        table: Dict[Tuple[str, str], FuncInfo] = {}
        for info in module.index.functions.values():
            if "." in info.qualname:
                cls, leaf = info.qualname.rsplit(".", 1)
                table[(cls, leaf)] = info
        return table

    def _enclosing_class(self, info: FuncInfo) -> Optional[str]:
        """The class qualname a method (or its nested defs) belongs to:
        strip function leaves off the qualname until what remains names a
        known method's class. 'C.install.<locals>' nesting renders as
        'C.install._handler' here, so walking suffixes off finds 'C'."""
        parts = info.qualname.split(".")
        # everything but the leaf could be Class.method chains; take the
        # OUTERMOST segment group that is not itself a function name.
        return parts[0] if len(parts) > 1 else None

    def _handler_roots(self, module: SourceModule) -> List[FuncInfo]:
        roots: List[FuncInfo] = []
        scope_of: Dict[int, object] = {}
        owner_of: Dict[int, FuncInfo] = {}
        for info in module.index.functions.values():
            for node in info.body_nodes():
                scope_of[id(node)] = info.scope
                owner_of[id(node)] = info
        methods = self._method_table(module)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if (call_name(node) or "") != "signal.signal":
                continue
            if len(node.args) < 2:
                continue
            target = node.args[1]
            scope = scope_of.get(id(node), module.index.module_scope)
            resolved: Optional[FuncInfo] = None
            if isinstance(target, ast.Name):
                resolved = scope.resolve(target.id)
            elif isinstance(target, SCOPE_NODES):
                resolved = module.index.info_for(target)
            elif isinstance(target, ast.Attribute):
                recv = dotted(target.value)
                owner = owner_of.get(id(node))
                if recv == "self" and owner is not None:
                    cls = self._enclosing_class(owner)
                    if cls is not None:
                        resolved = methods.get((cls, target.attr))
            if resolved is not None:
                roots.append(resolved)
        return roots

    def _lock_table(self, module: SourceModule) -> Dict[str, str]:
        """name -> 'lock' | 'rlock'. Keys are both bare names (`lock =
        threading.Lock()`) and class-scoped attrs (`C.self._lock`) so a
        `with self._lock` in class C looks up 'C.self._lock'."""
        locks: Dict[str, str] = {}
        for info in module.index.functions.values():
            cls = self._enclosing_class(info)
            for node in info.body_nodes():
                if not isinstance(node, ast.Assign):
                    continue
                if not isinstance(node.value, ast.Call):
                    continue
                kind = _lock_kind(node.value)
                if kind is None:
                    continue
                for t in node.targets:
                    name = dotted(t)
                    if name is None:
                        continue
                    if name.startswith("self.") and cls is not None:
                        locks[f"{cls}.{name}"] = kind
                    else:
                        locks[name] = kind
        for node in module.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                kind = _lock_kind(node.value)
                if kind is not None:
                    for t in node.targets:
                        name = dotted(t)
                        if name is not None:
                            locks[name] = kind
        return locks

    def _reachable(
        self,
        module: SourceModule,
        roots: List[FuncInfo],
        methods: Dict[Tuple[str, str], FuncInfo],
    ) -> List[FuncInfo]:
        """BFS from the handler roots through intra-module calls: simple
        names via the lexical scope chain, `self.<m>()` via the method
        table. Thread targets are deliberately NOT edges (a spawned
        thread is not handler context — that is the sanctioned escape
        hatch, provided the join is bounded)."""
        reached: Dict[int, FuncInfo] = {}
        queue = list(roots)
        while queue:
            info = queue.pop()
            if id(info.node) in reached:
                continue
            reached[id(info.node)] = info
            cls = self._enclosing_class(info)
            for node in info.body_nodes():
                if not isinstance(node, ast.Call):
                    continue
                callee: Optional[FuncInfo] = None
                if isinstance(node.func, ast.Name):
                    callee = info.scope.resolve(node.func.id)
                elif isinstance(node.func, ast.Attribute):
                    recv = dotted(node.func.value)
                    if recv == "self" and cls is not None:
                        callee = methods.get((cls, node.func.attr))
                if callee is not None:
                    queue.append(callee)
        return list(reached.values())

    # -- per-function scan ---------------------------------------------------

    def _check_function(
        self, module: SourceModule, info: FuncInfo, locks: Dict[str, str]
    ) -> List[Finding]:
        findings: List[Finding] = []
        cls = self._enclosing_class(info)

        def lock_kind_of(expr: ast.AST) -> Optional[str]:
            name = dotted(expr)
            if name is None:
                return None
            if name.startswith("self.") and cls is not None:
                return locks.get(f"{cls}.{name}")
            return locks.get(name)

        def add(node, message, key):
            findings.append(
                Finding(
                    checker=self.name,
                    path=module.relpath,
                    line=node.lineno,
                    col=node.col_offset,
                    message=f"{message} (reachable from a signal handler)",
                    symbol=info.qualname,
                    key=key,
                )
            )

        for node in info.body_nodes():
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    if lock_kind_of(expr) == "lock":
                        add(
                            node,
                            f"`with {dotted(expr)}` acquires a NON-reentrant "
                            "threading.Lock — the paused main thread may "
                            "hold it and a paused owner never releases "
                            "(use RLock, or move the work to a bounded "
                            "worker thread)",
                            f"handler-lock-{dotted(expr)}",
                        )
            elif isinstance(node, ast.Call):
                name = call_name(node) or ""
                leaf = name.split(".")[-1]
                if leaf == "acquire" and isinstance(node.func, ast.Attribute):
                    if lock_kind_of(node.func.value) == "lock":
                        add(
                            node,
                            f"{dotted(node.func.value)}.acquire() on a "
                            "non-reentrant threading.Lock",
                            f"handler-lock-{dotted(node.func.value)}",
                        )
                    continue
                if name in BLOCKING_NAMES:
                    add(node, f"{name}(): {BLOCKING_NAMES[name]}",
                        f"handler-blocking-{name}")
                    continue
                matched = False
                for prefix, why in BLOCKING_PREFIXES.items():
                    if name.startswith(prefix):
                        add(node, f"{name}(): {why}",
                            f"handler-blocking-{prefix[:-1]}")
                        matched = True
                        break
                if matched:
                    continue
                if (
                    leaf == "join"
                    and isinstance(node.func, ast.Attribute)
                    and not node.args
                    and not any(k.arg == "timeout" for k in node.keywords)
                    and not _queueish(dotted(node.func.value))
                ):
                    # str.join always takes an argument; a zero-arg join
                    # is a thread join, and unbounded it stalls the grace
                    # window forever when the worker is wedged.
                    add(
                        node,
                        f"{dotted(node.func.value) or '<expr>'}.join() "
                        "without a timeout — an unbounded wait inside the "
                        "grace window",
                        "handler-join-unbounded",
                    )
                    continue
                blocking_shape = (
                    (leaf == "get" and not node.args)  # q.get(t) is bounded
                    or (leaf == "put" and len(node.args) == 1)
                )
                if (
                    leaf in ("get", "put")
                    and isinstance(node.func, ast.Attribute)
                    and _queueish(dotted(node.func.value))
                    and blocking_shape
                    and not any(
                        k.arg in ("timeout", "block") for k in node.keywords
                    )
                ):
                    add(
                        node,
                        f"blocking {dotted(node.func.value)}.{leaf}() — "
                        "pass timeout= (or use the _nowait form)",
                        f"handler-blocking-queue-{leaf}",
                    )
        return findings
