"""BTL002 — awaits under asyncio locks, and lock-order cycles.

Holding a state lock across a network/queue await is a liveness
hazard: every other coroutine needing the lock stalls for a peer's
round-trip (or forever, against a dead peer), and with a second lock
in the picture an ABBA ordering deadlocks the loop outright.

Two sub-rules:

* an ``await`` of a network/queue primitive (aiohttp verbs,
  ``resp.json()``/``.read()``/``.text()``, queue ``get``/``put``/
  ``join``, ``asyncio.sleep``) inside ``async with <lock>:`` is flagged
  at the await — lexically, or when the lock is held across an ``await``
  of a project coroutine whose bottom-up fixpoint summary
  (:mod:`~baton_tpu_torch.analysis.summaries`) performs a network await at any
  depth (the finding then names the remote site and the witness chain).
  Either way it is suppressible at the await/call line or at the
  ``async with`` header (one allow covers a deliberately-held block);
* lock-acquisition ORDER is a whole-program directed graph: acquiring
  B while holding A — directly, or anywhere down the static call graph
  (:mod:`~baton_tpu_torch.analysis.callgraph`), across modules — adds edge
  A->B.  Any cycle in that graph is a potential deadlock and is
  reported once with every acquisition path that closes it, so a
  multi-hop cross-module ABBA pair shows both sides.

A "lock" is any ``async with`` context whose name ends with ``lock``
or ``mutex`` (``self._register_lock``, ``state_lock``, ...) — naming
convention as lint contract, same spirit as the counter registry.
Identities unify where references do: ``self._x_lock`` is
``RootClass._x_lock`` — the ROOT ancestor that introduces the
attribute, so an acquisition in an overriding subclass method unifies
with the base class's (class-hierarchy analysis); a module-global is
``pkg.mod.x_lock`` from its home module or through any import alias.
Locks reached through other objects' attributes stay module-local
(no type inference), so cycles through those are still unseen.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from baton_tpu_torch.analysis import _astutil as au
from baton_tpu_torch.analysis.engine import Finding, ProjectChecker, register
from baton_tpu_torch.analysis.project import FunctionInfo, ModuleInfo, Project
from baton_tpu_torch.analysis.summaries import (  # noqa: F401  (re-exported)
    NETWORK_ATTRS,
    NETWORK_DOTTED,
    get_summaries,
    is_network_call,
    lock_identity,
)


def _lock_identity(
    expr: ast.AST,
    class_name: Optional[str],
    mod: ModuleInfo,
    project: Optional[Project] = None,
) -> Optional[str]:
    """Normalized project-wide lock identity for an ``async with``
    context expr, or None when the context is not a lock.  With a
    project, ``self._x_lock`` normalizes to the ROOT-ancestor class that
    first declares the attribute, so a lock acquired in an overriding
    subclass method unifies with the base class's acquisitions."""
    return lock_identity(expr, class_name, mod, project=project)


@dataclasses.dataclass
class _Acquisition:
    lock: str
    node: ast.AST                     # the async with
    held: Tuple[str, ...]             # locks already held at this site


@dataclasses.dataclass
class _Witness:
    """One observed A-held-while-acquiring-B ordering."""

    path: str
    line: int
    col: int
    chain: Tuple[str, ...]            # function qualnames, caller first
    also_line: Optional[int] = None   # acquisition header, for allows

    def describe(self) -> str:
        via = (
            f" (via {' -> '.join(self.chain)})"
            if len(self.chain) > 1 else ""
        )
        return f"{self.path}:{self.line}{via}"


@register
class LockDisciplineChecker(ProjectChecker):
    rule = "BTL002"
    title = "network await under an asyncio lock / lock-order cycle"

    def check_project(self, project: Project) -> Iterable[Finding]:
        findings: List[Finding] = []
        summaries = get_summaries(project)
        graph = summaries.graph
        # per function: lock acquisitions and the calls made under lock
        acquires: Dict[str, List[_Acquisition]] = {}
        held_calls: Dict[str, List[Tuple[Tuple[str, ...], ast.Call]]] = {}
        awaited: Dict[str, set] = {}  # ids of Call nodes directly awaited
        for fn in project.functions():
            acqs: List[_Acquisition] = []
            calls: List[Tuple[Tuple[str, ...], ast.Call]] = []
            aw: set = set()
            self._collect(
                fn.node.body, fn, project, acqs, calls, aw, (), findings
            )
            acquires[fn.key] = acqs
            held_calls[fn.key] = calls
            awaited[fn.key] = aw

        # multi-hop: awaiting a project coroutine under a lock executes
        # every network await in that coroutine's fixpoint summary while
        # the lock is held — same stall, one call frame removed.
        for fn in project.functions():
            for held, call in held_calls[fn.key]:
                if id(call) not in awaited[fn.key]:
                    continue  # bare coroutine creation: nothing runs yet
                for edge in graph.callees(fn.key):
                    if edge.node is not call:
                        continue
                    summ = summaries.get(edge.callee.key)
                    if summ is None or not summ.is_async:
                        continue
                    self._flag_summary_awaits(
                        fn, call, held, edge, summ, findings
                    )
        # locks each function may acquire transitively, with the call
        # chain and site that witnesses the acquisition
        trans_memo: Dict[str, Dict[str, Tuple[str, int, Tuple[str, ...]]]] = {}

        def trans(key: str, visiting: frozenset) -> Dict[str, tuple]:
            if key in trans_memo:
                return trans_memo[key]
            if key in visiting:
                return {}  # recursion cycle: partial result is fine
            fn = graph.functions[key]
            out: Dict[str, tuple] = {}
            for acq in acquires.get(key, []):
                out.setdefault(
                    acq.lock,
                    (fn.module.path, acq.node.lineno, (fn.qualname,)),
                )
            for edge in graph.callees(key):
                for lock, (p, l, chain) in trans(
                    edge.callee.key, visiting | {key}
                ).items():
                    out.setdefault(lock, (p, l, (fn.qualname,) + chain))
            trans_memo[key] = out
            return out

        # the global lock-order graph: edge A -> B with first witness
        order: Dict[Tuple[str, str], _Witness] = {}
        for fn in project.functions():
            for acq in acquires[fn.key]:
                for outer in acq.held:
                    if outer != acq.lock:
                        order.setdefault(
                            (outer, acq.lock),
                            _Witness(
                                fn.module.path, acq.node.lineno,
                                acq.node.col_offset, (fn.qualname,),
                            ),
                        )
            for held, call in held_calls[fn.key]:
                # ALL dispatch candidates for this call node: through
                # the class hierarchy a self.method() may land in any
                # subclass override, and a lock acquired only in the
                # override must still order after the held ones
                for edge in graph.callees(fn.key):
                    if edge.node is not call:
                        continue
                    for lock, (_p, _l, chain) in trans(
                        edge.callee.key, frozenset({fn.key})
                    ).items():
                        for outer in held:
                            if outer != lock:
                                order.setdefault(
                                    (outer, lock),
                                    _Witness(
                                        fn.module.path, call.lineno,
                                        call.col_offset,
                                        (fn.qualname,) + chain,
                                    ),
                                )

        findings.extend(self._report_cycles(order))
        return findings

    # -- lock-order cycle reporting ------------------------------------
    def _report_cycles(
        self, order: Dict[Tuple[str, str], _Witness]
    ) -> List[Finding]:
        adj: Dict[str, List[str]] = {}
        for (a, b) in order:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        for outs in adj.values():
            outs.sort()

        findings: List[Finding] = []
        reported: set = set()
        for start in sorted(adj):
            cycle = self._shortest_cycle(start, adj)
            if cycle is None:
                continue
            key = frozenset(cycle)
            if key in reported:
                continue
            reported.add(key)
            edges = list(zip(cycle, cycle[1:] + cycle[:1]))
            witnesses = [order[e] for e in edges]
            primary = witnesses[0]
            path_desc = "; ".join(
                f"`{a}` held while acquiring `{b}` at {w.describe()}"
                for (a, b), w in zip(edges, witnesses)
            )
            ring = " -> ".join(f"`{x}`" for x in cycle + [cycle[0]])
            also = tuple(
                sorted(
                    {
                        line
                        for w in witnesses
                        for line in (w.line, w.also_line)
                        if line is not None
                        and w.path == primary.path
                        and line != primary.line
                    }
                )
            )
            findings.append(
                Finding(
                    self.rule, primary.path, primary.line, primary.col,
                    f"lock-order conflict: cycle {ring} — {path_desc} — "
                    f"an ABBA deadlock on the event loop",
                    also_lines=also,
                )
            )
        return findings

    @staticmethod
    def _shortest_cycle(
        start: str, adj: Dict[str, List[str]]
    ) -> Optional[List[str]]:
        """BFS for the shortest path start -> ... -> start; None when
        ``start`` is on no cycle."""
        frontier = [[start]]
        seen = set()
        while frontier:
            nxt = []
            for path in frontier:
                for succ in adj.get(path[-1], []):
                    if succ == start:
                        return path
                    if succ not in seen:
                        seen.add(succ)
                        nxt.append(path + [succ])
            frontier = nxt
        return None

    # -- per-function collection ---------------------------------------
    def _collect(
        self,
        stmts,
        fn: FunctionInfo,
        project: Project,
        acqs: List[_Acquisition],
        calls: List[Tuple[Tuple[str, ...], ast.Call]],
        awaited: set,
        held: Tuple[str, ...],
        findings: List[Finding],
    ) -> None:
        for stmt in stmts:
            self._visit(stmt, fn, project, acqs, calls, awaited,
                        held, findings)

    def _visit(
        self, node, fn, project, acqs, calls, awaited, held, findings
    ) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # separate execution context
        if isinstance(node, ast.AsyncWith):
            new_held = held
            header = [i.context_expr for i in node.items] + [
                i.optional_vars for i in node.items
            ]
            for item in node.items:
                expr = item.context_expr
                lock = _lock_identity(
                    expr, fn.class_name, fn.module, project
                )
                if lock is not None:
                    acqs.append(_Acquisition(lock, node, new_held))
                    new_held = new_held + (lock,)
                elif (
                    held
                    and isinstance(expr, ast.Call)
                    and is_network_call(expr)
                ):
                    # async with session.get(...) under a lock is the
                    # same hazard as awaiting it
                    self._flag_network(expr, held, node, fn, findings)
            for child in ast.iter_child_nodes(node):
                if child not in header:
                    self._visit(child, fn, project, acqs, calls, awaited,
                                new_held, findings)
            return
        if isinstance(node, ast.Await) and isinstance(node.value, ast.Call):
            awaited.add(id(node.value))
            if held and is_network_call(node.value):
                self._flag_network(node.value, held, None, fn, findings)
        if held and isinstance(node, ast.Call):
            calls.append((held, node))
        for child in ast.iter_child_nodes(node):
            self._visit(child, fn, project, acqs, calls, awaited,
                        held, findings)

    def _flag_summary_awaits(
        self, fn, call, held, edge, summ, findings
    ) -> None:
        for (path, line, _c), (display, chain) in sorted(
            summ.network_awaits.items()
        ):
            full = (edge.callee.qualname,) + chain
            via = " -> ".join(f"{q}()" for q in full)
            findings.append(
                Finding(
                    self.rule, fn.module.path,
                    call.lineno, call.col_offset,
                    f"await of network/queue primitive `{display}` "
                    f"(at {path}:{line}, reached via {via}) while "
                    f"holding lock `{held[-1]}` stalls every waiter "
                    f"for a peer round-trip",
                    also_lines=self._enclosing_lock_lines(fn, call),
                )
            )

    def _flag_network(self, call, held, _hdr, fn, findings) -> None:
        lock = held[-1]
        name = au.call_name(call) or f"<expr>.{call.func.attr}"
        findings.append(
            Finding(
                self.rule, fn.module.path, call.lineno, call.col_offset,
                f"await of network/queue primitive `{name}` while "
                f"holding lock `{lock}` stalls every waiter for a peer "
                f"round-trip",
                also_lines=self._enclosing_lock_lines(fn, call),
            )
        )

    @staticmethod
    def _enclosing_lock_lines(fn: FunctionInfo, call: ast.Call) -> tuple:
        """Lines of the ``async with <lock>`` headers enclosing ``call``
        — each is a valid suppression point for the await finding."""
        lines = []

        def rec(node, stack):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn.node:
                return False
            if node is call:
                lines.extend(stack)
                return True
            new_stack = stack
            if isinstance(node, ast.AsyncWith):
                new_stack = stack + [node.lineno]
            return any(
                rec(child, new_stack)
                for child in ast.iter_child_nodes(node)
            )

        rec(fn.node, [])
        return tuple(lines)
