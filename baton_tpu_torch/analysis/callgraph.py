"""Static call graph over a batonlint :class:`~.project.Project`.

Edges are the calls :meth:`Project.resolve_call_multi` can pin down
statically — same-module helpers, ``self.method`` (resolved through
the class hierarchy: nearest inherited definition PLUS every known
subclass override, so a lock acquired in an overriding method is
visible to callers of the base method), ``super()`` chains, imported
symbols, and ``alias.func`` through an imported module.  Each edge
keeps its call-site node so downstream rules (lock-order, staleness)
can report the path a hazard travels, not just its endpoints; a call
site with several dispatch candidates contributes one edge per
candidate.

Reflection calls the resolver CAN pin down also contribute edges:
``getattr(self, "handle_" + x)(...)`` fans out to every hierarchy
method matching the literal prefix, and dict-literal dispatch tables
(function-local, ``self.X``, or module-level) fan ``tbl[k](...)`` /
``tbl.get(k)(...)`` out to every table value.  Calls that remain
dynamic (computed names with no literal prefix, HOFs through opaque
objects) are simply absent, so rules built on the graph UNDER-report
across those boundaries and say so in their docs rather than guessing.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

from baton_tpu_torch.analysis import _astutil as au
from baton_tpu_torch.analysis.project import FunctionInfo, Project

__all__ = ["CallEdge", "CallGraph"]


def _is_self_call(call: ast.Call) -> bool:
    """``self.m()`` / ``cls.m()`` / ``super().m()`` — calls whose
    receiver is the caller's own instance, so the callee's ``self.*``
    effects land on the caller's state."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return False
    if isinstance(func.value, ast.Name) and func.value.id in ("self", "cls"):
        return True
    return (
        isinstance(func.value, ast.Call)
        and isinstance(func.value.func, ast.Name)
        and func.value.func.id == "super"
    )


def _local_dispatch_tables(fn_node: ast.AST) -> Dict[str, Tuple[str, ...]]:
    """Function-local ``tbl = {k: handler, ...}`` dispatch tables."""
    from baton_tpu_torch.analysis.project import _dict_literal_refs

    out: Dict[str, Tuple[str, ...]] = {}
    for node in au.walk_shallow(fn_node):
        if not isinstance(node, ast.Assign):
            continue
        refs = _dict_literal_refs(node.value)
        if refs is None:
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out.setdefault(t.id, refs)
    return out


@dataclasses.dataclass
class CallEdge:
    caller: FunctionInfo
    callee: FunctionInfo
    node: ast.Call                # the call site, in caller's module
    via_self: bool = False        # receiver is the caller's own instance

    @property
    def line(self) -> int:
        return self.node.lineno


class CallGraph:
    """``caller key -> [CallEdge]``; keys are ``module:Qual.name``."""

    def __init__(self, project: Project) -> None:
        self.project = project
        self.functions: Dict[str, FunctionInfo] = {
            fn.key: fn for fn in project.functions()
        }
        self.edges: Dict[str, List[CallEdge]] = {}
        for fn in project.functions():
            out: List[CallEdge] = []
            local_tables = _local_dispatch_tables(fn.node)
            for node in au.walk_shallow(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                seen_here: set = set()
                for callee in project.resolve_call_multi(
                    fn.module, fn.class_name, node
                ):
                    if callee.key != fn.key:
                        seen_here.add(callee.key)
                        out.append(
                            CallEdge(fn, callee, node, _is_self_call(node))
                        )
                for callee, via_self in project.reflection_targets(
                    fn.module, fn.class_name, node, local_tables
                ):
                    if callee.key != fn.key and callee.key not in seen_here:
                        seen_here.add(callee.key)
                        out.append(CallEdge(fn, callee, node, via_self))
            self.edges[fn.key] = out

    def callees(self, key: str) -> List[CallEdge]:
        return self.edges.get(key, [])

    def walk_from(
        self, key: str, max_depth: Optional[int] = None
    ) -> Iterator[Tuple[Tuple[str, ...], CallEdge]]:
        """DFS over call chains from ``key``; yields
        ``(chain_of_caller_keys, edge)`` for every edge reachable without
        revisiting a function already on the current chain (cycle-safe).
        """
        def rec(k: str, chain: Tuple[str, ...]) -> Iterator:
            if max_depth is not None and len(chain) > max_depth:
                return
            for edge in self.edges.get(k, []):
                if edge.callee.key in chain or edge.callee.key == key:
                    continue
                yield chain, edge
                yield from rec(edge.callee.key, chain + (edge.callee.key,))

        yield from rec(key, (key,))
