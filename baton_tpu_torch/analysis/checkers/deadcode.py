"""BTL007 — functions reachable from no entry point.

The entry-point model (see :mod:`~baton_tpu_torch.analysis.summaries`) makes
"reachable" meaningful for an event-loop server: a handler nobody
routes, a callback nobody schedules, a helper nobody calls is dead
weight that still costs review attention — and a dead *handler* is
usually a wiring bug, not tidiness.

Roots: public functions and methods (no leading ``_``) and dunders —
they ARE the module's API; decorated functions (registration
decorators run at import); every callable referenced by an entry-point
registration (routes, ``PeriodicTask``, loop callbacks, thread
dispatch); names referenced at module level (including ``__all__``
strings and class-body assignments); and functions named by another
module's imports.  From those roots the checker walks the call graph —
which, post reflection resolution, includes ``getattr``-prefix and
dispatch-table edges — plus by-value name references (callbacks passed
as arguments: ``map(self._f, xs)``, ``partial(self._f)``), so a
function is flagged only when *no* statically visible path roots it.

Because nested ``def``s and lambdas share the enclosing function's
lexical scope — and the call graph intentionally does not model
closures — reference collection for a *reached* function scans its
whole subtree (nested bodies included, call names included) and roots
any same-module function whose bare name is mentioned.  Coarse on
purpose: a dead-code rule must err toward silence.

Only private (leading ``_``, non-dunder) functions are flagged, at
their ``def`` line; suppress deliberate keep-arounds with
``# batonlint: allow[BTL007]``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from baton_tpu_torch.analysis.engine import Finding, ProjectChecker, register
from baton_tpu_torch.analysis.summaries import get_summaries

_SKIP = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _module_level_refs(mod) -> Set[str]:
    """Raw name/dotted refs made by module-scope code (class bodies
    included, function bodies excluded) plus ``__all__`` strings."""
    refs: Set[str] = set()

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _SKIP):
                continue
            if isinstance(child, ast.Name) and isinstance(
                child.ctx, ast.Load
            ):
                refs.add(child.id)
            elif isinstance(child, ast.Attribute):
                d = None
                if isinstance(child.value, ast.Name):
                    d = f"{child.value.id}.{child.attr}"
                if d is not None:
                    refs.add(d)
            if isinstance(child, ast.Assign):
                for t in child.targets:
                    if (
                        isinstance(t, ast.Name)
                        and t.id == "__all__"
                        and isinstance(child.value, (ast.List, ast.Tuple))
                    ):
                        refs.update(
                            e.value for e in child.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)
                        )
            walk(child)

    walk(mod.tree)
    return refs


def _subtree_names(fn) -> Set[str]:
    """Every bare name a function's subtree mentions: Name loads and
    attribute names, nested defs and lambdas INCLUDED — closures see the
    enclosing scope, so a mention anywhere in the subtree keeps a
    same-scope helper alive."""
    names: Set[str] = set()
    for n in ast.walk(fn.node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            names.add(n.id)
        elif isinstance(n, ast.Attribute):
            names.add(n.attr)
    return names


@register
class DeadCodeChecker(ProjectChecker):
    rule = "BTL007"
    title = (
        "function reachable from no entry point (dead handler or "
        "orphaned helper)"
    )

    def check_project(self, project) -> Iterable[Finding]:
        summ = get_summaries(project)
        graph = summ.graph

        roots: List[str] = []
        for fn in project.functions():
            bare = fn.node.name
            is_dunder = bare.startswith("__") and bare.endswith("__")
            if not bare.startswith("_") or is_dunder:
                roots.append(fn.key)
            elif fn.node.decorator_list:
                roots.append(fn.key)

        for fn in project.functions():
            lf = summ.locals.get(fn.key)
            if lf is None:
                continue
            for _kind, ref, _line in lf.entry_regs:
                for target in project.resolve_ref(
                    fn.module, fn.class_name, ref
                ):
                    roots.append(target.key)

        for mod in project.modules:
            for ref in _module_level_refs(mod):
                for target in project.resolve_ref(mod, None, ref):
                    roots.append(target.key)
            for dotted in mod.imports.values():
                target = project.function_by_dotted(dotted)
                if target is not None:
                    roots.append(target.key)

        reached: Set[str] = set()
        stack = list(roots)
        while stack:
            key = stack.pop()
            if key in reached:
                continue
            reached.add(key)
            for edge in graph.callees(key):
                if edge.callee.key not in reached:
                    stack.append(edge.callee.key)
            fn = graph.functions.get(key)
            lf = summ.locals.get(key)
            if fn is None or lf is None:
                continue
            # by-value references: callbacks handed around, getattr'd
            # names, nested defs passed to executors
            for ref in lf.name_refs:
                for target in project.resolve_ref(
                    fn.module, fn.class_name, ref
                ):
                    if target.key not in reached:
                        stack.append(target.key)
            # lexical-scope references: the call graph skips nested
            # def/lambda bodies and keys nested functions ambiguously,
            # so any same-module function whose bare name the subtree
            # mentions (incl. from closures) counts as live
            mentioned = _subtree_names(fn)
            for other in fn.module.functions.values():
                if (
                    other.key not in reached
                    and other.node.name in mentioned
                ):
                    stack.append(other.key)

        for fn in project.functions():
            if fn.key in reached:
                continue
            bare = fn.node.name
            if not bare.startswith("_") or (
                bare.startswith("__") and bare.endswith("__")
            ):
                continue
            yield Finding(
                "BTL007", fn.module.path, fn.node.lineno,
                fn.node.col_offset,
                f"`{fn.qualname}()` is reachable from no entry point "
                f"(no route, scheduled callback, thread dispatch, or "
                f"call/reference from live code): dead handler or "
                f"orphaned helper — delete it, or keep it deliberately "
                f"with '# batonlint: allow[BTL007]'",
            )
