"""Shared AST helpers for the batonlint checkers."""

from __future__ import annotations

import ast
from typing import Callable, Dict, Iterator, Optional, Set

_FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

# attribute reads that are static (concrete) even on a JAX tracer
STATIC_ATTRS = {"shape", "dtype", "ndim"}

# container mutators whose tainted argument taints the receiver
CONTAINER_MUTATORS = {
    "append", "extend", "insert", "add", "update", "setdefault",
}


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None (calls,
    subscripts and other dynamic receivers don't resolve statically)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base is not None else None
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def walk_shallow(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body WITHOUT descending into nested function
    definitions or lambdas.

    Nested defs are separate execution contexts — in async code they
    are typically closures handed to ``to_thread``/``run_in_executor``
    (so blocking work inside them is exactly the sanctioned routing),
    and they get their own analysis where relevant.
    """
    todo = list(ast.iter_child_nodes(node))
    while todo:
        child = todo.pop()
        yield child
        if not isinstance(child, _FUNCTION_NODES):
            todo.extend(ast.iter_child_nodes(child))


def iter_function_defs(tree: ast.AST) -> Iterator[tuple]:
    """Yield ``(qualname, class_name, node)`` for every def/async def.

    ``qualname`` is ``Class.method`` for methods, the bare name
    otherwise (nested functions keep their own bare name — good enough
    for same-module call-graph resolution).
    """

    def visit(node: ast.AST, class_name: Optional[str]) -> Iterator[tuple]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = (
                    f"{class_name}.{child.name}" if class_name else child.name
                )
                yield qual, class_name, child
                yield from visit(child, class_name)
            else:
                yield from visit(child, class_name)

    yield from visit(tree, None)


def sync_function_index(tree: ast.AST) -> Dict[str, ast.FunctionDef]:
    """``{qualname: node}`` for plain (non-async) defs — the targets a
    same-module call-graph walk can resolve."""
    return {
        qual: node
        for qual, _cls, node in iter_function_defs(tree)
        if isinstance(node, ast.FunctionDef)
    }


def resolve_local_call(
    call: ast.Call, class_name: Optional[str]
) -> Optional[str]:
    """Map a call expression to a same-module qualname candidate:
    ``self.helper(...)`` -> ``Class.helper``; ``helper(...)`` ->
    ``helper``. Anything else (other objects, dynamic) -> None."""
    func = call.func
    if isinstance(func, ast.Name):
        return func.id
    if (
        isinstance(func, ast.Attribute)
        and isinstance(func.value, ast.Name)
        and func.value.id in ("self", "cls")
        and class_name is not None
    ):
        return f"{class_name}.{func.attr}"
    return None


def make_taint_oracle(
    tainted: Set[str],
    call_taint: Optional[Callable[[ast.Call], Optional[bool]]] = None,
) -> Callable[[ast.AST], bool]:
    """Predicate: does this expression produce a traced value, given
    the current taint set (bare names and dotted ``self.attr`` paths)?

    ``call_taint``, when given, may override the verdict for a Call
    node (True/False), or return None to fall back to the default rule
    (a call consuming a tainted value returns a tainted value)."""

    def expr_tainted(expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if isinstance(expr, ast.Attribute):
            if expr.attr in STATIC_ATTRS:
                return False
            dotted = dotted_name(expr)
            if dotted is not None and dotted in tainted:
                return True
            return expr_tainted(expr.value)
        if isinstance(expr, _FUNCTION_NODES):
            return False
        if isinstance(expr, ast.Call):
            if call_taint is not None:
                verdict = call_taint(expr)
                if verdict is not None:
                    return verdict
            if expr_tainted(expr.func):
                return True
            return any(expr_tainted(a) for a in expr.args) or any(
                expr_tainted(k.value) for k in expr.keywords
            )
        return any(
            expr_tainted(child)
            for child in ast.iter_child_nodes(expr)
            if isinstance(child, ast.expr)
        )

    return expr_tainted


def taint_target(target: ast.AST, add: Callable[[str], None]) -> None:
    """Record an assignment target as tainted: names directly, dotted
    ``self.x`` paths by path, container element writes by container."""
    if isinstance(target, ast.Name):
        add(target.id)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            taint_target(elt, add)
    elif isinstance(target, ast.Starred):
        taint_target(target.value, add)
    elif isinstance(target, ast.Attribute):
        dotted = dotted_name(target)
        if dotted is not None:
            add(dotted)
        else:
            taint_target(target.value, add)
    elif isinstance(target, ast.Subscript):
        # d["k"] = tracer: reading ANY element of d may now yield it
        taint_target(target.value, add)


def propagate_taint(
    body: list, tainted: Set[str], expr_tainted
) -> bool:
    """One propagation pass over every statement (nested defs included
    — they trace as part of the same computation); True when the taint
    set grew."""
    changed = False

    def add(name: Optional[str]) -> None:
        nonlocal changed
        if name and name not in tainted:
            tainted.add(name)
            changed = True

    def call_args_tainted(call: ast.Call) -> bool:
        return any(expr_tainted(a) for a in call.args) or any(
            expr_tainted(k.value) for k in call.keywords
        )

    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Assign):
                if expr_tainted(node.value):
                    for t in node.targets:
                        taint_target(t, add)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                if node.value is not None and (
                    expr_tainted(node.value)
                    or (
                        isinstance(node, ast.AugAssign)
                        and expr_tainted(node.target)
                    )
                ):
                    taint_target(node.target, add)
            elif isinstance(node, ast.NamedExpr):
                if expr_tainted(node.value):
                    taint_target(node.target, add)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                if expr_tainted(node.iter):
                    taint_target(node.target, add)
            elif isinstance(node, ast.withitem):
                if node.optional_vars is not None and expr_tainted(
                    node.context_expr
                ):
                    taint_target(node.optional_vars, add)
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in CONTAINER_MUTATORS
                and call_args_tainted(node)
            ):
                taint_target(node.func.value, add)
    return changed


def param_names(node) -> set:
    args = node.args
    names = [
        a.arg
        for a in (
            list(getattr(args, "posonlyargs", []))
            + list(args.args)
            + list(args.kwonlyargs)
        )
    ]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return set(names)
