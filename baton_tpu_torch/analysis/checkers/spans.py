"""BTL031 — span hygiene: close on all paths, propagate traceparent.

Two invariants from ``baton_tpu_torch/utils/tracing.py``:

1. **Spans end on every path.** A manually started span
   (``sp = tracer.start_span(...)``) that is never ``.end()``-ed in a
   ``finally`` block leaks silently: the round's trace just misses the
   phase, and nothing fails. The blessed form is
   ``with tracer.span(...):`` (which ends on every exit path); a
   manual span is allowed only when some ``try/finally`` in the same
   function calls ``<var>.end(...)`` in its ``finally``.

2. **Outbound HTTP under an active span forwards ``traceparent``.**
   An ``aiohttp`` client call (``...session.get/post/put``) made
   inside a ``with ...span(...):`` block that does not build its
   headers through :func:`baton_tpu_torch.utils.tracing.trace_headers`
   breaks the trace right at the process boundary — the worker's spans
   end up in a different trace and the round's timeline silently loses
   its remote half. The ``headers=`` kwarg must be a
   ``trace_headers(...)`` call, or a local name assigned from one in
   the same function.

Scoped to ``server/`` files, like BTL001/BTL030 — that is where the
distributed protocol lives.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from baton_tpu_torch.analysis import _astutil as au
from baton_tpu_torch.analysis.engine import Checker, CheckContext, Finding, register

_HTTP_METHODS = {"get", "post", "put"}


def _is_span_call(node: ast.AST) -> bool:
    """``<anything>.span(...)`` — tracer.span / self.tracer.span."""
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "span"
    )


def _receiver_tail(node: ast.AST) -> Optional[str]:
    """Last identifier of the call receiver: ``self._session.post`` →
    ``_session``; ``sess.get`` → ``sess``."""
    if isinstance(node, ast.Attribute):
        base = node.value
        if isinstance(base, ast.Attribute):
            return base.attr
        if isinstance(base, ast.Name):
            return base.id
    return None


def _is_session_http_call(node: ast.AST) -> bool:
    """An aiohttp client-session verb call: ``....session.get/post/put``
    where the receiver's trailing name mentions a session. The name
    filter keeps ``dict.get`` / ``registry.get`` out of scope."""
    if not (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in _HTTP_METHODS
    ):
        return False
    tail = _receiver_tail(node.func)
    return tail is not None and ("session" in tail.lower() or tail == "sess")


def _is_trace_headers_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if isinstance(func, ast.Name):
        return func.id == "trace_headers"
    if isinstance(func, ast.Attribute):
        return func.attr == "trace_headers"
    return False


def _names_assigned_from_trace_headers(func_node: ast.AST) -> set:
    """Local names bound to a ``trace_headers(...)`` result anywhere in
    the function — accepts the two-statement form
    ``hdrs = trace_headers(...); session.post(..., headers=hdrs)``."""
    names = set()
    for node in ast.walk(func_node):
        if (
            isinstance(node, ast.Assign)
            and _is_trace_headers_call(node.value)
        ):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
    return names


def _finally_ended_names(func_node: ast.AST) -> set:
    """Names ``x`` with a ``x.end(...)`` call inside any ``finally``
    block of the function."""
    names = set()
    for node in ast.walk(func_node):
        if not isinstance(node, ast.Try) or not node.finalbody:
            continue
        for stmt in node.finalbody:
            for sub in ast.walk(stmt):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "end"
                    and isinstance(sub.func.value, ast.Name)
                ):
                    names.add(sub.func.value.id)
    return names


@register
class SpanHygieneChecker(Checker):
    rule = "BTL031"
    title = "span not closed on all paths / traceparent not forwarded"

    def applies_to(self, ctx: CheckContext) -> bool:
        return "server" in ctx.parts

    def check(self, ctx: CheckContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for qual, _cls, func_node in au.iter_function_defs(ctx.tree):
            findings.extend(self._check_manual_spans(ctx, func_node))
            findings.extend(self._check_propagation(ctx, func_node))
        return findings

    # -- invariant 1: manual spans closed in a finally ------------------
    def _check_manual_spans(self, ctx, func_node) -> Iterable[Finding]:
        ended = None  # computed lazily: most functions have no spans
        for node in ast.walk(func_node):
            if not (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "start_span"
            ):
                continue
            if ended is None:
                ended = _finally_ended_names(func_node)
            target = node.targets[0] if len(node.targets) == 1 else None
            name = target.id if isinstance(target, ast.Name) else None
            if name is not None and name in ended:
                continue
            yield Finding(
                self.rule, ctx.path, node.lineno, node.col_offset,
                "manually started span is not closed on all paths: "
                "call `.end()` in a try/finally, or use "
                "`with tracer.span(...)`",
            )

    # -- invariant 2: traceparent on outbound calls under a span --------
    def _check_propagation(self, ctx, func_node) -> Iterable[Finding]:
        span_bodies = []
        for node in ast.walk(func_node):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_span_call(item.context_expr) for item in node.items
            ):
                span_bodies.append(node)
        if not span_bodies:
            return
        ok_names = _names_assigned_from_trace_headers(func_node)
        seen = set()
        for with_node in span_bodies:
            for stmt in with_node.body:
                for node in ast.walk(stmt):
                    if id(node) in seen or not _is_session_http_call(node):
                        continue
                    seen.add(id(node))
                    headers = next(
                        (
                            kw.value for kw in node.keywords
                            if kw.arg == "headers"
                        ),
                        None,
                    )
                    if headers is not None and (
                        _is_trace_headers_call(headers)
                        or (
                            isinstance(headers, ast.Name)
                            and headers.id in ok_names
                        )
                    ):
                        continue
                    yield Finding(
                        self.rule, ctx.path, node.lineno, node.col_offset,
                        "outbound HTTP call under an active span must "
                        "forward `traceparent`: pass "
                        "`headers=trace_headers(...)` "
                        "(baton_tpu_torch/utils/tracing.py)",
                    )
