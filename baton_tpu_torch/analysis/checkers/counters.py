"""BTL030 — metric names must be declared in the registry.

Dashboards and the ops alert rules key on exact metric names; a typo
at an ``metrics.inc("updates_recieved")`` call site silently forks the
series and the alert never fires. Every counter name used under
``server/`` or ``loadgen/`` must appear in ``DECLARED_COUNTERS`` (or
match a prefix in
``DECLARED_COUNTER_PREFIXES``, for families built with f-strings),
every timer/histogram name observed via ``.observe()``/``.timer()`` in
``DECLARED_TIMERS``, and every gauge set via ``.set_gauge()`` in
``DECLARED_GAUGES`` — all in ``baton_tpu_torch/utils/metrics.py``.

The registry is parsed as AST literals by the engine — linting never
imports package code — and handed to this checker via
``ctx.counter_registry`` (a normalized dict; legacy 2-tuple fixtures
disable the timer/gauge audits). Dynamic counter names (f-strings,
variables) are checked against the declared prefixes when the static
prefix of the f-string resolves, and skipped otherwise; timers and
gauges have no prefix families, so only static names are audited.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from baton_tpu_torch.analysis.engine import Checker, CheckContext, Finding, register

_INC_METHODS = {"inc"}
_TIMER_METHODS = {"observe", "timer"}
_GAUGE_METHODS = {"set_gauge"}


def _static_prefix(node: ast.AST) -> Optional[str]:
    """The compile-time-known leading text of a counter-name argument:
    the whole string for a constant, the leading literal chunk for an
    f-string, None when nothing is statically known."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr) and node.values:
        first = node.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return first.value
    return None


def _name_args(node: ast.Call) -> list:
    """The metric-name argument, with conditional names unrolled:
    ``"a" if cond else "b"`` picks one of two metrics at runtime, so
    each branch is checked."""
    stack, args = [node.args[0]], []
    while stack:
        a = stack.pop()
        if isinstance(a, ast.IfExp):
            stack.extend((a.body, a.orelse))
        else:
            args.append(a)
    return args


@register
class CounterRegistryChecker(Checker):
    rule = "BTL030"
    title = "metric name not declared in utils/metrics.py registry"

    def applies_to(self, ctx: CheckContext) -> bool:
        # loadgen drives the server over HTTP and publishes its own
        # scenario_* series into the same dashboards, so its call sites
        # are audited against the same registry
        return (
            "server" in ctx.parts or "loadgen" in ctx.parts
        ) and ctx.counter_registry is not None

    def check(self, ctx: CheckContext) -> Iterable[Finding]:
        reg = ctx.counter_registry
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not (
                isinstance(func, ast.Attribute) and node.args
            ):
                continue
            if func.attr in _INC_METHODS:
                findings.extend(self._check_counter(ctx, node, reg))
            elif func.attr in _TIMER_METHODS and reg["timers"] is not None:
                findings.extend(self._check_named(
                    ctx, node, reg["timers"], "timer", "DECLARED_TIMERS"
                ))
            elif func.attr in _GAUGE_METHODS and reg["gauges"] is not None:
                findings.extend(self._check_named(
                    ctx, node, reg["gauges"], "gauge", "DECLARED_GAUGES"
                ))
        return findings

    def _check_counter(self, ctx, node, reg) -> Iterable[Finding]:
        declared = reg["counters"]
        prefixes = reg["counter_prefixes"]
        for arg in _name_args(node):
            is_exact = isinstance(arg, ast.Constant)
            prefix = _static_prefix(arg)
            if prefix is None:
                continue  # fully dynamic name; nothing checkable
            if is_exact:
                if prefix in declared or any(
                    prefix.startswith(p) for p in prefixes
                ):
                    continue
            else:
                # f-string family: its literal head must extend one
                # of the declared prefixes (or a declared prefix
                # must extend it, for short heads like f"up_{x}")
                if any(
                    prefix.startswith(p) or p.startswith(prefix)
                    for p in prefixes
                ):
                    continue
            yield Finding(
                self.rule, ctx.path, node.lineno, node.col_offset,
                f"counter `{prefix}{'' if is_exact else '...'}` "
                f"is not declared in DECLARED_COUNTERS"
                f"{'' if is_exact else ' / DECLARED_COUNTER_PREFIXES'}"
                f" (baton_tpu_torch/utils/metrics.py); declare it or "
                f"fix the typo",
            )

    def _check_named(
        self, ctx, node, declared, kind, registry_name
    ) -> Iterable[Finding]:
        # timers/gauges have no runtime-suffix families: only exact
        # static names are audited, dynamic names are skipped
        for arg in _name_args(node):
            if not (
                isinstance(arg, ast.Constant) and isinstance(arg.value, str)
            ):
                continue
            if arg.value in declared:
                continue
            yield Finding(
                self.rule, ctx.path, node.lineno, node.col_offset,
                f"{kind} `{arg.value}` is not declared in "
                f"{registry_name} (baton_tpu_torch/utils/metrics.py); "
                f"declare it or fix the typo",
            )
