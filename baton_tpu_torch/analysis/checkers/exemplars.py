"""BTL032 — declared-exemplar timers must observe with span context.

The fleet health plane links a histogram's worst recent observation
to its round trace: ``Metrics.observe(name, seconds, exemplar=…)``
stores the trace/span id of the p99 spike so an operator can jump from
"round_s regressed" straight to the offending round's trace document.
That linkage only works if every ``observe`` call site on an
exemplar-declared timer actually passes the context — one bare
``metrics.observe("round_s", dt)`` and the exemplar silently pins to
whichever *other* call site last beat it, and the p99→trace jump rots
without any test failing.

The set of timers that promise exemplars is declared next to the other
metric registries: ``DECLARED_EXEMPLAR_TIMERS`` in
``baton_tpu_torch/utils/metrics.py``, parsed as an AST literal by the engine
(never imported) and handed to checkers via
``ctx.counter_registry["exemplar_timers"]``. Scoped to ``server/`` and
``loadgen/`` like BTL030 — utils code (the ``timer()`` context manager
itself) is the mechanism, not a call site.

Flagged:

- ``metrics.observe("round_s", dt)`` — no ``exemplar=`` at all.
- ``metrics.observe("round_s", dt, exemplar=None)`` — a literal None
  defeats the declaration; pass ``tracing.current_context()`` (which
  may *return* None outside a span — that is fine, the decision is
  made at runtime, not hardcoded at the call site).

Suppress a genuinely context-free site with
``# batonlint: allow[BTL032]``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from baton_tpu_torch.analysis.engine import Checker, CheckContext, Finding, register


@register
class ExemplarCoverageChecker(Checker):
    rule = "BTL032"
    title = "exemplar-declared timer observed without span context"

    def applies_to(self, ctx: CheckContext) -> bool:
        reg = ctx.counter_registry
        return (
            ("server" in ctx.parts or "loadgen" in ctx.parts)
            and reg is not None
            and reg.get("exemplar_timers") is not None
        )

    def check(self, ctx: CheckContext) -> Iterable[Finding]:
        declared = ctx.counter_registry["exemplar_timers"]
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not (
                isinstance(func, ast.Attribute)
                and func.attr == "observe"
                and node.args
            ):
                continue
            name = node.args[0]
            if not (
                isinstance(name, ast.Constant)
                and isinstance(name.value, str)
                and name.value in declared
            ):
                continue
            exemplar = next(
                (kw.value for kw in node.keywords
                 if kw.arg == "exemplar"),
                None,
            )
            # a third positional arg is also an exemplar
            if exemplar is None and len(node.args) >= 3:
                exemplar = node.args[2]
            if exemplar is None:
                findings.append(Finding(
                    self.rule, ctx.path, node.lineno, node.col_offset,
                    f"timer `{name.value}` is in "
                    f"DECLARED_EXEMPLAR_TIMERS but this observe() "
                    f"passes no exemplar= — pass "
                    f"tracing.current_context() (or the round's "
                    f"trace/span ids) so the p99 exemplar keeps "
                    f"linking to a trace",
                ))
            elif (
                isinstance(exemplar, ast.Constant)
                and exemplar.value is None
            ):
                findings.append(Finding(
                    self.rule, ctx.path, node.lineno, node.col_offset,
                    f"timer `{name.value}` observe() hardcodes "
                    f"exemplar=None — that defeats the "
                    f"DECLARED_EXEMPLAR_TIMERS declaration; pass the "
                    f"active span context instead",
                ))
        return findings
