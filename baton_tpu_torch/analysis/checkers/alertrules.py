"""BTL033 — alert rule metric selectors must reference declared metrics.

BTL030 closes the producer half of the "typo forks the series" failure
mode; this closes the consumer half: an alert rule whose ``metric``
selector misspells a name (``timer:loop_lags_s:p95``) parses fine,
evaluates to "not present this tick" forever, and the alert silently
never fires — the exact failure ``checkers/counters.py`` was written
about. Any dict literal that *looks like* an alert rule (string
``name`` + string ``metric`` plus at least one other rule key) has its
selector audited against the same AST-parsed ``DECLARED_*`` registry:

- ``counter:<n>`` — ``n`` in ``DECLARED_COUNTERS`` or extending a
  ``DECLARED_COUNTER_PREFIXES`` family;
- ``gauge:<n>`` — ``n`` in ``DECLARED_GAUGES``;
- ``timer:<t>:<stat>`` — ``t`` in ``DECLARED_TIMERS`` and ``<stat>``
  one of the engine's stat suffixes;
- ``rounds.<series>`` — one of the derived series the engine computes
  from the ``rounds.jsonl`` tail (structural, not registry-backed).

Anything else is a finding. Legacy 2-tuple registry fixtures carry no
timer/gauge sets; those address forms are skipped there, matching
BTL030's degradation.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from baton_tpu_torch.analysis.engine import Checker, CheckContext, Finding, register

#: timer stat suffixes the engine resolves (obs/alerts.py TIMER_STATS)
_TIMER_STATS = frozenset({"count", "mean", "p50", "p95", "p99", "max"})

#: rounds.* series derived from the rounds.jsonl tail
#: (obs/alerts.py::derive_rounds_tail)
_ROUNDS_SERIES = frozenset({
    "tail",
    "straggler_rate",
    "duration_p95",
    "duration_p95_ratio",
    "recompile_storm_rounds",
    "mfu_mean",
    "mfu_ratio",
})

#: keys (beyond name/metric) that mark a dict literal as an alert rule
_RULE_MARKERS = frozenset({
    "op", "threshold", "burn_rate", "for_s", "cooldown_s", "severity",
    "capture", "clear_ratio",
})


def _const_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


@register
class AlertRuleMetricChecker(Checker):
    rule = "BTL033"
    title = "alert rule selects a metric absent from the DECLARED_* registry"

    def applies_to(self, ctx: CheckContext) -> bool:
        # rule packs can live anywhere (obs/ default pack, tests,
        # operator configs) — audit every module once a registry exists
        return ctx.counter_registry is not None

    def check(self, ctx: CheckContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Dict):
                continue
            keys = {}
            for k, v in zip(node.keys, node.values):
                name = _const_str(k)
                if name is not None:
                    keys[name] = v
            if "name" not in keys or "metric" not in keys:
                continue
            if not (_RULE_MARKERS & set(keys)):
                continue  # not an alert rule shape (e.g. SLO assertion)
            metric = _const_str(keys["metric"])
            if metric is None:
                continue  # dynamic selector; nothing checkable
            problem = self._audit(metric, ctx.counter_registry)
            if problem:
                rule_name = _const_str(keys["name"]) or "?"
                findings.append(Finding(
                    self.rule, ctx.path, node.lineno, node.col_offset,
                    f"alert rule `{rule_name}`: {problem} — the rule "
                    f"would silently never fire; fix the selector or "
                    f"declare the metric in baton_tpu_torch/utils/metrics.py",
                ))
        return findings

    def _audit(self, metric: str, reg) -> Optional[str]:
        """None when the selector resolves; else the problem text."""
        if metric.startswith("counter:"):
            name = metric[len("counter:"):]
            if name in reg["counters"] or any(
                name.startswith(p) for p in reg["counter_prefixes"]
            ):
                return None
            return (f"counter `{name}` is not declared in "
                    f"DECLARED_COUNTERS / DECLARED_COUNTER_PREFIXES")
        if metric.startswith("gauge:"):
            if reg["gauges"] is None:
                return None  # legacy fixture registry: no gauge audit
            name = metric[len("gauge:"):]
            if name in reg["gauges"]:
                return None
            return f"gauge `{name}` is not declared in DECLARED_GAUGES"
        if metric.startswith("timer:"):
            parts = metric.split(":")
            if len(parts) != 3:
                return (f"timer selector `{metric}` must be "
                        f"`timer:<name>:<stat>`")
            _, name, stat = parts
            if stat not in _TIMER_STATS:
                return (f"timer stat `{stat}` is not one of "
                        f"{sorted(_TIMER_STATS)}")
            if reg["timers"] is None or name in reg["timers"]:
                return None
            return f"timer `{name}` is not declared in DECLARED_TIMERS"
        if metric.startswith("rounds."):
            series = metric[len("rounds."):]
            if series in _ROUNDS_SERIES:
                return None
            return (f"`{metric}` is not a derived rounds series "
                    f"(known: {sorted(_ROUNDS_SERIES)})")
        return (f"selector `{metric}` is not in the evaluable namespace "
                f"(counter:/gauge:/timer:<n>:<stat>/rounds.*)")
