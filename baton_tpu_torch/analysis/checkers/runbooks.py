"""BTL034 — runbook rules must name a cataloged action with known params.

The runbook engine (``baton_tpu_torch/obs/runbooks.py``) is rules-as-data:
an operator pack is a list of dict literals, and a rule whose
``action`` misspells a catalog entry — or whose ``params`` override a
key the action does not define — is rejected at parse time in the
server but only *at runtime*. A pack committed to a scenario file or
test fixture can carry the typo for weeks before anything loads it.
This checker moves that strictness to lint time: any dict literal that
*looks like* a runbook rule (string ``name`` + string ``action`` plus
at least one other rule key) is audited against the action catalog and
its per-action parameter schema, and its ``trigger`` block — when
present as a literal — is shape-checked (exactly ``{"alert": <str>}``,
or a metric form whose selector lives in an evaluable namespace,
``fleet.*`` included).

The catalog below intentionally DUPLICATES the runtime literals
(``RUNBOOK_ACTIONS`` / ``ACTION_PARAMS`` keys /
``derive_fleet_view``'s address list) instead of importing them: the
analysis layer must lint a checkout whose runtime package may not even
import (that is the point of a linter), same policy as every other
checker's mirrored constant. ``tests/test_analysis.py`` pins the two
copies against each other.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from baton_tpu_torch.analysis.engine import Checker, CheckContext, Finding, register

#: mirror of obs/runbooks.py::RUNBOOK_ACTIONS
_ACTIONS = frozenset({
    "bias_cohort",
    "overprovision",
    "adaptive_deadline",
    "fedbuff_fallback",
    "pin_shapes",
})

#: mirror of obs/runbooks.py::ACTION_PARAMS keys, per action
_ACTION_PARAM_KEYS = {
    "bias_cohort": frozenset({"weight", "statuses"}),
    "overprovision": frozenset({"epsilon_max", "gain"}),
    "adaptive_deadline": frozenset({"quantile", "margin", "min_s", "max_s"}),
    "fedbuff_fallback": frozenset({"buffer_frac"}),
    "pin_shapes": frozenset({"quarantine"}),
}

#: keys (beyond name/action) that mark a dict literal as a runbook rule
_RULE_MARKERS = frozenset({
    "trigger", "for_s", "cooldown_s", "params", "description",
})

#: fleet.* addresses derive_fleet_view produces (obs/runbooks.py)
_FLEET_SERIES = frozenset({
    "clients",
    "active_clients",
    "healthy_frac",
    "slow_frac",
    "flaky_frac",
    "degrading_frac",
    "slow_or_flaky_frac",
    "churn_frac",
    "storm_clients",
})

#: rounds.* series shared with the alert evaluator (BTL033's list)
_ROUNDS_SERIES = frozenset({
    "tail",
    "straggler_rate",
    "duration_p95",
    "duration_p95_ratio",
    "recompile_storm_rounds",
    "mfu_mean",
    "mfu_ratio",
})


def _const_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _dict_keys(node: ast.Dict) -> Optional[dict]:
    """``{key: value_node}`` for an all-literal-keyed Dict, else None
    (a ``**spread`` or computed key makes the shape unauditable)."""
    out = {}
    for k, v in zip(node.keys, node.values):
        name = _const_str(k)
        if name is None:
            return None
        out[name] = v
    return out


@register
class RunbookRuleChecker(Checker):
    rule = "BTL034"
    title = "runbook rule names an unknown action, param, or trigger shape"

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
            if "name" not in keys or "action" not in keys:
                continue
            if not (_RULE_MARKERS & set(keys)):
                continue  # not a runbook rule shape
            rule_name = _const_str(keys["name"]) or "?"
            for problem in self._audit(keys):
                findings.append(Finding(
                    self.rule, ctx.path, node.lineno, node.col_offset,
                    f"runbook rule `{rule_name}`: {problem}",
                ))
        return findings

    def _audit(self, keys: dict) -> List[str]:
        problems: List[str] = []
        action = _const_str(keys["action"])
        if action is None:
            return problems  # dynamic action; nothing checkable
        if action not in _ACTIONS:
            problems.append(
                f"action `{action}` is not in the catalog "
                f"{sorted(_ACTIONS)} — the engine would reject the "
                f"pack at load"
            )
            return problems  # param schema is undefined for it
        params = keys.get("params")
        if isinstance(params, ast.Dict):
            pkeys = _dict_keys(params)
            if pkeys is not None:
                known = _ACTION_PARAM_KEYS[action]
                for pk in sorted(set(pkeys) - known):
                    problems.append(
                        f"param `{pk}` is not defined for action "
                        f"`{action}` (known: {sorted(known)}) — the "
                        f"override would never take effect; it is a "
                        f"parse error at load"
                    )
        trigger = keys.get("trigger")
        if isinstance(trigger, ast.Dict):
            tkeys = _dict_keys(trigger)
            if tkeys is not None:
                problems.extend(self._audit_trigger(tkeys))
        return problems

    def _audit_trigger(self, tkeys: dict) -> List[str]:
        if "alert" in tkeys:
            if set(tkeys) != {"alert"}:
                return [
                    "an alert trigger must be exactly `{\"alert\": "
                    "<rule name>}` — extra keys "
                    f"{sorted(set(tkeys) - {'alert'})} are rejected"
                ]
            return []
        if "metric" not in tkeys:
            return [
                "trigger needs either `alert` or a `metric`/`op`/"
                "`threshold` selector"
            ]
        metric = _const_str(tkeys["metric"])
        if metric is None:
            return []  # dynamic selector; nothing checkable
        if metric.startswith("fleet."):
            series = metric[len("fleet."):]
            if series in _FLEET_SERIES:
                return []
            return [
                f"`{metric}` is not a derived fleet series "
                f"(known: {sorted(_FLEET_SERIES)})"
            ]
        if metric.startswith("rounds."):
            series = metric[len("rounds."):]
            if series in _ROUNDS_SERIES:
                return []
            return [
                f"`{metric}` is not a derived rounds series "
                f"(known: {sorted(_ROUNDS_SERIES)})"
            ]
        if metric.startswith(("counter:", "gauge:", "timer:")):
            return []  # BTL033's registry audit owns these forms
        return [
            f"trigger selector `{metric}` is not in the evaluable "
            f"namespace (fleet.*/rounds.*/counter:/gauge:/timer:…)"
        ]
