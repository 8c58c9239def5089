"""Runbook plane: declarative remediations closing the observe→actuate loop.

Everything below the alerting plane is *advisory* — the ledger
classifies clients, the alert engine pages, and a human (or nobody)
reacts. This module is the reacting half: a :class:`RunbookEngine`
binds alert firings and fleet classifications to concrete, bounded
remediations the manager applies on its own invite path:

``bias_cohort``
    straggler-aware cohort selection — weighted sampling that biases
    round invites *away* from ``slow``/``flaky`` clients without ever
    hard-evicting them (their weight is reduced, never zeroed);
``overprovision``
    deadline-based over-provisioning — invite ``C·(1+ε)`` clients with
    ``ε`` derived from the recent miss (straggler) rate, so the round
    still fills its quorum when the expected fraction misses;
``adaptive_deadline``
    per-round reporting deadline fit from the fleet's observed
    ``train_s`` history (quantile × margin, clamped) instead of the
    static ``round_timeout``;
``fedbuff_fallback``
    asynchronous degradation — when churn classifications cross the
    trigger, finish a round as soon as a FedBuff-style buffer of
    ``ceil(buffer_frac · cohort)`` reports has landed rather than
    waiting out the stragglers (Nguyen et al., the same K-of-N buffer
    semantics as :mod:`baton_tpu_torch.parallel.fedbuff`);
``pin_shapes``
    recompile-storm response — ask workers to pin batch shapes via the
    round envelope and quarantine the storm-offending clients from the
    next cohorts while the storm lasts.

Rules are **data** (parsed and validated exactly like
:class:`~baton_tpu_torch.obs.alerts.AlertRule` — unknown keys fail at load,
the BTL034 lint class), every actuation is **explainable** (the manager
stamps each applied action into the round's ``rounds.jsonl`` record
with the triggering alert/classification and the engine appends
``entered``/``exited`` transitions to ``runbooks.jsonl``), and every
action is **reversible**: a rule holds while its trigger breaches and
exits through the same ``clear_ratio`` hysteresis the alert engine
uses — an ``{"alert": ...}`` trigger literally rides the alert's own
firing/resolved lifecycle, a metric trigger reuses
:meth:`AlertRule.breaches` / :meth:`AlertRule.still_breaching`.

Like the ledger and the alert engine this is an advisory plane: the
manager wraps every actuation site in try/except, and a runbook bug
degrades to "no remediation", never to a broken round.

Pure stdlib; imports nothing from ``server/`` so it unit-tests without
a federation.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import (
    Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple,
)

from baton_tpu_torch.obs.alerts import (
    ALERT_OPS,
    AlertRule,
    AlertRuleError,
    _quantile,
    resolve_view_metric,
)

__all__ = [
    "RunbookRule",
    "RunbookRuleError",
    "RunbookEngine",
    "RUNBOOK_ACTIONS",
    "ACTION_PARAMS",
    "DEFAULT_RUNBOOKS",
    "derive_fleet_view",
    "fit_deadline",
    "overprovision_count",
    "weighted_sample",
    "read_runbooks_jsonl",
]

#: the action catalog — every rule actuates exactly one of these
RUNBOOK_ACTIONS = (
    "bias_cohort",
    "overprovision",
    "adaptive_deadline",
    "fedbuff_fallback",
    "pin_shapes",
)

#: per-action parameter schema with defaults; a rule's ``params`` may
#: only override keys listed here (unknown param => parse error, the
#: same strictness as AlertRule and the BTL034 audit surface)
ACTION_PARAMS: Dict[str, Dict[str, Any]] = {
    # invite weight multiplier applied to clients whose ledger status is
    # in `statuses` — 0 < weight <= 1; never 0, biased clients must
    # still be sampled sometimes (no starvation)
    "bias_cohort": {"weight": 0.25, "statuses": ("slow", "flaky")},
    # ε = min(epsilon_max, gain · trigger_value); trigger_value is the
    # rule's own metric (typically rounds.straggler_rate = recent miss
    # rate), so provisioning tracks how much of the cohort misses
    "overprovision": {"epsilon_max": 0.5, "gain": 1.0},
    # deadline = clamp(quantile(train_s medians) · margin, min_s, max_s)
    "adaptive_deadline": {
        "quantile": 0.95, "margin": 1.5, "min_s": 0.25, "max_s": None,
    },
    # finish as soon as ceil(buffer_frac · cohort) reports have landed
    "fedbuff_fallback": {"buffer_frac": 0.5},
    # pin shapes in the round envelope; optionally quarantine the
    # clients whose observations carried recompile_storm flags
    "pin_shapes": {"quarantine": True},
}

#: statuses a bias_cohort rule may target (ledger classes, minus
#: ``inactive`` — inactive clients are already culled from sampling)
_BIASABLE_STATUSES = ("healthy", "slow", "flaky", "degrading")

#: weight below which a bias would effectively evict — refused at parse
_MIN_BIAS_WEIGHT = 0.01


class RunbookRuleError(ValueError):
    """A runbook rule failed validation — raised at parse time so a
    typo'd runbook pack fails the process start, not silently as a
    remediation that never actuates."""


@dataclass
class RunbookRule:
    """One declarative remediation. Build via :meth:`parse` (strict:
    unknown rule keys AND unknown per-action params are errors)."""

    name: str
    action: str
    trigger: dict
    for_s: float = 0.0
    cooldown_s: float = 30.0
    params: Dict[str, Any] = field(default_factory=dict)
    description: str = ""
    #: internal AlertRule evaluating a metric trigger (None for
    #: ``{"alert": ...}`` triggers, which ride the alert lifecycle)
    _trig: Optional[AlertRule] = None

    _KEYS = ("name", "action", "trigger", "for_s", "cooldown_s",
             "params", "description")
    _TRIGGER_METRIC_KEYS = ("metric", "op", "threshold", "clear_ratio")

    @staticmethod
    def parse(d: dict, ctx: str = "runbook rule") -> "RunbookRule":
        if not isinstance(d, dict):
            raise RunbookRuleError(f"{ctx}: rule must be an object, got "
                                   f"{type(d).__name__}")
        unknown = sorted(set(d) - set(RunbookRule._KEYS))
        if unknown:
            raise RunbookRuleError(f"{ctx}: unknown keys {unknown} "
                                   f"(known: {list(RunbookRule._KEYS)})")
        name = d.get("name")
        if not (isinstance(name, str) and name):
            raise RunbookRuleError(f"{ctx}: `name` must be a non-empty "
                                   f"string")
        action = d.get("action")
        if action not in RUNBOOK_ACTIONS:
            raise RunbookRuleError(f"{ctx} {name!r}: action {action!r} "
                                   f"not in {RUNBOOK_ACTIONS}")
        trigger = d.get("trigger")
        if not isinstance(trigger, dict) or not trigger:
            raise RunbookRuleError(f"{ctx} {name!r}: `trigger` must be a "
                                   f"non-empty object")
        trig_rule: Optional[AlertRule] = None
        if "alert" in trigger:
            extra = sorted(set(trigger) - {"alert"})
            if extra:
                raise RunbookRuleError(
                    f"{ctx} {name!r}: an alert trigger takes only the "
                    f"`alert` key (unknown {extra})")
            if not (isinstance(trigger["alert"], str) and trigger["alert"]):
                raise RunbookRuleError(f"{ctx} {name!r}: trigger `alert` "
                                       f"must be a non-empty string")
        else:
            extra = sorted(
                set(trigger) - set(RunbookRule._TRIGGER_METRIC_KEYS)
            )
            if extra:
                raise RunbookRuleError(
                    f"{ctx} {name!r}: unknown trigger keys {extra} (a "
                    f"trigger is {{'alert': name}} or "
                    f"{list(RunbookRule._TRIGGER_METRIC_KEYS)})")
            # delegate the full metric/op/threshold/clear_ratio
            # validation AND the hysteresis machinery to AlertRule
            try:
                trig_rule = AlertRule.parse(
                    {
                        "name": f"{name}.trigger",
                        "metric": trigger.get("metric"),
                        "op": trigger.get("op", ">"),
                        "threshold": trigger.get("threshold"),
                        "clear_ratio": trigger.get("clear_ratio"),
                    },
                    ctx=f"{ctx} {name!r} trigger",
                )
            except AlertRuleError as exc:
                raise RunbookRuleError(str(exc)) from None
        params = d.get("params", {})
        if not isinstance(params, dict):
            raise RunbookRuleError(f"{ctx} {name!r}: `params` must be an "
                                   f"object")
        schema = ACTION_PARAMS[action]
        bad = sorted(set(params) - set(schema))
        if bad:
            raise RunbookRuleError(
                f"{ctx} {name!r}: unknown params {bad} for action "
                f"{action!r} (known: {sorted(schema)})")
        merged = dict(schema)
        merged.update(params)
        RunbookRule._validate_params(name, action, merged, ctx)
        return RunbookRule(
            name=name,
            action=action,
            trigger=dict(trigger),
            for_s=max(0.0, float(d.get("for_s", 0.0))),
            cooldown_s=max(0.0, float(d.get("cooldown_s", 30.0))),
            params=merged,
            description=str(d.get("description", "")),
            _trig=trig_rule,
        )

    @staticmethod
    def _validate_params(name, action, p, ctx) -> None:
        def _num(key, lo=None, hi=None, optional=False):
            v = p.get(key)
            if v is None and optional:
                return
            try:
                v = float(v)
            except (TypeError, ValueError):
                raise RunbookRuleError(
                    f"{ctx} {name!r}: param {key!r} must be a number"
                ) from None
            if (lo is not None and v < lo) or (hi is not None and v > hi):
                raise RunbookRuleError(
                    f"{ctx} {name!r}: param {key!r}={v:g} out of range "
                    f"[{lo}, {hi}]")
            p[key] = v

        if action == "bias_cohort":
            _num("weight", _MIN_BIAS_WEIGHT, 1.0)
            statuses = p.get("statuses")
            if (not isinstance(statuses, (list, tuple)) or not statuses
                    or any(s not in _BIASABLE_STATUSES for s in statuses)):
                raise RunbookRuleError(
                    f"{ctx} {name!r}: param 'statuses' must be a "
                    f"non-empty subset of {_BIASABLE_STATUSES}")
            p["statuses"] = tuple(statuses)
        elif action == "overprovision":
            _num("epsilon_max", 0.0, 4.0)
            _num("gain", 0.0)
        elif action == "adaptive_deadline":
            _num("quantile", 0.0, 1.0)
            _num("margin", 1.0)
            _num("min_s", 0.0, optional=True)
            _num("max_s", 0.0, optional=True)
        elif action == "fedbuff_fallback":
            _num("buffer_frac", 0.0, 1.0)
            if p["buffer_frac"] <= 0.0:
                raise RunbookRuleError(
                    f"{ctx} {name!r}: buffer_frac must be > 0")
        elif action == "pin_shapes":
            p["quarantine"] = bool(p.get("quarantine", True))

    def trigger_desc(self) -> str:
        """One-line trigger description for explainability records."""
        if "alert" in self.trigger:
            return f"alert:{self.trigger['alert']}"
        t = self._trig
        return f"{t.metric} {t.op} {t._effective_threshold():g}"


#: a reasonable default pack — bias away from stragglers while the
#: straggler_rate alert fires, over-provision on sustained miss rate,
#: fall back to FedBuff buffering under churn, pin shapes on storms.
#: Operators opt in (runbooks default OFF, unlike alerts) by passing
#: ``runbook_rules="default"`` or an explicit list.
DEFAULT_RUNBOOKS = [
    {
        "name": "bias_stragglers",
        "action": "bias_cohort",
        "trigger": {"alert": "straggler_rate"},
        "params": {"weight": 0.25, "statuses": ["slow", "flaky"]},
        "description": "while the straggler_rate alert fires, invite "
                       "slow/flaky clients at quarter weight",
    },
    {
        "name": "overprovision_on_misses",
        "action": "overprovision",
        "trigger": {"metric": "rounds.straggler_rate", "op": ">",
                    "threshold": 0.15},
        "params": {"epsilon_max": 0.5, "gain": 1.5},
        "description": "invite C*(1+eps) with eps tracking the recent "
                       "miss rate",
    },
    {
        "name": "adaptive_deadline_on_misses",
        "action": "adaptive_deadline",
        "trigger": {"metric": "rounds.straggler_rate", "op": ">",
                    "threshold": 0.15},
        "params": {"quantile": 0.95, "margin": 1.5},
        "description": "fit the reporting deadline from observed "
                       "train_s instead of the static round_timeout",
    },
    {
        "name": "fedbuff_on_churn",
        "action": "fedbuff_fallback",
        "trigger": {"metric": "fleet.churn_frac", "op": ">",
                    "threshold": 0.34},
        "params": {"buffer_frac": 0.6},
        "description": "with a third of the active fleet flaky, finish "
                       "rounds on a FedBuff-style report buffer",
    },
    {
        "name": "pin_shapes_on_storm",
        "action": "pin_shapes",
        "trigger": {"alert": "recompile_storm"},
        "description": "pin batch shapes and quarantine storm offenders "
                       "while the recompile_storm alert fires",
    },
]


# ---------------------------------------------------------------------------
# Pure actuation helpers (unit-testable without an engine)


def weighted_sample(
    ids: Sequence[str],
    weights: Dict[str, float],
    k: int,
    rng,
) -> List[str]:
    """Sample ``k`` distinct ids with probability proportional to
    weight (Efraimidis–Spirakis A-Res: key = u^(1/w), take the top k).
    Deterministic under a seeded ``rng``; ids missing from ``weights``
    default to weight 1.0. Weights are floored at a tiny positive value
    so a mis-set weight can bias but never fully exclude a client."""
    k = max(0, min(int(k), len(ids)))
    if k == len(ids):
        return list(ids)
    keyed = []
    for cid in ids:
        w = max(1e-9, float(weights.get(cid, 1.0)))
        keyed.append((rng.random() ** (1.0 / w), cid))
    keyed.sort(key=lambda kv: kv[0], reverse=True)
    return [cid for _, cid in keyed[:k]]


def overprovision_count(
    k: int,
    n_available: int,
    miss_rate: float,
    *,
    epsilon_max: float = 0.5,
    gain: float = 1.0,
) -> Tuple[int, float]:
    """``(inflated_k, epsilon)``: invite ``ceil(k·(1+ε))`` with
    ``ε = min(epsilon_max, gain·miss_rate)``, capped by availability."""
    eps = min(float(epsilon_max), max(0.0, float(gain) * float(miss_rate)))
    inflated = int(math.ceil(k * (1.0 + eps)))
    return max(k, min(int(n_available), inflated)), eps


def fit_deadline(
    train_seconds: Iterable[float],
    *,
    quantile: float = 0.95,
    margin: float = 1.5,
    min_s: Optional[float] = 0.25,
    max_s: Optional[float] = None,
) -> Optional[float]:
    """Reporting deadline fit from per-client observed training times:
    ``clamp(quantile(train_s)·margin, min_s, max_s)``; None when no
    usable history exists (the caller keeps the static timeout)."""
    vals = sorted(
        float(v) for v in train_seconds
        if isinstance(v, (int, float)) and float(v) > 0.0
    )
    if not vals:
        return None
    d = _quantile(vals, min(1.0, max(0.0, float(quantile)))) * float(margin)
    if min_s is not None:
        d = max(d, float(min_s))
    if max_s is not None:
        d = min(d, float(max_s))
    return d


def derive_fleet_view(classified: Optional[Dict[str, dict]]) -> Dict[str, float]:
    """``fleet.*`` metric addresses from one
    :meth:`ClientLedger.classify_all` map — the classification half of
    the trigger namespace (the alert view supplies ``counter:`` /
    ``timer:`` / ``rounds.*``). Fractions are over *active* (non-
    ``inactive``) clients so a drained fleet doesn't dilute churn."""
    m: Dict[str, float] = {}
    if not classified:
        return m
    active = {
        cid: c for cid, c in classified.items()
        if isinstance(c, dict) and c.get("status") != "inactive"
    }
    m["fleet.clients"] = float(len(classified))
    m["fleet.active_clients"] = float(len(active))
    if not active:
        return m
    n = float(len(active))
    by_status: Dict[str, int] = {}
    for c in active.values():
        by_status[c.get("status", "?")] = by_status.get(
            c.get("status", "?"), 0) + 1
    for status in _BIASABLE_STATUSES:
        m[f"fleet.{status}_frac"] = by_status.get(status, 0) / n
    m["fleet.slow_or_flaky_frac"] = (
        by_status.get("slow", 0) + by_status.get("flaky", 0)
    ) / n
    # churn: clients that join rounds but keep missing the window —
    # exactly the flaky classification (+ degrading trending that way)
    m["fleet.churn_frac"] = (
        by_status.get("flaky", 0) + by_status.get("degrading", 0)
    ) / n
    m["fleet.storm_clients"] = float(sum(
        1 for c in active.values() if c.get("storms")
    ))
    return m


def read_runbooks_jsonl(path: str) -> Tuple[List[dict], int]:
    """Tolerant ``runbooks.jsonl`` reader — ``(events, n_torn)``."""
    from baton_tpu_torch.utils.slog import read_rounds_jsonl

    return read_rounds_jsonl(path)


# ---------------------------------------------------------------------------
# Engine


@dataclass
class _ActState:
    state: str = "idle"          # idle | pending | active
    pending_since: Optional[float] = None
    active_since: Optional[float] = None
    cooldown_until: float = 0.0
    episodes: int = 0
    last_value: Any = None
    skip_reason: Optional[str] = None
    actuations: int = 0          # times the manager applied this rule
    history: List[str] = field(default_factory=list)


class RunbookEngine:
    """Steps every runbook rule's idle→active→idle machine against
    successive metric views + the alert engine's firing set.

    One engine per manager; :meth:`evaluate` runs on the same
    ``PeriodicTask`` tick as the alert engine (the runbook view is the
    alert view plus ``fleet.*``). The manager consults
    :meth:`actuation` on its invite/finish paths and reports each
    application back via :meth:`record_actuation` so the status
    snapshot shows rules that are active-but-never-applied (a trigger
    bound to a metric its node never emits, the skip_reason surface).
    """

    def __init__(
        self,
        rules: Optional[Iterable] = None,
        *,
        log_path: Optional[str] = None,
        metrics=None,
        node: str = "manager",
        now: Callable[[], float] = time.time,
    ) -> None:
        parsed: List[RunbookRule] = []
        for i, r in enumerate(rules or ()):
            rule = r if isinstance(r, RunbookRule) else RunbookRule.parse(
                r, ctx=f"runbook rule [{i}]"
            )
            parsed.append(rule)
        names = [r.name for r in parsed]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise RunbookRuleError(f"duplicate runbook rule names: {dupes}")
        self.rules = parsed
        self.node = node
        self.metrics = metrics
        self._now = now
        self._log_path = log_path
        self._log_lock = threading.Lock()
        if log_path:
            os.makedirs(
                os.path.dirname(os.path.abspath(log_path)), exist_ok=True
            )
        self._states: Dict[str, _ActState] = {
            r.name: _ActState() for r in self.rules
        }

    # -- persistence ---------------------------------------------------
    def _append(self, record: dict) -> None:
        if not self._log_path:
            return
        data = json.dumps(record, default=repr) + "\n"
        with self._log_lock:
            with open(self._log_path, "a", encoding="utf-8") as fh:
                fh.write(data)
                fh.flush()

    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)

    def _emit(self, event: str, rule: RunbookRule, st: _ActState,
              now: float, **extra) -> dict:
        rec = {
            "ts": round(now, 6),
            "node": self.node,
            "event": event,
            "rule": rule.name,
            "action": rule.action,
            "trigger": rule.trigger_desc(),
            "value": st.last_value,
            "episode": st.episodes,
        }
        rec.update(extra)
        st.history = (st.history + [event])[-8:]
        self._append(rec)
        return rec

    # -- the tick ------------------------------------------------------
    def evaluate(
        self,
        view: Dict[str, float],
        firing: Sequence[str] = (),
    ) -> List[dict]:
        """Step every rule against one metric view and the currently-
        firing alert names. Returns the emitted transition events.
        Never raises on a bad rule/metric — per-rule failures are
        counted (``runbooks_eval_errors``) and held as skip_reason."""
        now = self._now()
        firing_set = set(firing)
        events: List[dict] = []
        for rule in self.rules:
            st = self._states[rule.name]
            try:
                events.extend(
                    self._step(rule, st, view, firing_set, now)
                )
            except Exception:
                self._inc("runbooks_eval_errors")
        if self.metrics is not None:
            self.metrics.set_gauge(
                "runbooks_active",
                sum(1 for s in self._states.values()
                    if s.state == "active"),
            )
        return events

    def _step(self, rule: RunbookRule, st: _ActState,
              view: Dict[str, float], firing_set: set,
              now: float) -> List[dict]:
        out: List[dict] = []
        if "alert" in rule.trigger:
            # ride the alert's own lifecycle: its clear_ratio hysteresis
            # already separates firing from resolved, so breach==hold
            breach = hold = rule.trigger["alert"] in firing_set
            st.last_value = 1.0 if breach else 0.0
            st.skip_reason = None
        else:
            value, skip = resolve_view_metric(view, rule._trig.metric)
            if value is None:
                st.skip_reason = skip
                return out  # not evaluable: hold state, try next tick
            st.skip_reason = None
            st.last_value = value
            breach = rule._trig.breaches(value)
            hold = rule._trig.still_breaching(value)
        if st.state == "idle":
            if breach and now >= st.cooldown_until:
                st.state = "pending"
                st.pending_since = now
                if rule.for_s <= 0:
                    out.append(self._enter(rule, st, now))
        elif st.state == "pending":
            if not breach:
                st.state = "idle"
                st.pending_since = None
            elif now - st.pending_since >= rule.for_s:
                out.append(self._enter(rule, st, now))
        elif st.state == "active":
            if not hold:
                st.state = "idle"
                st.active_since = None
                st.pending_since = None
                st.cooldown_until = now + rule.cooldown_s
                self._inc("runbooks_exited_total")
                out.append(self._emit(
                    "exited", rule, st, now,
                    cooldown_until=round(st.cooldown_until, 6),
                ))
        return out

    def _enter(self, rule: RunbookRule, st: _ActState, now: float) -> dict:
        st.state = "active"
        st.active_since = now
        st.episodes += 1
        self._inc("runbooks_entered_total")
        return self._emit("entered", rule, st, now, params=rule.params)

    # -- the actuation surface the manager consults --------------------
    def actuation(self, action: str) -> Optional[dict]:
        """The first ACTIVE rule for ``action`` as an explainability
        stub: ``{"action", "rule", "trigger", "value", "params"}`` —
        the manager applies it, extends it with the applied detail, and
        stamps it into the round's ``rounds.jsonl`` record. None when
        no rule for that action is active (the normal path)."""
        for rule in self.rules:
            if rule.action != action:
                continue
            st = self._states[rule.name]
            if st.state == "active":
                return {
                    "action": rule.action,
                    "rule": rule.name,
                    "trigger": rule.trigger_desc(),
                    "value": st.last_value,
                    "params": dict(rule.params),
                }
        return None

    def record_actuation(self, rule_name: str) -> None:
        """The manager applied this rule to a round."""
        st = self._states.get(rule_name)
        if st is not None:
            st.actuations += 1
        self._inc("runbooks_actuations_total")

    def active(self) -> List[str]:
        """Names of currently-active rules."""
        return [r.name for r in self.rules
                if self._states[r.name].state == "active"]

    # -- introspection -------------------------------------------------
    def status_snapshot(self) -> dict:
        """The ``GET /{name}/runbooks`` payload."""
        now = self._now()
        rules = []
        for rule in self.rules:
            st = self._states[rule.name]
            rules.append({
                "name": rule.name,
                "action": rule.action,
                "trigger": rule.trigger_desc(),
                "for_s": rule.for_s,
                "cooldown_s": rule.cooldown_s,
                "params": dict(rule.params),
                "description": rule.description,
                "state": st.state,
                "value": st.last_value,
                "episodes": st.episodes,
                "actuations": st.actuations,
                "active_since": st.active_since,
                "cooldown_until": st.cooldown_until or None,
                "skip_reason": st.skip_reason,
                "recent_transitions": list(st.history),
            })
        active = [r["name"] for r in rules if r["state"] == "active"]
        return {
            "node": self.node,
            "ts": round(now, 6),
            "rules": rules,
            "active": active,
            "summary": {
                "rules": len(rules),
                "active": len(active),
                "actuations": sum(r["actuations"] for r in rules),
            },
        }
