"""Alerting plane: declarative rules over the live metric namespace.

The system *measures* everything — round traces, per-client health,
per-round MFU/compile/HBM — but until this module nothing *watched*
the measurements: ``utils/metrics.py`` justifies its name registry by
"dashboards and alert rules", yet no alert rule was ever evaluable.
:class:`AlertEngine` closes that gap with rules **as data** evaluated
in-process by a ``PeriodicTask`` on the manager and every edge.

A rule selects one metric from the node's own flattened namespace —
the same addressing scheme :mod:`baton_tpu_torch.loadgen.slo` uses:

``counter:<name>`` / ``gauge:<name>``
    straight from the node's :meth:`Metrics.snapshot` (counters are
    absence-is-zero, exactly like the SLO evaluator);
``timer:<name>:<stat>``
    histogram stats, ``<stat>`` in ``count``/``mean``/``p50``/``p95``/
    ``p99``/``max`` (e.g. ``timer:loop_lag_s:p95``);
``rounds.<derived>``
    derived from the tail of the node's ``rounds.jsonl`` stream (the
    manager mirrors every appended record into a bounded deque so the
    evaluator never does blocking file IO on the loop): ``tail``,
    ``straggler_rate``, ``duration_p95``, ``duration_p95_ratio``
    (recent-half p95 over older-half p95 — the regression detector),
    ``recompile_storm_rounds``, ``mfu_mean``, ``mfu_ratio``
    (recent-half mean over older-half — falling means degrading).

Rules compare with a scalar ``threshold`` or a multi-window
**burn-rate pair** (Google SRE Workbook): a counter's per-second rate
over a short AND a long window, both of which must breach before the
rule trips — the short window gives fast detection, the long window
vetoes blips. Windowed rates come from the node's metrics-history ring.

Lifecycle per rule: ``ok → pending → firing → resolved(→ok)``.
``for_s`` holds a breach in ``pending`` before it may fire (transient
spikes never page); hysteresis resolves only when the value *clearly*
recovers (``clear_ratio`` scales the threshold, so flapping around the
line stays one firing episode); ``cooldown_s`` after a resolve
suppresses an immediate re-fire. Every transition is appended to
``alerts.jsonl`` with the same single-``write()``+flush crash-safety as
``rounds.jsonl``, and the engine exports ``alerts_*`` gauges/counters.

Rules marked ``capture: true`` invoke the engine's ``on_capture`` hook
when they fire (rate-limited per rule by ``cooldown_s``) — the manager
uses it to arm a forensics bundle for the next round
(:mod:`baton_tpu_torch.obs.forensics`).

The evaluator is an **advisory plane**: like the fleet ledger, a
failure inside rule resolution or the evaluation tick must never break
round completion. Per-rule resolution errors are counted
(``alerts_eval_errors``) and surfaced as ``skip_reason`` in the status
snapshot; the owning tick wraps the whole evaluation in try/except.

Pure stdlib; imports nothing from ``server/`` so it unit-tests without
a federation.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import (
    Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple,
)

__all__ = [
    "AlertRule",
    "AlertRuleError",
    "AlertEngine",
    "DEFAULT_RULES",
    "ALERT_OPS",
    "ALERT_SEVERITIES",
    "TIMER_STATS",
    "build_metric_view",
    "derive_rounds_tail",
    "resolve_view_metric",
    "windowed_rate",
    "read_alerts_jsonl",
]

#: comparators a rule may use (breach when ``value <op> threshold``)
ALERT_OPS = (">", ">=", "<", "<=", "==")
ALERT_SEVERITIES = ("info", "warn", "page")

#: timer stat address suffix -> snapshot key (same table as loadgen/slo)
TIMER_STATS = {
    "count": "count",
    "mean": "mean_s",
    "p50": "p50_s",
    "p95": "p95_s",
    "p99": "p99_s",
    "max": "max_s",
}

#: namespace prefixes where an absent address means "never incremented",
#: i.e. resolves to 0.0 — identical rule to loadgen/slo.resolve_metric
_ZERO_DEFAULT_PREFIXES = ("counter:",)


class AlertRuleError(ValueError):
    """A rule dict failed validation (unknown key, bad op, no
    threshold) — raised at parse time so a typo'd rule pack fails the
    process start, not silently at the first evaluation."""


@dataclass
class AlertRule:
    """One declarative rule. Build via :meth:`parse` (strict: unknown
    keys are errors, the BTL033 class of typo fails loudly)."""

    name: str
    metric: str
    op: str = ">"
    threshold: Optional[float] = None
    #: multi-window burn-rate pair: ``{"short_s", "long_s", "threshold"}``
    #: — the metric must be a ``counter:`` address; the rule breaches
    #: only when the counter's per-second rate over BOTH windows is
    #: ``op`` the pair's threshold
    burn_rate: Optional[dict] = None
    for_s: float = 0.0
    cooldown_s: float = 60.0
    severity: str = "warn"
    capture: bool = False
    #: hysteresis: while firing, the rule resolves only when the value
    #: stops breaching ``threshold * clear_ratio``; defaults to 0.9 for
    #: upper-bound ops and 1/0.9 for lower-bound ops (``==`` gets 1.0)
    clear_ratio: Optional[float] = None
    description: str = ""

    _KEYS = ("name", "metric", "op", "threshold", "burn_rate", "for_s",
             "cooldown_s", "severity", "capture", "clear_ratio",
             "description")

    @staticmethod
    def parse(d: dict, ctx: str = "alert rule") -> "AlertRule":
        if not isinstance(d, dict):
            raise AlertRuleError(f"{ctx}: rule must be an object, got "
                                 f"{type(d).__name__}")
        unknown = sorted(set(d) - set(AlertRule._KEYS))
        if unknown:
            raise AlertRuleError(f"{ctx}: unknown keys {unknown} "
                                 f"(known: {list(AlertRule._KEYS)})")
        name = d.get("name")
        metric = d.get("metric")
        if not (isinstance(name, str) and name):
            raise AlertRuleError(f"{ctx}: `name` must be a non-empty string")
        if not (isinstance(metric, str) and metric):
            raise AlertRuleError(f"{ctx} {name!r}: `metric` must be a "
                                 f"non-empty string")
        op = d.get("op", ">")
        if op not in ALERT_OPS:
            raise AlertRuleError(f"{ctx} {name!r}: op {op!r} not in "
                                 f"{ALERT_OPS}")
        severity = d.get("severity", "warn")
        if severity not in ALERT_SEVERITIES:
            raise AlertRuleError(f"{ctx} {name!r}: severity {severity!r} "
                                 f"not in {ALERT_SEVERITIES}")
        threshold = d.get("threshold")
        burn = d.get("burn_rate")
        if (threshold is None) == (burn is None):
            raise AlertRuleError(f"{ctx} {name!r}: exactly one of "
                                 f"`threshold` or `burn_rate` is required")
        if burn is not None:
            if not isinstance(burn, dict):
                raise AlertRuleError(f"{ctx} {name!r}: burn_rate must be "
                                     f"an object")
            missing = sorted(
                {"short_s", "long_s", "threshold"} - set(burn)
            )
            extra = sorted(
                set(burn) - {"short_s", "long_s", "threshold"}
            )
            if missing or extra:
                raise AlertRuleError(
                    f"{ctx} {name!r}: burn_rate needs exactly "
                    f"short_s/long_s/threshold "
                    f"(missing {missing}, unknown {extra})")
            if not float(burn["short_s"]) < float(burn["long_s"]):
                raise AlertRuleError(f"{ctx} {name!r}: burn_rate short_s "
                                     f"must be < long_s")
            if not metric.startswith("counter:"):
                raise AlertRuleError(
                    f"{ctx} {name!r}: burn_rate rules need a `counter:` "
                    f"metric address, got {metric!r}")
        clear = d.get("clear_ratio")
        if clear is not None and not float(clear) > 0:
            raise AlertRuleError(f"{ctx} {name!r}: clear_ratio must be > 0")
        return AlertRule(
            name=name,
            metric=metric,
            op=op,
            threshold=None if threshold is None else float(threshold),
            burn_rate=None if burn is None else {
                "short_s": float(burn["short_s"]),
                "long_s": float(burn["long_s"]),
                "threshold": float(burn["threshold"]),
            },
            for_s=max(0.0, float(d.get("for_s", 0.0))),
            cooldown_s=max(0.0, float(d.get("cooldown_s", 60.0))),
            severity=severity,
            capture=bool(d.get("capture", False)),
            clear_ratio=None if clear is None else float(clear),
            description=str(d.get("description", "")),
        )

    # -- comparison ----------------------------------------------------
    def _effective_threshold(self) -> float:
        return (self.burn_rate["threshold"] if self.burn_rate is not None
                else self.threshold)

    def _clear_threshold(self) -> float:
        thr = self._effective_threshold()
        ratio = self.clear_ratio
        if ratio is None:
            if self.op in (">", ">="):
                ratio = 0.9
            elif self.op in ("<", "<="):
                ratio = 1.0 / 0.9
            else:
                ratio = 1.0
        return thr * ratio

    def _cmp(self, value: float, threshold: float) -> bool:
        if self.op == ">":
            return value > threshold
        if self.op == ">=":
            return value >= threshold
        if self.op == "<":
            return value < threshold
        if self.op == "<=":
            return value <= threshold
        return value == threshold

    def breaches(self, value: Any) -> bool:
        """Does ``value`` trip the rule? Burn-rate values are
        ``{"short": rate, "long": rate}`` and BOTH windows must trip."""
        thr = self._effective_threshold()
        if self.burn_rate is not None:
            return (self._cmp(float(value["short"]), thr)
                    and self._cmp(float(value["long"]), thr))
        return self._cmp(float(value), thr)

    def still_breaching(self, value: Any) -> bool:
        """The hysteresis comparison used while FIRING: the alert holds
        until the value stops breaching the *clear* threshold, so a
        flap that dips just under the trigger line does not resolve.
        Burn-rate rules clear on the short window (it recovers first)."""
        clear = self._clear_threshold()
        if self.burn_rate is not None:
            return self._cmp(float(value["short"]), clear)
        return self._cmp(float(value), clear)


#: the default rule pack every node evaluates unless the operator
#: passes an explicit list (``rules=()`` disables alerting). Metric
#: selectors are audited against the DECLARED_* registries by batonlint
#: BTL033 — a typo here would otherwise mean "the alert never fires".
DEFAULT_RULES = [
    {
        "name": "straggler_rate",
        "metric": "rounds.straggler_rate",
        "op": ">",
        "threshold": 0.25,
        "for_s": 0.0,
        "cooldown_s": 60.0,
        "severity": "page",
        "capture": True,
        "description": "more than a quarter of recent participants "
                       "straggled past the reporting window",
    },
    {
        "name": "round_duration_p95_regression",
        "metric": "rounds.duration_p95_ratio",
        "op": ">",
        "threshold": 2.0,
        "for_s": 5.0,
        "cooldown_s": 120.0,
        "severity": "warn",
        "description": "recent rounds' p95 duration doubled vs the "
                       "older half of the tail window",
    },
    {
        "name": "recompile_storm",
        "metric": "rounds.recompile_storm_rounds",
        "op": ">=",
        "threshold": 1.0,
        "for_s": 0.0,
        "cooldown_s": 120.0,
        "severity": "warn",
        "capture": True,
        "description": "a recent round saw recompile storms (shape "
                       "churn recompiling XLA every call)",
    },
    {
        "name": "degrading_mfu",
        "metric": "rounds.mfu_ratio",
        "op": "<",
        "threshold": 0.67,
        "for_s": 5.0,
        "cooldown_s": 120.0,
        "severity": "warn",
        "description": "fleet MFU over recent rounds fell by a third "
                       "vs the older half of the tail window",
    },
    {
        "name": "loop_lag",
        "metric": "timer:loop_lag_s:p95",
        "op": ">",
        "threshold": 0.5,
        "for_s": 2.0,
        "cooldown_s": 60.0,
        "severity": "page",
        "capture": True,
        "description": "event-loop scheduling delay p95 above 500ms — "
                       "something synchronous is hogging the loop",
    },
]


# ---------------------------------------------------------------------------
# Metric view: the flat namespace one evaluation tick sees


def derive_rounds_tail(
    records: Sequence[dict], window: int = 8
) -> Dict[str, float]:
    """``rounds.*`` series from the last ``window`` round records
    (oldest first). Ratio metrics split the window in half; they only
    exist once both halves have data — a rule on a ratio simply skips
    until then (absent metric => not evaluable, never a crash)."""
    tail = [r for r in records if isinstance(r, dict)][-max(1, window):]
    m: Dict[str, float] = {}
    if not tail:
        return m
    m["rounds.tail"] = float(len(tail))
    participants = sum(_count(r.get("participants")) for r in tail)
    if participants:
        m["rounds.straggler_rate"] = sum(
            _count(r.get("stragglers")) for r in tail
        ) / participants
    durs = [float(r["duration_s"]) for r in tail
            if r.get("outcome") == "completed"
            and isinstance(r.get("duration_s"), (int, float))]
    if durs:
        m["rounds.duration_p95"] = _quantile(sorted(durs), 0.95)
        if len(durs) >= 4:
            half = len(durs) // 2
            older = _quantile(sorted(durs[:half]), 0.95)
            recent = _quantile(sorted(durs[half:]), 0.95)
            if older > 0:
                m["rounds.duration_p95_ratio"] = recent / older
    m["rounds.recompile_storm_rounds"] = float(sum(
        1 for r in tail
        if isinstance(r.get("compute"), dict)
        and r["compute"].get("recompile_storms")
    ))
    mfus = [float(r["compute"]["mfu"]) for r in tail
            if isinstance(r.get("compute"), dict)
            and isinstance(r["compute"].get("mfu"), (int, float))]
    if mfus:
        m["rounds.mfu_mean"] = sum(mfus) / len(mfus)
        if len(mfus) >= 4:
            half = len(mfus) // 2
            older = sum(mfus[:half]) / half
            recent = sum(mfus[half:]) / (len(mfus) - half)
            if older > 0:
                m["rounds.mfu_ratio"] = recent / older
    return m


def build_metric_view(
    snapshot: Optional[dict],
    rounds_tail: Sequence[dict] = (),
    rounds_window: int = 8,
) -> Dict[str, float]:
    """Flatten one node's metrics snapshot + rounds tail into the flat
    ``{address: float}`` namespace rules select from."""
    m: Dict[str, float] = {}
    if snapshot:
        for k, v in (snapshot.get("counters") or {}).items():
            m[f"counter:{k}"] = float(v)
        for k, v in (snapshot.get("gauges") or {}).items():
            m[f"gauge:{k}"] = float(v)
        for name, st in (snapshot.get("timers") or {}).items():
            for stat, key in TIMER_STATS.items():
                if key in st:
                    m[f"timer:{name}:{stat}"] = float(st[key])
    m.update(derive_rounds_tail(rounds_tail, rounds_window))
    return m


def resolve_view_metric(
    view: Dict[str, float], name: str
) -> Tuple[Optional[float], Optional[str]]:
    """``(value, skip_reason)``: counters default to 0 when untouched
    (same absence-is-zero rule as the SLO evaluator); everything else
    absent means *not evaluable this tick*, with the reason recorded."""
    val = view.get(name)
    if val is not None:
        return float(val), None
    if name.startswith(_ZERO_DEFAULT_PREFIXES):
        return 0.0, None
    return None, f"metric {name!r} not present in this node's namespace"


def windowed_rate(
    history: Optional[Sequence[dict]],
    counter: str,
    window_s: float,
    now: float,
) -> Tuple[Optional[float], Optional[str]]:
    """Per-second rate of ``counter`` over the history-ring samples in
    ``[now - window_s, now]`` — ``(rate, reason)``, rate None when the
    window lacks coverage (burn-rate rules then skip, they never guess)."""
    snaps = sorted(
        (s for s in (history or [])
         if isinstance(s, dict)
         and isinstance(s.get("ts"), (int, float))
         and s["ts"] >= now - window_s),
        key=lambda s: s["ts"],
    )
    if len(snaps) < 2:
        return None, (f"history window {window_s:g}s holds "
                      f"{len(snaps)} samples (need >= 2)")
    first, last = snaps[0], snaps[-1]
    span = float(last["ts"]) - float(first["ts"])
    if span <= 0:
        return None, f"history window {window_s:g}s has zero span"
    delta = (float((last.get("counters") or {}).get(counter, 0.0))
             - float((first.get("counters") or {}).get(counter, 0.0)))
    return delta / span, None


def _count(v: Any) -> int:
    if isinstance(v, (list, tuple)):
        return len(v)
    if isinstance(v, (int, float)):
        return int(v)
    return 0


def _quantile(sorted_vals: Sequence[float], q: float) -> float:
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    rank = q * (n - 1)
    lo = int(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def read_alerts_jsonl(path: str) -> Tuple[List[dict], int]:
    """Tolerant ``alerts.jsonl`` reader — ``(events, n_torn)``, same
    contract as :func:`baton_tpu_torch.utils.slog.read_rounds_jsonl`."""
    from baton_tpu_torch.utils.slog import read_rounds_jsonl

    return read_rounds_jsonl(path)


# ---------------------------------------------------------------------------
# Engine


@dataclass
class _RuleState:
    state: str = "ok"            # ok | pending | firing
    pending_since: Optional[float] = None
    firing_since: Optional[float] = None
    cooldown_until: float = 0.0
    episodes: int = 0
    last_value: Any = None
    last_event_ts: Optional[float] = None
    skip_reason: Optional[str] = None
    last_capture_ts: Optional[float] = None
    history: List[str] = field(default_factory=list)  # recent transitions


class AlertEngine:
    """Evaluates a rule pack against successive metric views.

    One engine per node; :meth:`evaluate` is called by the node's
    ``PeriodicTask`` tick with a freshly built view and (for burn-rate
    rules) the metrics-history ring. Thread-safe on the JSONL appender;
    the state machine itself runs on the owning loop only.
    """

    def __init__(
        self,
        rules: Optional[Iterable] = None,
        *,
        log_path: Optional[str] = None,
        metrics=None,
        node: str = "manager",
        rounds_window: int = 8,
        on_capture: Optional[Callable[[AlertRule, dict], Any]] = None,
        now: Callable[[], float] = time.time,
    ) -> None:
        parsed: List[AlertRule] = []
        for i, r in enumerate(DEFAULT_RULES if rules is None else rules):
            rule = r if isinstance(r, AlertRule) else AlertRule.parse(
                r, ctx=f"alert rule [{i}]"
            )
            parsed.append(rule)
        names = [r.name for r in parsed]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise AlertRuleError(f"duplicate alert rule names: {dupes}")
        self.rules = parsed
        self.node = node
        self.metrics = metrics
        self.rounds_window = max(1, int(rounds_window))
        self.on_capture = on_capture
        self._now = now
        self._log_path = log_path
        self._log_lock = threading.Lock()
        if log_path:
            os.makedirs(
                os.path.dirname(os.path.abspath(log_path)), exist_ok=True
            )
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules
        }

    # -- persistence ---------------------------------------------------
    def _append(self, record: dict) -> None:
        if not self._log_path:
            return
        # crash-safety: one write() + flush per line, same discipline as
        # RoundsLog — a crash tears at most the final line
        data = json.dumps(record, default=repr) + "\n"
        with self._log_lock:
            with open(self._log_path, "a", encoding="utf-8") as fh:
                fh.write(data)
                fh.flush()

    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)

    def log_event(self, record: dict) -> None:
        """Append an out-of-band event (e.g. a built forensics bundle)
        to ``alerts.jsonl`` with the lifecycle events, so one file tells
        the whole story of an incident."""
        self._append(dict(record, node=self.node))

    def _emit(self, event: str, rule: AlertRule, st: _RuleState,
              now: float, **extra) -> dict:
        rec = {
            "ts": round(now, 6),
            "node": self.node,
            "event": event,
            "rule": rule.name,
            "severity": rule.severity,
            "metric": rule.metric,
            "value": st.last_value,
            "threshold": rule._effective_threshold(),
            "for_s": rule.for_s,
            "episode": st.episodes,
        }
        if rule.capture:
            rec["capture"] = True
        rec.update(extra)
        st.last_event_ts = now
        st.history = (st.history + [event])[-8:]
        self._append(rec)
        return rec

    # -- resolution ----------------------------------------------------
    def _resolve_rule(
        self,
        rule: AlertRule,
        view: Dict[str, float],
        history: Optional[Sequence[dict]],
        now: float,
    ) -> Tuple[Any, Optional[str]]:
        if rule.burn_rate is None:
            return resolve_view_metric(view, rule.metric)
        counter = rule.metric[len("counter:"):]
        short, why_s = windowed_rate(
            history, counter, rule.burn_rate["short_s"], now
        )
        long_, why_l = windowed_rate(
            history, counter, rule.burn_rate["long_s"], now
        )
        if short is None or long_ is None:
            return None, why_s or why_l
        return {"short": round(short, 6), "long": round(long_, 6)}, None

    # -- the tick ------------------------------------------------------
    def evaluate(
        self,
        view: Dict[str, float],
        history: Optional[Sequence[dict]] = None,
    ) -> List[dict]:
        """Step every rule's state machine against one metric view.
        Returns the emitted transition events. Never raises on a bad
        rule/metric — per-rule failures are counted and recorded."""
        now = self._now()
        events: List[dict] = []
        for rule in self.rules:
            st = self._states[rule.name]
            try:
                value, skip = self._resolve_rule(rule, view, history, now)
            except Exception as exc:
                value, skip = None, f"evaluation error: {exc!r}"
                self._inc("alerts_eval_errors")
            if value is None:
                st.skip_reason = skip
                continue  # not evaluable: hold state, try next tick
            st.skip_reason = None
            st.last_value = value
            try:
                events.extend(self._step(rule, st, value, now))
            except Exception:
                self._inc("alerts_eval_errors")
        if self.metrics is not None:
            states = [s.state for s in self._states.values()]
            self.metrics.set_gauge(
                "alerts_firing", states.count("firing")
            )
            self.metrics.set_gauge(
                "alerts_pending", states.count("pending")
            )
        return events

    def _step(self, rule: AlertRule, st: _RuleState, value: Any,
              now: float) -> List[dict]:
        out: List[dict] = []
        breach = rule.breaches(value)
        if st.state == "ok":
            if breach and now >= st.cooldown_until:
                st.state = "pending"
                st.pending_since = now
                out.append(self._emit("pending", rule, st, now))
                if rule.for_s <= 0:
                    out.append(self._fire(rule, st, now))
        elif st.state == "pending":
            if not breach:
                # transient spike: the for_s hold did its job — back to
                # ok with no firing episode and no resolved event
                st.state = "ok"
                st.pending_since = None
            elif now - st.pending_since >= rule.for_s:
                out.append(self._fire(rule, st, now))
        elif st.state == "firing":
            if not rule.still_breaching(value):
                st.state = "ok"
                st.firing_since = None
                st.pending_since = None
                st.cooldown_until = now + rule.cooldown_s
                self._inc("alerts_resolved_total")
                out.append(self._emit(
                    "resolved", rule, st, now,
                    cooldown_until=round(st.cooldown_until, 6),
                ))
        return out

    def _fire(self, rule: AlertRule, st: _RuleState, now: float) -> dict:
        st.state = "firing"
        st.firing_since = now
        st.episodes += 1
        self._inc("alerts_fired_total")
        extra: Dict[str, Any] = {}
        if rule.capture and self.on_capture is not None:
            if (st.last_capture_ts is None
                    or now - st.last_capture_ts >= rule.cooldown_s):
                st.last_capture_ts = now
                self._inc("alerts_captures_armed")
                extra["capture_armed"] = True
            else:
                extra["capture_armed"] = False
                extra["capture_suppressed"] = (
                    f"per-rule capture cooldown ({rule.cooldown_s:g}s)"
                )
        event = self._emit("firing", rule, st, now, **extra)
        if extra.get("capture_armed"):
            try:
                self.on_capture(rule, event)
            except Exception:
                # capture arming is advisory; a broken hook must not
                # take the alert lifecycle down with it
                self._inc("alerts_eval_errors")
        return event

    # -- introspection -------------------------------------------------
    def status_snapshot(self) -> dict:
        """The ``GET /{name}/alerts`` payload."""
        now = self._now()
        rules = []
        for rule in self.rules:
            st = self._states[rule.name]
            rules.append({
                "name": rule.name,
                "metric": rule.metric,
                "op": rule.op,
                "threshold": rule._effective_threshold(),
                "burn_rate": rule.burn_rate,
                "for_s": rule.for_s,
                "cooldown_s": rule.cooldown_s,
                "severity": rule.severity,
                "capture": rule.capture,
                "description": rule.description,
                "state": st.state,
                "value": st.last_value,
                "episodes": st.episodes,
                "pending_since": st.pending_since,
                "firing_since": st.firing_since,
                "cooldown_until": st.cooldown_until or None,
                "skip_reason": st.skip_reason,
                "recent_transitions": list(st.history),
            })
        firing = [r["name"] for r in rules if r["state"] == "firing"]
        pending = [r["name"] for r in rules if r["state"] == "pending"]
        return {
            "node": self.node,
            "ts": round(now, 6),
            "rules": rules,
            "firing": firing,
            "pending": pending,
            "summary": {
                "rules": len(rules),
                "firing": len(firing),
                "pending": len(pending),
                "page_firing": sum(
                    1 for r in rules
                    if r["state"] == "firing" and r["severity"] == "page"
                ),
            },
        }

    def firing(self, severity: Optional[str] = None) -> List[str]:
        """Names of currently-firing rules, optionally filtered."""
        out = []
        for rule in self.rules:
            if self._states[rule.name].state != "firing":
                continue
            if severity is not None and rule.severity != severity:
                continue
            out.append(rule.name)
        return out
