"""SLO evaluator + regression gate over a scenario run's telemetry.

Inputs are exactly what the manager already records — the per-round SLO
records in ``rounds.jsonl`` (tolerantly read: a torn final line from a
crash is counted and reported, never raised) and the
``Experiment.metrics_snapshot()`` dict that also backs ``GET /metrics``
— plus the loadgen driver's own counters. From those it derives one
flat ``{metric_name: float}`` namespace:

``rounds.*``
    Derived from ``rounds.jsonl``: ``total`` / ``completed`` /
    ``aborted`` / ``completion_rate``, exact quantiles
    ``duration_p50|p95|p99`` + ``duration_mean|max`` over *completed*
    rounds, ``participants_mean`` / ``reporters_mean`` /
    ``straggler_rate``, and per-round byte means
    ``bytes_uploaded_mean`` / ``bytes_broadcast_mean``.
``counter:<name>`` / ``gauge:<name>``
    Straight from the manager snapshot.
``timer:<name>:<stat>``
    Histogram timer stats, ``<stat>`` in ``count`` / ``mean`` / ``p50``
    / ``p95`` / ``p99`` / ``max`` (e.g. ``timer:round_s:p95``).
``fleet:counter:<name>`` / ``fleet:gauge:<name>`` / ``fleet:timer:…``
    The worker fleet's shared registry (the engine points every
    simulated worker at one Metrics instance), e.g.
    ``fleet:timer:heartbeat_s:p95``.
``loadgen:<name>``
    The scenario driver's own counters/gauges (423 refusals, churn
    events, forced round ends).
``history:samples`` / ``history:span_s`` / ``history:delta:<counter>``
    / ``history:rate:<counter>``
    Derived from the manager's ``/metrics/history`` snapshot ring
    (``metrics_history.json``): windowed counter deltas over the run
    and per-second rates over the ring's wall-clock span. These are
    NOT absence-is-zero — a run that produced no history ring (or too
    few samples for a rate) fails the assertion, same rule as timers.
``alert:*``
    Derived from the manager's ``alerts.jsonl`` lifecycle stream
    (``baton_tpu_torch.obs.alerts``): ``alert:fired:<rule>`` /
    ``alert:resolved:<rule>`` count one rule's firing/resolved
    transitions, ``alert:fired_total`` / ``alert:pages_fired`` sum
    across rules, and ``alert:forensics_bundles`` counts the forensics
    bundles captures actually produced. These are absence-is-zero like
    counters — "the run fired no alerts" is a real, assertable zero
    (``{"metric": "alert:fired_total", "op": "==", "value": 0}`` is the
    quiet-fleet gate).
``runbook:*``
    Derived from the manager's ``runbooks.jsonl`` lifecycle stream and
    the per-round ``actuations`` records
    (``baton_tpu_torch.obs.runbooks``): ``runbook:entered:<rule>`` /
    ``runbook:exited:<rule>`` transition counts (exited ≥ 1 is the
    hysteresis-reversal proof), ``runbook:entered_total`` /
    ``runbook:exited_total``, ``runbook:actuated_rounds:<action>``, and
    ``runbook:actuations_total``. Absence-is-zero like counters.
``fairness:*``
    Per-class participation shares from ``fleet_health.json`` —
    ``fairness:share:<class>``, ``fairness:share_per_client:<class>``,
    ``fairness:clients:<class>``, ``fairness:participation_floor``
    (see :func:`derive_fairness_metrics`). NOT absence-is-zero: the
    starvation gate must fail loudly if fairness went unmeasured.
``compute:*``
    Derived from the ``compute`` section the manager folds into every
    round record (obs/compute.py): ``rounds_with_compute``,
    ``reporters_mean``, ``compile_s_max|mean``, ``steps_total``,
    ``samples_per_sec_per_chip_mean``, ``mfu_mean``,
    ``peak_hbm_gb_max``, ``recompile_storm_rounds``. A compute value
    that is null *with a recorded reason* in every round (CPU smoke has
    no MFU) becomes a ``skips`` entry instead of a metric — the
    baseline gate reports it ``skipped`` rather than regressed, exactly
    the bench carve-out; a null with NO reason is simply absent and
    regresses.

A *counter* address that the run never touched resolves to 0 — a
counter is born at its first ``inc``, so absence IS zero
(``counter:…``, ``fleet:counter:…``, and the ``loadgen:…`` namespace).
Every other address — timers, gauges, derived ``rounds.*`` — stays
missing when unproduced, and missing is a failure: "we stopped
measuring it" is precisely the regression class that hid the BENCH_r04
``fused_rounds_per_sec`` drop.

Two gates run over that namespace, both recorded in ``slo_report.json``:

1. **Assertions** from the scenario's ``slo.assertions`` block —
   ``{"metric", "op", "value"}``; an unresolvable metric is a *failure*
   (status ``missing``), per the absence rule above.
2. **Baseline deltas** vs a committed ``benchmarks/scenarios/baselines/
   *.json`` file: each entry pins ``value``, a ``direction``
   (``higher_is_better`` / ``lower_is_better``) and a relative
   ``tolerance`` (plus optional absolute ``tolerance_abs``); an
   observation worse than ``value ± tolerance`` — or missing from the
   run (counter addresses excepted, see above) — is a regression.

``evaluate_slo`` returns the full report; ``report["pass"]`` is the CI
verdict (any failed/missing assertion or any baseline regression ⇒
``False``, and the CLI exits nonzero).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence

from baton_tpu_torch.loadgen.scenario import (
    SLO_OPS,
    ScenarioError,
    SLOAssertion,
    SLOSpec,
)

_TIMER_STATS = {
    "count": "count",
    "mean": "mean_s",
    "p50": "p50_s",
    "p95": "p95_s",
    "p99": "p99_s",
    "max": "max_s",
}

_DIRECTIONS = ("higher_is_better", "lower_is_better")


def _count(v: Any) -> int:
    """Record fields that enumerate clients (``stragglers``) hold id
    lists; count-valued fields hold numbers. Normalize either to an
    int."""
    if isinstance(v, (list, tuple)):
        return len(v)
    if isinstance(v, (int, float)):
        return int(v)
    return 0


def _quantile(sorted_vals: Sequence[float], q: float) -> float:
    """Exact linear-interpolation quantile over a sorted sample (the
    rounds sample is small, unlike the manager's O(1) histograms)."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    rank = q * (n - 1)
    lo = int(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def resolve_metric(metrics: Dict[str, float], name: str) -> Optional[float]:
    """Metric lookup with the counter absence-is-zero rule (module
    docstring): an untouched counter address resolves to 0.0, anything
    else absent resolves to None (→ missing/regression)."""
    val = metrics.get(name)
    if val is not None:
        return val
    if name.startswith(("counter:", "fleet:counter:", "edge:counter:",
                        "loadgen:", "alert:", "runbook:")):
        return 0.0
    return None


def derive_metrics(
    records: List[dict],
    snapshot: Optional[dict] = None,
    loadgen_snapshot: Optional[dict] = None,
    fleet_snapshot: Optional[dict] = None,
    edge_snapshot: Optional[dict] = None,
) -> Dict[str, float]:
    """Flatten rounds.jsonl + the metrics snapshots into one
    ``{metric: float}`` namespace (see module docstring). Metrics whose
    inputs are absent (no completed rounds → no duration quantiles) are
    simply not present — the assertion layer turns absence into
    failure."""
    m: Dict[str, float] = {}
    total = len(records)
    completed = [r for r in records if r.get("outcome") == "completed"]
    m["rounds.total"] = float(total)
    m["rounds.completed"] = float(len(completed))
    m["rounds.aborted"] = float(total - len(completed))
    if total:
        m["rounds.completion_rate"] = len(completed) / total

    durs = sorted(
        float(r["duration_s"]) for r in completed
        if isinstance(r.get("duration_s"), (int, float))
    )
    if durs:
        m["rounds.duration_p50"] = _quantile(durs, 0.50)
        m["rounds.duration_p95"] = _quantile(durs, 0.95)
        m["rounds.duration_p99"] = _quantile(durs, 0.99)
        m["rounds.duration_mean"] = sum(durs) / len(durs)
        m["rounds.duration_max"] = durs[-1]

    def _mean(field: str, over: List[dict]) -> Optional[float]:
        vals = [
            float(r[field]) for r in over
            if isinstance(r.get(field), (int, float))
        ]
        return sum(vals) / len(vals) if vals else None

    for field, out in (
        ("participants", "rounds.participants_mean"),
        ("reporters", "rounds.reporters_mean"),
        ("bytes_uploaded", "rounds.bytes_uploaded_mean"),
        ("bytes_broadcast", "rounds.bytes_broadcast_mean"),
    ):
        val = _mean(field, completed)
        if val is not None:
            m[out] = val

    n_participants = sum(
        _count(r.get("participants")) for r in completed
    )
    if n_participants:
        m["rounds.straggler_rate"] = sum(
            _count(r.get("stragglers")) for r in completed
        ) / n_participants

    for prefix, snap in (("", snapshot), ("fleet:", fleet_snapshot),
                         ("edge:", edge_snapshot)):
        if not snap:
            continue
        for k, v in (snap.get("counters") or {}).items():
            m[f"{prefix}counter:{k}"] = float(v)
        for k, v in (snap.get("gauges") or {}).items():
            m[f"{prefix}gauge:{k}"] = float(v)
        for name, st in (snap.get("timers") or {}).items():
            for stat, key in _TIMER_STATS.items():
                if key in st:
                    m[f"{prefix}timer:{name}:{stat}"] = float(st[key])
    if loadgen_snapshot:
        for k, v in (loadgen_snapshot.get("counters") or {}).items():
            m[f"loadgen:{k}"] = float(v)
        for k, v in (loadgen_snapshot.get("gauges") or {}).items():
            m[f"loadgen:{k}"] = float(v)
    return m


def derive_history_metrics(history: Optional[List[dict]]) -> Dict[str, float]:
    """``history:*`` metrics from a ``/metrics/history`` snapshot ring.

    ``history:delta:<counter>`` is last-minus-first over the ring;
    ``history:rate:<counter>`` divides that by the ring's wall-clock
    span. With fewer than two timestamped snapshots only
    ``history:samples`` exists — an asserted rate then resolves missing
    and fails, which is the point: "we stopped recording history" must
    not pass a rate SLO vacuously."""
    m: Dict[str, float] = {}
    snaps = sorted(
        (
            s for s in (history or [])
            if isinstance(s, dict)
            and isinstance(s.get("ts"), (int, float))
        ),
        key=lambda s: s["ts"],
    )
    m["history:samples"] = float(len(snaps))
    if len(snaps) < 2:
        return m
    first, last = snaps[0], snaps[-1]
    span = float(last["ts"]) - float(first["ts"])
    m["history:span_s"] = span
    c0 = first.get("counters") or {}
    c1 = last.get("counters") or {}
    for name in set(c0) | set(c1):
        try:
            delta = float(c1.get(name, 0.0)) - float(c0.get(name, 0.0))
        except (TypeError, ValueError):
            continue
        m[f"history:delta:{name}"] = delta
        if span > 0:
            m[f"history:rate:{name}"] = delta / span
    return m


def derive_alert_metrics(events: Optional[List[dict]]) -> Dict[str, float]:
    """``alert:*`` metrics from the ``alerts.jsonl`` event stream.

    Counts lifecycle *transitions* (one ``firing`` episode per fire, no
    matter how long it burned) rather than sampling gauge state — a
    flap that fired twice must read as 2, and an alert still firing at
    run end must still count. Absence-is-zero (see module docstring):
    with no events at all the caller still resolves every ``alert:``
    address to 0.0."""
    m: Dict[str, float] = {}
    for e in events or []:
        if not isinstance(e, dict):
            continue
        ev = e.get("event")
        rule = e.get("rule")
        if ev == "firing" and rule:
            m[f"alert:fired:{rule}"] = m.get(f"alert:fired:{rule}", 0.0) + 1
            m["alert:fired_total"] = m.get("alert:fired_total", 0.0) + 1
            if e.get("severity") == "page":
                m["alert:pages_fired"] = m.get("alert:pages_fired", 0.0) + 1
        elif ev == "resolved" and rule:
            m[f"alert:resolved:{rule}"] = (
                m.get(f"alert:resolved:{rule}", 0.0) + 1
            )
        elif ev == "forensics":
            m["alert:forensics_bundles"] = (
                m.get("alert:forensics_bundles", 0.0) + 1
            )
    return m


def derive_fairness_metrics(fleet_health: Optional[dict]) -> Dict[str, float]:
    """``fairness:*`` participation-share metrics from the manager's
    ``fleet/health`` snapshot (``fleet_health.json``).

    The runbook cohort bias must speed rounds up WITHOUT starving slow
    clients, so the gate needs a number for "how much of the run's
    participation each health class actually got":

    ``fairness:share:<class>``
        Fraction of all reported updates contributed by that class
        (non-inactive classes only — an inactive client isn't being
        starved by selection, it left).
    ``fairness:clients:<class>``
        Non-inactive client count per class.
    ``fairness:share_per_client:<class>``
        Class share normalized by class size — comparable across
        classes of different sizes; under uniform selection every class
        reads ≈ ``1/total_clients``.
    ``fairness:participation_floor``
        ``min over classes`` of ``share_per_client · total_clients`` —
        1.0 is perfectly proportional participation, and the skew
        scenario asserts this stays above a floor while bias is active.

    NOT absence-is-zero: a run with no health snapshot (or no reports)
    resolves these missing, and an asserted floor then fails — "we
    stopped measuring fairness" must not pass vacuously."""
    m: Dict[str, float] = {}
    clients = (fleet_health or {}).get("clients") or {}
    shares: Dict[str, float] = {}
    counts: Dict[str, float] = {}
    total_reported = 0.0
    for info in clients.values():
        if not isinstance(info, dict):
            continue
        status = info.get("status")
        if not isinstance(status, str) or status == "inactive":
            continue
        rep = info.get("reported")
        rep = float(rep) if isinstance(rep, (int, float)) else 0.0
        shares[status] = shares.get(status, 0.0) + rep
        counts[status] = counts.get(status, 0.0) + 1.0
        total_reported += rep
    if not counts or total_reported <= 0:
        return m
    total_clients = sum(counts.values())
    floor = None
    for status in sorted(counts):
        share = shares.get(status, 0.0) / total_reported
        per_client = share / counts[status]
        m[f"fairness:share:{status}"] = share
        m[f"fairness:clients:{status}"] = counts[status]
        m[f"fairness:share_per_client:{status}"] = per_client
        ratio = per_client * total_clients
        floor = ratio if floor is None else min(floor, ratio)
    if floor is not None:
        m["fairness:participation_floor"] = floor
    return m


def derive_runbook_metrics(
    events: Optional[List[dict]],
    records: Optional[List[dict]] = None,
) -> Dict[str, float]:
    """``runbook:*`` metrics from the ``runbooks.jsonl`` lifecycle
    stream (``baton_tpu_torch.obs.runbooks``) plus the per-round
    ``actuations`` records in ``rounds.jsonl``.

    ``runbook:entered:<rule>`` / ``runbook:exited:<rule>`` count one
    rule's activation/hysteresis-exit transitions (entered AND exited
    ≥1 is the reversibility proof); ``runbook:entered_total`` /
    ``runbook:exited_total`` sum across rules;
    ``runbook:actuated_rounds:<action>`` counts rounds whose record
    carries at least one applied actuation of that action, and
    ``runbook:actuations_total`` counts every applied actuation.
    Absence-is-zero like counters — "the run never remediated" is a
    real, assertable zero."""
    m: Dict[str, float] = {}
    for e in events or []:
        if not isinstance(e, dict):
            continue
        ev = e.get("event")
        rule = e.get("rule")
        if ev == "entered" and rule:
            m[f"runbook:entered:{rule}"] = (
                m.get(f"runbook:entered:{rule}", 0.0) + 1
            )
            m["runbook:entered_total"] = m.get("runbook:entered_total", 0.0) + 1
        elif ev == "exited" and rule:
            m[f"runbook:exited:{rule}"] = (
                m.get(f"runbook:exited:{rule}", 0.0) + 1
            )
            m["runbook:exited_total"] = m.get("runbook:exited_total", 0.0) + 1
    for r in records or []:
        acts = r.get("actuations")
        if not isinstance(acts, list):
            continue
        seen_actions = set()
        for a in acts:
            if not isinstance(a, dict) or not a.get("action"):
                continue
            m["runbook:actuations_total"] = (
                m.get("runbook:actuations_total", 0.0) + 1
            )
            seen_actions.add(a["action"])
        for action in seen_actions:
            m[f"runbook:actuated_rounds:{action}"] = (
                m.get(f"runbook:actuated_rounds:{action}", 0.0) + 1
            )
    return m


def _compare(observed: float, op: str, value: float) -> bool:
    if op == "<=":
        return observed <= value
    if op == ">=":
        return observed >= value
    if op == "<":
        return observed < value
    if op == ">":
        return observed > value
    if op == "==":
        return observed == value
    raise ScenarioError(f"unknown SLO op {op!r} (known: {SLO_OPS})")


def check_assertions(
    assertions: Iterable[SLOAssertion], metrics: Dict[str, float]
) -> List[dict]:
    out = []
    for a in assertions:
        observed = resolve_metric(metrics, a.metric)
        if observed is None:
            status = "missing"
        else:
            status = "pass" if _compare(observed, a.op, a.value) else "fail"
        out.append({
            "metric": a.metric, "op": a.op, "value": a.value,
            "observed": observed, "status": status,
        })
    return out


def load_baseline(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        try:
            data = json.load(fh)
        except ValueError as exc:
            raise ScenarioError(f"{path}: not valid JSON: {exc}") from exc
    metrics = data.get("metrics")
    if not isinstance(metrics, dict) or not metrics:
        raise ScenarioError(f"{path}: baseline needs a non-empty `metrics` map")
    for name, spec in metrics.items():
        if not isinstance(spec, dict) or "value" not in spec:
            raise ScenarioError(f"{path}: baseline metric {name!r} needs `value`")
        if spec.get("direction", "higher_is_better") not in _DIRECTIONS:
            raise ScenarioError(
                f"{path}: baseline metric {name!r} direction must be one of "
                f"{_DIRECTIONS}"
            )
    return data


def check_baseline(
    baseline: dict, metrics: Dict[str, float]
) -> List[dict]:
    """Per-baseline-metric delta report. An entry regresses when the
    observation is worse than ``value`` by more than the tolerance in
    the bad direction — or when the run stopped producing the metric at
    all (the silent-drop failure mode)."""
    results = []
    for name, spec in baseline.get("metrics", {}).items():
        value = float(spec["value"])
        direction = spec.get("direction", "higher_is_better")
        tol = float(spec.get("tolerance", 0.0))
        tol_abs = float(spec.get("tolerance_abs", 0.0))
        observed = resolve_metric(metrics, name)
        entry: Dict[str, Any] = {
            "metric": name, "baseline": value, "direction": direction,
            "observed": observed, "delta": None, "delta_rel": None,
        }
        if observed is None:
            entry["regression"] = True
            entry["note"] = "metric missing from this run"
            results.append(entry)
            continue
        delta = observed - value
        entry["delta"] = delta
        if value:
            entry["delta_rel"] = delta / abs(value)
        slack = abs(value) * tol + tol_abs
        if direction == "higher_is_better":
            entry["regression"] = observed < value - slack
        else:
            entry["regression"] = observed > value + slack
        results.append(entry)
    return results


def derive_compute_metrics(
    records: List[dict],
) -> "tuple[Dict[str, float], Dict[str, str]]":
    """``compute:*`` metrics from completed rounds' ``compute``
    sections. Returns ``(metrics, skips)`` with the null-with-reason
    carve-out (module docstring): a value unmeasured in every round but
    excused in each lands in ``skips``; one that simply vanished stays
    absent and the baseline gate regresses it."""
    metrics: Dict[str, float] = {}
    skips: Dict[str, str] = {}
    sections = [
        r["compute"] for r in records
        if r.get("outcome") == "completed" and isinstance(r.get("compute"), dict)
    ]
    if not sections:
        return metrics, skips
    with_compute = [s for s in sections if s.get("reporters")]
    metrics["compute:rounds_with_compute"] = float(len(with_compute))
    metrics["compute:reporters_mean"] = sum(
        float(s.get("reporters") or 0) for s in sections
    ) / len(sections)

    def fold(key: str, out: str, agg) -> None:
        vals = [
            float(s[key]) for s in sections
            if isinstance(s.get(key), (int, float))
            and not isinstance(s.get(key), bool)
        ]
        if vals:
            metrics[out] = agg(vals)
            return
        for s in sections:
            why = s.get(f"{key}_reason") or s.get(f"{key}_source")
            if isinstance(why, str) and why:
                skips[out] = why
                return

    fold("compile_s", "compute:compile_s_max", max)
    fold("compile_s", "compute:compile_s_mean",
         lambda v: sum(v) / len(v))
    fold("steps", "compute:steps_total", sum)
    fold("samples_per_sec_per_chip",
         "compute:samples_per_sec_per_chip_mean",
         lambda v: sum(v) / len(v))
    fold("mfu", "compute:mfu_mean", lambda v: sum(v) / len(v))
    fold("peak_hbm_gb", "compute:peak_hbm_gb_max", max)
    metrics["compute:recompile_storm_rounds"] = float(sum(
        1 for s in sections if s.get("recompile_storms")
    ))
    return metrics, skips


def derive_bench_metrics(parsed: dict) -> "tuple[Dict[str, float], Dict[str, str]]":
    """Flatten one ``bench.py`` output record into the flat SLO
    namespace under a ``bench:`` prefix, so :func:`check_baseline` can
    gate flagship performance the same way it gates scenario telemetry.

    Returns ``(metrics, skips)``. A numeric field becomes
    ``bench:<name>``; each ``flagship_mfu_recorded`` record becomes
    ``bench:flagship:<model>:mfu`` / ``:rounds_per_sec``. A null
    ``fused_rounds_per_sec`` / ``mfu`` with a recorded excuse
    (``fused_skip_reason`` or ``degraded_reason``) lands in ``skips``
    instead — visible and auditable; a null with NO recorded reason is
    simply absent, which the baseline gate treats as a regression (the
    BENCH_r03→r04 silent-drop class)."""
    metrics: Dict[str, float] = {}
    skips: Dict[str, str] = {}
    for field in ("value", "rounds_per_sec", "dispatch_rounds_per_sec",
                  "fused_rounds_per_sec", "mfu",
                  "samples_per_sec_per_chip", "compile_s"):
        v = parsed.get(field)
        name = f"bench:{'rounds_per_sec' if field == 'value' else field}"
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            metrics[name] = float(v)
        elif v is None and field in parsed:
            reason = parsed.get("fused_skip_reason") or parsed.get(
                "degraded_reason"
            )
            if reason:
                skips[name] = str(reason)
    # donation on/off HBM-plan comparison and the wave1024 recorded
    # number: null with a recorded ``*_reason`` skips; null without one
    # regresses. Records from before bench.py emitted these fields are
    # recognizable by the missing ``donation_enabled`` marker and skip
    # with an explicit pre-schema note instead of failing the gate on
    # history the new code never measured.
    pre_schema = "donation_enabled" not in parsed
    donation = parsed.get("donation_hbm")
    if isinstance(donation, dict):
        delta = donation.get("delta_gb")
        if isinstance(delta, (int, float)) and not isinstance(delta, bool):
            metrics["bench:donation_hbm_delta_gb"] = float(delta)
        for variant in ("donate_on", "donate_off"):
            plan = (donation.get(variant) or {}).get("plan_gb")
            if isinstance(plan, (int, float)) and not isinstance(plan, bool):
                metrics[f"bench:donation_{variant}_plan_gb"] = float(plan)
    elif parsed.get("donation_hbm_reason"):
        skips["bench:donation_hbm_delta_gb"] = str(
            parsed["donation_hbm_reason"])
    elif pre_schema:
        skips["bench:donation_hbm_delta_gb"] = (
            "record predates the donation-plan bench stage")
    wave1024 = parsed.get("wave1024_recorded")
    if isinstance(wave1024, dict):
        rps = wave1024.get("rounds_per_sec")
        if isinstance(rps, (int, float)) and not isinstance(rps, bool):
            metrics["bench:wave1024_rounds_per_sec"] = float(rps)
    elif parsed.get("wave1024_reason"):
        skips["bench:wave1024_rounds_per_sec"] = str(
            parsed["wave1024_reason"])
    elif pre_schema:
        skips["bench:wave1024_rounds_per_sec"] = (
            "record predates the wave1024_reason bench field")
    flagship = parsed.get("flagship_mfu_recorded") or {}
    for rec in flagship.get("records") or []:
        model = rec.get("model")
        if not model:
            continue
        for field in ("mfu", "rounds_per_sec", "tokens_per_sec_per_chip",
                      "peak_hbm_gb"):
            v = rec.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                metrics[f"bench:flagship:{model}:{field}"] = float(v)
    return metrics, skips


def check_bench_baseline(
    baseline: dict, parsed: dict
) -> "tuple[List[dict], Dict[str, str]]":
    """Baseline-delta gate over one bench record. Same comparison rules
    as :func:`check_baseline`, with one bench-specific carve-out: a
    metric that is missing *with a recorded skip reason* reports
    ``skipped`` instead of regressing — an unmeasured flagship number
    must name why (accelerator probe failed, budget exhausted), or it
    fails CI."""
    metrics, skips = derive_bench_metrics(parsed)
    results = check_baseline(baseline, metrics)
    for entry in results:
        reason = skips.get(entry["metric"])
        if entry["regression"] and entry["observed"] is None and reason:
            entry["regression"] = False
            entry["note"] = f"skipped: {reason}"
    return results, skips


def evaluate_slo(
    slo: SLOSpec,
    records: List[dict],
    snapshot: Optional[dict] = None,
    *,
    loadgen_snapshot: Optional[dict] = None,
    fleet_snapshot: Optional[dict] = None,
    edge_snapshot: Optional[dict] = None,
    history: Optional[List[dict]] = None,
    alert_events: Optional[List[dict]] = None,
    fleet_health: Optional[dict] = None,
    runbook_events: Optional[List[dict]] = None,
    baseline: Optional[dict] = None,
    n_torn: int = 0,
    exclude_rounds: Iterable[str] = (),
    scenario_name: Optional[str] = None,
) -> dict:
    """The full SLO verdict for one run.

    ``exclude_rounds`` filters warm-up rounds out of the derived
    ``rounds.*`` metrics by round name (XLA compile time is a property
    of the harness, not the serving path). ``baseline`` overrides the
    on-disk file; otherwise ``slo.baseline`` is loaded when set.
    """
    excluded = set(exclude_rounds)
    kept = [r for r in records if r.get("round") not in excluded]
    metrics = derive_metrics(kept, snapshot, loadgen_snapshot,
                             fleet_snapshot, edge_snapshot)
    if history is not None:
        metrics.update(derive_history_metrics(history))
    if alert_events is not None:
        metrics.update(derive_alert_metrics(alert_events))
    if fleet_health is not None:
        metrics.update(derive_fairness_metrics(fleet_health))
    if runbook_events is not None:
        metrics.update(derive_runbook_metrics(runbook_events, kept))
    compute_metrics, compute_skips = derive_compute_metrics(kept)
    metrics.update(compute_metrics)
    assertions = check_assertions(slo.assertions, metrics)

    baseline_block = None
    if baseline is None and slo.baseline is not None:
        baseline = load_baseline(slo.baseline)
    if baseline is not None:
        results = check_baseline(baseline, metrics)
        for entry in results:
            reason = compute_skips.get(entry["metric"])
            if entry["regression"] and entry["observed"] is None and reason:
                # same carve-out as check_bench_baseline: unmeasured
                # WITH a recorded reason is a visible skip, not a
                # silent regression
                entry["regression"] = False
                entry["note"] = f"skipped: {reason}"
        baseline_block = {
            "path": slo.baseline,
            "results": results,
            "regressions": sum(1 for r in results if r["regression"]),
        }

    ok = all(a["status"] == "pass" for a in assertions) and (
        baseline_block is None or baseline_block["regressions"] == 0
    )
    return {
        "scenario": scenario_name,
        "pass": ok,
        "rounds_evaluated": len(kept),
        "rounds_excluded_warmup": len(records) - len(kept),
        "torn_lines": n_torn,
        "assertions": assertions,
        "baseline": baseline_block,
        "compute_skips": compute_skips,
        "metrics": metrics,
    }


def write_report(report: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=2, sort_keys=False)
        fh.write("\n")
