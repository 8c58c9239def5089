"""Declarative scenario configs for the open-loop load generator.

A scenario file (``benchmarks/scenarios/*.json``) describes one
production-traffic shape as an ordered list of **phases**, each with

- an **availability curve** — what fraction of the fleet answers
  ``round_start`` at time ``t`` (``step`` holds a level, ``sine`` is a
  compressed diurnal day);
- **churn rates** — expected permanent leaves/joins per second
  (leaves stop the worker's server cold: no deregister call, the
  manager finds out via notify failures and the TTL cull);
- **faults** — :class:`baton_tpu_torch.utils.faults.FaultInjector` rules
  installed for the phase's duration (delays, errors, connection
  drops, on the manager or on every worker);

plus fleet-wide knobs (worker count, device-speed multipliers mapped to
``train_time_scale``), manager knobs (round timeout, TTL, cohort
sampling), the open-loop round clock, the **alerts block** (the
manager's declarative alert rules — defaults to the
:mod:`baton_tpu_torch.obs.alerts` pack; rules are validated at parse time so
a typo'd rule fails the run at load, not silently at the first
evaluation tick), and the **SLO block** the evaluator
(:mod:`baton_tpu_torch.loadgen.slo`) gates on.

Everything here is pure config parsing + the availability math — no
I/O beyond :func:`load_scenario`, so the curve shapes are unit-testable
without spinning up a federation.

Unknown keys are an error, not a silent default: a typo'd
``"availabilty"`` must fail the run, not quietly flatten the curve.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

# pure-stdlib module (no jax, no server deps) — safe to import here
from baton_tpu_torch.obs.alerts import AlertRule, AlertRuleError


class ScenarioError(ValueError):
    """Malformed scenario config (bad key, type, or range)."""


_NAME_RE = re.compile(r"^[A-Za-z0-9_\-]{1,64}$")

#: metric comparison operators the SLO block accepts
SLO_OPS = ("<=", ">=", "<", ">", "==")


def _take(d: Dict[str, Any], ctx: str, **fields: Any) -> Dict[str, Any]:
    """Pop known ``fields`` (name → default) out of ``d``; any leftover
    key is a config error. Returns the resolved values."""
    if not isinstance(d, dict):
        raise ScenarioError(f"{ctx}: expected an object, got {type(d).__name__}")
    out = {}
    d = dict(d)
    for key, default in fields.items():
        out[key] = d.pop(key, default)
    if d:
        raise ScenarioError(
            f"{ctx}: unknown key(s) {sorted(d)} (known: {sorted(fields)})"
        )
    return out


def _num(ctx: str, name: str, val: Any, lo: Optional[float] = None,
         hi: Optional[float] = None) -> float:
    if not isinstance(val, (int, float)) or isinstance(val, bool):
        raise ScenarioError(f"{ctx}: `{name}` must be a number, got {val!r}")
    val = float(val)
    if lo is not None and val < lo:
        raise ScenarioError(f"{ctx}: `{name}` must be >= {lo}, got {val}")
    if hi is not None and val > hi:
        raise ScenarioError(f"{ctx}: `{name}` must be <= {hi}, got {val}")
    return val


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AvailabilitySpec:
    """``{"kind": "step", "level": 0.8}`` or
    ``{"kind": "sine", "min": 0.3, "max": 1.0, "period_s": 20}``.

    The sine starts at its peak (``phase`` = 0.25 turns) and troughs
    mid-period — one compressed diurnal day per ``period_s``."""

    kind: str = "step"
    level: float = 1.0
    min: float = 0.0
    max: float = 1.0
    period_s: float = 60.0
    phase: float = 0.25

    @staticmethod
    def parse(d: Dict[str, Any], ctx: str) -> "AvailabilitySpec":
        f = _take(d, ctx, kind="step", level=1.0, min=0.0, max=1.0,
                  period_s=60.0, phase=0.25)
        if f["kind"] not in ("step", "sine"):
            raise ScenarioError(
                f"{ctx}: availability kind must be 'step' or 'sine', "
                f"got {f['kind']!r}"
            )
        spec = AvailabilitySpec(
            kind=f["kind"],
            level=_num(ctx, "level", f["level"], 0.0, 1.0),
            min=_num(ctx, "min", f["min"], 0.0, 1.0),
            max=_num(ctx, "max", f["max"], 0.0, 1.0),
            period_s=_num(ctx, "period_s", f["period_s"], 1e-3),
            phase=_num(ctx, "phase", f["phase"]),
        )
        if spec.kind == "sine" and spec.min > spec.max:
            raise ScenarioError(f"{ctx}: sine min > max")
        return spec

    def level_at(self, t: float) -> float:
        """Available fraction of the fleet at ``t`` seconds into the
        phase, in [0, 1]."""
        if self.kind == "step":
            return self.level
        mid = 0.5 * (self.min + self.max)
        amp = 0.5 * (self.max - self.min)
        val = mid + amp * math.sin(
            2.0 * math.pi * (t / self.period_s + self.phase)
        )
        return min(1.0, max(0.0, val))


@dataclasses.dataclass(frozen=True)
class ChurnSpec:
    leave_per_s: float = 0.0
    join_per_s: float = 0.0

    @staticmethod
    def parse(d: Dict[str, Any], ctx: str) -> "ChurnSpec":
        f = _take(d, ctx, leave_per_s=0.0, join_per_s=0.0)
        return ChurnSpec(
            leave_per_s=_num(ctx, "leave_per_s", f["leave_per_s"], 0.0),
            join_per_s=_num(ctx, "join_per_s", f["join_per_s"], 0.0),
        )


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One FaultInjector rule, installed for the phase's duration."""

    target: str          # "manager" | "workers"
    action: str          # "error" | "delay" | "drop"
    match: str           # substring of path+query (see utils/faults.py)
    status: int = 503
    delay_s: float = 0.0
    times: Optional[int] = None

    @staticmethod
    def parse(d: Dict[str, Any], ctx: str) -> "FaultSpec":
        f = _take(d, ctx, target="manager", action=None, match=None,
                  status=503, delay_s=0.0, times=None)
        if f["target"] not in ("manager", "workers"):
            raise ScenarioError(
                f"{ctx}: fault target must be 'manager' or 'workers'"
            )
        if f["action"] not in ("error", "delay", "drop"):
            raise ScenarioError(
                f"{ctx}: fault action must be 'error', 'delay', or 'drop'"
            )
        if not isinstance(f["match"], str) or not f["match"]:
            raise ScenarioError(f"{ctx}: fault `match` must be a non-empty string")
        times = f["times"]
        if times is not None and (not isinstance(times, int) or times < 1):
            raise ScenarioError(f"{ctx}: fault `times` must be a positive int")
        return FaultSpec(
            target=f["target"], action=f["action"], match=f["match"],
            status=int(_num(ctx, "status", f["status"], 100, 599)),
            delay_s=_num(ctx, "delay_s", f["delay_s"], 0.0),
            times=times,
        )


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    name: str
    duration_s: float
    availability: AvailabilitySpec
    churn: ChurnSpec
    faults: Tuple[FaultSpec, ...]
    #: edge indices (into ``edges.count``) torn down cold when this
    #: phase is entered — the edge-death chaos knob
    kill_edges: Tuple[int, ...] = ()
    #: tear down the *active root replica* cold when this phase is
    #: entered — the control-plane chaos knob. Requires
    #: ``manager.standby_roots`` ≥ the number of kill_root phases: each
    #: kill consumes one warm standby (the driver waits for lease-expiry
    #: promotion and retargets the open-loop clock at the new active).
    kill_root: bool = False

    @staticmethod
    def parse(d: Dict[str, Any], idx: int) -> "PhaseSpec":
        ctx = f"phases[{idx}]"
        f = _take(d, ctx, name=f"phase{idx}", duration_s=None,
                  availability=None, churn=None, faults=None,
                  kill_edges=None, kill_root=False)
        if not isinstance(f["name"], str) or not f["name"]:
            raise ScenarioError(f"{ctx}: `name` must be a non-empty string")
        dur = _num(ctx, "duration_s", f["duration_s"], 1e-3)
        avail = AvailabilitySpec.parse(
            f["availability"] or {}, f"{ctx}.availability"
        )
        churn = ChurnSpec.parse(f["churn"] or {}, f"{ctx}.churn")
        raw_faults = f["faults"] or []
        if not isinstance(raw_faults, list):
            raise ScenarioError(f"{ctx}: `faults` must be a list")
        faults = tuple(
            FaultSpec.parse(fd, f"{ctx}.faults[{i}]")
            for i, fd in enumerate(raw_faults)
        )
        raw_kills = f["kill_edges"] or []
        if not isinstance(raw_kills, list):
            raise ScenarioError(f"{ctx}: `kill_edges` must be a list")
        kills = tuple(
            int(_num(f"{ctx}.kill_edges[{i}]", "index", k, 0))
            for i, k in enumerate(raw_kills)
        )
        if not isinstance(f["kill_root"], bool):
            raise ScenarioError(f"{ctx}: `kill_root` must be a boolean")
        return PhaseSpec(f["name"], dur, avail, churn, faults, kills,
                         f["kill_root"])


@dataclasses.dataclass(frozen=True)
class SpeedGroup:
    """A fraction of the fleet running at ``scale`` × real train time
    (worker ``train_time_scale``). Workers not covered by any group run
    at 1.0."""

    scale: float
    fraction: float


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    count: int = 8
    heartbeat_time: float = 0.5
    batch_size: int = 32
    learning_rate: float = 0.02
    min_batches: int = 2
    max_batches: int = 2
    upload_chunk_bytes: Optional[int] = None
    speeds: Tuple[SpeedGroup, ...] = ()

    @staticmethod
    def parse(d: Dict[str, Any]) -> "WorkerSpec":
        ctx = "workers"
        f = _take(d, ctx, count=8, heartbeat_time=0.5, batch_size=32,
                  learning_rate=0.02, min_batches=2, max_batches=2,
                  upload_chunk_bytes=None, speeds=None)
        count = int(_num(ctx, "count", f["count"], 1))
        raw_speeds = f["speeds"] or []
        if not isinstance(raw_speeds, list):
            raise ScenarioError(f"{ctx}: `speeds` must be a list")
        groups, frac_total = [], 0.0
        for i, sd in enumerate(raw_speeds):
            sf = _take(sd, f"{ctx}.speeds[{i}]", scale=None, fraction=None)
            scale = _num(f"{ctx}.speeds[{i}]", "scale", sf["scale"], 1.0)
            frac = _num(f"{ctx}.speeds[{i}]", "fraction", sf["fraction"],
                        0.0, 1.0)
            frac_total += frac
            groups.append(SpeedGroup(scale=scale, fraction=frac))
        if frac_total > 1.0 + 1e-9:
            raise ScenarioError(f"{ctx}: speed fractions sum to {frac_total} > 1")
        chunk = f["upload_chunk_bytes"]
        if chunk is not None:
            chunk = int(_num(ctx, "upload_chunk_bytes", chunk, 1))
        return WorkerSpec(
            count=count,
            heartbeat_time=_num(ctx, "heartbeat_time", f["heartbeat_time"], 0.05),
            batch_size=int(_num(ctx, "batch_size", f["batch_size"], 1)),
            learning_rate=_num(ctx, "learning_rate", f["learning_rate"], 0.0),
            min_batches=int(_num(ctx, "min_batches", f["min_batches"], 1)),
            max_batches=int(_num(ctx, "max_batches", f["max_batches"], 1)),
            upload_chunk_bytes=chunk,
            speeds=tuple(groups),
        )

    def speed_for(self, idx: int) -> float:
        """Deterministic speed assignment: group g covers the next
        ``round(fraction × count)`` worker indices, remainder is 1.0.
        Joined workers keep cycling the same layout (idx mod count)."""
        idx %= max(1, self.count)
        lo = 0
        for g in self.speeds:
            n = int(round(g.fraction * self.count))
            if lo <= idx < lo + n:
                return g.scale
            lo += n
        return 1.0


@dataclasses.dataclass(frozen=True)
class EdgeSpec:
    """The hierarchical aggregation tier (``server/edge.py``): ``count``
    edge aggregators between the fleet and the root manager, workers
    assigned by consistent hash (``server/topology.py``). ``count: 0``
    (the default) is the flat topology — every worker talks to the root
    directly. ``retry_s`` is how long a worker sits on the direct
    fallback route after an edge transport failure before re-trying its
    edge."""

    count: int = 0
    flush_after_s: float = 15.0
    heartbeat_time: float = 1.0
    retry_s: float = 30.0

    @staticmethod
    def parse(d: Dict[str, Any]) -> "EdgeSpec":
        ctx = "edges"
        f = _take(d, ctx, count=0, flush_after_s=15.0, heartbeat_time=1.0,
                  retry_s=30.0)
        return EdgeSpec(
            count=int(_num(ctx, "count", f["count"], 0)),
            flush_after_s=_num(ctx, "flush_after_s", f["flush_after_s"], 0.05),
            heartbeat_time=_num(ctx, "heartbeat_time", f["heartbeat_time"],
                                0.05),
            retry_s=_num(ctx, "retry_s", f["retry_s"], 0.0),
        )


@dataclasses.dataclass(frozen=True)
class ManagerSpec:
    round_timeout: float = 6.0
    client_ttl: float = 5.0
    cohort_fraction: float = 1.0
    min_cohort: int = 1
    ingest_workers: int = 2
    streaming_aggregation: bool = True
    #: warm standby root replicas behind the active (server/replication):
    #: 0 (default) is the single-root topology. With standbys the active
    #: journals every round and ships the WAL; workers get the standby
    #: list as their ``failover`` ring.
    standby_roots: int = 0
    ha_lease_s: float = 1.0
    ha_ship_interval_s: float = 0.25
    ha_promote_grace_s: float = 0.5

    @staticmethod
    def parse(d: Dict[str, Any]) -> "ManagerSpec":
        ctx = "manager"
        f = _take(d, ctx, round_timeout=6.0, client_ttl=5.0,
                  cohort_fraction=1.0, min_cohort=1, ingest_workers=2,
                  streaming_aggregation=True, standby_roots=0,
                  ha_lease_s=1.0, ha_ship_interval_s=0.25,
                  ha_promote_grace_s=0.5)
        return ManagerSpec(
            round_timeout=_num(ctx, "round_timeout", f["round_timeout"], 0.1),
            client_ttl=_num(ctx, "client_ttl", f["client_ttl"], 0.1),
            cohort_fraction=_num(ctx, "cohort_fraction", f["cohort_fraction"],
                                 0.0, 1.0),
            min_cohort=int(_num(ctx, "min_cohort", f["min_cohort"], 1)),
            ingest_workers=int(_num(ctx, "ingest_workers", f["ingest_workers"], 0)),
            streaming_aggregation=bool(f["streaming_aggregation"]),
            standby_roots=int(_num(ctx, "standby_roots", f["standby_roots"],
                                   0)),
            ha_lease_s=_num(ctx, "ha_lease_s", f["ha_lease_s"], 0.1),
            ha_ship_interval_s=_num(ctx, "ha_ship_interval_s",
                                    f["ha_ship_interval_s"], 0.01),
            ha_promote_grace_s=_num(ctx, "ha_promote_grace_s",
                                    f["ha_promote_grace_s"], 0.0),
        )


@dataclasses.dataclass(frozen=True)
class RoundsSpec:
    """The open-loop clock: a round is *attempted* every ``interval_s``
    seconds of scenario time regardless of whether the previous one
    finished — a busy manager answers 423 and the refusal is counted,
    exactly like overload in production."""

    n_epoch: int = 1
    interval_s: float = 2.0
    max_rounds: Optional[int] = None
    warmup: int = 1
    drain_grace_s: Optional[float] = None   # default: round_timeout + 5

    @staticmethod
    def parse(d: Dict[str, Any]) -> "RoundsSpec":
        ctx = "rounds"
        f = _take(d, ctx, n_epoch=1, interval_s=2.0, max_rounds=None,
                  warmup=1, drain_grace_s=None)
        max_rounds = f["max_rounds"]
        if max_rounds is not None:
            max_rounds = int(_num(ctx, "max_rounds", max_rounds, 1))
        grace = f["drain_grace_s"]
        if grace is not None:
            grace = _num(ctx, "drain_grace_s", grace, 0.0)
        return RoundsSpec(
            n_epoch=int(_num(ctx, "n_epoch", f["n_epoch"], 1)),
            interval_s=_num(ctx, "interval_s", f["interval_s"], 0.05),
            max_rounds=max_rounds,
            warmup=int(_num(ctx, "warmup", f["warmup"], 0)),
            drain_grace_s=grace,
        )


@dataclasses.dataclass(frozen=True)
class SLOAssertion:
    """``{"metric": "rounds.completion_rate", "op": ">=", "value": 0.5}``
    — metric addressing is documented in :mod:`baton_tpu_torch.loadgen.slo`."""

    metric: str
    op: str
    value: float

    @staticmethod
    def parse(d: Dict[str, Any], idx: int) -> "SLOAssertion":
        ctx = f"slo.assertions[{idx}]"
        f = _take(d, ctx, metric=None, op=None, value=None)
        if not isinstance(f["metric"], str) or not f["metric"]:
            raise ScenarioError(f"{ctx}: `metric` must be a non-empty string")
        if f["op"] not in SLO_OPS:
            raise ScenarioError(f"{ctx}: `op` must be one of {SLO_OPS}")
        return SLOAssertion(f["metric"], f["op"], _num(ctx, "value", f["value"]))


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    assertions: Tuple[SLOAssertion, ...] = ()
    baseline: Optional[str] = None   # resolved to an absolute path

    @staticmethod
    def parse(d: Dict[str, Any], base_dir: str) -> "SLOSpec":
        f = _take(d, "slo", assertions=None, baseline=None)
        raw = f["assertions"] or []
        if not isinstance(raw, list):
            raise ScenarioError("slo: `assertions` must be a list")
        assertions = tuple(
            SLOAssertion.parse(a, i) for i, a in enumerate(raw)
        )
        baseline = f["baseline"]
        if baseline is not None:
            if not isinstance(baseline, str) or not baseline:
                raise ScenarioError("slo: `baseline` must be a relative path")
            baseline = os.path.normpath(os.path.join(base_dir, baseline))
        return SLOSpec(assertions=assertions, baseline=baseline)


@dataclasses.dataclass(frozen=True)
class AlertsSpec:
    """The manager's alerting plane for this run. ``rules: null`` (or an
    absent block) evaluates the default pack from
    :mod:`baton_tpu_torch.obs.alerts`; an explicit list replaces it and every
    rule is validated by :meth:`AlertRule.parse` **at scenario load** —
    an unknown key or misspelled op fails the run before any socket
    opens. ``enabled: false`` turns the evaluator off entirely."""

    enabled: bool = True
    interval_s: float = 0.25
    rounds_window: int = 8
    rules: Optional[Tuple[Dict[str, Any], ...]] = None

    @staticmethod
    def parse(d: Dict[str, Any]) -> "AlertsSpec":
        ctx = "alerts"
        f = _take(d, ctx, enabled=True, interval_s=0.25, rounds_window=8,
                  rules=None)
        raw_rules = f["rules"]
        rules: Optional[Tuple[Dict[str, Any], ...]] = None
        if raw_rules is not None:
            if not isinstance(raw_rules, list):
                raise ScenarioError(f"{ctx}: `rules` must be a list or null")
            for i, rd in enumerate(raw_rules):
                try:
                    AlertRule.parse(rd, ctx=f"{ctx}.rules[{i}]")
                except AlertRuleError as exc:
                    raise ScenarioError(str(exc)) from exc
            rules = tuple(dict(rd) for rd in raw_rules)
        return AlertsSpec(
            enabled=bool(f["enabled"]),
            interval_s=_num(ctx, "interval_s", f["interval_s"], 0.01),
            rounds_window=int(_num(ctx, "rounds_window", f["rounds_window"],
                                   1)),
            rules=rules,
        )


@dataclasses.dataclass(frozen=True)
class RunbooksSpec:
    """The manager's autonomous-runbook plane for this run. Off by
    default — actuation is opt-in per scenario. ``rules: null`` with
    ``enabled: true`` loads the default pack from
    :mod:`baton_tpu_torch.obs.runbooks`; an explicit list replaces it and
    every rule is validated by :meth:`RunbookRule.parse` **at scenario
    load**, same contract as :class:`AlertsSpec`."""

    enabled: bool = False
    rules: Optional[Tuple[Dict[str, Any], ...]] = None

    @staticmethod
    def parse(d: Dict[str, Any]) -> "RunbooksSpec":
        ctx = "runbooks"
        f = _take(d, ctx, enabled=False, rules=None)
        raw_rules = f["rules"]
        rules: Optional[Tuple[Dict[str, Any], ...]] = None
        if raw_rules is not None:
            if not isinstance(raw_rules, list):
                raise ScenarioError(f"{ctx}: `rules` must be a list or null")
            from baton_tpu_torch.obs.runbooks import RunbookRule, RunbookRuleError
            for i, rd in enumerate(raw_rules):
                try:
                    RunbookRule.parse(rd, ctx=f"{ctx}.rules[{i}]")
                except RunbookRuleError as exc:
                    raise ScenarioError(str(exc)) from exc
            rules = tuple(dict(rd) for rd in raw_rules)
        return RunbooksSpec(enabled=bool(f["enabled"]), rules=rules)


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    seed: int
    model_dim: int
    workers: WorkerSpec
    manager: ManagerSpec
    rounds: RoundsSpec
    phases: Tuple[PhaseSpec, ...]
    slo: SLOSpec
    edges: EdgeSpec = EdgeSpec()
    alerts: AlertsSpec = AlertsSpec()
    runbooks: RunbooksSpec = RunbooksSpec()

    @property
    def total_s(self) -> float:
        return sum(p.duration_s for p in self.phases)

    def phase_at(self, t: float) -> Tuple[int, PhaseSpec, float]:
        """(index, phase, seconds-into-phase) at scenario time ``t``;
        past the end, sticks to the final phase."""
        acc = 0.0
        for i, p in enumerate(self.phases):
            if t < acc + p.duration_s:
                return i, p, t - acc
            acc += p.duration_s
        last = len(self.phases) - 1
        return last, self.phases[last], self.phases[last].duration_s

    def availability_at(self, t: float) -> float:
        _, phase, t_in = self.phase_at(t)
        return phase.availability.level_at(t_in)


def parse_scenario(d: Dict[str, Any], base_dir: str = ".") -> Scenario:
    f = _take(d, "scenario", name=None, seed=0, model=None, workers=None,
              manager=None, rounds=None, phases=None, slo=None, edges=None,
              alerts=None, runbooks=None)
    name = f["name"]
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise ScenarioError(
            "scenario `name` must match [A-Za-z0-9_-]{1,64} "
            "(it becomes the experiment's URL prefix)"
        )
    model = _take(f["model"] or {}, "model", dim=10)
    phases_raw = f["phases"]
    if not isinstance(phases_raw, list) or not phases_raw:
        raise ScenarioError("scenario needs a non-empty `phases` list")
    edges = EdgeSpec.parse(f["edges"] or {})
    manager = ManagerSpec.parse(f["manager"] or {})
    phases = tuple(PhaseSpec.parse(p, i) for i, p in enumerate(phases_raw))
    for i, p in enumerate(phases):
        for k in p.kill_edges:
            if k >= edges.count:
                raise ScenarioError(
                    f"phases[{i}]: kill_edges index {k} out of range "
                    f"(edges.count = {edges.count})"
                )
    n_root_kills = sum(1 for p in phases if p.kill_root)
    if n_root_kills > manager.standby_roots:
        raise ScenarioError(
            f"{n_root_kills} kill_root phase(s) but manager.standby_roots = "
            f"{manager.standby_roots} — each root kill consumes one warm "
            f"standby"
        )
    if manager.standby_roots > 0 and edges.count > 0:
        raise ScenarioError(
            "manager.standby_roots with an edge tier is not supported yet "
            "(edges have no root-failover ring)"
        )
    return Scenario(
        name=name,
        seed=int(_num("scenario", "seed", f["seed"])),
        model_dim=int(_num("model", "dim", model["dim"], 1)),
        workers=WorkerSpec.parse(f["workers"] or {}),
        manager=manager,
        rounds=RoundsSpec.parse(f["rounds"] or {}),
        phases=phases,
        slo=SLOSpec.parse(f["slo"] or {}, base_dir),
        edges=edges,
        alerts=AlertsSpec.parse(f["alerts"] or {}),
        runbooks=RunbooksSpec.parse(f["runbooks"] or {}),
    )


def load_scenario(path: str) -> Scenario:
    """Parse a scenario file; ``slo.baseline`` resolves relative to it."""
    with open(path, "r", encoding="utf-8") as fh:
        try:
            data = json.load(fh)
        except ValueError as exc:
            raise ScenarioError(f"{path}: not valid JSON: {exc}") from exc
    return parse_scenario(data, base_dir=os.path.dirname(os.path.abspath(path)))
