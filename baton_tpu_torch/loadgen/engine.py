"""Open-loop scenario driver: a real federation under synthetic traffic.

The engine spins up one real manager and ``workers.count`` real workers
— actual :class:`~baton_tpu_torch.server.http_manager.Experiment` /
:class:`~baton_tpu_torch.server.http_worker.ExperimentWorker` instances on
loopback sockets, nothing mocked — then plays the scenario's phases
against them:

- **Open-loop rounds.** ``GET start_round`` fires every
  ``rounds.interval_s`` seconds of scenario time whether or not the
  previous round finished. A busy manager answers 423 and the refusal
  is *counted*, not retried — arrival rate is the independent variable,
  exactly like production traffic, so overload shows up as a refusal
  rate instead of being silently absorbed by a closed feedback loop.
- **Availability.** Each tick computes the phase's curve level ``a`` and
  marks the first ``round(a × alive)`` workers (by index) available.
  Unavailable workers answer ``round_start`` with an injected 503 — the
  same refusal a phone off-charger would send — which the manager
  counts (``broadcast_rejected_503``) and excludes from the round
  without evicting the client. Deterministic rank-based selection keeps
  runs reproducible.
- **Churn.** Leave/join rates accumulate per tick; a leave tears the
  worker's HTTP server down cold (no deregister — the manager learns
  via notify failures and the TTL cull), a join spawns a brand-new
  worker mid-run. The fleet the SLOs see is never the fleet that
  registered.
- **Stragglers / device speeds.** ``workers.speeds`` maps fleet
  fractions to ``train_time_scale`` multipliers; the manager's
  ``round_timeout`` watchdog turns slow tails into recorded
  ``stragglers`` in ``rounds.jsonl``.
- **Faults.** Phase-scoped :class:`~baton_tpu_torch.utils.faults.FaultInjector`
  rules on the manager and/or every worker (delays, errors, connection
  drops), removed when the phase ends.

Warm-up rounds (CUDA context, cuDNN/cuBLAS plans, first blob fetch) run
before the scenario clock starts with everything available and no faults; their round names are recorded so
the SLO evaluator excludes them. Artifacts land in the run directory:
``rounds.jsonl`` (written by the manager), ``manager_metrics.json``
(the ``/metrics`` scrape), ``loadgen_metrics.json`` (driver counters),
``scenario_summary.json`` (phase timeline + per-round annotations),
plus — when the scenario's ``alerts`` block is enabled (the default) —
``alerts.jsonl`` (the manager's alert lifecycle stream, backing the SLO
evaluator's ``alert:*`` namespace), ``alerts_status.json`` (the final
``GET /alerts`` snapshot), ``forensics_index.json`` and a
``forensics/`` directory of content-addressed bundles. When the
scenario's ``runbooks`` block is enabled (opt-in), the manager also
writes ``runbooks.jsonl`` (the actuation lifecycle stream, backing the
SLO evaluator's ``runbook:*`` namespace) and the driver scrapes the
final ``GET /runbooks`` snapshot into ``runbooks_status.json``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
import random
import shutil
import socket
import time
from typing import List, Optional

import numpy as np
import aiohttp
from aiohttp import web

from baton_tpu_torch import resolve_device
from baton_tpu_torch.core.training import make_local_trainer
from baton_tpu_torch.data.synthetic import linear_client_data
from baton_tpu_torch.loadgen.scenario import PhaseSpec, Scenario
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.server.edge import EdgeAggregator
from baton_tpu_torch.server.http_manager import Manager
from baton_tpu_torch.server.http_worker import ExperimentWorker
from baton_tpu_torch.server.topology import EdgeTopology
from baton_tpu_torch.utils.faults import FaultInjector, Rule
from baton_tpu_torch.utils.metrics import Metrics
from baton_tpu_torch.utils.slog import read_rounds_jsonl

log = logging.getLogger("baton_tpu_torch.loadgen")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _TeeMetrics(Metrics):
    """Per-worker registry that mirrors every write into the shared
    fleet registry. The evaluator's ``fleet:*`` namespace keeps its
    aggregate semantics (one histogram across the whole simulated
    fleet) while each worker's own copy makes per-worker attribution —
    *which* device's heartbeat went bad — possible after the run."""

    def __init__(self, shared: Metrics) -> None:
        super().__init__()
        self._shared = shared

    def inc(self, name: str, value: float = 1.0) -> None:
        super().inc(name, value)
        self._shared.inc(name, value)

    def set_gauge(self, name: str, value: float) -> None:
        super().set_gauge(name, value)
        self._shared.set_gauge(name, value)

    def observe(self, name, seconds, exemplar=None) -> None:
        super().observe(name, seconds, exemplar=exemplar)
        self._shared.observe(name, seconds, exemplar=exemplar)


class _WorkerSlot:
    """One simulated device: its worker, server runner, fault injector
    (availability gate + phase faults), and the flags the ticker flips."""

    __slots__ = ("idx", "worker", "runner", "injector", "available", "alive")

    def __init__(self, idx: int, worker: ExperimentWorker,
                 runner: web.AppRunner, injector: FaultInjector) -> None:
        self.idx = idx
        self.worker = worker
        self.runner = runner
        self.injector = injector
        self.available = True
        self.alive = True


class _EdgeSlot:
    """One edge aggregator: its server runner, loopback port, and
    liveness (a killed edge's runner is torn down cold — no drain, no
    goodbye, exactly like a zone loss)."""

    __slots__ = ("name", "edge", "runner", "port", "alive")

    def __init__(self, name: str, edge: EdgeAggregator,
                 runner: web.AppRunner, port: int) -> None:
        self.name = name
        self.edge = edge
        self.runner = runner
        self.port = port
        self.alive = True


class _RootSlot:
    """One root replica (``manager.standby_roots``): its Experiment, its
    server runner, its loopback port. The active's kill is the same cold
    teardown as an edge death; a standby becomes the new active via the
    lease-expiry promotion in server/replication."""

    __slots__ = ("rid", "exp", "runner", "port", "alive")

    def __init__(self, rid: str, exp, runner: web.AppRunner,
                 port: int) -> None:
        self.rid = rid
        self.exp = exp
        self.runner = runner
        self.port = port
        self.alive = True


class ScenarioRunner:
    """Drives one scenario end to end; :meth:`run` returns the summary
    dict (also written to ``scenario_summary.json``). The root managers
    and the workers hold their params on ``device``, the card unless the
    caller asks for the CPU."""

    def __init__(self, scenario: Scenario, artifacts_dir: str,
                 tick_s: float = 0.1, device="cuda") -> None:
        self.device = resolve_device(device)
        self.scenario = scenario
        self.artifacts_dir = artifacts_dir
        self.tick_s = tick_s
        self.metrics = Metrics()
        # one shared registry for every simulated worker: fleet-wide
        # heartbeat/upload histograms instead of per-process islands
        # (exported as worker_metrics.json, addressed as ``fleet:*``)
        self.fleet_metrics = Metrics()
        # likewise one shared registry across the edge tier (exported
        # as edge_metrics.json, addressed as ``edge:*``)
        self.edge_metrics = Metrics()
        self._edge_slots: List[_EdgeSlot] = []
        self._root_slots: List[_RootSlot] = []
        self._topology: Optional[EdgeTopology] = None
        self.rounds_path = os.path.join(artifacts_dir, "rounds.jsonl")
        self.alerts_path = os.path.join(artifacts_dir, "alerts.jsonl")
        self.runbooks_path = os.path.join(artifacts_dir, "runbooks.jsonl")
        self._rng = random.Random(scenario.seed)
        self._nprng = np.random.default_rng(scenario.seed)
        self._slots: List[_WorkerSlot] = []
        self._next_idx = 0
        self._leave_debt = 0.0
        self._join_debt = 0.0
        self._runners: List[web.AppRunner] = []
        self._round_tasks: List[asyncio.Task] = []
        self._phase_rules: List[tuple] = []   # (injector, Rule)
        self._active_worker_faults: List = []  # FaultSpec, for joiners
        self._session: Optional[aiohttp.ClientSession] = None
        self._exp = None
        self._mport = 0
        self._model = None
        self._trainer = None
        self._coef = None
        self.warmup_round_names: List[str] = []
        self.phase_log: List[dict] = []

    # -- edge tier -----------------------------------------------------
    async def _spawn_edge(self, i: int) -> _EdgeSlot:
        scn = self.scenario
        port = _free_port()
        eapp = web.Application()
        edge = EdgeAggregator(
            eapp, f"127.0.0.1:{self._mport}", name=scn.name, port=port,
            edge_name=f"e{i}",
            heartbeat_time=scn.edges.heartbeat_time,
            flush_after_s=scn.edges.flush_after_s,
            metrics=self.edge_metrics,
        )
        runner = web.AppRunner(eapp)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        slot = _EdgeSlot(f"e{i}", edge, runner, port)
        self._edge_slots.append(slot)
        self._runners.append(runner)
        self.metrics.inc("scenario_edges_started")
        return slot

    async def _kill_edge(self, slot: _EdgeSlot) -> None:
        """Cold teardown: the cohort's workers discover the loss via
        transport errors and fall back direct to the root."""
        slot.alive = False
        if self._topology is not None:
            self._topology.mark_dead(slot.name)
        with contextlib.suppress(Exception):
            await slot.runner.cleanup()
        self.metrics.inc("scenario_edges_killed")
        log.info("loadgen: killed edge %s (port %d)", slot.name, slot.port)

    def _edge_for(self, idx: int) -> Optional[str]:
        """``host:port`` of the live edge a worker routes through, via
        the consistent-hash ring — None in the flat topology."""
        if self._topology is None:
            return None
        name = self._topology.assign(f"w{idx}")
        for slot in self._edge_slots:
            if slot.name == name:
                return f"127.0.0.1:{slot.port}"
        return None

    # -- root replicas -------------------------------------------------
    async def _spawn_standby(self, i: int, port: int,
                             standby_ports: List[int]) -> _RootSlot:
        """One warm standby root: a real manager on its own socket whose
        journal file is written by the WalReceiver. It shares the
        active's rounds/alerts log paths — after promotion its records
        continue the same streams the SLO evaluator reads. Its alert
        rules are empty (a standby evaluating fleet rules against an
        empty registry would fire spurious pages); ``log_event`` aborts
        still land in alerts.jsonl."""
        scn = self.scenario
        wal_dir = os.path.join(self.artifacts_dir, "wal")
        rid = f"root-{i}"
        sapp = web.Application()
        exp = Manager(sapp).register_experiment(
            self._model, name=scn.name, device=self.device,
            round_timeout=scn.manager.round_timeout,
            client_ttl=scn.manager.client_ttl,
            cohort_fraction=scn.manager.cohort_fraction,
            min_cohort=scn.manager.min_cohort,
            ingest_workers=scn.manager.ingest_workers,
            streaming_aggregation=scn.manager.streaming_aggregation,
            rounds_log_path=self.rounds_path,
            alert_rules=(), alerts_interval_s=0.0,
            alerts_log_path=(self.alerts_path if scn.alerts.enabled
                             else None),
            journal_path=os.path.join(wal_dir, f"{rid}.jsonl"),
            journal_fsync="never",
            recovery_policy="resume",
            ha_role="standby",
            ha_replica_id=rid,
            ha_standbys=[f"http://127.0.0.1:{p}" for p in standby_ports
                         if p != port],
            ha_lease_s=scn.manager.ha_lease_s,
            ha_ship_interval_s=scn.manager.ha_ship_interval_s,
            ha_promote_grace_s=scn.manager.ha_promote_grace_s,
            ha_token=f"loadgen-{scn.name}",
            chunk_spill_dir=os.path.join(wal_dir, f"spill-{rid}"),
        )
        runner = web.AppRunner(sapp)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        self._runners.append(runner)
        slot = _RootSlot(rid, exp, runner, port)
        self._root_slots.append(slot)
        return slot

    async def _kill_root(self) -> None:
        """Cold teardown of the active root replica, then block until a
        warm standby observes lease expiry and promotes. The open-loop
        clock, drain, and artifact scrapes all follow ``self._mport`` /
        ``self._exp``, so retargeting them here moves the whole driver
        to the new active."""
        scn = self.scenario
        active = next(
            (s for s in self._root_slots
             if s.alive and s.port == self._mport),
            None,
        )
        if active is None:
            log.warning("loadgen: kill_root with no live active root")
            return
        # strike at the most adversarial moment: a round mid-flight with
        # some updates accepted and already WAL-shipped, others still
        # outstanding. That is the moment the chaos target is about —
        # the promoted standby must resume the round and reuse the
        # journaled payloads (zero retraining for delivered clients).
        # The driver orchestrates the victim round itself instead of
        # hoping phase-boundary timing lands inside one: wait for the
        # fleet to go idle, fire a fresh round (the phase's faults —
        # e.g. a manager-side update delay — hold part of the fleet
        # outstanding), wait for the accepted set to stop growing and
        # for the shipper to put it on the standbys, then pull the plug.
        standbys = [s for s in self._root_slots
                    if s.alive and s.port != self._mport]

        def _idle() -> bool:
            if active.exp.rounds.in_progress:
                return False
            return all(
                not s.worker.round_in_progress
                and s.worker._pending is None
                for s in self._slots if s.alive
            )

        if not await self._wait(_idle, timeout_s=20.0):
            log.warning("loadgen: kill_root: fleet never went idle; "
                        "striking anyway")
        await self._fire_round()
        rm = active.exp.rounds

        def _partial() -> bool:
            return (rm.in_progress and bool(rm.client_responses)
                    and rm.clients_left > 0)

        caught = await self._wait(_partial, timeout_s=15.0, dt=0.01)
        if caught:
            # let the accepted set settle (all undelayed updates in, the
            # delayed ones still outstanding), then require the WAL
            # through the last accepted payload applied on every standby
            deadline = asyncio.get_running_loop().time() + 5.0
            n_resp = -1
            while asyncio.get_running_loop().time() < deadline:
                n = len(rm.client_responses)
                if n == n_resp or not _partial():
                    break
                n_resp = n
                await asyncio.sleep(0.2)
            try:
                jsize = os.path.getsize(active.exp.journal.path)
            except (OSError, AttributeError):
                jsize = 0
            await self._wait(
                lambda: all(
                    s.exp._wal_receiver is not None
                    and (s.exp._wal_receiver.status().get("applied_offset")
                         or 0) >= jsize
                    for s in standbys
                ),
                timeout_s=5.0, dt=0.01,
            )
        else:
            log.warning("loadgen: kill_root found no mid-round window "
                        "within 15s; killing the active anyway")
        active.alive = False
        with contextlib.suppress(Exception):
            await active.runner.cleanup()
        self.metrics.inc("scenario_roots_killed")
        log.info("loadgen: killed active root %s (port %d)",
                 active.rid, active.port)
        standbys = [s for s in self._root_slots if s.alive]
        promoted: List[_RootSlot] = []

        def _find():
            promoted[:] = [s for s in standbys if s.exp.ha_role == "active"]
            return bool(promoted)

        timeout = max(
            30.0,
            20 * (scn.manager.ha_lease_s + scn.manager.ha_promote_grace_s),
        )
        if not await self._wait(_find, timeout_s=timeout):
            raise RuntimeError(
                f"no standby promoted within {timeout:.0f}s of killing "
                f"{active.rid}"
            )
        new = promoted[0]
        self._exp = new.exp
        self._mport = new.port
        log.info("loadgen: %s promoted (epoch %d), driver retargeted",
                 new.rid, new.exp.ha_epoch)

    # -- fleet ---------------------------------------------------------
    async def _spawn_worker(self) -> _WorkerSlot:
        scn = self.scenario
        idx = self._next_idx
        self._next_idx += 1
        data = linear_client_data(
            self._nprng,
            coef=self._coef,
            min_batches=scn.workers.min_batches,
            max_batches=scn.workers.max_batches,
            batch_size=scn.workers.batch_size,
        )
        inj = FaultInjector()
        wapp = web.Application(middlewares=[inj.middleware])
        # with root replicas the worker's failover ring holds every
        # other root (joiners after a failover ring back to the dead
        # active too — rotation skips it on transport error)
        failover = [f"127.0.0.1:{s.port}" for s in self._root_slots
                    if s.port != self._mport] or None
        worker = ExperimentWorker(
            wapp, self._model, f"127.0.0.1:{self._mport}",
            name=scn.name, port=_free_port(), device=self.device,
            failover=failover,
            heartbeat_time=scn.workers.heartbeat_time,
            trainer=self._trainer,
            get_data=lambda d=data: (d, d["x"].shape[0]),
            rng_seed=idx,
            outbox_backoff=(0.05, 0.5),
            upload_chunk_bytes=scn.workers.upload_chunk_bytes,
            train_time_scale=scn.workers.speed_for(idx),
            edge=self._edge_for(idx),
            edge_retry_s=scn.edges.retry_s,
        )
        worker.metrics = _TeeMetrics(self.fleet_metrics)
        runner = web.AppRunner(wapp)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", worker.port).start()
        slot = _WorkerSlot(idx, worker, runner, inj)
        # the availability gate: a standing 503 on round_start that only
        # fires while the ticker has the slot marked unavailable — the
        # manager counts the refusal and skips the worker WITHOUT
        # evicting it (a 404 would force re-registration instead)
        inj.error("round_start", status=503,
                  gate=lambda s=slot: not s.available)
        for fs in self._active_worker_faults:
            self._install_fault(fs, inj, record=True)
        self._slots.append(slot)
        self._runners.append(runner)
        return slot

    async def _reap(self, slot: _WorkerSlot) -> None:
        """Cancel a worker's background delivery tasks. A departed
        worker's outbox would otherwise retry into its own closed
        session forever."""
        for task in (slot.worker._outbox_task, slot.worker._ship_task):
            if task is not None and not task.done():
                task.cancel()
                with contextlib.suppress(Exception, asyncio.CancelledError):
                    await task

    async def _leave(self, slot: _WorkerSlot) -> None:
        slot.alive = False
        slot.available = False
        with contextlib.suppress(Exception):
            await slot.runner.cleanup()
        await self._reap(slot)
        self.metrics.inc("scenario_workers_left")

    # -- faults --------------------------------------------------------
    def _install_fault(self, fs, inj: FaultInjector,
                       record: bool = False) -> Rule:
        if fs.action == "error":
            rule = inj.error(fs.match, status=fs.status, times=fs.times)
        elif fs.action == "delay":
            rule = inj.delay(fs.match, seconds=fs.delay_s, times=fs.times)
        else:
            rule = inj.drop(fs.match, times=fs.times)
        if record:
            self._phase_rules.append((inj, rule))
        return rule

    async def _enter_phase(self, idx: int, phase: PhaseSpec,
                           minj: FaultInjector, elapsed: float) -> None:
        for inj, rule in self._phase_rules:
            inj.remove(rule)
        self._phase_rules.clear()
        for k in phase.kill_edges:
            if k < len(self._edge_slots) and self._edge_slots[k].alive:
                await self._kill_edge(self._edge_slots[k])
        self._active_worker_faults = []
        for fs in phase.faults:
            if fs.target == "manager":
                # NOTE: manager faults always target the run's ORIGINAL
                # active root (its injector); faults in phases after a
                # kill_root land on the dead replica and are inert
                self._install_fault(fs, minj, record=True)
            else:
                self._active_worker_faults.append(fs)
                for slot in self._slots:
                    if slot.alive:
                        self._install_fault(fs, slot.injector, record=True)
        if phase.kill_root:
            # after fault installation: the victim round _kill_root
            # fires must run under this phase's faults (that is how a
            # scenario holds part of the fleet outstanding at the kill)
            await self._kill_root()
        self.metrics.set_gauge("scenario_phase_index", idx)
        self.phase_log.append({
            "phase": phase.name, "index": idx,
            "scenario_t": round(elapsed, 3), "wall_ts": None,  # stamped below
        })
        log.info("loadgen: entering phase %r (t=%.1fs, %d faults)",
                 phase.name, elapsed, len(phase.faults))

    # -- ticker pieces -------------------------------------------------
    def _apply_availability(self, level: float) -> None:
        alive = [s for s in self._slots if s.alive]
        alive.sort(key=lambda s: s.idx)
        k = int(round(level * len(alive)))
        for rank, slot in enumerate(alive):
            slot.available = rank < k
        self.metrics.set_gauge("scenario_availability", level)
        self.metrics.set_gauge("scenario_workers_available", k)
        self.metrics.set_gauge("scenario_workers_alive", len(alive))

    async def _apply_churn(self, phase: PhaseSpec, dt: float) -> None:
        self._leave_debt += phase.churn.leave_per_s * dt
        self._join_debt += phase.churn.join_per_s * dt
        while self._leave_debt >= 1.0:
            self._leave_debt -= 1.0
            alive = [s for s in self._slots if s.alive]
            if len(alive) <= 1:   # never churn the fleet to extinction
                break
            await self._leave(self._rng.choice(alive))
        while self._join_debt >= 1.0:
            self._join_debt -= 1.0
            await self._spawn_worker()
            self.metrics.inc("scenario_workers_joined")

    async def _fire_round(self) -> None:
        scn = self.scenario
        url = (f"http://127.0.0.1:{self._mport}/{scn.name}/start_round"
               f"?n_epoch={scn.rounds.n_epoch}")
        try:
            async with self._session.get(url) as resp:
                await resp.read()
                if resp.status == 200:
                    self.metrics.inc("scenario_rounds_started")
                elif resp.status == 423:
                    self.metrics.inc("scenario_rounds_refused_423")
                else:
                    self.metrics.inc("scenario_start_round_errors")
        except (aiohttp.ClientError, asyncio.TimeoutError):
            self.metrics.inc("scenario_start_round_errors")

    async def _wait(self, cond, timeout_s: float, dt: float = 0.05) -> bool:
        deadline = asyncio.get_running_loop().time() + timeout_s
        while asyncio.get_running_loop().time() < deadline:
            if cond():
                return True
            await asyncio.sleep(dt)
        return bool(cond())

    # -- the run -------------------------------------------------------
    async def run(self) -> dict:
        scn = self.scenario
        os.makedirs(self.artifacts_dir, exist_ok=True)
        # a fresh run must not inherit a previous run's rounds or alerts
        with contextlib.suppress(OSError):
            os.remove(self.rounds_path)
        with contextlib.suppress(OSError):
            os.remove(self.alerts_path)

        self._model = linear_regression_model(scn.model_dim)
        # ground-truth coefficients sized to the scenario's model (the
        # synthetic-data default is a fixed 10-dim demo vector)
        self._coef = self._nprng.standard_normal(scn.model_dim).astype(
            np.float32
        )
        self._trainer = make_local_trainer(
            linear_regression_model(scn.model_dim),
            batch_size=scn.workers.batch_size,
            learning_rate=scn.workers.learning_rate,
        )
        self._mport = _free_port()
        standby_ports = [_free_port()
                         for _ in range(scn.manager.standby_roots)]
        minj = FaultInjector()
        mapp = web.Application(middlewares=[minj.middleware])
        if scn.alerts.enabled:
            # rules=None evaluates the manager's default pack; an
            # explicit scenario list replaces it (already validated at
            # scenario load)
            alerts_kwargs = dict(
                alert_rules=(None if scn.alerts.rules is None
                             else [dict(r) for r in scn.alerts.rules]),
                alerts_log_path=self.alerts_path,
                alerts_interval_s=scn.alerts.interval_s,
                alerts_rounds_window=scn.alerts.rounds_window,
                forensics_dir=os.path.join(self.artifacts_dir, "forensics"),
            )
        else:
            alerts_kwargs = dict(alert_rules=(), alerts_interval_s=0.0)
        runbooks_kwargs = {}
        if scn.runbooks.enabled:
            # actuation rides the alert evaluator's tick; rules=None
            # loads the manager's default remediation pack (already
            # validated at scenario load, same contract as alerts)
            runbooks_kwargs = dict(
                runbook_rules=("default" if scn.runbooks.rules is None
                               else [dict(r) for r in scn.runbooks.rules]),
                runbooks_log_path=self.runbooks_path,
            )
            if not scn.alerts.enabled:
                # the runbook engine evaluates on the alerts tick —
                # keep the tick alive even with alerting itself off
                alerts_kwargs["alerts_interval_s"] = scn.alerts.interval_s
        ha_kwargs = {}
        if standby_ports:
            # replicated control plane: the active journals every round
            # (payloads included) and ships the WAL to the warm standbys;
            # workers get the standby list as their failover ring
            wal_dir = os.path.join(self.artifacts_dir, "wal")
            # a fresh run must not recover a previous run's journal
            shutil.rmtree(wal_dir, ignore_errors=True)
            os.makedirs(wal_dir, exist_ok=True)
            ha_kwargs = dict(
                journal_path=os.path.join(wal_dir, "root-0.jsonl"),
                journal_fsync="never",
                recovery_policy="resume",
                ha_role="active",
                ha_replica_id="root-0",
                ha_standbys=[f"http://127.0.0.1:{p}" for p in standby_ports],
                ha_lease_s=scn.manager.ha_lease_s,
                ha_ship_interval_s=scn.manager.ha_ship_interval_s,
                ha_promote_grace_s=scn.manager.ha_promote_grace_s,
                ha_token=f"loadgen-{scn.name}",
                chunk_spill_dir=os.path.join(wal_dir, "spill-root-0"),
            )
        self._exp = Manager(mapp).register_experiment(
            self._model, name=scn.name, device=self.device,
            round_timeout=scn.manager.round_timeout,
            client_ttl=scn.manager.client_ttl,
            cohort_fraction=scn.manager.cohort_fraction,
            min_cohort=scn.manager.min_cohort,
            ingest_workers=scn.manager.ingest_workers,
            streaming_aggregation=scn.manager.streaming_aggregation,
            rounds_log_path=self.rounds_path,
            **alerts_kwargs,
            **runbooks_kwargs,
            **ha_kwargs,
        )
        mrunner = web.AppRunner(mapp)
        await mrunner.setup()
        await web.TCPSite(mrunner, "127.0.0.1", self._mport).start()
        self._runners.append(mrunner)
        self._root_slots.append(
            _RootSlot("root-0", self._exp, mrunner, self._mport)
        )
        for i, port in enumerate(standby_ports, start=1):
            await self._spawn_standby(i, port, standby_ports)
        self._session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=60)
        )
        try:
            return await self._run_inner(minj)
        finally:
            await self._teardown()

    async def _run_inner(self, minj: FaultInjector) -> dict:
        scn = self.scenario
        exp = self._exp

        if scn.edges.count > 0:
            self._topology = EdgeTopology(
                [f"e{i}" for i in range(scn.edges.count)]
            )
            for i in range(scn.edges.count):
                await self._spawn_edge(i)
        for _ in range(scn.workers.count):
            await self._spawn_worker()
        # each edge registers its own root credentials too
        expected = scn.workers.count + scn.edges.count
        ok = await self._wait(
            lambda: len(exp.registry) >= expected, timeout_s=30.0
        )
        if not ok:
            raise RuntimeError(
                f"fleet failed to register: {len(exp.registry)}"
                f"/{expected} after 30s"
            )

        # warm-up: CUDA context, cuDNN/cuBLAS plans and first blob fetch
        # outside the scenario clock
        for _ in range(scn.rounds.warmup):
            before = exp.rounds.n_rounds
            await self._fire_round()
            await self._wait(
                lambda: exp.rounds.n_rounds > before
                or not exp.rounds.in_progress,
                timeout_s=max(60.0, 2 * scn.manager.round_timeout),
            )
            self.metrics.inc("scenario_warmup_rounds")
        # whatever landed in rounds.jsonl so far is warm-up; the SLO
        # evaluator excludes these names (first-call set-up is a harness
        # property, not a serving-path one)
        self.warmup_round_names = [
            r.get("round") for r in read_rounds_jsonl(self.rounds_path)[0]
        ]

        loop = asyncio.get_running_loop()
        t0 = loop.time()
        wall0 = time.time()
        last_tick = t0
        next_round_at = t0 + 0.01
        rounds_fired = 0
        cur_phase = -1
        total_s = scn.total_s
        while True:
            now = loop.time()
            elapsed = now - t0
            if elapsed >= total_s:
                break
            dt = now - last_tick
            last_tick = now
            pidx, phase, t_in = scn.phase_at(elapsed)
            if pidx != cur_phase:
                cur_phase = pidx
                await self._enter_phase(pidx, phase, minj, elapsed)
                self.phase_log[-1]["wall_ts"] = round(time.time(), 6)
            self._apply_availability(phase.availability.level_at(t_in))
            await self._apply_churn(phase, dt)
            if now >= next_round_at and (
                scn.rounds.max_rounds is None
                or rounds_fired < scn.rounds.max_rounds
            ):
                rounds_fired += 1
                next_round_at += scn.rounds.interval_s
                self._round_tasks.append(
                    asyncio.ensure_future(self._fire_round())
                )
            await asyncio.sleep(self.tick_s)

        # drain: everyone back online, no new rounds; let the last round
        # finish (the round_timeout watchdog force-finishes stragglers)
        self._apply_availability(1.0)
        for inj, rule in self._phase_rules:
            inj.remove(rule)
        self._phase_rules.clear()
        if self._round_tasks:
            await asyncio.wait(self._round_tasks, timeout=60.0)
        grace = (scn.rounds.drain_grace_s
                 if scn.rounds.drain_grace_s is not None
                 else scn.manager.round_timeout + 5.0)
        # drain against the *current* active — a kill_root phase may
        # have retargeted self._exp mid-run
        settled = await self._wait(
            lambda: not self._exp.rounds.in_progress, timeout_s=grace
        )
        if not settled:
            self.metrics.inc("scenario_rounds_forced_end")
            self._exp.end_round()

        # artifacts ---------------------------------------------------
        async with self._session.get(
            f"http://127.0.0.1:{self._mport}/{scn.name}/metrics"
        ) as resp:
            manager_metrics = await resp.json()
        # the manager's timestamped snapshot ring: the SLO evaluator's
        # ``history:*`` rate/delta namespace derives from this
        metrics_history = None
        try:
            async with self._session.get(
                f"http://127.0.0.1:{self._mport}/{scn.name}"
                "/metrics/history"
            ) as resp:
                if resp.status == 200:
                    metrics_history = await resp.json()
        except (aiohttp.ClientError, asyncio.TimeoutError):
            pass
        fleet_health = None
        try:
            async with self._session.get(
                f"http://127.0.0.1:{self._mport}/{scn.name}/fleet/health"
            ) as resp:
                if resp.status == 200:
                    fleet_health = await resp.json()
        except (aiohttp.ClientError, asyncio.TimeoutError):
            pass
        runbooks_status = None
        if scn.runbooks.enabled:
            try:
                async with self._session.get(
                    f"http://127.0.0.1:{self._mport}/{scn.name}/runbooks"
                ) as resp:
                    if resp.status == 200:
                        runbooks_status = await resp.json()
            except (aiohttp.ClientError, asyncio.TimeoutError):
                pass
        alerts_status = None
        forensics_index = None
        if scn.alerts.enabled:
            try:
                async with self._session.get(
                    f"http://127.0.0.1:{self._mport}/{scn.name}/alerts"
                ) as resp:
                    if resp.status == 200:
                        alerts_status = await resp.json()
                async with self._session.get(
                    f"http://127.0.0.1:{self._mport}/{scn.name}/forensics"
                ) as resp:
                    if resp.status == 200:
                        forensics_index = await resp.json()
            except (aiohttp.ClientError, asyncio.TimeoutError):
                pass
        loadgen_metrics = self.metrics.snapshot()
        worker_metrics = self.fleet_metrics.snapshot()
        edge_metrics = self.edge_metrics.snapshot()
        records, n_torn = read_rounds_jsonl(self.rounds_path)
        summary = {
            "scenario": scn.name,
            "total_s": total_s,
            "edges": {
                "count": scn.edges.count,
                "alive": sum(1 for s in self._edge_slots if s.alive),
            },
            "roots": {
                "count": 1 + scn.manager.standby_roots,
                "alive": sum(1 for s in self._root_slots if s.alive),
                "active": next(
                    (s.rid for s in self._root_slots
                     if s.port == self._mport), None,
                ),
            },
            "wall_started": round(wall0, 6),
            "rounds_fired": rounds_fired,
            "warmup_round_names": self.warmup_round_names,
            "phases": self.phase_log,
            "torn_lines": n_torn,
            "rounds": self._annotate_rounds(records, wall0),
            "counters": loadgen_metrics["counters"],
        }
        self._write_json("manager_metrics.json", manager_metrics)
        self._write_json("worker_metrics.json", worker_metrics)
        # per-worker attribution rides in a sibling artifact so the
        # aggregate fleet:* addresses keep their exact semantics
        self._write_json("worker_metrics_per_worker.json", {
            f"w{slot.idx}": slot.worker.metrics.snapshot()
            for slot in self._slots
        })
        if scn.edges.count > 0:
            self._write_json("edge_metrics.json", edge_metrics)
        self._write_json("loadgen_metrics.json", loadgen_metrics)
        if metrics_history is not None:
            self._write_json("metrics_history.json", metrics_history)
        if fleet_health is not None:
            self._write_json("fleet_health.json", fleet_health)
        if alerts_status is not None:
            self._write_json("alerts_status.json", alerts_status)
        if runbooks_status is not None:
            self._write_json("runbooks_status.json", runbooks_status)
        if forensics_index is not None:
            self._write_json("forensics_index.json", forensics_index)
        self._write_json("scenario_summary.json", summary)
        return summary

    def _annotate_rounds(self, records: List[dict], wall0: float) -> List[dict]:
        """Per-round digest with the phase each round *started* in
        (records carry finish-time ``wall_ts`` and ``duration_s``)."""
        out = []
        warmup = set(self.warmup_round_names)
        for r in records:
            started = float(r.get("wall_ts") or 0.0) - float(
                r.get("duration_s") or 0.0
            )
            entry = {
                "round": r.get("round"),
                "outcome": r.get("outcome"),
                "participants": r.get("participants"),
                "reporters": r.get("reporters"),
                "stragglers": len(r.get("stragglers") or ()),
                "duration_s": r.get("duration_s"),
                "warmup": r.get("round") in warmup,
            }
            if not entry["warmup"]:
                t = started - wall0
                entry["scenario_t"] = round(t, 3)
                entry["phase"] = self.scenario.phase_at(max(0.0, t))[1].name
            out.append(entry)
        return out

    def _write_json(self, name: str, obj: dict) -> None:
        with open(os.path.join(self.artifacts_dir, name), "w",
                  encoding="utf-8") as fh:
            json.dump(obj, fh, indent=2, default=repr)
            fh.write("\n")

    async def _teardown(self) -> None:
        for task in self._round_tasks:
            if not task.done():
                task.cancel()
                with contextlib.suppress(Exception, asyncio.CancelledError):
                    await task
        if self._session is not None:
            await self._session.close()
        # workers first (their cleanup pings nothing), manager last
        for runner in reversed(self._runners):
            with contextlib.suppress(Exception):
                await runner.cleanup()
        for slot in self._slots:
            await self._reap(slot)


async def run_scenario(scenario: Scenario, artifacts_dir: str,
                       tick_s: float = 0.1, device="cuda") -> dict:
    return await ScenarioRunner(scenario, artifacts_dir, tick_s=tick_s,
                                device=device).run()
