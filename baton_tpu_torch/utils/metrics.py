"""Metrics registry — counters, gauges, histogram timers, JSON export.

The reference's only observability is ``print`` statements and a broken
``loss_history`` endpoint (SURVEY §5 "Metrics/logging"). This registry
backs the manager's ``GET /{name}/metrics`` endpoint and the engine's
per-round/per-wave timings. Pure Python, no deps, threadsafe enough for
the asyncio + ``to_thread`` training model (GIL-atomic dict ops plus a
lock around multi-field histogram updates).

Timers are fixed-bucket log-spaced histograms: every ``observe`` lands
in one of ``len(_BUCKET_BOUNDS)+1`` buckets, so the snapshot can report
p50/p95/p99 with bounded error (one bucket's width, ratio √2) at O(1)
memory per timer — the SLO quantiles the scenario harness keys on.
"""

from __future__ import annotations

import asyncio
import bisect
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Declared metric registries.
#
# Dashboards and alert rules key on exact metric names, so every
# counter/timer/gauge touched under baton_tpu_torch/server/ or
# baton_tpu_torch/loadgen/ must be declared
# here — batonlint rule BTL030 enforces it (the linter parses these
# literals with ast.literal_eval; keep them plain literals, no computed
# values). Counter FAMILIES whose suffix is built at runtime (f-strings
# keyed on an HTTP status, for example) declare their static prefix in
# DECLARED_COUNTER_PREFIXES instead.
DECLARED_COUNTERS = frozenset({
    # manager: recovery / lifecycle
    "recovery_rounds_aborted",
    "recovery_rounds_resumed",
    "clients_culled",
    "rounds_finished",
    "broadcast_timeout",
    # manager: downlink data plane
    "range_resumes",
    "bytes_broadcast",
    "blob_hits_delta",
    "blob_hits_full",
    # manager: uplink ingest / admission control
    "ingest_rejected_429",
    "uploads_rejected_413",
    "control_rejected_413",
    "bytes_uploaded",
    "duplicate_updates_deduped",
    "repeat_updates_ignored",
    "updates_received",
    "compressed_updates_received",
    "chunk_bytes_received",
    "chunked_uploads_assembled",
    # manager: secure aggregation
    "secure_rounds_aborted_keys",
    "secure_rounds_aborted_shares",
    "secure_rounds_unrecoverable",
    "secure_dropouts_recovered",
    # manager: tracing
    "trace_spans_ingested",
    "trace_spans_rejected",
    # worker: secure aggregation downgrade guard
    "updates_refused_secure_downgrade",
    # worker: outbox / delivery
    "outbox_reloaded_from_disk",
    "updates_delivered",
    "update_retries",
    "update_backpressure_429",
    # worker: downlink blob fetch
    "blob_reused_anchor",
    "blob_fetch_delta",
    "blob_fetch_delta_chain",
    "blob_delta_digest_mismatch",
    "blob_fetch_failed",
    "blob_fetch_full",
    "blob_range_resumes",
    # worker: uplink chunked upload
    "chunk_upload_resumes",
    "chunk_bytes_resume_skipped",
    "chunk_bytes_put",
    # worker: control plane
    "broadcast_rejected_413",
    "train_epochs_completed",
    # worker: trace shipping
    "trace_spans_shipped",
    "trace_ship_failed",
    # manager: hierarchical aggregation (edge partial merge)
    "updates_received_edge_partial",
    "edge_contributors_credited",
    "edge_contributor_conflicts",
    "edge_contributors_unknown",
    "updates_refused_edge_secure",
    "updates_refused_edge_unsupported",
    # edge aggregator (server/edge.py)
    "edge_registers_proxied",
    "edge_heartbeats_proxied",
    "edge_relay_notifies",
    "edge_relay_failed",
    "edge_blob_hits",
    "edge_blob_fetches",
    "edge_blob_fetch_failed",
    "edge_bytes_served",
    "edge_bytes_fetched",
    "edge_range_resumes",
    "edge_updates_folded",
    "edge_updates_proxied",
    "edge_updates_refused_secure",
    "edge_partials_shipped",
    "edge_partial_ship_failed",
    "edge_partial_refused",
    "edge_partials_abandoned",
    # worker: edge routing fallback
    "edge_route_fallbacks",
    # loadgen: open-loop scenario driver (baton_tpu_torch/loadgen/engine.py)
    "scenario_rounds_started",
    "scenario_rounds_refused_423",
    "scenario_start_round_errors",
    "scenario_rounds_forced_end",
    "scenario_workers_joined",
    "scenario_workers_left",
    "scenario_warmup_rounds",
    "scenario_edges_started",
    "scenario_edges_killed",
    # fleet health plane (server/fleet.py ledger)
    "fleet_observations",
    "history_snapshots",
    # compute plane (baton_tpu_torch/obs/compute.py probe records)
    "compute_recompiles",        # worker: jit cache misses after the first
    "compute_records_invalid",   # manager: records dropped by sanitizer
    # manager: edge-tier phase wall times folded into round counter
    # deltas (float seconds; shipped per round in the partial's meta)
    "edge_phase_fold_s",
    "edge_phase_blob_fetch_s",
    "edge_phase_settle_s",
    "edge_phase_ship_prev_s",
    # alerting plane (baton_tpu_torch/obs/alerts.py engine, per node)
    "alerts_fired_total",
    "alerts_resolved_total",
    "alerts_eval_errors",
    "alerts_captures_armed",
    "alerts_captures_built",   # manager: forensics bundles materialized
    # runbook/actuation plane (baton_tpu_torch/obs/runbooks.py engine)
    "runbooks_entered_total",    # rule transitions into ACTIVE
    "runbooks_exited_total",     # hysteresis exits back to idle
    "runbooks_eval_errors",      # advisory: evaluation/actuation failures
    "runbooks_actuations_total",  # remediations actually applied to rounds
    # retention (trace-spool GC + jsonl rotation PeriodicTasks)
    "trace_spool_gc_removed",
    "jsonl_rotations",
    # replication control plane (server/replication.py + ha wiring)
    "wal_segments_shipped",
    "wal_bytes_shipped",
    "wal_segments_applied",
    "wal_segments_refused_stale",
    "wal_resyncs",
    "wal_snapshot_catchups",
    "wal_snapshot_catchups_sent",
    "wal_ship_errors",
    "wal_ship_fenced",
    "ha_promotions",
    "ha_lease_renewals",
    "heartbeats_redirected",
    # manager: journaled-payload recovery (resume without re-training)
    "recovery_updates_reused",
    "recovery_payload_replays_failed",
    "recovery_rebroadcasts",
    "journal_payloads_journaled",
    "journal_payloads_skipped_large",
    "chunk_sessions_restored",
    # worker: root-ring failover + topology redirects
    "root_failovers",
    "root_redirects_followed",
    # loadgen: root-kill chaos phases
    "scenario_roots_killed",
})

DECLARED_COUNTER_PREFIXES = (
    "updates_abandoned_",   # worker: f"updates_abandoned_{status}"
    "broadcast_rejected_",  # manager: f"broadcast_rejected_{status}"
)

# Timers/histograms observed under baton_tpu_torch/server/ (BTL030 audits
# .observe()/.timer() names against this set).
DECLARED_TIMERS = frozenset({
    "round_s",          # manager: reporting-window duration per round
    "checkpoint_s",     # manager: orbax save latency
    "notify_s",         # manager: per-client round_start broadcast POST
    "ingest_decode_s",  # manager: off-loop upload decode+validate
    "ingest_fold_s",    # manager: per-shard streaming fold
    "heartbeat_s",      # worker: heartbeat GET round-trip
    "loop_lag_s",       # both: event-loop scheduling delay (LoopLagProbe)
    # edge aggregator (server/edge.py)
    "edge_blob_fetch_s",    # edge: root blob fetch on cohort cache miss
    "edge_partial_ship_s",  # edge: partial upload to root, end to end
    "edge_relay_s",         # edge: root→worker notify/secure relay hop
    # fleet health plane
    "local_train_s",    # worker: self-measured local training wall time
    "upload_s",         # worker: one update POST end to end
    # compute plane (baton_tpu_torch/obs/compute.py probe)
    "compute_compile_s",  # worker/engine: jit compile wall per round
})

# Timers whose histogram must carry a trace exemplar: every direct
# ``observe()`` on these names is required (batonlint BTL032) to pass
# the active span context via ``exemplar=``, so a p99 spike on
# ``/metrics`` always links to a fetchable round trace. Plain literal —
# the linter parses this with ast.literal_eval like the sets above.
DECLARED_EXEMPLAR_TIMERS = frozenset({
    "round_s",
    "local_train_s",
    "upload_s",
    "compute_compile_s",
})

# Gauges set under baton_tpu_torch/server/ (BTL030 audits .set_gauge() names).
DECLARED_GAUGES = frozenset({
    # manager
    "chunk_sessions_active",
    "sim_wave",
    "sim_waves_total",
    "ingest_queue_depth",
    "clients_registered",
    "rounds_completed",
    "round_in_progress",
    "dh_cache_size",
    "dh_cache_hits",
    "dh_cache_misses",
    # worker
    "outbox_pending",
    "train_epoch",
    "train_epoch_loss",
    # edge aggregator (server/edge.py)
    "edge_cohort_size",
    "edge_round_pending",
    "edge_cache_bytes",
    # both: LoopLagProbe scheduling-delay gauge
    "loop_lag_s",
    # loadgen: scenario driver state
    "scenario_workers_available",
    "scenario_workers_alive",
    "scenario_phase_index",
    "scenario_availability",
    # fleet health plane: advisory per-class client counts
    # (server/fleet.py classifications exported by the manager/edges)
    "fleet_clients_total",
    "fleet_clients_healthy",
    "fleet_clients_slow",
    "fleet_clients_flaky",
    "fleet_clients_degrading",
    "fleet_clients_inactive",
    # alerting plane: current rule-state counts (obs/alerts.py engine)
    "alerts_firing",
    "alerts_pending",
    # runbook plane: rules currently ACTIVE (obs/runbooks.py engine)
    "runbooks_active",
    # compute plane (baton_tpu_torch/obs/compute.py probe records; latest round)
    "compute_mfu",
    "compute_samples_per_sec_per_chip",
    "compute_peak_hbm_gb",
    "compute_recompile_storm",
    "compute_steps",
    "compute_reporters",
    # replication control plane (role, lease, WAL positions)
    "replication_epoch",
    "replication_role_active",
    "replication_standbys",
    "replication_wal_shipped_offset",
    "replication_wal_applied_offset",
    "replication_wal_lag_s",
    "replication_lease_remaining_s",
})


# Log-spaced bucket upper bounds (seconds), ratio √2, 100 µs … ~1 677 s.
# 48 buckets + one overflow keep every histogram at a fixed 49 ints.
_BUCKET_RATIO = 2.0 ** 0.5
_BUCKET_BOUNDS = tuple(1e-4 * _BUCKET_RATIO ** i for i in range(48))

# How long a timer holds on to its worst-observation exemplar before a
# smaller observation may replace it: long enough to survive a scrape
# interval, short enough that a stale p99 trace link ages out.
_EXEMPLAR_TTL_S = 60.0


class _TimerStat:
    """One timer's fixed-bucket histogram plus the legacy scalar stats."""

    __slots__ = ("count", "total", "min", "max", "last", "buckets",
                 "exemplar")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self.last = 0.0
        self.buckets: List[int] = [0] * (len(_BUCKET_BOUNDS) + 1)
        # worst recent observation's span context: {"seconds", "trace_id",
        # "span_id", "ts"} — the /metrics link from a p99 spike to the
        # round trace that produced it
        self.exemplar: Optional[dict] = None

    def observe(
        self,
        seconds: float,
        exemplar: Optional[Tuple[str, str]] = None,
    ) -> None:
        self.count += 1
        self.total += seconds
        self.min = min(self.min, seconds)
        self.max = max(self.max, seconds)
        self.last = seconds
        self.buckets[bisect.bisect_left(_BUCKET_BOUNDS, seconds)] += 1
        if exemplar is not None:
            ex = self.exemplar
            now = time.time()
            if (
                ex is None
                or seconds >= ex["seconds"]
                or now - ex["ts"] > _EXEMPLAR_TTL_S
            ):
                self.exemplar = {
                    "seconds": seconds,
                    "trace_id": exemplar[0],
                    "span_id": exemplar[1],
                    "ts": now,
                }

    def quantile(self, q: float) -> float:
        """Histogram quantile with linear interpolation inside the
        landing bucket, clamped to the observed [min, max] — error is
        bounded by one bucket's width (ratio √2)."""
        if not self.count:
            return 0.0
        rank = q * (self.count - 1)
        seen = 0
        for i, n in enumerate(self.buckets):
            if not n:
                continue
            if rank < seen + n:
                lo = _BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
                hi = (
                    _BUCKET_BOUNDS[i]
                    if i < len(_BUCKET_BOUNDS)
                    else max(self.max, lo)
                )
                frac = (rank - seen + 1.0) / n
                est = lo + (hi - lo) * min(1.0, frac)
                return min(max(est, self.min), self.max)
            seen += n
        return self.max

    def to_json(self) -> dict:
        out = {
            "count": self.count,
            "total_s": self.total,
            "mean_s": self.total / self.count if self.count else 0.0,
            "min_s": self.min if self.count else 0.0,
            "max_s": self.max,
            "last_s": self.last,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "p99_s": self.quantile(0.99),
        }
        if self.exemplar is not None:
            out["exemplar"] = dict(self.exemplar)
        return out


class Metrics:
    def __init__(self, history_limit: int = 240) -> None:
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._timers: Dict[str, _TimerStat] = {}
        self._history: deque = deque(maxlen=max(2, history_limit))
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(
        self,
        name: str,
        seconds: float,
        exemplar: Optional[Tuple[str, str]] = None,
    ) -> None:
        """Record one histogram observation. ``exemplar`` is the active
        ``(trace_id, span_id)`` pair (``tracing.current_context()``) —
        required on timers in :data:`DECLARED_EXEMPLAR_TIMERS` so the
        worst recent observation links back to its round trace."""
        with self._lock:
            stat = self._timers.get(name)
            if stat is None:
                stat = self._timers[name] = _TimerStat()
            stat.observe(seconds, exemplar=exemplar)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # auto-capture the span context active at exit: timers used
            # under a `with tracer.span(...)` get exemplars for free
            from baton_tpu_torch.utils import tracing
            self.observe(name, time.perf_counter() - t0,
                         exemplar=tracing.current_context())

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": {k: v.to_json() for k, v in self._timers.items()},
            }

    # ------------------------------------------------------------------
    def record_history(
        self,
        ts: Optional[float] = None,
        snapshot: Optional[dict] = None,
    ) -> dict:
        """Append a timestamped snapshot to the bounded history ring
        (``GET /{name}/metrics/history``) so scrapers and the SLO
        evaluator can compute rates and windowed deltas without
        maintaining their own state. ``snapshot`` lets the caller record
        a DERIVED snapshot (extra computed gauges) instead of the raw
        registry. Returns the recorded entry."""
        snap = dict(snapshot) if snapshot is not None else self.snapshot()
        snap["ts"] = round(time.time() if ts is None else ts, 6)
        with self._lock:
            self._history.append(snap)
            n = len(self._history)
        self.inc("history_snapshots")
        return dict(snap, samples=n)

    def history(self, since: Optional[float] = None) -> List[dict]:
        """The recorded snapshot ring, oldest first. ``since`` keeps
        only samples with ``ts`` strictly after it, so pollers (the ops
        console) can fetch deltas instead of the full ring."""
        with self._lock:
            samples = list(self._history)
        if since is None:
            return samples
        return [s for s in samples if s.get("ts", 0.0) > since]


class LoopLagProbe:
    """Event-loop scheduling-delay probe — the runtime complement to
    batonlint BTL001. Arms ``call_later(interval)`` and measures how
    late the callback actually fires: any synchronous work hogging the
    loop (a blocking read, an un-thread-ed decode) shows up directly as
    lag. Publishes both a gauge (latest lag) and a histogram (p95/p99
    over the run) under ``loop_lag_s``."""

    def __init__(
        self,
        metrics: Metrics,
        interval: float = 0.25,
        name: str = "loop_lag_s",
    ) -> None:
        self.metrics = metrics
        self.interval = interval
        self.name = name
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._handle: Optional[asyncio.TimerHandle] = None
        self._expected = 0.0
        self._running = False

    def start(self, loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        self._loop = loop if loop is not None else asyncio.get_running_loop()
        self._running = True
        self._arm()

    def _arm(self) -> None:
        self._expected = time.monotonic() + self.interval
        self._handle = self._loop.call_later(self.interval, self._tick)

    def _tick(self) -> None:
        lag = max(0.0, time.monotonic() - self._expected)
        self.metrics.set_gauge(self.name, lag)
        self.metrics.observe(self.name, lag)
        if self._running:
            self._arm()

    def stop(self) -> None:
        self._running = False
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
