"""HTTP manager — reference-protocol control plane over the pure cores
(the port of ``baton_tpu/server/http_manager.py``: the same code with torch
at the JAX seams; the global params live on ``device``, the card by
default).

Exposes exactly the reference endpoint surface (SURVEY §2.8), same routes
and status codes, under ``/{experiment}/``:

  GET  register      JSON {url?, port}        → {client_id, key}
  GET  heartbeat     JSON {client_id, key}    → "OK" | 401
  GET  clients                                → sanitized client list
  GET  start_round   ?n_epoch= (default 32)   → {client_id: ack} | 400 | 423
  GET  end_round                              → round state JSON
  GET  loss_history                           → JSON list
  POST update        ?client_id&key, tensors  → "OK" | 401 | 410 | 413 | 429
  GET  round_blob/{digest}  ?client_id&key    → BTW1 bytes | 401 | 404
                     (v2 pull data plane; supports HTTP Range resume)
  PUT  update_chunk/{update_id}  ?client_id&key&offset&total
                     → {"offset"} per chunk, final chunk acks like POST
                       update | 409 {"offset": committed} | 413 | 429
  GET  update_chunk/{update_id}  ?client_id&key → {"offset", "total"}
                     committed-offset resume probe (HEAD works too)

Uplink ingest (v2): bodies are size-capped at the door
(``max_upload_bytes`` → 413), admitted through a bounded decode queue
(full → 429 + Retry-After), then decoded/validated/folded OFF the event
loop by the ingest pipeline (server/ingest.py) — the loop only does
auth, round checks, and acceptance bookkeeping, so heartbeats and blob
GETs stay responsive while 64 workers upload at once.

Data plane (v2, default): ``start_round`` serializes the round's params
ONCE into an immutable content-addressed blob (server/blobs.py); each
cohort member is notified with a small JSON envelope — round meta, blob
digest, byte size — and pulls the payload from ``round_blob/{digest}``
with Range-resumable GETs. Workers that still hold the previous round's
blob ("anchor") are offered a cached delta blob (``broadcast_delta=``,
computed once per round via ops/compression.py) and reconstruct
``anchor + delta``, verifying by digest with automatic full-blob
fallback. ``allow_pickle=True`` keeps the reference push protocol — a
full pickled body POSTed per client — for stock reference workers.
Uploads fold into a streaming FedAvg accumulator as they arrive
(``O(model)`` manager memory; robust aggregators keep the buffered
path), and every fan-out runs behind a bounded-concurrency gather
(``fanout_concurrency=``) so C=1024 never means 1024 parallel sockets.

Differences from the reference (each a recorded fix, SURVEY §2.9):
* loss_history / end_round handlers work (items 1-2 were AttributeErrors).
* zero-registered-clients start_round aborts cleanly instead of leaking
  the round lock (item 3).
* culled/evicted clients are dropped from the running round, and a
  straggler watchdog force-finishes rounds past ``round_timeout`` with
  partial aggregation (item 4).
* weight upload is BTW1 (no unpickling network bytes) unless
  ``allow_pickle=True`` opts into reference-demo compatibility.

With ``secure_agg=True`` the experiment speaks the Bonawitz
double-masking protocol (server/secure.py): ``start_round`` runs
AdvertiseKeys (``POST /{worker}/secure_keys``) then ShareKeys
(``POST /{worker}/secure_shares``), the broadcast relays each member's
sealed Shamir-share boxes, uploads arrive pairwise+self masked (uint64
ring elements the server cannot read individually), and finalization
reconstructs dropped members' mask keys and reporters' self-mask seeds
from ≥t shares (``POST /{worker}/secure_unmask``) before dequantizing
the sum.

Aggregation defaults to the engine's weighted tree mean — numerically
the reference formula ``Σ(w·θ)/Σw`` (manager.py:119-126) — with
Byzantine-robust alternatives via ``aggregator="trimmed:<r>"|"median"``
(ops/aggregation.py), and an attached
:class:`baton_tpu_torch.parallel.engine.FedSim` can contribute a whole TPU-
simulated cohort to the same round as one weighted participant, so real
edge clients and on-mesh simulated clients compose in one federation.
Workers may upload top-k sparse round deltas (``compress=`` on the
worker; ops/compression.py) — reconstructed here against the round's
broadcast anchor.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import math
import os
import re
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

import aiohttp
from aiohttp import web
import numpy as np
import torch

from baton_tpu_torch import resolve_device
from baton_tpu_torch.core.model import FedModel
from baton_tpu_torch.obs import alerts as obs_alerts
from baton_tpu_torch.obs import compute as obs_compute
from baton_tpu_torch.obs import forensics as obs_forensics
from baton_tpu_torch.obs import runbooks as obs_runbooks
from baton_tpu_torch.ops import aggregation as agg
from baton_tpu_torch.server import replication, wire
from baton_tpu_torch.server.blobs import BlobStore
from baton_tpu_torch.server.fleet import ClientLedger
from baton_tpu_torch.server.ingest import ChunkSession, IngestPipeline
from baton_tpu_torch.server.registry import AuthError, ClientRegistry, UnknownClient
from baton_tpu_torch.server.rounds import RoundInProgress, RoundManager
from baton_tpu_torch.server.state import params_to_state_dict, state_dict_to_params
from baton_tpu_torch.server.utils import (
    BodyTooLarge,
    PeriodicTask,
    bounded_gather,
    json_clean,
    read_body_capped,
    read_json_capped,
)
from baton_tpu_torch.utils import profiling, tracing
from baton_tpu_torch.utils.metrics import LoopLagProbe, Metrics
from baton_tpu_torch.utils.slog import RoundsLog, maybe_rotate_jsonl
from baton_tpu_torch.utils.tracing import trace_headers

DEFAULT_N_EPOCH = 32  # reference manager.py:52-55

_log = logging.getLogger(__name__)

#: worker self-reported timing fields accepted off the wire (anything
#: else in an update's ``meta["timings"]`` is dropped at the door)
_TIMING_KEYS = ("train_s", "upload_s", "hb_rtt_s")


def _clean_timings(raw: Any) -> Optional[dict]:
    """Sanitize a worker/edge-supplied ``timings`` dict: known keys
    only, finite non-negative floats, or ``None`` when nothing valid
    survives — ledger observations never carry attacker-shaped data."""
    if not isinstance(raw, dict):
        return None
    out = {}
    for key in _TIMING_KEYS:
        val = raw.get(key)
        if (
            isinstance(val, (int, float))
            and not isinstance(val, bool)
            and math.isfinite(val)
            and val >= 0
        ):
            out[key] = float(val)
    return out or None


#: compute-record fields accepted off the wire (obs/compute.py schema).
#: Numeric keys may also legitimately arrive as ``None`` — but only
#: with a non-empty ``<key>_reason``/``<key>_source`` string sibling
#: (the null-with-reason invariant, enforced here at the door).
_COMPUTE_NUM_KEYS = (
    "train_s", "steps", "n_chips", "samples_per_sec",
    "samples_per_sec_per_chip", "mfu", "flops_per_sample",
    "compile_s", "recompiles", "peak_hbm_gb",
)
_COMPUTE_STR_KEYS = (
    "device_kind", "model_family",
)
_COMPUTE_BOOL_KEYS = ("cache_hit", "recompile_storm")
_COMPUTE_MAX_STR = 256


def _clean_compute(raw: Any) -> Optional[dict]:
    """Sanitize a worker/edge-supplied compute record: known keys only,
    finite non-negative numbers, bounded strings, and the
    null-with-reason invariant — a null metric WITHOUT a reason/source
    sibling is dropped (never stored as a bare null), and reason
    strings survive only next to the field they excuse."""
    if not isinstance(raw, dict):
        return None
    out: dict = {}
    for key in _COMPUTE_NUM_KEYS:
        val = raw.get(key)
        if (
            isinstance(val, (int, float))
            and not isinstance(val, bool)
            and math.isfinite(val)
            and val >= 0
        ):
            out[key] = float(val)
        elif val is None and key in raw:
            why = raw.get(f"{key}_reason") or raw.get(f"{key}_source")
            if isinstance(why, str) and why:
                out[key] = None
                out[f"{key}_reason"] = why[:_COMPUTE_MAX_STR]
    for key in _COMPUTE_STR_KEYS:
        val = raw.get(key)
        if isinstance(val, str) and val:
            out[key] = val[:_COMPUTE_MAX_STR]
        elif val is None and key in raw:
            why = raw.get(f"{key}_reason") or raw.get(f"{key}_source")
            if isinstance(why, str) and why:
                out[key] = None
                out[f"{key}_reason"] = why[:_COMPUTE_MAX_STR]
    for key in _COMPUTE_BOOL_KEYS:
        if isinstance(raw.get(key), bool):
            out[key] = raw[key]
    # provenance sources riding next to MEASURED values (e.g.
    # peak_hbm_gb_source = "allocator" | "xla_memory_analysis")
    for key in _COMPUTE_NUM_KEYS:
        src = raw.get(f"{key}_source")
        if out.get(key) is not None and isinstance(src, str) and src:
            out[f"{key}_source"] = src[:_COMPUTE_MAX_STR]
    return out or None


class _BadUpload(ValueError):
    """An upload rejected with a *specific* 400 message (unknown
    compression scheme, compressed-in-secure-round, ...). Raised from
    the off-loop decode stage so the handler can distinguish precise
    rejections from the generic "Bad Payload" catch-all."""

    def __init__(self, msg: str) -> None:
        super().__init__(msg)
        self.msg = msg


class Manager:
    """Top-level container (reference manager.py:10-18): holds the aiohttp
    app and registered experiments."""

    def __init__(self, app: web.Application):
        self.app = app
        self.experiments: list[Experiment] = []

    def register_experiment(
        self,
        model: FedModel,
        params=None,
        name: Optional[str] = None,
        **kwargs: Any,
    ) -> "Experiment":
        name = name or getattr(model, "name", None) or f"exp_{len(self.experiments)}"
        experiment = Experiment(name, self.app, model, params=params, **kwargs)
        self.experiments.append(experiment)
        return experiment


class Experiment:
    """One federated experiment: global params + membership + rounds."""

    def __init__(
        self,
        name: str,
        app: web.Application,
        model: FedModel,
        params=None,
        client_ttl: float = 300.0,
        round_timeout: Optional[float] = None,
        allow_pickle: bool = False,
        rng_seed: int = 0,
        start_background_tasks: bool = True,
        checkpoint_dir: Optional[str] = None,
        checkpoint_keep: int = 3,
        metrics: Optional[Metrics] = None,
        secure_agg: bool = False,
        secure_scale_bits: int = 16,
        secure_phase_timeout: Optional[float] = None,
        aggregator: str = "mean",
        streaming_aggregation: bool = True,
        cohort_fraction: float = 1.0,
        min_cohort: int = 1,
        broadcast_quantize_bits: Optional[int] = None,
        broadcast_delta: Optional[str] = None,
        delta_chain_depth: int = 2,
        fanout_concurrency: int = 64,
        journal_path: Optional[str] = None,
        journal_fsync: Any = "always",
        recovery_policy: str = "resume",
        max_upload_bytes: Optional[int] = 1 << 30,
        ingest_workers: int = 4,
        ingest_queue_depth: int = 64,
        fold_shards: int = 1,
        max_chunk_sessions: int = 64,
        trace_dir: Optional[str] = None,
        rounds_log_path: Optional[str] = None,
        clients_log_path: Optional[str] = None,
        health_window: int = 32,
        metrics_history_interval_s: float = 5.0,
        alert_rules: Optional[list] = None,
        alerts_log_path: Optional[str] = None,
        alerts_interval_s: float = 1.0,
        alerts_rounds_window: int = 8,
        forensics_dir: Optional[str] = None,
        forensics_max_bundles: int = 16,
        runbook_rules: Optional[Any] = None,
        runbooks_log_path: Optional[str] = None,
        retention_interval_s: float = 60.0,
        trace_spool_max_age_s: float = 3600.0,
        trace_spool_max_files: int = 512,
        jsonl_max_bytes: Optional[int] = 64 * 1024 * 1024,
        ha_role: Optional[str] = None,
        ha_replica_id: Optional[str] = None,
        ha_standbys: Optional[list] = None,
        ha_replicas: Optional[dict] = None,
        ha_lease_s: float = 3.0,
        ha_ship_interval_s: float = 0.5,
        ha_promote_grace_s: float = 1.0,
        ha_auto_promote: bool = True,
        ha_token: Optional[str] = None,
        chunk_spill_dir: Optional[str] = None,
        journal_payloads: bool = True,
        journal_payload_max_bytes: Optional[int] = 8 * 1024 * 1024,
        device="cuda",
    ):
        """``device``: where the global params live and the buffered
        aggregators run (the card by default; ``"cpu"`` must be asked
        for). ``params``: the initial global params (tensors or arrays,
        named as the model's); without them the model's init runs from a
        ``torch.Generator`` seeded by ``rng_seed``.

        ``aggregator``: ``"mean"`` (sample-weighted FedAvg, reference
        manager.py:119-126), or Byzantine-robust ``"trimmed:<ratio>"`` /
        ``"median"`` (coordinate-wise order statistics over the round's
        reporters, unweighted — a poisoned client must not buy influence
        via a claimed n_samples; ops/aggregation.py).

        ``cohort_fraction``: the FedAvg paper's C — each round samples
        this fraction of registered clients (at least ``min_cohort``)
        for notification instead of broadcasting to everyone (the
        reference's only mode, manager.py:77-86). Unsampled clients
        simply skip the round; their next heartbeat keeps them
        registered.

        ``broadcast_quantize_bits`` (8 or 16): downlink compression —
        each round's broadcast ships stochastically-quantized weights
        (ops/compression.py::quantize_state_dict), 4x/2x smaller on the
        wire. All cohort members dequantize the SAME tensors, so every
        client still starts from identical params, and sparse uplink
        deltas are reconstructed against the dequantized anchor.

        ``broadcast_delta`` (``"q8"`` | ``"q16"`` | ``"topk:<frac>"`` |
        ``"topk:<frac>:qN"``): downlink delta blobs. Each round the
        manager additionally encodes prev_round → this_round under this
        spec, ONCE, and the round's broadcast becomes the (bit-defined)
        reconstruction ``anchor + delta`` — so a worker holding the
        previous round's blob downloads only the small delta, verifies
        its reconstruction by digest, and falls back to the full blob
        automatically. Mutually exclusive with ``allow_pickle`` (push
        clients never pull) and ``broadcast_quantize_bits`` (the delta
        spec already carries the lossy-encoding budget).

        ``delta_chain_depth``: how many consecutive rounds of delta
        blobs to retain and advertise (``delta_broadcast`` mode). A
        worker whose anchor is ``k < delta_chain_depth`` rounds old
        reconstructs the current round through ``k`` small delta pulls
        (each hop digest-verified) instead of one full-blob pull.
        Depth 1 disables chaining (single-hop deltas only); the default
        2 covers a worker that missed one round. Raising it trades blob
        store bytes (one delta blob per retained hop) for cheaper
        re-sync of longer absences.

        ``streaming_aggregation``: with the ``"mean"`` aggregator, fold
        each accepted upload into a running ``(weighted_sum, weight)``
        accumulator and free its tensors immediately — O(model) manager
        memory regardless of cohort size, bit-identical to the buffered
        fold (tests/test_dataplane.py). ``False`` keeps the buffered
        path (per-client state_dicts retained until ``end_round``) for
        introspection/debugging. Robust aggregators always buffer —
        order statistics need the whole cohort.

        ``fanout_concurrency``: cap on simultaneous outbound requests
        for every manager fan-out (notify broadcast, secure phases) —
        see :func:`baton_tpu_torch.server.utils.bounded_gather`.

        ``journal_path``: enable the control-plane write-ahead journal
        (server/journal.py) at this path. On construction the journal is
        replayed: the client registry (ids, auth keys, callback URLs)
        and round counter come back, and an in-flight round is handled
        per ``recovery_policy`` — ``"resume"`` re-announces the round to
        its surviving participants under its original name so their
        trained updates still land; ``"abort"`` discards it cleanly.
        Secure-aggregation rounds always abort on recovery: the mask/
        share state lived only in the dead process. ``journal_fsync``
        is the :class:`~baton_tpu_torch.server.journal.Journal` policy
        (``"always"`` | ``"never"`` | seconds between fsyncs).

        ``max_upload_bytes``: admission cap on any single uplink body
        (update POST, chunk PUT, or a chunked upload's declared total).
        Oversized requests get ``413`` at the door — Content-Length is
        checked before the body is read, and streamed reads are cut off
        at the cap. ``None`` disables the cap.

        ``ingest_workers`` / ``ingest_queue_depth``: the uplink ingest
        pipeline (server/ingest.py). Body decode, payload validation,
        top-k decompression, and the streaming fold run on a pool of
        ``ingest_workers`` threads so the event loop only does auth/
        round checks and hand-off; at most ``ingest_queue_depth``
        uploads may be in the decode stage at once, beyond which the
        manager answers ``429`` with ``Retry-After`` (the worker
        outbox's backoff honors it). ``ingest_workers=0`` disables the
        pipeline and restores the legacy fully-on-loop path.

        ``fold_shards``: number of parallel fold lanes for the
        streaming accumulator. The default 1 folds in acceptance order
        (bit-deterministic, same as the on-loop fold); ``>1`` opts into
        N partial accumulators merged at ``end_round`` — equal to the
        sequential fold up to fp32 reduction order.

        ``max_chunk_sessions``: cap on concurrently assembling chunked
        uploads (each can hold up to ``max_upload_bytes``); beyond it
        new sessions get ``429``.

        ``trace_dir``: enable the distributed round tracer's crash
        spool (baton_tpu_torch/utils/tracing.py): every finished span is
        appended to ``<trace_dir>/<trace_id>.jsonl`` eagerly, so a
        manager killed mid-round loses its heap but not its spans, and
        the recovered incarnation's ``GET /{name}/rounds/{rid}/trace``
        still covers both incarnations. Tracing itself (in-memory
        spans, traceparent propagation, the trace endpoint) is always
        on; the spool is the only part that needs a path.

        ``rounds_log_path``: append one SLO summary record per
        finished/aborted round (participants, stragglers, per-round
        counter deltas, phase durations) to this JSONL file — the data
        contract the scenario harness consumes
        (baton_tpu_torch/utils/slog.py::RoundsLog).

        ``clients_log_path``: persist the fleet health ledger's
        per-client per-round observations to this JSONL file
        (``clients.jsonl``, same crash-safe append discipline as
        ``rounds.jsonl``). The in-memory ledger + classifications
        (``GET /{name}/fleet/health``) are always on; ``health_window``
        bounds each client's observation ring.

        ``metrics_history_interval_s``: period of the background task
        that snapshots the metrics registry into the bounded history
        ring behind ``GET /{name}/metrics/history`` (0 disables it).

        ``alert_rules``: declarative alert rule pack
        (:mod:`baton_tpu_torch.obs.alerts`) evaluated every
        ``alerts_interval_s`` against this node's metric namespace, the
        metrics-history ring, and the last ``alerts_rounds_window``
        round records. ``None`` means the default pack; ``[]`` disables
        evaluation (the ``GET /{name}/alerts`` endpoint stays up).
        Lifecycle transitions append to ``alerts_log_path``
        (``alerts.jsonl``, same crash-safe discipline as
        ``rounds.jsonl``). Rules marked ``capture: true`` arm a
        forensics bundle for the next finished round, stored
        content-addressed under ``forensics_dir`` (in-memory-only when
        unset) and served at ``GET /{name}/forensics/{digest}``; at
        most ``forensics_max_bundles`` are retained.

        ``runbook_rules``: declarative remediation rules
        (:mod:`baton_tpu_torch.obs.runbooks`) the manager ACTUATES — biased/
        over-provisioned cohort sampling, adaptive round deadlines,
        FedBuff-style early finish, recompile-storm shape pinning —
        evaluated on the alerting tick against the alert view plus the
        fleet ledger's ``fleet.*`` classification metrics. Unlike
        alerts, runbooks are opt-in: ``None`` (default) disables
        actuation entirely (``GET /{name}/runbooks`` stays up);
        ``"default"`` selects
        :data:`~baton_tpu_torch.obs.runbooks.DEFAULT_RUNBOOKS`. Every
        applied actuation is stamped into the round's ``rounds.jsonl``
        record (``actuations``) with its triggering alert/metric, and
        rule enter/exit transitions append to ``runbooks_log_path``
        (``runbooks.jsonl``). Actuation is an advisory plane: any
        runbook failure falls back to the un-actuated behavior.

        Retention: every ``retention_interval_s`` a background task
        GCs the trace spool (age ``trace_spool_max_age_s`` / count
        ``trace_spool_max_files``, exempting traces referenced by
        retained forensics bundles) and rotates ``rounds.jsonl`` /
        ``clients.jsonl`` once they exceed ``jsonl_max_bytes``
        (``None`` disables rotation).

        Replication (server/replication.py): ``ha_role`` opts this
        replica into the control-plane HA protocol — ``"active"`` ships
        its journal to ``ha_standbys`` (base URLs) and renews an
        epoch-numbered lease every ``ha_ship_interval_s``;
        ``"standby"`` applies shipped WAL segments at
        ``POST /{name}/wal_segment``, refuses all serving routes 503,
        and (with ``ha_auto_promote``) promotes itself once the lease
        has been expired for ``ha_promote_grace_s``. Both roles require
        ``journal_path``. ``ha_replicas`` (``{replica_id: base_url}``)
        additionally builds the :class:`ExperimentTopology` hash-ring
        assignment of experiments to replicas; a heartbeat landing on
        the wrong replica gets a 307 redirect carrying the refreshed
        topology map. ``ha_token`` authenticates wal_segment POSTs.
        ``chunk_spill_dir`` spills chunk-upload sessions to disk so a
        restart keeps each committed prefix; ``journal_payloads``
        journals accepted update payloads (bodies up to
        ``journal_payload_max_bytes``) so a resumed round reuses
        already-delivered updates instead of re-training reporters."""
        self.device = resolve_device(device)
        if secure_agg and allow_pickle:
            raise ValueError(
                "secure_agg is incompatible with allow_pickle: reference-"
                "protocol pickle workers cannot speak the masking protocol"
            )
        if broadcast_quantize_bits not in (None, 8, 16):
            raise ValueError("broadcast_quantize_bits must be None, 8 or 16")
        if broadcast_quantize_bits is not None and allow_pickle:
            raise ValueError(
                "broadcast quantization is incompatible with allow_pickle: "
                "reference-protocol workers cannot dequantize"
            )
        self.broadcast_quantize_bits = broadcast_quantize_bits
        self._delta_spec: Optional[dict] = None
        if broadcast_delta is not None:
            if allow_pickle:
                raise ValueError(
                    "broadcast_delta is incompatible with allow_pickle: "
                    "reference-protocol workers use the push path and "
                    "never pull blobs"
                )
            if broadcast_quantize_bits is not None:
                raise ValueError(
                    "broadcast_delta and broadcast_quantize_bits are "
                    "mutually exclusive: the delta spec already carries "
                    "the lossy-encoding budget"
                )
            from baton_tpu_torch.ops.compression import parse_delta_spec

            self._delta_spec = parse_delta_spec(broadcast_delta)
        if fanout_concurrency < 1:
            raise ValueError(
                f"fanout_concurrency must be >= 1, got {fanout_concurrency}"
            )
        self.fanout_concurrency = int(fanout_concurrency)
        self._broadcast_anchor_sd: Optional[dict] = None
        # v2 pull data plane: content-addressed blobs + delta anchoring
        self._blobs = BlobStore()
        self._prev_blob_sd: Optional[dict] = None
        self._prev_blob_digest: Optional[str] = None
        # consecutive recent delta-hop descriptors {digest, size, from,
        # to}, oldest first, hop[i]["to"] == hop[i+1]["from"] — retained
        # up to ``delta_chain_depth`` rounds so a worker anchored k
        # rounds back (k < depth) chains k small delta pulls instead of
        # paying a full pull
        self._delta_hops: list = []
        if delta_chain_depth < 1:
            raise ValueError(
                f"delta_chain_depth must be >= 1, got {delta_chain_depth}"
            )
        self.delta_chain_depth = int(delta_chain_depth)
        # streaming FedAvg accumulator for the round in flight (None for
        # robust/secure rounds, which need the buffered path)
        self._stream_acc = None
        # owns every _stream_acc mutation: fold-lane threads add() into
        # it while the loop swaps/rebuilds it (and the simulated-cohort
        # path add()s on the loop) — an asyncio.Lock cannot exclude the
        # lanes, so this must be a threading.Lock on BOTH sides
        self._acc_lock = threading.Lock()
        self.streaming_aggregation = bool(streaming_aggregation)
        if max_upload_bytes is not None and max_upload_bytes < 1:
            raise ValueError(
                f"max_upload_bytes must be >= 1 or None, got {max_upload_bytes}"
            )
        if ingest_workers < 0:
            raise ValueError(
                f"ingest_workers must be >= 0, got {ingest_workers}"
            )
        if fold_shards < 1:
            raise ValueError(f"fold_shards must be >= 1, got {fold_shards}")
        if max_chunk_sessions < 1:
            raise ValueError(
                f"max_chunk_sessions must be >= 1, got {max_chunk_sessions}"
            )
        self.max_upload_bytes = (
            None if max_upload_bytes is None else int(max_upload_bytes)
        )
        self.fold_shards = int(fold_shards)
        self.max_chunk_sessions = int(max_chunk_sessions)
        if not (0.0 < cohort_fraction <= 1.0):
            raise ValueError(
                f"cohort_fraction must be in (0, 1], got {cohort_fraction}"
            )
        self.cohort_fraction = cohort_fraction
        self.min_cohort = max(1, int(min_cohort))
        import random as _random

        self._cohort_rng = _random.Random(rng_seed)
        self.aggregator = agg.parse_aggregator(aggregator)
        if secure_agg and self.aggregator[0] != "mean":
            raise ValueError(
                "robust aggregators are incompatible with secure_agg: the "
                "server only ever sees the cohort SUM, never per-client "
                "updates to trim or take medians over"
            )
        if recovery_policy not in ("resume", "abort"):
            raise ValueError(
                f"recovery_policy must be 'resume' or 'abort', "
                f"got {recovery_policy!r}"
            )
        self.recovery_policy = recovery_policy
        if ha_role not in (None, "active", "standby"):
            raise ValueError(
                f"ha_role must be None, 'active' or 'standby', got {ha_role!r}"
            )
        if ha_role is not None and journal_path is None:
            raise ValueError(
                "ha_role requires journal_path: the WAL is the "
                "replication channel"
            )
        self.ha_role = ha_role
        self.ha_replica_id = ha_replica_id or name
        self.ha_lease_s = float(ha_lease_s)
        self.ha_ship_interval_s = float(ha_ship_interval_s)
        self.ha_promote_grace_s = float(ha_promote_grace_s)
        self.ha_auto_promote = bool(ha_auto_promote)
        self.ha_token = ha_token
        self.ha_epoch = 0
        self._ha_standbys = [
            u.rstrip("/") for u in (ha_standbys or [])
        ]
        self._ha_replica_urls = {
            str(rid): str(url).rstrip("/")
            for rid, url in (ha_replicas or {}).items()
        }
        self._wal_shipper = None
        self._wal_receiver = None
        self._ha_lease: Optional[dict] = None
        self._recovered_ha_epoch = 0
        self.journal_payloads = bool(journal_payloads)
        self.journal_payload_max_bytes = (
            None
            if journal_payload_max_bytes is None
            else int(journal_payload_max_bytes)
        )
        self.name = name
        self.app = app
        self.model = model
        if params is None:
            params = model.init(torch.Generator().manual_seed(rng_seed))
        self.params = {
            k: torch.as_tensor(v, device=self.device) for k, v in params.items()
        }
        self.journal = None
        self._journal_path = journal_path
        self._journal_fsync = journal_fsync
        if journal_path is not None and ha_role != "standby":
            from baton_tpu_torch.server.journal import Journal

            self.journal = Journal(journal_path, fsync=journal_fsync)
        self.registry = ClientRegistry(
            name, client_ttl=client_ttl, journal=self.journal
        )
        self.rounds = RoundManager(
            name, round_timeout=round_timeout, journal=self.journal
        )
        self.metrics = metrics or Metrics()
        # HA wiring (server/replication.py): a standby owns no Journal —
        # its journal FILE is written verbatim by the WalReceiver and
        # only becomes a live Journal at promote()
        if ha_role == "standby":
            self._wal_receiver = replication.WalReceiver(
                journal_path, metrics=self.metrics
            )
        self._ha_topology = (
            replication.ExperimentTopology(sorted(self._ha_replica_urls))
            if self._ha_replica_urls
            else None
        )
        # Distributed round tracing. The service label is
        # per-INCARNATION (random suffix): a chaos test runs a killed
        # manager and its replacement in one OS process, and the trace
        # must attribute each span to the incarnation that emitted it.
        self.tracer = tracing.Tracer(
            service=f"manager#{os.urandom(2).hex()}", spool_dir=trace_dir
        )
        self.rounds_log = (
            RoundsLog(rounds_log_path) if rounds_log_path else None
        )
        # fleet health plane: per-client observation ledger + advisory
        # anomaly classification (server/fleet.py)
        self.fleet = ClientLedger(
            window=health_window,
            log_path=clients_log_path,
            metrics=self.metrics,
            node="manager",
        )
        self.metrics_history_interval_s = float(metrics_history_interval_s)
        # alerting plane (obs/alerts.py): rules evaluated on a periodic
        # tick against the metric view; capture-flagged rules arm a
        # forensics bundle for the next round. Advisory, like the fleet
        # ledger — nothing here may break round completion.
        self.alerts_interval_s = float(alerts_interval_s)
        self.clients_log_path = clients_log_path
        self.retention_interval_s = float(retention_interval_s)
        self.trace_spool_max_age_s = float(trace_spool_max_age_s)
        self.trace_spool_max_files = int(trace_spool_max_files)
        self.jsonl_max_bytes = (
            None if jsonl_max_bytes is None else int(jsonl_max_bytes)
        )
        # mirror of appended rounds.jsonl records: the alert evaluator
        # derives its rounds.* series from this deque so an evaluation
        # tick never does blocking file IO on the loop
        self._recent_rounds: deque = deque(maxlen=64)
        self.forensics = obs_forensics.ForensicsStore(
            forensics_dir, max_bundles=forensics_max_bundles
        )
        # the pending capture armed by a firing capture:true rule —
        # consumed by the next _finish_round_obs
        self._forensics_armed: Optional[dict] = None
        self.alerts = obs_alerts.AlertEngine(
            alert_rules,
            log_path=alerts_log_path,
            metrics=self.metrics,
            node="manager",
            rounds_window=alerts_rounds_window,
            on_capture=self._arm_forensics,
        )
        # runbook plane (obs/runbooks.py): remediations the manager
        # actually applies. Opt-in, unlike alerts — observation is free,
        # actuation changes round behavior, so None means NO rules.
        if runbook_rules == "default":
            runbook_rules = obs_runbooks.DEFAULT_RUNBOOKS
        self.runbooks = obs_runbooks.RunbookEngine(
            runbook_rules or (),
            log_path=runbooks_log_path,
            metrics=self.metrics,
            node="manager",
        )
        # actuations applied to the round in flight, stamped into its
        # rounds.jsonl record by _finish_round_obs (the explainability
        # contract: every actuation names its trigger)
        self._pending_actuations: list = []
        # the notify fan-out of the round in flight (participation
        # denominator for the ledger's missed-round accounting)
        self._round_cohort: list = []
        self._loop_probe = LoopLagProbe(self.metrics)
        # counter snapshot at round start — rounds.jsonl records deltas
        self._slo_base: Optional[dict] = None
        # uplink ingest pipeline (None = legacy fully-on-loop path)
        self._ingest = (
            IngestPipeline(
                workers=ingest_workers,
                queue_depth=ingest_queue_depth,
                fold_shards=fold_shards,
                metrics=self.metrics,
                tracer=self.tracer,
            )
            if ingest_workers > 0
            else None
        )
        # chunked resumable uploads: (client_id, update_id) → ChunkSession
        self.chunk_spill_dir = chunk_spill_dir
        self._chunks: Dict[tuple, ChunkSession] = {}
        if chunk_spill_dir is not None:
            self._chunks = ChunkSession.restore_sessions(chunk_spill_dir)
            if self._chunks:
                self.metrics.inc(
                    "chunk_sessions_restored", float(len(self._chunks))
                )
        # round-robin shard cursor for fold_shards>1 (reset per round)
        self._fold_rr = 0
        # client_ids mid-acceptance across an off-loop decompress await
        # (buffered compressed path) — treated like client_responses for
        # duplicate suppression
        self._accepting: set = set()
        # (edge_client_id, update_id) pairs of edge partials already
        # folded this round: the edge's at-least-once ship retries after
        # a lost 200, and re-folding a cohort partial would double every
        # contributor's weight at once
        self._edge_partial_ids: set = set()
        self.checkpointer = None
        if checkpoint_dir is not None:
            from baton_tpu_torch.utils.checkpoint import Checkpointer

            self.checkpointer = Checkpointer(
                checkpoint_dir, max_to_keep=checkpoint_keep
            )
            restored = self.checkpointer.restore(self.params)
            if restored is not None:
                # Manager restart resumes the federation (the reference
                # lost the global model here, SURVEY §5 checkpoint row).
                self.params = restored.params
                self.rounds.restore(
                    restored.meta.get("n_rounds", restored.step),
                    restored.meta.get("loss_history", []),
                )
        # the round in flight at crash time, recovered from the journal
        # and awaiting re-announce once the event loop is up
        self._recovered_round: Optional[dict] = None
        self._recovery_task = None
        if self.journal is not None:
            self._recover_from_journal(secure_agg)
        if self.ha_role == "active":
            # claim leadership: epoch strictly above anything the
            # journal has seen, fencing every prior incarnation
            self.ha_epoch = self._recovered_ha_epoch + 1
            self._ha_lease = replication.make_lease(
                self.ha_epoch, self.ha_replica_id, self.ha_lease_s
            )
            self.journal.append("ha_lease", **self._ha_lease)
            if self._ha_standbys:
                self._wal_shipper = replication.WalShipper(
                    name,
                    self.journal,
                    self._ha_standbys,
                    self.ha_replica_id,
                    lambda: self._session,
                    token=self.ha_token,
                    metrics=self.metrics,
                )
        self.allow_pickle = allow_pickle
        self.secure_agg = secure_agg
        self.secure_scale_bits = secure_scale_bits
        self.secure_phase_timeout = secure_phase_timeout
        self._rejection_logged_round: Optional[tuple] = None
        # live secure round: {"round_name", "cohort": [ids], "pks": {id: int}}
        self._secure_round: Optional[dict] = None
        self._secure_outboxes: Optional[dict] = None
        self._secure_task = None
        self._secure_finalizing = False
        self._checkpoint_task = None
        self._broadcasting = False
        self.simulator = None  # (FedSim, data, n_samples) triple when attached
        self._sim_args: Optional[dict] = None
        self._sim_task = None
        self.__session: Optional[aiohttp.ClientSession] = None
        self._register_handlers()
        self._background: list[PeriodicTask] = []
        if start_background_tasks:
            app.on_startup.append(self._start_background)
            app.on_cleanup.append(self._stop_background)

    # -- crash recovery ------------------------------------------------
    def _recover_from_journal(self, secure_agg: bool) -> None:
        """Replay snapshot+journal: rebuild membership (ids, keys,
        callback URLs) and the round counter, and stage any in-flight
        round for :meth:`_resume_round` once the event loop is up."""
        rec = self.journal.recover()
        self._recovered_ha_epoch = max(
            self._recovered_ha_epoch, rec.ha_epoch
        )
        if rec.empty:
            return
        for cid, c in rec.clients.items():
            self.registry.restore_client(
                cid,
                key=c.get("key"),
                remote=c.get("remote"),
                port=c.get("port"),
                url=c.get("url"),
                registered_at=c.get("registered_at"),
                num_updates=c.get("num_updates", 0),
                last_update=c.get("last_update"),
            )
        # the journal records every completed round (including the ones
        # the checkpoint's async save may not have landed before the
        # crash), so it is at least as new as the checkpoint — unless
        # journaling was enabled later, in which case keep the
        # checkpoint's counter/history
        if rec.n_rounds >= self.rounds.n_rounds:
            self.rounds.restore(rec.n_rounds, rec.loss_history)
        _log.info(
            "%s: recovered %d clients, %d completed rounds from journal",
            self.name, len(rec.clients), self.rounds.n_rounds,
        )
        if rec.open_round is None:
            return
        if self.recovery_policy == "abort" or secure_agg:
            # secure rounds can never resume: the mask/share directory
            # (self._secure_round) died with the process, so surviving
            # masked uploads could not be unmasked anyway
            reason = "secure_agg" if secure_agg else "recovery_policy"
            round_name = rec.open_round["round_name"]
            self.rounds._journal(
                "round_aborted", round_name=round_name, reason=reason,
            )
            self.metrics.inc("recovery_rounds_aborted")
            # the abort is an SLO event, not just a log line: land it in
            # rounds.jsonl and alerts.jsonl so a failover that kills a
            # secure round is auditable (secure mask/share state is
            # deliberately never shipped — forward secrecy over resume)
            self._finish_round_obs(round_name, f"aborted:recovery_{reason}")
            self.alerts.log_event({
                "event": "recovery_round_aborted",
                "round": round_name,
                "reason": reason,
                "ts": round(time.time(), 6),
            })
            _log.warning(
                "%s: in-flight round %s aborted on recovery (%s)",
                self.name, round_name, reason,
            )
            return
        self._recovered_round = rec.open_round

    async def _resume_round(self) -> None:
        """Re-announce the journal-recovered in-flight round to its
        surviving participants under its ORIGINAL name, so updates they
        trained before the crash (still parked in their outboxes,
        http_worker.py) land in the resumed round."""
        info = self._recovered_round
        self._recovered_round = None
        if info is None or self.rounds.in_progress:
            return
        round_name = info["round_name"]
        meta = dict(info.get("meta") or {})
        n_epoch = int(meta.get("n_epoch", DEFAULT_N_EPOCH))
        cohort = [
            cid for cid in sorted(info.get("participants") or [])
            if cid in self.registry
        ]
        if not cohort:
            self.rounds._journal(
                "round_aborted", round_name=round_name,
                reason="no surviving participants",
            )
            self.metrics.inc("recovery_rounds_aborted")
            _log.warning(
                "%s: round %s had no surviving participants; aborted",
                self.name, round_name,
            )
            return
        self.rounds.resume_round(round_name, **meta)
        self.metrics.inc("recovery_rounds_resumed")
        self._slo_base = self.metrics.snapshot()["counters"]
        trace_id = tracing.make_trace_id(self.name, round_name)
        _log.info(
            "%s: resuming round %s with %d participants",
            self.name, round_name, len(cohort),
        )
        # resumed broadcasts are always dense (never delta-encoded): the
        # quantization seed and blob anchor of the original broadcast
        # died with the old process, and a different anchor would
        # corrupt sparse-delta reconstruction
        state_dict = {
            k: np.ascontiguousarray(np.asarray(v))
            for k, v in params_to_state_dict(self.params).items()
        }
        self._broadcast_anchor_sd = state_dict
        with self._acc_lock:
            self._stream_acc = (
                self._new_stream_acc()
                if self.streaming_aggregation
                and self.aggregator[0] == "mean"
                else None
            )
        if self.allow_pickle:
            meta_out = {"update_name": round_name, "n_epoch": n_epoch}
            body = wire.encode_pickle(state_dict, meta_out)
            ctype = wire.PICKLE_CONTENT_TYPE
        else:
            envelope = self._publish_round_blobs(
                round_name, n_epoch, state_dict, None, None
            )
            body = json.dumps(envelope).encode()
            ctype = "application/json"
        payloads = dict(info.get("payloads") or {})
        rebroadcast = []
        self._broadcasting = True
        try:
            # journaled-payload replay FIRST: a participant whose
            # accepted update rode the WAL re-joins with its ORIGINAL
            # bytes re-ingested — zero re-training, zero retransfer.
            # Only participants with no journaled payload get the
            # re-announce below.
            for cid in cohort:
                p = payloads.get(cid)
                if not isinstance(p, dict) or not p.get("data"):
                    rebroadcast.append(cid)
                    continue
                try:
                    raw = base64.b64decode(p["data"])
                    self.rounds.client_start(cid)
                    resp = await self._ingest_update(
                        cid, raw, p.get("content_type")
                    )
                    ok = resp.status == 200
                except (asyncio.CancelledError, KeyboardInterrupt):
                    raise
                except Exception:
                    ok = False
                if ok:
                    self.metrics.inc("recovery_updates_reused")
                else:
                    self.metrics.inc("recovery_payload_replays_failed")
                    rebroadcast.append(cid)
            if rebroadcast:
                self.metrics.inc(
                    "recovery_rebroadcasts", float(len(rebroadcast))
                )
            # recovery re-announce is a span of the ORIGINAL round's
            # trace: the new incarnation's spans land in the same trace
            # id (derived from the round name), so an exported trace
            # shows both manager lifetimes and the recovery gap between
            with self.tracer.span(
                "recovery_rebroadcast",
                trace_id=trace_id,
                parent_id=tracing.root_span_id(trace_id),
                round=round_name,
                cohort=len(rebroadcast),
            ):
                await bounded_gather(
                    *[
                        self._notify_client(cid, body, ctype)
                        for cid in rebroadcast
                    ],
                    limit=self.fanout_concurrency,
                )
        finally:
            self._broadcasting = False
            # the reporting window starts NOW: the broadcast itself must
            # not count against the participants' round_timeout
            self.rounds.restart_clock()
        if self.rounds.in_progress and not len(self.rounds):
            started_wall = self.rounds.started_wall
            self.rounds.abort_round("resume broadcast unacknowledged")
            self.metrics.inc("recovery_rounds_aborted")
            self._finish_round_obs(
                round_name, "aborted:resume_unacknowledged",
                started_wall=started_wall,
            )
            return
        self._maybe_finish()

    # -- control-plane replication (server/replication.py) -------------
    async def _ha_tick(self) -> None:
        """One replication heartbeat. Active: renew + journal the lease,
        ship the WAL tail to every standby. Standby: promote once the
        active's lease has been expired past the grace window."""
        if self.ha_role == "active":
            self._ha_lease = replication.make_lease(
                self.ha_epoch, self.ha_replica_id, self.ha_lease_s
            )
            self.journal.append("ha_lease", **self._ha_lease)
            self.metrics.inc("ha_lease_renewals")
            if self._wal_shipper is not None:
                await self._wal_shipper.ship_once(
                    self.ha_epoch, self._ha_lease
                )
        elif self.ha_role == "standby" and self._wal_receiver is not None:
            if self.ha_auto_promote and self._wal_receiver.lease_expired(
                self.ha_promote_grace_s
            ):
                await self.promote()

    async def promote(self) -> bool:
        """Standby → active: stop accepting segments, replay the shipped
        WAL into live registry/round state, claim the next epoch, and
        start serving (resuming any in-flight round with its journaled
        payloads). Idempotent — a second call is a no-op."""
        if self.ha_role != "standby" or self._wal_receiver is None:
            return False
        receiver = self._wal_receiver
        # fence FIRST: from this instant every wal_segment POST from the
        # old active answers 409 stale_epoch, so nothing can mutate the
        # journal file underneath the replay below
        receiver.closed = True
        from baton_tpu_torch.server.journal import Journal

        self.journal = Journal(self._journal_path, fsync=self._journal_fsync)
        self.registry.journal = self.journal
        self.rounds.journal = self.journal
        self._recover_from_journal(self.secure_agg)
        self.ha_epoch = (
            max(self._recovered_ha_epoch, receiver.epoch) + 1
        )
        self.ha_role = "active"
        self._ha_lease = replication.make_lease(
            self.ha_epoch, self.ha_replica_id, self.ha_lease_s
        )
        self.journal.append("ha_lease", **self._ha_lease)
        if self._ha_topology is not None:
            holder = (receiver.lease or {}).get("holder")
            if holder:
                self._ha_topology.mark_dead(str(holder))
            self._ha_topology.mark_alive(self.ha_replica_id)
        if self._ha_standbys:
            self._wal_shipper = replication.WalShipper(
                self.name,
                self.journal,
                self._ha_standbys,
                self.ha_replica_id,
                lambda: self._session,
                token=self.ha_token,
                metrics=self.metrics,
            )
        self.metrics.inc("ha_promotions")
        _log.warning(
            "%s: standby %s promoted to active at epoch %d "
            "(wal generation=%s applied_offset=%d)",
            self.name, self.ha_replica_id, self.ha_epoch,
            receiver.generation, receiver.offset,
        )
        if self._recovered_round is not None:
            await self._resume_round()
        return True

    def _standby_refusal(self) -> Optional[web.Response]:
        """503 for serving routes while this replica is a standby — the
        client's failover list (or the 307 topology) sends it to the
        active; a standby must never mutate round state."""
        if self.ha_role != "standby":
            return None
        return web.json_response(
            {"error": "Standby", "epoch": self.ha_epoch}, status=503
        )

    async def handle_wal_segment(self, request: web.Request) -> web.Response:
        """``POST /{name}/wal_segment`` — the replication ingress."""
        if self.ha_token and (
            request.headers.get(replication.HA_TOKEN_HEADER) != self.ha_token
        ):
            return web.json_response({"error": "Unauthorized"}, status=401)
        try:
            seg = await read_json_capped(request, self.max_upload_bytes)
        except BodyTooLarge:
            return web.json_response({"error": "Too Large"}, status=413)
        except (ValueError, TypeError):
            return web.json_response({"error": "Bad Segment"}, status=400)
        if not isinstance(seg, dict):
            return web.json_response({"error": "Bad Segment"}, status=400)
        if self._wal_receiver is not None and not self._wal_receiver.closed:
            status, body = self._wal_receiver.apply(seg)
            return web.json_response(body, status=status)
        # active (or promoted ex-standby): any segment at or below our
        # epoch is a zombie's — the 409 here is the split-brain fence
        try:
            seg_epoch = int(seg.get("epoch", 0))
        except (TypeError, ValueError):
            return web.json_response({"error": "Bad Segment"}, status=400)
        if seg_epoch <= self.ha_epoch:
            self.metrics.inc("wal_segments_refused_stale")
            return web.json_response(
                {"error": "stale_epoch", "epoch": self.ha_epoch}, status=409
            )
        return web.json_response({"error": "not_standby"}, status=409)

    async def handle_replication(self, request: web.Request) -> web.Response:
        """``GET /{name}/replication`` — role/epoch/WAL positions for
        the ops console's replication pane."""
        wal: dict = {}
        if self._wal_shipper is not None:
            wal = {
                "generation": self.journal.generation,
                "targets": self._wal_shipper.positions(),
                "min_shipped_offset": self._wal_shipper.min_shipped_offset(),
            }
        elif self._wal_receiver is not None:
            wal = self._wal_receiver.status()
        body = {
            "role": self.ha_role,
            "replica": self.ha_replica_id,
            "epoch": self.ha_epoch,
            "lease": (
                self._ha_lease
                if self.ha_role == "active"
                else (self._wal_receiver.lease if self._wal_receiver else None)
            ),
            "wal": wal,
            "topology": self._ha_replica_urls or None,
        }
        return web.json_response(json_clean(body))

    # ------------------------------------------------------------------
    async def _start_background(self, app=None) -> None:
        self._loop_probe.start()
        cull = PeriodicTask(self._cull_tick, max(self.registry.client_ttl / 2, 1))
        self._background = [cull.start()]
        if self.metrics_history_interval_s > 0:
            history = PeriodicTask(
                self._history_tick, self.metrics_history_interval_s
            )
            self._background.append(history.start())
        if self.rounds.round_timeout is not None:
            watchdog = PeriodicTask(
                self._watchdog_tick, max(self.rounds.round_timeout / 4, 0.25)
            )
            self._background.append(watchdog.start())
        if (
            (self.alerts.rules or self.runbooks.rules)
            and self.alerts_interval_s > 0
        ):
            alerts_task = PeriodicTask(
                self._alerts_tick, self.alerts_interval_s
            )
            self._background.append(alerts_task.start())
        if self.retention_interval_s > 0 and (
            self.tracer.spool_dir
            or (self.jsonl_max_bytes is not None
                and (self.rounds_log is not None or self.clients_log_path))
        ):
            retention = PeriodicTask(
                self._retention_tick, self.retention_interval_s
            )
            self._background.append(retention.start())
        if self.ha_role is not None:
            ha = PeriodicTask(
                self._ha_tick, max(self.ha_ship_interval_s, 0.05)
            )
            self._background.append(ha.start())
        if self._recovered_round is not None:
            self._recovery_task = asyncio.get_running_loop().create_task(
                self._resume_round()
            )

    async def _stop_background(self, app=None) -> None:
        self._loop_probe.stop()
        for task in self._background:
            await task.stop()
        if self._recovery_task is not None:
            await self._recovery_task
            self._recovery_task = None
        if self._secure_task is not None:
            await self._secure_task
            self._secure_task = None
        if self.__session is not None:
            await self.__session.close()
        if self._checkpoint_task is not None:
            await self._checkpoint_task
            self._checkpoint_task = None
        if self._ingest is not None:
            self._ingest.shutdown()
        if self.checkpointer is not None:
            self.checkpointer.close()
        if self.journal is not None:
            self.journal.close()

    async def _cull_tick(self) -> None:
        for cid in self.registry.cull():
            self.rounds.drop_client(cid)
            self.metrics.inc("clients_culled")
        self._maybe_finish()

    async def _history_tick(self) -> None:
        # record the DERIVED snapshot (registry/round/fleet gauges
        # included) so a history entry equals what /metrics would have
        # answered at that instant
        self.metrics.record_history(snapshot=self.metrics_snapshot())

    async def _alerts_tick(self) -> None:
        # advisory plane: any failure is logged and counted, never
        # propagated — same contract as the fleet ledger
        view: Optional[dict] = None
        try:
            view = obs_alerts.build_metric_view(
                self.metrics_snapshot(),
                list(self._recent_rounds),
                self.alerts.rounds_window,
            )
            self.alerts.evaluate(view, history=self.metrics.history())
        except Exception:
            self.metrics.inc("alerts_eval_errors")
            _log.exception("%s: alert evaluation tick failed", self.name)
        if not self.runbooks.rules:
            return
        # runbook plane rides the same tick: the runbook view is the
        # alert view plus the ledger's fleet.* classification metrics,
        # and alert-triggered rules follow the engine's firing set
        try:
            rb_view = dict(view or {})
            rb_view.update(
                obs_runbooks.derive_fleet_view(self.fleet.classify_all())
            )
            self.runbooks.evaluate(rb_view, firing=self.alerts.firing())
        except Exception:
            self.metrics.inc("runbooks_eval_errors")
            _log.exception("%s: runbook evaluation tick failed", self.name)

    async def _retention_tick(self) -> None:
        """Bound the on-disk observability artifacts: trace-spool GC
        (exempting traces that retained forensics bundles reference) and
        size-based rotation of ``rounds.jsonl`` / ``clients.jsonl``
        (their readers are torn-line-tolerant). All file IO off-loop."""
        if self.tracer.spool_dir:
            removed = await asyncio.to_thread(
                tracing.gc_spool,
                self.tracer.spool_dir,
                max_age_s=self.trace_spool_max_age_s,
                max_files=self.trace_spool_max_files,
                exempt=self.forensics.referenced_trace_ids(),
            )
            if removed:
                self.metrics.inc("trace_spool_gc_removed", removed)
        if self.jsonl_max_bytes is None:
            return
        if self.rounds_log is not None:
            if await asyncio.to_thread(
                self.rounds_log.maybe_rotate, self.jsonl_max_bytes
            ):
                self.metrics.inc("jsonl_rotations")
        if self.clients_log_path:
            if await asyncio.to_thread(
                maybe_rotate_jsonl, self.clients_log_path,
                self.jsonl_max_bytes,
            ):
                self.metrics.inc("jsonl_rotations")

    async def _watchdog_tick(self) -> None:
        if self._broadcasting:
            # round setup (secure phases + broadcast) is still running:
            # ending the round now would strand the in-flight broadcast
            # on a dead round_name — the same knife-edge class as the
            # cull-tick abort, one tick over. The straggler timeout is
            # for clients that fail to REPORT, and nobody has even been
            # notified yet.
            return
        if self.rounds.is_expired:
            self.end_round()  # partial aggregation of whoever reported

    @property
    def _session(self) -> aiohttp.ClientSession:
        if self.__session is None:
            self.__session = aiohttp.ClientSession()
        return self.__session

    # ------------------------------------------------------------------
    def _register_handlers(self) -> None:
        r = self.app.router
        r.add_get(f"/{self.name}/register", self.handle_register)
        r.add_get(f"/{self.name}/heartbeat", self.handle_heartbeat)
        r.add_get(f"/{self.name}/clients", self.handle_clients)
        r.add_get(f"/{self.name}/start_round", self.handle_start_round)
        r.add_get(f"/{self.name}/end_round", self.handle_end_round)
        r.add_get(f"/{self.name}/loss_history", self.handle_loss_history)
        r.add_post(f"/{self.name}/update", self.handle_update)
        # chunked resumable uplink: offset/total-framed PUTs + a GET
        # offset probe (aiohttp auto-answers HEAD for GET routes)
        r.add_put(
            f"/{self.name}/update_chunk/{{update_id}}",
            self.handle_update_chunk,
        )
        r.add_get(
            f"/{self.name}/update_chunk/{{update_id}}",
            self.handle_update_chunk_probe,
        )
        r.add_get(f"/{self.name}/metrics", self.handle_metrics)
        r.add_get(
            f"/{self.name}/metrics/history", self.handle_metrics_history
        )
        r.add_get(f"/{self.name}/fleet/health", self.handle_fleet_health)
        # alerting plane: rule states + firing/pending lists; forensics
        # bundles by content digest
        r.add_get(f"/{self.name}/alerts", self.handle_alerts)
        # runbook plane: rule states + per-rule actuation counts
        r.add_get(f"/{self.name}/runbooks", self.handle_runbooks)
        r.add_get(f"/{self.name}/forensics", self.handle_forensics_index)
        r.add_get(
            f"/{self.name}/forensics/{{digest}}", self.handle_forensics
        )
        r.add_get(
            f"/{self.name}/round_blob/{{digest}}", self.handle_round_blob
        )
        # distributed tracing: export one round's trace; ingest workers'
        # shipped spans into it
        r.add_get(
            f"/{self.name}/rounds/{{rid}}/trace", self.handle_round_trace
        )
        r.add_post(f"/{self.name}/trace_spans", self.handle_trace_spans)
        # control-plane replication: WAL ingress + status pane
        r.add_post(f"/{self.name}/wal_segment", self.handle_wal_segment)
        r.add_get(f"/{self.name}/replication", self.handle_replication)

    # -- v2 pull data plane --------------------------------------------
    _RANGE_RE = re.compile(r"bytes=(\d+)-(\d*)$")

    async def handle_round_blob(self, request: web.Request) -> web.Response:
        """Serve an immutable round blob, with single-range resume.

        Only ``bytes=<start>-[<end>]`` ranges are honored (that is the
        resume shape); anything else is 416. The blob is immutable under
        its digest, so a resumed download never needs If-Range
        validation — the ETag IS the URL."""
        try:
            self.registry.verify(
                request.query.get("client_id", ""),
                request.query.get("key", ""),
            )
        except (UnknownClient, AuthError):
            return web.json_response({"err": "Unauthorized"}, status=401)
        digest = request.match_info["digest"]
        entry = self._blobs.get(digest)
        if entry is None:
            # round rolled and retention dropped it — the worker falls
            # back to whatever the CURRENT round's envelope names
            return web.json_response({"err": "Unknown Blob"}, status=404)
        data, kind = entry
        total = len(data)
        headers = {"Accept-Ranges": "bytes", "ETag": f'"{digest}"'}
        status, start, end = 200, 0, total
        range_hdr = request.headers.get("Range")
        if range_hdr is not None:
            m = self._RANGE_RE.match(range_hdr.strip())
            if m:
                start = int(m.group(1))
                end = int(m.group(2)) + 1 if m.group(2) else total
            if not m or start >= end or end > total:
                headers["Content-Range"] = f"bytes */{total}"
                return web.Response(status=416, headers=headers)
            status = 206
            headers["Content-Range"] = f"bytes {start}-{end - 1}/{total}"
            if start > 0:
                self.metrics.inc("range_resumes")
        payload = data[start:end]
        self.metrics.inc("bytes_broadcast", len(payload))
        self.metrics.inc(
            "blob_hits_delta" if kind == "delta" else "blob_hits_full"
        )
        return web.Response(
            body=payload, status=status,
            content_type=wire.CONTENT_TYPE, headers=headers,
        )

    # -- membership ----------------------------------------------------
    async def handle_register(self, request: web.Request) -> web.Response:
        refusal = self._standby_refusal()
        if refusal is not None:
            return refusal
        try:
            data = await read_json_capped(request)
        except BodyTooLarge as exc:
            self.metrics.inc("control_rejected_413")
            return web.json_response(
                {"err": "Body Too Large", "limit_bytes": exc.limit},
                status=413,
            )
        client = self.registry.register(
            remote=request.remote, port=data.get("port"), url=data.get("url")
        )
        return web.json_response(
            {"client_id": client.client_id, "key": client.key}
        )

    async def handle_heartbeat(self, request: web.Request) -> web.Response:
        refusal = self._standby_refusal()
        if refusal is not None:
            return refusal
        try:
            data = await read_json_capped(request)
        except BodyTooLarge as exc:
            self.metrics.inc("control_rejected_413")
            return web.json_response(
                {"err": "Body Too Large", "limit_bytes": exc.limit},
                status=413,
            )
        try:
            self.registry.heartbeat(data.get("client_id"), data.get("key"))
        except (UnknownClient, AuthError):
            return web.json_response({"err": "Invalid Client"}, status=401)
        # experiment sharding: a heartbeat landing on the wrong replica
        # learns the owner lazily — 307 + the refreshed topology map
        # (the data the worker needs to retarget every other call too)
        if self._ha_topology is not None:
            owner = self._ha_topology.assign(self.name)
            if owner is not None and owner != self.ha_replica_id:
                url = self._ha_replica_urls.get(owner)
                if url:
                    self.metrics.inc("heartbeats_redirected")
                    return web.json_response(
                        {
                            "url": f"{url}/{self.name}/",
                            "replica": owner,
                            "topology": self._ha_replica_urls,
                        },
                        status=307,
                        headers={"Location": f"{url}/{self.name}/heartbeat"},
                    )
        return web.json_response("OK")

    async def handle_clients(self, request: web.Request) -> web.Response:
        return web.json_response(self.registry.to_json())

    # -- rounds --------------------------------------------------------
    async def handle_start_round(self, request: web.Request) -> web.Response:
        refusal = self._standby_refusal()
        if refusal is not None:
            return refusal
        try:
            n_epoch = int(request.query["n_epoch"])
        except KeyError:
            n_epoch = DEFAULT_N_EPOCH
        except ValueError:
            return web.json_response({"err": "Invalid Epoch Value"}, status=400)
        try:
            status = await self.start_round(n_epoch)
        except RoundInProgress:
            return web.json_response(
                {"err": "Update already in progress"}, status=423
            )
        return web.json_response(status)

    async def handle_end_round(self, request: web.Request) -> web.Response:
        refusal = self._standby_refusal()
        if refusal is not None:
            return refusal
        if self._secure_round is not None:
            await self._end_round_secure()
        else:
            self.end_round()
        return web.json_response(json_clean(self.round_state()))

    async def handle_loss_history(self, request: web.Request) -> web.Response:
        return web.json_response([float(x) for x in self.rounds.loss_history])

    def metrics_snapshot(self) -> dict:
        """The full metrics snapshot — counters, gauges, histogram
        timers (p50/p95/p99), plus the derived registry/round gauges.
        This is the ONE producer behind both ``GET /{name}/metrics`` and
        the loadgen SLO evaluator (:mod:`baton_tpu_torch.loadgen.slo`), so the
        scraped view and the gated view cannot drift."""
        from baton_tpu_torch.server import secure

        # advisory fleet classification gauges (fleet_clients_*) are
        # published into the registry so scrapes AND history entries
        # carry them
        self.fleet.export_gauges(self.metrics)
        snap = self.metrics.snapshot()
        snap["gauges"]["clients_registered"] = float(len(self.registry))
        snap["gauges"]["rounds_completed"] = float(self.rounds.n_rounds)
        snap["gauges"]["round_in_progress"] = float(self.rounds.in_progress)
        dh = secure.dh_cache_stats()
        snap["gauges"]["dh_cache_size"] = float(dh["size"])
        snap["gauges"]["dh_cache_hits"] = float(dh["hits"])
        snap["gauges"]["dh_cache_misses"] = float(dh["misses"])
        if self.ha_role is not None:
            g = snap["gauges"]
            g["replication_epoch"] = float(self.ha_epoch)
            g["replication_role_active"] = float(self.ha_role == "active")
            g["replication_standbys"] = float(len(self._ha_standbys))
            if self._wal_shipper is not None:
                g["replication_wal_shipped_offset"] = float(
                    self._wal_shipper.min_shipped_offset()
                )
            recv = self._wal_receiver
            if recv is not None and self.ha_role == "standby":
                g["replication_wal_applied_offset"] = float(recv.offset)
                lag = recv.lag_s()
                if lag is not None:
                    g["replication_wal_lag_s"] = float(lag)
            lease = (
                self._ha_lease
                if self.ha_role == "active"
                else (recv.lease if recv is not None else None)
            )
            if isinstance(lease, dict):
                try:
                    g["replication_lease_remaining_s"] = float(
                        lease.get("expires", 0.0)
                    ) - time.time()
                except (TypeError, ValueError):
                    pass
        return snap

    async def handle_metrics(self, request: web.Request) -> web.Response:
        return web.json_response(self.metrics_snapshot())

    async def handle_metrics_history(
        self, request: web.Request
    ) -> web.Response:
        """``GET /{name}/metrics/history`` — the timestamped snapshot
        ring (oldest first) recorded by the background history task.
        ``?since=<ts>`` returns only samples strictly newer than the
        given wall-clock timestamp, so pollers (the ops console) fetch
        deltas instead of the full ring every refresh."""
        since = None
        raw_since = request.query.get("since")
        if raw_since is not None:
            try:
                since = float(raw_since)
            except ValueError:
                return web.json_response(
                    {"err": "Bad since Timestamp"}, status=400
                )
        history = self.metrics.history(since=since)
        return web.json_response({
            "interval_s": self.metrics_history_interval_s,
            "samples": len(history),
            "history": history,
        })

    async def handle_fleet_health(
        self, request: web.Request
    ) -> web.Response:
        """``GET /{name}/fleet/health`` — per-client telemetry windows
        + advisory anomaly classifications (server/fleet.py)."""
        return web.json_response(json_clean(self.fleet.health_snapshot()))

    # -- alerting plane ------------------------------------------------
    async def handle_alerts(self, request: web.Request) -> web.Response:
        """``GET /{name}/alerts`` — every rule's lifecycle state, last
        value, and recent transitions, plus the firing/pending lists."""
        return web.json_response(json_clean(self.alerts.status_snapshot()))

    # -- runbook plane -------------------------------------------------
    async def handle_runbooks(self, request: web.Request) -> web.Response:
        """``GET /{name}/runbooks`` — every remediation rule's state,
        trigger, params, and how often the manager applied it."""
        return web.json_response(
            json_clean(self.runbooks.status_snapshot())
        )

    def _record_actuation(self, act: dict, detail: dict) -> None:
        """One applied remediation → the round's explainability record
        (``rounds.jsonl`` ``actuations`` entry names the rule AND its
        triggering alert/classification) + the engine's counter."""
        entry = {
            "action": act["action"],
            "rule": act["rule"],
            "trigger": act["trigger"],
            "value": act.get("value"),
            "detail": detail,
        }
        self._pending_actuations.append(entry)
        self.runbooks.record_actuation(act["rule"])

    def _apply_round_deadline(self) -> None:
        """``adaptive_deadline`` actuation: fit THIS round's reporting
        deadline from the fleet's observed per-client ``train_s``
        medians instead of the static ``round_timeout``. Advisory —
        requires a configured ``round_timeout`` (that is what starts
        the expiry watchdog) and any failure keeps the static value."""
        try:
            act = self.runbooks.actuation("adaptive_deadline")
            if act is None or self.rounds.round_timeout is None:
                return
            p = act["params"]
            classified = self.fleet.classify_all()
            max_s = p.get("max_s")
            if max_s is None:
                # bound a bad fit: never hold a round open past 4x the
                # operator's static timeout
                max_s = 4.0 * self.rounds.round_timeout
            deadline = obs_runbooks.fit_deadline(
                (c.get("train_s_median") for c in classified.values()),
                quantile=p["quantile"],
                margin=p["margin"],
                min_s=p.get("min_s"),
                max_s=max_s,
            )
            if deadline is None:
                return
            self.rounds.set_deadline(deadline)
            self._record_actuation(act, {
                "deadline_s": round(deadline, 6),
                "base_timeout_s": self.rounds.round_timeout,
                "clients_fit": sum(
                    1 for c in classified.values()
                    if c.get("train_s_median") is not None
                ),
            })
        except Exception:
            self.metrics.inc("runbooks_eval_errors")
            _log.exception(
                "%s: adaptive_deadline actuation failed", self.name
            )

    def _fedbuff_buffer_full(self) -> bool:
        """``fedbuff_fallback`` actuation: under churn, finish the
        round as soon as a FedBuff-style buffer of
        ``ceil(buffer_frac · cohort)`` reports has landed instead of
        waiting out the stragglers."""
        try:
            act = self.runbooks.actuation("fedbuff_fallback")
            if act is None:
                return False
            cohort = len(self.rounds.clients)
            need = max(1, math.ceil(act["params"]["buffer_frac"] * cohort))
            have = len(self.rounds.client_responses)
            if have < need:
                return False
            self._record_actuation(act, {
                "buffered": have,
                "required": need,
                "cohort": cohort,
                "cut_stragglers": sorted(
                    set(self.rounds.clients)
                    - set(self.rounds.client_responses)
                ),
            })
            return True
        except Exception:
            self.metrics.inc("runbooks_eval_errors")
            return False

    async def handle_forensics_index(
        self, request: web.Request
    ) -> web.Response:
        return web.json_response(
            json_clean({"bundles": self.forensics.list_bundles()})
        )

    async def handle_forensics(self, request: web.Request) -> web.Response:
        """``GET /{name}/forensics/{digest}`` — one content-addressed
        bundle manifest with its evidence sections inline."""
        bundle = self.forensics.get(request.match_info["digest"])
        if bundle is None:
            return web.json_response({"err": "Unknown Bundle"}, status=404)
        return web.json_response(json_clean(bundle))

    def _arm_forensics(self, rule, event: dict) -> None:
        """``on_capture`` hook: a capture-flagged rule fired — arm a
        bundle for the next finished round, and arm the one-shot
        profiler capture that the next training step consumes
        (graceful no-op off-TPU / when no step runs while armed)."""
        base = self.forensics.dir_path or tempfile.gettempdir()
        profile_dir = os.path.join(
            base, f"forensics_profile_{self.name}_{rule.name}"
        )
        profiling.arm_forensics_trace(profile_dir)
        self._forensics_armed = {
            "rule": rule.name,
            "severity": rule.severity,
            "armed_ts": float(event.get("ts") or time.time()),
            "profile_dir": profile_dir,
        }

    def _build_forensics_bundle(self, record: dict) -> None:
        """Package the armed capture against the round that just
        finished: every evidence section present or null-with-reason
        (:mod:`baton_tpu_torch.obs.forensics`)."""
        armed, self._forensics_armed = self._forensics_armed, None
        if armed is None:
            return
        sections: Dict[str, Any] = {}
        reasons: Dict[str, str] = {}
        snap = self.metrics.snapshot()
        sections["jax_profile"] = obs_forensics.profile_dir_summary(
            armed.get("profile_dir")
        )
        if sections["jax_profile"] is None:
            reasons["jax_profile"] = (
                "profiler produced no artifacts (off-TPU no-op, or no "
                "training step ran while armed)"
            )
        try:
            sections["task_stacks"] = obs_forensics.dump_asyncio_tasks()
        except Exception as exc:
            reasons["task_stacks"] = obs_forensics.safe_repr_exc(exc)
        lag = (snap.get("timers") or {}).get("loop_lag_s")
        if lag is not None:
            sections["loop_lag"] = lag
        try:
            stragglers = record.get("stragglers") or None
            sections["fleet_slice"] = self.fleet.health_slice(stragglers)
        except Exception as exc:
            reasons["fleet_slice"] = obs_forensics.safe_repr_exc(exc)
        trace_id = record.get("trace_id")
        try:
            export = self.tracer.export(trace_id) if trace_id else None
            if export and export.get("traceEvents"):
                sections["round_trace"] = export
        except Exception as exc:
            reasons["round_trace"] = obs_forensics.safe_repr_exc(exc)
        history = self.metrics.history()
        if history:
            sections["metric_history"] = history[-32:]
        manifest = obs_forensics.build_manifest(
            rule=armed["rule"],
            severity=armed["severity"],
            round_name=record.get("round"),
            trace_id=trace_id,
            node="manager",
            armed_ts=armed["armed_ts"],
            captured_ts=time.time(),
            sections=sections,
            reasons=reasons,
        )
        digest = self.forensics.put(manifest)
        self.metrics.inc("alerts_captures_built")
        self.alerts.log_event({
            "ts": round(time.time(), 6),
            "event": "forensics",
            "rule": armed["rule"],
            "severity": armed["severity"],
            "round": record.get("round"),
            "digest": digest,
            "sections_present": manifest["sections_present"],
        })
        _log.info(
            "%s: forensics bundle %s captured for rule %s (round %s)",
            self.name, digest, armed["rule"], record.get("round"),
        )

    # -- distributed tracing -------------------------------------------
    def _round_trace_id(self, rid: str) -> str:
        """A trace id from either a full round name or a bare round
        index (``7`` → ``update_{name}_00007``)."""
        round_name = (
            f"update_{self.name}_{int(rid):05d}" if rid.isdigit() else rid
        )
        return tracing.make_trace_id(self.name, round_name)

    async def handle_round_trace(self, request: web.Request) -> web.Response:
        """``GET /{name}/rounds/{rid}/trace`` → Chrome ``trace_event``
        JSON for one round (load it straight into Perfetto). ``rid`` is
        the round name or its numeric index. Export reads the crash
        spool, so it runs off-loop."""
        trace_id = self._round_trace_id(request.match_info["rid"])
        export = await asyncio.to_thread(self.tracer.export, trace_id)
        if not export["traceEvents"]:
            return web.json_response({"err": "Unknown Trace"}, status=404)
        return web.json_response(export)

    async def handle_trace_spans(self, request: web.Request) -> web.Response:
        """``POST /{name}/trace_spans`` — authenticated span upstream:
        workers ship their finished spans here after delivering an
        update, so one endpoint serves the whole distributed trace."""
        try:
            self.registry.verify(
                request.query.get("client_id", ""),
                request.query.get("key", ""),
            )
        except (UnknownClient, AuthError):
            return web.json_response({"err": "Unauthorized"}, status=401)
        try:
            data = await read_json_capped(request)
        except BodyTooLarge as exc:
            self.metrics.inc("control_rejected_413")
            return web.json_response(
                {"err": "Body Too Large", "limit_bytes": exc.limit},
                status=413,
            )
        spans = data.get("spans") if isinstance(data, dict) else data
        if not isinstance(spans, list):
            return web.json_response({"err": "Bad Span List"}, status=400)
        # ingest validates per-span and appends to the crash spool —
        # file writes, so keep it off the loop
        accepted = await asyncio.to_thread(self.tracer.ingest, spans)
        self.metrics.inc("trace_spans_ingested", accepted)
        if accepted < len(spans):
            self.metrics.inc("trace_spans_rejected", len(spans) - accepted)
        return web.json_response({"accepted": accepted})

    def _finish_round_obs(
        self,
        round_name: str,
        outcome: str,
        participants=(),
        responses: Optional[dict] = None,
        started_wall: Optional[float] = None,
    ) -> None:
        """Round-end observability: emit the round's ROOT span
        retroactively (deterministic span id — phase spans were already
        parent-linked to it) and append the SLO record to rounds.jsonl.
        Called from every path that finishes or aborts a round."""
        trace_id = tracing.make_trace_id(self.name, round_name)
        end = time.time()
        t0 = started_wall if started_wall is not None else end
        self.tracer.record_span(
            "round",
            trace_id=trace_id,
            span_id=tracing.root_span_id(trace_id),
            start=t0,
            end=end,
            round=round_name,
            outcome=outcome,
        )
        # fold the round into the fleet ledger FIRST (rounds_log may be
        # off): every cohort member gets a reported/straggler/missed
        # observation, and non-reporters get a classification-backed
        # "why" for the SLO record. Advisory plane — it must never be
        # able to break round completion.
        cohort, self._round_cohort = self._round_cohort, []
        try:
            straggler_why = self.fleet.record_round(
                round_name, cohort, participants, responses
            )
        except Exception:
            _log.exception("%s: fleet ledger record failed", self.name)
            straggler_why = {}
        responses = responses or {}
        participants = sorted(participants)
        reporters = sorted(responses)
        base = self._slo_base or {}
        self._slo_base = None
        counters = self.metrics.snapshot()["counters"]
        deltas = {
            k: v - base.get(k, 0.0)
            for k, v in counters.items()
            if v != base.get(k, 0.0)
        }
        phases = {
            s["name"]: round(s["end"] - s["start"], 6)
            for s in self.tracer.spans_for(trace_id)
            if s.get("service") == self.tracer.service
            and s.get("name") != "round"
        }
        # compute plane: fold the reporters' per-client compute records
        # (obs/compute.py) into one round section — every unmeasured
        # aggregate is null-with-reason, never a bare null — and export
        # the latest round's values as gauges for /metrics + the console
        compute_section = obs_compute.summarize_round(
            [r.get("compute") for r in responses.values()
             if isinstance(r, dict)]
        )
        for gauge, key in (
            ("compute_mfu", "mfu"),
            ("compute_samples_per_sec_per_chip", "samples_per_sec_per_chip"),
            ("compute_peak_hbm_gb", "peak_hbm_gb"),
            ("compute_steps", "steps"),
        ):
            val = compute_section.get(key)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                self.metrics.set_gauge(gauge, float(val))
        self.metrics.set_gauge(
            "compute_reporters", compute_section["reporters"]
        )
        self.metrics.set_gauge(
            "compute_recompile_storm",
            1.0 if compute_section.get("recompile_storms") else 0.0,
        )
        cs = compute_section.get("compile_s")
        if isinstance(cs, (int, float)) and not isinstance(cs, bool):
            # root-side compile histogram (worst reporter per round) with
            # this round's trace as the exemplar: a p99 compile spike on
            # /metrics links straight to the round that recompiled
            self.metrics.observe(
                "compute_compile_s", float(cs),
                exemplar=(trace_id, tracing.root_span_id(trace_id)),
            )
        record = {
            "round": round_name,
            "round_index": self.rounds.n_rounds,
            "trace_id": trace_id,
            "service": self.tracer.service,
            "outcome": outcome,
            "duration_s": round(end - t0, 6),
            "participants": len(participants),
            "reporters": len(reporters),
            "stragglers": [c for c in participants if c not in responses],
            "straggler_why": straggler_why,
            "bytes_uploaded": deltas.get("bytes_uploaded", 0.0),
            "bytes_broadcast": deltas.get("bytes_broadcast", 0.0),
            "counters_delta": deltas,
            "phase_s": phases,
            "compute": compute_section,
        }
        # explainability contract: every remediation the manager applied
        # during this round lands in the round's own record, naming the
        # rule AND the alert/classification that triggered it
        acts, self._pending_actuations = self._pending_actuations, []
        if acts:
            record["actuations"] = acts
        # mirrored for the alert evaluator's rounds.* tail (no file IO
        # on an evaluation tick) — kept even when rounds_log is off
        self._recent_rounds.append(record)
        if self.rounds_log is not None:
            self.rounds_log.append(record)
        if self._forensics_armed is not None:
            # forensics is advisory: a broken capture must never break
            # round completion (same contract as the fleet ledger)
            try:
                self._build_forensics_bundle(record)
            except Exception:
                self.metrics.inc("alerts_eval_errors")
                _log.exception(
                    "%s: forensics bundle capture failed", self.name
                )

    def _new_stream_acc(self):
        """The round's streaming accumulator: sequential (deterministic)
        by default, sharded partials under ``fold_shards>1``."""
        if self.fold_shards > 1:
            return agg.ShardedStreamingMean(self.fold_shards)
        return agg.StreamingMean()

    def _retry_after_s(self) -> float:
        return self._ingest.retry_after_s if self._ingest is not None else 1.0

    def _reject_429(self, msg: str) -> web.Response:
        self.metrics.inc("ingest_rejected_429")
        return web.json_response(
            {"err": msg}, status=429,
            headers={"Retry-After": f"{self._retry_after_s():g}"},
        )

    async def handle_update(self, request: web.Request) -> web.Response:
        refusal = self._standby_refusal()
        if refusal is not None:
            return refusal
        try:
            client_id = self.registry.verify(
                request.query.get("client_id", ""), request.query.get("key", "")
            )
        except (UnknownClient, AuthError):
            return web.json_response({"err": "Unauthorized"}, status=401)
        t_read0 = time.monotonic()
        try:
            body = await read_body_capped(request, self.max_upload_bytes)
        except BodyTooLarge:
            self.metrics.inc("uploads_rejected_413")
            return web.json_response({"err": "Payload Too Large"}, status=413)
        # server-side view of the upload wall time (body streaming in):
        # the bandwidth denominator the ledger records per client
        upload_s = time.monotonic() - t_read0
        self.metrics.inc("bytes_uploaded", len(body))
        ctx = tracing.parse_traceparent(request.headers.get("traceparent"))
        if ctx is None:
            return await self._ingest_update(
                client_id, body, request.content_type, upload_s=upload_s
            )
        # join the caller's trace: the worker's upload span is the parent
        with self.tracer.span(
            "ingest", trace_id=ctx[0], parent_id=ctx[1],
            client=client_id, bytes=len(body),
        ):
            return await self._ingest_update(
                client_id, body, request.content_type, upload_s=upload_s
            )

    def _make_upload_decoder(self, body: bytes, content_type):
        """Build the decode+validate closure the ingest pipeline runs on
        a pool thread. Pure CPU work over immutable inputs — no loop
        state is touched off-loop (the anchor hint is captured here, on
        the loop; validation only needs the model's shapes, which are
        round-independent)."""
        anchor_hint = self._broadcast_anchor_sd

        def decode():
            tensors, meta = wire.decode_any(
                body, content_type, allow_pickle=self.allow_pickle
            )
            # validate at the door: a missing/mis-shaped tensor must be
            # rejected now, not crash aggregation after the round state
            # is consumed (which would discard every client's work)
            # coerce meta fields HERE so a malformed n_samples/
            # loss_history 400s at the door instead of 500ing later
            meta_n_samples = float(meta.get("n_samples", 0))
            meta_losses = [float(x) for x in meta.get("loss_history", [])]
            update_id = (
                str(meta["update_id"]) if meta.get("update_id") else None
            )
            compressed = False
            if meta.get("edge_partial") is not None:
                # an edge aggregator's cohort partial: always a dense
                # template-shaped mean (the edge refuses masked uploads
                # and decompresses before folding). Shape-validate like
                # a plain update; the secure/streaming 409s live in
                # _ingest_edge_partial where they can be counted.
                if not isinstance(meta["edge_partial"], dict):
                    raise _BadUpload("Bad Edge Partial")
                if meta.get("compressed") or meta.get("secure"):
                    raise _BadUpload(
                        "Edge Partial Cannot Be Compressed Or Masked"
                    )
                state_dict_to_params(self.params, tensors, device="cpu")
            elif meta.get("compressed"):
                if self.secure_agg:
                    # a sparse support set leaks which coordinates moved;
                    # masking needs dense ring elements (ops/compression.py)
                    raise _BadUpload("Compressed Upload In Secure Round")
                scheme = (meta["compressed"] or {}).get("scheme") \
                    if isinstance(meta["compressed"], dict) else None
                if scheme != "topk":
                    # an unknown scheme decoded under top-k semantics
                    # would poison the aggregate; reject precisely
                    raise _BadUpload(f"Unknown Compression Scheme {scheme!r}")
                compressed = True
                anchor = (
                    anchor_hint
                    if anchor_hint is not None
                    else params_to_state_dict(self.params)
                )
                self._validate_compressed_upload(tensors, anchor)
            elif self.secure_agg:
                self._validate_masked_upload(tensors, meta)
            else:
                state_dict_to_params(self.params, tensors, device="cpu")
            return tensors, meta, meta_n_samples, meta_losses, update_id, \
                compressed

        return decode

    def _journal_payload(
        self, client_id: str, round_name: str, body: bytes, content_type
    ) -> None:
        """Journal an accepted update's wire bytes so a successor (same
        process restarted, or a promoted standby replaying shipped WAL)
        can re-ingest the update instead of asking the worker to
        re-train: the worker's one-slot outbox dropped the payload on
        our 200 ack, so the journal is the ONLY copy that survives us.
        Called at the acceptance point, after ``client_end`` journaled
        ``update_accepted`` — replay pairs the two."""
        if (
            self.journal is None
            or not self.journal_payloads
            or not body
        ):
            return
        if (
            self.journal_payload_max_bytes is not None
            and len(body) > self.journal_payload_max_bytes
        ):
            self.metrics.inc("journal_payloads_skipped_large")
            return
        self.journal.append(
            "update_payload",
            round_name=round_name,
            client_id=client_id,
            content_type=str(content_type or "application/octet-stream"),
            data=base64.b64encode(body).decode("ascii"),
        )
        self.metrics.inc("journal_payloads_journaled")

    async def _ingest_update(
        self,
        client_id: str,
        body: bytes,
        content_type,
        upload_s: Optional[float] = None,
    ) -> web.Response:
        """Accept one assembled upload body (single POST or completed
        chunk session): decode/validate off-loop, then run the round
        checks + acceptance bookkeeping loop-atomically, then fold.

        The v2 data plane's acceptance-point invariant holds: once the 200 is
        sent, the update counts — so all bookkeeping happens with no
        intervening await, and the off-loop fold this handler awaits
        before answering is guaranteed to land in the round mean
        (``end_round`` additionally drains the fold lanes)."""
        decode = self._make_upload_decoder(body, content_type)
        pipe = self._ingest
        try:
            if pipe is not None:
                fut = pipe.submit_decode(decode)
                if fut is None:
                    return self._reject_429("Ingest Queue Full")
                decoded = await fut
            else:
                decoded = decode()
        except _BadUpload as e:
            return web.json_response({"err": e.msg}, status=400)
        except (MemoryError, asyncio.CancelledError):
            # resource exhaustion / shutdown are NOT client errors: let
            # them propagate (500 / cancellation) instead of masking
            # them as "Bad Payload" and silently inviting a retry
            raise
        except Exception:
            return web.json_response({"err": "Bad Payload"}, status=400)
        tensors, meta, meta_n_samples, meta_losses, update_id, compressed = \
            decoded
        round_name = meta.get("update_name")
        if not self.rounds.in_progress or round_name != self.rounds.round_name:
            return web.json_response({"error": "Wrong Update"}, status=410)
        if self._secure_finalizing:
            # dropout recovery has started and this client's masks are
            # being cancelled as dropped — its late upload can no longer
            # be folded into the sum
            return web.json_response({"error": "Round Finalizing"}, status=410)
        if isinstance(meta.get("edge_partial"), dict):
            # a cohort partial from an edge aggregator — the edge itself
            # is not a round participant, so this must branch before the
            # cohort/participant 410s below
            return await self._ingest_edge_partial(
                client_id, tensors, meta, update_id
            )
        if (
            self._secure_round is not None
            and client_id not in self._secure_round["cohort"]
        ):
            # not in this round's cohort: its masks reference a pk
            # directory nobody else holds (e.g. a straggler from an
            # aborted attempt that reuses this round name) — folding it
            # in would add uncancellable mask noise
            return web.json_response({"error": "Not In Cohort"}, status=410)
        if client_id not in self.rounds.clients:
            # never client_start'ed this round: an unsampled registered
            # client (cohort_fraction < 1) or a straggler from an aborted
            # attempt reusing the round name. Deliberate deviation from
            # the reference (which records any authenticated upload,
            # manager.py:105-107): counting an outsider would skew the
            # mean AND trip clients_left to 0 early, ending the round
            # before sampled participants report.
            return web.json_response(
                {"error": "Not A Participant"}, status=410
            )
        if (
            update_id is not None
            and self.rounds.update_ids.get(client_id) == update_id
        ):
            # the worker's at-least-once outbox retried an upload whose
            # first delivery DID land (e.g. the 200 was lost in transit).
            # Ack idempotently without re-counting: folding it in twice
            # would double this client's sample weight in the aggregate.
            self.metrics.inc("duplicate_updates_deduped")
            return web.json_response("OK")
        if (
            client_id in self.rounds.client_responses
            or client_id in self._accepting
        ):
            # a DIFFERENT update from a client whose first update was
            # already accepted (or is mid-acceptance across the buffered
            # path's decompress await): the first accepted update per
            # client per round is FINAL — its 200 ack promised it
            # counts, and under streaming aggregation it is already
            # folded into the running sum and cannot be retracted.
            self.metrics.inc("repeat_updates_ignored")
            return web.json_response("OK")
        # the per-round anchor (set once in start_round; what clients
        # loaded). Read AFTER the 410s: stale uploads never reach it.
        anchor = (
            self._broadcast_anchor_sd
            if self._broadcast_anchor_sd is not None
            else params_to_state_dict(self.params)
        )
        response = {
            "masked": bool(meta.get("secure", False)),
            "n_samples": meta_n_samples,
            "loss_history": meta_losses,
            "update_id": update_id,
            "upload_bytes": len(body),
        }
        # worker self-reported timings piggybacked on the update meta
        # (train wall time, heartbeat RTT) + the server-measured upload
        # wall: the fleet ledger's per-client observation fields
        timings = _clean_timings(meta.get("timings")) or {}
        if upload_s is not None and upload_s > 0:
            timings["upload_s"] = round(upload_s, 6)
        if timings:
            response["timings"] = timings
        # per-round compute record (obs/compute.py): sanitized at the
        # door, folded into the round's SLO record + fleet ledger
        compute = _clean_compute(meta.get("compute"))
        if compute is not None:
            response["compute"] = compute
        elif meta.get("compute") is not None:
            self.metrics.inc("compute_records_invalid")
        acc = self._stream_acc
        if acc is not None and not response["masked"]:
            # streaming FedAvg: acceptance bookkeeping FIRST (no await
            # between the checks above and client_end — loop-atomic, so
            # a racing duplicate sees client_responses), then the
            # decompress+fold runs off-loop on this shard's fold lane.
            # Awaiting it before the 200 keeps the old contract: after
            # any ack, the update IS in the running sum. Restrict to the
            # anchor's keys so a surplus tensor in an upload cannot
            # enter the running sums.
            response["streamed"] = True
            self.rounds.client_end(client_id, response)
            self._journal_payload(client_id, round_name, body, content_type)
            self.registry.record_update(client_id, round_name)
            self.metrics.inc("updates_received")
            if compressed:
                self.metrics.inc("compressed_updates_received")
            shard = 0
            if self.fold_shards > 1:
                shard = self._fold_rr % self.fold_shards
                self._fold_rr += 1
            sharded = self.fold_shards > 1

            def fold():
                t = tensors
                if compressed:
                    t = self._decompress_upload(t, anchor)
                payload = {k: t[k] for k in anchor}
                # decompress ran lock-free above (pure); only the fold
                # into the shared accumulator needs _acc_lock — the
                # loop-side simulated cohort add()s into the same one
                with self._acc_lock:
                    if sharded:
                        acc.add(payload, meta_n_samples, shard=shard)
                    else:
                        acc.add(payload, meta_n_samples)

            if pipe is not None:
                await pipe.submit_fold(shard, fold)
            else:
                fold()
            del tensors
            self._maybe_finish()
            return web.json_response("OK")
        # buffered / masked path: tensors are retained until end_round
        if compressed:
            # reconstruct AFTER the round checks: the anchor is only
            # right for the current round; stale uploads were already
            # 410'd above. The decompress runs off-loop, so the client
            # is flagged mid-acceptance for duplicate suppression and
            # the round checks re-run after the await.
            self._accepting.add(client_id)
            try:
                if pipe is not None:
                    tensors = await pipe.run_unbounded(
                        lambda: self._decompress_upload(tensors, anchor)
                    )
                else:
                    tensors = self._decompress_upload(tensors, anchor)
            finally:
                self._accepting.discard(client_id)
            if (
                not self.rounds.in_progress
                or round_name != self.rounds.round_name
            ):
                return web.json_response({"error": "Wrong Update"}, status=410)
            if client_id not in self.rounds.clients:
                return web.json_response(
                    {"error": "Not A Participant"}, status=410
                )
            self.metrics.inc("compressed_updates_received")
        response["state_dict"] = tensors
        del tensors
        self.rounds.client_end(client_id, response)
        if not response["masked"]:
            # masked (secure-agg) bodies are useless to a successor —
            # the mask directory dies with this process (see the
            # recovery abort policy) — so only plaintext payloads ship
            self._journal_payload(client_id, round_name, body, content_type)
        self.registry.record_update(client_id, round_name)
        self.metrics.inc("updates_received")
        self._maybe_finish()
        return web.json_response("OK")

    async def _ingest_edge_partial(
        self, client_id: str, tensors: dict, meta: dict, update_id
    ) -> web.Response:
        """Merge one edge aggregator's cohort partial into the round.

        The partial's tensors are the weighted mean over the edge's
        cohort and ``edge_partial.contributors`` maps each worker to its
        ``{n_samples, update_id, loss_history}``. Folding the mean back
        with the summed weight reproduces the flat sequential fold
        exactly (``StreamingMean`` is associative: ``mean × Σw`` is the
        cohort's weighted sum), and crediting each contributor its own
        per-worker response keeps loss-history aggregation, round
        accounting, and worker dedup (a direct retry after a lost edge
        ack) identical to the flat topology.

        Refusals are 409s the edge/worker can act on: secure rounds need
        direct uploads (a partial-folded masked update would break
        unmasking — the masks only cancel in the full cohort sum), and
        non-streaming aggregators need individual updates."""
        round_name = meta.get("update_name")
        info = meta["edge_partial"]
        edge_name = str(info.get("edge") or client_id)
        if self.secure_agg or self._secure_round is not None:
            self.metrics.inc("updates_refused_edge_secure")
            return web.json_response(
                {"err": "Secure Round Requires Direct Uploads"}, status=409
            )
        acc = self._stream_acc
        if acc is None:
            # buffered/robust aggregators need the individual updates
            self.metrics.inc("updates_refused_edge_unsupported")
            return web.json_response(
                {"err": "Edge Partials Require Streaming Aggregation"},
                status=409,
            )
        if update_id is not None and (
            (client_id, update_id) in self._edge_partial_ids
        ):
            self.metrics.inc("duplicate_updates_deduped")
            return web.json_response("OK")
        contributors = info.get("contributors")
        if not isinstance(contributors, dict) or not contributors:
            return web.json_response({"err": "Bad Edge Partial"}, status=400)
        credited, total_w = [], 0.0
        try:
            parsed = [
                (
                    str(cid),
                    float(c.get("n_samples", 0)),
                    str(c["update_id"]) if c.get("update_id") else None,
                    [float(x) for x in (c.get("loss_history") or [])],
                    int(c.get("bytes") or 0),
                    _clean_timings(c.get("timings")),
                    _clean_compute(c.get("compute")),
                )
                for cid, c in sorted(contributors.items())
            ]
        except (AttributeError, TypeError, ValueError):
            return web.json_response({"err": "Bad Edge Partial"}, status=400)
        for cid, w, uid, losses, nbytes, timings, compute in parsed:
            if not (w > 0) or not math.isfinite(w):
                return web.json_response(
                    {"err": "Bad Edge Partial"}, status=400
                )
            # the weight ALWAYS counts toward the fold — it physically
            # backs the partial's mean — but credit is conditional
            total_w += w
            if cid not in self.rounds.clients:
                # unsampled (cohort_fraction < 1) or dropped mid-round
                self.metrics.inc("edge_contributors_unknown")
                continue
            if cid in self.rounds.client_responses or cid in self._accepting:
                # the worker also delivered direct (edge ack lost →
                # direct retry race): its contribution is inside the
                # partial's mean and cannot be subtracted, so the weight
                # folds but the credit stays with the direct delivery
                self.metrics.inc("edge_contributor_conflicts")
                continue
            credited.append((cid, w, uid, losses, nbytes, timings, compute))
        if total_w <= 0:
            return web.json_response({"err": "Bad Edge Partial"}, status=400)
        # edge-tier phase wall times ride the partial's meta: folded
        # into float counters so each round's counters_delta (and thus
        # rounds.jsonl) shows where edge time went this round
        phase_s = info.get("phase_s")
        if isinstance(phase_s, dict):
            for key, counter in (
                ("fold", "edge_phase_fold_s"),
                ("blob_fetch", "edge_phase_blob_fetch_s"),
                ("settle", "edge_phase_settle_s"),
                ("ship_prev", "edge_phase_ship_prev_s"),
            ):
                val = phase_s.get(key)
                if (
                    isinstance(val, (int, float))
                    and not isinstance(val, bool)
                    and math.isfinite(val)
                    and val >= 0
                ):
                    self.metrics.inc(counter, float(val))
        anchor = (
            self._broadcast_anchor_sd
            if self._broadcast_anchor_sd is not None
            else params_to_state_dict(self.params)
        )
        # acceptance bookkeeping loop-atomically BEFORE the awaited fold
        # (same contract as the direct streaming path): once the 200 is
        # sent every credited contributor counts, and a racing duplicate
        # — partial or direct — sees client_responses/_edge_partial_ids
        if update_id is not None:
            self._edge_partial_ids.add((client_id, update_id))
        for cid, w, uid, losses, nbytes, timings, compute in credited:
            resp = {
                "masked": False,
                "n_samples": w,
                "loss_history": losses,
                "update_id": uid,
                "streamed": True,
                "via_edge": edge_name,
            }
            if nbytes > 0:
                resp["upload_bytes"] = nbytes
            if timings:
                resp["timings"] = timings
            if compute is not None:
                resp["compute"] = compute
            self.rounds.client_end(cid, resp)
            self.registry.record_update(cid, round_name)
            self.metrics.inc("updates_received")
            self.metrics.inc("edge_contributors_credited")
        self.metrics.inc("updates_received_edge_partial")
        shard = 0
        if self.fold_shards > 1:
            shard = self._fold_rr % self.fold_shards
            self._fold_rr += 1
        sharded = self.fold_shards > 1
        fold_w = total_w

        def fold():
            payload = {k: tensors[k] for k in anchor}
            if sharded:
                acc.add(payload, fold_w, shard=shard)
            else:
                acc.add(payload, fold_w)

        pipe = self._ingest
        if pipe is not None:
            await pipe.submit_fold(shard, fold)
        else:
            fold()
        self._maybe_finish()
        return web.json_response("OK")

    # -- chunked resumable uplink --------------------------------------
    async def handle_update_chunk(self, request: web.Request) -> web.Response:
        """``PUT /{name}/update_chunk/{update_id}?offset=&total=``.

        Chunks append strictly at the committed offset; a mismatched
        ``offset`` answers ``409 {"offset": committed}`` and the worker
        resumes from there (the manager is authoritative). The final
        chunk's response IS the update's acceptance response — 200 means
        accepted exactly as a single POST would have been."""
        refusal = self._standby_refusal()
        if refusal is not None:
            return refusal
        try:
            client_id = self.registry.verify(
                request.query.get("client_id", ""), request.query.get("key", "")
            )
        except (UnknownClient, AuthError):
            return web.json_response({"err": "Unauthorized"}, status=401)
        update_id = request.match_info["update_id"]
        try:
            offset = int(request.query["offset"])
            total = int(request.query["total"])
        except (KeyError, ValueError):
            return web.json_response({"err": "Bad Chunk Framing"}, status=400)
        if total <= 0 or offset < 0 or offset > total:
            return web.json_response({"err": "Bad Chunk Framing"}, status=400)
        if self.max_upload_bytes is not None and total > self.max_upload_bytes:
            # declared-size admission: reject the whole upload on its
            # FIRST chunk, before buffering anything
            self.metrics.inc("uploads_rejected_413")
            return web.json_response({"err": "Payload Too Large"}, status=413)
        key = (client_id, update_id)
        sess = self._chunks.get(key)
        if sess is None:
            if offset != 0:
                # unknown session (evicted, or a probe raced a round
                # roll): the committed offset is 0 — start over
                return web.json_response(
                    {"err": "Unknown Chunk Session", "offset": 0}, status=409
                )
            if len(self._chunks) >= self.max_chunk_sessions:
                return self._reject_429("Too Many Chunk Sessions")
            sess = ChunkSession(
                client_id=client_id, update_id=update_id, total=total,
                spill_dir=self.chunk_spill_dir,
            )
            self._chunks[key] = sess
            self.metrics.set_gauge("chunk_sessions_active", len(self._chunks))
        if sess.total != total:
            # inconsistent framing poisons the session — drop it
            self._chunks.pop(key, None)
            sess.discard()
            self.metrics.set_gauge("chunk_sessions_active", len(self._chunks))
            return web.json_response({"err": "Inconsistent Total"}, status=400)
        if sess.busy:
            # a zombie retry racing its own live transfer must not
            # interleave bytes into the buffer
            return web.json_response(
                {"err": "Chunk In Flight", "offset": sess.offset}, status=409
            )
        if offset != sess.offset:
            return web.json_response(
                {"err": "Offset Mismatch", "offset": sess.offset}, status=409
            )
        sess.busy = True
        try:
            try:
                chunk = await read_body_capped(request, sess.total - offset)
            except BodyTooLarge:
                self.metrics.inc("uploads_rejected_413")
                return web.json_response(
                    {"err": "Chunk Overruns Total"}, status=413
                )
            if offset == 0 and len(chunk) >= 4 and not self.allow_pickle \
                    and not wire.is_btw1(chunk):
                # first-frame sniff: don't buffer max_upload_bytes of a
                # payload that is destined for "Bad Payload" anyway
                self._chunks.pop(key, None)
                sess.discard()
                self.metrics.set_gauge(
                    "chunk_sessions_active", len(self._chunks))
                return web.json_response({"err": "Bad Payload"}, status=400)
            sess.extend(chunk)
            self.metrics.inc("bytes_uploaded", len(chunk))
            self.metrics.inc("chunk_bytes_received", len(chunk))
            if sess.offset < sess.total:
                return web.json_response({"offset": sess.offset})
            ctx = tracing.parse_traceparent(
                request.headers.get("traceparent")
            )
            if ctx is None:
                resp = await self._ingest_update(
                    client_id, sess.payload(), wire.CONTENT_TYPE
                )
            else:
                # the FINAL chunk's traceparent parents the assembly
                # ingest — one span per assembled upload, not per chunk
                with self.tracer.span(
                    "ingest", trace_id=ctx[0], parent_id=ctx[1],
                    client=client_id, bytes=sess.total, chunked=True,
                ):
                    resp = await self._ingest_update(
                        client_id, sess.payload(), wire.CONTENT_TYPE
                    )
        finally:
            sess.busy = False
        if resp.status == 429:
            # ingest queue full at assembly: keep the session — the
            # retry re-sends only the (empty) final frame, not 100 MB
            return resp
        self._chunks.pop(key, None)
        sess.discard()
        self.metrics.set_gauge("chunk_sessions_active", len(self._chunks))
        if resp.status == 200:
            self.metrics.inc("chunked_uploads_assembled")
        return resp

    async def handle_update_chunk_probe(
        self, request: web.Request
    ) -> web.Response:
        """Committed-offset probe (GET; aiohttp serves HEAD from the
        same route). An unknown session reports offset 0 — "start
        over" and "never started" are the same instruction."""
        try:
            client_id = self.registry.verify(
                request.query.get("client_id", ""), request.query.get("key", "")
            )
        except (UnknownClient, AuthError):
            return web.json_response({"err": "Unauthorized"}, status=401)
        sess = self._chunks.get((client_id, request.match_info["update_id"]))
        offset = sess.offset if sess is not None else 0
        return web.json_response(
            {"offset": offset, "total": sess.total if sess else None},
            headers={"Upload-Offset": str(offset)},
        )

    def _validate_compressed_upload(self, tensors, anchor) -> None:
        """Structural check for a "<name>@idx"/"<name>@val" sparse-delta
        upload (ops/compression.py wire layout): every model tensor
        present, indices int / unique / in range, val/idx lengths equal,
        any "@scale" a single finite value. Everything that could crash
        or poison :meth:`_decompress_upload` is rejected HERE (400), not
        after the round state is consumed."""
        for k, ref in anchor.items():
            idx = np.asarray(tensors[f"{k}@idx"])
            val = np.asarray(tensors[f"{k}@val"])
            size = int(np.size(np.asarray(ref)))
            if idx.ndim != 1 or val.shape != idx.shape:
                raise ValueError(f"bad sparse layout for {k}")
            if not np.issubdtype(idx.dtype, np.integer):
                raise ValueError(f"non-integer indices for {k}")
            if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= size):
                raise ValueError(f"index out of range for {k}")
            if np.unique(idx).size != idx.size:
                # duplicate indices silently drop delta mass in the
                # scatter (dense[idx] = val keeps only the last write)
                raise ValueError(f"duplicate indices for {k}")
            if not np.all(np.isfinite(np.asarray(val, np.float64))):
                raise ValueError(f"non-finite values for {k}")
            if f"{k}@scale" in tensors:
                scale = np.asarray(tensors[f"{k}@scale"]).ravel()
                if scale.size != 1 or not np.isfinite(scale[0]):
                    raise ValueError(f"bad scale for {k}")
                # a finite-but-huge scale can overflow val*scale to inf
                # in float32 and poison the aggregate past this door
                if val.size and not np.all(np.isfinite(
                    np.asarray(val, np.float32) * np.float32(scale[0])
                )):
                    raise ValueError(f"scale overflow for {k}")

    def _decompress_upload(self, tensors, anchor) -> dict:
        """anchor + sparse delta -> dense state_dict (float32)."""
        out = {}
        for k, ref in anchor.items():
            idx = np.asarray(tensors[f"{k}@idx"])
            val = np.asarray(tensors[f"{k}@val"], np.float32)
            if f"{k}@scale" in tensors:
                val = val * float(np.asarray(tensors[f"{k}@scale"]).ravel()[0])
            ref = np.asarray(ref, np.float32)
            dense = np.zeros(ref.size, np.float32)
            dense[idx] = val
            out[k] = ref + dense.reshape(ref.shape)
        return out

    # ------------------------------------------------------------------
    def attach_simulator(self, sim, data, n_samples, wave_size=None) -> None:
        """Let a TPU-simulated cohort participate in every HTTP round as
        one aggregate client (weight = its total sample count)."""
        if self.secure_agg:
            raise ValueError(
                "a simulated cohort runs inside the aggregator process — "
                "masking it from the server it lives in is meaningless; "
                "use plain aggregation for simulation"
            )
        if sim.device != self.device:
            raise ValueError(
                f"the simulated cohort runs on {sim.device}, the manager's "
                f"params live on {self.device}"
            )
        self.simulator = sim
        self._sim_args = {
            "data": data,
            "n_samples": torch.as_tensor(np.asarray(n_samples)),
            "wave_size": wave_size,
        }

    async def start_round(self, n_epoch: int) -> Dict[str, bool]:
        round_name = self.rounds.start_round(n_epoch=n_epoch)
        self._slo_base = self.metrics.snapshot()["counters"]
        # actuations applied while THIS round runs; _finish_round_obs
        # moves them into the round's rounds.jsonl record
        self._pending_actuations = []
        self._apply_round_deadline()
        trace_id = tracing.make_trace_id(self.name, round_name)
        self._secure_round = None  # invalidate any stale secure state
        # chunk sessions are per-round: a body assembled for the dead
        # round would only 410 at ingest, so drop the buffers now
        self._chunks.clear()
        self.metrics.set_gauge("chunk_sessions_active", 0)
        self._fold_rr = 0
        self._edge_partial_ids.clear()
        # _broadcasting must cover the WHOLE round setup — the secure
        # key/share phases included, not just the notify fan-out:
        # participants are only recorded at broadcast time, so a cull
        # tick firing during a long pre-broadcast phase sees
        # len(rounds)==0 and aborts a healthy round. Observed: EVERY
        # C=256 secure round died exactly this way (the O(C^2) share
        # phase outlasts the ttl/2=150 s cull period; C=128's ~135 s
        # phase just squeaked under — another knife edge).
        self._broadcasting = True
        try:
            # all setup-phase spans hang off the round's deterministic
            # root span id; the root itself is emitted retroactively at
            # round end (_finish_round_obs)
            with self.tracer.span(
                "round_setup",
                trace_id=trace_id,
                parent_id=tracing.root_span_id(trace_id),
                round=round_name,
            ):
                result = await self._start_round_phases(round_name, n_epoch)
        finally:
            self._broadcasting = False
            # round setup (secure phases + notify fan-out) is the
            # manager's own time; the expiry clock times the
            # participants' reporting window, which opens here
            self.rounds.restart_clock()
        # every participant may have reported during the (deferred)
        # broadcast window — settle the round now that the guard is down
        self._maybe_finish()
        return result

    async def _start_round_phases(
        self, round_name: str, n_epoch: int
    ) -> Dict[str, bool]:
        started_wall = self.rounds.started_wall
        for cid in self.registry.cull():
            self.rounds.drop_client(cid)
        if not len(self.registry) and self.simulator is None:
            # Fix of SURVEY §2.9 item 3: abort releases the round.
            self.rounds.abort_round()
            self._finish_round_obs(
                round_name, "aborted:no_clients", started_wall=started_wall
            )
            return {}
        # streaming FedAvg: created BEFORE any notify so a fast worker's
        # upload (which can land mid-broadcast) has somewhere to fold.
        # Robust aggregators are order statistics over the whole cohort
        # and secure rounds only ever yield a masked SUM — both keep the
        # buffered path (self._stream_acc stays None).
        with self._acc_lock:
            self._stream_acc = (
                self._new_stream_acc()
                if self.streaming_aggregation
                and self.aggregator[0] == "mean"
                and not self.secure_agg
                else None
            )
        state_dict = params_to_state_dict(self.params)
        meta = {"update_name": round_name, "n_epoch": n_epoch}
        # pin_shapes actuation: ask the cohort to hold batch/sequence
        # shapes fixed for this round (workers that predate the key
        # ignore it — the envelope parser reads only known fields)
        try:
            _pin_act = self.runbooks.actuation("pin_shapes")
        except Exception:
            _pin_act = None
        if _pin_act is not None:
            meta["pin_shapes"] = True
            self._record_actuation(_pin_act, {"pin_shapes": True})
        encoding = None
        delta_tensors = None
        if self.broadcast_quantize_bits is not None:
            from baton_tpu_torch.ops.compression import (
                dequantize_state_dict,
                quantize_state_dict,
            )

            bits = self.broadcast_quantize_bits
            state_dict = {
                k: np.asarray(v)
                for k, v in quantize_state_dict(
                    state_dict, seed=self.rounds.n_rounds, bits=bits
                ).items()
            }
            meta["quantized"] = {"bits": bits}
            encoding = {"quantized": {"bits": bits}}
            # sparse uplink deltas are computed against what the clients
            # actually LOADED — the dequantized broadcast ROUND-TRIPPED
            # through the model's param dtypes (state_dict_to_params
            # casts each leaf; skipping that cast would leave the anchor
            # off by an ulp per coordinate for non-f32 params)
            self._broadcast_anchor_sd = params_to_state_dict(
                state_dict_to_params(
                    self.params, dequantize_state_dict(state_dict),
                    device=self.device,
                )
            )
        else:
            state_dict = {
                k: np.ascontiguousarray(np.asarray(v))
                for k, v in state_dict.items()
            }
            if self._delta_spec is not None and self._prev_blob_sd is not None:
                from baton_tpu_torch.ops.compression import (
                    apply_delta_state_dict,
                    delta_encode_state_dict,
                )

                # the round's broadcast is DEFINED as the reconstruction
                # anchor + delta (bit-identical numpy on both sides) so
                # anchored workers and full-blob workers load the exact
                # same tensors — the worker verifies by re-encoding its
                # reconstruction and hashing it against the blob digest
                delta_tensors = delta_encode_state_dict(
                    self._prev_blob_sd, state_dict, self._delta_spec,
                    seed=self.rounds.n_rounds,
                )
                state_dict = apply_delta_state_dict(
                    self._prev_blob_sd, delta_tensors
                )
            # materialize the round anchor ONCE here, not per upload:
            # self.params is invariant until end_round, and a per-upload
            # params_to_state_dict is a full-model device-to-host copy
            self._broadcast_anchor_sd = state_dict
        cohort_ids = self._sample_cohort()
        # remember the fan-out for the fleet ledger: a sampled client
        # that never acks/reports is a "missed" observation at round end
        self._round_cohort = list(cohort_ids)
        if self.secure_agg:
            # Bonawitz round 0 (AdvertiseKeys): per-round DH key
            # agreement. Clients that fail are excluded BEFORE the pk
            # directory circulates.
            with self.tracer.span("secure_keys", cohort=len(cohort_ids)):
                pk_results = await bounded_gather(
                    *[
                        self._collect_pk(cid, round_name)
                        for cid in cohort_ids
                    ],
                    limit=self.fanout_concurrency,
                )
            pks = {cid: p for cid, p in pk_results if p is not None}
            if not pks:
                # observable abort: a silent {} return made a whole
                # cohort's failure look like "workers never responded"
                # (C=256 postmortem, CHANGES_r5.md)
                self.metrics.inc("secure_rounds_aborted_keys")
                _log.warning(
                    "%s: secure round aborted — no member advertised "
                    "keys (cohort %d)", self.name, len(cohort_ids))
                self.rounds.abort_round()
                self._finish_round_obs(
                    round_name, "aborted:secure_keys",
                    started_wall=started_wall,
                )
                return {}
            cohort_a = sorted(pks)
            t = len(cohort_a) // 2 + 1  # honest majority threshold
            # Bonawitz round 1 (ShareKeys): every member Shamir-shares
            # its self-mask seed and mask key across the cohort; the
            # sealed boxes are relayed (opaque to this server) inside
            # the round_start broadcast. Members that fail here never
            # distributed shares, so nobody may mask toward them — the
            # masking cohort is exactly the successful sharers.
            with self.tracer.span("secure_shares", cohort=len(cohort_a)):
                share_results = await bounded_gather(
                    *[
                        self._collect_shares(cid, round_name, pks, t)
                        for cid in cohort_a
                    ],
                    limit=self.fanout_concurrency,
                )
            outboxes = {cid: m for cid, m in share_results if m is not None}
            cohort = sorted(outboxes)
            if len(cohort) < t:
                # fewer sharers than the reconstruction threshold: the
                # round could never be unmasked — abort before training
                self.metrics.inc("secure_rounds_aborted_shares")
                _log.warning(
                    "%s: secure round aborted — %d/%d members completed "
                    "ShareKeys, below threshold t=%d (phase budget %.0fs)",
                    self.name, len(cohort), len(cohort_a), t,
                    self._secure_phase_budget_s())
                self.rounds.abort_round()
                self._finish_round_obs(
                    round_name, "aborted:secure_shares",
                    started_wall=started_wall,
                )
                return {}
            self._secure_round = {
                "round_name": round_name,
                "cohort": cohort,
                "index": {cid: x + 1 for x, cid in enumerate(cohort_a)},
                "t": t,
                "c_pks": {cid: p[0] for cid, p in pks.items()},
                "scale_bits": self.secure_scale_bits,
                # validation template cached once per round: per-upload
                # params_to_state_dict would device-to-host copy the full
                # model C times per round just to read names/shapes
                "template_shapes": {
                    k: tuple(v.shape)
                    for k, v in params_to_state_dict(self.params).items()
                },
            }
            meta["secure"] = {
                "cohort": cohort,
                "scale_bits": self.secure_scale_bits,
                # inbox is per-recipient — filled in the broadcast loop
            }
            self._secure_outboxes = outboxes
        # Participation is recorded inside _notify_client the moment a
        # client acks — NOT after the gather. A fast worker can train and
        # upload before slower notifies finish; recording late would let
        # its update hit a round that doesn't know it (the reference has
        # this exact race, manager.py:87-89). _broadcasting additionally
        # keeps _maybe_finish from ending/aborting the round while acks
        # are still arriving.
        if self.allow_pickle:
            # Reference-protocol PUSH broadcast (manager.py:77-86): stock
            # reference workers can only decode pickled state_dicts, so
            # an allow_pickle experiment speaks pickle in BOTH directions
            # — uploads were already accepted via wire.decode_any.
            body = wire.encode_pickle(state_dict, meta)
            coros = [
                self._notify_client(cid, body, wire.PICKLE_CONTENT_TYPE)
                for cid in cohort_ids
            ]
        else:
            # v2 PULL broadcast: serialize the round params ONCE into a
            # content-addressed blob; notify bodies are tiny envelopes.
            envelope = self._publish_round_blobs(
                round_name, n_epoch, state_dict, delta_tensors, encoding
            )
            if meta.get("pin_shapes"):
                envelope["pin_shapes"] = True
            if self._secure_round is not None:
                # per-recipient envelopes: each cohort member's carries
                # ITS inbox of sealed share boxes from the others
                recipients = self._secure_round["cohort"]
                outboxes = self._secure_outboxes
                coros = []
                for cid in recipients:
                    inbox = {
                        sender: outboxes[sender].get(cid)
                        for sender in recipients
                        if sender != cid and outboxes[sender].get(cid)
                    }
                    env = dict(envelope)
                    env["secure"] = dict(meta["secure"], inbox=inbox)
                    coros.append(self._notify_client(
                        cid, json.dumps(env).encode(), "application/json"
                    ))
            else:
                # ONE shared body for the whole cohort — no per-recipient
                # dict: a 1024-cohort round holds one reference
                shared = json.dumps(envelope).encode()
                coros = [
                    self._notify_client(cid, shared, "application/json")
                    for cid in cohort_ids
                ]
        with self.tracer.span("broadcast", cohort=len(coros)):
            results = await bounded_gather(
                *coros, limit=self.fanout_concurrency
            )

        if self.simulator is not None:
            self.rounds.client_start("__simulated__")
            self._sim_task = asyncio.get_running_loop().create_task(
                self._run_simulated(round_name, n_epoch)
            )
            # the cohort is a participant like any other: report its ack
            # in the start_round response (reference manager.py:87-89
            # records acknowledging clients)
            results = list(results) + [("__simulated__", True)]

        if self.rounds.in_progress and not len(self.rounds):
            self.rounds.abort_round()
            self._secure_round = None
            self._finish_round_obs(
                round_name, "aborted:broadcast_unacknowledged",
                started_wall=started_wall,
            )
        return dict(results)

    def _publish_round_blobs(
        self, round_name, n_epoch, state_dict, delta_tensors, encoding
    ) -> dict:
        """Encode the round's tensors ONCE into the blob store and build
        the v2 notify envelope. Retention keeps exactly this round's
        full blob, the previous full blob (a straggler may still be
        mid-download when the round rolls), and the last
        ``delta_chain_depth`` rounds of delta blobs (the chain)."""
        full_blob = wire.encode(state_dict, {})
        full_digest = self._blobs.put(full_blob, kind="full")
        envelope: Dict[str, Any] = {
            "v": 2,
            "update_name": round_name,
            "n_epoch": n_epoch,
            "blob": {"digest": full_digest, "size": len(full_blob)},
        }
        if encoding is not None:
            envelope["encoding"] = encoding
        keep = [full_digest, self._prev_blob_digest]
        hops = self._delta_hops
        if delta_tensors is not None and full_digest != self._prev_blob_digest:
            delta_blob = wire.encode(delta_tensors, {})
            delta_digest = self._blobs.put(delta_blob, kind="delta")
            hop = {
                "digest": delta_digest,
                "size": len(delta_blob),
                "from": self._prev_blob_digest,
                "to": full_digest,
            }
            envelope["delta"] = {
                k: hop[k] for k in ("digest", "size", "from")
            }
            # depth-N delta chain: the retained consecutive hops still
            # link into this round's anchor, so a worker anchored k
            # rounds back (k < delta_chain_depth) chains anchor → ... →
            # N through k small delta pulls instead of a full one. Each
            # hop's reconstruction is digest-verified against its "to"
            # — every hop is bit-defined the same way the depth-1
            # delta is. A discontinuity (recovery, an encoding round)
            # restarts the chain at this hop.
            if not (hops and hops[-1]["to"] == hop["from"]):
                hops = []
            hops = (hops + [hop])[-self.delta_chain_depth:]
            if len(hops) >= 2:
                envelope["delta_chain"] = [dict(h) for h in hops]
        elif not (
            delta_tensors is None
            and full_digest == self._prev_blob_digest
            and hops
            and hops[-1]["to"] == full_digest
        ):
            hops = []
        else:
            # params didn't move this round: the retained hops still
            # end at this round's blob, so workers anchored up to
            # delta_chain_depth rounds back keep their delta paths —
            # offer the last hop directly and the chain unchanged
            envelope["delta"] = {
                k: hops[-1][k] for k in ("digest", "size", "from")
            }
            if len(hops) >= 2:
                envelope["delta_chain"] = [dict(h) for h in hops]
        keep.extend(h["digest"] for h in hops)
        self._blobs.retain(keep)
        if encoding is None:
            # dense broadcasts anchor the next round's delta; quantized
            # ones don't (their tensors are @q layouts the delta path
            # doesn't speak, and the stochastic seed changes per round)
            self._prev_blob_sd = state_dict
            self._prev_blob_digest = full_digest
            self._delta_hops = hops
        else:
            self._prev_blob_sd = None
            self._prev_blob_digest = None
            self._delta_hops = []
        return envelope

    def _sample_cohort(self) -> list:
        """The round's notification cohort: all registered clients at
        ``cohort_fraction=1`` (reference behavior), else a uniform sample
        of ``max(min_cohort, fraction * N)`` without replacement.

        With runbook rules loaded, cohort selection is routed through
        :meth:`_sample_cohort_runbooks`, which applies any active
        ``pin_shapes`` quarantine / ``overprovision`` / ``bias_cohort``
        actuations; a failure there falls back to this uniform path so a
        runbook bug can never stop rounds from forming."""
        if self.runbooks.rules:
            try:
                return self._sample_cohort_runbooks(
                    list(self.registry.clients)
                )
            except Exception:
                self.metrics.inc("runbooks_eval_errors")
                _log.exception(
                    "%s: runbook cohort selection failed — falling back "
                    "to uniform sampling", self.name,
                )
        ids = list(self.registry.clients)
        if self.cohort_fraction >= 1.0 or len(ids) <= self.min_cohort:
            return ids
        k = min(len(ids), max(self.min_cohort,
                              int(round(self.cohort_fraction * len(ids)))))
        return sorted(self._cohort_rng.sample(ids, k))

    def _sample_cohort_runbooks(self, ids: list) -> list:
        """Cohort selection under active runbook actuations.

        Order matters and is part of the explainability contract:
        ``pin_shapes`` first narrows eligibility (quarantine clients
        whose recent windows carried recompile storms), then
        ``overprovision`` inflates the invite count against expected
        misses, then ``bias_cohort`` reweights the draw AWAY from
        slow/flaky clients without ever hard-excluding them — every
        client keeps a nonzero weight, so the fairness floor holds."""
        classified = self.fleet.classify_all()
        eligible = list(ids)

        act = self.runbooks.actuation("pin_shapes")
        if act is not None and act["params"].get("quarantine"):
            offenders = {
                cid for cid in eligible
                if classified.get(cid, {}).get("storms")
            }
            kept = [cid for cid in eligible if cid not in offenders]
            # never quarantine the round away: only narrow eligibility
            # while a viable cohort remains
            if offenders and len(kept) >= self.min_cohort:
                eligible = kept
                self._record_actuation(act, {
                    "quarantined": sorted(offenders),
                    "eligible": len(eligible),
                })

        if self.cohort_fraction >= 1.0 or len(eligible) <= self.min_cohort:
            return sorted(eligible) if eligible is not ids else eligible
        base_k = min(
            len(eligible),
            max(self.min_cohort,
                int(round(self.cohort_fraction * len(eligible)))),
        )
        k = base_k

        act = self.runbooks.actuation("overprovision")
        if act is not None and base_k < len(eligible):
            p = act["params"]
            k, eps = obs_runbooks.overprovision_count(
                base_k, len(eligible), float(act.get("value") or 0.0),
                epsilon_max=p["epsilon_max"], gain=p["gain"],
            )
            if k > base_k:
                self._record_actuation(act, {
                    "base_k": base_k,
                    "k": k,
                    "epsilon": round(eps, 6),
                    "miss_rate": act.get("value"),
                })

        if k >= len(eligible):
            return sorted(eligible)

        act = self.runbooks.actuation("bias_cohort")
        if act is not None:
            p = act["params"]
            downweight = set(p["statuses"])
            weights = {
                cid: p["weight"]
                for cid in eligible
                if classified.get(cid, {}).get("status") in downweight
            }
            if weights:
                picked = obs_runbooks.weighted_sample(
                    eligible, weights, k, self._cohort_rng
                )
                self._record_actuation(act, {
                    "weight": p["weight"],
                    "downweighted": len(weights),
                    "k": k,
                })
                return sorted(picked)

        return sorted(self._cohort_rng.sample(eligible, k))

    def _secure_phase_budget_s(self) -> float:
        """Per-request timeout for the secure-protocol phases. The
        ShareKeys phase is O(C) 2048-bit modexps PER MEMBER (O(C^2)
        total) — a fixed budget that is generous at 64 members starves
        the whole cohort at 256 (observed: aiohttp's default 300 s
        total timeout vs ~540 s of aggregate box building in the
        one-process benchmark topology), so the default scales with
        registry size. ``secure_phase_timeout`` overrides."""
        if self.secure_phase_timeout is not None:
            return self.secure_phase_timeout
        return max(300.0, 3.0 * max(1, len(self.registry)))

    async def _secure_post(self, client_id: str, endpoint: str, payload: dict):
        """POST a secure-protocol message to one worker; None on any
        failure (the protocol tolerates per-member failures by cohort
        exclusion or share-threshold slack)."""
        try:
            client = self.registry[client_id]
        except UnknownClient:
            return None  # culled between snapshot and task run
        url = (
            f"{client.url.rstrip('/')}/{endpoint}"
            f"?client_id={client_id}&key={client.key}"
        )
        try:
            async with self._session.post(
                url, json=payload, headers=trace_headers(),
                timeout=aiohttp.ClientTimeout(
                    total=self._secure_phase_budget_s()),
            ) as resp:
                if resp.status == 200:
                    return await resp.json()
                if resp.status == 404:
                    self.registry.drop(client_id)
                # 409/410 etc.: alive but unavailable for this round
        except asyncio.TimeoutError:
            # alive but too slow for this phase: cohort exclusion, NOT
            # eviction — and never let the bare TimeoutError (which is
            # not an aiohttp.ClientError) escape into the phase gather,
            # where it would 500 the whole start_round
            return None
        except (aiohttp.ClientError, ValueError, KeyError):
            self.registry.drop(client_id)
        return None

    async def _collect_pk(self, client_id: str, round_name: str):
        """AdvertiseKeys with one client → (cid, (c_pk, s_pk) | None).

        Degenerate public keys (0/1/p−1 — a Byzantine member's subgroup
        confinement) are rejected HERE so they never enter the directory:
        forwarded, they would make every honest worker's share-sealing
        loop fail and kill the whole cohort every round."""
        from baton_tpu_torch.server import secure

        data = await self._secure_post(
            client_id, "secure_keys", {"round": round_name}
        )
        try:
            c_pk, s_pk = int(data["c_pk"], 16), int(data["s_pk"], 16)
            if not (1 < c_pk < secure.MODP_P - 1):
                return client_id, None
            if not (1 < s_pk < secure.MODP_P - 1):
                return client_id, None
            return client_id, (c_pk, s_pk)
        except (TypeError, KeyError, ValueError):
            return client_id, None

    async def _collect_shares(
        self, client_id: str, round_name: str, pks: dict, t: int
    ):
        """ShareKeys with one client → (cid, {recipient: sealed_hex})."""
        data = await self._secure_post(
            client_id,
            "secure_shares",
            {
                "round": round_name,
                "pks": {
                    cid: {"c": f"{c:x}", "s": f"{s:x}"}
                    for cid, (c, s) in pks.items()
                },
                "t": t,
            },
        )
        try:
            return client_id, {
                str(k): str(v) for k, v in data["shares"].items()
            }
        except (TypeError, KeyError, AttributeError):
            return client_id, None

    async def _request_unmask(
        self, client_id: str, round_name: str, survivors, dropped,
        c_pk: int,
    ):
        """Unmasking with one reporter → its share bundle or None.

        ``c_pk`` (the reporter's own advertised mask public key) binds
        the request to ONE key-generation instance: aborted rounds
        reuse their name, so a stale finalizer's delayed unmask could
        otherwise pin its partition onto a same-name replacement
        round's state — the worker refuses on key mismatch."""
        return await self._secure_post(
            client_id,
            "secure_unmask",
            {"round": round_name, "survivors": survivors,
             "dropped": dropped, "c_pk": f"{c_pk:x}"},
        )

    async def _notify_client(
        self, client_id: str, body: bytes, content_type: str = wire.CONTENT_TYPE
    ):
        try:
            client = self.registry[client_id]
        except UnknownClient:
            # culled during the (possibly minutes-long) secure phases
            # between cohort sampling and this notify — skip, don't let
            # the exception escape the broadcast gather and 500 the
            # whole cohort's start_round
            return client_id, False
        url = f"{client.url.rstrip('/')}/round_start?client_id={client_id}&key={client.key}"
        # secure broadcasts scale like the share phases (each recipient
        # decrypts O(C) relayed boxes before acking): give them the same
        # cohort-scaled budget instead of aiohttp's default 300 s
        post_kw = ({"timeout": aiohttp.ClientTimeout(
            total=self._secure_phase_budget_s())} if self.secure_agg else {})
        with self.tracer.span("notify", client=client_id), \
                self.metrics.timer("notify_s"):
            return await self._notify_client_traced(
                client_id, url, body, content_type, post_kw
            )

    async def _notify_client_traced(
        self, client_id: str, url: str, body: bytes, content_type: str,
        post_kw: dict,
    ):
        try:
            async with self._session.post(
                url, data=body,
                headers=trace_headers({"Content-Type": content_type}),
                **post_kw,
            ) as resp:
                self.metrics.inc("bytes_broadcast", len(body))
                if resp.status == 200:
                    # record participation NOW, before yielding back to
                    # the loop — this client may upload its update at any
                    # moment after this ack (see start_round)
                    if self.rounds.in_progress:
                        self.rounds.client_start(client_id)
                        return client_id, True
                    return client_id, False
                # observable rejection: a cohort-wide refusal (e.g. every
                # worker 400ing the broadcast) must be distinguishable
                # from "workers never answered" — the C=256 postmortem
                # burned an hour on exactly that ambiguity
                self.metrics.inc(f"broadcast_rejected_{resp.status}")
                # dedup key includes started_at: aborted rounds REUSE
                # their name, so a name-only key would suppress the
                # retry round's first rejection — the exact diagnostic
                # this log exists to surface
                round_key = (self.rounds.round_name, self.rounds.started_at)
                if self._rejection_logged_round != round_key:
                    self._rejection_logged_round = round_key
                    try:
                        body_txt = (await resp.text())[:200]
                    except Exception:
                        body_txt = "<unreadable>"
                    _log.warning(
                        "%s: broadcast rejected by %s: HTTP %d %s "
                        "(first rejection this round; counters track "
                        "the rest)", self.name, client_id, resp.status,
                        body_txt)
                if resp.status == 404:
                    self.registry.drop(client_id)
                    self.rounds.drop_client(client_id)
                return client_id, False
        except asyncio.TimeoutError:
            # alive but slow (e.g. still decrypting its share inbox):
            # skip it this round WITHOUT eviction, and count it — a
            # cohort-wide broadcast timeout must be visible (the C=256
            # silent-abort postmortem)
            self.metrics.inc("broadcast_timeout")
            self.rounds.drop_client(client_id)
            return client_id, False
        except aiohttp.ClientError:
            self.registry.drop(client_id)
            self.rounds.drop_client(client_id)
            return client_id, False

    async def _run_simulated(self, round_name: str, n_epoch: int) -> None:
        """Run the attached FedSim cohort off the event loop and report it
        like any other client."""
        args = self._sim_args

        def on_wave(done: int, total: int) -> None:
            # per-wave heartbeat (engine progress_fn): GET /{name}/metrics
            # shows the cohort's position mid-round, mirroring the
            # worker-side per-epoch hook (http_worker.py)
            self.metrics.set_gauge("sim_wave", done)
            self.metrics.set_gauge("sim_waves_total", total)

        # under a quantized broadcast every participant must start from
        # the identical dequantized weights — including the in-process
        # simulated cohort, which never crosses the wire
        start_params = (
            state_dict_to_params(
                self.params, self._broadcast_anchor_sd, device=self.device
            )
            if self._broadcast_anchor_sd is not None
            else self.params
        )

        def run():
            # reset BOTH gauges: a stale total from the previous round
            # would render "0 of <old total>" until the first wave lands
            self.metrics.set_gauge("sim_wave", 0)
            self.metrics.set_gauge("sim_waves_total", 0)
            return self.simulator.run_round(
                start_params,
                args["data"],
                args["n_samples"],
                torch.Generator().manual_seed(self.rounds.n_rounds),
                n_epochs=n_epoch,
                wave_size=args["wave_size"],
                collect_client_losses=False,
                progress_fn=on_wave,
            )

        try:
            result = await asyncio.to_thread(run)
        except Exception as exc:  # CUDA/shape/OOM errors must not hang the round
            _log.exception(
                "simulated cohort failed in %s: %s", round_name, exc
            )
            if self.rounds.in_progress and self.rounds.round_name == round_name:
                self.rounds.drop_client("__simulated__")
                self._maybe_finish()
            return
        if not self.rounds.in_progress or self.rounds.round_name != round_name:
            return  # round was force-ended meanwhile
        response = {
            "n_samples": float(result.n_samples_total),
            "loss_history": [float(x) for x in result.loss_history.tolist()],
        }
        # the engine leaves its per-round compute record (MFU/compile/
        # HBM) in last_compute; fold it through the same sanitizer the
        # wire path uses so the SLO record sees one schema
        sim_compute = _clean_compute(
            getattr(self.simulator, "last_compute", None)
        )
        if sim_compute is not None:
            response["compute"] = sim_compute
        result_sd = params_to_state_dict(result.params)
        if self._stream_acc is not None:
            # the simulated cohort streams like any other participant;
            # _acc_lock because real uploads fold into the same
            # accumulator from the ingest lanes
            with self._acc_lock:
                self._stream_acc.add(
                    {k: np.asarray(v) for k, v in result_sd.items()},
                    response["n_samples"],
                )
            response["streamed"] = True
        else:
            response["state_dict"] = result_sd
        self.rounds.client_end("__simulated__", response)
        self._maybe_finish()

    def _validate_masked_upload(self, tensors, meta) -> None:
        """A secure-round upload must be EXACTLY the masked uint64 image
        of the full state dict — a missing, extra, mis-typed, or
        mis-shaped tensor would poison the modular sum (or crash
        finalization after the round state is consumed)."""
        if not meta.get("secure"):
            raise ValueError("plain upload in a secure-aggregation round")
        sr = self._secure_round
        if sr is None:
            raise ValueError("no secure round in flight")
        shapes = sr["template_shapes"]
        extra = set(tensors) - set(shapes)
        if extra:
            raise ValueError(f"masked upload has surplus tensors {sorted(extra)}")
        for name, ref_shape in shapes.items():
            arr = tensors.get(name)
            if arr is None:
                raise KeyError(f"masked upload missing tensor {name!r}")
            if np.asarray(arr).dtype != np.uint64:
                raise ValueError(f"masked tensor {name!r} must be uint64")
            if tuple(np.shape(arr)) != ref_shape:
                raise ValueError(f"masked tensor {name!r} has wrong shape")

    def _maybe_finish(self) -> None:
        if self._broadcasting:
            return  # start_round settles the round after the last ack
        if not self.rounds.in_progress:
            return
        if len(self.rounds) == 0:
            # every participant was culled/evicted mid-round: release the
            # round instead of leaving it locked forever (423 on all
            # future start_round calls — the §2.9 item 3 failure class)
            round_name = self.rounds.round_name
            started_wall = self.rounds.started_wall
            self.rounds.abort_round()
            self._secure_round = None
            self._finish_round_obs(
                round_name, "aborted:all_participants_lost",
                started_wall=started_wall,
            )
        elif self.rounds.clients_left == 0:
            self.end_round()
        elif self._fedbuff_buffer_full():
            # fedbuff_fallback actuation: under churn, a buffer's worth
            # of reports is the round — don't wait out the stragglers
            self.end_round()

    def end_round(self) -> None:
        """Aggregate reported weights into the global params — the
        reference FedAvg step (manager.py:113-132) as one merge.

        Secure rounds are finalized asynchronously (dropout recovery
        needs HTTP round-trips): this schedules :meth:`_end_round_secure`
        on the running loop, or runs it to completion when called from
        synchronous (test) code."""
        if not self.rounds.in_progress:
            return
        if self._secure_round is not None:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                asyncio.run(self._end_round_secure())
            else:
                self._secure_task = loop.create_task(self._end_round_secure())
            return
        n_epoch = (self.rounds.round_meta or {}).get("n_epoch", 0)
        round_name = self.rounds.round_name
        started_wall = self.rounds.started_wall
        participants = set(self.rounds.clients)
        trace_id = tracing.make_trace_id(self.name, round_name)
        self.metrics.observe(
            "round_s", self.rounds.elapsed,
            exemplar=(trace_id, tracing.root_span_id(trace_id)),
        )
        with self._acc_lock:
            acc, self._stream_acc = self._stream_acc, None
        if self._ingest is not None:
            # an accepted update's 200 promised its fold would land in
            # the mean; a forced finish (watchdog expiry, explicit
            # end_round) must wait for folds already on the lanes
            self._ingest.drain_folds()
        responses = self.rounds.end_round()
        self.metrics.inc("rounds_finished")
        try:
            reports = [
                r for r in responses.values() if r.get("n_samples", 0) > 0
            ]
            if not reports:
                return
            with self.tracer.span(
                "aggregate",
                trace_id=trace_id,
                parent_id=tracing.root_span_id(trace_id),
                reports=len(reports),
            ):
                if acc is not None:
                    # streaming FedAvg: the per-update tensors were
                    # folded (and freed) in handle_update — the merge
                    # is one division
                    merged = acc.mean()
                    if merged is None:
                        return
                    self.params = state_dict_to_params(
                        self.params, merged, device=self.device
                    )
                else:
                    weights = torch.tensor(
                        [r["n_samples"] for r in reports],
                        dtype=torch.float32, device=self.device,
                    )
                    stacked = {
                        k: torch.from_numpy(np.stack(
                            [np.asarray(r["state_dict"][k], np.float32)
                             for r in reports]
                        )).to(self.device)
                        for k in self.params
                    }
                    merged = agg.apply_aggregator(
                        self.aggregator, stacked, weights
                    )
                    self.params = agg.tree_cast_like(merged, self.params)
            self._record_history_and_checkpoint(reports, n_epoch)
        finally:
            self._finish_round_obs(
                round_name, "completed", participants, responses,
                started_wall=started_wall,
            )

    async def _end_round_secure(self) -> None:
        """Secure-round finalization — Bonawitz round 3 (Unmasking).

        The manager can only use the cohort's modular sum. Every
        reporter is asked ONCE for its share bundle under the round's
        survivor/dropped partition; from ≥t shares each, the server
        reconstructs (a) dropped members' mask keys — cancelling their
        uncancelled pairwise masks — and (b) each reporter's self-mask
        seed — removing PRG(b_i). Up to n−t reporters may fail to answer
        and the round still unmasks; below the threshold it aborts and
        the previous global params stand.
        """
        from baton_tpu_torch.server import secure

        sr = self._secure_round
        if (
            sr is None
            or not self.rounds.in_progress
            or self.rounds.round_name != sr["round_name"]
        ):
            return
        if self._secure_finalizing:
            # a finalization is already past this guard and mid-unmask;
            # a second one (watchdog tick / explicit end_round during the
            # await window) must not consume the round out from under it
            return
        self._secure_finalizing = True
        round_name = sr["round_name"]
        started_wall = self.rounds.started_wall
        trace_id = tracing.make_trace_id(self.name, round_name)
        try:
            # a masked upload is a reporter regardless of n_samples: its
            # masks are IN the modular sum, so it must not also be
            # treated as dropped (the correction would double-count);
            # zero-weight reporters contribute exactly 0 to the mean
            reporters = {
                cid: r
                for cid, r in self.rounds.client_responses.items()
                if r.get("masked")
            }
            dropped = sorted(c for c in sr["cohort"] if c not in reporters)
            survivors = sorted(reporters)
            if not reporters or len(survivors) < sr["t"]:
                # below the Shamir threshold nothing can be unmasked
                self.metrics.inc("secure_rounds_unrecoverable")
                self.rounds.abort_round()
                self._secure_round = None
                self._finish_round_obs(
                    round_name, "aborted:secure_below_threshold",
                    sr["cohort"], reporters, started_wall=started_wall,
                )
                return
            template = params_to_state_dict(self.params)
            with self.tracer.span(
                "secure_unmask",
                trace_id=trace_id,
                parent_id=tracing.root_span_id(trace_id),
                survivors=len(survivors),
                dropped=len(dropped),
            ):
                bundles = await bounded_gather(
                    *[
                        self._request_unmask(
                            rid, sr["round_name"], survivors, dropped,
                            sr["c_pks"][rid],
                        )
                        for rid in survivors
                    ],
                    limit=self.fanout_concurrency,
                )
            # collect shares by secret owner; x-indices were fixed at
            # share time, so partial responses compose correctly
            b_shares: Dict[str, Dict[int, int]] = {s: {} for s in survivors}
            csk_shares: Dict[str, Dict[int, int]] = {d: {} for d in dropped}
            for rid, bundle in zip(survivors, bundles):
                if bundle is None:
                    continue
                try:
                    x = int(bundle["x"])
                    if x != sr["index"].get(rid):
                        continue  # mislabeled shares would corrupt Lagrange
                    for cid, h in dict(bundle.get("b_shares", {})).items():
                        if cid in b_shares:
                            b_shares[cid][x] = secure.share_from_hex(str(h))
                    for cid, h in dict(bundle.get("csk_shares", {})).items():
                        if cid in csk_shares:
                            csk_shares[cid][x] = secure.share_from_hex(str(h))
                except (KeyError, ValueError, TypeError):
                    continue
            if self._secure_round is not sr or not self.rounds.in_progress:
                # round replaced/aborted during the unmask HTTP
                # round-trips — same ownership rule as after the
                # reconstruction thread below (identity, not name:
                # aborted rounds reuse their name)
                return
            t = sr["t"]
            short = [
                cid
                for cid, shs in list(b_shares.items()) + list(csk_shares.items())
                if len(shs) < t
            ]
            if short:
                # too many unmask responders failed: below threshold for
                # at least one secret — the sum cannot be opened
                self.metrics.inc("secure_rounds_unrecoverable")
                self.rounds.abort_round()
                self._secure_round = None
                self._finish_round_obs(
                    round_name, "aborted:secure_shares_short",
                    sr["cohort"], reporters, started_wall=started_wall,
                )
                return
            # Reconstruction + mask regeneration + the modular sum are
            # the round's heaviest host compute — O(dropped×survivors)
            # 2048-bit modexps plus O(C) Philox masks over the full
            # template (measured: ~20 s at 128 members with 32 dropped).
            # Run it all in a worker thread: on the loop it starved
            # heartbeats/uploads for every co-located client (the r4
            # secure_round_scale run recorded 26 starvation dropouts).
            # Aggregate the SNAPSHOTTED reporter set, not whatever lands
            # in the round state meanwhile: a straggler in `dropped`
            # that uploaded during an await window would otherwise be
            # counted in the sum while its masks are also 'corrected' —
            # leaving uncancelled mask noise in the params.
            # (handle_update additionally 410s those stragglers; this
            # is the backstop.)
            reports = list(reporters.values())

            def _reconstruct_and_open():
                corrections = []
                for d in dropped:
                    c_sk = secure.shamir_reconstruct(
                        dict(list(csk_shares[d].items())[:t])
                    )
                    seeds = {
                        rid: secure.dh_shared_seed(
                            c_sk, sr["c_pks"][rid], sr["round_name"]
                        )
                        for rid in survivors
                    }
                    corrections.append(
                        secure.dropout_correction(d, seeds, template)
                    )
                    # the reconstructed key exists only to cancel this
                    # round's residues — purge its cached DH powers so
                    # the dropped client's pairwise secrets don't
                    # outlive the finalization (secure.py
                    # forward-secrecy contract)
                    secure.purge_dh_secrets(c_sk)
                self_seeds = []
                for s_cid in survivors:
                    b_int = secure.shamir_reconstruct(
                        dict(list(b_shares[s_cid].items())[:t])
                    )
                    if b_int >> 256:
                        # a corrupt share makes the interpolation land
                        # almost surely outside the 256-bit seed range —
                        # the sum cannot be opened correctly
                        return None
                    self_seeds.append(b_int.to_bytes(32, "big"))
                corrections.append(
                    secure.self_mask_correction(self_seeds, template)
                )
                masked_sum = secure.modular_sum(
                    [r["state_dict"] for r in reports]
                )
                return secure.unmask_sum(
                    masked_sum, corrections, sr["scale_bits"]
                )

            total = await asyncio.to_thread(_reconstruct_and_open)
            if self._secure_round is not sr or not self.rounds.in_progress:
                # the round was aborted (or a NEW round started) while
                # the reconstruction thread ran — in either case this
                # finalization owns nothing anymore and must not touch
                # the current round's state. Identity (`is sr`), not the
                # round name: aborted rounds REUSE their name (reference
                # naming parity, rounds.py::abort_round), so a replacement
                # round is indistinguishable by name alone.
                return
            if total is None:
                # abort, don't crash the finalize task (which would
                # lock the round forever)
                self.metrics.inc("secure_rounds_unrecoverable")
                self.rounds.abort_round()
                self._secure_round = None
                self._finish_round_obs(
                    round_name, "aborted:secure_unmask_failed",
                    sr["cohort"], reporters, started_wall=started_wall,
                )
                return
            if dropped:
                self.metrics.inc("secure_dropouts_recovered", len(dropped))
            n_epoch = (self.rounds.round_meta or {}).get("n_epoch", 0)
            _rt = tracing.make_trace_id(self.name, round_name)
            self.metrics.observe(
                "round_s", self.rounds.elapsed,
                exemplar=(_rt, tracing.root_span_id(_rt)),
            )
            self.rounds.end_round()
            self.metrics.inc("rounds_finished")
            w = sum(float(r["n_samples"]) for r in reports)
            if w > 0:
                merged = {k: v / w for k, v in total.items()}
                self.params = state_dict_to_params(
                    self.params, merged, device=self.device
                )
                self._record_history_and_checkpoint(reports, n_epoch)
            self._secure_round = None
            self._finish_round_obs(
                round_name, "completed_secure",
                sr["cohort"], reporters, started_wall=started_wall,
            )
        finally:
            self._secure_finalizing = False

    def _record_history_and_checkpoint(self, reports, n_epoch) -> None:
        # loss history: sample-weighted per-epoch mean (manager.py:127-130)
        appended = []
        for epoch in range(n_epoch):
            num = sum(
                r["loss_history"][epoch] * r["n_samples"]
                for r in reports
                if len(r["loss_history"]) > epoch
            )
            den = sum(
                r["n_samples"] for r in reports if len(r["loss_history"]) > epoch
            )
            if den:
                self.rounds.loss_history.append(num / den)
                appended.append(float(num / den))
        if self.journal is not None:
            if appended:
                self.journal.append("losses_appended", values=appended)
            self._compact_journal()
        if self.checkpointer is not None:
            # A save copies the params off the device and writes the whole
            # model — under slow storage back-to-back rounds would stall
            # the event loop (heartbeats pause, live clients get culled).
            # Run the whole save call in a worker thread so the loop never
            # waits on storage; the Checkpointer serializes concurrent
            # saves under its lock and writes atomically (temp file +
            # os.replace); cleanup awaits the save in flight.
            import asyncio

            step = self.rounds.n_rounds
            meta = {
                "n_rounds": step,
                "loss_history": [float(x) for x in self.rounds.loss_history],
            }

            async def _save(params=self.params):
                with self.metrics.timer("checkpoint_s"):
                    await asyncio.to_thread(
                        self.checkpointer.save, step, params,
                        meta=meta, wait=False,
                    )

            try:
                asyncio.get_running_loop()
                self._checkpoint_task = asyncio.ensure_future(_save())
            except RuntimeError:
                # end_round called outside the event loop (direct unit
                # tests): save inline, there is no loop to stall
                with self.metrics.timer("checkpoint_s"):
                    self.checkpointer.save(
                        step, self.params, meta=meta, wait=False
                    )

    def _compact_journal(self) -> None:
        """Snapshot the full control-plane state and truncate the journal.
        Runs at round end (a quiescent point — the snapshot schema has no
        open round) so the journal only ever holds one round's events."""
        if self.rounds.in_progress:
            return
        from baton_tpu_torch.server.journal import registry_snapshot

        self.journal.compact(
            {
                "clients": registry_snapshot(self.registry),
                "n_rounds": self.rounds.n_rounds,
                "loss_history": [
                    float(x) for x in self.rounds.loss_history
                ],
                # leadership must survive compaction: a standby that
                # catches up from this snapshot (or a restart that
                # replays it) must not mint an epoch below the fence
                "ha_epoch": self.ha_epoch,
            }
        )

    def round_state(self) -> dict:
        return {
            "name": self.name,
            "round": self.rounds.round_name,
            "n_rounds": self.rounds.n_rounds,
            "in_progress": self.rounds.in_progress,
            "clients": sorted(self.rounds.clients),
            "reported": sorted(self.rounds.client_responses),
            "loss_history": [float(x) for x in self.rounds.loss_history],
        }
