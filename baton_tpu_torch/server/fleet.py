"""Fleet health plane: per-client telemetry ledger + anomaly scoring.

The round pipeline answers *what happened to round N*; this module
answers the operator questions that dominate at fleet scale — *which
client* is slow, *is it getting worse*, and *why was it a straggler*.

:class:`ClientLedger` keeps a bounded ring of per-client per-round
observations (train wall time, upload bytes/bandwidth, reported loss,
heartbeat RTT, participation outcome), persisted crash-safe to
``clients.jsonl`` with the same single-write+flush discipline as
``rounds.jsonl``, and classifies each client from its recent window:

``healthy``
    nothing anomalous in the window.
``slow``
    the client's median train time is a robust (median/MAD) outlier
    against the fleet's per-client medians.
``flaky``
    the client keeps missing rounds it was asked to join, or straggles
    past the reporting window, despite having reported before.
``degrading``
    the client's own train time is trending up — its recent half is
    materially worse than its older half.
``inactive``
    never participated in the window (an edge's own client entry, or a
    client the cohort sampler skipped) — excluded from anomaly gauges.

Classifications are **advisory**: exported as gauges and annotated into
round SLO records (``straggler_why``), never used for eviction. Client
identity is the registration id, so a cold-restarted worker starts a
fresh history; a worker that goes *unavailable* (503s, timeouts) keeps
its id and accumulates the misses that make it ``flaky``.

The scoring helpers (:func:`robust_zscore`, :func:`classify_client`)
are pure functions over observation dicts so the classification edges
(constant history, single sample, step change, flapping) unit-test
without a federation.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "ClientLedger",
    "classify_client",
    "robust_zscore",
    "STATUSES",
]

#: every classification the ledger can emit, in gauge-export order
STATUSES = ("healthy", "slow", "flaky", "degrading", "inactive")

# -- scoring thresholds (module-level so tests can reference them) ----
#: robust z-score above which a client's median train time is "slow"
SLOW_Z = 3.5
#: minimum clients with train timings before cross-sectional scoring
SLOW_MIN_FLEET = 3
#: missed/straggled rounds in the window before "flaky" fires …
FLAKY_MIN_MISSES = 2
#: … and the minimum fraction of the window they must represent
FLAKY_MIN_FRAC = 0.2
#: recent-half/older-half train-time ratio that means "degrading"
DEGRADE_RATIO = 1.5
#: observations with timings needed before trend detection
DEGRADE_MIN_OBS = 6
#: absolute train-time increase (s) below which trends are noise
DEGRADE_MIN_DELTA_S = 0.01
#: recent/older MFU ratio below which a client is losing compute
#: efficiency (the inverse direction of DEGRADE_RATIO: MFU falls)
MFU_DEGRADE_RATIO = 1.0 / 1.5
#: absolute MFU drop below which MFU trends are noise
MFU_DEGRADE_MIN_DELTA = 0.01
# 1.4826 scales MAD to σ for normal data; the floor keeps an outlier
# detectable when the rest of the fleet is perfectly uniform (MAD = 0)
_MAD_SIGMA = 1.4826
_MAD_FLOOR_FRAC = 0.05
_EPS = 1e-6


def robust_zscore(
    value: float,
    population: Sequence[float],
    *,
    mad_floor_frac: float = _MAD_FLOOR_FRAC,
) -> float:
    """Median/MAD z-score of ``value`` against ``population``.

    The scale floors at ``mad_floor_frac × |median|`` (and an absolute
    epsilon) so a uniform population — MAD exactly zero — still yields
    a finite, large score for a genuine outlier instead of dividing by
    zero, while a value equal to the median scores exactly 0.
    """
    if not population:
        return 0.0
    med = statistics.median(population)
    mad = statistics.median(abs(x - med) for x in population)
    scale = max(_MAD_SIGMA * mad, mad_floor_frac * abs(med), _EPS)
    return (value - med) / scale


def _median(values: Iterable[float]) -> Optional[float]:
    vals = [v for v in values if v is not None]
    return statistics.median(vals) if vals else None


def classify_client(
    window: Sequence[dict],
    fleet_train_medians: Sequence[float],
    *,
    slow_z: float = SLOW_Z,
) -> Tuple[str, str]:
    """Classify one client from its observation ``window`` (oldest
    first) against the fleet's per-client median train times. Returns
    ``(status, reason)``; ``reason`` is the human/SLO-record string.
    """
    if not window:
        return "inactive", "no observations"
    reported = [o for o in window if o.get("outcome") == "reported"]
    missed = [o for o in window if o.get("outcome") in ("missed", "straggler")]
    if not reported and not any(
        o.get("outcome") == "straggler" for o in window
    ):
        return "inactive", "no participation in window"

    # flaky: keeps missing rounds it was asked to join
    n = len(window)
    if (
        len(missed) >= FLAKY_MIN_MISSES
        and len(missed) / n >= FLAKY_MIN_FRAC
    ):
        return "flaky", (
            f"missed or straggled {len(missed)} of last {n} rounds"
        )

    trains = [o["train_s"] for o in reported
              if o.get("train_s") is not None]
    my_med = _median(trains)

    # slow: cross-sectional outlier vs the fleet's per-client medians
    if (
        my_med is not None
        and len(fleet_train_medians) >= SLOW_MIN_FLEET
    ):
        z = robust_zscore(my_med, fleet_train_medians)
        if z >= slow_z:
            fleet_med = statistics.median(fleet_train_medians)
            return "slow", (
                f"train_s median {my_med:.3f}s vs fleet median "
                f"{fleet_med:.3f}s (robust z={z:.1f})"
            )

    # degrading: own train time trending up within the window
    if len(trains) >= DEGRADE_MIN_OBS:
        half = len(trains) // 2
        older, recent = _median(trains[:half]), _median(trains[half:])
        if (
            older is not None and recent is not None
            and recent >= DEGRADE_RATIO * older
            and recent - older >= DEGRADE_MIN_DELTA_S
        ):
            return "degrading", (
                f"train_s median {older:.3f}s -> {recent:.3f}s over "
                f"last {len(trains)} reports"
            )

    # degrading (compute plane): own MFU trending DOWN — a client whose
    # wall time holds steady while its delivered FLOPs collapse (e.g.
    # a recompile storm, thermal throttling) would otherwise pass every
    # wall-clock check above
    mfus = [o["mfu"] for o in reported if o.get("mfu") is not None]
    if len(mfus) >= DEGRADE_MIN_OBS:
        half = len(mfus) // 2
        older, recent = _median(mfus[:half]), _median(mfus[half:])
        if (
            older is not None and recent is not None
            and recent <= MFU_DEGRADE_RATIO * older
            and older - recent >= MFU_DEGRADE_MIN_DELTA
        ):
            return "degrading", (
                f"mfu median {older:.3f} -> {recent:.3f} over "
                f"last {len(mfus)} reports"
            )

    return "healthy", ""


class ClientLedger:
    """Bounded per-client observation ring with crash-safe persistence.

    Thread-safe (ingest folds run off-loop); every mutation happens
    under one lock and every ``clients.jsonl`` append is a single
    ``write()`` + flush, mirroring :class:`baton_tpu_torch.utils.slog
    .RoundsLog` so a crash tears at most the final line.
    """

    def __init__(
        self,
        window: int = 32,
        log_path: Optional[str] = None,
        metrics=None,
        node: str = "manager",
    ) -> None:
        self.window = max(2, int(window))
        self.node = node
        self.metrics = metrics
        self._obs: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._log_path = log_path
        if log_path:
            os.makedirs(
                os.path.dirname(os.path.abspath(log_path)), exist_ok=True
            )

    # ------------------------------------------------------------------
    def observe(
        self,
        client_id: str,
        round_name: Optional[str],
        outcome: str,
        *,
        train_s: Optional[float] = None,
        upload_bytes: Optional[int] = None,
        upload_s: Optional[float] = None,
        loss: Optional[float] = None,
        hb_rtt_s: Optional[float] = None,
        n_samples: Optional[float] = None,
        via_edge: Optional[str] = None,
        mfu: Optional[float] = None,
        compile_s: Optional[float] = None,
        recompile_storm: Optional[bool] = None,
        ts: Optional[float] = None,
    ) -> dict:
        """Record one per-round observation for ``client_id``."""
        entry = {
            "ts": round(time.time() if ts is None else ts, 6),
            "node": self.node,
            "round": round_name,
            "client": client_id,
            "outcome": outcome,
        }
        if train_s is not None:
            entry["train_s"] = round(float(train_s), 6)
        if upload_bytes is not None:
            entry["upload_bytes"] = int(upload_bytes)
        if upload_s is not None and upload_s > 0:
            entry["upload_s"] = round(float(upload_s), 6)
            if upload_bytes:
                entry["upload_bw_bps"] = round(upload_bytes / upload_s, 1)
        if loss is not None:
            entry["loss"] = float(loss)
        if hb_rtt_s is not None:
            entry["hb_rtt_s"] = round(float(hb_rtt_s), 6)
        if n_samples is not None:
            entry["n_samples"] = float(n_samples)
        if via_edge is not None:
            entry["via_edge"] = via_edge
        if mfu is not None:
            entry["mfu"] = round(float(mfu), 6)
        if compile_s is not None:
            entry["compile_s"] = round(float(compile_s), 6)
        if recompile_storm:
            entry["recompile_storm"] = True
        with self._lock:
            ring = self._obs.get(client_id)
            if ring is None:
                ring = self._obs[client_id] = deque(maxlen=self.window)
            ring.append(entry)
        if self._log_path:
            data = json.dumps(entry, default=repr) + "\n"
            with self._lock:
                with open(self._log_path, "a", encoding="utf-8") as fh:
                    fh.write(data)
                    fh.flush()
        if self.metrics is not None:
            self.metrics.inc("fleet_observations")
        return entry

    def record_round(
        self,
        round_name: Optional[str],
        cohort: Iterable[str],
        participants: Iterable[str],
        responses: Optional[Dict[str, dict]] = None,
    ) -> Dict[str, str]:
        """Fold one finished round into the ledger.

        ``cohort`` is every client the round *asked* (the notify
        fan-out), ``participants`` those that acked ``round_start``,
        ``responses`` the per-client response dicts of those that
        reported (fields like ``timings``/``upload_bytes``/
        ``loss_history`` are picked up when present). Returns the
        *straggler-why* map: a classification-backed reason for every
        cohort member that did not report.
        """
        responses = responses or {}
        participants = set(participants)
        cohort = set(cohort) | participants | set(responses)
        for cid in sorted(cohort):
            resp = responses.get(cid)
            if resp is not None:
                timings = resp.get("timings") or {}
                loss_hist = resp.get("loss_history") or []
                compute = resp.get("compute") or {}
                self.observe(
                    cid, round_name, "reported",
                    train_s=timings.get("train_s"),
                    upload_bytes=resp.get("upload_bytes"),
                    upload_s=timings.get("upload_s"),
                    loss=loss_hist[-1] if loss_hist else None,
                    hb_rtt_s=timings.get("hb_rtt_s"),
                    n_samples=resp.get("n_samples"),
                    via_edge=resp.get("via_edge"),
                    mfu=compute.get("mfu"),
                    compile_s=compute.get("compile_s"),
                    recompile_storm=compute.get("recompile_storm"),
                )
            elif cid in participants:
                self.observe(cid, round_name, "straggler")
            else:
                self.observe(cid, round_name, "missed")
        why: Dict[str, str] = {}
        if cohort - set(responses):
            classified = self.classify_all()
            for cid in sorted(cohort - set(responses)):
                info = classified.get(cid)
                if info is None:
                    continue
                if info["status"] == "inactive":
                    # edges and never-participating registrations carry
                    # no train history; naming them every round would
                    # drown the real stragglers
                    continue
                if info["status"] != "healthy":
                    why[cid] = f"{info['status']}: {info['reason']}"
                else:
                    why[cid] = (
                        f"healthy: first straggle in last "
                        f"{info['rounds_seen']} rounds"
                        if cid in participants
                        else "healthy: did not ack round_start"
                    )
        return why

    # ------------------------------------------------------------------
    def classify_all(self) -> Dict[str, dict]:
        """``{client_id: {"status", "reason", …window stats}}`` for the
        whole ledger, computed from the current windows."""
        with self._lock:
            windows = {cid: list(ring) for cid, ring in self._obs.items()}
        fleet_meds = []
        per_client_med: Dict[str, Optional[float]] = {}
        for cid, win in windows.items():
            med = _median(
                o.get("train_s") for o in win
                if o.get("outcome") == "reported"
            )
            per_client_med[cid] = med
            if med is not None:
                fleet_meds.append(med)
        out: Dict[str, dict] = {}
        for cid, win in windows.items():
            status, reason = classify_client(win, fleet_meds)
            last = win[-1]
            reported = [o for o in win if o.get("outcome") == "reported"]
            info = {
                "status": status,
                "reason": reason,
                "rounds_seen": len(win),
                "reported": len(reported),
                "straggled": sum(
                    o.get("outcome") == "straggler" for o in win
                ),
                "missed": sum(o.get("outcome") == "missed" for o in win),
                # windowed recompile-storm count: the pin_shapes runbook
                # quarantines exactly the clients whose storms triggered
                # the alert, so the offender set must come from the same
                # ledger window the classification does
                "storms": sum(
                    1 for o in win if o.get("recompile_storm")
                ),
                "last_round": last.get("round"),
                "last_outcome": last.get("outcome"),
                "last_ts": last.get("ts"),
            }
            med = per_client_med.get(cid)
            if med is not None:
                info["train_s_median"] = round(med, 6)
            for key in ("train_s", "upload_bytes", "upload_bw_bps",
                        "loss", "hb_rtt_s", "via_edge",
                        "mfu", "compile_s"):
                for o in reversed(reported):
                    if o.get(key) is not None:
                        info[key] = o[key]
                        break
            out[cid] = info
        return out

    def class_counts(self) -> Dict[str, int]:
        counts = {status: 0 for status in STATUSES}
        for info in self.classify_all().values():
            counts[info["status"]] += 1
        return counts

    def export_gauges(self, metrics) -> Dict[str, int]:
        """Publish advisory ``fleet_clients_*`` class counts."""
        counts = self.class_counts()
        metrics.set_gauge("fleet_clients_total",
                          sum(counts.values()))
        for status in STATUSES:
            metrics.set_gauge(f"fleet_clients_{status}", counts[status])
        return counts

    def health_snapshot(self) -> dict:
        """The ``GET /{name}/fleet/health`` payload."""
        clients = self.classify_all()
        counts = {status: 0 for status in STATUSES}
        for info in clients.values():
            counts[info["status"]] += 1
        return {
            "node": self.node,
            "ts": round(time.time(), 6),
            "window": self.window,
            "summary": dict(counts, total=len(clients)),
            "clients": clients,
        }

    def health_slice(self, client_ids=None) -> dict:
        """The forensics-bundle fleet evidence: classifications for the
        implicated clients only (the round's stragglers), or — with no
        ids — every client currently classified non-healthy. Bounded so
        a bundle never embeds a 10k-client ledger dump."""
        clients = self.classify_all()
        if client_ids is not None:
            picked = {cid: clients[cid] for cid in client_ids
                      if cid in clients}
            unknown = sorted(set(client_ids) - set(clients))
        else:
            picked = {cid: info for cid, info in clients.items()
                      if info["status"] != "healthy"}
            unknown = []
        return {
            "node": self.node,
            "window": self.window,
            "implicated": sorted(picked),
            "unknown": unknown,
            "clients": picked,
        }

    # ------------------------------------------------------------------
    def known_clients(self) -> List[str]:
        with self._lock:
            return sorted(self._obs)

    def forget(self, client_id: str) -> None:
        """Drop a client's ring (e.g. on deregistration) — the
        persisted ``clients.jsonl`` history is kept."""
        with self._lock:
            self._obs.pop(client_id, None)
