"""Control-plane replication: WAL shipping, leases, and root sharding.

The journal (:mod:`baton_tpu_torch.server.journal`) made a manager restart a
pause instead of an amnesia event — but only on the same machine: the
journal file is local, so losing the *host* still loses the registry
and the in-flight round. This module turns that WAL into a replication
channel, the control-plane analogue of the edge tier's data-plane
scale-out:

* **WAL shipping** — :class:`WalShipper` (on the active root) streams
  the journal's bytes to one or more warm standbys over authed HTTP
  (``POST /{name}/wal_segment``); :class:`WalReceiver` (on each
  standby) appends them to its own journal file. Segments are framed
  by ``(generation, offset)``: ``offset`` is the byte position in the
  journal file and ``generation`` counts compactions (compaction
  truncates the file, so offsets are only comparable within one
  generation). A receiver that sees a frame it cannot splice —
  wrong generation, gap, overlap — answers 409 with the position it
  *can* accept; the shipper either resumes from that offset or falls
  back to a **snapshot catch-up** (the full snapshot file + journal
  tail in one segment), so a standby can join or rejoin at any time.
* **Lease-based active/standby** — leadership is an epoch-numbered
  lease journaled by the active (``ha_lease`` events) and therefore
  shipped with everything else. A standby that observes lease expiry
  (plus a grace period) replays its copy of the WAL, bumps the epoch,
  and starts serving. Every shipped segment carries the sender's
  epoch; a receiver (or a promoted ex-standby) refuses any segment
  whose epoch is below its own with **409 stale_epoch** — the fence
  that keeps a zombie active from split-braining a round after its
  lease was taken.
* **Experiment sharding** — :class:`ExperimentTopology` puts root
  replica ids on the same consistent-hash ring the edge tier uses
  (:mod:`baton_tpu_torch.server.topology`) and assigns each experiment name
  to a replica. A replica marked dead hands its experiments to the
  next live replica clockwise, moving nothing else. Workers and edges
  learn a reassignment lazily: their next heartbeat to the wrong
  replica answers **307** with the owner's URL (plus the full topology
  map in the body), exactly the cheap redirect contract HTTP already
  gives us.

The wire format of one segment (JSON body of ``POST wal_segment``)::

    {"epoch": 3, "replica": "root-0", "generation": 2, "offset": 1184,
     "data": "<journal JSONL bytes>",        # may be "" (lease heartbeat)
     "full": false,                          # true => snapshot catch-up
     "snapshot": null,                       # full only: snapshot file text
     "lease": {"epoch": 3, "holder": "root-0", "expires": 171...}}

Responses: ``200 {"generation": g, "offset": o}`` (the position after
splicing), ``409 {"error": "stale_epoch", "epoch": e}`` (fenced), or
``409 {"error": "resync", "generation": g, "offset": o, "need_full":
bool}`` (shipper must rewind or send a full segment). Auth rides the
``X-Baton-Ha-Token`` header — a shared secret between replicas, never
a per-client credential.

Everything here is transport + framing; the *meaning* of the shipped
bytes stays in ``journal.replay``, which is what the standby runs at
promotion time. Secure-aggregation rounds are the one thing replication
deliberately does not save: mask/share state is never journaled (so a
standby cannot unmask), and a failover aborts such rounds with reason
``secure_agg`` — forward secrecy over availability, documented in the
README.
"""

from __future__ import annotations

import asyncio
import bisect
import contextlib
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import aiohttp

from baton_tpu_torch.server.journal import SNAPSHOT_SUFFIX
from baton_tpu_torch.server.topology import _ring_hash

log = logging.getLogger(__name__)

#: shared-secret header for replica-to-replica calls
HA_TOKEN_HEADER = "X-Baton-Ha-Token"


# ----------------------------------------------------------------------
class ExperimentTopology:
    """Experiment → root-replica assignment on a consistent-hash ring.

    Mirrors :class:`baton_tpu_torch.server.topology.EdgeTopology` (same vnode
    ring, same clockwise skip-dead walk) but hashes *experiment names*
    over *replica ids*: killing a replica reassigns only the arcs it
    owned, so at most ``1/len(replicas)`` of experiments move."""

    def __init__(self, replicas: Iterable[str], replicas_per_node: int = 128):
        self.replicas: List[str] = list(dict.fromkeys(replicas))
        if not self.replicas:
            raise ValueError("ExperimentTopology needs at least one replica")
        self._dead: set = set()
        ring: List[Tuple[int, str]] = []
        for rid in self.replicas:
            for v in range(replicas_per_node):
                ring.append((_ring_hash(f"{rid}#{v}"), rid))
        ring.sort()
        self._ring = ring
        self._points = [p for p, _ in ring]

    def mark_dead(self, replica_id: str) -> None:
        if replica_id in self.replicas:
            self._dead.add(replica_id)

    def mark_alive(self, replica_id: str) -> None:
        self._dead.discard(replica_id)

    def is_live(self, replica_id: str) -> bool:
        return replica_id in self.replicas and replica_id not in self._dead

    def live_replicas(self) -> List[str]:
        return [r for r in self.replicas if r not in self._dead]

    def assign(self, experiment_name: str) -> Optional[str]:
        """The live replica owning ``experiment_name``; None when every
        replica is dead."""
        if len(self._dead) >= len(self.replicas):
            return None
        start = bisect.bisect_right(self._points, _ring_hash(experiment_name))
        n = len(self._ring)
        for step in range(n):
            rid = self._ring[(start + step) % n][1]
            if rid not in self._dead:
                return rid
        return None

    def cohorts(self) -> Dict[str, List[str]]:
        """Live replica id → sorted experiment list is the *caller's*
        join (experiments live app-side); this returns the live set for
        symmetry with EdgeTopology's console helpers."""
        return {rid: [] for rid in self.live_replicas()}


# ----------------------------------------------------------------------
class WalReceiver:
    """Standby-side WAL endpoint: splices shipped segments into the
    local journal file and tracks the active's lease.

    Owns the journal *files* directly (no :class:`Journal` instance —
    a standby must never append its own events until promoted). All
    state is derivable: a restarted standby answers the first segment
    with a resync and the shipper re-ships from a snapshot."""

    def __init__(self, path: str, metrics: Any = None):
        self.path = os.path.abspath(path)
        self.snapshot_path = self.path + SNAPSHOT_SUFFIX
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.metrics = metrics
        #: generation of the journal bytes on disk (None until the
        #: first full segment lands — nothing splices before that)
        self.generation: Optional[int] = None
        self.offset = 0
        #: highest epoch ever accepted; segments below it are fenced
        self.epoch = 0
        self.lease: Optional[dict] = None
        self.last_applied_wall: Optional[float] = None
        #: set at promotion: every further segment is refused (the old
        #: active is a zombie by definition once we serve)
        self.closed = False

    # -- applying ------------------------------------------------------
    def apply(self, seg: dict) -> Tuple[int, dict]:
        """Splice one shipped segment; returns ``(status, body)`` for
        the HTTP handler. Pure state machine — no awaits — so a
        segment is applied atomically w.r.t. the event loop."""
        try:
            epoch = int(seg.get("epoch", 0))
            gen = int(seg.get("generation", 0))
            off = int(seg.get("offset", 0))
        except (TypeError, ValueError):
            return 400, {"error": "Bad Segment"}
        if self.closed or epoch < self.epoch:
            self._inc("wal_segments_refused_stale")
            return 409, {"error": "stale_epoch", "epoch": self.epoch}
        full = bool(seg.get("full"))
        data = seg.get("data")
        if data is None:
            data = ""
        if not isinstance(data, str):
            return 400, {"error": "Bad Segment"}
        if not full and (self.generation is None or gen != self.generation
                         or off != self.offset):
            self._inc("wal_resyncs")
            return 409, {
                "error": "resync",
                "generation": self.generation,
                "offset": self.offset,
                "need_full": (self.generation is None
                              or gen != self.generation),
            }
        raw = data.encode("utf-8")
        if full:
            snap = seg.get("snapshot")
            if snap is None:
                with contextlib.suppress(OSError):
                    os.remove(self.snapshot_path)
            else:
                tmp = self.snapshot_path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as fh:
                    fh.write(snap)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, self.snapshot_path)
            with open(self.path, "wb") as fh:
                fh.write(raw)
                fh.flush()
                os.fsync(fh.fileno())
            self.generation = gen
            self.offset = len(raw)
            self._inc("wal_snapshot_catchups")
        elif raw:
            with open(self.path, "ab") as fh:
                fh.write(raw)
                fh.flush()
            self.offset += len(raw)
        self.epoch = max(self.epoch, epoch)
        lease = seg.get("lease")
        if isinstance(lease, dict):
            self.lease = dict(lease)
            with contextlib.suppress(TypeError, ValueError):
                self.epoch = max(self.epoch, int(lease.get("epoch", 0)))
        self.last_applied_wall = time.time()
        self._inc("wal_segments_applied")
        return 200, {"generation": self.generation, "offset": self.offset}

    # -- promotion inputs ----------------------------------------------
    def lease_expired(self, grace_s: float = 0.0,
                      now: Optional[float] = None) -> bool:
        """True once the active's lease has lapsed past the grace
        window. A standby that never heard a lease does NOT consider it
        expired — promoting blind during a cold fleet boot would mint
        two actives."""
        if self.lease is None:
            return False
        if now is None:
            now = time.time()
        try:
            expires = float(self.lease.get("expires", 0.0))
        except (TypeError, ValueError):
            return False
        return now > expires + grace_s

    def lag_s(self, now: Optional[float] = None) -> Optional[float]:
        if self.last_applied_wall is None:
            return None
        return max(0.0, (time.time() if now is None else now)
                   - self.last_applied_wall)

    def status(self) -> dict:
        return {
            "generation": self.generation,
            "applied_offset": self.offset,
            "epoch": self.epoch,
            "lease": self.lease,
            "lag_s": self.lag_s(),
            "closed": self.closed,
        }

    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)


# ----------------------------------------------------------------------
class WalShipper:
    """Active-side WAL pump: per-standby (generation, offset) cursors,
    incremental tail shipping, resync/snapshot catch-up, and the
    stale-epoch fence check.

    Driven by the manager's ``_ha_tick`` — one :meth:`ship_once` per
    tick, no background task of its own, so teardown is the manager's
    existing task teardown."""

    def __init__(self, name: str, journal: Any, standbys: Iterable[str],
                 replica_id: str,
                 session_factory: Callable[[], aiohttp.ClientSession],
                 token: Optional[str] = None, metrics: Any = None,
                 timeout_s: float = 5.0):
        self.name = name
        self.journal = journal
        self.replica_id = replica_id
        self._session_factory = session_factory
        self.token = token
        self.metrics = metrics
        self.timeout_s = timeout_s
        #: per-standby cursor: where the *standby* is, not where we are
        self._targets: Dict[str, dict] = {
            url.rstrip("/"): {"generation": None, "offset": 0,
                              "need_full": True, "fenced": False,
                              "last_ok_wall": None}
            for url in standbys
        }

    # -- segments ------------------------------------------------------
    def _read_tail(self, offset: int) -> str:
        # runs on a worker thread (ship_once routes segment builds
        # through asyncio.to_thread), under journal.io_lock — the lock,
        # not loop-atomicity, is what keeps a compaction from tearing
        # the segment between the cursor read and the file read
        with open(self.journal.path, "rb") as fh:
            fh.seek(offset)
            return fh.read().decode("utf-8")

    def _full_segment(self, epoch: int, lease: Optional[dict]) -> dict:
        snap = None
        if os.path.exists(self.journal.snapshot_path):
            # same frame-consistency contract as _read_tail; snapshots
            # are one compacted state, not history
            with open(self.journal.snapshot_path, "r",
                      encoding="utf-8") as fh:
                snap = fh.read()
        return {
            "epoch": epoch, "replica": self.replica_id,
            "generation": self.journal.generation, "offset": 0,
            "data": self._read_tail(0), "full": True, "snapshot": snap,
            "lease": lease,
        }

    def _tail_segment(self, epoch: int, offset: int,
                      lease: Optional[dict]) -> dict:
        return {
            "epoch": epoch, "replica": self.replica_id,
            "generation": self.journal.generation, "offset": offset,
            "data": self._read_tail(offset), "full": False,
            "snapshot": None, "lease": lease,
        }

    def _build_segment(self, epoch: int, lease: Optional[dict],
                       generation: Any, offset: int,
                       need_full: bool) -> dict:
        """Build one standby's segment on a worker thread.

        ``journal.io_lock`` makes (generation, journal bytes, snapshot)
        one atomic frame: appends and compactions on the loop wait for
        the read, instead of the read blocking the loop.  The full-vs-
        tail decision is re-taken UNDER the lock — a compaction that
        landed after the loop-side cursor read bumps the generation, and
        shipping a tail against the truncated file would feed the
        standby a torn frame."""
        with self.journal.io_lock:
            if need_full or generation != self.journal.generation:
                return self._full_segment(epoch, lease)
            return self._tail_segment(epoch, offset, lease)

    # -- the pump ------------------------------------------------------
    async def ship_once(self, epoch: int,
                        lease: Optional[dict] = None) -> None:
        """Ship whatever each standby is missing (or an empty lease
        heartbeat when it is caught up). Transport failures are counted
        and retried next tick; a stale-epoch refusal fences the target
        permanently — *we* are the zombie."""
        for url, t in self._targets.items():
            if t["fenced"]:
                continue
            # the cursor snapshot crosses an await here, but the build
            # re-validates it against the live generation under
            # journal.io_lock — a mid-flight compaction downgrades this
            # ship to a full segment instead of tearing it
            seg = await asyncio.to_thread(
                self._build_segment, epoch, lease,
                t["generation"], t["offset"], t["need_full"],
            )
            await self._post(url, t, seg)

    async def _post(self, url: str, t: dict, seg: dict) -> None:
        headers = {}
        if self.token:
            headers[HA_TOKEN_HEADER] = self.token
        try:
            session = self._session_factory()
            async with session.post(
                f"{url}/{self.name}/wal_segment", json=seg, headers=headers,
                timeout=aiohttp.ClientTimeout(total=self.timeout_s),
            ) as resp:
                try:
                    body = await resp.json()
                except (aiohttp.ContentTypeError, ValueError):
                    body = {}
                self._on_response(url, t, seg, resp.status, body)
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            self._inc("wal_ship_errors")

    def _on_response(self, url: str, t: dict, seg: dict, status: int,
                     body: dict) -> None:
        if status == 200:
            t["generation"] = seg["generation"]
            t["offset"] = int(body.get("offset",
                                       seg["offset"]
                                       + len(seg["data"].encode("utf-8"))))
            t["need_full"] = False
            t["last_ok_wall"] = time.time()
            self._inc("wal_segments_shipped")
            if seg["data"]:
                self._inc("wal_bytes_shipped", len(seg["data"]))
            if seg.get("full"):
                self._inc("wal_snapshot_catchups_sent")
        elif status == 409 and body.get("error") == "stale_epoch":
            # the standby (or its successor) moved past our epoch: we
            # lost the lease while we weren't looking. Never ship again.
            t["fenced"] = True
            self._inc("wal_ship_fenced")
            log.warning("wal shipper %s: standby %s fenced us "
                        "(their epoch %s)", self.replica_id, url,
                        body.get("epoch"))
        elif status == 409 and body.get("error") == "resync":
            t["need_full"] = bool(body.get("need_full", True))
            if not t["need_full"]:
                t["generation"] = body.get("generation")
                t["offset"] = int(body.get("offset", 0))
            self._inc("wal_resyncs")
        else:
            self._inc("wal_ship_errors")

    # -- introspection -------------------------------------------------
    @property
    def fenced(self) -> bool:
        """True once ANY standby refused us as stale — the strongest
        possible signal that our lease is gone."""
        return any(t["fenced"] for t in self._targets.values())

    def positions(self) -> Dict[str, dict]:
        return {
            url: {"generation": t["generation"], "offset": t["offset"],
                  "need_full": t["need_full"], "fenced": t["fenced"],
                  "last_ok_wall": t["last_ok_wall"]}
            for url, t in self._targets.items()
        }

    def min_shipped_offset(self) -> int:
        """The most lagging standby's acked offset (0 when none acked
        in the current generation) — the replication_wal_shipped_offset
        gauge."""
        offs = [t["offset"] for t in self._targets.values()
                if t["generation"] == self.journal.generation
                and not t["fenced"]]
        return min(offs) if offs else 0

    def _inc(self, name: str, value: float = 1.0) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, value)


# ----------------------------------------------------------------------
def make_lease(epoch: int, holder: str, duration_s: float,
               now: Optional[float] = None) -> dict:
    """One lease record — journaled as the ``ha_lease`` event's fields
    and carried verbatim on every shipped segment."""
    if now is None:
        now = time.time()
    return {"epoch": int(epoch), "holder": holder,
            "expires": round(now + duration_s, 6)}
