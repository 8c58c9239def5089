"""Edge aggregator — the hierarchical tier between workers and root.

One :class:`EdgeAggregator` fronts a cohort of workers for a single
root manager experiment, collapsing the root's per-round work from
``O(C)`` to ``O(E)`` on both planes:

* **Downlink.** The edge fetches each round blob from the root ONCE
  (Range-resumable, digest-verified — the same pull contract the
  worker speaks) and serves its cohort from a local content-addressed
  :class:`~baton_tpu_torch.server.blobs.BlobStore` with the root's exact
  Range/ETag semantics, so a worker cannot tell which tier it is
  talking to.
* **Uplink.** The edge runs its own
  :class:`~baton_tpu_torch.server.ingest.IngestPipeline` to decode/validate
  cohort updates off-loop and folds them into a weighted
  :class:`~baton_tpu_torch.ops.aggregation.StreamingMean` partial. When the
  cohort has reported (or ``flush_after_s`` expires) it ships ONE
  ``edge_partial`` update upstream — the partial mean, the summed
  sample weight, and the contributor set — which the root merges
  ``ShardedStreamingMean``-style (weighted sums are associative, so
  the tree fold equals the flat fold to fp32 reduction order).

Control plane: workers register/heartbeat THROUGH the edge. The
registration proxy rewrites each worker's callback URL to this edge's
``/relay/`` endpoint, so the root's notify and secure-protocol POSTs
route back through the edge hop (carrying ``traceparent`` — one round
stays one trace), while the credentials the worker holds are ROOT
credentials: a worker that loses its edge falls back to the root
directly without re-registering (see ``http_worker._edge_failed``).

Deliberate non-goals, all of which degrade to the flat topology
instead of failing:

* **Masked (secure-aggregation) uploads are refused with 409** — a
  partial fold of ring elements would break unmasking (the pairwise
  masks only cancel in the full cohort sum). The worker pins masked
  bodies to its direct root route; the 409 is a guard, not a path.
* **Compressed/quantized uploads and encoded broadcasts proxy
  through** — the edge folds dense template-shaped tensors only.
* **An unknown round proxies through** — the root is authoritative
  about liveness; the edge never turns its own staleness into a 410.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import logging
import random
import re
import time
from typing import Dict, Optional, Set, Tuple

import aiohttp
from aiohttp import web
import numpy as np

from baton_tpu_torch.obs import alerts as obs_alerts
from baton_tpu_torch.ops.aggregation import StreamingMean
from baton_tpu_torch.server import wire
from baton_tpu_torch.server.blobs import BlobStore
from baton_tpu_torch.server.fleet import ClientLedger
from baton_tpu_torch.server.ingest import IngestPipeline
from baton_tpu_torch.server.utils import (
    BodyTooLarge,
    PeriodicTask,
    json_clean,
    random_key,
    read_body_capped,
    read_json_capped,
)
from baton_tpu_torch.utils import tracing
from baton_tpu_torch.utils.metrics import Metrics
from baton_tpu_torch.utils.tracing import Tracer, trace_headers

MAX_BACKOFF = 30.0


@dataclasses.dataclass
class _WorkerRoute:
    """One proxied worker: its real callback URL (for root→worker
    relays) and its ROOT credentials' key (for authenticating the
    worker's own blob/update requests at this edge — the register
    proxy sees the key on its way back to the worker)."""

    url: str
    key: str


class _ChunkSession:
    """Uplink chunk reassembly state — same offset-committed contract
    as the manager's (manager is authoritative shape; see
    ``http_manager.handle_update_chunk``)."""

    __slots__ = ("client_id", "update_id", "total", "buf", "busy",
                 "content_type")

    def __init__(self, client_id: str, update_id: str, total: int) -> None:
        self.client_id = client_id
        self.update_id = update_id
        self.total = total
        self.buf = bytearray()
        self.busy = False
        self.content_type = wire.CONTENT_TYPE

    @property
    def offset(self) -> int:
        return len(self.buf)


class _EdgeRound:
    """Per-round fold state. One instance per observed ``round_start``
    envelope; retired (and its unshipped partial counted abandoned)
    when the next round's envelope arrives."""

    def __init__(
        self, round_name: str, n_epoch: int, digest: str, size: int,
        proxy_only: bool, secure: bool,
    ) -> None:
        self.round_name = round_name
        self.n_epoch = n_epoch
        self.digest = digest
        self.size = size
        # proxy_only: secure or encoded broadcasts — the edge cannot
        # derive a dense validation template, so uplink passes through
        self.proxy_only = proxy_only
        self.secure = secure
        self.acc = StreamingMean()
        self.template: Optional[dict] = None
        self.template_ready = asyncio.Event()
        # contributor bookkeeping shipped inside the partial's meta
        self.contributors: Dict[str, dict] = {}
        self.update_ids: Set[str] = set()
        self.notified: Set[str] = set()
        self.shipped = False
        self.shipping = False
        # accepted updates whose fold is still queued in the pipeline:
        # ship must drain these or the partial's mean would omit tensors
        # its contributor set credits
        self.pending_folds = 0
        self.ship_update_id = random_key(16)
        self.settle_task: Optional[asyncio.Future] = None
        self.deadline_task: Optional[asyncio.Future] = None
        # per-round phase wall times shipped upstream in the partial's
        # meta (the root folds them into the round's counter deltas)
        self.t0 = time.monotonic()
        self.fold_s = 0.0
        self.fetch_s = 0.0

    def cancel_tasks(self) -> None:
        for t in (self.settle_task, self.deadline_task):
            if t is not None and not t.done():
                t.cancel()


class EdgeAggregator:
    """HTTP edge tier for one experiment ``name``.

    Speaks the worker-facing manager protocol downward (register /
    heartbeat / round_blob / update / update_chunk / trace_spans) and
    the worker protocol upward (it registers at the root as a client
    of its own, with a callback that declines cohort membership).
    """

    _RANGE_RE = re.compile(r"bytes=(\d+)-(\d*)$")

    def __init__(
        self,
        app: web.Application,
        manager: str,
        name: str,
        port: int,
        edge_name: Optional[str] = None,
        edge_host: str = "127.0.0.1",
        heartbeat_time: float = 30.0,
        ship_settle_s: float = 0.25,
        flush_after_s: float = 20.0,
        ingest_workers: int = 2,
        ingest_queue_depth: int = 64,
        upload_chunk_bytes: Optional[int] = None,
        max_upload_bytes: Optional[int] = 1 << 30,
        metrics: Optional[Metrics] = None,
        clients_log_path: Optional[str] = None,
        health_window: int = 32,
        metrics_history_interval_s: float = 5.0,
        alert_rules: Optional[list] = None,
        alerts_log_path: Optional[str] = None,
        alerts_interval_s: float = 1.0,
        auto_start: bool = True,
    ) -> None:
        self.name = name
        self.port = port
        self.host = edge_host
        self.edge_name = edge_name or f"edge_{random_key(6)}"
        self.root_url = f"http://{manager}/{self.name}/"
        self.heartbeat_time = float(heartbeat_time)
        self.ship_settle_s = float(ship_settle_s)
        self.flush_after_s = float(flush_after_s)
        self.upload_chunk_bytes = upload_chunk_bytes
        self.max_upload_bytes = max_upload_bytes

        self.metrics = metrics if metrics is not None else Metrics()
        self.tracer = Tracer(service=f"edge:{self.edge_name}")
        # this tier's half of the fleet health plane: the edge ledgers
        # its own cohort (the workers it relays for), the root ledgers
        # everyone — same scoring, different vantage point
        self.fleet = ClientLedger(
            window=health_window, log_path=clients_log_path,
            metrics=self.metrics, node=f"edge:{self.edge_name}",
        )
        self.metrics_history_interval_s = float(metrics_history_interval_s)
        self._history_task: Optional[PeriodicTask] = None
        # alerting plane, edge vantage: the same declarative engine the
        # root runs, over this edge's own metric namespace (rules that
        # select rounds.* series simply skip here — the edge keeps no
        # rounds.jsonl tail). No forensics on edges: the deep-capture
        # evidence (profiler, round trace) lives at the root.
        self.alerts_interval_s = float(alerts_interval_s)
        self.alerts = obs_alerts.AlertEngine(
            alert_rules,
            log_path=alerts_log_path,
            metrics=self.metrics,
            node=f"edge:{self.edge_name}",
        )
        self._alerts_task: Optional[PeriodicTask] = None
        self._last_ship_s: Optional[float] = None
        self._pipe = IngestPipeline(
            workers=ingest_workers, queue_depth=ingest_queue_depth,
            fold_shards=1, metrics=self.metrics, tracer=self.tracer,
        )
        self.blob_cache = BlobStore()
        # expected byte sizes from the current envelope (full + deltas):
        # doubles as the cache-retention set at round roll
        self._blob_sizes: Dict[str, int] = {}
        self._blob_waits: Dict[str, asyncio.Future] = {}

        self._workers: Dict[str, _WorkerRoute] = {}
        self._round: Optional[_EdgeRound] = None
        self._chunks: Dict[Tuple[str, str], _ChunkSession] = {}

        # this edge's OWN root credentials (blob fetch, partial upload,
        # trace shipping) — lazily established, rotated on 401
        self.client_id: Optional[str] = None
        self.key: str = ""
        self._register_lock = asyncio.Lock()
        self._closed = False
        self._heartbeat_task: Optional[PeriodicTask] = None
        self.__session: Optional[aiohttp.ClientSession] = None

        r = app.router
        r.add_get(f"/{self.name}/register", self.handle_register)
        r.add_get(f"/{self.name}/heartbeat", self.handle_heartbeat)
        r.add_get(
            f"/{self.name}/round_blob/{{digest}}", self.handle_round_blob
        )
        r.add_post(f"/{self.name}/update", self.handle_update)
        r.add_put(
            f"/{self.name}/update_chunk/{{update_id}}",
            self.handle_update_chunk,
        )
        r.add_get(
            f"/{self.name}/update_chunk/{{update_id}}",
            self.handle_update_chunk_probe,
        )
        r.add_post(f"/{self.name}/trace_spans", self.handle_trace_spans)
        r.add_post(f"/{self.name}/relay/{{tail}}", self.handle_relay)
        r.add_post(f"/{self.name}/edge/{{tail}}", self.handle_edge_callback)
        r.add_get(f"/{self.name}/metrics", self.handle_metrics)
        r.add_get(
            f"/{self.name}/metrics/history", self.handle_metrics_history
        )
        r.add_get(f"/{self.name}/fleet/health", self.handle_fleet_health)
        r.add_get(f"/{self.name}/alerts", self.handle_alerts)
        if auto_start:
            app.on_startup.append(self._on_startup)
            app.on_cleanup.append(self._on_cleanup)

    # -- lifecycle -----------------------------------------------------
    async def _on_startup(self, app=None) -> None:
        asyncio.ensure_future(self._ensure_registered())
        self._heartbeat_task = PeriodicTask(
            self._heartbeat_tick, self.heartbeat_time
        ).start()
        if self.metrics_history_interval_s > 0:
            self._history_task = PeriodicTask(
                self._history_tick, self.metrics_history_interval_s
            ).start()
        if self.alerts.rules and self.alerts_interval_s > 0:
            self._alerts_task = PeriodicTask(
                self._alerts_tick, self.alerts_interval_s
            ).start()

    async def _history_tick(self) -> None:
        self.fleet.export_gauges(self.metrics)
        self.metrics.record_history()

    async def _alerts_tick(self) -> None:
        # advisory plane: a failed evaluation is counted, never raised
        try:
            self.fleet.export_gauges(self.metrics)
            view = obs_alerts.build_metric_view(self.metrics.snapshot())
            self.alerts.evaluate(view, history=self.metrics.history())
        except Exception:
            self.metrics.inc("alerts_eval_errors")
            logging.getLogger(__name__).exception(
                "%s: edge alert evaluation tick failed", self.edge_name
            )

    async def _on_cleanup(self, app=None) -> None:
        self._closed = True
        if self._heartbeat_task is not None:
            await self._heartbeat_task.stop()
        if self._history_task is not None:
            await self._history_task.stop()
        if self._alerts_task is not None:
            await self._alerts_task.stop()
        r = self._round
        if r is not None:
            r.cancel_tasks()
            if not r.shipped and r.contributors:
                self.metrics.inc("edge_partials_abandoned")
        self._pipe.shutdown()
        if self.__session is not None:
            await self.__session.close()

    @property
    def _session(self) -> aiohttp.ClientSession:
        if self.__session is None:
            self.__session = aiohttp.ClientSession()
        return self.__session

    def _creds(self) -> str:
        return f"client_id={self.client_id}&key={self.key}"

    def _invalidate_credentials(self, stale_id: Optional[str]) -> None:
        """Drop credentials observed to 401 — unless a handshake that
        completed during the observing await already replaced them (the
        401 then belonged to the OLD identity and the fresh credentials
        must survive). The compare and the write run loop-atomically,
        so this can never clobber an in-flight ``_register_with_root``
        commit the way a blind ``self.client_id = None`` could."""
        if stale_id is not None and self.client_id == stale_id:
            # guarded by the compare above, not by _register_lock
            self.client_id = None  # batonlint: allow[BTL004]

    async def _ensure_registered(self) -> None:
        if self.client_id is not None:
            return
        await self._register_with_root()

    async def _register_with_root(self) -> None:
        """Register this edge as a root client of its own. The callback
        points at ``/edge/`` — a stub that observes round envelopes and
        politely declines cohort membership with 409 (never 404, which
        would get these credentials dropped)."""
        if self._register_lock.locked():
            # collision guard: piggyback on the in-flight handshake
            async with self._register_lock:
                return
        async with self._register_lock:  # batonlint: allow[BTL002]
            payload = {
                "url": f"http://{self.host}:{self.port}/{self.name}/edge/"
            }
            backoff = 0.5
            while not self._closed:
                try:
                    async with self._session.get(
                        self.root_url + "register", json=payload
                    ) as resp:
                        data = await resp.json()
                        self.client_id = data["client_id"]
                        self.key = data["key"]
                        return
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        RuntimeError, TypeError, KeyError, ValueError):
                    # RuntimeError: session closed mid-shutdown
                    await asyncio.sleep(backoff * (0.5 + random.random() / 2))
                    backoff = min(backoff * 2, MAX_BACKOFF)

    async def _heartbeat_tick(self) -> None:
        """Keep this edge's own registry entry alive (the root TTL-culls
        silent clients, edge included). Single attempt per tick; a 401
        means the root restarted — rejoin with fresh credentials."""
        if self.client_id is None:
            await self._ensure_registered()
            return
        try:
            cid = self.client_id
            with self.metrics.timer("heartbeat_s"):
                async with self._session.get(
                    self.root_url + "heartbeat",
                    json={"client_id": cid, "key": self.key},
                ) as resp:
                    status = resp.status
            if status == 401:
                self._invalidate_credentials(cid)
                await self._ensure_registered()
        except (aiohttp.ClientError, asyncio.TimeoutError):
            pass  # next tick retries; workers fall back direct meanwhile

    # -- membership proxy ----------------------------------------------
    async def handle_register(self, request: web.Request) -> web.Response:
        """Register a worker at the ROOT, substituting this edge's relay
        endpoint as the callback so notify/secure traffic routes back
        through this hop. The response (root credentials) passes through
        untouched — the worker can always fall back to the root with
        the same identity."""
        try:
            data = await read_json_capped(request)
        except BodyTooLarge as exc:
            return web.json_response(
                {"err": "Body Too Large", "limit_bytes": exc.limit},
                status=413,
            )
        # the worker's REAL callback, derived exactly as the root
        # registry would have derived it had the worker gone direct
        worker_url = data.get("url") or (
            f"http://{request.remote}:{data.get('port')}/{self.name}/"
        )
        if not worker_url.endswith("/"):
            worker_url += "/"
        relay = f"http://{self.host}:{self.port}/{self.name}/relay/"
        try:
            async with self._session.get(
                self.root_url + "register", json={"url": relay}
            ) as resp:
                status = resp.status
                payload = await resp.json()
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
            return web.json_response({"err": "Root Unreachable"}, status=502)
        if (
            status == 200
            and isinstance(payload, dict)
            and payload.get("client_id")
        ):
            self._workers[str(payload["client_id"])] = _WorkerRoute(
                url=worker_url, key=str(payload.get("key") or "")
            )
            self.metrics.inc("edge_registers_proxied")
            self.metrics.set_gauge("edge_cohort_size", len(self._workers))
        return web.json_response(payload, status=status)

    async def handle_heartbeat(self, request: web.Request) -> web.Response:
        try:
            data = await read_json_capped(request)
        except BodyTooLarge as exc:
            return web.json_response(
                {"err": "Body Too Large", "limit_bytes": exc.limit},
                status=413,
            )
        try:
            async with self._session.get(
                self.root_url + "heartbeat", json=data
            ) as resp:
                status = resp.status
                body = await resp.read()
                ctype = resp.content_type
        except (aiohttp.ClientError, asyncio.TimeoutError):
            return web.json_response({"err": "Root Unreachable"}, status=502)
        self.metrics.inc("edge_heartbeats_proxied")
        return web.Response(body=body, status=status, content_type=ctype)

    def _auth_worker(self, request: web.Request) -> Optional[str]:
        """client_id when the query credentials match a worker this edge
        registered; None otherwise (the worker re-registers on 401 and
        the route re-forms through whatever tier answered)."""
        cid = request.query.get("client_id", "")
        route = self._workers.get(cid)
        if route is None or not route.key or (
            route.key != request.query.get("key", "")
        ):
            return None
        return cid

    # -- downlink: content-addressed blob cache ------------------------
    async def handle_round_blob(self, request: web.Request) -> web.Response:
        if self._auth_worker(request) is None:
            return web.json_response({"err": "Unauthorized"}, status=401)
        digest = request.match_info["digest"]
        hit = digest in self.blob_cache
        data = await self._ensure_blob(digest, self._blob_sizes.get(digest))
        if data is None:
            return web.json_response({"err": "Unknown Blob"}, status=404)
        if hit:
            self.metrics.inc("edge_blob_hits")
        # Range/ETag semantics mirror handle_round_blob at the root —
        # the worker's resume logic must not care which tier serves it
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
                self.metrics.inc("edge_range_resumes")
        payload = data[start:end]
        self.metrics.inc("edge_bytes_served", len(payload))
        return web.Response(
            body=payload, status=status,
            content_type=wire.CONTENT_TYPE, headers=headers,
        )

    async def _ensure_blob(
        self, digest: str, size: Optional[int]
    ) -> Optional[bytes]:
        """Cache lookup with single-flight root fetch: N workers
        stampeding a cold digest produce ONE upstream download — that
        C→E fan-out collapse is the downlink half of this tier."""
        entry = self.blob_cache.get(digest)
        if entry is not None:
            return entry[0]
        fut = self._blob_waits.get(digest)
        if fut is not None:
            return await asyncio.shield(fut)
        fut = asyncio.get_running_loop().create_future()
        self._blob_waits[digest] = fut
        data: Optional[bytes] = None
        try:
            data = await self._fetch_blob_from_root(digest, size)
            if data is not None:
                self.blob_cache.put(data, kind="full")
                self.metrics.set_gauge(
                    "edge_cache_bytes", self.blob_cache.total_bytes
                )
        finally:
            self._blob_waits.pop(digest, None)
            if not fut.done():
                fut.set_result(data)
        return data

    async def _fetch_blob_from_root(
        self, digest: str, size: Optional[int], max_attempts: int = 6
    ) -> Optional[bytes]:
        """Range-resumable, digest-verified pull of one blob from the
        root (the worker's ``_fetch_blob`` contract, with edge
        credentials). Without a declared size (a digest this edge never
        saw an envelope for) the buffer can't be trusted across
        attempts, so failures restart from zero."""
        await self._ensure_registered()
        buf = bytearray()
        with self.tracer.span(
            "edge_blob_fetch", digest=digest[:12]
        ) as sp, self.metrics.timer("edge_blob_fetch_s"):
            for attempt in range(max_attempts):
                if self._closed:
                    break
                cid = self.client_id
                url = self.root_url + f"round_blob/{digest}?{self._creds()}"
                headers = trace_headers()
                if buf:
                    headers["Range"] = f"bytes={len(buf)}-"
                    self.metrics.inc("edge_range_resumes")
                try:
                    async with self._session.get(
                        url, headers=headers
                    ) as resp:
                        if resp.status == 200 and buf:
                            buf.clear()  # server ignored the Range
                        if resp.status in (200, 206):
                            async for chunk in resp.content.iter_chunked(
                                1 << 16
                            ):
                                buf.extend(chunk)
                                if size is not None and len(buf) > size:
                                    break
                        elif resp.status in (404, 410):
                            sp.set(outcome="gone")
                            self.metrics.inc("edge_blob_fetch_failed")
                            return None
                        elif resp.status == 401:
                            self._invalidate_credentials(cid)
                            await self._ensure_registered()
                            buf.clear()
                except (aiohttp.ClientError, asyncio.TimeoutError):
                    pass
                complete = (
                    len(buf) == size if size is not None else len(buf) > 0
                )
                if complete and (
                    hashlib.sha256(bytes(buf)).hexdigest() == digest
                ):
                    self.metrics.inc("edge_blob_fetches")
                    self.metrics.inc("edge_bytes_fetched", len(buf))
                    sp.set(bytes=len(buf), attempts=attempt + 1)
                    return bytes(buf)
                if size is None or (size is not None and len(buf) >= size):
                    # digest mismatch or unsized partial: unresumable
                    buf.clear()
                await asyncio.sleep(
                    min(0.2 * 2 ** attempt, 2.0) * (0.5 + random.random() / 2)
                )
            sp.set(outcome="exhausted")
        self.metrics.inc("edge_blob_fetch_failed")
        return None

    # -- root→worker relay ---------------------------------------------
    async def handle_relay(self, request: web.Request) -> web.Response:
        """Forward one root→worker control POST (``round_start``,
        ``secure_*``) to the worker the root addressed by query
        ``client_id``. An unknown worker answers 404 ON PURPOSE: the
        root drops the client, its next heartbeat 401s, and it
        re-registers through whichever tier is alive — the stale relay
        route self-heals instead of silently eating notifies."""
        tail = request.match_info["tail"]
        cid = request.query.get("client_id", "")
        route = self._workers.get(cid)
        if route is None:
            return web.json_response({"err": "Unknown Worker"}, status=404)
        try:
            body = await read_body_capped(
                request, self.max_upload_bytes or (1 << 30)
            )
        except BodyTooLarge as exc:
            return web.json_response(
                {"err": "Body Too Large", "limit_bytes": exc.limit},
                status=413,
            )
        if tail == "round_start":
            # learn the round (roll fold state, prefetch the blob)
            # BEFORE forwarding: the worker may start fetching the
            # moment it acks, and the single-flight cache wants the
            # fetch already in motion
            self._observe_envelope(body)
        # re-read after the body-read suspension: the worker may have
        # re-registered (new route) while the POST body streamed in
        route = self._workers.get(cid)
        if route is None:
            return web.json_response({"err": "Unknown Worker"}, status=404)
        ctx = tracing.parse_traceparent(request.headers.get("traceparent"))
        token = tracing.activate(ctx[0], ctx[1]) if ctx is not None else None
        qs = request.query_string
        url = route.url.rstrip("/") + "/" + tail + (f"?{qs}" if qs else "")
        try:
            with self.tracer.span(
                "edge_relay", target=tail, client=cid
            ) as sp, self.metrics.timer("edge_relay_s"):
                try:
                    async with self._session.post(
                        url, data=body,
                        headers=trace_headers({
                            "Content-Type": request.content_type
                            or "application/octet-stream"
                        }),
                    ) as resp:
                        payload = await resp.read()
                        ctype = resp.content_type
                        sp.set(status=resp.status)
                        if tail == "round_start":
                            self.metrics.inc("edge_relay_notifies")
                            r = self._round
                            if resp.status == 200 and r is not None:
                                r.notified.add(cid)
                                self._set_pending_gauge(r)
                        return web.Response(
                            body=payload, status=resp.status,
                            content_type=ctype,
                        )
                except (aiohttp.ClientError, asyncio.TimeoutError):
                    sp.set(status=None)
                    self.metrics.inc("edge_relay_failed")
                    # 502, not 404: a transient worker hiccup must not
                    # get it evicted from the root registry
                    return web.json_response(
                        {"err": "Worker Unreachable"}, status=502
                    )
        finally:
            if token is not None:
                tracing.deactivate(token)

    async def handle_edge_callback(
        self, request: web.Request
    ) -> web.Response:
        """The root's callback endpoint for the edge's OWN registry
        entry. The edge is infrastructure, not a trainer: it declines
        every cohort invitation with 409 (a 404 would drop its
        credentials). A ``round_start`` body is still a fresh envelope
        — observe it opportunistically."""
        if request.match_info["tail"] == "round_start":
            try:
                body = await read_body_capped(
                    request, self.max_upload_bytes or (1 << 30)
                )
            except BodyTooLarge:
                return web.json_response({"err": "Body Too Large"},
                                         status=413)
            self._observe_envelope(body)
        return web.json_response({"err": "Edge Aggregator"}, status=409)

    # -- round state ---------------------------------------------------
    def _observe_envelope(self, body: bytes) -> None:
        """Parse a v2 notify envelope and roll per-round fold state.
        Legacy push bodies (raw tensors) and malformed JSON are ignored
        — uploads for rounds the edge never learned proxy through."""
        try:
            env = json.loads(body.decode("utf-8"))
            round_name = str(env["update_name"])
            n_epoch = int(env["n_epoch"])
            digest = str(env["blob"]["digest"])
            size = int(env["blob"]["size"])
        except (UnicodeDecodeError, ValueError, TypeError, KeyError):
            return
        r = self._round
        if r is not None and r.round_name == round_name:
            return
        if r is not None:
            r.cancel_tasks()
            if not r.shipped and r.contributors:
                # the root rolled the round under our feet (watchdog
                # force-end, abort): the partial can never land
                self.metrics.inc("edge_partials_abandoned")
            self._ledger_round(r)
        secure = env.get("secure") is not None
        encoded = bool(env.get("encoding"))
        r = _EdgeRound(
            round_name, n_epoch, digest, size,
            proxy_only=secure or encoded, secure=secure,
        )
        self._round = r
        # cache retention: this envelope's digests (full + delta hops)
        # survive the roll; everything older is dropped
        sizes: Dict[str, int] = {digest: size}
        for hop in [env.get("delta")] + list(env.get("delta_chain") or []):
            if isinstance(hop, dict):
                try:
                    sizes[str(hop["digest"])] = int(hop["size"])
                except (KeyError, ValueError, TypeError):
                    continue
        self._blob_sizes = sizes
        self.blob_cache.retain(sizes)
        self.metrics.set_gauge(
            "edge_cache_bytes", self.blob_cache.total_bytes
        )
        self._set_pending_gauge(r)
        r.deadline_task = asyncio.ensure_future(
            self._ship_later(r, self.flush_after_s, force=True)
        )
        if not r.proxy_only:
            asyncio.ensure_future(self._prepare_round(r))

    async def _prepare_round(self, r: _EdgeRound) -> None:
        """Prefetch the round blob and decode the dense validation
        template the fold path checks shapes against. A failed prefetch
        degrades the round to proxy-only — never blocks it."""
        try:
            t_fetch0 = time.monotonic()
            data = await self._ensure_blob(r.digest, r.size)
            r.fetch_s = time.monotonic() - t_fetch0
            if data is not None:
                r.template = (await asyncio.to_thread(wire.decode, data))[0]
            else:
                r.proxy_only = True
        except Exception:
            r.proxy_only = True
        finally:
            r.template_ready.set()

    def _set_pending_gauge(self, r: _EdgeRound) -> None:
        self.metrics.set_gauge(
            "edge_round_pending",
            max(0, len(r.notified - set(r.contributors))),
        )

    def _ledger_round(self, r: _EdgeRound) -> None:
        """Fold one retired round into this edge's cohort ledger:
        contributors reported (with their self-reported timings and
        body size), notified-but-silent workers straggled. Best-effort
        — health accounting must never break a round roll."""
        if not r.notified and not r.contributors:
            return
        try:
            responses = {
                cid: {
                    "n_samples": c.get("n_samples"),
                    "loss_history": c.get("loss_history"),
                    "upload_bytes": c.get("bytes"),
                    "timings": c.get("timings"),
                    "compute": c.get("compute"),
                }
                for cid, c in r.contributors.items()
            }
            self.fleet.record_round(
                r.round_name, r.notified, r.notified, responses
            )
        except Exception:
            logging.getLogger(__name__).exception(
                "edge fleet ledger record failed"
            )

    # -- uplink: cohort ingest + fold ----------------------------------
    async def handle_update(self, request: web.Request) -> web.Response:
        cid = self._auth_worker(request)
        if cid is None:
            return web.json_response({"err": "Unauthorized"}, status=401)
        try:
            body = await read_body_capped(request, self.max_upload_bytes)
        except BodyTooLarge:
            return web.json_response({"err": "Payload Too Large"},
                                     status=413)
        ctx = tracing.parse_traceparent(request.headers.get("traceparent"))
        if ctx is None:
            return await self._ingest_cohort_update(
                cid, body, request.content_type
            )
        with self.tracer.span(
            "edge_ingest", trace_id=ctx[0], parent_id=ctx[1],
            client=cid, bytes=len(body),
        ):
            return await self._ingest_cohort_update(
                cid, body, request.content_type
            )

    async def _ingest_cohort_update(
        self, client_id: str, body: bytes, content_type
    ) -> web.Response:
        """Decode off-loop, then fold into the round partial — or proxy
        upstream when this edge cannot own the update (unknown round,
        compressed body, already shipped). Masked bodies 409: the
        worker pins those direct, so an arrival here is a downgrade
        guard firing, not a route."""

        def decode():
            tensors, meta = wire.decode_any(
                body, content_type, allow_pickle=False
            )
            return tensors, meta

        fut = self._pipe.submit_decode(decode)
        if fut is None:
            return web.json_response(
                {"err": "Ingest Queue Full"}, status=429,
                headers={"Retry-After": "1"},
            )
        try:
            tensors, meta = await fut
        except asyncio.CancelledError:
            raise
        except Exception:
            return web.json_response({"err": "Bad Payload"}, status=400)

        # round snapshot taken AFTER the decode suspension: a roll that
        # landed mid-decode must route this update against the round
        # that is actually open now
        r = self._round
        if meta.get("secure") or (r is not None and r.secure):
            # partial-folding ring elements breaks unmasking — refuse
            # loudly; the worker's 409 handler marks this route down
            # and re-delivers direct to the root
            self.metrics.inc("edge_updates_refused_secure")
            return web.json_response(
                {"err": "Secure Round Requires Direct Upload"}, status=409
            )
        round_name = str(meta.get("update_name") or "")
        if (
            r is None
            or r.proxy_only
            or r.shipped
            or r.shipping
            or round_name != r.round_name
            or meta.get("compressed")
        ):
            return await self._proxy_update(client_id, body, content_type)
        try:
            # the only await between the snapshot and here is a
            # return-await in the branch above (branch-sensitive BTL003
            # knows that path cannot fall through); staleness is
            # re-checked with the identity test right after this wait
            await asyncio.wait_for(
                r.template_ready.wait(), timeout=30.0
            )
        except asyncio.TimeoutError:
            return await self._proxy_update(client_id, body, content_type)
        if (
            self._round is not r or r.template is None or r.shipped
            or r.shipping
        ):
            # the round rolled (or the partial started shipping) while
            # we waited on the template: the root owns this update now
            return await self._proxy_update(client_id, body, content_type)

        try:
            n_samples = float(meta.get("n_samples", 0))
            losses = [float(x) for x in meta.get("loss_history", [])]
            update_id = (
                str(meta["update_id"]) if meta.get("update_id") else None
            )
        except (TypeError, ValueError):
            return web.json_response({"err": "Bad Payload"}, status=400)
        if not (n_samples > 0) or not np.isfinite(n_samples):
            return web.json_response({"err": "Bad Payload"}, status=400)
        for k, ref in r.template.items():
            v = tensors.get(k)
            if v is None or tuple(np.shape(v)) != tuple(np.shape(ref)):
                return web.json_response({"err": "Bad Payload"}, status=400)

        if update_id is not None and update_id in r.update_ids:
            # at-least-once redelivery of an already-folded update
            return web.Response(text="OK")
        if client_id in r.contributors:
            # same client, NEW update id: first accepted result wins
            # (mirrors the root's repeat_updates_ignored contract)
            return web.Response(text="OK")

        # acceptance point: ALL bookkeeping (including the pending-fold
        # increment) lands before the await so a ship racing this
        # accept either sees shipping already set (we proxied above) or
        # drains our fold before computing the partial mean
        if update_id is not None:
            r.update_ids.add(update_id)
        entry = {
            "n_samples": n_samples,
            "update_id": update_id,
            "loss_history": losses,
            "bytes": len(body),
        }
        timings = meta.get("timings")
        if isinstance(timings, dict):
            # worker self-reported wall times, shipped upstream in the
            # partial's contributor set (the root sanitizes values)
            entry["timings"] = timings
        compute = meta.get("compute")
        if isinstance(compute, dict):
            # per-round compute record (obs/compute.py) — same contract
            # as timings: pass through verbatim, the root sanitizes
            entry["compute"] = compute
        r.contributors[client_id] = entry
        r.pending_folds += 1
        self.metrics.inc("edge_updates_folded")
        self._set_pending_gauge(r)
        template = r.template

        def fold():
            t_fold0 = time.perf_counter()
            payload = {
                k: np.asarray(tensors[k], np.float32) for k in template
            }
            r.acc.add(payload, n_samples)
            # fold_shards=1: one fold worker, so += never races
            r.fold_s += time.perf_counter() - t_fold0

        try:
            await self._pipe.submit_fold(0, fold)
        finally:
            r.pending_folds -= 1
        self._maybe_ship(r)
        return web.Response(text="OK")

    async def _proxy_update(
        self, client_id: str, body: bytes, content_type
    ) -> web.Response:
        """Pass one update through to the root under the WORKER's own
        credentials (the root registered it; the edge only relayed).
        A transport failure answers 409 so the worker marks this route
        down and re-delivers direct."""
        route = self._workers.get(client_id)
        if route is None:
            return web.json_response({"err": "Unauthorized"}, status=401)
        url = (
            self.root_url
            + f"update?client_id={client_id}&key={route.key}"
        )
        try:
            async with self._session.post(
                url, data=body,
                headers=trace_headers({
                    "Content-Type": content_type or wire.CONTENT_TYPE
                }),
            ) as resp:
                payload = await resp.read()
                self.metrics.inc("edge_updates_proxied")
                return web.Response(
                    body=payload, status=resp.status,
                    content_type=resp.content_type,
                )
        except (aiohttp.ClientError, asyncio.TimeoutError):
            return web.json_response(
                {"err": "Root Unreachable Via Edge"}, status=409
            )

    # -- uplink: chunked reassembly (worker→edge) ----------------------
    async def handle_update_chunk(
        self, request: web.Request
    ) -> web.Response:
        """Same offset-committed contract as the root's chunk endpoint;
        the assembled body enters :meth:`_ingest_cohort_update` exactly
        as a single POST would have."""
        cid = self._auth_worker(request)
        if cid is None:
            return web.json_response({"err": "Unauthorized"}, status=401)
        update_id = request.match_info["update_id"]
        try:
            offset = int(request.query["offset"])
            total = int(request.query["total"])
        except (KeyError, ValueError):
            return web.json_response({"err": "Bad Chunk Framing"},
                                     status=400)
        if total <= 0 or offset < 0 or offset > total:
            return web.json_response({"err": "Bad Chunk Framing"},
                                     status=400)
        if self.max_upload_bytes is not None and total > self.max_upload_bytes:
            return web.json_response({"err": "Payload Too Large"},
                                     status=413)
        key = (cid, update_id)
        sess = self._chunks.get(key)
        if sess is None:
            if offset != 0:
                return web.json_response(
                    {"err": "Unknown Chunk Session", "offset": 0}, status=409
                )
            sess = _ChunkSession(cid, update_id, total)
            sess.content_type = request.content_type or wire.CONTENT_TYPE
            self._chunks[key] = sess
        if sess.total != total:
            self._chunks.pop(key, None)
            return web.json_response({"err": "Inconsistent Total"},
                                     status=400)
        if sess.busy:
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
                return web.json_response({"err": "Chunk Overruns Total"},
                                         status=413)
            sess.buf.extend(chunk)
            if sess.offset < sess.total:
                return web.json_response({"offset": sess.offset})
            ctx = tracing.parse_traceparent(
                request.headers.get("traceparent")
            )
            if ctx is None:
                resp = await self._ingest_cohort_update(
                    cid, bytes(sess.buf), sess.content_type
                )
            else:
                with self.tracer.span(
                    "edge_ingest", trace_id=ctx[0], parent_id=ctx[1],
                    client=cid, bytes=sess.total, chunked=True,
                ):
                    resp = await self._ingest_cohort_update(
                        cid, bytes(sess.buf), sess.content_type
                    )
        finally:
            sess.busy = False
        if resp.status == 429:
            return resp  # keep the session; the retry re-sends one frame
        self._chunks.pop(key, None)
        return resp

    async def handle_update_chunk_probe(
        self, request: web.Request
    ) -> web.Response:
        cid = self._auth_worker(request)
        if cid is None:
            return web.json_response({"err": "Unauthorized"}, status=401)
        sess = self._chunks.get((cid, request.match_info["update_id"]))
        offset = sess.offset if sess is not None else 0
        return web.json_response(
            {"offset": offset, "total": sess.total if sess else None},
            headers={"Upload-Offset": str(offset)},
        )

    # -- ship: one partial upstream ------------------------------------
    def _maybe_ship(self, r: _EdgeRound) -> None:
        """Arm the settle timer once every notified worker has
        reported. The delay absorbs a straggler notify landing just
        after the last accept; the ``flush_after_s`` deadline task
        bounds the wait when part of the cohort never reports."""
        if r.shipped or r.shipping:
            return
        if not r.notified or not (
            r.notified <= set(r.contributors)
        ):
            return
        if r.settle_task is not None and not r.settle_task.done():
            r.settle_task.cancel()
        r.settle_task = asyncio.ensure_future(
            self._ship_later(r, self.ship_settle_s)
        )

    async def _ship_later(
        self, r: _EdgeRound, delay: float, force: bool = False
    ) -> None:
        try:
            await asyncio.sleep(delay)
        except asyncio.CancelledError:
            return
        if r.shipped or r.shipping or self._round is not r:
            return
        if not force and not (
            r.notified and r.notified <= set(r.contributors)
        ):
            return
        await self._ship_partial(r)

    async def _ship_partial(self, r: _EdgeRound) -> None:
        """Encode the partial (cohort mean + Σ weight + contributor
        set) and deliver it upstream as ONE update. 200 from the root
        is the cohort's acceptance; anything terminal still marks the
        round shipped so stragglers proxy through instead of folding
        into a partial that will never leave."""
        if r.shipped or r.shipping:
            return
        # from this point every new upload proxies through (the ingest
        # path checks `shipping`), so contributors/acc only have to
        # settle, not stay open
        r.shipping = True
        try:
            if not r.contributors:
                r.shipped = True
                return
            # drain accepts whose fold is still queued in the pipeline:
            # they are already in `contributors`, so the mean must
            # include their tensors or the root would credit clients
            # this partial never aggregated
            for _ in range(3000):
                if not r.pending_folds:
                    break
                await asyncio.sleep(0.01)
            mean = await asyncio.to_thread(r.acc.mean)
            if mean is None:
                r.shipped = True
                return
            # per-round phase wall times for the root's SLO counter
            # deltas. "settle" is envelope→ship-start (fold + wait);
            # "ship_prev" is the PREVIOUS round's measured upstream
            # delivery — this round's isn't known until after encode.
            phase_s = {
                "fold": round(r.fold_s, 6),
                "blob_fetch": round(r.fetch_s, 6),
                "settle": round(time.monotonic() - r.t0, 6),
            }
            if self._last_ship_s is not None:
                phase_s["ship_prev"] = round(self._last_ship_s, 6)
            meta = {
                "update_name": r.round_name,
                "n_samples": float(r.acc.total_weight),
                "loss_history": [],
                "update_id": r.ship_update_id,
                "edge_partial": {
                    "edge": self.edge_name,
                    "contributors": r.contributors,
                    "phase_s": phase_s,
                },
            }
            body = await asyncio.to_thread(wire.encode, mean, meta)
            trace_id = tracing.make_trace_id(self.name, r.round_name)
            with self.tracer.span(
                "edge_partial_upload", trace_id=trace_id,
                parent_id=tracing.root_span_id(trace_id),
                round=r.round_name, contributors=len(r.contributors),
                bytes=len(body),
            ) as sp, self.metrics.timer("edge_partial_ship_s"):
                t_ship0 = time.monotonic()
                status = await self._deliver_upstream(body, r.ship_update_id)
                self._last_ship_s = time.monotonic() - t_ship0
                sp.set(status=status)
            r.shipped = True
            if status == 200:
                self.metrics.inc("edge_partials_shipped")
            elif status == 409:
                # the root refuses partials for this round (secure or
                # buffered aggregation): misconfiguration made visible
                self.metrics.inc("edge_partial_refused")
            else:
                self.metrics.inc("edge_partial_ship_failed")
            self._set_pending_gauge(r)
            asyncio.ensure_future(self._ship_spans(trace_id))
        finally:
            r.shipping = False

    async def _deliver_upstream(
        self, body: bytes, update_id: str, max_attempts: int = 6
    ) -> Optional[int]:
        """Deliver the encoded partial to the root with bounded retries
        — chunked when configured and the body is large, single POST
        otherwise. Returns the final HTTP status (None = transport
        failure exhausted the attempts)."""
        backoff = 0.5
        status: Optional[int] = None
        for _ in range(max_attempts):
            if self._closed:
                return status
            await self._ensure_registered()
            cid = self.client_id
            retry_after: Optional[float] = None
            chunked = (
                self.upload_chunk_bytes is not None
                and len(body) > self.upload_chunk_bytes
            )
            if chunked:
                status, retry_after = await self._ship_chunked(
                    body, update_id
                )
            else:
                url = self.root_url + f"update?{self._creds()}"
                try:
                    async with self._session.post(
                        url, data=body,
                        headers=trace_headers(
                            {"Content-Type": wire.CONTENT_TYPE}
                        ),
                    ) as resp:
                        status = resp.status
                        ra = resp.headers.get("Retry-After")
                        try:
                            retry_after = float(ra) if ra else None
                        except ValueError:
                            retry_after = None
                except (aiohttp.ClientError, asyncio.TimeoutError):
                    status = None
            if status in (200, 400, 409, 410, 413):
                return status  # terminal either way
            if status == 401:
                # root restarted: rejoin and retry (no-op if a parallel
                # task already re-registered during our await)
                self._invalidate_credentials(cid)
            delay = backoff * (0.5 + random.random() / 2)
            if retry_after is not None:
                delay = max(delay, retry_after)
            await asyncio.sleep(delay)
            backoff = min(backoff * 2, MAX_BACKOFF)
        return status

    async def _ship_chunked(
        self, body: bytes, update_id: str
    ) -> Tuple[Optional[int], Optional[float]]:
        """One chunked delivery attempt against the root's resumable
        endpoint (probe → ordered PUTs, 409 = authoritative offset
        resync) — the worker's algorithm with edge credentials."""
        total = len(body)
        base = (
            self.root_url + f"update_chunk/{update_id}?{self._creds()}"
        )
        try:
            async with self._session.get(
                base, headers=trace_headers()
            ) as resp:
                if resp.status == 401:
                    return 401, None
                if resp.status == 200:
                    data = await resp.json()
                    offset = max(0, min(int(data.get("offset", 0)), total))
                else:
                    offset = 0
        except (aiohttp.ClientError, asyncio.TimeoutError,
                TypeError, ValueError):
            return None, None
        resyncs = 0
        while True:
            end = min(offset + int(self.upload_chunk_bytes), total)
            url = base + f"&offset={offset}&total={total}"
            try:
                async with self._session.put(
                    url, data=body[offset:end],
                    headers=trace_headers(
                        {"Content-Type": wire.CONTENT_TYPE}
                    ),
                ) as resp:
                    if resp.status == 409:
                        resyncs += 1
                        if resyncs > 8:
                            return None, None
                        try:
                            data = await resp.json()
                            offset = max(
                                0, min(int(data.get("offset", 0)), total)
                            )
                        except (TypeError, ValueError):
                            return None, None
                        continue
                    if resp.status != 200:
                        ra = resp.headers.get("Retry-After")
                        try:
                            return resp.status, float(ra) if ra else None
                        except ValueError:
                            return resp.status, None
                    if end >= total:
                        return 200, None
                    try:
                        data = await resp.json()
                        offset = min(
                            total, max(end, int(data.get("offset", end)))
                        )
                    except (TypeError, ValueError):
                        offset = end
            except (aiohttp.ClientError, asyncio.TimeoutError):
                return None, None

    # -- tracing -------------------------------------------------------
    async def handle_trace_spans(self, request: web.Request) -> web.Response:
        """Pass worker span batches through to the root untouched (the
        query already carries the worker's root credentials)."""
        try:
            body = await read_body_capped(request, 8 << 20)
        except BodyTooLarge:
            return web.json_response({"err": "Body Too Large"}, status=413)
        qs = request.query_string
        url = self.root_url + "trace_spans" + (f"?{qs}" if qs else "")
        try:
            async with self._session.post(
                url, data=body,
                headers={"Content-Type": "application/json"},
            ) as resp:
                payload = await resp.read()
                return web.Response(
                    body=payload, status=resp.status,
                    content_type=resp.content_type,
                )
        except (aiohttp.ClientError, asyncio.TimeoutError):
            return web.json_response({"err": "Root Unreachable"}, status=502)

    async def _ship_spans(self, trace_id: str) -> None:
        """Ship this edge's own finished spans for one round upstream —
        best-effort, after the partial lands, so the root's trace
        endpoint can serve the whole tree in one document."""
        spans = self.tracer.drain(trace_id)
        if not spans:
            return
        url = self.root_url + f"trace_spans?{self._creds()}"
        try:
            async with self._session.post(url, json=spans) as resp:
                if resp.status == 200:
                    self.metrics.inc("trace_spans_shipped", len(spans))
                else:
                    self.metrics.inc("trace_ship_failed")
        except (aiohttp.ClientError, asyncio.TimeoutError):
            self.metrics.inc("trace_ship_failed")

    # -- observability -------------------------------------------------
    async def handle_metrics(self, request: web.Request) -> web.Response:
        self.fleet.export_gauges(self.metrics)
        snap = self.metrics.snapshot()
        snap["edge"] = {
            "edge_name": self.edge_name,
            "workers": len(self._workers),
            "round": self._round.round_name if self._round else None,
            "round_shipped": self._round.shipped if self._round else None,
            "cache_bytes": self.blob_cache.total_bytes,
        }
        return web.json_response(snap)

    async def handle_metrics_history(
        self, request: web.Request
    ) -> web.Response:
        hist = self.metrics.history()
        return web.json_response({
            "interval_s": self.metrics_history_interval_s,
            "samples": len(hist),
            "history": hist,
        })

    async def handle_fleet_health(
        self, request: web.Request
    ) -> web.Response:
        return web.json_response(json_clean(self.fleet.health_snapshot()))

    async def handle_alerts(self, request: web.Request) -> web.Response:
        """``GET /{name}/alerts`` — this edge's rule states (same
        payload shape as the root's endpoint)."""
        return web.json_response(json_clean(self.alerts.status_snapshot()))
