"""HTTP worker runtime — a real (non-simulated) federated client
(the port of ``baton_tpu/server/http_worker.py``: the same code with torch
at the JAX seams; it trains on ``device``, the card by default).

Reference counterpart: worker.py:12-127. Same lifecycle — register with
the manager, heartbeat on a period, accept ``round_start`` broadcasts,
train locally, POST the result to ``update`` — with the recorded fixes
(SURVEY §2.9):

* item 5 FIXED — ``round_in_progress`` is actually set/cleared, so the
  409 duplicate-round guard works (it was dead code in the reference).
* item 7 FIXED — training runs via ``asyncio.to_thread`` (and torch's
  kernels release the GIL), so heartbeats keep flowing mid-round; the
  reference blocked its event loop for the whole local run.
* Heartbeat backoff is capped exponential (reference doubled unboundedly,
  worker.py:78 ``# TODO: better backoff``).
* At-least-once uploads: a trained update is parked in a one-slot
  outbox and retried with capped exponential backoff + jitter until the
  manager answers 200 (delivered) or 410 (round dead — abandoned), a
  401 triggering re-registration in between. The reference — and the
  seed before this — dropped the whole round's training on the first
  failed POST. Every upload carries a fresh ``update_id`` so the
  manager dedupes redelivery (a 200 lost in transit must not
  double-count the client's samples in the aggregate).
* Weights travel as BTW1 tensors, not pickles (pickle decode opt-in).
* Pull data plane (v2): ``round_start`` delivers a small JSON envelope
  naming the round blob by sha256 digest; the worker fetches it from
  ``GET /{name}/round_blob/{digest}`` with HTTP Range resume across
  connection drops, or reconstructs it from the previous round's
  anchor plus a delta blob when the manager offers one (full-blob
  fallback on any digest mismatch). Legacy whole-model push bodies are
  still accepted on the same route.
* Mid-training visibility (reference utils.py:70-91 streams tqdm batch
  progress + a running loss): the multi-epoch run reports each
  finished epoch from the training thread via a progress hook
  (core/training.py::LocalTrainer.progress_fn) into a :class:`Metrics`
  registry served live at ``GET /{name}/metrics`` — gauges
  ``train_epoch`` / ``train_epoch_loss`` update *during* the round.

The training itself is the port's :class:`LocalTrainer` on ``device``.
Init comes from a ``torch.Generator`` seeded by ``rng_seed`` and every
round's shuffles from a second one seeded by ``rng_seed + 1``: several
workers share one process (and one card) from their training threads, so
nothing draws from torch's global generator. With ``compress=`` the
round delta (trained params less the broadcast anchor) is taken on
``device``, so its top-k runs where the params are; masks, shares and
delta reconstructions are numpy on the host, as in the reference.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import os
import pathlib
import random
import secrets
import time
import weakref
from typing import Callable, Optional, Tuple

import aiohttp
from aiohttp import web
import numpy as np
import torch

from baton_tpu_torch import resolve_device
from baton_tpu_torch.core.model import FedModel
from baton_tpu_torch.core.training import LocalTrainer, make_local_trainer
from baton_tpu_torch.obs.compute import ComputeProbe
from baton_tpu_torch.ops.padding import pad_dataset, round_up
from baton_tpu_torch.server import wire
from baton_tpu_torch.server.state import params_to_state_dict, state_dict_to_params
from baton_tpu_torch.server.utils import (
    BodyTooLarge,
    PeriodicTask,
    random_key,
    read_body_capped,
    read_json_capped,
)
from baton_tpu_torch.utils import profiling, tracing
from baton_tpu_torch.utils.metrics import Metrics
from baton_tpu_torch.utils.tracing import trace_headers

GetData = Callable[[], Tuple[dict, int]]
MAX_BACKOFF = 60.0


@dataclasses.dataclass
class _PendingUpdate:
    """One-slot durable outbox entry: the encoded upload for the round
    in flight, kept until the manager acks (200) or declares the round
    dead (410). ``compressed_template`` is the pre-compression delta —
    needed to fold the kept mass back into the error-feedback residual
    if the update is abandoned rather than delivered."""

    round_name: str
    update_id: str
    body: bytes
    compressed_template: Optional[dict] = None
    attempts: int = 0
    # masked (secure-aggregation) bodies are pinned to the direct root
    # route: an edge partial-folding ring elements would break unmasking
    masked: bool = False


def _host(t: torch.Tensor, dtype=None) -> np.ndarray:
    """A device tensor as a host numpy array (for the wire)."""
    arr = t.detach().cpu().numpy()
    return arr if dtype is None else arr.astype(dtype, copy=False)


def _parse_compress(spec: Optional[str], seed: int = 0):
    """``"topk:<frac>[:q8|q16]"`` -> ErrorFeedbackCompressor, else None.
    ``seed`` decorrelates the stochastic quantizer across workers."""
    if spec is None:
        return None
    from baton_tpu_torch.ops.compression import ErrorFeedbackCompressor

    parts = spec.split(":")
    if parts[0] != "topk" or len(parts) not in (2, 3):
        raise ValueError(
            f"unknown compress spec {spec!r}; expected 'topk:<frac>[:q8|q16]'"
        )
    frac = float(parts[1])
    if not (0.0 < frac <= 1.0):
        # fail at construction: inside the round task this would only
        # surface as a permanent silent straggler
        raise ValueError(f"compress fraction must be in (0, 1], got {frac}")
    bits = None
    if len(parts) == 3:
        if parts[2] not in ("q8", "q16"):
            raise ValueError(f"unknown quantizer {parts[2]!r} in {spec!r}")
        bits = int(parts[2][1:])
    return ErrorFeedbackCompressor(frac=frac, bits=bits, seed=seed)


class ExperimentWorker:
    """Subclass and implement ``get_data() -> (data_dict, n_samples)``
    (reference worker.py:126-127), or pass ``get_data=`` callable."""

    def __init__(
        self,
        app: web.Application,
        model: FedModel,
        manager: str,
        name: Optional[str] = None,
        port: int = 8080,
        heartbeat_time: float = 60.0,
        worker_host: Optional[str] = None,
        trainer: Optional[LocalTrainer] = None,
        get_data: Optional[GetData] = None,
        allow_pickle: bool = False,
        rng_seed: int = 0,
        auto_register: bool = True,
        compress: Optional[str] = None,
        outbox_backoff: Tuple[float, float] = (0.25, 10.0),
        outbox_dir: Optional[str] = None,
        upload_chunk_bytes: Optional[int] = None,
        max_broadcast_bytes: Optional[int] = 1 << 30,
        train_time_scale: float = 1.0,
        edge: Optional[str] = None,
        edge_retry_s: float = 10.0,
        failover: Optional[list] = None,
        device="cuda",
    ):
        """``device``: where the params live and training runs (the card
        by default; ``"cpu"`` must be asked for).

        ``compress`` turns on sparse round-delta uploads
        (ops/compression.py): ``"topk:0.05"`` keeps the top 5% of delta
        coordinates per tensor with error feedback across rounds;
        ``"topk:0.05:q8"`` additionally quantizes kept values to int8.
        Ignored for secure rounds (masking needs dense ring elements).

        ``outbox_backoff``: ``(base, cap)`` seconds for the upload retry
        schedule — capped exponential with jitter.

        ``outbox_dir``: persist the one-slot outbox to disk (the encoded
        upload body as a BTW1 file + a meta JSON). A worker that crashes
        between training and delivery reloads the slot on startup and
        delivers the round's work after restart — closing the ROADMAP
        worker-crash gap. The error-feedback compressor residual is NOT
        persisted: after a crash-reload an abandoned update's kept mass
        cannot be folded back (only delayed-delivery is durable).

        ``upload_chunk_bytes``: updates larger than this are delivered
        as offset/total-framed ``PUT update_chunk`` frames with a
        committed-offset probe, so a transfer that dies at 90% resumes
        from the manager's committed prefix on the outbox's next
        attempt instead of re-sending the whole body. ``None`` (the
        default) keeps the single-POST path for every size.

        ``max_broadcast_bytes``: cap on an inline ``round_start`` body
        (the v1 push path; v2 pull rounds carry only a small envelope).
        Oversized broadcasts get a 413 instead of an unbounded buffer.
        ``None`` disables the cap. Default 1 GiB — far above any real
        model push, low enough to bound a misbehaving peer.

        ``edge``: ``"host:port"`` of an edge aggregator
        (server/edge.py) to route control and data traffic through —
        register, heartbeat, blob fetch, plain uploads, span shipping.
        The edge serves round blobs from its local cache and folds the
        cohort's updates into one upstream partial. On any transport
        failure at the edge, the worker marks the route down for
        ``edge_retry_s`` seconds and falls back DIRECT to the root
        (credentials are root credentials either way — the edge only
        proxies registration), so a dead edge degrades fan-in instead
        of stalling rounds. Masked (secure-aggregation) uploads always
        go direct regardless.

        ``failover``: additional root ``"host:port"`` addresses (warm
        standbys / other replicas, server/replication.py). Any direct-
        root transport failure or 503 (a standby refusing to serve)
        rotates to the next address; a heartbeat answered 307 (the
        experiment was resharded to another replica) retargets every
        subsequent call to the redirect's URL. The at-least-once outbox
        then redelivers the parked update to the new active — which
        either reuses the journaled copy (dedup by update_id) or
        ingests this one.

        ``train_time_scale``: simulated device-speed multiplier, >= 1.0.
        After real training finishes, the worker idles inside the
        ``local_train`` span until the round's compute has taken
        ``scale ×`` its measured wall time — a 3.0 worker behaves like
        hardware 3× slower without burning 3× the CPU. Load-generation
        knob (stragglers, heterogeneous fleets); 1.0 = off."""
        self.device = resolve_device(device)
        self.name = name or getattr(model, "name", "fedmodel")
        self.model = model
        self.metrics = Metrics()
        # last successful heartbeat round-trip, piggybacked on update
        # metadata so the manager's fleet ledger sees link latency
        self._last_hb_rtt: Optional[float] = None
        # span recorder for this worker's half of each round's trace;
        # the label is upgraded to the registered client_id so traces
        # name workers the way the manager's round state does
        self.tracer = tracing.Tracer(
            service=f"worker#{os.urandom(2).hex()}"
        )
        if trainer is None:
            # default trainer gets the per-epoch metrics heartbeat (module
            # docstring). A USER-supplied trainer is kept verbatim (it
            # may be shared by several workers) — call
            # enable_progress_metrics() to opt a custom trainer in.
            self.trainer = self._with_progress_hook(make_local_trainer(model))
        else:
            self.trainer = trainer
        # compute-plane probe (obs/compute.py): one record per round —
        # compile tracking keyed on the trainer's shape signature, MFU
        # when the model family has FLOPs accounting, null-with-reason
        # otherwise. The record rides update meta to the manager.
        self.compute_probe = ComputeProbe(model=model)
        self.app = app
        self.port = port
        self.worker_host = worker_host
        self.manager = manager
        # direct-root route ring: the configured manager first, then the
        # failover replicas; _root_idx rotates on transport failure/503,
        # _root_override (full base URL) is pinned by a 307 redirect
        self._root_urls = [
            f"http://{m}/{self.name}/"
            for m in [manager] + [str(x) for x in (failover or []) if x]
        ]
        self._root_idx = 0
        self._root_override: Optional[str] = None
        self.edge_url = f"http://{edge}/{self.name}/" if edge else None
        self.edge_retry_s = float(edge_retry_s)
        # monotonic deadline until which the edge route is considered
        # down (0.0 = up); flipped by _edge_failed on transport errors
        self._edge_down_until = 0.0
        self.allow_pickle = allow_pickle
        self.compressor = _parse_compress(compress, seed=rng_seed)
        self._round_anchor: Optional[dict] = None
        # v2 pull data plane: the last dense round blob we hold, by
        # digest — advertised implicitly (the manager's envelope names
        # the delta's base digest; we apply it only if it matches)
        self._anchor_sd: Optional[dict] = None
        self._anchor_digest: Optional[str] = None
        if get_data is not None:
            self.get_data = get_data  # type: ignore[assignment]

        init_gen = torch.Generator().manual_seed(rng_seed)
        self.params = {
            k: v.to(self.device) for k, v in model.init(init_gen).items()
        }
        # the per-epoch shuffles of every round (the reference splits a
        # JAX key per round; one explicit generator advances instead)
        self.rng = torch.Generator().manual_seed(rng_seed + 1)

        self.client_id: Optional[str] = None
        self.key: Optional[str] = None
        self.n_updates = 0
        self.round_in_progress = False
        self.outbox_backoff = outbox_backoff
        self.outbox_dir = outbox_dir
        if upload_chunk_bytes is not None and upload_chunk_bytes < 1:
            raise ValueError(
                f"upload_chunk_bytes must be >= 1 or None, "
                f"got {upload_chunk_bytes}"
            )
        self.upload_chunk_bytes = upload_chunk_bytes
        if max_broadcast_bytes is not None and max_broadcast_bytes < 1:
            raise ValueError(
                f"max_broadcast_bytes must be >= 1 or None, "
                f"got {max_broadcast_bytes}"
            )
        self.max_broadcast_bytes = max_broadcast_bytes
        if not train_time_scale >= 1.0:
            raise ValueError(
                f"train_time_scale must be >= 1.0 (a simulated device "
                f"cannot outrun the real one), got {train_time_scale}"
            )
        self.train_time_scale = float(train_time_scale)
        self._pending: Optional[_PendingUpdate] = self._load_persisted()
        if self._pending is not None:
            self.metrics.set_gauge("outbox_pending", 1)
            self.metrics.inc("outbox_reloaded_from_disk")
        self._outbox_task: Optional[asyncio.Task] = None
        self._ship_task: Optional[asyncio.Task] = None
        # guards the broadcast handler's await windows (body read, boxed-
        # share decryption in a worker thread): a duplicate round_start
        # arriving mid-handler must 409 exactly like one arriving
        # mid-training, or two training tasks would stack (§2.9 item 5)
        self._broadcast_busy = False
        self.last_update: Optional[str] = None
        self.heartbeat_time = heartbeat_time
        self._heartbeat_task: Optional[PeriodicTask] = None
        self._register_lock = asyncio.Lock()
        self.__session: Optional[aiohttp.ClientSession] = None

        # secure aggregation (server/secure.py, Bonawitz double masking):
        # one state dict per round_name, bounded to the two most recent
        # rounds so a long-lived worker doesn't accumulate key material.
        self._secure: dict = {}
        # (round_name, state) captured at broadcast time; report_update
        # masks with THIS object and refuses to upload if the live
        # registry was re-keyed underneath it (abort/restart TOCTOU) —
        # never silently falls back to an unmasked upload.
        self._broadcast_secure_st: Optional[tuple] = None

        app.router.add_get(f"/{self.name}/metrics", self.handle_metrics)
        app.router.add_post(f"/{self.name}/round_start", self.handle_round_start)
        app.router.add_post(f"/{self.name}/secure_keys", self.handle_secure_keys)
        app.router.add_post(f"/{self.name}/secure_shares", self.handle_secure_shares)
        app.router.add_post(f"/{self.name}/secure_unmask", self.handle_secure_unmask)
        if auto_register:
            app.on_startup.append(self._on_startup)
            app.on_cleanup.append(self._on_cleanup)

    async def _on_startup(self, app=None) -> None:
        asyncio.ensure_future(self.register_with_manager())
        if self._pending is not None and (
            self._outbox_task is None or self._outbox_task.done()
        ):
            # a disk-reloaded outbox slot: deliver the pre-crash round's
            # trained update as soon as registration lands (the drain
            # loop's 401 path re-registers as needed)
            self._outbox_task = asyncio.ensure_future(self._drain_outbox())

    async def _on_cleanup(self, app=None) -> None:
        if self._heartbeat_task is not None:
            # cancel, not wait: a heartbeat tick retries a dead manager
            # forever, and waiting for it hung the app's cleanup
            await self._heartbeat_task.stop(cancel=True)
        if self._ship_task is not None and not self._ship_task.done():
            self._ship_task.cancel()
            try:
                await self._ship_task
            except asyncio.CancelledError:
                pass
        if self._outbox_task is not None and not self._outbox_task.done():
            self._outbox_task.cancel()
            try:
                await self._outbox_task
            except asyncio.CancelledError:
                pass
        if self.__session is not None:
            await self.__session.close()

    @property
    def _session(self) -> aiohttp.ClientSession:
        if self.__session is None:
            self.__session = aiohttp.ClientSession()
        return self.__session

    # -- hierarchical routing ------------------------------------------
    def _via_edge(self) -> bool:
        """True while control/data traffic should route through the
        configured edge aggregator (configured AND not marked down)."""
        return (
            self.edge_url is not None
            and time.monotonic() >= self._edge_down_until
        )

    @property
    def manager_url(self) -> str:
        """The current upstream base URL: the edge aggregator while that
        route is healthy, the root manager otherwise. Re-evaluated per
        attempt by every caller, so a mid-retry fallback takes effect on
        the very next request."""
        return self.edge_url if self._via_edge() else self.root_url

    def _edge_failed(self) -> None:
        """Mark the edge route down for ``edge_retry_s``: the next
        attempt at any upstream call goes direct to the root (same
        credentials — the edge only proxies registration)."""
        if self.edge_url is None or not self._via_edge():
            return
        self._edge_down_until = time.monotonic() + self.edge_retry_s
        self.metrics.inc("edge_route_fallbacks")

    @property
    def root_url(self) -> str:
        """The current direct-root base URL: a 307-learned owner when
        one is pinned, else the failover ring's current entry."""
        return self._root_override or self._root_urls[self._root_idx]

    def _root_failed(self) -> None:
        """Rotate the direct-root route to the next replica. A 307
        override is dropped first (the owner it named is the thing that
        just failed); with a single configured root this is a no-op and
        the caller's backoff retries the same address."""
        if self._root_override is not None:
            self._root_override = None
        elif len(self._root_urls) > 1:
            self._root_idx = (self._root_idx + 1) % len(self._root_urls)
        else:
            return
        self.metrics.inc("root_failovers")

    def _follow_redirect(self, data) -> bool:
        """Pin the direct-root route to a 307 redirect's owner URL (the
        topology reassignment contract, server/replication.py)."""
        if not isinstance(data, dict):
            return False
        url = data.get("url")
        if not isinstance(url, str) or not url.startswith("http"):
            return False
        self._root_override = url if url.endswith("/") else url + "/"
        self.metrics.inc("root_redirects_followed")
        return True

    # -- membership ----------------------------------------------------
    async def register_with_manager(self) -> None:
        if self._register_lock.locked():
            return  # collision guard (reference ensure_no_collision, per-instance now)
        # holding the lock across the retry loop IS the point: a second
        # register attempt must wait out the whole handshake, not
        # interleave with it
        async with self._register_lock:  # batonlint: allow[BTL002]
            payload = {"url": self.worker_host, "port": self.port}
            backoff = 1.0
            while True:
                # URL per attempt: an edge failure mid-loop falls the
                # next attempt back to the root (direct registration —
                # the root then notifies this worker directly too)
                via_edge = self._via_edge()
                url = self.manager_url + "register"
                try:
                    async with self._session.get(url, json=payload) as resp:
                        if resp.status != 200:
                            # a standby answers 503; anything non-200
                            # here means "not this replica" — rotate the
                            # root ring and retry (KeyError-ing on the
                            # error body would kill registration for
                            # good)
                            raise aiohttp.ClientResponseError(
                                resp.request_info, (), status=resp.status
                            )
                        data = await resp.json()
                        self.client_id = data["client_id"]
                        self.key = data["key"]
                        self.tracer.service = f"worker:{self.client_id}"
                        break
                except aiohttp.ClientError:
                    if via_edge:
                        self._edge_failed()
                    else:
                        self._root_failed()
                    await asyncio.sleep(backoff)
                    backoff = min(backoff * 2, MAX_BACKOFF)
            # (Re)start the heartbeat loop — unless we're being called
            # FROM it (401 -> re-register path): stopping would cancel
            # the current task ("Task cannot await on itself") and kill
            # heartbeating permanently. The running loop just continues.
            hb = self._heartbeat_task
            inside_heartbeat = hb is not None and hb.is_current_task()
            if not inside_heartbeat:
                if hb is not None:
                    await hb.stop()
                self._heartbeat_task = PeriodicTask(
                    self.heartbeat, self.heartbeat_time
                ).start()

    async def heartbeat(self) -> None:
        backoff = 1.0
        redirects = 0
        while True:
            # URL per attempt, not once at the top: a dead edge marked
            # down inside this loop must not pin every retry to it
            via_edge = self._via_edge()
            url = self.manager_url + "heartbeat"
            try:
                # time only the round-trip: the 401 path's re-register
                # (with its own retry backoff) would skew the histogram
                t_hb0 = time.perf_counter()
                with self.metrics.timer("heartbeat_s"):
                    async with self._session.get(
                        url,
                        json={"client_id": self.client_id, "key": self.key},
                        allow_redirects=False,
                    ) as resp:
                        status = resp.status
                        data = None
                        if status == 307:
                            try:
                                data = await resp.json()
                            except (aiohttp.ContentTypeError, ValueError):
                                data = None
                if status == 200:
                    self._last_hb_rtt = time.perf_counter() - t_hb0
                    return
                if status == 401:
                    # manager restarted or culled us: rejoin
                    return await self.register_with_manager()
                if status == 307:
                    # the experiment was resharded: retarget the direct
                    # root route and heartbeat the owner right away
                    # (bounded — a 307 ping-pong falls into the backoff)
                    if self._follow_redirect(data) and redirects < 2:
                        redirects += 1
                        continue
                if status == 503 and not via_edge:
                    # a standby: our active is elsewhere — rotate the
                    # ring, then take the backoff (an un-promoted fleet
                    # answering 503 everywhere must not spin hot)
                    self._root_failed()
            except aiohttp.ClientError:
                if via_edge:
                    self._edge_failed()
                    continue  # retry direct immediately, no backoff
                self._root_failed()
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, MAX_BACKOFF)

    # -- secure aggregation --------------------------------------------
    def _check_manager_auth(self, request: web.Request) -> bool:
        return (
            request.query.get("client_id") == self.client_id
            and request.query.get("key") == self.key
        )

    def _secure_state(self, round_name: str):
        st = self._secure.get(round_name)
        # a pending claim (keys still being generated in the thread
        # pool) is not usable state: shares/unmask against it would
        # KeyError mid-protocol
        return None if st is None or st.get("pending") else st

    async def handle_secure_keys(self, request: web.Request) -> web.Response:
        """Bonawitz round 0 (AdvertiseKeys): generate the round's two DH
        keypairs — ``c`` keys the pairwise masks, ``s`` keys the
        encrypted share transport — and return both public keys."""
        if not self._check_manager_auth(request):
            return web.json_response({"err": "Wrong Client"}, status=404)
        if self.round_in_progress:
            # Mid-round key rotation would orphan the still-running
            # round's masks (aborted rounds REUSE round names — reference
            # naming parity). Refuse; the manager excludes us this round.
            return web.json_response({"err": "Update in Progress"}, status=409)
        if self._broadcast_busy:
            # a round_start broadcast is mid-acceptance: re-keying now
            # would swap self._secure out from under its await windows
            # (the BTL003 TOCTOU) and strand the broadcast on a dead
            # state object. Refuse; a restarting manager retries keys
            # once the broadcast window closes.
            return web.json_response(
                {"err": "Broadcast in Progress"}, status=409
            )
        from baton_tpu_torch.server import secure

        try:
            data = await read_json_capped(request)
        except BodyTooLarge as exc:
            self.metrics.inc("control_rejected_413")
            return web.json_response(
                {"err": "Body Too Large", "limit_bytes": exc.limit},
                status=413,
            )
        round_name = str(data["round"])
        # claim the round slot BEFORE the thread window (loop-atomic):
        # aborted rounds reuse names, so a stale delayed handler must be
        # detectable by state identity — exactly the manager-side
        # finalization rule — or it would overwrite a replacement
        # round's keys and desynchronize the whole cohort's masks
        replaced = self._secure.get(round_name)
        if replaced is not None:
            # re-keying a live name discards the old state in place —
            # the eviction loop below won't see it, so its cached DH
            # powers must be dropped here (forward-secrecy contract)
            secure.purge_dh_secrets(
                *[k for k in (replaced.get("c_sk"), replaced.get("s_sk"))
                  if k is not None])
        st = {"pending": True, "peer_shares": {}, "partition": None}
        self._secure[round_name] = st
        while len(self._secure) > 2:  # keep current + previous round
            old = self._secure.pop(next(iter(self._secure)))
            # forward secrecy: evicting a round's keys must also drop
            # the cached DH powers derived from them (secure.py);
            # a pending claim has no keys yet
            secure.purge_dh_secrets(
                *[k for k in (old.get("c_sk"), old.get("s_sk"))
                  if k is not None])
        # two 2048-bit modexps (~14 ms): off the loop — with C cohort
        # members sharing one process (tests, benchmarks, co-located
        # silos) the serialized key generations alone starve heartbeats
        (c_sk, c_pk), (s_sk, s_pk) = await asyncio.to_thread(
            lambda: (secure.dh_keypair(), secure.dh_keypair()))
        if self._secure.get(round_name) is not st:
            # a replacement round advertised keys while this handler
            # sat in the thread pool: ours are stale — drop them
            secure.purge_dh_secrets(c_sk, s_sk)
            return web.json_response({"err": "Superseded"}, status=409)
        st.update(c_sk=c_sk, c_pk=c_pk, s_sk=s_sk, s_pk=s_pk)
        del st["pending"]
        return web.json_response({"c_pk": f"{c_pk:x}", "s_pk": f"{s_pk:x}"})

    async def handle_secure_shares(self, request: web.Request) -> web.Response:
        """Bonawitz round 1 (ShareKeys): given the cohort's pk directory,
        draw the self-mask seed b, Shamir-share b and the mask secret key
        c_sk across the cohort, and return each peer's share pair sealed
        under the pairwise share-transport key (the manager relays the
        boxes but cannot open them)."""
        if not self._check_manager_auth(request):
            return web.json_response({"err": "Wrong Client"}, status=404)
        from baton_tpu_torch.server import secure

        try:
            data = await read_json_capped(request)
        except BodyTooLarge as exc:
            self.metrics.inc("control_rejected_413")
            return web.json_response(
                {"err": "Body Too Large", "limit_bytes": exc.limit},
                status=413,
            )
        round_name = str(data["round"])
        st = self._secure_state(round_name)
        if st is None:
            return web.json_response({"err": "Unknown Round"}, status=410)
        try:
            pks = {
                cid: (int(p["c"], 16), int(p["s"], 16))
                for cid, p in data["pks"].items()
            }
            t = int(data["t"])
        except (KeyError, ValueError, TypeError):
            return web.json_response({"err": "Bad Payload"}, status=400)
        cohort = sorted(pks)
        if self.client_id not in cohort or not 1 <= t <= len(cohort):
            return web.json_response({"err": "Bad Cohort"}, status=400)
        if t < len(cohort) // 2 + 1:
            # a low threshold is the t=1 unmask-everyone attack: with
            # t=1 the server holds a reconstructing share of every b_i
            # and c_sk_i by itself — refuse anything below honest majority
            return web.json_response({"err": "Threshold Too Low"}, status=400)
        index = {cid: x + 1 for x, cid in enumerate(cohort)}

        # O(C) 2048-bit modexps (~7 ms each — the protocol's dominant
        # host cost) plus the Shamir splits and box sealing: run the
        # whole block off the event loop. At C=128 this block is ~1 s;
        # serialized across a co-located cohort it starved heartbeats
        # and uploads for minutes (26 unplanned dropouts in the r4
        # secure_round_scale run).
        def _build_boxes():
            b_seed = secrets.token_bytes(32)
            b_shares = secure.shamir_share(
                int.from_bytes(b_seed, "big"), len(cohort), t
            )
            csk_shares = secure.shamir_share(st["c_sk"], len(cohort), t)
            boxes = {}
            for cid in cohort:
                if cid == self.client_id:
                    continue
                # direction-bound key: without the sender->recipient
                # context the pair's two boxes would share one
                # nonce-free keystream (a two-time pad to the relaying
                # server) and a reflected box would still authenticate
                try:
                    key = secure.dh_shared_seed(
                        st["s_sk"], pks[cid][1],
                        f"{round_name}|shares|{self.client_id}>{cid}",
                    )
                except ValueError:
                    continue  # Byzantine pk: skip this peer, not the round
                plain = (
                    secure.share_to_hex(b_shares[index[cid]])
                    + secure.share_to_hex(csk_shares[index[cid]])
                ).encode()
                boxes[cid] = secure.seal(key, plain).hex()
            return b_seed, b_shares, csk_shares, boxes

        b_seed, b_shares, csk_shares, boxes = await asyncio.to_thread(
            _build_boxes)
        if self._secure_state(round_name) is not st:
            # the round was re-keyed (same name — aborted rounds reuse
            # names) while the boxes were being built: these shares are
            # bound to dead keys and must not clobber the new state
            return web.json_response({"err": "Superseded"}, status=409)
        st.update(
            pks=pks, cohort=cohort, index=index, t=t, b=b_seed,
            own_shares=(
                b_shares[index[self.client_id]],
                csk_shares[index[self.client_id]],
            ),
        )
        return web.json_response({"shares": boxes})

    async def handle_secure_unmask(self, request: web.Request) -> web.Response:
        """Bonawitz round 3 (Unmasking): given the server's survivor/
        dropped partition of the masking cohort, return — per peer —
        EITHER its self-mask share (survivors) OR its mask-key share
        (dropped), never both. The either-or rule plus partition pinning
        is what makes a fabricated dropout claim useless: naming a live
        reporter 'dropped' forfeits its self-mask share, so its upload
        stays masked by PRG(b)."""
        if not self._check_manager_auth(request):
            return web.json_response({"err": "Wrong Client"}, status=404)
        from baton_tpu_torch.server import secure

        try:
            data = await read_json_capped(request)
        except BodyTooLarge as exc:
            self.metrics.inc("control_rejected_413")
            return web.json_response(
                {"err": "Body Too Large", "limit_bytes": exc.limit},
                status=413,
            )
        round_name = str(data.get("round", ""))
        st = self._secure_state(round_name)
        if st is None or "cohort" not in st:
            return web.json_response({"err": "Unknown Round"}, status=410)
        try:
            req_c_pk = int(str(data.get("c_pk", "")), 16)
        except ValueError:
            req_c_pk = None
        if req_c_pk != st["c_pk"]:
            # the request is bound to a different key-generation
            # instance of this round NAME (aborted rounds reuse names):
            # a stale finalizer must not pin its partition onto the
            # replacement round's state
            return web.json_response({"err": "Unknown Round"}, status=410)
        survivors = sorted(map(str, data.get("survivors", [])))
        dropped = sorted(map(str, data.get("dropped", [])))
        cohort = set(st["cohort"])
        part = (tuple(survivors), tuple(dropped))
        if (
            not set(survivors) <= cohort
            or not set(dropped) <= cohort
            or set(survivors) & set(dropped)
            or self.client_id not in survivors
            or len(survivors) < st["t"]
        ):
            # len(survivors) >= t also bounds fake-dropout claims: a
            # partition dropping more than n-t members cannot
            # reconstruct and is refused outright
            return web.json_response({"err": "Bad Partition"}, status=400)
        if st["partition"] is not None and st["partition"] != part:
            # a second, DIFFERENT partition for the same round is the
            # both-share-types extraction attack — refuse permanently
            return web.json_response({"err": "Partition Pinned"}, status=409)
        st["partition"] = part

        b_shares = {}
        csk_shares = {}
        for cid in survivors:
            if cid == self.client_id:
                b_shares[cid] = secure.share_to_hex(st["own_shares"][0])
            elif cid in st["peer_shares"]:
                b_shares[cid] = secure.share_to_hex(
                    st["peer_shares"][cid][0]
                )
        for cid in dropped:
            if cid in st["peer_shares"]:
                csk_shares[cid] = secure.share_to_hex(
                    st["peer_shares"][cid][1]
                )
        return web.json_response({
            "x": st["index"][self.client_id],
            "b_shares": b_shares,
            "csk_shares": csk_shares,
        })

    # -- rounds --------------------------------------------------------
    async def handle_round_start(self, request: web.Request) -> web.Response:
        if self.round_in_progress or self._broadcast_busy:
            return web.json_response({"err": "Update in Progress"}, status=409)
        if (
            request.query.get("client_id") != self.client_id
            or request.query.get("key") != self.key
        ):
            asyncio.ensure_future(self.register_with_manager())
            return web.json_response({"err": "Wrong Client"}, status=404)
        self._broadcast_busy = True
        # join the manager's trace: the notify span's traceparent makes
        # this broadcast's fetch/reconstruct spans (and, via the context
        # copied into the spawned round task, the train span) children
        # of the manager's notify
        ctx = tracing.parse_traceparent(request.headers.get("traceparent"))
        token = tracing.activate(ctx[0], ctx[1]) if ctx is not None else None
        try:
            return await self._handle_round_start_locked(request)
        finally:
            if token is not None:
                tracing.deactivate(token)
            self._broadcast_busy = False

    async def _handle_round_start_locked(
        self, request: web.Request
    ) -> web.Response:
        try:
            body = await read_body_capped(request, self.max_broadcast_bytes)
        except BodyTooLarge as exc:
            # mirror the manager's upload-cap contract: reject with the
            # limit in the body so the peer can see what it tripped
            self.metrics.inc("broadcast_rejected_413")
            return web.json_response(
                {"err": "Body Too Large", "limit_bytes": exc.limit},
                status=413,
            )
        if request.content_type == "application/json" or body[:1] == b"{":
            # v2 pull protocol: the notify body is a small JSON envelope;
            # the round payload is fetched from the manager's blob store
            return await self._handle_round_start_envelope(body)
        # legacy push protocol: the full round payload IS the body
        try:
            content_type = request.content_type

            def _decode_broadcast():
                # CPU-bound decode (pickle/BTW1, possibly dequantize) of
                # a model-sized body, off-loop like the manager's and
                # edge's ingest decoders — heartbeats keep flowing while
                # a multi-MB broadcast unpacks
                tensors, meta = wire.decode_any(
                    body, content_type, allow_pickle=self.allow_pickle
                )
                if meta.get("quantized"):
                    # downlink-compressed broadcast (manager
                    # broadcast_quantize_bits): reconstruct dense weights
                    from baton_tpu_torch.ops.compression import dequantize_state_dict

                    tensors = dequantize_state_dict(tensors)
                return tensors, meta

            tensors, meta = await asyncio.to_thread(_decode_broadcast)
            round_name = meta["update_name"]
            n_epoch = int(meta["n_epoch"])
            new_params = state_dict_to_params(
                self.params, tensors, device=self.device
            )
        except Exception:
            # reject before mutating any state: a bad broadcast must not
            # leave the worker with half-loaded params
            return web.json_response({"err": "Bad Payload"}, status=400)
        return await self._accept_broadcast(
            round_name, n_epoch, new_params, meta.get("secure")
        )

    async def _handle_round_start_envelope(self, body: bytes) -> web.Response:
        """v2 notify: parse the envelope, obtain the round tensors (anchor
        reuse → delta reconstruction → full blob, in fallback order),
        then accept like any broadcast."""
        try:
            env = json.loads(body.decode("utf-8"))
            round_name = str(env["update_name"])
            n_epoch = int(env["n_epoch"])
            digest = str(env["blob"]["digest"])
            size = int(env["blob"]["size"])
            encoding = env.get("encoding") or {}
            delta_info = env.get("delta")
            delta_chain = env.get("delta_chain")
        except Exception:
            return web.json_response({"err": "Bad Envelope"}, status=400)
        tensors = await self._obtain_round_tensors(
            digest, size, delta_info, delta_chain=delta_chain
        )
        if tensors is None:
            # the manager's bounded notify fan-out naturally backpressures
            # these downloads; a 503 here lets it count the miss and
            # exclude us this round instead of hanging the broadcast
            return web.json_response({"err": "Blob Unavailable"}, status=503)
        try:
            load = tensors
            if encoding.get("quantized"):
                from baton_tpu_torch.ops.compression import dequantize_state_dict

                load = dequantize_state_dict(tensors)
            new_params = state_dict_to_params(
                self.params, load, device=self.device
            )
        except Exception:
            return web.json_response({"err": "Bad Payload"}, status=400)
        if not encoding:
            # dense blobs anchor the next round's delta; encoded blobs
            # (@q layouts) are not valid delta bases
            self._anchor_sd = tensors
            self._anchor_digest = digest
        else:
            self._anchor_sd = None
            self._anchor_digest = None
        return await self._accept_broadcast(
            round_name, n_epoch, new_params, env.get("secure")
        )

    async def _obtain_round_tensors(
        self, digest: str, size: int, delta_info, delta_chain=None
    ) -> Optional[dict]:
        """The pull side of the data plane, cheapest source first:

        1. digest matches the anchor we already hold → no download;
        2. the envelope offers a delta FROM our anchor → fetch the small
           delta blob, reconstruct ``anchor + delta``, and verify the
           reconstruction re-encodes to the round blob's digest;
        3. the envelope offers a delta CHAIN passing through our anchor
           (we missed up to ``delta_chain_depth - 1`` rounds) → apply
           the hops from our anchor forward, digest-verifying each
           intermediate reconstruction;
        4. otherwise (fresh worker, stale anchor, or verification
           failure) → fetch the full blob (Range-resumable).
        """
        if self._anchor_sd is not None and self._anchor_digest == digest:
            self.metrics.inc("blob_reused_anchor")
            return dict(self._anchor_sd)
        if (
            delta_info
            and self._anchor_sd is not None
            and delta_info.get("from") == self._anchor_digest
        ):
            try:
                ddigest = str(delta_info["digest"])
                dsize = int(delta_info["size"])
            except (KeyError, TypeError, ValueError):
                ddigest = None
            draw = (
                await self._fetch_blob(ddigest, dsize)
                if ddigest is not None
                else None
            )
            if draw is not None:
                from baton_tpu_torch.ops.compression import apply_delta_state_dict

                try:
                    delta_tensors, _ = wire.decode(draw)
                    cand = apply_delta_state_dict(
                        self._anchor_sd, delta_tensors
                    )
                    if (
                        hashlib.sha256(wire.encode(cand, {})).hexdigest()
                        == digest
                    ):
                        self.metrics.inc("blob_fetch_delta")
                        return cand
                except Exception:
                    pass
                # reconstruction didn't hash to the round blob (anchor
                # drift, corrupt delta): fall through to the full blob
                self.metrics.inc("blob_delta_digest_mismatch")
        if (
            isinstance(delta_chain, list)
            and delta_chain
            and self._anchor_sd is not None
        ):
            # the chain is the manager's recent-hop history (oldest
            # first, up to delta_chain_depth hops): a worker absent k
            # rounds joins at whichever hop starts FROM the anchor it
            # still holds and applies the suffix from there
            start = next(
                (
                    i
                    for i, hop in enumerate(delta_chain)
                    if isinstance(hop, dict)
                    and hop.get("from") == self._anchor_digest
                ),
                None,
            )
            if start is not None:
                cand = await self._apply_delta_chain(
                    delta_chain[start:], digest
                )
                if cand is not None:
                    return cand
        raw = await self._fetch_blob(digest, size)
        if raw is None:
            self.metrics.inc("blob_fetch_failed")
            return None
        try:
            tensors, _ = wire.decode(raw)
        except Exception:
            self.metrics.inc("blob_fetch_failed")
            return None
        self.metrics.inc("blob_fetch_full")
        return tensors

    async def _apply_delta_chain(
        self, hops, final_digest: str
    ) -> Optional[dict]:
        """Walk a depth-N delta chain from our anchor: fetch each hop's
        delta blob, reconstruct, and verify the intermediate state
        re-encodes to the hop's ``to`` digest — every step is as
        bit-defined as the single-hop delta path. Any failure returns
        None and the caller falls back to the full blob."""
        from baton_tpu_torch.ops.compression import apply_delta_state_dict

        # safe across the fetch awaits: each hop re-encodes and verifies
        # against the hop's `to` digest, so a stale anchor cannot produce
        # a wrong state — it fails verification and we fall back to the
        # full blob.
        sd = self._anchor_sd  # batonlint: allow[BTL003]
        to = None
        for i, hop in enumerate(hops):
            try:
                ddigest = str(hop["digest"])
                dsize = int(hop["size"])
                to = str(
                    hop["to"] if hop.get("to") is not None
                    else (final_digest if i == len(hops) - 1 else "")
                )
            except (KeyError, TypeError, ValueError):
                self.metrics.inc("blob_delta_digest_mismatch")
                return None
            raw = await self._fetch_blob(ddigest, dsize)
            if raw is None:
                self.metrics.inc("blob_delta_digest_mismatch")
                return None
            try:
                delta_tensors, _ = wire.decode(raw)
                cand = apply_delta_state_dict(sd, delta_tensors)
                if hashlib.sha256(wire.encode(cand, {})).hexdigest() != to:
                    raise ValueError("hop digest mismatch")
            except Exception:
                self.metrics.inc("blob_delta_digest_mismatch")
                return None
            sd = cand
        if to != final_digest:
            # chain ends at some other state (stale envelope): unusable
            self.metrics.inc("blob_delta_digest_mismatch")
            return None
        self.metrics.inc("blob_fetch_delta_chain")
        return sd

    async def _fetch_blob(
        self, digest: str, size: int, max_attempts: int = 6
    ) -> Optional[bytes]:
        """GET a content-addressed blob, resuming interrupted transfers
        with HTTP Range and verifying the assembled bytes by digest."""
        buf = bytearray()
        base, cap = 0.2, 2.0
        with self.tracer.span(
            "fetch_blob", digest=digest[:12], size=size
        ) as fetch_sp:
            for attempt in range(max_attempts):
                # URL per attempt: the blob is immutable and addressed
                # by digest, so a resume that fell back from a dead edge
                # to the root continues byte-for-byte where it stopped
                via_edge = self._via_edge()
                url = (
                    self.manager_url
                    + f"round_blob/{digest}"
                    + f"?client_id={self.client_id}&key={self.key}"
                )
                headers = trace_headers()
                if buf:
                    # the blob is immutable under its digest, so a partial
                    # body resumes where it stopped instead of restarting
                    headers["Range"] = f"bytes={len(buf)}-"
                    self.metrics.inc("blob_range_resumes")
                try:
                    async with self._session.get(
                        url, headers=headers
                    ) as resp:
                        if resp.status == 200 and buf:
                            buf.clear()  # server ignored the Range: restart
                        if resp.status in (200, 206):
                            async for chunk in resp.content.iter_chunked(
                                1 << 16
                            ):
                                buf.extend(chunk)
                                if len(buf) > size:
                                    # a server streaming MORE than the
                                    # envelope's declared size can never
                                    # verify — stop buffering it now
                                    # instead of after an unbounded read
                                    break
                        elif resp.status in (404, 410):
                            # blob gone (round rolled): give up
                            fetch_sp.set(outcome="gone")
                            return None
                        else:
                            buf.clear()  # 416/401/5xx: restart clean
                except (aiohttp.ClientError, asyncio.TimeoutError):
                    # partial body stays in buf; next attempt resumes
                    if via_edge:
                        self._edge_failed()
                if len(buf) == size:
                    if hashlib.sha256(buf).hexdigest() == digest:
                        fetch_sp.set(attempts=attempt + 1)
                        return bytes(buf)
                    buf.clear()  # corrupt assembly: restart from scratch
                elif len(buf) > size:
                    buf.clear()
                if attempt < max_attempts - 1:
                    delay = min(base * (2 ** attempt), cap)
                    await asyncio.sleep(delay * (0.5 + random.random() / 2))
            fetch_sp.set(outcome="exhausted")
            return None

    async def _accept_broadcast(
        self, round_name: str, n_epoch: int, new_params, secure_info
    ) -> web.Response:
        """Common tail for both broadcast protocols: open the secure
        inbox if the round is masked, load params, and spawn the round."""
        if secure_info is not None:
            st = self._secure.get(round_name)
            if st is None or "cohort" not in st:
                # key agreement / share distribution never happened for
                # this round: we cannot produce a correctly-masked
                # upload, and an unmasked one would poison the sum
                return web.json_response({"err": "No Round Keys"}, status=400)
            mask_cohort = sorted(map(str, secure_info["cohort"]))
            if (
                not set(mask_cohort) <= set(st["cohort"])
                or self.client_id not in mask_cohort
            ):
                return web.json_response({"err": "Bad Cohort"}, status=400)
            opened = await asyncio.to_thread(
                self._decrypt_share_inbox, st, round_name,
                dict(secure_info.get("inbox", {})),
            )
            if self._secure.get(round_name) is not st:
                # the round was re-keyed while the inbox decrypted in
                # the thread pool (an abort/restart REUSES the name):
                # committing mask_cohort into the dead state object
                # would leave the live one bare and let report_update
                # fall through to an UNMASKED upload — the secure-agg
                # downgrade. Refuse the whole broadcast instead.
                self.metrics.inc("broadcast_rejected_superseded")
                return web.json_response({"err": "Superseded"}, status=409)
            st["mask_cohort"] = mask_cohort
            st["scale_bits"] = int(secure_info.get("scale_bits", 16))
            st["peer_shares"].update(opened)
        # capture the secure state AT BROADCAST TIME: report_update
        # must refuse (not downgrade to plain) if this exact object is
        # no longer the round's live state when the upload is built
        self._broadcast_secure_st = (
            (round_name, st) if secure_info is not None else None
        )
        self.params = new_params
        # the broadcast is this round's delta anchor: the manager holds
        # the identical tensors until end_round, so `anchor + delta`
        # reconstructs exactly server-side (ops/compression.py docstring);
        # kept as fp32 on the worker's device, where the delta is taken
        if self.compressor is not None:
            self._round_anchor = {
                k: v.detach().to(torch.float32, copy=True)
                for k, v in new_params.items()
            }
        if self._pending is not None:
            # an accepted broadcast supersedes any undelivered previous
            # update — including a manager-resumed round re-announcing
            # the SAME name: we retrain from the fresh broadcast, and
            # letting the stale body race the new one could count this
            # worker twice in the resumed round
            self._cancel_pending("superseded")
        self.last_update = round_name
        self.round_in_progress = True
        asyncio.ensure_future(self._run_round(round_name, n_epoch))
        return web.json_response("OK")

    def _decrypt_share_inbox(self, st, round_name: str, inbox: dict) -> dict:
        """Decrypt the share boxes relayed via the manager (Bonawitz
        round 2 inbox); a box failing authentication just leaves that
        sender's shares missing (reconstruction needs only t of n).
        O(C) modexps — call via ``asyncio.to_thread``, same starvation
        argument as handle_secure_shares."""
        from baton_tpu_torch.server import secure as _secure

        opened = {}
        for sender, ct_hex in inbox.items():
            if sender == self.client_id or sender not in st["pks"]:
                continue
            try:
                key = _secure.dh_shared_seed(
                    st["s_sk"], st["pks"][sender][1],
                    f"{round_name}|shares|{sender}>{self.client_id}",
                )
                plain = _secure.unseal(key, bytes.fromhex(ct_hex)).decode()
                half = len(plain) // 2
                opened[sender] = (
                    _secure.share_from_hex(plain[:half]),
                    _secure.share_from_hex(plain[half:]),
                )
            except (ValueError, UnicodeDecodeError):
                pass
        return opened

    def _with_progress_hook(self, trainer: LocalTrainer) -> LocalTrainer:
        """Attach this worker's per-epoch metrics hook to ``trainer``.

        The hook holds the worker only weakly: a trainer can outlive the
        worker (shared, or kept by a caller), and a strongly-captured
        ``self`` would pin the worker — params on the card, dataset
        closure and all — long after app cleanup.
        """
        wref = weakref.ref(self)

        def hook(epoch_idx, epoch_loss):
            w = wref()
            if w is not None:
                # late-bound attribute lookup keeps the hook patchable
                w._on_epoch_progress(epoch_idx, epoch_loss)

        return dataclasses.replace(trainer, progress_fn=hook)

    def enable_progress_metrics(self) -> None:
        """Opt a user-supplied trainer into the per-epoch metrics
        heartbeat. Note this makes the trainer unique to this worker."""
        if self.trainer.progress_fn is None:
            self.trainer = self._with_progress_hook(self.trainer)

    def _on_epoch_progress(self, epoch_idx, epoch_loss) -> None:
        """Progress hook target: runs on the training thread after each
        epoch."""
        self.metrics.set_gauge("train_epoch", int(epoch_idx) + 1)
        self.metrics.set_gauge("train_epoch_loss", float(epoch_loss))
        self.metrics.inc("train_epochs_completed")

    async def handle_metrics(self, request: web.Request) -> web.Response:
        return web.json_response(self.metrics.snapshot())

    def _record_compute(
        self,
        train_sig: tuple,
        train_s: float,
        n_samples: int,
        n_epoch: int,
        steps: int,
        t_wall0: float,
    ) -> Optional[dict]:
        """Build this round's compute record (obs/compute.py) and publish
        it locally: a ``compute`` child span under the active
        ``local_train`` span, the ``compute_compile_s`` histogram with a
        trace exemplar, and latest-round gauges. Returns the record for
        the update meta (None only if the probe itself fails — the round
        must never die on telemetry)."""
        try:
            compute = self.compute_probe.record_round(
                key="local_train",
                signature=train_sig,
                train_s=train_s,
                n_samples=n_samples,
                device=self.device,
                n_epochs=n_epoch,
                steps=steps,
            )
        except Exception:
            return None
        ctx = tracing.current_context()
        if ctx is not None:
            self.tracer.record_span(
                "compute", ctx[0], t_wall0, time.time(),
                parent_id=ctx[1],
                **{k: v for k, v in compute.items() if v is not None},
            )
        compile_s = compute.get("compile_s")
        if isinstance(compile_s, (int, float)):
            self.metrics.observe(
                "compute_compile_s", float(compile_s), exemplar=ctx
            )
        if not compute.get("cache_hit") and compute.get("recompiles"):
            self.metrics.inc("compute_recompiles")
        for gauge, key in (
            ("compute_mfu", "mfu"),
            ("compute_samples_per_sec_per_chip", "samples_per_sec_per_chip"),
            ("compute_peak_hbm_gb", "peak_hbm_gb"),
            ("compute_steps", "steps"),
        ):
            val = compute.get(key)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                self.metrics.set_gauge(gauge, float(val))
        self.metrics.set_gauge(
            "compute_recompile_storm",
            1.0 if compute.get("recompile_storm") else 0.0,
        )
        return compute

    async def _run_round(self, round_name: str, n_epoch: int) -> None:
        # reset per-round progress so round N+1's zero-epochs state is
        # distinguishable from round N's completion
        self.metrics.set_gauge("train_epoch", 0)
        self.metrics.set_gauge("train_epoch_loss", 0.0)
        try:
            data, n_samples = self.get_data()

            def train():
                capacity = round_up(
                    next(iter(data.values())).shape[0], self.trainer.batch_size
                )
                padded, n = pad_dataset(
                    {k: np.asarray(v) for k, v in data.items()}, capacity
                )
                assert n == n_samples or n_samples <= n
                padded = {
                    k: torch.as_tensor(v, device=self.device)
                    for k, v in padded.items()
                }
                try:
                    sig = self.trainer.train_signature(padded, n_epoch)
                    steps = self.trainer.steps_per_round(capacity, n_epoch)
                except Exception:
                    # delegating trainer wrappers (chaos harnesses proxy
                    # only ``train``) need not expose the accounting
                    # helpers — derive the shape signature locally;
                    # build_record defaults steps epoch-wise
                    sig = (
                        tuple(sorted(
                            (k, tuple(v.shape), str(v.dtype))
                            for k, v in padded.items()
                        )),
                        int(n_epoch),
                    )
                    steps = None
                # forensics: when a capture:true alert armed a one-shot
                # profiler capture, this step consumes it (no-op when
                # unarmed; profiler failures are swallowed inside)
                with profiling.forensics_trace():
                    params, _, losses = self.trainer.train(
                        self.params, padded, int(n_samples), n_epoch,
                        generator=self.rng,
                    )
                return params, losses.detach().cpu().numpy(), sig, steps

            # explicit derived trace id: under a live traceparent
            # context (copied into this task at ensure_future) the span
            # parents to the manager's notify; on a legacy broadcast
            # with no context it still joins the round's derived trace
            trace_id = tracing.make_trace_id(self.name, round_name)
            with self.tracer.span(
                "local_train", trace_id=trace_id, round=round_name,
                n_epoch=n_epoch, n_samples=n_samples,
            ) as train_sp:
                loop = asyncio.get_running_loop()
                t_train0 = loop.time()
                t_wall0 = time.time()
                params, loss_history, train_sig, steps = (
                    await asyncio.to_thread(train)
                )
                if self.train_time_scale > 1.0:
                    # pad to scale× the measured compute time: simulated
                    # slow hardware, same numerics (see __init__ doc)
                    extra = (self.train_time_scale - 1.0) * (
                        loop.time() - t_train0
                    )
                    train_sp.set(time_scale=self.train_time_scale)
                    await asyncio.sleep(extra)
                train_s = loop.time() - t_train0
                if len(loss_history):
                    train_sp.set(final_loss=float(loss_history[-1]))
                # observed inside the span so the histogram exemplar
                # carries this round's local_train span context
                self.metrics.observe(
                    "local_train_s", train_s,
                    exemplar=tracing.current_context(),
                )
                compute = self._record_compute(
                    train_sig, train_s, n_samples, n_epoch, steps, t_wall0
                )
            self.params = params
            await self.report_update(
                round_name, n_samples, loss_history,
                timings={
                    "train_s": train_s,
                    "hb_rtt_s": self._last_hb_rtt,
                },
                compute=compute,
            )
        finally:
            self.round_in_progress = False

    async def report_update(
        self, round_name: str, n_samples: int, loss_history,
        timings: Optional[dict] = None,
        compute: Optional[dict] = None,
    ) -> None:
        """Encode the trained update and park it in the outbox; actual
        delivery (with retries) happens in :meth:`_drain_outbox`. Returns
        as soon as the slot is filled, so the caller's round bookkeeping
        never waits on the network. ``timings`` (self-reported seconds,
        e.g. ``{"train_s": …, "hb_rtt_s": …}``) ride along in the update
        metadata for the manager's fleet ledger — advisory data, so None
        entries are simply dropped rather than sent. ``compute`` is the
        round's compute record (obs/compute.py) — shipped verbatim
        (nulls INCLUDED: each carries its reason field; the manager's
        sanitizer enforces that invariant server-side). The meta dict is
        shared by every encode branch and the chunked upload slices the
        same body, so both plain and chunked paths carry it."""
        update_id = random_key(16)
        meta = {
            "update_name": round_name,
            "n_samples": int(n_samples),
            "loss_history": [float(x) for x in loss_history],
            "update_id": update_id,
        }
        if timings:
            cleaned = {
                k: round(float(v), 6)
                for k, v in timings.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            }
            if cleaned:
                meta["timings"] = cleaned
        if compute:
            meta["compute"] = compute
        # use the secure state captured AT BROADCAST TIME, not a fresh
        # registry fetch: if the round was re-keyed since (abort/restart
        # reusing the name mid-round), a fresh fetch returns the NEW
        # round's bare state, "mask_cohort" is absent, and the upload
        # silently falls through to the PLAIN branch — defeating secure
        # aggregation. Refuse instead; the manager treats us as a
        # dropout and Shamir-recovers our masks.
        captured = self._broadcast_secure_st
        st = None
        if captured is not None and captured[0] == round_name:
            st = captured[1]
            if self._secure.get(round_name) is not st or "mask_cohort" not in st:
                self.metrics.inc("updates_refused_secure_downgrade")
                self._broadcast_secure_st = None
                return
        compressed_payload = None  # set only on the compressed branch
        # one span for the upload's encoding, whichever branch builds it
        trace_id = tracing.make_trace_id(self.name, round_name)
        with self.tracer.span(
            "encode_update", trace_id=trace_id,
            parent_id=tracing.root_span_id(trace_id), round=round_name,
        ):
            if st is not None:
                # Secure round: upload sample-weighted quantized params plus
                # every pairwise mask and the self mask PRG(b) — the manager
                # can only use the cohort sum (server/secure.py). Weighting
                # happens client-side because the server cannot scale a
                # masked ring element.
                from baton_tpu_torch.server import secure

                # O(C) seed modexps + O(C) Philox masks over the full state
                # dict — by far the heaviest per-upload host work in a
                # secure round. Off the loop (same starvation argument as
                # handle_secure_shares); numpy mask generation also releases
                # the GIL, so co-located cohorts overlap it.
                def _build_masked_body():
                    seeds = {
                        other: secure.dh_shared_seed(
                            st["c_sk"], st["pks"][other][0], round_name
                        )
                        for other in st["mask_cohort"]
                        if other != self.client_id
                    }
                    weighted = {
                        k: np.asarray(v, np.float64) * float(n_samples)
                        for k, v in params_to_state_dict(self.params).items()
                    }
                    return wire.encode(
                        secure.mask_state_dict(
                            weighted, self.client_id, seeds, st["scale_bits"],
                            self_seed=st["b"],
                        ),
                        dict(meta, secure=True, scale_bits=st["scale_bits"]),
                    )

                body = await asyncio.to_thread(_build_masked_body)
            elif self.compressor is not None and self._round_anchor is not None:
                # sparse round delta (ops/compression.py): top-k of
                # (trained - broadcast) with error feedback; flat wire layout
                # "<name>@idx"/"<name>@val" (+"@scale" when quantized). The
                # delta and its top-k stay on the worker's device; only the
                # kept coordinates cross to the host.
                delta = {
                    k: v.detach().to(torch.float32) - self._round_anchor[k]
                    for k, v in self.params.items()
                }
                compressed_payload = self.compressor.compress(delta)
                compressed_template = delta
                tensors = {}
                for k, p in compressed_payload.items():
                    tensors[f"{k}@idx"] = _host(p["idx"], np.int32)
                    val = p["val"]
                    if isinstance(val, dict):  # quantized {"q", "scale"}
                        tensors[f"{k}@val"] = _host(val["q"])
                        tensors[f"{k}@scale"] = np.asarray(
                            [float(val["scale"])], np.float32
                        )
                    else:
                        tensors[f"{k}@val"] = _host(val, np.float32)
                body = wire.encode(
                    tensors, dict(meta, compressed={"scheme": "topk"})
                )
            else:
                body = wire.encode(params_to_state_dict(self.params), meta)
        await self._enqueue_update(
            _PendingUpdate(
                round_name=round_name,
                update_id=update_id,
                body=body,
                compressed_template=(
                    compressed_template
                    if compressed_payload is not None
                    else None
                ),
                masked=st is not None,
            )
        )

    # -- at-least-once outbox ------------------------------------------
    def _outbox_paths(self) -> Tuple[pathlib.Path, pathlib.Path]:
        d = pathlib.Path(self.outbox_dir)
        return d / "outbox.body", d / "outbox.json"

    def _persist_pending(self, p: _PendingUpdate) -> None:
        """Write the outbox slot to disk: body first, then the meta JSON
        via tmp-file + ``os.replace`` — the meta rename is the commit
        point, so a crash mid-write leaves either a complete slot or no
        slot, never a half one."""
        if self.outbox_dir is None:
            return
        body_path, meta_path = self._outbox_paths()
        body_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = body_path.with_suffix(".body.tmp")
        tmp.write_bytes(p.body)
        os.replace(tmp, body_path)
        meta = {
            "round_name": p.round_name,
            "update_id": p.update_id,
            "body_len": len(p.body),
        }
        tmp = meta_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, meta_path)

    def _clear_persisted(self) -> None:
        if self.outbox_dir is None:
            return
        for path in self._outbox_paths():
            try:
                path.unlink()
            except FileNotFoundError:
                pass

    def _load_persisted(self) -> Optional[_PendingUpdate]:
        """Reload a crash-survived outbox slot, if the on-disk pair is
        complete and consistent (meta committed, body the advertised
        length, BTW1 magic intact). Anything short of that is treated as
        no slot — delivery is at-least-once, never garbage."""
        if self.outbox_dir is None:
            return None
        body_path, meta_path = self._outbox_paths()
        try:
            meta = json.loads(meta_path.read_text())
            body = body_path.read_bytes()
        except (FileNotFoundError, ValueError, OSError):
            return None
        if (
            not isinstance(meta, dict)
            or len(body) != meta.get("body_len")
            or not wire.is_btw1(body)
        ):
            return None
        try:
            return _PendingUpdate(
                round_name=str(meta["round_name"]),
                update_id=str(meta["update_id"]),
                body=body,
            )
        except KeyError:
            return None

    async def _enqueue_update(self, pending: _PendingUpdate) -> None:
        # one slot: a newer round's update supersedes anything still
        # undelivered (the manager 410s stale rounds anyway).
        # Slot mutation stays loop-atomic (before the first await); only
        # the disk write goes to the thread pool — the outbox body is
        # the full encoded update, large enough that a synchronous
        # write_bytes would stall heartbeats (BTL001).
        if self._pending is not None:
            self._cancel_pending("superseded")
        self._pending = pending
        await asyncio.to_thread(self._persist_pending, pending)
        self.metrics.set_gauge("outbox_pending", 1)
        if self._outbox_task is None or self._outbox_task.done():
            self._outbox_task = asyncio.ensure_future(self._drain_outbox())

    def _cancel_pending(self, reason: str) -> None:
        p, self._pending = self._pending, None
        self._clear_persisted()
        self.metrics.set_gauge("outbox_pending", 0)
        if p is not None and p.compressed_template is not None:
            # the kept mass never reached the manager: fold it back into
            # the error-feedback residual or it is lost for good
            self.compressor.restore(p.compressed_template)
        if p is not None:
            self.metrics.inc(f"updates_abandoned_{reason}")

    async def _drain_outbox(self) -> None:
        """Retry the parked upload until the manager answers 200
        (delivered) or 410 (round dead): capped exponential backoff with
        jitter, re-registering on 401 so the retry after a manager
        restart carries fresh credentials. A 429's ``Retry-After`` is a
        floor under the backoff — the manager's admission control is
        authoritative about when to come back."""
        base, cap = self.outbox_backoff
        while (p := self._pending) is not None:
            status, retry_after = await self._post_update(p)
            if self._pending is not p:
                continue  # superseded while the POST was in flight
            if status == 200:
                self._pending = None
                self._clear_persisted()
                self.metrics.set_gauge("outbox_pending", 0)
                self.n_updates += 1
                self.metrics.inc("updates_delivered")
                # fire-and-forget: shipping spans must neither delay the
                # next slot nor add an await window between the slot
                # snapshot and its use (the BTL003 staleness rule)
                self._ship_task = asyncio.ensure_future(
                    self._ship_spans(
                        tracing.make_trace_id(self.name, p.round_name)
                    )
                )
                continue
            if status == 410:
                # the round is gone (aborted, force-ended, or we were
                # dropped from it): this update can never land
                self._cancel_pending("round_gone")
                continue
            # undeliverable right now (connection refused, 5xx, 401,
            # 429 backpressure): keep the slot and back off
            p.attempts += 1
            self.metrics.inc("update_retries")
            # backoff is computed from the slot snapshot BEFORE the
            # re-register await below can yield: if this update is
            # superseded while rejoining, the loop head re-checks slot
            # identity rather than touching the stale object again
            delay = min(base * (2 ** (p.attempts - 1)), cap)
            delay *= 0.5 + random.random() / 2
            if retry_after is not None:
                delay = max(delay, retry_after)
            if status == 429:
                self.metrics.inc("update_backpressure_429")
            if status == 401:
                # manager restarted without its registry: rejoin, then
                # retry the SAME update under the new credentials
                await self.register_with_manager()
            await asyncio.sleep(delay)

    async def _ship_spans(self, trace_id: str) -> None:
        """Ship this round's finished spans upstream (``POST
        /{name}/trace_spans``) so the manager's trace endpoint serves
        the distributed round in one document. Best-effort and
        fire-after-delivery: spans are observability, not protocol
        state — a failed ship drops them (counted) rather than blocking
        or re-queueing the outbox."""
        spans = self.tracer.drain(trace_id)
        if not spans:
            return
        url = (
            self.manager_url
            + f"trace_spans?client_id={self.client_id}&key={self.key}"
        )
        try:
            async with self._session.post(url, json=spans) as resp:
                if resp.status == 200:
                    self.metrics.inc("trace_spans_shipped", len(spans))
                else:
                    self.metrics.inc("trace_ship_failed")
        except (aiohttp.ClientError, asyncio.TimeoutError):
            self.metrics.inc("trace_ship_failed")

    @staticmethod
    def _retry_after_s(resp) -> Optional[float]:
        """Parse a Retry-After header (seconds form) from a response;
        None when absent/unparseable."""
        val = resp.headers.get("Retry-After")
        if val is None:
            return None
        try:
            return max(0.0, float(val))
        except ValueError:
            return None

    async def _post_update(
        self, p: _PendingUpdate
    ) -> Tuple[Optional[int], Optional[float]]:
        """One delivery attempt; ``(status, retry_after_s)`` — status is
        None on transport failure. The URL is rebuilt per attempt:
        credentials may have rotated via a 401 → re-register cycle
        between attempts. Bodies above ``upload_chunk_bytes`` go through
        the chunked resumable path."""
        chunked = (
            self.upload_chunk_bytes is not None
            and len(p.body) > self.upload_chunk_bytes
        )
        # the outbox task may outlive the round task's copied context:
        # derive the round's trace id from the slot itself so a retry
        # hours later (or after a crash-reload) still joins the right
        # trace, parented to the round's deterministic root span
        trace_id = tracing.make_trace_id(self.name, p.round_name)
        # masked bodies always go direct: the edge cannot partial-fold
        # ring elements (unmasking only works on the full cohort sum)
        via_edge = self._via_edge() and not p.masked
        base_url = self.edge_url if via_edge else self.root_url
        with self.tracer.span(
            "upload", trace_id=trace_id,
            parent_id=tracing.root_span_id(trace_id),
            round=p.round_name, bytes=len(p.body),
            attempt=p.attempts + 1, chunked=chunked,
            via_edge=via_edge,
        ) as up_sp:
            t_up0 = time.perf_counter()
            if chunked:
                status, retry_after = await self._post_update_chunked(
                    p, base_url
                )
                up_sp.set(status=status)
                if status == 200:
                    # successful deliveries only: a refused or retried
                    # attempt's wall time is backoff, not bandwidth
                    self.metrics.observe(
                        "upload_s", time.perf_counter() - t_up0,
                        exemplar=tracing.current_context(),
                    )
                if status is None and via_edge:
                    self._edge_failed()
                elif (status is None or status == 503) and not via_edge:
                    self._root_failed()
                return status, retry_after
            url = (
                base_url
                + f"update?client_id={self.client_id}&key={self.key}"
            )
            try:
                async with self._session.post(
                    url, data=p.body,
                    headers=trace_headers(
                        {"Content-Type": wire.CONTENT_TYPE}
                    ),
                ) as resp:
                    up_sp.set(status=resp.status)
                    if resp.status == 200:
                        self.metrics.observe(
                            "upload_s", time.perf_counter() - t_up0,
                            exemplar=tracing.current_context(),
                        )
                    if resp.status == 409 and via_edge:
                        # the edge refused to fold (secure round, round
                        # unknown): mark the route down so the outbox's
                        # next attempt delivers direct to the root
                        self._edge_failed()
                    if resp.status == 503 and not via_edge:
                        # a standby refusing to serve: rotate the root
                        # ring so the backoff retry lands on the active
                        self._root_failed()
                    return resp.status, self._retry_after_s(resp)
            except (aiohttp.ClientError, asyncio.TimeoutError):
                # manager down; the backoff loop keeps trying
                up_sp.set(status=None)
                if via_edge:
                    self._edge_failed()
                else:
                    self._root_failed()
                return None, None

    async def _post_update_chunked(
        self, p: _PendingUpdate, base_url: Optional[str] = None
    ) -> Tuple[Optional[int], Optional[float]]:
        """Deliver one update as offset/total-framed PUT chunks.

        One attempt = a committed-offset probe + the remaining chunks in
        order. A transport failure returns ``(None, None)`` and the
        outbox backoff retries — the manager keeps the committed prefix,
        so the next attempt's probe resumes where this one died instead
        of re-sending the whole body. The final chunk's 200 IS the
        update's acceptance ack."""
        total = len(p.body)
        base = (
            (base_url if base_url is not None else self.manager_url)
            + f"update_chunk/{p.update_id}"
            + f"?client_id={self.client_id}&key={self.key}"
        )
        try:
            # called under _post_update's "upload" span: trace_headers()
            # picks the active context up, so the probe and every PUT
            # below carry the same traceparent — the manager's assembly
            # ingest span parents off the final chunk's copy of it
            async with self._session.get(
                base, headers=trace_headers()
            ) as resp:
                if resp.status == 401:
                    return 401, self._retry_after_s(resp)
                if resp.status == 200:
                    data = await resp.json()
                    offset = max(0, min(int(data.get("offset", 0)), total))
                else:
                    offset = 0
        except (aiohttp.ClientError, asyncio.TimeoutError,
                TypeError, ValueError):
            return None, None
        if offset:
            self.metrics.inc("chunk_upload_resumes")
            self.metrics.inc("chunk_bytes_resume_skipped", offset)
        resyncs = 0
        while True:
            end = min(offset + self.upload_chunk_bytes, total)
            url = base + f"&offset={offset}&total={total}"
            try:
                self.metrics.inc("chunk_bytes_put", end - offset)
                async with self._session.put(
                    url, data=p.body[offset:end],
                    headers=trace_headers(
                        {"Content-Type": wire.CONTENT_TYPE}
                    ),
                ) as resp:
                    if resp.status == 409:
                        # the manager's committed offset is authoritative
                        resyncs += 1
                        if resyncs > 8:
                            return None, self._retry_after_s(resp)
                        try:
                            data = await resp.json()
                            offset = max(
                                0, min(int(data.get("offset", 0)), total)
                            )
                        except (TypeError, ValueError):
                            return None, None
                        continue
                    if resp.status != 200:
                        return resp.status, self._retry_after_s(resp)
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

    # ------------------------------------------------------------------
    def get_data(self) -> Tuple[dict, int]:
        raise NotImplementedError
