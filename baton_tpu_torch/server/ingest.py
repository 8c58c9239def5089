"""Uplink ingest pipeline — the manager's off-loop decode/fold stages.

The v2 data plane made the *downlink* pull-based and cheap, but
every accepted upload was still wire-decoded, validated, top-k
decompressed, and folded into the streaming accumulator synchronously
on the asyncio event loop. One 100 MB upload therefore stalled every
heartbeat, blob Range GET, and other client's ack for the duration of
a few hundred milliseconds of numpy work — the classic "don't do CPU
work on the loop" failure, at the worst possible place (the hot path
that scales with cohort size).

This module gives the manager a two-stage pipeline instead:

* **decode stage** — a bounded :class:`ThreadPoolExecutor` running
  body decode + payload validation (+ buffered-path decompression).
  Admission is a counted semaphore checked *on the loop*:
  :meth:`IngestPipeline.submit_decode` returns ``None`` when
  ``queue_depth`` jobs are already in flight, and the HTTP handler
  answers ``429 Retry-After`` — backpressure the worker outbox's
  retry/backoff already knows how to honor.

* **fold stage** — ``fold_shards`` single-thread lanes. Submissions
  happen on the event loop *after* acceptance bookkeeping, so each
  lane executes folds in acceptance order (FIFO executor queue), and
  the default ``fold_shards=1`` keeps the StreamingMean fold exactly
  as deterministic as the old on-loop code. ``fold_shards>1`` trades
  that for parallel partial accumulators (see
  :class:`~baton_tpu_torch.ops.aggregation.ShardedStreamingMean`) whose
  weighted partial sums merge at ``end_round`` — associative up to
  fp32 reduction order.

The pipeline reports ``ingest_queue_depth`` (gauge), and
``ingest_decode_s`` / ``ingest_fold_s`` (histogram timers with
p50/p95/p99) through the manager's metrics registry. With a ``tracer``
it also records per-stage ``ingest_decode`` / ``ingest_fold`` spans
into the caller's trace: the context is captured *on the loop* at
submit time (executors don't propagate contextvars), so the spans land
under the handler's ``ingest`` span and the exported round trace shows
queue wait vs. execution per upload.

:class:`ChunkSession` is the server half of the chunked resumable
upload protocol (``PUT /{name}/update_chunk/{update_id}`` with
``offset``/``total`` framing): assembly state for one in-flight upload,
owned by the manager's per-experiment session table.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as _futures_wait
from typing import Any, Callable, List, Optional

from baton_tpu_torch.utils import tracing


class IngestPipeline:
    """Bounded off-loop decode pool + ordered fold lanes.

    Executors are created lazily (an experiment that never receives an
    upload spawns no threads) and torn down by :meth:`shutdown` from the
    app's cleanup hook.
    """

    def __init__(
        self,
        workers: int = 4,
        queue_depth: int = 64,
        fold_shards: int = 1,
        metrics=None,
        retry_after_s: float = 1.0,
        tracer=None,
    ) -> None:
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if fold_shards < 1:
            raise ValueError(f"fold_shards must be >= 1, got {fold_shards}")
        self.workers = int(workers)
        self.queue_depth = int(queue_depth)
        self.retry_after_s = float(retry_after_s)
        self._metrics = metrics
        self._tracer = tracer
        self._lock = threading.Lock()
        self._inflight = 0
        self._decode_pool: Optional[ThreadPoolExecutor] = None
        self._lanes: List[Optional[ThreadPoolExecutor]] = [None] * int(
            fold_shards)

    # ------------------------------------------------------------------
    @property
    def fold_shards(self) -> int:
        return len(self._lanes)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def _pool(self) -> ThreadPoolExecutor:
        if self._decode_pool is None:
            self._decode_pool = ThreadPoolExecutor(
                max_workers=self.workers, thread_name_prefix="ingest-decode")
        return self._decode_pool

    def _lane(self, shard: int) -> ThreadPoolExecutor:
        i = int(shard) % len(self._lanes)
        if self._lanes[i] is None:
            # max_workers=1 is the ordering guarantee: one lane, FIFO
            self._lanes[i] = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"ingest-fold-{i}")
        return self._lanes[i]

    def _set_depth_gauge(self, depth: int) -> None:
        if self._metrics is not None:
            self._metrics.set_gauge("ingest_queue_depth", float(depth))

    # ------------------------------------------------------------------
    def submit_decode(self, fn: Callable[[], Any]):
        """Admit + run ``fn`` on the decode pool.

        Returns an awaitable for ``fn()``'s result, or ``None`` when
        ``queue_depth`` jobs are already in flight — the caller turns
        that into ``429 Retry-After`` (admission control happens here,
        on the loop, *before* any expensive work).
        """
        with self._lock:
            if self._inflight >= self.queue_depth:
                return None
            self._inflight += 1
            depth = self._inflight
        self._set_depth_gauge(depth)
        # executors don't carry contextvars: snapshot the caller's trace
        # context here, on the loop, for the stage span recorded below
        ctx = tracing.current_context() if self._tracer is not None else None

        def run():
            t0 = time.perf_counter()
            w0 = time.time()
            try:
                return fn()
            finally:
                with self._lock:
                    self._inflight -= 1
                    left = self._inflight
                self._set_depth_gauge(left)
                dt = time.perf_counter() - t0
                if self._metrics is not None:
                    self._metrics.observe("ingest_decode_s", dt)
                if ctx is not None:
                    self._tracer.record_span(
                        "ingest_decode", trace_id=ctx[0], parent_id=ctx[1],
                        start=w0, end=w0 + dt,
                    )

        return asyncio.get_running_loop().run_in_executor(self._pool(), run)

    def run_unbounded(self, fn: Callable[[], Any]):
        """Off-loop without admission accounting — for work that was
        already admitted once (e.g. decompressing a buffered upload
        after its acceptance checks passed)."""
        return asyncio.get_running_loop().run_in_executor(self._pool(), fn)

    def submit_fold(self, shard: int, fn: Callable[[], Any]):
        """Queue ``fn`` on the shard's fold lane and return an awaitable.

        Submission order *from the event loop* is acceptance order, and
        the single-thread lane preserves it — so ``fold_shards=1``
        reproduces the sequential on-loop fold bit-for-bit.
        """

        ctx = tracing.current_context() if self._tracer is not None else None

        def run():
            t0 = time.perf_counter()
            w0 = time.time()
            try:
                return fn()
            finally:
                dt = time.perf_counter() - t0
                if self._metrics is not None:
                    self._metrics.observe("ingest_fold_s", dt)
                if ctx is not None:
                    self._tracer.record_span(
                        "ingest_fold", trace_id=ctx[0], parent_id=ctx[1],
                        start=w0, end=w0 + dt, shard=int(shard),
                    )

        return asyncio.wrap_future(self._lane(shard).submit(run))

    def drain_folds(self, timeout: Optional[float] = 30.0) -> None:
        """Block until every already-queued fold has run.

        ``end_round`` calls this before consuming the accumulator: an
        accepted update's 200 ack promised its fold would land in the
        round mean, and a forced finish (watchdog expiry, explicit
        ``end_round``) must not break that promise. Safe to call from
        the loop — lane jobs are pure numpy and never touch the loop.
        """
        barriers = [
            lane.submit(lambda: None)
            for lane in self._lanes if lane is not None
        ]
        if barriers:
            _futures_wait(barriers, timeout=timeout)

    def shutdown(self) -> None:
        """Tear down the executors (app cleanup). Queued folds finish;
        queued decodes are abandoned (their rounds are over anyway)."""
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=False)
            self._decode_pool = None
        for i, lane in enumerate(self._lanes):
            if lane is not None:
                lane.shutdown(wait=True)
                self._lanes[i] = None


@dataclasses.dataclass
class ChunkSession:
    """Server-side assembly state for one chunked resumable upload.

    The committed prefix is :attr:`offset`; a PUT whose ``offset``
    doesn't equal it gets ``409 {"offset": committed}`` and the worker
    resyncs — the manager's committed offset is authoritative. ``busy``
    rejects interleaved PUTs for the same session (a client must send
    chunks sequentially; a retry racing its own zombie connection must
    not corrupt the buffer).

    With a ``spill_dir`` the body lives in a ``<digest>.part`` file
    (plus a ``.meta`` sidecar naming the session) instead of a
    process-memory bytearray: a manager restart rescans the directory
    (:meth:`restore_sessions`) and keeps every committed prefix — the
    worker's next offset probe resumes mid-upload instead of starting
    over — and upload buffering stops being bounded by RAM.
    """

    client_id: str
    update_id: str
    total: int
    buf: bytearray = dataclasses.field(default_factory=bytearray)
    busy: bool = False
    spill_dir: Optional[str] = None
    _spill_size: int = 0

    def __post_init__(self) -> None:
        if self.spill_dir is None:
            return
        os.makedirs(self.spill_dir, exist_ok=True)
        base = self._spill_base(self.spill_dir, self.client_id,
                                self.update_id)
        self._part_path = base + ".part"
        meta_path = base + ".meta"
        if not os.path.exists(meta_path):
            tmp = meta_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump({"client_id": self.client_id,
                           "update_id": self.update_id,
                           "total": self.total}, fh)
            os.replace(tmp, meta_path)
        try:
            self._spill_size = os.path.getsize(self._part_path)
        except OSError:
            self._spill_size = 0

    @staticmethod
    def _spill_base(spill_dir: str, client_id: str, update_id: str) -> str:
        digest = hashlib.sha256(
            f"{client_id}\x00{update_id}".encode("utf-8")
        ).hexdigest()[:24]
        return os.path.join(spill_dir, digest)

    @property
    def offset(self) -> int:
        if self.spill_dir is not None:
            return self._spill_size
        return len(self.buf)

    def extend(self, chunk: bytes) -> None:
        if self.spill_dir is None:
            self.buf.extend(chunk)
            return
        with open(self._part_path, "ab") as fh:
            fh.write(chunk)
            fh.flush()
        self._spill_size += len(chunk)

    def payload(self) -> bytes:
        if self.spill_dir is None:
            return bytes(self.buf)
        try:
            with open(self._part_path, "rb") as fh:
                return fh.read()
        except OSError:
            return b""

    def discard(self) -> None:
        """Release the session's storage (no-op for the in-memory
        path — the bytearray dies with the object)."""
        if self.spill_dir is None:
            return
        base = self._spill_base(self.spill_dir, self.client_id,
                                self.update_id)
        for suffix in (".part", ".meta"):
            try:
                os.remove(base + suffix)
            except OSError:
                pass

    @classmethod
    def restore_sessions(cls, spill_dir: str) -> dict:
        """Rebuild the session table from a spill directory after a
        restart: ``{(client_id, update_id): ChunkSession}`` with each
        offset recomputed from its ``.part`` file's size — the file IS
        the committed prefix. Unreadable sidecars are skipped (a crash
        mid-create loses only that one upload's progress)."""
        out: dict = {}
        try:
            names = os.listdir(spill_dir)
        except OSError:
            return out
        for name in sorted(names):
            if not name.endswith(".meta"):
                continue
            try:
                with open(os.path.join(spill_dir, name), "r",
                          encoding="utf-8") as fh:
                    meta = json.load(fh)
                sess = cls(client_id=str(meta["client_id"]),
                           update_id=str(meta["update_id"]),
                           total=int(meta["total"]),
                           spill_dir=spill_dir)
            except (OSError, ValueError, KeyError, TypeError):
                continue
            out[(sess.client_id, sess.update_id)] = sess
        return out
