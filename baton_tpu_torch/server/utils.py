"""Control-plane utilities.

Replaces reference utils.py with deliberate fixes (SURVEY §2.9 decisions):

* ``random_key`` — cryptographic (``secrets``), any length, with
  replacement. The reference used ``random.sample(ascii_letters, n)``:
  non-crypto, no repeated chars, max length 52 (utils.py:38-39). FIXED.
* ``json_clean`` — same semantics as utils.py:23-35: strips ``key`` and
  ``state_dict`` fields so secrets/bulk tensors never leak into JSON
  introspection responses; stringifies datetimes; tuplifies sets. KEPT.
* ``RunningMean`` — exact weighted mean. The reference's EpochProgress
  running mean is biased (utils.py:85-88: inputs [4,2,6] → 4.75, true
  mean 4.0). FIXED.
* ``PeriodicTask`` — periodic scheduling for heartbeats/culling. Same
  *capability* as reference utils.py:42-67, different mechanism: an
  ``asyncio.Event``-gated wait loop (stop is a prompt event set, not a
  task cancellation), optional immediate first tick, and exception
  logging so one failed tick doesn't silently kill the schedule.
"""

from __future__ import annotations

import asyncio
import json
import secrets
import string
from contextlib import suppress
from datetime import datetime
from typing import Any

_ALPHABET = string.ascii_letters + string.digits


def random_key(length: int = 32) -> str:
    """Cryptographically random URL-safe token of ``length`` chars."""
    return "".join(secrets.choice(_ALPHABET) for _ in range(length))


def json_clean(data: Any) -> Any:
    """Recursively sanitize a structure for JSON responses.

    Drops ``key``/``state_dict`` entries (credentials and bulk tensors),
    stringifies datetimes, tuplifies sets — reference utils.py:23-35
    semantics, extended to lists/tuples.
    """
    if isinstance(data, dict):
        return {
            k: json_clean(v)
            for k, v in data.items()
            if k not in ("key", "state_dict")
        }
    if isinstance(data, (list, tuple)):
        return [json_clean(v) for v in data]
    if isinstance(data, set):
        return [json_clean(v) for v in sorted(data, key=str)]
    if isinstance(data, datetime):
        return str(data)
    return data


async def bounded_gather(*coros, limit: int, return_exceptions: bool = False):
    """``asyncio.gather`` behind a concurrency window.

    A 1024-client round must not mean 1024 simultaneous sockets/file
    descriptors out of the manager (Bonawitz et al. 2019 pace their
    fan-out the same way): at most ``limit`` of the given coroutines run
    at once, the rest wait on a semaphore. Results keep input order.

    Failure semantics match ``gather(return_exceptions=True)`` wrapped
    in a re-raise: one failing coroutine never cancels its siblings —
    every coroutine runs to completion, and only then is the first
    exception raised (or, with ``return_exceptions=True``, exceptions
    are returned in place like plain gather).
    """
    if limit <= 0:
        raise ValueError(f"limit must be positive, got {limit}")
    sem = asyncio.Semaphore(limit)

    async def windowed(coro):
        async with sem:
            return await coro

    results = await asyncio.gather(
        *(windowed(c) for c in coros), return_exceptions=True
    )
    if not return_exceptions:
        for r in results:
            if isinstance(r, BaseException):
                raise r
    return results


class BodyTooLarge(Exception):
    """Raised by :func:`read_body_capped` when a request body exceeds
    the configured cap — the handler answers ``413``."""

    def __init__(self, limit: int, seen: int) -> None:
        super().__init__(f"request body exceeds {limit} bytes (saw >= {seen})")
        self.limit = limit
        self.seen = seen


async def read_body_capped(request, limit):
    """Read an aiohttp request body under a byte cap.

    Two layers of enforcement (the old
    ``await request.read()`` buffered whatever the peer sent):

    * declared size — a ``Content-Length`` above ``limit`` is rejected
      at the door, before a single body byte is read;
    * streamed cap — a chunked-transfer (or lying) client is cut off as
      soon as the accumulated bytes pass ``limit``, so the manager never
      buffers more than ``limit + 64KiB``.

    ``limit=None`` means uncapped (legacy behavior, explicit opt-out).
    Raises :class:`BodyTooLarge`; returns ``bytes`` otherwise.
    """
    if limit is None:
        # explicit opt-out: this IS the uncapped path callers chose
        return await request.read()  # batonlint: allow[BTL020]
    limit = int(limit)
    declared = request.content_length
    if declared is not None and declared > limit:
        raise BodyTooLarge(limit, declared)
    buf = bytearray()
    async for chunk in request.content.iter_chunked(1 << 16):
        buf.extend(chunk)
        if len(buf) > limit:
            raise BodyTooLarge(limit, len(buf))
    return bytes(buf)


# Control-plane JSON (register, heartbeat, secure-agg key/share
# exchange) is a few KiB in the worst case; 4 MiB is two orders of
# magnitude of headroom while still bounding a hostile POST.
MAX_JSON_BODY = 4 << 20


async def read_json_capped(request, limit=MAX_JSON_BODY):
    """Parse a JSON request body under a byte cap.

    The ``await request.json()`` convenience buffers the whole body
    before parsing — on control endpoints that is an unbounded
    allocation driven by the peer. This reads through
    :func:`read_body_capped` (Content-Length precheck + streamed
    cut-off) and parses the result, so control handlers get the same
    413 semantics as the upload path. Raises :class:`BodyTooLarge` on
    oversize and ``json.JSONDecodeError``/``UnicodeDecodeError`` on a
    malformed body (callers already answer 400 for those).
    """
    body = await read_body_capped(request, limit)
    return json.loads(body.decode("utf-8"))


class RunningMean:
    """Exact (optionally weighted) running mean."""

    def __init__(self) -> None:
        self.total = 0.0
        self.weight = 0.0

    def update(self, value: float, weight: float = 1.0) -> None:
        self.total += float(value) * float(weight)
        self.weight += float(weight)

    @property
    def mean(self) -> float:
        return self.total / self.weight if self.weight else 0.0


class PeriodicTask:
    """Run an async callable every ``interval`` seconds until stopped.

    Stop is signalled through an :class:`asyncio.Event` rather than task
    cancellation: a tick in progress finishes cleanly, and ``stop()``
    returns as soon as the loop observes the event (at worst one
    ``interval``'s wait, interrupted immediately by the event). A tick
    that raises is logged and the schedule continues — a transient
    heartbeat failure must not kill liveness checking.
    """

    def __init__(self, func, interval: float, run_immediately: bool = False):
        self.func = func
        self.interval = interval
        self.run_immediately = run_immediately
        self._stop = asyncio.Event()
        self._stop.set()  # not running
        self._loop_task: asyncio.Task | None = None

    @property
    def is_started(self) -> bool:
        return not self._stop.is_set()

    def is_current_task(self) -> bool:
        """True when called from inside this schedule's own tick — used
        to avoid await-on-self deadlocks in restart paths."""
        return (
            self._loop_task is not None
            and self._loop_task is asyncio.current_task()
        )

    def start(self) -> "PeriodicTask":
        if self._stop.is_set():
            self._stop = asyncio.Event()
            self._loop_task = asyncio.get_event_loop().create_task(
                self._schedule()
            )
        return self

    async def stop(self, cancel: bool = False) -> None:
        """Signal the schedule to end and wait for it. ``cancel`` also
        cancels a tick in flight instead of waiting for it: at shutdown a
        tick may be retrying a peer that is already gone, and would never
        end (a worker's heartbeat against a stopped manager)."""
        self._stop.set()
        if self._loop_task is not None:
            if cancel:
                self._loop_task.cancel()
            with suppress(asyncio.CancelledError):
                await self._loop_task
            self._loop_task = None

    async def _tick(self) -> None:
        try:
            await self.func()
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # keep the schedule alive
            print(f"PeriodicTask({getattr(self.func, '__name__', self.func)}): "
                  f"tick failed: {exc!r}")

    async def _schedule(self) -> None:
        # intentional identity capture: if the task is stopped and
        # restarted, self._stop is replaced — THIS schedule must keep
        # honoring its own generation's stop event, not the new one.
        stop = self._stop  # batonlint: allow[BTL003]
        if self.run_immediately and not stop.is_set():
            await self._tick()
        while not stop.is_set():
            # wait_for(stop.wait(), interval): either the interval elapses
            # (TimeoutError -> run a tick) or stop fires (exit promptly)
            try:
                await asyncio.wait_for(stop.wait(), timeout=self.interval)
                return
            except asyncio.TimeoutError:
                await self._tick()
