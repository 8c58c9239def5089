"""Helpers for the port's socket tests (not a test module).

* :func:`run_bounded` runs a test's coroutine under its own wall-clock
  limit: ``asyncio.run`` in a daemon thread, joined with a timeout. At the
  limit the test fails with every thread's stack
  (``faulthandler.dump_traceback(all_threads=True)``), so a hang names
  where it blocks instead of stalling the whole run.
* :func:`listen` binds a port below the ephemeral range and keeps the
  socket open;
  :func:`serve` hands that very socket to aiohttp (``web.SockSite``). No
  port is closed and re-bound, so parallel test processes cannot race
  for it. :func:`reserve_port` and :func:`tcp_site` do the same for the
  reference's socket cases run against the port, in place of their
  ``free_port()`` and ``web.TCPSite`` (``_torch_carried_cases`` seams),
  and :func:`engine_sockets` in place of the loadgen engine's own.
"""

from __future__ import annotations

import asyncio
import contextlib
import faulthandler
import random
import socket
import tempfile
import threading

import pytest
from aiohttp import web

# A federation round of the linear model takes well under a second on one
# core; a test here runs a few. The limit only bounds a hang.
LIMIT_S = 60.0


def run_bounded(coro_fn, limit_s: float = LIMIT_S):
    """Run ``coro_fn()`` to completion in its own event loop within
    ``limit_s`` seconds; return its result or raise its exception."""
    out = {}

    def target():
        try:
            out["value"] = asyncio.run(coro_fn())
        except BaseException as exc:  # handed to the test thread below
            out["error"] = exc

    thread = threading.Thread(target=target, name="bounded-test", daemon=True)
    thread.start()
    thread.join(limit_s)
    if thread.is_alive():
        with tempfile.TemporaryFile("w+") as fh:
            faulthandler.dump_traceback(file=fh, all_threads=True)
            fh.seek(0)
            stacks = fh.read()
        pytest.fail(f"the test passed its {limit_s:.0f} s limit; every thread's "
                    f"stack:\n{stacks}", pytrace=False)
    if "error" in out:
        raise out["error"]
    return out.get("value")


# Ports just below Linux's default ephemeral range (32768-60999). The JAX
# package's socket tests, running in parallel processes beside these,
# take a port with bind(0), close it and bind it again later; a port taken
# from the ephemeral range here could be the one they are about to bind.
_PORTS = range(24576, 32768)


def listen():
    """``(socket, port)``: a TCP socket bound to a free loopback port below
    the ephemeral range, kept open for :func:`serve`."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    for port in random.sample(_PORTS, 256):
        try:
            sock.bind(("127.0.0.1", port))
            return sock, port
        except OSError:
            continue
    sock.bind(("127.0.0.1", 0))
    return sock, sock.getsockname()[1]


async def serve(app: web.Application, sock) -> web.AppRunner:
    """Serve ``app`` on the already bound ``sock``; returns the runner
    (``await runner.cleanup()`` stops it)."""
    runner = web.AppRunner(app)
    await runner.setup()
    await web.SockSite(runner, sock).start()
    return runner


async def wait_until(cond, timeout_s: float = 20.0, dt: float = 0.02) -> bool:
    """Poll ``cond()`` until it holds or ``timeout_s`` passes."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while loop.time() < deadline:
        if cond():
            return True
        await asyncio.sleep(dt)
    return cond()


# ports reserved by reserve_port(), each with its bound socket, until
# tcp_site() serves it
_RESERVED = {}


def reserve_port() -> int:
    """An ephemeral port bound now and kept open until :func:`tcp_site`
    serves it."""
    sock, port = listen()
    _RESERVED[port] = sock
    return port


def tcp_site(runner: web.AppRunner, host: str, port: int) -> web.SockSite:
    """``web.TCPSite(runner, host, port)`` on the socket that
    :func:`reserve_port` holds for ``port``."""
    return web.SockSite(runner, _RESERVED.pop(port))


# the seams that put these in place of a reference case's own
SOCKET_SEAMS = (("= free_port()", "= reserve_port()"), ("web.TCPSite(", "tcp_site("))


class _EngineWeb:
    """``aiohttp.web`` as the loadgen engine sees it under
    :func:`engine_sockets`: ``TCPSite`` serves the socket that
    :func:`reserve_port` bound."""

    TCPSite = staticmethod(tcp_site)

    def __getattr__(self, name):
        return getattr(web, name)


@contextlib.contextmanager
def engine_sockets():
    """Within this block the loadgen engine (``baton_tpu_torch.loadgen.
    engine``) binds its servers' ports with :func:`reserve_port` and serves
    them with :func:`tcp_site`, in place of its close-and-rebind
    ``_free_port`` and ``web.TCPSite``."""
    from baton_tpu_torch.loadgen import engine

    free_port, web_ = engine._free_port, engine.web
    engine._free_port, engine.web = reserve_port, _EngineWeb()
    try:
        yield
    finally:
        engine._free_port, engine.web = free_port, web_
