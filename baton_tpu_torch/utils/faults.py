"""HTTP-layer fault injection for elasticity testing.

The reference's failure handling (heartbeat/TTL cull, eager eviction,
401 re-register — SURVEY §3.3) was only ever exercised by manually
killing processes; there is no fault *injection* anywhere in its tree
(SURVEY §5). This module makes those paths testable deterministically:
an aiohttp middleware that, per matching route, can

* ``error`` — short-circuit with an HTTP status (e.g. 503 heartbeat
  outage, 404 "wrong client" to force re-registration),
* ``delay`` — sleep before proceeding (stragglers; exercises the
  round watchdog's partial aggregation),
* ``drop`` — abort the TCP transport with no response (connection
  reset; exercises the manager's eager-eviction path).

Rules fire a bounded number of ``times`` (default: forever) and record
every hit, so tests assert both the injected failure and the recovery.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Callable, List, Optional

from aiohttp import web


@dataclasses.dataclass
class Rule:
    match: str                      # substring of the request path
    action: str                     # "error" | "delay" | "drop"
    status: int = 503               # for "error"
    delay_s: float = 0.0            # for "delay"
    times: Optional[int] = None     # None = unlimited
    hits: int = 0
    # Optional dynamic guard: the rule only fires while gate() is truthy.
    # Lets a harness flip a standing rule on/off (e.g. an availability
    # curve toggling a worker's 503 refusal) without mutating the rule
    # list from another task mid-iteration.
    gate: Optional[Callable[[], bool]] = None

    def applies(self, path: str) -> bool:
        if self.match not in path:
            return False
        if self.times is not None and self.hits >= self.times:
            return False
        return self.gate is None or bool(self.gate())


def _match_target(request: web.Request) -> str:
    """Rules match against path + query string: worker requests carry
    their identity in the query (``update?client_id=...``), and per-client
    faults (drop ONE worker's uploads, not the route) need to see it."""
    return request.path_qs


class FaultInjector:
    """Attach to any app (manager or worker) at construction time:

        inj = FaultInjector()
        app = web.Application(middlewares=[inj.middleware])
        inj.error("heartbeat", status=503, times=2)
    """

    def __init__(self) -> None:
        self.rules: List[Rule] = []

        @web.middleware
        async def middleware(request: web.Request, handler):
            for rule in self.rules:
                if not rule.applies(_match_target(request)):
                    continue
                rule.hits += 1
                if rule.action == "error":
                    return web.json_response(
                        {"err": "injected fault"}, status=rule.status
                    )
                if rule.action == "delay":
                    await asyncio.sleep(rule.delay_s)
                elif rule.action == "drop":
                    if request.transport is not None:
                        request.transport.abort()
                    raise ConnectionResetError("injected connection drop")
            return await handler(request)

        self.middleware = middleware

    # ------------------------------------------------------------------
    def error(self, match: str, status: int = 503, times: Optional[int] = None,
              gate: Optional[Callable[[], bool]] = None) -> Rule:
        rule = Rule(match=match, action="error", status=status, times=times,
                    gate=gate)
        self.rules.append(rule)
        return rule

    def delay(self, match: str, seconds: float, times: Optional[int] = None,
              gate: Optional[Callable[[], bool]] = None) -> Rule:
        rule = Rule(match=match, action="delay", delay_s=seconds, times=times,
                    gate=gate)
        self.rules.append(rule)
        return rule

    def drop(self, match: str, times: Optional[int] = None,
             gate: Optional[Callable[[], bool]] = None) -> Rule:
        rule = Rule(match=match, action="drop", times=times, gate=gate)
        self.rules.append(rule)
        return rule

    def clear(self) -> None:
        self.rules.clear()

    def remove(self, rule: Rule) -> None:
        """Detach one rule (phase-scoped faults end with their phase)."""
        try:
            self.rules.remove(rule)
        except ValueError:
            pass
