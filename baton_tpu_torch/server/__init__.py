"""Elastic control plane — the edge of the framework.

The TPU simulation engine (baton_tpu_torch.parallel) covers *simulated*
clients; this package keeps the reference's capability for *real*
external clients: register / heartbeat / cull / re-register membership,
round orchestration, and sample-weighted aggregation of uploaded weights,
speaking the reference wire protocol (SURVEY §2.8: same routes, same
status codes 400/401/404/409/410/423).

Architecture difference from the reference: the round state machine
(:mod:`rounds`) and membership registry (:mod:`registry`) are pure,
clock-injected Python — no asyncio, trivially unit-testable — and the
aiohttp layer (:mod:`http_manager`, :mod:`http_worker`) is a thin
adapter. The reference interleaves both (update_manager.py's state *is*
an asyncio.Lock, client_manager.py owns an aiohttp session).
"""

from baton_tpu_torch.server.rounds import (
    RoundManager,
    RoundError,
    RoundInProgress,
    RoundNotInProgress,
)
from baton_tpu_torch.server.registry import ClientRegistry, AuthError, UnknownClient

__all__ = [
    "RoundManager",
    "RoundError",
    "RoundInProgress",
    "RoundNotInProgress",
    "ClientRegistry",
    "AuthError",
    "UnknownClient",
]
