"""Client membership registry — pure, clock-injected, asyncio-free.

Reference counterpart: client_manager.py:14-150 (registration, heartbeat,
TTL culling, auth), minus the transport: HTTP fan-out lives in
:mod:`baton_tpu_torch.server.http_manager`, so this core is unit-testable with
a fake clock.

Parity decisions (SURVEY §2.3, §2.9):
* client_id format KEPT: ``client_{name}_{6 chars}`` (client_manager.py:89);
  keys are 32 chars but now cryptographically random (FIXED, utils.py:38-39).
* Callback URL derivation KEPT: client-supplied ``url`` or
  ``http://{remote}:{port}/{name}/`` (client_manager.py:95-99).
* Per-client state KEPT: key/remote/port/last_heartbeat/url/last_update/
  num_updates (client_manager.py:100-109).
* TTL culling KEPT (client_manager.py:129-137); eviction notifications to
  the round manager are the caller's job (fixing the straggler hang).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from baton_tpu_torch.server.utils import json_clean, random_key


class UnknownClient(KeyError):
    pass


class AuthError(Exception):
    pass


@dataclasses.dataclass
class Client:
    client_id: str
    key: str
    remote: Optional[str]
    port: Optional[int]
    url: Optional[str]
    last_heartbeat: float
    registered_at: float
    last_update: Optional[str] = None
    num_updates: int = 0

    def to_json(self) -> dict:
        return json_clean(dataclasses.asdict(self))


class ClientRegistry:
    def __init__(
        self,
        name: str,
        client_ttl: float = 300.0,
        clock: Callable[[], float] = time.time,
        journal=None,
    ):
        self.name = name
        self.client_ttl = client_ttl
        self._clock = clock
        self.journal = journal
        self.clients: Dict[str, Client] = {}

    def _journal(self, event: str, **fields) -> None:
        if self.journal is not None:
            self.journal.append(event, **fields)

    def __len__(self) -> int:
        return len(self.clients)

    def __contains__(self, client_id: str) -> bool:
        return client_id in self.clients

    def __getitem__(self, client_id: str) -> Client:
        try:
            return self.clients[client_id]
        except KeyError:
            raise UnknownClient(client_id) from None

    # ------------------------------------------------------------------
    def register(
        self,
        remote: Optional[str] = None,
        port: Optional[int] = None,
        url: Optional[str] = None,
    ) -> Client:
        client_id = f"client_{self.name}_{random_key(6)}"
        key = random_key(32)
        if not url:
            url = f"http://{remote}:{port}/{self.name}/"
        now = self._clock()
        client = Client(
            client_id=client_id,
            key=key,
            remote=remote,
            port=port,
            url=url,
            last_heartbeat=now,
            registered_at=now,
        )
        # journal before exposing the credential: a crash after the
        # worker learns its key must still find the key on replay
        self._journal(
            "client_registered",
            client_id=client_id, key=key, remote=remote, port=port,
            url=url, registered_at=now,
        )
        self.clients[client_id] = client
        return client

    def restore_client(
        self,
        client_id: str,
        key: str,
        remote: Optional[str] = None,
        port: Optional[int] = None,
        url: Optional[str] = None,
        registered_at: Optional[float] = None,
        num_updates: int = 0,
        last_update: Optional[str] = None,
    ) -> Client:
        """Re-admit a journal-recovered client with its original id and
        auth key. Not journaled (the journal already knows it); the
        heartbeat clock restarts now so recovery downtime doesn't count
        against the TTL."""
        now = self._clock()
        client = Client(
            client_id=client_id,
            key=key,
            remote=remote,
            port=port,
            url=url,
            last_heartbeat=now,
            registered_at=registered_at if registered_at is not None else now,
            last_update=last_update,
            num_updates=int(num_updates or 0),
        )
        self.clients[client_id] = client
        return client

    def heartbeat(self, client_id: str, key: str) -> None:
        self.verify(client_id, key)
        self.clients[client_id].last_heartbeat = self._clock()

    def verify(self, client_id: str, key: str) -> str:
        """Auth check (reference verify_request, client_manager.py:144-150):
        raises UnknownClient / AuthError → HTTP 401 at the edge."""
        if client_id not in self.clients:
            raise UnknownClient(client_id)
        if self.clients[client_id].key != key:
            raise AuthError(client_id)
        return client_id

    def drop(self, client_id: str) -> None:
        if client_id in self.clients:
            self._journal(
                "client_dropped", client_id=client_id, reason="dropped"
            )
        self.clients.pop(client_id, None)

    def cull(self) -> List[str]:
        """Evict clients whose heartbeat is older than the TTL; returns
        evicted ids so the caller can drop them from a running round."""
        now = self._clock()
        stale = [
            cid
            for cid, c in self.clients.items()
            if (now - c.last_heartbeat) > self.client_ttl
        ]
        for cid in stale:
            self._journal("client_dropped", client_id=cid, reason="culled")
            del self.clients[cid]
        return stale

    def record_update(self, client_id: str, round_name: str) -> None:
        c = self.clients.get(client_id)
        if c is not None:
            c.last_update = round_name
            c.num_updates += 1

    def to_json(self) -> list:
        return [c.to_json() for c in self.clients.values()]
