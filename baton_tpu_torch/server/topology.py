"""Declarative worker→edge assignment for the hierarchical tier.

The topology is a classic consistent-hash ring: every edge aggregator
owns ``replicas`` pseudo-random points on a 2^64 ring (derived from
SHA-256 of ``"{edge_id}#{i}"``), and a worker maps to the first live
edge point clockwise from the hash of its own id. Properties we lean
on:

- **Deterministic.** Assignment is a pure function of (edge ids, live
  set, worker id) — every component (load generator, benchmarks, an
  operator reading a config) computes the same mapping without
  coordination.
- **Minimal disruption.** When an edge dies, only the workers that
  hashed to its points move (to the next live point clockwise); the
  rest of the fleet keeps its edge and its warm blob cache.
- **Degrade, don't stall.** With zero live edges :meth:`assign`
  returns ``None`` — the caller's contract is that ``None`` means
  *direct to root*. A lost tier degrades fan-in, it never wedges a
  round.

No asyncio, no I/O: the liveness flags are plain state owned by
whoever drives the topology (the loadgen engine flips them when it
kills an edge; a production control plane would drive them from
heartbeats).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple


def _ring_hash(key: str) -> int:
    """Stable 64-bit ring position (first 8 bytes of SHA-256)."""
    return int.from_bytes(
        hashlib.sha256(key.encode("utf-8")).digest()[:8], "big"
    )


class EdgeTopology:
    """Consistent-hash assignment of workers to edge aggregators.

    ``edges`` is the full declared set of edge ids (order-insensitive);
    ``replicas`` points per edge trade balance for ring size (128 keeps
    the max/mean cohort skew under ~1.3 for small E).
    """

    def __init__(self, edges: Sequence[str], replicas: int = 128) -> None:
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        ids = list(edges)
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate edge ids: {ids}")
        self.replicas = replicas
        self._dead: set = set()
        # sorted (point, edge_id) ring; bisect on the point column
        ring: List[Tuple[int, str]] = []
        for eid in ids:
            for i in range(replicas):
                ring.append((_ring_hash(f"{eid}#{i}"), eid))
        ring.sort()
        self._ring = ring
        self._points = [p for p, _ in ring]
        self._edges = ids

    @property
    def edges(self) -> List[str]:
        return list(self._edges)

    def live_edges(self) -> List[str]:
        return [e for e in self._edges if e not in self._dead]

    def is_live(self, edge_id: str) -> bool:
        return edge_id in self._edges and edge_id not in self._dead

    def mark_dead(self, edge_id: str) -> None:
        if edge_id not in self._edges:
            raise KeyError(edge_id)
        self._dead.add(edge_id)

    def mark_alive(self, edge_id: str) -> None:
        if edge_id not in self._edges:
            raise KeyError(edge_id)
        self._dead.discard(edge_id)

    def assign(self, worker_id: str) -> Optional[str]:
        """Edge id owning ``worker_id``, or ``None`` when no edge is
        live (callers route direct to root)."""
        if not self._ring or len(self._dead) >= len(self._edges):
            return None
        start = bisect.bisect_right(self._points, _ring_hash(worker_id))
        n = len(self._ring)
        for off in range(n):
            _, eid = self._ring[(start + off) % n]
            if eid not in self._dead:
                return eid
        return None

    def cohorts(self, worker_ids: Sequence[str]) -> Dict[Optional[str], List[str]]:
        """Group ``worker_ids`` by assigned edge (``None`` bucket =
        direct to root)."""
        out: Dict[Optional[str], List[str]] = {}
        for wid in worker_ids:
            out.setdefault(self.assign(wid), []).append(wid)
        return out
