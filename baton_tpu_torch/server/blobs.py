"""Content-addressed blob store — the manager's broadcast data plane.

The reference pushes a full pickled model to every client per round
(reference manager.py:85): ``O(C × model)`` bytes leave the manager in
one burst. Production FL systems invert the direction (Bonawitz et al.
2019, "Towards Federated Learning at Scale"): the notify message is a
tiny envelope and clients *pull* the round payload. This module holds
the pulled side: immutable byte blobs keyed by their SHA-256 digest.

Content addressing buys three properties the push path cannot have:

* **idempotent resume** — a blob never changes under its digest, so an
  interrupted download continues with an HTTP Range request instead of
  restarting, and the client verifies the digest over the assembled
  bytes (integrity comes free);
* **dedup** — a round whose params did not move hashes to the previous
  round's digest, and an anchored worker skips the download entirely;
* **delta negotiation** — a delta blob is just another immutable blob;
  a worker that reconstructs ``anchor + delta`` can re-hash the result
  and KNOW it holds the same bytes a full download would have given it.

The store is deliberately tiny: the manager retains only the current
round's full blob, its delta blob, and the previous full blob (for
stragglers still mid-download when the round rolls), via
:meth:`BlobStore.retain`.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Optional, Tuple


def blob_digest(data) -> str:
    """SHA-256 hex digest of a bytes-like object — the blob's address."""
    return hashlib.sha256(data).hexdigest()


class BlobStore:
    """In-memory ``{digest: (bytes, kind)}`` with explicit retention.

    ``kind`` tags a blob for metrics (``"full"`` vs ``"delta"``); it is
    not part of the address.
    """

    def __init__(self) -> None:
        self._blobs: Dict[str, Tuple[bytes, str]] = {}

    def put(self, data: bytes, kind: str = "full") -> str:
        digest = blob_digest(data)
        # first write wins: blobs are immutable by construction, so a
        # re-put of identical bytes is a no-op (and a re-put of
        # different bytes under one digest is impossible)
        self._blobs.setdefault(digest, (bytes(data), kind))
        return digest

    def get(self, digest: str) -> Optional[Tuple[bytes, str]]:
        return self._blobs.get(digest)

    def retain(self, keep: Iterable[Optional[str]]) -> None:
        """Drop every blob whose digest is not in ``keep``."""
        keep_set = {d for d in keep if d}
        for digest in list(self._blobs):
            if digest not in keep_set:
                del self._blobs[digest]

    def __contains__(self, digest: str) -> bool:
        return digest in self._blobs

    def __len__(self) -> int:
        return len(self._blobs)

    @property
    def total_bytes(self) -> int:
        return sum(len(b) for b, _ in self._blobs.values())
