"""Write-ahead journal for the manager control plane.

The paper's failure model (heartbeat/TTL culling, 401 re-registration)
assumes the *manager* never dies: the client registry — ids, auth keys,
callback URLs — and the running round's state live only in process
memory, so a coordinator crash forgets every credential it ever issued
and silently discards the in-flight round's training. Production FL
coordinators journal exactly this state (Bonawitz et al., *Towards
Federated Learning at Scale*, §4: the "master" persists its state so a
restart is a pause, not an amnesia event).

This module is the durability layer: an append-only JSONL journal of
control-plane *events*, replayed on boot to rebuild the registry and
round state. Model params are NOT journaled — they ride the existing
orbax :class:`baton_tpu_torch.utils.checkpoint.Checkpointer`; the journal
covers the cheap-but-critical metadata the checkpoint does not.

Design points:

* **Event vocabulary** (one JSON object per line, ``{"event": ...}``):
  ``client_registered`` / ``client_dropped`` for membership,
  ``round_started`` / ``round_client_joined`` / ``round_client_dropped``
  / ``update_accepted`` / ``round_ended`` / ``round_aborted`` /
  ``losses_appended`` for rounds. ``update_accepted`` carries the
  upload's dedup key (``update_id``) — the at-least-once worker outbox
  (http_worker.py) may deliver the same update many times, and the
  buffered-aggregation weighting (FedBuff, Nguyen et al.) is only
  correct if each update is folded in exactly once.
* **fsync policy**: ``"always"`` (default — fsync every append; an
  acknowledged state transition survives power loss), ``"never"``
  (flush to the OS only), or a float (minimum seconds between fsyncs —
  bounded-loss batching for hot registries).
* **Compaction**: :meth:`Journal.compact` writes a snapshot of the full
  control-plane state atomically (temp file + rename, same discipline
  as orbax) and truncates the journal. The manager piggybacks this on
  its per-round checkpoint, so the journal only ever holds events since
  the last completed round.
* **Torn writes**: a crash mid-append leaves a partial final line;
  :meth:`Journal.load` skips undecodable lines (warning, not error), so
  recovery always sees the longest valid prefix.

Auth keys are what make "workers keep their credentials across a
manager restart" possible, so they must be journaled — but not in the
clear: when ``BATON_JOURNAL_KEY`` is set (a passphrase, or a path to a
file holding one) every ``key`` field — and the ``data`` body of
``update_payload`` events, which carries a client's model update —
is wrapped at the append/compact boundary (``enc1:`` envelope:
HMAC-SHA256 keystream + truncated-HMAC tag, stdlib only) and unwrapped
transparently on load. Legacy plaintext journals keep reading as-is —
migration is "set the env var and let the next compaction rewrite the
snapshot". A wrapped key that cannot be unwrapped (env var lost, or
wrong) degrades to ``None``: the client re-registers instead of anyone
trusting an unverifiable credential; an unverifiable payload likewise
degrades to None, so recovery rebroadcasts the round rather than
replaying bytes it cannot authenticate. Replication
(:mod:`baton_tpu_torch.server.replication`) ships journal bytes verbatim, so
standbys see only wrapped keys/payloads on the wire and need the same
``BATON_JOURNAL_KEY`` to serve after promotion.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

_log = logging.getLogger(__name__)

SNAPSHOT_SUFFIX = ".snapshot"

#: env var naming the at-rest wrap key: either the passphrase itself or
#: a path to a file whose (stripped) contents are the passphrase
WRAP_KEY_ENV = "BATON_JOURNAL_KEY"
_WRAP_PREFIX = "enc1:"


def load_wrap_key(env: str = WRAP_KEY_ENV) -> Optional[bytes]:
    """Resolve the at-rest wrap key from the environment; None (no
    wrapping) when unset. A value that names a readable file is
    dereferenced so the secret can live outside the process table."""
    raw = os.environ.get(env)
    if not raw:
        return None
    if os.path.isfile(raw):
        try:
            with open(raw, "r", encoding="utf-8") as fh:
                raw = fh.read().strip()
        except OSError as exc:
            _log.warning("%s names an unreadable file (%s); at-rest key "
                         "wrapping disabled", env, exc)
            return None
        if not raw:
            return None
    return hashlib.sha256(raw.encode("utf-8")).digest()


def _keystream(wk: bytes, nonce: bytes, n: int) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < n:
        out.extend(hmac.new(wk, b"ks" + nonce + counter.to_bytes(4, "big"),
                            hashlib.sha256).digest())
        counter += 1
    return bytes(out[:n])


def wrap_value(plain: str, wk: bytes) -> str:
    """``enc1:<nonce>:<ciphertext>:<tag>`` (hex fields) — encrypt-then-
    MAC with independent HMAC-derived keystream and tag, stdlib only
    (the serving image carries no cryptography package)."""
    nonce = os.urandom(12)
    pt = plain.encode("utf-8")
    ct = bytes(a ^ b for a, b in zip(pt, _keystream(wk, nonce, len(pt))))
    tag = hmac.new(wk, b"tag" + nonce + ct, hashlib.sha256).digest()[:16]
    return _WRAP_PREFIX + nonce.hex() + ":" + ct.hex() + ":" + tag.hex()


def unwrap_value(value: Any, wk: Optional[bytes]) -> Optional[str]:
    """Inverse of :func:`wrap_value` with two deliberate degradations:
    a non-``enc1:`` value passes through untouched (legacy plaintext
    journals), and a wrapped value that cannot be verified — missing
    key, wrong key, mangled envelope — becomes None so the client
    re-registers rather than anyone trusting an unchecked credential."""
    if not isinstance(value, str) or not value.startswith(_WRAP_PREFIX):
        return value
    if wk is None:
        _log.warning("journal holds wrapped auth keys but %s is unset; "
                     "dropping keys (clients will re-register)",
                     WRAP_KEY_ENV)
        return None
    try:
        nonce_hex, ct_hex, tag_hex = value[len(_WRAP_PREFIX):].split(":")
        nonce = bytes.fromhex(nonce_hex)
        ct = bytes.fromhex(ct_hex)
        tag = bytes.fromhex(tag_hex)
    except ValueError:
        return None
    want = hmac.new(wk, b"tag" + nonce + ct, hashlib.sha256).digest()[:16]
    if not hmac.compare_digest(tag, want):
        _log.warning("journaled auth key failed unwrap (wrong %s?); "
                     "dropping key", WRAP_KEY_ENV)
        return None
    pt = bytes(a ^ b for a, b in zip(ct, _keystream(wk, nonce, len(ct))))
    return pt.decode("utf-8", "replace")


class Journal:
    """Append-only JSONL event log with snapshot+truncate compaction."""

    def __init__(self, path: str, fsync: Any = "always"):
        if fsync not in ("always", "never") and not isinstance(
            fsync, (int, float)
        ):
            raise ValueError(
                f"fsync must be 'always', 'never' or seconds, got {fsync!r}"
            )
        self.path = os.path.abspath(path)
        self.snapshot_path = self.path + SNAPSHOT_SUFFIX
        self.fsync = fsync
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._last_fsync = 0.0
        self.appends = 0
        #: bumps on every compaction — the WAL shipper's frame id, since
        #: compaction truncates the file and resets byte offsets
        self.generation = 0
        #: makes (generation, journal bytes, snapshot file) one atomic
        #: frame: the WAL shipper builds segments on a worker thread
        #: holding this, so a compaction (truncate + generation bump) on
        #: the loop can never tear a segment mid-read.  A threading.Lock
        #: because the reader is NOT on the event loop.
        self.io_lock = threading.Lock()
        self._wrap_key = load_wrap_key()

    # ------------------------------------------------------------------
    def append(self, event: str, **fields: Any) -> None:
        """Durably record one control-plane event."""
        if self._wrap_key is not None and isinstance(fields.get("key"), str):
            fields = dict(fields, key=wrap_value(fields["key"],
                                                 self._wrap_key))
        if (self._wrap_key is not None and event == "update_payload"
                and isinstance(fields.get("data"), str)):
            # a journaled upload body is model-update content — at rest
            # it gets the same envelope as auth keys, and the WAL ships
            # it wrapped so standbys never hold plaintext training bytes
            fields = dict(fields, data=wrap_value(fields["data"],
                                                  self._wrap_key))
        rec = {"event": event, **fields}
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        # brief critical section: a segment build holding io_lock on a
        # worker thread sees either all of this append or none of it
        with self.io_lock:
            self._fh.write(line)
            self._fh.flush()
            self._maybe_fsync()
            self.appends += 1

    def _maybe_fsync(self) -> None:
        if self.fsync == "never":
            return
        if self.fsync == "always":
            os.fsync(self._fh.fileno())
            return
        now = time.monotonic()
        if now - self._last_fsync >= float(self.fsync):
            os.fsync(self._fh.fileno())
            self._last_fsync = now

    # ------------------------------------------------------------------
    def load(self) -> Tuple[Optional[dict], List[dict]]:
        """(snapshot | None, events) currently on disk — the recovery
        input. Undecodable journal lines (torn final write) are skipped
        with a warning so the longest valid prefix always replays."""
        snapshot = None
        if os.path.exists(self.snapshot_path):
            try:
                with open(self.snapshot_path, "r", encoding="utf-8") as fh:
                    snapshot = json.load(fh)
            except (OSError, json.JSONDecodeError) as exc:
                # a half-written snapshot cannot happen (atomic rename),
                # so this is real corruption — recover from events alone
                _log.warning("journal snapshot unreadable (%s); ignoring", exc)
        events: List[dict] = []
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                for lineno, line in enumerate(fh, 1):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        _log.warning(
                            "journal %s line %d undecodable (torn write?); "
                            "skipped", self.path, lineno)
                        continue
                    if isinstance(rec, dict) and "event" in rec:
                        events.append(rec)
        except OSError:
            pass
        # transparent at-rest unwrap: plaintext legacy values pass
        # through, unverifiable wrapped values degrade to None
        if snapshot:
            for c in (snapshot.get("clients") or {}).values():
                if isinstance(c, dict) and "key" in c:
                    c["key"] = unwrap_value(c["key"], self._wrap_key)
        for rec in events:
            if "key" in rec:
                rec["key"] = unwrap_value(rec["key"], self._wrap_key)
            if rec.get("event") == "update_payload" and "data" in rec:
                # unverifiable body → None → replay keeps the event but
                # _resume_round sees no payload and rebroadcasts; the
                # round degrades to re-training, never to bad tensors
                rec["data"] = unwrap_value(rec["data"], self._wrap_key)
        return snapshot, events

    def recover(self) -> "RecoveredState":
        snapshot, events = self.load()
        return replay(snapshot, events)

    # ------------------------------------------------------------------
    def compact(self, snapshot: dict) -> None:
        """Write ``snapshot`` atomically, then truncate the journal.

        Call only at a quiescent point (no round in flight): the
        snapshot schema carries membership and history, not an open
        round, so compacting mid-round would forget it."""
        if self._wrap_key is not None and snapshot.get("clients"):
            snapshot = dict(snapshot, clients={
                cid: (dict(c, key=wrap_value(c["key"], self._wrap_key))
                      if isinstance(c.get("key"), str)
                      and not c["key"].startswith(_WRAP_PREFIX)
                      else dict(c))
                for cid, c in snapshot["clients"].items()
            })
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(snapshot, fh, separators=(",", ":"))
            fh.flush()
            os.fsync(fh.fileno())
        # io_lock spans snapshot publication, truncation and the
        # generation bump: a concurrent segment build must see the
        # pre-compaction frame or the post-compaction frame, never a
        # fresh snapshot with a stale generation
        with self.io_lock:
            os.replace(tmp, self.snapshot_path)
            # events up to here are superseded by the snapshot: truncate
            self._fh.close()
            self._fh = open(self.path, "w", encoding="utf-8")
            self._fh.flush()
            if self.fsync != "never":
                os.fsync(self._fh.fileno())
            # byte offsets restart from zero — a new shipping generation
            self.generation += 1

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            if self.fsync != "never":
                os.fsync(self._fh.fileno())
            self._fh.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ----------------------------------------------------------------------
@dataclasses.dataclass
class RecoveredState:
    """Control-plane state rebuilt from snapshot + journal replay."""

    clients: Dict[str, dict] = dataclasses.field(default_factory=dict)
    n_rounds: int = 0
    loss_history: List[float] = dataclasses.field(default_factory=list)
    #: the in-flight round at crash time, or None:
    #: {round_name, meta, participants: [ids], accepted: {cid: update_id},
    #:  payloads: {cid: {data: b64, content_type}}}
    open_round: Optional[dict] = None
    #: highest leadership epoch ever journaled (``ha_lease`` events +
    #: compaction snapshots) — 0 when replication was never enabled.
    #: A promoting standby serves at ``ha_epoch + 1``.
    ha_epoch: int = 0
    #: True when neither snapshot nor events existed — a fresh journal
    #: must not override e.g. a checkpoint-restored round counter.
    empty: bool = True


def replay(
    snapshot: Optional[dict], events: Iterable[dict]
) -> RecoveredState:
    """Fold snapshot + events into the state the manager died with.

    Replay is pure and total: unknown event types are ignored (forward
    compatibility), events referencing unknown clients/rounds are
    no-ops, so any valid journal prefix produces a usable state."""
    st = RecoveredState()
    if snapshot:
        st.empty = False
        st.clients = {
            str(cid): dict(c) for cid, c in (snapshot.get("clients") or {}).items()
        }
        st.n_rounds = int(snapshot.get("n_rounds", 0))
        st.loss_history = [float(x) for x in snapshot.get("loss_history", [])]
        st.ha_epoch = int(snapshot.get("ha_epoch", 0))
    for ev in events:
        st.empty = False
        kind = ev.get("event")
        cid = ev.get("client_id")
        if kind == "client_registered":
            st.clients[cid] = {
                k: ev.get(k)
                for k in ("key", "remote", "port", "url", "registered_at")
            }
            st.clients[cid].setdefault("num_updates", 0)
        elif kind == "client_dropped":
            st.clients.pop(cid, None)
            if st.open_round is not None:
                st.open_round["participants"].discard(cid)
                st.open_round["accepted"].pop(cid, None)
                st.open_round["payloads"].pop(cid, None)
        elif kind == "round_started":
            st.open_round = {
                "round_name": ev.get("round_name"),
                "meta": ev.get("meta") or {},
                "participants": set(),
                "accepted": {},
                "payloads": {},
            }
        elif kind == "round_client_joined":
            if st.open_round is not None:
                st.open_round["participants"].add(cid)
        elif kind == "round_client_dropped":
            if st.open_round is not None:
                st.open_round["participants"].discard(cid)
                st.open_round["accepted"].pop(cid, None)
                st.open_round["payloads"].pop(cid, None)
        elif kind == "update_payload":
            # the accepted upload's bytes, riding the WAL so a standby
            # can finish the round without re-training the reporter
            if (st.open_round is not None
                    and ev.get("round_name") == st.open_round["round_name"]):
                st.open_round["payloads"][cid] = {
                    "data": ev.get("data"),
                    "content_type": ev.get("content_type"),
                }
        elif kind == "ha_lease":
            with_epoch = ev.get("epoch")
            if isinstance(with_epoch, (int, float)):
                st.ha_epoch = max(st.ha_epoch, int(with_epoch))
        elif kind == "update_accepted":
            if st.open_round is not None:
                st.open_round["accepted"][cid] = ev.get("update_id")
            c = st.clients.get(cid)
            if c is not None:
                c["num_updates"] = int(c.get("num_updates") or 0) + 1
                c["last_update"] = ev.get("round_name")
        elif kind == "round_ended":
            st.n_rounds = int(ev.get("n_rounds", st.n_rounds + 1))
            st.open_round = None
        elif kind == "round_aborted":
            st.open_round = None
        elif kind == "losses_appended":
            st.loss_history.extend(float(x) for x in ev.get("values", []))
    return st


def registry_snapshot(registry) -> Dict[str, dict]:
    """The per-client snapshot schema (mirrors ``client_registered``
    event fields) from a live :class:`ClientRegistry`."""
    return {
        cid: {
            "key": c.key,
            "remote": c.remote,
            "port": c.port,
            "url": c.url,
            "registered_at": c.registered_at,
            "num_updates": c.num_updates,
            "last_update": c.last_update,
        }
        for cid, c in registry.clients.items()
    }
