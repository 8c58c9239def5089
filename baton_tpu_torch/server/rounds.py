"""Round state machine — pure, clock-injected, asyncio-free.

Reference counterpart: update_manager.py:17-68, where the round state is
literally an ``asyncio.Lock`` (``in_progress == lock.locked()``,
update_manager.py:31-33). Here the state is explicit data, so the machine
is unit-testable without an event loop and cannot leak a lock.

Deliberate fixes over the reference (SURVEY §2.9, keep/fix record):
* item 3 FIXED — aborting a round (e.g. zero clients accepted) resets
  state; the reference left the lock held when zero clients were
  *registered*, 423-ing every later round.
* item 4 FIXED — ``drop_client`` removes a dead client from the running
  round so ``clients_left`` can reach zero, and ``deadline``/``is_expired``
  give rounds a straggler timeout. The reference round hung forever if a
  participant died mid-round.
* Round naming KEPT: ``update_{name}_{:05d}`` (update_manager.py:26).
* Exception hierarchy KEPT: RoundError/RoundInProgress/RoundNotInProgress
  mirror UpdateException/UpdateInProgress/UpdateNotInProgress
  (update_manager.py:5-14).

Durability: when constructed with a ``journal``
(:class:`baton_tpu_torch.server.journal.Journal`), every state transition is
appended to it *before* the in-memory mutation, so a crash at any point
leaves the journal a superset of memory and replay cannot lose an
acknowledged transition. ``client_end`` journals only the response's
scalar envelope (n_samples, update_id) — never the tensors, which are
the checkpoint's job.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Set

from baton_tpu_torch.server.utils import random_key


class RoundError(Exception):
    pass


class RoundInProgress(RoundError):
    pass


class RoundNotInProgress(RoundError):
    pass


class RoundManager:
    def __init__(
        self,
        name: Optional[str] = None,
        round_timeout: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        journal=None,
    ):
        self.name = name or random_key(6)
        self.round_timeout = round_timeout
        self._clock = clock
        self.journal = journal
        self.loss_history: list = []
        self.n_rounds = 0
        self._in_progress = False
        self._reset_state()

    def _reset_state(self) -> None:
        self.round_name = f"update_{self.name}_{self.n_rounds:05d}"
        self.clients: Set[str] = set()
        self.client_responses: Dict[str, Any] = {}
        self.update_ids: Dict[str, str] = {}
        self.round_meta: Optional[dict] = None
        self.started_at: Optional[float] = None
        # per-round deadline override (runbook adaptive_deadline
        # actuation); cleared with the rest of the round state so an
        # actuated deadline never outlives the round it was fit for
        self.deadline_override: Optional[float] = None
        # wall-clock (epoch) round start: the injected monotonic clock
        # is the right base for expiry math but meaningless across
        # processes — trace spans and rounds.jsonl SLO records need a
        # timestamp a recovered manager incarnation can line up with
        self.started_wall: Optional[float] = None

    def _journal(self, event: str, **fields: Any) -> None:
        if self.journal is not None:
            self.journal.append(event, **fields)

    # ------------------------------------------------------------------
    @property
    def in_progress(self) -> bool:
        return self._in_progress

    @property
    def clients_left(self) -> int:
        return len(self.clients) - len(self.client_responses)

    @property
    def effective_timeout(self) -> Optional[float]:
        """The deadline the running round is actually held to: the
        per-round :meth:`set_deadline` override when one was actuated,
        else the static ``round_timeout``."""
        if self.deadline_override is not None:
            return self.deadline_override
        return self.round_timeout

    @property
    def is_expired(self) -> bool:
        """True when the running round has outlived its deadline."""
        timeout = self.effective_timeout
        if not self._in_progress or timeout is None:
            return False
        return self.elapsed > timeout

    def set_deadline(self, seconds: Optional[float]) -> None:
        """Override THIS round's straggler deadline (runbook
        ``adaptive_deadline``). Applies to the running round only —
        ``_reset_state`` clears it on start/abort, so the static
        ``round_timeout`` is restored the moment the actuation stops
        being re-applied. No-op outside a round."""
        if not self._in_progress:
            return
        self.deadline_override = (
            None if seconds is None else max(0.0, float(seconds))
        )

    @property
    def elapsed(self) -> float:
        """Seconds since the running round started (0 outside a round)."""
        if not self._in_progress or self.started_at is None:
            return 0.0
        return self._clock() - self.started_at

    def __len__(self) -> int:
        return len(self.clients) if self._in_progress else 0

    # ------------------------------------------------------------------
    def start_round(self, **round_meta: Any) -> str:
        if self._in_progress:
            raise RoundInProgress(self.round_name)
        self._reset_state()
        self._journal(
            "round_started", round_name=self.round_name, meta=round_meta
        )
        self._in_progress = True
        self.round_meta = round_meta
        self.started_at = self._clock()
        self.started_wall = time.time()
        return self.round_name

    def resume_round(self, round_name: str, **round_meta: Any) -> str:
        """Re-open a journal-recovered in-flight round under its original
        name, so workers still holding trained updates for it can deliver
        them to the restarted manager. Participants re-join via
        :meth:`client_start` as the re-announce is acked, exactly like a
        fresh round."""
        if self._in_progress:
            raise RoundInProgress(self.round_name)
        self._reset_state()
        self._journal(
            "round_started", round_name=round_name, meta=round_meta,
            resumed=True,
        )
        self.round_name = round_name
        self._in_progress = True
        self.round_meta = round_meta
        self.started_at = self._clock()
        self.started_wall = time.time()
        return self.round_name

    def restart_clock(self) -> None:
        """Restart the round-expiry clock at ``now``.

        The straggler timeout is meant to bound the time a participant
        takes to REPORT after being notified — not the manager's own
        round setup. Callers invoke this as the broadcast guard drops,
        so a slow (or fault-injected) broadcast/secure phase does not
        eat into the participants' reporting window and expire a round
        nobody had a fair chance to answer. No-op outside a round.
        """
        if self._in_progress:
            self.started_at = self._clock()

    def client_start(self, client_id: str) -> None:
        if not self._in_progress:
            raise RoundNotInProgress
        if client_id not in self.clients:
            self._journal(
                "round_client_joined",
                round_name=self.round_name, client_id=client_id,
            )
        self.clients.add(client_id)

    def client_end(self, client_id: str, response: Any) -> None:
        if not self._in_progress:
            raise RoundNotInProgress
        if isinstance(response, dict):
            self._journal(
                "update_accepted",
                round_name=self.round_name,
                client_id=client_id,
                update_id=response.get("update_id"),
                n_samples=response.get("n_samples"),
            )
            uid = response.get("update_id")
            if uid:
                self.update_ids[client_id] = uid
        self.client_responses[client_id] = response

    def drop_client(self, client_id: str) -> None:
        """Remove a participant mid-round (culled/evicted client) so the
        round can complete without it.

        A client that already delivered an accepted update is NOT
        dropped: the 200 ack promised the update counts (at-least-once
        contract), and under streaming aggregation the contribution has
        already been folded into the running sum — it cannot be
        retracted. Culling only removes clients the round is still
        *waiting on*."""
        if not self._in_progress:
            return
        if client_id in self.client_responses:
            return
        if client_id in self.clients:
            self._journal(
                "round_client_dropped",
                round_name=self.round_name, client_id=client_id,
            )
        self.clients.discard(client_id)
        self.client_responses.pop(client_id, None)
        self.update_ids.pop(client_id, None)

    def end_round(self) -> Dict[str, Any]:
        """Finish the round, returning ``{client_id: response}`` for all
        clients that reported (possibly partial on timeout)."""
        if not self._in_progress:
            raise RoundNotInProgress
        self._journal(
            "round_ended",
            round_name=self.round_name, n_rounds=self.n_rounds + 1,
        )
        self._in_progress = False
        self.n_rounds += 1
        return self.client_responses

    def restore(self, n_rounds: int, loss_history) -> None:
        """Resume from checkpointed state: set the round counter and loss
        history and recompute the derived round name. The single entry
        point for manager restart-resume — keeps the name/counter
        invariant here instead of in callers."""
        if self._in_progress:
            raise RoundInProgress(self.round_name)
        self.n_rounds = int(n_rounds)
        self.loss_history = list(loss_history)
        self._reset_state()

    def abort_round(self, reason: Optional[str] = None) -> None:
        """Cancel a round without counting it (e.g. no client accepted
        the broadcast — reference manager.py:90-92 path, minus the
        zero-registered-clients lock leak)."""
        if not self._in_progress:
            return
        self._journal(
            "round_aborted", round_name=self.round_name, reason=reason
        )
        self._in_progress = False
        self._reset_state()
