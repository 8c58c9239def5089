"""Partial personalization, FedPer-style: per-client personal leaves
(counterpart of ``baton_tpu/parallel/personalization.py``).

Each client keeps its own copy of some leaves (classically the head),
which never leave it; the rest ("shared") is trained and aggregated as
usual. The personal state is one stacked dict ``[C, ...]`` of the
personal leaves, so a round is one ``LocalTrainer.train_stacked`` call:
every client starts from its personal leaves merged with the shared
ones (and, under FedProx, is anchored there), trains the full model and
is split again. The shared halves combine by the sim's aggregator; the
personal halves are the new stack.

The returned global params carry the unweighted mean of the personal
leaves over the clients that hold samples, as a warm start for clients
joining later; nothing trains on it directly.

One device only: a sim with a mesh cannot be built (ROADMAP item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from baton_tpu_torch.core.model import Params
from baton_tpu_torch.core.partition import PathPredicate, make_partition
from baton_tpu_torch.core.training import stack_copies
from baton_tpu_torch.ops import aggregation as agg
from baton_tpu_torch.parallel.engine import FedSim, client_eval_sums, federation_eval


@dataclasses.dataclass
class PersonalizedRoundResult:
    params: Params                # shared aggregated; personal leaves = warm-start mean
    personal_state: Params        # [C, ...] stacked personal leaves
    loss_history: torch.Tensor    # [n_epochs], sample-weighted
    client_losses: torch.Tensor   # [C, n_epochs]


class FedPer:
    """Personalized federated training over a :class:`FedSim`'s trainer.

    ``personal(name, leaf) -> bool`` marks the per-client leaves. The
    personal stack threads through rounds like the params do; the caller
    owns it (``Checkpointer.save(extra=)`` to resume)."""

    def __init__(self, sim: FedSim, personal: PathPredicate):
        if sim.trainable_predicate is not None:
            raise ValueError(
                "FedPer and a trainable/frozen partition both re-plumb the "
                "param tree; compose by marking frozen leaves neither "
                "personal nor trained instead")
        if sim.server_optimizer is not None:
            raise ValueError(
                "FedPer aggregates shared leaves directly; a FedOpt "
                "server optimizer would be silently ignored — configure "
                "the FedSim without one for personalized rounds")
        self.sim = sim
        self.personal_pred = personal
        self.partition = None

    def _ensure_partition(self, params: Params) -> None:
        if self.partition is None:
            # the "trainable" side of the partition is the personal leaves
            self.partition = make_partition(params, self.personal_pred)

    def init_personal(self, params: Params, n_clients: int) -> Params:
        """The personal stack, each client a copy of the global leaves."""
        self._ensure_partition(params)
        personal, _ = self.partition.split(params)
        return stack_copies(personal, n_clients)

    def run_round(self, params: Params, personal_state: Optional[Params], data, n_samples,
                  generator: Optional[torch.Generator] = None, n_epochs: int = 1,
                  perms: Optional[torch.Tensor] = None) -> PersonalizedRoundResult:
        """One round; ``personal_state`` None starts from the globals.
        ``perms`` [C, n_epochs, capacity] injects the shuffles, otherwise
        they are drawn from ``generator``."""
        self._ensure_partition(params)
        data, n_samples = self.sim._to_device(data, n_samples)
        c = int(n_samples.shape[0])
        if personal_state is None:
            personal_state = self.init_personal(params, c)
        _, shared = self.partition.split(params)
        trainer = self.sim.trainer
        # each client's round-start params are its FedProx anchor
        full = self.partition.merge(personal_state, stack_copies(shared, c))
        new_full, _, closs = trainer.train_stacked(
            full, trainer.init_opt_states(params, c), data, n_samples, n_epochs, perms,
            generator, anchor=full if trainer.regularizer is not None else None)
        new_pers, new_shared = self.partition.split(new_full)
        shared_agg = agg.aggregate_stacked(self.sim.aggregator, new_shared, n_samples, shared)
        # warm start for future clients: the mean over the clients that
        # hold samples (a client without any returns its unchanged leaves)
        m = (n_samples > 0).float()
        n_real = m.sum().clamp_min(1.0)
        pers_mean = {k: (torch.tensordot(m, v.float(), dims=([0], [0])) / n_real).to(v.dtype)
                     for k, v in new_pers.items()}
        return PersonalizedRoundResult(
            params=self.partition.merge(pers_mean, shared_agg),
            personal_state=new_pers,
            loss_history=agg.weighted_scalar_mean(closs, n_samples.float()),
            client_losses=closs,
        )

    @torch.no_grad()
    def evaluate(self, params: Params, personal_state: Params, data, n_samples
                 ) -> Dict[str, float]:
        """Each client scored on its own data with its own personal
        leaves; returns the example-weighted federation aggregate
        ``{"loss", "n"}`` (and ``"accuracy"`` for integer labels)."""
        self._ensure_partition(params)
        data, n_samples = self.sim._to_device(data, n_samples)
        _, shared = self.partition.split(params)
        model, part = self.sim.model, self.partition
        return federation_eval(torch.func.vmap(
            lambda pers, d, n: client_eval_sums(model, part.merge(pers, shared), d, n))(
            personal_state, data, n_samples))
