"""Stateful clients: per-client optimizer state kept across rounds
(counterpart of ``baton_tpu/parallel/stateful.py``).

Cross-device FedAvg starts every client from a fresh optimizer each round
(the engine's default). A cross-silo federation sees the same few
institutions every round, and each may keep its local Adam or momentum
moments across the round boundary.

The cohort's optimizer states are one stacked dict ``[C, ...]`` (Adam's
count ``[C]``), so a round is one ``LocalTrainer.train_stacked`` call
over (state, data, shuffles): every step one vmapped launch for the whole
cohort. The trained params combine by the sim's aggregator and a FedOpt
server optimizer composes on top, as in ``FedSim.run_round``. The caller
owns the stack and threads it between rounds; ``Checkpointer.save(extra=)``
carries it across a restart. Memory: C optimizer states (about 2C params
for Adam), held for the whole run.

One device only: a sim with a mesh cannot be built (ROADMAP item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from baton_tpu_torch.core.model import Params
from baton_tpu_torch.core.training import stack_copies
from baton_tpu_torch.ops import aggregation as agg
from baton_tpu_torch.parallel.engine import FedSim, server_update


@dataclasses.dataclass
class StatefulRoundResult:
    params: Params
    opt_states: Any               # [C, ...] stacked, threads to the next round
    loss_history: torch.Tensor    # [n_epochs], sample-weighted
    client_losses: torch.Tensor   # [C, n_epochs]
    server_opt_state: Any = None


class StatefulClients:
    """Synchronous rounds with persistent per-client optimizer state over
    a :class:`FedSim` (its model, trainer, aggregator and server
    optimizer); the sim's own ``run_round`` keeps clients stateless."""

    def __init__(self, sim: FedSim):
        if sim.trainable_predicate is not None:
            raise ValueError(
                "StatefulClients threads full-param optimizer state; "
                "compose with LoRA by building the FedSim on the adapter "
                "pytree directly")
        self.sim = sim

    def init_opt_states(self, params: Params, n_clients: int):
        """Stacked optimizer states, one per client, all initialized from
        the same global params, on the sim's device."""
        params = {k: v.to(self.sim.device) for k, v in params.items()}
        return self.sim.trainer.init_opt_states(params, n_clients)

    def run_round(self, params: Params, opt_states, data, n_samples,
                  generator: Optional[torch.Generator] = None, n_epochs: int = 1,
                  server_opt_state=None, perms: Optional[torch.Tensor] = None
                  ) -> StatefulRoundResult:
        """One round; ``opt_states`` None starts every client afresh.
        ``perms`` [C, n_epochs, capacity] injects the shuffles, otherwise
        they are drawn from ``generator``."""
        data, n_samples = self.sim._to_device(data, n_samples)
        c = int(n_samples.shape[0])
        if opt_states is None:
            opt_states = self.init_opt_states(params, c)
        trainer = self.sim.trainer
        anchor = params if trainer.regularizer is not None else None
        trained, new_opt_states, closs = trainer.train_stacked(
            stack_copies(params, c), opt_states, data, n_samples, n_epochs, perms, generator,
            anchor=anchor)
        aggregate = agg.aggregate_stacked(self.sim.aggregator, trained, n_samples, params)
        if self.sim.server_optimizer is not None:
            if server_opt_state is None:
                server_opt_state = self.sim.server_optimizer.init(params)
            new_params, server_opt_state = server_update(
                self.sim.server_optimizer, params, aggregate, server_opt_state)
        else:
            new_params = aggregate
        return StatefulRoundResult(
            params=new_params,
            opt_states=new_opt_states,
            loss_history=agg.weighted_scalar_mean(closs, n_samples.float()),
            client_losses=closs,
            server_opt_state=server_opt_state,
        )
