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

A round runs on the sim's clients mesh (``sim.mesh``, a clients-only
mesh and the mean aggregator, ``require_clients_mesh``; without one, a
mesh of one shard on the sim's device): the cohort is padded to a
multiple of the shards with phantom clients (zero data, no samples, row
0's optimizer state, which their all-masked steps leave as it is), each
shard trains its clients' slice of the state stack on its own device,
and the FedAvg and the loss history are psums over the client axis
(``kernel_specs("stateful.round")``); the new states come back unpadded,
in client order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from baton_tpu_torch.core.model import Params
from baton_tpu_torch.core.training import random_perms, stack_copies
from baton_tpu_torch.ops import aggregation as agg
from baton_tpu_torch.ops.padding import round_up
from baton_tpu_torch.parallel.engine import FedSim, server_update
from baton_tpu_torch.parallel.mesh import (
    CLIENT_AXIS,
    client_sharding,
    device_put,
    replicate,
    require_clients_mesh,
    shard_client_arrays,
)
from baton_tpu_torch.parallel.personalization import _pad_stack


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
        if sim.mesh is not None:
            require_clients_mesh(sim.mesh, sim.aggregator, "StatefulClients")
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
        if perms is None:
            perms = random_perms(c, n_epochs, next(iter(data.values())).shape[1], generator)
        aggregate, new_opt_states, loss_history, closs = self._round(
            params, opt_states, data, n_samples, perms, n_epochs, generator)
        if self.sim.server_optimizer is not None:
            if server_opt_state is None:
                server_opt_state = self.sim.server_optimizer.init(params)
            new_params, server_opt_state = server_update(
                self.sim.server_optimizer, params, aggregate, server_opt_state)
        else:
            new_params = aggregate
        return StatefulRoundResult(params=new_params, opt_states=new_opt_states,
                                   loss_history=loss_history, client_losses=closs,
                                   server_opt_state=server_opt_state)

    def _round(self, params: Params, opt_states, data, n_samples, perms, n_epochs: int,
               generator):
        """The round on the sim's clients mesh (meshless: one shard):
        ``(aggregate, new_opt_states, loss_history, client_losses)``, the
        states and losses unpadded. The mean is a psum; a robust aggregator
        (one shard only, ``require_clients_mesh``) combines the gathered
        stack."""
        sim, trainer = self.sim, self.sim.trainer
        mesh = sim._clients_mesh
        c = int(n_samples.shape[0])
        target = round_up(c, int(mesh.shape[CLIENT_AXIS]))
        data_p, n_p, perms_p = sim._pad_wave(data, n_samples, perms.to(sim.device), target)
        states = shard_client_arrays(_pad_stack(opt_states, target - c), mesh)
        shards = zip(replicate(params, mesh), states, shard_client_arrays(data_p, mesh),
                     device_put(n_p, client_sharding(mesh)),
                     device_put(perms_p, client_sharding(mesh)))
        gens, rows, after = sim._shard_noise(generator, target)
        outs = []
        for (p, st, d, n, pm), g, r in zip(shards, gens, rows):
            anchor = p if trainer.regularizer is not None else None
            outs.append((trainer.train_stacked(stack_copies(p, int(n.shape[0])), st, d, n,
                                               n_epochs, pm, g, anchor=anchor, noise_rows=r), n))
        after()
        weights = [n.float() for _, n in outs]
        if sim.aggregator[0] == "mean":
            aggregate = agg.tree_cast_like(agg.psum_weighted_mean(
                [o[0] for o, _ in outs], weights, mesh)[0], params)
        else:
            aggregate = agg.aggregate_stacked(
                sim.aggregator, agg.gather_client_tree([o[0] for o, _ in outs], mesh, c),
                n_samples, params)
        loss_history = agg.psum_weighted_scalar_mean([o[2] for o, _ in outs], weights, mesh)[0]
        new_states = agg.gather_client_tree([o[1] for o, _ in outs], mesh, c)
        closs = agg.gather_clients([o[2] for o, _ in outs], mesh)[:c]
        return aggregate, new_states, loss_history, closs
