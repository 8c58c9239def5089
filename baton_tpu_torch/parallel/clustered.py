"""Clustered federated learning, IFCA-style: K global models, clients
self-select (counterpart of ``baton_tpu/parallel/clustered.py``).

When the cohort mixes populations, one global model fits none of them.
IFCA keeps K models; each round every client evaluates all K on its own
data, trains the best-fitting one, and each model aggregates only the
clients that chose it.

Cluster params are one stacked dict ``[K, ...]``, and a round is:

1. assignment: the ``[C, K]`` masked-loss grid, a ``torch.func.vmap``
   over clients of a vmap over clusters (no grad; the flash kernels fold
   both axes into one launch per layer), then ``argmin`` over K (the first
   minimum on a tie, as JAX's);
2. training: each client trains the params gathered by its assignment,
   one ``LocalTrainer.train_stacked`` call (each client anchored at its
   own gathered params under FedProx);
3. per-cluster sample-weighted means through one one-hot fp32 product.
   A cluster no client chose keeps its params bit for bit.

The caller threads ``cluster_params`` between rounds and owns
checkpointing them (``Checkpointer.save(extra=)``).

A round runs on the sim's clients mesh (``sim.mesh``;
``require_clients_mesh``; without one, a mesh of one shard on the sim's
device): the cohort is padded to a multiple of the shards with phantom
clients, each shard assigns and trains its clients on its own device from
the cluster params copied there, and the per-cluster sums and weights are one psum over the
client axis (``kernel_specs("clustered.round")``); assignments and losses
come back unpadded, in client order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from baton_tpu_torch.core.model import FedModel, Params
from baton_tpu_torch.ops import aggregation as agg
from baton_tpu_torch.core.training import random_perms
from baton_tpu_torch.ops.padding import round_up
from baton_tpu_torch.parallel.engine import FedSim, client_eval_sums, federation_eval
from baton_tpu_torch.parallel.mesh import (
    CLIENT_AXIS,
    client_sharding,
    device_put,
    replicate,
    require_clients_mesh,
    shard_client_arrays,
)


@dataclasses.dataclass
class ClusteredRoundResult:
    cluster_params: Params        # [K, ...] stacked
    assignments: np.ndarray       # [C] int, the cluster each client chose
    loss_history: torch.Tensor    # [n_epochs], sample-weighted over clients
    client_losses: torch.Tensor   # [C, n_epochs]


def _masked_mean_loss(model: FedModel, p: Params, d, n) -> torch.Tensor:
    """One client's mean loss over its first ``n`` rows under ``p``: the
    one assignment rule of rounds and evaluation (they must agree, or a
    client would train one cluster and be scored with another)."""
    losses = model.per_example_loss(p, d)
    mask = (torch.arange(losses.shape[0], device=losses.device) < n).float()
    return (losses.float() * mask).sum() / mask.sum().clamp_min(1.0)


class ClusteredFedSim:
    """IFCA rounds over a :class:`FedSim`'s trainer."""

    def __init__(self, sim: FedSim, n_clusters: int):
        if n_clusters < 2:
            raise ValueError("clustering needs n_clusters >= 2")
        if sim.trainable_predicate is not None:
            raise ValueError(
                "ClusteredFedSim trains full param trees; partitioned "
                "sims are not supported")
        if sim.aggregator[0] != "mean":
            raise ValueError(
                "per-cluster aggregation is the sample-weighted mean; "
                "robust rules within tiny per-cluster cohorts are "
                "statistically meaningless — filter clients instead")
        if sim.server_optimizer is not None:
            raise ValueError(
                "FedOpt server state per cluster is not threaded here; "
                "configure the FedSim without a server optimizer")
        if sim.mesh is not None:
            require_clients_mesh(sim.mesh, sim.aggregator, "ClusteredFedSim")
        self.sim = sim
        self.n_clusters = n_clusters

    def init_clusters(self, generator: torch.Generator) -> Params:
        """K models initialized one after another from ``generator`` and
        stacked; distinct inits let assignment break symmetry in round 1."""
        return agg.tree_stack([self.sim.init(generator) for _ in range(self.n_clusters)])

    @torch.no_grad()
    def loss_grid(self, cluster_params: Params, data, n_samples) -> torch.Tensor:
        """[C, K]: every cluster's masked mean loss on every client's data."""
        model = self.sim.model

        def client_row(d, n):
            return torch.func.vmap(lambda p: _masked_mean_loss(model, p, d, n))(cluster_params)

        return torch.func.vmap(client_row)(data, n_samples)

    def _assign(self, cluster_params: Params, data, n_samples):
        """Each client's cluster [C] and its params gathered [C, ...]."""
        assign = self.loss_grid(cluster_params, data, n_samples).argmin(dim=1)
        return assign, {k: v[assign] for k, v in cluster_params.items()}

    def run_round(self, cluster_params: Params, data, n_samples,
                  generator: Optional[torch.Generator] = None, n_epochs: int = 1,
                  perms: Optional[torch.Tensor] = None) -> ClusteredRoundResult:
        """One round. ``perms`` [C, n_epochs, capacity] injects the
        shuffles, otherwise they are drawn from ``generator``."""
        data, n_samples = self.sim._to_device(data, n_samples)
        c, k_clusters = int(n_samples.shape[0]), self.n_clusters
        mesh = self.sim._clients_mesh
        if perms is None:
            perms = random_perms(c, n_epochs, next(iter(data.values())).shape[1], generator)
        target = round_up(c, int(mesh.shape[CLIENT_AXIS]))
        data_p, n_p, perms_p = self.sim._pad_wave(data, n_samples, perms.to(self.sim.device),
                                                  target)
        shards = zip(replicate(cluster_params, mesh), shard_client_arrays(data_p, mesh),
                     device_put(n_p, client_sharding(mesh)),
                     device_put(perms_p, client_sharding(mesh)))
        trainer = self.sim.trainer
        outs = []
        for cp, d, n, pm in shards:
            assign, mine = self._assign(cp, d, n)
            trained, _, closs = trainer.train_stacked(
                mine, trainer.init_opt_states({k: v[0] for k, v in mine.items()},
                                              int(n.shape[0])), d,
                n, n_epochs, pm, generator,
                anchor=mine if trainer.regularizer is not None else None)
            wk = torch.nn.functional.one_hot(assign, k_clusters).float() * n.float()[:, None]
            # per-cluster sample-weighted sums [K, ...] and weights [K]
            outs.append(({"sums": {k: torch.tensordot(wk, v.float(), dims=([0], [0]))
                                   for k, v in trained.items()}, "denom": wk.sum(dim=0)},
                         assign, closs))
        total = agg.psum([o[0] for o in outs], mesh)[0]
        assign = agg.gather_clients([o[1] for o in outs], mesh)[:c]
        closs = agg.gather_clients([o[2] for o in outs], mesh)[:c]
        denom = total["denom"]

        def combine(sums, old):
            shape = (k_clusters,) + (1,) * (sums.dim() - 1)
            mean = sums / denom.clamp_min(1e-9).reshape(shape)
            return torch.where((denom <= 0).reshape(shape), old.float(), mean).to(old.dtype)

        return ClusteredRoundResult(
            cluster_params={k: combine(total["sums"][k], v) for k, v in cluster_params.items()},
            assignments=assign.cpu().numpy(),
            loss_history=agg.weighted_scalar_mean(closs, n_samples.float()),
            client_losses=closs,
        )

    @torch.no_grad()
    def evaluate(self, cluster_params: Params, data, n_samples) -> Dict[str, float]:
        """Each client scored with its best-fitting cluster (a fresh
        assignment); returns the example-weighted federation aggregate
        ``{"loss", "n"}`` (and ``"accuracy"`` for integer labels)."""
        data, n_samples = self.sim._to_device(data, n_samples)
        _, mine = self._assign(cluster_params, data, n_samples)
        model = self.sim.model
        sums = torch.func.vmap(lambda p, d, n: client_eval_sums(model, p, d, n))
        return federation_eval(sums(mine, data, n_samples))
