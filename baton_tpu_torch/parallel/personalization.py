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

A round runs on the sim's clients mesh (``sim.mesh``;
``require_clients_mesh``; without one, a mesh of one shard on the sim's
device): the cohort is padded to a multiple of the shards with phantom
clients (zero data, no samples, row 0's personal leaves), each shard
trains its slice of the personal stack on its own device, and the shared
FedAvg, the warm-start mean and the loss history are psums over the client axis
(``kernel_specs("personalization.round")``); phantoms carry weight 0 and
are left out of the warm-start mean, so they change nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from baton_tpu_torch.core.model import Params
from baton_tpu_torch.core.partition import PathPredicate, make_partition
from baton_tpu_torch.core import optim
from baton_tpu_torch.core.training import random_perms, stack_copies
from baton_tpu_torch.ops import aggregation as agg
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


def _pad_stack(tree, pad: int):
    """A ``[C, ...]`` stacked tree (nested dicts) padded with ``pad``
    copies of row 0: phantom rows only need valid shapes and dtypes."""
    if pad <= 0:
        return tree
    return optim.tree_map(lambda a: torch.cat([a, a[:1].expand(pad, *a.shape[1:])]), tree)


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
        if sim.mesh is not None:
            require_clients_mesh(sim.mesh, sim.aggregator, "FedPer")
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
        if perms is None:
            perms = random_perms(c, n_epochs, next(iter(data.values())).shape[1], generator)
        target = round_up(c, int(self.sim._clients_mesh.shape[CLIENT_AXIS]))
        data_p, n_p, perms_p = self.sim._pad_wave(data, n_samples, perms.to(self.sim.device),
                                                  target)
        new_pers, shared_agg, pers_mean, loss_history, closs = self._round(
            _pad_stack(personal_state, target - c), shared, data_p, n_p, perms_p, n_epochs,
            generator)
        return PersonalizedRoundResult(
            params=self.partition.merge(pers_mean, shared_agg),
            personal_state={k: v[:c] for k, v in new_pers.items()},
            loss_history=loss_history, client_losses=closs[:c])

    def _round(self, personal_state, shared, data, n_samples, perms, n_epochs: int,
               generator=None):
        """The round on the sim's clients mesh (meshless: one shard) on a
        cohort already a multiple of the shards: ``(new_personal_state,
        shared_agg, pers_mean, loss_history, client_losses)``, the stacks
        and losses of every (phantom included) client in client order.
        Each client's round-start params are its FedProx anchor. The shared
        mean is a psum; a robust aggregator (one shard only,
        ``require_clients_mesh``) combines the gathered stack."""
        sim, part = self.sim, self.partition
        mesh, trainer = sim._clients_mesh, sim.trainer
        total = int(n_samples.shape[0])
        gens, rows, after = sim._shard_noise(generator, total)
        outs = []
        for pers, sh, d, n, pm, g, r in zip(
                shard_client_arrays(personal_state, mesh), replicate(shared, mesh),
                shard_client_arrays(data, mesh), device_put(n_samples, client_sharding(mesh)),
                device_put(perms, client_sharding(mesh)), gens, rows):
            c = int(n.shape[0])
            full = part.merge(pers, stack_copies(sh, c))
            new_full, _, closs = trainer.train_stacked(
                full, trainer.init_opt_states({k: v[0] for k, v in full.items()}, c), d, n,
                n_epochs, pm, g, anchor=full if trainer.regularizer is not None else None,
                noise_rows=r)
            new_pers, new_shared = part.split(new_full)
            outs.append((new_pers, new_shared, closs, n.float(), (n > 0).float()))
        after()
        weights = [o[3] for o in outs]
        if sim.aggregator[0] == "mean":
            shared_agg = agg.tree_cast_like(agg.psum_weighted_mean(
                [o[1] for o in outs], weights, mesh)[0], shared)
        else:
            shared_agg = agg.aggregate_stacked(
                sim.aggregator, agg.gather_client_tree([o[1] for o in outs], mesh, total),
                n_samples, shared)
        # warm start for future clients: the mean over the clients that
        # hold samples (a client without any returns its unchanged leaves)
        tot = agg.psum([{"s": {k: torch.tensordot(o[4], v.float(), dims=([0], [0]))
                               for k, v in o[0].items()}, "n": o[4].sum()} for o in outs],
                       mesh)[0]
        pers_mean = {k: (v / tot["n"].clamp_min(1.0)).to(personal_state[k].dtype)
                     for k, v in tot["s"].items()}
        loss_history = agg.psum_weighted_scalar_mean([o[2] for o in outs], weights, mesh)[0]
        new_pers = {k: agg.gather_clients([o[0][k] for o in outs], mesh)
                    for k in personal_state}
        closs = agg.gather_clients([o[2] for o in outs], mesh)
        return new_pers, shared_agg, pers_mean, loss_history, closs

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
