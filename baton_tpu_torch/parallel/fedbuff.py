"""Asynchronous buffered aggregation, FedBuff-style (counterpart of
``baton_tpu/parallel/fedbuff.py``).

``concurrency`` clients are in flight; each starts from the globals of
the version current when it started (its stale anchor). A server step
completes the ``buffer_size`` longest-running clients, applies the
staleness-discounted, sample-weighted mean of their deltas to the
current globals (the polynomial discount ``(1 + s)**(-alpha)``), bumps
the version and backfills the pool with fresh clients anchored there.
Completion follows the queue order, so staleness comes from the overlap
alone and is deterministic.

The buffer trains as one ``LocalTrainer.train_stacked`` call: the
clients' stale anchors are the stacked starting params and, under
FedProx, each client's own proximal anchor; the frozen leaves of a
trainable partition are held once. The host keeps the queue. Each step
reads the buffer's mean last-epoch loss back (``.item()``), one device
sync a step, as the reference's ``float(...)`` does.

On a clients mesh (``sim.mesh``; ``require_clients_mesh``; without one,
the buffer is one shard) the buffer's stacked axis is split over the
shards as a synchronous wave is (``kernel_specs("fedbuff.train")``):
each shard trains ``buffer_size / n`` of the completions, and
``buffer_size`` must be a multiple of the
mesh's size (phantom-padding an async buffer would skew the staleness
discount). The queue stays on the host.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional, Tuple

import numpy as np
import torch

from baton_tpu_torch.core.model import Params
from baton_tpu_torch.core.training import random_perms
from baton_tpu_torch.ops import aggregation as agg
from baton_tpu_torch.parallel.engine import FedSim
from baton_tpu_torch.parallel.mesh import (
    CLIENT_AXIS,
    client_sharding,
    device_put,
    replicate,
    require_clients_mesh,
    shard_client_arrays,
)


@dataclasses.dataclass
class AsyncResult:
    params: Params
    version: int                 # server steps applied
    mean_staleness: float        # average staleness of the applied updates
    loss_history: np.ndarray     # [n_steps] mean completed-client loss


class FedBuff:
    """Buffered asynchronous server loop over a :class:`FedSim`'s trainer.

    ``server_lr`` scales the applied mean delta (the FedBuff paper's global
    learning rate). Under overlap, consecutive flushes re-apply movement
    computed from the same anchor up to ``concurrency / buffer_size``
    times; the default ``buffer_size / concurrency`` cancels that
    multiplicity, and 1.0 gives plain buffered averaging."""

    def __init__(self, sim: FedSim, buffer_size: int = 4, concurrency: int = 8,
                 alpha: float = 0.5, server_lr: Optional[float] = None):
        if buffer_size <= 0 or concurrency < buffer_size:
            raise ValueError(
                f"need concurrency >= buffer_size >= 1, got "
                f"{concurrency} < {buffer_size}")
        if sim.aggregator[0] != "mean":
            raise ValueError(
                "FedBuff applies a staleness-weighted mean; robust "
                "aggregators are a synchronous-round feature")
        if sim.server_optimizer is not None:
            raise ValueError(
                "FedBuff applies server_lr-scaled mean deltas directly; "
                "a FedOpt server optimizer would be silently ignored — "
                "configure the FedSim without one for async runs")
        if sim.mesh is not None:
            require_clients_mesh(sim.mesh, sim.aggregator, "FedBuff")
            n_dev = int(sim.mesh.shape[CLIENT_AXIS])
            if buffer_size % n_dev != 0:
                raise ValueError(
                    f"buffer_size ({buffer_size}) must be a multiple of the clients-mesh size "
                    f"({n_dev}) so each server step shards evenly — phantom-padding an async "
                    "buffer would skew the staleness discount")
        self.sim = sim
        self.buffer_size = buffer_size
        self.concurrency = concurrency
        self.alpha = alpha
        self.server_lr = server_lr if server_lr is not None else buffer_size / concurrency

    def _train_buffer(self, anchors: Params, data, n_samples, perms, n_epochs, frozen):
        """The buffer's clients, each from a fresh optimizer state at its
        own stale anchor, split over the sim's clients mesh (meshless: one
        shard); returns (trained [K, ...], losses [K, n_epochs])."""
        trainer, mesh = self.sim.trainer, self.sim._clients_mesh
        outs = []
        for a, d, n, pm, fz in zip(
                shard_client_arrays(anchors, mesh), shard_client_arrays(data, mesh),
                device_put(n_samples, client_sharding(mesh)),
                device_put(perms.to(n_samples.device), client_sharding(mesh)),
                replicate(frozen, mesh)):
            outs.append(trainer.train_stacked(
                a, trainer.init_opt_states({name: v[0] for name, v in a.items()},
                                           int(n.shape[0])),
                d, n, n_epochs, pm, anchor=a if trainer.regularizer is not None else None,
                frozen=fz))
        trained = {name: agg.gather_clients([o[0][name] for o in outs], mesh)
                   for name in anchors}
        return trained, agg.gather_clients([o[2] for o in outs], mesh)

    def run(self, params: Params, data, n_samples, generator: Optional[torch.Generator] = None,
            n_steps: int = 1, n_epochs: int = 1, perms: Optional[torch.Tensor] = None
            ) -> AsyncResult:
        """``data``/``n_samples`` in the engine's stacked ``[C, ...]``
        layout; clients are drawn round-robin from the cohort. Each step's
        shuffles are ``perms[step]`` ([n_steps, buffer_size, n_epochs,
        capacity]) when given, else drawn from ``generator``."""
        # pool anchors and deltas are trainable-only; frozen leaves are
        # held once for every step and merge back at the end
        params, frozen = self.sim._split(params)
        data, n_samples = self.sim._to_device(data, n_samples)
        c = int(n_samples.shape[0])
        capacity = next(iter(data.values())).shape[1]
        device = n_samples.device

        # in-flight pool: (client_index, anchor_params, start_version)
        version = 0
        next_client = 0
        pool: Deque[Tuple[int, Params, int]] = deque()

        def fill() -> None:
            nonlocal next_client
            while len(pool) < self.concurrency:
                pool.append((next_client % c, params, version))
                next_client += 1

        fill()
        losses = []
        staleness_sum = 0.0
        n_applied = 0
        for step in range(n_steps):
            done = [pool.popleft() for _ in range(self.buffer_size)]
            idx = torch.as_tensor([d[0] for d in done], device=device)
            anchors = agg.tree_stack([d[1] for d in done])
            stale = np.asarray([version - d[2] for d in done], np.float32)
            d_k = {k: v[idx] for k, v in data.items()}
            n_k = n_samples[idx]
            step_perms = (random_perms(self.buffer_size, n_epochs, capacity, generator)
                          if perms is None else perms[step])
            trained, client_losses = self._train_buffer(
                anchors, d_k, n_k, step_perms, n_epochs, frozen)
            # staleness-discounted, sample-weighted mean of the deltas (fp32),
            # applied to the current globals, not to the stale anchors
            deltas = {k: t.float() - anchors[k].float() for k, t in trained.items()}
            disc = (1.0 + stale) ** (-self.alpha)
            w = n_k.float() * torch.as_tensor(disc, device=device)
            mean_delta = agg.weighted_tree_mean(deltas, w)
            params = {k: (p.float() + self.server_lr * mean_delta[k]).to(p.dtype)
                      for k, p in params.items()}
            version += 1
            staleness_sum += float(stale.sum())
            n_applied += len(done)
            losses.append(client_losses[:, -1].mean().item())
            fill()

        if self.sim.partition is not None:
            params = self.sim.partition.merge(params, frozen)
        return AsyncResult(
            params=params,
            version=version,
            mean_staleness=staleness_sum / max(n_applied, 1),
            loss_history=np.asarray(losses),
        )
