"""Local training (counterpart of ``baton_tpu/core/training.py``): masked
multi-epoch plain SGD, the ``optax.sgd`` default of the JAX package.

Static-shape discipline as in JAX: client datasets are padded to a
``capacity`` divisible by ``batch_size``; each epoch draws a permutation
of the padded rows, and ``perm < n_samples`` marks the real ones, so
padding contributes exactly nothing to losses and gradients. The epoch
loss is the exact sample-weighted mean ``Σ loss_i / n_samples``, and a
step whose batch holds no real sample leaves the params untouched.

Clients train in lockstep: every step is one ``torch.func.vmap`` of
``torch.func.grad_and_value`` over the stacked per-client params, so the
kernels below see all clients of a wave in one launch.

JAX draws its permutations from threefry keys, which torch cannot
reproduce; callers that need JAX's exact shuffles inject them as
``perms``, otherwise they come from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from baton_tpu_torch.core.model import Batch, FedModel, Params


def num_batches(capacity: int, batch_size: int) -> int:
    if capacity % batch_size != 0:
        raise ValueError(
            f"padded capacity {capacity} must be divisible by batch_size {batch_size}; "
            "use baton_tpu_torch.ops.padding.pad_dataset"
        )
    return capacity // batch_size


def random_perms(n_clients: int, n_epochs: int, capacity: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[n_clients, n_epochs, capacity] row permutations."""
    return torch.stack([
        torch.stack([torch.randperm(capacity, generator=generator) for _ in range(n_epochs)])
        for _ in range(n_clients)
    ])


@dataclasses.dataclass(frozen=True)
class LocalTrainer:
    """Multi-epoch local SGD. ``train`` runs one client,
    ``train_clients`` a stacked cohort from shared starting params."""

    model: FedModel
    batch_size: int
    learning_rate: float

    def _objective(self, params: Params, batch: Batch):
        loss_sum, count = self.model.loss_and_count(params, batch)
        return loss_sum / count.clamp_min(1.0), (loss_sum, count)

    def train(self, params: Params, data: Batch, n_samples: int, n_epochs: int = 1,
              perm: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """One client: ``data`` is a dict of [capacity, ...] tensors,
        ``perm`` an optional [n_epochs, capacity] injected shuffle.
        Returns ``(params, loss_history[n_epochs])``."""
        device = next(iter(params.values())).device
        n = torch.as_tensor([n_samples], device=device)
        stacked = {k: v[None] for k, v in data.items()}
        perms = None if perm is None else perm[None]
        p, losses = self.train_clients(params, stacked, n, n_epochs, perms, generator)
        return {k: v[0] for k, v in p.items()}, losses[0]

    def train_clients(self, params: Params, data: Batch, n_samples: torch.Tensor,
                      n_epochs: int = 1, perms: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
        """C clients from the same ``params``: ``data`` leaves are
        [C, capacity, ...], ``n_samples`` [C], ``perms`` an optional
        [C, n_epochs, capacity]. Returns the per-client params (leaves
        [C, ...]) and losses [C, n_epochs]."""
        c, capacity = n_samples.shape[0], next(iter(data.values())).shape[1]
        nb = num_batches(capacity, self.batch_size)
        device = n_samples.device
        if perms is None:
            perms = random_perms(c, n_epochs, capacity, generator)
        perms = perms.to(device)
        p = {k: v.unsqueeze(0).repeat(c, *([1] * v.dim())) for k, v in params.items()}
        grad_fn = torch.func.vmap(
            torch.func.grad_and_value(self._objective, has_aux=True))
        rows = torch.arange(c, device=device)[:, None]
        history = []
        for e in range(n_epochs):
            perm = perms[:, e]
            mask = (perm < n_samples[:, None]).float()
            shuffled = {k: v[rows, perm] for k, v in data.items()}
            if "mask" in shuffled:
                mask = mask * shuffled["mask"].float()
            shuffled["mask"] = mask
            loss_sums, counts = [], []
            for i in range(nb):
                sl = slice(i * self.batch_size, (i + 1) * self.batch_size)
                batch = {k: v[:, sl] for k, v in shuffled.items()}
                grads, (_, (loss_sum, count)) = grad_fn(p, batch)
                # an all-padding batch has exactly-zero grads; the gate
                # keeps its step a no-op, as in the JAX trainer
                nonempty = count > 0
                p = {k: torch.where(nonempty.view(-1, *([1] * (v.dim() - 1))),
                                    v + grads[k] * -self.learning_rate, v)
                     for k, v in p.items()}
                loss_sums.append(loss_sum)
                counts.append(count)
            total = torch.stack(counts, 1).sum(1).clamp_min(1.0)
            history.append(torch.stack(loss_sums, 1).sum(1) / total)
        return p, torch.stack(history, 1)


def make_local_trainer(model: FedModel, optimizer=None, batch_size: int = 32,
                       learning_rate: float = 1e-3) -> LocalTrainer:
    """Plain SGD, batch 32 and lr 1e-3 by default (the reference demo's
    settings). Other optimizers are not ported yet."""
    if optimizer is not None:
        raise NotImplementedError("only plain SGD is ported; pass optimizer=None")
    return LocalTrainer(model=model, batch_size=batch_size, learning_rate=learning_rate)
