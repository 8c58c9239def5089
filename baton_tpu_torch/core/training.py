"""Local training (counterpart of ``baton_tpu/core/training.py``): masked
multi-epoch training with a pluggable optimizer (``core/optim.py``,
plain SGD by default), an optional regularizer around an anchor (FedProx)
and an optional trainable/frozen partition.

Static-shape discipline as in JAX: client datasets are padded to a
``capacity`` divisible by ``batch_size``; each epoch draws a permutation
of the padded rows, and ``perm < n_samples`` marks the real ones, so
padding contributes exactly nothing to losses and gradients. The epoch
loss is the exact sample-weighted mean ``Σ loss_i / n_samples``, and a
step whose batch holds no real sample leaves the params and the
optimizer state (Adam's count included) untouched.

Clients train in lockstep: every step is one ``torch.func.vmap`` of
``torch.func.grad_and_value`` over the stacked per-client trainable
params, so the kernels below see all clients of a wave in one launch.
The regularizer's anchor and the frozen params enter that vmap unbatched
(``in_dims=None``): they are never repeated per client, and the gradient
is taken with respect to the trainable params alone.

JAX draws its permutations from threefry keys, which torch cannot
reproduce; callers that need JAX's exact shuffles inject them as
``perms``, otherwise they come from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from baton_tpu_torch.core import optim
from baton_tpu_torch.core.model import Batch, FedModel, Params
from baton_tpu_torch.core.partition import ParamPartition

Regularizer = Callable[[Params, Params], torch.Tensor]


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


def _stack(tree, c: int):
    """Repeat every leaf of nested dicts along a new leading client axis."""
    return optim.tree_map(lambda v: v.unsqueeze(0).repeat(c, *([1] * v.dim())), tree)


def _where(keep: torch.Tensor, new, old):
    """``new`` where ``keep`` [C] is true, else ``old``, leaf by leaf."""
    return optim.tree_map(
        lambda n, o: torch.where(keep.view(-1, *([1] * (n.dim() - 1))), n, o), new, old)


@dataclasses.dataclass(frozen=True)
class LocalTrainer:
    """Multi-epoch local training. ``train`` runs one client and returns
    ``(params, opt_state, loss_history[n_epochs])``; ``train_clients``
    runs a stacked cohort from shared starting params.

    With ``regularizer`` set, the local objective is ``data_loss +
    regularizer(params, anchor)`` and the caller passes ``anchor`` (the
    round's global params for FedProx). With ``partition`` set, ``params``
    is the trainable dict only and the caller passes the ``frozen`` dict;
    the model sees ``partition.merge(params, frozen)`` while gradients,
    optimizer state and the returned params stay trainable-only.

    ``progress_fn(epoch_index, epoch_loss)``, when set, runs on the host
    after each epoch (a float for one client, a list of floats for a
    cohort); it costs one device sync per epoch.
    """

    model: FedModel
    optimizer: optim.GradientTransformation
    batch_size: int
    regularizer: Optional[Regularizer] = None
    partition: Optional[ParamPartition] = None
    progress_fn: Optional[Callable[[int, object], None]] = None

    def init_opt_state(self, params: Params):
        return self.optimizer.init(params)

    def train_signature(self, data: Batch, n_epochs: int) -> tuple:
        """The shape signature of one ``train`` call: data shapes and
        dtypes, the epoch count and the batch size."""
        shapes = tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in data.items()))
        return (shapes, int(n_epochs), int(self.batch_size))

    def steps_per_round(self, capacity: int, n_epochs: int) -> int:
        """Optimizer steps one ``train`` call executes on the device: every
        padded batch of every epoch (masked no-ops included: they still
        cost the FLOPs)."""
        return int(n_epochs) * num_batches(int(capacity), self.batch_size)

    def _objective(self, params: Params, frozen: Optional[Params],
                   anchor: Optional[Params], batch: Batch):
        merged = self.partition.merge(params, frozen) if self.partition else params
        loss_sum, count = self.model.loss_and_count(merged, batch)
        loss = loss_sum / count.clamp_min(1.0)
        if self.regularizer is not None:
            loss = loss + self.regularizer(params, anchor)
        return loss, (loss_sum, count)

    def update_step(self, params: Params, opt_state, grads: Params, nonempty: torch.Tensor):
        """One optimizer step of a stacked cohort ([C, ...] leaves, a [C]
        ``nonempty`` gate): the optimizer's update applied where the batch
        held a sample; elsewhere params and state stay as they were."""
        updates, new_state = self.optimizer.update(grads, opt_state, params)
        new_params = optim.apply_updates(params, updates)
        return _where(nonempty, new_params, params), _where(nonempty, new_state, opt_state)

    def train(self, params: Params, data: Batch, n_samples: int, n_epochs: int = 1,
              anchor: Optional[Params] = None, frozen: Optional[Params] = None,
              perm: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """One client from a fresh optimizer state: ``data`` is a dict of
        [capacity, ...] tensors, ``perm`` an optional [n_epochs, capacity]
        injected shuffle. Returns ``(params, opt_state, loss_history)``."""
        return self.train_with_opt_state(params, self.optimizer.init(params), data, n_samples,
                                         n_epochs, anchor, frozen, perm, generator)

    def train_with_opt_state(self, params: Params, opt_state, data: Batch, n_samples: int,
                             n_epochs: int = 1, anchor: Optional[Params] = None,
                             frozen: Optional[Params] = None,
                             perm: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None):
        """``train`` from a given optimizer state (a stateful local
        optimizer kept across rounds)."""
        device = next(iter(params.values())).device
        n = torch.as_tensor([n_samples], device=device)
        stacked = {k: v[None] for k, v in data.items()}
        perms = None if perm is None else perm[None]
        p, state, losses = self._train_stacked(
            _stack(params, 1), _stack(opt_state, 1), stacked, n, n_epochs, perms, generator,
            anchor, frozen)
        unstack = lambda tree: optim.tree_map(lambda v: v[0], tree)  # noqa: E731
        return unstack(p), unstack(state), losses[0]

    def train_clients(self, params: Params, data: Batch, n_samples: torch.Tensor,
                      n_epochs: int = 1, perms: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      anchor: Optional[Params] = None, frozen: Optional[Params] = None):
        """C clients from the same ``params``, each from a fresh optimizer
        state (as JAX's ``train`` under vmap): ``data`` leaves are
        [C, capacity, ...], ``n_samples`` [C], ``perms`` an optional
        [C, n_epochs, capacity]. Returns the per-client params (leaves
        [C, ...]) and losses [C, n_epochs]; the optimizer states are
        dropped, as the engine drops them."""
        c = n_samples.shape[0]
        p, _, losses = self._train_stacked(
            _stack(params, c), _stack(self.optimizer.init(params), c), data, n_samples,
            n_epochs, perms, generator, anchor, frozen)
        return p, losses

    def _train_stacked(self, p, opt_state, data, n_samples, n_epochs, perms, generator,
                       anchor, frozen):
        if self.regularizer is not None and anchor is None:
            raise ValueError("a trainer with a regularizer needs the anchor params")
        if self.partition is not None and frozen is None:
            raise ValueError("a trainer with a partition needs the frozen params")
        c, capacity = n_samples.shape[0], next(iter(data.values())).shape[1]
        nb = num_batches(capacity, self.batch_size)
        device = n_samples.device
        if perms is None:
            perms = random_perms(c, n_epochs, capacity, generator)
        perms = perms.to(device)
        grad_fn = torch.func.vmap(
            torch.func.grad_and_value(self._objective, has_aux=True),
            in_dims=(0, None, None, 0))
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
                grads, (_, (loss_sum, count)) = grad_fn(p, frozen, anchor, batch)
                # an all-padding batch has exactly-zero grads; the gate keeps
                # its step a no-op for the params and the optimizer state
                p, opt_state = self.update_step(p, opt_state, grads, count > 0)
                loss_sums.append(loss_sum)
                counts.append(count)
            total = torch.stack(counts, 1).sum(1).clamp_min(1.0)
            history.append(torch.stack(loss_sums, 1).sum(1) / total)
            if self.progress_fn is not None:
                loss = history[-1].tolist()
                self.progress_fn(e, loss[0] if c == 1 else loss)
        return p, opt_state, torch.stack(history, 1)


def make_local_trainer(model: FedModel,
                       optimizer: Optional[optim.GradientTransformation] = None,
                       batch_size: int = 32, learning_rate: float = 1e-3,
                       regularizer: Optional[Regularizer] = None,
                       partition: Optional[ParamPartition] = None, dp=None,
                       progress_fn: Optional[Callable[[int, object], None]] = None
                       ) -> LocalTrainer:
    """A :class:`LocalTrainer`; ``optimizer=None`` means
    ``optim.sgd(learning_rate)``, batch 32 and lr 1e-3 by default (the
    reference demo's settings). DP-SGD (``dp``) is not ported yet."""
    if dp is not None:
        raise NotImplementedError("DP-SGD (dp=...) is not ported yet")
    if optimizer is None:
        optimizer = optim.sgd(learning_rate)
    return LocalTrainer(model=model, optimizer=optimizer, batch_size=batch_size,
                        regularizer=regularizer, partition=partition, progress_fn=progress_fn)


def make_evaluator(model: FedModel):
    """Full-dataset evaluation: mean loss over the real rows, and accuracy
    for integer labels. The whole set goes through one ``apply``."""

    @torch.no_grad()
    def evaluate(params: Params, data: Batch):
        losses = model.per_example_loss(params, data)
        mask = data.get("mask")
        mask = torch.ones_like(losses) if mask is None else mask
        mask = mask.float()
        denom = mask.sum().clamp_min(1.0)
        out = {"loss": (losses * mask).sum() / denom}
        y = data.get("y")
        if y is not None and not torch.is_floating_point(y):
            correct = (model.apply(params, data).argmax(dim=-1) == y).float()
            out["accuracy"] = (correct * mask).sum() / denom
        return out

    return evaluate
