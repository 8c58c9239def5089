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
The frozen params enter that vmap unbatched (``in_dims=None``): they are
never repeated per client, and the gradient is taken with respect to the
trainable params alone. The regularizer's anchor is unbatched too when
the cohort shares it (FedSim's round), or batched when it is stacked per
client, as each client's own starting params are in ``train_stacked``'s
callers (FedBuff's stale anchors, FedPer's merged params, a cluster's
gather).

With ``dp`` (a :class:`baton_tpu_torch.ops.privacy.DPConfig`) a step is
DP-SGD (JAX's ``dp=`` branch): each client's per-example gradients of
its masked data-loss sum are a ``vmap`` nested inside the client
``vmap``, clipped and summed in fp32, noised and divided by the static
batch size (``privacy.dp_sgd_grads``); a regularizer's gradient is added
exactly, without noise. ``torch.func.vmap`` refuses random draws inside
the transform, so each step's noise is drawn before it: one
``[C, *shape]`` standard-normal tensor per trainable leaf, in the
params' order, from the cohort's noise generator (:func:`noise_generator`
of the caller's generator), and client ``c`` gets row ``c``.

JAX draws its permutations from threefry keys, which torch cannot
reproduce; callers that need JAX's exact shuffles inject them as
``perms``, otherwise they come from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from baton_tpu_torch.core import optim
from baton_tpu_torch.core.model import Batch, FedModel, Params
from baton_tpu_torch.core.partition import ParamPartition
from baton_tpu_torch.ops import privacy

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


def noise_seed(generator: torch.Generator) -> int:
    """One 62-bit seed drawn from ``generator`` (``noise_generator``'s)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())


def noise_generator(generator: Optional[torch.Generator], device: torch.device
                    ) -> torch.Generator:
    """The generator a cohort's DP noise is drawn from on ``device``:
    ``generator`` itself when it lies there, else a new generator on
    ``device`` seeded with :func:`noise_seed` of it, so the draws stay on
    the card and depend only on the caller's generator."""
    if generator is None:
        raise ValueError("DP-SGD noise needs a torch.Generator")
    if draws_on(generator, device):
        return generator
    return torch.Generator(device=device).manual_seed(noise_seed(generator))


def draws_on(generator: torch.Generator, device) -> bool:
    """True when ``generator`` draws on ``device`` (``cuda`` and
    ``cuda:<current>`` are one card)."""
    a, b = generator.device, torch.device(device)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def stack_copies(tree, c: int):
    """``c`` copies of every leaf of nested dicts, along a new leading
    client axis."""
    return optim.tree_map(lambda v: v.unsqueeze(0).repeat(c, *([1] * v.dim())), tree)


def stack_shapes(params: Params, total: int) -> dict:
    """``{name: [total, *shape]}`` meta tensors for stacked ``params``
    (shape templates: nothing is allocated)."""
    return {k: torch.empty((total,) + tuple(v.shape[1:]), device="meta")
            for k, v in params.items()}


def noise_rows_of(params: Params, generator: torch.Generator,
                  noise_rows: Tuple[int, int, int], device) -> Params:
    """Rows ``lo:hi`` (``noise_rows = (lo, hi, total)``) of one step's
    standard-normal noise for a cohort of ``total`` clients stacked like
    ``params``, on ``device``: ``privacy.gaussian_noise_like`` of the
    cohort's ``[total, ...]`` shapes from ``generator``, drawn leaf by leaf
    in the params' order (the draws of the whole cohort's noise) and cut
    to the rows at once, so one leaf's whole draw is alive at a time and
    the rows kept own their memory."""
    lo, hi, total = noise_rows
    out = {}
    for k, shape in stack_shapes(params, total).items():
        full = privacy.gaussian_noise_like({k: shape}, 1.0, generator)[k]
        out[k] = (full.to(device, non_blocking=True) if (lo, hi) == (0, total)
                  else full[lo:hi].to(device, non_blocking=True, copy=True))
    return out


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

    With ``dp`` set, every step is DP-SGD (module docstring); the noise
    comes from ``generator`` (:func:`noise_generator`).

    ``progress_fn(epoch_index, epoch_loss)``, when set, runs on the host
    after each epoch (a float for one client, a list of floats for a
    cohort); it costs one device sync per epoch.
    """

    model: FedModel
    optimizer: optim.GradientTransformation
    batch_size: int
    regularizer: Optional[Regularizer] = None
    partition: Optional[ParamPartition] = None
    dp: Optional[privacy.DPConfig] = None
    progress_fn: Optional[Callable[[int, object], None]] = None

    def init_opt_state(self, params: Params):
        return self.optimizer.init(params)

    def init_opt_states(self, params: Params, n_clients: int):
        """``n_clients`` fresh optimizer states of one client's ``params``,
        stacked [C, ...] (Adam's count [C])."""
        return stack_copies(self.optimizer.init(params), n_clients)

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

    def _dp_grads(self, params: Params, frozen: Optional[Params], anchor: Optional[Params],
                  batch: Batch, noise: Optional[Params]):
        """One client's DP-SGD gradient (``privacy.dp_sgd_grads`` of the
        masked data-loss sum, plus the regularizer's exact gradient) and
        its ``(loss_sum, count)``. Padding rows have exactly-zero
        gradients, so clipping leaves them as they are."""

        def data_loss_sum(p, b):
            merged = self.partition.merge(p, frozen) if self.partition else p
            return self.model.loss_and_count(merged, b)[0]

        grads, ex_losses = privacy.dp_sgd_grads(data_loss_sum, params, batch, None, self.dp,
                                                self.batch_size, noise=noise)
        if self.regularizer is not None:
            # the prox term is data-independent: its gradient is exact
            # (un-noised) and consumes no privacy budget
            reg = torch.func.grad(lambda q: self.regularizer(q, anchor))(params)
            grads = {k: (g + reg[k]).to(g.dtype) for k, g in grads.items()}
        # ex_losses are mask-zeroed already; NOT privatized (DPConfig)
        return grads, (ex_losses.sum(), batch["mask"].float().sum())

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
        optimizer kept across rounds). ``params`` and ``opt_state`` enter
        :meth:`train_stacked` as views along a client axis of 1, not as
        copies (the counterpart of the reference donating ``opt_state``):
        it writes none of its inputs, so the caller's tensors stay as they
        were and the state is not held twice while it runs."""
        device = next(iter(params.values())).device
        n = torch.as_tensor([n_samples], device=device)
        stacked = {k: v[None] for k, v in data.items()}
        perms = None if perm is None else perm[None]
        view = lambda tree: optim.tree_map(lambda v: v[None], tree)  # noqa: E731
        p, state, losses = self.train_stacked(
            view(params), view(opt_state), stacked, n, n_epochs, perms, generator, anchor,
            frozen)
        unstack = lambda tree: optim.tree_map(lambda v: v[0], tree)  # noqa: E731
        return unstack(p), unstack(state), losses[0]

    def train_clients(self, params: Params, data: Batch, n_samples: torch.Tensor,
                      n_epochs: int = 1, perms: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      anchor: Optional[Params] = None, frozen: Optional[Params] = None,
                      noise_rows: Optional[Tuple[int, int, int]] = None):
        """C clients from the same ``params``, each from a fresh optimizer
        state (as JAX's ``train`` under vmap): ``data`` leaves are
        [C, capacity, ...], ``n_samples`` [C], ``perms`` an optional
        [C, n_epochs, capacity]. Returns the per-client params (leaves
        [C, ...]) and losses [C, n_epochs]; the optimizer states are
        dropped, as the engine drops them. ``noise_rows``: see
        ``train_stacked``."""
        c = n_samples.shape[0]
        p, _, losses = self.train_stacked(
            stack_copies(params, c), self.init_opt_states(params, c), data, n_samples,
            n_epochs, perms, generator, anchor, frozen, noise_rows)
        return p, losses

    def train_stacked(self, params: Params, opt_state, data: Batch, n_samples: torch.Tensor,
                      n_epochs: int = 1, perms: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      anchor: Optional[Params] = None, frozen: Optional[Params] = None,
                      noise_rows: Optional[Tuple[int, int, int]] = None):
        """C clients, each from its own starting point: ``params`` and
        ``opt_state`` leaves are [C, ...] (``init_opt_states`` gives fresh
        states), ``data`` leaves [C, capacity, ...], ``n_samples`` [C],
        ``perms`` an optional [C, n_epochs, capacity]. ``anchor`` is one
        dict for the whole cohort (leaves shaped as one client's) or one
        per client (leaves [C, ...], as ``params``); ``frozen`` is one
        dict, never batched. Under DP with noise, each step draws
        ``privacy.gaussian_noise_like(params, 1.0, g)`` of the stacked
        params from ``g = noise_generator(generator, device)``, after the
        shuffles. ``noise_rows = (lo, hi, total)`` makes these C clients rows
        ``lo:hi`` of a cohort of ``total``: each step draws the cohort's
        ``[total, ...]`` noise from ``generator`` itself (a replica of the
        cohort's noise generator, one a shard of a clients mesh) and keeps
        those rows (:func:`noise_rows_of`), so a client gets the noise it
        gets without the mesh.
        Returns ``(params, opt_state, losses [C, n_epochs])``."""
        p = params
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
        name = next(iter(anchor)) if anchor is not None else None
        anchor_dim = 0 if name is not None and anchor[name].dim() == p[name].dim() else None
        if self.dp is None:
            grad_fn = torch.func.vmap(
                torch.func.grad_and_value(self._objective, has_aux=True),
                in_dims=(0, None, anchor_dim, 0))

            def step_grads(p, batch):
                grads, (_, sums) = grad_fn(p, frozen, anchor, batch)
                return grads, sums
        else:
            noisy = self.dp.noise_multiplier > 0
            if noisy and noise_rows is not None and generator is None:
                raise ValueError("DP-SGD noise needs a torch.Generator")
            gen = (None if not noisy else generator if noise_rows is not None
                   else noise_generator(generator, device))
            dp_fn = torch.func.vmap(self._dp_grads,
                                    in_dims=(0, None, anchor_dim, 0, 0 if noisy else None))

            def step_grads(p, batch):
                noise = None
                if noisy and noise_rows is None:
                    noise = privacy.gaussian_noise_like(p, 1.0, gen)
                elif noisy:
                    noise = noise_rows_of(p, gen, noise_rows, device)
                return dp_fn(p, frozen, anchor, batch, noise)
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
                grads, (loss_sum, count) = step_grads(p, batch)
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
                       partition: Optional[ParamPartition] = None,
                       dp: Optional[privacy.DPConfig] = None,
                       progress_fn: Optional[Callable[[int, object], None]] = None
                       ) -> LocalTrainer:
    """A :class:`LocalTrainer`; ``optimizer=None`` means
    ``optim.sgd(learning_rate)``, batch 32 and lr 1e-3 by default (the
    reference demo's settings); ``dp`` a ``privacy.DPConfig`` makes every
    step DP-SGD."""
    if optimizer is None:
        optimizer = optim.sgd(learning_rate)
    return LocalTrainer(model=model, optimizer=optimizer, batch_size=batch_size,
                        regularizer=regularizer, partition=partition, dp=dp,
                        progress_fn=progress_fn)


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
