"""Optimizers as pure functions (the part of ``optax`` that the JAX
package, its examples and its tests use).

A :class:`GradientTransformation` is a pair of pure functions over flat
``{name: tensor}`` dicts:

  * ``init(params) -> state``
  * ``update(grads, state, params) -> (updates, state)``

and :func:`apply_updates` adds the updates to the params. Nothing is
mutated in place. Every operation is elementwise, so one client's
``[...]`` leaves and a stacked cohort's ``[C, ...]`` leaves go through
the same code; a stacked Adam state carries a ``[C]`` step count.
``torch.optim`` cannot serve here: it mutates its state in place, keeps
Adam's step as a float and knows no client axis.

The arithmetic is optax's, operation for operation:

* ``trace``: ``t = g + momentum * t``; the update is ``t``, or with
  Nesterov ``g + momentum * t``;
* ``scale_by_adam``: ``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 - b2) *
  g**2 + b2 * nu``, an int32 ``count`` incremented before the bias
  correction ``mu / (1 - b1**count)``, and the update
  ``mu_hat / (sqrt(nu_hat + eps_root) + eps)``;
* then ``scale(-learning_rate)``.

States are nested dicts of tensors: ``{}`` for plain SGD,
``{"trace": {...}}`` with momentum, ``{"count", "mu", "nu"}`` for Adam.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
OptState = Dict[str, Any]

_INT32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)``; ``hyperparams`` records the constructor's
    arguments."""

    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Optional[Params]], Tuple[Params, OptState]]
    hyperparams: Mapping[str, Any] = dataclasses.field(default_factory=dict)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _bias_correction(moment: torch.Tensor, correction: torch.Tensor):
    """``moment / correction``; the correction ``1 - decay**count`` is []
    or, for a stacked cohort, [C], broadcast over the leaf's trailing
    axes."""
    correction = correction.reshape(correction.shape + (1,) * (moment.dim() - correction.dim()))
    return moment / correction.to(moment.dtype)


def _scale(updates: Params, step_size: float) -> Params:
    return {k: g * step_size for k, g in updates.items()}


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    """``optax.sgd``: ``trace(momentum, nesterov)`` when momentum is set,
    then ``scale(-learning_rate)``."""

    def init(params: Params) -> OptState:
        if momentum is None:
            return {}
        return {"trace": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(grads: Params, state: OptState, params: Optional[Params] = None):
        if momentum is None:
            return _scale(grads, -learning_rate), state
        trace = {k: g + momentum * state["trace"][k] for k, g in grads.items()}
        updates = ({k: g + momentum * trace[k] for k, g in grads.items()}
                   if nesterov else trace)
        return _scale(updates, -learning_rate), {"trace": trace}

    return GradientTransformation(init, update, {
        "name": "sgd", "learning_rate": learning_rate, "momentum": momentum,
        "nesterov": nesterov})


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> GradientTransformation:
    """``optax.adam``: ``scale_by_adam(b1, b2, eps, eps_root)`` then
    ``scale(-learning_rate)``."""

    def init(params: Params) -> OptState:
        device = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(grads: Params, state: OptState, params: Optional[Params] = None):
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * g ** 2 + b2 * state["nu"][k] for k, g in grads.items()}
        count = state["count"]
        count = torch.where(count < _INT32_MAX, count + 1, count)
        c1, c2 = (1 - decay ** count.to(torch.float32) for decay in (b1, b2))
        updates = {}
        for k in grads:
            nu_hat = _bias_correction(nu[k], c2)
            if eps_root:  # adding 0.0 changes no value: skip its launch
                nu_hat = nu_hat + eps_root
            updates[k] = _bias_correction(mu[k], c1) / (torch.sqrt(nu_hat) + eps)
        return _scale(updates, -learning_rate), {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update, {
        "name": "adam", "learning_rate": learning_rate, "b1": b1, "b2": b2, "eps": eps,
        "eps_root": eps_root})


def apply_updates(params: Params, updates: Params) -> Params:
    """``p + u`` cast back to ``p``'s dtype, as ``optax.apply_updates``."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
