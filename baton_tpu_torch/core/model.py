"""Model contract (counterpart of ``baton_tpu/core/model.py``).

A model is three pure functions over a flat parameter dict
``{slash/joined/name: tensor}``:

  * ``init(generator) -> params``
  * ``apply(params, batch) -> outputs``
  * ``per_example_loss(params, batch) -> [B]`` per-example losses

Being pure, they go straight through ``torch.func.grad`` and
``torch.func.vmap`` over a stacked client axis. The models of this package
use no randomness in ``apply``, so it takes no generator.

Batches are dicts of tensors with a shared leading batch dimension; an
optional ``"mask"`` entry (f32[B], 1.0 = real sample) is consumed by the
framework, never by the model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping

import torch

Params = Dict[str, torch.Tensor]
Batch = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FedModel:
    """A federated model: pure init/apply/per-example-loss functions."""

    init: Callable[[torch.Generator], Params]
    apply: Callable[[Params, Batch], Any]
    per_example_loss: Callable[[Params, Batch], torch.Tensor]
    name: str = "fedmodel"
    aux: Any = None

    def masked_loss(self, params: Params, batch: Batch) -> torch.Tensor:
        """Mean loss over real (unmasked) examples; an all-padding batch
        gives 0 through the guarded denominator."""
        losses = self.per_example_loss(params, batch)
        mask = batch.get("mask")
        if mask is None:
            return losses.mean()
        mask = mask.to(losses.dtype)
        return (losses * mask).sum() / mask.sum().clamp_min(1.0)

    def loss_and_count(self, params: Params, batch: Batch):
        """(sum of masked losses, number of real examples) — sums, so
        callers form exact sample-weighted means over ragged batches."""
        losses = self.per_example_loss(params, batch)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(losses)
        mask = mask.to(losses.dtype)
        return (losses * mask).sum(), mask.sum()
