"""Linear regression (counterpart of ``baton_tpu/models/linear.py``): the
reference demo's 10 -> 1 linear layer with MSE, params
``{"w": [d, 1], "b": [1]}``."""

from __future__ import annotations

import torch

from baton_tpu_torch.core.losses import mse
from baton_tpu_torch.core.model import FedModel


def linear_regression_model(in_dim: int = 10, name: str = "lineartest") -> FedModel:
    def init(gen: torch.Generator):
        # torch.nn.Linear's default U(-1/sqrt(d), 1/sqrt(d)) scale
        bound = in_dim ** -0.5
        w = (torch.rand((in_dim, 1), generator=gen) * 2 - 1) * bound
        return {"w": w, "b": torch.zeros(1)}

    def apply(params, batch):
        return batch["x"] @ params["w"] + params["b"]

    def per_example_loss(params, batch):
        return mse(apply(params, batch), batch)

    return FedModel(init=init, apply=apply, per_example_loss=per_example_loss, name=name)
