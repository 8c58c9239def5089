"""Small MLP classifier (counterpart of ``baton_tpu/models/mlp.py``). The
JAX params are a list of layers, so their names are ``"0/w"``, ``"0/b"``,
``"1/w"``, ...; weights are ``[d_in, d_out]``."""

from __future__ import annotations

from typing import Sequence

import torch

from baton_tpu_torch.core.losses import softmax_cross_entropy
from baton_tpu_torch.core.model import FedModel


def mlp_classifier_model(in_dim: int, hidden: Sequence[int] = (64,), n_classes: int = 10,
                         name: str = "mlp") -> FedModel:
    dims = [in_dim, *hidden, n_classes]
    n_layers = len(dims) - 1

    def init(gen: torch.Generator):
        params = {}
        for i in range(n_layers):
            scale = (2.0 / dims[i]) ** 0.5
            params[f"{i}/w"] = torch.randn((dims[i], dims[i + 1]), generator=gen) * scale
            params[f"{i}/b"] = torch.zeros(dims[i + 1])
        return params

    def apply(params, batch):
        h = batch["x"].reshape(batch["x"].shape[0], -1)
        for i in range(n_layers):
            h = h @ params[f"{i}/w"] + params[f"{i}/b"]
            if i < n_layers - 1:
                h = torch.relu(h)
        return h

    def per_example_loss(params, batch):
        return softmax_cross_entropy(apply(params, batch), batch)

    return FedModel(init=init, apply=apply, per_example_loss=per_example_loss, name=name)
