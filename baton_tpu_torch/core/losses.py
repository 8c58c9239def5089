"""Per-example loss builders (counterpart of ``baton_tpu/core/losses.py``)."""

from __future__ import annotations

import torch


def mse(outputs: torch.Tensor, batch) -> torch.Tensor:
    """Per-example mean-squared error against ``batch["y"]`` (a trailing
    size-1 output axis is squeezed to match a rank-1 target)."""
    y = batch["y"]
    if outputs.dim() > y.dim():
        outputs = outputs.squeeze(-1)
    err = (outputs - y).float()
    if err.dim() == 1:
        return err * err
    return (err * err).mean(dim=tuple(range(1, err.dim())))


def softmax_cross_entropy(logits: torch.Tensor, batch) -> torch.Tensor:
    """Per-example cross entropy with integer labels ``batch["y"]`` [B]."""
    logits = logits.float()
    labels = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.take_along_dim(logits, labels[..., None], dim=-1).squeeze(-1)
    return logz - label_logits


def sigmoid_binary_cross_entropy(logits: torch.Tensor, batch) -> torch.Tensor:
    """Per-example binary cross entropy with labels ``batch["y"]`` in {0, 1}
    [B], in fp32 (a trailing size-1 logit axis is squeezed), in the stable
    form max(x, 0) - x·y + log1p(exp(-|x|))."""
    y = batch["y"].float()
    logits = logits.float()
    if logits.dim() > y.dim():
        logits = logits.squeeze(-1)
    return logits.clamp_min(0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
