"""Per-example loss builders (counterpart of ``baton_tpu/core/losses.py``)."""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, batch) -> torch.Tensor:
    """Per-example cross entropy with integer labels ``batch["y"]`` [B]."""
    logits = logits.float()
    labels = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.take_along_dim(logits, labels[..., None], dim=-1).squeeze(-1)
    return logz - label_logits
