"""Sample-weighted FedAvg over a stacked client axis (counterpart of
``baton_tpu/ops/aggregation.py``): ``Σ_c w_c · leaf[c] / Σ_c w_c``,
accumulated in fp32 whatever the parameter dtype."""

from __future__ import annotations

import torch

from baton_tpu_torch.core.model import Params


def weighted_tree_sum(stacked: Params, weights: torch.Tensor) -> Params:
    """``Σ_c w_c · leaf[c]`` for every leaf of a ``[C, ...]``-stacked dict.
    fp32 leaves: these are partial sums for further accumulation (waves),
    and callers cast the final mean back to the parameter dtype."""
    w = weights.float()
    return {k: torch.tensordot(w, leaf.float(), dims=([0], [0]))
            for k, leaf in stacked.items()}


def weighted_tree_mean(stacked: Params, weights: torch.Tensor) -> Params:
    """The reference rule ``Σ(value · n_samples) / Σ n_samples`` in fp32,
    with the denominator clamped at 1e-9 so an all-zero cohort gives 0."""
    denom = weights.float().sum().clamp_min(1e-9)
    return {k: (s / denom).to(stacked[k].dtype)
            for k, s in weighted_tree_sum(stacked, weights).items()}
