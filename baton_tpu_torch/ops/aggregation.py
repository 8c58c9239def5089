"""Aggregation over a stacked client axis (counterpart of
``baton_tpu/ops/aggregation.py``).

* Sample-weighted FedAvg, ``Σ_c w_c · leaf[c] / Σ_c w_c``, accumulated in
  fp32 whatever the parameter dtype.
* The robust rules: coordinate-wise trimmed mean and median, unweighted,
  selected by a spec string (:func:`parse_aggregator`) and combined by
  :func:`aggregate_stacked`.
* :class:`StreamingMean` and :class:`ShardedStreamingMean`: numpy folds of
  ``{name: array}`` updates as they arrive, copied from the JAX package.

Params are flat ``{name: tensor}`` dicts; a stacked dict has a leading
client axis on every leaf. The mesh (``psum``) forms wait for the
multi-device port.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from baton_tpu_torch.core.model import Params


def tree_stack(trees: Sequence[Params]) -> Params:
    """Stack identically named dicts along a new axis 0."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def tree_unstack(tree: Params) -> list:
    """Inverse of :func:`tree_stack`."""
    n = next(iter(tree.values())).shape[0]
    return [{k: v[i] for k, v in tree.items()} for i in range(n)]


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


def weighted_scalar_mean(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Sample-weighted mean of per-client values ``[C, ...]`` (the loss
    history), in fp32."""
    w = weights.float()
    return torch.tensordot(w, values.float(), dims=([0], [0])) / w.sum().clamp_min(1e-9)


def tree_sub(a: Params, b: Params) -> Params:
    return {k: a[k] - b[k] for k in a}


def tree_add(a: Params, b: Params) -> Params:
    return {k: a[k] + b[k] for k in a}


def tree_scale(a: Params, s) -> Params:
    return {k: v * s for k, v in a.items()}


def tree_zeros_like(a: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in a.items()}


def global_sq_dist(a: Params, b: Params) -> torch.Tensor:
    """``‖a − b‖²`` over all leaves, in fp32."""
    total = torch.zeros((), dtype=torch.float32, device=next(iter(a.values())).device)
    for k in a:
        total = total + (a[k].float() - b[k].float()).square().sum()
    return total


def trimmed_mean(stacked: Params, trim_ratio: float = 0.1) -> Params:
    """Coordinate-wise trimmed mean over the client axis: drop the
    ``int(C * trim_ratio)`` smallest and largest values of each coordinate
    (none if that would drop them all) and average the rest."""

    def one(leaf):
        c = leaf.shape[0]
        k = int(c * trim_ratio)
        srt = torch.sort(leaf.float(), dim=0).values
        kept = srt[k: c - k] if c - 2 * k > 0 else srt
        return kept.mean(dim=0).to(leaf.dtype)

    return {name: one(leaf) for name, leaf in stacked.items()}


def coordinate_median(stacked: Params) -> Params:
    """Coordinate-wise median over the client axis. For an even count it
    is the mean of the two middle values, as ``jnp.median`` gives
    (``torch.median`` would return the lower one)."""

    def one(leaf):
        c = leaf.shape[0]
        srt = torch.sort(leaf.float(), dim=0).values
        mid = srt[c // 2] if c % 2 else (srt[c // 2 - 1] + srt[c // 2]) * 0.5
        return mid.to(leaf.dtype)

    return {name: one(leaf) for name, leaf in stacked.items()}


def parse_aggregator(spec: str):
    """``"mean" | "trimmed:<ratio>" | "median"`` -> tagged tuple."""
    if spec == "mean":
        return ("mean",)
    if spec == "median":
        return ("median",)
    if spec.startswith("trimmed:"):
        ratio = float(spec.split(":", 1)[1])
        if not (0.0 <= ratio < 0.5):
            raise ValueError(f"trim ratio must be in [0, 0.5), got {ratio}")
        return ("trimmed", ratio)
    raise ValueError(
        f"unknown aggregator {spec!r}; expected 'mean', 'median', or 'trimmed:<ratio>'")


def apply_aggregator(spec, stacked: Params, weights: Optional[torch.Tensor]) -> Params:
    """Dispatch a :func:`parse_aggregator` tuple over stacked client params
    (the robust rules ignore ``weights``)."""
    if spec[0] == "trimmed":
        return trimmed_mean(stacked, spec[1])
    if spec[0] == "median":
        return coordinate_median(stacked)
    return weighted_tree_mean(stacked, weights)


def aggregate_stacked(spec, stacked: Params, n_samples, like: Params) -> Params:
    """Combine ``[C, ...]``-stacked client params into one dict typed like
    ``like``. For the robust rules, zero-sample clients are excluded first:
    their "update" is the unchanged broadcast, and enough of them would
    pull the order statistic to a no-op round (all of them are kept when
    every client is empty). The weighted mean needs no exclusion."""
    n = torch.as_tensor(n_samples)
    if spec[0] != "mean":
        keep = torch.nonzero(n.cpu() > 0).flatten()
        if keep.numel() == 0:
            keep = torch.arange(n.shape[0])
        device = next(iter(stacked.values())).device
        keep = keep.to(device)
        merged = apply_aggregator(spec, {k: v.index_select(0, keep) for k, v in stacked.items()},
                                  None)
    else:
        merged = apply_aggregator(spec, stacked, n.float())
    return tree_cast_like(merged, like)


def tree_cast_like(tree: Params, like: Params) -> Params:
    """Cast every leaf to the dtype of the same-named ``like`` leaf."""
    return {k: v.to(like[k].dtype) for k, v in tree.items()}


class StreamingMean:
    """O(model) streaming FedAvg: fold ``{name: array}`` updates as they
    arrive, keeping only ``(Σ w_c · x_c, Σ w_c)``.

    Accumulation is sequential fp32 numpy, so the result is a
    deterministic function of arrival order and matches the reference
    formula evaluated left to right in fp32. Only the ``"mean"``
    aggregator streams; the order statistics need the whole cohort.
    ``add`` and ``mean`` take an internal lock: numpy releases the GIL
    mid-ufunc, so two threads folding at once could otherwise drop an
    update.
    """

    def __init__(self) -> None:
        self._sums: Optional[dict] = None
        self._weight = np.float32(0.0)
        self.count = 0
        self._lock = threading.Lock()

    def add(self, state_dict: dict, weight: float) -> None:
        """Fold one client's update with sample weight ``weight``. After
        this returns the caller may drop the tensors."""
        w = np.float32(weight)
        with self._lock:
            if self._sums is None:
                self._sums = {k: np.asarray(v, np.float32) * w for k, v in state_dict.items()}
            else:
                for k, v in state_dict.items():
                    self._sums[k] += np.asarray(v, np.float32) * w
            self._weight = self._weight + w
            self.count += 1

    @property
    def total_weight(self) -> float:
        return float(self._weight)

    def mean(self) -> Optional[dict]:
        """``Σ w·x / max(Σ w, 1e-9)`` as fp32 arrays, or None if nothing
        was folded."""
        with self._lock:
            if self._sums is None:
                return None
            denom = np.maximum(self._weight, np.float32(1e-9))
            return {k: v / denom for k, v in self._sums.items()}


class ShardedStreamingMean:
    """N independent :class:`StreamingMean` partials, merged at ``mean()``
    (weighted sums are associative, so the merge equals the sequential
    fold up to fp32 reduction order). Same duck type as StreamingMean,
    with a ``shard=`` routing argument to ``add``."""

    def __init__(self, shards: int = 1) -> None:
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.partials = [StreamingMean() for _ in range(int(shards))]

    @property
    def shards(self) -> int:
        return len(self.partials)

    @property
    def count(self) -> int:
        return sum(p.count for p in self.partials)

    @property
    def total_weight(self) -> float:
        return float(sum(p.total_weight for p in self.partials))

    def add(self, state_dict: dict, weight: float, shard: int = 0) -> None:
        self.partials[int(shard) % len(self.partials)].add(state_dict, weight)

    def mean(self) -> Optional[dict]:
        """Merge partial ``(Σ w·x, Σ w)`` pairs, then divide once."""
        sums: Optional[dict] = None
        weight = np.float32(0.0)
        for p in self.partials:
            with p._lock:
                if p._sums is None:
                    continue
                if sums is None:
                    sums = {k: np.array(v, np.float32, copy=True) for k, v in p._sums.items()}
                else:
                    for k, v in p._sums.items():
                        sums[k] += v
                weight = weight + p._weight
        if sums is None:
            return None
        denom = np.maximum(weight, np.float32(1e-9))
        return {k: v / denom for k, v in sums.items()}
