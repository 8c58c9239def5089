"""Trainable/frozen parameter partitioning (counterpart of
``baton_tpu/core/partition.py``).

A :class:`ParamPartition` splits a flat ``{name: tensor}`` params dict
into a *trainable* part (per-client, optimized, aggregated) and a
*frozen* part (held once and shared by every simulated client) by a
predicate over the names. The names are the JAX package's ``path_str``
(slash-joined), so one predicate selects the same leaves in both
packages.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]
PathPredicate = Callable[[str, torch.Tensor], bool]


class ParamPartition:
    """Split and merge params of fixed names by a per-leaf boolean mask.
    ``merge`` restores the original order of the names."""

    def __init__(self, paths: Tuple[str, ...], mask: Tuple[bool, ...]):
        self.paths = tuple(paths)
        self.mask = tuple(mask)
        self.n_trainable = sum(self.mask)

    @property
    def frozen_paths(self) -> Tuple[str, ...]:
        return tuple(p for p, m in zip(self.paths, self.mask) if not m)

    @property
    def trainable_paths(self) -> Tuple[str, ...]:
        return tuple(p for p, m in zip(self.paths, self.mask) if m)

    def split(self, params: Params) -> Tuple[Params, Params]:
        if set(params) != set(self.paths):
            raise ValueError(
                f"params have {len(params)} leaves, partition expects {len(self.mask)}"
                + (" (same count, other names)" if len(params) == len(self.mask) else ""))
        trainable = {p: params[p] for p, m in zip(self.paths, self.mask) if m}
        frozen = {p: params[p] for p, m in zip(self.paths, self.mask) if not m}
        return trainable, frozen

    def merge(self, trainable: Params, frozen: Params) -> Params:
        if trainable is None or frozen is None:
            raise ValueError(
                "partition.merge needs both halves; a partition-configured "
                "trainer must be passed the frozen leaves explicitly")
        n_frozen = len(self.mask) - self.n_trainable
        if (set(trainable) != set(self.trainable_paths)
                or set(frozen) != set(self.frozen_paths)):
            raise ValueError(
                f"expected {self.n_trainable} trainable + {n_frozen} frozen "
                f"leaves, got {len(trainable)} + {len(frozen)}")
        return {p: (trainable if m else frozen)[p] for p, m in zip(self.paths, self.mask)}


def make_partition(params: Params, predicate: PathPredicate) -> ParamPartition:
    """Build a partition: ``predicate(name, leaf)`` True = trainable."""
    mask = tuple(bool(predicate(name, leaf)) for name, leaf in params.items())
    if not any(mask):
        raise ValueError("partition selects no trainable leaves")
    return ParamPartition(tuple(params), mask)
