"""The value of a param split over a mesh axis, and the axis's reduction.

:class:`ShardedLeaf` and :func:`model_sum` are what the model functions
compute with on a ``model`` axis (``parallel/tensor_parallel.py`` places
params as them and says how). They depend on nothing of the port, so the
models layer imports them without loading the ``parallel`` package.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Sequence

import torch
from torch.utils import _pytree

if TYPE_CHECKING:
    from baton_tpu_torch.parallel.partition import PartitionSpec

MODEL_AXIS = "model"


class ShardedLeaf:
    """One param leaf split over a mesh axis: ``shards`` in shard order,
    equal slices of dim ``split_dim``, shard ``j`` on the ``j``-th device of
    ``axis``."""

    __slots__ = ("shards", "split_dim", "axis")

    def __init__(self, shards: Sequence[torch.Tensor], split_dim: int, axis: str = MODEL_AXIS):
        self.shards = tuple(shards)
        self.split_dim = int(split_dim)
        self.axis = axis

    @property
    def shape(self) -> torch.Size:
        shape = list(self.shards[0].shape)
        shape[self.split_dim] = sum(t.shape[self.split_dim] for t in self.shards)
        return torch.Size(shape)

    @property
    def ndim(self) -> int:
        return self.shards[0].dim()

    def dim(self) -> int:
        return self.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The first shard's device (where :meth:`gather` puts the whole)."""
        return self.shards[0].device

    @property
    def devices(self) -> list:
        return [t.device for t in self.shards]

    @property
    def spec(self) -> PartitionSpec:
        """The leaf's layout, as JAX's ``sharding.spec`` prints it."""
        # imported here: this module loads before the parallel package
        from baton_tpu_torch.parallel.partition import dim_spec

        return dim_spec(self.axis, self.split_dim, self.ndim)

    @property
    def size(self) -> int:
        """Each shard's extent along ``split_dim``."""
        return self.shards[0].shape[self.split_dim]

    def offsets(self) -> list:
        """``(start, size)`` of each shard along ``split_dim``."""
        return [(j * self.size, self.size) for j in range(len(self.shards))]

    def gather(self) -> torch.Tensor:
        """The whole tensor on the first shard's device."""
        home = self.device
        return torch.cat([on(t, home) for t in self.shards], dim=self.split_dim)

    def map(self, fn: Callable[[int, torch.Tensor], torch.Tensor]) -> "ShardedLeaf":
        """``fn(j, shard_j)`` of every shard, with the same layout."""
        return ShardedLeaf([fn(j, t) for j, t in enumerate(self.shards)], self.split_dim,
                           self.axis)

    def __repr__(self) -> str:
        return (f"ShardedLeaf(shape={tuple(self.shape)}, dtype={self.dtype}, spec={self.spec}, "
                f"devices={self.devices})")


_pytree.register_pytree_node(
    ShardedLeaf,
    lambda leaf: (list(leaf.shards), (leaf.split_dim, leaf.axis)),
    lambda shards, ctx: ShardedLeaf(shards, *ctx),
    serialized_type_name="baton_tpu_torch.core.sharded.ShardedLeaf",
)


def is_sharded(x) -> bool:
    return isinstance(x, ShardedLeaf)


def on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself where it already lies there."""
    return t if t.device == device else t.to(device, non_blocking=True)


def model_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The model axis's reduction: the partials added in shard order on the
    first one's device (one part is returned as it is)."""
    total = parts[0]
    for part in parts[1:]:
        total = total + on(part, total.device)
    return total
