"""Device meshes and placement (counterpart of ``baton_tpu/parallel/mesh.py``).

A mesh is a grid of ``torch.device``s with one name per axis, as a
``jax.sharding.Mesh`` is. One process drives every shard it holds: shard
``j`` of a tensor split over an axis lives on the ``j``-th device along it.
The cluster of simulated clients is a mesh with a ``clients`` axis:
per-client params, optimizer states and data shards are split along it,
the round's broadcast is a copy to every shard's device, and FedAvg is a
psum over it (:func:`baton_tpu_torch.ops.aggregation.psum`).

A device may appear more than once. That is the port's counterpart of
XLA's virtual host devices (``--xla_force_host_platform_device_count``):
``make_mesh(8, devices=[torch.device("cpu")] * 8)`` is an 8-way clients
mesh on the CPU, and ``[torch.device("cuda", 0)] * 4`` a 4-way one on one
card.

A mesh may span processes (:func:`baton_tpu_torch.parallel.multihost.
make_hybrid_mesh`): ``process_ids`` names the process that holds each
device, a process places and computes only the shards it holds
(:meth:`Mesh.local_shards`), and the psum adds them before one
``torch.distributed.all_reduce``.

A placed value, the result of :func:`device_put`, is a list of tensors,
one for each device of the mesh this process holds, in the mesh's order
(row-major over its axes), each the slice of the value that device holds
under the spec, as ``jax.device_put`` lays it out: on a 1-D mesh (or one
whose other axes have size 1) shard ``j`` on the ``j``-th device, and a
replicated value one copy a device. A hybrid ``("clients", "model")``
mesh is a grid: :meth:`Mesh.line` is one row or column of it as a 1-D
mesh (the clients along one model index, or the model shards of one
clients shard), which is how the engine and
:mod:`baton_tpu_torch.parallel.tensor_parallel` address it. All
PartitionSpecs come from :mod:`baton_tpu_torch.parallel.partition`; this
module builds meshes and places tensors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from baton_tpu_torch.parallel.partition import (  # noqa: F401  (re-exported)
    CLIENT_AXIS,
    MODEL_AXIS,
    NamedSharding,
    client_spec,
    replicated_spec,
)


def _object_array(items, shape) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    for i, d in enumerate(items):
        arr[i] = d
    return arr.reshape(shape)


class Mesh:
    """``devices``: an array of ``torch.device``s with one dimension per
    name in ``axis_names``; ``mesh.shape[name]`` is the size of that axis.
    ``process_ids`` (same shape, default all 0) is the rank of the process
    that holds each device; ``process_index`` is this process's rank and
    ``process_group`` the ``torch.distributed`` group of the processes
    (None: the default group)."""

    def __init__(self, devices, axis_names: Sequence[str], process_ids=None,
                 process_index: int = 0, process_group=None):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of {arr.ndim} dimensions needs as many axis names, "
                             f"got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must differ, got {axis_names}")
        ids = (np.zeros(arr.shape, dtype=np.int64) if process_ids is None
               else np.asarray(process_ids, dtype=np.int64))
        if ids.shape != arr.shape:
            raise ValueError(f"process_ids of shape {ids.shape} for devices of shape {arr.shape}")
        if process_index not in set(ids.flat):
            raise ValueError(f"process {process_index} holds no device of the mesh")
        self.devices = arr
        self.axis_names = axis_names
        self.process_ids = ids
        self.process_index = int(process_index)
        self.process_group = process_group

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_processes(self) -> bool:
        return len(set(self.process_ids.flat)) > 1

    def _along(self, arr: np.ndarray, axis_name: str) -> list:
        if axis_name not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis_name!r}; its axes are {self.axis_names}")
        along = np.moveaxis(arr, self.axis_names.index(axis_name), 0)
        return list(along.reshape(along.shape[0], -1)[:, 0])

    def axis_devices(self, axis_name: str) -> list:
        """The devices along ``axis_name``, at index 0 of every other axis:
        shard ``j`` of a tensor split over that axis lives on the ``j``-th."""
        return self._along(self.devices, axis_name)

    def axis_process_ids(self, axis_name: str) -> List[int]:
        """The rank of the process that holds each shard along
        ``axis_name`` (at index 0 of every other axis), in shard order."""
        return [int(p) for p in self._along(self.process_ids, axis_name)]

    def local_shards(self, axis_name: str = CLIENT_AXIS) -> List[Tuple[int, torch.device]]:
        """``(j, device)`` of the shards along ``axis_name`` that this
        process holds, in shard order."""
        owners = self.axis_process_ids(axis_name)
        return [(j, d) for j, (d, p) in enumerate(zip(self.axis_devices(axis_name), owners))
                if p == self.process_index]

    def line(self, axis_name: str, **at: int) -> "Mesh":
        """The 1-D mesh along ``axis_name`` with every other axis fixed at
        its index in ``at`` (0 where not given): on a ``("clients",
        "model")`` mesh, ``line("clients")`` is the clients axis at model
        index 0 and ``line("model", clients=j)`` the model shards of
        clients shard ``j``. It keeps the devices' owners, this process's
        index and the process group."""
        if axis_name not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis_name!r}; its axes are {self.axis_names}")
        unknown = set(at) - set(self.axis_names) | ({axis_name} & set(at))
        if unknown:
            raise ValueError(f"cannot fix axes {sorted(unknown)} of a line along {axis_name!r} "
                             f"on a mesh with axes {self.axis_names}")
        index = tuple(slice(None) if a == axis_name else at.get(a, 0) for a in self.axis_names)
        return Mesh(self.devices[index], (axis_name,), process_ids=self.process_ids[index],
                    process_index=self.process_index, process_group=self.process_group)

    def local_line(self, axis_name: str) -> "Mesh":
        """The first line along ``axis_name`` (other axes in the mesh's
        order) whose devices this process holds every one of."""
        others = [a for a in self.axis_names if a != axis_name]
        for pos in np.ndindex(*(self.shape[a] for a in others)):
            sub = self.line(axis_name, **dict(zip(others, pos)))
            if (sub.process_ids == self.process_index).all():
                return sub
        raise ValueError(f"process {self.process_index} holds no whole line of the mesh along "
                         f"{axis_name!r}: that axis crosses processes")

    def local_devices(self) -> list:
        """Every device of the mesh this process holds, in the mesh's order
        (a replicated value's shard devices)."""
        return [d for d, p in zip(self.devices.flat, self.process_ids.flat)
                if p == self.process_index]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = (CLIENT_AXIS,),
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices``, all of them on
    the first axis (size 1 on the others), as the JAX package's
    ``make_mesh``. ``devices`` defaults to every CUDA device; with none it
    raises (there is no CPU fallback: pass ``devices=[torch.device("cpu")]
    * n`` for a mesh on the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=[torch.device('cpu')]"
                               " * n for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(_object_array(devs, (len(devs),) + (1,) * (len(axis_names) - 1)), axis_names)


def cuda_clients_mesh() -> Optional[Mesh]:
    """The examples' ``use_mesh=True``: a clients mesh over every CUDA
    device when there is more than one, else None (one device runs
    meshless), as the JAX examples build one over ``jax.devices()``."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        return make_mesh()
    return None


def client_sharding(mesh: Mesh, axis: str = CLIENT_AXIS) -> NamedSharding:
    """Sharding of ``[C, ...]`` stacked client arrays: dim 0 over the
    client axis, the rest whole."""
    return NamedSharding(mesh, client_spec(axis))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Fully replicated sharding (the global model each round)."""
    return NamedSharding(mesh, replicated_spec())


def device_put(x: torch.Tensor, sharding: NamedSharding) -> List[torch.Tensor]:
    """``x`` placed on ``sharding`` (``jax.device_put``): one tensor for each
    device of the mesh this process holds, in the mesh's order (row-major
    over its axes), each moved with ``.to(device, non_blocking=True)`` (no
    copy where it is ``x``'s own device). Device ``(i_0, i_1, ...)`` (its
    index along each axis) holds, for every dim the spec names axes for,
    slice ``k`` of ``n`` equal slices of that dim, where ``n`` is the
    product of those axes' sizes and ``k`` the device's index along them
    read as one number, the first axis named the most significant (a
    tuple of names splits one dim over several axes); every other dim is
    whole. So a replicated value is one copy a device, and on a 1-D mesh
    shard ``j`` is the ``j``-th slice on the ``j``-th device. A split dim
    must be a multiple of its ``n``."""
    mesh, spec = sharding.mesh, sharding.spec
    splits = []  # (dim, axis names)
    for dim, names in enumerate(spec):
        if names is None:
            continue
        names = names if isinstance(names, tuple) else (names,)
        for name in names:
            if name not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {name!r}; the mesh has {mesh.axis_names}")
        n = int(np.prod([mesh.shape[a] for a in names]))
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over the {n} shards "
                             f"of axis {names[0] if len(names) == 1 else names!r}")
        splits.append((dim, names, x.shape[dim] // n))
    out = []
    for pos in np.ndindex(*mesh.devices.shape):
        if mesh.process_ids[pos] != mesh.process_index:
            continue
        index = dict(zip(mesh.axis_names, pos))
        part = x
        for dim, names, size in splits:
            k = 0
            for a in names:
                k = k * mesh.shape[a] + index[a]
            part = part.narrow(dim, k * size, size)
        out.append(part.to(mesh.devices[pos], non_blocking=True))
    return out


def _per_shard(tree, place, n: int) -> list:
    """``n`` trees shaped as ``tree`` (nested dicts of tensors, None
    kept): leaf ``x`` of tree ``i`` is ``place(x)[i]``."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        subs = {k: _per_shard(v, place, n) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return place(tree)


def shard_client_arrays(tree, mesh: Mesh, axis: str = CLIENT_AXIS) -> list:
    """Nested dicts of ``[C, ...]`` tensors split along the client axis:
    one tree per shard this process holds, in shard order, each holding
    that shard's clients."""
    line = mesh.line(axis)  # on a hybrid mesh, each clients shard's first model device
    sharding = client_sharding(line, axis)
    return _per_shard(tree, lambda x: device_put(x, sharding), len(line.local_shards(axis)))


def replicate(tree, mesh: Mesh, axis: str = CLIENT_AXIS) -> list:
    """Nested dicts of tensors copied to the device of every shard along
    ``axis`` that this process holds, in shard order (the round's
    broadcast; no copy where a shard's device is the tensor's own)."""
    devices = [d for _, d in mesh.local_shards(axis)]
    return _per_shard(tree, lambda x: [x.to(d, non_blocking=True) for d in devices],
                      len(devices))


def require_clients_mesh(mesh: Mesh, aggregator_spec, who: str) -> None:
    """The construction rule of the client-axis wrappers (FedPer,
    StatefulClients, ClusteredFedSim, FedBuff): a clients-only mesh, no
    hybrid model axis, and the mean combine rule (the sharded rounds
    aggregate with psum means; robust order statistics need the whole
    stack on one device)."""
    if MODEL_AXIS in mesh.axis_names:
        raise ValueError(
            f"{who} shards client state over the {CLIENT_AXIS!r} axis; "
            "the hybrid clients x model mesh is not supported here")
    if CLIENT_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names} but {who} needs a "
                         f"{CLIENT_AXIS!r} axis")
    if aggregator_spec[0] != "mean":
        raise ValueError(
            f"sharded {who} aggregates with a psum mean; robust rules "
            "need the full stack on one device — use a meshless FedSim")
