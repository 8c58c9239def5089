"""Device meshes (counterpart of ``baton_tpu/parallel/mesh.py``; only
:class:`Mesh` and :func:`make_mesh` so far).

A mesh is a grid of ``torch.device``s with one name per axis, as a
``jax.sharding.Mesh`` is. The sequence-parallel attention of
:mod:`baton_tpu_torch.parallel.ring_attention` shards over one of its
axes inside one process: shard ``j`` of that axis lives on the ``j``-th
device along it.

A device may appear more than once. That is the port's counterpart of
XLA's virtual host devices (``--xla_force_host_platform_device_count``):
``make_mesh(8, ("seq",), devices=[torch.device("cpu")] * 8)`` is an 8-way
mesh on the CPU, and ``[torch.device("cuda", 0)] * 8`` runs an 8-way ring
on one card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

CLIENT_AXIS = "clients"


class Mesh:
    """``devices``: an array of ``torch.device``s with one dimension per
    name in ``axis_names``. ``mesh.shape[name]`` is the size of that axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of {arr.ndim} dimensions needs as many axis names, "
                             f"got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must differ, got {axis_names}")
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis_name: str) -> list:
        """The devices along ``axis_name``, at index 0 of every other axis:
        shard ``j`` of a tensor split over that axis lives on the ``j``-th."""
        if axis_name not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis_name!r}; its axes are {self.axis_names}")
        along = np.moveaxis(self.devices, self.axis_names.index(axis_name), 0)
        return list(along.reshape(along.shape[0], -1)[:, 0])


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
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return Mesh(arr.reshape((len(devs),) + (1,) * (len(axis_names) - 1)), axis_names)
