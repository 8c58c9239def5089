"""Meshes across processes (counterpart of ``baton_tpu/parallel/multihost.py``).

The JAX package joins hosts with ``jax.distributed`` and lays out a
hybrid mesh whose slowest axis crosses hosts (DCN) while the others stay
inside one (ICI). The port joins processes with
``torch.distributed.init_process_group`` over a TCP coordinator, and
:func:`make_hybrid_mesh` builds a :class:`~baton_tpu_torch.parallel.mesh.
Mesh` whose ``dcn_axis`` spans the processes and whose other axes span
each process's local devices. The ``clients`` axis communicates once a
round (the FedAvg psum of one model-sized tree), so it is the one that
crosses processes in a federation; its transport is one ``all_reduce``
(``ops/aggregation.py:_all_reduce``). A ``seq`` axis crosses them the same
way, ``make_hybrid_mesh([], dcn_axis="seq", devices=...)``: each process
holds a contiguous run of the sequence's shards and the ring's blocks, the
seams' gathers and Ulysses' re-shard cross the boundary by
``torch.distributed`` point-to-point and collective calls
(``parallel/ring_attention.py``).

The backend follows the tensors: a process's shards live on its
``devices`` (by default one GPU a process, ``cuda:(rank % local GPUs)``
with ranks laid out node by node; without a GPU the caller must pass
``devices=["cpu"]``: nothing falls back to the CPU), and the backend is nccl
for CUDA devices, with the process's current device set to its first,
and gloo for the CPU. ``backend=`` overrides it: two processes that
share one GPU need gloo (NCCL refuses two ranks on one device; gloo's
``all_reduce`` takes CUDA tensors and copies them through the host).

Differences from the JAX functions, by design: ``initialize_multihost``
takes ``backend=``, ``devices=`` and ``timeout_s=`` (JAX's reads its
transport from the platform), and ``make_hybrid_mesh`` takes
``devices=``, the process's local devices (JAX's reads
``jax.local_devices()``; the port's default is the current CUDA device in
a multi-process group, every CUDA device in one process, and
``[torch.device("cpu")] * n`` gives n CPU shards). A single process needs
no process group: ``initialize_multihost`` is then a no-op returning 0.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from baton_tpu_torch.parallel.mesh import Mesh, _object_array


def process_devices(process_id: int, devices: Optional[Sequence] = None) -> list:
    """The devices a process's shards live on: ``devices``, else one GPU a
    process (``cuda:(process_id % device_count)``). Without a GPU and
    without ``devices`` it raises: a process runs on the CPU only when
    asked, with ``devices=["cpu"]``."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass devices=["cpu"] to run this '
                           "process's shards on the CPU")
    return [torch.device("cuda", process_id % torch.cuda.device_count())]


def default_backend(devices: Sequence[torch.device]) -> str:
    """nccl where every device is a GPU, else gloo."""
    return "nccl" if all(torch.device(d).type == "cuda" for d in devices) else "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    devices: Optional[Sequence] = None,
    timeout_s: float = 120.0,
) -> int:
    """Join the process group of ``num_processes`` processes over the TCP
    coordinator ``host:port`` and return this process's rank; a no-op
    returning 0 for one process. ``devices`` are the devices this
    process's shards will live on (:func:`process_devices`: without a GPU
    they must be given); ``backend``
    defaults from them (:func:`default_backend`), and where they are GPUs
    the current CUDA device becomes the first. A bad address or a
    coordinator that does not answer within ``timeout_s`` raises; nothing
    falls back to a single-process run. Joining again with the same rank
    is a no-op."""
    import torch.distributed as dist

    if num_processes is not None and num_processes <= 1:
        return 0
    if dist.is_initialized():
        if process_id is not None and dist.get_rank() != process_id:
            raise RuntimeError(f"already initialized as rank {dist.get_rank()}, not {process_id}")
        return dist.get_rank()
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address ('host:port'), "
                         "num_processes and process_id")
    host, sep, port = coordinator_address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address {coordinator_address!r} is not 'host:port'")
    devices = process_devices(int(process_id), devices)
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend or default_backend(devices),
                            init_method=f"tcp://{host}:{port}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


def make_hybrid_mesh(
    ici_axes: Sequence[Tuple[str, int]],
    dcn_axis: str = "clients",
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A mesh with ``dcn_axis`` spanning the processes and ``ici_axes``
    (name, size) spanning each process's local ``devices``; the sizes
    multiply to a divisor of the local device count, and the DCN axis
    takes the processes times the local devices left over. Each process's
    devices are contiguous along the ICI axes, so only ``dcn_axis`` crosses
    processes. In one process it is an ordinary mesh with the same axis
    names. ``devices`` defaults to the current CUDA device in a
    multi-process group (the one GPU ``initialize_multihost`` gave the
    process) and to every CUDA device in one process."""
    import torch.distributed as dist

    multi = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=[torch.device('cpu')]"
                               " * n for a mesh on the CPU")
        devices = ([torch.device("cuda", torch.cuda.current_device())] if multi else
                   [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    local = [torch.device(d) for d in devices]
    n_proc = dist.get_world_size() if multi else 1
    rank = dist.get_rank() if multi else 0
    ici_names = [n for n, _ in ici_axes]
    ici_sizes = [s for _, s in ici_axes]
    ici_total = int(np.prod(ici_sizes)) if ici_sizes else 1
    if len(local) % ici_total:
        raise ValueError(f"ICI axes {ici_axes} need {ici_total} devices a process but this "
                         f"process has {len(local)}")
    per_proc = len(local) // ici_total
    shape = (n_proc * per_proc,) + tuple(ici_sizes)
    # every process lays out the same global grid; a process's own devices
    # fill its block of the DCN axis (the others' are placeholders of the
    # same kind that it never addresses)
    grid = _object_array(local * n_proc, shape)
    owners = np.repeat(np.arange(n_proc), len(local)).reshape(shape)
    return Mesh(grid, (dcn_axis, *ici_names), process_ids=owners, process_index=rank)
