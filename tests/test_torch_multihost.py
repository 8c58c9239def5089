"""Two processes over gloo on the CPU (the port's counterpart of
``tests/test_multihost.py``): each child (``tests/_torch_multihost_child.py``)
holds 4 CPU shards, joins one process group through
``initialize_multihost``, builds ``make_hybrid_mesh([("model", 2)],
dcn_axis="clients")`` and runs the FedAvg psum with the clients axis
crossing the process boundary, against numpy at rtol 1e-5; then a FedSim
round on 8 shards over both processes against the meshless round (1e-5).
Every child runs under a hard timeout and is killed in ``finally``; the
children destroy their process group on exit. Also: one process needs no
process group, a bad coordinator address raises, and the defaults give
each process its own GPU and take the backend from its devices (nccl for
GPUs, gloo for the CPU; CUDA stubbed, no group joined)."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from baton_tpu_torch.parallel.multihost import (
    default_backend,
    initialize_multihost,
    make_hybrid_mesh,
    process_devices,
)

CHILD_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_fedavg_over_gloo():
    n_proc = 2
    coord = f"127.0.0.1:{free_port()}"
    child = os.path.join(os.path.dirname(__file__), "_torch_multihost_child.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(child)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, child, coord, str(n_proc), str(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for rank in range(n_proc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            assert p.returncode == 0, f"child failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert o["ok"] and o["world"] == 2
        assert o["mesh"] == {"clients": 4, "model": 2}
        assert o["round_gap"] <= 1e-5


def test_one_process_needs_no_process_group():
    assert initialize_multihost("127.0.0.1:1", num_processes=1, process_id=0) == 0
    assert not torch.distributed.is_initialized()
    mesh = make_hybrid_mesh([("model", 4)], dcn_axis="clients", devices=["cpu"] * 8)
    assert mesh.shape == {"clients": 2, "model": 4} and not mesh.spans_processes
    assert make_hybrid_mesh([("seq", 8)], dcn_axis="clients",
                            devices=["cpu"] * 8).shape == {"clients": 1, "seq": 8}
    with pytest.raises(ValueError, match="devices a process"):
        make_hybrid_mesh([("model", 3)], devices=["cpu"] * 8)


@pytest.mark.parametrize("address", ["127.0.0.1", "no-port:", ":8080"])
def test_a_bad_coordinator_address_raises(address):
    with pytest.raises(ValueError, match="host:port"):
        initialize_multihost(address, num_processes=2, process_id=0, backend="gloo")
    assert not torch.distributed.is_initialized()


def _stub_cuda(monkeypatch, n_gpus):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n_gpus > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_gpus)


@pytest.mark.parametrize("n_gpus,rank,devices,want,backend", [
    (0, 1, None, ["cpu"], "gloo"),
    (2, 3, None, ["cuda:1"], "nccl"),
    (8, 3, None, ["cuda:3"], "nccl"),
    (1, 1, ["cuda:0", "cuda:0"], ["cuda:0", "cuda:0"], "nccl"),
    (2, 0, ["cpu"] * 4, ["cpu"] * 4, "gloo"),
])
def test_default_devices_and_backend(monkeypatch, n_gpus, rank, devices, want, backend):
    _stub_cuda(monkeypatch, n_gpus)
    got = process_devices(rank, devices)
    assert got == [torch.device(d) for d in want]
    assert default_backend(got) == backend


@pytest.mark.parametrize("backend,devices,want_backend,want_device", [
    (None, None, "nccl", "cuda:1"),
    ("gloo", None, "gloo", "cuda:1"),
    (None, ["cpu"] * 2, "gloo", None),
])
def test_initialize_multihost_defaults(monkeypatch, backend, devices, want_backend, want_device):
    """Rank 3 of 4 on a node of 2 GPUs: its own GPU made current and nccl,
    unless the caller asks for gloo or gives CPU devices."""
    import torch.distributed as dist

    _stub_cuda(monkeypatch, 2)
    seen = {}
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.update(device=torch.device(d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda b, **kw: seen.update(backend=b, rank=kw["rank"]))
    monkeypatch.setattr(dist, "get_rank", lambda: seen["rank"])
    assert initialize_multihost("127.0.0.1:29500", 4, 3, backend=backend, devices=devices) == 3
    assert seen["backend"] == want_backend
    assert seen.get("device") == (None if want_device is None else torch.device(want_device))


def test_hybrid_mesh_defaults_to_the_process_gpu(monkeypatch):
    """In a group of 2 processes the default devices are the current GPU
    alone, so rank 1 holds shard 1 on its own device."""
    import torch.distributed as dist

    _stub_cuda(monkeypatch, 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    mesh = make_hybrid_mesh([], dcn_axis="clients")
    assert mesh.shape == {"clients": 2} and mesh.spans_processes
    assert mesh.local_shards("clients") == [(1, torch.device("cuda", 1))]
