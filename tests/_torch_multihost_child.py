"""Child process of ``tests/test_torch_multihost.py`` (not a test module):
``python _torch_multihost_child.py <coordinator host:port> <n> <rank>``.

Each process holds 4 CPU shards and joins one gloo process group;
``make_hybrid_mesh([("model", 2)], dcn_axis="clients")`` lays out
``clients(4, across the processes) x model(2)``, and the port's FedAvg
psum (``ops/aggregation.py:psum_weighted_mean``) runs with the clients
axis crossing the process boundary. Then a FedSim round on a clients mesh
of 8 shards over both processes against the same round without a mesh.
Prints one JSON line; the process group is destroyed on every exit."""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from baton_tpu_torch import FedSim
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.ops.aggregation import psum_weighted_mean
from baton_tpu_torch.parallel.mesh import client_sharding, device_put
from baton_tpu_torch.parallel.multihost import initialize_multihost, make_hybrid_mesh

CPU4 = [torch.device("cpu")] * 4


def fedavg_psum(n_proc: int) -> dict:
    mesh = make_hybrid_mesh([("model", 2)], dcn_axis="clients", devices=CPU4)
    assert mesh.shape == {"clients": 2 * n_proc, "model": 2}, mesh.shape
    c, d = mesh.shape["clients"], 8
    rng = np.random.default_rng(0)
    theta = {"w": rng.normal(size=(c, d)).astype(np.float32),
             "b": rng.normal(size=(c,)).astype(np.float32)}
    weights = (np.arange(c) + 1).astype(np.float32)
    expected = {k: (weights.reshape((c,) + (1,) * (v.ndim - 1)) * v).sum(0) / weights.sum()
                for k, v in theta.items()}
    sharding = client_sharding(mesh)
    local = {k: device_put(torch.from_numpy(v), sharding) for k, v in theta.items()}
    stacks = [{k: local[k][i] for k in local} for i in range(len(local["w"]))]
    assert [j for j, _ in mesh.local_shards()] == [2 * dist.get_rank(), 2 * dist.get_rank() + 1]
    out = psum_weighted_mean(stacks, device_put(torch.from_numpy(weights), sharding), mesh)
    for k, want in expected.items():
        for shard in out:
            np.testing.assert_allclose(shard[k].numpy(), want, rtol=1e-5, atol=1e-6)
    return dict(mesh.shape)


def fedsim_round() -> float:
    """A round on 8 shards over both processes against the meshless round."""
    mesh = make_hybrid_mesh([], dcn_axis="clients", devices=CPU4)
    rng = np.random.default_rng(1)
    data = {"x": torch.from_numpy(rng.normal(size=(6, 4, 3)).astype(np.float32)),
            "y": torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32))}
    n = torch.tensor([4, 2, 0, 3, 4, 1])
    perms = torch.stack([torch.stack([torch.randperm(4, generator=torch.Generator()
                                                     .manual_seed(10 * c + e))
                                      for e in range(2)]) for c in range(6)])
    model = linear_regression_model(3)
    params = model.init(torch.Generator().manual_seed(0))
    kw = dict(batch_size=2, learning_rate=0.05)
    plain = FedSim(model, device="cpu", **kw).run_round(params, data, n, n_epochs=2,
                                                        perms=perms)
    meshed = FedSim(model, mesh=mesh, **kw).run_round(params, data, n, n_epochs=2, perms=perms)
    torch.testing.assert_close(meshed.client_losses, plain.client_losses, rtol=1e-6, atol=1e-6)
    gap = max((meshed.params[k] - plain.params[k]).abs().max().item() for k in params)
    assert gap <= 1e-5, gap
    return gap


def main() -> None:
    coord, n_proc, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    try:
        assert initialize_multihost(coord, n_proc, rank, backend="gloo", timeout_s=60) == rank
        assert dist.get_world_size() == n_proc and dist.get_backend() == "gloo"
        shape = fedavg_psum(n_proc)
        gap = fedsim_round()
        print(json.dumps({"rank": rank, "world": dist.get_world_size(), "mesh": shape,
                          "round_gap": gap, "ok": True}), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
