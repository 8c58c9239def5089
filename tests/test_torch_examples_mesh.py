"""Examples 01, 02 and 10 with ``use_mesh=True`` on an 8-shard CPU mesh:
the example's own ``run`` with ``cuda_clients_mesh`` giving
``make_mesh(8, devices=[cpu] * 8)`` (on a machine with more than one card
it gives every CUDA device), each under its own assertion at its tiny
preset (example 02 at the test size of ``tests/test_torch_examples_rest.py``:
a ResNet-18 round is too slow for the CPU). The sim each builds is held
to carry that mesh."""

from functools import partial

import numpy as np
import pytest
import torch

from baton_tpu_torch.examples import cnn_mnist_fedavg, real_digits, resnet_cifar_dirichlet
from baton_tpu_torch.models.resnet import resnet_model
from baton_tpu_torch.parallel import engine
from baton_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


@pytest.fixture
def cpu_mesh(monkeypatch):
    """Every example's ``cuda_clients_mesh`` gives 8 CPU shards; returns
    the meshes of the FedSims built meanwhile."""
    mesh = make_mesh(8, devices=[torch.device("cpu")] * 8)
    for example in (cnn_mnist_fedavg, real_digits, resnet_cifar_dirichlet):
        monkeypatch.setattr(example, "cuda_clients_mesh", lambda: mesh)
    built = []
    init = engine.FedSim.__init__

    def recording(self, *args, **kw):
        init(self, *args, **kw)
        built.append(self.mesh)

    monkeypatch.setattr(engine.FedSim, "__init__", recording)
    return mesh, built


def test_example01_on_a_mesh(cpu_mesh):
    m = cnn_mnist_fedavg.run(use_mesh=True, device="cpu")
    assert m["accuracy"] > 0.5, "demo should learn the class prototypes"
    assert cpu_mesh[1] == [cpu_mesh[0]]


def test_example02_on_a_mesh(cpu_mesh, tmp_path):
    tiny = partial(resnet_model, blocks_per_stage=(1,), n_classes=10, n_groups=8,
                   name="resnet_tiny")
    history, metrics = resnet_cifar_dirichlet.run(
        n_clients=4, n_total=64, n_rounds=2, model_fn=tiny, compute_dtype=torch.float32,
        image_size=16, data_dir=str(tmp_path), use_mesh=True, device="cpu")
    assert history[-1] < history[0], "loss should fall"
    assert np.isfinite(metrics["loss"]) and 0.0 <= metrics["accuracy"] <= 1.0
    assert cpu_mesh[1] == [cpu_mesh[0]]


def test_example10_on_a_mesh(cpu_mesh):
    assert real_digits.run(n_clients=8, n_rounds=20, n_epochs=2, use_mesh=True,
                           device="cpu") > 0.85
    assert cpu_mesh[1] == [cpu_mesh[0]]
