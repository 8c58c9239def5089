"""The port's examples 02, 09 and 10 (``baton_tpu_torch/examples/
resnet_cifar_dirichlet.py``, ``bandwidth_efficient_http.py``,
``real_digits.py``) on the CPU under the gates of
``tests/test_examples.py``: example 02 at its test size (a 1-stage
ResNet on 16 px of the CIFAR loader's synthetic fallback, nothing
downloaded) resumes from its checkpoints to the same history; example
09's federation learns past 0.8 with uploads under half the dense size;
example 10 reaches 0.85 held-out accuracy on scikit-learn's real digits
(synchronous, and FedBuff). ``use_mesh=True`` asks for a clients mesh
over the CUDA devices and, with at most one, runs meshless
(``tests/test_torch_examples_mesh.py`` runs them on a mesh), and each
example needs a GPU unless asked for the CPU."""

from functools import partial

import numpy as np
import pytest
import torch

from baton_tpu_torch.examples import bandwidth_efficient_http, real_digits
from baton_tpu_torch.examples import resnet_cifar_dirichlet
from baton_tpu_torch.models.resnet import resnet_model
from _torch_sockets import reserve_port, run_bounded, tcp_site

torch.set_num_threads(1)


def test_resnet_cifar_dirichlet_resumes(tmp_path):
    tiny = partial(resnet_model, blocks_per_stage=(1,), n_classes=10, n_groups=8,
                   name="resnet_tiny")
    kw = dict(n_clients=4, n_total=64, n_rounds=2, model_fn=tiny, compute_dtype=torch.float32,
              image_size=16, checkpoint_dir=str(tmp_path / "ck"), data_dir=str(tmp_path),
              device="cpu")
    history, metrics = resnet_cifar_dirichlet.run(**kw)
    assert np.isfinite(history[-1]) and 0.0 <= metrics["accuracy"] <= 1.0
    # resume: the same arguments restore from the checkpoint and skip done rounds
    history2, _ = resnet_cifar_dirichlet.run(**kw)
    np.testing.assert_allclose(history2, history, rtol=1e-6)


def test_bandwidth_efficient_http(monkeypatch):
    # the workers' and the manager's ports held open from the start (no
    # race with parallel test processes for a freed port)
    monkeypatch.setattr(bandwidth_efficient_http, "free_port", reserve_port)
    monkeypatch.setattr(bandwidth_efficient_http.web, "TCPSite", tcp_site)
    out = run_bounded(lambda: bandwidth_efficient_http.federation(
        n_workers=3, n_rounds=8, device="cpu"), limit_s=120.0)
    assert out["accuracy"] > 0.8
    # sparse q16 uploads are a small fraction of the full state dict
    assert out["mean_upload_bytes"] < out["full_upload_bytes"] / 2


@pytest.mark.parametrize("fedbuff", [False, True], ids=["fedavg", "fedbuff"])
def test_real_digits(fedbuff):
    """8 non-IID Dirichlet shards of the real digits to > 0.85 held-out
    accuracy (chance is 0.1)."""
    assert real_digits.run(n_clients=8, n_rounds=20, n_epochs=2, fedbuff=fedbuff,
                           device="cpu") > 0.85


@pytest.mark.parametrize("example", [resnet_cifar_dirichlet, real_digits],
                         ids=["02", "10"])
def test_a_mesh_is_refused_naming_its_roadmap_item(example, tmp_path):
    """No longer refused: ``use_mesh=True`` builds a clients mesh over the
    CUDA devices when there is more than one; here there is none, so the
    run is meshless, as the reference's on one device."""
    assert example.cuda_clients_mesh() is None
    if example is resnet_cifar_dirichlet:
        tiny = partial(resnet_model, blocks_per_stage=(1,), n_classes=10, n_groups=8)
        history, _ = example.run(n_clients=2, n_total=16, n_rounds=1, model_fn=tiny,
                                 compute_dtype=torch.float32, image_size=8,
                                 data_dir=str(tmp_path), use_mesh=True, device="cpu")
        assert np.isfinite(history).all()
    else:
        assert example.run(n_clients=2, n_rounds=1, n_epochs=1, use_mesh=True,
                           device="cpu") > 0.0


def test_the_examples_need_a_gpu_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet_cifar_dirichlet.run(n_clients=2, n_total=8, data_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        real_digits.run(n_clients=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bandwidth_efficient_http.run(n_workers=1)
