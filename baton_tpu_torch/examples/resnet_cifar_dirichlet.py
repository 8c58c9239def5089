"""BASELINE config 2: ResNet-18 / CIFAR-10, non-IID Dirichlet clients (the
port of ``examples/02_resnet_cifar_dirichlet.py``).

Simulated FedAvg clients with label-skew shards, trained in bf16 on one
card. Shows the scale levers: ``wave_size`` (the memory ceiling: clients
are processed in accumulating waves; ``"auto"`` sizes them from the
card), ``use_mesh=True`` (a clients mesh over every CUDA device when
there is more than one; one device runs meshless) and checkpoint/resume
for long runs.

CIFAR-10 is read through the offline loaders: ``data_dir`` files when
present, else the loader's deterministic synthetic surrogate (reported
as ``synthetic=True``); nothing is downloaded unless ``download=True``.

  python -m baton_tpu_torch.examples.resnet_cifar_dirichlet [--scale tiny|full] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from baton_tpu_torch.data.datasets import load_cifar10
from baton_tpu_torch.data.partition import dirichlet_partition, partition_stats
from baton_tpu_torch.models.resnet import resnet18_cifar_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel.engine import FedSim
from baton_tpu_torch.parallel.mesh import cuda_clients_mesh
from baton_tpu_torch.utils.checkpoint import Checkpointer


def make_data(rng, n_total, n_clients, alpha, image_size=32, n_classes=10, data_dir=None,
              download=False):
    """Real CIFAR-10 when available (``data_dir`` / ``download``), otherwise
    the loader's synthetic surrogate, cut to ``n_total`` images and split
    into Dirichlet(``alpha``) label-skew shards. ``n_classes`` is the
    reference's parameter (unused there too: CIFAR-10 has ten)."""
    train, _test, info = load_cifar10(data_dir=data_dir, download=download,
                                      fallback="synthetic", seed=int(rng.integers(1 << 31)))
    print(f"dataset: {info['name']} (synthetic={info['synthetic']}, "
          f"source={info['source']})")
    if n_total < len(train["y"]):
        sel = rng.permutation(len(train["y"]))[:n_total]
        train = {k: v[sel] for k, v in train.items()}
    if image_size != train["x"].shape[1]:  # tiny-scale smoke runs
        train = dict(train)
        train["x"] = train["x"][:, :image_size, :image_size, :]
    return dirichlet_partition(train, n_clients, rng, alpha=alpha)


def run(n_clients=16, n_total=1024, alpha=0.5, n_rounds=3, n_epochs=1,
        batch_size=32, wave_size=None, use_mesh=False,
        checkpoint_dir=None, seed=0, model_fn=None,
        compute_dtype=torch.bfloat16, image_size=32,
        data_dir=None, download=False, device="cuda"):
    """Train ``n_rounds`` FedAvg rounds; returns ``(loss history,
    federated evaluation)``. A ``checkpoint_dir`` that holds a run's
    steps resumes it."""
    rng = np.random.default_rng(seed)
    shards = make_data(rng, n_total, n_clients, alpha, image_size=image_size,
                       data_dir=data_dir, download=download)
    stats = partition_stats(shards)
    print(f"{n_clients} Dirichlet(alpha={alpha}) shards, "
          f"sizes {[s['n'] for s in stats[:8]]}…")
    data, n_samples = stack_client_datasets(shards, batch_size=batch_size)

    mesh = cuda_clients_mesh() if use_mesh else None
    model = (model_fn or resnet18_cifar_model)(compute_dtype=compute_dtype)
    sim = FedSim(model, batch_size=batch_size, learning_rate=0.05, mesh=mesh, device=device)
    params = sim.init(torch.Generator().manual_seed(seed))
    data = {k: torch.as_tensor(v, device=sim.device) for k, v in data.items()}
    n_samples = torch.as_tensor(n_samples, device=sim.device)

    checkpointer = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    params, history = sim.run_rounds(
        params, data, n_samples, torch.Generator().manual_seed(seed + 1),
        n_rounds=n_rounds, n_epochs=n_epochs, wave_size=wave_size,
        checkpointer=checkpointer)
    print(f"loss: {history[0]:.4f} -> {history[-1]:.4f} over {n_rounds} rounds")
    metrics = sim.evaluate_round(params, data, n_samples)
    print(f"federated eval: loss {metrics['loss']:.4f} "
          f"accuracy {metrics['accuracy']:.3f}")
    if checkpointer is not None:
        checkpointer.close()
    return history, metrics


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--scale", choices=["tiny", "full"], default="tiny")
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--data-dir", default=None,
                   help="directory holding cifar-10-batches-py/ or cifar10.npz")
    p.add_argument("--download", action="store_true",
                   help="fetch CIFAR-10 if missing (needs network)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU instead of the CUDA card")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    if args.scale == "full":
        run(n_clients=128, n_total=50_000, n_rounds=100, n_epochs=1,
            wave_size=32, use_mesh=args.mesh,
            checkpoint_dir=args.checkpoint_dir,
            data_dir=args.data_dir, download=args.download, device=device)
    else:
        history, _ = run(use_mesh=args.mesh,
                         checkpoint_dir=args.checkpoint_dir,
                         data_dir=args.data_dir, download=args.download, device=device)
        assert history[-1] < history[0], "loss should fall"
