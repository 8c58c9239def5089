"""BASELINE config 1: 2-layer CNN / MNIST, 4-worker FedAvg (the port of
``examples/01_cnn_mnist_fedavg.py``).

The four "workers" are indices on the vmapped client axis, the round
broadcast is the shared global params, and FedAvg is the engine's
sample-weighted mean; local training is SGD at lr 0.01 with momentum 0.9,
batch 32. ``real_data=True`` loads MNIST with ``fallback="synthetic"``:
without ``data_dir`` files (and nothing is ever downloaded unless
``download=True``) it trains on the loader's class-conditional surrogate,
labelled ``synthetic`` in what it prints. Prints per-round train loss and
a final federated evaluation.

  python -m baton_tpu_torch.examples.cnn_mnist_fedavg [--cpu] [--data-dir D]

Rounds run through ``FedSim.run_rounds``: round ``r`` shuffles with
``round_generator(seed + 1, r)``, as the reference folds ``r`` into its
key, so ``checkpoint_dir=`` resumes a stopped run where it stopped.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from baton_tpu_torch.core import optim
from baton_tpu_torch.data.datasets import load_mnist
from baton_tpu_torch.data.partition import iid_partition
from baton_tpu_torch.data.synthetic import synthetic_image_clients
from baton_tpu_torch.models.cnn import cnn_mnist_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel.engine import FedSim
from baton_tpu_torch.utils.checkpoint import Checkpointer


def client_data(n_clients=4, batch_size=32, n_per_client=64, seed=0,
                data_dir=None, download=False, real_data=False):
    """The example's stacked client data ``(data, n_samples)`` (numpy), as
    ``examples/01_cnn_mnist_fedavg.py:run`` builds it."""
    rng = np.random.default_rng(seed)
    if real_data:
        train, _test, info = load_mnist(
            data_dir=data_dir, download=download, fallback="synthetic",
            seed=seed,
        )
        print(f"dataset: mnist (synthetic={info['synthetic']})")
        n_keep = min(n_clients * n_per_client, len(train["y"]))
        sel = rng.permutation(len(train["y"]))[:n_keep]
        datasets = iid_partition({k: v[sel] for k, v in train.items()},
                                 n_clients, rng)
    else:
        datasets = synthetic_image_clients(rng, n_clients,
                                           n_per_client=n_per_client)
    return stack_client_datasets(datasets, batch_size=batch_size)


def make_sim(batch_size=32, device="cuda") -> FedSim:
    """The example's FedSim: the 2-layer CNN, local SGD(0.01, momentum 0.9)."""
    return FedSim(cnn_mnist_model(), batch_size=batch_size,
                  optimizer=optim.sgd(0.01, momentum=0.9), device=device)


def run(n_clients=4, n_rounds=4, n_epochs=2, batch_size=32,
        n_per_client=64, use_mesh=False, seed=0,
        data_dir=None, download=False, real_data=False,
        device="cuda", checkpoint_dir: Optional[str] = None):
    """Train ``n_rounds`` rounds; returns the final federated evaluation
    (``loss``, ``accuracy``, ``n``) with the final ``params``, the
    ``loss_history`` (one entry per epoch), and the host seconds spent
    making the client data (``data_s``) and in the rounds (``train_s``,
    which ends on the last round's losses read back from the device)."""
    if use_mesh:
        raise NotImplementedError(
            "a device mesh is not ported yet (ROADMAP item 11)")
    t0 = time.perf_counter()
    data, n_samples = client_data(n_clients, batch_size, n_per_client, seed,
                                  data_dir, download, real_data)
    data_s = time.perf_counter() - t0
    sim = make_sim(batch_size, device)
    params = sim.init(torch.Generator().manual_seed(seed))
    checkpointer = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    t0 = time.perf_counter()
    params, history = sim.run_rounds(
        params, data, n_samples, torch.Generator().manual_seed(seed + 1),
        n_rounds=n_rounds, n_epochs=n_epochs, checkpointer=checkpointer)
    train_s = time.perf_counter() - t0
    for r in range(len(history) // n_epochs):
        print(f"round {r}: loss/epoch "
              f"{[round(float(x), 4) for x in history[r * n_epochs:(r + 1) * n_epochs]]}")

    metrics = sim.evaluate_round(params, data, n_samples)
    print(f"federated eval: loss {metrics['loss']:.4f} "
          f"accuracy {metrics['accuracy']:.3f} over {int(metrics['n'])} samples")
    return dict(metrics, params=params, loss_history=history, data_s=data_s,
                train_s=train_s)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--scale", choices=["tiny", "full"], default="tiny")
    p.add_argument("--data-dir", default=None,
                   help="directory holding MNIST idx/npz files")
    p.add_argument("--download", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU instead of the CUDA card")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    if args.scale == "full":
        m = run(n_clients=4, n_rounds=20, n_epochs=4, n_per_client=15000,
                real_data=True, data_dir=args.data_dir,
                download=args.download, device=device)
    else:
        m = run(real_data=bool(args.data_dir), data_dir=args.data_dir,
                download=args.download, device=device)
    assert m["accuracy"] > 0.5, "demo should learn the class prototypes"
