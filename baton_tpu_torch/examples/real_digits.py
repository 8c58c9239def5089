"""Real bytes, zero egress: federated CNN on scikit-learn's bundled digits
(the port of ``examples/10_real_digits.py``).

Trains on the real UCI handwritten-digit images that ship inside
scikit-learn (``baton_tpu_torch.data.load_digits_real``): 1,797 8x8
grayscale digits, split into non-IID Dirichlet client shards, with
accuracy reported on a held-out real test split. It needs scikit-learn,
which the machine with the card may not have; the CPU runs it in under a
minute.

  python -m baton_tpu_torch.examples.real_digits [--clients 8] [--rounds 20]
      [--alpha 0.5] [--fedbuff] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from baton_tpu_torch.data import dirichlet_partition, load_digits_real
from baton_tpu_torch.models.cnn import cnn_mnist_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel.engine import FedSim
from baton_tpu_torch.parallel.mesh import cuda_clients_mesh


def run(n_clients=8, n_rounds=20, n_epochs=2, alpha=0.5, batch_size=32,
        use_mesh=False, fedbuff=False, seed=0, device="cuda"):
    """Train on Dirichlet shards of the real digits (synchronous FedAvg,
    or asynchronous FedBuff); returns the held-out accuracy."""
    train, test, info = load_digits_real(seed=seed)
    print(f"dataset: {info['dataset']} (real={info['real']}) "
          f"train={info['n_train']} test={info['n_test']}")

    rng = np.random.default_rng(seed)
    clients = dirichlet_partition(train, n_clients=n_clients, rng=rng,
                                  alpha=alpha, min_samples=batch_size // 4)
    sizes = [len(c["y"]) for c in clients]
    print(f"{n_clients} Dirichlet(alpha={alpha}) shards, "
          f"sizes {min(sizes)}..{max(sizes)}")
    data, n_samples = stack_client_datasets(clients, batch_size=batch_size)

    mesh = cuda_clients_mesh() if use_mesh else None
    if mesh is not None:
        print(f"clients mesh over {mesh.devices.size} devices")
    model = cnn_mnist_model(image_size=8, channels=1, width=16, name="cnn_digits")
    sim = FedSim(model, batch_size=batch_size, learning_rate=0.1, mesh=mesh, device=device)
    params = sim.init(torch.Generator().manual_seed(seed))
    data = {k: torch.as_tensor(v, device=sim.device) for k, v in data.items()}
    n_samples = torch.as_tensor(n_samples, device=sim.device)

    if fedbuff:
        from baton_tpu_torch.parallel.fedbuff import FedBuff

        buf = max(n_clients // 2, 1)
        fb = FedBuff(sim, buffer_size=buf, concurrency=2 * buf, alpha=0.5)
        res = fb.run(params, data, n_samples, torch.Generator().manual_seed(seed + 1),
                     n_steps=n_rounds, n_epochs=n_epochs)
        params = res.params
        print(f"async FedBuff: {n_rounds} server steps, "
              f"mean staleness {res.mean_staleness:.2f}, "
              f"final step loss {res.loss_history[-1]:.4f}")
    else:
        params, hist = sim.run_rounds(params, data, n_samples,
                                      torch.Generator().manual_seed(seed + 1),
                                      n_rounds=n_rounds, n_epochs=n_epochs)
        print(f"sync FedAvg: loss {hist[0]:.4f} -> {hist[-1]:.4f}")

    ts, tn = stack_client_datasets([test], batch_size=64)
    m = sim.evaluate_round(params, ts, tn)
    print(f"held-out REAL-data accuracy: {m['accuracy']:.4f} (n={int(m['n'])})")
    return m["accuracy"]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--fedbuff", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU instead of the CUDA card")
    args = p.parse_args()
    run(n_clients=args.clients, n_rounds=args.rounds, n_epochs=args.epochs,
        alpha=args.alpha, use_mesh=args.mesh, fedbuff=args.fedbuff,
        device="cpu" if args.cpu else "cuda")
