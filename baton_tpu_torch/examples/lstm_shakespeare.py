"""Char-LSTM federated language modelling, the FedAvg paper's Shakespeare
workload (the port of ``examples/07_lstm_shakespeare.py``).

Each client is one speaking role's text, the model a stacked character
LSTM, and rounds average the whole model. The roles are synthetic
per-client Markov "styles" (``data/synthetic.py::synthetic_char_clients``),
so the recipe runs offline; real Shakespeare shards replace the data
call. The recurrence is a Python loop over time (``models/lstm.py``):
the round is bound by the host's kernel launches.

  python -m baton_tpu_torch.examples.lstm_shakespeare [--scale tiny|full] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from baton_tpu_torch.data.synthetic import synthetic_char_clients
from baton_tpu_torch.models.lstm import LSTMConfig, lstm_lm_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel.engine import FedSim

LEARNING_RATE = 0.5

# --scale full: the FedAvg paper's shape, a 2 x 256 LSTM over a 90-char alphabet
FULL = dict(n_clients=64, n_per_client=256, n_rounds=50, n_epochs=1, batch_size=32,
            seq_len=80)


def client_data(cfg, n_clients, n_per_client, seq_len, batch_size, seed=0):
    """The example's stacked client data ``(data, n_samples)`` (numpy)."""
    rng = np.random.default_rng(seed)
    shards = synthetic_char_clients(rng, n_clients, n_per_client=n_per_client,
                                    seq_len=seq_len, vocab_size=cfg.vocab_size, order=1)
    return stack_client_datasets(shards, batch_size=batch_size)


def make_sim(cfg, batch_size=8, device="cuda") -> FedSim:
    """The example's FedSim: the char LSTM, local SGD at lr 0.5."""
    return FedSim(lstm_lm_model(cfg), batch_size=batch_size, learning_rate=LEARNING_RATE,
                  device=device)


def run(n_clients=8, n_per_client=16, n_rounds=4, n_epochs=2, batch_size=8,
        seq_len=24, config=None, seed=0, device="cuda"):
    """Train ``n_rounds`` rounds; returns ``(loss history, evaluation)``."""
    cfg = config or LSTMConfig.tiny(vocab_size=16)
    data, n_samples = client_data(cfg, n_clients, n_per_client, seq_len, batch_size, seed)
    sim = make_sim(cfg, batch_size, device)
    params = sim.init(torch.Generator(device=sim.device).manual_seed(seed))
    params, history = sim.run_rounds(params, data, n_samples,
                                     torch.Generator().manual_seed(seed + 1),
                                     n_rounds=n_rounds, n_epochs=n_epochs)
    metrics = sim.evaluate_round(params, data, n_samples)
    chance = float(np.log(cfg.vocab_size))
    print(f"char-LSTM FedAvg: loss {history[0]:.4f} -> {history[-1]:.4f} "
          f"(chance {chance:.4f}); eval loss {metrics['loss']:.4f}")
    return history, metrics


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--scale", choices=["tiny", "full"], default="tiny")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU instead of the CUDA card")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    if args.scale == "full":
        run(**FULL, config=LSTMConfig.shakespeare(), device=device)
    else:
        history, _ = run(device=device)
        assert history[-1] < history[0], "loss should fall"
