"""BASELINE config 3: BERT federated text-classification fine-tune with
FedProx (the port of ``examples/03_bert_fedprox.py``).

Non-IID text clients drift apart during multi-epoch local training;
FedProx adds a proximal term ``mu/2 · ||w − w_global||²`` to each client's
local objective (``core/regularizers.py``), keeping local updates anchored
to the broadcast round model. AG-News stands in as 4-class sequences of
token ids: ``make_data`` draws the reference's synthetic topics, and
``real_data=True`` reads the AG-News CSVs from ``data_dir`` through the
offline loader (``load_ag_news``), whose synthetic fallback takes their
place when the files are absent. Nothing is downloaded.

  python -m baton_tpu_torch.examples.bert_fedprox [--scale tiny|full] [--cpu]
      [--mu MU] [--data-dir D] [--remat]

Rounds run through ``FedSim.run_rounds``: round ``r`` shuffles with
``round_generator(seed + 1, r)``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from baton_tpu_torch.core.regularizers import fedprox
from baton_tpu_torch.data.datasets import load_ag_news
from baton_tpu_torch.data.partition import dirichlet_partition
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel.engine import FedSim

LEARNING_RATE = 5e-3


def make_ag_news_data(rng, cfg, n_clients, n_per_client, alpha=0.3, data_dir=None):
    """Real AG-News (byte-tokenized) when the CSVs are in ``data_dir``,
    else the loader's labelled synthetic surrogate; Dirichlet label-skew
    shards either way. Requires ``cfg.vocab_size >= 257`` (byte vocab)."""
    train, _test, info = load_ag_news(data_dir=data_dir, max_len=cfg.max_len,
                                      fallback="synthetic", seed=int(rng.integers(1 << 31)))
    print(f"dataset: ag_news (synthetic={info['synthetic']})")
    n_keep = min(n_clients * n_per_client, len(train["y"]))
    sel = rng.permutation(len(train["y"]))[:n_keep]
    return dirichlet_partition({k: v[sel] for k, v in train.items()}, n_clients, rng,
                               alpha=alpha)


def make_data(rng, cfg, n_clients, n_per_client):
    """Class-correlated token sequences: each class has a 'topic'
    distribution over the vocabulary; each client is skewed toward two
    classes (label heterogeneity, the FedProx setting)."""
    topics = rng.dirichlet(np.full(cfg.vocab_size, 0.1), size=cfg.n_classes)
    datasets = []
    for _ in range(n_clients):
        fav = rng.choice(cfg.n_classes, size=2, replace=False)
        y = rng.choice(fav, size=n_per_client).astype(np.int32)
        x = np.stack([rng.choice(cfg.vocab_size, size=cfg.max_len, p=topics[label])
                      for label in y]).astype(np.int32)
        datasets.append({"x": x, "y": y})
    return datasets


def example_config(config=None, real_data=False) -> BertConfig:
    """The example's model config: ``BertConfig.tiny(n_classes=4)`` unless
    given, widened to the byte vocabulary (257) for real data, since a
    smaller embedding table would clamp half the token ids."""
    cfg = config or BertConfig.tiny(n_classes=4)
    if real_data and cfg.vocab_size < 257:
        cfg = dataclasses.replace(cfg, vocab_size=257)
    return cfg


def client_data(cfg, n_clients, n_per_client, batch_size, seed=0, real_data=False,
                data_dir=None):
    """The example's stacked client data ``(data, n_samples)`` (numpy), as
    ``examples/03_bert_fedprox.py:run`` draws it."""
    rng = np.random.default_rng(seed)
    shards = (make_ag_news_data(rng, cfg, n_clients, n_per_client, data_dir=data_dir)
              if real_data else make_data(rng, cfg, n_clients, n_per_client))
    return stack_client_datasets(shards, batch_size=batch_size)


def make_sim(cfg, batch_size=8, mu=0.1, remat=False, device="cuda") -> FedSim:
    """The example's FedSim: BERT with a classification head, local SGD at
    lr 5e-3, FedProx(``mu``) (none for ``mu`` 0). ``remat`` recomputes the
    encoder blocks' activations in the backward pass."""
    model = bert_classifier_model(cfg, remat=remat)
    return FedSim(model, batch_size=batch_size, learning_rate=LEARNING_RATE,
                  regularizer=fedprox(mu=mu) if mu else None, device=device)


def run(n_clients=8, n_per_client=24, n_rounds=3, n_epochs=2, batch_size=8, mu=0.1,
        config=None, seed=0, real_data=False, data_dir=None, remat=False, device="cuda"):
    """Train ``n_rounds`` rounds; returns ``(loss history, federated
    evaluation)``."""
    cfg = example_config(config, real_data)
    sim = make_sim(cfg, batch_size, mu, remat, device)
    data, n_samples = client_data(cfg, n_clients, n_per_client, batch_size, seed, real_data,
                                  data_dir)
    params = sim.init(torch.Generator().manual_seed(seed))
    params, history = sim.run_rounds(params, data, n_samples,
                                     torch.Generator().manual_seed(seed + 1),
                                     n_rounds=n_rounds, n_epochs=n_epochs)
    metrics = sim.evaluate_round(params, data, n_samples)
    print(f"FedProx(mu={mu}): loss {history[0]:.4f} -> {history[-1]:.4f}, "
          f"eval accuracy {metrics['accuracy']:.3f}")
    return history, metrics


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--scale", choices=["tiny", "full"], default="tiny")
    p.add_argument("--mu", type=float, default=0.1)
    p.add_argument("--data-dir", default=None,
                   help="directory holding AG-News train.csv/test.csv")
    p.add_argument("--remat", action="store_true",
                   help="recompute encoder activations in backward (fits bigger "
                        "cohorts/sequences on the card)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU instead of the CUDA card")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    if args.scale == "full":
        # AG-News: 120k samples over 64 clients; byte-level vocab (257)
        # needs vocab_size >= 257 on the model
        run(n_clients=64, n_per_client=1875, n_rounds=30, n_epochs=2, batch_size=32,
            mu=args.mu, real_data=True, data_dir=args.data_dir, remat=args.remat,
            config=BertConfig.base(n_classes=4, vocab_size=512), device=device)
    else:
        history, _ = run(mu=args.mu, real_data=bool(args.data_dir), data_dir=args.data_dir,
                         remat=args.remat, device=device)
        assert history[-1] < history[0], "loss should fall"
