"""Dataset partitioners: IID, Dirichlet label skew and label shards (a
copy of the numpy module ``baton_tpu/data/partition.py``; both draw from
numpy's RNG, so the same seed gives the same shards bit for bit).

The Dirichlet scheme is the standard label-skew protocol: for each client
draw p ~ Dir(alpha·1_K) over classes and sample its shard accordingly;
alpha→∞ is IID, alpha→0 is one-class clients.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def iid_partition(
    data: Dict[str, np.ndarray], n_clients: int, rng: np.random.Generator
) -> List[Dict[str, np.ndarray]]:
    n = next(iter(data.values())).shape[0]
    perm = rng.permutation(n)
    shards = np.array_split(perm, n_clients)
    return [{k: v[idx] for k, v in data.items()} for idx in shards]


def dirichlet_partition(
    data: Dict[str, np.ndarray],
    n_clients: int,
    rng: np.random.Generator,
    alpha: float = 0.5,
    label_key: str = "y",
    min_samples: int = 1,
) -> List[Dict[str, np.ndarray]]:
    """Label-skew Dirichlet partition of a labelled dataset."""
    y = np.asarray(data[label_key])
    classes = np.unique(y)
    idx_by_class = {c: rng.permutation(np.flatnonzero(y == c)) for c in classes}
    client_indices: List[List[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = idx_by_class[c]
        props = rng.dirichlet(np.full(n_clients, alpha))
        # convert proportions to contiguous split points over this class
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for client_i, chunk in enumerate(np.split(idx, cuts)):
            client_indices[client_i].extend(chunk.tolist())
    # Rebalance BEFORE materializing any shard so stolen rows move (not
    # duplicate) between clients.
    for ci in client_indices:
        if len(ci) < min_samples:
            largest = max(range(n_clients), key=lambda i: len(client_indices[i]))
            need = min_samples - len(ci)
            ci.extend(client_indices[largest][-need:])
            del client_indices[largest][-need:]
    shards = []
    for ci in client_indices:
        arr = np.asarray(ci, dtype=np.int64)
        rng.shuffle(arr)
        shards.append({k: v[arr] for k, v in data.items()})
    return shards


def partition_stats(shards: List[Dict[str, np.ndarray]], label_key: str = "y"):
    """Per-shard (size, label histogram) — observability for non-IID runs."""
    stats = []
    for s in shards:
        y = np.asarray(s[label_key])
        vals, counts = np.unique(y, return_counts=True)
        stats.append({"n": int(y.shape[0]), "labels": dict(zip(vals.tolist(), counts.tolist()))})
    return stats


def label_shard_partition(
    data: Dict[str, np.ndarray],
    n_clients: int,
    rng: np.random.Generator,
    classes_per_client: int = 2,
    label_key: str = "y",
) -> List[Dict[str, np.ndarray]]:
    """The FedAvg paper's "pathological non-IID" split: sort by label,
    cut into ``n_clients * classes_per_client`` equal shards, deal each
    client ``classes_per_client`` shards — so most clients see only a
    couple of classes. Harsher than a Dirichlet skew; the classic
    stress test for aggregation/personalization methods."""
    if classes_per_client < 1:
        raise ValueError("classes_per_client must be >= 1")
    y = np.asarray(data[label_key])
    n = len(y)
    n_shards = n_clients * classes_per_client
    if n_shards > n:
        raise ValueError(
            f"{n_shards} shards requested from {n} samples"
        )
    # sort by label with a random tie-break so repeated calls differ
    order = np.lexsort((rng.random(n), y))
    shard_bounds = np.linspace(0, n, n_shards + 1).astype(int)
    shard_ids = rng.permutation(n_shards)
    out: List[Dict[str, np.ndarray]] = []
    for c in range(n_clients):
        mine = shard_ids[c * classes_per_client:(c + 1) * classes_per_client]
        idx = np.concatenate(
            [order[shard_bounds[s]:shard_bounds[s + 1]] for s in mine]
        )
        out.append({k: np.asarray(v)[idx] for k, v in data.items()})
    return out
