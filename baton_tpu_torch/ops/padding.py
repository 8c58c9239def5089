"""Ragged-data padding — static shapes, exact counts for FedAvg.

A copy of the numpy module ``baton_tpu/ops/padding.py``: every client
dataset is zero-padded to a shared ``capacity`` divisible by the batch
size, and the true row count travels alongside as ``n_samples``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_to_capacity(array: np.ndarray, capacity: int) -> np.ndarray:
    """Zero-pad axis 0 of ``array`` to ``capacity`` rows."""
    n = array.shape[0]
    if n > capacity:
        raise ValueError(f"dataset has {n} rows > capacity {capacity}")
    if n == capacity:
        return array
    pad = np.zeros((capacity - n,) + array.shape[1:], dtype=array.dtype)
    return np.concatenate([array, pad], axis=0)


def pad_dataset(
    data: Dict[str, np.ndarray], capacity: int
) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad every array in ``data`` to ``capacity`` rows; returns
    ``(padded, n_samples)``."""
    n = next(iter(data.values())).shape[0]
    padded = {k: pad_to_capacity(np.asarray(v), capacity) for k, v in data.items()}
    return padded, n


def stack_client_datasets(
    datasets: Sequence[Dict[str, np.ndarray]],
    batch_size: int,
    capacity: int | None = None,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Pad + stack per-client datasets into ``[C, capacity, ...]`` arrays.

    Returns ``(stacked_data, n_samples[C])``. ``capacity`` defaults to the
    largest client dataset rounded up to a batch multiple.
    """
    if not datasets:
        raise ValueError("no client datasets")
    sizes = [next(iter(d.values())).shape[0] for d in datasets]
    if capacity is None:
        capacity = round_up(max(sizes), batch_size)
    else:
        capacity = round_up(capacity, batch_size)
    keys = list(datasets[0].keys())
    stacked = {
        k: np.stack([pad_to_capacity(np.asarray(d[k]), capacity) for d in datasets])
        for k in keys
    }
    return stacked, np.asarray(sizes, dtype=np.int32)
