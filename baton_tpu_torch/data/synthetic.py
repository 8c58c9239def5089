"""Synthetic datasets (a copy of the numpy module
``baton_tpu/data/synthetic.py``; both draw from numpy's RNG, so the same
seed gives the same arrays bit for bit).

``linear_client_data`` mirrors the reference demo's per-client data draw:
``32·randint(5,20)`` samples of ``y = p·X`` for a fixed 10-dim coefficient
vector (reference: demo.py:52-59) — including the ragged per-client sizes
that exercise the padding/masking machinery.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# The reference demo's fixed coefficient vector (demo.py:55).
DEMO_COEF = np.array([11, 5, 3, 2, 5, 6, 2, 7, 8, 1], dtype=np.float32)


def linear_client_data(
    rng: np.random.Generator,
    coef: Optional[np.ndarray] = None,
    noise: float = 0.0,
    min_batches: int = 5,
    max_batches: int = 20,
    batch_size: int = 32,
):
    """One client's dataset: ``{"x","y"}`` with 32·U[5,20] rows."""
    coef = DEMO_COEF if coef is None else np.asarray(coef, np.float32)
    n = batch_size * int(rng.integers(min_batches, max_batches + 1))
    x = rng.standard_normal((n, coef.shape[0])).astype(np.float32)
    y = x @ coef
    if noise:
        y = y + noise * rng.standard_normal(n).astype(np.float32)
    return {"x": x, "y": y.astype(np.float32)}


def synthetic_classification_clients(
    rng: np.random.Generator,
    n_clients: int,
    n_per_client: int = 128,
    in_dim: int = 32,
    n_classes: int = 10,
    ragged: bool = True,
) -> Tuple[list, np.ndarray]:
    """Linearly-separable-ish classification shards for engine tests."""
    w = rng.standard_normal((in_dim, n_classes)).astype(np.float32)
    datasets = []
    for _ in range(n_clients):
        n = n_per_client
        if ragged:
            n = int(rng.integers(n_per_client // 2, n_per_client + 1))
        x = rng.standard_normal((n, in_dim)).astype(np.float32)
        logits = x @ w + 0.5 * rng.standard_normal((n, n_classes)).astype(np.float32)
        y = np.argmax(logits, axis=-1).astype(np.int32)
        datasets.append({"x": x, "y": y})
    return datasets, w


def synthetic_image_clients(
    rng: np.random.Generator,
    n_clients: int,
    n_per_client: int = 64,
    image_size: int = 28,
    channels: int = 1,
    n_classes: int = 10,
):
    """MNIST-shaped synthetic image shards (class-dependent mean patches)."""
    protos = rng.standard_normal((n_classes, image_size, image_size, channels)).astype(
        np.float32
    )
    datasets = []
    for _ in range(n_clients):
        y = rng.integers(0, n_classes, size=n_per_client).astype(np.int32)
        x = protos[y] + 0.5 * rng.standard_normal(
            (n_per_client, image_size, image_size, channels)
        ).astype(np.float32)
        datasets.append({"x": x, "y": y})
    return datasets


def synthetic_char_clients(
    rng: np.random.Generator,
    n_clients: int,
    n_per_client: int = 32,
    seq_len: int = 32,
    vocab_size: int = 90,
    order: int = 2,
):
    """Shakespeare-shaped non-IID char-LM shards (models/lstm.py).

    Each client is a distinct "speaking role": its text is drawn from a
    client-specific order-``order`` Markov chain over the character
    alphabet, so clients share structure (a common base chain) but
    differ in style (per-client perturbation) — the non-IID shape of
    the FedAvg paper's role-per-client Shakespeare split. Sequences are
    next-char pairs: ``y`` is ``x`` shifted by one.
    """
    base = rng.dirichlet(np.full(vocab_size, 0.3), size=vocab_size ** order)
    datasets = []
    for _ in range(n_clients):
        style = rng.dirichlet(np.full(vocab_size, 0.5), size=vocab_size ** order)
        probs = 0.7 * base + 0.3 * style
        # per-state CDF once, then one searchsorted per char: rng.choice
        # re-validates p on every call — tens of seconds at example 07's
        # full scale (64 clients x ~20k chars)
        cdf = np.cumsum(probs, axis=1)
        uniforms = rng.random(n_per_client * seq_len + 1)
        text_len = n_per_client * seq_len + 1
        text = np.empty(text_len, np.int64)
        text[:order] = rng.integers(0, vocab_size, order)
        state = 0
        for i in range(order):
            state = state * vocab_size + int(text[i])
        for i in range(order, text_len):
            c = int(np.searchsorted(cdf[state], uniforms[i], side="right"))
            text[i] = min(c, vocab_size - 1)
            state = (state * vocab_size + int(text[i])) % (vocab_size ** order)
        xs = text[: n_per_client * seq_len].reshape(n_per_client, seq_len)
        ys = text[1: n_per_client * seq_len + 1].reshape(n_per_client, seq_len)
        datasets.append({"x": xs.astype(np.int32), "y": ys.astype(np.int32)})
    return datasets
