"""Secure aggregation — pairwise-masked sums in a finite field (the port
of ``baton_tpu/ops/secure_agg.py``).

The offline primitive behind the HTTP protocol (``server/secure.py``
imports :data:`DEFAULT_SCALE_BITS` from here):

* Updates are **fixed-point quantized** into the ring Z_2^32
  (:func:`quantize` / :func:`dequantize`) — masking must be exact, and
  float addition is not associative; uint32 modular arithmetic is.
* For every client pair ``i < j`` a mask tree is drawn from numpy's
  Philox generator keyed on ``(seed, i, j)`` (it stands in for the
  Diffie-Hellman agreed seed of the real protocol, as ``server/secure.py``
  draws its uint64 masks); client ``i`` adds it, client ``j`` subtracts
  it, so the masks cancel **exactly** in the modular sum and any single
  masked update is uniform noise to the server.
* **Dropout recovery**: :func:`net_mask_of` recomputes any client's net
  mask so the server can subtract the residue of a client that dropped
  after masking.

Trees are flat ``{name: array}`` dicts (what the port's params are) and
the seed is an int, where the reference takes a JAX key: the masks differ
from the reference's bit for bit, the algebra does not. The arithmetic
stays in numpy ``uint32`` on the host, as in the reference: it runs at
the HTTP edge, and torch's unsigned-integer ops are too thin for modular
sums.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

Tree = Dict[str, np.ndarray]

DEFAULT_SCALE_BITS = 16  # fixed-point fractional bits
_RING = 1 << 32


def quantize(tree: Tree, scale_bits: int = DEFAULT_SCALE_BITS) -> Tree:
    """Float tree -> uint32 fixed-point (two's complement in Z_2^32).

    Exact for magnitudes < 2^(31 - scale_bits - log2 C) summed over C
    clients; callers clip updates before quantizing.
    """
    scale = float(1 << scale_bits)

    def one(leaf):
        q = np.round(np.asarray(leaf, np.float64) * scale).astype(np.int64)
        return (q % _RING).astype(np.uint32)

    return {k: one(v) for k, v in tree.items()}


def dequantize(tree: Tree, scale_bits: int = DEFAULT_SCALE_BITS) -> Tree:
    """uint32 ring elements -> float64, values >= 2^31 read as negative."""
    scale = float(1 << scale_bits)

    def one(leaf):
        v = np.asarray(leaf, np.int64)
        v = np.where(v >= _RING // 2, v - _RING, v)
        return v.astype(np.float64) / scale

    return {k: one(v) for k, v in tree.items()}


def _mask_tree(seed: int, i: int, j: int, template: Tree) -> Tree:
    """Uniform uint32 ring elements shaped like ``template``, shared by
    the (unordered) pair i, j: one Philox stream keyed on (seed, lo, hi),
    drawn leaf by leaf in sorted name order."""
    lo, hi = (i, j) if i < j else (j, i)
    gen = np.random.Generator(np.random.Philox(key=[seed, (lo << 32) | hi]))
    return {
        k: gen.integers(0, _RING, size=np.shape(template[k]), dtype=np.uint32)
        for k in sorted(template)
    }


def net_mask_of(seed: int, client: int, n_clients: int, template: Tree) -> Tree:
    """Client's total mask: Σ_{j>c} m(c,j) − Σ_{j<c} m(j,c)  (mod 2^32)."""
    total = {k: np.zeros(np.shape(v), np.uint32) for k, v in template.items()}
    for other in range(n_clients):
        if other == client:
            continue
        mask = _mask_tree(seed, client, other, template)
        for k in total:
            if other > client:
                total[k] = (total[k] + mask[k]).astype(np.uint32)
            else:
                total[k] = (total[k] - mask[k]).astype(np.uint32)
    return total


def mask_update(update: Tree, seed: int, client: int, n_clients: int,
                scale_bits: int = DEFAULT_SCALE_BITS) -> Tree:
    """Client-side: quantize and add the net pairwise mask (mod 2^32)."""
    q = quantize(update, scale_bits)
    mask = net_mask_of(seed, client, n_clients, q)
    return {k: (q[k] + mask[k]).astype(np.uint32) for k in q}


def aggregate_masked(masked_updates: Sequence[Tree],
                     scale_bits: int = DEFAULT_SCALE_BITS,
                     dropped_net_masks: Sequence[Tree] = ()) -> Tree:
    """Server-side: modular sum of masked updates -> dequantized float sum.

    With a full cohort the pairwise masks cancel identically. If clients
    dropped after masking, pass their :func:`net_mask_of` trees: the
    survivors' residual masks toward a dropped client sum to exactly the
    negation of that client's net mask, so adding it cancels the residue.
    """
    total = {k: np.asarray(v, np.uint32) for k, v in masked_updates[0].items()}
    for u in list(masked_updates[1:]) + list(dropped_net_masks):
        total = {
            k: (a + np.asarray(u[k], np.uint32)).astype(np.uint32)
            for k, a in total.items()
        }
    return dequantize(total, scale_bits)
