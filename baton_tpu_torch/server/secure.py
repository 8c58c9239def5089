"""Secure-aggregation wire protocol: key agreement, masking, recovery.

The reference manager observes every client's raw weights
(reference manager.py:95-126). This module gives the HTTP control plane
a Bonawitz-style protocol on top of the modular-masking primitives in
:mod:`baton_tpu_torch.ops.secure_agg`, so the manager only ever learns the
*sum* of client updates:

0. **AdvertiseKeys** — per round, every cohort member generates TWO
   Diffie-Hellman keypairs (RFC 3526 group 14, 2048-bit MODP): ``c``
   keys derive the pairwise mask seeds, ``s`` keys encrypt the share
   transport (``POST /{name}/secure_keys``). Each pair (i, j) shares
   seeds ``SHA-256(context ‖ DH(sk_i, pk_j))`` the server cannot
   compute.
1. **ShareKeys** — each member draws a self-mask seed b_i and
   Shamir-shares (t-of-n, honest-majority t = ⌊n/2⌋+1) both b_i and
   its mask secret key c_sk_i across the cohort
   (``POST /{name}/secure_shares``). Share pairs travel sealed under
   the pairwise s-key (encrypt-then-MAC) and are RELAYED by the
   manager inside the ``round_start`` broadcast — opaque to it.
   Members that fail this phase never distributed shares, so they are
   excluded from the masking cohort outright.
2. **MaskedInputCollection** — each client uploads its sample-weighted
   update quantized into Z_2^64 (fixed point) plus one Philox-derived
   uint64 mask per pair (``+`` when its client_id sorts first, ``−``
   otherwise) plus its self mask PRG(b_i). Any single upload — even
   with every pairwise seed known — is uniform noise without b_i. The
   64-bit ring (vs the 32-bit offline primitive in ops/secure_agg.py)
   buys headroom for sample-weighted sums: at 16 fractional bits,
   Σᵢ nᵢ·|θ| may reach 2^47 before wrapping.
3. **Unmasking** — the server partitions the masking cohort into
   survivors (reporters) and dropped, and asks every reporter ONCE for
   its share bundle (``POST /{name}/secure_unmask``): per peer, EITHER
   the self-mask share (survivors) OR the mask-key share (dropped) —
   never both, and the partition is pinned for the round. From ≥t
   shares each, the server reconstructs dropped members' c_sk (to
   cancel their residual pairwise masks) and survivors' b_i (to remove
   self masks), then dequantizes the sum.

Threat model (Bonawitz et al. 2017, honest-but-curious single server,
honest majority of clients): the server learns only the survivors'
sum. Fabricated dropout claims are useless — naming a live reporter
"dropped" forfeits its self-mask share under the either-or rule, so
its upload stays masked by PRG(b_i); asking again with a different
partition is refused (pinning). Up to n−t unmask responders may fail
and the round still opens; below the threshold the manager aborts and
the previous global params stand, which is safe. Round-binding every
seed hash prevents cross-round mask replay. (Active network attackers
impersonating the server/clients would additionally need a PKI for
signed key advertisements — out of scope, as in the paper's
semi-honest variant.)
"""

from __future__ import annotations

import hashlib
import secrets
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from baton_tpu_torch.ops.secure_agg import DEFAULT_SCALE_BITS

_RING_BITS = 64
_RING = 1 << _RING_BITS


def quantize64(
    state: Mapping[str, np.ndarray], scale_bits: int = DEFAULT_SCALE_BITS
) -> Dict[str, np.ndarray]:
    """Float state dict -> uint64 fixed point (two's complement in
    Z_2^64). int64 intermediates hold scale_bits=16 magnitudes up to
    2^47 exactly — the sample-weighted sums this protocol ships."""
    scale = float(1 << scale_bits)
    return {
        k: np.round(np.asarray(v, np.float64) * scale)
        .astype(np.int64)
        .astype(np.uint64)
        for k, v in state.items()
    }


def dequantize64(
    state: Mapping[str, np.ndarray], scale_bits: int = DEFAULT_SCALE_BITS
) -> Dict[str, np.ndarray]:
    """uint64 ring elements -> float64; values >= 2^63 read as negative."""
    scale = float(1 << scale_bits)
    out = {}
    for k, v in state.items():
        signed = np.asarray(v, np.uint64).astype(np.int64)  # two's complement
        out[k] = signed.astype(np.float64) / scale
    return out

# RFC 3526 group 14: 2048-bit MODP prime, generator 2. A fixed,
# nothing-up-my-sleeve group (pi-derived) — the standard choice for
# finite-field DH without external crypto dependencies.
MODP_P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
MODP_G = 2
_SK_BITS = 256  # exponent size; 2^256 work factor ≫ the group's ~110-bit strength


def dh_keypair() -> Tuple[int, int]:
    """Fresh per-round DH keypair (sk, pk = g^sk mod p)."""
    sk = secrets.randbits(_SK_BITS) | 1
    return sk, pow(MODP_G, sk, MODP_P)


# Cached DH powers. The 2048-bit modexp is the protocol's dominant host
# cost (measured ~7 ms each; a 64-cohort round needs ~190 per client)
# and depends only on (sk, pk), not the context — so the three
# context-distinct derivations per peer pair (mask seed + one sealed-box
# direction each way) share one cached power. Forward secrecy is why the
# keypairs are per-round, so the cache must not outlive them: parties
# call :func:`purge_dh_secrets` when they discard a round's secure state
# (worker key rotation, manager round finalization/abort) — a plain dict
# with targeted eviction, NOT an lru_cache that would retain old rounds'
# shared secrets for the process lifetime. Guarded by a lock: callers
# run on asyncio worker THREADS (the event-loop starvation fix moved
# all heavy crypto off-loop), so purge's iterate-and-delete can race a
# concurrent insert/clear — "dict changed size during iteration" inside
# a finalize task would leave a round locked forever. The 7 ms modexp
# itself runs OUTSIDE the lock so threads don't serialize on it.
import threading as _threading

_DH_CACHE: Dict[Tuple[int, int], bytes] = {}
# Sized for a 256-member cohort's full pair matrix (256·255 = 65,280
# entries, ~26 MB of 2048-bit powers). The old 16384 cap sat on a knife
# edge: C=128 (16,256 pairs) just fit, while C=256 wholesale-clear()ed
# the cache mid-protocol — every worker's inbox decryption then
# recomputed 255 modexps, the broadcast phase ballooned ~540 s past the
# manager's HTTP timeout, and the whole cohort silently failed to ack.
# Eviction is oldest-first (insertion order), never a wholesale clear.
_DH_CACHE_MAX = 65536
_DH_CACHE_LOCK = _threading.Lock()
# Tombstones for purged secret keys: a ~7 ms modexp in flight on a pool
# thread when its sk is purged would otherwise re-insert the dead
# round's shared secret AFTER the purge, silently undoing it. sks are
# per-round ephemerals and never legitimately reused after purge, so
# refusing future cache inserts for them costs nothing. Insertion-
# ordered with a hard cap — oldest tombstones fall off.
_DH_PURGED: Dict[int, None] = {}
_DH_PURGED_MAX = 4096
# hit/miss tally for the cache — the C=256 postmortem above was, at
# bottom, an *invisible* cache wipe; dh_cache_stats() surfaces the
# cache's health as manager gauges so the next sizing knife edge shows
# up on a dashboard instead of in a timeout
_DH_CACHE_HITS = 0
_DH_CACHE_MISSES = 0


def _dh_raw(sk: int, pk_other: int) -> bytes:
    global _DH_CACHE_HITS, _DH_CACHE_MISSES
    key = (sk, pk_other)
    with _DH_CACHE_LOCK:
        v = _DH_CACHE.get(key)
        if v is None:
            _DH_CACHE_MISSES += 1
        else:
            _DH_CACHE_HITS += 1
    if v is None:
        v = pow(pk_other, sk, MODP_P).to_bytes(256, "big")
        with _DH_CACHE_LOCK:
            if sk not in _DH_PURGED:
                while len(_DH_CACHE) >= _DH_CACHE_MAX:
                    _DH_CACHE.pop(next(iter(_DH_CACHE)))
                _DH_CACHE[key] = v
    return v


def dh_cache_stats() -> Dict[str, int]:
    """Size + hit/miss counters of the process-wide DH power cache,
    read under the cache lock (surfaced as ``dh_cache_*`` gauges by the
    manager's ``/metrics`` endpoint)."""
    with _DH_CACHE_LOCK:
        return {
            "size": len(_DH_CACHE),
            "hits": _DH_CACHE_HITS,
            "misses": _DH_CACHE_MISSES,
        }


def purge_dh_secrets(*sks: int) -> None:
    """Drop every cached DH power derived from the given secret keys.
    Call when a round's secure state is discarded — after this, only a
    party still holding the ephemeral sk itself can rederive the pairwise
    seeds (the forward-secrecy contract of per-round keypairs). Purged
    keys are tombstoned so a concurrent in-flight derivation cannot
    re-insert them."""
    with _DH_CACHE_LOCK:
        for sk in sks:
            _DH_PURGED[sk] = None
        while len(_DH_PURGED) > _DH_PURGED_MAX:
            _DH_PURGED.pop(next(iter(_DH_PURGED)))
        dead = [k for k in _DH_CACHE if k[0] in sks]
        for k in dead:
            del _DH_CACHE[k]


def dh_shared_seed(sk: int, pk_other: int, context: str) -> bytes:
    """32-byte pairwise seed: SHA-256(context ‖ g^(sk_i·sk_j) mod p).

    Symmetric in the pair by DH; ``context`` (the round name) binds masks
    to one round so a replayed upload can't be unmasked with old seeds.
    """
    if not 1 < pk_other < MODP_P - 1:
        raise ValueError("invalid DH public key")
    return hashlib.sha256(
        context.encode() + b"|" + _dh_raw(sk, pk_other)
    ).digest()


# ======================================================================
# Shamir t-of-n secret sharing over GF(2^521 − 1)
#
# The double-masking protocol (Bonawitz et al. 2017) needs each client's
# self-mask seed b_i and mask-DH secret key recoverable by the SERVER
# from any t honest peers — but no fewer. 2^521 − 1 is a Mersenne prime
# comfortably above both 256-bit seeds and 256-bit DH exponents, and
# Python integers make the field arithmetic exact and dependency-free.

SHAMIR_P = (1 << 521) - 1
_SHARE_BYTES = 66  # ceil(521 / 8)


def shamir_share(secret: int, n: int, t: int) -> Dict[int, int]:
    """Split ``secret`` into n shares with threshold t (any t reconstruct,
    t−1 reveal nothing). Returns {x: f(x)} for x = 1..n."""
    if not 0 <= secret < SHAMIR_P:
        raise ValueError("secret out of field range")
    if not 1 <= t <= n:
        raise ValueError(f"need 1 <= t <= n, got t={t}, n={n}")
    coeffs = [secret] + [
        secrets.randbelow(SHAMIR_P) for _ in range(t - 1)
    ]
    out = {}
    for x in range(1, n + 1):
        y = 0
        for c in reversed(coeffs):  # Horner
            y = (y * x + c) % SHAMIR_P
        out[x] = y
    return out


def shamir_reconstruct(shares: Dict[int, int]) -> int:
    """Lagrange interpolation at 0 — exact iff ≥ t shares are supplied
    (fewer yields a uniformly wrong value, by design)."""
    total = 0
    xs = list(shares)
    for xi in xs:
        num, den = 1, 1
        for xj in xs:
            if xj == xi:
                continue
            num = (num * (-xj)) % SHAMIR_P
            den = (den * (xi - xj)) % SHAMIR_P
        total = (
            total + shares[xi] * num * pow(den, SHAMIR_P - 2, SHAMIR_P)
        ) % SHAMIR_P
    return total


def share_to_hex(y: int) -> str:
    return y.to_bytes(_SHARE_BYTES, "big").hex()


def share_from_hex(h: str) -> int:
    return int.from_bytes(bytes.fromhex(h), "big")


# ======================================================================
# authenticated share transport (client→client, relayed via the server)
#
# Share pairs travel through the untrusted manager, so they are
# encrypted+MACed under a key only the two endpoints can derive
# (DH on the dedicated share-transport keypair). Stdlib-only AEAD:
# SHA-256 counter-mode keystream + HMAC-SHA256 (encrypt-then-MAC).

import hmac as _hmac


def _keystream(key: bytes, n: int) -> bytes:
    out = b""
    ctr = 0
    while len(out) < n:
        out += hashlib.sha256(key + b"|ks|" + ctr.to_bytes(8, "big")).digest()
        ctr += 1
    return out[:n]


def seal(key: bytes, plaintext: bytes) -> bytes:
    ct = bytes(
        a ^ b for a, b in zip(plaintext, _keystream(key, len(plaintext)))
    )
    tag = _hmac.new(key, b"|mac|" + ct, hashlib.sha256).digest()
    return tag + ct


def unseal(key: bytes, sealed: bytes) -> bytes:
    """Raises ValueError on a forged/garbled box."""
    tag, ct = sealed[:32], sealed[32:]
    want = _hmac.new(key, b"|mac|" + ct, hashlib.sha256).digest()
    if not _hmac.compare_digest(tag, want):
        raise ValueError("share box failed authentication")
    return bytes(a ^ b for a, b in zip(ct, _keystream(key, len(ct))))


def _pair_sign(my_id: str, other_id: str) -> int:
    """Mask sign convention: the lexicographically-smaller client_id adds
    the pair's mask, the larger subtracts it — identical on every party
    with no coordination."""
    if my_id == other_id:
        raise ValueError("no pairwise mask with self")
    return 1 if my_id < other_id else -1


def pair_mask(seed: bytes, template: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Deterministic uniform-uint64 mask per tensor from a 32-byte seed.

    Philox (256-bit key = the seed) is counter-based and bit-identical
    across platforms, so client-side masking and server-side dropout
    recovery derive the same stream from the same seed.
    """
    words = np.frombuffer(seed, dtype=np.uint64)  # 4 × uint64
    gen = np.random.Generator(
        np.random.Philox(
            key=words[:2],  # Philox keys are 128-bit
            counter=np.concatenate([words[2:], np.zeros(2, np.uint64)]),
        )
    )
    # one stream, consumed in sorted-name order: client masking and
    # server recovery must draw identical bits even if their state dicts
    # were built in different insertion orders
    out = {}
    for name in sorted(template):
        out[name] = gen.integers(
            0, 1 << 64, size=np.shape(template[name]), dtype=np.uint64
        )
    return out


def mask_state_dict(
    state: Mapping[str, np.ndarray],
    my_id: str,
    pair_seeds: Mapping[str, bytes],
    scale_bits: int = DEFAULT_SCALE_BITS,
    self_seed: Optional[bytes] = None,
) -> Dict[str, np.ndarray]:
    """Client-side: quantize ``state`` and add every pairwise mask, plus
    (double-masking) the client's own self-mask PRG(b_i).

    ``pair_seeds`` maps each *other* cohort member's client_id to the DH
    seed shared with it. The result is uint64 ring elements — uniform
    noise to anyone missing the seeds. With ``self_seed`` (the Bonawitz
    b_i) the upload stays uniform noise EVEN to a server that somehow
    learned every pairwise seed; b_i is only recoverable from t Shamir
    shares held by the peers.
    """
    out = quantize64(state, scale_bits)
    for other_id, seed in pair_seeds.items():
        sign = _pair_sign(my_id, other_id)
        mask = pair_mask(seed, out)
        for k in out:
            if sign > 0:
                out[k] = (out[k] + mask[k]).astype(np.uint64)
            else:
                out[k] = (out[k] - mask[k]).astype(np.uint64)
    if self_seed is not None:
        mask = pair_mask(self_seed, out)
        for k in out:
            out[k] = (out[k] + mask[k]).astype(np.uint64)
    return out


def self_mask_correction(
    self_seeds: Sequence[bytes], template: Mapping[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Server-side: the additive correction removing reporters' self
    masks — the negated sum of PRG(b_i) over the reconstructed b_i."""
    corr = {
        k: np.zeros(np.shape(v), np.uint64) for k, v in template.items()
    }
    for seed in self_seeds:
        mask = pair_mask(seed, template)
        for k in corr:
            corr[k] = (corr[k] - mask[k]).astype(np.uint64)
    return corr


def modular_sum(updates: Sequence[Mapping[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Σ mod 2^64 over masked uploads (server-side)."""
    total = {k: np.asarray(v, np.uint64).copy() for k, v in updates[0].items()}
    for u in updates[1:]:
        for k in total:
            total[k] = (total[k] + np.asarray(u[k], np.uint64)).astype(np.uint64)
    return total


def dropout_correction(
    dropped_id: str,
    revealed_seeds: Mapping[str, bytes],
    template: Mapping[str, np.ndarray],
) -> Dict[str, np.ndarray]:
    """Server-side: the additive correction cancelling a dropped client.

    Each reporter i's upload contains ``sign(i, d)·mask(seed_id)`` toward
    dropped client d; summing ``sign(d, i)·mask(seed_id)`` over the
    reporters (whose seeds with d they revealed) is exactly the negation
    of the residue.
    """
    corr = {
        k: np.zeros(np.shape(v), np.uint64) for k, v in template.items()
    }
    for reporter_id, seed in revealed_seeds.items():
        sign = _pair_sign(dropped_id, reporter_id)
        mask = pair_mask(seed, template)
        for k in corr:
            if sign > 0:
                corr[k] = (corr[k] + mask[k]).astype(np.uint64)
            else:
                corr[k] = (corr[k] - mask[k]).astype(np.uint64)
    return corr


def unmask_sum(
    masked_sum: Mapping[str, np.ndarray],
    corrections: Sequence[Mapping[str, np.ndarray]],
    scale_bits: int = DEFAULT_SCALE_BITS,
) -> Dict[str, np.ndarray]:
    """Apply dropout corrections and dequantize to float64."""
    total = {k: np.asarray(v, np.uint64).copy() for k, v in masked_sum.items()}
    for corr in corrections:
        for k in total:
            total[k] = (total[k] + np.asarray(corr[k], np.uint64)).astype(np.uint64)
    return dequantize64(total, scale_bits)
