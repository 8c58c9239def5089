"""Update compression for the HTTP edge — top-k sparsification with
error feedback, and stochastic int8 quantization (the port of
``baton_tpu/ops/compression.py``).

The round *delta* rather than the weights crosses the network, sparsified
to the top-k largest-magnitude coordinates with the dropped mass carried
forward ("error feedback", so the compressor is unbiased over time), and
optionally stochastically quantized (unbiased per draw). Both compose with
sample-weighted FedAvg because the mean of deltas is the delta of the
mean:

    mean_w(anchor + d_i) = anchor + mean_w(d_i)

so the manager reconstructs ``anchor + decompress(payload)`` per upload
and aggregates as usual (server/http_manager.py).

Two halves:

* the uplink (:func:`topk_compress`, :func:`topk_decompress`,
  :func:`quantize_stochastic`, :func:`dequantize`,
  :class:`ErrorFeedbackCompressor`, :func:`decompress_payload`) and
  :func:`quantize_state_dict` are torch on the tensors' device: the HTTP
  worker hands them its round delta on the card, so ResNet-18's top-k runs
  there. ``torch.topk`` is the plain counterpart of the reference's
  ``jax.lax.top_k`` (XLA's op, not a hand-written kernel). Randomness
  comes from an explicit ``torch.Generator`` where the reference splits
  JAX keys. Trees are flat ``{name: tensor}`` dicts; numpy leaves are
  taken as CPU tensors.
* the downlink's numpy functions (:func:`dequantize_state_dict`,
  :func:`parse_delta_spec`, :func:`delta_encode_state_dict`,
  :func:`apply_delta_state_dict`) are the reference's, byte for byte: a
  delta blob encoded by either package's manager reconstructs to the same
  bytes, and so to the same digest, in either package's worker.

Incompatible with secure aggregation by construction: masking requires
every upload to be a dense ring element (server/secure.py), and a sparse
support set would itself leak which coordinates changed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

Tree = Dict[str, Any]


def _leaf_k(size: int, frac: float) -> int:
    return max(1, min(size, int(round(size * frac))))


def _f32(leaf, device=None) -> torch.Tensor:
    return torch.as_tensor(leaf, dtype=torch.float32, device=device)


def topk_compress(
    tree: Tree, frac: float, residual: Optional[Tree] = None
) -> Tuple[Tree, Tree]:
    """Keep the top ``frac`` fraction of coordinates per leaf (by
    magnitude); everything else goes into the returned residual.

    Returns ``(payload, new_residual)``. ``payload`` has one
    ``{"idx": int32[k], "val": f32[k], "size": int}`` per leaf (flat
    indexing, in descending magnitude as ``jax.lax.top_k`` orders them),
    on the leaf's device. With ``residual`` from the previous round the
    input is pre-corrected: compress(tree + residual) — error feedback.
    """
    if not (0.0 < frac <= 1.0):
        raise ValueError(f"frac must be in (0, 1], got {frac}")
    payloads, new_res = {}, {}
    for name, leaf in tree.items():
        flat = _f32(leaf).reshape(-1)
        if residual is not None:
            flat = flat + _f32(residual[name], flat.device).reshape(-1)
        k = _leaf_k(flat.numel(), frac)
        _, idx = torch.topk(flat.abs(), k)
        val = flat[idx]
        kept = torch.zeros_like(flat)
        kept[idx] = val
        payloads[name] = {
            "idx": idx.to(torch.int32),
            "val": val,
            "size": int(flat.numel()),
        }
        new_res[name] = (flat - kept).reshape(tuple(leaf.shape))
    return payloads, new_res


def topk_decompress(payload: Tree, template: Tree) -> Tree:
    """Reconstruct dense leaves shaped like ``template`` from a
    :func:`topk_compress` payload (on the values' device)."""
    out = {}
    for name, t in template.items():
        p = payload[name]
        val = _f32(p["val"])
        dense = torch.zeros(int(p["size"]), dtype=torch.float32, device=val.device)
        dense[torch.as_tensor(p["idx"], device=val.device).long()] = val
        out[name] = dense.reshape(tuple(t.shape))
    return out


def _quantize_leaf(x: torch.Tensor, generator: torch.Generator, bits: int):
    qmax = float(2 ** (bits - 1) - 1)
    dtype = torch.int8 if bits == 8 else torch.int16
    scale = torch.clamp(x.abs().max(), min=1e-12) / qmax
    y = x / scale
    lo = torch.floor(y)
    # P(round up) = frac(y) -> unbiased
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    up = u.to(x.device) < (y - lo)
    q = torch.clamp(lo + up, -qmax, qmax).to(dtype)
    return {"q": q, "scale": scale}


def quantize_stochastic(
    tree: Tree, generator: torch.Generator, bits: int = 8
) -> Tree:
    """Unbiased fixed-point quantization: each leaf becomes
    ``{"q": int8/int16[...], "scale": f32[]}`` with stochastic rounding
    (E[dequantize] == input, exactly), drawn from ``generator`` leaf by
    leaf."""
    if bits not in (8, 16):
        raise ValueError("bits must be 8 or 16")
    return {k: _quantize_leaf(_f32(v), generator, bits) for k, v in tree.items()}


def _is_quantized(x) -> bool:
    return isinstance(x, dict) and "q" in x


def dequantize(tree: Tree) -> Tree:
    def one(p):
        if _is_quantized(p):
            return _f32(p["q"]) * _f32(p["scale"])
        return {k: one(v) for k, v in p.items()}

    return one(tree)


@dataclasses.dataclass
class ErrorFeedbackCompressor:
    """Stateful top-k compressor for a worker's round deltas.

    Carries the residual across rounds (on the deltas' device) so the
    *sum* of transmitted updates tracks the sum of true updates (EF-SGD):
    nothing the compressor drops is ever lost, only delayed.
    """

    frac: float
    bits: Optional[int] = None  # additionally quantize kept values
    residual: Optional[Tree] = None
    # Seed the quantizer DIFFERENTLY per client (http_worker threads its
    # rng_seed here): identical seeds would correlate every client's
    # rounding errors and the cohort mean's quantization noise would
    # stop shrinking with cohort size.
    seed: int = 0
    _generator: Optional[torch.Generator] = dataclasses.field(
        default=None, repr=False
    )
    _last_exact: Optional[Tree] = dataclasses.field(
        default=None, repr=False
    )

    def compress(self, delta: Tree) -> Tree:
        payload, self.residual = topk_compress(delta, self.frac,
                                               self.residual)
        # pre-quantization payload kept for restore(): the EF invariant
        # must hold exactly per event, not just in expectation
        self._last_exact = payload
        if self.bits is not None:
            # quantization error is NOT fed back: stochastic rounding is
            # already unbiased per draw, so only top-k's (biased)
            # truncation needs the residual
            if self._generator is None:
                device = next(iter(payload.values()))["val"].device
                self._generator = torch.Generator(device=device)
                self._generator.manual_seed(self.seed)
            payload = {
                k: dict(p, val=_quantize_leaf(p["val"], self._generator,
                                              self.bits))
                for k, p in payload.items()
            }
        return payload

    def restore(self, template: Tree) -> None:
        """Fold the last ``compress()``'s kept mass back into the
        residual. Call when the upload FAILS (connection error, stale
        round, auth reset): ``compress`` already moved the kept mass out
        of the residual as "transmitted", and dropping it silently would
        lose it for good — violating the EF guarantee that dropped mass
        is only ever delayed. Restores the EXACT pre-quantization values
        (the invariant holds per event, not just in expectation)."""
        if self._last_exact is None:
            return
        dense = topk_decompress(self._last_exact, template)
        self._last_exact = None
        if self.residual is None:
            self.residual = dense
        else:
            self.residual = {k: r + dense[k] for k, r in self.residual.items()}


def decompress_payload(payload: Tree, template: Tree) -> Tree:
    """Decode a payload whose ``val`` entries may be quantized."""
    payload = {
        k: dict(p, val=_f32(p["val"]["q"]) * _f32(p["val"]["scale"]))
        if _is_quantized(p["val"]) else p
        for k, p in payload.items()
    }
    return topk_decompress(payload, template)


# ---------------------------------------------------------------------------
# downlink (broadcast) quantization — the server->client half of the
# bandwidth story. The manager quantizes the round's state dict once per
# round; every cohort member dequantizes the SAME tensors, so all clients
# still start from identical params (which also keeps secure-aggregation
# and sparse-upload anchors consistent).


def quantize_state_dict(
    state: Dict[str, Any], seed: int, bits: int = 8
) -> Dict[str, torch.Tensor]:
    """Flat wire layout: ``{"<name>@q": intN, "<name>@qscale": f32[1]}``.
    Stochastic rounding (unbiased) seeded per round."""
    q = quantize_stochastic(dict(state), torch.Generator().manual_seed(seed),
                            bits=bits)
    out: Dict[str, torch.Tensor] = {}
    for k, p in q.items():
        out[f"{k}@q"] = p["q"]
        out[f"{k}@qscale"] = p["scale"].reshape(1)
    return out


def dequantize_state_dict(tensors: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`quantize_state_dict` (accepts numpy or jnp)."""
    import numpy as np

    out: Dict[str, Any] = {}
    for k in tensors:
        if not k.endswith("@q"):
            continue
        name = k[: -len("@q")]
        scale = float(np.asarray(tensors[f"{name}@qscale"]).ravel()[0])
        out[name] = np.asarray(tensors[k], np.float32) * scale
    if not out:
        raise ValueError("no quantized tensors found in payload")
    return out


# ---------------------------------------------------------------------------
# broadcast delta blobs — the downlink analogue of the uplink top-k path.
# The manager encodes prev_round -> this_round as a (sparse and/or
# quantized) delta ONCE per round; any worker still anchored on the
# previous round's blob downloads the small delta instead of the full
# model. Because the delta is lossy, BOTH sides define the round's
# broadcast as the RECONSTRUCTION ``apply_delta(anchor, delta)`` — pure
# sequential numpy fp32, bit-identical on manager and worker — so the
# worker can re-encode its reconstruction and verify it hashes to the
# round blob's digest (falling back to the full download on mismatch).


def parse_delta_spec(spec: str) -> Dict[str, Any]:
    """``"q8" | "q16" | "topk:<frac>" | "topk:<frac>:q8|q16"`` ->
    ``{"frac": Optional[float], "bits": Optional[int]}``.

    Mirrors the worker-side upload compression specs so operators tune
    both directions with one vocabulary."""
    frac: Optional[float] = None
    bits: Optional[int] = None
    parts = spec.split(":")
    if parts[0] == "topk":
        if len(parts) not in (2, 3):
            raise ValueError(f"bad delta spec {spec!r}")
        frac = float(parts[1])
        if not (0.0 < frac <= 1.0):
            raise ValueError(f"delta top-k frac must be in (0, 1], got {frac}")
        if len(parts) == 3:
            parts = [parts[2]]
        else:
            parts = []
    if parts:
        if len(parts) != 1 or parts[0] not in ("q8", "q16"):
            raise ValueError(
                f"unknown delta spec {spec!r}; expected 'q8', 'q16', "
                "'topk:<frac>', or 'topk:<frac>:q8|q16'"
            )
        bits = int(parts[0][1:])
    return {"frac": frac, "bits": bits}


def delta_encode_state_dict(
    prev: Dict[str, Any],
    new: Dict[str, Any],
    spec: Dict[str, Any],
    seed: int = 0,
) -> Dict[str, Any]:
    """Encode ``new - prev`` per tensor under a :func:`parse_delta_spec`.

    Flat wire layouts (matching the repo's existing conventions):
    top-k  -> ``{"<k>@idx": int64[k], "<k>@val": f32[k] | int8/16[k],
    "<k>@scale": f32[1]}`` (``@scale`` only when quantized); dense
    quantized -> ``{"<k>@q": intN[shape], "<k>@qscale": f32[1]}``.

    Pure numpy on purpose: the encode runs once per round on the manager
    host and must not depend on XLA reduction order."""
    import numpy as np

    frac, bits = spec["frac"], spec["bits"]
    rng = np.random.default_rng(seed)
    qmax = float(2 ** ((bits or 8) - 1) - 1)
    qdtype = np.int8 if (bits or 8) == 8 else np.int16

    def stoch_round(x: "np.ndarray") -> "np.ndarray":
        lo = np.floor(x)
        up = rng.random(x.shape, dtype=np.float32) < (x - lo)
        return np.clip(lo + up, -qmax, qmax)

    out: Dict[str, Any] = {}
    for k, prev_arr in prev.items():
        p32 = np.asarray(prev_arr, np.float32).ravel()
        n32 = np.asarray(new[k], np.float32).ravel()
        d = n32 - p32
        if frac is not None:
            kk = _leaf_k(d.size, frac)
            idx = np.argpartition(np.abs(d), d.size - kk)[d.size - kk:]
            idx = np.sort(idx).astype(np.int64)
            val = d[idx]
            out[f"{k}@idx"] = idx
            if bits is not None:
                scale = max(float(np.max(np.abs(val))), 1e-12) / qmax
                out[f"{k}@val"] = stoch_round(val / np.float32(scale)).astype(qdtype)
                out[f"{k}@scale"] = np.asarray([scale], np.float32)
            else:
                out[f"{k}@val"] = val.astype(np.float32)
        elif bits is not None:
            scale = max(float(np.max(np.abs(d))), 1e-12) / qmax
            shape = np.asarray(prev_arr).shape
            out[f"{k}@q"] = (
                stoch_round(d / np.float32(scale)).astype(qdtype).reshape(shape)
            )
            out[f"{k}@qscale"] = np.asarray([scale], np.float32)
        else:
            raise ValueError("delta spec must sparsify and/or quantize")
    return out


def apply_delta_state_dict(
    anchor: Dict[str, Any], delta: Dict[str, Any]
) -> Dict[str, Any]:
    """Reconstruct the round broadcast: ``anchor + decode(delta)``.

    Deterministic sequential numpy fp32 (then cast back to each anchor
    tensor's dtype) so manager and worker reconstructions are
    bit-identical — that is what makes the worker's digest verification
    of ``wire.encode(reconstruction)`` meaningful."""
    import numpy as np

    out: Dict[str, Any] = {}
    for k, ref in anchor.items():
        ref_np = np.asarray(ref)
        ref32 = ref_np.astype(np.float32).ravel()
        if f"{k}@q" in delta:
            scale = np.float32(np.asarray(delta[f"{k}@qscale"]).ravel()[0])
            dense = np.asarray(delta[f"{k}@q"], np.float32).ravel() * scale
        elif f"{k}@idx" in delta:
            val = np.asarray(delta[f"{k}@val"], np.float32)
            if f"{k}@scale" in delta:
                val = val * np.float32(
                    np.asarray(delta[f"{k}@scale"]).ravel()[0]
                )
            dense = np.zeros(ref32.size, np.float32)
            dense[np.asarray(delta[f"{k}@idx"], np.int64)] = val
        else:
            raise KeyError(f"delta payload missing tensor {k!r}")
        out[k] = (ref32 + dense).reshape(ref_np.shape).astype(ref_np.dtype)
    return out
