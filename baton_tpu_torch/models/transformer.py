"""Shared transformer building blocks (counterpart of
``baton_tpu/models/transformer.py``).

Parameters are flat dicts; a block's functions take the sub-dict of its
own names (``scope(params, "blocks/3/")``). Dense weights are
``[d_in, d_out]`` and applied as ``x @ w``, in the JAX package's layout,
so the weights bridge copies without transposes. Params stay fp32;
activations are cast to the compute dtype per apply; norms and softmax
run in fp32. Attention tensors are [B, H, L, Dh]; every model takes an
``attention_fn`` with the signature of :func:`dot_product_attention`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from baton_tpu_torch.core.model import Params
from baton_tpu_torch.ops.flash_attention import flash_attention

# attention_fn(q, k, v, bias, causal) -> out
#   q [B, Hq, L, Dh], k/v [B, Hkv, L, Dh], bias None or [B, 1, 1, L] additive
AttentionFn = Callable[..., torch.Tensor]


def scope(params: Params, prefix: str) -> Params:
    """The entries of ``params`` under ``prefix``, with it stripped."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def prefixed(prefix: str, params: Params) -> Params:
    return {prefix + k: v for k, v in params.items()}


# ---------------------------------------------------------------------------
# initializers


def normal_init(gen: torch.Generator, shape, stddev) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * stddev


def dense_init(gen, d_in, d_out, stddev=None) -> torch.Tensor:
    """[d_in, d_out] fan-in scaled normal (stddev 1/sqrt(d_in) default)."""
    if stddev is None:
        stddev = d_in ** -0.5
    return normal_init(gen, (d_in, d_out), stddev)


def ln_init(d) -> Params:
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


# ---------------------------------------------------------------------------
# norms (fp32 statistics whatever the compute dtype)


def layer_norm(x, p, eps=1e-6):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# attention


def dot_product_attention(q, k, v, bias=None, causal=False):
    """Dense scaled-dot-product attention with GQA. q [B, Hq, L, Dh];
    k, v [B, Hkv, L, Dh]. The contractions run in the input dtype, the
    softmax in fp32; ``bias`` is additive, broadcastable to [B, Hq, L, L]."""
    b, hq, l, dh = q.shape
    hkv = k.shape[1]
    scale = dh ** -0.5
    if hq != hkv:
        qg = q.reshape(b, hkv, hq // hkv, l, dh)
        scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) * scale
        scores = scores.reshape(b, hq, l, l)
    else:
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    scores = scores.float()
    if bias is not None:
        scores = scores + bias
    if causal:
        pos = torch.arange(l, device=q.device)
        scores = torch.where(pos[:, None] >= pos[None, :], scores,
                             torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    if hq != hkv:
        probs = probs.reshape(b, hkv, hq // hkv, l, l)
        out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v)
        return out.reshape(b, hq, l, dh)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


# The TPU package sends L < 4096 to the dense einsum, a crossover measured
# on a v5e; no TPU speed claim carries over to the H100. Until the card's
# own crossover is measured, every length goes to the flash kernels.
_FLASH_MIN_LEN = 0


def default_attention(q, k, v, bias=None, causal=False):
    """The model zoo's default attention: the flash kernels for no bias or
    a per-key [B, 1, 1, L] bias, the dense path for any other bias shape."""
    b, lk = q.shape[0], k.shape[2]
    if lk >= _FLASH_MIN_LEN and (bias is None or tuple(bias.shape) == (b, 1, 1, lk)):
        return flash_attention(q, k, v, bias=bias, causal=causal)
    return dot_product_attention(q, k, v, bias=bias, causal=causal)


def padding_bias(mask, dtype=torch.float32):
    """[B, L] 1/0 validity mask -> additive [B, 1, 1, L] attention bias."""
    return ((1.0 - mask.float()) * -1e30)[:, None, None, :].to(dtype)


def mha_init(gen, d_model, n_heads, n_kv_heads=None, head_dim=None, out_std=None) -> Params:
    n_kv = n_kv_heads or n_heads
    dh = head_dim or d_model // n_heads
    return {
        "wq": dense_init(gen, d_model, n_heads * dh),
        "wk": dense_init(gen, d_model, n_kv * dh),
        "wv": dense_init(gen, d_model, n_kv * dh),
        "wo": dense_init(gen, n_heads * dh, d_model, stddev=out_std),
    }


def mha_apply(
    p,
    x,
    n_heads: int,
    n_kv_heads: Optional[int] = None,
    bias=None,
    causal: bool = False,
    attention_fn: AttentionFn = default_attention,
):
    """Multi-head attention over x [B, L, D] -> [B, L, D]."""
    b, l, _ = x.shape
    n_kv = n_kv_heads or n_heads
    dh = p["wq"].shape[1] // n_heads

    def proj(w, h):
        y = x @ w.to(x.dtype)
        return y.reshape(b, l, h, dh).transpose(1, 2)  # [B, H, L, Dh]

    q, k, v = proj(p["wq"], n_heads), proj(p["wk"], n_kv), proj(p["wv"], n_kv)
    out = attention_fn(q, k, v, bias=bias, causal=causal)
    out = out.transpose(1, 2).reshape(b, l, n_heads * dh)
    return out @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# MLP


def gelu_mlp_init(gen, d_model, d_ff) -> Params:
    return {
        "w1": dense_init(gen, d_model, d_ff),
        "b1": torch.zeros(d_ff),
        "w2": dense_init(gen, d_ff, d_model),
        "b2": torch.zeros(d_model),
    }


def gelu_mlp_apply(p, x):
    h = x @ p["w1"].to(x.dtype) + p["b1"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ p["w2"].to(x.dtype) + p["b2"].to(x.dtype)


# ---------------------------------------------------------------------------
# pre-LN encoder block


def prenorm_block_init(gen, d_model, n_heads, d_ff) -> Params:
    return {
        **prefixed("ln1/", ln_init(d_model)),
        **prefixed("attn/", mha_init(gen, d_model, n_heads)),
        **prefixed("ln2/", ln_init(d_model)),
        **prefixed("mlp/", gelu_mlp_init(gen, d_model, d_ff)),
    }


def prenorm_block_apply(p, x, n_heads, bias=None,
                        attention_fn: AttentionFn = default_attention):
    x = x + mha_apply(scope(p, "attn/"), layer_norm(x, scope(p, "ln1/")), n_heads,
                      bias=bias, attention_fn=attention_fn)
    return x + gelu_mlp_apply(scope(p, "mlp/"), layer_norm(x, scope(p, "ln2/")))
