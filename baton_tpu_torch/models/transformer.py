"""Shared transformer building blocks (counterpart of
``baton_tpu/models/transformer.py``).

Parameters are flat dicts; a block's functions take the sub-dict of its
own names (``scope(params, "blocks/3/")``). Dense weights are
``[d_in, d_out]`` and applied as ``x @ w``, in the JAX package's layout,
so the weights bridge copies without transposes. Params stay fp32;
activations are cast to the compute dtype per apply; norms and softmax
run in fp32. Attention tensors are [B, H, L, Dh]; every model takes an
``attention_fn`` with the signature of :func:`dot_product_attention`.
Initializers draw on the generator's device, so a model built from a
CUDA generator is made on the card (an 8B base is never staged on the
host). :func:`remat` is the counterpart of ``jax.checkpoint`` for a block.

Every product of a matrix the ``transformer-tp`` rule table can shard goes
through :func:`linear`, :func:`column_parallel` / :func:`row_parallel` or
:func:`embed`. On a plain tensor each is the dense ``x @ w`` (a lookup for
``embed``) of a meshless call. On a :class:`~baton_tpu_torch.parallel.
tensor_parallel.ShardedLeaf` placed over a mesh's ``model`` axis they
compute Megatron's layout by hand, as GSPMD derives it for the JAX
package: a column-parallel weight gives one output part a shard (each on
its shard's device), the elementwise ops run on the parts, and a
row-parallel weight contracts each part with its shard and adds the
partials (``tensor_parallel.model_sum``); a bias after a row-parallel
product is added once, after the sum. Attention runs each shard's own
heads where the shard edges of ``wq``/``wk``/``wv`` fall on heads and
keep GQA's map (``n_heads`` and ``n_kv_heads`` both divide by the shard
count), and otherwise on the gathered projections.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from torch.utils import _pytree

from baton_tpu_torch.core.model import Params
from baton_tpu_torch.ops.flash_attention import flash_attention
from baton_tpu_torch.core.sharded import is_sharded, model_sum, on

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
# products with weights that may be placed over the model axis


def _whole(t):
    return t.gather() if is_sharded(t) else t


def _joined(parts):
    """The parts concatenated on their last dim on the first one's device."""
    if len(parts) == 1:
        return parts[0]
    home = parts[0].device
    return torch.cat([on(p, home) for p in parts], dim=-1)


def linear(x, w, b=None):
    """``x @ w (+ b)`` whole, in x's dtype, whatever ``w``'s placement."""
    if not is_sharded(w):
        y = x @ w.to(x.dtype)
        return y if b is None else y + _whole(b).to(x.dtype)
    if w.split_dim == 0:
        return row_parallel([x], w, b)
    return _joined(column_parallel(x, w, b))


def column_parallel(x, w, b=None) -> list:
    """``x @ w (+ b)`` split over ``w``'s output columns: one part for each
    shard of a column-parallel ``w`` (on its shard's device, in shard
    order), else the one whole product."""
    if not is_sharded(w) or w.split_dim != w.ndim - 1:
        return [linear(x, w, b)]
    parts = []
    for j, (wj, (start, size)) in enumerate(zip(w.shards, w.offsets())):
        xj = on(x, wj.device)
        y = xj @ wj.to(xj.dtype)
        if b is not None:
            bj = (b.shards[j] if is_sharded(b) and b.size == size
                  else _whole(b).narrow(-1, start, size))
            y = y + on(bj, wj.device).to(xj.dtype)
        parts.append(y)
    return parts


def row_parallel(parts, w, b=None):
    """``concat(parts) @ w (+ b)``: for a row-parallel ``w`` each part
    (re-split on its rows where the parts do not match them) times its
    shard, the partials added by ``model_sum`` and ``b`` added once after."""
    if not is_sharded(w) or w.split_dim != 0:
        return linear(_joined(parts), w, b)
    if len(parts) != len(w.shards) or any(p.shape[-1] != w.size for p in parts):
        x = _joined(parts)
        parts = [x.narrow(-1, start, size) for start, size in w.offsets()]
    y = model_sum([on(p, wj.device) @ wj.to(p.dtype) for p, wj in zip(parts, w.shards)])
    return y if b is None else y + on(_whole(b), y.device).to(y.dtype)


def embed(w, ids):
    """The rows ``w[ids]``; for a vocab-parallel ``w`` (rows split) each
    shard looks up the ids in its own range, gives zeros for the others,
    and ``model_sum`` adds the shards (one of them holds each row)."""
    if not is_sharded(w) or w.split_dim != 0:
        return _whole(w)[ids]
    parts = []
    for wj, (start, size) in zip(w.shards, w.offsets()):
        local = on(ids, wj.device) - start
        hit = (local >= 0) & (local < size)
        parts.append(wj[local.clamp(0, size - 1)] * hit.unsqueeze(-1).to(wj.dtype))
    return model_sum(parts)


# ---------------------------------------------------------------------------
# initializers


def normal_init(gen: torch.Generator, shape, stddev) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * stddev


def dense_init(gen, d_in, d_out, stddev=None) -> torch.Tensor:
    """[d_in, d_out] fan-in scaled normal (stddev 1/sqrt(d_in) default)."""
    if stddev is None:
        stddev = d_in ** -0.5
    return normal_init(gen, (d_in, d_out), stddev)


def ln_init(d, device=None) -> Params:
    return {"scale": torch.ones(d, device=device), "bias": torch.zeros(d, device=device)}


def rms_init(d, device=None) -> Params:
    return {"scale": torch.ones(d, device=device)}


# ---------------------------------------------------------------------------
# norms (fp32 statistics whatever the compute dtype)


def layer_norm(x, p, eps=1e-6):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * p["scale"] + p["bias"]).to(x.dtype)


def rms_norm(x, p, eps=1e-6):
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (RoPE)


def rope_angles(seq_len: int, head_dim: int, theta: float = 10000.0, device=None):
    """Returns (cos, sin) each [L, Dh/2], fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(pos, inv_freq)  # [L, Dh/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Rotate the two halves of the channels (not interleaved pairs), as
    the JAX package does. x [B, H, L, Dh]; cos/sin [L, Dh/2]."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1, r2], dim=-1).to(x.dtype)


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
# on a v5e; no TPU number steers the card. Until a sweep on the card is
# adopted (configure_attention_dispatch), every length goes to the flash
# kernels; beyond the dense budget they take over whatever the crossover.
_FLASH_MIN_LEN = 0
# None, or the kernels' one tile after a sweep adopted it
_FLASH_BLOCKS = None
# the port's kernels have one (block_q, block_k) tile
# (csrc/flash_attention_mma.cu: TILE = 64)
KERNEL_BLOCKS = (64, 64)
_DENSE_SCORES_BUDGET_BYTES = 512 * 1024 ** 2


def _kernel_blocks(blocks) -> tuple:
    blocks = (int(blocks[0]), int(blocks[1]))
    if blocks != KERNEL_BLOCKS:
        raise ValueError(f"the flash kernels have one tile {KERNEL_BLOCKS}, got {blocks}")
    return blocks


def configure_attention_dispatch(min_len=None, blocks=None, sweep_path=None):
    """Apply a MEASURED flash-vs-dense crossover to the dispatcher.

    Explicit ``min_len`` / ``blocks`` win; ``blocks`` other than the
    kernels' tile raise ``ValueError``. Otherwise ``sweep_path`` names an
    artifact in ``benchmarks/attention_sweep.py``'s record shape
    (``{"platform", "results": [{"L", "dense_ms", "flash": {"<bq>x<bk>":
    ms}}]}``): the threshold becomes the smallest measured L whose best
    flash config beats the dense path. Only ``platform == "gpu"``
    artifacts are trusted: a TPU or CPU sweep never steers the card. A
    malformed row (a null timing, a foreign tile) is skipped without
    discarding the rows after it. Returns the ``(min_len, blocks)`` now in
    effect; a missing or foreign artifact, or one with no crossover,
    changes nothing.
    """
    global _FLASH_MIN_LEN, _FLASH_BLOCKS
    if blocks is not None:
        blocks = _kernel_blocks(blocks)
    if sweep_path is not None and min_len is None and blocks is None:
        import json

        try:
            with open(sweep_path) as f:
                sweep = json.load(f)
            records = (sorted(sweep.get("results", []), key=lambda r: r.get("L", 1 << 30))
                       if sweep.get("platform") == "gpu" else [])
        except (OSError, ValueError, AttributeError):
            records = []
        for rec in records:
            try:
                dense = rec.get("dense_ms")
                flash = rec.get("flash") or {}
                if not (isinstance(dense, (int, float)) and flash):
                    continue
                spec, ms = min(flash.items(), key=lambda kv: kv[1])
                if ms < dense:
                    blocks = _kernel_blocks(spec.split("x"))
                    min_len = int(rec["L"])
                    break
            except (ValueError, KeyError, TypeError, AttributeError, IndexError):
                continue
    if min_len is not None:
        _FLASH_MIN_LEN = int(min_len)
    if blocks is not None:
        _FLASH_BLOCKS = blocks
    return _FLASH_MIN_LEN, _FLASH_BLOCKS


def default_attention(q, k, v, bias=None, causal=False):
    """The model zoo's default attention: the flash kernels from
    ``_FLASH_MIN_LEN`` on, or wherever the dense path's fp32 scores would
    exceed ``_DENSE_SCORES_BUDGET_BYTES``, for no bias or a per-key
    [B, 1, 1, L] bias; the dense path otherwise (any other bias shape)."""
    b, hq, lq = q.shape[:3]
    lk = k.shape[2]
    scores_bytes = 4 * b * hq * lq * lk
    if (lk >= _FLASH_MIN_LEN or scores_bytes > _DENSE_SCORES_BUDGET_BYTES) and (
            bias is None or tuple(bias.shape) == (b, 1, 1, lk)):
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
    rope: Optional[tuple] = None,
    attention_fn: AttentionFn = default_attention,
):
    """Multi-head attention over x [B, L, D] -> [B, L, D]; ``rope`` is
    ``(cos, sin)`` from :func:`rope_angles`, applied to q and k. With
    ``wq``/``wk``/``wv`` column-parallel, shard ``j`` attends over its own
    query heads ``j·Hq/m ..`` and kv heads ``j·Hkv/m ..`` (GQA's map
    ``h // (Hq/Hkv)`` holds inside each shard) and ``wo`` is row-parallel;
    where the shard edges do not fall so, the projections are gathered
    and attention runs over every head at once."""
    b, l, _ = x.shape
    n_kv = n_kv_heads or n_heads
    dh = p["wq"].shape[1] // n_heads
    qs, ks, vs = (column_parallel(x, p[name]) for name in ("wq", "wk", "wv"))
    m = len(qs)
    by_heads = (len(ks) == len(vs) == m and n_heads % m == 0 and n_kv % m == 0
                and all(q.shape[-1] == n_heads // m * dh for q in qs)
                and all(t.shape[-1] == n_kv // m * dh for t in ks + vs))
    if not by_heads:
        qs, ks, vs = [_joined(qs)], [_joined(ks)], [_joined(vs)]
    outs = []
    for q, k, v in zip(qs, ks, vs):
        dev = q.device
        hq, hkv = q.shape[-1] // dh, k.shape[-1] // dh
        q = q.reshape(b, l, hq, dh).transpose(1, 2)  # [B, H, L, Dh]
        k = on(k, dev).reshape(b, l, hkv, dh).transpose(1, 2)
        v = on(v, dev).reshape(b, l, hkv, dh).transpose(1, 2)
        if rope is not None:
            cos, sin = (on(t, dev) for t in rope)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        out = attention_fn(q, k, v, bias=None if bias is None else on(bias, dev), causal=causal)
        outs.append(out.transpose(1, 2).reshape(b, l, hq * dh))
    return row_parallel(outs, p["wo"])


# ---------------------------------------------------------------------------
# MLP


def gelu_mlp_init(gen, d_model, d_ff) -> Params:
    return {
        "w1": dense_init(gen, d_model, d_ff),
        "b1": torch.zeros(d_ff, device=gen.device),
        "w2": dense_init(gen, d_ff, d_model),
        "b2": torch.zeros(d_model, device=gen.device),
    }


def gelu_mlp_apply(p, x):
    """``w1``/``b1`` column-parallel, ``w2`` row-parallel, ``b2`` added once
    after the partials' sum."""
    hs = [F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
          for h in column_parallel(x, p["w1"], p["b1"])]
    return row_parallel(hs, p["w2"], p["b2"])


def swiglu_init(gen, d_model, d_ff) -> Params:
    return {
        "w_gate": dense_init(gen, d_model, d_ff),
        "w_up": dense_init(gen, d_model, d_ff),
        "w_down": dense_init(gen, d_ff, d_model),
    }


def swiglu_apply(p, x):
    """``w_gate``/``w_up`` column-parallel, ``w_down`` row-parallel."""
    gs, us = column_parallel(x, p["w_gate"]), column_parallel(x, p["w_up"])
    if len(gs) != len(us) or any(g.shape != u.shape for g, u in zip(gs, us)):
        gs, us = [_joined(gs)], [_joined(us)]
    return row_parallel([F.silu(g) * on(u, g.device) for g, u in zip(gs, us)], p["w_down"])


# ---------------------------------------------------------------------------
# pre-LN encoder block


def prenorm_block_init(gen, d_model, n_heads, d_ff) -> Params:
    return {
        **prefixed("ln1/", ln_init(d_model, gen.device)),
        **prefixed("attn/", mha_init(gen, d_model, n_heads)),
        **prefixed("ln2/", ln_init(d_model, gen.device)),
        **prefixed("mlp/", gelu_mlp_init(gen, d_model, d_ff)),
    }


def prenorm_block_apply(p, x, n_heads, bias=None,
                        attention_fn: AttentionFn = default_attention):
    x = x + mha_apply(scope(p, "attn/"), layer_norm(x, scope(p, "ln1/")), n_heads,
                      bias=bias, attention_fn=attention_fn)
    return x + gelu_mlp_apply(scope(p, "mlp/"), layer_norm(x, scope(p, "ln2/")))


# ---------------------------------------------------------------------------
# rematerialisation (the counterpart of jax.checkpoint for one block call)


class _Remat(torch.autograd.Function):
    """One block call that keeps only its inputs for the backward pass,
    which runs the block again under ``torch.func.vjp``. It composes with
    ``torch.func.vmap(grad(...))``, where ``torch.utils.checkpoint`` does
    not (saved-tensor hooks, and no ``setup_context``). The vjp is taken
    only with respect to the inputs that need a gradient: a frozen weight
    (unbatched under the client vmap) gets none, so no weight gradient of
    the frozen base is ever formed.

    ``torch.func.grad`` runs the backward pass with ``create_graph=True``,
    so whatever a backward computes is recorded for a second derivative
    and kept until the gradient call returns. The recompute runs under
    ``no_grad`` (the vjp inside it still differentiates the block): each
    block's recomputed activations are freed once its gradients are out.
    No second derivative goes through a remat block."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *inputs):
        return fn(*inputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[1:]) if need]

        def block(*diff):
            full = list(inputs)
            for i, t in zip(wanted, diff):
                full[i] = t
            return ctx.fn(*full)

        out = [None] * len(inputs)
        with torch.no_grad():
            _, vjp_fn = torch.func.vjp(block, *(inputs[i] for i in wanted))
            for i, g in zip(wanted, vjp_fn(grads)):
                out[i] = g
        return (None, *out)


def remat(block_fn: Callable) -> Callable:
    """``block_fn(params, *tensors) -> tensor or tuple of tensors`` as one
    rematerialised call: the backward pass recomputes the block's
    activations from its inputs (its flat params, a placed param's shards
    among them, and ``tensors``) instead of storing them. Every argument
    must be a tensor; close over anything else (a None bias) in
    ``block_fn``."""

    def call(params: Params, *tensors):
        leaves, spec = _pytree.tree_flatten(params)
        n = len(leaves)
        single = []

        def flat(*ts):
            out = block_fn(_pytree.tree_unflatten(list(ts[:n]), spec), *ts[n:])
            if isinstance(out, tuple):
                return out
            single.append(True)
            return (out,)

        out = _Remat.apply(flat, *leaves, *tensors)
        return out[0] if single else out

    return call


# ---------------------------------------------------------------------------
# per-token LM loss (used by llama.py and lstm.py)


def per_token_cross_entropy(logits, labels):
    """logits [B, L, V], labels int [B, L] -> fp32 [B, L]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None], dim=-1).squeeze(-1)
    return logz - ll
