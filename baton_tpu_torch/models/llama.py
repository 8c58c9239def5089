"""Llama-class decoder-only LM (counterpart of ``baton_tpu/models/llama.py``;
BASELINE config 4: LoRA instruction-tune).

RMSNorm pre-norm, RoPE, SwiGLU MLP (or a routed MoE layer), grouped-query
attention and an untied output head, from the blocks of
:mod:`baton_tpu_torch.models.transformer`. Params are fp32, activations
``compute_dtype``; norms and softmax run in fp32. Attention is causal
inside the kernel; an optional per-token ``loss_mask`` weights the LM
loss (instruction tuning masks the prompt). For federation, pair it with
:func:`baton_tpu_torch.models.lora.lora_wrap` and
``trainable=lora_trainable`` (:func:`llama_lora_target` places the
adapters on the attention projections).

Batches: ``{"x": int[B, L] inputs, "y": int[B, L] next-token targets,
"loss_mask"?: [B, L] 1.0 = the token counts}``. The per-example loss is
the mean over each sequence's unmasked tokens, [B].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from baton_tpu_torch.core.model import FedModel
from baton_tpu_torch.models.moe import MoEConfig, moe_apply, moe_init
from baton_tpu_torch.models.transformer import (
    AttentionFn,
    default_attention,
    dense_init,
    embed,
    linear,
    mha_apply,
    mha_init,
    normal_init,
    per_token_cross_entropy,
    prefixed,
    remat as remat_block,
    rms_init,
    rms_norm,
    rope_angles,
    scope,
    swiglu_apply,
    swiglu_init,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    max_len: int = 8192
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    # Mixture-of-Experts: every block's SwiGLU FFN becomes a routed
    # expert layer (models/moe.py)
    moe: Optional[MoEConfig] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-sized config."""
        defaults = dict(
            vocab_size=256, max_len=32, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=128, rope_theta=10000.0,
        )
        defaults.update(kw)
        return cls(**defaults)


def llama_lora_target(path: str, leaf) -> bool:
    """LoRA target predicate: the attention projections (wq/wk/wv/wo)."""
    return path.rsplit("/", 1)[-1] in ("wq", "wk", "wv", "wo")


def _block_init(gen: torch.Generator, cfg: LlamaConfig):
    if cfg.moe is not None:
        mlp = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe)
    else:
        mlp = swiglu_init(gen, cfg.d_model, cfg.d_ff)
    return {
        **prefixed("norm_attn/", rms_init(cfg.d_model, gen.device)),
        **prefixed("attn/", mha_init(
            gen, cfg.d_model, cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            out_std=cfg.d_model ** -0.5 / (2 * cfg.n_layers) ** 0.5)),
        **prefixed("norm_mlp/", rms_init(cfg.d_model, gen.device)),
        **prefixed("mlp/", mlp),
    }


def _block_apply(p, x, cos, sin, cfg: LlamaConfig, attention_fn: AttentionFn):
    """Returns (x, aux): aux is the block's MoE load-balance loss (0 for
    a dense block), one output structure for both variants."""
    x = x + mha_apply(
        scope(p, "attn/"), rms_norm(x, scope(p, "norm_attn/")), cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, causal=True, rope=(cos, sin),
        attention_fn=attention_fn,
    )
    h = rms_norm(x, scope(p, "norm_mlp/"))
    if cfg.moe is not None:
        y, aux = moe_apply(scope(p, "mlp/"), h, cfg.moe)
        return x + y, aux
    return x + swiglu_apply(scope(p, "mlp/"), h), torch.zeros((), device=x.device)


def vocab_logits(x: torch.Tensor, w) -> torch.Tensor:
    """fp32 logits of ``x @ w`` with the operands in x's dtype. With bf16
    operands the matmul accumulates in fp32 but writes bf16, cast to fp32
    after: ``torch.mm(out_dtype=float32)`` has no derivative (torch 2.11),
    where JAX keeps the fp32 accumulator (``preferred_element_type``). A
    column-parallel ``lm_head`` gives each shard's slice of the vocab,
    gathered before the loss (the remat head holds one sequence's)."""
    return linear(x, w).float()


def _head_losses(p, x, y):
    """Per-token losses of the final norm and the vocab projection:
    x [B, L, D], y [B, L] -> fp32 [B, L]."""
    logits = vocab_logits(rms_norm(x, {"scale": p["norm_f/scale"]}), p["lm_head"])
    return per_token_cross_entropy(logits, y)


def llama_lm_model(
    config: Optional[LlamaConfig] = None,
    compute_dtype: torch.dtype = torch.float32,
    attention_fn: AttentionFn = default_attention,
    name: str = "llama_lm",
    remat: bool = False,
) -> FedModel:
    """``remat=True`` recomputes each decoder block's activations in the
    backward pass instead of storing them (``transformer.remat``): stored
    activations drop from every layer's to the block inputs' at about a
    third more FLOPs, which is what fits config 4 on one card. The loss's
    head (final norm, vocab projection, cross entropy) is then recomputed
    too, one sequence at a time: XLA fuses the log-softmax over the fp32
    logits, while torch holds them several times over (4.2 GB each at
    batch 8 x 1024 tokens x 128,256). Each token's arithmetic is the
    same; only what is kept for the backward pass changes."""
    cfg = config or LlamaConfig.llama3_8b()

    def init(gen: torch.Generator):
        params = {"tok_emb": normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02)}
        for i in range(cfg.n_layers):
            params.update(prefixed(f"blocks/{i}/", _block_init(gen, cfg)))
        params.update(prefixed("norm_f/", rms_init(cfg.d_model, gen.device)))
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size)
        return params

    def block(p, x, cos, sin):
        return _block_apply(p, x, cos, sin, cfg, attention_fn)

    block_fn = remat_block(block) if remat else block
    head_fn = remat_block(_head_losses)

    def _hidden(params, batch):
        """The last block's output [B, L, D] and the summed MoE aux loss."""
        # JAX's gathers clamp out-of-range ids where torch's would raise
        ids = batch["x"].long().clamp(0, cfg.vocab_size - 1)
        cos, sin = rope_angles(ids.shape[-1], cfg.head_dim, cfg.rope_theta, ids.device)
        x = embed(params["tok_emb"], ids).to(compute_dtype)
        aux_total = torch.zeros((), device=x.device)
        for i in range(cfg.n_layers):
            x, aux = block_fn(scope(params, f"blocks/{i}/"), x, cos, sin)
            aux_total = aux_total + aux
        return x, aux_total

    def apply(params, batch):
        """Next-token logits [B, L, V] (fp32)."""
        x, _ = _hidden(params, batch)
        return vocab_logits(rms_norm(x, scope(params, "norm_f/")), params["lm_head"])

    def per_example_loss(params, batch):
        x, aux = _hidden(params, batch)
        y = batch["y"]
        head = {"norm_f/scale": params["norm_f/scale"], "lm_head": params["lm_head"]}
        if remat:
            tok_loss = torch.cat([head_fn(head, x[i:i + 1], y[i:i + 1])
                                  for i in range(x.shape[0])])
        else:
            tok_loss = _head_losses(head, x, y)  # [B, L]
        loss_mask = batch.get("loss_mask")
        if loss_mask is None:
            loss = tok_loss.mean(dim=-1)
        else:
            m = loss_mask.float()
            loss = (tok_loss * m).sum(dim=-1) / m.sum(dim=-1).clamp_min(1.0)
        if cfg.moe is None:
            return loss
        # the load-balance term is a whole-forward scalar: added to every
        # example, the mean loss gains exactly aux_weight·aux
        return loss + cfg.moe.aux_weight * aux

    return FedModel(init=init, apply=apply, per_example_loss=per_example_loss,
                    name=name, aux=cfg)
