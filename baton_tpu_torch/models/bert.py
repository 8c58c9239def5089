"""BERT-style text classifier (counterpart of ``baton_tpu/models/bert.py``):
pre-LN blocks plus a final LayerNorm, learned absolute position
embeddings, first-token pooling through a tanh pooler, and padding as an
additive attention bias from ``batch["attn_mask"]`` ([B, L], 1 = real).

Batches: ``{"x": int[B, L], "attn_mask"?: [B, L], "y": int[B]}``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from baton_tpu_torch.core.losses import softmax_cross_entropy
from baton_tpu_torch.core.model import FedModel
from baton_tpu_torch.models.transformer import (
    AttentionFn,
    default_attention,
    dense_init,
    layer_norm,
    ln_init,
    normal_init,
    padding_bias,
    prefixed,
    prenorm_block_apply,
    prenorm_block_init,
    scope,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_len: int = 128
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    n_classes: int = 4  # AG-News

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        """Test-sized config."""
        defaults = dict(
            vocab_size=128, max_len=16, d_model=32, n_layers=2, n_heads=4,
            d_ff=64, n_classes=4,
        )
        defaults.update(kw)
        return cls(**defaults)


def bert_classifier_model(
    config: Optional[BertConfig] = None,
    compute_dtype: torch.dtype = torch.float32,
    attention_fn: AttentionFn = default_attention,
    name: str = "bert_classifier",
) -> FedModel:
    cfg = config or BertConfig.base()

    def init(gen: torch.Generator):
        params = {
            "tok_emb": normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02),
            "pos_emb": normal_init(gen, (cfg.max_len, cfg.d_model), 0.02),
        }
        for i in range(cfg.n_layers):
            params.update(prefixed(f"blocks/{i}/", prenorm_block_init(
                gen, cfg.d_model, cfg.n_heads, cfg.d_ff)))
        params.update(prefixed("ln_f/", ln_init(cfg.d_model)))
        params["pooler/w"] = dense_init(gen, cfg.d_model, cfg.d_model)
        params["pooler/b"] = torch.zeros(cfg.d_model)
        params["head/w"] = dense_init(gen, cfg.d_model, cfg.n_classes)
        params["head/b"] = torch.zeros(cfg.n_classes)
        return params

    def apply(params, batch):
        # JAX's gathers clamp out-of-range ids where torch's would raise
        ids = batch["x"].long().clamp(0, cfg.vocab_size - 1)
        l = ids.shape[-1]
        x = params["tok_emb"][ids] + params["pos_emb"][:l]
        x = x.to(compute_dtype)
        attn_mask = batch.get("attn_mask")
        bias = None if attn_mask is None else padding_bias(attn_mask)
        for i in range(cfg.n_layers):
            x = prenorm_block_apply(scope(params, f"blocks/{i}/"), x, cfg.n_heads,
                                    bias=bias, attention_fn=attention_fn)
        x = layer_norm(x, scope(params, "ln_f/"))
        cls = x[:, 0, :].float()
        pooled = torch.tanh(cls @ params["pooler/w"] + params["pooler/b"])
        return pooled @ params["head/w"] + params["head/b"]

    def per_example_loss(params, batch):
        return softmax_cross_entropy(apply(params, batch), batch)

    return FedModel(init=init, apply=apply, per_example_loss=per_example_loss,
                    name=name, aux=cfg)
