"""Vision Transformer (counterpart of ``baton_tpu/models/vit.py``; BASELINE
config 5: ViT-B/16 cross-silo).

Patchify is a reshape and one dense projection ([B, H, W, C] -> [B, N,
P·P·C] -> [B, N, D]; the same arithmetic as a stride-P convolution, with
no convolution), then a class token, learned position embeddings, pre-LN
encoder blocks with a GELU MLP, a final LayerNorm and a linear head on
the class token. No BatchNorm: a pure function of its params, so it
vmaps over the client axis. Sequences are ``N + 1`` long (197 at
224 px, patch 16): the flash kernels take the ragged last tile.

Batches: ``{"x": f32[B, H, W, C] (NHWC), "y": int[B]}``, H and W divisible
by ``patch``.
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
    linear,
    ln_init,
    normal_init,
    prefixed,
    prenorm_block_apply,
    prenorm_block_init,
    remat as remat_block,
    scope,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch: int = 16
    channels: int = 3
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    n_classes: int = 1000

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    @classmethod
    def b16(cls, **kw) -> "ViTConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        """Test-sized config."""
        defaults = dict(
            image_size=16, patch=4, channels=3, d_model=32, n_layers=2,
            n_heads=4, d_ff=64, n_classes=10,
        )
        defaults.update(kw)
        return cls(**defaults)


def _patchify(x, patch):
    """[B, H, W, C] -> [B, N, patch*patch*C] without convolution."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def vit_model(
    config: Optional[ViTConfig] = None,
    compute_dtype: torch.dtype = torch.float32,
    attention_fn: AttentionFn = default_attention,
    name: str = "vit",
    remat: bool = False,
) -> FedModel:
    """``remat=True`` recomputes each encoder block's activations in the
    backward pass instead of storing them (``transformer.remat``)."""
    cfg = config or ViTConfig.b16()
    patch_dim = cfg.patch * cfg.patch * cfg.channels

    def init(gen: torch.Generator):
        params = {
            "patch_proj/w": dense_init(gen, patch_dim, cfg.d_model),
            "patch_proj/b": torch.zeros(cfg.d_model, device=gen.device),
            "cls_token": normal_init(gen, (1, 1, cfg.d_model), 0.02),
            "pos_emb": normal_init(gen, (cfg.n_patches + 1, cfg.d_model), 0.02),
        }
        for i in range(cfg.n_layers):
            params.update(prefixed(f"blocks/{i}/", prenorm_block_init(
                gen, cfg.d_model, cfg.n_heads, cfg.d_ff)))
        params.update(prefixed("ln_f/", ln_init(cfg.d_model, gen.device)))
        params["head/w"] = dense_init(gen, cfg.d_model, cfg.n_classes)
        params["head/b"] = torch.zeros(cfg.n_classes, device=gen.device)
        return params

    def block(p, x):
        return prenorm_block_apply(p, x, cfg.n_heads, attention_fn=attention_fn)

    block_fn = remat_block(block) if remat else block

    def apply(params, batch):
        x = _patchify(batch["x"], cfg.patch).to(compute_dtype)
        x = linear(x, params["patch_proj/w"], params["patch_proj/b"])
        b = x.shape[0]
        cls = params["cls_token"].to(x.dtype).expand(b, 1, cfg.d_model)
        x = torch.cat([cls, x], dim=1) + params["pos_emb"].to(x.dtype)
        for i in range(cfg.n_layers):
            x = block_fn(scope(params, f"blocks/{i}/"), x)
        x = layer_norm(x, scope(params, "ln_f/"))
        cls_out = x[:, 0, :].float()
        return linear(cls_out, params["head/w"], params["head/b"])

    def per_example_loss(params, batch):
        return softmax_cross_entropy(apply(params, batch), batch)

    return FedModel(init=init, apply=apply, per_example_loss=per_example_loss,
                    name=name, aux=cfg)
