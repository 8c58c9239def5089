"""Character-level LSTM language model (counterpart of
``baton_tpu/models/lstm.py``; the FedAvg paper's Shakespeare workload).

A stacked LSTM whose step computes all four gates of a layer with one
``[B, E+H] @ [E+H, 4H]`` matmul (input and hidden concatenated). Params
are fp32; activations run in ``compute_dtype`` with the cell state ``c``
kept in fp32 and the gate nonlinearities in fp32. The forget-gate bias
starts at 1.

JAX runs the recurrence as one ``lax.scan``; here it is a Python loop
over time, so a step of a sequence of length L launches O(L · layers)
small kernels: the model is bound by the host's launches, not the card.

Batches: ``{"x": int[B, L] chars, "y": int[B, L] next chars,
"loss_mask"?: [B, L]}``, the decoder LM's contract (models/llama.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from baton_tpu_torch.core.model import FedModel
from baton_tpu_torch.models.transformer import dense_init, normal_init, per_token_cross_entropy


@dataclasses.dataclass(frozen=True)
class LSTMConfig:
    vocab_size: int = 90      # printable-ASCII Shakespeare alphabet
    d_embed: int = 8          # the FedAvg paper's char embedding is tiny
    d_hidden: int = 256
    n_layers: int = 2

    @classmethod
    def shakespeare(cls, **kw) -> "LSTMConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "LSTMConfig":
        """Test-sized config."""
        defaults = dict(vocab_size=32, d_embed=4, d_hidden=16, n_layers=2)
        defaults.update(kw)
        return cls(**defaults)


def _cell_init(gen: torch.Generator, d_in: int, d_hidden: int):
    # one fused kernel for the four gates (i, f, g, o): [d_in + d_hidden, 4*d_hidden]
    bias = torch.zeros(4 * d_hidden, device=gen.device)
    bias[d_hidden:2 * d_hidden] = 1.0  # forget gate
    return {"kernel": dense_init(gen, d_in + d_hidden, 4 * d_hidden), "bias": bias}


def _cell_step(p, x, h, c, compute_dtype):
    """One LSTM step: x [B, d_in], h [B, H], c fp32 [B, H]."""
    z = torch.cat([x, h], dim=-1) @ p["kernel"].to(x.dtype)
    z = z.float() + p["bias"]
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = (torch.sigmoid(o) * torch.tanh(c)).to(compute_dtype)
    return h, c


def lstm_lm_model(
    config: Optional[LSTMConfig] = None,
    compute_dtype: torch.dtype = torch.float32,
    name: str = "lstm_lm",
) -> FedModel:
    cfg = config or LSTMConfig.shakespeare()

    def init(gen: torch.Generator):
        params = {"embed": normal_init(gen, (cfg.vocab_size, cfg.d_embed), 0.1)}
        d_in = cfg.d_embed
        for i in range(cfg.n_layers):
            for k, v in _cell_init(gen, d_in, cfg.d_hidden).items():
                params[f"layers/{i}/{k}"] = v
            d_in = cfg.d_hidden
        params["out"] = dense_init(gen, cfg.d_hidden, cfg.vocab_size)
        return params

    def apply(params, batch):
        """Next-char logits fp32 [B, L, V]."""
        # JAX's gathers clamp out-of-range ids where torch's would raise
        ids = batch["x"].long().clamp(0, cfg.vocab_size - 1)
        b, l = ids.shape
        x = params["embed"][ids].to(compute_dtype)  # [B, L, E]
        layers = [{"kernel": params[f"layers/{i}/kernel"], "bias": params[f"layers/{i}/bias"]}
                  for i in range(cfg.n_layers)]
        h = [x.new_zeros((b, cfg.d_hidden)) for _ in layers]
        c = [x.new_zeros((b, cfg.d_hidden), dtype=torch.float32) for _ in layers]
        top = []
        for t in range(l):
            inp = x[:, t]
            for i, layer in enumerate(layers):
                h[i], c[i] = _cell_step(layer, inp, h[i], c[i], compute_dtype)
                inp = h[i]
            top.append(inp)
        top = torch.stack(top, dim=1)  # [B, L, H]
        return (top @ params["out"].to(top.dtype)).float()

    def per_example_loss(params, batch):
        tok_loss = per_token_cross_entropy(apply(params, batch), batch["y"])  # [B, L]
        loss_mask = batch.get("loss_mask")
        if loss_mask is None:
            return tok_loss.mean(dim=-1)
        m = loss_mask.float()
        return (tok_loss * m).sum(dim=-1) / m.sum(dim=-1).clamp_min(1.0)

    return FedModel(init=init, apply=apply, per_example_loss=per_example_loss,
                    name=name, aux=cfg)
