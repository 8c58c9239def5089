"""Mixture-of-Experts FFN (counterpart of ``baton_tpu/models/moe.py``).

Top-k routing in the GShard/Switch dispatch-tensor form, with static
shapes: every expert gets a fixed capacity ``C = ceil(capacity_factor ·
K · L / E)`` and a token past it is dropped (its gate mass is not added
back; the residual stream carries it unchanged). Dispatch [B, S, E, C]
times the tokens feeds the stacked expert weights [E, D, F] in one
batched contraction; combine is the transpose einsum weighted by the
gates. Routing is fp32; the expert matmuls keep x's dtype. The Switch
load-balance term is ``E · Σ_e f_e · P_e`` (f_e: the share of tokens
whose first choice is e; P_e: the mean router probability).

Both one-hots are comparisons against an ``arange``: an over-capacity
slot (position >= C) then matches no column and its row is all zeros, as
``jax.nn.one_hot`` gives it; ``torch.nn.functional.one_hot`` would raise.
Expert parallelism (sharding E over a mesh) waits for the mesh port.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from baton_tpu_torch.models.transformer import dense_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_weight: float = 0.01


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, cfg: MoEConfig):
    e = cfg.n_experts

    def stack(d_in, d_out):
        return torch.stack([dense_init(gen, d_in, d_out) for _ in range(e)])

    return {
        "router": dense_init(gen, d_model, e),
        "w_gate": stack(d_model, d_ff),   # [E, D, F]
        "w_up": stack(d_model, d_ff),     # [E, D, F]
        "w_down": stack(d_ff, d_model),   # [E, F, D]
    }


def moe_capacity(cfg: MoEConfig, seq_len: int) -> int:
    return max(1, math.ceil(cfg.capacity_factor * cfg.top_k * seq_len / cfg.n_experts))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot whose row is all zeros where ``idx`` >= n."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _route(p, x, cfg: MoEConfig):
    """fp32 router probabilities [B, L, E] and the renormalised top-k gates
    and expert indices [B, L, K]."""
    probs = torch.softmax(torch.einsum("bld,de->ble", x.float(), p["router"]), dim=-1)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, idx


def moe_apply(p, x, cfg: MoEConfig):
    """x [B, L, D] -> (y [B, L, D] in x.dtype, aux fp32 scalar)."""
    b, l, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = moe_capacity(cfg, l)
    probs, gate, idx = _route(p, x, cfg)

    # flatten choices k-major (s = k·L + l): every token's first choice
    # claims capacity before any token's second
    idx_f = idx.transpose(1, 2).reshape(b, k * l)            # [B, S]
    gate_f = gate.transpose(1, 2).reshape(b, k * l)
    mask = _one_hot(idx_f, e)                                 # [B, S, E]
    pos = ((torch.cumsum(mask, dim=1) - 1.0) * mask).sum(-1).to(torch.int64)
    disp = mask[..., None] * _one_hot(pos, c)[:, :, None, :]  # [B, S, E, C]

    disp_x = disp.to(x.dtype)
    expert_in = torch.einsum("bklec,bld->becd", disp_x.reshape(b, k, l, e, c), x)
    h_gate = torch.einsum("becd,edf->becf", expert_in, p["w_gate"].to(x.dtype))
    h_up = torch.einsum("becd,edf->becf", expert_in, p["w_up"].to(x.dtype))
    h = (F.silu(h_gate.float()) * h_up.float()).to(x.dtype)
    expert_out = torch.einsum("becf,efd->becd", h, p["w_down"].to(x.dtype)).float()

    comb = disp * gate_f[..., None, None]                     # [B, S, E, C]
    y = torch.einsum("bsec,becd->bsd", comb, expert_out)      # fp32 [B, S, D]
    y = y.reshape(b, k, l, d).sum(dim=1)                      # fold the choices

    frac_tokens = _one_hot(idx[..., 0], e).mean(dim=(0, 1))  # [E]
    mean_prob = probs.mean(dim=(0, 1))                        # [E]
    aux = e * (frac_tokens * mean_prob).sum()
    return y.to(x.dtype), aux


def moe_dense_oracle(p, x, cfg: MoEConfig):
    """Every token through its top-k experts densely, with no capacity
    dropping: what :func:`moe_apply` equals whenever capacity is ample."""
    _, gate, idx = _route(p, x, cfg)
    xf = x.float()

    def ffn(e):
        g = F.silu(xf @ p["w_gate"][e].float())
        u = xf @ p["w_up"][e].float()
        return (g * u) @ p["w_down"][e].float()

    all_out = torch.stack([ffn(e) for e in range(cfg.n_experts)], dim=2)  # [B, L, E, D]
    sel = torch.take_along_dim(all_out, idx[..., None], dim=2)           # [B, L, K, D]
    return (sel * gate[..., None]).sum(dim=2).to(x.dtype)
