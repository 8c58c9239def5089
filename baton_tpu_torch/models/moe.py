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

Expert parallelism: with the stacked experts placed over a mesh's
``model`` axis (``tensor_parallel.shard_params_tp``: E split, the router
replicated), routing and dispatch run replicated, each shard runs its own
experts' einsums on its slice of the dispatched tokens, and the combine
sums the shards' partial outputs (``tensor_parallel.model_sum``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from baton_tpu_torch.models.transformer import dense_init
from baton_tpu_torch.core.sharded import is_sharded, model_sum, on


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
    comb = disp * gate_f[..., None, None]                     # [B, S, E, C]
    if is_sharded(p["w_gate"]):
        # expert parallelism: each shard's experts, the partial outputs summed
        parts = []
        for j, (start, size) in enumerate(p["w_gate"].offsets()):
            dev = p["w_gate"].shards[j].device
            ws = [on(_expert_shard(p[name], j, start, size), dev)
                  for name in ("w_gate", "w_up", "w_down")]
            out = _experts(on(expert_in.narrow(1, start, size), dev), *ws)
            parts.append(torch.einsum("bsec,becd->bsd", on(comb.narrow(2, start, size), dev), out))
        y = model_sum(parts)                                  # fp32 [B, S, D]
    else:
        expert_out = _experts(expert_in, p["w_gate"], p["w_up"], p["w_down"])
        y = torch.einsum("bsec,becd->bsd", comb, expert_out)  # fp32 [B, S, D]
    y = y.reshape(b, k, l, d).sum(dim=1)                      # fold the choices

    frac_tokens = _one_hot(idx[..., 0], e).mean(dim=(0, 1))  # [E]
    mean_prob = probs.mean(dim=(0, 1))                        # [E]
    aux = e * (frac_tokens * mean_prob).sum()
    return y.to(x.dtype), aux


def _experts(expert_in, w_gate, w_up, w_down):
    """The stacked experts' SwiGLU on their dispatched tokens [B, E, C, D]
    (x's dtype) -> fp32 [B, E, C, D]."""
    dtype = expert_in.dtype
    h_gate = torch.einsum("becd,edf->becf", expert_in, w_gate.to(dtype))
    h_up = torch.einsum("becd,edf->becf", expert_in, w_up.to(dtype))
    h = (F.silu(h_gate.float()) * h_up.float()).to(dtype)
    return torch.einsum("becf,efd->becd", h, w_down.to(dtype)).float()


def _expert_shard(w, j: int, start: int, size: int):
    """Experts ``start:start + size`` of a stacked weight: shard ``j`` of a
    placed one split so, else a slice on the shard's device."""
    if is_sharded(w):
        if w.split_dim == 0 and w.size == size:
            return w.shards[j]
        w = w.gather()
    return w.narrow(0, start, size)


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
