"""LoRA — low-rank adapter fine-tuning (counterpart of
``baton_tpu/models/lora.py``; BASELINE config 4).

For every targeted 2-D weight ``W [in, out]`` the effective weight is
``W + (alpha/rank)·A@B``, with ``A [in, r]`` normal / sqrt(in) and
``B [r, out]`` zeros, so step 0 is exactly the base model. The wrapped
model's flat params are ``base/<name>`` for the base model's own and
``lora/<name>/a``, ``lora/<name>/b`` for the adapters (the JAX package's
``path_str`` names of ``{"base": ..., "lora": {name: {"a", "b"}}}``), and
``apply`` merges in the forward. With ``FedSim(...,
trainable=lora_trainable)`` only the adapters are per-client, trained and
aggregated; the frozen base is held once.

A base weight placed over a mesh's ``model`` axis (a ``ShardedLeaf``) is
merged shard by shard: a column-parallel ``W_j`` gets ``s·A @ B[:, cols_j]``
and a row-parallel one ``s·A[rows_j] @ B``, so the merged weight keeps the
base's layout while the adapters stay whole, per client, and replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from baton_tpu_torch.core.model import FedModel, Params
from baton_tpu_torch.core.sharded import is_sharded, on

TargetPredicate = Callable[[str, Any], bool]


@dataclasses.dataclass(frozen=True)
class LoraSpec:
    """Rank/alpha of a wrapped model, stored on ``FedModel.aux`` so the
    training-time scale and the deploy-time merge cannot diverge."""

    rank: int
    alpha: float

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def default_target(path: str, leaf) -> bool:
    """Adapt every 2-D matrix (matmul weights; biases and norms are 1-D)."""
    return hasattr(leaf, "dim") and leaf.dim() == 2


def lora_trainable(path: str, leaf) -> bool:
    """Partition predicate selecting the adapters of a wrapped model."""
    return path.startswith("lora/")


def merge_lora_model(model: FedModel, params: Params) -> Params:
    """Deploy params for a :func:`lora_wrap`-ped model, merged at the
    exact scale it was trained with (``model.aux``)."""
    spec = model.aux
    if not isinstance(spec, LoraSpec):
        raise ValueError(f"{model.name} is not a lora_wrap-ped model")
    return merge_lora(params, spec.alpha, spec.rank)


def merge_lora(params: Params, alpha: float, rank: int) -> Params:
    """The base model's params with ``W += (alpha/rank)·A@B`` on every
    adapted weight. Prefer :func:`merge_lora_model`, which cannot drift
    from the training-time scale."""
    scale = alpha / rank
    merged = {}
    for key, leaf in params.items():
        if not key.startswith("base/"):
            continue
        name = key[len("base/"):]
        a = params.get(f"lora/{name}/a")
        if a is not None:
            leaf = _merged(leaf, a, params[f"lora/{name}/b"], scale)
        merged[name] = leaf
    return merged


def _merged(w, a, b, scale: float):
    """``w + scale·a@b``; for a placed ``w`` each shard gets its columns
    (column-parallel) or rows (row-parallel) of the product."""
    if not is_sharded(w):
        return w + (scale * (a @ b)).to(w.dtype)
    size = w.size
    if w.split_dim == 1:
        return w.map(lambda j, wj: wj + (scale * (on(a, wj.device) @ on(
            b.narrow(1, j * size, size), wj.device))).to(wj.dtype))
    return w.map(lambda j, wj: wj + (scale * (on(a.narrow(0, j * size, size), wj.device)
                                              @ on(b, wj.device))).to(wj.dtype))


def lora_wrap(
    model: FedModel,
    rank: int = 8,
    alpha: Optional[float] = None,
    target: TargetPredicate = default_target,
    name: Optional[str] = None,
) -> FedModel:
    """Wrap ``model`` with LoRA adapters on every targeted 2-D weight.

    ``init(generator)`` builds the base and the adapters on the
    generator's device. Load pretrained weights by overwriting the
    ``base/*`` params after init.
    """
    if alpha is None:
        alpha = 2.0 * rank
    spec = LoraSpec(rank=rank, alpha=float(alpha))

    def init(gen: torch.Generator) -> Params:
        base = model.init(gen)
        targets = [(k, v.shape) for k, v in base.items() if target(k, v)]
        if not targets:
            raise ValueError("LoRA target predicate matched no 2-D leaves")
        params = {f"base/{k}": v for k, v in base.items()}
        for path, (fan_in, fan_out) in targets:
            params[f"lora/{path}/a"] = torch.randn(
                (fan_in, rank), generator=gen, device=gen.device) / fan_in ** 0.5
            params[f"lora/{path}/b"] = torch.zeros((rank, fan_out), device=gen.device)
        return params

    def apply(params, batch):
        return model.apply(merge_lora(params, alpha, rank), batch)

    def per_example_loss(params, batch):
        return model.per_example_loss(merge_lora(params, alpha, rank), batch)

    return FedModel(init=init, apply=apply, per_example_loss=per_example_loss,
                    name=name or f"{model.name}_lora{rank}", aux=spec)
