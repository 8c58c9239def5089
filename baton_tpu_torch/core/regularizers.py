"""Local-objective regularizers (counterpart of
``baton_tpu/core/regularizers.py``).

The local objective is ``data_loss + regularizer(params, anchor)``, where
``anchor`` is the round's broadcast global params
(:class:`baton_tpu_torch.core.training.LocalTrainer`): the shape FedProx
needs.
"""

from __future__ import annotations

from baton_tpu_torch.ops.aggregation import global_sq_dist


def fedprox(mu: float):
    """FedProx proximal term ``(mu/2)·‖params − global‖²`` (Li et al.,
    MLSys 2020), in fp32. BASELINE config 3 (BERT/AG-News federated
    fine-tune) uses it."""

    def reg(params, anchor):
        return global_sq_dist(params, anchor) * (0.5 * mu)

    return reg
