"""The port's ops, with the names ``baton_tpu/ops/__init__.py`` exports."""

from baton_tpu_torch.ops.aggregation import (
    psum_weighted_mean,
    tree_stack,
    tree_unstack,
    weighted_tree_mean,
    weighted_tree_sum,
)
from baton_tpu_torch.ops.padding import pad_dataset, pad_to_capacity
from baton_tpu_torch.ops.privacy import (
    DPConfig,
    clip_by_global_norm,
    dp_fedavg,
    global_norm,
    poisson_sample,
    rdp_epsilon,
    sampled_gaussian_rdp,
    subsampled_rdp_epsilon,
)
from baton_tpu_torch.ops.secure_agg import aggregate_masked, mask_update, net_mask_of

__all__ = [
    "psum_weighted_mean",
    "weighted_tree_mean",
    "weighted_tree_sum",
    "tree_stack",
    "tree_unstack",
    "pad_dataset",
    "pad_to_capacity",
    "DPConfig",
    "clip_by_global_norm",
    "dp_fedavg",
    "global_norm",
    "poisson_sample",
    "rdp_epsilon",
    "sampled_gaussian_rdp",
    "subsampled_rdp_epsilon",
    "aggregate_masked",
    "mask_update",
    "net_mask_of",
]
