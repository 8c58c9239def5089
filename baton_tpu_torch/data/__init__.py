from baton_tpu_torch.data.partition import (
    dirichlet_partition,
    iid_partition,
    label_shard_partition,
    partition_stats,
)
from baton_tpu_torch.data.synthetic import (
    linear_client_data,
    synthetic_char_clients,
    synthetic_classification_clients,
    synthetic_image_clients,
)

__all__ = [
    "dirichlet_partition",
    "iid_partition",
    "label_shard_partition",
    "partition_stats",
    "linear_client_data",
    "synthetic_char_clients",
    "synthetic_classification_clients",
    "synthetic_image_clients",
]
