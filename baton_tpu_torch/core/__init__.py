from baton_tpu_torch.core.model import FedModel
from baton_tpu_torch.core.training import LocalTrainer, make_local_trainer
from baton_tpu_torch.core.partition import ParamPartition, make_partition
from baton_tpu_torch.core.regularizers import fedprox

__all__ = [
    "FedModel",
    "LocalTrainer",
    "make_local_trainer",
    "ParamPartition",
    "make_partition",
    "fedprox",
]
