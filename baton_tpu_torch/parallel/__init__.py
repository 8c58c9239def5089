from baton_tpu_torch.parallel.engine import FedSim, RoundResult
from baton_tpu_torch.parallel.fedbuff import AsyncResult, FedBuff
from baton_tpu_torch.parallel.personalization import FedPer, PersonalizedRoundResult
from baton_tpu_torch.parallel.clustered import ClusteredFedSim, ClusteredRoundResult
from baton_tpu_torch.parallel.stateful import StatefulClients, StatefulRoundResult

__all__ = [
    "FedSim",
    "RoundResult",
    "FedBuff",
    "AsyncResult",
    "FedPer",
    "PersonalizedRoundResult",
    "StatefulClients",
    "StatefulRoundResult",
    "ClusteredFedSim",
    "ClusteredRoundResult",
]
