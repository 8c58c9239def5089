from baton_tpu_torch.parallel.mesh import make_mesh, client_sharding, replicated_sharding
from baton_tpu_torch.parallel.engine import FedSim, RoundResult
from baton_tpu_torch.parallel.fedbuff import AsyncResult, FedBuff
from baton_tpu_torch.parallel.personalization import FedPer, PersonalizedRoundResult
from baton_tpu_torch.parallel.clustered import ClusteredFedSim, ClusteredRoundResult
from baton_tpu_torch.parallel.stateful import StatefulClients, StatefulRoundResult
from baton_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ulysses_attention,
    make_ring_attention_fn,
    make_striped_attention_fn,
    make_ulysses_attention_fn,
)
from baton_tpu_torch.parallel.multihost import initialize_multihost, make_hybrid_mesh

__all__ = [
    "make_mesh",
    "client_sharding",
    "replicated_sharding",
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
    "ring_attention",
    "ulysses_attention",
    "make_ring_attention_fn",
    "make_striped_attention_fn",
    "make_ulysses_attention_fn",
    "initialize_multihost",
    "make_hybrid_mesh",
]
