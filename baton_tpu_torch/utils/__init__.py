"""Auxiliary subsystems carried over from ``baton_tpu/utils``: the
round checkpointer, metrics, tracing, structured logs, fault injection and
the profiler hooks.
"""

from baton_tpu_torch.utils.checkpoint import Checkpointer, RestoredState
from baton_tpu_torch.utils.metrics import Metrics
from baton_tpu_torch.utils.profiling import annotate, profile_trace, timed

__all__ = [
    "Checkpointer",
    "RestoredState",
    "Metrics",
    "annotate",
    "profile_trace",
    "timed",
]
