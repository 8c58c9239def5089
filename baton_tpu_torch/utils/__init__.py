"""Auxiliary subsystems carried over from ``baton_tpu/utils``: metrics,
tracing, structured logs, fault injection and the profiler hooks.

The reference's checkpointer (orbax) is not ported yet, and this package
does not import one.
"""

from baton_tpu_torch.utils.metrics import Metrics
from baton_tpu_torch.utils.profiling import annotate, profile_trace, timed

__all__ = [
    "Metrics",
    "annotate",
    "profile_trace",
    "timed",
]
