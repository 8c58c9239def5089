"""baton_tpu_torch — the PyTorch/CUDA port of baton_tpu for one NVIDIA H100.

The JAX package ``baton_tpu`` stays the reference; this package imports
neither it nor JAX. Its layout follows ``baton_tpu`` module for module.
Parameters are flat ``{slash/joined/name: tensor}`` dicts with the JAX
package's names and shapes (``server/state.py`` bridges the two).

Device rule: entry points take ``device="cuda"`` by default and raise
when no GPU is present, unless the caller asks for ``device="cpu"`` (as
the tests do). Nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The entry points' device rule: ``cuda`` needs a GPU; ``cpu`` only
    when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


# imported after resolve_device: the engine imports it from here
from baton_tpu_torch.core.model import FedModel  # noqa: E402
from baton_tpu_torch.parallel.engine import FedSim  # noqa: E402

__all__ = ["FedModel", "FedSim", "resolve_device"]
