"""Weights bridge between the port's params and flat named state dicts
(counterpart of ``baton_tpu/server/state.py``).

The port's params already are a flat ``{name: tensor}`` dict with the JAX
package's slash-joined names (``"blocks/3/attn/wq"``) and its shapes:
dense weights keep JAX's ``[d_in, d_out]`` layout and are applied as
``x @ w``. So the bridge is a plain copy, with no transposes, to and from
the ``{name: numpy array}`` dicts that
``baton_tpu.server.state.params_to_state_dict`` produces. A leaf placed
over a mesh's ``model`` axis (``tensor_parallel.ShardedLeaf``) is gathered
on the way out, and given a mesh the params are placed by the
``transformer-tp`` table on the way in (``tensor_parallel.shard_params_tp``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from baton_tpu_torch import resolve_device
from baton_tpu_torch.core.model import Params
from baton_tpu_torch.parallel.tensor_parallel import is_sharded, shard_params_tp


def params_to_state_dict(params: Params) -> Dict[str, np.ndarray]:
    """``{name: numpy array}``, a placed leaf gathered whole."""
    return {name: (t.gather() if is_sharded(t) else t).detach().cpu().numpy()
            for name, t in params.items()}


def state_dict_to_params(template: Params, state: Dict[str, np.ndarray],
                         device="cuda", mesh=None) -> Params:
    """Params named and typed like ``template`` from a flat state dict, on
    ``device``, or with a ``mesh`` placed on it by the ``transformer-tp``
    table (``shard_params_tp``; the mesh then names the devices). Raises
    KeyError on a missing tensor and ValueError on a shape mismatch: a
    malformed upload must not corrupt the global model.
    """
    device = resolve_device(device) if mesh is None else torch.device("cpu")
    out = {}
    for name, leaf in template.items():
        if name not in state:
            raise KeyError(f"state dict missing tensor {name!r}")
        arr = np.asarray(state[name])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"tensor {name!r} has shape {arr.shape}, expected {tuple(leaf.shape)}"
            )
        out[name] = torch.from_numpy(np.array(arr)).to(device=device, dtype=leaf.dtype)
    return out if mesh is None else shard_params_tp(out, mesh)
