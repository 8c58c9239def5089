"""Shared helpers of the model-zoo parity tests (not a test module): the
JAX params carried to the port through the weights bridge, one FedSim
round of each package on the same data and JAX's shuffles, and the
tolerance checks."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu_torch.parallel.engine import FedSim
from baton_tpu_torch.server.state import params_to_state_dict, state_dict_to_params
from _torch_variants import jax_round_perms


def port(jax_params):
    """JAX params (a pytree) -> the port's flat dict, through the bridge."""
    state = jax_to_state(jax_params)
    template = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    return state_dict_to_params(template, state, device="cpu")


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach().float()) if torch.is_tensor(got)
                               else np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=msg)


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def rounds_agree(jmodel, tmodel, jparams, data, n_samples, batch_size, lr, n_epochs=1,
                 trainable=None, key=None, tol=1e-4):
    """One round of JAX's FedSim and the port's on the same weights, data
    and the permutations JAX draws from ``key``: losses and every param
    within ``tol``. Returns ``(port params before, port result)``."""
    key = jax.random.key(1) if key is None else key
    jsim = JaxFedSim(jmodel, batch_size=batch_size, learning_rate=lr, trainable=trainable)
    jres = jsim.run_round(jparams, to_jax(data), jnp.asarray(n_samples), key, n_epochs=n_epochs)
    sim = FedSim(tmodel, batch_size=batch_size, learning_rate=lr, trainable=trainable,
                 device="cpu")
    params = port(jparams)
    perms = torch.from_numpy(jax_round_perms(key, len(n_samples), n_epochs,
                                             next(iter(data.values())).shape[1]))
    res = sim.run_round(params, data, n_samples, n_epochs=n_epochs, perms=perms)
    close(res.loss_history, jres.loss_history, tol, "loss history")
    got = params_to_state_dict(res.params)
    want = jax_to_state(jres.params)
    assert set(got) == set(want)
    for name in want:
        close(got[name], want[name], tol, name)
    return params, res
