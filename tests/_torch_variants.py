"""Inputs and comparisons shared by the parity tests of the port against
the JAX package (not a test module).

JAX's threefry keys cannot be reproduced in torch, so a parity test takes
the permutations a JAX module draws from the key it hands each client
and injects them into the port (``perms=``); weights cross as flat state
dicts (``baton_tpu.server.state``)."""

from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from baton_tpu.server.state import params_to_state_dict as jax_to_state

BAND = 5e-2  # the reference's band for multi-round runs (tests/test_mesh_equivalence.py)


def jax_round_perms(rng, n_clients, n_epochs, capacity):
    """[C, n_epochs, capacity]: client c trains with split(rng, C)[c],
    and each epoch permutes with the first half of its epoch key."""
    return np.array(_round_perms(rng, n_clients, n_epochs, capacity))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _round_perms(rng, n_clients, n_epochs, capacity):
    def client(cr):
        return jax.vmap(lambda er: jax.random.permutation(jax.random.split(er)[0], capacity))(
            jax.random.split(cr, n_epochs))

    return jax.vmap(client)(jax.random.split(rng, n_clients))


def round_perms(rng, n_clients, n_epochs, capacity) -> torch.Tensor:
    """:func:`jax_round_perms` as a tensor, for a port's ``perms=``."""
    return torch.from_numpy(jax_round_perms(rng, n_clients, n_epochs, capacity))


def fedbuff_perms(rng, n_steps, buffer_size, n_epochs, capacity) -> torch.Tensor:
    """[n_steps, K, n_epochs, capacity]: JAX FedBuff's key chain, ``rng,
    sub = split(rng)`` a step and ``split(sub, K)`` over the buffer."""
    return torch.from_numpy(np.array(
        _fedbuff_perms(rng, n_steps, buffer_size, n_epochs, capacity)))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _fedbuff_perms(rng, n_steps, buffer_size, n_epochs, capacity):
    def step(rng, _):
        rng, sub = jax.random.split(rng)
        return rng, _round_perms(sub, buffer_size, n_epochs, capacity)

    return jax.lax.scan(step, rng, None, length=n_steps)[1]


def to_port(jparams) -> dict:
    """JAX params (any pytree) as the port's flat ``{name: tensor}``."""
    return {k: torch.from_numpy(np.array(v)) for k, v in jax_to_state(jparams).items()}


def assert_params_close(got: dict, want, tol: float):
    """``got`` (port params) against ``want`` (JAX params, or any flat
    ``{name: array}``) leaf by leaf, within ``tol`` relative and absolute."""
    want = jax_to_state(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name].detach().cpu()), w, rtol=tol,
                                   atol=tol, err_msg=name)
