"""The port's LocalTrainer against the JAX trainer on BERT-tiny: the same
weights, data and (injected) per-epoch permutations. One SGD step 1e-6,
one epoch of several steps 1e-5; a zero-sample client is an exact no-op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.core.training import make_local_trainer as jax_trainer
from baton_tpu.models.bert import BertConfig as JaxBertConfig
from baton_tpu.models.bert import bert_classifier_model as jax_bert
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu_torch.core.training import make_local_trainer
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.server.state import state_dict_to_params

# small shapes: one thread each keeps the parallel test workers from
# oversubscribing the cores (and runs these tests faster)
torch.set_num_threads(1)

BATCH, L = 4, 16


def jax_perms(rng, n_epochs, capacity):
    """The permutations the JAX trainer draws from ``rng``
    (core/training.py:205-206, 228): [n_epochs, capacity]."""
    return np.stack([
        np.asarray(jax.random.permutation(jax.random.split(er)[0], capacity))
        for er in jax.random.split(rng, n_epochs)
    ])


def client_data(seed, capacity, n):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, capacity)
    data = {"x": rng.integers(0, 128, (capacity, L)).astype(np.int32),
            "attn_mask": (np.arange(L)[None] < lengths[:, None]).astype(np.float32),
            "y": rng.integers(0, 4, capacity).astype(np.int32)}
    for v in data.values():
        v[n:] = 0  # padding rows are zeros, as stack_client_datasets makes them
    return data


@pytest.fixture(scope="module")
def models():
    jmodel = jax_bert(JaxBertConfig.tiny())
    jparams = jmodel.init(jax.random.key(0))
    state = jax_to_state(jparams)
    template = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    return jmodel, jparams, bert_classifier_model(BertConfig.tiny()), \
        state_dict_to_params(template, state, device="cpu")


def _run_both(models, capacity, n, n_epochs):
    jmodel, jparams, tmodel, tparams = models
    data = client_data(1, capacity, n)
    rng = jax.random.key(2)
    jp, _, jloss = jax_trainer(jmodel, batch_size=BATCH, learning_rate=0.05).train(
        jparams, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(n), rng,
        n_epochs)
    perm = torch.from_numpy(jax_perms(rng, n_epochs, capacity))
    tp, tloss = make_local_trainer(tmodel, batch_size=BATCH, learning_rate=0.05).train(
        tparams, {k: torch.from_numpy(v) for k, v in data.items()}, n, n_epochs, perm=perm)
    return jax_to_state(jp), tp, np.asarray(jloss), tloss.numpy()


@pytest.mark.parametrize("capacity,n,n_epochs,tol", [
    (BATCH, 3, 1, 1e-6),      # one SGD step
    (3 * BATCH, 10, 1, 1e-5),  # one epoch of three steps, a ragged last batch
])
def test_matches_jax_trainer(models, capacity, n, n_epochs, tol):
    jstate, tp, jloss, tloss = _run_both(models, capacity, n, n_epochs)
    np.testing.assert_allclose(tloss, jloss, rtol=tol, atol=tol)
    for name, want in jstate.items():
        np.testing.assert_allclose(tp[name].numpy(), want, rtol=tol, atol=tol,
                                   err_msg=name)


def test_zero_sample_client_is_exact_noop(models):
    _, _, tmodel, tparams = models
    data = {k: torch.from_numpy(v) for k, v in client_data(3, 2 * BATCH, 0).items()}
    tp, tloss = make_local_trainer(tmodel, batch_size=BATCH, learning_rate=0.05).train(
        tparams, data, 0, 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tloss, torch.zeros(2))
    for name, v in tparams.items():
        assert torch.equal(tp[name], v), name


def test_capacity_must_divide_into_batches(models):
    _, _, tmodel, tparams = models
    data = {k: torch.from_numpy(v) for k, v in client_data(4, 6, 6).items()}
    with pytest.raises(ValueError):
        make_local_trainer(tmodel, batch_size=BATCH).train(tparams, data, 6)
