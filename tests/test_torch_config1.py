"""BASELINE config 1 (``examples/01_cnn_mnist_fedavg.py``) in the port
(``baton_tpu_torch/examples/cnn_mnist_fedavg.py``) on the CPU: its round
against the JAX example's round on the same synthetic-fallback MNIST
(``load_mnist(fallback="synthetic")`` with no files: nothing downloads),
the same weights (carried by ``server/state.py`` names) and the shuffles
JAX draws from the example's round key, within 1e-4; and ``run()`` as
the example runs it, stopped and resumed."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baton_tpu.models.cnn import cnn_mnist_model as jax_cnn
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu.server.state import state_dict_to_params as jax_from_state
from baton_tpu_torch.examples import cnn_mnist_fedavg as config1
from baton_tpu_torch.server.state import params_to_state_dict
from _torch_variants import jax_round_perms

torch.set_num_threads(2)

SEED, N_EPOCHS = 0, 2


@pytest.fixture(scope="module")
def mnist_fallback(tmp_path_factory):
    """The example's client data from the synthetic fallback (an empty
    ``data_dir``)."""
    empty = tmp_path_factory.mktemp("no_mnist_here")
    return config1.client_data(seed=SEED, data_dir=str(empty), real_data=True)


def test_round_matches_the_jax_example(mnist_fallback):
    data, n_samples = mnist_fallback
    assert data["x"].shape == (4, 64, 28, 28, 1) and list(n_samples) == [64] * 4
    sim = config1.make_sim(device="cpu")
    params = sim.init(torch.Generator().manual_seed(SEED))
    jmodel = jax_cnn()
    jparams = jax_from_state(jmodel.init(jax.random.key(SEED)), params_to_state_dict(params))
    jsim = JaxFedSim(jmodel, batch_size=32, optimizer=optax.sgd(0.01, momentum=0.9))
    # the example's round 0 key
    key = jax.random.fold_in(jax.random.key(SEED + 1), 0)
    jres = jsim.run_round(jparams, {k: jnp.asarray(v) for k, v in data.items()},
                          jnp.asarray(n_samples), key, n_epochs=N_EPOCHS)
    perms = torch.from_numpy(jax_round_perms(key, 4, N_EPOCHS, data["x"].shape[1]))
    res = sim.run_round(params, data, n_samples, n_epochs=N_EPOCHS, perms=perms)
    np.testing.assert_allclose(res.loss_history.numpy(), np.asarray(jres.loss_history),
                               rtol=1e-4, atol=1e-4)
    moved = 0.0
    for name, want in jax_to_state(jres.params).items():
        np.testing.assert_allclose(res.params[name].numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        moved = max(moved, float(np.abs(want - params_to_state_dict(params)[name]).max()))
    assert moved > 1e-3  # the round moved the params


def test_run_learns_and_resumes(tmp_path):
    """``run()`` as the example runs it by default (4 rounds of 2 epochs on
    its synthetic clients) passes the example's own accuracy bar; the same
    run stopped after 2 rounds and resumed from its checkpoints ends on
    the same params, to the bit."""
    whole = config1.run(device="cpu")
    assert whole["accuracy"] > 0.5, "the example should learn the class prototypes"
    assert len(whole["loss_history"]) == 4 * N_EPOCHS
    config1.run(n_rounds=2, checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    resumed = config1.run(checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    assert resumed["loss_history"] == whole["loss_history"]
    for name, want in whole["params"].items():
        assert torch.equal(resumed["params"][name], want), name
