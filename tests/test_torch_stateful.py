"""The port's ``StatefulClients`` against the JAX package's, on the cases
of ``tests/test_stateful.py`` that run on one device: the same linear
clients (numpy seed 0), the same initial weights, and the permutations
JAX draws from each round's key. A first round from fresh states equals
the stateless engine round (1e-6) and JAX's (1e-5, params and momentum);
threading momentum over 12 rounds beats per-round resets in both
packages, within the reference's 5e-2 band of each other; a FedOpt
server composes (4 rounds, band). The 2-layer BERT case is in
``test_torch_variants_bert.py``, the guards in
``test_torch_port_rules.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baton_tpu.data.synthetic import linear_client_data
from baton_tpu.models.linear import linear_regression_model as jax_linear
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.parallel.stateful import StatefulClients as JaxStatefulClients
from baton_tpu_torch import FedSim
from baton_tpu_torch.core import optim
from baton_tpu_torch.data.synthetic import DEMO_COEF
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel import StatefulClients
from _torch_variants import BAND, assert_params_close, round_perms, to_port

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    nprng = np.random.default_rng(0)
    datasets = [linear_client_data(nprng, min_batches=2, max_batches=3) for _ in range(6)]
    data, n_samples = stack_client_datasets(datasets, batch_size=32)
    jparams = JaxFedSim(jax_linear(10), batch_size=32).init(jax.random.key(0))
    return data, n_samples, jparams


def _jax_data(data, n_samples):
    return {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(n_samples)


def _sims(jax_kw, port_kw):
    return (JaxFedSim(jax_linear(10), batch_size=32, **jax_kw),
            FedSim(linear_regression_model(10), batch_size=32, device="cpu", **port_kw))


def test_first_round_matches_stateless_engine_and_jax(setup):
    data, n_samples, jparams = setup
    jsim, sim = _sims(dict(optimizer=optax.sgd(0.02, momentum=0.9)),
                      dict(optimizer=optim.sgd(0.02, momentum=0.9)))
    key = jax.random.key(7)
    perms = round_perms(key, 6, 2, data["x"].shape[1])
    params = to_port(jparams)
    engine = sim.run_round(params, data, n_samples, n_epochs=2, perms=perms)
    res = StatefulClients(sim).run_round(params, None, data, n_samples, n_epochs=2,
                                         perms=perms)
    for name in params:
        torch.testing.assert_close(res.params[name], engine.params[name], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(res.loss_history, engine.loss_history, rtol=1e-6, atol=0)

    jres = JaxStatefulClients(jsim).run_round(jparams, None, *_jax_data(data, n_samples), key,
                                              n_epochs=2)
    assert_params_close(res.params, jres.params, 1e-5)
    assert_params_close(res.opt_states["trace"], jres.opt_states[0].trace, 1e-5)
    assert res.opt_states["trace"]["w"].shape == (6, 10, 1)
    np.testing.assert_allclose(res.client_losses.numpy(), np.asarray(jres.client_losses),
                               rtol=1e-5, atol=1e-5)


def _run_rounds(setup, n_rounds, n_epochs, jax_kw, port_kw, key_seed, reset=False):
    """``n_rounds`` stateful rounds in both packages from the same
    weights and shuffles, with per-round resets (the engine's
    ``run_round``) alongside when ``reset``; returns the final port and
    JAX results, the reset params of each, and the first round's first
    epoch loss of each."""
    data, n_samples, jparams = setup
    jdata, jn = _jax_data(data, n_samples)
    jsim, sim = _sims(jax_kw, port_kw)
    jsc, sc = JaxStatefulClients(jsim), StatefulClients(sim)
    p, opt, sos = to_port(jparams), None, None
    jp, jopt, jsos = jparams, None, None
    p_reset, jp_reset = p, jparams
    first = None
    for r in range(n_rounds):
        key = jax.random.fold_in(jax.random.key(key_seed), r)
        perms = round_perms(key, 6, n_epochs, data["x"].shape[1])
        res = sc.run_round(p, opt, data, n_samples, n_epochs=n_epochs, perms=perms,
                           server_opt_state=sos)
        jres = jsc.run_round(jp, jopt, jdata, jn, key, n_epochs=n_epochs, server_opt_state=jsos)
        p, opt, sos = res.params, res.opt_states, res.server_opt_state
        jp, jopt, jsos = jres.params, jres.opt_states, jres.server_opt_state
        if first is None:
            first = (float(res.loss_history[0]), float(jres.loss_history[0]))
        if reset:
            p_reset = sim.run_round(p_reset, data, n_samples, n_epochs=n_epochs,
                                    perms=perms).params
            jp_reset = jsim.run_round(jp_reset, jdata, jn, key, n_epochs=n_epochs).params
    return res, jres, p_reset, jp_reset, first


def test_threaded_momentum_differs_from_reset_and_converges(setup):
    kw = (dict(optimizer=optax.sgd(0.01, momentum=0.9)),
          dict(optimizer=optim.sgd(0.01, momentum=0.9)))
    # 12 rounds: momentum overshoots around rounds 6-8 before settling
    # well under the reset trajectory (the reference's reading)
    res, jres, p_reset, jp_reset, _ = _run_rounds(setup, 12, 1, *kw, key_seed=1, reset=True)
    for state, reset in ((res.params, p_reset), (to_port(jres.params), to_port(jp_reset))):
        w_state, w_reset = state["w"].numpy().ravel(), reset["w"].numpy().ravel()
        assert not np.allclose(w_state, w_reset)  # the state genuinely threads
        err_state = float(np.max(np.abs(w_state - DEMO_COEF)))
        err_reset = float(np.max(np.abs(w_reset - DEMO_COEF)))
        assert err_state < err_reset and err_state < 2.0, (err_state, err_reset)
    assert_params_close(res.params, jres.params, BAND)
    assert_params_close(p_reset, jp_reset, BAND)


def test_composes_with_fedopt_server_optimizer(setup):
    res, jres, _, _, first = _run_rounds(
        setup, 4, 2, dict(learning_rate=0.02, server_optimizer=optax.sgd(1.0, momentum=0.5)),
        dict(learning_rate=0.02, server_optimizer=optim.sgd(1.0, momentum=0.5)), key_seed=2)
    assert set(res.server_opt_state) == {"trace"}
    assert float(res.loss_history[-1]) < first[0] * 0.2
    assert float(jres.loss_history[-1]) < first[1] * 0.2
    np.testing.assert_allclose(res.loss_history.numpy(), np.asarray(jres.loss_history),
                               rtol=BAND, atol=BAND)
    assert_params_close(res.params, jres.params, BAND)
    assert_params_close(res.server_opt_state["trace"], jres.server_opt_state[0].trace, BAND)
