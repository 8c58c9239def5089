"""``FedSim.run_rounds_fused`` of the port on the CPU, where its round body
runs in a plain loop (the CUDA graph is the card's: ``chip_smoke.py``
phase 19).

The cases of ``tests/test_fused_rounds.py`` (fused against ``run_rounds``,
waves, a server optimizer, learning), bit-equal on the CPU since both
run the same body on the same draws; the options the body threads
(FedProx's anchor, a trainable part, DP-SGD with noise) bit-equal too;
the robust aggregators refused; the caller's params untouched. Then the
port's fused run against JAX's with one batch a client (the shuffle only
reorders a sum, so JAX's threefry keys need not be reproduced), within
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baton_tpu.models.linear import linear_regression_model as jax_linear
from baton_tpu.models.mlp import mlp_classifier_model as jax_mlp
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu_torch import FedSim
from baton_tpu_torch.core import optim
from baton_tpu_torch.core.regularizers import fedprox
from baton_tpu_torch.data.synthetic import linear_client_data, synthetic_classification_clients
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.ops.privacy import DPConfig
from _torch_variants import assert_params_close, to_port

torch.set_num_threads(1)


def _linear_setup(n_clients=8):
    rng = np.random.default_rng(0)
    datasets = [linear_client_data(rng, min_batches=2, max_batches=3)
                for _ in range(n_clients)]
    return stack_client_datasets(datasets, batch_size=32)


def _assert_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _both(sim, params, data, n, n_rounds, **kw):
    loop = sim.run_rounds(params, data, n, torch.Generator().manual_seed(1),
                          n_rounds=n_rounds, **kw)
    fused = sim.run_rounds_fused(params, data, n, torch.Generator().manual_seed(1),
                                 n_rounds=n_rounds, **kw)
    return loop, fused


def test_fused_matches_loop_vmap():
    data, n = _linear_setup()
    sim = FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.02, device="cpu")
    params = sim.init(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in params.items()}
    (p_loop, h_loop), (p_fused, h_fused) = _both(sim, params, data, n, 4, n_epochs=2)
    _assert_equal(p_loop, p_fused)
    assert h_fused == h_loop and len(h_fused) == 8
    _assert_equal(params, before)  # the caller's params are never mutated
    assert sim.last_fused == {"graph": False, "rounds": 4}


def test_fused_waves_match_single_wave():
    # wave accumulation is associative: 2 waves == 1 wave up to fp32 order
    data, n = _linear_setup()
    sim = FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.02, device="cpu")
    params = sim.init(torch.Generator().manual_seed(0))
    p1, h1 = sim.run_rounds_fused(params, data, n, torch.Generator().manual_seed(1),
                                  n_rounds=2, wave_size=4, donate_buffers=False)
    p2, h2 = sim.run_rounds_fused(params, data, n, torch.Generator().manual_seed(1),
                                  n_rounds=2)
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h1, h2, rtol=1e-5)
    # a short last wave (8 clients in waves of 3) pads with phantoms as run_rounds does
    (p_loop, h_loop), (p_fused, h_fused) = _both(sim, params, data, n, 2, wave_size=3)
    _assert_equal(p_loop, p_fused)
    assert h_fused == h_loop


def test_fused_with_server_optimizer():
    data, n = _linear_setup()
    sim = FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.02,
                 server_optimizer=optim.adam(0.1), device="cpu")
    params = sim.init(torch.Generator().manual_seed(0))
    (p_loop, h_loop, s_loop), (p_fused, h_fused, s_fused) = _both(
        sim, params, data, n, 3, return_server_opt_state=True)
    _assert_equal(p_loop, p_fused)
    assert h_fused == h_loop
    assert int(s_fused["count"]) == int(s_loop["count"]) == 3
    _assert_equal(s_loop["mu"], s_fused["mu"])


@pytest.mark.parametrize("option", ["fedprox", "trainable", "dp"])
def test_fused_threads_each_option_as_run_rounds(option):
    rng = np.random.default_rng(0)
    datasets, _ = synthetic_classification_clients(rng, 4, n_per_client=24, in_dim=8,
                                                   n_classes=3)
    data, n = stack_client_datasets(datasets, batch_size=8)
    kw = {"fedprox": {"regularizer": fedprox(0.1)},
          "trainable": {"trainable": lambda name, leaf: name.startswith("1/")},
          "dp": {"dp": DPConfig(clip_norm=0.5, noise_multiplier=0.7)}}[option]
    sim = FedSim(mlp_classifier_model(8, (16,), 3), batch_size=8, learning_rate=0.1,
                 device="cpu", **kw)
    params = sim.init(torch.Generator().manual_seed(0))
    (p_loop, h_loop), (p_fused, h_fused) = _both(sim, params, data, n, 3, n_epochs=2,
                                                 wave_size=3)
    _assert_equal(p_loop, p_fused)
    assert h_fused == h_loop
    if option == "trainable":
        _assert_equal({k: p_fused[k] for k in ("0/w", "0/b")},
                      {k: params[k] for k in ("0/w", "0/b")})


@pytest.mark.parametrize("aggregator", ["median", "trimmed:0.2"])
def test_fused_refuses_robust_aggregators(aggregator):
    data, n = _linear_setup(4)
    sim = FedSim(linear_regression_model(10), batch_size=32, aggregator=aggregator,
                 device="cpu")
    with pytest.raises(NotImplementedError, match="run_round/run_rounds"):
        sim.run_rounds_fused(sim.init(torch.Generator().manual_seed(0)), data, n,
                             torch.Generator().manual_seed(1), n_rounds=2)


def test_fused_learns_classification():
    rng = np.random.default_rng(0)
    datasets, _ = synthetic_classification_clients(rng, 8)
    data, n = stack_client_datasets(datasets, batch_size=32)
    sim = FedSim(mlp_classifier_model(32, (64,), 10), batch_size=32, learning_rate=0.3,
                 device="cpu")
    params = sim.init(torch.Generator().manual_seed(0))
    params, history = sim.run_rounds_fused(params, data, n, torch.Generator().manual_seed(1),
                                           n_rounds=10, n_epochs=2)
    assert history[-1] < history[0] * 0.5
    assert sim.evaluate_round(params, data, n)["accuracy"] > 0.7


@pytest.mark.parametrize("model", ["linear", "mlp_fedadam"])
def test_fused_against_jax_fused_with_one_batch_a_client(model):
    """One batch a client: each epoch's shuffle only reorders the rows of
    one sum, so the port's and JAX's fused runs agree without sharing
    keys (4 rounds of 2 epochs, two waves, within 1e-5)."""
    rng = np.random.default_rng(3)
    sizes = (16, 11, 0, 16, 9)
    if model == "linear":
        datasets = [{"x": rng.normal(size=(s, 6)).astype(np.float32),
                     "y": rng.normal(size=(s,)).astype(np.float32)} for s in sizes]
        jm, tm, kw, jkw = jax_linear(6), linear_regression_model(6), {}, {}
    else:
        datasets = [{"x": rng.normal(size=(s, 6)).astype(np.float32),
                     "y": rng.integers(0, 3, s).astype(np.int32)} for s in sizes]
        jm, tm = jax_mlp(6, (8,), 3), mlp_classifier_model(6, (8,), 3)
        kw = {"server_optimizer": optim.adam(0.05)}
        jkw = {"server_optimizer": optax.adam(0.05)}
    data, n = stack_client_datasets(datasets, batch_size=16)
    assert data["x"].shape[1] == 16  # one batch a client
    jsim = JaxFedSim(jm, batch_size=16, learning_rate=0.05, **jkw)
    jparams = jm.init(jax.random.key(0))
    jp, jh = jsim.run_rounds_fused(jparams, {k: jnp.asarray(v) for k, v in data.items()},
                                   jnp.asarray(n), jax.random.key(1), n_rounds=4, n_epochs=2,
                                   wave_size=3, donate_buffers=False)
    sim = FedSim(tm, batch_size=16, learning_rate=0.05, device="cpu", **kw)
    p, h = sim.run_rounds_fused(to_port(jparams), data, n, torch.Generator().manual_seed(1),
                                n_rounds=4, n_epochs=2, wave_size=3)
    assert_params_close(p, jp, 1e-5)
    np.testing.assert_allclose(h, jh, rtol=1e-5, atol=1e-6)
