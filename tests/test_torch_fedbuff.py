"""The port's ``FedBuff`` against the JAX package's, on the cases of
``tests/test_fedbuff.py`` that run on one device: the same clients
(numpy seed 0), the same initial weights, and each step's permutations
from JAX's key chain (``rng, sub = split(rng)``; ``split(sub, K)``).

A zero-staleness step equals the closed-form weighted delta mean (1e-5,
float64 oracle) and JAX's step (1e-5); staleness follows the queue
(0.5 over two steps); async training converges under staleness, the
default ``server_lr`` tames overlap where 1.0 diverges, FedProx anchors
each client at its own stale start, a trainable head leaves the frozen
leaves bit-equal (the reference's LoRA case, on a partition), and 64
clients in flight over a cohort of 16 keep the queue's staleness. Every
multi-step run agrees with JAX's within the reference's 5e-2 band. The
2-layer BERT case is in ``test_torch_variants_bert.py``, the guards in
``test_torch_port_rules.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.core.regularizers import fedprox as jax_fedprox
from baton_tpu.models.linear import linear_regression_model as jax_linear
from baton_tpu.models.mlp import mlp_classifier_model as jax_mlp
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.parallel.fedbuff import FedBuff as JaxFedBuff
from baton_tpu_torch import FedSim
from baton_tpu_torch.core.regularizers import fedprox
from baton_tpu_torch.data.synthetic import DEMO_COEF, linear_client_data
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel import FedBuff
from _torch_variants import BAND, assert_params_close, fedbuff_perms, jax_round_perms, to_port

torch.set_num_threads(1)


def _cohort(n_clients, **kw):
    nprng = np.random.default_rng(0)
    return stack_client_datasets([linear_client_data(nprng, **kw) for _ in range(n_clients)],
                                 batch_size=32)


@pytest.fixture(scope="module")
def setup():
    data, n_samples = _cohort(6, min_batches=2, max_batches=3)
    jparams = JaxFedSim(jax_linear(10), batch_size=32).init(jax.random.key(0))
    return data, n_samples, jparams


def _both(data, n_samples, jparams, key, n_steps, n_epochs=1, jax_sim_kw=None,
          port_sim_kw=None, model=("linear",), batch_size=32, learning_rate=0.02, **fb_kw):
    """The same FedBuff run in both packages: (port result, JAX result)."""
    if model[0] == "linear":
        jmodel, tmodel = jax_linear(10), linear_regression_model(10)
    else:
        jmodel, tmodel = jax_mlp(*model[1:]), mlp_classifier_model(*model[1:])
    jsim = JaxFedSim(jmodel, batch_size=batch_size, learning_rate=learning_rate,
                     **(jax_sim_kw or {}))
    sim = FedSim(tmodel, batch_size=batch_size, learning_rate=learning_rate, device="cpu",
                 **(port_sim_kw or {}))
    fb = FedBuff(sim, **fb_kw)
    perms = fedbuff_perms(key, n_steps, fb.buffer_size, n_epochs, data["x"].shape[1])
    res = fb.run(to_port(jparams), data, n_samples, n_steps=n_steps, n_epochs=n_epochs,
                 perms=perms)
    jres = JaxFedBuff(jsim, **fb_kw).run(
        jparams, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(n_samples), key,
        n_steps=n_steps, n_epochs=n_epochs)
    assert res.version == jres.version == n_steps
    assert res.mean_staleness == jres.mean_staleness
    return res, jres


def test_key_chain_perms_equal_the_loop_form():
    """The jitted perms helpers draw what the key chain drawn op by op
    gives: each step ``rng, sub = split(rng)``, each client
    ``split(sub, K)[c]``, each epoch the first half of its epoch key."""
    def round_loop(rng, k, e, cap):
        return np.stack([
            np.stack([np.asarray(jax.random.permutation(jax.random.split(er)[0], cap))
                      for er in jax.random.split(cr, e)])
            for cr in jax.random.split(rng, k)])

    rng, steps = jax.random.key(9), []
    for _ in range(3):
        rng, sub = jax.random.split(rng)
        steps.append(round_loop(sub, 2, 2, 7))
    np.testing.assert_array_equal(fedbuff_perms(jax.random.key(9), 3, 2, 2, 7).numpy(),
                                  np.stack(steps))
    np.testing.assert_array_equal(jax_round_perms(jax.random.key(9), 3, 2, 7),
                                  round_loop(jax.random.key(9), 3, 2, 7))


def _err(params) -> float:
    return float(np.max(np.abs(np.asarray(params["w"]).ravel() - DEMO_COEF)))


def test_zero_staleness_step_equals_weighted_delta_mean(setup):
    """concurrency == buffer_size == C: every client anchors at the
    current globals, so one step is one synchronous FedAvg round in the
    delta form."""
    data, n_samples, jparams = setup
    c = len(n_samples)
    key = jax.random.key(42)
    res, jres = _both(data, n_samples, jparams, key, 1, n_epochs=2, buffer_size=c,
                      concurrency=c, alpha=0.5)
    assert res.mean_staleness == 0.0
    assert_params_close(res.params, jres.params, 1e-5)
    np.testing.assert_allclose(res.loss_history, jres.loss_history, rtol=1e-5, atol=1e-5)

    # the float64 oracle: each client trained alone from the globals
    params = to_port(jparams)
    trainer = FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.02,
                     device="cpu").trainer
    perms = fedbuff_perms(key, 1, c, 2, data["x"].shape[1])[0]
    num = {k: np.zeros(v.shape) for k, v in params.items()}
    for i in range(c):
        p, _, _ = trainer.train(params, {k: torch.as_tensor(v[i]) for k, v in data.items()},
                                int(n_samples[i]), 2, perm=perms[i])
        for k in num:
            num[k] += float(n_samples[i]) * (p[k].double() - params[k].double()).numpy()
    want = {k: params[k].double().numpy() + num[k] / float(np.sum(n_samples)) for k in num}
    assert_params_close(res.params, want, 1e-5)


@pytest.mark.parametrize("concurrency,staleness", [(4, 0.5), (3, 0.25)])
def test_staleness_emerges_from_overlap(setup, concurrency, staleness):
    """Buffer 2. With 4 in flight the first step's buffer is fresh and
    the second completes clients anchored before step 1: mean staleness
    0.5. With 3, the second step mixes a stale client with a fresh one,
    so the discount weighs them apart: 0.25."""
    res, jres = _both(*setup, jax.random.key(1), 2, buffer_size=2, concurrency=concurrency,
                      alpha=0.5)
    assert res.mean_staleness == staleness
    assert_params_close(res.params, jres.params, 1e-5)


def test_async_training_converges_with_staleness(setup):
    res, jres = _both(*setup, jax.random.key(2), 40, n_epochs=2, buffer_size=2,
                      concurrency=6, alpha=0.5)
    assert res.mean_staleness > 0.5  # genuine overlap happened
    assert _err(res.params) < 1.0
    assert res.loss_history[-1] < res.loss_history[0] * 0.1
    assert_params_close(res.params, jres.params, BAND)
    np.testing.assert_allclose(res.loss_history, jres.loss_history, rtol=BAND, atol=BAND)


def test_default_server_lr_tames_overlap_amplification():
    """8 clients, concurrency 8, buffer 2, client lr 0.02, 2 local epochs:
    full-strength application (server_lr 1.0) diverges where the default
    ``buffer_size / concurrency`` converges."""
    data, n_samples = _cohort(8)
    jparams = JaxFedSim(jax_linear(10), batch_size=32).init(jax.random.key(0))
    kw = dict(buffer_size=2, concurrency=8, alpha=0.5)
    res, jres = _both(data, n_samples, jparams, jax.random.key(1), 60, n_epochs=2, **kw)
    assert _err(res.params) < 0.5 and _err(jres.params) < 0.5
    assert_params_close(res.params, jres.params, BAND)
    # the same shuffles at full strength (JAX's own test holds its run)
    sim = FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.02, device="cpu")
    full = FedBuff(sim, server_lr=1.0, **kw).run(
        to_port(jparams), data, n_samples, n_steps=60, n_epochs=2,
        perms=fedbuff_perms(jax.random.key(1), 60, 2, 2, data["x"].shape[1]))
    assert _err(full.params) > 100.0  # diverged without the damping


def test_fedbuff_with_fedprox_regularizer(setup):
    """Each client's proximal anchor is its own stale start point."""
    res, jres = _both(*setup, jax.random.key(5), 20, n_epochs=2,
                      jax_sim_kw=dict(regularizer=jax_fedprox(mu=0.1)),
                      port_sim_kw=dict(regularizer=fedprox(mu=0.1)), buffer_size=2,
                      concurrency=4)
    assert _err(res.params) < 2.0
    assert_params_close(res.params, jres.params, BAND)


def test_fedbuff_honors_a_trainable_head():
    """The reference's LoRA case on a trainable partition: async training
    moves only the head and leaves every frozen leaf bit-equal."""
    nprng = np.random.default_rng(0)
    datasets = [{"x": nprng.normal(size=(32, 8)).astype(np.float32),
                 "y": nprng.integers(0, 4, size=(32,)).astype(np.int32)} for _ in range(4)]
    data, n_samples = stack_client_datasets(datasets, batch_size=16)

    def head_only(path, leaf):
        return path.startswith("1/")

    jparams = JaxFedSim(jax_mlp(8, (16,), 4), batch_size=16).init(jax.random.key(0))
    res, jres = _both(data, n_samples, jparams, jax.random.key(6), 6,
                      jax_sim_kw=dict(trainable=head_only), port_sim_kw=dict(trainable=head_only),
                      model=("mlp", 8, (16,), 4), batch_size=16, learning_rate=0.05,
                      buffer_size=2, concurrency=4)
    start = to_port(jparams)
    assert list(res.params) == list(start)
    for name, leaf in start.items():
        if head_only(name, leaf):
            assert not torch.equal(res.params[name], leaf), name
        else:
            assert torch.equal(res.params[name], leaf), name
    assert_params_close(res.params, jres.params, BAND)


def test_fedbuff_high_concurrency_64_in_flight():
    """64 clients in flight over a cohort of 16 on one device: the first
    flush is fresh, and once the pipe is full every flush drains updates
    anchored 64/16 = 4 flushes back."""
    data, n_samples = _cohort(16)
    jparams = JaxFedSim(jax_linear(10), batch_size=32).init(jax.random.key(0))
    res, jres = _both(data, n_samples, jparams, jax.random.key(3), 12, buffer_size=16,
                      concurrency=64, alpha=0.5)
    assert 2.0 < res.mean_staleness < 4.0
    assert res.loss_history[-1] < res.loss_history[0] * 0.5
    assert_params_close(res.params, jres.params, BAND)
