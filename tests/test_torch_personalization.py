"""The port's ``FedPer`` against the JAX package's, on the cases of
``tests/test_personalization.py`` that run on one device: the same
label-permuted MLP clients (numpy seed 0), the same initial weights, and
the permutations JAX draws from each round's key.

One round: the personal stack and the params equal JAX's (1e-5), the
shared leaves equal the engine's FedAvg on the same shuffles (1e-6), and
each client's personal row equals that client's trained head (1e-6);
the heads differ between clients and the stack threads into a second
round. Over 8 rounds the personal heads beat the global model in both
packages (within the reference's 5e-2 band of each other). FedProx and
the median aggregator with zero-sample clients match JAX (1e-5). The
2-layer BERT case is in ``test_torch_variants_bert.py``, the guards in
``test_torch_port_rules.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.core.regularizers import fedprox as jax_fedprox
from baton_tpu.models.mlp import mlp_classifier_model as jax_mlp
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.parallel.personalization import FedPer as JaxFedPer
from baton_tpu_torch import FedSim
from baton_tpu_torch.core.regularizers import fedprox
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel import FedPer
from _torch_variants import BAND, assert_params_close, round_perms, to_port

torch.set_num_threads(1)


def _head(path, leaf):
    """Personal predicate: the final layer ("1/w", "1/b")."""
    return path.startswith("1/")


@pytest.fixture(scope="module")
def setup():
    """Same features everywhere, but each client permutes the label
    space: one global head cannot fit all clients, a personal one fits
    each."""
    nprng = np.random.default_rng(0)
    protos = nprng.normal(size=(4, 8)).astype(np.float32) * 3.0
    datasets = []
    for _ in range(4):
        perm = nprng.permutation(4)
        y_true = nprng.integers(0, 4, size=48).astype(np.int32)
        x = protos[y_true] + 0.3 * nprng.normal(size=(48, 8)).astype(np.float32)
        datasets.append({"x": x, "y": perm[y_true].astype(np.int32)})
    data, n_samples = stack_client_datasets(datasets, batch_size=16)
    jparams = JaxFedSim(jax_mlp(8, (16,), 4), batch_size=16).init(jax.random.key(0))
    return data, n_samples, jparams


def _sims(aggregator="mean", jax_kw=None, port_kw=None):
    return (JaxFedSim(jax_mlp(8, (16,), 4), batch_size=16, learning_rate=0.1,
                      aggregator=aggregator, **(jax_kw or {})),
            FedSim(mlp_classifier_model(8, (16,), 4), batch_size=16, learning_rate=0.1,
                   aggregator=aggregator, device="cpu", **(port_kw or {})))


def _jax(data, n_samples):
    return {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(n_samples)


def _round_both(fp, jfp, params, pers, jparams, jpers, data, n_samples, key, n_epochs=2,
                tol=1e-5):
    """One round in both packages; the port's result after holding it to
    JAX's within ``tol``."""
    res = fp.run_round(params, pers, data, n_samples, n_epochs=n_epochs,
                       perms=round_perms(key, len(n_samples), n_epochs, data["x"].shape[1]))
    jres = jfp.run_round(jparams, jpers, *_jax(data, n_samples), key, n_epochs=n_epochs)
    assert_params_close(res.params, jres.params, tol)
    assert_params_close(res.personal_state,
                        dict(zip(jfp.partition.trainable_paths, jres.personal_state)), tol)
    np.testing.assert_allclose(res.loss_history.numpy(), np.asarray(jres.loss_history),
                               rtol=tol, atol=tol)
    return res, jres


def test_personal_leaves_diverge_shared_leaves_agree(setup):
    data, n_samples, jparams = setup
    jsim, sim = _sims()
    fp, jfp = FedPer(sim, personal=_head), JaxFedPer(jsim, personal=_head)
    params = to_port(jparams)
    key = jax.random.key(1)
    res, jres = _round_both(fp, jfp, params, None, jparams, None, data, n_samples, key)
    head_w = res.personal_state["1/w"]
    assert head_w.shape == (4, 16, 4)
    assert not torch.allclose(head_w[0], head_w[1])

    # the shared leaves are the engine's FedAvg; each personal row is that
    # client's own trained head
    perms = round_perms(key, 4, 2, data["x"].shape[1])
    engine = sim.run_round(params, data, n_samples, n_epochs=2, perms=perms)
    trained, _ = sim.trainer.train_clients(params, {k: torch.as_tensor(v) for k, v in
                                                    data.items()},
                                           torch.as_tensor(n_samples), 2, perms)
    for name in params:
        if _head(name, None):
            torch.testing.assert_close(res.personal_state[name], trained[name], rtol=1e-6,
                                       atol=1e-6)
        else:
            torch.testing.assert_close(res.params[name], engine.params[name], rtol=1e-6,
                                       atol=1e-6)

    # the stack threads into the next round
    res2, _ = _round_both(fp, jfp, res.params, res.personal_state, jres.params,
                          jres.personal_state, data, n_samples, jax.random.key(2), tol=BAND)
    assert np.isfinite(float(res2.loss_history[-1]))
    assert res2.loss_history[-1] < res.loss_history[0]


def test_personalized_head_beats_global_on_permuted_labels(setup):
    """Global FedAvg accuracy stays near chance (the heads average to
    mush); FedPer's heads fit their own shards."""
    data, n_samples, jparams = setup
    jsim, sim = _sims()
    jdata, jn = _jax(data, n_samples)
    fp, jfp = FedPer(sim, personal=_head), JaxFedPer(jsim, personal=_head)
    p_glob, jp_glob = to_port(jparams), jparams
    p, pers, jp, jpers = to_port(jparams), None, jparams, None
    for r in range(8):
        key = jax.random.fold_in(jax.random.key(3), r)
        perms = round_perms(key, 4, 2, data["x"].shape[1])
        p_glob = sim.run_round(p_glob, data, n_samples, n_epochs=2, perms=perms).params
        jp_glob = jsim.run_round(jp_glob, jdata, jn, key, n_epochs=2).params
        res = fp.run_round(p, pers, data, n_samples, n_epochs=2, perms=perms)
        jres = jfp.run_round(jp, jpers, jdata, jn, key, n_epochs=2)
        p, pers, jp, jpers = res.params, res.personal_state, jres.params, jres.personal_state
    acc_glob = sim.evaluate_round(p_glob, data, n_samples)["accuracy"]
    acc_pers = fp.evaluate(p, pers, data, n_samples)["accuracy"]
    assert acc_pers > 0.9, acc_pers
    assert acc_pers > acc_glob + 0.25, (acc_pers, acc_glob)
    jeval = jfp.evaluate(jp, jpers, jdata, jn)
    assert acc_pers == pytest.approx(jeval["accuracy"], abs=BAND)
    assert fp.evaluate(p, pers, data, n_samples)["n"] == jeval["n"] == float(n_samples.sum())
    assert_params_close(p, jp, BAND)
    assert_params_close(pers, dict(zip(jfp.partition.trainable_paths, jpers)), BAND)
    assert_params_close(p_glob, jp_glob, BAND)


def test_fedper_with_fedprox_regularizer(setup):
    data, n_samples, jparams = setup
    jsim, sim = _sims(jax_kw=dict(regularizer=jax_fedprox(mu=0.05)),
                      port_kw=dict(regularizer=fedprox(mu=0.05)))
    res, _ = _round_both(FedPer(sim, personal=_head), JaxFedPer(jsim, personal=_head),
                         to_port(jparams), None, jparams, None, data, n_samples,
                         jax.random.key(9))
    assert np.isfinite(float(res.loss_history[-1]))


def test_fedper_robust_excludes_zero_sample_clients(setup):
    """A median round with half the cohort at n_samples 0 aggregates the
    real participants only: the shared leaves move."""
    data, n_samples, jparams = setup
    jsim, sim = _sims(aggregator="median")
    n0 = np.asarray(n_samples).copy()
    n0[2:] = 0
    params = to_port(jparams)
    res, _ = _round_both(FedPer(sim, personal=_head), JaxFedPer(jsim, personal=_head),
                         params, None, jparams, None, data, n0, jax.random.key(4))
    assert any(not torch.allclose(res.params[k], params[k]) for k in params
               if not _head(k, None))
