"""The port's ``ClusteredFedSim`` against the JAX package's, on the cases
of ``tests/test_clustered.py`` that run on one device: clients from two
linear populations with opposite coefficients (numpy seed 0), the same
initial clusters, and the permutations JAX draws from each round's key.

Over 12 rounds K=2 separates the populations and recovers both vectors
while one global model fits neither, in both packages, with the same
assignments and clusters within the reference's 5e-2 band. One round
with K=3 matches JAX (1e-5) and a cluster no client chose keeps its
params bit for bit; identical clusters tie, and every client takes the
first, as JAX's ``argmin`` gives it. The loss grid (a vmap over clients
of a vmap over clusters) equals the losses computed one pair at a time.
The 2-layer BERT case is in ``test_torch_variants_bert.py``, the guards
in ``test_torch_port_rules.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.models.linear import linear_regression_model as jax_linear
from baton_tpu.parallel.clustered import ClusteredFedSim as JaxClusteredFedSim
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu_torch import FedSim
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel import ClusteredFedSim
from baton_tpu_torch.parallel.clustered import _masked_mean_loss
from _torch_variants import BAND, assert_params_close, round_perms, to_port

torch.set_num_threads(1)

COEF_A = np.array([5, -3, 2, 8, -1, 4, 0, 7, -6, 2], np.float32)
COEF_B = -COEF_A


@pytest.fixture(scope="module")
def setup():
    nprng = np.random.default_rng(0)
    datasets, pops = [], []
    for pop, coef in ((0, COEF_A), (1, COEF_B)):
        for _ in range(4):
            x = nprng.normal(size=(64, 10)).astype(np.float32)
            y = x @ coef + 0.1 * nprng.normal(size=64).astype(np.float32)
            datasets.append({"x": x, "y": y.astype(np.float32)})
            pops.append(pop)
    data, n_samples = stack_client_datasets(datasets, batch_size=32)
    return data, n_samples, np.asarray(pops)


def _sims():
    return (JaxFedSim(jax_linear(10), batch_size=32, learning_rate=0.05),
            FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.05,
                   device="cpu"))


def _jax(data, n_samples):
    return {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(n_samples)


def test_ifca_separates_populations_and_recovers_both(setup):
    data, n_samples, pops = setup
    jdata, jn = _jax(data, n_samples)
    jsim, sim = _sims()
    jcf, cf = JaxClusteredFedSim(jsim, n_clusters=2), ClusteredFedSim(sim, n_clusters=2)
    jclusters = jcf.init_clusters(jax.random.key(0))
    clusters = to_port(jclusters)
    jp = jsim.init(jax.random.key(0))
    p = to_port(jp)
    for r in range(12):
        key = jax.random.fold_in(jax.random.key(1), r)
        perms = round_perms(key, 8, 2, data["x"].shape[1])
        res = cf.run_round(clusters, data, n_samples, n_epochs=2, perms=perms)
        jres = jcf.run_round(jclusters, jdata, jn, key, n_epochs=2)
        np.testing.assert_array_equal(res.assignments, jres.assignments)
        clusters, jclusters = res.cluster_params, jres.cluster_params
        p = sim.run_round(p, data, n_samples, n_epochs=2, perms=perms).params
        jp = jsim.run_round(jp, jdata, jn, key, n_epochs=2).params
    assert_params_close(clusters, jclusters, BAND)
    assert_params_close(p, jp, BAND)

    # the assignments are the populations, up to a label swap
    a = res.assignments
    assert np.all(a == pops) or np.all(a == 1 - pops), (a, pops)
    # both coefficient vectors recovered by their clusters
    w = clusters["w"].numpy().reshape(2, -1)
    k_a = a[0]
    err_a, err_b = np.max(np.abs(w[k_a] - COEF_A)), np.max(np.abs(w[1 - k_a] - COEF_B))
    assert err_a < 0.5 and err_b < 0.5, (err_a, err_b)
    # one global model fits neither population
    w_glob = p["w"].numpy().ravel()
    assert np.max(np.abs(w_glob - COEF_A)) > 2.0 and np.max(np.abs(w_glob - COEF_B)) > 2.0
    # clustered evaluation is far better than the global model's
    loss_cluster = cf.evaluate(clusters, data, n_samples)["loss"]
    loss_global = sim.evaluate_round(p, data, n_samples)["loss"]
    assert loss_cluster < loss_global * 0.1, (loss_cluster, loss_global)
    assert loss_cluster == pytest.approx(jcf.evaluate(jclusters, jdata, jn)["loss"], rel=BAND)


def test_empty_cluster_keeps_params(setup):
    """K=3 over two populations: one round against JAX, and a cluster no
    client chose keeps its previous params bit for bit."""
    data, n_samples, _ = setup
    jsim, sim = _sims()
    jcf, cf = JaxClusteredFedSim(jsim, n_clusters=3), ClusteredFedSim(sim, n_clusters=3)
    jclusters = jcf.init_clusters(jax.random.key(5))
    clusters = to_port(jclusters)
    key = jax.random.key(6)
    res = cf.run_round(clusters, data, n_samples, perms=round_perms(key, 8, 1,
                                                                    data["x"].shape[1]))
    jres = jcf.run_round(jclusters, *_jax(data, n_samples), key)
    np.testing.assert_array_equal(res.assignments, jres.assignments)
    assert_params_close(res.cluster_params, jres.cluster_params, 1e-5)
    np.testing.assert_allclose(res.client_losses.numpy(), np.asarray(jres.client_losses),
                               rtol=1e-5, atol=1e-5)
    for k in set(range(3)) - set(res.assignments.tolist()):
        assert torch.equal(res.cluster_params["w"][k], clusters["w"][k])
        assert torch.equal(res.cluster_params["b"][k], clusters["b"][k])
    assert all(bool(torch.isfinite(v).all()) for v in res.cluster_params.values())


def test_tied_clusters_go_to_the_first(setup):
    """Three identical clusters: every loss ties, every client takes
    cluster 0 (JAX's argmin too), and clusters 1 and 2 stay bit-equal."""
    data, n_samples, _ = setup
    jsim, sim = _sims()
    one = JaxFedSim(jax_linear(10), batch_size=32).init(jax.random.key(2))
    jclusters = jax.tree_util.tree_map(lambda a: jnp.stack([a] * 3), one)
    clusters = to_port(jclusters)
    key = jax.random.key(7)
    res = ClusteredFedSim(sim, n_clusters=3).run_round(
        clusters, data, n_samples, perms=round_perms(key, 8, 1, data["x"].shape[1]))
    jres = JaxClusteredFedSim(jsim, n_clusters=3).run_round(jclusters, *_jax(data, n_samples),
                                                            key)
    assert res.assignments.tolist() == np.asarray(jres.assignments).tolist() == [0] * 8
    for name, v in clusters.items():
        assert torch.equal(res.cluster_params[name][1:], v[1:]), name
    assert_params_close(res.cluster_params, jres.cluster_params, 1e-5)


def test_loss_grid_equals_pairs_one_at_a_time(setup):
    data, n_samples, _ = setup
    cf = ClusteredFedSim(_sims()[1], n_clusters=3)
    clusters = cf.init_clusters(torch.Generator().manual_seed(0))
    tdata = {k: torch.as_tensor(v) for k, v in data.items()}
    n = torch.as_tensor(n_samples)
    grid = cf.loss_grid(clusters, tdata, n)
    assert grid.shape == (8, 3)
    with torch.no_grad():
        want = torch.stack([torch.stack([
            _masked_mean_loss(cf.sim.model, {k: v[j] for k, v in clusters.items()},
                              {k: v[i] for k, v in tdata.items()}, n[i])
            for j in range(3)]) for i in range(8)])
    torch.testing.assert_close(grid, want, rtol=1e-6, atol=1e-6)
