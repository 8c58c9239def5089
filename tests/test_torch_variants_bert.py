"""The four federation variants of the port on a 2-layer narrow BERT
(``BertConfig.tiny``) against the JAX package's: three clients (one
without samples), the same weights and the permutations JAX draws from
each key. The attention runs through the flash wrappers (their plain
versions on the CPU), under one vmap in training and two in the
clustered loss grid.

Stateful clients with local Adam over two rounds (params 1e-5 then 1e-4,
the moments 1e-4, the per-client count); FedBuff with FedProx over two
steps, each client anchored at its own stale start (1e-4); FedPer with
the pooler and the head personal (1e-5); clustered FL with K=2 (1e-5,
and the loss grid equal to the pairs taken one at a time)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baton_tpu.core.regularizers import fedprox as jax_fedprox
from baton_tpu.models.bert import BertConfig as JaxBertConfig
from baton_tpu.models.bert import bert_classifier_model as jax_bert
from baton_tpu.parallel.clustered import ClusteredFedSim as JaxClusteredFedSim
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.parallel.fedbuff import FedBuff as JaxFedBuff
from baton_tpu.parallel.personalization import FedPer as JaxFedPer
from baton_tpu.parallel.stateful import StatefulClients as JaxStatefulClients
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu.server.state import state_dict_to_params as jax_from_state
from baton_tpu_torch import FedSim
from baton_tpu_torch.core import optim
from baton_tpu_torch.core.regularizers import fedprox
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel import ClusteredFedSim, FedBuff, FedPer, StatefulClients
from baton_tpu_torch.parallel.clustered import _masked_mean_loss
from baton_tpu_torch.server.state import params_to_state_dict
from _torch_variants import assert_params_close, fedbuff_perms, round_perms, to_port

torch.set_num_threads(1)

BATCH, L, LR = 4, 16, 0.05
SIZES = (7, 0, 8)


def _personal(path, leaf):
    return path.startswith(("pooler/", "head/"))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    datasets = []
    for n in SIZES:
        lengths = rng.integers(1, L + 1, n)
        datasets.append({
            "x": rng.integers(0, 128, (n, L)).astype(np.int32),
            "attn_mask": (np.arange(L)[None] < lengths[:, None]).astype(np.float32),
            "y": rng.integers(0, 4, n).astype(np.int32)})
    data, n_samples = stack_client_datasets(datasets, batch_size=BATCH)
    # the port draws the weights (JAX's init would run op by op here);
    # JAX takes them through its state bridge
    tmodel, jmodel = bert_classifier_model(BertConfig.tiny()), jax_bert(JaxBertConfig.tiny())
    jparams = jax_from_state(jax.eval_shape(jmodel.init, jax.random.key(0)),
                             params_to_state_dict(tmodel.init(torch.Generator().manual_seed(0))))
    jdata = ({k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(n_samples))
    return data, n_samples, jdata, jmodel, jparams, tmodel


def _sims(setup, jax_kw=None, port_kw=None):
    jmodel, tmodel = setup[3], setup[5]
    return (JaxFedSim(jmodel, batch_size=BATCH, learning_rate=LR, **(jax_kw or {})),
            FedSim(tmodel, batch_size=BATCH, learning_rate=LR, device="cpu", **(port_kw or {})))


def _perms(setup, key, n_epochs=1):
    return round_perms(key, len(SIZES), n_epochs, setup[0]["x"].shape[1])


def test_stateful_local_adam_two_rounds(setup):
    data, n_samples, jdata, _, jparams, _ = setup
    jsim, sim = _sims(setup, dict(optimizer=optax.adam(1e-3)), dict(optimizer=optim.adam(1e-3)))
    jsc, sc = JaxStatefulClients(jsim), StatefulClients(sim)
    p, opt, jp, jopt = to_port(jparams), None, jparams, None
    for r, tol in enumerate((1e-5, 1e-4)):
        key = jax.random.key(10 + r)
        res = sc.run_round(p, opt, data, n_samples, perms=_perms(setup, key))
        jres = jsc.run_round(jp, jopt, *jdata, key)
        p, opt, jp, jopt = res.params, res.opt_states, jres.params, jres.opt_states
        assert_params_close(p, jp, tol)
        np.testing.assert_allclose(res.loss_history.numpy(), np.asarray(jres.loss_history),
                                   rtol=1e-5, atol=1e-5)
    adam = jopt[0]
    assert opt["count"].dtype == torch.int32
    assert opt["count"].tolist() == np.asarray(adam.count).tolist() == [4, 0, 4]
    for field in ("mu", "nu"):
        assert_params_close(opt[field], jax_to_state(getattr(adam, field)), 1e-4)


def test_fedbuff_fedprox_two_steps(setup):
    data, n_samples, jdata, _, jparams, _ = setup
    jsim, sim = _sims(setup, dict(regularizer=jax_fedprox(0.1)), dict(regularizer=fedprox(0.1)))
    kw = dict(buffer_size=2, concurrency=3, alpha=0.5)
    key = jax.random.key(3)
    res = FedBuff(sim, **kw).run(to_port(jparams), data, n_samples, n_steps=2,
                                 perms=fedbuff_perms(key, 2, 2, 1, data["x"].shape[1]))
    jres = JaxFedBuff(jsim, **kw).run(jparams, *jdata, key, n_steps=2)
    # step 1 completes clients 0 and 1 (fresh), step 2 clients 2 and 0
    # (client 2 anchored before step 1)
    assert res.mean_staleness == jres.mean_staleness == 0.25
    assert_params_close(res.params, jres.params, 1e-4)
    np.testing.assert_allclose(res.loss_history, jres.loss_history, rtol=1e-5, atol=1e-5)


def test_fedper_pooler_and_head_personal(setup):
    data, n_samples, jdata, _, jparams, _ = setup
    jsim, sim = _sims(setup)
    fp, jfp = FedPer(sim, personal=_personal), JaxFedPer(jsim, personal=_personal)
    key = jax.random.key(4)
    res = fp.run_round(to_port(jparams), None, data, n_samples, perms=_perms(setup, key))
    jres = jfp.run_round(jparams, None, *jdata, key)
    assert_params_close(res.params, jres.params, 1e-5)
    assert_params_close(res.personal_state,
                        dict(zip(jfp.partition.trainable_paths, jres.personal_state)), 1e-5)
    assert sorted(res.personal_state) == ["head/b", "head/w", "pooler/b", "pooler/w"]
    assert not torch.equal(res.personal_state["head/w"][0], res.personal_state["head/w"][2])
    got = fp.evaluate(res.params, res.personal_state, data, n_samples)
    want = jfp.evaluate(jres.params, jres.personal_state, *jdata)
    assert got == pytest.approx(want, rel=1e-5, abs=1e-5)


def test_clustered_two_clusters(setup):
    data, n_samples, jdata, _, jparams, tmodel = setup
    jsim, sim = _sims(setup)
    jcf, cf = JaxClusteredFedSim(jsim, n_clusters=2), ClusteredFedSim(sim, n_clusters=2)
    clusters = cf.init_clusters(torch.Generator().manual_seed(5))
    jclusters = jax_from_state(jax.eval_shape(jcf.init_clusters, jax.random.key(5)),
                               params_to_state_dict(clusters))
    tdata = {k: torch.as_tensor(v) for k, v in data.items()}
    n = torch.as_tensor(n_samples)
    grid = cf.loss_grid(clusters, tdata, n)
    with torch.no_grad():
        pairs = torch.tensor([[float(_masked_mean_loss(
            tmodel, {k: v[j] for k, v in clusters.items()}, {k: v[i] for k, v in tdata.items()},
            n[i])) for j in range(2)] for i in range(len(SIZES))])
    torch.testing.assert_close(grid, pairs, rtol=1e-5, atol=1e-5)

    key = jax.random.key(6)
    res = cf.run_round(clusters, data, n_samples, perms=_perms(setup, key))
    jres = jcf.run_round(jclusters, *jdata, key)
    np.testing.assert_array_equal(res.assignments, jres.assignments)
    assert res.assignments.tolist() == grid.argmin(dim=1).tolist()
    assert_params_close(res.cluster_params, jres.cluster_params, 1e-5)
    np.testing.assert_allclose(res.client_losses.numpy(), np.asarray(jres.client_losses),
                               rtol=1e-5, atol=1e-5)
    assert cf.evaluate(res.cluster_params, data, n_samples) == pytest.approx(
        jcf.evaluate(jres.cluster_params, *jdata), rel=1e-5, abs=1e-5)
