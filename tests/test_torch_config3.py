"""BASELINE config 3 (``examples/03_bert_fedprox.py``) in the port
(``baton_tpu_torch/examples/bert_fedprox.py``) on the CPU: its data equals
the JAX example's (the synthetic topics bit for bit, and the AG-News
loader's synthetic fallback with no files: nothing downloads), its round
agrees with the JAX example's round on the same weights (carried by
``server/state.py`` names) and the shuffles JAX draws from the example's
round key, within 1e-4, and ``run()`` as the example runs it lowers the
loss."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.core.regularizers import fedprox as jax_fedprox
from baton_tpu.models.bert import bert_classifier_model as jax_bert
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu.server.state import state_dict_to_params as jax_from_state
from baton_tpu_torch.examples import bert_fedprox
from baton_tpu_torch.server.state import params_to_state_dict
from _torch_variants import jax_round_perms

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SEED, N_EPOCHS, BATCH, MU = 0, 2, 8, 0.1


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "bert_fedprox_example", ROOT / "examples" / "03_bert_fedprox.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _assert_same_shards(got, want):
    assert len(got) == len(want)
    for d, w in zip(got, want):
        assert d.keys() == w.keys()
        for k in d:
            np.testing.assert_array_equal(d[k], w[k])
            assert d[k].dtype == w[k].dtype


@pytest.mark.parametrize("real_data", [False, True], ids=["topics", "ag_news_fallback"])
def test_data_is_the_examples(real_data, tmp_path):
    example = _jax_example()
    cfg = bert_fedprox.example_config(real_data=real_data)
    jcfg = example.BertConfig.tiny(n_classes=4, vocab_size=cfg.vocab_size)
    if real_data:
        got = bert_fedprox.make_ag_news_data(np.random.default_rng(SEED), cfg, 8, 24,
                                             data_dir=str(tmp_path))
        want = example.make_ag_news_data(np.random.default_rng(SEED), jcfg, 8, 24,
                                         data_dir=str(tmp_path))
    else:
        got = bert_fedprox.make_data(np.random.default_rng(SEED), cfg, 8, 24)
        want = example.make_data(np.random.default_rng(SEED), jcfg, 8, 24)
    _assert_same_shards(got, want)


def test_round_matches_the_jax_example():
    cfg = bert_fedprox.example_config()
    data, n_samples = bert_fedprox.client_data(cfg, 8, 24, BATCH, seed=SEED)
    sim = bert_fedprox.make_sim(cfg, BATCH, MU, device="cpu")
    params = sim.init(torch.Generator().manual_seed(SEED))
    jcfg = _jax_example().BertConfig.tiny(n_classes=4)
    assert (jcfg.vocab_size, jcfg.max_len) == (cfg.vocab_size, cfg.max_len)
    jmodel = jax_bert(jcfg)
    jparams = jax_from_state(jmodel.init(jax.random.key(SEED)), params_to_state_dict(params))
    jsim = JaxFedSim(jmodel, batch_size=BATCH, learning_rate=5e-3, regularizer=jax_fedprox(MU))
    key = jax.random.fold_in(jax.random.key(SEED + 1), 0)  # the example's round 0
    jres = jsim.run_round(jparams, {k: jnp.asarray(v) for k, v in data.items()},
                          jnp.asarray(n_samples), key, n_epochs=N_EPOCHS)
    perms = torch.from_numpy(jax_round_perms(key, len(n_samples), N_EPOCHS, data["x"].shape[1]))
    res = sim.run_round(params, data, n_samples, n_epochs=N_EPOCHS, perms=perms)
    np.testing.assert_allclose(res.loss_history.numpy(), np.asarray(jres.loss_history),
                               rtol=1e-4, atol=1e-4)
    moved = 0.0
    start = params_to_state_dict(params)
    for name, want in jax_to_state(jres.params).items():
        np.testing.assert_allclose(res.params[name].numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        moved = max(moved, float(np.abs(want - start[name]).max()))
    assert moved > 1e-3  # the round moved the params


def test_run_learns():
    history, metrics = bert_fedprox.run(n_rounds=2, device="cpu")
    assert len(history) == 2 * N_EPOCHS and history[-1] < history[0]
    assert 0.0 <= metrics["accuracy"] <= 1.0


def test_run_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert_fedprox.run()
