"""The port's FedSim round against JAX's on BERT-tiny: three clients, one
with zero samples, the same weights and the permutations JAX draws from
the round key (rebuilt as engine.py:490 and training.py:205-206, 228 draw
them). Params 1e-4, loss 1e-5. The same for the robust aggregators
(median, trimmed mean) on five clients, and for a tiny ResNet under each
conv lowering. Waves and the FedAvg formula are held against the port's
own one-wave round and numpy; each round leaves a valid compute record."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.models.bert import BertConfig as JaxBertConfig
from baton_tpu.models.bert import bert_classifier_model as jax_bert
from baton_tpu.models.resnet import resnet_model as jax_resnet
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu_torch import FedSim
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.models.resnet import resnet_model
from baton_tpu_torch.obs.compute import validate_record
from baton_tpu_torch.ops.aggregation import weighted_tree_mean
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.server.state import state_dict_to_params
from _torch_variants import jax_round_perms

IMPLS = ("direct", "im2col", "shift")

# small shapes: one thread each keeps the parallel test workers from
# oversubscribing the cores (and runs these tests faster)
torch.set_num_threads(1)

BATCH, L, EPOCHS = 4, 16, 2
SIZES = (7, 0, 8)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    datasets = []
    for n in SIZES:
        lengths = rng.integers(1, L + 1, n)
        datasets.append({
            "x": rng.integers(0, 128, (n, L)).astype(np.int32),
            "attn_mask": (np.arange(L)[None] < lengths[:, None]).astype(np.float32),
            "y": rng.integers(0, 4, n).astype(np.int32),
        })
    data, n_samples = stack_client_datasets(datasets, batch_size=BATCH)
    jmodel = jax_bert(JaxBertConfig.tiny())
    jparams = jmodel.init(jax.random.key(0))
    state = jax_to_state(jparams)
    template = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    tparams = state_dict_to_params(template, state, device="cpu")
    sim = FedSim(bert_classifier_model(BertConfig.tiny()), batch_size=BATCH,
                 learning_rate=0.05, device="cpu")
    return data, n_samples, jmodel, jparams, sim, tparams


def test_round_matches_jax(setup):
    data, n_samples, jmodel, jparams, sim, tparams = setup
    key = jax.random.key(1)
    jsim = JaxFedSim(jmodel, batch_size=BATCH, learning_rate=0.05)
    jres = jsim.run_round(jparams, {k: jnp.asarray(v) for k, v in data.items()},
                          jnp.asarray(n_samples), key, n_epochs=EPOCHS)
    perms = torch.from_numpy(jax_round_perms(key, len(SIZES), EPOCHS, data["x"].shape[1]))
    res = sim.run_round(tparams, data, n_samples, n_epochs=EPOCHS, perms=perms)

    np.testing.assert_allclose(res.loss_history.numpy(), np.asarray(jres.loss_history),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.client_losses.numpy(), np.asarray(jres.client_losses),
                               rtol=1e-5, atol=1e-5)
    assert float(res.n_samples_total) == float(jres.n_samples_total) == sum(SIZES)
    for name, want in jax_to_state(jres.params).items():
        np.testing.assert_allclose(res.params[name].numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    jeval = jsim.evaluate_round(jres.params, {k: jnp.asarray(v) for k, v in data.items()},
                                jnp.asarray(n_samples))
    teval = sim.evaluate_round(res.params, data, n_samples)
    assert teval["n"] == jeval["n"]
    np.testing.assert_allclose(teval["loss"], jeval["loss"], rtol=1e-4, atol=1e-4)
    assert teval["accuracy"] == pytest.approx(jeval["accuracy"])


def test_waves_of_two_equal_one_wave(setup):
    data, n_samples, _, _, sim, tparams = setup
    perms = torch.stack([torch.stack([torch.randperm(8, generator=torch.Generator()
                                                     .manual_seed(10 * c + e))
                                      for e in range(EPOCHS)]) for c in range(len(SIZES))])
    one = sim.run_round(tparams, data, n_samples, n_epochs=EPOCHS, perms=perms)
    waves = sim.run_round(tparams, data, n_samples, n_epochs=EPOCHS, perms=perms,
                          wave_size=2)
    torch.testing.assert_close(waves.loss_history, one.loss_history, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(waves.client_losses, one.client_losses, rtol=0, atol=0)
    for name in tparams:
        torch.testing.assert_close(waves.params[name], one.params[name],
                                   rtol=1e-6, atol=1e-6)


def test_aggregate_is_the_weighted_mean_formula(setup):
    data, n_samples, _, _, sim, tparams = setup
    perms = torch.zeros((len(SIZES), 1, 8), dtype=torch.long) + torch.arange(8)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    client_params, _ = sim.trainer.train_clients(
        tparams, batch, torch.from_numpy(n_samples), 1, perms)
    res = sim.run_round(tparams, data, n_samples, perms=perms)
    w = n_samples.astype(np.float64)
    mean = weighted_tree_mean(client_params, torch.from_numpy(n_samples))
    for name, stacked in client_params.items():
        want = np.tensordot(w, stacked.numpy().astype(np.float64), axes=(0, 0)) / w.sum()
        np.testing.assert_allclose(res.params[name].numpy(), want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(mean[name].numpy(), want, rtol=1e-6, atol=1e-6)


def test_cohort_selection_progress_and_run_rounds(setup):
    data, n_samples, _, _, sim, tparams = setup
    perms = torch.stack([torch.randperm(8, generator=torch.Generator().manual_seed(c))[None]
                         for c in range(2)])
    seen = []
    picked = sim.run_round(tparams, data, n_samples, perms=perms, client_indices=[2, 0],
                           wave_size=1, progress_fn=lambda done, total: seen.append((done, total)))
    sliced = sim.run_round(tparams, {k: v[[2, 0]] for k, v in data.items()},
                           n_samples[[2, 0]], perms=perms)
    assert seen == [(1, 2), (2, 2)]
    assert float(picked.n_samples_total) == SIZES[2] + SIZES[0]
    for name in tparams:
        torch.testing.assert_close(picked.params[name], sliced.params[name],
                                   rtol=1e-6, atol=1e-6)
    params, history = sim.run_rounds(tparams, data, n_samples, torch.Generator().manual_seed(0),
                                     n_rounds=2, n_epochs=EPOCHS)
    assert len(history) == 2 * EPOCHS and all(np.isfinite(history))
    assert set(params) == set(tparams)


def _assert_round_matches(res, jres, n_total):
    np.testing.assert_allclose(res.loss_history.numpy(), np.asarray(jres.loss_history),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.client_losses.numpy(), np.asarray(jres.client_losses),
                               rtol=1e-5, atol=1e-5)
    assert float(res.n_samples_total) == float(jres.n_samples_total) == n_total
    for name, want in jax_to_state(jres.params).items():
        np.testing.assert_allclose(res.params[name].numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("aggregator", ["median", "trimmed:0.25"])
def test_robust_round_matches_jax(setup, aggregator):
    """Five clients, one empty: the four with samples (an even count) are
    combined by the order statistic; the loss stays sample-weighted."""
    _, _, jmodel, jparams, _, tparams = setup
    sizes = (7, 0, 8, 3, 5)
    rng = np.random.default_rng(5)
    datasets = []
    for n in sizes:
        lengths = rng.integers(1, L + 1, n)
        datasets.append({
            "x": rng.integers(0, 128, (n, L)).astype(np.int32),
            "attn_mask": (np.arange(L)[None] < lengths[:, None]).astype(np.float32),
            "y": rng.integers(0, 4, n).astype(np.int32),
        })
    data, n_samples = stack_client_datasets(datasets, batch_size=BATCH)
    key = jax.random.key(2)
    jres = JaxFedSim(jmodel, batch_size=BATCH, learning_rate=0.05, aggregator=aggregator).run_round(
        jparams, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(n_samples), key,
        n_epochs=EPOCHS)
    perms = torch.from_numpy(jax_round_perms(key, len(sizes), EPOCHS, data["x"].shape[1]))
    sim = FedSim(bert_classifier_model(BertConfig.tiny()), batch_size=BATCH,
                 learning_rate=0.05, aggregator=aggregator, device="cpu")
    res = sim.run_round(tparams, data, n_samples, n_epochs=EPOCHS, perms=perms, wave_size=2)
    _assert_round_matches(res, jres, sum(sizes))


@pytest.mark.parametrize("impl", IMPLS)
def test_tiny_resnet_round_matches_jax(impl):
    """A 2-stage ResNet, three clients (one empty), batch 4: every client
    trains on the vmapped per-client convs of ``impl``."""
    sizes = (7, 0, 5)
    rng = np.random.default_rng(6)
    datasets = [{"x": rng.normal(size=(n, 8, 8, 3)).astype(np.float32),
                 "y": rng.integers(0, 10, n).astype(np.int32)} for n in sizes]
    data, n_samples = stack_client_datasets(datasets, batch_size=BATCH)
    kw = dict(blocks_per_stage=(1, 1), n_groups=8, conv_impl=impl, name="resnet_tiny")
    jmodel = jax_resnet(**kw)
    jparams = jmodel.init(jax.random.key(0))
    key = jax.random.key(1)
    jres = JaxFedSim(jmodel, batch_size=BATCH, learning_rate=0.05).run_round(
        jparams, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(n_samples), key)
    state = jax_to_state(jparams)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    perms = torch.from_numpy(jax_round_perms(key, len(sizes), 1, data["x"].shape[1]))
    res = FedSim(resnet_model(**kw), batch_size=BATCH, learning_rate=0.05,
                 device="cpu").run_round(tparams, data, n_samples, perms=perms)
    _assert_round_matches(res, jres, sum(sizes))
    assert max(float((res.params[k] - tparams[k]).abs().max()) for k in tparams) > 1e-3


def test_round_leaves_a_compute_record(setup):
    data, n_samples, _, _, _, tparams = setup
    sim = FedSim(bert_classifier_model(BertConfig.tiny()), batch_size=BATCH, learning_rate=0.05,
                 device="cpu")
    sim.run_round(tparams, data, n_samples, torch.Generator().manual_seed(0))
    first = sim.last_compute
    sim.run_round(tparams, data, n_samples, torch.Generator().manual_seed(1))
    rec = sim.last_compute
    assert validate_record(first) == [] and validate_record(rec) == []
    assert first["cache_hit"] is False and rec["cache_hit"] is True
    assert rec["device_kind"] == "cpu" and rec["steps"] == len(SIZES) * 2
    assert rec["samples_per_sec"] == pytest.approx(sum(SIZES) / rec["train_s"], rel=1e-3)
    assert rec["mfu"] is None and rec["mfu_reason"]  # no FLOPs accounting for BERT
    assert rec["peak_hbm_gb"] is None and "cpu" in rec["peak_hbm_gb_reason"]


def test_a_failing_probe_leaves_no_record_and_the_round_runs(setup, monkeypatch):
    data, n_samples, _, _, sim, tparams = setup

    def broken(**kw):
        raise RuntimeError("probe down")

    monkeypatch.setattr(sim.compute_probe, "record_round", broken)
    res = sim.run_round(tparams, data, n_samples, torch.Generator().manual_seed(0))
    assert sim.last_compute is None
    assert np.isfinite(res.loss_history.numpy()).all()
