"""The port's ``FedSim(mesh=make_mesh(8, devices=[cpu] * 8))`` against JAX's
``FedSim(mesh=make_mesh(8))`` on its 8 virtual CPU devices: the same
weights, data and the permutations JAX draws from the round key
(``tests/_torch_variants.py:jax_round_perms``), at the tolerances of
``tests/test_torch_engine.py``: params 1e-4, losses 1e-5. BERT-tiny with
three clients (one empty, padded to 8 on the mesh), both aggregator kinds,
a wave smaller than the cohort, ``evaluate_round`` and ``evaluate_clients``;
the tiny ResNet. Then the port's mesh against its own meshless path
(``run_rounds``, ``run_rounds_fused``, ``wave_size="auto"``, the wave
sizer's per-shard probe with DP noise rows), a shard's DP noise rows (the
rows of the wave's draw, owning their memory), and the meshes FedSim
refuses: none with a ``model`` axis inside a process any more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.models.bert import BertConfig as JaxBertConfig
from baton_tpu.models.bert import bert_classifier_model as jax_bert
from baton_tpu.models.resnet import resnet_model as jax_resnet
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.parallel.mesh import make_mesh as jax_make_mesh
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu_torch import FedSim
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.models.resnet import resnet_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.ops.privacy import DPConfig
from baton_tpu_torch.parallel.mesh import Mesh, make_mesh
from _torch_variants import jax_round_perms, to_port

torch.set_num_threads(1)

BATCH, L, EPOCHS = 4, 16, 2
CPU8 = [torch.device("cpu")] * 8


def _mesh(n=8):
    return make_mesh(n, devices=CPU8[:n])


def _bert_data(sizes, seed):
    rng = np.random.default_rng(seed)
    datasets = []
    for n in sizes:
        lengths = rng.integers(1, L + 1, n)
        datasets.append({
            "x": rng.integers(0, 128, (n, L)).astype(np.int32),
            "attn_mask": (np.arange(L)[None] < lengths[:, None]).astype(np.float32),
            "y": rng.integers(0, 4, n).astype(np.int32),
        })
    return stack_client_datasets(datasets, batch_size=BATCH)


@pytest.fixture(scope="module")
def bert():
    jmodel = jax_bert(JaxBertConfig.tiny())
    jparams = jmodel.init(jax.random.key(0))
    return jmodel, jparams, to_port(jparams)


def _jnp(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _assert_round(res, jres, n_total):
    np.testing.assert_allclose(res.loss_history.numpy(), np.asarray(jres.loss_history),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.client_losses.numpy(), np.asarray(jres.client_losses),
                               rtol=1e-5, atol=1e-5)
    assert float(res.n_samples_total) == float(jres.n_samples_total) == n_total
    for name, want in jax_to_state(jres.params).items():
        np.testing.assert_allclose(res.params[name].numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("aggregator", ["mean", "median", "trimmed:0.25"])
def test_bert_mesh_round_matches_jax(bert, aggregator):
    """Three clients (one empty) padded with five phantoms onto the 8
    shards; the robust rules combine the clients with samples."""
    jmodel, jparams, tparams = bert
    sizes = (7, 0, 8) if aggregator == "mean" else (7, 0, 8, 3, 5)
    data, n_samples = _bert_data(sizes, 0)
    key = jax.random.key(1)
    jsim = JaxFedSim(jmodel, batch_size=BATCH, learning_rate=0.05, aggregator=aggregator,
                     mesh=jax_make_mesh(8))
    jres = jsim.run_round(jparams, _jnp(data), jnp.asarray(n_samples), key, n_epochs=EPOCHS)
    perms = torch.from_numpy(jax_round_perms(key, len(sizes), EPOCHS, data["x"].shape[1]))
    sim = FedSim(bert_classifier_model(BertConfig.tiny()), batch_size=BATCH, learning_rate=0.05,
                 aggregator=aggregator, mesh=_mesh())
    res = sim.run_round(tparams, data, n_samples, n_epochs=EPOCHS, perms=perms)
    _assert_round(res, jres, sum(sizes))
    if aggregator == "mean":
        jeval = jsim.evaluate_round(jres.params, _jnp(data), jnp.asarray(n_samples))
        teval = sim.evaluate_round(res.params, data, n_samples)
        assert teval["n"] == jeval["n"]
        np.testing.assert_allclose(teval["loss"], jeval["loss"], rtol=1e-4, atol=1e-4)
        assert teval["accuracy"] == pytest.approx(jeval["accuracy"])
        jcl = jsim.evaluate_clients(jres.params, _jnp(data), jnp.asarray(n_samples), wave_size=8)
        tcl = sim.evaluate_clients(res.params, data, n_samples, wave_size=3)
        np.testing.assert_allclose(tcl["per_client"]["loss"], jcl["per_client"]["loss"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tcl["per_client"]["n"], jcl["per_client"]["n"])
        assert tcl["fairness"]["n_clients"] == jcl["fairness"]["n_clients"] == 2


def test_bert_mesh_waves_smaller_than_the_cohort_match_jax(bert):
    """Ten clients in waves of 8 on the 8 shards: two waves, the second
    with six phantoms."""
    jmodel, jparams, tparams = bert
    sizes = (7, 0, 8, 3, 5, 8, 1, 4, 6, 2)
    data, n_samples = _bert_data(sizes, 3)
    key = jax.random.key(4)
    jres = JaxFedSim(jmodel, batch_size=BATCH, learning_rate=0.05, mesh=jax_make_mesh(8)
                     ).run_round(jparams, _jnp(data), jnp.asarray(n_samples), key,
                                 n_epochs=EPOCHS, wave_size=8)
    perms = torch.from_numpy(jax_round_perms(key, len(sizes), EPOCHS, data["x"].shape[1]))
    seen = []
    res = FedSim(bert_classifier_model(BertConfig.tiny()), batch_size=BATCH, learning_rate=0.05,
                 mesh=_mesh()).run_round(tparams, data, n_samples, n_epochs=EPOCHS, perms=perms,
                                         wave_size=5, progress_fn=lambda *a: seen.append(a))
    assert seen == [(1, 2), (2, 2)]  # the wave of 5 rounds up to the 8 shards
    _assert_round(res, jres, sum(sizes))


def test_tiny_resnet_mesh_round_matches_jax():
    sizes = (7, 0, 5)
    rng = np.random.default_rng(6)
    datasets = [{"x": rng.normal(size=(n, 8, 8, 3)).astype(np.float32),
                 "y": rng.integers(0, 10, n).astype(np.int32)} for n in sizes]
    data, n_samples = stack_client_datasets(datasets, batch_size=BATCH)
    kw = dict(blocks_per_stage=(1, 1), n_groups=8, name="resnet_tiny")
    jmodel = jax_resnet(**kw)
    jparams = jmodel.init(jax.random.key(0))
    key = jax.random.key(1)
    jres = JaxFedSim(jmodel, batch_size=BATCH, learning_rate=0.05, mesh=jax_make_mesh(8)
                     ).run_round(jparams, _jnp(data), jnp.asarray(n_samples), key)
    perms = torch.from_numpy(jax_round_perms(key, len(sizes), 1, data["x"].shape[1]))
    res = FedSim(resnet_model(**kw), batch_size=BATCH, learning_rate=0.05, mesh=_mesh()
                 ).run_round(to_port(jparams), data, n_samples, perms=perms)
    _assert_round(res, jres, sum(sizes))


# ---------------------------------------------------------------------------
# the mesh against the port's own meshless path


def _linear_cohort(n_clients=6, seed=0):
    rng = np.random.default_rng(seed)
    data = {"x": torch.from_numpy(rng.normal(size=(n_clients, 4, 3)).astype(np.float32)),
            "y": torch.from_numpy(rng.normal(size=(n_clients, 4)).astype(np.float32))}
    n = torch.from_numpy(rng.integers(0, 5, n_clients))
    return linear_regression_model(3), data, n


def _close(a, b, tol):
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=tol, atol=tol)


def test_mesh_run_rounds_and_auto_wave_equal_the_meshless_rounds():
    model, data, n = _linear_cohort()
    kw = dict(batch_size=2, learning_rate=0.05)
    plain = FedSim(model, device="cpu", **kw)
    meshed = FedSim(model, mesh=_mesh(4), **kw)
    params = plain.init(torch.Generator().manual_seed(0))
    p1, h1 = plain.run_rounds(params, data, n, torch.Generator().manual_seed(1), n_rounds=3,
                              n_epochs=2, wave_size=8)
    p2, h2 = meshed.run_rounds(params, data, n, torch.Generator().manual_seed(1), n_rounds=3,
                               n_epochs=2)
    _close(p2, p1, 1e-5)
    np.testing.assert_allclose(h2, h1, rtol=1e-5, atol=1e-6)
    assert meshed.auto_wave_size(params, data, n) is None  # the CPU has no allocator peak
    auto = meshed.run_round(params, data, n, torch.Generator().manual_seed(2), wave_size="auto")
    whole = meshed.run_round(params, data, n, torch.Generator().manual_seed(2))
    _close(auto.params, whole.params, 0)


def test_mesh_wave_sizer_halves_in_multiples_of_the_shards():
    """The per-shard search on a line footprint: waves are multiples of
    the 4 shards, and the smallest is one client a shard."""
    model, data, n = _linear_cohort(n_clients=13)
    sim = FedSim(model, batch_size=2, mesh=_mesh(4))
    params = sim.init(torch.Generator().manual_seed(0))
    line = lambda w: 1.0 + w  # noqa: E731  GiB at a wave of w clients
    assert sim.auto_wave_size(params, data, n, budget_gb=100.0, footprint=line) is None
    assert sim.auto_wave_size(params, data, n, budget_gb=9.5, footprint=line) == 8
    assert sim.auto_wave_size(params, data, n, budget_gb=5.5, footprint=line) == 4
    with pytest.raises(RuntimeError, match="down to 4"):
        sim.auto_wave_size(params, data, n, budget_gb=4.5, footprint=line)


def test_mesh_fused_rounds_equal_the_meshless_fused_rounds():
    model, data, n = _linear_cohort(n_clients=5)
    kw = dict(batch_size=2, learning_rate=0.05)
    params = FedSim(model, device="cpu", **kw).init(torch.Generator().manual_seed(0))
    p1, h1 = FedSim(model, device="cpu", **kw).run_rounds_fused(
        params, data, n, torch.Generator().manual_seed(1), n_rounds=3, wave_size=8)
    sim = FedSim(model, mesh=_mesh(), **kw)
    p2, h2 = sim.run_rounds_fused(params, data, n, torch.Generator().manual_seed(1), n_rounds=3)
    _close(p2, p1, 1e-5)
    np.testing.assert_allclose(h2, h1, rtol=1e-5, atol=1e-6)
    assert sim.last_fused == {"graph": False, "rounds": 3}


def test_dp_noise_rows_are_the_meshless_rows():
    """Under DP with noise every client gets the noise rows it gets
    without the mesh (one replica of the wave's noise generator a shard,
    each drawing the whole wave and keeping its rows), and the caller's
    generator ends where the meshless round leaves it."""
    from baton_tpu_torch.models.mlp import mlp_classifier_model

    rng = np.random.default_rng(2)
    data = {"x": torch.from_numpy(rng.normal(size=(8, 4, 5)).astype(np.float32)),
            "y": torch.from_numpy(rng.integers(0, 3, (8, 4)))}
    n = torch.tensor([4, 2, 0, 3, 4, 1, 4, 2])
    model = mlp_classifier_model(5, (8,), 3)
    kw = dict(batch_size=2, learning_rate=0.1, dp=DPConfig(clip_norm=1.0, noise_multiplier=0.7))
    params = FedSim(model, device="cpu", **kw).init(torch.Generator().manual_seed(0))
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    plain = FedSim(model, device="cpu", **kw).run_round(params, data, n, gens[0], n_epochs=2)
    meshed = FedSim(model, mesh=_mesh(4), **kw).run_round(params, data, n, gens[1], n_epochs=2)
    _close(meshed.params, plain.params, 1e-5)
    torch.testing.assert_close(meshed.client_losses, plain.client_losses, rtol=1e-5, atol=1e-6)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_only_a_model_axis_is_refused():
    """A mesh with a ``model`` axis runs now (its waves a multiple of the
    clients extent); refused are a mesh without a ``clients`` axis, one
    with a third axis of more than one shard, and one whose ``model`` axis
    crosses processes (all ValueError, as the mesh cannot be honoured)."""
    model = linear_regression_model(3)
    hybrid = FedSim(model, mesh=Mesh(np.array([CPU8[:2]] * 4, dtype=object),
                                     ("clients", "model")))
    assert hybrid.is_hybrid and hybrid._clients_per_wave_unit() == 4
    assert hybrid.partition_rule_set == "transformer-tp"
    with pytest.raises(ValueError, match="'clients' axis"):
        FedSim(model, mesh=make_mesh(8, ("seq",), devices=CPU8))
    with pytest.raises(ValueError, match="'clients' axis"):
        FedSim(model, mesh=Mesh(np.array([CPU8[:2]] * 4, dtype=object), ("clients", "seq")))
    with pytest.raises(ValueError, match="crosses processes"):
        FedSim(model, mesh=Mesh(np.array([CPU8[:2]] * 4, dtype=object), ("clients", "model"),
                                process_ids=[[0, 1]] * 4))
    sim = FedSim(model, mesh=_mesh())
    assert sim.device == torch.device("cpu") and sim._clients_per_wave_unit() == 8
    assert not sim.is_hybrid and sim.partition_rule_set == "client-stacked"


def test_a_shards_noise_rows_are_the_waves_rows_and_own_their_memory():
    """``noise_rows_of``: each shard's rows equal (bitwise) those rows of
    the wave's one draw from the same generator state, and hold no more
    storage than the rows themselves; the whole wave is the draw itself."""
    from baton_tpu_torch.core.training import noise_rows_of
    from baton_tpu_torch.ops.privacy import gaussian_noise_like

    stacked = {"w": torch.zeros(1, 5, 3), "b": torch.zeros(1, 3)}
    wave = {k: torch.zeros((8,) + v.shape[1:]) for k, v in stacked.items()}
    want = gaussian_noise_like(wave, 1.0, torch.Generator().manual_seed(7))
    whole = noise_rows_of(stacked, torch.Generator().manual_seed(7), (0, 8, 8), "cpu")
    for k in want:
        assert torch.equal(whole[k], want[k])
    for lo, hi in ((0, 2), (2, 4), (6, 8)):
        rows = noise_rows_of(stacked, torch.Generator().manual_seed(7), (lo, hi, 8), "cpu")
        for k in want:
            assert torch.equal(rows[k], want[k][lo:hi])
            assert rows[k].untyped_storage().nbytes() == rows[k].numel() * 4
