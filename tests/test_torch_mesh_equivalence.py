"""The properties of ``tests/test_mesh_equivalence.py``, held against the
port's sharded paths on 8 shards of the CPU (``make_mesh(8, devices=
[cpu] * 8)``): spec equality (every sharded round's layout is
``partition.kernel_specs``'s); fold equivalence (the psum FedAvg of the
same trained client contributions against a float64 oracle, 1e-5);
exact phantom-row invariance inside one sharded call, for the engine and
for FedPer (bitwise); exact bookkeeping for clustered FL and FedBuff
against their meshless runs; StatefulClients threading its state on the
mesh; the LoRA frozen base untouched; the robust aggregator on the mesh
rejecting a poisoned client; and the fused rounds with phantom padding
in the 5e-2 band (the port's mesh keeps every shuffle, so it lands far
inside it). The JAX package's counterparts run beside them where the
property compares layouts."""

import numpy as np
import pytest
import torch

from baton_tpu.parallel.partition import kernel_specs as jax_kernel_specs
from baton_tpu_torch import FedSim
from baton_tpu_torch.core import optim
from baton_tpu_torch.data.synthetic import DEMO_COEF, linear_client_data
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.models.lora import lora_trainable, lora_wrap
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.ops import aggregation as agg
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel import ClusteredFedSim, FedBuff, FedPer, StatefulClients
from baton_tpu_torch.parallel.mesh import CLIENT_AXIS, make_mesh, require_clients_mesh
from baton_tpu_torch.parallel.partition import PartitionSpec, client_spec, kernel_specs, \
    replicated_spec

torch.set_num_threads(1)
BAND = 5e-2  # the reference's cross-layout band (tests/test_mesh_equivalence.py)


def _mesh(n=8):
    return make_mesh(n, devices=[torch.device("cpu")] * n)


def _linear_setup(rng, n_clients=8):
    datasets = [linear_client_data(rng, min_batches=2, max_batches=3) for _ in range(n_clients)]
    data, n_samples = stack_client_datasets(datasets, batch_size=32)
    return {k: torch.from_numpy(v) for k, v in data.items()}, torch.from_numpy(n_samples)


def _perms(n_clients, n_epochs, capacity, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([torch.stack([torch.randperm(capacity, generator=gen)
                                     for _ in range(n_epochs)]) for _ in range(n_clients)])


def _wave_sums(sim, params, frozen, data, n_samples, perms, n_epochs=1):
    """The sharded weighted-sums wave (``kernel_specs("engine.wave_sums")``)
    as one call on a wave already a multiple of the shards: ``(Σ w·params,
    Σ w·losses, Σ w, client_losses)``, the losses of every client
    (phantoms included) in client order."""
    anchor = params if sim.trainer.regularizer is not None else None
    closs = []
    psum, lsum, wsum = sim._fold_waves(params, frozen, anchor, data, n_samples, perms,
                                       int(n_samples.shape[0]), n_epochs, [None],
                                       per_client=closs)
    return psum, lsum, wsum, closs[0]


def _tree_close(a, b, tol):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), rtol=tol, atol=tol,
                                   err_msg=k)


def test_kernel_spec_table_is_the_partition_layout():
    cli, rep = PartitionSpec(CLIENT_AXIS), PartitionSpec()
    assert client_spec() == cli and replicated_spec() == rep
    want = {
        "engine.wave_sums": ((rep, rep, cli, cli, cli), (rep, rep, rep, cli)),
        "engine.wave_params": ((rep, rep, cli, cli, cli), (cli, cli)),
        "fedbuff.train": ((cli, cli, cli, cli, rep), (cli, cli)),
        "clustered.round": ((rep, cli, cli, cli), (rep, cli, cli)),
        "stateful.round": ((rep, cli, cli, cli, cli), (rep, cli, rep, cli)),
        "personalization.round": ((cli, rep, cli, cli, cli), (cli, rep, rep, rep, cli)),
    }
    for name, specs in want.items():
        assert kernel_specs(name) == specs, name
        assert [tuple(map(tuple, side)) for side in jax_kernel_specs(name)] == \
            [tuple(map(tuple, side)) for side in specs], name
    ins, outs = kernel_specs("engine.wave_sums", axis="workers")
    assert ins[2] == PartitionSpec("workers") and outs[3] == PartitionSpec("workers")


def test_engine_fold_equivalence_on_trained_contributions(nprng):
    """The sharded fold (per-shard weighted sums, one psum over the
    clients axis) equals the float64 oracle on the same trained client
    params; training happens once, so only the fold is under test."""
    data, n_samples = _linear_setup(nprng)
    sim = FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.02, device="cpu")
    params = sim.init(torch.Generator().manual_seed(0))
    client_params, _ = sim.trainer.train_clients(params, data, n_samples, 1,
                                                 _perms(8, 1, data["x"].shape[1]))
    w = n_samples.float()
    w64 = w.double().numpy()
    oracle = {k: np.tensordot(w64, v.double().numpy(), axes=(0, 0)) / w64.sum()
              for k, v in client_params.items()}
    mesh = _mesh()
    shards = [{k: v[j:j + 1] for k, v in client_params.items()} for j in range(8)]
    means = agg.psum_weighted_mean(shards, [w[j:j + 1] for j in range(8)], mesh)
    assert len(means) == 8
    for mean in means:
        _tree_close(mean, oracle, 1e-5)
    _tree_close(agg.weighted_tree_mean(client_params, w), oracle, 1e-5)
    # the same fold inside the engine's sharded weighted-sums call
    psum, lsum, wsum, _ = _wave_sums(
        FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.02, mesh=mesh),
        params, None, data, n_samples, _perms(8, 1, data["x"].shape[1]))
    assert float(wsum) == float(w.sum())
    _tree_close({k: v / wsum for k, v in psum.items()}, oracle, 1e-5)


def _phantom_fill(tree, seed, pad=2):
    """``tree``'s [C, ...] leaves with ``pad`` rows of arbitrary values
    (random floats, zero integers) appended."""
    gen = torch.Generator().manual_seed(seed)

    def fill(v):
        rows = (torch.randn((pad,) + v.shape[1:], generator=gen).to(v.dtype)
                if v.is_floating_point() else v.new_zeros((pad,) + v.shape[1:]))
        return torch.cat([v, rows])

    return {k: fill(v) for k, v in tree.items()}


def test_engine_sharded_wave_phantom_rows_cannot_perturb(nprng):
    """Zero-sample phantom rows contribute exactly nothing to the sharded
    wave: the same call twice with different phantom data and shuffles
    gives bit-identical sums and real clients' losses."""
    data6, n6 = _linear_setup(nprng, n_clients=6)
    sim = FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.02, mesh=_mesh())
    params = sim.init(torch.Generator().manual_seed(0))
    cap = data6["x"].shape[1]
    n = torch.cat([n6, n6.new_zeros(2)])
    real = _perms(6, 1, cap)
    outs = [_wave_sums(sim, params, None, _phantom_fill(data6, s), n,
                       torch.cat([real, _perms(2, 1, cap, seed=s)]))
            for s in (10, 99)]
    for a, b in zip(outs[0][0].values(), outs[1][0].values()):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][1], outs[1][1]) and torch.equal(outs[0][2], outs[1][2])
    assert torch.equal(outs[0][3][:6], outs[1][3][:6])


def _head(name, leaf):
    return name.startswith("1/")


def _classified(rng, n_clients):
    datasets = []
    for c in range(n_clients):
        n = int(rng.integers(8, 24))
        x = rng.normal(size=(n, 8)).astype(np.float32)
        y = ((x[:, 0] > 0).astype(np.int32) + c) % 4
        datasets.append({"x": x, "y": y})
    data, n_samples = stack_client_datasets(datasets, batch_size=16)
    return {k: torch.from_numpy(v) for k, v in data.items()}, torch.from_numpy(n_samples)


def test_fedper_sharded_kernel_phantom_rows_cannot_perturb(nprng):
    data6, n6 = _classified(nprng, 6)
    model = mlp_classifier_model(8, (16,), 4)
    fp = FedPer(FedSim(model, batch_size=16, learning_rate=0.1, mesh=_mesh()), personal=_head)
    params = model.init(torch.Generator().manual_seed(0))
    fp._ensure_partition(params)
    pers6 = fp.init_personal(params, 6)
    _, shared = fp.partition.split(params)
    cap = data6["x"].shape[1]
    n = torch.cat([n6, n6.new_zeros(2)])
    real = _perms(6, 1, cap)
    outs = [fp._round(_phantom_fill(pers6, s), shared, _phantom_fill(data6, s + 1), n,
                      torch.cat([real, _perms(2, 1, cap, seed=s)]), 1) for s in (11, 77)]
    for i in (1, 2):  # shared aggregate and warm-start mean
        for k in outs[0][i]:
            assert torch.equal(outs[0][i][k], outs[1][i][k]), k
    assert torch.equal(outs[0][3], outs[1][3])  # loss history
    for k in outs[0][0]:  # the real clients' personal rows
        assert torch.equal(outs[0][0][k][:6], outs[1][0][k][:6])
    assert torch.equal(outs[0][4][:6], outs[1][4][:6])


def test_engine_sharded_round_weights_and_unaligned_cohort(nprng):
    data, n_samples = _linear_setup(nprng)
    sim = FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.01, mesh=_mesh())
    params = sim.init(torch.Generator().manual_seed(0))
    res = sim.run_round(params, data, n_samples, torch.Generator().manual_seed(5), n_epochs=2)
    assert res.client_losses.shape == (8, 2)
    assert torch.isfinite(res.loss_history).all()
    assert float(res.n_samples_total) == float(n_samples.sum())
    res6 = sim.run_round(params, {k: v[:6] for k, v in data.items()}, n_samples[:6],
                         torch.Generator().manual_seed(5))
    assert res6.client_losses.shape == (6, 1)
    assert float(res6.n_samples_total) == float(n_samples[:6].sum())
    assert all(torch.isfinite(v).all() for v in res6.params.values())


def test_robust_aggregator_on_mesh_rejects_byzantine(nprng):
    data, n_samples = _linear_setup(nprng)
    poisoned = dict(data, y=data["y"].clone())
    poisoned["y"][0] *= 1e3
    model = linear_regression_model(10)
    params = model.init(torch.Generator().manual_seed(0))

    def err(aggregator):
        sim = FedSim(model, batch_size=32, learning_rate=0.05, aggregator=aggregator, mesh=_mesh())
        res = sim.run_round(params, poisoned, n_samples, torch.Generator().manual_seed(5),
                            n_epochs=4)
        return float(np.max(np.abs(res.params["w"].numpy().ravel() - DEMO_COEF)))

    err_trimmed, err_mean = err("trimmed:0.2"), err("mean")
    assert err_trimmed < 15.0 < err_mean, (err_trimmed, err_mean)


def test_lora_sharded_round_keeps_frozen_base_untouched(nprng):
    model = lora_wrap(mlp_classifier_model(8, (16,), 4), rank=2)
    params = model.init(torch.Generator().manual_seed(0))
    data, n_samples = _classified(nprng, 8)
    sim = FedSim(model, batch_size=16, learning_rate=0.1, trainable=lora_trainable, mesh=_mesh())
    res = sim.run_round(params, data, n_samples, torch.Generator().manual_seed(3))
    base = [k for k in params if not lora_trainable(k, params[k])]
    adapters = [k for k in params if lora_trainable(k, params[k])]
    assert base and adapters
    assert all(torch.equal(res.params[k], params[k]) for k in base)
    assert any(not torch.equal(res.params[k], params[k]) for k in adapters)
    assert torch.isfinite(res.loss_history).all()


def _mixture(rng, n_clients=8):
    """Two populations with opposite coefficients (clients alternate)."""
    datasets, pops = [], []
    for c in range(n_clients):
        pop = c % 2
        x = rng.normal(size=(40, 10)).astype(np.float32)
        coef = DEMO_COEF * (1.0 if pop == 0 else -1.0)
        datasets.append({"x": x, "y": (x @ coef).astype(np.float32)})
        pops.append(pop)
    data, n_samples = stack_client_datasets(datasets, batch_size=32)
    return {k: torch.from_numpy(v) for k, v in data.items()}, torch.from_numpy(n_samples), \
        np.asarray(pops)


def test_clustered_mesh_assignments_match_single_device_exactly(nprng):
    data, n_samples, pops = _mixture(nprng)
    model = linear_regression_model(10)
    cf1 = ClusteredFedSim(FedSim(model, batch_size=32, learning_rate=0.05, device="cpu"), 2)
    cf8 = ClusteredFedSim(FedSim(model, batch_size=32, learning_rate=0.05, mesh=_mesh()), 2)
    clusters = cf1.init_clusters(torch.Generator().manual_seed(0))
    perms = _perms(8, 2, data["x"].shape[1], seed=1)
    r1 = cf1.run_round(clusters, data, n_samples, n_epochs=2, perms=perms)
    r8 = cf8.run_round(clusters, data, n_samples, n_epochs=2, perms=perms)
    np.testing.assert_array_equal(r1.assignments, r8.assignments)
    _tree_close(r8.cluster_params, r1.cluster_params, 1e-4)
    # unaligned: 6 clients pad to the 8 shards; unpadded outputs
    r1b = cf1.run_round(clusters, {k: v[:6] for k, v in data.items()}, n_samples[:6],
                        perms=perms[:6, :1])
    r8b = cf8.run_round(clusters, {k: v[:6] for k, v in data.items()}, n_samples[:6],
                        perms=perms[:6, :1])
    assert r8b.assignments.shape == (6,)
    np.testing.assert_array_equal(r1b.assignments, r8b.assignments)
    # the mesh path alone separates the populations
    cl = clusters
    for r in range(12):
        res = cf8.run_round(cl, data, n_samples, torch.Generator().manual_seed(100 + r),
                            n_epochs=2)
        cl = res.cluster_params
    a = res.assignments
    assert np.all(a == pops) or np.all(a == 1 - pops), (a, pops)


def test_fedbuff_mesh_bookkeeping_matches_single_device_exactly(nprng):
    datasets = [linear_client_data(nprng) for _ in range(8)]
    data, n_samples = stack_client_datasets(datasets, batch_size=32)
    data = {k: torch.from_numpy(v) for k, v in data.items()}
    n_samples = torch.from_numpy(n_samples)
    model = linear_regression_model(10)
    params = model.init(torch.Generator().manual_seed(0))
    cap = data["x"].shape[1]
    perms = torch.stack([_perms(4, 2, cap, seed=s) for s in range(6)])
    out = {}
    for name, sim in [("single", FedSim(model, batch_size=32, learning_rate=0.02, device="cpu")),
                      ("mesh", FedSim(model, batch_size=32, learning_rate=0.02, mesh=_mesh(4)))]:
        out[name] = FedBuff(sim, buffer_size=4, concurrency=8, alpha=0.5).run(
            params, data, n_samples, n_steps=6, n_epochs=2, perms=perms)
    assert out["mesh"].version == out["single"].version == 6
    assert out["mesh"].mean_staleness == out["single"].mean_staleness
    losses = out["mesh"].loss_history
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, out["single"].loss_history, rtol=1e-5)
    _tree_close(out["mesh"].params, out["single"].params, 1e-4)
    with pytest.raises(ValueError, match="multiple of the clients-mesh size"):
        FedBuff(FedSim(model, mesh=_mesh(4)), buffer_size=6, concurrency=8)


def test_stateful_mesh_threads_state_and_learns(nprng):
    datasets = [linear_client_data(nprng, min_batches=2, max_batches=3) for _ in range(6)]
    data, n_samples = stack_client_datasets(datasets, batch_size=32)
    data = {k: torch.from_numpy(v) for k, v in data.items()}
    n_samples = torch.from_numpy(n_samples)
    model = linear_regression_model(10)
    sim = FedSim(model, batch_size=32, optimizer=optim.sgd(0.01, momentum=0.9), mesh=_mesh())
    params = sim.init(torch.Generator().manual_seed(0))
    sc = StatefulClients(sim)
    p, opt = params, None
    for r in range(2):
        res = sc.run_round(p, opt, data, n_samples, torch.Generator().manual_seed(r))
        p, opt = res.params, res.opt_states
    assert all(v.shape[0] == 6 for v in opt["trace"].values())  # unpadded, client-stacked
    reset = sc.run_round(res.params, None, data, n_samples, torch.Generator().manual_seed(1))
    threaded = sc.run_round(res.params, opt, data, n_samples, torch.Generator().manual_seed(1))
    assert not torch.allclose(threaded.params["w"], reset.params["w"])
    # the meshless stateful round from the same states agrees
    plain = StatefulClients(FedSim(model, batch_size=32, optimizer=optim.sgd(0.01, momentum=0.9),
                                   device="cpu"))
    perms = _perms(6, 1, data["x"].shape[1], seed=4)
    a = sc.run_round(res.params, opt, data, n_samples, perms=perms)
    b = plain.run_round(res.params, opt, data, n_samples, perms=perms)
    _tree_close(a.params, b.params, 1e-5)
    _tree_close(a.opt_states["trace"], b.opt_states["trace"], 1e-5)
    p, opt = params, None
    for r in range(12):
        res = sc.run_round(p, opt, data, n_samples, torch.Generator().manual_seed(r))
        p, opt = res.params, res.opt_states
    err = float(np.max(np.abs(p["w"].numpy().ravel() - DEMO_COEF)))
    assert err < 2.0, err


def test_fedper_mesh_round_layout_and_warm_start(nprng):
    data, n_samples = _classified(nprng, 6)
    model = mlp_classifier_model(8, (16,), 4)
    fp = FedPer(FedSim(model, batch_size=16, learning_rate=0.1, mesh=_mesh()), personal=_head)
    params = model.init(torch.Generator().manual_seed(0))
    res = fp.run_round(params, None, data, n_samples, torch.Generator().manual_seed(2))
    assert all(v.shape[0] == 6 for v in res.personal_state.values())
    assert res.client_losses.shape == (6, 1)
    assert torch.isfinite(res.loss_history).all()
    pers_mean, _ = fp.partition.split(res.params)
    want = {k: v.double().mean(0).numpy() for k, v in res.personal_state.items()}
    _tree_close({k: v.double() for k, v in pers_mean.items()}, want, 1e-5)


def test_fused_phantom_padding_semantic_guardrail(nprng):
    """5 clients pad to the 8 shards in the fused rounds; the padded mesh
    run stays in the band of the unpadded meshless one."""
    data, n_samples = _linear_setup(nprng, n_clients=5)
    model = linear_regression_model(10)
    kw = dict(batch_size=32, learning_rate=0.02)
    params = model.init(torch.Generator().manual_seed(0))
    p_m, h_m = FedSim(model, mesh=_mesh(), **kw).run_rounds_fused(
        params, data, n_samples, torch.Generator().manual_seed(1), n_rounds=2)
    p_v, h_v = FedSim(model, device="cpu", **kw).run_rounds_fused(
        params, data, n_samples, torch.Generator().manual_seed(1), n_rounds=2)
    _tree_close(p_m, p_v, BAND)
    np.testing.assert_allclose(h_m, h_v, rtol=BAND)


def test_wrappers_keep_the_construction_rules():
    model = linear_regression_model(10)
    hybrid = make_mesh(8, ("clients", "model"), devices=[torch.device("cpu")] * 8)
    with pytest.raises(ValueError, match="hybrid"):
        require_clients_mesh(hybrid, ("mean",), "FedPer")
    with pytest.raises(ValueError, match="needs a 'clients' axis"):
        require_clients_mesh(make_mesh(2, ("seq",), devices=["cpu"] * 2), ("mean",), "FedPer")
    with pytest.raises(ValueError, match="psum mean"):
        StatefulClients(FedSim(model, aggregator="median", mesh=_mesh()))
    with pytest.raises(ValueError, match="psum mean"):
        FedPer(FedSim(model, aggregator="trimmed:0.1", mesh=_mesh()), personal=_head)
