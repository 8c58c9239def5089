"""DP-SGD in the port's trainer and FedSim (``LocalTrainer(dp=)``,
``FedSim(dp=)``) on the CPU.

One DP round of the port against JAX's on the same weights and JAX's
shuffles, with sigma 0 and a clip small enough to bind (JAX's noise comes
from threefry keys the port cannot draw): a tiny MLP without and with
FedProx (whose gradient is added without noise), two epochs of two
batches with a client without samples, within 1e-5; and a 2-layer ViT,
one batch a client, within 1e-5. Then the stacked trainer against each
client alone: with noise, every client's step equals ``dp_sgd_grads``
on that client with the same draws (the cohort's noise drawn outside the
vmap from the trainer's generator, client c's row), to 1e-6; the
generator the noise needs; and ``make_local_trainer(dp=)``'s one-client
``train``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.core.regularizers import fedprox as jax_fedprox
from baton_tpu.models.mlp import mlp_classifier_model as jax_mlp
from baton_tpu.models.vit import ViTConfig as JaxViTConfig
from baton_tpu.models.vit import vit_model as jax_vit
from baton_tpu.ops.privacy import DPConfig as JaxDPConfig
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu_torch import FedSim
from baton_tpu_torch.core import optim
from baton_tpu_torch.core.regularizers import fedprox
from baton_tpu_torch.core.training import make_local_trainer, noise_generator, stack_copies
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.models.vit import ViTConfig, vit_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.ops.privacy import DPConfig, dp_sgd_grads, gaussian_noise_like
from _torch_variants import assert_params_close, round_perms, to_port

torch.set_num_threads(1)


def _mlp_data(sizes=(7, 0, 8), batch=4, seed=0):
    rng = np.random.default_rng(seed)
    datasets = [{"x": rng.normal(size=(n, 6)).astype(np.float32),
                 "y": rng.integers(0, 3, n).astype(np.int32)} for n in sizes]
    return stack_client_datasets(datasets, batch_size=batch)


def _round_against_jax(jmodel, tmodel, jparams, data, n, batch, lr, n_epochs, tol,
                       prox=None):
    key = jax.random.key(1)
    jkw = {"regularizer": jax_fedprox(prox)} if prox else {}
    tkw = {"regularizer": fedprox(prox)} if prox else {}
    jsim = JaxFedSim(jmodel, batch_size=batch, learning_rate=lr,
                     dp=JaxDPConfig(clip_norm=0.05, noise_multiplier=0.0), **jkw)
    jres = jsim.run_round(jparams, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(n),
                          key, n_epochs=n_epochs)
    sim = FedSim(tmodel, batch_size=batch, learning_rate=lr, device="cpu",
                 dp=DPConfig(clip_norm=0.05, noise_multiplier=0.0), **tkw)
    perms = round_perms(key, len(n), n_epochs, data["x"].shape[1])
    res = sim.run_round(to_port(jparams), data, n, perms=perms, n_epochs=n_epochs)
    assert_params_close(res.params, jres.params, tol)
    np.testing.assert_allclose(res.loss_history.numpy(), np.asarray(jres.loss_history),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(res.client_losses.numpy(), np.asarray(jres.client_losses),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("prox", [None, 0.5], ids=["plain", "fedprox"])
def test_dp_round_matches_jax_mlp(prox):
    data, n = _mlp_data()
    jm = jax_mlp(6, (8,), 3)
    _round_against_jax(jm, mlp_classifier_model(6, (8,), 3), jm.init(jax.random.key(0)),
                       data, n, batch=4, lr=0.5, n_epochs=2, tol=1e-5, prox=prox)


def test_dp_round_matches_jax_vit():
    """A 2-layer ViT, one batch a client (the shuffle only reorders the
    rows of one clipped sum)."""
    rng = np.random.default_rng(1)
    cfg = ViTConfig.tiny()
    datasets = [{"x": rng.normal(size=(s, 16, 16, 3)).astype(np.float32),
                 "y": rng.integers(0, cfg.n_classes, s).astype(np.int32)} for s in (4, 3)]
    data, n = stack_client_datasets(datasets, batch_size=4)
    jm = jax_vit(JaxViTConfig.tiny())
    _round_against_jax(jm, vit_model(cfg), jm.init(jax.random.key(0)), data, n, batch=4,
                       lr=0.5, n_epochs=1, tol=1e-5)


def _client_batches(data, n, perms, batch):
    """Client c's first batch as the trainer cuts it: shuffled rows and
    the mask of real ones."""
    out = []
    for c in range(len(n)):
        perm = perms[c, 0]
        rows = {k: torch.as_tensor(v)[c][perm][:batch] for k, v in data.items()}
        rows["mask"] = (perm < int(n[c])).float()[:batch]
        out.append(rows)
    return out


@pytest.mark.parametrize("prox", [None, 0.3], ids=["plain", "fedprox"])
def test_stacked_step_equals_each_client_alone_with_the_same_draws(prox):
    data, n = _mlp_data(sizes=(4, 2, 0, 4), batch=4, seed=3)
    model = mlp_classifier_model(6, (8,), 3)
    params = model.init(torch.Generator().manual_seed(0))
    dp = DPConfig(clip_norm=0.2, noise_multiplier=1.5)
    trainer = make_local_trainer(model, batch_size=4, learning_rate=0.3, dp=dp,
                                 regularizer=fedprox(prox) if prox else None)
    perms = torch.stack([torch.randperm(4, generator=torch.Generator().manual_seed(c))[None]
                         for c in range(4)])
    got, losses = trainer.train_clients(params, {k: torch.as_tensor(v) for k, v in data.items()},
                                        torch.as_tensor(n), 1, perms,
                                        torch.Generator().manual_seed(9),
                                        anchor=params if prox else None)
    # the draws the trainer made: one [C, *shape] standard normal a leaf
    noise = gaussian_noise_like(stack_copies(params, 4), 1.0,
                                noise_generator(torch.Generator().manual_seed(9), "cpu"))

    def loss_sum(p, b):
        return model.loss_and_count(p, b)[0]

    sgd = optim.sgd(0.3)
    for c, batch in enumerate(_client_batches(data, n, perms, 4)):
        grads, ex = dp_sgd_grads(loss_sum, params, batch, None, dp, 4,
                                 noise={k: v[c] for k, v in noise.items()})
        if prox:
            reg = torch.func.grad(lambda q: fedprox(prox)(q, params))(params)
            grads = {k: g + reg[k] for k, g in grads.items()}
        updates, _ = sgd.update(grads, sgd.init(params), params)
        want = params if int(n[c]) == 0 else optim.apply_updates(params, updates)
        for k in params:
            torch.testing.assert_close(got[k][c], want[k], rtol=1e-6, atol=1e-6)
        count = float(batch["mask"].sum())
        if count:
            np.testing.assert_allclose(float(losses[c, 0]), float(ex.sum()) / count,
                                       rtol=1e-6)


def test_noise_moves_the_round_and_needs_a_generator():
    data, n = _mlp_data()
    model = mlp_classifier_model(6, (8,), 3)
    sim = FedSim(model, batch_size=4, learning_rate=0.5, device="cpu",
                 dp=DPConfig(clip_norm=0.5, noise_multiplier=1.0))
    params = sim.init(torch.Generator().manual_seed(0))
    perms = torch.stack([torch.arange(8)[None]] * 3)
    with pytest.raises(ValueError, match="Generator"):
        sim.run_round(params, data, n, perms=perms)
    a = sim.run_round(params, data, n, torch.Generator().manual_seed(1)).params
    b = sim.run_round(params, data, n, torch.Generator().manual_seed(1)).params
    c = sim.run_round(params, data, n, torch.Generator().manual_seed(2)).params
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    quiet = dataclasses.replace(sim.trainer, dp=DPConfig(clip_norm=0.5, noise_multiplier=0.0))
    sim.trainer = quiet  # sigma 0: no draws, so no generator needed
    assert torch.isfinite(sim.run_round(params, data, n, perms=perms).loss_history).all()


def test_make_local_trainer_dp_trains_one_client():
    data, n = _mlp_data(sizes=(8,))
    model = mlp_classifier_model(6, (8,), 3)
    trainer = make_local_trainer(model, batch_size=4, learning_rate=0.5,
                                 dp=DPConfig(clip_norm=1.0, noise_multiplier=0.5))
    assert trainer.dp == DPConfig(1.0, 0.5)
    params = model.init(torch.Generator().manual_seed(0))
    new, _, losses = trainer.train(params, {k: torch.as_tensor(v[0]) for k, v in data.items()},
                                   8, n_epochs=2, generator=torch.Generator().manual_seed(3))
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    assert any(not torch.equal(new[k], params[k]) for k in params)
