"""``baton_tpu_torch/ops/privacy.py`` on the CPU.

The privacy cases of ``tests/test_privacy.py`` against the port: the
clipping oracles (global norm, per example), sigma 0 with a huge clip
equal to the plain mean gradient, masked padding rows as clipped no-ops,
DP federated training that still learns, DP-FedAvg's uniform mean and
its clipped outlier, the accountant (monotonic, the canonical MNIST
epsilon, its limits) and Poisson sampling. Then the port against the JAX
package on the same numpy inputs, the noise drawn once by JAX and handed
to the port as its standard normals: the per-example clipped sum,
``dp_sgd_grads`` and ``dp_fedavg`` within 1e-6, and the accountant's
outputs within 1e-12."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.models.mlp import mlp_classifier_model as jax_mlp
from baton_tpu.ops import privacy as jpriv
from baton_tpu_torch import FedSim
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.ops.privacy import (
    DEFAULT_ORDERS,
    INT_ORDERS,
    DPConfig,
    clip_by_global_norm,
    dp_fedavg,
    dp_sgd_grads,
    gaussian_noise_like,
    global_norm,
    per_example_clipped_grad_sum,
    poisson_sample,
    rdp_epsilon,
    rdp_to_epsilon,
    sampled_gaussian_rdp,
    subsampled_rdp_epsilon,
)
from _torch_variants import to_port

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the reference's cases


def test_clip_by_global_norm():
    tree = {"a": torch.ones(3) * 3.0, "b": torch.ones(4) * 4.0}
    # ||tree|| = sqrt(9*3 + 16*4) = sqrt(91)
    np.testing.assert_allclose(float(global_norm(tree)), np.sqrt(91), rtol=1e-6)
    clipped = clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    same = clip_by_global_norm(tree, 100.0)  # under the limit: untouched
    assert torch.equal(same["a"], tree["a"])


def test_per_example_clipping_oracle():
    """Scalar loss w·x per example: grad_i = x_i."""
    params = {"w": torch.zeros(3)}

    def loss_fn(p, batch1):
        return (batch1["x"] @ p["w"]).sum()

    batch = {"x": torch.tensor([[3.0, 0, 0], [0, 0.5, 0]])}
    summed, losses = per_example_clipped_grad_sum(loss_fn, params, batch, 1.0)
    # example 0 has norm 3 -> clipped to [1,0,0]; example 1 norm .5 -> kept
    np.testing.assert_allclose(summed["w"].numpy(), [1.0, 0.5, 0.0], rtol=1e-6)
    assert losses.shape == (2,)  # un-clipped losses, from the same pass


def _loss_sum(model):
    return lambda p, b: model.loss_and_count(p, b)[0]


def test_dp_grads_equal_plain_grads_when_disabled_noise():
    """sigma=0 + huge clip -> DP estimator == plain mean batch gradient."""
    rng = np.random.default_rng(0)
    model = linear_regression_model(4)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"x": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
             "y": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32)),
             "mask": torch.ones(8)}
    g_dp, _ = dp_sgd_grads(_loss_sum(model), params, batch, None,
                           DPConfig(clip_norm=1e9, noise_multiplier=0.0), 8)
    g_plain = torch.func.grad(lambda p: _loss_sum(model)(p, batch) / 8.0)(params)
    for k in params:
        torch.testing.assert_close(g_dp[k], g_plain[k], rtol=1e-5, atol=1e-6)


def test_dp_padding_rows_are_clipped_noops():
    """Masked garbage rows contribute nothing to the DP gradient sum."""
    rng = np.random.default_rng(1)
    model = linear_regression_model(3)
    params = model.init(torch.Generator().manual_seed(0))
    x = rng.normal(size=(4, 3)).astype(np.float32)
    y = rng.normal(size=(4,)).astype(np.float32)
    dp = DPConfig(clip_norm=0.5, noise_multiplier=0.0)
    clean = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "mask": torch.ones(4)}
    garbage = {"x": torch.from_numpy(np.concatenate([x, np.full((4, 3), 50.0, np.float32)])),
               "y": torch.from_numpy(np.concatenate([y, np.full((4,), 50.0, np.float32)])),
               "mask": torch.tensor([1.0, 1, 1, 1, 0, 0, 0, 0])}
    g_clean, _ = dp_sgd_grads(_loss_sum(model), params, clean, None, dp, 8)
    g_garbage, _ = dp_sgd_grads(_loss_sum(model), params, garbage, None, dp, 8)
    for k in params:
        torch.testing.assert_close(g_clean[k], g_garbage[k], rtol=1e-6, atol=0)


def test_dp_federated_training_learns():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(6, 3))
    datasets = []
    for _ in range(4):
        n = int(rng.integers(30, 50))
        x = rng.normal(size=(n, 6)).astype(np.float32)
        datasets.append({"x": x, "y": np.argmax(x @ w, axis=1).astype(np.int32)})
    data, n_samples = stack_client_datasets(datasets, batch_size=16)
    sim = FedSim(mlp_classifier_model(6, (16,), 3), batch_size=16, learning_rate=0.1,
                 dp=DPConfig(clip_norm=1.0, noise_multiplier=0.3), device="cpu")
    params = sim.init(torch.Generator().manual_seed(0))
    params, hist = sim.run_rounds(params, data, n_samples, torch.Generator().manual_seed(1),
                                  n_rounds=5, n_epochs=2)
    assert hist[-1] < hist[0]


def test_dp_fedavg_uniform_mean_oracle():
    stacked = {"w": torch.from_numpy(np.random.default_rng(3).normal(size=(3, 4))
                                     .astype(np.float32))}
    out = dp_fedavg(stacked, {"w": torch.zeros(4)}, None, clip_norm=1e9, noise_multiplier=0.0)
    torch.testing.assert_close(out["w"], stacked["w"].mean(0), rtol=1e-6, atol=0)


def test_dp_fedavg_clips_outlier():
    honest = np.random.default_rng(4).normal(size=(2, 4)).astype(np.float32) * 0.01
    stacked = {"w": torch.from_numpy(np.concatenate([honest, np.ones((1, 4), np.float32) * 1e6]))}
    out = dp_fedavg(stacked, {"w": torch.zeros(4)}, None, clip_norm=0.1, noise_multiplier=0.0)
    # the attacker's delta is clipped to norm 0.1; the mean's norm <= 0.1
    assert float(global_norm(out)) <= 0.1 + 1e-6


def test_noise_needs_a_generator_or_the_draws():
    tree = {"w": torch.zeros(4)}
    with pytest.raises(ValueError, match="Generator"):
        dp_fedavg({"w": torch.zeros(2, 4)}, tree, None, clip_norm=1.0, noise_multiplier=1.0)
    gen = torch.Generator().manual_seed(5)
    noise = gaussian_noise_like(tree, 2.0, gen)
    want = torch.randn(4, generator=torch.Generator().manual_seed(5)) * 2.0
    assert torch.equal(noise["w"], want)


def test_rdp_accounting_monotonic():
    e1 = rdp_epsilon(noise_multiplier=1.0, steps=100, delta=1e-5)
    e2 = rdp_epsilon(noise_multiplier=2.0, steps=100, delta=1e-5)
    e3 = rdp_epsilon(noise_multiplier=1.0, steps=400, delta=1e-5)
    assert e2 < e1 < e3
    assert rdp_epsilon(0.0, 1, 1e-5) == float("inf")
    assert e1 < e3 <= 4 * e1


def test_subsampled_accounting_canonical_mnist():
    """σ=1.1, q=256/60000, 60 epochs, δ=1e-5 → ε=3.0 under the classic
    RDP→DP conversion, and the tight conversion below it."""
    q = 256 / 60000
    steps = int(60 * 60000 / 256)
    rdp = sampled_gaussian_rdp(q, 1.1, INT_ORDERS) * steps
    classic = min(r + math.log(1e5) / (a - 1) for r, a in zip(rdp, INT_ORDERS))
    assert abs(classic - 3.0) < 0.05, classic
    tight = subsampled_rdp_epsilon(1.1, steps, 1e-5, q)
    assert 2.0 < tight < classic


def test_subsampled_accounting_limits():
    r = sampled_gaussian_rdp(1.0, 2.0, [2, 4, 8])  # q=1: α/(2σ²) exactly
    np.testing.assert_allclose(r, [a / 8.0 for a in (2, 4, 8)], rtol=1e-12)
    assert np.all(sampled_gaussian_rdp(0.0, 2.0, [2, 4]) == 0.0)
    full = rdp_epsilon(1.0, 1000, 1e-5)
    amp = subsampled_rdp_epsilon(1.0, 1000, 1e-5, 0.01)
    assert amp < full / 50
    assert amp < subsampled_rdp_epsilon(1.0, 1000, 1e-5, 0.1)
    assert subsampled_rdp_epsilon(0.0, 10, 1e-5, 0.5) == float("inf")


def test_poisson_sample_drives_cohorts():
    rng = np.random.default_rng(6)
    counts = [poisson_sample(rng, 200, 0.25).size for _ in range(50)]
    assert 35 < np.mean(counts) < 65  # E=50, binomial std ~6.1
    idx = poisson_sample(rng, 100, 0.3)
    assert np.all(np.diff(idx) > 0) and (idx.size == 0 or idx[-1] < 100)
    assert poisson_sample(rng, 100, 0.0).size == 0
    assert poisson_sample(rng, 100, 1.0).size == 100
    with pytest.raises(ValueError):
        poisson_sample(rng, 10, 1.5)


# ---------------------------------------------------------------------------
# the port against the JAX package


def _mlp_batch(seed, n=6, masked=2):
    rng = np.random.default_rng(seed)
    mask = np.ones(n, np.float32)
    mask[n - masked:] = 0.0
    return {"x": rng.normal(size=(n, 5)).astype(np.float32),
            "y": rng.integers(0, 3, n).astype(np.int32), "mask": mask}


def _jax_normals(rng, tree):
    """The standard normals JAX's ``gaussian_noise_like(tree, std, rng)``
    scales by std, by leaf name."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(rng, len(leaves))
    normals = [jax.random.normal(k, leaf.shape, jnp.float32) for k, leaf in zip(keys, leaves)]
    return to_port(jax.tree_util.tree_unflatten(treedef, normals))


def _close(got, want, tol=1e-6):
    want = to_port(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("clip", [0.05, 1e9])
def test_clipped_sum_and_dp_grads_match_jax(clip):
    jm = jax_mlp(5, (8,), 3)
    jparams = jm.init(jax.random.key(0))
    model = mlp_classifier_model(5, (8,), 3)
    params = to_port(jparams)
    batch = _mlp_batch(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def jloss(p, b, r):
        return jm.loss_and_count(p, b, r)[0]

    jsum, jlosses = jpriv.per_example_clipped_grad_sum(jloss, jparams, jbatch,
                                                        jax.random.key(1), clip)
    summed, losses = per_example_clipped_grad_sum(_loss_sum(model), params, tbatch, clip)
    _close(summed, jsum)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-6, atol=1e-6)

    dp = DPConfig(clip_norm=clip if clip < 1e3 else 1.0, noise_multiplier=0.8)
    rng = jax.random.key(2)
    jgrads, _ = jpriv.dp_sgd_grads(jloss, jparams, jbatch, rng,
                                   jpriv.DPConfig(dp.clip_norm, dp.noise_multiplier), 8)
    noise = _jax_normals(jax.random.split(rng)[1], jparams)
    grads, _ = dp_sgd_grads(_loss_sum(model), params, tbatch, None, dp, 8, noise=noise)
    _close(grads, jgrads)


def test_dp_fedavg_matches_jax():
    rng = np.random.default_rng(8)
    global_p = {"0/w": rng.normal(size=(5, 8)).astype(np.float32),
                "0/b": rng.normal(size=(8,)).astype(np.float32)}
    stacked = {k: (v[None] + rng.normal(size=(4,) + v.shape) * s).astype(np.float32)
               for (k, v), s in zip(global_p.items(), (0.3, 10.0))}
    key = jax.random.key(3)
    jout = jpriv.dp_fedavg({k: jnp.asarray(v) for k, v in stacked.items()},
                           {k: jnp.asarray(v) for k, v in global_p.items()}, key,
                           clip_norm=2.0, noise_multiplier=1.3)
    noise = _jax_normals(key, {k: jnp.asarray(v) for k, v in global_p.items()})
    out = dp_fedavg({k: torch.from_numpy(v) for k, v in stacked.items()},
                    {k: torch.from_numpy(v) for k, v in global_p.items()}, None,
                    clip_norm=2.0, noise_multiplier=1.3, noise=noise)
    _close(out, jout)


def test_accountant_matches_jax():
    for sigma, steps, delta, q in ((1.1, 14062, 1e-5, 256 / 60000), (0.5, 40, 1e-5, 0.5),
                                   (2.0, 1, 1e-6, 1.0), (0.8, 300, 1e-5, 0.0)):
        assert abs(rdp_epsilon(sigma, steps, delta) - jpriv.rdp_epsilon(sigma, steps, delta)) \
            <= 1e-12
        np.testing.assert_allclose(sampled_gaussian_rdp(q, sigma),
                                   jpriv.sampled_gaussian_rdp(q, sigma), rtol=0, atol=1e-12)
        rdp = jpriv.sampled_gaussian_rdp(q, sigma) * steps
        assert abs(rdp_to_epsilon(rdp, INT_ORDERS, delta)
                   - jpriv.rdp_to_epsilon(rdp, jpriv.INT_ORDERS, delta)) <= 1e-12
        assert abs(subsampled_rdp_epsilon(sigma, steps, delta, q)
                   - jpriv.subsampled_rdp_epsilon(sigma, steps, delta, q)) <= 1e-12
    assert (INT_ORDERS, DEFAULT_ORDERS) == (jpriv.INT_ORDERS, jpriv.DEFAULT_ORDERS)
