"""The port's MoE layer (``baton_tpu_torch/models/moe.py``) against the JAX
package on the same weights and numpy inputs: ``moe_apply`` with ample
capacity and with tokens dropped past it, and its load-balance term,
1e-5; ``moe_dense_oracle``, and ``moe_apply`` equal to it when capacity
is ample (1e-5). Then the reference's own cases (``tests/test_moe.py``
but its expert-parallel one, which waits for the mesh port): gradients
against the oracle, the exact zeros of dropped tokens, the capacity
formula, a training Llama-MoE and its remat gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.models import moe as jm
from baton_tpu_torch.core.training import make_local_trainer
from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model
from baton_tpu_torch.models.moe import (
    MoEConfig,
    moe_apply,
    moe_capacity,
    moe_dense_oracle,
    moe_init,
)
from _torch_zoo import close, port

torch.set_num_threads(1)

D, FF = 16, 32


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(cfg_kw, seed=0):
    jcfg, cfg = jm.MoEConfig(**cfg_kw), MoEConfig(**cfg_kw)
    jp = jm.moe_init(jax.random.key(seed), D, FF, jcfg)
    return jp, port(jp), jcfg, cfg


# capacity_factor 0.5: C = ceil(0.5 · 2 · 12 / 4) = 3 slots an expert for
# 24 choices, so tokens are dropped; 8.0 leaves every expert room for all
CASES = {"ample": dict(n_experts=4, top_k=2, capacity_factor=8.0),
         "dropping": dict(n_experts=4, top_k=2, capacity_factor=0.5)}


@pytest.mark.parametrize("case", CASES)
def test_moe_apply_and_aux_match_jax(case):
    jp, p, jcfg, cfg = _both(CASES[case])
    x = _x(1, 2, 12, D)
    jy, jaux = jm.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux = moe_apply(p, torch.from_numpy(x), cfg)
    close(y, jy, 1e-5)
    close(aux, jaux, 1e-5)
    oracle = moe_dense_oracle(p, torch.from_numpy(x), cfg)
    close(oracle, jm.moe_dense_oracle(jp, jnp.asarray(x), jcfg), 1e-5)
    if case == "ample":
        close(y, oracle.numpy(), 1e-5)
    else:  # some tokens were dropped: the capacity mattered
        assert moe_capacity(cfg, 12) == 3
        assert (y - oracle).abs().max() > 1e-3


def test_moe_dropped_tokens_match_jax_under_vmap():
    """The client vmap over the dropping layer (the comparison one-hots
    batch as any elementwise op)."""
    jp, p, jcfg, cfg = _both(CASES["dropping"])
    x = _x(2, 3, 2, 12, D)
    jy = jax.vmap(lambda xx: jm.moe_apply(jp, xx, jcfg)[0])(jnp.asarray(x))
    y = torch.func.vmap(lambda xx: moe_apply(p, xx, cfg)[0])(torch.from_numpy(x))
    close(y, jy, 1e-5)


@pytest.fixture
def moe_params():
    cfg = MoEConfig(n_experts=4, top_k=2, capacity_factor=8.0)
    return moe_init(torch.Generator().manual_seed(0), D, FF, cfg), cfg


def test_moe_matches_dense_oracle(moe_params, nprng):
    p, cfg = moe_params
    x = torch.from_numpy(nprng.normal(size=(2, 12, D)).astype(np.float32))
    y, aux = moe_apply(p, x, cfg)
    close(y, moe_dense_oracle(p, x, cfg).numpy(), 1e-5)
    assert 1.0 <= float(aux) <= cfg.n_experts


def test_moe_grads_match_dense_oracle(moe_params, nprng):
    p, cfg = moe_params
    x = torch.from_numpy(nprng.normal(size=(2, 8, D)).astype(np.float32))
    g = torch.func.grad(lambda p: (moe_apply(p, x, cfg)[0] ** 2).sum())(p)
    g_o = torch.func.grad(lambda p: (moe_dense_oracle(p, x, cfg) ** 2).sum())(p)
    for name in g:
        np.testing.assert_allclose(g[name].numpy(), g_o[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_moe_capacity_dropping_zeroes_overflow(nprng):
    """Every token routed to one expert with capacity 1: exactly the first
    token is processed, the rest get an exact zero."""
    cfg = MoEConfig(n_experts=2, top_k=1, capacity_factor=0.1)
    assert moe_capacity(cfg, 8) == 1
    p = moe_init(torch.Generator().manual_seed(0), D, FF, cfg)
    p = dict(p, router=torch.zeros_like(p["router"]))  # tied logits: one expert for all
    x = torch.from_numpy(nprng.normal(size=(1, 8, D)).astype(np.float32))
    y, _ = moe_apply(p, x, cfg)
    assert float(y[0, 0].abs().sum()) > 0.0
    assert torch.equal(y[0, 1:], torch.zeros_like(y[0, 1:]))


def test_moe_capacity_formula():
    assert moe_capacity(MoEConfig(8, 2, 1.0), 64) == 16
    assert moe_capacity(MoEConfig(8, 2, 1.25), 64) == 20
    assert moe_capacity(MoEConfig(64, 1, 1.0), 8) == 1  # floor at 1


def test_llama_moe_trains(nprng):
    cfg = LlamaConfig.tiny(moe=MoEConfig(n_experts=4, top_k=2))
    model = llama_lm_model(cfg)
    trainer = make_local_trainer(model, batch_size=2, learning_rate=5e-2)
    toks = torch.from_numpy(nprng.integers(0, cfg.vocab_size, size=(2, cfg.max_len)))
    params = model.init(torch.Generator().manual_seed(0))
    _, _, hist = trainer.train(params, {"x": toks, "y": toks}, 2, 4,
                               generator=torch.Generator().manual_seed(1))
    assert float(hist[-1]) < float(hist[0])


def test_llama_moe_remat_grads(nprng):
    cfg = LlamaConfig.tiny(n_layers=1, moe=MoEConfig(n_experts=2, top_k=1))
    plain, remat = llama_lm_model(cfg), llama_lm_model(cfg, remat=True, name="llama_moe_remat")
    params = plain.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(nprng.integers(0, cfg.vocab_size, size=(2, cfg.max_len)))
    batch = {"x": toks, "y": toks}

    def loss(model):
        return lambda p: model.per_example_loss(p, batch).mean()

    g1, g2 = torch.func.grad(loss(plain))(params), torch.func.grad(loss(remat))(params)
    for name in g1:
        np.testing.assert_allclose(g1[name].numpy(), g2[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
