"""The port's transformer blocks and BERT classifier against the JAX
package on the same weights (carried across by the weights bridge) and
the same numpy inputs: fp32 1e-5, bf16 compute 2e-2. On the CPU the
port's attention runs the flash kernels' plain versions, the JAX side
its dense einsum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.models import transformer as jt
from baton_tpu.models.bert import BertConfig as JaxBertConfig
from baton_tpu.models.bert import bert_classifier_model as jax_bert
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu_torch.models import transformer as tt
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.server.state import state_dict_to_params

# small shapes: one thread each keeps the parallel test workers from
# oversubscribing the cores (and runs these tests faster)
torch.set_num_threads(1)

B, L, D, H, FF = 3, 16, 32, 4, 64


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mask():
    lengths = np.array([16, 9, 1])
    return (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)


def _port(jax_params):
    """JAX params (a pytree) -> the port's flat dict, through the bridge."""
    state = jax_to_state(jax_params)
    template = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    return state_dict_to_params(template, state, device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_layer_norm():
    x = _x(0, B, L, D) * 3 + 1
    p = {"scale": jnp.asarray(_x(1, D)), "bias": jnp.asarray(_x(2, D))}
    want = jt.layer_norm(jnp.asarray(x), p)
    got = tt.layer_norm(torch.from_numpy(x), _port(p))
    _close(got, want, 1e-5)


def test_gelu_mlp():
    p = jt.gelu_mlp_init(jax.random.key(0), D, FF)
    x = _x(1, B, L, D)
    _close(tt.gelu_mlp_apply(_port(p), torch.from_numpy(x)),
           jt.gelu_mlp_apply(p, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_with_padding(causal):
    p = jt.mha_init(jax.random.key(1), D, H)
    x, mask = _x(2, B, L, D), _mask()
    want = jt.mha_apply(p, jnp.asarray(x), H, bias=jt.padding_bias(jnp.asarray(mask)),
                        causal=causal)
    got = tt.mha_apply(_port(p), torch.from_numpy(x), H,
                       bias=tt.padding_bias(torch.from_numpy(mask)), causal=causal)
    _close(got, want, 1e-5)


def test_dense_attention_matches():
    """The port's dense path (taken for biases that are not per-key)."""
    q, k, v = _x(3, B, H, L, 8), _x(4, B, 2, L, 8), _x(5, B, 2, L, 8)
    bias = _x(6, B, H, L, L)
    want = jt.dot_product_attention(*map(jnp.asarray, (q, k, v, bias)), causal=True)
    got = tt.default_attention(*map(torch.from_numpy, (q, k, v, bias)), causal=True)
    _close(got, want, 1e-5)


def test_prenorm_block():
    p = jt.prenorm_block_init(jax.random.key(2), D, H, FF)
    x, mask = _x(3, B, L, D), _mask()
    want = jt.prenorm_block_apply(p, jnp.asarray(x), H,
                                  bias=jt.padding_bias(jnp.asarray(mask)))
    got = tt.prenorm_block_apply(_port(p), torch.from_numpy(x), H,
                                 bias=tt.padding_bias(torch.from_numpy(mask)))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_bert_tiny_logits_and_loss(dtype, tol):
    jmodel = jax_bert(JaxBertConfig.tiny(), compute_dtype=getattr(jnp, dtype))
    tmodel = bert_classifier_model(BertConfig.tiny(), compute_dtype=getattr(torch, dtype))
    jparams = jmodel.init(jax.random.key(3))
    rng = np.random.default_rng(4)
    batch = {"x": rng.integers(0, 128, (B, L)).astype(np.int32),
             "attn_mask": _mask(),
             "y": rng.integers(0, 4, B).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tparams = _port(jparams)
    _close(tmodel.apply(tparams, tbatch), jmodel.apply(jparams, jbatch, None), tol)
    _close(tmodel.per_example_loss(tparams, tbatch),
           jmodel.per_example_loss(jparams, jbatch, None), tol)
