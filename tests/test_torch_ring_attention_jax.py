"""The port's sequence-parallel kernels against the JAX package's on the
same numpy inputs: ring × flash (the port's block wrappers on the plain
path; JAX's Pallas kernels in interpret mode under ``shard_map`` on its
8-device virtual CPU mesh) and the dense ring, forward and the vjp of a
drawn cotangent for q, k, v and the padding bias. The port's mesh repeats
the CPU as often as JAX's has devices. JAX runs once per case (a
module-scoped cache). Tolerances: fp32 outputs 1e-5 and gradients 1e-4
(tests/test_torch_flash_attention.py's), bf16 2e-2."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.parallel.mesh import make_mesh as jax_make_mesh
from baton_tpu.parallel.ring_attention import (
    make_flash_ring_attention_fn as jax_flash_ring_fn,
    make_ring_attention_fn as jax_ring_fn,
)
from baton_tpu_torch.parallel.mesh import make_mesh
from baton_tpu_torch.parallel.ring_attention import (
    make_flash_ring_attention_fn,
    make_ring_attention_fn,
)

torch.set_num_threads(1)

# (kernel, n, b, hq, hkv, l, d, causal, valid lengths or None, dtype)
CASES = {
    "flash_causal_gqa_bias": ("flash", 4, 2, 4, 2, 16, 8, True, (5, 16), "float32"),
    "flash_full_8": ("flash", 8, 1, 4, 4, 32, 8, False, None, "float32"),
    "flash_all_padding_shards": ("flash", 8, 2, 4, 2, 32, 8, True, (3, 29), "float32"),
    "flash_bf16_causal": ("flash", 4, 1, 4, 2, 32, 8, True, (20,), "bfloat16"),
    "dense_causal_bias": ("dense", 8, 2, 4, 2, 32, 8, True, (9, 32), "float32"),
}
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


def _arrays(name):
    _, n, b, hq, hkv, l, d, causal, lengths, dtype = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((b, hq, l, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, l, d)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((b, hq, l, d)).astype(np.float32)
    bias = None
    if lengths is not None:
        valid = np.arange(l)[None, :] < np.asarray(lengths)[:, None]
        bias = np.where(valid, 0.0, -1e30).astype(np.float32)[:, None, None, :]
    return q, k, v, dout, bias


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """JAX's output and its vjp of the case's cotangent (numpy fp32)."""
    kind, n, *_, causal, _, dtype = CASES[name]
    q, k, v, dout, bias = _arrays(name)
    mesh = jax_make_mesh(n, axis_names=("seq",))
    fn = (jax_flash_ring_fn if kind == "flash" else jax_ring_fn)(mesh)
    jd = getattr(jnp, dtype)
    args = [jnp.asarray(a).astype(jd) for a in (q, k, v)]
    if bias is None:
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, causal=causal), *args)
    else:
        args.append(jnp.asarray(bias))
        out, vjp = jax.vjp(lambda q, k, v, b: fn(q, k, v, bias=b, causal=causal), *args)
    grads = vjp(jnp.asarray(dout).astype(jd))
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_the_jax_ring(name):
    kind, n, *_, causal, _, dtype = CASES[name]
    q, k, v, dout, bias = _arrays(name)
    mesh = make_mesh(n, ("seq",), devices=[torch.device("cpu")] * n)
    fn = (make_flash_ring_attention_fn if kind == "flash" else make_ring_attention_fn)(mesh)
    td = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    if bias is not None:
        args.append(torch.from_numpy(bias).requires_grad_())
    out = fn(*args[:3], bias=None if bias is None else args[3], causal=causal)
    assert out.dtype == td
    grads = torch.autograd.grad(out, args, torch.from_numpy(dout).to(td))
    j_out, j_grads = _jax_case(name)
    tol_out, tol_grad = TOL[dtype]
    np.testing.assert_allclose(out.detach().float().numpy(), j_out, rtol=tol_out, atol=tol_out)
    for g, jg, what, a in zip(grads, j_grads, ("q", "k", "v", "bias"), args):
        assert g.dtype == a.dtype, what
        assert np.isfinite(g.float().numpy()).all(), what
        np.testing.assert_allclose(g.float().numpy(), jg, rtol=tol_grad, atol=tol_grad,
                                   err_msg=f"d{what}")
