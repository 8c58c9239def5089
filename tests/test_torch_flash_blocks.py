"""The port's ring block entry points ``flash_block_fwd`` and
``flash_block_bwd`` on the CPU (their plain versions) against the JAX
package's (``baton_tpu/ops/flash_attention.py:507-564``, the Pallas kernels
in interpret mode) on the same numpy inputs: Lq != Lk, ragged L, GQA, a
padding bias, the causal diagonal block, a block whose keys are all
padding, and the dtypes each returns. The backward runs against a global
out and lse that are not the block's own, as in the ring. Tolerances: fp32
1e-5, bf16 2e-2 (the port's kernel tolerances)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.ops.flash_attention import flash_block_bwd as jax_block_bwd
from baton_tpu.ops.flash_attention import flash_block_fwd as jax_block_fwd
from baton_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (b, hq, hkv, lq, lk, d, causal, bias kind, dtype): the bias kinds are
# None, "ragged" (each row's keys valid to a drawn length) and "all_padding"
CASES = {
    "square": (2, 4, 4, 16, 16, 8, False, None, "float32"),
    "lq_ne_lk": (2, 4, 4, 8, 24, 8, False, "ragged", "float32"),
    "ragged_l": (1, 2, 2, 20, 12, 8, False, "ragged", "float32"),
    "gqa": (2, 8, 2, 16, 16, 8, False, "ragged", "float32"),
    "causal_diagonal": (2, 4, 2, 16, 16, 8, True, "ragged", "float32"),
    "all_padding": (2, 4, 2, 16, 16, 8, False, "all_padding", "float32"),
    "bf16": (1, 4, 2, 16, 16, 8, False, "ragged", "bfloat16"),
    "bf16_causal": (1, 4, 4, 16, 16, 8, True, None, "bfloat16"),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """numpy inputs, and JAX's forward and backward outputs (once a case)."""
    b, hq, hkv, lq, lk, d, causal, bias_kind, dtype = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, lk, d)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    # a global out and lse from other keys, as the ring's backward has them
    out = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    lse = (rng.standard_normal((b, hq, lq)) + np.log(lk) + 2.0).astype(np.float32)
    valid = np.ones((b, lk), bool)
    if bias_kind == "ragged":
        valid = np.arange(lk)[None, :] < rng.integers(1, lk + 1, b)[:, None]
    elif bias_kind == "all_padding":
        valid[:] = False
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    arrays = {"q": q, "k": k, "v": v, "bias": bias, "out": out, "dout": dout, "lse": lse}
    jd = getattr(jnp, dtype)
    j = {n: jnp.asarray(a) if n in ("bias", "lse") else jnp.asarray(a).astype(jd)
         for n, a in arrays.items()}
    j_out, j_lse = jax_block_fwd(j["q"], j["k"], j["v"], j["bias"], causal, interpret=True)
    j_grads = jax_block_bwd(j["q"], j["k"], j["v"], j["bias"], j["out"], j["dout"], j["lse"],
                            causal, interpret=True)
    return arrays, (j_out, j_lse), j_grads


def _torch_inputs(name):
    arrays = _case(name)[0]
    td = getattr(torch, CASES[name][-1])
    return {n: torch.from_numpy(a) if n in ("bias", "lse") else torch.from_numpy(a).to(td)
            for n, a in arrays.items()}


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_block_forward_matches_jax(name):
    causal, dtype = CASES[name][6], CASES[name][-1]
    t = _torch_inputs(name)
    out, lse = fa.flash_block_fwd(t["q"], t["k"], t["v"], t["bias"], causal)
    j_out, j_lse = _case(name)[1]
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    assert str(j_out.dtype) == dtype and j_lse.dtype == jnp.float32
    assert out.shape == t["q"].shape and lse.shape == t["q"].shape[:3]
    _close(out, j_out, TOL[dtype], "out")
    if CASES[name][7] == "all_padding":
        # every key masked: lse sits at the mask's -1e30 (weight 0 when
        # combined), the output is the keys' plain mean, finite
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        assert (lse < -1e29).all()
        np.testing.assert_allclose(np.asarray(j_lse), lse.numpy(), rtol=1e-6)
    else:
        _close(lse, j_lse, TOL[dtype], "lse")


@pytest.mark.parametrize("name", list(CASES))
def test_block_backward_matches_jax(name):
    causal, dtype = CASES[name][6], CASES[name][-1]
    t = _torch_inputs(name)
    grads = fa.flash_block_bwd(t["q"], t["k"], t["v"], t["bias"], t["out"], t["dout"], t["lse"],
                               causal)
    j_grads = _case(name)[2]
    for g, jg, like, what in zip(grads, j_grads, ("q", "k", "v", "bias"),
                                 ("dq", "dk", "dv", "dbias")):
        # dq, dk, dv in their inputs' dtypes, dbias fp32, as JAX returns them
        want_dtype = torch.float32 if what == "dbias" else t[like].dtype
        assert g.dtype == want_dtype, what
        assert str(jg.dtype) == str(want_dtype).replace("torch.", ""), what
        assert g.shape == t[like].shape, what
        _close(g, jg, TOL[dtype], what)
    if CASES[name][7] == "all_padding":
        # against the global lse, a block of padding keys adds nothing
        for g in grads:
            assert torch.count_nonzero(g) == 0


def test_blocks_are_not_differentiable():
    t = _torch_inputs("square")
    q = t["q"].clone().requires_grad_()
    out, lse = fa.flash_block_fwd(q, t["k"], t["v"], t["bias"], False)
    assert not out.requires_grad and not lse.requires_grad
    grads = fa.flash_block_bwd(q, t["k"], t["v"], t["bias"], t["out"], t["dout"], t["lse"], False)
    assert not any(g.requires_grad for g in grads)


def test_a_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """The block wrappers go through the kernel wrappers: a tensor off the
    CPU reaches the kernel launch (stubbed here) and never the plain
    version."""
    q, k, v = (torch.randn(1, 2, 16, 64) for _ in range(3))
    monkeypatch.setattr(fa, "_on_cpu", lambda *xs: False)
    monkeypatch.setattr(fa, "_fwd_plain", lambda *a: pytest.fail("plain forward on a card"))
    launched = []

    def launch(name, device, *args):
        launched.append(name)
        raise RuntimeError("no card here")

    monkeypatch.setattr(fa, "_launch", launch)
    with pytest.raises(RuntimeError, match="no card"):
        fa.flash_block_fwd(q, k, v, torch.zeros(1, 16), False)
    assert launched == ["flash_fwd_tf32x3"]
