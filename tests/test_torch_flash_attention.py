"""The port's flash attention on the CPU (its plain versions, through the
autograd Functions) against the JAX package: the Pallas kernels in
interpret mode, their private ``_fwd``/``_bwd_call`` for lse and the
backward outputs, and the dense ``dot_product_attention``. Replays every
case of tests/test_flash_attention.py; fp32 values 1e-5, gradients 1e-4,
bf16 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.models.transformer import dot_product_attention as jax_dense
from baton_tpu.models.transformer import padding_bias as jax_padding_bias
from baton_tpu.ops.flash_attention import _bwd_call as jax_bwd_call
from baton_tpu.ops.flash_attention import _fwd as jax_fwd
from baton_tpu.ops.flash_attention import flash_attention as jax_flash
from baton_tpu_torch.ops import flash_attention as fa

# small shapes: one thread each keeps the parallel test workers from
# oversubscribing the cores (and runs these tests faster)
torch.set_num_threads(1)

# (b, hq, hkv, l, d, causal, valid keys or None, dtype) — the shapes of
# tests/test_flash_attention.py
CASES = {
    "dense": (2, 4, 4, 32, 16, False, None, "float32"),
    "dense_causal": (2, 4, 4, 32, 16, True, None, "float32"),
    "key_bias": (2, 2, 2, 16, 8, False, 12, "float32"),
    "gqa": (1, 8, 2, 16, 8, True, None, "float32"),
    "unpadded_length": (1, 2, 2, 20, 8, True, None, "float32"),
    "grad_bias": (2, 4, 2, 16, 8, False, 13, "float32"),
    "grad_bias_causal": (2, 4, 2, 16, 8, True, 13, "float32"),
    "gqa_fold": (1, 4, 1, 8, 8, True, None, "float32"),
    "bfloat16": (1, 2, 2, 16, 8, True, None, "bfloat16"),
}


def _inputs(seed, b, hq, hkv, l, d, valid, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, l, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, l, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, l, d)).astype(np.float32)
    dout = rng.standard_normal((b, hq, l, d)).astype(np.float32)
    mask = None
    if valid is not None:
        mask = (np.arange(l)[None, :] < valid).astype(np.float32).repeat(b, 0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(a).astype(jd) for a in (q, k, v, dout)]
    tx = [torch.from_numpy(a).to(td) for a in (q, k, v, dout)]
    return jx, tx, mask


def _np(x):
    return np.asarray(x.float().detach()) if torch.is_tensor(x) else np.asarray(x, np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_kernels(name):
    b, hq, hkv, l, d, causal, valid, dtype = CASES[name]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), mask = _inputs(0, b, hq, hkv, l, d, valid, dtype)
    jbias = None if mask is None else jax_padding_bias(jnp.asarray(mask))
    tbias = None if mask is None else torch.from_numpy(np.array(jbias))
    fwd_tol = 1e-5 if dtype == "float32" else 2e-2
    grad_tol = 1e-4 if dtype == "float32" else 2e-2

    # forward: the Pallas kernel (interpret mode) and the dense oracle
    want = jax_flash(jq, jk, jv, bias=jbias, causal=causal, block_q=8, block_k=8)
    dense = jax_dense(jq, jk, jv, bias=jbias, causal=causal)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    got = fa.flash_attention(tq, tk, tv, bias=tbias, causal=causal)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=fwd_tol, atol=fwd_tol)
    np.testing.assert_allclose(_np(got), _np(dense), rtol=fwd_tol, atol=fwd_tol)

    # gradients (incl. dbias) of sum(out·cos(out)), as the JAX test takes them
    def jax_loss(q, k, v, bias):
        out = jax_flash(q, k, v, bias=bias, causal=causal, block_q=8, block_k=8)
        return (out * jnp.cos(out)).sum()

    bias_arg = jnp.zeros((b, 1, 1, l)) if jbias is None else jbias
    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(jq, jk, jv, bias_arg)
    tb = torch.from_numpy(np.array(bias_arg)).requires_grad_()
    out = fa.flash_attention(tq, tk, tv, bias=tb, causal=causal)
    tgrads = torch.autograd.grad((out * torch.cos(out)).sum(), (tq, tk, tv, tb))
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(_np(g), _np(w), rtol=grad_tol, atol=grad_tol)


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][3] % 8 == 0])
def test_plain_versions_match_private_kernels(name):
    """lse and the backward outputs of the plain versions against JAX's
    ``_fwd``/``_bwd_call`` directly (block 8, interpret mode)."""
    b, hq, hkv, l, d, causal, valid, dtype = CASES[name]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), mask = _inputs(1, b, hq, hkv, l, d, valid, dtype)
    bias2d = np.zeros((b, l), np.float32) if mask is None else (1.0 - mask) * -1e30
    scale = d ** -0.5
    tol = 1e-5 if dtype == "float32" else 2e-2
    grad_tol = 1e-4 if dtype == "float32" else 2e-2
    jout, jlse = jax_fwd(jq, jk, jv, jnp.asarray(bias2d), causal, scale, 8, 8, True)
    tb = torch.from_numpy(bias2d)
    tout, tlse = fa._fwd_plain(tq, tk, tv, tb, causal, scale)
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(tlse), _np(jlse), rtol=tol, atol=tol)

    jgrads = jax_bwd_call(jq, jk, jv, jnp.asarray(bias2d), jout, jdo, jlse,
                          causal, scale, 8, 8, True)
    tgrads = fa._bwd(tq, tk, tv, tb, tout, tdo, tlse, causal, scale)
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(_np(g), _np(w), rtol=grad_tol, atol=grad_tol)
    if hq == hkv:  # no GQA fold: the per-head kernel outputs are the gradients
        delta = (tdo.float() * tout.float()).sum(-1)
        dk_h, dv_h, db_h = fa._bwd_dkv_plain(tq, tk, tv, tb, tdo, tlse, delta, causal, scale)
        np.testing.assert_allclose(_np(dk_h), _np(jgrads[1]), rtol=grad_tol, atol=grad_tol)
        np.testing.assert_allclose(_np(dv_h), _np(jgrads[2]), rtol=grad_tol, atol=grad_tol)


def test_fully_masked_rows_stay_finite():
    """A zero-padded sample masks every key: NEG_INF is finite, so its
    attention is a uniform average (as in JAX) and nothing turns NaN."""
    (jq, jk, jv, _), (tq, tk, tv, _), _ = _inputs(2, 2, 2, 2, 16, 8, None, "float32")
    mask = np.ones((2, 16), np.float32)
    mask[1] = 0.0
    jbias = jax_padding_bias(jnp.asarray(mask))
    tbias = torch.from_numpy(np.array(jbias))
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    out = fa.flash_attention(tq, tk, tv, bias=tbias)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(_np(out[1]), _np(tv[1].mean(dim=1, keepdim=True).expand_as(tv[1])),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(out), _np(jax_dense(jq, jk, jv, bias=jbias)),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(out.sum(), (tq, tk, tv))
    assert all(torch.isfinite(g).all() for g in grads)


def test_vmap_grad_folds_clients_into_one_launch_per_pass():
    """vmap(grad) through the autograd Functions equals a per-client loop,
    with every client's tensors going through one call per pass."""
    c, b, h, l, d = 3, 2, 2, 8, 8
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((c, b, h, l, d)).astype(np.float32))
               for _ in range(3))
    bias = torch.from_numpy(
        np.where(rng.random((c, b, 1, 1, l)) < 0.8, 0.0, -1e30).astype(np.float32))

    def loss(q, k, v, bias):
        out = fa.flash_attention(q, k, v, bias=bias)
        return (out * torch.cos(out)).sum()

    calls = {"fwd": 0, "bwd": 0}
    fwd_plain, bwd_dq_plain = fa._fwd_plain, fa._bwd_dq_plain

    def counted_fwd(*a):
        calls["fwd"] += 1
        return fwd_plain(*a)

    def counted_bwd(*a):
        calls["bwd"] += 1
        return bwd_dq_plain(*a)

    fa._fwd_plain, fa._bwd_dq_plain = counted_fwd, counted_bwd
    try:
        got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(q, k, v, bias)
    finally:
        fa._fwd_plain, fa._bwd_dq_plain = fwd_plain, bwd_dq_plain
    assert calls == {"fwd": 1, "bwd": 1}
    for i in range(c):
        want = torch.func.grad(loss, argnums=(0, 1, 2))(q[i], k[i], v[i], bias[i])
        for g, w in zip(got, want):
            torch.testing.assert_close(g[i], w, rtol=1e-6, atol=1e-6)


def test_no_fallback_for_other_devices():
    """Only CPU tensors take the plain path; anything else goes to the
    kernel or raises, and the CPU path counts no launch."""
    fa.reset_launches()
    q = torch.zeros((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    x = torch.randn(1, 1, 8, 64)
    fa.flash_attention(x, x, x)
    assert fa.launches() == {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0}
