"""Sequence parallelism in the port on the CPU: every case of
tests/test_ring_attention.py (its 17 functions and their
parametrisations) on ``make_mesh(n, ("seq",), devices=[cpu] * n)`` with
the reference's n, held against the port's dense oracle
(``models.transformer.dot_product_attention``) at each case's own
tolerance (rtol 1e-4, atol 1e-5 for the kernels, 2e-4 for ring × flash,
the reference's looser bands for whole-decoder gradients). Added: a
shard whose keys are all padding, ring × flash under
``torch.func.vmap(grad)`` as ``LocalTrainer`` runs it, and the mesh
itself. The comparisons with the JAX functions are in
tests/test_torch_ring_attention_jax.py."""

import importlib

import numpy as np
import pytest
import torch

from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model
from baton_tpu_torch.models.transformer import dot_product_attention, padding_bias
from baton_tpu_torch.parallel.mesh import Mesh, make_mesh
from baton_tpu_torch.parallel.ring_attention import (
    flash_ring_attention,
    make_flash_ring_attention_fn,
    make_ring_attention_fn,
    make_striped_attention_fn,
    make_ulysses_attention_fn,
    ring_attention,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mesh(n):
    return make_mesh(n, axis_names=("seq",), devices=[CPU] * n)


def _qkv(nprng, b=2, hq=8, hkv=8, l=32, dh=4):
    q = torch.from_numpy(nprng.normal(size=(b, hq, l, dh)).astype(np.float32))
    k = torch.from_numpy(nprng.normal(size=(b, hkv, l, dh)).astype(np.float32))
    v = torch.from_numpy(nprng.normal(size=(b, hkv, l, dh)).astype(np.float32))
    return q, k, v


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=rtol,
                               atol=atol, err_msg=msg)


def _ragged_bias(nprng, b, l):
    """Per-row ragged valid lengths -> additive key bias [B, 1, 1, L]."""
    lengths = nprng.integers(l // 4, l + 1, size=b)
    mask = np.arange(l)[None, :] < lengths[:, None]
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)
    return torch.from_numpy(bias[:, None, None, :]), lengths


def _grads(fn, args, argnums):
    return torch.func.grad(fn, argnums=argnums)(*args)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_dense(nprng, causal):
    q, k, v = _qkv(nprng)
    out = make_ring_attention_fn(_mesh(8))(q, k, v, causal=causal)
    _close(out, dot_product_attention(q, k, v, causal=causal), 1e-4, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gqa(nprng, causal):
    q, k, v = _qkv(nprng, hq=8, hkv=2, l=16)
    out = make_ring_attention_fn(_mesh(4))(q, k, v, causal=causal)
    _close(out, dot_product_attention(q, k, v, causal=causal), 1e-4, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_dense(nprng, causal):
    q, k, v = _qkv(nprng, hq=8, hkv=8)
    out = make_ulysses_attention_fn(_mesh(8))(q, k, v, causal=causal)
    _close(out, dot_product_attention(q, k, v, causal=causal), 1e-4, 1e-5)


def _llama_batch(nprng, cfg):
    x = torch.from_numpy(nprng.integers(0, cfg.vocab_size, size=(2, cfg.max_len)).astype(np.int32))
    return {"x": x, "y": x}


def test_llama_with_ring_attention_matches_dense(nprng):
    """The attention_fn seam end to end: same params, same tokens, ring
    against dense decoder forward passes."""
    cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=4, max_len=32)
    dense_model = llama_lm_model(cfg)
    ring_model = llama_lm_model(cfg, attention_fn=make_ring_attention_fn(_mesh(8)),
                                name="llama_ring")
    params = dense_model.init(torch.Generator().manual_seed(0))
    batch = _llama_batch(nprng, cfg)
    _close(ring_model.apply(params, batch), dense_model.apply(params, batch), 2e-4, 2e-4)


def test_llama_ring_attention_grads_flow(nprng):
    """Ring attention is differentiable: gradients through the sharded
    kernel are finite and match dense-attention gradients."""
    cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=4, max_len=16)
    dense_model = llama_lm_model(cfg)
    ring_model = llama_lm_model(cfg, attention_fn=make_ring_attention_fn(_mesh(4)),
                                name="llama_ring")
    params = dense_model.init(torch.Generator().manual_seed(0))
    batch = _llama_batch(nprng, cfg)

    def loss(model):
        return lambda p: model.per_example_loss(p, batch).mean()

    g_dense = torch.func.grad(loss(dense_model))(params)
    g_ring = torch.func.grad(loss(ring_model))(params)
    for name in g_dense:
        assert torch.isfinite(g_ring[name]).all(), name
        _close(g_ring[name], g_dense[name], 5e-3, 5e-4, name)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_padded_bias_matches_dense(nprng, causal):
    q, k, v = _qkv(nprng)
    bias, lengths = _ragged_bias(nprng, q.shape[0], q.shape[2])
    out = make_ring_attention_fn(_mesh(8))(q, k, v, bias=bias, causal=causal)
    oracle = dot_product_attention(q, k, v, bias=bias, causal=causal)
    # only valid query rows are meaningful (the model's loss mask drops the rest)
    for row, n_valid in enumerate(lengths):
        _close(out[row, :, :n_valid], oracle[row, :, :n_valid], 1e-4, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_padded_bias_gqa(nprng, causal):
    q, k, v = _qkv(nprng, hq=8, hkv=2, l=16)
    bias, lengths = _ragged_bias(nprng, q.shape[0], 16)
    out = make_ring_attention_fn(_mesh(4))(q, k, v, bias=bias, causal=causal)
    oracle = dot_product_attention(q, k, v, bias=bias, causal=causal)
    for row, n_valid in enumerate(lengths):
        _close(out[row, :, :n_valid], oracle[row, :, :n_valid], 1e-4, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_padded_bias_matches_dense(nprng, causal):
    q, k, v = _qkv(nprng)
    bias, lengths = _ragged_bias(nprng, q.shape[0], q.shape[2])
    out = make_ulysses_attention_fn(_mesh(8))(q, k, v, bias=bias, causal=causal)
    oracle = dot_product_attention(q, k, v, bias=bias, causal=causal)
    for row, n_valid in enumerate(lengths):
        _close(out[row, :, :n_valid], oracle[row, :, :n_valid], 1e-4, 1e-5)


def test_sp_bias_rejects_non_key_bias(nprng):
    q, k, v = _qkv(nprng, l=16)
    full = torch.zeros((2, 1, 16, 16))  # a per-(query, key) bias
    for make in (make_ring_attention_fn, make_flash_ring_attention_fn,
                 make_ulysses_attention_fn):
        with pytest.raises(ValueError, match="per-key bias"):
            make(_mesh(4))(q, k, v, bias=full)


def test_ring_bias_gradients_flow(nprng):
    """SP attention with a bias stays differentiable (BERT training)."""
    q, k, v = _qkv(nprng, l=16)
    bias, _ = _ragged_bias(nprng, 2, 16)
    ring = make_ring_attention_fn(_mesh(4))

    def f(q, k, v):
        return (ring(q, k, v, bias=bias) ** 2).sum()

    def f_ref(q, k, v):
        return (dot_product_attention(q, k, v, bias=bias) ** 2).sum()

    for a, b in zip(_grads(f, (q, k, v), (0, 1, 2)), _grads(f_ref, (q, k, v), (0, 1, 2))):
        _close(a, b, 1e-3, 1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_matches_dense(nprng, causal):
    q, k, v = _qkv(nprng, l=32)
    out = make_flash_ring_attention_fn(_mesh(4))(q, k, v, causal=causal)
    _close(out, dot_product_attention(q, k, v, causal=causal), 2e-4, 2e-5)


def test_flash_ring_gqa_with_padded_bias(nprng):
    q, k, v = _qkv(nprng, hq=8, hkv=2, l=16)
    bias, _ = _ragged_bias(nprng, q.shape[0], 16)
    out = make_flash_ring_attention_fn(_mesh(4))(q, k, v, bias=bias)
    _close(out, dot_product_attention(q, k, v, bias=bias), 2e-4, 2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_grads_match_dense(nprng, causal):
    """The ring-level autograd.Function: dq plus the ring-rotated dk/dv
    match dense-attention gradients."""
    q, k, v = _qkv(nprng, hq=4, hkv=4, l=16)
    ring_fn = make_flash_ring_attention_fn(_mesh(4))

    def loss(fn):
        return lambda q, k, v: (fn(q, k, v, causal=causal) ** 2).sum()

    g_ring = _grads(loss(ring_fn), (q, k, v), (0, 1, 2))
    g_dense = _grads(loss(dot_product_attention), (q, k, v), (0, 1, 2))
    for gr, gd, name in zip(g_ring, g_dense, "qkv"):
        _close(gr, gd, 5e-4, 5e-5, f"d{name} mismatch")


def test_flash_ring_bias_grads(nprng):
    """Every cotangent of the biased ring backward: dq, the ring-homed
    dk/dv accumulators and the bias's own (a rotation-count fault would
    give one shard's dbias to another)."""
    q, k, v = _qkv(nprng, hq=4, hkv=4, l=16)
    bias, _ = _ragged_bias(nprng, q.shape[0], 16)
    ring_fn = make_flash_ring_attention_fn(_mesh(2))

    def loss(fn):
        return lambda q, k, v, b: (fn(q, k, v, bias=b) ** 2).sum()

    g_ring = _grads(loss(ring_fn), (q, k, v, bias), (0, 1, 2, 3))
    g_dense = _grads(loss(dot_product_attention), (q, k, v, bias), (0, 1, 2, 3))
    for gr, gd, name in zip(g_ring, g_dense, ("q", "k", "v", "bias")):
        _close(gr, gd, 5e-4, 5e-5, f"d{name} mismatch")


@pytest.mark.parametrize("causal", [False, True])
def test_striped_matches_dense(nprng, causal):
    q, k, v = _qkv(nprng)
    out = make_striped_attention_fn(_mesh(8))(q, k, v, causal=causal)
    _close(out, dot_product_attention(q, k, v, causal=causal), 1e-4, 1e-5)


def test_striped_gqa_bias_and_grads(nprng):
    """Striped causal attention with GQA heads and a padding-key bias:
    outputs and every cotangent match dense attention."""
    q, k, v = _qkv(nprng, hq=8, hkv=2)
    mask = np.ones((2, 32), np.float32)
    mask[:, 28:] = 0.0  # last tokens padded
    bias = padding_bias(torch.from_numpy(mask))
    striped = make_striped_attention_fn(_mesh(8))

    def loss(fn):
        return lambda q, k, v: torch.tanh(fn(q, k, v, bias=bias, causal=True).float()).sum()

    _close(striped(q, k, v, bias=bias, causal=True),
           dot_product_attention(q, k, v, bias=bias, causal=True), 1e-4, 1e-5)
    for a, b in zip(_grads(loss(striped), (q, k, v), (0, 1, 2)),
                    _grads(loss(dot_product_attention), (q, k, v), (0, 1, 2))):
        _close(a, b, 2e-4, 2e-5)


def test_striped_llama_decoder_end_to_end(nprng):
    """The striped seam drops into the decoder like the ring seam: a
    training-loss forward matches the dense-attention model."""
    cfg = LlamaConfig.tiny(max_len=32, n_heads=4, n_kv_heads=2)
    dense_m = llama_lm_model(cfg)
    striped_m = llama_lm_model(cfg, attention_fn=make_striped_attention_fn(_mesh(8)))
    params = dense_m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(nprng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
    batch = {"x": toks, "y": toks}
    _close(striped_m.per_example_loss(params, batch), dense_m.per_example_loss(params, batch),
           1e-4, 1e-5)


# ----------------------------------------------------------------------
# added cases: all-padding shards, vmap(grad), the skip rule, the mesh


@pytest.mark.parametrize("kind", ["ring", "flash", "striped", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_shards_whose_keys_are_all_padding(nprng, kind, causal):
    """Row 0 keeps 5 of 32 keys, so on 8 shards of 4 the last six shards
    hold only padding: their blocks get weight 0 in the combine and every
    output and gradient stays finite and equal to the dense oracle's, on
    every row (the masked keys count for nothing anywhere)."""
    q, k, v = _qkv(nprng, hq=8, hkv=8, l=32)
    mask = np.ones((2, 32), np.float32)
    mask[0, 5:] = 0.0
    mask[1, 30:] = 0.0
    bias = padding_bias(torch.from_numpy(mask))
    make = {"ring": make_ring_attention_fn, "flash": make_flash_ring_attention_fn,
            "striped": make_striped_attention_fn, "ulysses": make_ulysses_attention_fn}[kind]
    fn = make(_mesh(8))

    def loss(f):
        return lambda q, k, v, b: (f(q, k, v, bias=b, causal=causal) ** 2).sum()

    out = fn(q, k, v, bias=bias, causal=causal)
    assert torch.isfinite(out).all()
    _close(out, dot_product_attention(q, k, v, bias=bias, causal=causal), 2e-4, 2e-5)
    got = _grads(loss(fn), (q, k, v, bias), (0, 1, 2, 3))
    want = _grads(loss(dot_product_attention), (q, k, v, bias), (0, 1, 2, 3))
    for a, b, name in zip(got, want, ("q", "k", "v", "bias")):
        assert torch.isfinite(a).all(), name
        _close(a, b, 5e-4, 5e-5, f"d{name}")


def test_flash_ring_under_vmap_of_grad(nprng):
    """``torch.func.vmap(grad(...))`` over a client axis, as LocalTrainer
    runs it: the ring's vmap rule folds the clients into the batch; k and
    v shared by every client (unbatched) work too."""
    q = torch.from_numpy(nprng.normal(size=(3, 2, 4, 16, 8)).astype(np.float32))
    k, v = (torch.from_numpy(nprng.normal(size=(3, 2, 2, 16, 8)).astype(np.float32))
            for _ in range(2))
    bias, _ = _ragged_bias(nprng, 2, 16)
    ring = make_flash_ring_attention_fn(_mesh(4))

    def loss(fn):
        return lambda q, k, v: (fn(q, k, v, bias=bias, causal=True) ** 2).sum()

    got = torch.func.vmap(torch.func.grad(loss(ring), argnums=(0, 1, 2)))(q, k, v)
    want = torch.func.vmap(torch.func.grad(loss(dot_product_attention), argnums=(0, 1, 2)))(
        q, k, v)
    for a, b, name in zip(got, want, "qkv"):
        _close(a, b, 5e-4, 5e-5, f"d{name}")
    got = torch.func.vmap(torch.func.grad(loss(ring)), in_dims=(0, None, None))(q, k[0], v[0])
    want = torch.func.vmap(torch.func.grad(loss(dot_product_attention)),
                           in_dims=(0, None, None))(q, k[0], v[0])
    _close(got, want, 5e-4, 5e-5)


def test_causal_rings_attend_each_block_once(nprng, monkeypatch):
    """The skip rule: a causal flash ring of N shards makes N + N(N-1)/2
    block forwards (the diagonal once, then only blocks from the past), so
    the diagonal is never counted twice; the dense ring agrees with the
    oracle on the same rule."""
    # the module (the package exports a function of the same name)
    ra = importlib.import_module("baton_tpu_torch.parallel.ring_attention")
    calls = []
    real = ra.flash_block_fwd

    def counting(q, k, v, b, causal):
        calls.append(causal)
        return real(q, k, v, b, causal)

    monkeypatch.setattr(ra, "flash_block_fwd", counting)
    q, k, v = _qkv(nprng, l=32)
    shards = [list(torch.chunk(x, 8, dim=2)) for x in (q, k, v)]
    outs = flash_ring_attention(*shards, causal=True)
    assert calls.count(True) == 8 and calls.count(False) == 28
    _close(torch.cat(outs, 2), dot_product_attention(q, k, v, causal=True), 2e-4, 2e-5)
    calls.clear()
    flash_ring_attention(*shards, causal=False)
    assert calls == [False] * 64
    _close(torch.cat(ring_attention(*shards, causal=True), 2),
           dot_product_attention(q, k, v, causal=True), 1e-4, 1e-5)


def test_mesh_shape_and_repeated_devices():
    mesh = make_mesh(4, axis_names=("seq", "model"), devices=[CPU] * 6)
    assert isinstance(mesh, Mesh) and mesh.shape == {"seq": 4, "model": 1}
    assert mesh.axis_names == ("seq", "model")
    assert mesh.axis_devices("seq") == [CPU] * 4
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_devices("clients")
    with pytest.raises(ValueError, match="divisible"):
        make_ring_attention_fn(_mesh(3))(*_qkv(np.random.default_rng(0), l=16))
    with pytest.raises(ValueError, match="head counts"):
        make_ulysses_attention_fn(_mesh(4))(*_qkv(np.random.default_rng(0), hq=8, hkv=2))


def test_make_mesh_needs_a_gpu_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert make_mesh(2, devices=["cpu", "cpu", "cpu"]).shape == {"clients": 2}
