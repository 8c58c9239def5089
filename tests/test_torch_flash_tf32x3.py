"""The arithmetic of the fp32 backward kernels' 3xTF32 design
(``baton_tpu_torch/ops/csrc/flash_attention_tf32.cu``), emulated on the
CPU, against the JAX package's backward (``_bwd_call`` in Pallas interpret
mode, block 8), as ``tests/test_torch_flash_attention.py`` holds the plain
versions.

The kernels split each fp32 operand x of a product into big = rna(x) and
small = rna(x - big), both TF32 values rounded as ``cvt.rna.tf32.f32``
rounds (add 0x1000 to the fp32 bit pattern, clear the 13 low bits), and
take a.b as as.bb + ab.bs + ab.bb in fp32 accumulators. The emulation
computes each product as those three fp32 matmuls of the TF32 parts (each
product of two TF32 values is exact in fp32) and recomputes p and ds from
the forward's lse as the kernels do: dv = p^T.do, dk = ds^T.q·scale,
dq = ds.k·scale, dbias the sum of the unrounded ds. It must lie within the
port's fp32 gradient tolerance (1e-4) of JAX at D 64 and 128, with GQA,
causal masks, a ragged L, fully masked rows and a padding bias; one TF32
product alone (1xTF32) must not, which is why the kernels split."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.ops.flash_attention import _bwd_call as jax_bwd_call
from baton_tpu.ops.flash_attention import _fwd as jax_fwd
from baton_tpu_torch.ops import flash_attention as fa

# small shapes: one thread each keeps the parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

GRAD_TOL = 1e-4  # the port's fp32 gradient tolerance (rtol = atol)
BLOCK = 8  # JAX's blocks in interpret mode; L is padded to a multiple of it

# (b, hq, hkv, l, d, causal, bias kind)
CASES = {
    "d64": (1, 2, 2, 40, 64, False, None),
    "d128_causal": (1, 2, 2, 32, 128, True, None),
    "gqa_causal_padding": (1, 4, 2, 32, 64, True, "lengths"),
    "ragged_l": (2, 2, 2, 37, 64, False, "lengths"),
    "masked_rows": (2, 2, 2, 24, 64, False, "masked_rows"),
    "gqa_padding_d128": (2, 2, 1, 24, 128, False, "lengths"),
}


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does (to nearest,
    ties away from zero), kept in fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm_3xtf32(a, b):
    """a @ b (batched) as the kernels take it: as.bb + ab.bs + ab.bb."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm_1xtf32(a, b):
    """a @ b in one TF32 product: the negative control."""
    return tf32_rna(a) @ tf32_rna(b)


def bwd_emulated(mm, q, k, v, bias2d, out, dout, lse, causal, scale):
    """(dq, dk, dv, dbias) with every product through ``mm``, wrapped as
    ``fa._bwd`` wraps the kernels: delta before, the GQA fold after."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    k_h, v_h = fa._expand_kv(k, hq), fa._expand_kv(v, hq)
    delta = (dout * out).sum(-1)
    x = mm(q, k_h.transpose(-1, -2)) * scale + bias2d[:, None, None, :]
    if causal:
        keep = torch.arange(lq)[:, None] >= torch.arange(lk)[None, :]
        x = torch.where(keep, x, torch.full_like(x, fa.NEG_INF))
    p = torch.exp(x - lse[..., None])
    ds = p * (mm(dout, v_h.transpose(-1, -2)) - delta[..., None])
    dv_h = mm(p.transpose(-1, -2), dout)
    dk_h = scale * mm(ds.transpose(-1, -2), q)
    dq = scale * mm(ds, k_h)
    fold = lambda t: t.reshape(b, hkv, hq // hkv, lk, d).sum(2)  # noqa: E731
    return dq, fold(dk_h), fold(dv_h), ds.sum(2).sum(1)


def _inputs(seed, b, hq, hkv, l, d, bias_kind):
    rng = np.random.default_rng(seed)
    q, dout = (rng.standard_normal((b, hq, l, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, l, d)).astype(np.float32) for _ in range(2))
    valid = np.ones((b, l), bool)
    if bias_kind is not None:
        valid = np.arange(l)[None, :] < rng.integers(l // 2, l + 1, b)[:, None]
    if bias_kind == "masked_rows":
        valid[0] = False  # a zero-padded sample: every key masked
    bias2d = np.where(valid, 0.0, -1e30).astype(np.float32)
    return q, k, v, dout, bias2d


def _jax_backward(q, k, v, dout, bias2d, causal, scale):
    """JAX's forward and backward on the inputs padded to whole blocks
    (zero rows; padded keys get the -1e30 bias), cut back to L: out, lse,
    and (dq, dk, dv, dbias) as numpy arrays."""
    l = q.shape[2]
    pad = -l % BLOCK
    rows = lambda a: np.pad(a, ((0, 0), (0, 0), (0, pad), (0, 0)))  # noqa: E731
    jq, jk, jv, jdo = (jnp.asarray(rows(a)) for a in (q, k, v, dout))
    jb = jnp.asarray(np.pad(bias2d, ((0, 0), (0, pad)), constant_values=-1e30))
    out, lse = jax_fwd(jq, jk, jv, jb, causal, scale, BLOCK, BLOCK, True)
    grads = jax_bwd_call(jq, jk, jv, jb, out, jdo, lse, causal, scale, BLOCK, BLOCK, True)
    cut = [np.asarray(g)[:, :, :l] for g in grads[:3]] + [np.asarray(grads[3])[:, :l]]
    return np.asarray(out)[:, :, :l], np.asarray(lse)[:, :, :l], cut


def _case(name, mm, seed=0):
    b, hq, hkv, l, d, causal, bias_kind = CASES[name]
    q, k, v, dout, bias2d = _inputs(seed, b, hq, hkv, l, d, bias_kind)
    scale = d ** -0.5
    out, lse, want = _jax_backward(q, k, v, dout, bias2d, causal, scale)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, bias2d, out, dout, lse)]
    got = bwd_emulated(mm, *t, causal, scale)
    return [g.numpy() for g in got], want


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_backward_matches_jax(name):
    got, want = _case(name, mm_3xtf32)
    for what, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert np.isfinite(g).all(), what
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=what)


def test_1xtf32_backward_misses_the_fp32_tolerance():
    """The negative control: one TF32 product per fp32 product, seed 0, the
    D 128 causal case, is beyond 1e-4 of JAX in some gradient (the 3xTF32
    version of the same case is within it)."""
    got, want = _case("d128_causal", mm_1xtf32)
    worst = max(np.max(np.abs(g - w) / (GRAD_TOL + GRAD_TOL * np.abs(w)))
                for g, w in zip(got, want))
    assert worst > 1.0, worst


def test_split_gives_back_x_to_2_to_the_minus_22():
    """big + small is x to within 2^-22 of |x|, over magnitudes from 1e-30
    to 1e30, and both parts are TF32 (their 13 low bits clear)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.uniform(-30, 30, 100_000)).astype(np.float32))
    big, small = split(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = ((big.double() + small.double()) - x.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all(), (err / x.double().abs()).max()


def test_tf32_rounding_is_to_nearest_ties_away():
    """cvt.rna's rounding: 1 + 2^-11 (a tie) goes to 1 + 2^-10, and so
    does -(1 + 2^-11) in magnitude; below the tie it goes down."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -11 - 2.0 ** -23],
                     dtype=torch.float32)
    assert tf32_rna(x).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]
