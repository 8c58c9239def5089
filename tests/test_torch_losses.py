"""The port's per-example losses against the JAX package's on the same
seeded numpy inputs: ``sigmoid_binary_cross_entropy`` (its stable form
holds where the naive one overflows in fp32, logits up to |x| = 80; [B]
and [B, 1] logits), ``softmax_cross_entropy`` and ``mse``, each in fp32
within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.core import losses as jlosses
from baton_tpu_torch.core import losses

TOL = 1e-6


def _binary(seed, b, scale, trailing):
    rng = np.random.default_rng(seed)
    logits = (rng.uniform(-1.0, 1.0, (b,)) * scale).astype(np.float32)
    logits[:4] = [80.0, -80.0, 0.0, -0.0]
    y = rng.integers(0, 2, b).astype(np.int32)
    y[:2] = [0, 1]  # the largest losses: 80 each
    return (logits[:, None] if trailing else logits), y


@pytest.mark.parametrize("trailing", [False, True], ids=["[B]", "[B,1]"])
@pytest.mark.parametrize("scale", [4.0, 80.0])
def test_sigmoid_binary_cross_entropy_matches_jax(scale, trailing):
    logits, y = _binary(7, 64, scale, trailing)
    got = losses.sigmoid_binary_cross_entropy(torch.from_numpy(logits), {"y": torch.from_numpy(y)})
    want = np.asarray(jlosses.sigmoid_binary_cross_entropy(jnp.asarray(logits),
                                                           {"y": jnp.asarray(y)}, None))
    assert got.dtype == torch.float32 and got.shape == (64,)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    x = logits.reshape(-1).astype(np.float64)
    exact = np.maximum(x, 0) - x * y + np.log1p(np.exp(-np.abs(x)))
    np.testing.assert_allclose(got.numpy(), exact, rtol=TOL, atol=TOL)
    assert got[0].item() == pytest.approx(80.0) and got[1].item() == pytest.approx(80.0)


def test_the_naive_form_overflows_where_the_stable_one_does_not():
    logits, y = _binary(8, 16, 80.0, False)
    x, t = torch.from_numpy(logits), torch.from_numpy(y).float()
    naive = -(t * torch.log(torch.sigmoid(x)) + (1 - t) * torch.log(1 - torch.sigmoid(x)))
    assert not torch.isfinite(naive).all()
    assert torch.isfinite(losses.sigmoid_binary_cross_entropy(x, {"y": t})).all()


def test_bf16_logits_give_fp32_losses():
    logits, y = _binary(9, 32, 8.0, True)
    half = torch.from_numpy(logits).bfloat16()
    got = losses.sigmoid_binary_cross_entropy(half, {"y": torch.from_numpy(y)})
    want = np.asarray(jlosses.sigmoid_binary_cross_entropy(
        jnp.asarray(half.float().numpy()).astype(jnp.bfloat16), {"y": jnp.asarray(y)}, None))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_softmax_cross_entropy_and_mse_match_jax():
    rng = np.random.default_rng(10)
    logits = (rng.normal(size=(16, 10)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    got = losses.softmax_cross_entropy(torch.from_numpy(logits), {"y": torch.from_numpy(labels)})
    want = jlosses.softmax_cross_entropy(jnp.asarray(logits), {"y": jnp.asarray(labels)}, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for shape in ((16, 1), (16, 3, 2)):
        out = rng.normal(size=shape).astype(np.float32)
        y = rng.normal(size=shape if shape[-1] != 1 else shape[:1]).astype(np.float32)
        got = losses.mse(torch.from_numpy(out), {"y": torch.from_numpy(y)})
        want = jlosses.mse(jnp.asarray(out), {"y": jnp.asarray(y)}, None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
