"""``chip_smoke.flip_check`` on the CPU. The check bounds each element of
the bf16 dkv and dq kernels' gaps from their plain versions by the bf16
rounding flips of p and ds they can come from. Here each plain version is
evaluated a second way that forms p and ds as the tensor-core kernels do
(the score rounded once, as by ``fmaf``, then ``exp2``). That gap must lie
within the bound at every element. An error in p of 3e-4, far below
bf16's resolution, must not."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from baton_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _inputs(b, hq, hkv, l, d, bias_kind):
    gen = torch.Generator().manual_seed(0)
    q, dout = (torch.randn(b, hq, l, d, generator=gen).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, hkv, l, d, generator=gen).bfloat16() for _ in range(2))
    valid = np.arange(l)[None, :] < np.random.default_rng(0).integers(16, l + 1, b)[:, None]
    if bias_kind == "masked_rows":
        valid[0] = False  # a zero-padded sample: every key masked
    bias = torch.from_numpy(np.where(valid, 0.0, -1e30).astype(np.float32))
    return q, k, v, dout, bias


def _p_ds_as_the_kernel_forms_them(q, k, v, bias, dout, lse, delta, causal, scale, p_error):
    """p and ds for the expanded k, v: the score rounded once to fp32, p
    from exp2, times ``1 + p_error``."""
    hq = q.shape[1]
    k, v = fa._expand_kv(k, hq), fa._expand_kv(v, hq)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double())
    x = (s * scale + bias.double()[:, None, None, :]).float()
    if causal:
        lq, lk = x.shape[-2:]
        keep = torch.arange(lq)[:, None] >= torch.arange(lk)[None, :]
        x = torch.where(keep, x, torch.full_like(x, fa.NEG_INF))
    p = torch.exp2((x - lse[..., None]) * 1.4426950408889634) * (1 + p_error)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.double(), v.double()).float()
    return k, p, p * (dp - delta[..., None])


def _dkv_as_the_kernel_forms_p(q, k, v, bias, dout, lse, delta, causal, scale, p_error):
    _, p, ds = _p_ds_as_the_kernel_forms_them(q, k, v, bias, dout, lse, delta, causal, scale,
                                              p_error)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.bfloat16().float(), dout.float())
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds.bfloat16().float(), q.float())
    return {"dk": dk, "dv": dv, "db": ds.sum(dim=2)}


def _dq_as_the_kernel_forms_ds(q, k, v, bias, dout, lse, delta, causal, scale, p_error):
    k, _, ds = _p_ds_as_the_kernel_forms_them(q, k, v, bias, dout, lse, delta, causal, scale,
                                              p_error)
    return {"dq": scale * torch.einsum("bhqk,bhkd->bhqd", ds.bfloat16().float(), k.float())}


SHAPES = pytest.mark.parametrize("b,hq,hkv,l,causal,bias_kind", [
    (4, 4, 4, 128, False, "lengths"),
    (2, 4, 2, 96, False, "masked_rows"),
    (2, 8, 2, 128, True, "lengths"),
])


def _check(got_fn, want_fn, b, hq, hkv, l, causal, bias_kind, p_error):
    d = 64
    q, k, v, dout, bias = _inputs(b, hq, hkv, l, d, bias_kind)
    scale = d ** -0.5
    out, lse = fa._fwd_plain(q, k, v, bias, causal, scale)
    delta = (dout.float() * out.float()).sum(-1)
    args = (q, k, v, bias, dout, lse, delta, causal, scale)
    got = got_fn(*args, p_error)
    want = dict(zip(got, want_fn(*args)))
    if p_error == 0.0:
        chip_smoke.flip_check(fa, "case", args, got, want)
    else:
        with pytest.raises(RuntimeError, match="rounding flips"):
            chip_smoke.flip_check(fa, "case", args, got, want)


@pytest.mark.parametrize("p_error", [0.0, 3e-4])
@SHAPES
def test_dkv_flip_check(b, hq, hkv, l, causal, bias_kind, p_error):
    _check(_dkv_as_the_kernel_forms_p, fa._bwd_dkv_plain, b, hq, hkv, l, causal, bias_kind,
           p_error)


@pytest.mark.parametrize("p_error", [0.0, 3e-4])
@SHAPES
def test_dq_flip_check(b, hq, hkv, l, causal, bias_kind, p_error):
    _check(_dq_as_the_kernel_forms_ds, lambda *a: (fa._bwd_dq_plain(*a),), b, hq, hkv, l,
           causal, bias_kind, p_error)
