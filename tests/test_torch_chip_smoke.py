"""``chip_smoke.flip_check`` on the CPU. The check bounds each element of
the bf16 dkv and dq kernels' gaps from their plain versions by the bf16
rounding flips of p and ds they can come from. Here each plain version is
evaluated a second way that forms p and ds as the tensor-core kernels do
(the score rounded once, as by ``fmaf``, then ``exp2``). That gap must lie
within the bound at every element. An error in p of 3e-4, far below
bf16's resolution, must not.

Then ``kernel_kind`` on kernel names of cuDNN convolutions, GroupNorm,
cuBLAS and the port; phase 6's check of the vmapped round against every
client trained alone, on a tiny ResNet, passing and failing a trainer
that mixes the clients up; and ``main`` with every phase, the card and
nvidia-smi stubbed: it runs phases 2-7 in order and ends with the card's
name and power limit, the kernels line and the ok/device line; a failing
vision phase fails it before any result line."""

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


@pytest.mark.parametrize("name,kind", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
     "convolution (cuDNN)"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "convolution (cuDNN)"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_wo_smem_bf16bf16_bf16f32_f32", "convolution (cuDNN)"),
    ("cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_64x64_64x4>",
     "convolution (cuDNN)"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, float>",
     "convolution (cuDNN)"),
    ("void cudnn::winograd_nonfused::winogradForwardData4x4<float, float>",
     "convolution (cuDNN)"),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>", "group norm"),
    ("void at::native::(anonymous namespace)::ComputeFusedParamsCUDAKernel<float>", "group norm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1",
     "matmul (cuBLAS)"),
    ("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NTT", "matmul (cuBLAS)"),
    ("void fwd_mma_kernel<64, false>(FwdArgs)", "flash attention (this port)"),
    ("void at::native::elementwise_kernel<128, 2, ...>", "elementwise and other"),
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvolutionINS1_11thread",
     "convolution (cuDNN)"),
    ("void at::native::vectorized_elementwise_kernel<4, convert_kernel<float>>",
     "elementwise and other"),
])
def test_kernel_kind_classifies_convolutions(name, kind):
    assert chip_smoke.kernel_kind(name) == kind


def _tiny_resnet_round():
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.resnet import resnet_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    rng = np.random.default_rng(0)
    datasets = [{"x": rng.normal(size=(n, 8, 8, 3)).astype(np.float32),
                 "y": rng.integers(0, 10, n).astype(np.int32)} for n in (12, 6, 0, 9)]
    data, n_samples = stack_client_datasets(datasets, batch_size=8)
    model = resnet_model(blocks_per_stage=(1, 1), n_groups=4, compute_dtype=torch.bfloat16)
    sim = FedSim(model, batch_size=8, learning_rate=0.05, device="cpu")
    reference = resnet_model(blocks_per_stage=(1, 1), n_groups=4)
    return sim, reference, sim.init(torch.Generator().manual_seed(0)), data, n_samples


def test_vmapped_round_agrees_with_each_client_alone():
    """Phase 6's reference check at a tiny size: the vmapped bf16 round
    lies as close to fp32 as the bf16 clients alone do."""
    stats = chip_smoke.vmap_against_clients_alone(*_tiny_resnet_round(),
                                                  torch.Generator().manual_seed(2))
    assert stats["client_ratio_max"] <= chip_smoke.BF16_GAP_RATIO_TOL
    assert stats["mixed_up_control_ratio_min"] > chip_smoke.BF16_GAP_RATIO_TOL


@pytest.mark.parametrize("fault", ["mixed_up", "update_scaled"])
def test_a_faulty_vmapped_trainer_fails_the_reference_check(monkeypatch, fault):
    """A trainer that hands every client the next one's params, or takes
    1.5x the step, fails it."""
    from baton_tpu_torch.core.training import LocalTrainer

    train_clients = LocalTrainer.train_clients

    def faulty(self, params, *args, **kw):
        p, losses = train_clients(self, params, *args, **kw)
        if fault == "mixed_up":
            return {k: v.roll(1, 0) for k, v in p.items()}, losses
        return {k: params[k] + 1.5 * (v - params[k]) for k, v in p.items()}, losses

    monkeypatch.setattr(LocalTrainer, "train_clients", faulty)
    with pytest.raises(RuntimeError, match="vmapped round and clients alone differ"):
        chip_smoke.vmap_against_clients_alone(*_tiny_resnet_round(),
                                              torch.Generator().manual_seed(2))


PHASES = ("kernel_phase", "bert_round_phase", "in_context_phase", "timing_phase",
          "resnet_round_phase", "vision_parity_phase")


def _stub_main(monkeypatch, tmp_path, fail=None):
    """``chip_smoke.main`` with every phase, the card and nvidia-smi
    replaced by stubs; returns the list the phases append their names to."""
    import subprocess
    import sys

    called = []

    def stub(phase):
        def run(*args, **kw):
            called.append(phase)
            if phase == fail:
                raise RuntimeError(f"check failed: {phase}")
            return {"bert_round_phase": ({"fwd": 1}, {"fwd": 1}, {}),
                    "timing_phase": ([{"name": "flash_fwd"}], {}),
                    "resnet_round_phase": {}}.get(phase)
        return run

    for phase in PHASES:
        monkeypatch.setattr(chip_smoke, phase, stub(phase))
    library = tmp_path / "libflash.so"
    library.with_suffix(".log").write_text("ptxas info: Used 128 registers\n")
    monkeypatch.setattr(fa, "load_library", lambda: None)
    monkeypatch.setattr(fa, "library_path", lambda: library)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(subprocess, "run", lambda *a, **kw: subprocess.CompletedProcess(
        a, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n", stderr=""))
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return called


def test_main_runs_the_vision_phases_and_ends_with_the_ok_line(monkeypatch, tmp_path, capsys):
    import json

    called = _stub_main(monkeypatch, tmp_path)
    assert chip_smoke.main() == 0
    assert called == list(PHASES)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert json.loads(lines[-2]) == {"kernels": [{"name": "flash_fwd"}]}
    assert lines[-3] == "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.mark.parametrize("failing", ["resnet_round_phase", "vision_parity_phase"])
def test_a_failing_vision_phase_fails_the_smoke(monkeypatch, tmp_path, capsys, failing):
    called = _stub_main(monkeypatch, tmp_path, fail=failing)
    with pytest.raises(RuntimeError, match=failing):
        chip_smoke.main()
    assert called[-1] == failing
    assert '"ok": true' not in capsys.readouterr().out
