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
that mixes the clients up; phases 8-10's checks at a tiny size (FedProx's
drift, the frozen tensors of a partitioned round, the card-against-CPU
comparator), each passing and failing a broken input; phase 11's fold of
the uploads, the split of a round from its spans and the trainer that
notes its devices; phase 12's fold of compressed uploads and its
error-feedback ledger, each passing and failing a broken input; phase
15's checks of the clustered assignments, the clusters' means and the
launches per step, each passing and failing a broken input, and its
card-against-CPU runs of the four variants at a tiny size; phase 16's
host-side helpers (the 4·P·tokens count, the memory estimate and the wave
it picks, the frozen-base check, the sweep artifact's writer and what
``configure_attention_dispatch`` reads from it); phase 21's checks (the
ring's launch count against a counted CPU step of example 06, the shard
by shard comparator and the model-gradient check, each failing a broken
input) and phase 2's check of the flash block wrappers, passing them and
failing a broken dk, dtype or launch; phase 2's masked-row case against
float64, passing the plain version and failing a dbias off by more than
fp32 summation explains; phase 22's checks at a tiny size on the CPU (the
band, the mesh round held against meshless, which fails a round that drops
a shard from its psum though the band alone passes it, the psum fold
against float64, each failing a broken input; the four
variants on 2 shards against 8; the two processes over gloo); and ``main``
with every phase, the card and nvidia-smi stubbed: it runs phases 2-22 in
order and ends with the card's name and power limit, the kernels line
(with its config-4, ring and mesh launches, the ring's counted a step)
and the ok/device line; a failing phase from 6 on fails it before any
result line."""

import dataclasses
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
    (1, 2, 1, 512, True, "lengths"),  # sums past SUM_TERMS: the allowance grows
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
    ("void (anonymous namespace)::dkv_tf32x3_kernel<64>(float const*, float const*)",
     "flash attention (this port)"),
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
          "llama_timing_phase", "resnet_round_phase", "vision_parity_phase",
          "fedprox_bert_phase", "resnet_optimizer_phase", "options_parity_phase",
          "http_round_phase", "bandwidth_phase", "secure_phase", "config1_phase",
          "variants_phase", "config4_phase", "hybrid_config4_phase", "remat_phase", "vit_phase",
          "lstm_phase", "zoo_parity_phase", "crossover_phase", "config5_phase",
          "config5_timing_phase", "auto_wave_phase", "fused_phase", "examples_phase",
          "sequence_parallel_phase", "mesh_phase", "hybrid_phase")
COUNTS = {"fwd": 48, "bwd_dkv": 48, "bwd_dq": 48}
VARIANT_COUNTS = {"fwd": 816, "bwd_dkv": 312, "bwd_dq": 312}
# config 4 with remat: the forward twice a layer a step, 32 layers, 4 steps a round
CONFIG4_COUNTS = {"fwd": 1024, "bwd_dkv": 512, "bwd_dq": 512}
CONFIG4_PER_ROUND = {"fwd": 256, "bwd_dkv": 128, "bwd_dq": 128}
LLAMA_ROW = {"ms": 0.2, "bound_ms": 0.1}
# config 5 with remat: 12 layers, 2 waves x 2 steps a round, 3 rounds
CONFIG5_COUNTS = {"fwd": 288, "bwd_dkv": 144, "bwd_dq": 144}
CONFIG5_PER_ROUND = {"fwd": 96, "bwd_dkv": 48, "bwd_dq": 48}
CONFIG5_PER_STEP = {"fwd": 24, "bwd_dkv": 12, "bwd_dq": 12}
CONFIG5_ROW = {"ms": 0.3, "bound_ms": 0.1}
FUSED_COUNTS = {"fwd": 48, "bwd_dkv": 48, "bwd_dq": 48}
# example 06's full preset: 36 block calls a pass and layer, 8 layers, remat, 5 steps
RING_PER_STEP = {"fwd": 576, "bwd_dkv": 288, "bwd_dq": 288}
RING_COUNTS = {k: 5 * n for k, n in RING_PER_STEP.items()}
RING_ROW = {"float32": {"ms": 2.0, "bound_ms": 0.5}, "bfloat16": {"ms": 0.5, "bound_ms": 0.1}}
# phase 2's fp32 ring-block case: max abs error by kernel
RING_ERRS = {"flash_fwd": 1e-6, "flash_bwd_dkv": 2e-6, "flash_bwd_dq": 3e-6}
# phase 22a: BERT-base's 12 layers, one round on 4 shards and meshless
MESH_COUNTS = {"fwd": 48, "bwd_dkv": 48, "bwd_dq": 48}
MESHLESS_COUNTS = {"fwd": 12, "bwd_dkv": 12, "bwd_dq": 12}
# phase 23: config 4's round on 2 x 2 shards, 4x the meshless; BERT's frozen
# encoder on 2 x 2, 12 layers x 4 steps x 4 shards, forward only
HYBRID_COUNTS = {"fwd": 1024, "bwd_dkv": 512, "bwd_dq": 512}
HYBRID_BERT_COUNTS = {"fwd": 192, "bwd_dkv": 0, "bwd_dq": 0}


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
            return {"kernel_phase": {"bert_base": {}, "ring_block_float32": RING_ERRS},
                    "bert_round_phase": ({"fwd": 1}, {"fwd": 1}, {"peak_memory_gb": 37.24}),
                    "timing_phase": ([{"name": "flash_fwd_mma", "pass": "fwd"}], {}),
                    "resnet_round_phase": {},
                    "fedprox_bert_phase": (COUNTS, {k: 12 for k in COUNTS}, {}),
                    "resnet_optimizer_phase": {}, "options_parity_phase": {},
                    "http_round_phase": {}, "bandwidth_phase": {}, "secure_phase": {},
                    "config1_phase": {}, "variants_phase": {"launches": VARIANT_COUNTS},
                    "llama_timing_phase": {"flash_fwd": LLAMA_ROW},
                    "config4_phase": (CONFIG4_COUNTS, CONFIG4_PER_ROUND,
                                      {"steps_per_round": 4}, {}),
                    "hybrid_config4_phase": {"launches_per_round": HYBRID_COUNTS},
                    "hybrid_phase": {"bert": {"hybrid": {"launches": HYBRID_BERT_COUNTS}}},
                    "remat_phase": {}, "vit_phase": {}, "lstm_phase": {},
                    "zoo_parity_phase": {}, "crossover_phase": {},
                    "config5_phase": (CONFIG5_COUNTS, CONFIG5_PER_ROUND,
                                      {"wave": 2, "per_step": CONFIG5_PER_STEP}, None),
                    "config5_timing_phase": {"flash_fwd": CONFIG5_ROW},
                    "auto_wave_phase": {},
                    "fused_phase": {"launches_fused_bert": FUSED_COUNTS,
                                    "launches_per_round_fused_bert": {k: 12 for k in COUNTS}},
                    "examples_phase": {},
                    "sequence_parallel_phase": (RING_COUNTS, [RING_PER_STEP] * 5,
                                                dict.fromkeys(RING_ERRS, RING_ROW), {}),
                    "mesh_phase": (MESH_COUNTS,
                                   {"bert": {"meshless": {"launches": MESHLESS_COUNTS}}}),
                    }.get(phase)
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
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
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
    csrc = "baton_tpu_torch/ops/csrc/"
    fp32_rows = [{
        "name": f"flash_{counter}_{design}", "pass": counter, "route": "cuda",
        "design": design, "source": csrc + source, "replaces": chip_smoke.TPU_KERNELS[counter],
        "launches": RING_COUNTS[counter],
        "launches_per_step_ring_flash": [RING_PER_STEP[counter]] * 5,
        "max_abs_err": RING_ERRS[f"flash_{counter}"], "tol": 1e-4, **RING_ROW["float32"],
        "library_call": ("scaled_dot_product_attention forward" if counter == "fwd"
                         else "scaled_dot_product_attention backward (dq, dk, dv)"),
        "shape": "the ring block: B 1, 8/4 heads, L 4,096, D 64, not causal, fp32"}
        for counter, design, source in (("fwd", "tf32x3", "flash_attention_tf32.cu"),
                                        ("bwd_dkv", "tf32x3", "flash_attention_tf32.cu"),
                                        ("bwd_dq", "tf32x3", "flash_attention_tf32.cu"))]
    assert json.loads(lines[-2]) == {"kernels": [{
        "name": "flash_fwd_mma", "pass": "fwd", "launches_config3": 48,
        "launches_per_round_config3": 12,
        "launches_variants": 816, "llama_shape": LLAMA_ROW, "launches_config4": 1024,
        "launches_per_round_config4": 256, "launches_per_step_config4": 64,
        "launches_config5": 288, "launches_per_round_config5": 96,
        "launches_per_step_config5": 24, "config5_shape": CONFIG5_ROW,
        "launches_fused_bert": 48, "launches_per_round_fused_bert": 12,
        "ring_block_shape": RING_ROW["bfloat16"], "launches_per_round_mesh_bert": 48,
        "launches_per_round_meshless_bert": 12, "launches_per_round_hybrid_config4": 1024,
        "launches_per_round_hybrid_bert": 192}, *fp32_rows]}
    assert lines[-3] == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_kernels_line_has_a_row_per_launch_key():
    """``KERNELS`` names one source in the repo for every launch key the
    kernels count under, and each pass's design on each dtype is one of
    them."""
    assert set(chip_smoke.KERNELS) == set(fa.launches_by_design)
    root = Path(chip_smoke.__file__).resolve().parent
    assert all((root / src).is_file() for src in chip_smoke.KERNELS.values())
    for dtype in (torch.float32, torch.bfloat16):
        assert set(chip_smoke.design_keys(fa, dtype).values()) <= set(chip_smoke.KERNELS)
    assert chip_smoke.design_names(fa, torch.float32) == "tf32x3"
    assert chip_smoke.design_names(fa, torch.bfloat16) == "mma"


@pytest.mark.parametrize("failing", ["resnet_round_phase", "vision_parity_phase",
                                     "fedprox_bert_phase", "resnet_optimizer_phase",
                                     "options_parity_phase", "http_round_phase",
                                     "bandwidth_phase", "secure_phase", "config1_phase",
                                     "variants_phase", "config4_phase", "remat_phase",
                                     "vit_phase", "lstm_phase", "zoo_parity_phase",
                                     "crossover_phase", "config5_phase", "auto_wave_phase",
                                     "fused_phase", "examples_phase",
                                     "sequence_parallel_phase", "mesh_phase",
                                     "hybrid_config4_phase", "hybrid_phase"])
def test_a_failing_vision_phase_fails_the_smoke(monkeypatch, tmp_path, capsys, failing):
    called = _stub_main(monkeypatch, tmp_path, fail=failing)
    with pytest.raises(RuntimeError, match=failing):
        chip_smoke.main()
    assert called[-1] == failing
    assert '"ok": true' not in capsys.readouterr().out


def _tiny_bert_cohort():
    from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    from baton_tpu_torch.examples.bert_fedprox import make_data

    cfg = BertConfig.tiny()
    datasets = make_data(np.random.default_rng(0), cfg, 4, 8)
    datasets[2] = {k: v[:0] for k, v in datasets[2].items()}  # a client without samples
    data, n_samples = stack_client_datasets(datasets, batch_size=4)
    model = bert_classifier_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0)), data, n_samples


def test_config3_data_is_the_examples():
    """Phase 8 draws its clients with the port's example 03
    (``baton_tpu_torch/examples/bert_fedprox.py``), whose ``make_data``
    draws the JAX example's arrays bit for bit: each client skewed to two
    classes."""
    import inspect

    from baton_tpu_torch.examples.bert_fedprox import make_data
    from baton_tpu_torch.models.bert import BertConfig

    assert "from baton_tpu_torch.examples.bert_fedprox import make_data" in inspect.getsource(
        chip_smoke.fedprox_bert_phase)
    spec = importlib.util.spec_from_file_location(
        "bert_fedprox_example",
        Path(__file__).resolve().parents[1] / "examples" / "03_bert_fedprox.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = BertConfig.tiny()
    datasets = make_data(np.random.default_rng(0), cfg, 6, 16)
    want = example.make_data(np.random.default_rng(0), example.BertConfig.tiny(), 6, 16)
    for d, w in zip(datasets, want, strict=True):
        assert d.keys() == w.keys()
        for k in d:
            np.testing.assert_array_equal(d[k], w[k])
            assert d[k].dtype == w[k].dtype == np.int32
        assert d["x"].shape == (16, cfg.max_len)
        assert len(set(d["y"].tolist())) <= 2 and d["x"].max() < cfg.vocab_size


@pytest.mark.parametrize("swapped", [False, True], ids=["mu_as_set", "mu_swapped"])
def test_fedprox_drift_check(swapped):
    """Phase 8's drift comparison on tiny BERT: FedProx (mu 0.1) keeps the
    clients nearer the global params; the sims swapped must fail."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core.regularizers import fedprox
    from baton_tpu_torch.core.training import random_perms

    model, params, data, n_samples = _tiny_bert_cohort()
    perms = random_perms(4, 2, data["x"].shape[1], torch.Generator().manual_seed(1))
    sims = [FedSim(model, batch_size=4, learning_rate=0.05, device="cpu", **kw)
            for kw in ({}, {"regularizer": fedprox(0.1)})]
    free, prox = (chip_smoke.mean_client_drift(sim, params, data, n_samples, 2, perms)
                  for sim in (sims[::-1] if swapped else sims))
    if swapped:
        with pytest.raises(RuntimeError, match="did not reduce the client drift"):
            chip_smoke.check_fedprox_drift(free, prox)
    else:
        chip_smoke.check_fedprox_drift(free, prox)


@pytest.mark.parametrize("fault", [None, "frozen_perturbed", "trainable_still"])
def test_partition_round_check(fault):
    """Phase 8's check of a trainable-head round: frozen tensors
    bit-equal, trainable ones moved; a frozen tensor off by one ulp, or a
    trainable one left as it was, fails it."""
    from baton_tpu_torch import FedSim

    model, params, data, n_samples = _tiny_bert_cohort()
    sim = FedSim(model, batch_size=4, learning_rate=0.05, device="cpu",
                 trainable=lambda name, leaf: name.startswith(chip_smoke.CONFIG3_HEAD))
    end = dict(sim.run_round(params, data, n_samples, torch.Generator().manual_seed(0)).params)
    trainable = sim.partition.trainable_paths
    if fault == "frozen_perturbed":
        scale = end["ln_f/scale"]
        end["ln_f/scale"] = torch.nextafter(scale, torch.full_like(scale, 2))
    elif fault == "trainable_still":
        end["head/b"] = params["head/b"].clone()
    if fault is None:
        chip_smoke.check_partition_round(params, end, trainable)
    else:
        with pytest.raises(RuntimeError, match="frozen params changed|did not move"):
            chip_smoke.check_partition_round(params, end, trainable)


def test_options_against_cpu_at_a_tiny_size():
    """Phase 10's comparator runs every option; with the CPU on both sides
    every gap is 0."""
    model, params, data, n_samples = _tiny_bert_cohort()
    perms = torch.stack([torch.randperm(8, generator=torch.Generator().manual_seed(c))[None]
                         for c in range(4)])
    errs = chip_smoke.options_against_cpu("tiny", model, params, data, n_samples, perms, 4,
                                          0.05, ("pooler/", "head/"), device="cpu")
    assert set(errs) == set(chip_smoke.option_variants(("pooler/", "head/")))
    assert all(e == 0.0 for e in errs.values())


@pytest.mark.parametrize("gap", [5e-5, 2e-4])
def test_compare_rounds_holds_the_tolerance(gap):
    """The card-against-CPU comparator passes a gap within 1e-4 and fails
    one beyond it, in the params and in the losses."""
    from baton_tpu_torch import FedSim

    model, params, data, n_samples = _tiny_bert_cohort()
    res = FedSim(model, batch_size=4, learning_rate=0.05, device="cpu").run_round(
        params, data, n_samples, torch.Generator().manual_seed(0))
    shifted = dataclasses.replace(res, params={k: v + gap for k, v in res.params.items()})
    lossy = dataclasses.replace(res, loss_history=res.loss_history + gap)
    for card in (shifted, lossy):
        if gap <= 1e-4:
            chip_smoke.compare_rounds("tiny", card, res, params)
        else:
            with pytest.raises(RuntimeError, match="card and CPU"):
                chip_smoke.compare_rounds("tiny", card, res, params)
    assert chip_smoke.compare_rounds("tiny", lossy, res, params, hold=False) == 0.0


def _uploads(n_samples, seed=0):
    from baton_tpu_torch.server import wire

    rng = np.random.default_rng(seed)
    sds = [{"w": rng.normal(size=(3, 2)).astype(np.float32),
            "b": rng.normal(size=(2,)).astype(np.float32)} for _ in n_samples]
    bodies = [wire.encode(sd, {"update_name": "u", "n_samples": n, "loss_history": [1.0]})
              for sd, n in zip(sds, n_samples)]
    return sds, bodies


@pytest.mark.parametrize("weights_as_sent", [True, False], ids=["as_sent", "reweighted"])
def test_fold_of_uploads_against_the_aggregate(weights_as_sent):
    """Phase 11's fold check: the sample-weighted mean recomputed from the
    bodies equals a mean folded from the same uploads within the
    tolerance; a mean folded with other weights does not."""
    n_samples = [48, 20, 7]
    sds, bodies = _uploads(n_samples)
    fold, total = chip_smoke.fold_of_uploads(bodies)
    assert total == sum(n_samples)
    weights = n_samples if weights_as_sent else [1, 1, 1]
    aggregate = {k: sum(np.float32(w) * sd[k] for w, sd in zip(weights, sds))
                 / np.float32(sum(weights)) for k in sds[0]}
    gap = chip_smoke.max_gap(aggregate, fold)
    if weights_as_sent:
        assert gap <= chip_smoke.HTTP_FOLD_TOL
    else:
        assert gap > 100 * chip_smoke.HTTP_FOLD_TOL
    with pytest.raises(RuntimeError, match="different tensors"):
        chip_smoke.max_gap({"w": fold["w"]}, fold)


def _replayed_workers():
    """Two linear workers (48 and 20 samples, batch 32) trained one epoch
    from the same start, as phase 11's replay trains its two workers."""
    from baton_tpu_torch.core.training import make_local_trainer
    from baton_tpu_torch.models.linear import linear_regression_model
    from baton_tpu_torch.ops.padding import pad_dataset, round_up

    model = linear_regression_model(10)
    trainer = make_local_trainer(model, batch_size=32, learning_rate=0.05)
    start = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    trained, counts = [], []
    for i, n in enumerate((48, 20)):
        data = {"x": rng.normal(size=(n, 10)).astype(np.float32),
                "y": rng.normal(size=(n, 1)).astype(np.float32)}
        padded, n = pad_dataset(data, round_up(n, 32))
        padded = {k: torch.as_tensor(v) for k, v in padded.items()}
        trained.append(trainer.train(start, padded, n, 1,
                                     generator=torch.Generator().manual_seed(i))[0])
        counts.append(n)
    return start, trained, counts


@pytest.mark.parametrize("merged", ["as_sent", "miscounted", "dropped"])
def test_replay_check_sees_a_misweighted_or_dropped_upload(merged):
    """Phase 11's replay check at a tiny size: a round merged from the
    uploads as sent holds; merged with the 20-sample worker counted as 32,
    or without that worker's upload, it fails."""
    start, trained, counts = _replayed_workers()
    assert counts == [48, 20]
    end = {"as_sent": lambda: chip_smoke.replay_merge(trained, counts, start),
           "miscounted": lambda: chip_smoke.replay_merge(trained, [48, 32], start),
           "dropped": lambda: chip_smoke.replay_merge(trained[:1], [48], start)}[merged]()
    if merged == "as_sent":
        gap, moved = chip_smoke.hold_replay("tiny", start, end, trained, counts, 32)
        assert gap == 0.0 and moved > 0
    else:
        with pytest.raises(RuntimeError, match="the HTTP round and its replay differ"):
            chip_smoke.hold_replay("tiny", start, end, trained, counts, 32)


def test_replay_check_fails_when_it_cannot_see_the_planted_faults():
    """Workers whose params came back alike make a miscounted or partial
    merge equal the right one: the planted-fault control must then fail
    the phase."""
    start, trained, counts = _replayed_workers()
    trained = [trained[0], trained[0]]
    end = chip_smoke.replay_merge(trained, counts, start)
    with pytest.raises(RuntimeError, match="cannot see the last worker's 20 samples counted as 32"):
        chip_smoke.hold_replay("tiny", start, end, trained, counts, 32)


def _span(name, start, end, service="manager#1"):
    return {"name": name, "start": start, "end": end, "service": service}


def test_round_split_from_the_spans_of_a_round():
    spans = [_span("round_setup", 0.0, 0.5), _span("broadcast", 0.1, 0.5),
             _span("local_train", 0.5, 1.5, "worker:a"), _span("local_train", 0.5, 2.5, "worker:b"),
             _span("encode_update", 1.5, 1.6, "worker:a"),
             _span("encode_update", 2.5, 2.8, "worker:b"),
             _span("upload", 1.6, 2.0, "worker:a"), _span("upload", 2.8, 3.4, "worker:b"),
             _span("ingest_decode", 1.7, 1.8), _span("ingest_decode", 2.9, 3.0),
             _span("ingest_fold", 1.8, 1.9), _span("ingest_fold", 3.0, 3.3),
             _span("aggregate", 3.4, 3.5), _span("round", 0.0, 3.5)]
    split = chip_smoke.round_split(spans)
    want = {"setup": 0.5, "local_train": 1.5, "local_train_max": 2.0, "upload_encode": 0.2,
            "transfer_decode": 0.5 - 0.2, "decode": 0.1, "fold": 0.2, "merge": 0.1, "uploads": 2}
    assert split.keys() == want.keys()
    for k, v in want.items():
        assert split[k] == pytest.approx(v), k
    both = chip_smoke.mean_split([split, dict(split, setup=1.5)])
    assert both["setup"] == pytest.approx(1.0) and both["merge"] == pytest.approx(0.1)
    with pytest.raises(RuntimeError, match="encode_update"):
        chip_smoke.round_split([s for s in spans if s["name"] != "encode_update"])


def test_recording_trainer_notes_its_devices_and_trains_alike():
    from baton_tpu_torch.core.training import make_local_trainer
    from baton_tpu_torch.models.linear import linear_regression_model

    model = linear_regression_model(3)
    base = make_local_trainer(model, batch_size=4, learning_rate=0.1)
    seen = []
    trainer = chip_smoke.recording_trainer(base, seen)
    params = model.init(torch.Generator().manual_seed(0))
    data = {"x": torch.randn(8, 3, generator=torch.Generator().manual_seed(1)),
            "y": torch.randn(8, 1, generator=torch.Generator().manual_seed(2))}
    got = trainer.train(params, data, 8, 2, generator=torch.Generator().manual_seed(3))
    want = base.train(params, data, 8, 2, generator=torch.Generator().manual_seed(3))
    assert seen == [["cpu"]]
    for k in params:
        assert torch.equal(got[0][k], want[0][k])
    assert trainer.batch_size == base.batch_size and trainer.optimizer is base.optimizer



@pytest.mark.parametrize("anchor_off", [0.0, 1e-3])
def test_fold_of_compressed_uploads_against_the_aggregate(anchor_off):
    """Phase 12's fold: top-k uploads reconstructed on the round's anchor
    and weighted by their samples; the wrong anchor moves it."""
    from baton_tpu_torch.ops.compression import ErrorFeedbackCompressor
    from baton_tpu_torch.server import wire

    rng = np.random.default_rng(0)
    anchor = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    trained, bodies = [], []
    for i, n in enumerate((12, 5)):
        delta = {k: torch.from_numpy(0.1 * rng.normal(size=v.shape).astype(np.float32))
                 for k, v in anchor.items()}
        payload = ErrorFeedbackCompressor(frac=1.0, seed=i).compress(delta)
        tensors = {}
        for k, p in payload.items():
            tensors[f"{k}@idx"], tensors[f"{k}@val"] = p["idx"].numpy(), p["val"].numpy()
        bodies.append(wire.encode(tensors, {"n_samples": n, "compressed": {"scheme": "topk"}}))
        trained.append({k: anchor[k] + delta[k].numpy() for k in anchor})
    want = {k: (12 * trained[0][k].astype(np.float64) + 5 * trained[1][k]) / 17 for k in anchor}
    fold, weight = chip_smoke.fold_of_compressed_uploads(
        bodies, {k: v + anchor_off for k, v in anchor.items()})
    assert weight == 17.0
    gap = chip_smoke.max_gap(fold, want)
    assert (gap <= chip_smoke.HTTP_FOLD_TOL) == (anchor_off == 0.0)


@pytest.mark.parametrize("fault", [None, "residual dropped", "restore forgets"])
def test_error_feedback_ledger(fault):
    """Phase 12's error-feedback check: the transmitted mass plus the
    residual equals the true deltas' sum, through a failed upload's
    restore; a compressor that drops its residual, or a restore that does
    not fold the kept mass back, breaks it."""
    from baton_tpu_torch.ops.compression import ErrorFeedbackCompressor

    rng = np.random.default_rng(1)
    comp = ErrorFeedbackCompressor(frac=0.2, bits=8, seed=3)
    if fault == "restore forgets":
        comp.restore = lambda template: setattr(comp, "_last_exact", None)
    sums = chip_smoke.track_error_feedback(comp)
    for r in range(4):
        delta = {"w": torch.from_numpy(rng.normal(size=(40,)).astype(np.float32))}
        comp.compress(delta)
        if r == 1:
            comp.restore(delta)  # the upload failed: its kept mass goes back
        if r == 2 and fault == "residual dropped":
            comp.residual = {k: torch.zeros_like(v) for k, v in comp.residual.items()}
    gap = chip_smoke.error_feedback_gap(sums, comp.residual)
    assert (gap <= chip_smoke.EF_TOL) == (fault is None)


def test_cluster_assignment_check_allows_only_near_ties():
    pairs = torch.tensor([[1.0, 2.0], [1.5, 1.49], [3.0, 1.0]])
    chip_smoke.check_cluster_assignments([0, 0, 1], pairs)  # client 1 within 2e-2
    with pytest.raises(RuntimeError, match="client 2 took cluster 0"):
        chip_smoke.check_cluster_assignments([0, 1, 0], pairs)


@pytest.mark.parametrize("fault", [None, "misweighted", "empty_moved"])
def test_cluster_means_check(fault):
    """Phase 15's check of a clustered round: each chosen cluster the
    sample-weighted mean of its clients, an unchosen one bit-equal."""
    gen = torch.Generator().manual_seed(0)
    old = {"w": torch.randn(3, 4, 2, generator=gen)}
    trained = {"w": torch.randn(5, 4, 2, generator=gen)}
    assign, n = np.array([0, 2, 0, 2, 2]), np.array([3, 1, 5, 0, 2])
    new = {"w": old["w"].clone()}
    for k in (0, 2):
        m = torch.as_tensor(assign == k)
        w = torch.as_tensor(n, dtype=torch.float32)[m]
        new["w"][k] = torch.tensordot(w, trained["w"][m], dims=([0], [0])) / w.sum()
    if fault == "misweighted":
        new["w"][2] = trained["w"][torch.as_tensor(assign == 2)].mean(0)
    if fault == "empty_moved":
        new["w"][1] += 1e-7
    if fault is None:
        assert chip_smoke.check_cluster_means(new, old, trained, assign, n) < 1e-6
    else:
        with pytest.raises(RuntimeError, match="weighted mean|no client but changed"):
            chip_smoke.check_cluster_means(new, old, trained, assign, n)


def test_step_launch_check():
    mma = {"fwd_mma": 24, "bwd_dkv_mma": 12, "bwd_dq_mma": 12}
    counts = {"fwd": 24, "bwd_dkv": 12, "bwd_dq": 12}
    assert chip_smoke.check_step_launches("grid + round", counts, mma, 12, 1,
                                          fwd_extra=1) == counts
    with pytest.raises(RuntimeError, match="launches"):  # the grid launched per client
        chip_smoke.check_step_launches("grid", {"fwd": 96, "bwd_dkv": 0, "bwd_dq": 0},
                                       {"fwd_mma": 96}, 12, 0, fwd_extra=1)
    with pytest.raises(RuntimeError, match="mma"):
        chip_smoke.check_step_launches("round", {"fwd": 12, "bwd_dkv": 12, "bwd_dq": 12},
                                       {"fwd_mma": 12, "bwd_dkv_tf32x3": 12, "bwd_dq_mma": 12},
                                       12, 1)


def test_variants_against_cpu_at_a_tiny_size():
    """Phase 15's card-against-CPU runs of the four variants; with the
    CPU on both sides every gap is 0."""
    model, params, data, n_samples = _tiny_bert_cohort()
    perms = torch.stack([torch.randperm(8, generator=torch.Generator().manual_seed(c))[None]
                         for c in range(4)])
    gaps = chip_smoke.variants_against_cpu(
        model, params, model.init(torch.Generator().manual_seed(1)), data, n_samples, 4, 0.05,
        perms, device="cpu")
    assert len(gaps) == 4 and all(g == 0.0 for g in gaps.values())


# ---------------------------------------------------------------------------
# phase 16's host-side helpers


def test_lora_train_flops_is_four_p_tokens():
    """The suite's adapters-only count: 4 x 8,043,892,736 params (the
    Llama-3-8B base and its rank-16 adapters) x 65,536 tokens a round."""
    assert chip_smoke.lora_train_flops(8_043_892_736, 4 * 16 * 1024) == \
        4.0 * 8_043_892_736 * 65_536


def test_config4_memory_estimate_counts_the_params_and_the_clients():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from baton_tpu_torch.examples import llama_lora
    from baton_tpu_torch.models.lora import lora_trainable

    cfg = llama_lora.FULL_CONFIG
    with FakeTensorMode():
        params = llama_lora.make_sim(cfg, rank=16, batch_size=8, device="cpu")[1].init(
            torch.Generator())
        n_base = sum(v.numel() for k, v in params.items() if not lora_trainable(k, v))
        n_adapter = sum(v.numel() for k, v in params.items() if lora_trainable(k, v))
    one, two = (chip_smoke.config4_memory_estimate(cfg, 8, w, 16) for w in (1, 2))
    assert one["base"] == 4 * n_base and one["adapters"] == 4 * n_adapter
    assert one["client_parts"]["merged_targets"] == 4 * 32 * 41_943_040  # wq, wk, wv, wo
    assert one["client_parts"]["block_inputs"] == 2 * 32 * 8 * 1024 * 4096
    assert two["total"] - one["total"] == one["per_client"]
    # 32.2 GB of params and ~10.6 GB a client: 85 GB at 85% holds a wave of
    # 3, and the wave must divide the cohort of 4
    assert chip_smoke.config4_wave(cfg, 8, 16, 4, 85e9) == 2
    assert chip_smoke.config4_wave(cfg, 8, 16, 3, 85e9) == 3
    assert chip_smoke.config4_wave(cfg, 8, 16, 4, 40e9) == 1


def test_frozen_bit_equal_check():
    params = {"base/w": torch.ones(3), "lora/w/a": torch.zeros(2)}
    host = {"base/w": params["base/w"].clone()}
    assert chip_smoke.check_frozen_bit_equal(params, host) == 1
    params["base/w"] = torch.nextafter(params["base/w"], torch.tensor(2.0))
    with pytest.raises(RuntimeError, match="frozen tensor base/w changed"):
        chip_smoke.check_frozen_bit_equal(params, host)


@pytest.mark.parametrize("flash_ms,crossover", [((9.0, 1.5, 1.0), 256), ((9.0, 9.0, 9.0), None),
                                                ((1.0, 9.0, 1.0), 128)])
def test_sweep_written_and_read_back(tmp_path, flash_ms, crossover):
    """The sweep in attention_sweep.py's record shape, platform gpu; the
    dispatcher reads the crossover the phase prints, and changes nothing
    without one."""
    import json

    from baton_tpu_torch.models import transformer as T

    results = [{"L": l, "batch": 8192 // l, "dense_ms": 2.0, "flash": {"64x64": ms}}
               for l, ms in zip((128, 256, 512), flash_ms)]
    path = tmp_path / "sweep.json"
    payload = chip_smoke.write_sweep(path, "NVIDIA H100 80GB HBM3", results)
    assert json.loads(path.read_text()) == payload and payload["platform"] == "gpu"
    assert chip_smoke.sweep_crossover(results) == crossover
    orig = (T._FLASH_MIN_LEN, T._FLASH_BLOCKS)
    try:
        read = T.configure_attention_dispatch(sweep_path=str(path))
    finally:
        T._FLASH_MIN_LEN, T._FLASH_BLOCKS = orig
    assert read == (orig if crossover is None else (crossover, (64, 64)))


def _tiny_dp_trainer(sigma=0.5):
    from baton_tpu_torch.core.training import make_local_trainer
    from baton_tpu_torch.models.mlp import mlp_classifier_model
    from baton_tpu_torch.ops.privacy import DPConfig

    model = mlp_classifier_model(5, (8,), 3)
    trainer = make_local_trainer(model, batch_size=4, dp=DPConfig(1.0, sigma))
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.normal(size=(2, 4, 5)).astype(np.float32)),
             "y": torch.from_numpy(rng.integers(0, 3, (2, 4)).astype(np.int64)),
             "mask": torch.ones(2, 4)}
    return trainer, model.init(torch.Generator().manual_seed(0)), batch


def test_noise_replay_check():
    """Phase 17's noise replay: the trainer's DP step minus its sigma-0
    step is sigma·clip·N/B for N from the generator seeded the same way;
    a step that scales its noise by the count of real rows is caught."""
    trainer, params, batch = _tiny_dp_trainer()
    assert chip_smoke.noise_replay_gap(trainer, params, batch, seed=5) < 1e-6

    class Rescaled(type(trainer)):
        def _dp_grads(self, p, frozen, anchor, b, noise):
            if noise is not None:
                noise = {k: v * 4 / 3 for k, v in noise.items()}
            return super()._dp_grads(p, frozen, anchor, b, noise)

    wrong = Rescaled(**{f.name: getattr(trainer, f.name) for f in dataclasses.fields(trainer)})
    assert chip_smoke.noise_replay_gap(wrong, params, batch, seed=5) > 1e-2


# ---------------------------------------------------------------------------
# phase 21's checks


def test_ring_launch_count_is_what_example06_launches(monkeypatch):
    """The count phase 21 holds the card to, against a counted CPU step of
    example 06 (the flash wrappers counting as their kernels do): a causal
    ring of N shards makes N + N(N-1)/2 block calls a pass and layer, and
    remat runs the forward twice; 36 at N = 8, so 576 / 288 / 288 a step of
    the full preset's 8 layers."""
    from baton_tpu_torch.examples import long_context_ring as ex
    from baton_tpu_torch.models.llama import LlamaConfig

    assert [chip_smoke.ring_block_calls(n) for n in (1, 2, 4, 8)] == [1, 3, 10, 36]
    assert chip_smoke.ring_block_calls(8, causal=False) == 64
    assert chip_smoke.ring_step_launches(8, 8, remat=True) == RING_PER_STEP
    counted = {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0}
    for name in counted:
        real = getattr(fa, f"_{name}")

        def wrapper(*args, _real=real, _name=name):
            counted[_name] += 1
            return _real(*args)

        monkeypatch.setattr(fa, f"_{name}", wrapper)
    cfg = LlamaConfig.tiny(max_len=32, n_heads=4, n_kv_heads=2, n_layers=2)
    for remat in (True, False):
        for k in counted:
            counted[k] = 0
        ex.run(n_devices=4, seq_len=32, n_steps=2, batch_size=1, config=cfg, remat=remat,
               device="cpu")
        want = chip_smoke.ring_step_launches(4, cfg.n_layers, remat)
        assert counted == {k: 2 * n for k, n in want.items()}


def test_shard_comparator_names_the_shard_that_is_off():
    want = torch.randn(1, 2, 32, 4)
    assert chip_smoke.check_shards("ok", want + 1e-6, want, 8, 1e-4) < 1e-5
    for j in (0, 5, 7):
        got = want.clone()
        got[:, :, 4 * j + 1] += 1e-2  # one row of shard j
        with pytest.raises(RuntimeError, match=f"shard {j} off"):
            chip_smoke.check_shards("out", got, want, 8, 1e-4)
    bias_grad = torch.randn(1, 1, 1, 32)
    off = bias_grad.clone()
    off[..., 30] = float("nan")
    with pytest.raises(RuntimeError, match="shard 7 not finite"):
        chip_smoke.check_shards("dbias", off, bias_grad, 8, 1e-4, dim=3)


def test_hold_attention_passes_the_ring_and_fails_a_broken_one():
    """Phase 21's comparison of a seam with one flash call, on the CPU at a
    tiny size: ring × flash passes; a ring that drops one shard's diagonal
    block fails on that shard."""
    from baton_tpu_torch.ops.flash_attention import flash_attention
    from baton_tpu_torch.parallel.mesh import make_mesh
    from baton_tpu_torch.parallel.ring_attention import make_flash_ring_attention_fn

    gen = torch.Generator().manual_seed(0)
    q, dout = (torch.randn(1, 4, 32, 8, generator=gen) for _ in range(2))
    k, v = (torch.randn(1, 2, 32, 8, generator=gen) for _ in range(2))
    bias = torch.where(torch.arange(32) < 13, 0.0, -1e30)[None, None, None, :]
    ring = make_flash_ring_attention_fn(make_mesh(8, ("seq",), devices=["cpu"] * 8))
    errs = chip_smoke.hold_attention("ring", ring, flash_attention, (q, k, v, dout, bias), 8,
                                     1e-4)
    assert set(errs) == {"out", "dq", "dk", "dv", "dbias"} and max(errs.values()) < 1e-4

    def broken(q, k, v, bias=None, causal=False):
        out = ring(q, k, v, bias=bias, causal=causal)
        return torch.cat([out[:, :, :8], 0.5 * out[:, :, 8:12], out[:, :, 12:]], dim=2)

    with pytest.raises(RuntimeError, match="out: shard 2 off"):
        chip_smoke.hold_attention("ring", broken, flash_attention, (q, k, v, dout, bias), 8,
                                  1e-4)


@pytest.mark.parametrize("dtype,fault", [(torch.float32, None), (torch.bfloat16, None),
                                         (torch.float32, "dk"), (torch.bfloat16, "dq_dtype"),
                                         (torch.float32, "fallback")])
def test_block_wrapper_check(monkeypatch, dtype, fault):
    """Phase 2's check of ``flash_block_fwd`` / ``flash_block_bwd`` on the
    CPU at a tiny ring block (the wrappers take their plain path here, so
    the launches are stubbed): it passes the wrappers, and fails a dk off
    at one key, a dq not cast back to bf16, and a call that launched no
    kernel; a block of padding keys takes the row's out and lse, as in the
    ring."""
    import functools

    monkeypatch.setattr(chip_smoke, "RING_BLOCK", (1, 4, 2, 40, 8))
    monkeypatch.setattr(chip_smoke, "attention_inputs",
                        functools.partial(chip_smoke.attention_inputs, device="cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    launched = {} if fault == "fallback" else dict.fromkeys(
        chip_smoke.design_keys(fa, dtype).values(), 1)
    monkeypatch.setattr(chip_smoke, "launches_since", lambda fa, before: ({}, launched))
    real_bwd = fa.flash_block_bwd

    def bwd(*args):
        dq, dk, dv, db = real_bwd(*args)
        if fault == "dk":
            dk = dk.clone()
            dk[0, 1, 7, 3] += 1e-2
        if fault == "dq_dtype":
            dq = dq.float()
        return dq, dk, dv, db

    monkeypatch.setattr(fa, "flash_block_bwd", bwd)
    for causal, all_padding in ((False, False), (True, False), (False, True)):
        if fault is None:
            chip_smoke.block_wrapper_case(fa, 100, dtype, causal, all_padding)
            continue
        match = {"dk": "dk: max abs err", "dq_dtype": "dtypes",
                 "fallback": "launches by design"}[fault]
        with pytest.raises(RuntimeError, match=match):
            chip_smoke.block_wrapper_case(fa, 100, dtype, causal, all_padding)


def test_model_gradient_check():
    want = {"a": torch.tensor([1.0, -2.0]), "b": torch.tensor([1e-3, 0.0])}
    got = {"a": want["a"] + 1e-5, "b": want["b"] * (1 + 1e-5)}
    assert chip_smoke.check_model_grads("ok", got, want) < 1e-4
    with pytest.raises(RuntimeError, match="gradient of b"):
        chip_smoke.check_model_grads("bad", dict(got, b=want["b"] * 1.01), want)


# ---------------------------------------------------------------------------
# phase 2's masked-row case and phase 22's checks


@pytest.mark.parametrize("fault", [None, "db"])
def test_masked_row_case_against_float64(monkeypatch, fault):
    """Phase 2's fp32 sample with every key masked, at L 512 on the CPU
    (the kernel wrapper takes its plain version here, its launch counted
    by a stub): both within the fp32 summation bound of float64; a dbias
    off by 1.0 at one key (|dbias| up to ~600, the bound there ~0.13) is
    not."""
    import functools

    monkeypatch.setattr(chip_smoke, "attention_inputs",
                        functools.partial(chip_smoke.attention_inputs, device="cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def counted(*args):
        fa.launches_by_design["bwd_dkv_tf32x3"] += 1
        dk, dv, db = fa._bwd_dkv_plain(*args)
        if fault == "db":
            db = db.clone()
            db[0, 1, 7] += 1.0
        return dk, dv, db

    monkeypatch.setattr(fa, "_bwd_dkv", counted)
    case = ("masked_long", 1, 4, 2, 512, 64, torch.float32, False, "masked_rows")
    if fault is None:
        out = chip_smoke.masked_row_oracle_case(fa, 0, *case)
        assert set(out) == {"dk", "dv", "db"}
        assert all(o["kernel_share_of_bound"] <= 1.0 for o in out.values())
    else:
        with pytest.raises(RuntimeError, match="db: kernel"):
            chip_smoke.masked_row_oracle_case(fa, 0, *case)


@pytest.mark.parametrize("fault", [None, "out"])
def test_masked_row_forward_case_against_float64(monkeypatch, fault):
    """Phase 2's forward long-sum oracle on the same sample at L 512 on the
    CPU (the forward wrapper takes its plain version, its launch counted by
    a stub): out and lse within the fp32 summation bound of float64; an out
    off by 1e-3 at one element (|out| ~0.1, the bound there ~3e-5) is
    not."""
    import functools

    monkeypatch.setattr(chip_smoke, "attention_inputs",
                        functools.partial(chip_smoke.attention_inputs, device="cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def counted(*args):
        fa.launches_by_design["fwd_tf32x3"] += 1
        out, lse = fa._fwd_plain(*args)
        if fault == "out":
            out = out.clone()
            out[0, 1, 7, 3] += 1e-3
        return out, lse

    monkeypatch.setattr(fa, "_fwd", counted)
    case = ("masked_long", 1, 4, 2, 512, 64, torch.float32, False, "masked_rows")
    if fault is None:
        got = chip_smoke.masked_row_forward_oracle_case(fa, 0, *case)
        assert set(got) == {"out", "lse"}
        assert all(o["kernel_share_of_bound"] <= 1.0 for o in got.values())
    else:
        with pytest.raises(RuntimeError, match="forward out: kernel"):
            chip_smoke.masked_row_forward_oracle_case(fa, 0, *case)


def test_gamma_is_the_worst_case_fp32_sum_error():
    assert chip_smoke.gamma(1) == pytest.approx(2.0 ** -24, rel=1e-6)
    assert chip_smoke.gamma(4096) == pytest.approx(4096 * 2.0 ** -24, rel=1e-3)


@pytest.mark.parametrize("off", [0.0, 0.2])
def test_band_check(off):
    start = {"w": torch.zeros(4)}
    want = {"w": torch.tensor([0.1, -0.2, 0.3, 0.0])}
    got = {"w": want["w"] + torch.tensor([1e-3, 0.0, off, 0.0])}
    band = chip_smoke.within_band(got, want, start)
    assert band["inside"] == (off == 0.0)
    assert band["largest_change"] == pytest.approx(0.3)
    assert band["max_gap"] == pytest.approx(max(1e-3, off), rel=1e-5)


@pytest.mark.parametrize("fault", [None, "one_shard_dropped"])
def test_mesh_round_held_against_meshless(monkeypatch, fault):
    """Phase 22's hold on 4 CPU shards of a linear round whose largest
    change (about 2.5e-2) is half the band: the mesh round passes;
    one that drops its last shard from the psum stays inside the band yet
    moves 8e-2 of the change, and fails."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.data.synthetic import linear_client_data
    from baton_tpu_torch.models.linear import linear_regression_model
    from baton_tpu_torch.ops import aggregation as agg
    from baton_tpu_torch.ops.padding import stack_client_datasets
    from baton_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    data, n = stack_client_datasets(
        [linear_client_data(rng, min_batches=1, max_batches=2) for _ in range(8)], batch_size=32)
    data, n = {k: torch.from_numpy(v) for k, v in data.items()}, torch.from_numpy(n)
    model, kw = linear_regression_model(10), dict(batch_size=32, learning_rate=5e-4)
    perms = torch.stack([torch.randperm(data["x"].shape[1],
                                        generator=torch.Generator().manual_seed(c))[None]
                         for c in range(8)])
    plain = FedSim(model, device="cpu", **kw)
    start = plain.init(torch.Generator().manual_seed(0))
    want = plain.run_round(start, data, n, perms=perms)
    if fault:
        real = agg.psum
        monkeypatch.setattr(agg, "psum", lambda parts, m, axis="clients": real(
            parts[:-1] + [{"p": {k: torch.zeros_like(v) for k, v in parts[-1]["p"].items()},
                           "l": torch.zeros_like(parts[-1]["l"]),
                           "w": torch.zeros_like(parts[-1]["w"])}], m, axis))
    got = FedSim(model, mesh=make_mesh(4, devices=["cpu"] * 4), **kw).run_round(
        start, data, n, perms=perms)
    band = chip_smoke.within_band(got.params, want.params, start)
    assert band["inside"] and band["largest_change"] <= chip_smoke.MESH_BAND
    if fault:
        with pytest.raises(RuntimeError, match="22a: the mesh round"):
            chip_smoke.hold_against_meshless("22a", got, want, start)
    else:
        held, loss_gap = chip_smoke.hold_against_meshless("22a", got, want, start)
        assert held["gap_over_change"] < 1e-4 and loss_gap < 1e-3


@pytest.mark.parametrize("fault", [None, "one_shard_dropped"])
def test_fold_against_float64(monkeypatch, fault):
    """Phase 22a's fold on 4 CPU shards: the psum FedAvg of trained
    client contributions within its fp32 bound of float64; a psum that
    drops a shard's sums is far outside it."""
    from baton_tpu_torch.ops import aggregation as agg
    from baton_tpu_torch.parallel.mesh import make_mesh

    gen = torch.Generator().manual_seed(0)
    client_params = {"w": torch.randn(8, 16, 4, generator=gen), "b": torch.randn(8, 4, generator=gen)}
    n_samples = np.array([3, 0, 7, 1, 5, 2, 8, 4])
    mesh = make_mesh(4, devices=["cpu"] * 4)
    if fault:
        real = agg.psum
        monkeypatch.setattr(agg, "psum", lambda parts, m, axis="clients": real(
            parts[:-1] + [{"sums": {k: torch.zeros_like(v) for k, v in parts[-1]["sums"].items()},
                           "w": parts[-1]["w"]}], m, axis))
        with pytest.raises(RuntimeError, match="psum fold"):
            chip_smoke.fold_against_oracle(client_params, n_samples, mesh)
    else:
        fold = chip_smoke.fold_against_oracle(client_params, n_samples, mesh)
        assert fold["share_of_bound"] <= 1.0 and fold["max_gap"] < 1e-5


def test_mesh_variants_against_cpu_at_a_tiny_size():
    """Phase 22c at a tiny size: the four variants on 2 shards against 8,
    both on the CPU, FedBuff's buffer of 8: every gap within 1e-4 and the
    bookkeeping equal."""
    model, params, data, n_samples = _tiny_bert_cohort()
    perms = torch.stack([torch.randperm(8, generator=torch.Generator().manual_seed(c))[None]
                         for c in range(4)])
    gaps = chip_smoke.variants_against_cpu(
        model, params, model.init(torch.Generator().manual_seed(1)), data, n_samples, 4, 0.05,
        perms, device="cpu", shards=chip_smoke.VARIANT_SHARDS, buffer=chip_smoke.VARIANT_BUFFER)
    assert len(gaps) == 4 and all(g <= 1e-5 for g in gaps.values())


def test_two_processes_over_gloo_on_the_cpu():
    """Phase 22d with its children's shards on the CPU: two processes, 2
    shards each, the psum across them within its fp32 bound of float64."""
    outs = chip_smoke.two_process_phase("cpu")
    assert [o["local_shards"] for o in outs] == [[0, 1], [2, 3]]
    assert all(o["backend"] == "gloo" and o["share_of_bound"] <= 1.0 for o in outs)


# ---------------------------------------------------------------------------
# phase 23's checks


def _counting_flash(monkeypatch):
    """The flash wrappers counting their calls as their kernels count
    launches on the card."""
    counted = {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0}
    for name in counted:
        real = getattr(fa, f"_{name}")

        def wrapper(*args, _real=real, _name=name):
            counted[_name] += 1
            return _real(*args)

        monkeypatch.setattr(fa, f"_{name}", wrapper)
    return counted


def _tiny_lora_hybrid_case(remat=False):
    """A tiny LoRA Llama (4/2 heads: 2/1 a shard on 2 model shards), 6
    clients of 8 sequences, batch 4, its adapters nonzero."""
    from baton_tpu_torch.examples import llama_lora
    from baton_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.tiny(max_len=16, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
    model = llama_lora.make_sim(cfg, 4, 4, "cpu", remat=remat)[1]
    params = model.init(torch.Generator().manual_seed(0))
    params = {k: (v + 0.05 if k.endswith("/b") else v) for k, v in params.items()}
    data, n_samples = llama_lora.client_data(cfg, 6, 8, 4, seed=0)
    perms = torch.stack([torch.randperm(8, generator=torch.Generator().manual_seed(c))[None]
                         for c in range(6)])
    return cfg, model, params, data, n_samples, perms


def _cpu_grid(clients, model):
    from baton_tpu_torch.parallel.mesh import Mesh

    return Mesh(np.array([[torch.device("cpu")] * model] * clients, dtype=object),
                ("clients", "model"))


@pytest.mark.parametrize("remat", [True, False])
def test_hybrid_launch_count_is_what_a_hybrid_round_launches(monkeypatch, remat):
    """The count phase 23 holds the card to, against a counted CPU round on
    2 x 2 shards: 6 clients in waves of 4 (2 waves, the second padded), 2
    steps each, 2 layers: every clients shard's every step launches each
    kernel once a layer a model shard (the forward twice under remat), and
    a frozen encoder under a trainable head launches the forward only."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
    from baton_tpu_torch.models.lora import lora_trainable

    counted = _counting_flash(monkeypatch)
    cfg, model, params, data, n_samples, perms = _tiny_lora_hybrid_case(remat)
    sim = FedSim(model, batch_size=4, learning_rate=1e-2, trainable=lora_trainable,
                 mesh=_cpu_grid(2, 2))
    sim.run_round(params, data, n_samples, perms=perms, wave_size=4)
    assert counted == chip_smoke.hybrid_round_launches(cfg.n_layers, 2 * 2, 2, 2, remat=remat)
    assert chip_smoke.hybrid_round_launches(32, 4, 2, 2) == HYBRID_COUNTS
    assert chip_smoke.hybrid_round_launches(32, 4, 1, 1) == CONFIG4_PER_ROUND
    bert = bert_classifier_model(BertConfig.tiny())
    bert_params = bert.init(torch.Generator().manual_seed(0))
    bert_data, bert_n = _tiny_bert_cohort()[2:]
    for k in counted:
        counted[k] = 0
    FedSim(bert, batch_size=4, learning_rate=0.05, mesh=_cpu_grid(2, 2),
           trainable=lambda path, leaf: path.startswith(chip_smoke.CONFIG3_HEAD)).run_round(
        bert_params, bert_data, bert_n, perms=torch.zeros(4, 1, 8, dtype=torch.long)
        + torch.arange(8))
    assert counted == chip_smoke.hybrid_round_launches(2, 2, 2, 2, backward=False)
    assert chip_smoke.hybrid_round_launches(12, 4, 2, 2, backward=False) == HYBRID_BERT_COUNTS


@pytest.mark.parametrize("fault", [None, "one_model_partial_dropped"])
def test_hybrid_round_held_against_meshless(monkeypatch, fault):
    """Phase 23's gap rule on a tiny fp32 LoRA round on 2 x 2 CPU shards:
    the hybrid round passes it (its gap a rounding error of the change); a
    round whose model-axis reduction drops the last shard's partial moves
    the adapters far from the meshless round and fails it."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models import transformer
    from baton_tpu_torch.models.lora import lora_trainable

    _, model, params, data, n_samples, perms = _tiny_lora_hybrid_case()
    kw = dict(batch_size=4, learning_rate=1e-2, trainable=lora_trainable)
    want = FedSim(model, device="cpu", **kw).run_round(params, data, n_samples, perms=perms)
    if fault:
        real = transformer.model_sum
        monkeypatch.setattr(transformer, "model_sum",
                            lambda parts: real(parts[:-1]) if len(parts) > 1 else real(parts))
    got = FedSim(model, mesh=_cpu_grid(2, 2), **kw).run_round(params, data, n_samples,
                                                             perms=perms)
    adapters = [k for k in params if lora_trainable(k, params[k])]
    gap = max(float((got.params[k] - want.params[k]).abs().max()) for k in adapters)
    moved = max(float((want.params[k] - params[k]).abs().max()) for k in adapters)
    if fault:
        assert gap / moved > 5 * chip_smoke.HYBRID_GAP_SHARE
        with pytest.raises(RuntimeError, match="23a: the hybrid round"):
            chip_smoke.hold_hybrid("23a", got, want, params, adapters)
    else:
        held = chip_smoke.hold_hybrid("23a", got, want, params, adapters)
        assert held["gap_over_change"] < 1e-4 and held["loss_gap"] < 1e-5
        chip_smoke.check_placed_base("23a", got.params, "base/blocks/0/attn/wq",
                                     "base/blocks/0/attn/wo")


def test_hybrid_peak_and_placement_checks():
    """The memory rule: at or under the meshless peak passes, above fails;
    the placement check fails a base left whole or split the wrong way."""
    chip_smoke.check_hybrid_peak("23a", 44.0, 55.02)
    chip_smoke.check_hybrid_peak("23a", 55.02, 55.02)
    with pytest.raises(RuntimeError, match="over the meshless round's"):
        chip_smoke.check_hybrid_peak("23a", 55.03, 55.02)
    from baton_tpu_torch.parallel.tensor_parallel import shard_params_tp

    params = {"wq": torch.zeros(8, 8), "wo": torch.zeros(8, 8)}
    chip_smoke.check_placed_base("23a", shard_params_tp(params, _cpu_grid(1, 2)), "wq", "wo")
    with pytest.raises(RuntimeError, match="want PartitionSpec"):
        chip_smoke.check_placed_base("23a", params, "wq", "wo")
    with pytest.raises(RuntimeError, match="want PartitionSpec"):
        chip_smoke.check_placed_base("23a", shard_params_tp(params, _cpu_grid(1, 2)), "wo", "wq")
