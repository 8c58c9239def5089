#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``baton_tpu_torch``) on one GPU.

Run from a checkout of the repository: ``python3 chip_smoke.py``. It needs
one CUDA card and ``nvcc``; it builds the flash-attention kernels from
``baton_tpu_torch/ops/csrc`` on first use. Phases, any failure of which
exits non-zero:

1. the card's name and power limit, and the kernels' build time with
   ptxas's registers, shared memory and spills for each kernel;
2. each kernel against its plain PyTorch version on the card: bf16 and
   fp32, causal or not, fully masked rows, GQA, ragged L (a single
   partial tile at L=40, L=200), D 64 and 128, and BERT-base's own shape
   (tolerance fp32 1e-4, bf16 2e-2); every bf16 call must go through
   the tensor-core design (mma), every fp32 one through the SIMT one; in
   every bf16 case each element of the dkv and dq kernels' gaps from
   their plain versions must lie within what bf16 rounding flips of p and
   ds can give (``flip_check``);
3. the main path at full width: BERT-base (bf16 compute) FedSim rounds,
   8 clients x 32 samples, L=128, one warm-up, ten timed rounds (mean and
   median: the host shares its cores, so single rounds vary), one
   round under torch.profiler (device time by kind of kernel, and the
   device's busy share) and a federated evaluation; every kernel must
   launch exactly once per layer per round (the client axis folds into
   one launch), every launch the mma design;
4. a 2-layer fp32 BERT-base-width round on the card against the same
   round of the port on the CPU (plain path), same weights and shuffles,
   params within 1e-4;
5. kernel times at BERT's shape (each the median of 5 readings of 20
   launches) beside their plain versions, PyTorch's
   scaled_dot_product_attention and the card's bound, as one JSON line,
   and the bytes/s of PyTorch's own copy as a yardstick;
6. the vision path at full width: ``bench.py``'s round, ResNet-18 with
   GroupNorm (bf16 compute), 32 clients x 48 CIFAR-shaped samples, batch
   32, lr 0.05, one wave, data drawn as ``bench.py`` draws it; one
   warm-up, ten timed rounds, one profiled round (device time by kind),
   peak memory, the round's compute record (MFU against the card's peak)
   and a federated evaluation; no flash kernel may launch in it. The
   round (clients vmapped, convs grouped by client) against every client
   trained alone without vmap on the same inputs, at these shapes, in
   bf16 and in fp32: per client and for the weighted mean, the round's
   distance from fp32 within ``BF16_GAP_RATIO_TOL`` times the bf16
   clients alone's, and a mixed-up pairing of clients outside it. Then 3 timed
   rounds (after a warm-up) each with the ``im2col`` and ``shift`` conv
   lowerings, beside ``direct``;
7. a 2-stage fp32 ResNet round on the card against the same round of the
   port on the CPU, 4 clients (one without samples), same weights and
   shuffles, once per conv lowering and once with the ``median``
   aggregator: params and losses within 1e-4.

``python3 chip_smoke.py --kernels-only`` runs phases 1, 2 and 5 alone: the
short first call after a kernel changes (build, ptxas report, comparison
at real widths, times). It prints no result line.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the package beside this script, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# kernel name -> (launch counter, design on the bf16 main path, its source,
# TPU kernel it replaces)
CSRC = "baton_tpu_torch/ops/csrc/"
KERNELS = {
    "flash_fwd": ("fwd", "mma", CSRC + "flash_attention_mma.cu",
                  "baton_tpu/ops/flash_attention.py:65"),
    "flash_bwd_dkv": ("bwd_dkv", "mma", CSRC + "flash_attention_mma.cu",
                      "baton_tpu/ops/flash_attention.py:203"),
    "flash_bwd_dq": ("bwd_dq", "mma", CSRC + "flash_attention_mma.cu",
                     "baton_tpu/ops/flash_attention.py:253"),
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, iters=20, warmup=3, readings=5) -> float:
    """Device time of one call of ``fn``: the median over ``readings`` of
    the mean by CUDA events over ``iters`` calls (one reading alone can
    catch a transient of the shared machine, 1.8x seen)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(readings):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return float(np.median(means))


# no bare "conv": it would match elementwise "convert" kernels
CONV_TOKENS = ("convolution", "conv2d", "fprop", "dgrad", "wgrad", "cudnn", "winograd",
               "implicit_gemm", "nchwtonhwc", "nhwctonchw")
NORM_TOKENS = ("groupnorm", "group_norm", "rowwisemoments", "fusedparams",
               "internalgradients", "gammabeta")


def kernel_kind(name: str) -> str:
    n = name.lower()
    if re.search(r"(^|[^a-z_])(fwd|dkv|dq)(_mma)?_kernel", n):
        return "flash attention (this port)"
    # before matmul: cuDNN's implicit-GEMM conv kernels carry gemm/xmma too
    if any(t in n for t in CONV_TOKENS):
        return "convolution (cuDNN)"
    if any(t in n for t in NORM_TOKENS):
        return "group norm"
    if any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    if "reduce" in n:
        return "reductions"
    if any(t in n for t in ("index", "scatter", "gather")):
        return "index/gather/scatter"
    return "elementwise and other"


def device_breakdown(prof, wall_s):
    """Device time of a profiled round, by kind and by kernel, and the
    device's busy share of the round's wall time (one stream, so kernel
    times do not overlap). None when the profiler saw no device time."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if total_ms == 0:
        print("  profiler saw no device time: breakdown not measured")
        return None
    kinds = {}
    for e in kernels:
        kind = kernel_kind(e.key)
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    busy = total_ms / (wall_s * 1e3)
    print(f"  profiled round: wall {wall_s * 1e3:.1f} ms, device busy {total_ms:.1f} ms "
          f"({100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%)")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"    {kind:28s} {ms:9.2f} ms  {100 * ms / total_ms:5.1f}% of device time")
    for e in top:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms x{e.count:<5d} {e.key[:110]}")
    return {"wall_ms": wall_s * 1e3, "device_ms": total_ms, "busy_share": busy,
            "by_kind_ms": kinds,
            "top": [[e.key[:110], e.count, e.self_device_time_total / 1e3] for e in top]}


def attention_inputs(seed, b, hq, hkv, l, d, dtype, bias_kind):
    """q, k, v, dout and a [B, L] bias made from a seed, on the card."""
    gen = torch.Generator().manual_seed(seed)
    q, dout = (torch.randn(b, hq, l, d, generator=gen) for _ in range(2))
    k, v = (torch.randn(b, hkv, l, d, generator=gen) for _ in range(2))
    lengths = np.random.default_rng(seed).integers(16, l + 1, b)
    valid = np.arange(l)[None, :] < lengths[:, None]
    if bias_kind == "masked_rows":
        valid[0] = False  # a zero-padded sample: every key masked
    elif bias_kind is None:
        valid[:] = True
    bias = torch.from_numpy(np.where(valid, 0.0, -1e30).astype(np.float32))
    return [t.to("cuda", dtype) for t in (q, k, v, dout)] + [bias.cuda()]


def compare_case(fa, seed, name, b, hq, hkv, l, d, dtype, causal, bias_kind):
    """Each kernel against its plain version on the same inputs; returns
    {kernel: max abs error}. The backward kernels get the plain forward's
    out and lse, so each comparison holds one kernel alone."""
    q, k, v, dout, bias = attention_inputs(seed, b, hq, hkv, l, d, dtype, bias_kind)
    scale = d ** -0.5
    tol = TOL[dtype]
    out_p, lse_p = fa._fwd_plain(q, k, v, bias, causal, scale)
    delta = (dout.float() * out_p.float()).sum(-1)
    design = "mma" if dtype == torch.bfloat16 else "simt"
    before = dict(fa.launches_by_design)
    pairs = {
        "flash_fwd": (fa._fwd(q, k, v, bias, causal, scale), (out_p, lse_p)),
        "flash_bwd_dkv": (fa._bwd_dkv(q, k, v, bias, dout, lse_p, delta, causal, scale),
                          fa._bwd_dkv_plain(q, k, v, bias, dout, lse_p, delta, causal, scale)),
        "flash_bwd_dq": ((fa._bwd_dq(q, k, v, bias, dout, lse_p, delta, causal, scale),),
                         (fa._bwd_dq_plain(q, k, v, bias, dout, lse_p, delta, causal, scale),)),
    }
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in fa.launches_by_design.items() if n != before[k]}
    check(ran == {f"fwd_{design}": 1, f"bwd_dkv_{design}": 1, f"bwd_dq_{design}": 1},
          f"{name}: launches by design {ran}")
    errs = {}
    for kname, (got, want) in pairs.items():
        err = 0.0
        for g, w in zip(got, want):
            g, w = g.float(), w.float()
            check(bool(torch.isfinite(g).all()), f"{name} {kname}: non-finite output")
            err = max(err, (g - w).abs().max().item())
            check(torch.allclose(g, w, rtol=tol, atol=tol),
                  f"{name} {kname}: max abs err {(g - w).abs().max().item():.3e} "
                  f"beyond rtol=atol={tol}")
        errs[kname] = err
    print(f"  {name:24s} B={b} Hq={hq} Hkv={hkv} L={l} D={d} {str(dtype)[6:]:8s} "
          f"causal={int(causal)} bias={bias_kind} {design}: "
          + " ".join(f"{k}={e:.2e}" for k, e in errs.items()) + f" (tol {tol})")
    if dtype == torch.bfloat16:
        got, want = (dict(zip(("dk", "dv", "db", "dq"),
                              (*pairs["flash_bwd_dkv"][i], *pairs["flash_bwd_dq"][i])))
                     for i in (0, 1))
        flip_check(fa, name, (q, k, v, bias, dout, lse_p, delta, causal, scale), got, want)
    return errs


def kernel_phase(fa):
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("bert_base", 256, 12, 12, 128, 64, bf16, False, "lengths"),
        ("fp32_d64", 4, 4, 4, 128, 64, f32, False, None),
        ("fp32_causal_d128", 2, 4, 4, 128, 128, f32, True, "lengths"),
        ("bf16_causal_d128", 2, 4, 4, 128, 128, bf16, True, "lengths"),
        ("bf16_causal_d64", 2, 4, 4, 192, 64, bf16, True, None),
        ("fp32_masked_rows", 3, 4, 4, 96, 64, f32, False, "masked_rows"),
        ("bf16_masked_rows", 3, 4, 4, 96, 128, bf16, False, "masked_rows"),
        ("fp32_gqa_causal", 2, 8, 2, 128, 64, f32, True, "lengths"),
        ("bf16_gqa", 2, 8, 2, 128, 128, bf16, False, "lengths"),
        ("fp32_ragged200_causal", 2, 4, 4, 200, 64, f32, True, "lengths"),
        ("bf16_ragged200_gqa", 2, 4, 2, 200, 128, bf16, False, "masked_rows"),
        ("bf16_l40_partial_tile", 3, 4, 4, 40, 64, bf16, False, "lengths"),
        ("bf16_ragged200_causal", 2, 4, 4, 200, 64, bf16, True, "lengths"),
        ("bf16_gqa_causal_d64", 2, 8, 2, 128, 64, bf16, True, "lengths"),
        ("bf16_l40_causal_d128", 2, 4, 2, 40, 128, bf16, True, None),
    ]
    print("phase 2: kernels against their plain versions")
    results = {c[0]: compare_case(fa, seed, *c) for seed, c in enumerate(cases)}
    return results["bert_base"]


def flip_check(fa, name, args, got, want):
    """Accounts for the bf16 backward kernels' gaps from their plain
    versions on ``args``; ``got`` and ``want`` map outputs (``dk``, ``dv``,
    ``db``, ``dq``) to the kernel's and the plain version's values. The two
    form the fp32 p a few ulps apart (the kernel's fmaf, __expf and
    tensor-core sums against torch's ops). Where p (ds) lies that close to
    a bf16 rounding boundary the two round it to neighbouring bf16 values,
    and dv (dk, dq) moves by one bf16 step of p (ds), plus that fp32
    uncertainty, times |do| (|q|, |k|). The bound sums those moves over
    every such element, plus 2^-20 of each sum's magnitude for the fp32
    summation order; every element of each output must lie within it."""
    q, k, v, bias, dout, lse, delta, causal, scale = args
    k, v = fa._expand_kv(k, q.shape[1]), fa._expand_kv(v, q.shape[1])
    p, ds = fa._p_ds(q, k, v, bias, dout, lse, delta, causal, scale)
    qa, ka, va, oa = (t.float().abs() for t in (q, k, v, dout))
    eps = 2.0 ** -20

    def ein(a, x):  # contract the queries (dk, dv)
        return torch.einsum("bhqk,bhqd->bhkd", a, x)

    def ein_q(a, x):  # contract the keys (dq)
        return torch.einsum("bhqk,bhkd->bhqd", a, x)

    def finite_abs(t):
        """|t|, but 0 for the -1e30 masking constant: in a fully masked row
        x = lse = -1e30 in both, so x - lse = 0 exactly."""
        return torch.where(t.abs() < 1e29, t.abs(), 0.0)

    # fp32 uncertainty of p (score sum, argument, exp) and of ds (p's, and dp's sum)
    arg_mag = (1 + scale * torch.einsum("bhqd,bhkd->bhqk", qa, ka)
               + finite_abs(bias)[:, None, None, :] + finite_abs(lse)[..., None])
    err_p = torch.where(p > 0, p * eps * arg_mag, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    dp_mag = torch.einsum("bhqd,bhkd->bhqk", oa, va)
    err_ds = err_p * (dp - delta[..., None]).abs() + p * eps * dp_mag

    def flip_steps(x, err):
        """Where x lies within err of a rounding boundary, one bf16 step plus
        err, else 0: two values err apart that round apart differ after
        rounding by at most that (err is what counts where x cancelled to
        near 0, as ds in a causal row that sees one key; at 0 itself every
        nonzero neighbour rounds apart, and the step is 0)."""
        step = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
        step = torch.where(x == 0, 0.0, step)
        dist = step / 2 - (x - x.bfloat16().float()).abs()
        return torch.where(dist <= err, step + err, 0.0)

    fp, fds = flip_steps(p, err_p), flip_steps(ds, err_ds)
    dsr = ds.bfloat16().float().abs()
    bounds = {
        "dk": lambda: scale * (ein(fds, qa) + eps * ein(dsr, qa)),
        "dv": lambda: ein(fp, oa) + eps * ein(p.bfloat16().float().abs(), oa),
        "db": lambda: err_ds.sum(2) + eps * ds.abs().sum(2),
        "dq": lambda: scale * (ein_q(fds, ka) + eps * ein_q(dsr, ka)),
    }
    over, parts = 0, []
    for out in got:
        g, w = got[out], want[out]
        gap, bound = (g - w).abs(), bounds[out]()
        at = int(gap.argmax())
        n_over = int((gap > bound).sum())
        over += n_over
        parts.append(f"{out} {gap.flatten()[at].item():.2e} (bound "
                     f"{bound.flatten()[at].item():.2e}, |plain| {w.flatten()[at].abs().item():.2e}"
                     f", {n_over} over)")
    print(f"    gap vs bf16 rounding flips: p near a boundary at {int((fp > 0).sum())} "
          f"of {p.numel()}, ds at {int((fds > 0).sum())}; max gap " + ", ".join(parts))
    check(over == 0, f"{name}: {'/'.join(got)} gap beyond what bf16 rounding flips explain "
          f"at {over} elements")


def bert_round_phase(fa):
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    cfg = BertConfig(vocab_size=30522, max_len=128, d_model=768, n_layers=12,
                     n_heads=12, d_ff=3072, n_classes=4)
    n_clients, batch, seq = 8, 32, 128
    rng = np.random.default_rng(0)
    datasets = []
    for _ in range(n_clients):
        lengths = rng.integers(16, seq + 1, batch)
        datasets.append({
            "x": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
            "attn_mask": (np.arange(seq)[None] < lengths[:, None]).astype(np.float32),
            "y": rng.integers(0, cfg.n_classes, batch).astype(np.int32),
        })
    data, n_samples = stack_client_datasets(datasets, batch_size=batch)
    model = bert_classifier_model(cfg, compute_dtype=torch.bfloat16, name="bert_base_bf16")
    sim = FedSim(model, batch_size=batch, learning_rate=0.01)
    params = sim.init(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in params.values())
    first = {k: v.clone() for k, v in params.items()}
    gen = torch.Generator().manual_seed(1)
    print(f"phase 3: BERT-base FedSim rounds ({n_params / 1e6:.1f} M params, bf16 compute, "
          f"{n_clients} clients x {batch} samples, L={seq})")

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    times, losses, breakdown = [], [], None
    n_timed = 10
    profiled = n_timed + 1
    # round 0 warms up, rounds 1..n_timed are timed, the last runs under the profiler
    for r in range(profiled + 1):
        before = fa.launches()
        before_design = dict(fa.launches_by_design)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with (torch.profiler.profile(activities=activities) if r == profiled
              else contextlib.nullcontext()) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sim.run_round(params, data, n_samples, gen)
            loss = res.loss_history.tolist()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        params = res.params
        losses.extend(loss)
        delta = {k: n - before[k] for k, n in fa.launches().items()}
        by_design = {k: n - before_design[k] for k, n in fa.launches_by_design.items()
                     if n != before_design[k]}
        label = {0: " (warm-up)", profiled: " (profiled)"}.get(r, "")
        print(f"  round {r}{label}: loss {loss} {dt:.4f} s launches {delta} by design {by_design}")
        if r == profiled:
            breakdown = device_breakdown(prof, dt)
        elif r > 0:
            times.append(dt)
        check(all(math.isfinite(x) for x in loss), f"round {r}: non-finite loss")
        check(all(n == cfg.n_layers for n in delta.values()),
              f"round {r}: launches {delta}, want {cfg.n_layers} of each kernel")
        check(by_design == {"fwd_mma": cfg.n_layers, "bwd_dkv_mma": cfg.n_layers,
                            "bwd_dq_mma": cfg.n_layers},
              f"round {r}: launches by design {by_design}, want every launch on mma")
    per_round = delta  # every round's count was checked equal
    ev = sim.evaluate_round(params, data, n_samples)
    main_launches = fa.launches()
    main_by_design = dict(fa.launches_by_design)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    changed = max((params[k] - first[k]).abs().max().item() for k in params)
    check(math.isfinite(ev["loss"]), "evaluation loss is not finite")
    check(all(bool(torch.isfinite(v).all()) for v in params.values()), "non-finite params")
    check(changed > 0, "the round left the params unchanged")
    s_round, s_median = sum(times) / n_timed, float(np.median(times))
    print(f"  evaluate_round: {ev}")
    print(f"  s/round mean {s_round:.4f}, median {s_median:.4f}, min {min(times):.4f} "
          f"(rounds 1-{n_timed}: {', '.join(f'{t:.4f}' for t in times)}); "
          f"samples/s {n_clients * batch / s_round:.1f} (at the median "
          f"{n_clients * batch / s_median:.1f}); peak memory {peak_gb:.2f} GB; "
          f"max |param change| {changed:.3e}; launches over the path {main_launches}, "
          f"by design {main_by_design}")
    if breakdown:
        ratio = breakdown["device_ms"] / 1e3 / s_median
        print(f"  profiled device time over the unprofiled median wall: {ratio:.3f} (not a busy "
              "share: the profiler lengthens kernels)")
    return main_launches, per_round, {"breakdown": breakdown, "round_s": times,
                           "s_per_round": s_round, "s_per_round_median": s_median,
                           "samples_per_s": n_clients * batch / s_round,
                           "peak_memory_gb": peak_gb, "losses": losses,
                           "eval": ev, "n_params": n_params}


def in_context_phase(fa):
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    cfg = BertConfig(vocab_size=30522, max_len=128, d_model=768, n_layers=2,
                     n_heads=12, d_ff=3072, n_classes=4)
    batch, seq = 32, 128
    rng = np.random.default_rng(2)
    datasets = []
    for n in (32, 20, 32, 0):
        lengths = rng.integers(16, seq + 1, n)
        datasets.append({
            "x": rng.integers(0, cfg.vocab_size, (n, seq)).astype(np.int32),
            "attn_mask": (np.arange(seq)[None] < lengths[:, None]).astype(np.float32),
            "y": rng.integers(0, cfg.n_classes, n).astype(np.int32),
        })
    data, n_samples = stack_client_datasets(datasets, batch_size=batch)
    perms = torch.from_numpy(np.stack([rng.permutation(batch)[None] for _ in datasets]))
    model = bert_classifier_model(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    print("phase 4: 2-layer fp32 BERT round, card against the CPU (plain path)")
    before = fa.launches()
    before_design = dict(fa.launches_by_design)
    t0 = time.perf_counter()
    gpu = FedSim(model, batch_size=batch, learning_rate=0.01).run_round(
        {k: v.cuda() for k, v in params.items()}, data, n_samples, perms=perms)
    gpu_params = {k: v.cpu() for k, v in gpu.params.items()}
    t_gpu = time.perf_counter() - t0
    delta = {k: n - before[k] for k, n in fa.launches().items()}
    by_design = {k: n - before_design[k] for k, n in fa.launches_by_design.items()
                 if n != before_design[k]}
    t0 = time.perf_counter()
    cpu = FedSim(model, batch_size=batch, learning_rate=0.01, device="cpu").run_round(
        params, data, n_samples, perms=perms)
    t_cpu = time.perf_counter() - t0
    err = max((gpu_params[k] - cpu.params[k]).abs().max().item() for k in params)
    moved = max((cpu.params[k] - params[k]).abs().max().item() for k in params)
    loss_err = (gpu.loss_history.cpu() - cpu.loss_history).abs().max().item()
    print(f"  card {t_gpu:.2f} s, CPU {t_cpu:.2f} s; launches on the card {delta}; "
          f"max |param diff| {err:.3e} (tol 1e-4; max |param change| {moved:.3e}); "
          f"loss {gpu.loss_history.tolist()} vs {cpu.loss_history.tolist()}")
    check(all(n == cfg.n_layers for n in delta.values()), f"card round launches {delta}")
    check(by_design == {"fwd_simt": cfg.n_layers, "bwd_dkv_simt": cfg.n_layers,
                        "bwd_dq_simt": cfg.n_layers}, f"fp32 round launches by design {by_design}")
    check(err <= 1e-4, f"card and CPU params differ by {err:.3e}")
    check(loss_err <= 1e-4, f"card and CPU losses differ by {loss_err:.3e}")


def timing_phase(fa, name, main_launches, per_round, bert_errs):
    """Kernel, plain and library times at BERT-base's shape (bf16, padding
    bias), and the card's bound for the same work. ``main_launches`` and
    ``per_round`` (launches by pass over the main path and in one of its
    rounds) are None when the main path did not run (--kernels-only)."""
    import torch.nn.functional as F

    b, h, l, d, dtype = 256, 12, 128, 64, torch.bfloat16
    q, k, v, dout, bias = attention_inputs(7, b, h, h, l, d, dtype, "lengths")
    scale = d ** -0.5
    out, lse = fa._fwd_plain(q, k, v, bias, False, scale)
    delta = (dout.float() * out.float()).sum(-1)
    args = (q, k, v, bias, dout, lse, delta, False, scale)
    mask4 = bias[:, None, None, :].to(dtype)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask4)

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask4)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qg, kg, vg), dout, retain_graph=True)

    timed = {
        "flash_fwd": (lambda: fa._fwd(q, k, v, bias, False, scale),
                      lambda: fa._fwd_plain(q, k, v, bias, False, scale), sdpa),
        "flash_bwd_dkv": (lambda: fa._bwd_dkv(*args), lambda: fa._bwd_dkv_plain(*args),
                          sdpa_bwd),
        "flash_bwd_dq": (lambda: fa._bwd_dq(*args), lambda: fa._bwd_dq_plain(*args),
                         sdpa_bwd),
    }
    el, n_bhld, n_bhl = q.element_size(), b * h * l * d, b * h * l
    bias_b, mm = b * l * 4, 2 * b * h * l * l * d  # one L x L x D product
    work = {  # bytes each input read once and each output written once, FLOPs
        "flash_fwd": (4 * el * n_bhld + bias_b + 4 * n_bhl, 2 * mm),
        "flash_bwd_dkv": (4 * el * n_bhld + 8 * n_bhl + bias_b + 8 * n_bhld + 4 * n_bhl,
                          4 * mm),
        "flash_bwd_dq": (4 * el * n_bhld + 8 * n_bhl + bias_b + 4 * n_bhld, 3 * mm),
    }
    from baton_tpu_torch.obs.compute import card_peaks

    peaks = card_peaks(name)
    check(peaks is not None, f"no data-sheet peaks for {name!r}")
    bw, bf16_peak = peaks
    print(f"phase 5: times at BERT's shape (B={b}, H={h}, L={l}, D={d}, bf16, padding bias); "
          f"bound from {bw / 1e12:.2f} TB/s and {bf16_peak / 1e12:.0f} TFLOP/s bf16")
    rows = []
    for kname, (kernel, plain, library) in timed.items():
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        library_ms = time_ms(library)
        ms2 = time_ms(kernel)  # a second reading shows the spread
        nbytes, flops = work[kname]
        t_bytes, t_ops = nbytes / bw * 1e3, flops / bf16_peak * 1e3
        counter, design, source, replaces = KERNELS[kname]
        rows.append({
            "name": kname, "route": "cuda", "design": design, "source": source,
            "replaces": replaces,
            "launches": main_launches[counter] if main_launches else None,
            "launches_per_round": per_round[counter] if per_round else None,
            "max_abs_err": bert_errs[kname], "tol": TOL[dtype],
            "ms": ms, "ms_repeat": ms2, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "library_call": ("scaled_dot_product_attention forward" if kname == "flash_fwd"
                             else "scaled_dot_product_attention backward (dq, dk, dv)"),
            "bytes": nbytes, "flops": flops, "achieved_tb_s": nbytes / ms / 1e9,
            "bound_share": max(t_bytes, t_ops) / ms,
        })
        print(f"  {kname} ({design}): {ms:.4f} ms (again {ms2:.4f}), plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
              f"{nbytes / ms / 1e9:.2f} TB/s achieved, {100 * max(t_bytes, t_ops) / ms:.1f}% "
              f"of the bound)")

    # the fp32 SIMT kernels (phase 4's path, not the main one)
    q32, k32, v32, dout32 = (t.float() for t in (q, k, v, dout))
    args32 = (q32, k32, v32, bias, dout32, lse, delta, False, scale)
    simt = {"flash_fwd_simt_fp32": time_ms(lambda: fa._fwd(q32, k32, v32, bias, False, scale)),
            "flash_bwd_dkv_simt_fp32": time_ms(lambda: fa._bwd_dkv(*args32)),
            "flash_bwd_dq_simt_fp32": time_ms(lambda: fa._bwd_dq(*args32))}
    print("  fp32 SIMT at the same shape: "
          + ", ".join(f"{k} {ms:.4f} ms" for k, ms in simt.items()))
    # a yardstick for the kernels' bytes/s: PyTorch's copy of q reads and writes it once
    clone_tb_s = 2 * q.numel() * el / time_ms(q.clone) / 1e9
    print(f"  q.clone() moves {clone_tb_s:.3f} TB/s on this card")
    return rows, dict(simt, clone_tb_s=clone_tb_s)


def time_round(sim, params, data, n_samples, gen):
    """One round to its end on the card: (result, wall seconds, losses)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run_round(params, data, n_samples, gen)
    loss = res.loss_history.tolist()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, loss


# Phase 6's reference check. At init, bf16 rounding alone moves a
# ResNet-18's updates far from fp32 (tens of percent in the first layers)
# on either path, so the vmapped bf16 round is held to the distance from
# fp32 of every client trained alone in bf16: at most this many times it.
# Set from the card's readings in PERF.md (1.22 at most; a mixed-up client 3.2 or more).
BF16_GAP_RATIO_TOL = 1.6
LOSS_REL_TOL = 2e-2  # per-client losses, vmapped against alone, both bf16


def train_each_client_alone(model, params, data, n_samples, perms, batch, lr):
    """Every client trained alone, without vmap: plain autograd SGD over
    its batches in the order of ``perms`` [C, 1, capacity], the steps that
    ``LocalTrainer.train_clients`` takes for all clients at once (a batch
    without samples is skipped). Returns the per-client params (leaves
    [C, ...]) and losses [C]."""
    clients, losses = [], []
    for c in range(perms.shape[0]):
        perm = perms[c, 0].to(n_samples.device)
        rows = {k: v[c][perm] for k, v in data.items()}
        mask = (perm < n_samples[c]).float()
        rows["mask"] = mask * rows["mask"].float() if "mask" in rows else mask
        p = dict(params)
        loss_sum = count = 0.0
        for s in range(0, perm.shape[0], batch):
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            ls, n = model.loss_and_count(leaves, {k: v[s:s + batch] for k, v in rows.items()})
            if n.item() > 0:
                grads = torch.autograd.grad(ls / n, list(leaves.values()))
                p = {k: (v + g * -lr).detach() for (k, v), g in zip(leaves.items(), grads)}
            loss_sum, count = loss_sum + ls.item(), count + n.item()
        clients.append(p)
        losses.append(loss_sum / max(count, 1.0))
    stacked = {k: torch.stack([p[k] for p in clients]) for k in params}
    return stacked, torch.tensor(losses)


def update_gaps(start, got, want):
    """Per client (leading axis), the largest over tensors of
    ||got - want|| / ||want - start||: two updates' gap relative to the
    reference's update."""
    gaps = []
    for k, s in start.items():
        g, w = got[k].float(), want[k].float()
        c = g.shape[0]
        num = (g - w).reshape(c, -1).norm(dim=1)
        gaps.append(num / (w - s.float()).reshape(c, -1).norm(dim=1).clamp_min(1e-30))
    return torch.stack(gaps).max(0).values


def vmap_against_clients_alone(sim, reference_model, params, data, n_samples, gen):
    """The bf16 round (the clients vmapped: convs grouped by client)
    against every client trained alone (plain convs) on the same inputs
    and shuffles, once in the round's dtype and once in fp32
    (``reference_model``). Each vmapped client's update and the round's
    mean update must lie within ``BF16_GAP_RATIO_TOL`` times the bf16
    clients alone's distance from fp32 (``update_gaps``), and per-client
    losses within ``LOSS_REL_TOL``. A control pairs each vmapped client
    with the next client's fp32 reference: the check must reject it."""
    from baton_tpu_torch.core.training import random_perms

    data = {k: torch.as_tensor(v, device=sim.device) for k, v in data.items()}
    n = torch.as_tensor(n_samples, device=sim.device)
    capacity = next(iter(data.values())).shape[1]
    perms = random_perms(n.shape[0], 1, capacity, gen)
    trainer = sim.trainer
    alone, alone_losses = train_each_client_alone(sim.model, params, data, n, perms,
                                                  trainer.batch_size, trainer.learning_rate)
    ref, _ = train_each_client_alone(reference_model, params, data, n, perms,
                                     trainer.batch_size, trainer.learning_rate)
    vmapped, _ = trainer.train_clients(params, data, n, 1, perms.to(sim.device))
    res = sim.run_round(params, data, n_samples, perms=perms)
    w = n.float()

    def mean(t):
        return {k: (torch.tensordot(w, v.float(), dims=([0], [0])) / w.sum())[None]
                for k, v in t.items()}

    round_ratio = (update_gaps(params, {k: v[None] for k, v in res.params.items()}, mean(ref))
                   / update_gaps(params, mean(alone), mean(ref))).item()
    has = (n > 0).nonzero()[:, 0]  # a client without samples does not move
    vmapped, alone, ref = ({k: v[has] for k, v in t.items()} for t in (vmapped, alone, ref))
    noise = update_gaps(params, alone, ref)
    ratio = update_gaps(params, vmapped, ref) / noise
    control = update_gaps(params, vmapped, {k: v.roll(-1, 0) for k, v in ref.items()}) / noise
    same_dtype = update_gaps(params, vmapped, alone)
    has = has.cpu()
    loss_gap = ((res.client_losses[:, 0].cpu()[has] - alone_losses[has]).abs()
                / alone_losses[has].abs()).max().item()
    stats = {"bf16_alone_from_fp32_max": noise.max().item(),
             "bf16_alone_from_fp32_median": noise.median().item(),
             "client_ratio_max": ratio.max().item(), "client_ratio_median": ratio.median().item(),
             "round_ratio": round_ratio, "vmapped_from_alone_max": same_dtype.max().item(),
             "loss_rel_gap_max": loss_gap, "mixed_up_control_ratio_min": control.min().item(),
             "ratio_tol": BF16_GAP_RATIO_TOL, "loss_tol": LOSS_REL_TOL}
    print("  the round against every client alone (relative L2 of the updates, worst tensor):"
          f" bf16 alone from fp32 max {stats['bf16_alone_from_fp32_max']:.3e}, median "
          f"{stats['bf16_alone_from_fp32_median']:.3e}; vmapped from fp32 over that: per client"
          f" max {stats['client_ratio_max']:.3f}, median {stats['client_ratio_median']:.3f}, the"
          f" round's mean {round_ratio:.3f} (tol {BF16_GAP_RATIO_TOL}); vmapped from bf16 alone"
          f" max {stats['vmapped_from_alone_max']:.3e}; per-client losses {loss_gap:.3e} relative"
          f" (tol {LOSS_REL_TOL}); mixed-up control ratio min "
          f"{stats['mixed_up_control_ratio_min']:.3f}")
    check(max(stats["client_ratio_max"], round_ratio) <= BF16_GAP_RATIO_TOL
          and loss_gap <= LOSS_REL_TOL, f"vmapped round and clients alone differ: {stats}")
    check(stats["mixed_up_control_ratio_min"] > BF16_GAP_RATIO_TOL,
          f"the check cannot tell mixed-up clients apart: {stats}")
    return stats


def resnet_round_phase(fa):
    """``bench.py``'s round (bench.py:32-41, 430-461) on the port."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.resnet import resnet18_cifar_model
    from baton_tpu_torch.obs.compute import validate_record
    from baton_tpu_torch.ops.padding import stack_client_datasets

    n_clients, per_client, batch, lr = 32, 48, 32, 0.05
    rng = np.random.default_rng(0)
    datasets = [{"x": rng.normal(size=(per_client, 32, 32, 3)).astype(np.float32),
                 "y": rng.integers(0, 10, size=(per_client,)).astype(np.int32)}
                for _ in range(n_clients)]
    data, n_samples = stack_client_datasets(datasets, batch_size=batch)
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}  # staged, as bench
    n_total = int(n_samples.sum())

    def make_sim(impl):
        model = resnet18_cifar_model(compute_dtype=torch.bfloat16, conv_impl=impl)
        return FedSim(model, batch_size=batch, learning_rate=lr)

    sim = make_sim("direct")
    params = sim.init(torch.Generator().manual_seed(0))
    first = {k: v.clone() for k, v in params.items()}
    n_params = sum(p.numel() for p in params.values())
    gen = torch.Generator().manual_seed(1)
    print(f"phase 6: ResNet-18 FedSim rounds as bench.py ({n_params / 1e6:.2f} M params, bf16 "
          f"compute, {n_clients} clients x {per_client} samples, capacity "
          f"{data['x'].shape[1]}, batch {batch}, lr {lr}, conv direct)")

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    times, losses, records, breakdown = [], [], [], None
    n_timed = 10
    profiled = n_timed + 1
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for r in range(profiled + 1):
        with (torch.profiler.profile(activities=activities) if r == profiled
              else contextlib.nullcontext()) as prof:
            res, dt, loss = time_round(sim, params, data, n_samples, gen)
        params = res.params
        losses.extend(loss)
        rec = sim.last_compute
        check(rec is not None and validate_record(rec) == [],
              f"round {r}: compute record {rec} breaks null-with-reason")
        label = {0: " (warm-up)", profiled: " (profiled)"}.get(r, "")
        print(f"  round {r}{label}: loss {loss} {dt:.4f} s; record train_s {rec['train_s']} "
              f"mfu {rec['mfu']} cache_hit {rec['cache_hit']}")
        if r == profiled:
            breakdown = device_breakdown(prof, dt)
        elif r > 0:
            times.append(dt)
            records.append(rec)
        check(all(math.isfinite(x) for x in loss), f"round {r}: non-finite loss")
    ev = sim.evaluate_round(params, data, n_samples)
    flash = fa.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    changed = max((params[k] - first[k]).abs().max().item() for k in params)
    check(all(n == 0 for n in flash.values()), f"flash kernels launched in the ResNet round: {flash}")
    check(math.isfinite(ev["loss"]), "evaluation loss is not finite")
    check(all(bool(torch.isfinite(v).all()) for v in params.values()), "non-finite params")
    check(changed > 0, "the rounds left the params unchanged")
    check(all(r["mfu"] is not None for r in records), "no MFU on this card")
    reference = vmap_against_clients_alone(sim, resnet18_cifar_model(), first, data, n_samples,
                                           torch.Generator().manual_seed(2))
    s_mean, s_median = sum(times) / n_timed, float(np.median(times))
    mfus = [r["mfu"] for r in records]
    print(f"  evaluate_round: {ev}")
    print(f"  s/round mean {s_mean:.4f}, median {s_median:.4f}, min {min(times):.4f} "
          f"(rounds 1-{n_timed}: {', '.join(f'{t:.4f}' for t in times)}); samples/s "
          f"{n_total / s_mean:.1f} (at the median {n_total / s_median:.1f}); peak memory "
          f"{peak_gb:.2f} GB; max |param change| {changed:.3e}; flash launches {flash}")
    print(f"  MFU (compute record, {records[0]['flops_per_sample']:.3g} FLOP/sample, peak of "
          f"{records[0]['device_kind']}): median {float(np.median(mfus)):.4f}, "
          f"min {min(mfus):.4f}, max {max(mfus):.4f}")
    print(f"  last_compute: {json.dumps(records[-1])}")
    if breakdown:
        print(f"  profiled device time over the unprofiled median wall: "
              f"{breakdown['device_ms'] / 1e3 / s_median:.3f} (not a busy share: the profiler "
              "lengthens kernels)")

    lowerings = {"direct": {"round_s": times, "s_per_round_median": s_median,
                            "peak_memory_gb": peak_gb}}
    for impl in ("im2col", "shift"):
        del sim, res
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sim = make_sim(impl)
        p = {k: v.clone() for k, v in first.items()}
        g = torch.Generator().manual_seed(1)
        _, warm, loss = time_round(sim, p, data, n_samples, g)
        check(all(math.isfinite(x) for x in loss), f"{impl}: non-finite loss")
        impl_times = []
        for _ in range(3):
            res, dt, loss = time_round(sim, p, data, n_samples, g)
            p = res.params
            impl_times.append(dt)
            check(all(math.isfinite(x) for x in loss), f"{impl}: non-finite loss")
        lowerings[impl] = {"round_s": impl_times, "warm_up_s": warm,
                           "s_per_round_median": float(np.median(impl_times)),
                           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("  conv lowerings, s/round (median; rounds) and peak memory:")
    for impl, st in lowerings.items():
        print(f"    {impl:7s} {st['s_per_round_median']:.4f} s "
              f"({', '.join(f'{t:.4f}' for t in st['round_s'])}), "
              f"{n_total / st['s_per_round_median']:.1f} samples/s, "
              f"peak {st['peak_memory_gb']:.2f} GB")
    return {"breakdown": breakdown, "round_s": times, "s_per_round": s_mean,
            "s_per_round_median": s_median, "samples_per_s": n_total / s_mean,
            "peak_memory_gb": peak_gb, "losses": losses, "eval": ev, "n_params": n_params,
            "mfu_median": float(np.median(mfus)), "last_compute": records[-1],
            "against_clients_alone": reference, "lowerings": lowerings}


def vision_parity_phase():
    """A 2-stage fp32 ResNet round, card against the port's CPU round."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.resnet import resnet_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    batch = 8
    rng = np.random.default_rng(4)
    datasets = [{"x": rng.normal(size=(n, 16, 16, 3)).astype(np.float32),
                 "y": rng.integers(0, 10, n).astype(np.int32)} for n in (16, 0, 11, 13)]
    data, n_samples = stack_client_datasets(datasets, batch_size=batch)
    perms = torch.from_numpy(np.stack([rng.permutation(data["x"].shape[1])[None]
                                       for _ in datasets]))
    print("phase 7: 2-stage fp32 ResNet round, card against the CPU, per conv lowering "
          "and with the median aggregator (tol 1e-4)")
    for impl, aggregator in (("direct", "mean"), ("im2col", "mean"), ("shift", "mean"),
                             ("direct", "median")):
        model = resnet_model(blocks_per_stage=(1, 1), n_groups=8, conv_impl=impl)
        params = model.init(torch.Generator().manual_seed(3))
        kw = dict(batch_size=batch, learning_rate=0.05, aggregator=aggregator)
        gpu = FedSim(model, **kw).run_round({k: v.cuda() for k, v in params.items()}, data,
                                            n_samples, perms=perms)
        cpu = FedSim(model, device="cpu", **kw).run_round(params, data, n_samples, perms=perms)
        err = max((gpu.params[k].cpu() - cpu.params[k]).abs().max().item() for k in params)
        moved = max((cpu.params[k] - params[k]).abs().max().item() for k in params)
        loss_err = (gpu.loss_history.cpu() - cpu.loss_history).abs().max().item()
        print(f"  {impl:7s} {aggregator:7s} max |param diff| {err:.3e} (max |param change| "
              f"{moved:.3e}), max |loss diff| {loss_err:.3e}")
        check(moved > 0, f"{impl}/{aggregator}: the CPU round left the params unchanged")
        check(err <= 1e-4, f"{impl}/{aggregator}: card and CPU params differ by {err:.3e}")
        check(loss_err <= 1e-4, f"{impl}/{aggregator}: card and CPU losses differ by "
              f"{loss_err:.3e}")


def main() -> int:
    kernels_only = sys.argv[1:] == ["--kernels-only"]
    if sys.argv[1:] and not kernels_only:
        print(f"usage: {sys.argv[0]} [--kernels-only]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from baton_tpu_torch.ops import flash_attention as fa

    # fp32 comparisons hold full fp32 on the card: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}")

    t0 = time.perf_counter()
    fa.load_library()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({fa.library_path().name})")
    for line in fa.library_path().with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())

    phases = time.perf_counter()
    bert_errs = kernel_phase(fa)
    if kernels_only:
        rows, extra = timing_phase(fa, name, None, None, bert_errs)
        print(json.dumps({"kernels": rows, "extra": extra}))
        print(f"phases 2 and 5 took {time.perf_counter() - phases:.1f} s; no result line "
              "(--kernels-only)")
        return 0
    main_launches, per_round, round_stats = bert_round_phase(fa)
    in_context_phase(fa)
    rows, extra = timing_phase(fa, name, main_launches, per_round, bert_errs)
    print(f"phases 2-5 took {time.perf_counter() - phases:.1f} s")
    vision = time.perf_counter()
    resnet_stats = resnet_round_phase(fa)
    vision_parity_phase()
    print(f"phases 6-7 took {time.perf_counter() - vision:.1f} s")

    print(json.dumps({"round": round_stats, "resnet_round": resnet_stats, "extra": extra}))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
