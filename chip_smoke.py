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
   partial tile at L=40, L=200), D 64 and 128, BERT-base's own shape and
   each model shard's shape on phase 23's hybrid meshes (tolerance fp32
   1e-4, bf16 2e-2); every bf16 call must go through
   the tensor-core design (mma), every fp32 call (the forward and both
   passes of the backward) through the 3xTF32 tensor-core one (tf32x3);
   in every bf16 case each element of the dkv and dq kernels' gaps from
   their plain versions must lie within what bf16 rounding flips of p and
   ds can give (``flip_check``); and one fp32 sample with every key
   masked at L 4,096, where out, dk, dv and dbias sum 4,096 terms of
   order 1: the forward and dkv kernels and their plain versions each
   held against float64 on the same inputs within the worst-case fp32
   error of those sums (``masked_row_oracle_case``,
   ``masked_row_forward_oracle_case``);
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
   and the bytes/s of PyTorch's own copy as a yardstick; then the same at
   Llama-3-8B's attention shape, the bound counting the tiles the causal
   mask leaves (the kernels skip those wholly in the future);
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
   aggregator: params and losses within 1e-4;
8. BASELINE config 3 at BERT-base width (``examples/03_bert_fedprox.py``
   ``--scale full``: vocab 512, bf16 compute, FedProx mu 0.1, local SGD
   lr 5e-3, batch 32, 2 epochs) on its label-skewed synthetic data (the
   port's example 03, ``baton_tpu_torch/examples/bert_fedprox.py``), cut
   to 8 clients x 64 samples, one wave: a warm-up, five timed rounds and
   a profiled one; every flash kernel launches once per layer per step.
   The same clients at mu = 0 must drift farther from the global params;
   a trainable-head variant (``pooler/*``, ``head/*``) must leave every
   frozen tensor bit-equal, move the trainable ones and stay below the
   memory of the frozen params repeated per client. Then one optimizer
   step's device time and launches (SGD, momentum, Adam) on 8 clients;
9. phase 6's ResNet-18 round with local momentum 0.9 and a FedAdam
   server (three rounds, its state threaded: count 3), then local Adam:
   s/round, MFU and peak memory against phase 6, and one optimizer step's
   device time and launches on 32 clients;
10. a 2-layer fp32 BERT round (phase 4's) and a 2-stage ResNet round
   (phase 7's), each with local momentum, local Adam, FedProx, a FedAdam
   server (two rounds, its state threaded), a trainable part, then all of
   them at once (two rounds), card
   against the CPU: params and losses within 1e-4 (``option_variants``
   says why Adam's eps is raised there);
11. the reference's HTTP round on the card: a ``Manager`` and 8
   ``ExperimentWorker``s in this process over loopback (BTW1 uploads,
   the mean aggregator), each worker training phase 6's ResNet-18 (bf16
   compute) on 48 samples drawn as phase 6 draws them, batch 32, 1 epoch,
   lr 0.05: a warm-up and 3 timed rounds (from ``start_round`` until the
   round count advances), samples/s, the split of a round from the
   manager's and workers' spans, each worker's compute record as it
   reached the manager and ``rounds.jsonl``, and peak memory. The global
   params equal the sample-weighted mean of the bodies the manager
   received (1e-6), no flash kernel launches, and every trainer is handed
   tensors on the card. Then an fp32 variant, 2 workers (20 and 48
   samples) for 2 rounds, against each worker's local train replayed in
   this process from the broadcast and merged by the port's aggregator:
   params within 1e-4 and within a hundredth of the round's largest
   param change, while a replay with the 20-sample worker counted as 32,
   or with its upload dropped, must fail that check;
12. phase 11's federation with the bandwidth options and a restart: 3
   rounds with every worker uploading top-k (10%) int8 round deltas with
   error feedback (the top-k on the card) and int8 broadcasts, the
   manager checkpointing each round; then the manager stops, a new one on
   the same port resumes from the checkpoints (params to the bit, round
   count, loss history) with top-k int8 delta broadcasts, and runs 2
   rounds with the same workers, which register again. Each round's
   params equal the fold of the decoded uploads (1e-6); each worker's
   transmitted mass plus its residual equals the sum of its true deltas
   (1e-5 relative); the first round after the restart pulls the full
   blob and the second a delta, with no digest mismatch. Round times and
   bytes per upload and per blob pull are printed against the dense size;
13. secure aggregation at ResNet-18 width (fp32): 4 workers, threshold 3,
   2 rounds; in the second the last worker drops after the share
   exchange and its masks are recovered. Each round's params equal the
   sample-weighted mean of what the survivors trained (within the fixed
   point's quantum, 2^-16) and their replayed local trains (the quantum
   plus 1e-4, and a hundredth of the largest change, with the planted
   faults of phase 11 failing); the host times of masking on the workers
   and unmasking on the manager are printed;
14. BASELINE config 1 (``baton_tpu_torch/examples/cnn_mnist_fedavg.py``,
   the synthetic MNIST fallback): the tiny preset's 4 rounds of ``run()``
   on the card, the same run stopped after 2 rounds and resumed from its
   checkpoints (1e-6, cuDNN's deterministic algorithms for this phase)
   and on the CPU (1e-4); then the full preset (4 x 15,000 samples, 4
   epochs) for 1 of its 20 rounds, timed apart from making its data,
   its accuracy above 0.5. No flash kernel launches in phases 12-14;
15. the federation variants on phase 3's BERT-base and clients (bf16
   compute, 8 x 32 samples): stateful clients with local Adam, 3 rounds
   of 2 epochs (round 0 equal to ``FedSim.run_round`` within 1e-6,
   Adam's count 3 x the steps a round; that FedSim round's own peak
   printed beside the stateful rounds'); FedBuff with buffer =
   concurrency = 8 at ``server_lr`` 1.0 for 1 step (FedAvg within 1e-5),
   then buffer 4 of 8 in flight, alpha 0.5, 6 steps (mean staleness
   5/6, steps/s); FedPer with the pooler and the head personal, 3 rounds
   (round 0's shared leaves equal FedAvg's and each personal row that
   client's trained head, 1e-6; the rows differ after round 3;
   ``evaluate``); clustered FL with K=2, 3 rounds (each assignment the
   argmin of the losses taken one pair at a time, or within 2e-2 of it;
   each chosen cluster the sample-weighted mean of its clients' trained
   params, 1e-5), then two equal clusters (every client to the first,
   the empty one bit-equal). Every training step launches each flash
   kernel once per layer, on mma, and the clustered loss grid (a vmap
   over clients of a vmap over clusters) one forward per layer for the
   whole grid. Seconds per round or step (the median after a warm-up),
   peak memory beside its estimate and the device time by kind of one
   profiled stateful round, 2 FedBuff steps and one clustered round are
   printed. The kernels line's ``launches_variants`` counts the launches
   of the variants' own rounds and steps above, not of the checks beside
   them. Then each variant on a 2-layer fp32 BERT card against the CPU,
   same weights and shuffles (1e-4).
16. the model zoo: (a) BASELINE config 4 at Llama-3-8B's width and depth
   (``examples/04_llama_lora.py --scale full``'s shape, LoRA rank 16 on
   wq/wk/wv/wo, batch 8, lr 1e-2, the example's half-masked synthetic
   tokens) in bf16 with remat, cut to 4 clients x 16 samples in waves of
   what fits: a warm-up, a timed round and a profiled one; the host copy
   of the frozen base taken for phase 23a (which continues from these
   params and checks the base bit-equal after both), the
   adapters moved, each flash kernel on mma once per layer per step (the
   forward twice: remat runs it again in the backward); s/round,
   tokens/s, the 4·P·tokens MFU, peak memory against its estimate, device
   time by kind and the busy share. (b) Remat at Llama width, 2 layers:
   fp32 loss and adapter gradients with and without remat within 1e-6,
   and one bf16 gradient's peak lower with remat. (c) ViT-B/16, bf16, 4
   clients x 16 images of 224 px: a warm-up and 3 timed rounds, flash
   once per layer per step at L = 197. (d) Example 07's full preset for
   one round: 64 clients x 256 sequences of 80 chars. (e) The tiny Llama
   + LoRA, Llama-MoE dropping tokens, ViT and LSTM, one fp32 round each,
   card against CPU (1e-4). (f) Dense attention against flash at Llama's
   head shape for L 128-4096, written as a ``"gpu"`` sweep artifact that
   ``configure_attention_dispatch`` must read the printed crossover from
   (the dispatch itself is left at ``_FLASH_MIN_LEN = 0``). The kernels
   line's ``launches_config4`` counts 16a's rounds.
17. BASELINE config 5 (``examples/05_vit_dp_secure.py --scale full``'s
   shape: ViT-B/16, 1,000 classes, DP-SGD clip 1.0 sigma 0.5, batch 64,
   delta 1e-5, Poisson cohorts at 0.75) in bf16 with remat, as
   ``benchmarks/tpu_suite.py``'s ``vit_dp`` stage runs it, cut to 4
   clients x 128 images (2 steps a client): a warm-up, 2 timed rounds and
   a profiled one, each wave sized by ``wave_size="auto"`` (the sizing
   timed apart); s/round, images/s, peak memory, device time by kind,
   busy share; each flash kernel on mma once per layer per wave-step (the
   forward twice: remat), the accountant's epsilon, the example's secure
   aggregation of every client's delta (``err < 1e-3``), the noise
   replayed from its generator (noised minus sigma-0 gradients equal
   sigma·clip·N/64 within 1e-5 relative) and a 2-layer fp32 DP round
   card against the CPU (1e-4). Then the kernels' times at config 5's
   attention shape (B = wave x 64, 12 heads, L 197, D 64). The kernels
   line's ``launches_config5`` counts the rounds.
18. ``auto_wave_size`` against the allocator on phase 17's cohort and
   phase 6's ResNet-18 cohort: the wave and the line fitted from the
   trial waves; a round at that wave peaks at or under the budget, the
   line at twice the wave is over it; then a tighter budget that must
   halve the wave, under which the round's peak must stay too.
19. ``run_rounds_fused`` as a CUDA graph against ``run_rounds`` on phase
   3's BERT-base and phase 6's ResNet-18 cohorts, 4 rounds each from the
   same params and generator: params and losses within 1e-5 (bit-equality
   printed), s/round of both and of the replays, busy shares, capture
   time, and the flash launches of the fused run counted as the eager
   round plus the captured launches times the replays
   (``launches_fused_bert``); then a DP run with noise (a 2-layer ViT in
   waves of 2, the noise from generators registered with the graph)
   within 1e-5.
20. examples 02 and 09 at their tiny presets on the card, under their
   own assertions.
21. sequence parallelism (example 06, ``examples/06_long_context_ring.py``,
   ported as ``baton_tpu_torch/examples/long_context_ring.py``) on a mesh
   of 8 shards of the one card: (a) the ``--scale full`` preset as written
   (vocab 32,000, L 32,768, d 512, 8/4 heads, 8 layers, d_ff 1,536, batch
   1, remat, fp32, 5 steps through ring × flash): s/step, tokens/s, peak
   memory, a profiled step's busy share; each kernel's launches a step
   against what the ring implies (N + N(N-1)/2 block calls a pass and
   layer, the forward twice under remat); step 0's loss and gradients
   against one flash call over the whole 32,768 (1e-4 of each tensor's
   largest value); (b) the ``--striped`` preset (L 8,192, the dense ring,
   2 steps): step 0's loss against the flash model, no flash launch; (c)
   ring × flash alone at (a)'s shape, causal, with and without a ragged
   padding bias (half the shards all padding), bf16 and fp32, forward and
   the q, k, v and bias gradients against one ``flash_attention`` call
   shard by shard (fp32 1e-4, bf16 2e-2), every launch's design checked;
   times of both and of SDPA on the whole sequence; each kernel's time at
   the ring block's shape (B 1, 8/4 heads, L 4,096, D 64) in fp32 and
   bf16 beside its bound (fp32: the CUDA cores' and the 3xTF32 tensor
   cores' bound), and the fp32 backward pair's against SDPA's fp32
   backward; (d) the dense ring, Ulysses (N = 4) and the striped fn
   against the flash call at L 8,192 in fp32.
22. the clients mesh on the one card (a mesh may repeat ``cuda:0``):
   (a) phase 3's BERT-base round on 4 shards against the same round
   meshless (same weights and shuffles): each flash kernel 4 x 12 launches
   a round, each forward over a quarter of the meshless batch, all mma;
   params and loss in the reference's band (rtol = atol = 5e-2); the psum
   of the trained client contributions against float64 within the
   worst-case fp32 error of the sum; s/round, peak memory, one psum's
   time and the wave sizer's per-shard line against the meshless one;
   (b) BASELINE config 2 at full width (example 02's ``--scale full``:
   ResNet-18, 128 Dirichlet(0.5) clients of 50,000 CIFAR-shaped images
   from the loader's synthetic fallback, batch 32, waves of 32, bf16) on
   4 shards, 2 of its 100 rounds (s, images/s, MFU, peak memory; the loss
   falls), and round 0 meshless in waves of 8 in the band; (c) stateful
   clients, FedBuff (buffer 8 of 12), FedPer and clustered FL on 2 shards
   of the card against 8 of the CPU at phase 15's small fp32 size (1e-4,
   assignments, versions and staleness equal); (d) two processes on the
   card over gloo, 2 shards each, the FedAvg psum of 4 clients'
   ResNet-18-sized params across them against float64, each child under
   a hard timeout.

23. the mesh's ``model`` axis: hybrid ``("clients", "model")`` meshes of
   shards of the one card, the frozen base tensor-parallel over
   ``model``. (a) Right after phase 16a and from its params: BASELINE
   config 4 at Llama-3-8B width and depth on 2 x 2 shards (each model
   shard 16/4 heads), one meshless round and two hybrid rounds (the
   second profiled) on the same shuffles: the base comes back placed (wq
   column-, wo row-parallel) and, gathered, bit-equal to 16a's host copy;
   each kernel's launches a round what the shapes give (1024 / 512 / 512:
   4x the meshless, all mma); the hybrid peak at or under the meshless
   one; the adapters' gap from the meshless round in the reference's band
   and at most ``HYBRID_GAP_SHARE`` of the round's change; s/round,
   tokens/s, the 4·P·tokens MFU, peak memory, busy share. (b) BERT-base
   (vocab 30,522, bf16) with config 3's trainable head, the encoder frozen
   and placed (``b1`` split, ``b2`` once, the vocab split on 2 shards and
   replicated on 4), on 2 x 2 shards against meshless at phase 8's
   cohort: launches (forward only), peak, the gap rule. (c) fp32, card
   against CPU: a tiny LoRA Llama round on 4 x 2 shards (1e-4), the MoE
   layer with its experts over 4 shards against replicated (JAX's rtol
   1e-5 / atol 1e-6), and a tiny Llama's loss and gradients with its
   base on a ``model``-4 axis, the kv heads' shard edges inside a head,
   against replicated (JAX's rtol 2e-4 / atol 1e-5).

``python3 chip_smoke.py --kernels-only`` runs phases 1, 2 and 5 alone, and
21's fp32 times at the ring block (the forward and the backward pair): the
short first call after a kernel changes (build, ptxas report, comparison at
real widths, times). It prints no result line.

Before the last line comes the ``kernels`` line: one row a hand-written
kernel, by its launch key (``fwd_mma``, ``bwd_dkv_mma``, ``bwd_dq_mma`` on
the main path, phase 3's BERT-base round; ``fwd_tf32x3``, ``bwd_dkv_tf32x3``,
``bwd_dq_tf32x3`` on example 06's ring x flash, phase 21a), each with its
launches on its path, its error in phase 2, and its times and bounds at
that path's shape. The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the package beside this script, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# the TPU kernel each pass replaces, and each hand-written kernel's source by
# its launch key ("<pass>_<design>", as counted in fa.launches_by_design);
# the kernels line has one row a key, named after its C entry point
# ("flash_" + key): bf16 (mma) on the main path, phase 3's BERT-base round,
# fp32 (tf32x3) on example 06's ring x flash, phase 21a
CSRC = "baton_tpu_torch/ops/csrc/"
TPU_KERNELS = {"fwd": "baton_tpu/ops/flash_attention.py:65",
               "bwd_dkv": "baton_tpu/ops/flash_attention.py:203",
               "bwd_dq": "baton_tpu/ops/flash_attention.py:253"}
KERNELS = {
    "fwd_mma": CSRC + "flash_attention_mma.cu",
    "bwd_dkv_mma": CSRC + "flash_attention_mma.cu",
    "bwd_dq_mma": CSRC + "flash_attention_mma.cu",
    "fwd_tf32x3": CSRC + "flash_attention_tf32.cu",
    "bwd_dkv_tf32x3": CSRC + "flash_attention_tf32.cu",
    "bwd_dq_tf32x3": CSRC + "flash_attention_tf32.cu",
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


def timed(fn):
    """``fn()`` to its end on the card: (result, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


PASSES = ("fwd", "bwd_dkv", "bwd_dq")


def design_keys(fa, dtype, d=64) -> dict:
    """{pass: its launch key "<pass>_<design>"} for one dtype: what each
    pass's kernel counts under in ``fa.launches_by_design``."""
    return {p: f"{p}_{fa._design(dtype, d, p)}" for p in PASSES}


def design_names(fa, dtype) -> str:
    """The designs of the three passes, as printed: "mma" or "tf32x3" (or
    "a/b/c" were they to differ)."""
    designs = [key[len(p) + 1:] for p, key in design_keys(fa, dtype).items()]
    return designs[0] if len(set(designs)) == 1 else "/".join(designs)


def launch_counts(fa):
    """The launch counts now, by pass and by design, for ``launches_since``."""
    return fa.launches(), dict(fa.launches_by_design)


def launches_since(fa, before):
    """(launches by pass, launches by design) since ``before`` = the
    ``launch_counts`` then; designs that did not launch are left out."""
    by_pass = {k: n - before[0][k] for k, n in fa.launches().items()}
    by_design = {k: n - before[1][k] for k, n in fa.launches_by_design.items()
                 if n != before[1][k]}
    return by_pass, by_design


# no bare "conv": it would match elementwise "convert" kernels
CONV_TOKENS = ("convolution", "conv2d", "fprop", "dgrad", "wgrad", "cudnn", "winograd",
               "implicit_gemm", "nchwtonhwc", "nhwctonchw")
NORM_TOKENS = ("groupnorm", "group_norm", "rowwisemoments", "fusedparams",
               "internalgradients", "gammabeta")


def kernel_kind(name: str) -> str:
    n = name.lower()
    if re.search(r"(^|[^a-z_])(fwd|dkv|dq)(_mma|_tf32x3)?_kernel", n):
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
    kinds, kind_counts = {}, {}
    for e in kernels:
        kind = kernel_kind(e.key)
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
        kind_counts[kind] = kind_counts.get(kind, 0) + e.count
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    busy = total_ms / (wall_s * 1e3)
    print(f"  profiled round: wall {wall_s * 1e3:.1f} ms, device busy {total_ms:.1f} ms "
          f"({100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%)")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"    {kind:28s} {ms:9.2f} ms  {100 * ms / total_ms:5.1f}% of device time")
    for e in top:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms x{e.count:<5d} {e.key[:110]}")
    return {"wall_ms": wall_s * 1e3, "device_ms": total_ms, "busy_share": busy,
            "by_kind_ms": kinds, "by_kind_count": kind_counts,
            "top": [[e.key[:110], e.count, e.self_device_time_total / 1e3] for e in top]}


def attention_inputs(seed, b, hq, hkv, l, d, dtype, bias_kind, device="cuda"):
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
    return [t.to(device, dtype) for t in (q, k, v, dout)] + [bias.to(device)]


def launched_since(fa, before):
    """The launches by design since the snapshot ``before``, nonzero ones only."""
    return {key: n - before[key] for key, n in fa.launches_by_design.items() if n != before[key]}


def compare_case(fa, seed, name, b, hq, hkv, l, d, dtype, causal, bias_kind):
    """Each kernel against its plain version on the same inputs; returns
    {kernel: max abs error}. The backward kernels get the plain forward's
    out and lse, so each comparison holds one kernel alone."""
    q, k, v, dout, bias = attention_inputs(seed, b, hq, hkv, l, d, dtype, bias_kind)
    scale = d ** -0.5
    tol = TOL[dtype]
    out_p, lse_p = fa._fwd_plain(q, k, v, bias, causal, scale)
    delta = (dout.float() * out_p.float()).sum(-1)
    design = design_names(fa, dtype)
    before = dict(fa.launches_by_design)
    pairs = {
        "flash_fwd": (fa._fwd(q, k, v, bias, causal, scale), (out_p, lse_p)),
        "flash_bwd_dkv": (fa._bwd_dkv(q, k, v, bias, dout, lse_p, delta, causal, scale),
                          fa._bwd_dkv_plain(q, k, v, bias, dout, lse_p, delta, causal, scale)),
        "flash_bwd_dq": ((fa._bwd_dq(q, k, v, bias, dout, lse_p, delta, causal, scale),),
                         (fa._bwd_dq_plain(q, k, v, bias, dout, lse_p, delta, causal, scale),)),
    }
    torch.cuda.synchronize()
    ran = launched_since(fa, before)
    check(ran == dict.fromkeys(design_keys(fa, dtype).values(), 1),
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


U32 = 2.0 ** -24  # fp32's unit roundoff


def gamma(n: int) -> float:
    """The worst-case relative error of an fp32 sum or dot product of ``n``
    terms in any order, ``n·u / (1 - n·u)`` (Higham, Accuracy and Stability
    of Numerical Algorithms, 3.1), of the sum of the terms' magnitudes."""
    return n * U32 / (1 - n * U32)


def hold_against_float64(name, label, shape, whats, kernel, plain, oracle, bounds):
    """Each output of a kernel and of its plain version against its float64
    oracle, element by element, within ``bounds``: prints each gap and its
    share of the bound, fails past it, and returns them by output."""
    out = {}
    for what, got_k, got_p, want, bound in zip(whats, kernel, plain, oracle, bounds):
        gap_k, gap_p = ((g.double() - want).abs() for g in (got_k, got_p))
        share_k, share_p = ((g / bound.clamp_min(1e-300)).max().item() for g in (gap_k, gap_p))
        out[what] = {"kernel_gap": gap_k.max().item(), "plain_gap": gap_p.max().item(),
                     "kernel_share_of_bound": share_k, "plain_share_of_bound": share_p,
                     "kernel_plain_gap": (got_k - got_p).abs().max().item(),
                     "max_abs": want.abs().max().item()}
        check(share_k <= 1.0 and share_p <= 1.0,
              f"{name} {label}{what}: kernel {share_k:.3g}, plain {share_p:.3g} of the fp32 "
              "summation bound from float64")
    print(f"  {name:24s} {shape} float32 every key masked, {label}tf32x3, against float64: "
          + "; ".join(
              f"{w} kernel {o['kernel_gap']:.2e} ({o['kernel_share_of_bound']:.2e} of bound), "
              f"plain {o['plain_gap']:.2e} ({o['plain_share_of_bound']:.2e}), kernel-plain "
              f"{o['kernel_plain_gap']:.2e}, |max| {o['max_abs']:.2e}" for w, o in out.items()))
    return out


def masked_row_oracle_case(fa, seed, name, b, hq, hkv, l, d, dtype, causal, bias_kind):
    """The fp32 dkv kernel on a sample whose every key is masked, held
    against float64. There lse = -1e30 swallows the scores, so p = 1 at
    every key in both fp32 and float64, and dk, dv and dbias each sum ``l``
    terms of order 1: the kernel's sequential fmaf sums and the plain
    version's blocked einsum round them in different orders. Both are held
    against the float64 results on the same inputs (lse and delta
    included), element by element, at the worst-case fp32 error of those
    sums: ``gamma(l)`` of each sum of magnitudes, plus ``gamma(d + 1)`` of
    the dp dot product and the subtraction of delta carried through every
    ds. Returns the gaps of both from float64 and their share of the bound."""
    check(dtype == torch.float32 and not causal and bias_kind == "masked_rows" and b == 1,
          f"{name}: the oracle case is one fp32 sample with every key masked")
    q, k, v, dout, bias = attention_inputs(seed, b, hq, hkv, l, d, dtype, bias_kind)
    scale = d ** -0.5
    out_p, lse = fa._fwd_plain(q, k, v, bias, causal, scale)
    delta = (dout.float() * out_p.float()).sum(-1)
    args = (q, k, v, bias, dout, lse, delta, causal, scale)
    before = dict(fa.launches_by_design)
    kernel = fa._bwd_dkv(*args)
    torch.cuda.synchronize()
    ran = launched_since(fa, before)
    check(ran == {"bwd_dkv_tf32x3": 1}, f"{name}: launches by design {ran}")
    plain = fa._bwd_dkv_plain(*args)
    q64, k64, v64, do64 = (t.double() for t in (q, fa._expand_kv(k, hq), fa._expand_kv(v, hq),
                                                 dout))
    s = torch.einsum("bhqd,bhkd->bhqk", q64, k64) * scale + bias.double()[:, None, None, :]
    p = torch.exp(s - lse.double()[..., None])
    check(bool((p == 1).all()), f"{name}: p is not 1 at every masked key")
    del s
    delta64 = delta.double()[..., None]
    dp = torch.einsum("bhqd,bhkd->bhqk", do64, v64)
    ds = p * (dp - delta64)
    # dp's D-term dot product and the subtraction of delta, in every ds
    err_ds = gamma(d + 1) * (torch.einsum("bhqd,bhkd->bhqk", do64.abs(), v64.abs())
                             + delta64.abs())
    del dp
    oracle = (scale * torch.einsum("bhqk,bhqd->bhkd", ds, q64),
              torch.einsum("bhqk,bhqd->bhkd", p, do64), ds.sum(2))
    bounds = (scale * (gamma(l) * torch.einsum("bhqk,bhqd->bhkd", ds.abs(), q64.abs())
                       + torch.einsum("bhqk,bhqd->bhkd", err_ds, q64.abs())) * (1 + U32),
              gamma(l) * torch.einsum("bhqk,bhqd->bhkd", p, do64.abs()),
              gamma(l) * ds.abs().sum(2) + err_ds.sum(2))
    del p, ds, err_ds
    return hold_against_float64(name, "", f"B={b} Hq={hq} Hkv={hkv} L={l} D={d}",
                                ("dk", "dv", "db"), kernel, plain, oracle, bounds)


def masked_row_forward_oracle_case(fa, seed, name, b, hq, hkv, l, d, dtype, causal,
                                   bias_kind):
    """The fp32 forward kernel on a sample whose every key is masked, held
    against float64: the forward's long sums. Every score is the bias's
    -1e30 (q.k^T * scale is swallowed), so the row max is -1e30 and p = 1 at
    every key in both fp32 and float64: out is the mean of ``l`` rows of v
    and l the sum of ``l`` ones, each a sum of ``l`` terms that the kernel
    takes a kv tile at a time in fresh fragments and adds in fp32, and the
    plain version in one einsum. The bound is the worst case of any order of
    fp32 sums, so it does not tell a truncating tensor-core chain over the
    keys from a rounding one; the check that caught such a chain in the
    backward is phase 21a's step-0 check, one flash call over 32,768 tokens
    against the ring within 1e-4. Both are held against float64 on the same
    inputs, element by element: out within ``gamma(l)`` of the sum of
    magnitudes of p.v and of its p.v (the error of the sums and, through l,
    of the division) plus the division's rounding; lse = m + log l within
    the score's error (``gamma(d)`` of its dot product, the rounding of the
    score), the log's change under l's ``gamma(l)`` and the roundings of
    the log and the add. Returns the gaps of both from float64 and their
    share of the bound."""
    check(dtype == torch.float32 and not causal and bias_kind == "masked_rows" and b == 1,
          f"{name}: the oracle case is one fp32 sample with every key masked")
    q, k, v, _, bias = attention_inputs(seed, b, hq, hkv, l, d, dtype, bias_kind)
    scale = d ** -0.5
    before = dict(fa.launches_by_design)
    kernel = fa._fwd(q, k, v, bias, causal, scale)
    torch.cuda.synchronize()
    ran = launched_since(fa, before)
    check(ran == {"fwd_tf32x3": 1}, f"{name}: launches by design {ran}")
    plain = fa._fwd_plain(q, k, v, bias, causal, scale)
    q64, k64, v64 = (t.double() for t in (q, fa._expand_kv(k, hq), fa._expand_kv(v, hq)))
    x = torch.einsum("bhqd,bhkd->bhqk", q64, k64) * scale + bias.double()[:, None, None, :]
    # the score's error: its D-term dot product, then the rounding of fmaf
    err_x = (gamma(d) * scale * torch.einsum("bhqd,bhkd->bhqk", q64.abs(), k64.abs())
             + U32 * x.abs()).amax(-1)
    m = x.amax(-1, keepdim=True)
    p = torch.exp(x - m)
    check(bool((p == 1).all()), f"{name}: p is not 1 at every masked key")
    del x
    total = p.sum(-1)
    pv = torch.einsum("bhqk,bhkd->bhqd", p, v64)
    out64 = pv / total[..., None]
    lse64 = m.squeeze(-1) + torch.log(total)
    g = gamma(l)
    # first order in g, with 2g of room for the second-order terms
    bounds = ((g * (torch.einsum("bhqk,bhkd->bhqd", p, v64.abs()) + pv.abs())
               / total[..., None] + U32 * out64.abs()) * (1 + 2 * g),
              err_x + g * (1 + g) + 2 * U32 * torch.log(total).abs() + U32 * lse64.abs())
    del p
    return hold_against_float64(name, "forward ", f"B={b} Hq={hq} Hkv={hkv} L={l} D={d}",
                                ("out", "lse"), kernel, plain, (out64, lse64), bounds)


# phase 2's long masked-row case (ROADMAP Queue 3): one fp32 sample with
# every key masked at the ring block's shape, held against float64
MASKED_ROW_CASE = ("fp32_masked_rows_long", 1, 8, 4, 4096, 64, torch.float32, False,
                   "masked_rows")


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
        # phase 16's shapes: Llama-3-8B's attention and ViT-B/16's ragged L = 197
        ("llama3_8b", 8, 32, 8, 1024, 128, bf16, True, None),
        ("vit_b16", 16, 12, 12, 197, 64, bf16, False, None),
        # phase 21's ring block (B 1, 8/4 heads, L/N = 4,096, D 64): the fp32
        # kernels of example 06's full preset and the bf16 mma kernels of
        # 21c, past blocks and the causal diagonal, with and without padding
        *((f"ring_block_{str(dtype)[6:]}{tag}", *RING_BLOCK, dtype, causal, bias_kind)
          for dtype in (f32, bf16)
          for tag, causal, bias_kind in (("", False, None), ("_causal", True, "lengths"),
                                         ("_padded", False, "lengths"))),
    ]
    print("phase 2: kernels against their plain versions")
    results = {c[0]: compare_case(fa, seed, *c) for seed, c in enumerate(cases)}
    masked_row_oracle_case(fa, len(cases), *MASKED_ROW_CASE)
    masked_row_forward_oracle_case(fa, len(cases), *MASKED_ROW_CASE)
    # phase 23's per-model-shard shapes: 23a's Llama-3-8B (16/4 heads a
    # shard of 2), 23b's BERT-base (6/6 heads, a clients shard's 4 clients
    # x 32), 23c's tiny Llama round (2/1 heads a shard) and its model-4
    # gradients (projections gathered: the shard edges fall inside kv heads)
    model_shard_cases = [
        ("llama3_8b_model_shard", 8, 16, 4, 1024, 128, bf16, True, None),
        ("bert_base_model_shard", 128, 6, 6, 128, 64, bf16, False, "lengths"),
        ("fp32_tiny_llama_model_shard", 8, 2, 1, 32, 64, f32, True, None),
        ("fp32_tiny_llama_model4_gathered", 4, 4, 2, 64, 64, f32, True, None),
    ]
    for seed, c in enumerate(model_shard_cases, start=len(cases) + 1):
        compare_case(fa, seed, *c)
    wrapper_cases = [(dtype, causal, False) for dtype in (f32, bf16) for causal in (False, True)]
    wrapper_cases += [(f32, False, True), (bf16, False, True)]
    for seed, case in enumerate(wrapper_cases):
        block_wrapper_case(fa, 100 + seed, *case)
    return results


def block_wrapper_case(fa, seed, dtype, causal, all_padding=False):
    """``flash_block_fwd`` and ``flash_block_bwd`` on card tensors at the
    ring block's shape with a ragged padding bias: one launch of each
    kernel, the reference's dtypes (out in q's, lse and dbias fp32, dq, dk,
    dv in their inputs'), and each output against the plain versions on the
    same inputs. The backward takes the wrapper's own out and lse, except
    for a block whose keys are ``all_padding``: as in the ring, it takes
    the out and lse of the row's valid keys, and the block's own lse must
    give it no weight in the ring's combine."""
    b, hq, hkv, l, d = RING_BLOCK
    q, k, v, dout, bias = attention_inputs(seed, b, hq, hkv, l, d, dtype, "lengths")
    scale = d ** -0.5
    row = fa._fwd_plain(q, k, v, bias, causal, scale) if all_padding else None
    if all_padding:
        bias = torch.full_like(bias, -1e30)
    before = launch_counts(fa)
    out, lse = fa.flash_block_fwd(q, k, v, bias, causal)
    g_out, g_lse = row or (out, lse)
    grads = fa.flash_block_bwd(q, k, v, bias, g_out, dout, g_lse, causal)
    torch.cuda.synchronize()
    _, by_design = launches_since(fa, before)
    design = design_names(fa, dtype)
    name = (f"block wrappers {str(dtype)[6:]} causal={int(causal)}"
            + (" all padding" if all_padding else ""))
    check(by_design == dict.fromkeys(design_keys(fa, dtype).values(), 1),
          f"{name}: launches by design {by_design}")
    check((out.dtype, lse.dtype) == (dtype, torch.float32)
          and [g.dtype for g in grads] == [dtype] * 3 + [torch.float32]
          and grads[3].shape == (b, l), f"{name}: dtypes or dbias shape")
    check(not all_padding or lse.max().item() < -1e29, f"{name}: lse {lse.max().item()}")
    delta = (dout.float() * g_out.float()).sum(-1)
    args = (q, k, v, bias, dout, g_lse, delta, causal, scale)
    dk_h, dv_h, db_h = fa._bwd_dkv_plain(*args)
    fold = lambda t: t.reshape(b, hkv, hq // hkv, l, d).sum(2)  # noqa: E731  GQA
    want = (*fa._fwd_plain(q, k, v, bias, causal, scale), fa._bwd_dq_plain(*args).to(dtype),
            fold(dk_h).to(dtype), fold(dv_h).to(dtype), db_h.sum(1))
    tol, errs = TOL[dtype], []
    for what, g, w in zip(("out", "lse", "dq", "dk", "dv", "dbias"), (out, lse, *grads), want):
        g, w = g.float(), w.float()
        errs.append(f"{what}={(g - w).abs().max().item():.2e}")
        check(bool(torch.isfinite(g).all()) and torch.allclose(g, w, rtol=tol, atol=tol),
              f"{name} {what}: max abs err {(g - w).abs().max().item():.3e} beyond "
              f"rtol=atol={tol}")
    print(f"  {name:44s} B={b} Hq={hq} Hkv={hkv} L={l} D={d} {design}: "
          + " ".join(errs) + f" (tol {tol})")


# flip_check's fp32 summation allowance, 2^-20 of a sum's magnitude, holds
# for sums of up to this many terms (phase 2's cases before Llama's: L <= 200)
SUM_TERMS = 256


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
    summation order; every element of each output must lie within it.
    The summation allowance covers sums of up to ``SUM_TERMS`` terms and
    grows in proportion beyond (the worst-case fp32 summation error grows
    with the number of terms): at Llama's L = 1024 a causal dv column of
    key 0 sums 1,024 queries and needed 2.33 times 2^-20 (PERF.md)."""
    q, k, v, bias, dout, lse, delta, causal, scale = args
    k, v = fa._expand_kv(k, q.shape[1]), fa._expand_kv(v, q.shape[1])
    p, ds = fa._p_ds(q, k, v, bias, dout, lse, delta, causal, scale)
    qa, ka, va, oa = (t.float().abs() for t in (q, k, v, dout))
    eps = 2.0 ** -20
    lq, lk = p.shape[-2:]
    eps_q, eps_k = (eps * max(1.0, n / SUM_TERMS) for n in (lq, lk))  # sums over q, over k

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
    # each output's bound: (the rounding flips' part, the summation order's part)
    bounds = {
        "dk": lambda: (scale * ein(fds, qa), scale * eps_q * ein(dsr, qa)),
        "dv": lambda: (ein(fp, oa), eps_q * ein(p.bfloat16().float().abs(), oa)),
        "db": lambda: (err_ds.sum(2), eps_q * ds.abs().sum(2)),
        "dq": lambda: (scale * ein_q(fds, ka), scale * eps_k * ein_q(dsr, ka)),
    }
    over, parts, excess = 0, [], []
    for out in got:
        g, w = got[out], want[out]
        flips, summation = bounds[out]()
        gap, bound = (g - w).abs(), flips + summation
        at = int(gap.argmax())
        is_over = gap > bound
        n_over = int(is_over.sum())
        over += n_over
        parts.append(f"{out} {gap.flatten()[at].item():.2e} (bound "
                     f"{bound.flatten()[at].item():.2e}, |plain| {w.flatten()[at].abs().item():.2e}"
                     f", {n_over} over)")
        if n_over:
            # how many summation allowances the worst element beyond its bound needs
            need = torch.where(is_over, (gap - flips) / summation.clamp_min(1e-30), 0.0)
            worst = int(need.argmax())
            index = np.unravel_index(worst, tuple(need.shape))
            excess.append(f"{out}: {n_over} over, the worst needs {need.flatten()[worst].item():.2f}"
                          f" x its summation allowance at {tuple(int(i) for i in index)}")
    print(f"    gap vs bf16 rounding flips: p near a boundary at {int((fp > 0).sum())} "
          f"of {p.numel()}, ds at {int((fds > 0).sum())}; max gap " + ", ".join(parts))
    if excess:
        print("    beyond the bound: " + "; ".join(excess))
    check(over == 0, f"{name}: {'/'.join(got)} gap beyond what bf16 rounding flips explain "
          f"at {over} elements")


def bert_base_cohort(n_clients=8, batch=32):
    """Phase 3's BERT-base (bf16 compute) and its clients: ``n_clients`` x
    ``batch`` samples of random tokens, lengths 16-128, numpy seed 0.
    Returns ``(cfg, model, data, n_samples)``."""
    from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    cfg = BertConfig(vocab_size=30522, max_len=128, d_model=768, n_layers=12,
                     n_heads=12, d_ff=3072, n_classes=4)
    seq = cfg.max_len
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
    return cfg, model, data, n_samples


def bert_round_phase(fa):
    from baton_tpu_torch import FedSim

    n_clients, batch, seq = 8, 32, 128
    cfg, model, data, n_samples = bert_base_cohort(n_clients, batch)
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
        before = launch_counts(fa)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with (torch.profiler.profile(activities=activities) if r == profiled
              else contextlib.nullcontext()) as prof:
            res, dt = timed(lambda: sim.run_round(params, data, n_samples, gen))
        params = res.params
        loss = res.loss_history.tolist()
        losses.extend(loss)
        delta, by_design = launches_since(fa, before)
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
    before = launch_counts(fa)
    t0 = time.perf_counter()
    gpu = FedSim(model, batch_size=batch, learning_rate=0.01).run_round(
        {k: v.cuda() for k, v in params.items()}, data, n_samples, perms=perms)
    gpu_params = {k: v.cpu() for k, v in gpu.params.items()}
    t_gpu = time.perf_counter() - t0
    delta, by_design = launches_since(fa, before)
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
    check(by_design == dict.fromkeys(design_keys(fa, torch.float32).values(), cfg.n_layers),
          f"fp32 round launches by design {by_design}")
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
        counter = kname[len("flash_"):]
        key = design_keys(fa, dtype)[counter]
        design = key[len(counter) + 1:]
        rows.append({
            "name": f"flash_{key}", "pass": counter, "route": "cuda", "design": design,
            "source": KERNELS[key], "replaces": TPU_KERNELS[counter],
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

    # the fp32 kernels (phase 4's path, not the main one)
    q32, k32, v32, dout32 = (t.float() for t in (q, k, v, dout))
    args32 = (q32, k32, v32, bias, dout32, lse, delta, False, scale)
    keys32 = design_keys(fa, torch.float32)
    fp32 = {f"flash_{keys32['fwd']}_fp32":
            time_ms(lambda: fa._fwd(q32, k32, v32, bias, False, scale)),
            f"flash_{keys32['bwd_dkv']}_fp32": time_ms(lambda: fa._bwd_dkv(*args32)),
            f"flash_{keys32['bwd_dq']}_fp32": time_ms(lambda: fa._bwd_dq(*args32))}
    print("  fp32 kernels at the same shape: "
          + ", ".join(f"{k} {ms:.4f} ms" for k, ms in fp32.items()))
    # a yardstick for the kernels' bytes/s: PyTorch's copy of q reads and writes it once
    clone_tb_s = 2 * q.numel() * el / time_ms(q.clone) / 1e9
    print(f"  q.clone() moves {clone_tb_s:.3f} TB/s on this card")
    return rows, dict(fp32, clone_tb_s=clone_tb_s)


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
    lr = trainer.optimizer.hyperparams["learning_rate"]  # plain SGD, as the clients alone
    alone, alone_losses = train_each_client_alone(sim.model, params, data, n, perms,
                                                  trainer.batch_size, lr)
    ref, _ = train_each_client_alone(reference_model, params, data, n, perms,
                                     trainer.batch_size, lr)
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


def resnet18_cohort(n_clients=32, per_client=48, batch=32):
    """``bench.py``'s clients (phase 6's): CIFAR-shaped random images and
    labels drawn from numpy seed 0, staged on the card as bench stages
    them. Returns ``(data, n_samples)``."""
    from baton_tpu_torch.ops.padding import stack_client_datasets

    rng = np.random.default_rng(0)
    datasets = [{"x": rng.normal(size=(per_client, 32, 32, 3)).astype(np.float32),
                 "y": rng.integers(0, 10, size=(per_client,)).astype(np.int32)}
                for _ in range(n_clients)]
    data, n_samples = stack_client_datasets(datasets, batch_size=batch)
    return {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}, n_samples


def resnet_round_phase(fa):
    """``bench.py``'s round (bench.py:32-41, 430-461) on the port."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.resnet import resnet18_cifar_model
    from baton_tpu_torch.obs.compute import validate_record

    n_clients, per_client, batch, lr = 32, 48, 32, 0.05
    data, n_samples = resnet18_cohort(n_clients, per_client, batch)
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
            res, dt = timed(lambda: sim.run_round(params, data, n_samples, gen))
        params = res.params
        loss = res.loss_history.tolist()
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
        res, warm = timed(lambda: sim.run_round(p, data, n_samples, g))
        loss = res.loss_history.tolist()
        check(all(math.isfinite(x) for x in loss), f"{impl}: non-finite loss")
        impl_times = []
        for _ in range(3):
            res, dt = timed(lambda: sim.run_round(p, data, n_samples, g))
            p, loss = res.params, res.loss_history.tolist()
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


# ---------------------------------------------------------------------
# phases 8-10: the trainer's options (local optimizers, FedProx, FedOpt
# server optimizers, trainable partitions)

CONFIG3_HEAD = ("pooler/", "head/")


def mean_client_drift(sim, params, data, n_samples, n_epochs, perms):
    """Mean over the clients with samples of ``||p_i - global||`` (all
    params), each client trained by ``sim``'s trainer (no partition) from
    ``params``."""
    anchor = params if sim.trainer.regularizer is not None else None
    n = torch.as_tensor(n_samples, device=sim.device)
    clients, _ = sim.trainer.train_clients(
        params, {k: torch.as_tensor(v, device=sim.device) for k, v in data.items()}, n,
        n_epochs, perms.to(sim.device), anchor=anchor)
    sq = sum((clients[k].float() - params[k].float()).reshape(n.shape[0], -1).square().sum(1)
             for k in clients)
    return sq.sqrt()[n > 0].mean().item()


def check_fedprox_drift(drift_free: float, drift_prox: float) -> None:
    """FedProx's proximal term must pull the clients toward the anchor:
    the mean drift without it is larger."""
    check(drift_free > drift_prox,
          f"FedProx did not reduce the client drift: {drift_free:.6e} without it, "
          f"{drift_prox:.6e} with it")


def check_partition_round(start, end, trainable_names) -> None:
    """Every frozen param bit-equal after the rounds, every trainable one
    moved."""
    frozen_changed = [k for k in start if k not in trainable_names
                      and not torch.equal(start[k].cpu(), end[k].cpu())]
    still = [k for k in trainable_names if torch.equal(start[k].cpu(), end[k].cpu())]
    check(not frozen_changed, f"frozen params changed: {frozen_changed[:5]}")
    check(not still, f"trainable params did not move: {still[:5]}")


def fedprox_bert_phase(fa):
    """BASELINE config 3 at BERT-base width (``examples/03_bert_fedprox.py``
    ``--scale full``), cut to 8 clients x 64 samples, one wave."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core.regularizers import fedprox
    from baton_tpu_torch.core.training import random_perms
    from baton_tpu_torch.examples.bert_fedprox import make_data
    from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    cfg = BertConfig(vocab_size=512, max_len=128, d_model=768, n_layers=12, n_heads=12,
                     d_ff=3072, n_classes=4)
    n_clients, per_client, batch, n_epochs, lr, mu = 8, 64, 32, 2, 5e-3, 0.1
    t0 = time.perf_counter()
    datasets = make_data(np.random.default_rng(0), cfg, n_clients, per_client)
    data, n_samples = stack_client_datasets(datasets, batch_size=batch)
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    t_data = time.perf_counter() - t0
    model = bert_classifier_model(cfg, compute_dtype=torch.bfloat16, name="bert_base_config3")

    def make_sim(**kw):
        return FedSim(model, batch_size=batch, learning_rate=lr, **kw)

    sim = make_sim(regularizer=fedprox(mu))
    params = sim.init(torch.Generator().manual_seed(0))
    first = {k: v.clone() for k, v in params.items()}
    n_params = sum(v.numel() for v in params.values())
    steps = sim.trainer.steps_per_round(data["x"].shape[1], n_epochs)
    n_total = int(n_samples.sum())
    print(f"phase 8: BASELINE config 3 (BERT-base, vocab {cfg.vocab_size}, {n_params / 1e6:.1f} M "
          f"params, bf16 compute), FedProx mu {mu}, local SGD lr {lr}, batch {batch}, "
          f"{n_epochs} epochs ({steps} steps), {n_clients} clients x {per_client} samples, "
          f"one wave; data drawn in {t_data:.1f} s")

    gen = torch.Generator().manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    times, losses, breakdown = [], [], None
    n_timed = 5
    profiled = n_timed + 1
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for r in range(profiled + 1):
        before = launch_counts(fa)
        with (torch.profiler.profile(activities=activities) if r == profiled
              else contextlib.nullcontext()) as prof:
            res, dt = timed(lambda: sim.run_round(params, data, n_samples, gen,
                                                  n_epochs=n_epochs))
        params = res.params
        loss = res.loss_history.tolist()
        losses.extend(loss)
        delta, _ = launches_since(fa, before)
        label = {0: " (warm-up)", profiled: " (profiled)"}.get(r, "")
        print(f"  round {r}{label}: loss {loss} {dt:.4f} s launches {delta}")
        if r == profiled:
            breakdown = device_breakdown(prof, dt)
        elif r > 0:
            times.append(dt)
        check(all(math.isfinite(x) for x in loss), f"round {r}: non-finite loss")
        check(all(n == cfg.n_layers * steps for n in delta.values()),
              f"round {r}: launches {delta}, want {cfg.n_layers * steps} of each kernel")
    launches = fa.launches()
    per_round = delta  # every round's count was checked equal
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ev = sim.evaluate_round(params, data, n_samples)
    check(math.isfinite(ev["loss"]), "evaluation loss is not finite")
    check(all(bool(torch.isfinite(v).all()) for v in params.values()), "non-finite params")
    s_mean, s_median = sum(times) / n_timed, float(np.median(times))
    print(f"  evaluate_round: {ev}")
    print(f"  s/round mean {s_mean:.4f}, median {s_median:.4f} (rounds 1-{n_timed}: "
          f"{', '.join(f'{t:.4f}' for t in times)}); samples/s {n_total / s_mean:.1f} (at the "
          f"median {n_total / s_median:.1f}); peak memory {peak_gb:.2f} GB; flash launches "
          f"over the rounds {launches}, per round {per_round}")
    if breakdown:
        print(f"  profiled device time over the unprofiled median wall: "
              f"{breakdown['device_ms'] / 1e3 / s_median:.3f}")

    # FedProx against no proximal term: the same clients, inputs and shuffles
    perms = random_perms(n_clients, n_epochs, data["x"].shape[1], torch.Generator().manual_seed(2))
    drift_prox = mean_client_drift(sim, first, data, n_samples, n_epochs, perms)
    drift_free = mean_client_drift(make_sim(), first, data, n_samples, n_epochs, perms)
    print(f"  mean client drift ||p_i - global||: mu=0 {drift_free:.6e}, mu={mu} {drift_prox:.6e} "
          f"({100 * (1 - drift_prox / drift_free):.4f}% less)")
    check_fedprox_drift(drift_free, drift_prox)

    # the trainable head: pooler and classifier only, the encoder frozen
    del sim, res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    head_sim = make_sim(regularizer=fedprox(mu),
                        trainable=lambda name, leaf: name.startswith(CONFIG3_HEAD))
    p = {k: v.clone() for k, v in first.items()}
    head_times = []
    fa.reset_launches()
    for r in range(4):
        res, dt = timed(lambda: head_sim.run_round(p, data, n_samples, gen, n_epochs=n_epochs))
        p, loss = res.params, res.loss_history.tolist()
        check(all(math.isfinite(x) for x in loss), f"head round {r}: non-finite loss")
        if r > 0:
            head_times.append(dt)
    head_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainable = head_sim.partition.trainable_paths
    check_partition_round(first, p, trainable)
    frozen_gb = sum(first[k].numel() * first[k].element_size()
                    for k in head_sim.partition.frozen_paths) / 1e9
    print(f"  trainable head ({len(trainable)} of {len(first)} tensors, "
          f"{sum(first[k].numel() for k in trainable) / 1e6:.3f} M params): s/round median "
          f"{float(np.median(head_times)):.4f} ({', '.join(f'{t:.4f}' for t in head_times)}); "
          f"peak {head_peak_gb:.2f} GB ({head_peak_gb - base_gb:.2f} GB over what was held "
          f"before) against the full round's {peak_gb:.2f} GB; the frozen params take "
          f"{frozen_gb:.3f} GB, {n_clients} copies of them {n_clients * frozen_gb:.2f} GB; flash "
          f"launches {fa.launches()}; every frozen tensor bit-equal after 4 rounds")
    check(head_peak_gb - base_gb < n_clients * frozen_gb,
          f"the head rounds took {head_peak_gb - base_gb:.2f} GB, as much as {n_clients} copies "
          f"of the frozen params ({n_clients * frozen_gb:.2f} GB)")
    del head_sim, res
    torch.cuda.empty_cache()
    update = update_step_costs("BERT-base config 3", first, n_clients)
    return launches, per_round, {
        "round_s": times, "s_per_round": s_mean, "s_per_round_median": s_median,
        "samples_per_s": n_total / s_mean, "peak_memory_gb": peak_gb, "breakdown": breakdown,
        "losses": losses, "eval": ev, "drift_mu0": drift_free, "drift_mu": drift_prox,
        "head_round_s": head_times, "head_peak_memory_gb": head_peak_gb,
        "head_base_gb": base_gb, "frozen_gb": frozen_gb, "update_step": update}


def update_step_costs(label, params, n_clients):
    """Device time (CUDA events) and kernel launches (profiler) of one
    optimizer step of ``LocalTrainer.update_step`` on ``n_clients``
    stacked copies of ``params``: plain SGD, momentum and Adam."""
    from baton_tpu_torch.core import optim
    from baton_tpu_torch.core.training import LocalTrainer

    gen = torch.Generator(device="cuda").manual_seed(3)
    stacked = {k: v.unsqueeze(0).repeat(n_clients, *([1] * v.dim())) for k, v in params.items()}
    grads = {k: torch.randn(v.shape, generator=gen, device="cuda") * 1e-3
             for k, v in stacked.items()}
    nonempty = torch.ones(n_clients, dtype=torch.bool, device="cuda")
    nbytes = sum(v.numel() * v.element_size() for v in stacked.values())
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name, opt in (("sgd", optim.sgd(0.05)), ("momentum", optim.sgd(0.05, momentum=0.9)),
                      ("adam", optim.adam(1e-3))):
        trainer = LocalTrainer(model=None, optimizer=opt, batch_size=1)
        state = optim.tree_map(lambda v: v.unsqueeze(0).repeat(n_clients, *([1] * v.dim())),
                               opt.init(params))

        def step():
            return trainer.update_step(stacked, state, grads, nonempty)

        ms = time_ms(step, iters=5, readings=3)
        with torch.profiler.profile(activities=activities) as prof:
            step()
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        out[name] = {"ms": ms, "launches": launches}
        del state
    print(f"  {label}: one optimizer step of {n_clients} clients x {len(params)} tensors "
          f"({nbytes / 1e9:.2f} GB of params): "
          + ", ".join(f"{k} {v['ms']:.3f} ms in {v['launches']} launches" for k, v in out.items()))
    return out


def resnet_optimizer_phase(phase6):
    """``bench.py``'s ResNet-18 round (phase 6's model, data, cohort and
    lr) with local momentum and a FedAdam server, then local Adam."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core import optim
    from baton_tpu_torch.models.resnet import resnet18_cifar_model

    n_clients, per_client, batch, lr = 32, 48, 32, 0.05
    data, n_samples = resnet18_cohort(n_clients, per_client, batch)
    n_total = int(n_samples.sum())
    model = resnet18_cifar_model(compute_dtype=torch.bfloat16)
    params = model.init(torch.Generator().manual_seed(0))
    params = {k: v.cuda() for k, v in params.items()}
    model_gb = sum(v.numel() * 4 for v in params.values()) / 1e9
    print(f"phase 9: ResNet-18 rounds as phase 6 with the optimizer layer ({n_clients} clients x "
          f"{per_client} samples, batch {batch}); phase 6 (plain SGD): s/round median "
          f"{phase6['s_per_round_median']:.4f}, MFU median {phase6['mfu_median']:.4f}, peak "
          f"{phase6['peak_memory_gb']:.2f} GB")
    variants = {
        "local momentum 0.9 + FedAdam server adam(1e-2)":
            (dict(optimizer=optim.sgd(lr, momentum=0.9), server_optimizer=optim.adam(1e-2)), 1),
        "local adam(1e-3)": (dict(optimizer=optim.adam(1e-3)), 2),
    }
    stats = {}
    for label, (kw, moments) in variants.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sim = FedSim(model, batch_size=batch, learning_rate=lr, **kw)
        gen = torch.Generator().manual_seed(1)
        timed(lambda: sim.run_round(params, data, n_samples, gen))  # warm-up, its state dropped
        p, state, times, mfus = params, None, [], []
        for r in range(3):
            res, dt = timed(lambda: sim.run_round(p, data, n_samples, gen,
                                                  server_opt_state=state))
            times.append(dt)
            p, state, loss = res.params, res.server_opt_state, res.loss_history.tolist()
            mfus.append(sim.last_compute["mfu"])
            check(all(math.isfinite(x) for x in loss), f"{label} round {r}: non-finite loss")
            check(mfus[-1] is not None, f"{label} round {r}: no MFU on this card")
        check(all(bool(torch.isfinite(v).all()) for v in p.values()), f"{label}: non-finite params")
        check(max((p[k] - params[k]).abs().max().item() for k in p) > 0,
              f"{label}: the rounds left the params unchanged")
        if sim.server_optimizer is not None:
            check(int(state["count"]) == 3, f"{label}: server count {int(state['count'])}, want 3")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        estimate = phase6["peak_memory_gb"] + moments * n_clients * model_gb
        med = float(np.median(times))
        print(f"  {label}: s/round median {med:.4f} ({', '.join(f'{t:.4f}' for t in times)}), "
              f"{n_total / med:.1f} samples/s; MFU median {float(np.median(mfus)):.4f}; peak "
              f"{peak_gb:.2f} GB (phase 6's plus {moments} x {n_clients} x {model_gb:.3f} GB of "
              f"moments: {estimate:.2f} GB)"
              + (f"; server count {int(state['count'])}" if state else ""))
        stats[label] = {"round_s": times, "s_per_round_median": med, "mfu": mfus,
                        "peak_memory_gb": peak_gb, "estimate_gb": estimate}
        del sim, res, p, state
    torch.cuda.empty_cache()
    stats["update_step"] = update_step_costs("ResNet-18", params, n_clients)
    return stats


def compare_rounds(name, card, cpu, start, tol=1e-4, hold=True):
    """A round on the card against the same round on the CPU: params and
    losses within ``tol`` (printed only, with ``hold`` false); the CPU
    round must have moved the params. Returns the largest param gap."""
    err = max((card.params[k].cpu().float() - cpu.params[k].float()).abs().max().item()
              for k in start)
    moved = max((cpu.params[k].float() - start[k].cpu().float()).abs().max().item()
                for k in start)
    loss_err = (card.loss_history.cpu() - cpu.loss_history).abs().max().item()
    print(f"  {name:44s} max |param diff| {err:.3e} (max |param change| {moved:.3e}), "
          f"max |loss diff| {loss_err:.3e}" + ("" if hold else " (measured, not held)"))
    check(moved > 0, f"{name}: the CPU round left the params unchanged")
    if hold:
        check(err <= tol, f"{name}: card and CPU params differ by {err:.3e} (tol {tol})")
        check(loss_err <= tol, f"{name}: card and CPU losses differ by {loss_err:.3e} (tol {tol})")
    return err


# Adam's step lr * g / (|g| + eps) moves by up to lr * dg / eps where |g|
# is near 0, so a gap dg between two correct fp32 gradients (another
# summation order) shows in the params amplified by lr / eps. With optax's
# eps = 1e-8 a one-ulp gap in an aggregate or a ~1e-9 gap in a gradient
# moves a step by up to ~1e-3, beyond the 1e-4 the card is held to. So
# the held comparisons use FedAdam's adaptivity tau = 1e-3 on the server
# (Reddi et al. 2021) and eps = 1e-5 for local Adam (lr / eps = 100; at
# 1e-6 the 2-layer BERT's gap read 6.8e-5, PERF.md); local Adam at the
# default eps is run too and its gap printed, not held. All the options
# at once take local momentum: FedAdam amplifies the local gap by lr / tau
# = 10 where the pseudo-gradient is near 0.
FEDADAM_TAU = 1e-3
LOCAL_ADAM_EPS = 1e-5


def option_variants(trainable_prefixes):
    """Phase 10's options, each alone and then all at once: name ->
    (FedSim keyword arguments, whether the card-vs-CPU gap is held)."""
    from baton_tpu_torch.core import optim
    from baton_tpu_torch.core.regularizers import fedprox

    def trainable(name, leaf):
        return name.startswith(trainable_prefixes)

    return {
        "local momentum 0.9": (dict(optimizer=optim.sgd(0.01, momentum=0.9)), True),
        "local adam(1e-3, eps 1e-5)": (dict(optimizer=optim.adam(1e-3, eps=LOCAL_ADAM_EPS)),
                                       True),
        "local adam(1e-3, eps 1e-8)": (dict(optimizer=optim.adam(1e-3)), False),
        "fedprox mu 0.1": (dict(regularizer=fedprox(0.1)), True),
        "fedadam server adam(1e-2, eps 1e-3)": (
            dict(server_optimizer=optim.adam(1e-2, eps=FEDADAM_TAU)), True),
        "trainable " + "+".join(trainable_prefixes): (dict(trainable=trainable), True),
        "all together": (dict(optimizer=optim.sgd(0.01, momentum=0.9),
                              regularizer=fedprox(0.1),
                              server_optimizer=optim.adam(1e-2, eps=FEDADAM_TAU),
                              trainable=trainable), True),
    }


def options_against_cpu(label, model, params, data, n_samples, perms, batch, lr,
                        trainable_prefixes, device="cuda"):
    """Every option of ``option_variants`` on ``device`` against the same
    rounds on the CPU: two rounds where a server optimizer's state threads
    from one to the next, one round for the options that keep nothing
    across rounds."""
    from baton_tpu_torch import FedSim

    errs = {}
    for name, (kw, hold) in option_variants(trainable_prefixes).items():
        results = []
        for dev in (device, "cpu"):
            sim = FedSim(model, batch_size=batch, learning_rate=lr, device=dev, **kw)
            p, state = {k: v.to(dev) for k, v in params.items()}, None
            for _ in range(2 if "server_optimizer" in kw else 1):
                res = sim.run_round(p, data, n_samples, n_epochs=perms.shape[1], perms=perms,
                                    server_opt_state=state)
                p, state = res.params, res.server_opt_state
            results.append(res)
        errs[name] = compare_rounds(f"{label} {name}", *results, params, hold=hold)
        if "trainable" in kw:
            check_partition_round(params, results[0].params, sim.partition.trainable_paths)
    return errs


def options_parity_phase():
    """Phase 10: 2-layer fp32 BERT (phase 4's) and 2-stage ResNet (phase
    7's) rounds with each option, card against the CPU."""
    from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
    from baton_tpu_torch.models.resnet import resnet_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    print("phase 10: the options, fp32, rounds of one epoch (two with a server optimizer), "
          "card against the CPU (tol 1e-4)")
    cfg = BertConfig(vocab_size=30522, max_len=128, d_model=768, n_layers=2, n_heads=12,
                     d_ff=3072, n_classes=4)
    rng = np.random.default_rng(2)
    datasets = []
    for n in (32, 20, 32, 0):
        lengths = rng.integers(16, cfg.max_len + 1, n)
        datasets.append({
            "x": rng.integers(0, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32),
            "attn_mask": (np.arange(cfg.max_len)[None] < lengths[:, None]).astype(np.float32),
            "y": rng.integers(0, cfg.n_classes, n).astype(np.int32)})
    data, n_samples = stack_client_datasets(datasets, batch_size=16)
    perms = torch.from_numpy(np.stack([rng.permutation(32)[None] for _ in datasets]))
    model = bert_classifier_model(cfg)
    errs = {"bert " + k: v for k, v in options_against_cpu(
        "bert", model, model.init(torch.Generator().manual_seed(3)), data, n_samples, perms, 16,
        0.01, ("blocks/1/", "ln_f/", "pooler/", "head/")).items()}

    rng = np.random.default_rng(4)
    datasets = [{"x": rng.normal(size=(n, 16, 16, 3)).astype(np.float32),
                 "y": rng.integers(0, 10, n).astype(np.int32)} for n in (16, 0, 11, 13)]
    data, n_samples = stack_client_datasets(datasets, batch_size=8)
    perms = torch.from_numpy(np.stack([rng.permutation(16)[None] for _ in datasets]))
    model = resnet_model(blocks_per_stage=(1, 1), n_groups=8)
    errs.update({"resnet " + k: v for k, v in options_against_cpu(
        "resnet", model, model.init(torch.Generator().manual_seed(3)), data, n_samples, perms,
        8, 0.05, ("s1b0/", "fc/")).items()})
    return errs


# phase 11: the reference's HTTP round. A Manager and ExperimentWorkers in
# this process, over loopback, speaking the BTW1 wire; every worker trains
# bench.py's ResNet-18 on the card from its own thread.

HTTP_FOLD_TOL = 1e-6  # global params against the fold of the bodies the manager received
HTTP_REPLAY_TOL = 1e-4  # the fp32 HTTP round against its in-process replay (as phases 4, 7, 10)
REPLAY_MOVE_SHARE = 1e-2  # ... and the gap within this share of the round's largest param change
ROUND_LIMIT_S = 120.0  # one HTTP round, from start_round until every worker is idle again


def fold_of_uploads(bodies):
    """The sample-weighted mean of BTW1 upload bodies, recomputed from the
    bodies in fp64: ``({name: fp32 array}, total weight)``."""
    from baton_tpu_torch.server import wire

    sums, total = {}, 0.0
    for body in bodies:
        tensors, meta = wire.decode(body)
        w = float(meta["n_samples"])
        for k, v in tensors.items():
            sums[k] = sums.get(k, 0.0) + np.asarray(v, np.float64) * w
        total += w
    return {k: (v / total).astype(np.float32) for k, v in sums.items()}, total


def max_gap(a, b) -> float:
    """Largest absolute difference between two dicts of same-named arrays
    or tensors."""
    check(set(a) == set(b), f"different tensors: {sorted(set(a) ^ set(b))}")
    as_np = lambda v: v.detach().cpu().double().numpy() if torch.is_tensor(v) else np.asarray(  # noqa: E731
        v, np.float64)
    return max(float(np.max(np.abs(as_np(a[k]) - as_np(b[k])))) for k in a)


SPLIT_NEEDS = ("round_setup", "local_train", "encode_update", "upload", "ingest_fold", "aggregate")


def round_split(spans):
    """A round's split from its trace (the manager's spans and those its
    workers shipped), in seconds: the manager's setup (the blob's encode
    and the notify fan-out, the workers' blob fetch and load included),
    the workers' local train (mean and max), upload encode, transfer +
    decode (the worker's upload less the manager's fold: its 200 means
    folded) with the decode alone, the fold of one upload, and the merge."""
    by = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s["end"] - s["start"])
    missing = [n for n in SPLIT_NEEDS if not by.get(n)]
    check(not missing, f"spans missing from the round's trace: {missing} (has {sorted(by)})")
    mean = {n: float(np.mean(v)) for n, v in by.items()}
    return {"setup": mean["round_setup"], "local_train": mean["local_train"],
            "local_train_max": max(by["local_train"]), "upload_encode": mean["encode_update"],
            "transfer_decode": mean["upload"] - mean["ingest_fold"],
            "decode": mean.get("ingest_decode", 0.0), "fold": mean["ingest_fold"],
            "merge": mean["aggregate"], "uploads": len(by["upload"])}


def mean_split(splits):
    """The per-key mean of several rounds' splits."""
    return {k: float(np.mean([s[k] for s in splits])) for k in splits[0]}


def recording_trainer(trainer, seen):
    """``trainer`` whose ``train`` first notes the devices of the params
    and data it is handed in ``seen``."""
    from baton_tpu_torch.core.training import LocalTrainer

    class Recording(LocalTrainer):
        def train(self, params, data, *args, **kw):
            seen.append(sorted({v.device.type for v in [*params.values(), *data.values()]}))
            return super().train(params, data, *args, **kw)

    return Recording(**{f.name: getattr(trainer, f.name)
                        for f in dataclasses.fields(LocalTrainer)})


async def http_federation(model, datasets, *, seeds, lr, batch, log_dir, rounds,
                          manager_kw=None, worker_kw=None, heartbeat_time=30.0):
    """A Manager (built with ``manager_kw``) and one ExperimentWorker (built
    with ``worker_kw``) per dataset on loopback, all on the card;
    ``rounds(fed)`` runs the rounds. ``fed.exp`` is the current manager's
    experiment and ``fed.workers`` the workers; ``await fed.drive()``
    starts a round and returns its seconds from ``start_round`` until
    ``rounds.n_rounds`` advances; ``await fed.start()`` only starts one
    (returning its start time) and ``await fed.wait_round(n0, t0)`` waits
    for the count to pass ``n0``; ``await fed.get(path)`` GETs a manager
    endpoint; ``await fed.restart(**kw)`` stops the manager and starts a
    new one on the same port, waiting until every worker has registered
    again; ``fed.meter`` lists ``(kind, bytes)`` of every upload and blob
    download the managers served, and ``fed.bodies`` the upload bodies
    they received. Returns what ``rounds`` returns, with those bodies and
    the devices the trainers were handed."""
    import asyncio
    import socket
    import types

    import aiohttp
    from aiohttp import web

    from baton_tpu_torch.core.training import make_local_trainer
    from baton_tpu_torch.server.http_manager import Manager
    from baton_tpu_torch.server.http_worker import ExperimentWorker

    def listen(port=0):
        sock = socket.socket()
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", port))
        return sock, sock.getsockname()[1]

    async def serve(app, sock):
        runner = web.AppRunner(app)
        await runner.setup()
        await web.SockSite(runner, sock).start()
        return runner

    bodies, seen, meter = [], [], []
    # the timer waits on the manager's end of a round, not on a busy poll
    # of the event loop that the manager and every worker share
    round_ended, loop = asyncio.Event(), asyncio.get_running_loop()

    @web.middleware
    async def metering(request, handler):
        resp = await handler(request)
        if request.path.endswith("/update"):
            meter.append(("upload", request.content_length or 0))
        elif "/round_blob/" in request.path and resp.status == 200:
            meter.append(("blob", resp.content_length or 0))
        return resp

    def build_manager(kw):
        app = web.Application(middlewares=[metering])
        exp = Manager(app).register_experiment(
            model, name="httpround", round_timeout=300.0, rng_seed=0,
            rounds_log_path=str(Path(log_dir) / "rounds.jsonl"), **kw)
        decoder, end_round, end_secure = (exp._make_upload_decoder, exp.end_round,
                                          exp._end_round_secure)

        def recording_decoder(body, content_type):
            bodies.append(bytes(body))
            return decoder(body, content_type)

        def end_round_and_signal():
            end_round()
            loop.call_soon_threadsafe(round_ended.set)

        async def end_secure_and_signal():
            # a secure round ends after its unmasking, not at end_round
            try:
                await end_secure()
            finally:
                round_ended.set()

        exp._make_upload_decoder = recording_decoder
        exp.end_round = end_round_and_signal
        exp._end_round_secure = end_secure_and_signal
        return app, exp

    async def wait_registered():
        for _ in range(3000):
            if len(fed.exp.registry) == len(fed.workers):
                break
            await asyncio.sleep(0.01)
        check(len(fed.exp.registry) == len(fed.workers),
              f"{len(fed.exp.registry)} of {len(fed.workers)} registered")

    sock, mport = listen()
    app, exp = build_manager(manager_kw or {})
    fed = types.SimpleNamespace(exp=exp, workers=[], meter=meter, bodies=bodies,
                                runner=await serve(app, sock))
    runners = []
    for d, seed in zip(datasets, seeds):
        wsock, wport = listen()
        wapp = web.Application()
        trainer = recording_trainer(make_local_trainer(model, batch_size=batch,
                                                       learning_rate=lr), seen)
        fed.workers.append(ExperimentWorker(
            wapp, model, f"127.0.0.1:{mport}", name="httpround", port=wport,
            heartbeat_time=heartbeat_time, rng_seed=seed, trainer=trainer,
            get_data=lambda d=d: (d, d["x"].shape[0]), **(worker_kw or {})))
        runners.append(await serve(wapp, wsock))
    await wait_registered()
    session = aiohttp.ClientSession()
    base = f"http://127.0.0.1:{mport}/httpround/"

    async def get(path):
        async with session.get(base + path) as resp:
            check(resp.status == 200, f"{path} answered {resp.status}")
            return await resp.json()

    async def start():
        round_ended.clear()
        t0 = time.perf_counter()
        acks = await get("start_round?n_epoch=1")
        check(len(acks) == len(fed.workers) and all(acks.values()), f"acks {acks}")
        return t0

    async def wait_round(n0, t0):
        while fed.exp.rounds.n_rounds == n0:
            left = ROUND_LIMIT_S - (time.perf_counter() - t0)
            check(left > 0, f"the round did not complete in {ROUND_LIMIT_S} s")
            with contextlib.suppress(TimeoutError):
                await asyncio.wait_for(round_ended.wait(), left)
            round_ended.clear()
        dt = time.perf_counter() - t0
        # a worker still flagged mid-round would 409 the next broadcast
        while any(w.round_in_progress for w in fed.workers):
            check(time.perf_counter() - t0 < ROUND_LIMIT_S, "a worker stayed mid-round")
            await asyncio.sleep(0.02)
        return dt

    async def drive():
        n0 = fed.exp.rounds.n_rounds
        return await wait_round(n0, await start())

    async def restart(**kw):
        await fed.runner.cleanup()
        app, fed.exp = build_manager(kw)
        fed.runner = await serve(app, listen(mport)[0])
        await wait_registered()

    fed.get, fed.start, fed.wait_round, fed.drive, fed.restart = get, start, wait_round, drive, \
        restart
    try:
        out = await rounds(fed)
        # the workers ship their spans after each delivery
        for w in fed.workers:
            if w._ship_task is not None:
                await w._ship_task
    finally:
        await session.close()
        for r in runners + [fed.runner]:
            await r.cleanup()
    return out, bodies, seen


def http_round_phase(fa):
    """Phase 11: ``bench.py``'s ResNet-18 (bf16 compute) on 8 HTTP workers
    under one Manager, all on the card in this process; then an fp32
    variant held against its in-process replay."""
    import asyncio
    import tempfile

    from baton_tpu_torch.models.resnet import resnet18_cifar_model
    from baton_tpu_torch.obs.compute import validate_record
    from baton_tpu_torch.server import wire
    from baton_tpu_torch.server.state import params_to_state_dict
    from baton_tpu_torch.utils import tracing
    from baton_tpu_torch.utils.slog import read_rounds_jsonl

    n_workers, per_worker, batch, lr, n_timed = 8, 48, 32, 0.05, 3
    rng = np.random.default_rng(0)  # drawn as phase 6 draws its clients
    datasets = [{"x": rng.normal(size=(per_worker, 32, 32, 3)).astype(np.float32),
                 "y": rng.integers(0, 10, size=(per_worker,)).astype(np.int32)}
                for _ in range(n_workers)]
    model = resnet18_cifar_model(compute_dtype=torch.bfloat16, conv_impl="direct")
    n_total = n_workers * per_worker
    print(f"phase 11: the HTTP round: a Manager and {n_workers} ExperimentWorkers on loopback, "
          f"ResNet-18 as bench.py (bf16 compute, conv direct), {per_worker} samples a worker, "
          f"batch {batch}, 1 epoch, lr {lr}, mean aggregator, BTW1 uploads")
    fa.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    async def rounds(fed):
        exp = fed.exp
        n_params = sum(v.numel() for v in exp.params.values())
        check(all(v.device.type == "cuda" for v in exp.params.values()),
              "the manager's params are not on the card")
        warm = await fed.drive()
        times = [await fed.drive() for _ in range(n_timed)]
        return {"n_params": n_params, "warm_up_s": warm, "round_s": times,
                "params": params_to_state_dict(exp.params), "exp": exp}

    with tempfile.TemporaryDirectory() as log_dir:
        out, bodies, seen = asyncio.run(http_federation(
            model, datasets, seeds=range(n_workers), lr=lr, batch=batch, log_dir=log_dir,
            rounds=rounds))
        records, torn = read_rounds_jsonl(str(Path(log_dir) / "rounds.jsonl"))
    exp = out.pop("exp")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times = out["round_s"]
    check(len(bodies) == n_workers * (n_timed + 1), f"{len(bodies)} uploads received")
    last_round = {wire.decode(b)[1]["update_name"] for b in bodies[-n_workers:]}
    check(last_round == {records[-1]["round"]}, f"the last uploads belong to {last_round}")
    fold, weight = fold_of_uploads(bodies[-n_workers:])
    fold_gap = max_gap(out["params"], fold)
    check(weight == n_total, f"the last round's uploads weigh {weight}, not {n_total}")
    check(fold_gap <= HTTP_FOLD_TOL,
          f"global params differ from the fold of the uploads by {fold_gap:.3e}")
    check(all(devs == ["cuda"] for devs in seen), f"a trainer was handed CPU tensors: {seen}")
    check(all(np.isfinite(v).all() for v in out["params"].values()), "non-finite params")
    flash = fa.launches()
    check(all(n == 0 for n in flash.values()), f"flash kernels launched in the HTTP round: {flash}")
    check(torn == 0 and len(records) == n_timed + 1, f"rounds.jsonl: {len(records)} records, "
          f"{torn} torn")
    check(all(r["outcome"] == "completed" and r["reporters"] == n_workers for r in records),
          "a round in rounds.jsonl did not complete with every worker")
    splits = [round_split(exp.tracer.spans_for(tracing.make_trace_id(exp.name, r["round"])))
              for r in records[1:]]
    split = mean_split(splits)
    s_mean, s_median = float(np.mean(times)), float(np.median(times))
    print(f"  {out['n_params'] / 1e6:.2f} M params a worker, {len(bodies[-1]) / 1e6:.1f} MB an "
          f"upload; warm-up round {out['warm_up_s']:.4f} s")
    print(f"  s/round mean {s_mean:.4f}, median {s_median:.4f} (rounds 1-{n_timed}: "
          f"{', '.join(f'{t:.4f}' for t in times)}); samples/s {n_total / s_mean:.1f} (at the "
          f"median {n_total / s_median:.1f}); peak memory {peak_gb:.2f} GB (the card, every "
          f"worker and the manager)")
    print("  split of a round (mean of the timed rounds, s; from the manager's and workers' "
          "spans): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    print(f"  aggregate against the fold of the last round's {n_workers} uploads: max |diff| "
          f"{fold_gap:.3e} (tol {HTTP_FOLD_TOL}); trainers handed {seen[0]} tensors; flash "
          f"launches {flash}")
    last = [wire.decode(b)[1].get("compute") or {} for b in bodies[-n_workers:]]
    check(all(validate_record(c) == [] for c in last), "a worker's compute record is invalid")
    print("  compute records of the last round, as they reached the manager (samples/s, peak "
          "GB, mfu): " + "; ".join(f"{c.get('samples_per_sec')}, {c.get('peak_hbm_gb')}, "
                                   f"{c.get('mfu')}" for c in last))
    for r in records:
        c = r["compute"]
        print(f"  rounds.jsonl {r['round']}: duration {r['duration_s']} s, compute: reporters "
              f"{c['reporters']}, samples/s per chip {c.get('samples_per_sec_per_chip')}, peak "
              f"{c.get('peak_hbm_gb')} GB, mfu {c.get('mfu')}")
    stats = {"round_s": times, "s_per_round": s_mean, "s_per_round_median": s_median,
             "samples_per_s": n_total / s_mean, "warm_up_s": out["warm_up_s"],
             "peak_memory_gb": peak_gb, "split": split, "split_by_round": splits,
             "fold_gap": fold_gap, "worker_compute": last}
    stats["replay"] = http_replay_phase()
    return stats


def replay_merge(trained, counts, like):
    """The port's mean aggregator over the replayed workers' params,
    weighted by their sample ``counts`` and cast like ``like``."""
    from baton_tpu_torch.ops import aggregation as agg

    device = next(iter(like.values())).device
    weights = torch.tensor([float(n) for n in counts], device=device)
    return agg.tree_cast_like(agg.apply_aggregator(
        agg.parse_aggregator("mean"), agg.tree_stack(trained), weights), like)


def replay_holds(gap: float, moved: float, tol: float = HTTP_REPLAY_TOL) -> bool:
    """The replay check: the gap within ``tol`` (``HTTP_REPLAY_TOL``) and
    within ``REPLAY_MOVE_SHARE`` of the round's largest param change."""
    return gap <= tol and gap <= REPLAY_MOVE_SHARE * moved


def hold_replay(name, start, end, trained, counts, batch, tol=HTTP_REPLAY_TOL):
    """One fp32 HTTP round, from ``start`` to the manager's ``end``,
    against its replay: the workers' replayed params ``trained`` merged
    with their sample ``counts``. Two planted faults must fail the same
    check: the last worker's samples counted as its padded batches, and
    its upload dropped. Returns the gap and the largest param change."""
    gap, moved = max_gap(end, replay_merge(trained, counts, start)), max_gap(end, start)
    padded = -(-counts[-1] // batch) * batch
    faults = {
        f"the last worker's {counts[-1]} samples counted as {padded}":
            replay_merge(trained, [*counts[:-1], padded], start),
        "the last worker's upload dropped": replay_merge(trained[:-1], counts[:-1], start),
    }
    controls = {fault: max_gap(end, want) for fault, want in faults.items()}
    print(f"  {name}: manager against the replay max |diff| {gap:.3e} (tol {tol:.3e} and "
          f"{REPLAY_MOVE_SHARE} x the max |param change| {moved:.3e}); against planted faults: "
          + ", ".join(f"{fault} {g:.3e}" for fault, g in controls.items()))
    check(moved > 0, f"{name} left the params unchanged")
    check(replay_holds(gap, moved, tol), f"{name}: the HTTP round and its replay differ by "
          f"{gap:.3e} (max |param change| {moved:.3e})")
    for fault, g in controls.items():
        check(not replay_holds(g, moved, tol), f"{name}: the replay check cannot see {fault} "
              f"({g:.3e})")
    return gap, moved


def http_replay_phase():
    """Phase 11's fp32 variant: 2 workers (one with fewer samples than a
    batch), 2 rounds; each worker's local train replayed in-process with
    ``LocalTrainer.train`` from the broadcast params, its data and a
    generator seeded as the worker seeds it, merged by the port's
    aggregator (``hold_replay``)."""
    import asyncio
    import tempfile

    from baton_tpu_torch.core.training import make_local_trainer
    from baton_tpu_torch.models.resnet import resnet18_cifar_model
    from baton_tpu_torch.ops.padding import pad_dataset, round_up

    batch, lr, seeds = 32, 0.05, (11, 12)
    rng = np.random.default_rng(5)
    datasets = [{"x": rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
                 "y": rng.integers(0, 10, size=(n,)).astype(np.int32)} for n in (48, 20)]
    model = resnet18_cifar_model(compute_dtype=torch.float32, conv_impl="direct")

    async def rounds(fed):
        starts, ends = [], []
        for _ in range(2):
            starts.append({k: v.clone() for k, v in fed.exp.params.items()})
            await fed.drive()
            ends.append({k: v.clone() for k, v in fed.exp.params.items()})
        return starts, ends

    with tempfile.TemporaryDirectory() as log_dir:
        (starts, ends), _, seen = asyncio.run(http_federation(
            model, datasets, seeds=seeds, lr=lr, batch=batch, log_dir=log_dir, rounds=rounds))
    check(all(devs == ["cuda"] for devs in seen), f"a trainer was handed CPU tensors: {seen}")
    trainer = make_local_trainer(model, batch_size=batch, learning_rate=lr)
    gens = [torch.Generator().manual_seed(s + 1) for s in seeds]
    padded = []
    for d in datasets:
        p, n = pad_dataset(d, round_up(d["x"].shape[0], batch))
        padded.append(({k: torch.as_tensor(v, device="cuda") for k, v in p.items()}, n))
    readings = []
    for r, (start, end) in enumerate(zip(starts, ends)):
        trained = [trainer.train(start, d, n, 1, generator=g)[0]
                   for (d, n), g in zip(padded, gens)]
        gap, moved = hold_replay(f"fp32 variant, round {r}", start, end, trained,
                                 [n for _, n in padded], batch)
        readings.append({"gap": gap, "moved": moved})
    return readings


# phases 12-14: the HTTP round's remaining options (compressed uploads,
# quantised and delta broadcasts, a manager restart resumed from its
# checkpoints, secure aggregation) and BASELINE config 1.

COMPRESS = "topk:0.1:q8"  # the uploads of phase 12 and its delta broadcasts
EF_TOL = 1e-5  # relative: transmitted plus residual against the sum of the true deltas
SECURE_QUANTUM = 2.0 ** -16  # the fixed point of DEFAULT_SCALE_BITS = 16
SECURE_TOL = SECURE_QUANTUM + HTTP_REPLAY_TOL  # a secure round against its fp32 replay
RESUME_TOL = 1e-6  # config 1 stopped after 2 rounds and resumed, against 4 rounds in one go
CONFIG1_FULL_ROUNDS = 1  # of the full preset's 20: the smoke's time limit


def fold_of_compressed_uploads(bodies, anchor):
    """The sample-weighted mean of top-k BTW1 uploads, each reconstructed
    as ``anchor + decode(payload)``, in fp64: ``({name: fp32 array},
    total weight)``."""
    from baton_tpu_torch.server import wire

    sums, total = {}, 0.0
    for body in bodies:
        tensors, meta = wire.decode(body)
        check(meta.get("compressed") == {"scheme": "topk"}, "an upload is not top-k compressed")
        w = float(meta["n_samples"])
        for k, ref in anchor.items():
            val = np.asarray(tensors[f"{k}@val"], np.float64)
            if f"{k}@scale" in tensors:
                val = val * float(np.asarray(tensors[f"{k}@scale"]).ravel()[0])
            dense = np.asarray(ref, np.float64).ravel().copy()
            dense[np.asarray(tensors[f"{k}@idx"], np.int64)] += val
            sums[k] = sums.get(k, 0.0) + dense.reshape(np.shape(ref)) * w
        total += w
    return {k: (v / total).astype(np.float32) for k, v in sums.items()}, total


def track_error_feedback(compressor):
    """Wrap ``compressor`` (an ``ErrorFeedbackCompressor``) to sum, in fp64
    on its deltas' device, the true deltas it is handed and the exact
    (pre-quantisation) mass it transmits, less what a failed upload gives
    back; returns those running sums, ``{"true": tree, "sent": tree}``."""
    from baton_tpu_torch.ops.compression import topk_decompress

    sums = {}
    compress, restore = compressor.compress, compressor.restore

    def add(key, tree, sign=1.0):
        acc = sums.setdefault(key, {k: torch.zeros(v.shape, dtype=torch.float64,
                                                   device=v.device) for k, v in tree.items()})
        for k, v in tree.items():
            acc[k] += sign * v.double()

    def tracked_compress(delta):
        payload = compress(delta)
        add("true", delta)
        add("sent", topk_decompress(compressor._last_exact, delta))
        return payload

    def tracked_restore(template):
        if compressor._last_exact is not None:
            add("sent", topk_decompress(compressor._last_exact, template), -1.0)
        restore(template)

    compressor.compress, compressor.restore = tracked_compress, tracked_restore
    return sums


def error_feedback_gap(sums, residual) -> float:
    """``max |sent + residual - true| / max |true|`` over every tensor."""
    gap = max(float((sums["sent"][k] + residual[k].double() - v).abs().max())
              for k, v in sums["true"].items())
    return gap / max(float(v.abs().max()) for v in sums["true"].values())


def resnet_workers_data(seed, sizes):
    """CIFAR-shaped worker datasets of ``sizes`` samples, drawn as phase 6
    draws its clients."""
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
             "y": rng.integers(0, 10, size=(n,)).astype(np.int32)} for n in sizes]


def bandwidth_phase(fa):
    """Phase 12: phase 11's federation with the bandwidth options and a
    manager restart. (a) 3 rounds: every worker uploads top-k (10%) int8
    round deltas with error feedback, the manager broadcasts int8 weights
    and checkpoints every round. (b) The manager stops; a new one on the
    same port and checkpoint directory, broadcasting top-k int8 deltas
    against the previous round's blob, runs 2 rounds with the same workers
    (they register again after a 401): the first pulls the full blob (no
    anchor after the restart), the second the delta."""
    import asyncio
    import tempfile

    from baton_tpu_torch.models.resnet import resnet18_cifar_model
    from baton_tpu_torch.server import wire
    from baton_tpu_torch.server.state import params_to_state_dict
    from baton_tpu_torch.utils import tracing

    n_workers, per_worker, batch, lr = 8, 48, 32, 0.05
    datasets = resnet_workers_data(0, [per_worker] * n_workers)
    n_total = sum(d["x"].shape[0] for d in datasets)
    model = resnet18_cifar_model(compute_dtype=torch.bfloat16, conv_impl="direct")
    print(f"phase 12: phase 11's federation ({n_workers} workers, ResNet-18 bf16) with uploads "
          f"{COMPRESS} (error feedback on the card), int8 broadcasts and checkpoints, then a "
          f"manager restart from the checkpoints with delta broadcasts {COMPRESS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    async def one_round(fed, label):
        n0, nb, nm = fed.exp.rounds.n_rounds, len(fed.bodies), len(fed.meter)
        t0 = await fed.start()
        # what the workers loaded this round: the manager's upload anchor
        anchor, name = dict(fed.exp._broadcast_anchor_sd), fed.exp.rounds.round_name
        dt = await fed.wait_round(n0, t0)
        # each worker ships its spans once its upload's 200 is back
        while any(w._pending is not None for w in fed.workers):
            await asyncio.sleep(0.01)
        for w in fed.workers:
            if w._ship_task is not None:
                await w._ship_task
        split = round_split(fed.exp.tracer.spans_for(tracing.make_trace_id(fed.exp.name, name)))
        fold, weight = fold_of_compressed_uploads(fed.bodies[nb:], anchor)
        check(weight == n_total, f"{label}: the uploads weigh {weight}, not {n_total}")
        gap = max_gap(params_to_state_dict(fed.exp.params), fold)
        check(gap <= HTTP_FOLD_TOL, f"{label}: global params differ from the fold of the "
              f"decoded uploads by {gap:.3e}")
        ups = [b for kind, b in fed.meter[nm:] if kind == "upload"]
        blobs = [b for kind, b in fed.meter[nm:] if kind == "blob"]
        check(len(ups) == n_workers, f"{label}: {len(ups)} uploads")
        return {"round": label, "s": dt, "fold_gap": gap, "upload_bytes": float(np.mean(ups)),
                "blob_bytes": blobs, "split": split}

    def counters(workers, name):
        return sum(w.metrics.snapshot()["counters"].get(name, 0.0) for w in workers)

    async def rounds(fed):
        efs = [track_error_feedback(w.compressor) for w in fed.workers]
        dense = len(wire.encode(params_to_state_dict(fed.exp.params), {}))
        out = {"dense_bytes": dense, "rounds": []}
        for r in range(3):
            out["rounds"].append(await one_round(fed, f"(a) round {r}"))
        saved = params_to_state_dict(fed.exp.params)
        n_rounds, losses = fed.exp.rounds.n_rounds, list(fed.exp.rounds.loss_history)
        t0 = time.perf_counter()
        await fed.restart(broadcast_delta=COMPRESS, checkpoint_dir=ckdir)
        out["restart_s"] = time.perf_counter() - t0
        exp = fed.exp
        check(exp.rounds.n_rounds == n_rounds == 3, f"resumed at round {exp.rounds.n_rounds}")
        check([float(x) for x in exp.rounds.loss_history] == [float(x) for x in losses],
              "the resumed loss history differs")
        restored = params_to_state_dict(exp.params)
        check(all(v.device.type == "cuda" for v in exp.params.values()),
              "the resumed params are not on the card")
        check(all(np.array_equal(restored[k], v) for k, v in saved.items()),
              "the resumed params differ from the checkpointed ones")
        fetched = counters(fed.workers, "blob_fetch_delta")
        for r in range(2):
            out["rounds"].append(await one_round(fed, f"(b) round {r}"))
        delta_pulls = counters(fed.workers, "blob_fetch_delta") - fetched
        mismatches = counters(fed.workers, "blob_delta_digest_mismatch")
        check(delta_pulls == n_workers, f"{delta_pulls} delta pulls, not {n_workers}")
        check(mismatches == 0, f"{mismatches} delta reconstructions missed the blob's digest")
        full, delta = out["rounds"][3]["blob_bytes"], out["rounds"][4]["blob_bytes"]
        check(len(full) == len(delta) == n_workers and min(full) >= 0.99 * dense
              and max(delta) < 0.5 * dense, f"blob pulls after the restart: {full}, then {delta}")
        out["ef_gaps"] = [error_feedback_gap(ef, w.compressor.residual)
                          for ef, w in zip(efs, fed.workers)]
        out.update(delta_pulls=delta_pulls, digest_mismatches=mismatches,
                   n_params=sum(v.numel() for v in exp.params.values()))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        ckdir = str(Path(tmp) / "ckpt")
        out, bodies, seen = asyncio.run(http_federation(
            model, datasets, seeds=range(n_workers), lr=lr, batch=batch, log_dir=tmp,
            rounds=rounds, heartbeat_time=1.0, worker_kw={"compress": COMPRESS},
            manager_kw={"broadcast_quantize_bits": 8, "checkpoint_dir": ckdir}))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(devs == ["cuda"] for devs in seen), f"a trainer was handed CPU tensors: {seen}")
    worst_ef = max(out["ef_gaps"])
    check(worst_ef <= EF_TOL, f"error feedback lost mass: relative gap {worst_ef:.3e}")
    flash = fa.launches()
    check(all(n == 0 for n in flash.values()), f"flash kernels launched: {flash}")
    dense = out["dense_bytes"]
    print(f"  {out['n_params'] / 1e6:.2f} M params; a dense upload or blob is {dense / 1e6:.2f} MB "
          f"(phase 11's)")
    for r in out["rounds"]:
        blobs = r["blob_bytes"]
        print(f"  {r['round']}: {r['s']:.4f} s; upload {r['upload_bytes'] / 1e6:.3f} MB "
              f"({dense / r['upload_bytes']:.1f}x smaller); broadcast pulls {len(blobs)} of "
              f"{np.mean(blobs) / 1e6 if blobs else 0.0:.3f} MB each; fold of the decoded uploads "
              f"max |diff| {r['fold_gap']:.3e} (tol {HTTP_FOLD_TOL})")
        print("    split (s, from the spans): " + ", ".join(f"{k} {v:.4f}"
                                                       for k, v in r["split"].items()))
    print(f"  restart: the new manager resumed round 3, its loss history and params to the bit, "
          f"{out['restart_s']:.2f} s until every worker registered again; delta pulls "
          f"{out['delta_pulls']:.0f}, digest mismatches {out['digest_mismatches']:.0f}")
    print(f"  error feedback (sent + residual against the true deltas, relative, 5 rounds): "
          f"worst {worst_ef:.3e} (tol {EF_TOL}); peak memory {peak_gb:.2f} GB; flash launches "
          f"{flash}")
    out.update(peak_memory_gb=peak_gb, ef_worst=worst_ef)
    return out


def secure_phase(fa):
    """Phase 13: secure aggregation at ResNet-18 width, fp32 (so the round
    can be replayed): 4 workers (48, 48, 20, 48 samples; threshold 3), 2
    rounds; in the second the last worker trains but never uploads, after
    it took part in the key and share exchange, and the manager recovers
    its masks from the survivors' shares. Each round's new params against
    the sample-weighted mean of what the survivors trained (the fixed
    point's quantum) and against the survivors' local trains replayed in
    this process (the quantum plus phase 11's replay tolerance)."""
    import asyncio
    import tempfile

    from baton_tpu_torch.core.training import make_local_trainer
    from baton_tpu_torch.models.resnet import resnet18_cifar_model
    from baton_tpu_torch.ops.padding import pad_dataset, round_up
    from baton_tpu_torch.server import secure
    from baton_tpu_torch.server.state import params_to_state_dict

    sizes, batch, lr, seeds = (48, 48, 20, 48), 32, 0.05, (21, 22, 23, 24)
    datasets = resnet_workers_data(7, sizes)
    model = resnet18_cifar_model(compute_dtype=torch.float32, conv_impl="direct")
    print(f"phase 13: secure aggregation, {len(sizes)} workers ({', '.join(map(str, sizes))} "
          f"samples), ResNet-18 fp32, threshold {len(sizes) // 2 + 1}, 2 rounds, the last worker "
          f"dropping after the share exchange in the second")
    mask_s, unmask_s = [], []
    mask_state_dict = secure.mask_state_dict

    def timed_mask(*args, **kw):
        t0 = time.perf_counter()
        try:
            return mask_state_dict(*args, **kw)
        finally:
            mask_s.append(time.perf_counter() - t0)

    async def rounds(fed):
        exp = fed.exp
        end_secure = exp._end_round_secure

        async def timed_end():
            t0 = time.perf_counter()
            try:
                await end_secure()
            finally:
                unmask_s.append(time.perf_counter() - t0)

        exp._end_round_secure = timed_end
        out = []
        # round 1: every worker uploads
        start = {k: v.clone() for k, v in exp.params.items()}
        dt = await fed.drive()
        out.append({"start": start, "end": {k: v.clone() for k, v in exp.params.items()},
                    "trained": [{k: v.clone() for k, v in w.params.items()} for w in fed.workers],
                    "survivors": list(range(len(sizes))), "s": dt})
        # round 2: the last worker trains but never uploads
        dropped = fed.workers[-1]

        async def silent(*args, **kw):
            return None

        dropped.report_update = silent
        start = {k: v.clone() for k, v in exp.params.items()}
        n0 = exp.rounds.n_rounds
        t0 = await fed.start()
        while len(exp.rounds.client_responses) < len(sizes) - 1:
            check(time.perf_counter() - t0 < ROUND_LIMIT_S, "the survivors did not report")
            await asyncio.sleep(0.02)
        await fed.get("end_round")  # finish without the dropped worker: recover its masks
        dt = await fed.wait_round(n0, t0)
        del dropped.report_update
        out.append({"start": start, "end": {k: v.clone() for k, v in exp.params.items()},
                    "trained": [{k: v.clone() for k, v in w.params.items()}
                                for w in fed.workers],
                    "survivors": list(range(len(sizes) - 1)), "s": dt})
        counters = exp.metrics.snapshot()["counters"]
        check(counters.get("secure_dropouts_recovered") == 1.0,
              f"dropouts recovered: {counters.get('secure_dropouts_recovered')}")
        return out

    secure.mask_state_dict = timed_mask
    try:
        with tempfile.TemporaryDirectory() as log_dir:
            out, bodies, seen = asyncio.run(http_federation(
                model, datasets, seeds=seeds, lr=lr, batch=batch, log_dir=log_dir,
                rounds=rounds, manager_kw={"secure_agg": True}))
    finally:
        secure.mask_state_dict = mask_state_dict
    check(all(devs == ["cuda"] for devs in seen), f"a trainer was handed CPU tensors: {seen}")
    check(len(bodies) == 2 * len(sizes) - 1, f"{len(bodies)} uploads received")
    # the survivors' local trains replayed from each round's broadcast,
    # every worker's shuffle generator advanced as the worker's own
    trainer = make_local_trainer(model, batch_size=batch, learning_rate=lr)
    gens = [torch.Generator().manual_seed(s + 1) for s in seeds]
    padded = []
    for d in datasets:
        pd, n = pad_dataset(d, round_up(d["x"].shape[0], batch))
        padded.append(({k: torch.as_tensor(v, device="cuda") for k, v in pd.items()}, n))
    readings = []
    for r, rnd in enumerate(out):
        replayed = [trainer.train(rnd["start"], d, n, 1, generator=g)[0]
                    for (d, n), g in zip(padded, gens)]
        keep = rnd["survivors"]
        counts = [datasets[i]["x"].shape[0] for i in keep]
        weights = np.asarray(counts, np.float64)
        mean = {k: sum(w * rnd["trained"][i][k].double().cpu().numpy()
                       for w, i in zip(weights, keep)) / weights.sum() for k in rnd["end"]}
        sum_gap = max_gap(rnd["end"], mean)
        print(f"  round {r} ({len(keep)} survivors): {rnd['s']:.4f} s; new params against the "
              f"sample-weighted mean of what the survivors trained max |diff| {sum_gap:.3e} "
              f"(tol {SECURE_QUANTUM:.3e})")
        check(sum_gap <= SECURE_QUANTUM, f"round {r}: the unmasked mean is off by {sum_gap:.3e}")
        gap, moved = hold_replay(f"secure round {r}", rnd["start"], rnd["end"],
                                 [replayed[i] for i in keep], counts, batch, tol=SECURE_TOL)
        readings.append({"s": rnd["s"], "survivors": len(keep), "mean_gap": sum_gap,
                         "replay_gap": gap, "moved": moved})
    check(len(mask_s) == 2 * len(sizes) - 1 and len(unmask_s) == 2,
          f"{len(mask_s)} maskings, {len(unmask_s)} unmaskings")
    flash = fa.launches()
    check(all(n == 0 for n in flash.values()), f"flash kernels launched: {flash}")
    print(f"  host time: masking an upload on a worker (quantise, {len(sizes) - 1} pair masks and "
          f"the self mask over {sum(v.numel() for v in out[0]['end'].values()) / 1e6:.2f} M "
          f"uint64) mean {np.mean(mask_s):.4f} s, max {max(mask_s):.4f} s; unmasking on the "
          f"manager (share requests, reconstruction, masks, modular sum) "
          f"{', '.join(f'{t:.4f}' for t in unmask_s)} s; flash launches {flash}")
    return {"rounds": readings, "mask_s": mask_s, "unmask_s": unmask_s}


def config1_phase(fa):
    """Phase 14: BASELINE config 1 (``examples/01_cnn_mnist_fedavg.py``:
    4 clients, the 2-layer CNN, local SGD 0.01 with momentum 0.9, batch
    32, ``load_mnist``'s synthetic fallback) through the port's ``run()``.
    The example's default (tiny) preset, 64 samples a client and 2 epochs,
    is the gate: 4 rounds on the card; the same run stopped after 2 rounds
    and resumed from its checkpoints by a new FedSim (within 1e-6, with
    cuDNN's deterministic algorithms for this phase); and the 4 rounds on
    the CPU (within 1e-4). Then the example's ``--scale full`` preset, 4 x
    15,000 samples and 4 epochs a round, cut from 20 rounds to
    ``CONFIG1_FULL_ROUNDS``, timed apart from making its data, and held to
    the example's own check (accuracy above 0.5)."""
    import tempfile

    from baton_tpu_torch.examples import cnn_mnist_fedavg as config1

    print("phase 14: BASELINE config 1 (2-layer CNN, 4 clients of the synthetic MNIST "
          "fallback, SGD 0.01 momentum 0.9, batch 32); the tiny preset's gate (64 samples a "
          "client, 2 epochs, 4 rounds) with torch.backends.cudnn.deterministic = True, then "
          f"the full preset (15,000 samples a client, 4 epochs) for {CONFIG1_FULL_ROUNDS} of "
          "its 20 rounds")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # an empty data directory: the loader falls back to its
            # surrogate, and nothing is read from or written to $HOME
            kw = dict(real_data=True, data_dir=str(Path(tmp) / "no_mnist"))
            # run() prints each round's losses: kept out of this output
            with contextlib.redirect_stdout(io.StringIO()):
                whole = config1.run(**kw)
                config1.run(n_rounds=2, checkpoint_dir=str(Path(tmp) / "ck"), **kw)
                resumed = config1.run(checkpoint_dir=str(Path(tmp) / "ck"), **kw)
                cpu = config1.run(device="cpu", **kw)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    params = whole["params"]
    check(all(v.device.type == "cuda" for v in params.values()), "config 1 ran off the card")
    check(all(bool(torch.isfinite(v).all()) for v in params.values()), "non-finite params")
    check(len(whole["loss_history"]) == 8 and whole["loss_history"][-1] < whole["loss_history"][0],
          f"the loss did not fall: {whole['loss_history']}")
    resume_gap = max_gap(resumed["params"], params)
    loss_resume_gap = float(np.max(np.abs(np.subtract(resumed["loss_history"],
                                                      whole["loss_history"]))))
    cpu_gap = max_gap(cpu["params"], params)
    loss_cpu_gap = float(np.max(np.abs(np.subtract(cpu["loss_history"], whole["loss_history"]))))
    print(f"  tiny preset (the gate): 4 rounds {whole['train_s']:.4f} s on the card, "
          f"{cpu['train_s']:.4f} s on the CPU (data {whole['data_s']:.4f} s apart), loss "
          f"{whole['loss_history'][0]:.4f} -> {whole['loss_history'][-1]:.4f}")
    print(f"  stopped after 2 rounds and resumed: params max |diff| {resume_gap:.3e}, losses "
          f"{loss_resume_gap:.3e} (tol {RESUME_TOL}); card against the CPU: params "
          f"{cpu_gap:.3e}, losses {loss_cpu_gap:.3e} (tol {TOL[torch.float32]})")
    check(resume_gap <= RESUME_TOL and loss_resume_gap <= RESUME_TOL,
          f"the resumed run differs by {resume_gap:.3e} / {loss_resume_gap:.3e}")
    check(cpu_gap <= TOL[torch.float32] and loss_cpu_gap <= TOL[torch.float32],
          f"the card and the CPU differ by {cpu_gap:.3e} / {loss_cpu_gap:.3e}")

    n_per_client, n_epochs = 15000, 4
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            full = config1.run(n_clients=4, n_rounds=CONFIG1_FULL_ROUNDS, n_epochs=n_epochs,
                               n_per_client=n_per_client, real_data=True,
                               data_dir=str(Path(tmp) / "no_mnist"))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = full["loss_history"]
    check(all(bool(torch.isfinite(v).all()) for v in full["params"].values()),
          "non-finite params in the full preset")
    check(len(hist) == CONFIG1_FULL_ROUNDS * n_epochs and hist[-1] < hist[0],
          f"the full preset's loss did not fall: {hist}")
    check(int(full["n"]) == 4 * n_per_client, f"evaluated {full['n']} samples")
    check(full["accuracy"] > 0.5, f"the full preset's accuracy {full['accuracy']:.3f}")
    round_s = full["train_s"] / CONFIG1_FULL_ROUNDS
    samples_s = 4 * n_per_client * n_epochs / round_s
    print(f"  full preset: data {full['data_s']:.4f} s; {CONFIG1_FULL_ROUNDS} rounds "
          f"{full['train_s']:.4f} s ({round_s:.4f} s a round, {samples_s:.1f} samples/s over "
          f"{n_epochs * -(-n_per_client // 32)} steps of 4 clients x 32 a round); loss {hist[0]:.4f} -> {hist[-1]:.4f}, "
          f"accuracy {full['accuracy']:.4f} over {int(full['n'])} samples; peak "
          f"{peak_gb:.2f} GB")
    flash = fa.launches()
    check(all(n == 0 for n in flash.values()), f"flash kernels launched: {flash}")
    return {"tiny_train_s": whole["train_s"], "tiny_cpu_train_s": cpu["train_s"],
            "resume_gap": resume_gap, "cpu_gap": cpu_gap, "loss_cpu_gap": loss_cpu_gap,
            "full_rounds": CONFIG1_FULL_ROUNDS, "full_data_s": full["data_s"],
            "full_train_s": full["train_s"], "full_round_s": round_s,
            "full_samples_s": samples_s, "full_accuracy": float(full["accuracy"]),
            "full_loss_history": hist, "full_peak_gb": peak_gb}


# ---------------------------------------------------------------------
# phase 15: the federation variants (stateful clients, FedBuff, FedPer,
# clustered FL) at BERT-base width, on phase 3's model and clients.

def check_cluster_assignments(assign, pair_grid, tol=2e-2) -> None:
    """Each client's cluster is the argmin of its row of ``pair_grid``
    ([C, K], the losses computed one (client, cluster) pair at a time); a
    client may take another cluster only where the two losses lie within
    ``tol`` of each other."""
    for c, k in enumerate(np.asarray(assign).tolist()):
        row = [float(x) for x in pair_grid[c]]
        best = int(np.argmin(row))
        check(k == best or abs(row[k] - row[best]) <= tol,
              f"client {c} took cluster {k} (loss {row[k]:.6f}) over cluster {best} "
              f"(loss {row[best]:.6f})")


def check_cluster_means(new, old, trained, assign, n_samples, tol=1e-5) -> float:
    """Each cluster that clients chose equals the sample-weighted mean of
    their ``trained`` params (fp64, within ``tol``); a cluster no client
    chose equals ``old`` bit for bit. Returns the largest gap."""
    assign = torch.as_tensor(np.asarray(assign))
    w = torch.as_tensor(np.asarray(n_samples), dtype=torch.float64)
    gap = 0.0
    for k in range(next(iter(new.values())).shape[0]):
        members = torch.nonzero(assign == k).flatten()
        if members.numel() == 0:
            check(all(torch.equal(new[n][k], old[n][k]) for n in new),
                  f"cluster {k} had no client but changed")
            continue
        for name, v in trained.items():
            wk = w[members].to(v.device)
            want = torch.tensordot(wk, v[members.to(v.device)].double(), dims=([0], [0]))
            gap = max(gap, float((new[name][k].double() - want / wk.sum()).abs().max()))
    check(gap <= tol, f"a cluster is {gap:.3e} from the weighted mean of its clients (tol {tol})")
    return gap


def variant_runs(model, params, second, data, n_samples, batch, lr, perms, device, shards=None,
                 buffer=(2, 3)):
    """Phase 15's four variants at a small size on ``device``, from the
    same weights (``second`` is the other cluster) and shuffles ``perms``
    [C, n_epochs, capacity] on any device: name -> (the params they end
    with, their losses). ``shards``: each on a clients mesh of that many
    shards of ``device`` (phase 22c); ``buffer``: FedBuff's buffer size and
    concurrency (a multiple of ``shards``), each step's completions taking
    ``perms`` in queue order."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core import optim
    from baton_tpu_torch.core.regularizers import fedprox
    from baton_tpu_torch.ops.aggregation import tree_stack
    from baton_tpu_torch.parallel import ClusteredFedSim, FedBuff, FedPer, StatefulClients
    from baton_tpu_torch.parallel.mesh import make_mesh

    mesh = None if shards is None else make_mesh(shards, devices=[torch.device(device)] * shards)

    def sim(**kw):
        return FedSim(model, batch_size=batch, learning_rate=lr, device=device, mesh=mesh, **kw)

    start = {k: v.to(device) for k, v in params.items()}
    n_epochs = perms.shape[1]
    out = {}
    stateful = StatefulClients(sim(optimizer=optim.adam(1e-3, eps=LOCAL_ADAM_EPS)))
    p, opt, losses = start, None, []
    for _ in range(2):
        res = stateful.run_round(p, opt, data, n_samples, n_epochs=n_epochs, perms=perms)
        p, opt = res.params, res.opt_states
        losses.append(res.loss_history)
    out["stateful, local adam(1e-3, eps 1e-5), 2 rounds"] = (p, torch.cat(losses))
    # buffer 2 of 3 in flight: step 1 completes clients 0 and 1, step 2
    # clients 2 (anchored before step 1) and 0
    size, concurrency = buffer
    c = int(len(n_samples))
    step_perms = (torch.stack([perms[[0, 1]], perms[[2, 0]]]) if buffer == (2, 3) else
                  torch.stack([perms[[(s * size + i) % c for i in range(size)]]
                               for s in range(2)]))
    fb = FedBuff(sim(regularizer=fedprox(0.1)), buffer_size=size, concurrency=concurrency)
    res = fb.run(start, data, n_samples, n_steps=2, n_epochs=n_epochs, perms=step_perms)
    out[f"fedbuff, fedprox 0.1, buffer {size} of {concurrency}, 2 steps"] = (
        {**res.params, "version": torch.tensor(float(res.version)),
         "mean_staleness": torch.tensor(res.mean_staleness)},
        torch.as_tensor(res.loss_history))
    fp = FedPer(sim(), personal=lambda name, leaf: name.startswith(CONFIG3_HEAD))
    res = fp.run_round(start, None, data, n_samples, n_epochs=n_epochs, perms=perms)
    out["fedper, pooler+head personal"] = (
        {**res.params, **{"personal/" + k: v for k, v in res.personal_state.items()}},
        res.loss_history)
    clusters = tree_stack([start, {k: v.to(device) for k, v in second.items()}])
    res = ClusteredFedSim(sim(), n_clusters=2).run_round(clusters, data, n_samples,
                                                         n_epochs=n_epochs, perms=perms)
    out["clustered, k=2"] = ({**res.cluster_params,
                              "assignments": torch.as_tensor(res.assignments).double()},
                             res.loss_history)
    return out


BOOKKEEPING = ("assignments", "version", "mean_staleness")  # held exactly, card against CPU


def variants_against_cpu(model, params, second, data, n_samples, batch, lr, perms,
                         device="cuda", shards=(None, None), buffer=(2, 3)):
    """Every variant of ``variant_runs`` on ``device`` against the same
    run on the CPU: params and losses within 1e-4, the CPU run moved, the
    bookkeeping (clustered assignments, FedBuff's version and staleness)
    equal. ``shards``: the clients meshes (card, CPU) of phase 22c."""
    card = variant_runs(model, params, second, data, n_samples, batch, lr, perms, device,
                        shards[0], buffer)
    cpu = variant_runs(model, params, second, data, n_samples, batch, lr, perms, "cpu",
                       shards[1], buffer)
    gaps = {}
    for name, (got, losses) in card.items():
        want, want_losses = cpu[name]
        err = max_gap(got, want)
        loss_err = float((torch.as_tensor(losses).cpu().double()
                          - torch.as_tensor(want_losses).double()).abs().max())
        moved = max(float((want[k].double() - params[k].double()).abs().max())
                    for k in params if k in want)
        print(f"  {name:48s} max |param diff| {err:.3e} (max |param change| {moved:.3e}), "
              f"max |loss diff| {loss_err:.3e}")
        check(moved > 0, f"{name}: the CPU run left the params unchanged")
        for key in BOOKKEEPING:
            if key in want:
                check(torch.equal(got[key].cpu(), want[key].cpu()),
                      f"{name}: {key} {got[key].tolist()} on the card, {want[key].tolist()} "
                      "on the CPU")
        check(err <= 1e-4, f"{name}: card and CPU params differ by {err:.3e} (tol 1e-4)")
        check(loss_err <= 1e-4, f"{name}: card and CPU losses differ by {loss_err:.3e}")
        gaps[name] = err
    return gaps


def small_variant_cohort():
    """Phase 15's (and 22c's) small fp32 cohort: a 2-layer BERT at
    BERT-base width, 4 clients of 16, 10, 16 and 0 samples, batch 8, one
    epoch's shuffles. Returns ``(model, data, n_samples, perms)``."""
    from baton_tpu_torch.core.training import random_perms
    from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    small = BertConfig(vocab_size=30522, max_len=128, d_model=768, n_layers=2, n_heads=12,
                       d_ff=3072, n_classes=4)
    rng = np.random.default_rng(5)
    datasets = []
    for n in (16, 10, 16, 0):
        lengths = rng.integers(16, small.max_len + 1, n)
        datasets.append({
            "x": rng.integers(0, small.vocab_size, (n, small.max_len)).astype(np.int32),
            "attn_mask": (np.arange(small.max_len)[None] < lengths[:, None]).astype(np.float32),
            "y": rng.integers(0, small.n_classes, n).astype(np.int32)})
    data, n_samples = stack_client_datasets(datasets, batch_size=8)
    perms = random_perms(4, 1, data["x"].shape[1], torch.Generator().manual_seed(6))
    return bert_classifier_model(small), data, n_samples, perms


def check_step_launches(name, by_pass, by_design, n_layers, steps, fwd_extra=0) -> dict:
    """Each flash kernel once per layer per training step (``fwd_extra``
    more forward launches, the clustered grid's), every one on mma.
    Returns ``by_pass``."""
    want = {"fwd": n_layers * (steps + fwd_extra), "bwd_dkv": n_layers * steps,
            "bwd_dq": n_layers * steps}
    check(by_pass == want, f"{name}: launches {by_pass}, want {want}")
    check(set(by_design) <= {"fwd_mma", "bwd_dkv_mma", "bwd_dq_mma"},
          f"{name}: launches by design {by_design}, want every launch on mma")
    return by_pass


def profiled(fn, label):
    """``fn()`` once under torch.profiler, tracing the device's kernels only
    (as 16a and 23a do): (result, ``device_breakdown``). The host's op
    events are not recorded: ``device_breakdown`` reads none of them, and
    reducing them took tens of seconds of phase 19 alone."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out, dt = timed(fn)
    print(f"  {label} under the profiler:")
    return out, device_breakdown(prof, dt)


def variants_phase(fa, phase3_peak_gb):
    """Phase 15: stateful clients, FedBuff, FedPer and clustered FL on
    phase 3's BERT-base (bf16 compute) and clients, then each at 2 layers
    in fp32 card against the CPU."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core import optim
    from baton_tpu_torch.core.training import random_perms
    from baton_tpu_torch.parallel import ClusteredFedSim, FedBuff, FedPer, StatefulClients
    from baton_tpu_torch.parallel.clustered import _masked_mean_loss

    n_clients, batch, lr = 8, 32, 0.01
    cfg, model, data, n_samples = bert_base_cohort(n_clients, batch)
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    n_samples = torch.as_tensor(n_samples, device="cuda")
    capacity, layers = data["x"].shape[1], cfg.n_layers
    torch.cuda.empty_cache()
    base = FedSim(model, batch_size=batch, learning_rate=lr)
    start = base.init(torch.Generator().manual_seed(0))
    model_gb = sum(v.numel() * v.element_size() for v in start.values()) / 1e9
    print(f"phase 15: the federation variants on phase 3's BERT-base ({cfg.n_layers} layers, "
          f"d {cfg.d_model}, bf16 compute, {model_gb:.3f} GB of fp32 params), {n_clients} "
          f"clients x {batch} samples, L={cfg.max_len}, batch {batch}, lr {lr}")

    def perms_for(seed, n_epochs=1, c=n_clients):
        return random_perms(c, n_epochs, capacity, torch.Generator().manual_seed(seed))

    def peak(label, estimate_gb, why):
        gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"  {label}: peak memory {gb:.2f} GB (estimate {estimate_gb:.2f} GB: {why})")
        return gb

    stats = {}
    # the launches of the variants' own runs (the rounds and steps below
    # whose counts are checked), without those of the checks beside them
    main = collections.Counter()

    # (a) stateful clients with local Adam, 3 rounds of 2 epochs
    n_epochs = 2
    steps = base.trainer.steps_per_round(capacity, n_epochs)
    adam_sim = FedSim(model, batch_size=batch, optimizer=optim.adam(1e-4))
    sc = StatefulClients(adam_sim)
    torch.cuda.reset_peak_memory_stats()
    p, opt, times = start, None, []
    for r in range(3):
        perms = perms_for(10 + r, n_epochs)
        before = launch_counts(fa)
        res, dt = timed(lambda: sc.run_round(p, opt, data, n_samples, n_epochs=n_epochs,
                                             perms=perms))
        main.update(check_step_launches(f"stateful round {r}", *launches_since(fa, before),
                                        layers, steps))
        loss = res.loss_history.tolist()
        check(all(math.isfinite(x) for x in loss), f"stateful round {r}: non-finite loss")
        if r == 0:
            first, first_perms = res.params, perms
        else:
            times.append(dt)
        print(f"  stateful round {r}: loss {loss} {dt:.4f} s")
        p, opt = res.params, res.opt_states
    count = opt["count"].tolist()
    check(count == [3 * steps] * n_clients, f"Adam's counts {count}, want {3 * steps} each")
    stats["stateful_round_s"] = times
    stats["stateful_peak_gb"] = peak(
        "stateful", phase3_peak_gb + 2 * n_clients * model_gb,
        f"phase 3's {phase3_peak_gb:.2f} plus 2 moments x {n_clients} clients x "
        f"{model_gb:.3f}")
    res, stats["stateful_breakdown"] = profiled(
        lambda: sc.run_round(p, opt, data, n_samples, n_epochs=n_epochs, perms=perms),
        "a stateful round")
    del res
    torch.cuda.reset_peak_memory_stats()
    engine = adam_sim.run_round(start, data, n_samples, n_epochs=n_epochs, perms=first_perms)
    stats["fedsim_adam_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gap = max_gap(first, engine.params)
    print(f"  stateful: s/round median {float(np.median(times)):.4f} ({times}); Adam's count "
          f"{count[0]} = 3 rounds x {steps} steps; round 0 against FedSim.run_round (same "
          f"Adam, same shuffles): max |param diff| {gap:.3e} (tol 1e-6); that FedSim round's "
          f"own peak {stats['fedsim_adam_peak_gb']:.2f} GB (it holds the same moments while "
          f"it runs)")
    check(gap <= 1e-6, f"stateful round 0 is {gap:.3e} from FedSim.run_round")
    del sc, adam_sim, p, opt, first, engine
    torch.cuda.empty_cache()

    # (b) FedBuff: buffer = concurrency = 8 at server_lr 1.0 is FedAvg in
    # the delta form; then buffer 4 of 8 in flight, alpha 0.5, 6 steps
    perms = perms_for(20)
    fb = FedBuff(base, buffer_size=n_clients, concurrency=n_clients, server_lr=1.0)
    res = fb.run(start, data, n_samples, n_steps=1, perms=perms[None])
    engine = base.run_round(start, data, n_samples, perms=perms)
    gap = max_gap(res.params, engine.params)
    print(f"  fedbuff buffer = concurrency = {n_clients}, server_lr 1.0, 1 step against "
          f"FedSim.run_round: max |param diff| {gap:.3e} (tol 1e-5)")
    check(gap <= 1e-5, f"the zero-staleness FedBuff step is {gap:.3e} from FedAvg")
    del res, engine
    torch.cuda.reset_peak_memory_stats()
    fb = FedBuff(base, buffer_size=4, concurrency=n_clients, alpha=0.5)
    stamps = []
    train_buffer = fb._train_buffer

    def stamped(*args, **kw):  # a step starts after the previous one's loss read-back
        stamps.append(time.perf_counter())
        return train_buffer(*args, **kw)

    fb._train_buffer = stamped
    n_steps = 6
    step_perms = torch.stack([perms_for(30 + s, c=4) for s in range(n_steps)])
    before = launch_counts(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fb.run(start, data, n_samples, n_steps=n_steps, perms=step_perms)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dt = t1 - t0
    main.update(check_step_launches("fedbuff 6 steps", *launches_since(fa, before), layers,
                                    n_steps))
    step_s = np.diff(stamps + [t1]).tolist()
    check(res.mean_staleness == 5 / 6, f"mean staleness {res.mean_staleness}, want 5/6")
    check(all(math.isfinite(x) for x in res.loss_history), "fedbuff: non-finite loss")
    stats["fedbuff_step_s"] = step_s
    stats["fedbuff_steps_per_s"] = n_steps / dt
    stats["fedbuff_peak_gb"] = peak(
        "fedbuff (buffer 4)", phase3_peak_gb / 2 + 4 * model_gb,
        f"half of phase 3's {phase3_peak_gb:.2f} (4 clients of 8) plus 4 stacked anchors x "
        f"{model_gb:.3f}")
    print(f"  fedbuff buffer 4 of {n_clients}, alpha 0.5, {n_steps} steps: mean staleness "
          f"{res.mean_staleness} (5/6), {n_steps / dt:.2f} steps/s, s/step median "
          f"{float(np.median(step_s)):.4f} ({', '.join(f'{t:.4f}' for t in step_s)}; each "
          f"ends in one loss read-back); losses {res.loss_history.tolist()}")
    fb._train_buffer = train_buffer
    _, stats["fedbuff_breakdown"] = profiled(
        lambda: fb.run(start, data, n_samples, n_steps=2, perms=step_perms[:2]),
        "2 fedbuff steps")
    del fb, res
    torch.cuda.empty_cache()

    # (c) FedPer, the pooler and the head personal, 3 rounds
    torch.cuda.reset_peak_memory_stats()
    fp = FedPer(base, personal=lambda name, leaf: name.startswith(CONFIG3_HEAD))
    p, pers, times = start, None, []
    for r in range(3):
        perms = perms_for(40 + r)
        before = launch_counts(fa)
        res, dt = timed(lambda: fp.run_round(p, pers, data, n_samples, perms=perms))
        main.update(check_step_launches(f"fedper round {r}", *launches_since(fa, before),
                                        layers, 1))
        if r == 0:
            engine = base.run_round(start, data, n_samples, perms=perms)
            trained, _ = base.trainer.train_clients(start, data, n_samples, 1, perms)
            shared = max_gap({k: v for k, v in res.params.items() if k not in res.personal_state},
                             {k: v for k, v in engine.params.items()
                              if k not in res.personal_state})
            personal = max_gap(res.personal_state, {k: trained[k] for k in res.personal_state})
            print(f"  fedper round 0: shared leaves against FedSim.run_round {shared:.3e}, "
                  f"personal rows against each client's trained head {personal:.3e} (tol 1e-6)")
            check(shared <= 1e-6 and personal <= 1e-6, "fedper round 0 is off its oracles")
            del engine, trained
        else:
            times.append(dt)
        p, pers = res.params, res.personal_state
    spread = max(float((pers[k] - pers[k][:1]).abs().max()) for k in pers)
    check(spread > 0, "the personal rows are equal across clients after 3 rounds")
    ev = fp.evaluate(p, pers, data, n_samples)
    check(math.isfinite(ev["loss"]), f"fedper evaluate: {ev}")
    stats["fedper_round_s"] = times
    stats["fedper_eval"] = ev
    stats["fedper_peak_gb"] = peak(
        "fedper", phase3_peak_gb, f"phase 3's {phase3_peak_gb:.2f}: the same stacked round")
    print(f"  fedper: s/round median {float(np.median(times)):.4f} ({times}); personal rows "
          f"differ by up to {spread:.3e}; evaluate {ev}")
    del fp, p, pers, res
    torch.cuda.empty_cache()

    # (d) clustered FL, K=2, 3 rounds (the first a warm-up); then two
    # equal clusters, which tie
    torch.cuda.reset_peak_memory_stats()
    cf = ClusteredFedSim(base, n_clusters=2)
    clusters = cf.init_clusters(torch.Generator().manual_seed(1))
    times, grid_gaps = [], []
    for r in range(3):
        perms = perms_for(50 + r)
        before = launch_counts(fa)
        grid = cf.loss_grid(clusters, data, n_samples)
        check_step_launches(f"clustered grid {r}", *launches_since(fa, before), layers, 0,
                            fwd_extra=1)
        with torch.no_grad():
            pairs = torch.tensor([[float(_masked_mean_loss(
                model, {k: v[j] for k, v in clusters.items()}, {k: v[i] for k, v in data.items()},
                n_samples[i])) for j in range(2)] for i in range(n_clients)])
        grid_gaps.append(float((grid.cpu() - pairs).abs().max()))
        before = launch_counts(fa)
        res, dt = timed(lambda: cf.run_round(clusters, data, n_samples, perms=perms))
        main.update(check_step_launches(f"clustered round {r}", *launches_since(fa, before),
                                        layers, 1, fwd_extra=1))
        check_cluster_assignments(res.assignments, pairs)
        mine = {k: v[torch.as_tensor(res.assignments, device="cuda")]
                for k, v in clusters.items()}
        trained, _, _ = base.trainer.train_stacked(
            mine, base.trainer.init_opt_states(start, n_clients), data, n_samples, 1, perms)
        gap = check_cluster_means(res.cluster_params, clusters, trained, res.assignments,
                                  n_samples.cpu())
        print(f"  clustered round {r}: assignments {res.assignments.tolist()}, grid against the "
              f"pairs one at a time {grid_gaps[-1]:.3e}, clusters against their clients' mean "
              f"{gap:.3e} (tol 1e-5), {dt:.4f} s")
        if r > 0:
            times.append(dt)
        clusters = res.cluster_params
        del mine, trained
    _, stats["clustered_breakdown"] = profiled(
        lambda: cf.run_round(clusters, data, n_samples, perms=perms), "a clustered round")
    tie = {k: torch.stack([v[0], v[0]]) for k, v in clusters.items()}
    res = cf.run_round(tie, data, n_samples, perms=perms_for(60))
    check(res.assignments.tolist() == [0] * n_clients,
          f"tied clusters assigned {res.assignments.tolist()}, want all to cluster 0")
    check(all(torch.equal(res.cluster_params[k][1], tie[k][1]) for k in tie),
          "the empty cluster changed")
    ev = cf.evaluate(clusters, data, n_samples)
    check(math.isfinite(ev["loss"]), f"clustered evaluate: {ev}")
    stats["clustered_round_s"] = times
    stats["clustered_grid_gaps"] = grid_gaps
    stats["clustered_eval"] = ev
    stats["clustered_peak_gb"] = peak(
        "clustered", phase3_peak_gb + 2 * model_gb,
        f"phase 3's {phase3_peak_gb:.2f} plus 2 clusters x {model_gb:.3f} (the {n_clients} "
        "gathered copies take the place of phase 3's broadcast)")
    print(f"  clustered: s/round median {float(np.median(times)):.4f} ({times}); tied "
          f"clusters all to cluster 0, the empty one bit-equal; evaluate {ev}")
    stats["launches"] = dict(main)
    del cf, clusters, tie, res, base, start
    torch.cuda.empty_cache()

    # the four at 2 layers in fp32, card against the CPU (phase 10's model)
    print("  2-layer fp32 BERT-base width, card against the CPU (tol 1e-4):")
    smodel, sdata, sn, perms = small_variant_cohort()
    before = launch_counts(fa)
    t0 = time.perf_counter()
    stats["cpu_gaps"] = variants_against_cpu(
        smodel, smodel.init(torch.Generator().manual_seed(3)),
        smodel.init(torch.Generator().manual_seed(4)), sdata, sn, 8, 0.01, perms)
    _, by_design = launches_since(fa, before)
    check(set(by_design) == set(design_keys(fa, torch.float32).values()),
          f"the fp32 card runs launched {by_design}, want the fp32 kernels")
    print(f"  the fp32 runs on the card and the CPU took {time.perf_counter() - t0:.1f} s")
    print(f"  launches over the variants' own BERT-base runs (stateful 3 rounds, fedbuff 6 "
          f"steps, fedper 3 rounds, clustered 3 rounds; not their checks) {stats['launches']}")
    return stats


# phase 16: the model zoo. BASELINE config 4 (examples/04_llama_lora.py
# --scale full: Llama-3-8B's width and depth, LoRA rank 16 on wq/wk/wv/wo)
# in bf16 with remat, as benchmarks/tpu_suite.py runs its config-4 stage;
# remat against none; ViT-B/16; the Shakespeare LSTM; the zoo's tiny
# models card against CPU; and the flash-vs-dense crossover on the card.

CONFIG4_CLIENTS, CONFIG4_PER_CLIENT = 4, 16  # cut from 64 x 512 (PERF.md §4)
CONFIG4_TIMED_ROUNDS = 1  # cut from 10: a warm-up, a timed round and a profiled one
CONFIG4_RANK, CONFIG4_BATCH = 16, 8
CONFIG4_HEADROOM = 0.85  # the share of the card a wave's estimate may fill
REMAT_TOL = 1e-6  # loss and adapter gradients, remat against none, fp32
ZOO_CPU_TOL = 1e-4  # the zoo's tiny fp32 rounds, card against the CPU
SWEEP_LENGTHS = (128, 256, 512, 1024, 2048, 4096)
SWEEP_TOKENS = 8192  # batch x L of every sweep point: Llama's batch 8 at L 1024
LLAMA_ATTENTION = (8, 32, 8, 1024, 128)  # B, Hq, Hkv, L, D of Llama-3-8B at batch 8


def lora_train_flops(n_params: int, tokens: int) -> float:
    """Adapters-only LoRA training FLOPs (``benchmarks/tpu_suite.py``'s
    model FLOPs): the forward 2·P·N plus the activation backward through
    the frozen base 2·P·N, no base weight gradients, and no remat
    recompute (that is hardware work, not model work)."""
    return 4.0 * n_params * tokens


def config4_memory_estimate(cfg, batch: int, wave: int, rank: int) -> dict:
    """Analytic peak device bytes of a bf16 remat LoRA round: the fp32
    params, and per client of a wave the merged fp32 target weights and
    the block inputs (both kept as remat inputs), one sequence's fp32
    logits with their log-softmax and gradient (the remat head runs a
    sequence at a time), and one block's recomputed activations (~180 KB
    a token in bf16)."""
    d, hd, layers = cfg.d_model, cfg.head_dim, cfg.n_layers
    tokens = batch * cfg.max_len
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd  # wq, wo, wk, wv
    per_layer = attn + 3 * d * cfg.d_ff + 2 * d
    base = 4 * (2 * cfg.vocab_size * d + layers * per_layer + d)
    adapters = 4 * layers * rank * (2 * (d + cfg.n_heads * hd) + 2 * (d + cfg.n_kv_heads * hd))
    client = {"merged_targets": 4 * layers * attn,
              "block_inputs": 2 * layers * tokens * d,
              "logits_x3": 3 * 4 * cfg.max_len * cfg.vocab_size,
              "block_recompute": 180 * 1024 * tokens}
    per_client = sum(client.values())
    return {"base": base, "adapters": adapters, "per_client": per_client,
            "client_parts": client, "total": base + adapters + wave * per_client}


def config4_wave(cfg, batch, rank, n_clients, device_bytes) -> int:
    """The largest wave that divides the cohort (no phantom clients) and
    whose estimate fits CONFIG4_HEADROOM of the card; at least 1."""
    fits = [w for w in range(1, n_clients + 1) if n_clients % w == 0
            and config4_memory_estimate(cfg, batch, w, rank)["total"]
            <= CONFIG4_HEADROOM * device_bytes]
    return max(fits, default=1)


def check_frozen_bit_equal(params, host_copy) -> int:
    """Every frozen tensor against its host copy, one at a time (no second
    copy of the base on the card; a tensor placed over a model axis is
    gathered first). Returns the number compared."""
    from baton_tpu_torch.parallel.tensor_parallel import gather_params

    for name, before in host_copy.items():
        check(torch.equal(gather_params(params[name]).to("cpu"), before),
              f"frozen tensor {name} changed")
    return len(host_copy)


def config4_phase(fa, name):
    """Phase 16a: BASELINE config 4 at Llama-3-8B width and depth, bf16,
    remat, 4 clients x 16 samples (2 steps each), one wave of what fits;
    a warm-up, the timed rounds and a profiled one. Returns the launches,
    a round's launches, the stats and the context phase 23a continues from
    (the params on the card and the frozen base's host copy: 23a checks the
    base bit-equal after 16a's rounds and its own)."""
    from baton_tpu_torch.examples import llama_lora
    from baton_tpu_torch.models.lora import lora_trainable
    from baton_tpu_torch.obs.compute import card_peaks

    cfg, batch, rank = llama_lora.FULL_CONFIG, CONFIG4_BATCH, CONFIG4_RANK
    n_clients, per_client = CONFIG4_CLIENTS, CONFIG4_PER_CLIENT
    sim, model = llama_lora.make_sim(cfg, rank, batch, "cuda", compute_dtype=torch.bfloat16,
                                     remat=True)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = timed(lambda: sim.init(torch.Generator(device="cuda").manual_seed(0)))
    n_params = sum(v.numel() for v in params.values())
    n_adapter = sum(v.numel() for k, v in params.items() if lora_trainable(k, v))
    t0 = time.perf_counter()
    host_copy = {k: v.to("cpu", copy=True) for k, v in params.items() if not lora_trainable(k, v)}
    copy_s = time.perf_counter() - t0
    data, n_samples = llama_lora.client_data(cfg, n_clients, per_client, batch, seed=0)
    device_bytes = torch.cuda.get_device_properties(0).total_memory
    wave = config4_wave(cfg, batch, rank, n_clients, device_bytes)
    estimate = config4_memory_estimate(cfg, batch, wave, rank)
    steps = per_client // batch
    n_waves = -(-n_clients // wave)
    tokens = n_clients * per_client * cfg.max_len
    print(f"phase 16a: BASELINE config 4 at Llama-3-8B width and depth (vocab {cfg.vocab_size}, "
          f"d {cfg.d_model}, {cfg.n_layers} layers, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
          f"{cfg.d_ff}, L {cfg.max_len}; {n_params / 1e9:.3f} B params, {n_adapter / 1e6:.2f} M "
          f"adapters, LoRA rank {rank}), bf16, remat; cut from 64 clients x 512 samples and 10 "
          f"rounds to {n_clients} x {per_client} ({steps} steps each) and a warm-up, "
          f"{CONFIG4_TIMED_ROUNDS} timed rounds and a profiled one; wave {wave} of "
          f"{n_clients} (the largest divisor of the cohort whose estimate fits 85% of "
          f"{device_bytes / 1e9:.1f} GB)")
    print(f"  init on the card {init_s:.1f} s, host copy of the frozen base {copy_s:.1f} s")
    gen = torch.Generator().manual_seed(1)
    profiled_round = CONFIG4_TIMED_ROUNDS + 1
    times, losses, breakdown = [], [], None
    start = params
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    for r in range(profiled_round + 1):
        before = launch_counts(fa)
        # the device's kernels only: the host's ops make the trace slow to reduce
        activities = [torch.profiler.ProfilerActivity.CUDA]
        with (torch.profiler.profile(activities=activities) if r == profiled_round
              else contextlib.nullcontext()) as prof:
            res, dt = timed(lambda: sim.run_round(params, data, n_samples, gen,
                                                  wave_size=wave))
        params = res.params
        loss = res.loss_history.tolist()
        losses.extend(loss)
        delta, by_design = launches_since(fa, before)
        label = {0: " (warm-up)", profiled_round: " (profiled)"}.get(r, "")
        print(f"  round {r}{label}: loss {loss} {dt:.3f} s launches {delta} by design "
              f"{by_design}")
        check(all(math.isfinite(x) for x in loss), f"config 4 round {r}: non-finite loss")
        # remat runs each block's forward again in the backward pass: the
        # forward kernel launches twice a layer a step
        wave_steps = n_waves * steps
        check_step_launches(f"config 4 round {r}", delta, by_design, cfg.n_layers, wave_steps,
                            fwd_extra=wave_steps)
        if r == profiled_round:
            breakdown = device_breakdown(prof, dt)
        elif r > 0:
            times.append(dt)
    per_round = delta
    launches = fa.launches()
    peak = torch.cuda.max_memory_allocated()
    moved = max((params[k] - start[k]).abs().max().item() for k in params
                if lora_trainable(k, params[k]))
    check(moved > 0, "config 4: the adapters did not move")
    s_median = float(np.median(times))
    flops = lora_train_flops(n_params, tokens)
    bw, peak_flops = card_peaks(name)
    mfu = flops / s_median / peak_flops
    print(f"  adapters moved by up to {moved:.3e} (the frozen base is checked after phase 23a)")
    print(f"  s/round median {s_median:.3f} ({', '.join(f'{t:.3f}' for t in times)}); "
          f"{tokens / s_median:.1f} tokens/s; MFU {mfu:.4f} (4·P·tokens = {flops:.4e} FLOP a "
          f"round over {peak_flops / 1e12:.0f} TFLOP/s; the remat recompute not counted)")
    print(f"  peak memory {peak / 1e9:.2f} GB against the estimate {estimate['total'] / 1e9:.2f} "
          f"GB (base {estimate['base'] / 1e9:.2f}, per client {estimate['per_client'] / 1e9:.2f}: "
          + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in estimate["client_parts"].items()) + ")")
    print(f"  launches over the path {launches}; a round {per_round}")
    del start, res
    torch.cuda.empty_cache()
    ctx = {"sim": sim, "model": model, "params": params, "host_copy": host_copy, "data": data,
           "n_samples": n_samples, "wave": wave, "steps": steps, "n_params": n_params,
           "tokens": tokens, "rounds_before": profiled_round + 1, "peak_memory_gb": peak / 1e9,
           "per_round": per_round}
    return launches, per_round, {
        "n_params": n_params, "n_adapter": n_adapter, "wave": wave, "n_waves": n_waves,
        "steps_per_round": n_waves * steps, "round_s": times, "s_per_round_median": s_median,
        "tokens_per_s": tokens / s_median, "mfu": mfu, "flops_per_round": flops,
        "peak_memory_gb": peak / 1e9, "estimate_gb": estimate["total"] / 1e9,
        "losses": losses, "init_s": init_s, "breakdown": breakdown}, ctx


def remat_grads(model, params, batch):
    """(loss, adapter gradients) of the mean loss, the base held frozen."""
    from baton_tpu_torch.core.partition import make_partition
    from baton_tpu_torch.models.lora import lora_trainable

    part = make_partition(params, lora_trainable)
    trainable, frozen = part.split(params)
    grads, loss = torch.func.grad_and_value(
        lambda t: model.per_example_loss(part.merge(t, frozen), batch).mean())(trainable)
    return loss, grads


def remat_phase():
    """Phase 16b: remat at Llama-3-8B width, 2 layers: the fp32 loss and
    adapter gradients with and without remat within REMAT_TOL; then the
    peak memory of one bf16 gradient of batch 8 x 1024 with remat below
    the peak without."""
    from baton_tpu_torch.examples import llama_lora
    from baton_tpu_torch.models.llama import llama_lm_model, llama_lora_target
    from baton_tpu_torch.models.lora import lora_wrap

    cfg = dataclasses.replace(llama_lora.FULL_CONFIG, n_layers=2)

    def build(remat, dtype):
        return lora_wrap(llama_lm_model(cfg, compute_dtype=dtype, remat=remat),
                         rank=CONFIG4_RANK, target=llama_lora_target)

    params = build(False, torch.float32).init(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    for k in params:  # nonzero B: every adapter gets a gradient
        if k.endswith("/b"):
            params[k] = 0.01 * torch.randn(params[k].shape, generator=gen, device="cuda")
    print(f"phase 16b: remat at Llama-3-8B width, {cfg.n_layers} layers")
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 256)),
                           device="cuda")
    small = {"x": toks, "y": toks.roll(-1, 1)}
    (l0, g0), (l1, g1) = (remat_grads(build(r, torch.float32), params, small)
                          for r in (False, True))
    gap = max((g1[k] - g0[k]).abs().max().item() for k in g0)
    scale = max(g0[k].abs().max().item() for k in g0)
    loss_gap = abs(l1.item() - l0.item())
    print(f"  fp32, batch 2 x 256: loss {l0.item():.6f}, gap {loss_gap:.3e}; adapter "
          f"gradients max |gap| {gap:.3e} at max |grad| {scale:.3e} (tol {REMAT_TOL})")
    check(loss_gap <= REMAT_TOL * max(1.0, abs(l0.item())), f"remat loss gap {loss_gap:.3e}")
    check(all(torch.allclose(g1[k], g0[k], rtol=REMAT_TOL, atol=REMAT_TOL) for k in g0),
          f"remat adapter gradients differ by {gap:.3e}")
    del g0, g1
    data, _ = llama_lora.client_data(cfg, 1, CONFIG4_BATCH, CONFIG4_BATCH, seed=3)
    full = {k: torch.as_tensor(v[0], device="cuda") for k, v in data.items()}
    peaks = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = remat_grads(build(remat, torch.bfloat16), params, full)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 1e9
        check(math.isfinite(loss.item()), "remat bf16 loss is not finite")
        del loss, grads
    print(f"  bf16, batch {CONFIG4_BATCH} x {cfg.max_len}: one gradient's peak above the params "
          f"{peaks[False]:.2f} GB without remat, {peaks[True]:.2f} GB with")
    check(peaks[True] < peaks[False], "remat did not lower the peak memory")
    del params
    torch.cuda.empty_cache()
    return {"grad_gap": gap, "grad_scale": scale, "loss_gap": loss_gap,
            "peak_gb_no_remat": peaks[False], "peak_gb_remat": peaks[True]}


def vit_phase(fa):
    """Phase 16c: ViT-B/16 (100 classes, bf16), 4 clients x 16 images of
    224 px, batch 16 (the suite's non-DP shape): a warm-up and 3 timed
    rounds, flash once per layer per step on mma at L = 197."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.vit import ViTConfig, vit_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    cfg = ViTConfig.b16(n_classes=100)
    n_clients, batch = 4, 16
    model = vit_model(cfg, compute_dtype=torch.bfloat16)
    sim = FedSim(model, batch_size=batch, learning_rate=0.01)
    params = sim.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    data, n_samples = stack_client_datasets([{
        "x": rng.normal(size=(batch, cfg.image_size, cfg.image_size, cfg.channels)
                        ).astype(np.float32),
        "y": rng.integers(0, cfg.n_classes, (batch,)).astype(np.int32)}
        for _ in range(n_clients)], batch_size=batch)
    n_params = sum(v.numel() for v in params.values())
    print(f"phase 16c: ViT-B/16 ({n_params / 1e6:.1f} M params, {cfg.n_classes} classes, bf16), "
          f"{n_clients} clients x {batch} images of {cfg.image_size} px, L {cfg.n_patches + 1}")
    gen = torch.Generator().manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for r in range(4):
        before = launch_counts(fa)
        res, dt = timed(lambda: sim.run_round(params, data, n_samples, gen))
        params = res.params
        delta, by_design = launches_since(fa, before)
        loss = res.loss_history.tolist()
        print(f"  round {r}{' (warm-up)' if r == 0 else ''}: loss {loss} {dt:.4f} s launches "
              f"{delta} by design {by_design}")
        check(all(math.isfinite(x) for x in loss), f"vit round {r}: non-finite loss")
        check_step_launches(f"vit round {r}", delta, by_design, cfg.n_layers, 1)
        if r:
            times.append(dt)
    peak = torch.cuda.max_memory_allocated() / 1e9
    s_median = float(np.median(times))
    print(f"  s/round median {s_median:.4f} ({', '.join(f'{t:.4f}' for t in times)}), "
          f"{n_clients * batch / s_median:.1f} images/s; peak memory {peak:.2f} GB")
    return {"round_s": times, "s_per_round_median": s_median, "peak_memory_gb": peak,
            "n_params": n_params}


def lstm_phase():
    """Phase 16d: example 07's --scale full preset for one round (cut from
    50): 64 clients x 256 sequences of 80 chars, batch 32, the 2 x 256
    LSTM in fp32; a warm-up round and two timed ones (no profiled round:
    the profiler's processing of its tens of thousands of small kernels
    took about a minute)."""
    from baton_tpu_torch.examples import lstm_shakespeare as ex
    from baton_tpu_torch.models.lstm import LSTMConfig

    cfg, full = LSTMConfig.shakespeare(), ex.FULL
    t0 = time.perf_counter()
    data, n_samples = ex.client_data(cfg, full["n_clients"], full["n_per_client"],
                                     full["seq_len"], full["batch_size"], seed=0)
    data_s = time.perf_counter() - t0
    sim = ex.make_sim(cfg, full["batch_size"], "cuda")
    params = sim.init(torch.Generator(device="cuda").manual_seed(0))
    print(f"phase 16d: example 07's full preset, 1 round of 50 ({full['n_clients']} clients x "
          f"{full['n_per_client']} sequences, L {full['seq_len']}, batch {full['batch_size']}, "
          f"LSTM {cfg.n_layers} x {cfg.d_hidden}, fp32); data made in {data_s:.1f} s")
    gen = torch.Generator().manual_seed(1)
    (warm, warm_s) = timed(lambda: sim.run_round(params, data, n_samples, gen))
    res, dt = timed(lambda: sim.run_round(warm.params, data, n_samples, gen))
    last, dt2 = timed(lambda: sim.run_round(res.params, data, n_samples, gen))
    loss = res.loss_history.tolist()
    check(all(math.isfinite(x) for x in loss), "lstm: non-finite loss")
    check(float(last.loss_history[-1]) < float(warm.loss_history[0]),
          "lstm: the loss did not fall over three rounds")
    print(f"  warm-up {warm_s:.3f} s, rounds {dt:.3f} and {dt2:.3f} s (loss {loss}); a step is "
          f"a Python loop over {full['seq_len']} time steps x {cfg.n_layers} layers")
    return {"round_s": [dt, dt2], "warm_up_s": warm_s, "data_s": data_s,
            "losses": [float(warm.loss_history[0]), loss[0], float(last.loss_history[0])]}


def zoo_parity_phase():
    """Phase 16e: one fp32 round of each tiny zoo model on the card against
    the same round on the CPU (same weights and shuffles), ZOO_CPU_TOL."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core.training import random_perms
    from baton_tpu_torch.examples import llama_lora, lstm_shakespeare
    from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model
    from baton_tpu_torch.models.lora import lora_trainable
    from baton_tpu_torch.models.lstm import LSTMConfig
    from baton_tpu_torch.models.moe import MoEConfig, moe_capacity
    from baton_tpu_torch.models.vit import ViTConfig, vit_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    # head dim 64: the kernels take 64 or 128
    tiny = LlamaConfig.tiny(d_model=128, n_heads=2, n_kv_heads=1)
    # capacity 0.5: ceil(0.5 · 2 · 32 / 4) = 8 slots an expert for 64 choices
    moe = MoEConfig(n_experts=4, top_k=2, capacity_factor=0.5)
    check(moe_capacity(moe, tiny.max_len) * moe.n_experts < moe.top_k * tiny.max_len,
          "the MoE case must drop tokens")
    rng = np.random.default_rng(0)
    vit_cfg = ViTConfig.tiny(d_model=128, n_heads=2)
    vit_data = stack_client_datasets([{
        "x": rng.normal(size=(n, 16, 16, 3)).astype(np.float32),
        "y": rng.integers(0, 10, (n,)).astype(np.int32)} for n in (6, 0, 8)], batch_size=4)
    llama_data = llama_lora.client_data(tiny, 3, 8, 4, seed=0)
    lstm_cfg = LSTMConfig.tiny(vocab_size=16)
    cases = {
        "tiny llama + lora": (llama_lora.make_sim(tiny, 4, 4, "cpu")[0].model,
                              llama_data, 4, 1e-2, {"trainable": lora_trainable}),
        "tiny llama moe (tokens dropped)": (
            llama_lm_model(dataclasses.replace(tiny, moe=moe)), llama_data, 4, 5e-2, {}),
        "tiny vit": (vit_model(vit_cfg), vit_data, 4, 5e-2, {}),
        "tiny lstm": (lstm_shakespeare.make_sim(lstm_cfg, 8, "cpu").model,
                      lstm_shakespeare.client_data(lstm_cfg, 4, 16, 24, 8), 8, 0.5, {}),
    }
    print(f"phase 16e: the zoo's tiny models, one fp32 round each, card against the CPU "
          f"(tol {ZOO_CPU_TOL})")
    errs = {}
    for label, (model, (data, n_samples), batch, lr, kw) in cases.items():
        params = model.init(torch.Generator().manual_seed(0))
        if "trainable" in kw:  # nonzero B, so the adapters' A moves too
            params = {k: (v + 0.05 if k.endswith("/b") else v) for k, v in params.items()}
        perms = random_perms(len(n_samples), 2, data["x"].shape[1],
                             torch.Generator().manual_seed(1))
        results = []
        for dev in ("cuda", "cpu"):
            sim = FedSim(model, batch_size=batch, learning_rate=lr, device=dev, **kw)
            results.append(sim.run_round({k: v.to(dev) for k, v in params.items()}, data,
                                         n_samples, n_epochs=2, perms=perms))
        errs[label] = compare_rounds(label, *results, params, tol=ZOO_CPU_TOL)
    return errs


def write_sweep(path, device_kind, results) -> dict:
    """The sweep in ``benchmarks/attention_sweep.py``'s record shape."""
    payload = {"platform": "gpu", "device_kind": device_kind,
               "shape": {"tokens": SWEEP_TOKENS, "heads": 32, "kv_heads": 8, "head_dim": 128,
                         "dtype": "bfloat16", "causal": True,
                         "measure": "fwd+bwd(q,k,v), CUDA events, median of 5 readings"},
               "results": results}
    Path(path).write_text(json.dumps(payload, indent=2))
    return payload


def sweep_crossover(results):
    """The smallest L whose flash time beats the dense one, or None."""
    for rec in sorted(results, key=lambda r: r["L"]):
        if min(rec["flash"].values()) < rec["dense_ms"]:
            return rec["L"]
    return None


def crossover_phase(name, out_dir):
    """Phase 16f: dense ``dot_product_attention`` against ``flash_attention``
    at Llama's head shape (32/8 heads, D 128, bf16, causal), forward plus
    backward, SWEEP_TOKENS tokens a call; the sweep goes to a file that
    ``configure_attention_dispatch`` must read the same crossover from.
    The dispatch is restored after (``_FLASH_MIN_LEN`` stays 0)."""
    from baton_tpu_torch.models import transformer as T
    from baton_tpu_torch.ops.flash_attention import flash_attention

    print(f"phase 16f: the flash-vs-dense crossover at Llama's head shape (32/8 heads, D 128, "
          f"bf16, causal, fwd+bwd, {SWEEP_TOKENS} tokens a call)")
    results = []
    for l in SWEEP_LENGTHS:
        b = SWEEP_TOKENS // l
        q, k, v, dout, _ = attention_inputs(11, b, 32, 8, l, 128, torch.bfloat16, None)
        q, k, v = (t.requires_grad_() for t in (q, k, v))

        def step(fn):
            return lambda: torch.autograd.grad(fn(q, k, v, causal=True), (q, k, v), dout)

        dense_ms = time_ms(step(T.dot_product_attention), iters=5)
        flash_ms = time_ms(step(flash_attention), iters=5)
        results.append({"L": l, "batch": b, "dense_ms": dense_ms, "flash": {"64x64": flash_ms}})
        print(f"  L {l:5d} (batch {b:3d}): dense {dense_ms:.4f} ms, flash {flash_ms:.4f} ms "
              f"({dense_ms / flash_ms:.2f}x)")
        del q, k, v, dout
    path = Path(out_dir) / "attention_sweep_gpu.json"
    write_sweep(path, name, results)
    crossover = sweep_crossover(results)
    orig = (T._FLASH_MIN_LEN, T._FLASH_BLOCKS)
    try:
        read = T.configure_attention_dispatch(sweep_path=str(path))
    finally:
        T._FLASH_MIN_LEN, T._FLASH_BLOCKS = orig
    want = orig if crossover is None else (crossover, T.KERNEL_BLOCKS)
    print(f"  crossover {crossover}; configure_attention_dispatch read {read} from {path.name}; "
          f"the dispatch stays at {orig} (_FLASH_MIN_LEN is not adopted in this run)")
    check(read == want, f"configure_attention_dispatch read {read}, the sweep says {want}")
    return {"results": results, "crossover": crossover}


def attention_times(fa, name, label, b, hq, hkv, l, d, causal, bias_kind, seed,
                    dtype=torch.bfloat16):
    """Kernel, plain and SDPA times at one attention shape and the card's
    bound, counting only the (query, key) pairs a causal mask keeps (the
    kernels skip tiles wholly in the future). The operations bound is the
    FLOPs over bf16's peak, or for fp32 the lesser of the CUDA cores' time
    and that of three TF32 products on the tensor cores (3xTF32: fp32's
    accuracy), each kept beside it; an fp32 call adds a row ``bwd_pair``:
    the two backward kernels called back to back against SDPA's backward."""
    import torch.nn.functional as F

    from baton_tpu_torch.obs.compute import card_peaks

    q, k, v, dout, bias = attention_inputs(seed, b, hq, hkv, l, d, dtype, bias_kind)
    scale = d ** -0.5
    out, lse = fa._fwd_plain(q, k, v, bias, causal, scale)
    delta = (dout.float() * out.float()).sum(-1)
    args = (q, k, v, bias, dout, lse, delta, causal, scale)
    sdpa_kw = ({"is_causal": True} if causal else {} if bias_kind is None
               else {"attn_mask": bias[:, None, None, :].to(q.dtype)})

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=hq != hkv, **sdpa_kw)

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=hq != hkv, **sdpa_kw)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qg, kg, vg), dout, retain_graph=True)

    timed_fns = {
        "flash_fwd": (lambda: fa._fwd(q, k, v, bias, causal, scale),
                      lambda: fa._fwd_plain(q, k, v, bias, causal, scale), sdpa),
        "flash_bwd_dkv": (lambda: fa._bwd_dkv(*args), lambda: fa._bwd_dkv_plain(*args),
                          sdpa_bwd),
        "flash_bwd_dq": (lambda: fa._bwd_dq(*args), lambda: fa._bwd_dq_plain(*args), sdpa_bwd),
    }
    el = q.element_size()
    q_el, kv_el, rows, bias_b = b * hq * l * d, b * hkv * l * d, b * hq * l, 4 * b * l
    pairs = b * hq * (l * (l + 1) // 2 if causal else l * l)  # the (query, key) pairs computed
    work = {  # bytes each input read once and each output written once, FLOPs
        "flash_fwd": (el * (2 * q_el + 2 * kv_el) + bias_b + 4 * rows, 4 * pairs * d),
        "flash_bwd_dkv": (el * (2 * q_el + 2 * kv_el) + bias_b + 8 * rows + 8 * q_el + 4 * rows,
                          8 * pairs * d),
        "flash_bwd_dq": (el * (2 * q_el + 2 * kv_el) + bias_b + 8 * rows + 4 * q_el,
                         6 * pairs * d),
    }
    if dtype == torch.float32:
        timed_fns["bwd_pair"] = (lambda: (fa._bwd_dkv(*args), fa._bwd_dq(*args)),
                                 lambda: (fa._bwd_dkv_plain(*args), fa._bwd_dq_plain(*args)),
                                 sdpa_bwd)
        work["bwd_pair"] = tuple(map(sum, zip(work["flash_bwd_dkv"], work["flash_bwd_dq"])))
    bw, bf16_peak = card_peaks(name)
    print(f"times at {label}'s shape: B={b}, Hq={hq}, Hkv={hkv}, L={l}, D={d}, "
          f"{'causal' if causal else 'not causal'}, bias {bias_kind}, {str(dtype)[6:]}"
          + ("; the bound counts the causal half" if causal else ""))
    out_rows = {}
    for kname, (kernel, plain, library) in timed_fns.items():
        ms, plain_ms, library_ms = time_ms(kernel), time_ms(plain, iters=3), time_ms(library)
        nbytes, flops = work[kname]
        t_bytes = nbytes / bw * 1e3
        if dtype == torch.bfloat16:
            t_ops, fp32_bounds = flops / bf16_peak * 1e3, {}
        else:  # fp32: on the CUDA cores, or in three TF32 products on the tensor cores
            fp32_bounds = {"bound_ms_fp32_cores": max(t_bytes, flops / FP32_PEAK * 1e3),
                           "bound_ms_3xtf32": max(t_bytes, 3 * flops / TF32_PEAK * 1e3)}
            t_ops = min(flops / FP32_PEAK, 3 * flops / TF32_PEAK) * 1e3
            fp32_bounds.update({f"bound_share_{k[len('bound_ms_'):]}": v / ms
                                for k, v in list(fp32_bounds.items())})
        out_rows[kname] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                           "bound_ms": max(t_bytes, t_ops),
                           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                           "bytes": nbytes, "flops": flops,
                           "bound_share": max(t_bytes, t_ops) / ms, **fp32_bounds}
        print(f"  {kname}: {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms by {out_rows[kname]['bound_by']} "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
              f"{100 * max(t_bytes, t_ops) / ms:.1f}% of the bound"
              + "".join(f"; {k} {v:.4f} ({100 * v / ms:.1f}%)" for k, v in fp32_bounds.items()
                        if k.startswith("bound_ms"))
              + ")")
    return out_rows


def llama_timing_phase(fa, name):
    """Kernel, plain and SDPA times at Llama-3-8B's attention shape (B 8,
    32/8 heads, L 1024, D 128, causal, no bias, bf16) and the card's bound."""
    return attention_times(fa, name, "Llama", *LLAMA_ATTENTION, causal=True, bias_kind=None,
                           seed=13)


# phases 17-20: BASELINE config 5 (ViT-B/16 with DP-SGD and secure
# aggregation, examples/05_vit_dp_secure.py --scale full in bf16 with remat,
# as benchmarks/tpu_suite.py's vit_dp stage runs it), the wave sizer
# against the allocator, run_rounds_fused as a CUDA graph, and examples 02
# and 09 on the card.

CONFIG5_CLIENTS, CONFIG5_PER_CLIENT = 4, 128  # cut from 16 x 4,096 (PERF.md §4)
CONFIG5_TIMED_ROUNDS = 2  # cut from 20: a warm-up, 2 timed rounds and a profiled one
CONFIG5_BATCH, CONFIG5_CLIP, CONFIG5_SIGMA, CONFIG5_DELTA = 64, 1.0, 0.5, 1e-5
NOISE_REPLAY_TOL = 1e-5  # relative: noised minus quiet gradients against sigma·clip·N/64
FUSED_TOL = 1e-5  # fused rounds against run_rounds, params and losses
FUSED_ROUNDS = 4


def config5_cohort():
    """Phase 17's ViT-B/16 (1,000 classes, bf16 compute, remat) DP sim and
    its clients, drawn as the example draws them (numpy seed 0). Returns
    ``(cfg, sim, params, data, n_samples, rng)``; ``rng`` then draws the
    Poisson cohorts."""
    from baton_tpu_torch.examples import vit_dp_secure as ex
    from baton_tpu_torch.models.vit import ViTConfig
    from baton_tpu_torch.ops.padding import stack_client_datasets

    cfg = ViTConfig.b16()
    rng = np.random.default_rng(0)
    data, n_samples = stack_client_datasets(
        ex.make_data(rng, cfg, CONFIG5_CLIENTS, CONFIG5_PER_CLIENT), batch_size=CONFIG5_BATCH)
    sim = ex.make_sim(cfg, CONFIG5_BATCH, CONFIG5_CLIP, CONFIG5_SIGMA, remat=True,
                      compute_dtype=torch.bfloat16, device="cuda")
    params = sim.init(torch.Generator(device="cuda").manual_seed(0))
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    return cfg, sim, params, data, torch.as_tensor(n_samples, device="cuda"), rng


def noise_replay_gap(trainer, params, batch, seed) -> float:
    """One DP step of ``trainer`` on ``batch`` (leaves [C, B, ...]) with the
    noise a generator seeded ``seed`` gives, minus the same step at sigma
    0, against ``sigma·clip·N / B``: the largest gap over the largest
    expected value (relative)."""
    from baton_tpu_torch.core.training import noise_generator, stack_copies
    from baton_tpu_torch.ops.privacy import DPConfig, gaussian_noise_like

    c, b = batch["mask"].shape
    stacked = stack_copies(params, c)
    dp = trainer.dp
    normals = gaussian_noise_like(stacked, 1.0, noise_generator(
        torch.Generator().manual_seed(seed), next(iter(params.values())).device))
    quiet = dataclasses.replace(trainer, dp=DPConfig(dp.clip_norm, 0.0))
    noised = torch.func.vmap(trainer._dp_grads, in_dims=(0, None, None, 0, 0))(
        stacked, None, None, batch, normals)[0]
    plain = torch.func.vmap(quiet._dp_grads, in_dims=(0, None, None, 0, None))(
        stacked, None, None, batch, None)[0]
    gap = scale = 0.0
    for k, n in normals.items():
        want = dp.noise_multiplier * dp.clip_norm * n / b
        gap = max(gap, (noised[k].float() - plain[k].float() - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
    return gap / scale


def dp_parity_against_cpu(fa) -> dict:
    """A 2-layer ViT-B/16-width DP round (fp32, sigma 0, clip 1.0) on the
    card against the same round on the CPU: 2 clients (8 and 5 images,
    batch 4), same weights and shuffles; params and losses within
    ``ZOO_CPU_TOL``, the fp32 kernels once per layer per step."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.vit import ViTConfig, vit_model
    from baton_tpu_torch.ops.padding import stack_client_datasets
    from baton_tpu_torch.ops.privacy import DPConfig

    cfg = ViTConfig.b16(n_layers=2)
    rng = np.random.default_rng(5)
    datasets = [{"x": rng.normal(size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
                 "y": rng.integers(0, cfg.n_classes, n).astype(np.int32)} for n in (8, 5)]
    data, n_samples = stack_client_datasets(datasets, batch_size=4)
    perms = torch.from_numpy(np.stack([rng.permutation(8)[None] for _ in datasets]))
    model = vit_model(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    kw = dict(batch_size=4, learning_rate=0.05, dp=DPConfig(CONFIG5_CLIP, 0.0))
    before = launch_counts(fa)
    card = FedSim(model, **kw).run_round({k: v.cuda() for k, v in params.items()}, data,
                                         n_samples, perms=perms)
    by_pass, by_design = launches_since(fa, before)
    cpu = FedSim(model, device="cpu", **kw).run_round(params, data, n_samples, perms=perms)
    err = max((card.params[k].cpu() - cpu.params[k]).abs().max().item() for k in params)
    loss_err = (card.loss_history.cpu() - cpu.loss_history).abs().max().item()
    moved = max((cpu.params[k] - params[k]).abs().max().item() for k in params)
    print(f"  2-layer fp32 DP round (sigma 0) card against the CPU: max |param diff| {err:.3e}, "
          f"loss {loss_err:.3e} (tol {ZOO_CPU_TOL}; max |param change| {moved:.3e}); launches "
          f"{by_pass} by design {by_design}")
    check(err <= ZOO_CPU_TOL and loss_err <= ZOO_CPU_TOL,
          f"DP round card against CPU: params {err:.3e}, loss {loss_err:.3e}")
    steps = 2  # two batches of 4 a client, one wave
    check(by_pass == {"fwd": 2 * steps, "bwd_dkv": 2 * steps, "bwd_dq": 2 * steps}
          and set(by_design) <= set(design_keys(fa, torch.float32).values()),
          f"DP fp32 round launches {by_pass} by design {by_design}")
    return {"param_err": err, "loss_err": loss_err, "moved": moved}


def config5_phase(fa, name):
    """Phase 17: BASELINE config 5 at ViT-B/16 width (bf16 compute, remat,
    DP-SGD clip 1.0 sigma 0.5, batch 64, delta 1e-5, Poisson cohorts at
    0.75), cut to 4 clients x 128 images: a warm-up, 2 timed rounds and a
    profiled one, waves from ``wave_size="auto"``; the accountant's
    epsilon, the example's secure-aggregation half, the noise replayed
    from its generator, and a 2-layer round card against the CPU."""
    from baton_tpu_torch.examples import vit_dp_secure as ex
    from baton_tpu_torch.ops.privacy import poisson_sample
    from baton_tpu_torch.parallel.engine import round_generator

    cfg, sim, params, data, n_samples, rng = config5_cohort()
    n_params = sum(v.numel() for v in params.values())
    steps = CONFIG5_PER_CLIENT // CONFIG5_BATCH
    print(f"phase 17: BASELINE config 5, ViT-B/16 ({n_params / 1e6:.1f} M params, "
          f"{cfg.n_classes} classes, L {cfg.n_patches + 1}, bf16, remat) with DP-SGD (clip "
          f"{CONFIG5_CLIP}, sigma {CONFIG5_SIGMA}, batch {CONFIG5_BATCH}), {CONFIG5_CLIENTS} "
          f"clients x {CONFIG5_PER_CLIENT} images ({steps} steps a client), Poisson cohorts at "
          f"{ex.cohort_rate(CONFIG5_CLIENTS)}, waves from wave_size='auto'")
    base = torch.Generator().manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    total = {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0}
    times, images_s, losses, breakdown, sizing_s, waves = [], [], [], None, [], []
    profiled_round = CONFIG5_TIMED_ROUNDS + 1
    r = 0
    while r <= profiled_round:
        cohort = poisson_sample(rng, CONFIG5_CLIENTS, ex.cohort_rate(CONFIG5_CLIENTS))
        if cohort.size == 0:  # an empty cohort is a no-op round, as in the example
            continue
        idx = torch.as_tensor(cohort, device="cuda")
        # the wave sizer's trial waves (once per cohort size: the round then
        # finds its answer cached), outside the timed window
        wave, dt_size = timed(lambda: sim._auto_wave(
            params, {k: v[idx] for k, v in data.items()}, n_samples[idx], 1))
        sizing_s.append(dt_size)
        wave = cohort.size if wave is None else wave
        waves.append(wave)
        before = launch_counts(fa)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with (torch.profiler.profile(activities=activities) if r == profiled_round
              else contextlib.nullcontext()) as prof:
            res, dt = timed(lambda: sim.run_round(params, data, n_samples,
                                                  round_generator(base, r),
                                                  client_indices=cohort, wave_size="auto"))
        params = res.params
        by_pass, by_design = launches_since(fa, before)
        loss = res.loss_history.tolist()
        losses.extend(loss)
        n_waves = -(-cohort.size // wave)
        label = {0: " (warm-up)", profiled_round: " (profiled)"}.get(r, "")
        print(f"  round {r}{label}: cohort {cohort.tolist()}, wave {wave} ({n_waves} waves, sizing "
              f"{dt_size:.2f} s), loss {loss} {dt:.4f} s, launches {by_pass} by design {by_design}")
        check(all(math.isfinite(x) for x in loss), f"config 5 round {r}: non-finite loss")
        # one launch per layer per step covers the wave's clients x examples;
        # remat runs the forward again in the backward
        per_round = check_step_launches(f"config 5 round {r}", by_pass, by_design, cfg.n_layers,
                                        n_waves * steps, fwd_extra=n_waves * steps)
        for k in total:
            total[k] += per_round[k]
        if r == profiled_round:
            breakdown = device_breakdown(prof, dt)
        elif r > 0:
            times.append(dt)
            images_s.append(float(n_samples[idx].sum()) / dt)
        r += 1
    peak = torch.cuda.max_memory_allocated() / 1e9
    s_median = float(np.median(times))
    n_steps_run, eps, eps_amp, q = ex.epsilons(profiled_round + 1, 1, CONFIG5_PER_CLIENT,
                                               CONFIG5_BATCH, CONFIG5_PER_CLIENT, CONFIG5_SIGMA,
                                               CONFIG5_DELTA)
    check(math.isfinite(eps) and math.isfinite(eps_amp) and 0 < eps_amp < eps,
          f"accountant: epsilon {eps}, amplified {eps_amp}")
    print(f"  s/round median {s_median:.4f} ({', '.join(f'{t:.4f}' for t in times)}), images/s "
          f"median {float(np.median(images_s)):.1f}; peak memory {peak:.2f} GB; wave sizing "
          f"{', '.join(f'{t:.2f}' for t in sizing_s)} s; epsilon {eps:.3f} at delta "
          f"{CONFIG5_DELTA} after {n_steps_run} steps ({eps_amp:.3f} amplified at q={q:.3f}); "
          f"footprint line {json.dumps(sim.wave_footprint)}")
    per_step = {"fwd": 2 * cfg.n_layers, "bwd_dkv": cfg.n_layers, "bwd_dq": cfg.n_layers}

    # the example's secure-aggregation half: each client's delta masked
    deltas, dt_deltas = timed(lambda: ex.client_deltas(sim, params, data, n_samples))
    t0 = time.perf_counter()
    err = ex.secure_sum_error(deltas, 0)
    mask_s = time.perf_counter() - t0
    del deltas
    print(f"  secure aggregation of {CONFIG5_CLIENTS} clients' deltas: masked-sum error {err:.2e} "
          f"(the example's limit 1e-3); the clients alone {dt_deltas:.2f} s, masking and "
          f"unmasking on the host {mask_s:.2f} s")
    check(err < 1e-3, f"secure aggregation's sum error {err:.2e}")

    # the noise, replayed from its generator on two clients' first batches
    batch = {k: v[:2, :CONFIG5_BATCH] for k, v in data.items()}
    batch["mask"] = torch.ones(2, CONFIG5_BATCH, device="cuda")
    replay = noise_replay_gap(sim.trainer, params, batch, seed=5)
    print(f"  noise replay: noised minus sigma-0 gradients against sigma*clip*N/{CONFIG5_BATCH}: "
          f"{replay:.3e} relative (tol {NOISE_REPLAY_TOL})")
    check(replay <= NOISE_REPLAY_TOL, f"noise replay gap {replay:.3e}")
    del batch
    torch.cuda.empty_cache()
    parity = dp_parity_against_cpu(fa)
    stats = {"round_s": times, "s_per_round_median": s_median, "images_per_s": images_s,
             "peak_memory_gb": peak, "losses": losses, "breakdown": breakdown,
             "waves": waves, "wave": max(waves), "wave_sizing_s": sizing_s,
             "wave_footprint": sim.wave_footprint,
             "epsilon": eps, "epsilon_amplified": eps_amp, "steps": n_steps_run,
             "secure_err": err, "secure_mask_s": mask_s, "noise_replay": replay,
             "cpu_parity": parity, "n_params": n_params, "per_step": per_step}
    return total, per_round, stats, (sim, params, data, n_samples)


def config5_timing_phase(fa, name, wave):
    """Kernel, plain and SDPA times at config 5's attention shape (B = wave
    x 64 examples, 12 heads, L 197, D 64, bf16, padding bias): the batch
    one launch sees under the per-example vmap."""
    return attention_times(fa, name, "config 5", wave * CONFIG5_BATCH, 12, 12, 197, 64,
                           causal=False, bias_kind="lengths", seed=17)


def wave_check(label, sim, params, data, n_samples, budget_gb, gen_seed):
    """``auto_wave_size`` at ``budget_gb`` (None: the card's), a round at
    the wave it picks, and the checks: the round's measured peak at or
    under the budget, and the fitted line over it at twice the wave."""
    from baton_tpu_torch.utils.profiling import GIB, device_budget_gb

    c = int(len(n_samples))
    budget = device_budget_gb("cuda") if budget_gb is None else budget_gb
    wave, dt = timed(lambda: sim.auto_wave_size(params, data, n_samples, budget_gb=budget))
    line = sim.wave_footprint

    def estimate(w):
        return line["in_use_gb"] + (line["trial_gb"][0] if w <= 1
                                    else line["base_gb"] + w * line["per_client_gb"])

    w = c if wave is None else wave
    torch.cuda.reset_peak_memory_stats()
    res, dt_round = timed(lambda: sim.run_round(params, data, n_samples,
                                                torch.Generator().manual_seed(gen_seed),
                                                wave_size=wave))
    peak = torch.cuda.max_memory_allocated() / GIB
    print(f"  {label}: budget {budget:.2f} GiB -> wave {wave} (of {c}; sizing {dt:.2f} s); line "
          f"in use {line['in_use_gb']:.3f} + base {line['base_gb']:.3f} + {line['per_client_gb']:.3f}"
          f" a client GiB (trials {line['trial_gb'][0]:.3f}, {line['trial_gb'][1]:.3f}); round at "
          f"wave {w}: peak {peak:.3f} GiB (line {estimate(w):.3f}), {dt_round:.2f} s"
          + (f"; line at {2 * w}: {estimate(2 * w):.3f}" if w < c else ""))
    check(bool(torch.isfinite(res.loss_history).all()), f"{label}: non-finite loss")
    check(peak <= budget, f"{label}: the round's peak {peak:.3f} GiB is over the {budget:.3f} budget")
    if w < c:
        check(estimate(2 * w) > budget, f"{label}: the line at {2 * w} fits the budget too")
    return {"budget_gb": budget, "wave": wave, "line": dict(line), "peak_gib": peak,
            "line_at_wave_gib": estimate(w), "sizing_s": dt, "round_s": dt_round}, estimate


def auto_wave_phase(config5_ctx):
    """Phase 18: ``auto_wave_size`` against the allocator on phase 17's
    cohort (all 4 clients) and phase 6's ResNet-18 cohort (32 x 48): the
    wave and line at the card's budget, then at a budget that forces the
    search to halve at least once."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.resnet import resnet18_cifar_model

    print("phase 18: auto_wave_size against the allocator (trial waves of 1 and 2 clients, "
          "a line, the halving search)")
    out = {}
    sim, params, data, n_samples = config5_ctx
    out["config5"], line = wave_check("config 5", sim, params, data, n_samples, None, 2)
    w = out["config5"]["wave"] or CONFIG5_CLIENTS
    half = max(1, w // 2)
    # a budget half a client over the line at half the wave: the search must halve
    tight = line(half) + 0.5 * out["config5"]["line"]["per_client_gb"]
    out["config5_tight"], _ = wave_check("config 5, tight budget", sim, params, data, n_samples,
                                         tight, 3)
    check(out["config5_tight"]["wave"] is not None and out["config5_tight"]["wave"] < w,
          f"the tight budget did not halve the wave: {out['config5_tight']['wave']}")
    del config5_ctx, sim, params, data
    torch.cuda.empty_cache()

    data, n_samples = resnet18_cohort()
    sim = FedSim(resnet18_cifar_model(compute_dtype=torch.bfloat16), batch_size=32,
                 learning_rate=0.05)
    params = sim.init(torch.Generator().manual_seed(0))
    out["resnet18"], line = wave_check("ResNet-18 (32 x 48)", sim, params, data, n_samples, None, 4)
    c = int(len(n_samples))
    w = out["resnet18"]["wave"] or c
    tight = (line(w) + line(max(1, w // 2))) / 2
    out["resnet18_tight"], _ = wave_check("ResNet-18, tight budget", sim, params, data, n_samples,
                                          tight, 5)
    check(out["resnet18_tight"]["wave"] is not None and out["resnet18_tight"]["wave"] < w,
          f"the tight budget did not halve the ResNet wave: {out['resnet18_tight']['wave']}")
    return out


def fused_against_loop(fa, label, sim, params, data, n_samples):
    """``FedSim.run_rounds_fused`` against ``run_rounds`` for
    ``FUSED_ROUNDS`` rounds from the same params and generator (after a
    warm-up round): timed, then each profiled; params and losses within
    ``FUSED_TOL``. The fused run's steady s/round is its replays' span on
    the device over the replays, and its busy share the profiled device
    time a round over that. Returns the stats, the flash launches the
    fused run made (the eager round 0 plus the captured ones times the
    replays) and the captured launches a round."""
    gen = torch.Generator().manual_seed(1)
    timed(lambda: sim.run_rounds(params, data, n_samples, gen, n_rounds=1))  # warm-up
    (p_loop, h_loop), dt_loop = timed(lambda: sim.run_rounds(params, data, n_samples, gen,
                                                             n_rounds=FUSED_ROUNDS))
    before = launch_counts(fa)
    (p_fused, h_fused), dt_fused = timed(lambda: sim.run_rounds_fused(
        params, data, n_samples, gen, n_rounds=FUSED_ROUNDS))
    # the Python counters saw the eager round 0 and the capture; each replay
    # re-runs the captured launches without Python
    seen, _ = launches_since(fa, before)
    record = dict(sim.last_fused)
    check(record["graph"] and record["replays"] == FUSED_ROUNDS - 1,
          f"{label}: the fused run did not replay a graph: {record}")
    per_round = {k: n // 2 for k, n in seen.items()}
    launched = {k: per_round[k] * (1 + record["replays"]) for k in per_round}
    err = max((p_loop[k].float() - p_fused[k].float()).abs().max().item() for k in p_loop)
    loss_err = max(abs(a - b) for a, b in zip(h_loop, h_fused))
    bit_equal = all(torch.equal(p_loop[k], p_fused[k]) for k in p_loop) and h_loop == h_fused
    _, loop_prof = profiled(lambda: sim.run_rounds(params, data, n_samples, gen,
                                                   n_rounds=FUSED_ROUNDS), f"{label} run_rounds")
    _, fused_prof = profiled(lambda: sim.run_rounds_fused(params, data, n_samples, gen,
                                                          n_rounds=FUSED_ROUNDS),
                             f"{label} run_rounds_fused")
    # the profiler sees the kernels a graph replays: its flash count must be
    # the eager round's plus the captured launches times the replays
    traced = fused_prof and fused_prof["by_kind_count"].get("flash attention (this port)", 0)
    if traced is not None:
        check(traced == sum(launched.values()),
              f"{label}: the profiler saw {traced} flash launches in the fused run, the "
              f"count gives {sum(launched.values())}")
    replay_round_s = record["replay_s"] / record["replays"]
    busy_replays = (fused_prof["device_ms"] / 1e3 / FUSED_ROUNDS / replay_round_s
                    if fused_prof else None)
    loop_busy = f"{100 * loop_prof['busy_share']:.1f}%" if loop_prof else "not measured"
    fused_busy = f"{100 * busy_replays:.1f}%" if busy_replays else "not measured"
    print(f"  {label}: run_rounds {dt_loop / FUSED_ROUNDS:.4f} s/round (busy {loop_busy}); fused "
          f"{dt_fused / FUSED_ROUNDS:.4f} s/round over the call (capture {record['capture_s']:.3f}"
          f" s), replays {replay_round_s:.4f} s/round on the device (busy {fused_busy}: the "
          f"profiled device time a round over that); max |param diff| {err:.3e}, losses "
          f"{loss_err:.3e} (tol {FUSED_TOL}), bit-equal {bit_equal}; flash launches per round "
          f"{per_round}, in the fused run {launched} (the profiler saw {traced})")
    check(err <= FUSED_TOL and loss_err <= FUSED_TOL,
          f"{label}: fused and run_rounds differ: params {err:.3e}, losses {loss_err:.3e}")
    return {"s_per_round_loop": dt_loop / FUSED_ROUNDS, "s_per_round_fused": dt_fused / FUSED_ROUNDS,
            "s_per_round_replay": replay_round_s, "capture_s": record["capture_s"],
            "param_err": err, "loss_err": loss_err, "bit_equal": bit_equal,
            "busy_loop": loop_prof and loop_prof["busy_share"], "busy_replays": busy_replays,
            "device_ms_loop": loop_prof and loop_prof["device_ms"],
            "device_ms_fused": fused_prof and fused_prof["device_ms"],
            "flash_launches_traced": traced}, launched, per_round


def fused_phase(fa):
    """Phase 19: ``run_rounds_fused`` as a CUDA graph on phase 3's BERT-base
    cohort (8 x 32, bf16) and phase 6's ResNet-18 cohort (32 x 48, bf16)."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.resnet import resnet18_cifar_model

    print(f"phase 19: run_rounds_fused as a CUDA graph against run_rounds, {FUSED_ROUNDS} rounds "
          "each from the same params and generator")
    cfg, model, data, n_samples = bert_base_cohort(8, 32)
    sim = FedSim(model, batch_size=32, learning_rate=0.01)
    params = sim.init(torch.Generator().manual_seed(0))
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    bert, launched, per_round = fused_against_loop(fa, "BERT-base", sim, params, data, n_samples)
    check(per_round == {"fwd": cfg.n_layers, "bwd_dkv": cfg.n_layers, "bwd_dq": cfg.n_layers},
          f"fused BERT round launches {per_round}")
    del sim, params, data
    torch.cuda.empty_cache()
    data, n_samples = resnet18_cohort()
    sim = FedSim(resnet18_cifar_model(compute_dtype=torch.bfloat16), batch_size=32,
                 learning_rate=0.05)
    params = sim.init(torch.Generator().manual_seed(0))
    resnet, resnet_launched, _ = fused_against_loop(fa, "ResNet-18", sim, params, data, n_samples)
    check(all(n == 0 for n in resnet_launched.values()), "flash kernels in the ResNet rounds")
    del sim, params, data
    dp = fused_dp_round(fa)
    return {"bert": bert, "resnet18": resnet, "dp": dp, "launches_fused_bert": launched,
            "launches_per_round_fused_bert": per_round}


def fused_dp_round(fa):
    """The fused rounds under DP-SGD with noise: a 2-layer ViT (D 64, bf16,
    flash on mma) on 4 clients x 16 images in waves of 2, each wave's noise
    from a device generator registered with the graph and seeded before
    every replay; against ``run_rounds`` within ``FUSED_TOL``."""
    from baton_tpu_torch.examples import vit_dp_secure as ex
    from baton_tpu_torch.models.vit import ViTConfig
    from baton_tpu_torch.ops.padding import stack_client_datasets

    cfg = ViTConfig(image_size=64, patch=16, d_model=128, n_layers=2, n_heads=2, d_ff=256,
                    n_classes=10)
    rng = np.random.default_rng(7)
    data, n_samples = stack_client_datasets(ex.make_data(rng, cfg, 4, 16), batch_size=8)
    sim = ex.make_sim(cfg, 8, CONFIG5_CLIP, CONFIG5_SIGMA, compute_dtype=torch.bfloat16)
    params = sim.init(torch.Generator().manual_seed(0))
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    gen = torch.Generator().manual_seed(1)
    p_loop, h_loop = sim.run_rounds(params, data, n_samples, gen, n_rounds=3, wave_size=2)
    p_fused, h_fused = sim.run_rounds_fused(params, data, n_samples, gen, n_rounds=3,
                                            wave_size=2)
    record = dict(sim.last_fused)
    err = max((p_loop[k] - p_fused[k]).abs().max().item() for k in p_loop)
    loss_err = max(abs(a - b) for a, b in zip(h_loop, h_fused))
    moved = max((p_loop[k] - params[k]).abs().max().item() for k in p_loop)
    bit_equal = all(torch.equal(p_loop[k], p_fused[k]) for k in p_loop)
    print(f"  DP-SGD (sigma {CONFIG5_SIGMA}), 2-layer ViT, 4 clients in waves of 2, 3 rounds: max "
          f"|param diff| {err:.3e}, losses {loss_err:.3e} (tol {FUSED_TOL}; max |param change| "
          f"{moved:.3e}), bit-equal {bit_equal}; {record}")
    check(record["graph"] and record["replays"] == 2, f"DP fused run: {record}")
    check(err <= FUSED_TOL and loss_err <= FUSED_TOL,
          f"DP fused and run_rounds differ: params {err:.3e}, losses {loss_err:.3e}")
    return {"param_err": err, "loss_err": loss_err, "bit_equal": bit_equal, "moved": moved}


def examples_phase():
    """Phase 20: examples 02 (ResNet-18 on Dirichlet shards of the CIFAR
    loader's synthetic fallback, nothing downloaded) and 09 (the HTTP
    federation with the bandwidth levers) at their tiny presets on the
    card, each under its own assertions."""
    from baton_tpu_torch.examples import bandwidth_efficient_http, resnet_cifar_dirichlet

    print("phase 20: examples 02 and 09 at their tiny presets on the card")
    with tempfile.TemporaryDirectory() as tmp:
        (history, metrics), dt02 = timed(lambda: resnet_cifar_dirichlet.run(data_dir=tmp))
    check(history[-1] < history[0], f"example 02: loss should fall, {history}")
    out09, dt09 = timed(lambda: bandwidth_efficient_http.run())
    check(out09["accuracy"] > 0.8, f"example 09: accuracy {out09['accuracy']}")
    check(out09["mean_upload_bytes"] < out09["full_upload_bytes"] / 2,
          f"example 09: uploads {out09}")
    print(f"  example 02: loss {history[0]:.4f} -> {history[-1]:.4f}, accuracy "
          f"{metrics['accuracy']:.3f}, {dt02:.1f} s; example 09: accuracy {out09['accuracy']:.3f}, "
          f"uploads {out09['mean_upload_bytes']:.0f} of {out09['full_upload_bytes']} B, {dt09:.1f} s")
    return {"example02": {"history": history, "eval": metrics, "s": dt02},
            "example09": dict(out09, s=dt09)}


# phase 21: sequence parallelism on a mesh of 8 shards of the one card.
# Example 06's full preset (ring × flash, fp32), its striped preset (the
# dense ring), ring × flash alone in bf16 and fp32, and the dense ring,
# Ulysses and striped fns, each against one flash call over the sequence.

RING_SHARDS = 8
RING_ATTENTION = (1, 8, 4, 32768, 64)  # B, Hq, Hkv, L, D of example 06's full preset
# one block of its ring: B, Hq, Hkv, Lq = Lk = L/N, D (phases 2 and 21)
RING_BLOCK = (*RING_ATTENTION[:3], RING_ATTENTION[3] // RING_SHARDS, RING_ATTENTION[4])
RING_SEAMS_LEN = 8192  # (d): the dense seams hold (L/N)^2 scores a block under autograd
RING_PADDED_LEN = 13000  # (c)'s valid keys: shard 3 partly, shards 4-7 all padding
RING_STRIPED_STEPS = 2  # (b): cut from the preset's 5
FP32_PEAK = 67e12  # FLOP/s in fp32 outside the tensor cores (H100 SXM data sheet)
TF32_PEAK = 495e12  # FLOP/s in TF32 on the tensor cores, dense (the same data sheet)
RING_TOL = 1e-4  # (a)-(b): loss and each gradient against the flash model, relative


def ring_block_calls(n: int, causal: bool = True) -> int:
    """Flash block calls of one ring pass over ``n`` shards: each shard's
    diagonal block, then (causal) only the blocks from its past, so
    ``n + n(n-1)/2``; not causal ``n²``."""
    return n + n * (n - 1) // 2 if causal else n * n


def ring_step_launches(n: int, n_layers: int, remat: bool) -> dict:
    """Kernel launches of one training step of a causal decoder whose
    attention is a ring × flash of ``n`` shards: a pass's block calls a
    layer, the forward once more under remat (the backward recomputes each
    block), each backward kernel once a block."""
    calls = ring_block_calls(n) * n_layers
    return {"fwd": calls * (2 if remat else 1), "bwd_dkv": calls, "bwd_dq": calls}


def check_shards(name, got, want, n, tol, dim=2) -> float:
    """``got`` against ``want`` on each of the ``n`` shards along ``dim``
    (rtol = atol = ``tol``); fails naming the first shard that is off.
    Returns the largest error."""
    errs = []
    for j, (g, w) in enumerate(zip(torch.chunk(got.float(), n, dim),
                                   torch.chunk(want.float(), n, dim))):
        check(bool(torch.isfinite(g).all()), f"{name}: shard {j} not finite")
        err = (g - w).abs().max().item()
        check(torch.allclose(g, w, rtol=tol, atol=tol),
              f"{name}: shard {j} off by {err:.3e}, beyond rtol=atol={tol}")
        errs.append(err)
    return max(errs)


def check_model_grads(name, got, want, tol=RING_TOL) -> float:
    """Every param's gradient within ``tol`` of the reference's at its own
    scale (max |got - want| over max |want|); returns the largest gap."""
    gaps = {k: ((got[k].float() - w.float()).abs().max()
                / w.float().abs().max().clamp_min(1e-30)).item() for k, w in want.items()}
    worst = max(gaps, key=gaps.get)
    check(set(got) == set(want) and gaps[worst] <= tol,
          f"{name}: gradient of {worst} off by {gaps[worst]:.3e} of its largest value (tol {tol})")
    return gaps[worst]


def ring_inputs(seed, b, hq, hkv, l, d, dtype, valid=None):
    """``attention_inputs``' q, k, v and dout, and a [B, 1, 1, L] bias that
    masks the keys past ``valid`` (None for no bias)."""
    q, k, v, dout, _ = attention_inputs(seed, b, hq, hkv, l, d, dtype, None)
    bias = None
    if valid is not None:
        keep = torch.arange(l, device=q.device) < valid
        bias = torch.where(keep, 0.0, -1e30).expand(b, l)[:, None, None, :].contiguous()
    return q, k, v, dout, bias


def attention_vjp(fn, q, k, v, dout, bias, causal=True):
    """``fn``'s output and its vjp of ``dout`` for q, k, v (and the bias)."""
    args = [t.detach().requires_grad_() for t in (q, k, v)]
    if bias is not None:
        args.append(bias.detach().requires_grad_())
    out = fn(*args[:3], bias=None if bias is None else args[3], causal=causal)
    grads = torch.autograd.grad(out, args, dout)
    return out.detach(), grads


def hold_attention(name, fn, ref, inputs, n, tol, causal=True) -> dict:
    """``fn`` against ``ref`` on ``inputs``, forward and gradients, shard
    by shard; returns the largest error of each."""
    q, k, v, dout, bias = inputs
    got, want = attention_vjp(fn, *inputs, causal), attention_vjp(ref, *inputs, causal)
    errs = {"out": check_shards(f"{name} out", got[0], want[0], n, tol)}
    for what, g, w in zip(("dq", "dk", "dv", "dbias"), got[1], want[1]):
        # dbias is [B, 1, 1, L]: its length axis is the last
        errs[what] = check_shards(f"{name} {what}", g, w, n, tol, dim=3 if what == "dbias" else 2)
    return errs


def long_context_phase(fa):
    """Phase 21a: example 06's full preset as written, 5 steps of ring ×
    flash over 8 shards of the card; step 0 held against the flash model."""
    from baton_tpu_torch.examples import long_context_ring as ex
    from baton_tpu_torch.models.llama import llama_lm_model
    from baton_tpu_torch.ops.flash_attention import make_flash_attention_fn
    from baton_tpu_torch.parallel.mesh import make_mesh

    full = ex.full_preset()
    cfg, n, steps, batch = full["config"], full["n_devices"], full["n_steps"], full["batch_size"]
    mesh = make_mesh(n, ("seq",), devices=[torch.device("cuda")] * n)
    ring_model = llama_lm_model(cfg, attention_fn=ex.make_attention_fn(mesh), remat=True)
    flash_model = llama_lm_model(cfg, attention_fn=make_flash_attention_fn(), remat=True)
    params = ring_model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.as_tensor(ex.make_tokens(cfg, batch, 0), device="cuda")
    batch_t = {"x": toks, "y": toks}
    n_params = sum(v.numel() for v in params.values())
    print(f"phase 21a: example 06 --scale full, ring x flash over {n} shards of the card "
          f"(vocab {cfg.vocab_size}, L {cfg.max_len}, d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, {cfg.n_layers} layers, d_ff {cfg.d_ff}; {n_params / 1e6:.1f} M "
          f"params, batch {batch}, remat, fp32, {steps} steps)")

    def loss_and_grads(model):
        fn = torch.func.grad_and_value(lambda p: model.per_example_loss(p, batch_t).mean())
        grads, loss = fn(params)
        return loss.item(), grads

    (ring_loss, ring_grads), ring_s = timed(lambda: loss_and_grads(ring_model))
    (flash_loss, flash_grads), flash_s = timed(lambda: loss_and_grads(flash_model))
    loss_gap = abs(ring_loss - flash_loss) / abs(flash_loss)
    check(loss_gap <= RING_TOL, f"21a: step 0 loss {ring_loss} against the flash model's "
          f"{flash_loss} (relative {loss_gap:.3e}, tol {RING_TOL})")
    grad_gap = check_model_grads("21a", ring_grads, flash_grads)
    del ring_grads, flash_grads
    torch.cuda.empty_cache()
    print(f"  step 0 against one flash call over all {cfg.max_len} tokens: loss {ring_loss:.6f} "
          f"vs {flash_loss:.6f} (relative {loss_gap:.2e}), gradients within {grad_gap:.2e} of "
          f"each tensor's largest value (tol {RING_TOL}); {ring_s:.1f} s ring, {flash_s:.1f} s "
          "flash")

    stamps, counts = [], []

    def stamp(step, loss):
        stamps.append(time.perf_counter())
        counts.append(fa.launches())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    losses = ex.run(**full, device="cuda", params=params, progress_fn=stamp)
    by_pass, by_design = fa.launches(), {k: v for k, v in fa.launches_by_design.items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = np.diff([t0] + stamps).tolist()
    per_step = ring_step_launches(n, cfg.n_layers, remat=True)
    # each step's launches as counted, against what the ring implies
    measured = [{k: now[k] - (prev[k] if prev else 0) for k in now}
                for prev, now in zip([None] + counts[:-1], counts)]
    check(len(measured) == steps and all(m == per_step for m in measured)
          and by_pass == {k: c * steps for k, c in per_step.items()},
          f"21a: launches a step {measured} ({by_pass} in all), want {per_step} a step x {steps}")
    check(set(by_design) == set(design_keys(fa, torch.float32).values()),
          f"21a: launches by design {by_design}, want every fp32 pass on its design")
    check(all(math.isfinite(x) for x in losses) and len(losses) == steps,
          f"21a: losses {losses}")
    check(abs(losses[0] - ring_loss) <= RING_TOL * abs(ring_loss),
          f"21a: run's step 0 loss {losses[0]} against the held {ring_loss}")
    median_s = float(np.median(step_s[1:]))
    tokens_s = batch * cfg.max_len / median_s
    print(f"  {steps} steps: s/step {[round(x, 4) for x in step_s]} (median after the first "
          f"{median_s:.4f}), {tokens_s:.1f} tokens/s, peak {peak_gb:.2f} GB; losses "
          f"{[round(x, 4) for x in losses]}; launches {by_pass} ({per_step} a step: "
          f"{ring_block_calls(n)} block calls a pass and layer), {by_design}")
    _, breakdown = profiled(lambda: ex.run(**dict(full, n_steps=1), device="cuda",
                                           params=params), "one step")
    return by_pass, measured, {
        "s_per_step": step_s, "median_s_per_step": median_s, "tokens_per_s": tokens_s,
        "peak_memory_gb": peak_gb, "losses": losses, "step0_loss_gap": loss_gap,
        "step0_grad_gap": grad_gap, "launches_by_design": by_design,
        "busy_share": breakdown["busy_share"] if breakdown else None, "profile": breakdown}


def striped_phase(fa):
    """Phase 21b: the ``--striped`` full preset (L 8,192, the dense ring),
    2 steps; step 0's loss against the flash model, no flash launch."""
    from baton_tpu_torch.examples import long_context_ring as ex
    from baton_tpu_torch.models.llama import llama_lm_model
    from baton_tpu_torch.ops.flash_attention import make_flash_attention_fn

    full = dict(ex.full_preset(striped=True), n_steps=RING_STRIPED_STEPS)
    cfg = full["config"]
    params = llama_lm_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.as_tensor(ex.make_tokens(cfg, full["batch_size"], 0), device="cuda")
    print(f"phase 21b: example 06 --scale full --striped (L {cfg.max_len}, the dense ring over "
          f"{full['n_devices']} shards, fp32, remat), {RING_STRIPED_STEPS} of its 5 steps")
    with torch.no_grad():
        want = llama_lm_model(cfg, attention_fn=make_flash_attention_fn()).per_example_loss(
            params, {"x": toks, "y": toks}).mean().item()
    stamps = []
    fa.reset_launches()
    t0 = time.perf_counter()
    losses = ex.run(**full, device="cuda", params=params,
                    progress_fn=lambda step, loss: stamps.append(time.perf_counter()))
    launched = fa.launches()
    check(not any(launched.values()), f"21b: the striped ring launched flash kernels {launched}")
    gap = abs(losses[0] - want) / abs(want)
    check(gap <= RING_TOL, f"21b: step 0 loss {losses[0]} against the flash model's {want}")
    step_s = np.diff([t0] + stamps).tolist()
    print(f"  losses {[round(x, 4) for x in losses]}, step 0 against the flash model {want:.6f} "
          f"(relative {gap:.2e}); s/step {[round(x, 4) for x in step_s]}; no flash launch")
    return {"losses": losses, "step0_loss_gap": gap, "s_per_step": step_s}


def ring_flash_alone_phase(fa):
    """Phase 21c: ring × flash at (a)'s attention shape against one
    ``flash_attention`` call, causal, with and without a ragged padding
    bias, bf16 and fp32; times of both and of SDPA on the whole sequence."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from baton_tpu_torch.ops.flash_attention import flash_attention
    from baton_tpu_torch.parallel.mesh import make_mesh
    from baton_tpu_torch.parallel.ring_attention import make_flash_ring_attention_fn

    b, hq, hkv, l, d = RING_ATTENTION
    n = RING_SHARDS
    ring = make_flash_ring_attention_fn(make_mesh(n, ("seq",),
                                                  devices=[torch.device("cuda")] * n))
    print(f"phase 21c: ring x flash alone over {n} shards (B {b}, {hq}/{hkv} heads, L {l}, "
          f"D {d}, causal) against one flash call over the sequence")
    errs, times = {}, {}
    calls = ring_block_calls(n)
    for dtype in (torch.bfloat16, torch.float32):
        design, keys = design_names(fa, dtype), set(design_keys(fa, dtype).values())
        dname = str(dtype)[6:]
        for valid in (None, RING_PADDED_LEN):
            inputs = ring_inputs(21, b, hq, hkv, l, d, dtype, valid)
            label = f"{dname} {'no bias' if valid is None else f'{valid} valid keys'}"
            before = launch_counts(fa)
            got = attention_vjp(ring, *inputs)
            by_pass, by_design = launches_since(fa, before)
            check(by_pass == {"fwd": calls, "bwd_dkv": calls, "bwd_dq": calls}
                  and set(by_design) == keys,
                  f"21c {label}: launches {by_pass} {by_design}, want {calls} each on {design}")
            del got
            errs[label] = hold_attention(f"21c {label}", ring, flash_attention, inputs, n,
                                         TOL[dtype])
            print(f"  {label}: " + " ".join(f"{k}={e:.2e}" for k, e in errs[label].items())
                  + f" (tol {TOL[dtype]}); {calls} launches of each kernel, all {design}")
        q, k, v, dout, _ = ring_inputs(21, b, hq, hkv, l, d, dtype)
        ke, ve = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))

        def fwd_bwd(fn, *xs):
            xs = [x.detach().requires_grad_() for x in xs]
            out = fn(*xs)
            return torch.autograd.grad(out, xs, dout)

        def sdpa(q, k, v):
            # never the math backend: its L x L scores would not fit
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION]):
                return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        causal = lambda fn: (lambda q, k, v: fn(q, k, v, causal=True))  # noqa: E731
        t = {"ring_fwd": time_ms(lambda: causal(ring)(q, k, v), iters=1, warmup=1),
             "flash_fwd": time_ms(lambda: causal(flash_attention)(q, k, v), iters=1, warmup=1),
             "sdpa_fwd": time_ms(lambda: sdpa(q, ke, ve), iters=1, warmup=1),
             "ring_fwd_bwd": time_ms(lambda: fwd_bwd(causal(ring), q, k, v), iters=1, warmup=1),
             "flash_fwd_bwd": time_ms(lambda: fwd_bwd(causal(flash_attention), q, k, v),
                                      iters=1, warmup=1),
             "sdpa_fwd_bwd": time_ms(lambda: fwd_bwd(sdpa, q, ke, ve), iters=1, warmup=1)}
        times[dname] = t
        print(f"  {dname} times (ms, median of 5 readings): " + ", ".join(
            f"{k} {ms:.3f}" for k, ms in t.items()) + " (SDPA on k, v repeated to 8 heads)")
    return {"errors": errs, "times_ms": times}


def ring_seams_phase():
    """Phase 21d: the dense ring (8 shards), Ulysses (4: the kv heads are
    4) and the striped fn (8) against one flash call at L 8,192, fp32,
    causal, forward and q, k, v gradients."""
    from baton_tpu_torch.ops.flash_attention import flash_attention
    from baton_tpu_torch.parallel.mesh import make_mesh
    from baton_tpu_torch.parallel.ring_attention import (
        make_ring_attention_fn,
        make_striped_attention_fn,
        make_ulysses_attention_fn,
    )

    b, hq, hkv, _, d = RING_ATTENTION
    inputs = ring_inputs(41, b, hq, hkv, RING_SEAMS_LEN, d, torch.float32)

    def mesh(n):
        return make_mesh(n, ("seq",), devices=[torch.device("cuda")] * n)

    print(f"phase 21d: the dense seams at L {RING_SEAMS_LEN} (B {b}, {hq}/{hkv} heads, D {d}, "
          "fp32, causal) against one flash call")
    errs = {}
    for label, fn, n in (("dense ring", make_ring_attention_fn(mesh(8)), 8),
                         ("ulysses", make_ulysses_attention_fn(mesh(hkv)), hkv),
                         ("striped", make_striped_attention_fn(mesh(8)), 8)):
        errs[label], dt = timed(lambda: hold_attention(f"21d {label}", fn, flash_attention,
                                                         inputs, n, TOL[torch.float32]))
        print(f"  {label} over {n} shards: " + " ".join(
            f"{k}={e:.2e}" for k, e in errs[label].items()) + f" (tol 1e-4), {dt:.1f} s")
    return errs


def sequence_parallel_phase(fa, name):
    """Phase 21: (a)-(d) above; returns (launches of (a) by pass, each of
    its steps' launches as counted, ring-block rows by kernel and dtype,
    stats)."""
    torch.cuda.empty_cache()
    launches, per_step, stats = long_context_phase(fa)
    torch.cuda.empty_cache()
    stats = {"long_context": stats, "striped": striped_phase(fa)}
    torch.cuda.empty_cache()
    stats["ring_flash_alone"] = ring_flash_alone_phase(fa)
    block_rows, stats["ring_block_bwd_pair_fp32"] = ring_block_times(fa, name)
    stats["seams"] = ring_seams_phase()
    return launches, per_step, block_rows, stats


def ring_block_times(fa, name, dtypes=(torch.float32, torch.bfloat16)):
    """``attention_times`` at the ring block's shape, not causal (28 of a
    layer's 36 block calls), per dtype: ({kernel: {dtype: row}}, the fp32
    backward pair's row)."""
    block_rows, pair = {}, None
    for dtype in dtypes:
        rows = attention_times(fa, name, "the ring block", *RING_BLOCK, causal=False,
                               bias_kind=None, seed=31, dtype=dtype)
        pair = rows.pop("bwd_pair", pair)
        for kname, row in rows.items():
            block_rows.setdefault(kname, {})[str(dtype)[6:]] = row
    return block_rows, pair


def fp32_rows(fa, block_rows, errs, launches=None, per_step=None) -> list:
    """The kernels line's rows of the fp32 kernels, whose path is example
    06's ring x flash (phase 21a): times and bounds at the ring block's
    fp32 shape, the max abs error of phase 2's fp32 ring-block case
    (``errs``), and 21a's launches in all and a step (None when it did not
    run)."""
    rows = []
    for counter, key in design_keys(fa, torch.float32).items():
        times = block_rows[f"flash_{counter}"]["float32"]
        rows.append({
            "name": f"flash_{key}", "pass": counter, "route": "cuda",
            "design": key[len(counter) + 1:], "source": KERNELS[key],
            "replaces": TPU_KERNELS[counter],
            "launches": launches[counter] if launches else None,
            "launches_per_step_ring_flash": ([step[counter] for step in per_step]
                                             if per_step else None),
            "max_abs_err": errs[f"flash_{counter}"], "tol": TOL[torch.float32],
            **times,
            "library_call": ("scaled_dot_product_attention forward" if counter == "fwd"
                             else "scaled_dot_product_attention backward (dq, dk, dv)"),
            "shape": "the ring block: B 1, 8/4 heads, L 4,096, D 64, not causal, fp32"})
    return rows


# phase 22: the clients mesh on the one card. A mesh may repeat its device:
# 4 shards of cuda:0 train a quarter of each wave each, issued before any is
# read, and meet in one psum a round (parallel/mesh.py, ops/aggregation.py).

MESH_SHARDS = 4  # (a), (b)
MESH_BAND = 5e-2  # the reference's cross-layout band (tests/test_mesh_equivalence.py)
# (a), (b): the params' gap from meshless as a share of the round's largest
# change; read 1.6e-4 (a) and 4.1e-6 (b) on the card, and a round that drops
# a shard from its psum is near 8e-2 (tests/test_torch_chip_smoke.py)
MESH_GAP_SHARE = 1e-2
MESH_TIMED_ROUNDS = 3  # (a): after a warm-up, each side
CONFIG2 = dict(n_clients=128, n_total=50_000, alpha=0.5, batch_size=32, wave_size=32, lr=0.05)
CONFIG2_ROUNDS = 2  # cut from the preset's 100 (PERF.md §4)
VARIANT_SHARDS = (2, 8)  # (c): shards of the card, of the CPU
VARIANT_BUFFER = (8, 12)  # (c): FedBuff's buffer (a multiple of both) and concurrency
PSUM_CHILD_TIMEOUT_S = 180  # (d): each child process


def card_mesh(n: int):
    """A clients mesh of ``n`` shards of ``cuda:0``."""
    from baton_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, devices=[torch.device("cuda", 0)] * n)


def within_band(got, want, start) -> dict:
    """``got`` against ``want`` (two rounds from ``start``) in the
    reference's band, every element within rtol = atol = ``MESH_BAND``;
    also the gap as a share of the round's largest change. Returns both."""
    gap = max_gap(got, want)
    moved = max(float((want[k].double() - start[k].double()).abs().max()) for k in start)
    inside = all(torch.allclose(got[k].float(), want[k].float(), rtol=MESH_BAND, atol=MESH_BAND)
                 for k in want)
    return {"max_gap": gap, "largest_change": moved, "gap_over_change": gap / moved,
            "inside": inside}


def hold_against_meshless(label, got, want, start) -> tuple:
    """The mesh's round ``got`` against the meshless round ``want`` (round
    results from the params ``start``): every param and the loss within
    the reference's band, and the params' gap at most ``MESH_GAP_SHARE`` of
    the round's largest change (the band alone passes a round that drops a
    shard where a round moves the params less than it). Returns ``(band,
    loss_gap)``."""
    band = within_band(got.params, want.params, start)
    loss_gap = (got.loss_history - want.loss_history).abs().max().item()
    check(band["inside"] and band["gap_over_change"] <= MESH_GAP_SHARE
          and loss_gap <= MESH_BAND * want.loss_history.abs().max().item(),
          f"{label}: the mesh round is outside the band of the meshless one, or its gap is over "
          f"{MESH_GAP_SHARE} of the round's change ({band}, loss {loss_gap})")
    return band, loss_gap


def noise_draw_costs(params, n_clients: int, n_shards: int) -> dict:
    """One DP-SGD step's noise for a wave of ``n_clients`` clients stacked
    like ``params`` (``training.noise_rows_of``): meshless, one draw of the
    wave; on ``n_shards`` shards, each shard draws the whole wave and keeps
    its rows (what keeps a client's noise the same on any mesh). The ms of
    each and its peak GB above the memory in use; the mesh's peak must stay
    under twice the meshless one (the rows kept own their memory, and one
    leaf's whole draw is alive at a time)."""
    from baton_tpu_torch.core.training import noise_rows_of

    templ = {k: torch.empty((1,) + tuple(v.shape), device="meta") for k, v in params.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    per = n_clients // n_shards
    fns = {"meshless": lambda: noise_rows_of(templ, gen, (0, n_clients, n_clients), "cuda"),
           "mesh": lambda: [noise_rows_of(templ, gen, (j * per, (j + 1) * per, n_clients), "cuda")
                            for j in range(n_shards)]}
    out = {}
    for label, fn in fns.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[label] = {"peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                      "ms": time_ms(fn, iters=3, warmup=1, readings=3)}
    check(out["mesh"]["peak_gb"] < 2 * out["meshless"]["peak_gb"],
          f"22a: the mesh's noise for one step peaks at {out['mesh']['peak_gb']:.2f} GB, the "
          f"meshless {out['meshless']['peak_gb']:.2f} GB")
    return out


def fold_against_oracle(client_params, n_samples, mesh) -> dict:
    """The mesh's psum FedAvg of trained client contributions (``[C, ...]``
    split over the shards as a round splits them) against float64, element
    by element within the worst-case fp32 error of that sum,
    ``gamma(C + 2)`` of the weighted sum of magnitudes over the weights.
    Returns the largest gap and its share of the bound."""
    from baton_tpu_torch.ops import aggregation as agg
    from baton_tpu_torch.parallel.mesh import client_sharding, device_put, shard_client_arrays

    w = torch.as_tensor(n_samples, device=next(iter(client_params.values())).device).float()
    means = agg.psum_weighted_mean(shard_client_arrays(client_params, mesh),
                                   device_put(w, client_sharding(mesh)), mesh)
    w64 = w.double()
    gap = share = 0.0
    for k, v in client_params.items():
        v64 = v.double()
        oracle = torch.tensordot(w64, v64, dims=([0], [0])) / w64.sum()
        bound = gamma(len(w) + 2) * torch.tensordot(w64, v64.abs(), dims=([0], [0])) / w64.sum()
        for mean in means:
            diff = (mean[k].double() - oracle).abs()
            gap = max(gap, diff.max().item())
            share = max(share, (diff / bound.clamp_min(1e-300)).max().item())
    check(share <= 1.0, f"the psum fold is {share:.3g} of its fp32 bound from float64")
    return {"max_gap": gap, "share_of_bound": share}


def mesh_bert_phase(fa):
    """Phase 22a: phase 3's BERT-base round on 4 shards of the card against
    the same round meshless (same weights and shuffles): launches, the
    batch each forward launch sees, times, peak memory, the band, the
    fold against float64, the psum's time and the wave sizer's line."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core.training import random_perms
    from baton_tpu_torch.ops import aggregation as agg

    cfg, model, data, n_samples = bert_base_cohort()
    n_clients, batch = len(n_samples), 32
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    n_samples = torch.as_tensor(n_samples, device="cuda")
    mesh = card_mesh(MESH_SHARDS)
    sims = {"meshless": FedSim(model, batch_size=batch, learning_rate=0.01),
            "mesh": FedSim(model, batch_size=batch, learning_rate=0.01, mesh=mesh)}
    params = sims["meshless"].init(torch.Generator().manual_seed(0))
    perms = random_perms(n_clients, 1, data["x"].shape[1], torch.Generator().manual_seed(1))
    print(f"phase 22a: BERT-base rounds on a clients mesh of {MESH_SHARDS} shards of the card "
          f"against meshless ({n_clients} clients x {batch} samples, bf16 compute, one wave)")
    real_fwd, batches = fa._fwd, []

    def noting_fwd(q, *args):
        batches.append(int(q.shape[0]))
        return real_fwd(q, *args)

    out = {}
    for label, sim in sims.items():
        sim.run_round(params, data, n_samples, perms=perms)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batches.clear()
        fa._fwd = noting_fwd
        try:
            before = launch_counts(fa)
            res, first_s = timed(lambda: sim.run_round(params, data, n_samples, perms=perms))
            by_pass, by_design = launches_since(fa, before)
        finally:
            fa._fwd = real_fwd
        times = [timed(lambda: sim.run_round(params, data, n_samples, perms=perms))[1]
                 for _ in range(MESH_TIMED_ROUNDS)]
        out[label] = {"res": res, "launches": by_pass, "by_design": by_design,
                      "batches": sorted(set(batches)), "s_per_round": [first_s] + times,
                      "median_s": float(np.median([first_s] + times)),
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"  {label}: s/round {[round(t, 4) for t in [first_s] + times]}, peak "
              f"{out[label]['peak_memory_gb']:.2f} GB, launches a round {by_pass} {by_design}, "
              f"forward batch {out[label]['batches']}, loss {res.loss_history.tolist()}")
    plain, meshed = out["meshless"], out["mesh"]
    layers = cfg.n_layers
    check(plain["launches"] == {k: layers for k in plain["launches"]}
          and meshed["launches"] == {k: MESH_SHARDS * layers for k in meshed["launches"]}
          and meshed["by_design"] == {f"{p}_mma": MESH_SHARDS * layers
                                      for p in ("fwd", "bwd_dkv", "bwd_dq")},
          f"22a: launches {meshed['launches']} {meshed['by_design']} on the mesh, "
          f"{plain['launches']} meshless; want {MESH_SHARDS} x {layers} of each, all mma")
    check(len(plain["batches"]) == 1 and meshed["batches"] == [plain["batches"][0] // MESH_SHARDS],
          f"22a: forward batches {meshed['batches']} on the mesh, {plain['batches']} meshless")
    band, loss_gap = hold_against_meshless("22a", meshed["res"], plain["res"], params)
    client_params, _ = sims["meshless"].trainer.train_clients(params, data, n_samples, 1,
                                                              perms.cuda())
    fold = fold_against_oracle(client_params, n_samples, mesh)
    parts = [{k: v.float() for k, v in params.items()} for _ in range(MESH_SHARDS)]
    psum_ms = time_ms(lambda: agg.psum(parts, mesh), iters=5)
    del client_params, parts
    torch.cuda.empty_cache()
    noise = noise_draw_costs(params, n_clients, MESH_SHARDS)
    n_params = sum(v.numel() for v in params.values())
    footprints = {}
    for label, sim in sims.items():
        line = sim._fit_wave_footprint(params, data, n_samples)
        footprints[label] = dict(sim.wave_footprint, at_8_gb=line(n_clients))
    torch.cuda.empty_cache()
    print(f"  the mesh against meshless: params {band['max_gap']:.3e} ({band['gap_over_change']:.3e}"
          f" of the largest change {band['largest_change']:.3e}; band rtol = atol = {MESH_BAND}), "
          f"loss {loss_gap:.3e}; the psum fold against float64 {fold['max_gap']:.3e} "
          f"({fold['share_of_bound']:.3e} of its fp32 bound); one psum of the {n_params / 1e6:.1f} M "
          f"fp32 params over {MESH_SHARDS} shards {psum_ms:.4f} ms; the wave sizer's line "
          f"meshless {footprints['meshless']}, on the mesh (a client a shard a step) "
          f"{footprints['mesh']}; one DP step's noise for the wave meshless {noise['meshless']}, "
          f"on the mesh (each shard draws the wave) {noise['mesh']}")
    stats = {label: {k: v for k, v in o.items() if k != "res"} for label, o in out.items()}
    stats.update(band=band, loss_gap=loss_gap, fold=fold, psum_ms=psum_ms,
                 wave_footprint=footprints, dp_noise_step=noise)
    return meshed["launches"], stats


def config2_phase(fa):
    """Phase 22b: BASELINE config 2 at full width (example 02's ``--scale
    full``: ResNet-18, 128 Dirichlet(0.5) clients of 50,000 CIFAR-shaped
    images from the loader's synthetic fallback, batch 32, waves of 32,
    bf16) on 4 shards of the card, 2 of its 100 rounds; then round 0
    meshless on the same inputs, in waves of 8 (each the clients one shard
    holds in a wave), against the mesh's round 0."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.examples import resnet_cifar_dirichlet as ex02
    from baton_tpu_torch.ops.padding import stack_client_datasets
    from baton_tpu_torch.parallel.engine import round_generator

    cfg = CONFIG2
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as empty:  # no CIFAR-10 files: the synthetic fallback
        shards = ex02.make_data(np.random.default_rng(0), cfg["n_total"], cfg["n_clients"],
                                cfg["alpha"], data_dir=empty)
    data, n_samples = stack_client_datasets(shards, batch_size=cfg["batch_size"])
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    n_samples = torch.as_tensor(n_samples, device="cuda")
    data_s = time.perf_counter() - t0
    model = ex02.resnet18_cifar_model(compute_dtype=torch.bfloat16)
    capacity = data["x"].shape[1]
    sim = FedSim(model, batch_size=cfg["batch_size"], learning_rate=cfg["lr"],
                 mesh=card_mesh(MESH_SHARDS))
    params = sim.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    n_real = int(n_samples.sum())
    print(f"phase 22b: BASELINE config 2 (example 02 --scale full: ResNet-18, "
          f"{cfg['n_clients']} Dirichlet({cfg['alpha']}) clients, {n_real} images, capacity "
          f"{capacity}, batch {cfg['batch_size']}, waves of {cfg['wave_size']}, bf16) on "
          f"{MESH_SHARDS} shards of the card, {CONFIG2_ROUNDS} of its 100 rounds; data made in "
          f"{data_s:.1f} s")
    before = launch_counts(fa)
    rounds, p, first = [], params, None
    for i in range(CONFIG2_ROUNDS):
        torch.cuda.reset_peak_memory_stats()
        res, dt = timed(lambda: sim.run_round(p, data, n_samples, round_generator(gen, i),
                                              wave_size=cfg["wave_size"]))
        rec = sim.last_compute or {}
        rounds.append({"s": dt, "images_per_s": n_real / dt, "mfu": rec.get("mfu"),
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "loss": res.loss_history.tolist()})
        print(f"  round {i}: {dt:.3f} s, {n_real / dt:.1f} images/s, MFU {rec.get('mfu')}, "
              f"peak {rounds[-1]['peak_memory_gb']:.2f} GB, loss {rounds[-1]['loss']}")
        first = first or res
        p = res.params
    by_pass, _ = launches_since(fa, before)
    check(not any(by_pass.values()), f"22b: ResNet-18 launched flash kernels {by_pass}")
    check(all(math.isfinite(x) for r in rounds for x in r["loss"])
          and rounds[-1]["loss"][-1] < rounds[0]["loss"][0],
          f"22b: the loss did not fall: {[r['loss'] for r in rounds]}")
    check(all(torch.isfinite(v).all() for v in p.values()), "22b: non-finite params")
    plain = FedSim(model, batch_size=cfg["batch_size"], learning_rate=cfg["lr"])
    ref, ref_s = timed(lambda: plain.run_round(params, data, n_samples, round_generator(gen, 0),
                                               wave_size=cfg["wave_size"] // MESH_SHARDS))
    band, loss_gap = hold_against_meshless("22b", first, ref, params)
    print(f"  round 0 meshless in waves of {cfg['wave_size'] // MESH_SHARDS}: {ref_s:.3f} s; "
          f"the mesh's round 0 against it: params {band['max_gap']:.3e} "
          f"({band['gap_over_change']:.3e} of the largest change), loss {loss_gap:.3e}")
    del data, sim, plain
    torch.cuda.empty_cache()
    return {"rounds": rounds, "n_images": n_real, "capacity": capacity, "data_s": data_s,
            "meshless_round0_s": ref_s, "band": band, "loss_gap": loss_gap}


def mesh_variants_phase():
    """Phase 22c: the four variants at phase 15's small fp32 size on 2
    shards of the card against 8 shards of the CPU."""
    model, data, n_samples, perms = small_variant_cohort()
    print(f"phase 22c: the four variants on a clients mesh, {VARIANT_SHARDS[0]} shards of the "
          f"card against {VARIANT_SHARDS[1]} of the CPU (2-layer fp32 BERT-base width; FedBuff "
          f"buffer {VARIANT_BUFFER[0]} of {VARIANT_BUFFER[1]}; tol 1e-4, bookkeeping exact)")
    t0 = time.perf_counter()
    gaps = variants_against_cpu(model, model.init(torch.Generator().manual_seed(3)),
                                model.init(torch.Generator().manual_seed(4)), data, n_samples,
                                8, 0.01, perms, shards=VARIANT_SHARDS, buffer=VARIANT_BUFFER)
    print(f"  the mesh runs on the card and the CPU took {time.perf_counter() - t0:.1f} s")
    return gaps


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def psum_child(coordinator: str, rank: int, device: str = "cuda") -> int:
    """Phase 22d's child: ``python3 chip_smoke.py --psum-child host:port
    rank [device]``. Joins a gloo group of 2 processes, each with 2 shards
    of ``device`` (``cuda:0`` on the card), and runs the FedAvg psum of 4
    clients' ResNet-18-sized params (made from a seed) across the process
    boundary against float64 (within ``gamma(C + 2)`` of the weighted sum
    of magnitudes), timing it. Prints one JSON line; destroys its process
    group on every exit."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from baton_tpu_torch.models.resnet import resnet18_cifar_model
    from baton_tpu_torch.ops import aggregation as agg
    from baton_tpu_torch.parallel.mesh import client_sharding, device_put, shard_client_arrays
    from baton_tpu_torch.parallel.multihost import initialize_multihost, make_hybrid_mesh

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    try:
        initialize_multihost(coordinator, 2, rank, backend="gloo", devices=[dev] * 2,
                             timeout_s=60)
        mesh = make_hybrid_mesh([], dcn_axis="clients", devices=[dev] * 2)
        c = mesh.shape["clients"]
        shapes = {k: v.shape for k, v in resnet18_cifar_model().init(
            torch.Generator().manual_seed(0)).items()}
        gen = torch.Generator(device=dev).manual_seed(0)
        theta = {k: torch.randn((c,) + tuple(shape), generator=gen, device=dev)
                 for k, shape in shapes.items()}
        w = torch.arange(1, c + 1, dtype=torch.float32, device=dev)
        stacks, ws = shard_client_arrays(theta, mesh), device_put(w, client_sharding(mesh))
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        means = agg.psum_weighted_mean(stacks, ws, mesh)
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            agg.psum_weighted_mean(stacks, ws, mesh)
        sync()
        psum_ms = (time.perf_counter() - t0) / 5 * 1e3
        w64, share, gap = w.double(), 0.0, 0.0
        for k, v in theta.items():
            oracle = torch.tensordot(w64, v.double(), dims=([0], [0])) / w64.sum()
            bound = gamma(c + 2) * torch.tensordot(w64, v.double().abs(), dims=([0], [0])) / w64.sum()
            for mean in means:
                diff = (mean[k].double() - oracle).abs()
                gap, share = max(gap, diff.max().item()), max(
                    share, (diff / bound.clamp_min(1e-300)).max().item())
        n_params = sum(v[0].numel() for v in theta.values())
        print(json.dumps({"rank": rank, "world": dist.get_world_size(),
                          "backend": dist.get_backend(), "mesh": mesh.shape,
                          "local_shards": [j for j, _ in mesh.local_shards()],
                          "n_params": n_params, "max_gap": gap, "share_of_bound": share,
                          "psum_ms": psum_ms}), flush=True)
        return 0 if share <= 1.0 else 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def two_process_phase(device: str = "cuda") -> list:
    """Phase 22d: two processes on the one card joined over gloo (NCCL
    refuses two ranks on one GPU), one FedAvg psum across them against
    float64; each child under a hard timeout, killed in ``finally``."""
    coordinator = f"127.0.0.1:{free_port()}"
    print(f"phase 22d: two processes on the one card over gloo ({coordinator}), 2 shards of "
          f"{device} each: the FedAvg psum of 4 clients' ResNet-18-sized params across them")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--psum-child",
                               coordinator, str(rank), device], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=PSUM_CHILD_TIMEOUT_S)
            check(p.returncode == 0, f"22d: a child exited {p.returncode}:\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check([o["rank"] for o in outs] == [0, 1] and all(o["world"] == 2 for o in outs)
          and [o["local_shards"] for o in outs] == [[0, 1], [2, 3]]
          and all(o["share_of_bound"] <= 1.0 for o in outs), f"22d: {outs}")
    for o in outs:
        print(f"  rank {o['rank']} ({o['backend']}, mesh {o['mesh']}, shards {o['local_shards']}):"
              f" {o['n_params'] / 1e6:.2f} M params a client, psum {o['psum_ms']:.2f} ms, "
              f"against float64 {o['max_gap']:.3e} ({o['share_of_bound']:.3e} of its fp32 bound)")
    print(f"  the two processes took {time.perf_counter() - t0:.1f} s, start to exit")
    return outs


def mesh_phase(fa):
    """Phase 22: (a)-(d) above; returns (the launches of (a)'s mesh round
    by pass, stats)."""
    torch.cuda.empty_cache()
    launches, bert = timed_phase("22a", mesh_bert_phase, fa)
    torch.cuda.empty_cache()
    stats = {"bert": bert, "config2": timed_phase("22b", config2_phase, fa)}
    stats["variants"] = timed_phase("22c", mesh_variants_phase)
    torch.cuda.empty_cache()
    stats["two_processes"] = timed_phase("22d", two_process_phase)
    return launches, stats


HYBRID_GRID = (2, 2)  # (a), (b): clients x model shards of the card
HYBRID_CPU_GRID = (4, 2)  # (c): the tiny LoRA round's grid, card and CPU
# (a), (b): the adapters' (the head's) gap from the meshless round as a share
# of the round's largest change, about 3x the card's readings (PERF.md): 23a
# read 6.5e-2 (bf16 partial sums round twice through 32 layers), 23b 3.6e-3;
# a fp32 round that drops one model shard's partial reads 1.3
# (tests/test_torch_chip_smoke.py)
HYBRID_GAP_SHARE = 0.2
HYBRID_TIMED_ROUNDS = 1  # (a): the hybrid rounds timed before the profiled one
HYBRID_TP_RTOL, HYBRID_TP_ATOL = 2e-4, 1e-5  # (c): JAX's TP-against-replicated gradients
MOE_EP_RTOL, MOE_EP_ATOL = 1e-5, 1e-6  # (c): JAX's expert-parallel case


def card_grid(clients: int, model: int):
    """A hybrid ``("clients", "model")`` mesh of ``clients x model`` shards of
    ``cuda:0`` (or of the CPU with ``device="cpu"``)."""
    from baton_tpu_torch.parallel.mesh import Mesh

    return Mesh(np.array([[torch.device("cuda", 0)] * model] * clients, dtype=object),
                ("clients", "model"))


def hybrid_round_launches(n_layers: int, wave_steps: int, clients: int, model: int,
                          remat: bool = True, backward: bool = True) -> dict:
    """Each flash kernel's launches in one round on a ``clients x model``
    grid whose model shards each attend over their own heads: every clients
    shard trains its slice of every wave (phantoms included), and each of
    its steps launches each kernel once a layer a model shard (the forward
    twice under remat; no backward kernel where no gradient reaches the
    attention, as under a frozen encoder)."""
    per = n_layers * wave_steps * clients * model
    back = per if backward else 0
    return {"fwd": per * (2 if remat and backward else 1), "bwd_dkv": back, "bwd_dq": back}


def hold_hybrid(label, got, want, start, names, limit=HYBRID_GAP_SHARE) -> dict:
    """The hybrid round ``got`` against the meshless round ``want`` (round
    results from the params ``start``) on the trainable params ``names``:
    each within the reference's band (rtol = atol = ``MESH_BAND``), the loss
    too, and the largest gap at most ``limit`` of the round's largest change
    (the band alone passes a round that drops a model shard's partial where a
    round moves the params less than it). Returns the readings."""
    gap = max(float((got.params[k].double() - want.params[k].double()).abs().max())
              for k in names)
    moved = max(float((want.params[k].double() - start[k].double()).abs().max()) for k in names)
    inside = all(torch.allclose(got.params[k].float(), want.params[k].float(), rtol=MESH_BAND,
                                atol=MESH_BAND) for k in names)
    loss_gap = (got.loss_history - want.loss_history).abs().max().item()
    out = {"max_gap": gap, "largest_change": moved, "gap_over_change": gap / max(moved, 1e-300),
           "inside": inside, "loss_gap": loss_gap}
    check(inside and out["gap_over_change"] <= limit
          and loss_gap <= MESH_BAND * want.loss_history.abs().max().item(),
          f"{label}: the hybrid round is outside the band of the meshless one, or its gap is "
          f"over {limit} of the round's change ({out})")
    return out


def check_hybrid_peak(label, hybrid_gb: float, meshless_gb: float) -> None:
    """The hybrid round's peak at or under the meshless round's at the same
    wave: the base is placed as views, never copied a shard."""
    check(hybrid_gb <= meshless_gb, f"{label}: the hybrid round peaks at {hybrid_gb:.2f} GB, "
          f"over the meshless round's {meshless_gb:.2f} GB")


def check_placed_base(label, params, column: str, row: str) -> None:
    """``column`` split over ``model`` on dim 1 and ``row`` on dim 0."""
    from baton_tpu_torch.parallel.partition import dim_spec
    from baton_tpu_torch.parallel.tensor_parallel import is_sharded

    for name, spec in ((column, dim_spec("model", 1, 2)), (row, dim_spec("model", 0, 2))):
        check(is_sharded(params[name]) and params[name].spec == spec,
              f"{label}: {name} is {params[name]!r}, want {spec}")


def hybrid_config4_phase(fa, name, ctx):
    """Phase 23a: BASELINE config 4 at Llama-3-8B width and depth on a 2 x 2
    hybrid mesh of the card, from where phase 16a left it: one meshless
    round and two hybrid rounds (the second profiled) from the same params
    and shuffles. The frozen base comes back placed and, gathered, bit-equal
    to 16a's host copy (after 16a's rounds and these); each kernel's
    launches are what the shapes give; the hybrid peak is at or under the
    meshless one; the adapters hold the gap rule."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core.training import random_perms
    from baton_tpu_torch.examples import llama_lora
    from baton_tpu_torch.models.lora import lora_trainable
    from baton_tpu_torch.obs.compute import card_peaks

    sim, model, params = ctx["sim"], ctx["model"], ctx["params"]
    data, n_samples, wave = ctx["data"], ctx["n_samples"], ctx["wave"]
    cfg = llama_lora.FULL_CONFIG
    clients, shards = HYBRID_GRID
    n_clients = len(n_samples)
    wave_steps = -(-n_clients // wave) * ctx["steps"]
    hsim = FedSim(model, batch_size=CONFIG4_BATCH, learning_rate=llama_lora.LEARNING_RATE,
                  trainable=lora_trainable, mesh=card_grid(clients, shards))
    perms = random_perms(n_clients, 1, data["x"].shape[1], torch.Generator().manual_seed(3))
    adapters = [k for k in params if lora_trainable(k, params[k])]
    print(f"phase 23a: BASELINE config 4 at Llama-3-8B width and depth on a {clients} x {shards} "
          f"hybrid mesh of the card (the frozen base tensor-parallel over 'model': each model "
          f"shard {cfg.n_heads // shards}/{cfg.n_kv_heads // shards} heads), wave {wave}, "
          f"against one meshless round from the same params and shuffles")

    def round_on(s, profile=False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts(fa)
        # the device's kernels only: the host's ops of a hybrid round are
        # ~4x 16a's, and their trace took minutes to reduce
        activities = [torch.profiler.ProfilerActivity.CUDA]
        with (torch.profiler.profile(activities=activities) if profile
              else contextlib.nullcontext()) as prof:
            res, dt = timed(lambda: s.run_round(params, data, n_samples, perms=perms,
                                                wave_size=wave))
        by_pass, by_design = launches_since(fa, before)
        return res, dt, by_pass, by_design, torch.cuda.max_memory_allocated() / 1e9, prof

    want, plain_s, plain_launches, _, plain_peak, _ = round_on(sim)
    print(f"  meshless: {plain_s:.3f} s, peak {plain_peak:.2f} GB, launches {plain_launches}, "
          f"loss {want.loss_history.tolist()}")
    want_launches = hybrid_round_launches(cfg.n_layers, wave_steps, clients, shards)
    rounds, breakdown = [], None
    for r in range(HYBRID_TIMED_ROUNDS + 1):
        profile = r == HYBRID_TIMED_ROUNDS
        res, dt, by_pass, by_design, peak, prof = round_on(hsim, profile)
        label = " (profiled)" if profile else ""
        print(f"  hybrid round {r}{label}: {dt:.3f} s, peak {peak:.2f} GB, launches {by_pass} "
              f"{by_design}, loss {res.loss_history.tolist()}")
        check(by_pass == want_launches and set(by_design) <= {"fwd_mma", "bwd_dkv_mma",
                                                                "bwd_dq_mma"},
              f"23a round {r}: launches {by_pass} {by_design}, want {want_launches} on mma")
        check_hybrid_peak(f"23a round {r}", peak, plain_peak)
        if profile:
            t0 = time.perf_counter()
            breakdown = device_breakdown(prof, dt)
            print(f"  (the trace reduced in {time.perf_counter() - t0:.1f} s)")
        rounds.append({"res": res, "s": dt, "peak_gb": peak, "launches": by_pass})
    # the kernels line reports the counts measured on the timed round; the
    # formula is only the check above
    measured = rounds[0]["launches"]
    got = rounds[0]["res"]
    check_placed_base("23a", got.params, "base/blocks/0/attn/wq", "base/blocks/0/attn/wo")
    held = hold_hybrid("23a", got, want, params, adapters)
    repeat = max(float((rounds[1]["res"].params[k] - got.params[k]).abs().max()) for k in adapters)
    t0 = time.perf_counter()
    n_frozen = check_frozen_bit_equal(got.params, ctx["host_copy"])
    check_s = time.perf_counter() - t0
    times = [r["s"] for r in rounds[:HYBRID_TIMED_ROUNDS]]
    s_median = float(np.median(times))
    flops = lora_train_flops(ctx["n_params"], ctx["tokens"])
    mfu = flops / s_median / card_peaks(name)[1]
    print(f"  the hybrid round against meshless: adapters {held['max_gap']:.3e} "
          f"({held['gap_over_change']:.3e} of the largest change {held['largest_change']:.3e}; "
          f"limit {HYBRID_GAP_SHARE}, band {MESH_BAND}), loss {held['loss_gap']:.3e}; hybrid "
          f"rounds 0 and 1 apart by {repeat:.3e}; every frozen tensor bit-equal after phase 16a's "
          f"{ctx['rounds_before']} rounds and these {1 + len(rounds)} ({n_frozen} tensors, "
          f"gathered and compared on the host one at a time, {check_s:.1f} s)")
    print(f"  s/round {', '.join(f'{t:.3f}' for t in times)} (median {s_median:.3f}) against "
          f"the meshless {plain_s:.3f}; {ctx['tokens'] / s_median:.1f} tokens/s; MFU {mfu:.4f} "
          f"(4·P·tokens); peak {max(r['peak_gb'] for r in rounds):.2f} GB against the meshless "
          f"{plain_peak:.2f} GB; launches a round {measured} (counted on round 0), meshless "
          f"{plain_launches}")
    out = {"s_per_round": times, "s_per_round_median": s_median, "meshless_s": plain_s,
           "tokens_per_s": ctx["tokens"] / s_median, "mfu": mfu,
           "peak_memory_gb": [r["peak_gb"] for r in rounds], "meshless_peak_gb": plain_peak,
           "launches_per_round": measured, "meshless_launches": plain_launches,
           "held": held, "repeat_gap": repeat, "frozen_checked": n_frozen,
           "breakdown": breakdown}
    del rounds, got, want, hsim
    ctx.clear()
    torch.cuda.empty_cache()
    return out


def hybrid_bert_phase(fa):
    """Phase 23b: BERT-base (vocab 30,522, bf16) with config 3's
    trainable-head variant (the encoder frozen and placed over ``model``:
    ``b1`` split, ``b2`` once, the vocab split on 2 shards) on a 2 x 2 hybrid
    mesh of the card against the meshless round, at phase 8's cohort (8
    clients x 64 samples, batch 32, 2 epochs, lr 5e-3, FedProx mu 0.1): a
    warm-up, a timed round and a profiled one on each."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core.regularizers import fedprox
    from baton_tpu_torch.core.training import random_perms
    from baton_tpu_torch.examples.bert_fedprox import make_data
    from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
    from baton_tpu_torch.ops.padding import stack_client_datasets
    from baton_tpu_torch.parallel.tensor_parallel import describe_tp_sharding, is_sharded

    cfg = BertConfig(vocab_size=30522, max_len=128, d_model=768, n_layers=12, n_heads=12,
                     d_ff=3072, n_classes=4)
    n_clients, per_client, batch, n_epochs, lr, mu = 8, 64, 32, 2, 5e-3, 0.1
    data, n_samples = stack_client_datasets(
        make_data(np.random.default_rng(0), cfg, n_clients, per_client), batch_size=batch)
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    model = bert_classifier_model(cfg, compute_dtype=torch.bfloat16, name="bert_base_config3")
    clients, shards = HYBRID_GRID
    kw = dict(batch_size=batch, learning_rate=lr, regularizer=fedprox(mu),
              trainable=lambda path, leaf: path.startswith(CONFIG3_HEAD))
    sims = {"meshless": FedSim(model, **kw),
            "hybrid": FedSim(model, mesh=card_grid(clients, shards), **kw)}
    params = sims["meshless"].init(torch.Generator().manual_seed(0))
    perms = random_perms(n_clients, n_epochs, data["x"].shape[1], torch.Generator().manual_seed(2))
    steps = sims["meshless"].trainer.steps_per_round(data["x"].shape[1], n_epochs)
    on4 = describe_tp_sharding({"tok_emb": params["tok_emb"]}, card_grid(1, 4))["tok_emb"]
    print(f"phase 23b: BERT-base (vocab {cfg.vocab_size}, bf16) with the trainable head, the "
          f"encoder frozen, on a {clients} x {shards} hybrid mesh of the card against meshless "
          f"({n_clients} clients x {per_client}, batch {batch}, {n_epochs} epochs, FedProx mu "
          f"{mu}); tok_emb on 4 model shards: {on4} (30,522 does not split 4 ways)")
    check(on4 == "PartitionSpec()", f"23b: tok_emb over 4 shards is {on4}, want the fallback")
    out = {}
    for label, sim in sims.items():
        sim.run_round(params, data, n_samples, perms=perms, n_epochs=n_epochs)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts(fa)
        res, dt = timed(lambda: sim.run_round(params, data, n_samples, perms=perms,
                                              n_epochs=n_epochs))
        by_pass, by_design = launches_since(fa, before)
        out[label] = {"res": res, "s": dt, "launches": by_pass, "by_design": by_design,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"  {label}: {dt:.4f} s, peak {out[label]['peak_gb']:.2f} GB, launches {by_pass} "
              f"{by_design}, loss {res.loss_history.tolist()}")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, profiled_s = timed(lambda: sim.run_round(params, data, n_samples, perms=perms,
                                                         n_epochs=n_epochs))
        out[label]["breakdown"] = device_breakdown(prof, profiled_s)
    got, want = out["hybrid"], out["meshless"]
    check(want["launches"] == hybrid_round_launches(cfg.n_layers, steps, 1, 1, backward=False)
          and got["launches"] == hybrid_round_launches(cfg.n_layers, steps, clients, shards,
                                                       backward=False),
          f"23b: launches {got['launches']} hybrid, {want['launches']} meshless")
    check_hybrid_peak("23b", got["peak_gb"], want["peak_gb"])
    hp = got["res"].params
    check_placed_base("23b", hp, "blocks/0/mlp/w1", "blocks/0/mlp/w2")
    check(is_sharded(hp["tok_emb"]) and is_sharded(hp["blocks/0/mlp/b1"])
          and not is_sharded(hp["blocks/0/mlp/b2"]), "23b: tok_emb, b1 or b2 placed wrongly")
    head = sims["meshless"].partition.trainable_paths
    held = hold_hybrid("23b", got["res"], want["res"], params, head)
    print(f"  the hybrid round against meshless: the head {held['max_gap']:.3e} "
          f"({held['gap_over_change']:.3e} of the largest change {held['largest_change']:.3e}; "
          f"limit {HYBRID_GAP_SHARE}), loss {held['loss_gap']:.3e}")
    stats = {label: {k: v for k, v in o.items() if k != "res"} for label, o in out.items()}
    stats["held"] = held
    del out, sims
    torch.cuda.empty_cache()
    return stats


def hybrid_parity_phase():
    """Phase 23c: the small fp32 cases, card against CPU: a tiny LoRA Llama
    round on 4 x 2 shards of the card against 4 x 2 of the CPU (1e-4); the
    MoE layer with its experts over 4 card shards against replicated (JAX's
    tolerance); one loss and gradient of a tiny Llama with its base on a
    ``model``-4 axis (the kv heads' shard edges inside a head) against
    replicated on the card (JAX's tolerances)."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core.training import random_perms
    from baton_tpu_torch.examples import llama_lora
    from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model
    from baton_tpu_torch.models.lora import lora_trainable
    from baton_tpu_torch.models.moe import MoEConfig, moe_apply, moe_init
    from baton_tpu_torch.parallel.mesh import Mesh
    from baton_tpu_torch.parallel.tensor_parallel import gather_params, shard_params_tp

    # head dim 64, the kernels' (fp32: the tf32x3 design); 4/2 heads split
    # 2/1 a shard on 2 model shards
    tiny = LlamaConfig.tiny(d_model=256, n_heads=4, n_kv_heads=2, d_ff=256)
    clients, shards = HYBRID_CPU_GRID
    cpu_grid = Mesh(np.array([[torch.device("cpu")] * shards] * clients, dtype=object),
                    ("clients", "model"))
    model = llama_lora.make_sim(tiny, 4, 4, "cpu")[0].model
    params = model.init(torch.Generator().manual_seed(0))
    params = {k: (v + 0.05 if k.endswith("/b") else v) for k, v in params.items()}
    data, n_samples = llama_lora.client_data(tiny, 6, 8, 4, seed=0)
    perms = random_perms(len(n_samples), 2, data["x"].shape[1], torch.Generator().manual_seed(1))
    print(f"phase 23c: fp32 card against CPU on hybrid meshes: a tiny LoRA Llama (d 256, 4/2 "
          f"heads of 64) round on {clients} x {shards} shards; the MoE layer on 4 expert shards; "
          f"a tiny Llama's gradients on a model-4 axis")
    results = []
    for grid, dev in ((card_grid(clients, shards), "cuda"), (cpu_grid, "cpu")):
        sim = FedSim(model, batch_size=4, learning_rate=1e-2, trainable=lora_trainable, mesh=grid)
        res = sim.run_round({k: v.to(dev) for k, v in params.items()}, data, n_samples,
                            n_epochs=2, perms=perms)
        results.append(dataclasses.replace(res, params=gather_params(res.params)))
    errs = {"lora_round": compare_rounds("tiny LoRA llama on a hybrid mesh", *results, params,
                                         tol=ZOO_CPU_TOL)}

    moe_cfg = MoEConfig(n_experts=4, top_k=2, capacity_factor=4.0)
    p = moe_init(torch.Generator(device="cuda").manual_seed(0), 64, 128, moe_cfg)
    x = torch.randn(2, 64, 64, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    y_rep, aux_rep = moe_apply(p, x, moe_cfg)
    y_ep, aux_ep = moe_apply(shard_params_tp(p, Mesh(np.array([torch.device("cuda", 0)] * 4,
                                                              dtype=object), ("model",))),
                             x, moe_cfg)
    moe_gap = (y_ep - y_rep).abs().max().item()
    check(torch.allclose(y_ep, y_rep, rtol=MOE_EP_RTOL, atol=MOE_EP_ATOL)
          and math.isclose(aux_ep.item(), aux_rep.item(), rel_tol=1e-6),
          f"23c: expert-parallel MoE off replicated by {moe_gap:.3e}")
    errs["moe_expert_parallel"] = moe_gap

    grads_cfg = LlamaConfig.tiny(max_len=64, d_model=256, n_heads=4, n_kv_heads=2, d_ff=256)
    lm = llama_lm_model(grads_cfg)
    base = {k: v.cuda() for k, v in lm.init(torch.Generator().manual_seed(0)).items()}
    toks = torch.randint(0, grads_cfg.vocab_size, (4, grads_cfg.max_len),
                         generator=torch.Generator().manual_seed(2)).cuda()
    batch = {"x": toks, "y": toks}

    def loss(q):
        return lm.per_example_loss(q, batch).mean()

    want_g, want_l = torch.func.grad_and_value(loss)(base)
    placed = shard_params_tp(base, card_grid(2, 4))
    got_g, got_l = torch.func.grad_and_value(loss)(placed)
    got_g = gather_params(got_g)
    grad_gap = max(((got_g[k] - want_g[k]).abs() / (HYBRID_TP_ATOL + HYBRID_TP_RTOL
                                                    * want_g[k].abs())).max().item()
                   for k in want_g)
    check(math.isclose(got_l.item(), want_l.item(), rel_tol=1e-5) and grad_gap <= 1.0,
          f"23c: model-4 gradients off replicated ({grad_gap:.3e} of the tolerance), loss "
          f"{got_l.item()} against {want_l.item()}")
    errs["tp_grads_share_of_tolerance"] = grad_gap
    print(f"  expert-parallel MoE against replicated {moe_gap:.3e} (rtol {MOE_EP_RTOL}, atol "
          f"{MOE_EP_ATOL}); model-4 gradients against replicated at {grad_gap:.3e} of rtol "
          f"{HYBRID_TP_RTOL} / atol {HYBRID_TP_ATOL}, loss {got_l.item():.6f} against "
          f"{want_l.item():.6f}")
    return errs


def hybrid_phase(fa):
    """Phase 23 (b) and (c); (a) runs right after phase 16a, from its params."""
    torch.cuda.empty_cache()
    return {"bert": timed_phase("23b", hybrid_bert_phase, fa),
            "parity": timed_phase("23c", hybrid_parity_phase)}


def timed_phase(label, fn, *args):
    """``fn(*args)``, printing the seconds it took under ``label``."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label} took {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
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
    errs = kernel_phase(fa)
    if kernels_only:
        rows, extra = timing_phase(fa, name, None, None, errs["bert_base"])
        for row, llama in zip(rows, llama_timing_phase(fa, name).values()):
            row["llama_shape"] = llama
        block_rows, extra["ring_block_bwd_pair_fp32"] = ring_block_times(fa, name,
                                                                         (torch.float32,))
        rows += fp32_rows(fa, block_rows, errs["ring_block_float32"])
        print(json.dumps({"kernels": rows, "extra": extra}))
        print(f"phases 2 and 5 took {time.perf_counter() - phases:.1f} s; no result line "
              "(--kernels-only)")
        return 0
    main_launches, per_round, round_stats = bert_round_phase(fa)
    in_context_phase(fa)
    rows, extra = timing_phase(fa, name, main_launches, per_round, errs["bert_base"])
    for row, llama in zip(rows, llama_timing_phase(fa, name).values()):
        row["llama_shape"] = llama
    print(f"phases 2-5 took {time.perf_counter() - phases:.1f} s")
    vision = time.perf_counter()
    resnet_stats = resnet_round_phase(fa)
    vision_parity_phase()
    print(f"phases 6-7 took {time.perf_counter() - vision:.1f} s")
    options = time.perf_counter()
    config3_launches, config3_per_round, config3_stats = timed_phase("8", fedprox_bert_phase, fa)
    optimizer_stats = timed_phase("9", resnet_optimizer_phase, resnet_stats)
    parity_errs = timed_phase("10", options_parity_phase)
    print(f"phases 8-10 took {time.perf_counter() - options:.1f} s")
    http = time.perf_counter()
    http_stats = http_round_phase(fa)
    print(f"phase 11 took {time.perf_counter() - http:.1f} s")
    second = time.perf_counter()
    fa.reset_launches()
    bandwidth_stats = timed_phase("12", bandwidth_phase, fa)
    secure_stats = timed_phase("13", secure_phase, fa)
    config1_stats = timed_phase("14", config1_phase, fa)
    print(f"phases 12-14 took {time.perf_counter() - second:.1f} s")
    variants = time.perf_counter()
    variants_stats = variants_phase(fa, round_stats["peak_memory_gb"])
    print(f"phase 15 took {time.perf_counter() - variants:.1f} s")
    zoo = time.perf_counter()
    torch.cuda.empty_cache()
    config4_launches, config4_per_round, config4_stats, config4_ctx = timed_phase(
        "16a", config4_phase, fa, name)
    # 23a continues from 16a's params and host copy: the base is not made twice
    hybrid_stats = {"config4": timed_phase("23a", hybrid_config4_phase, fa, name, config4_ctx)}
    del config4_ctx
    zoo_stats = {"config4": config4_stats, "remat": timed_phase("16b", remat_phase),
                 "vit": timed_phase("16c", vit_phase, fa), "lstm": timed_phase("16d", lstm_phase),
                 "parity": timed_phase("16e", zoo_parity_phase)}
    with tempfile.TemporaryDirectory() as tmp:
        zoo_stats["crossover"] = timed_phase("16f", crossover_phase, name, tmp)
    print(f"phase 16 took {time.perf_counter() - zoo:.1f} s")
    slice10 = time.perf_counter()
    torch.cuda.empty_cache()
    config5_launches, config5_per_round, config5_stats, config5_ctx = timed_phase(
        "17", config5_phase, fa, name)
    config5_times = config5_timing_phase(fa, name, config5_stats["wave"])
    auto_stats = timed_phase("18", auto_wave_phase, config5_ctx)
    del config5_ctx
    fused_stats = timed_phase("19", fused_phase, fa)
    examples_stats = timed_phase("20", examples_phase)
    print(f"phases 17-20 took {time.perf_counter() - slice10:.1f} s")
    slice11 = time.perf_counter()
    ring_launches, ring_per_step, ring_rows, ring_stats = sequence_parallel_phase(fa, name)
    print(f"phase 21 took {time.perf_counter() - slice11:.1f} s")
    slice12 = time.perf_counter()
    mesh_launches, mesh_stats = mesh_phase(fa)
    print(f"phase 22 took {time.perf_counter() - slice12:.1f} s")
    slice13 = time.perf_counter()
    hybrid_stats.update(hybrid_phase(fa))
    print(f"phases 23b-c took {time.perf_counter() - slice13:.1f} s")
    for row in rows:  # the bf16 (mma) kernels' other paths
        counter = row["pass"]
        row["launches_config3"] = config3_launches[counter]
        row["launches_per_round_config3"] = config3_per_round[counter]
        row["launches_variants"] = variants_stats["launches"][counter]
        row["launches_config4"] = config4_launches[counter]
        row["launches_per_round_config4"] = config4_per_round[counter]
        row["launches_per_step_config4"] = (config4_per_round[counter]
                                            // config4_stats["steps_per_round"])
        row["launches_config5"] = config5_launches[counter]
        row["launches_per_round_config5"] = config5_per_round[counter]
        row["launches_per_step_config5"] = config5_stats["per_step"][counter]
        row["config5_shape"] = config5_times[f"flash_{counter}"]
        row["launches_fused_bert"] = fused_stats["launches_fused_bert"][counter]
        row["launches_per_round_fused_bert"] = fused_stats["launches_per_round_fused_bert"][counter]
        row["ring_block_shape"] = ring_rows[f"flash_{counter}"]["bfloat16"]
        row["launches_per_round_mesh_bert"] = mesh_launches[counter]
        row["launches_per_round_meshless_bert"] = mesh_stats["bert"]["meshless"]["launches"][
            counter]
        row["launches_per_round_hybrid_config4"] = hybrid_stats["config4"][
            "launches_per_round"][counter]
        row["launches_per_round_hybrid_bert"] = hybrid_stats["bert"]["hybrid"]["launches"][
            counter]
    rows += fp32_rows(fa, ring_rows, errs["ring_block_float32"], ring_launches, ring_per_step)

    print(json.dumps({"round": round_stats, "resnet_round": resnet_stats, "extra": extra,
                      "config3_round": config3_stats, "resnet_optimizers": optimizer_stats,
                      "options_parity": parity_errs, "http_round": http_stats,
                      "bandwidth": bandwidth_stats, "secure": secure_stats,
                      "config1": config1_stats, "variants": variants_stats, "zoo": zoo_stats,
                      "config5": config5_stats, "auto_wave": auto_stats, "fused": fused_stats,
                      "examples": examples_stats, "sequence_parallel": ring_stats,
                      "clients_mesh": mesh_stats, "hybrid_mesh": hybrid_stats}))
    print(f"the smoke took {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--psum-child"]:
        sys.exit(psum_child(*sys.argv[2:3], int(sys.argv[3]), *sys.argv[4:5]))
    sys.exit(main())
