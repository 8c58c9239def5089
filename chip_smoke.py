#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``baton_tpu_torch``) on one GPU.

Run from a checkout of the repository: ``python3 chip_smoke.py``. It needs
one CUDA card and ``nvcc``; it builds the flash-attention kernels from
``baton_tpu_torch/ops/csrc`` on first use. Phases, any failure of which
exits non-zero:

1. the card's name and power limit, and the kernels' build time with
   ptxas's registers, shared memory and spills for each kernel, and the
   HGMMA (wgmma) instructions of each (``cuobjdump -sass``): both wgmma
   kernels at both head dims must have some;
2. each kernel against its plain PyTorch version on the card: bf16 and
   fp32, causal or not, fully masked rows, GQA, ragged L (a single
   partial tile at L=40, L=200), D 64 and 128, BERT-base's own shape and
   each model shard's shape on phase 23's hybrid meshes (tolerance fp32
   1e-4, bf16 2e-2); every bf16 call must go through
   its pass's design (``BF16_KEYS``: wgmma forward and dkv, mma dq),
   every fp32 call (the forward and both
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
   one launch), every launch its pass's bf16 design (wgmma, wgmma, mma);
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
   kernel once per layer, on its bf16 design, and the clustered loss grid (a vmap
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
   adapters moved, each flash kernel on its bf16 design once per layer per step (the
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
   busy share; each flash kernel on its bf16 design once per layer per wave-step (the
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
   times of both and of SDPA on the whole sequence, and of each kernel
   alone on it; each kernel's time at the ring block's shape (B 1, 8/4
   heads, L 4,096, D 64) in fp32 and bf16 beside its bound (fp32: the
   CUDA cores' and the 3xTF32 tensor cores' bound), and each dtype's
   backward pair against SDPA's backward; (d) the dense ring, Ulysses (N = 4) and the striped fn
   against the flash call at L 8,192 in fp32.
22. the clients mesh on the one card (a mesh may repeat ``cuda:0``):
   (a) phase 3's BERT-base round on 4 shards against the same round
   meshless (same weights and shuffles): each flash kernel 4 x 12 launches
   a round, each forward over a quarter of the meshless batch, all bf16 designs;
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
   4x the meshless, all bf16 designs); the hybrid peak at or under the meshless
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
24. the operations planes, right after phase 11 and with its helpers:
   (a) phase 11's federation (ResNet-18, bf16 compute, 8 workers x 48
   samples, batch 32, lr 0.05, all on the card in this process) behind 2
   ``EdgeAggregator``s of 4 workers each under one root ``Manager``: a
   warm-up and 2 timed rounds. In each round the root's new params lie
   within the two-level fp32 fold's worst case of the float64 fold of
   the uploads the workers sent (``hold_edge_fold``: γ(n) of Σ w|x| / Σ w,
   n the roundings an upload meets: the edge's product, 4 additions and
   division, the root's product, 2 additions, its fold shards' merge and
   division); the root served the round blob once an edge and the edges
   once a worker; the root received one ``edge_partial`` an edge and no
   direct update, the partials crediting every worker once; each edge
   shipped one partial; every worker's compute record names the card.
   One round's trace holds spans of the manager, the edges and the
   workers. s/round against phase 11's flat round, the edges' fold and
   blob-fetch seconds and the round's split are printed. (b) While it is
   up, ``python -m baton_tpu_torch.ops --once --json`` against the root
   and both edges (a subprocess under a time limit) exits 0: every node
   answered, no ``page`` alert fires, and the compute pane carries the
   card's numbers (peak memory from ``torch.cuda``). (c) The reference's
   ``edge_cohort`` scenario (8 workers of a linear model behind 2 edges;
   steady, edge_loss with edge 1 killed, recovery: 8 / 8 / 6 s; without
   its baseline, the JAX package's numbers) through the port's loadgen
   with ``device="cuda"``: every one of its 11 SLO assertions passes
   through the port's ``evaluate_slo``, every round ends, the killed
   edge's workers fall back to the root (``edge_route_fallbacks``), and
   the params of the root and the workers live on the card. No flash
   kernel launches in phase 24.
25. the ring across processes, at the end: (a) two processes on the one
   card joined over gloo (NCCL refuses two ranks on one device; gloo's
   transport goes through host memory), each holding 4 shards of a seq
   axis of 8 that crosses the process boundary (``make_hybrid_mesh([],
   dcn_axis="seq")``), run example 06's ``--scale full`` model with phase
   21a's params and tokens: step 0's loss and every gradient within 1e-5
   of 21a's one-process ring (relative to each tensor's largest value),
   then 2 steps of the example's trainer with finite losses and the two
   processes' params within 1e-6 of each other; each process's launches a
   step those of its own shards (``ring_step_launches`` for shards 0-3 and
   4-7, on tf32x3); s/step against 21a's, the bytes each process sent
   across the boundary a step, its transport's seconds a step and its
   peak memory. (b) In the same processes, the dense ring and the striped
   fn over the 8 shards, Ulysses over 4 and ring x flash in bf16 (the bf16
   kernels, launches counted) at B 2, 8/4 heads, L 4,096, D 64, causal,
   shards 5-7 all padding, forward and the q, k, v and bias gradients,
   each within 1e-5 of the same fn over as many shards in one process.
   Both children run under a hard timeout and are killed in ``finally``.
   (c) ``python -m baton_tpu_torch.analysis baton_tpu_torch`` in a
   process of its own exits 0 with no finding and never imports JAX.
26. ``run_rounds_fused`` on meshes, 4 rounds each against ``run_rounds``
   on the same mesh from the same params and generator, within 1e-5
   (bit-equality printed), through ``fused_against_loop`` where one
   process drives the card: (a) phase 22a's BERT-base cohort on 4 shards
   of the card, one CUDA graph over the shards: its launches a round 4 x
   12 of each kernel, the fused run's the eager round's plus the captured
   ones times the replays (the profiler's count too), s/round of both and
   of the replays, busy shares; (b) 23b's case (BERT-base, the encoder
   frozen and placed, config 3's head, FedProx mu 0.1, 8 clients x 64, 2
   epochs) on 2 x 2 shards: forward launches only, the base placed in the
   result and bit-equal to what went in; (c) two processes on the card
   over gloo, each holding 2 shards of a clients axis of 4
   (``make_hybrid_mesh([], dcn_axis="clients")``), (a)'s cohort: a
   warm-up round, then ``run_rounds`` and ``run_rounds_fused`` as two
   captured pieces around the round's eager all-reduce (``pieces`` 2,
   3 replays, 2 x 12 launches a round a process, all bf16 designs), the two
   processes' params equal and within 22a's band of (a)'s fused params;
   each prints replay A and B seconds a round (CUDA events), the
   all-reduce's host seconds and bytes a round; then phase 19's DP case
   (8 clients in waves of 4) on the same processes within 1e-5. Both
   children run under a hard timeout and are killed in ``finally``.
   Phases 19, 26a and 26b time ``run_rounds_fused`` with donation on from
   clones of their params (every trainable leaf donated or the port's own,
   none copied, the donated ones the result's) and profile it with
   ``donate_buffers=False``, since their params start the profiled runs
   again; 26c's children run it last with donation on;
27. buffer donation (``run_rounds_fused(donate_buffers=)``) on phase 3's
   BERT-base cohort with phase 9's FedAdam server (``optim.adam(1e-2)``),
   3 fused rounds with donation on and off from identical clones of the
   params and the server state: bit-equal params, server state and losses;
   with donation every leaf of the caller's is the result's (``data_ptr``)
   and ``last_fused["donation"]`` counts them all donated, without it none
   is and every leaf is copied, the caller's clones unchanged; each run 2
   replays and 2 x 12 counted launches a kernel, all bf16 designs (the counts set to
   0 just before each run), and under the profiler 3 x 12 launches a
   kernel ran on the device (round 0 and the replays). Then ``fedsim_fused_donation_plan`` on the
   same case: its ``delta_gb`` (the allocator's peak, off minus on) at
   least 0.9 of the trainable params' and server state's bytes, printed
   beside them; and ``configure_torch_for_bench()``'s record.

``python3 chip_smoke.py --kernels-only`` runs phases 1, 2 and 5 alone, and
the times of config 5's shape (a wave of 3) and of 21's ring block in both
dtypes (each pass and the backward pair): the short first call after a
kernel changes (build, ptxas and HGMMA report, comparison at real widths,
times). It prints no result line.

Before the last line comes the ``kernels`` line: one row a hand-written
kernel, by its launch key (``fwd_wgmma``, ``bwd_dkv_wgmma``, ``bwd_dq_mma`` on
the main path, phase 3's BERT-base round; ``fwd_tf32x3``, ``bwd_dkv_tf32x3``,
``bwd_dq_tf32x3`` on example 06's ring x flash, phase 21a), each with its
launches on its path, its error in phase 2, and its times and bounds at
that path's shape; the fp32 rows add each process's launches a step in
25a, the bf16 rows each process's launches in 25b's bf16 ring and their
launches in phase 26 (26a's fused run and round, 26b's round, each 26c
process's round) and those the profiler saw in phase 27's fused run with
donation (``launches_donation``). The last line
is ``{"ok": true, "device": {...}}``. Without a CUDA card,
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
import shutil
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
# ("flash_" + key): bf16 (wgmma, wgmma, mma) on the main path, phase 3's BERT-base round,
# fp32 (tf32x3) on example 06's ring x flash, phase 21a
CSRC = "baton_tpu_torch/ops/csrc/"
TPU_KERNELS = {"fwd": "baton_tpu/ops/flash_attention.py:65",
               "bwd_dkv": "baton_tpu/ops/flash_attention.py:203",
               "bwd_dq": "baton_tpu/ops/flash_attention.py:253"}
KERNELS = {
    "fwd_wgmma": CSRC + "flash_attention_wgmma.cu",
    "bwd_dkv_wgmma": CSRC + "flash_attention_wgmma.cu",
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
# each bf16 pass's launch key on every path the smoke drives, as fa._design
# chooses it (phase 2 checks that the two agree): the forward and dkv on
# wgmma fed by TMA, dq on mma.sync
BF16_KEYS = {"fwd": "fwd_wgmma", "bwd_dkv": "bwd_dkv_wgmma", "bwd_dq": "bwd_dq_mma"}


def design_keys(fa, dtype, d=64) -> dict:
    """{pass: its launch key "<pass>_<design>"} for one dtype: what each
    pass's kernel counts under in ``fa.launches_by_design``."""
    return {p: f"{p}_{fa._design(dtype, d, p)}" for p in PASSES}


def design_names(fa, dtype) -> str:
    """The designs of the three passes, as printed: "tf32x3" where they
    agree, "a/b/c" (bf16: "wgmma/wgmma/mma") where they differ."""
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
    if re.search(r"(^|[^a-z_])(fwd|dkv|dq)(_mma|_wgmma|_tf32x3)?_kernel", n):
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


def event_totals(prof, device_type=torch.autograd.DeviceType.CUDA):
    """``{name: [count, µs]}`` of a profiled block's events on
    ``device_type`` (on a card: its kernels, copies and sets), summed from
    the profiler's raw events: ``key_averages`` first builds a Python tree
    of every event, which took 25 s for 23a's hybrid round. User
    annotations span other events and are left out."""
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == device_type and not e.is_user_annotation():
            t = totals.setdefault(e.name(), [0, 0.0])
            t[0] += 1
            t[1] += e.duration_ns() / 1e3
    return totals


def device_breakdown(prof, wall_s):
    """Device time of a profiled round, by kind and by kernel, and the
    device's busy share of the round's wall time (one stream, so kernel
    times do not overlap). None when the profiler saw no device time."""
    kernels = [(name, count, us) for name, (count, us) in event_totals(prof).items() if us > 0]
    total_ms = sum(us for _, _, us in kernels) / 1e3
    if total_ms == 0:
        print("  profiler saw no device time: breakdown not measured")
        return None
    kinds, kind_counts = {}, {}
    for name, count, us in kernels:
        kind = kernel_kind(name)
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
        kind_counts[kind] = kind_counts.get(kind, 0) + count
    top = sorted(kernels, key=lambda k: -k[2])[:12]
    busy = total_ms / (wall_s * 1e3)
    print(f"  profiled round: wall {wall_s * 1e3:.1f} ms, device busy {total_ms:.1f} ms "
          f"({100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%)")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"    {kind:28s} {ms:9.2f} ms  {100 * ms / total_ms:5.1f}% of device time")
    for name, count, us in top:
        print(f"    {us / 1e3:9.2f} ms x{count:<5d} {name[:110]}")
    return {"wall_ms": wall_s * 1e3, "device_ms": total_ms, "busy_share": busy,
            "by_kind_ms": kinds, "by_kind_count": kind_counts,
            "top": [[name[:110], count, us / 1e3] for name, count, us in top]}


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
        # kernels of example 06's full preset and the bf16 kernels of
        # 21c, past blocks and the causal diagonal, with and without padding
        *((f"ring_block_{str(dtype)[6:]}{tag}", *RING_BLOCK, dtype, causal, bias_kind)
          for dtype in (f32, bf16)
          for tag, causal, bias_kind in (("", False, None), ("_causal", True, "lengths"),
                                         ("_padded", False, "lengths"))),
    ]
    print("phase 2: kernels against their plain versions")
    for d in (64, 128):
        check(design_keys(fa, bf16, d) == BF16_KEYS,
              f"fa._design's bf16 keys at D {d} {design_keys(fa, bf16, d)}, the smoke's "
              f"{BF16_KEYS}")
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


def bert_base_cohort(n_clients=8, batch=32, cfg=None):
    """Phase 3's BERT-base (bf16 compute) and its clients: ``n_clients`` x
    ``batch`` samples of random tokens, lengths 16-128, numpy seed 0
    (``cfg``: another BERT, as the CPU tests' tiny one, lengths 16 to its
    ``max_len``). Returns ``(cfg, model, data, n_samples)``."""
    from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    cfg = cfg or BertConfig(vocab_size=30522, max_len=128, d_model=768, n_layers=12,
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


PEAK_SOURCE = "torch.cuda.max_memory_allocated"  # a record's peak on the card


def check_default_record(label, rec, kind, n_chips) -> dict:
    """A compute record from ``ComputeProbe.record_round`` called with
    neither ``device`` nor ``n_chips``: valid, naming ``kind`` (the card's
    CUDA name, or ``cpu``), counting ``n_chips`` (the process group's world
    size, else the cards) and reading the allocator's peak on a card (null
    with a reason on the CPU). Returns the three fields."""
    from baton_tpu_torch.obs.compute import validate_record

    got = {key: rec.get(key) for key in ("device_kind", "n_chips", "peak_hbm_gb_source")}
    want = {"device_kind": kind, "n_chips": n_chips,
            "peak_hbm_gb_source": None if kind == "cpu" else PEAK_SOURCE}
    bad = validate_record(rec)
    check(got == want and not bad, f"{label}: record_round's defaults gave {got}, want {want}"
          + (f"; {bad}" if bad else ""))
    return got


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
        check(by_design == dict.fromkeys(BF16_KEYS.values(), cfg.n_layers),
              f"round {r}: launches by design {by_design}, want every launch on "
              f"{'/'.join(BF16_KEYS.values())}")
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
    # the probe's defaults: this process's card, the run's cards, the
    # allocator's peak (a fresh signature: the rounds' records stand)
    defaults = check_default_record(
        "phase 3", sim.compute_probe.record_round(
            key="smoke_defaults", signature=("phase 3", "defaults"), train_s=s_median,
            n_samples=float(n_samples.sum())),
        torch.cuda.get_device_name(), torch.cuda.device_count())
    print(f"  record_round without device or n_chips: {defaults}")
    return main_launches, per_round, {"breakdown": breakdown, "round_s": times,
                           "s_per_round": s_round, "s_per_round_median": s_median,
                           "samples_per_s": n_clients * batch / s_round,
                           "peak_memory_gb": peak_gb, "losses": losses,
                           "eval": ev, "n_params": n_params, "default_record": defaults}


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
CONFIG3_TIMED_ROUNDS = 3  # phase 8: after a warm-up, before the profiled round (cut from 5)


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
    n_timed = CONFIG3_TIMED_ROUNDS
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
        launches = sum(count for count, _ in event_totals(prof).values())
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
    (FedSim keyword arguments, whether the card-vs-CPU gap is held, the
    rounds run). All at once runs two rounds, so the server optimizer's
    state threads from one to the next; every option alone runs one."""
    from baton_tpu_torch.core import optim
    from baton_tpu_torch.core.regularizers import fedprox

    def trainable(name, leaf):
        return name.startswith(trainable_prefixes)

    return {
        "local momentum 0.9": (dict(optimizer=optim.sgd(0.01, momentum=0.9)), True, 1),
        "local adam(1e-3, eps 1e-5)": (dict(optimizer=optim.adam(1e-3, eps=LOCAL_ADAM_EPS)),
                                       True, 1),
        "local adam(1e-3, eps 1e-8)": (dict(optimizer=optim.adam(1e-3)), False, 1),
        "fedprox mu 0.1": (dict(regularizer=fedprox(0.1)), True, 1),
        "fedadam server adam(1e-2, eps 1e-3)": (
            dict(server_optimizer=optim.adam(1e-2, eps=FEDADAM_TAU)), True, 1),
        "trainable " + "+".join(trainable_prefixes): (dict(trainable=trainable), True, 1),
        "all together": (dict(optimizer=optim.sgd(0.01, momentum=0.9),
                              regularizer=fedprox(0.1),
                              server_optimizer=optim.adam(1e-2, eps=FEDADAM_TAU),
                              trainable=trainable), True, 2),
    }


def options_against_cpu(label, model, params, data, n_samples, perms, batch, lr,
                        trainable_prefixes, device="cuda"):
    """Every option of ``option_variants`` on ``device`` against the same
    rounds on the CPU, as many as the option runs."""
    from baton_tpu_torch import FedSim

    errs = {}
    for name, (kw, hold, n_rounds) in option_variants(trainable_prefixes).items():
        results = []
        for dev in (device, "cpu"):
            sim = FedSim(model, batch_size=batch, learning_rate=lr, device=dev, **kw)
            p, state = {k: v.to(dev) for k, v in params.items()}, None
            for _ in range(n_rounds):
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

    print("phase 10: the options, fp32, a round of one epoch (two rounds all together), "
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
EDGE_SETTLE_S = 0.05  # an edge (phase 24) ships this long after its last worker reported
EDGE_SHIP_LIMIT_S = 30.0  # phase 24a waits this long at most for the edges' ship counts


def upload_sums(bodies):
    """Over BTW1 upload bodies in fp64, by tensor name: ``Σ w·x``,
    ``Σ w·|x|`` and ``Σ w`` (``w`` each body's ``n_samples``)."""
    from baton_tpu_torch.server import wire

    sums, mags, total = {}, {}, 0.0
    for body in bodies:
        tensors, meta = wire.decode(body)
        w = float(meta["n_samples"])
        for k, v in tensors.items():
            x = np.asarray(v, np.float64)
            sums[k] = sums.get(k, 0.0) + x * w
            mags[k] = mags.get(k, 0.0) + np.abs(x) * w
        total += w
    return sums, mags, total


def fold_of_uploads(bodies):
    """The sample-weighted mean of BTW1 upload bodies, recomputed from the
    bodies in fp64: ``({name: fp32 array}, total weight)``."""
    sums, _, total = upload_sums(bodies)
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


EDGE_SPLIT_NEEDS = (("manager", "round_setup"), ("worker", "local_train"),
                    ("worker", "encode_update"), ("worker", "upload"), ("edge", "edge_ingest"),
                    ("edge", "ingest_decode"), ("edge", "ingest_fold"),
                    ("edge", "edge_partial_upload"), ("manager", "ingest_decode"),
                    ("manager", "ingest_fold"), ("manager", "aggregate"))
# the keys of edge_round_split that are the root's partial folds
EDGE_SPLIT_ROOT = ("partial_ship", "root_decode", "root_fold", "merge", "partials")


def edge_round_split(spans):
    """A round's split behind edges from its trace (the manager's spans and
    those its edges and workers shipped), in seconds, each tier's spans
    against its own: the manager's setup, the workers' local train (mean
    and max) and upload encode, the transfer to the edge (the worker's
    upload less the edge's ingest of it: the edge answers once it has
    folded), the edge's ingest, decode and fold of one upload; then the
    root's partial folds: an edge's partial shipped (its transfer and the
    root's ingest), the root's decode and fold of one partial, and the
    merge."""
    by = {}
    for s in spans:
        by.setdefault((tier_of(s), s["name"]), []).append(s["end"] - s["start"])
    missing = [n for n in EDGE_SPLIT_NEEDS if not by.get(n)]
    check(not missing, f"spans missing from the round's trace: {missing} (has {sorted(by)})")
    mean = {n: float(np.mean(v)) for n, v in by.items()}
    return {"setup": mean["manager", "round_setup"],
            "local_train": mean["worker", "local_train"],
            "local_train_max": max(by["worker", "local_train"]),
            "upload_encode": mean["worker", "encode_update"],
            "transfer_to_edge": mean["worker", "upload"] - mean["edge", "edge_ingest"],
            "edge_ingest": mean["edge", "edge_ingest"],
            "edge_decode": mean["edge", "ingest_decode"], "edge_fold": mean["edge", "ingest_fold"],
            "uploads": len(by["worker", "upload"]),
            "partial_ship": mean["edge", "edge_partial_upload"],
            "root_decode": mean["manager", "ingest_decode"],
            "root_fold": mean["manager", "ingest_fold"], "merge": mean["manager", "aggregate"],
            "partials": len(by["manager", "ingest_fold"])}


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
                          manager_kw=None, worker_kw=None, heartbeat_time=30.0, edges=0):
    """A Manager (built with ``manager_kw``) and one ExperimentWorker (built
    with ``worker_kw``) per dataset on loopback, all on the card;
    ``rounds(fed)`` runs the rounds. ``fed.exp`` is the current manager's
    experiment, ``fed.url`` its base URL and ``fed.workers`` the workers;
    ``await fed.drive()``
    starts a round and returns its seconds from ``start_round`` until
    ``rounds.n_rounds`` advances; ``await fed.start()`` only starts one
    (returning its start time) and ``await fed.wait_round(n0, t0)`` waits
    for the count to pass ``n0``; ``await fed.get(path)`` GETs a manager
    endpoint; ``await fed.restart(**kw)`` stops the manager and starts a
    new one on the same port, waiting until every worker has registered
    again; ``fed.meter`` lists ``(kind, bytes)`` of every upload and blob
    download the managers served, and ``fed.bodies`` the upload bodies
    they received. With ``edges`` > 0 that many ``EdgeAggregator``s stand
    between the manager and the workers (each ships its partial
    ``EDGE_SETTLE_S`` after its last worker reported, and ships part of its
    cohort only after ``ROUND_LIMIT_S``, so a slow warm-up ships whole), worker
    ``i`` behind edge ``i * edges // len(datasets)``: ``fed.edges`` are
    they, ``fed.edge_urls`` their experiment bases, ``fed.edge_meter``
    lists ``(edge, kind, bytes)`` of every upload and blob download they
    served, and ``fed.edge_bodies`` ``(edge, body)`` of the uploads they
    received. Returns what ``rounds`` returns, with those bodies and the
    devices the trainers were handed."""
    import asyncio
    import socket
    import types

    import aiohttp
    from aiohttp import web

    from baton_tpu_torch.core.training import make_local_trainer
    from baton_tpu_torch.server.edge import EdgeAggregator
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

    bodies, seen, meter, edge_meter, edge_bodies = [], [], [], [], []
    # the timer waits on the manager's end of a round, not on a busy poll
    # of the event loop that the manager and every worker share
    round_ended, loop = asyncio.Event(), asyncio.get_running_loop()

    def metering_into(note):
        @web.middleware
        async def metering(request, handler):
            resp = await handler(request)
            if request.path.endswith("/update"):
                note("upload", request.content_length or 0)
            elif "/round_blob/" in request.path and resp.status == 200:
                note("blob", resp.content_length or 0)
            return resp
        return metering

    metering = metering_into(lambda kind, n: meter.append((kind, n)))

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

    def recording_edge(edge, i):
        ingest = edge._ingest_cohort_update

        async def recording_ingest(client_id, body, content_type):
            edge_bodies.append((i, bytes(body)))
            return await ingest(client_id, body, content_type)

        edge._ingest_cohort_update = recording_ingest
        return edge

    async def wait_registered():
        # each edge registers at the manager too
        want = len(fed.workers) + len(fed.edges)
        for _ in range(3000):
            if len(fed.exp.registry) == want:
                break
            await asyncio.sleep(0.01)
        check(len(fed.exp.registry) == want, f"{len(fed.exp.registry)} of {want} registered")

    sock, mport = listen()
    app, exp = build_manager(manager_kw or {})
    fed = types.SimpleNamespace(exp=exp, url=f"http://127.0.0.1:{mport}/httpround", workers=[],
                                meter=meter, bodies=bodies, edges=[],
                                edge_urls=[], edge_meter=edge_meter, edge_bodies=edge_bodies,
                                runner=await serve(app, sock))
    runners, edge_runners, edge_addrs = [], [], []
    for i in range(edges):
        esock, eport = listen()
        eapp = web.Application(middlewares=[metering_into(
            lambda kind, n, i=i: edge_meter.append((i, kind, n)))])
        fed.edges.append(recording_edge(EdgeAggregator(
            eapp, f"127.0.0.1:{mport}", name="httpround", port=eport, edge_name=f"e{i}",
            ship_settle_s=EDGE_SETTLE_S, flush_after_s=ROUND_LIMIT_S), i))
        edge_addrs.append(f"127.0.0.1:{eport}")
        fed.edge_urls.append(f"http://127.0.0.1:{eport}/httpround")
        edge_runners.append(await serve(eapp, esock))
    for j, (d, seed) in enumerate(zip(datasets, seeds)):
        wsock, wport = listen()
        wapp = web.Application()
        trainer = recording_trainer(make_local_trainer(model, batch_size=batch,
                                                       learning_rate=lr), seen)
        edge = edge_addrs[j * edges // len(datasets)] if edges else None
        fed.workers.append(ExperimentWorker(
            wapp, model, f"127.0.0.1:{mport}", name="httpround", port=wport,
            heartbeat_time=heartbeat_time, rng_seed=seed, trainer=trainer,
            get_data=lambda d=d: (d, d["x"].shape[0]), edge=edge, **(worker_kw or {})))
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
        # an edge declines its own invitation: it aggregates, it trains nothing
        check(len(acks) == len(fed.workers) + len(fed.edges)
              and sum(map(bool, acks.values())) == len(fed.workers), f"acks {acks}")
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
        for r in runners + edge_runners + [fed.runner]:
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

    n_workers, per_worker, batch, lr, n_timed = 8, 48, 32, 0.05, 2  # n_timed cut from 3
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


# phase 24: the operations planes on the card (the edge tier, the ops
# console and the loadgen), with phase 11's federation and helpers.

EDGES = 2  # 24a: edges under the root, phase 11's 8 workers 4 an edge
EDGE_TIMED_ROUNDS = 1  # 24a: after a warm-up (cut from 2, PERF.md §4)
CONSOLE_LIMIT_S = 120.0  # 24b: the console's subprocess, its import of torch included
# 24c: benchmarks/scenarios/edge_cohort.json's values, its baseline (the JAX
# package's numbers) left out: 8 workers of a linear model (dim 10, batch
# 32) behind 2 edges, steady / edge_loss (edge 1 killed) / recovery
EDGE_COHORT = {
    "name": "edge_cohort", "seed": 11, "model": {"dim": 10},
    "workers": {"count": 8, "heartbeat_time": 0.5, "batch_size": 32, "min_batches": 2,
                "max_batches": 2, "learning_rate": 0.02},
    "edges": {"count": 2, "flush_after_s": 3.0, "heartbeat_time": 1.0, "retry_s": 60.0},
    "manager": {"round_timeout": 5.0, "client_ttl": 6.0, "cohort_fraction": 1.0,
                "min_cohort": 1, "ingest_workers": 2},
    "rounds": {"n_epoch": 1, "interval_s": 2.0, "max_rounds": 10, "warmup": 1},
    "phases": [
        {"name": "steady", "duration_s": 8, "availability": {"kind": "step", "level": 1.0}},
        {"name": "edge_loss", "duration_s": 8, "availability": {"kind": "step", "level": 1.0},
         "kill_edges": [1]},
        {"name": "recovery", "duration_s": 6, "availability": {"kind": "step", "level": 1.0}},
    ],
    "slo": {"assertions": [
        {"metric": "rounds.total", "op": ">=", "value": 8},
        {"metric": "rounds.completion_rate", "op": ">=", "value": 0.7},
        {"metric": "loadgen:scenario_rounds_forced_end", "op": "==", "value": 0},
        {"metric": "rounds.participants_mean", "op": ">=", "value": 5},
        {"metric": "counter:updates_received_edge_partial", "op": ">=", "value": 1},
        {"metric": "edge:counter:edge_partials_shipped", "op": ">=", "value": 1},
        {"metric": "loadgen:scenario_edges_killed", "op": "==", "value": 1},
        {"metric": "counter:updates_refused_edge_secure", "op": "==", "value": 0},
        {"metric": "loadgen:scenario_start_round_errors", "op": "==", "value": 0},
        {"metric": "history:samples", "op": ">=", "value": 2},
        {"metric": "history:rate:updates_received", "op": ">", "value": 0.0},
    ]},
}


def edge_fold_terms(per_edge: int, n_edges: int, fold_shards: int) -> int:
    """The fp32 roundings an upload meets on its way into the root's params
    through an edge: the edge's product w·x, its ``per_edge`` additions
    (``StreamingMean``) and its division by the cohort's weight; the root's
    product of that mean by the weight, its ``n_edges`` additions, the
    merge of its ``fold_shards`` partial sums and its division by the whole
    weight."""
    return 1 + per_edge + 1 + 1 + n_edges + fold_shards + 1


def hold_edge_fold(params, uploads, per_edge, n_edges, fold_shards) -> dict:
    """The root's params (fp32 arrays) against the float64 fold of the
    uploads the workers sent (BTW1 bodies), ``Σ w·x / Σ w``: at every
    element within ``γ(edge_fold_terms) · Σ w·|x| / Σ w``, the worst case
    of the two-level fp32 fold (the weights are sample counts, exact in
    fp32). Returns the largest gap, its largest share of the bound, the
    count of terms and γ."""
    sums, mags, total = upload_sums(uploads)
    terms = edge_fold_terms(per_edge, n_edges, fold_shards)
    g = gamma(terms)
    check(set(params) == set(sums),
          f"params and uploads name different tensors: {sorted(set(params) ^ set(sums))}")
    worst, share = 0.0, 0.0
    for k in params:
        gap = np.abs(np.asarray(params[k], np.float64) - sums[k] / total)
        bound = g * mags[k] / total
        over = gap > bound
        check(not over.any(), f"{k}: the root's params differ from the float64 fold of the "
              f"uploads by {float(gap.max()):.3e}, beyond gamma({terms}) = {g:.3e} of "
              f"sum w|x| / sum w at {int(over.sum())} elements")
        worst = max(worst, float(gap.max()))
        share = max(share, float(np.max(gap / np.maximum(bound, np.finfo(np.float64).tiny))))
    return {"max_gap": worst, "max_share_of_bound": share, "terms": terms, "gamma": g}


def check_edge_round(label, got, n_workers, n_edges) -> None:
    """Phase 24a's counts of one round (``edge_rounds``): the root served
    the round blob once an edge and the edges once a worker; the root
    received one ``edge_partial`` update an edge, no direct update, and
    the partials credit every worker once; each edge shipped one partial
    and received its workers' uploads."""
    check(got["root_blobs"] == n_edges,
          f"{label}: the root served the blob {got['root_blobs']} times, not once an edge")
    check(got["edge_blobs"] == n_workers,
          f"{label}: the edges served the blob {got['edge_blobs']} times, not once a worker")
    check(got["partials"] == n_edges and got["direct"] == 0,
          f"{label}: the root received {got['partials']} edge partials and {got['direct']} "
          f"direct updates")
    check(got["root_uploads"] == n_edges, f"{label}: {got['root_uploads']} uploads to the root")
    check(got["partials_shipped"] == n_edges,
          f"{label}: edge_partials_shipped rose by {got['partials_shipped']}")
    check(len(got["credited"]) == n_workers and len(set(got["credited"])) == n_workers,
          f"{label}: the partials credit {got['credited']}")
    check(len(got["uploads"]) == n_workers,
          f"{label}: the edges received {len(got['uploads'])} uploads")


def tier_of(span) -> str:
    """The tier of a span's service: ``manager``, ``edge``, ``worker`` or,
    for any other, the service itself."""
    service = span.get("service", "")
    return next((t for t in ("manager", "edge", "worker") if service.startswith(t)), service)


def trace_tiers(spans) -> dict:
    """The spans of one trace by tier: the manager's, the edges' and the
    workers' services."""
    return dict(collections.Counter(tier_of(s) for s in spans))


async def edge_rounds(fed, n_timed) -> list:
    """Phase 24a's rounds: a warm-up and ``n_timed`` rounds through the
    edges of ``fed`` (``http_federation(edges=...)``). For each round, its
    seconds and what crossed the tiers: blob downloads and uploads the
    root and the edges served, the bodies the root received (edge
    partials or direct), the workers each partial credits, the edges'
    fold and blob-fetch seconds from the partials' meta, the uploads the
    edges received, and the root's params after it."""
    import asyncio

    from baton_tpu_torch.server import wire
    from baton_tpu_torch.server.state import params_to_state_dict

    def shipped():
        return sum(e.metrics.snapshot()["counters"].get("edge_partials_shipped", 0)
                   for e in fed.edges)

    out = []
    for _ in range(n_timed + 1):
        at = (len(fed.meter), len(fed.edge_meter), len(fed.bodies), len(fed.edge_bodies),
              shipped())
        seconds = await fed.drive()
        # the root ends the round on the last partial's fold, before that
        # edge has its answer
        t0 = time.perf_counter()
        while (shipped() - at[4] < len(fed.edges)
               and time.perf_counter() - t0 < EDGE_SHIP_LIMIT_S):
            await asyncio.sleep(0.01)
        metas = [wire.decode(b)[1] for b in fed.bodies[at[2]:]]
        partials = [m["edge_partial"] for m in metas if m.get("edge_partial")]
        root_kinds = collections.Counter(kind for kind, _ in fed.meter[at[0]:])
        edge_kinds = collections.Counter(kind for _, kind, _ in fed.edge_meter[at[1]:])
        out.append({
            "s": seconds, "round": metas[0]["update_name"] if metas else None,
            "root_blobs": root_kinds["blob"], "root_uploads": root_kinds["upload"],
            "edge_blobs": edge_kinds["blob"], "partials": len(partials),
            "direct": len(metas) - len(partials), "partials_shipped": shipped() - at[4],
            "credited": [c for p in partials for c in p["contributors"]],
            "edge_fold_s": [p["phase_s"]["fold"] for p in partials],
            "edge_blob_fetch_s": [p["phase_s"]["blob_fetch"] for p in partials],
            "uploads": [b for _, b in fed.edge_bodies[at[3]:]],
            "params": params_to_state_dict(fed.exp.params)})
    return out


async def console_probe(root_url, edge_urls, rounds_path):
    """``python -m baton_tpu_torch.ops --once --json`` against a root and
    its edges, in a subprocess under ``CONSOLE_LIMIT_S``, killed if it
    outlives it: ``(exit code, the poll state, stderr)``."""
    import asyncio

    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "baton_tpu_torch.ops", "--once", "--json", "--root", root_url,
        "--edges", ",".join(edge_urls), "--rounds", str(rounds_path), cwd=str(ROOT),
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
    try:
        out, err = await asyncio.wait_for(proc.communicate(), CONSOLE_LIMIT_S)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    state = json.loads(out) if out.strip() else None
    return proc.returncode, state, err.decode(errors="replace")


def check_console(rc, state, err) -> None:
    """Phase 24b: the console exited 0, every node it polled answered and
    no ``page`` alert fires anywhere in the fleet."""
    from baton_tpu_torch.ops.console import firing_alerts

    check(state is not None, f"the console printed no state (exit {rc}): {err[-2000:]}")
    down = [n["url"] for n in [state["root"], *state["edges"]] if not n["up"]]
    check(not down, f"the console found these nodes down: {down}")
    pages = firing_alerts(state, severity="page")
    check(not pages, f"page alerts fire: {[(p.get('node'), p.get('name')) for p in pages]}")
    check(rc == 0, f"the console exited {rc}: {err[-2000:]}")


def edge_tier_phase(fa, flat):
    """Phase 24a-b: phase 11's federation (ResNet-18 as ``bench.py``, bf16
    compute, 8 workers x 48 samples drawn as phase 6 draws them, batch 32,
    lr 0.05, all on the card in this process) behind ``EDGES`` edge
    aggregators of 4 workers each under one root Manager: a warm-up and
    ``EDGE_TIMED_ROUNDS`` timed rounds, each held by ``check_edge_round``
    and ``hold_edge_fold``, one round's trace across the three tiers, and
    the ops console run against the root and the edges while they are up.
    ``flat`` is phase 11's stats (same workers, no edges)."""
    import asyncio
    import tempfile

    from baton_tpu_torch.models.resnet import resnet18_cifar_model
    from baton_tpu_torch.obs.compute import validate_record
    from baton_tpu_torch.ops.console import _compute_line
    from baton_tpu_torch.server import wire
    from baton_tpu_torch.utils import tracing

    n_workers, per_worker, batch, lr = 8, 48, 32, 0.05
    rng = np.random.default_rng(0)  # drawn as phase 6 draws its clients
    datasets = [{"x": rng.normal(size=(per_worker, 32, 32, 3)).astype(np.float32),
                 "y": rng.integers(0, 10, size=(per_worker,)).astype(np.int32)}
                for _ in range(n_workers)]
    model = resnet18_cifar_model(compute_dtype=torch.bfloat16, conv_impl="direct")
    print(f"phase 24a: phase 11's federation behind {EDGES} EdgeAggregators of "
          f"{n_workers // EDGES} workers each under one root Manager, all on the card: "
          f"ResNet-18 (bf16 compute), {per_worker} samples a worker, batch {batch}, lr {lr}; "
          f"a warm-up and {EDGE_TIMED_ROUNDS} timed rounds; edges ship "
          f"{EDGE_SETTLE_S} s after their last worker")

    with tempfile.TemporaryDirectory() as log_dir:
        rounds_path = Path(log_dir) / "rounds.jsonl"

        async def rounds(fed):
            got = await edge_rounds(fed, EDGE_TIMED_ROUNDS)
            # 24b: the console while the root and the edges are up
            console = await console_probe(fed.url, fed.edge_urls, rounds_path)
            trace = {r["round"]: fed.exp.tracer.spans_for(
                tracing.make_trace_id(fed.exp.name, r["round"])) for r in got}
            return got, console, trace, fed.exp.fold_shards

        (got, console, trace, fold_shards), _, seen = asyncio.run(http_federation(
            model, datasets, seeds=range(n_workers), lr=lr, batch=batch, log_dir=log_dir,
            rounds=rounds, edges=EDGES))
    check(all(devs == ["cuda"] for devs in seen), f"a trainer was handed CPU tensors: {seen}")
    name = torch.cuda.get_device_name(0)
    folds = []
    for i, r in enumerate(got):
        label = f"round {i}" + (" (warm-up)" if i == 0 else "")
        check_edge_round(label, r, n_workers, EDGES)
        folds.append(hold_edge_fold(r["params"], r["uploads"], n_workers // EDGES, EDGES,
                                    fold_shards))
        computes = [wire.decode(b)[1].get("compute") or {} for b in r["uploads"]]
        check(all(c.get("device_kind") == name and validate_record(c) == [] for c in computes),
              f"{label}: a worker's compute record does not name the card or is invalid")
        check(all(np.isfinite(v).all() for v in r["params"].values()), f"{label}: non-finite")
    timed = got[1:]
    tiers = trace_tiers(trace[timed[0]["round"]])
    check(all(tiers.get(t) for t in ("manager", "edge", "worker")),
          f"the trace of {timed[0]['round']} lacks a tier: {tiers}")
    rc, state, err = console
    check_console(rc, state, err)
    pane = _compute_line(state["root"], "root")
    tail = (state["rounds_tail"] or [{}])[-1].get("compute") or {}
    check(pane is not None and tail.get("peak_hbm_gb_source") == "torch.cuda.max_memory_allocated",
          f"the console's compute pane shows no card's numbers: {pane}; rounds tail {tail}")
    flash = fa.launches()
    check(all(n == 0 for n in flash.values()), f"flash kernels launched in phase 24a: {flash}")
    times = [r["s"] for r in timed]
    s_mean = float(np.mean(times))
    split = mean_split([edge_round_split(trace[r["round"]]) for r in timed])
    stats = {"round_s": times, "s_per_round": s_mean, "warm_up_s": got[0]["s"],
             "samples_per_s": n_workers * per_worker / s_mean,
             "flat_s_per_round": flat.get("s_per_round"),
             "edge_fold_s": [r["edge_fold_s"] for r in timed],
             "edge_blob_fetch_s": [r["edge_blob_fetch_s"] for r in timed],
             "blob_fetches_at_root": [r["root_blobs"] for r in timed],
             "blob_fetches_saved_at_root": [n_workers - r["root_blobs"] for r in timed],
             "fold": folds, "trace_tiers": tiers, "split": split,
             "console": {"rc": rc, "nodes_up": 1 + len(state["edges"]), "compute_pane": pane,
                         "peak_hbm_gb_source": tail.get("peak_hbm_gb_source")}}
    print(f"  s/round mean {s_mean:.4f} (rounds 1-{len(times)}: "
          f"{', '.join(f'{t:.4f}' for t in times)}; warm-up {got[0]['s']:.4f}); phase 11's "
          f"flat round with the same workers {flat.get('s_per_round')}")
    print("  edges' fold s a round (edge 0, edge 1): " + "; ".join(
        ", ".join(f"{x:.4f}" for x in r["edge_fold_s"]) for r in timed)
        + "; their blob fetch from the root: " + "; ".join(
        ", ".join(f"{x:.4f}" for x in r["edge_blob_fetch_s"]) for r in timed))
    print(f"  each round: the root served the blob {EDGES} times (flat: {n_workers}), the "
          f"edges {n_workers}; the root received {EDGES} edge partials crediting all "
          f"{n_workers} workers and no direct update")
    print("  root params against the float64 fold of the uploads: " + "; ".join(
        f"max |diff| {f['max_gap']:.3e}, {f['max_share_of_bound']:.3f} of the bound "
        f"gamma({f['terms']}) = {f['gamma']:.3e} of sum w|x| / sum w" for f in folds))
    print(f"  trace of {timed[0]['round']}: spans by tier {tiers}")
    print("  split of a round (mean of the timed rounds, s; workers to edges): " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items() if k not in EDGE_SPLIT_ROOT))
    print("  the root's partial folds (mean of the timed rounds, s): " + ", ".join(
        f"{k} {split[k]:.4f}" for k in EDGE_SPLIT_ROOT))
    print(f"phase 24b: python -m baton_tpu_torch.ops --once --json: exit {rc}, "
          f"{1 + len(state['edges'])} nodes up, no page alert;\n  {pane.strip()}; rounds "
          f"tail peak HBM from {tail.get('peak_hbm_gb_source')}")
    return stats


def scenario_cli(scenario: dict, work, device: str) -> dict:
    """``python -m baton_tpu_torch.loadgen <scenario.json> --device <device>
    --artifacts <work>/artifacts``, run in this process through the CLI's
    ``main`` with ``scenario`` written to ``<work>/<name>.json``: its exit
    code, seconds, ``slo_report.json``, round records and the loadgen's and
    the workers' counters."""
    from baton_tpu_torch.loadgen.__main__ import main
    from baton_tpu_torch.utils.slog import read_rounds_jsonl

    work = Path(work)
    path, art = work / f"{scenario['name']}.json", work / "artifacts"
    path.write_text(json.dumps(scenario))
    t0 = time.perf_counter()
    rc = main([str(path), "--device", device, "--artifacts", str(art)])
    run_s = time.perf_counter() - t0
    report = art / "slo_report.json"
    counters = lambda name: json.loads((art / name).read_text())["counters"]  # noqa: E731
    return {"rc": rc, "run_s": run_s,
            "report": json.loads(report.read_text()) if report.exists() else None,
            "records": read_rounds_jsonl(str(art / "rounds.jsonl"))[0],
            "loadgen": counters("loadgen_metrics.json"),
            "fleet": counters("worker_metrics.json")}


def scenario_peak_sources(records) -> set:
    """Where the workers' compute records of a scenario's completed rounds
    took their peak memory from (``peak_hbm_gb_source``; where it is null,
    the reason)."""
    return {(r.get("compute") or {}).get("peak_hbm_gb_source")
            or (r.get("compute") or {}).get("peak_hbm_gb_reason")
            for r in records if r.get("outcome") == "completed"}


def check_scenario_run(run) -> None:
    """Phase 24c (``scenario_cli``'s result): the CLI exited 0, every SLO
    assertion passes, every recorded round reached a terminal outcome and
    none was forced to end, and the killed edge's workers fell back to the
    root directly."""
    report, records = run["report"], run["records"]
    check(report is not None, f"the CLI wrote no slo_report.json (exit {run['rc']})")
    failed = [(a["metric"], a["op"], a["value"], a["observed"])
              for a in report["assertions"] if a["status"] != "pass"]
    check(not failed and report["pass"], f"SLO assertions failed: {failed}")
    check(run["rc"] == 0, f"the CLI exited {run['rc']}")
    stuck = [r.get("round") for r in records
             if not (r.get("outcome") == "completed" or str(r.get("outcome")).startswith("aborted:"))]
    check(records and not stuck, f"rounds without a terminal outcome: {stuck}")
    check(run["loadgen"].get("scenario_rounds_forced_end", 0) == 0,
          "the drain forced a round to end")
    check(run["fleet"].get("edge_route_fallbacks", 0) > 0,
          "no worker fell back from the killed edge to the root")


def loadgen_phase():
    """Phase 24c: the reference's ``edge_cohort`` scenario (``EDGE_COHORT``)
    through the port's loadgen CLI on the card (``scenario_cli`` with
    ``--device cuda``), its SLO block through the port's ``evaluate_slo``."""
    import tempfile

    from baton_tpu_torch.loadgen.scenario import parse_scenario

    scn = parse_scenario(EDGE_COHORT)
    check(len(scn.slo.assertions) == 11 and scn.slo.baseline is None,
          "edge_cohort's SLO block is not its 11 assertions without a baseline")
    print(f"phase 24c: python -m baton_tpu_torch.loadgen {scn.name}.json --device cuda: "
          f"{scn.workers.count} workers (linear, dim {scn.model_dim}, batch "
          f"{scn.workers.batch_size}) behind {scn.edges.count} edges, phases " + ", ".join(
              f"{p.name} {p.duration_s:g} s" for p in scn.phases))
    with tempfile.TemporaryDirectory() as work:
        run = scenario_cli(EDGE_COHORT, work, "cuda")
    check_scenario_run(run)
    report, fleet = run["report"], run["fleet"]
    peaks = scenario_peak_sources(run["records"])
    check(peaks == {"torch.cuda.max_memory_allocated"},
          f"the workers' compute records of the completed rounds take their peak memory from "
          f"{peaks}, not the card's allocator")
    stats = {"run_s": run["run_s"], "rc": run["rc"], "rounds": report["rounds_evaluated"],
             "warmup_rounds": report["rounds_excluded_warmup"],
             "assertions": [{k: a[k] for k in ("metric", "op", "value", "observed", "status")}
                            for a in report["assertions"]],
             "edge_route_fallbacks": fleet.get("edge_route_fallbacks"),
             "peak_hbm_gb_source": sorted(peaks)}
    print(f"  exit {run['rc']}; {report['rounds_evaluated']} rounds "
          f"(+{report['rounds_excluded_warmup']} warm-up) in {run['run_s']:.1f} s; "
          f"{len(report['assertions'])} of {len(report['assertions'])} SLO assertions pass: "
          + "; ".join(f"{a['metric']} {a['op']} {a['value']} ({a['observed']})"
                      for a in report["assertions"]))
    print(f"  edge_route_fallbacks {fleet.get('edge_route_fallbacks')}; the workers' peak "
          f"memory from {sorted(peaks)}")
    return stats


def operations_phase(fa, flat):
    """Phase 24: the edge tier and the console (24a-b), then the loadgen
    (24c); no flash kernel launches in it."""
    fa.reset_launches()
    out = {"edge_tier": timed_phase("24a-b", edge_tier_phase, fa, flat),
           "loadgen": timed_phase("24c", loadgen_phase)}
    flash = fa.launches()
    check(all(n == 0 for n in flash.values()), f"flash kernels launched in phase 24: {flash}")
    return out

# phases 12-14: the HTTP round's remaining options (compressed uploads,
# quantised and delta broadcasts, a manager restart resumed from its
# checkpoints, secure aggregation) and BASELINE config 1.

COMPRESS = "topk:0.1:q8"  # the uploads of phase 12 and its delta broadcasts
EF_TOL = 1e-5  # relative: transmitted plus residual against the sum of the true deltas
SECURE_QUANTUM = 2.0 ** -16  # the fixed point of DEFAULT_SCALE_BITS = 16
SECURE_TOL = SECURE_QUANTUM + HTTP_REPLAY_TOL  # a secure round against its fp32 replay
RESUME_TOL = 1e-6  # config 1 stopped after 2 rounds and resumed, against 4 rounds in one go
CONFIG1_FULL_ROUNDS = 1  # of the full preset's 20: the smoke's time limit
CONFIG1_FULL_EPOCHS = 2  # of the full preset's 4 a round (cut from 4, PERF.md §4)
BANDWIDTH_ROUNDS = 1  # phase 12 (a), before the restart: cut from 3, then 2 (PERF.md §4)


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
    manager restart. (a) ``BANDWIDTH_ROUNDS`` rounds: every worker uploads
    top-k (10%) int8 round deltas with error feedback, the manager
    broadcasts int8 weights and checkpoints every round. (b) The manager stops; a new one on the
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
        for r in range(BANDWIDTH_ROUNDS):
            out["rounds"].append(await one_round(fed, f"(a) round {r}"))
        saved = params_to_state_dict(fed.exp.params)
        n_rounds, losses = fed.exp.rounds.n_rounds, list(fed.exp.rounds.loss_history)
        t0 = time.perf_counter()
        await fed.restart(broadcast_delta=COMPRESS, checkpoint_dir=ckdir)
        out["restart_s"] = time.perf_counter() - t0
        exp = fed.exp
        check(exp.rounds.n_rounds == n_rounds == BANDWIDTH_ROUNDS,
              f"resumed at round {exp.rounds.n_rounds}")
        check([float(x) for x in exp.rounds.loss_history] == [float(x) for x in losses],
              "the resumed loss history differs")
        restored = params_to_state_dict(exp.params)
        check(all(v.device.type == "cuda" for v in exp.params.values()),
              "the resumed params are not on the card")
        check(all(np.array_equal(restored[k], v) for k, v in saved.items()),
              "the resumed params differ from the checkpointed ones")
        fetched = counters(fed.workers, "blob_fetch_delta")
        for r in range(2):  # a full blob pull, then a delta
            out["rounds"].append(await one_round(fed, f"(b) round {r}"))
        delta_pulls = counters(fed.workers, "blob_fetch_delta") - fetched
        mismatches = counters(fed.workers, "blob_delta_digest_mismatch")
        check(delta_pulls == n_workers, f"{delta_pulls} delta pulls, not {n_workers}")
        check(mismatches == 0, f"{mismatches} delta reconstructions missed the blob's digest")
        full, delta = (out["rounds"][BANDWIDTH_ROUNDS]["blob_bytes"],
                       out["rounds"][BANDWIDTH_ROUNDS + 1]["blob_bytes"])
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
    print(f"  restart: the new manager resumed round {BANDWIDTH_ROUNDS}, its loss history and "
          f"params to the bit, "
          f"{out['restart_s']:.2f} s until every worker registered again; delta pulls "
          f"{out['delta_pulls']:.0f}, digest mismatches {out['digest_mismatches']:.0f}")
    print(f"  error feedback (sent + residual against the true deltas, relative, "
          f"{len(out['rounds'])} rounds): "
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
    ``CONFIG1_FULL_ROUNDS`` of ``CONFIG1_FULL_EPOCHS`` epochs, timed apart
    from making its data, and held to the example's own check (accuracy
    above 0.5)."""
    import tempfile

    from baton_tpu_torch.examples import cnn_mnist_fedavg as config1

    print("phase 14: BASELINE config 1 (2-layer CNN, 4 clients of the synthetic MNIST "
          "fallback, SGD 0.01 momentum 0.9, batch 32); the tiny preset's gate (64 samples a "
          "client, 2 epochs, 4 rounds) with torch.backends.cudnn.deterministic = True, then "
          f"the full preset (15,000 samples a client) for {CONFIG1_FULL_ROUNDS} of its 20 rounds "
          f"of {CONFIG1_FULL_EPOCHS} of its 4 epochs")
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

    n_per_client, n_epochs = 15000, CONFIG1_FULL_EPOCHS
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
    t0 = time.perf_counter()
    card = variant_runs(model, params, second, data, n_samples, batch, lr, perms, device,
                        shards[0], buffer)
    t1 = time.perf_counter()
    cpu = variant_runs(model, params, second, data, n_samples, batch, lr, perms, "cpu",
                       shards[1], buffer)
    print(f"  the runs on {device} took {t1 - t0:.1f} s, on the CPU "
          f"{time.perf_counter() - t1:.1f} s")
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
    more forward launches, the clustered grid's), every one on its pass's
    bf16 design (``BF16_KEYS``). Returns ``by_pass``."""
    want = {"fwd": n_layers * (steps + fwd_extra), "bwd_dkv": n_layers * steps,
            "bwd_dq": n_layers * steps}
    check(by_pass == want, f"{name}: launches {by_pass}, want {want}")
    check(set(by_design) <= set(BF16_KEYS.values()),
          f"{name}: launches by design {by_design}, want every launch on "
          f"{'/'.join(BF16_KEYS.values())}")
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


def short_of(got, want) -> bool:
    """Whether a profiler's count ``got`` (an int or ``{pass: n}``) is below
    ``want`` and nowhere above it: what a dropped activity record gives."""
    if isinstance(want, dict):
        return (all(got.get(k, 0) <= n for k, n in want.items()) and set(got) <= set(want)
                and got != want)
    return got < want


def observed(run, traced_of, want, label):
    """``run()`` under the profiler, and once more if the flash launches it
    saw (``traced_of`` of the result; None without a trace) fall short of
    ``want``: the profiler's activity buffers may drop a record of the tens
    of thousands a fused run makes, while the launches are the same in every
    run. A second short count, or any count above ``want``, is left to the
    caller's exact check. Returns the last result."""
    out = run()
    got = traced_of(out)
    if got is not None and short_of(got, want):
        print(f"  {label}: the profiler saw {got} flash launches, want {want}: a record "
              "dropped; profiling the same run once more")
        out = run()
    return out


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


RECORD_MFU_TOL = 1e-3  # 16a: the compute record's MFU against 4·P·tokens over its train_s
LLAMA_FAMILY = "llama_lm"  # 16a registers it by the model's name prefix


@contextlib.contextmanager
def registered_flops(family: str, flops_per_sample: float, name_prefixes):
    """``register_model_flops`` as a user calls it, for the block; the FLOPs
    tables as they were after it, so later phases see the same tables."""
    from baton_tpu_torch.obs import compute

    flops, prefixes = dict(compute.MODEL_FAMILY_FLOPS), list(compute._FAMILY_PREFIXES)
    compute.register_model_flops(family, flops_per_sample, name_prefixes=name_prefixes)
    try:
        yield
    finally:
        compute.MODEL_FAMILY_FLOPS.clear()
        compute.MODEL_FAMILY_FLOPS.update(flops)
        compute._FAMILY_PREFIXES[:] = prefixes


def check_unregistered_record(label, rec, model_name) -> None:
    """A round's compute record before its family is registered: no family
    and no MFU, each null with its reason."""
    check(rec is not None and rec["model_family"] is None
          and model_name in rec.get("model_family_reason", "")
          and rec["mfu"] is None and bool(rec.get("mfu_reason")),
          f"{label}: before registration the record's family and MFU must be null with a "
          f"reason: {rec}")


def check_record_mfu(label, rec, flops_per_round, peak_flops) -> tuple:
    """A round's compute record against the smoke's own 4·P·tokens MFU over
    the record's train_s, within ``RECORD_MFU_TOL`` relative. Returns
    (the record's MFU, the smoke's)."""
    want = flops_per_round / rec["train_s"] / peak_flops
    got = rec.get("mfu")
    check(got is not None and abs(got - want) <= RECORD_MFU_TOL * want,
          f"{label}: the record's MFU {got} ({rec.get('mfu_reason')}) against 4·P·tokens "
          f"over its train_s {want:.6f} (tol {RECORD_MFU_TOL} relative)")
    return got, want


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
    gathered first). A card's tensor comes to the host through one pinned
    buffer reused for every tensor: a fresh pageable copy of each took 18 s
    for the 8B base. Returns the number compared."""
    from baton_tpu_torch.parallel.tensor_parallel import gather_params

    staging = None
    for name, before in host_copy.items():
        now = gather_params(params[name])
        check(now.dtype == before.dtype and now.shape == before.shape,
              f"frozen tensor {name} changed its dtype or shape")
        if now.device.type == "cuda":
            if staging is None:
                staging = torch.empty(max(v.numel() * v.element_size()
                                          for v in host_copy.values()),
                                      dtype=torch.uint8, pin_memory=True)
            host = staging[:before.numel() * before.element_size()].view(before.dtype)
            now = host.view(before.shape).copy_(now)
        check(torch.equal(now, before), f"frozen tensor {name} changed")
    return len(host_copy)


def config4_phase(fa, name):
    """Phase 16a: BASELINE config 4 at Llama-3-8B width and depth, bf16,
    remat, 4 clients x 16 samples (2 steps each), one wave of what fits;
    a warm-up, the timed rounds and a profiled one. The warm-up runs before
    the Llama family is registered (its record: MFU null with a reason);
    then ``register_model_flops`` gives the family 4·P·L FLOPs a sequence,
    a sim is built as a user would build it, and every later round's record
    carries the MFU, held against the smoke's own; the registration is
    undone when the phase ends. Returns the launches, a round's launches,
    the stats and the context phase 23a continues from (the params on the
    card and the frozen base's host copy: 23a checks the base bit-equal
    after 16a's rounds and its own)."""
    with contextlib.ExitStack() as registration:
        return config4_rounds(fa, name, registration)


def config4_rounds(fa, name, registration):
    """Phase 16a's rounds; ``registration`` holds the family's registration
    until the phase ends."""
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
    times, losses, breakdown, record_mfu = [], [], None, []
    flops = lora_train_flops(n_params, tokens)
    bw, peak_flops = card_peaks(name)
    start = params
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    for r in range(profiled_round + 1):
        if r == 1:  # a user registers the family, then builds the sim
            registration.enter_context(registered_flops(
                LLAMA_FAMILY, lora_train_flops(n_params, cfg.max_len), (LLAMA_FAMILY,)))
            sim, model = llama_lora.make_sim(cfg, rank, batch, "cuda",
                                             compute_dtype=torch.bfloat16, remat=True)
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
        rec = sim.last_compute
        if r == 0:
            check_unregistered_record("config 4 round 0", rec, model.name)
            print(f"  round 0's record before registration: model_family None "
                  f"({rec['model_family_reason']}), mfu None ({rec['mfu_reason']})")
        else:
            got, want = check_record_mfu(f"config 4 round {r}", rec, flops, peak_flops)
            record_mfu.append({"round": r, "record_mfu": got, "smoke_mfu": want,
                               "train_s": rec["train_s"], "family": rec["model_family"],
                               "flops_per_sample": rec["flops_per_sample"]})
            print(f"  round {r}'s record: family {rec['model_family']}, "
                  f"{rec['flops_per_sample']:.4e} FLOP a sample, train_s {rec['train_s']}, "
                  f"mfu {got} against 4·P·tokens over train_s {want:.6f} "
                  f"({abs(got - want) / want:.2e} relative, tol {RECORD_MFU_TOL})")
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
        "record_mfu": record_mfu, "losses": losses, "init_s": init_s,
        "breakdown": breakdown}, ctx


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
    rounds, flash once per layer per step on its bf16 design at L = 197."""
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
    accuracy), each kept beside it. A row ``bwd_pair`` times the two
    backward kernels called back to back against SDPA's backward (dq, dk
    and dv in one call), so both dtypes compare like with like."""
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


def llama_rows(fa, name, rows, extra):
    """``llama_timing_phase`` into the bf16 rows of the kernels line (each
    row's ``llama_shape``) and its backward pair into ``extra``."""
    llama = llama_timing_phase(fa, name)
    extra["llama_bwd_pair_bf16"] = llama.pop("bwd_pair")
    for row in rows:
        row["llama_shape"] = llama[f"flash_{row['pass']}"]


# phases 17-20: BASELINE config 5 (ViT-B/16 with DP-SGD and secure
# aggregation, examples/05_vit_dp_secure.py --scale full in bf16 with remat,
# as benchmarks/tpu_suite.py's vit_dp stage runs it), the wave sizer
# against the allocator, run_rounds_fused as a CUDA graph, and examples 02
# and 09 on the card.

CONFIG5_CLIENTS, CONFIG5_PER_CLIENT = 4, 128  # cut from 16 x 4,096 (PERF.md §4)
CONFIG5_TIMED_ROUNDS = 1  # cut from 20: a warm-up, 1 timed round and a profiled one
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


def fused_against_loop(fa, label, sim, params, data, n_samples, **kw):
    """``FedSim.run_rounds_fused`` against ``run_rounds`` for
    ``FUSED_ROUNDS`` rounds from the same params and generator (after a
    warm-up round; ``kw`` to both, such as ``n_epochs``): timed, then each
    profiled; params (a leaf placed over a model axis gathered) and losses
    within ``FUSED_TOL``. The timed fused run donates (the default) from
    clones of ``params``: every trainable leaf of theirs donated or the
    port's own, none copied, the donated ones the result's (``data_ptr``);
    the profiled one keeps ``params`` (``donate_buffers=False``). The fused
    run's steady s/round is its replays'
    span on the device over the replays, and its busy share the profiled
    device time a round over that. Returns the stats, the flash launches
    the fused run made (the eager round 0 plus the captured ones times the
    replays), the captured launches a round and the fused run's params."""
    from baton_tpu_torch.parallel.tensor_parallel import gather_params

    gen = torch.Generator().manual_seed(1)
    timed(lambda: sim.run_rounds(params, data, n_samples, gen, n_rounds=1, **kw))  # warm-up
    (p_loop, h_loop), dt_loop = timed(lambda: sim.run_rounds(params, data, n_samples, gen,
                                                             n_rounds=FUSED_ROUNDS, **kw))
    # donation on (the default) from clones, since params start the
    # profiled runs below again: the clones' trainable leaves are the result's
    start = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in params.items()}
    before = launch_counts(fa)
    (p_fused, h_fused), dt_fused = timed(lambda: sim.run_rounds_fused(
        start, data, n_samples, gen, n_rounds=FUSED_ROUNDS, **kw))
    # the Python counters saw the eager round 0 and the capture; each replay
    # re-runs the captured launches without Python
    seen, _ = launches_since(fa, before)
    record = dict(sim.last_fused)
    check(record["graph"] and record["replays"] == FUSED_ROUNDS - 1,
          f"{label}: the fused run did not replay a graph: {record}")
    donation = record["donation"]
    trainable = sim._split(start)[0]
    shared = sum(isinstance(v, torch.Tensor) and p_fused[k].data_ptr() == v.data_ptr()
                 for k, v in trainable.items())
    check(donation["copied"] == 0 and 0 < donation["donated"] == shared
          and donation["donated"] + donation["owned"] == len(trainable),
          f"{label}: donation {donation}, {shared} of {len(trainable)} trainable leaves the "
          "result's")
    p_loop, p_whole = gather_params(p_loop), gather_params(p_fused)
    del start
    per_round = {k: n // 2 for k, n in seen.items()}
    launched = {k: per_round[k] * (1 + record["replays"]) for k in per_round}
    err = max((p_loop[k].float() - p_whole[k].float()).abs().max().item() for k in p_loop)
    loss_err = max(abs(a - b) for a, b in zip(h_loop, h_fused))
    bit_equal = all(torch.equal(p_loop[k], p_whole[k]) for k in p_loop) and h_loop == h_fused
    del p_loop, p_whole
    _, loop_prof = profiled(lambda: sim.run_rounds(params, data, n_samples, gen,
                                                   n_rounds=FUSED_ROUNDS, **kw),
                            f"{label} run_rounds")
    # the profiler sees the kernels a graph replays: its flash count must be
    # the eager round's plus the captured launches times the replays
    def flash_seen(prof):
        return prof and prof["by_kind_count"].get("flash attention (this port)", 0)

    _, fused_prof = observed(
        lambda: profiled(lambda: sim.run_rounds_fused(params, data, n_samples, gen,
                                                      n_rounds=FUSED_ROUNDS,
                                                      donate_buffers=False, **kw),
                         f"{label} run_rounds_fused"),
        lambda out: flash_seen(out[1]), sum(launched.values()), label)
    traced = flash_seen(fused_prof)
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
          f"{per_round}, in the fused run {launched} (the profiler saw {traced}); the timed "
          f"fused run donated {donation['donated']} of {len(trainable)} trainable leaves "
          f"({donation['donated_bytes']:,} B), owned {donation['owned']}, copied 0")
    check(err <= FUSED_TOL and loss_err <= FUSED_TOL,
          f"{label}: fused and run_rounds differ: params {err:.3e}, losses {loss_err:.3e}")
    return {"s_per_round_loop": dt_loop / FUSED_ROUNDS, "s_per_round_fused": dt_fused / FUSED_ROUNDS,
            "s_per_round_replay": replay_round_s, "capture_s": record["capture_s"],
            "param_err": err, "loss_err": loss_err, "bit_equal": bit_equal,
            "busy_loop": loop_prof and loop_prof["busy_share"], "busy_replays": busy_replays,
            "device_ms_loop": loop_prof and loop_prof["device_ms"],
            "device_ms_fused": fused_prof and fused_prof["device_ms"],
            "flash_launches_traced": traced, "donation": donation}, launched, per_round, p_fused


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
    bert, launched, per_round, _ = fused_against_loop(fa, "BERT-base", sim, params, data,
                                                      n_samples)
    check(per_round == {"fwd": cfg.n_layers, "bwd_dkv": cfg.n_layers, "bwd_dq": cfg.n_layers},
          f"fused BERT round launches {per_round}")
    del sim, params, data
    torch.cuda.empty_cache()
    data, n_samples = resnet18_cohort()
    sim = FedSim(resnet18_cifar_model(compute_dtype=torch.bfloat16), batch_size=32,
                 learning_rate=0.05)
    params = sim.init(torch.Generator().manual_seed(0))
    resnet, resnet_launched, _, _ = fused_against_loop(fa, "ResNet-18", sim, params, data,
                                                       n_samples)
    check(all(n == 0 for n in resnet_launched.values()), "flash kernels in the ResNet rounds")
    del sim, params, data
    dp = fused_dp_round(fa)
    return {"bert": bert, "resnet18": resnet, "dp": dp, "launches_fused_bert": launched,
            "launches_per_round_fused_bert": per_round}


DP_VIT = dict(image_size=64, patch=16, d_model=128, n_layers=2, n_heads=2, d_ff=256,
              n_classes=10)  # phase 19's DP case (26c's on the card)


def fused_dp_round(fa, mesh=None, n_clients=4, wave=2, vit=DP_VIT):
    """The fused rounds under DP-SGD with noise: a 2-layer ViT (D 64, bf16,
    flash on its bf16 designs) on ``n_clients`` clients x 16 images in waves of
    ``wave``, each wave's noise from device generators registered with the
    graph (one a shard) and seeded before every replay; against
    ``run_rounds`` within ``FUSED_TOL``. ``mesh``: a clients mesh (26c's
    across processes), else meshless; ``vit`` the config (smaller in the
    CPU tests)."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.examples import vit_dp_secure as ex
    from baton_tpu_torch.models.vit import ViTConfig, vit_model
    from baton_tpu_torch.ops.padding import stack_client_datasets
    from baton_tpu_torch.ops.privacy import DPConfig

    cfg = ViTConfig(**vit)
    rng = np.random.default_rng(7)
    data, n_samples = stack_client_datasets(ex.make_data(rng, cfg, n_clients, 16), batch_size=8)
    # ex.make_sim's FedSim, on the mesh
    sim = FedSim(vit_model(cfg, compute_dtype=torch.bfloat16), batch_size=8,
                 learning_rate=ex.LEARNING_RATE, mesh=mesh,
                 dp=DPConfig(clip_norm=CONFIG5_CLIP, noise_multiplier=CONFIG5_SIGMA))
    params = sim.init(torch.Generator().manual_seed(0))
    data = {k: torch.as_tensor(v, device=sim.device) for k, v in data.items()}
    gen = torch.Generator().manual_seed(1)
    p_loop, h_loop = sim.run_rounds(params, data, n_samples, gen, n_rounds=3, wave_size=wave)
    p_fused, h_fused = sim.run_rounds_fused(params, data, n_samples, gen, n_rounds=3,
                                            wave_size=wave, donate_buffers=False)
    record = dict(sim.last_fused)
    err = max((p_loop[k] - p_fused[k]).abs().max().item() for k in p_loop)
    loss_err = max(abs(a - b) for a, b in zip(h_loop, h_fused))
    moved = max((p_loop[k] - params[k]).abs().max().item() for k in p_loop)
    bit_equal = all(torch.equal(p_loop[k], p_fused[k]) for k in p_loop)
    print(f"  DP-SGD (sigma {CONFIG5_SIGMA}), 2-layer ViT, {n_clients} clients in waves "
          f"of {wave}, 3 rounds: max |param diff| {err:.3e}, losses {loss_err:.3e} (tol "
          f"{FUSED_TOL}; max |param change| {moved:.3e}), bit-equal {bit_equal}; {record}")
    check(not record["graph"] if sim.device.type == "cpu"
          else record["graph"] and record["replays"] == 2, f"DP fused run: {record}")
    check(err <= FUSED_TOL and loss_err <= FUSED_TOL,
          f"DP fused and run_rounds differ: params {err:.3e}, losses {loss_err:.3e}")
    return {"param_err": err, "loss_err": loss_err, "bit_equal": bit_equal, "moved": moved,
            "last_fused": record}


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


def ring_block_calls(n: int, causal: bool = True, shards=None) -> int:
    """Flash block calls of one ring pass over ``n`` shards, made for the
    ``shards`` given (default all): each shard's diagonal block, then
    (causal) only the blocks from its past, so shard ``j`` makes ``j + 1``
    and all ``n + n(n-1)/2``; not causal ``n`` a shard, ``n²`` in all."""
    shards = range(n) if shards is None else shards
    return sum(j + 1 if causal else n for j in shards)


def ring_step_launches(n: int, n_layers: int, remat: bool, shards=None) -> dict:
    """Kernel launches of one training step of a causal decoder whose
    attention is a ring × flash of ``n`` shards, made for the ``shards``
    given (default all): a pass's block calls a layer, the forward once
    more under remat (the backward recomputes each block), each backward
    kernel once a block."""
    calls = ring_block_calls(n, shards=shards) * n_layers
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


def model_grad_gap(got, want) -> tuple:
    """(name, gap) of the param whose gradient lies farthest from the
    reference's at its own scale (max |got - want| over max |want|); gap
    inf when the two name different params."""
    if set(got) != set(want):
        return "names", math.inf
    gaps = {k: ((got[k].float() - w.float()).abs().max()
                / w.float().abs().max().clamp_min(1e-30)).item() for k, w in want.items()}
    worst = max(gaps, key=gaps.get)
    return worst, gaps[worst]


def check_model_grads(name, got, want, tol=RING_TOL) -> float:
    """Every param's gradient within ``tol`` of the reference's at its own
    scale (``model_grad_gap``); returns the largest gap."""
    worst, gap = model_grad_gap(got, want)
    check(gap <= tol, f"{name}: gradient of {worst} off by {gap:.3e} of its largest value "
          f"(tol {tol})")
    return gap


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
    flash over 8 shards of the card; step 0 held against the flash model.
    Returns (launches by pass, each step's launches, the one-process ring's
    step 0 for phase 25a: its config, params, tokens, loss and gradients on
    the host, and the median s/step; stats)."""
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
    # phase 25a holds the ring across processes against this one-process ring
    reference = {"config": dataclasses.asdict(cfg), "n": n, "batch": batch,
                 "params": {k: v.cpu() for k, v in params.items()},
                 "tokens": toks.cpu(), "loss": ring_loss,
                 "grads": {k: v.cpu() for k, v in ring_grads.items()}}
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
    reference["median_s_per_step"] = median_s
    return by_pass, measured, reference, {
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
    bias, bf16 and fp32; times of both and of SDPA on the whole sequence,
    and of each kernel alone on it (bf16: beside its operations bound)."""
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
        # each kernel alone on the whole sequence, and (bf16) its operations bound
        bias0 = torch.zeros(b, l, device=q.device)
        scale = d ** -0.5
        out, lse = fa._fwd(q, k, v, bias0, True, scale)
        args = (q, k, v, bias0, dout, lse, (dout.float() * out.float()).sum(-1), True, scale)
        t.update({"kernel_fwd": time_ms(lambda: fa._fwd(q, k, v, bias0, True, scale), iters=1,
                                        warmup=1),
                  "kernel_bwd_dkv": time_ms(lambda: fa._bwd_dkv(*args), iters=1, warmup=1),
                  "kernel_bwd_dq": time_ms(lambda: fa._bwd_dq(*args), iters=1, warmup=1)})
        if dtype == torch.bfloat16:
            from baton_tpu_torch.obs.compute import card_peaks

            pairs = b * hq * l * (l + 1) // 2  # the (query, key) pairs a causal mask keeps
            peak = card_peaks(torch.cuda.get_device_name(0))[1]
            t.update({f"bound_{k}": m * pairs * d / peak * 1e3
                      for k, m in (("kernel_fwd", 4), ("kernel_bwd_dkv", 8), ("kernel_bwd_dq", 6))})
        del out, lse, args
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
    stats, (a)'s one-process ring for phase 25a)."""
    torch.cuda.empty_cache()
    launches, per_step, reference, stats = long_context_phase(fa)
    torch.cuda.empty_cache()
    stats = {"long_context": stats, "striped": striped_phase(fa)}
    torch.cuda.empty_cache()
    stats["ring_flash_alone"] = ring_flash_alone_phase(fa)
    block_rows, pairs = ring_block_times(fa, name)
    stats["ring_block_bwd_pair_fp32"] = pairs["float32"]
    stats["ring_block_bwd_pair_bf16"] = pairs["bfloat16"]
    stats["seams"] = ring_seams_phase()
    return launches, per_step, block_rows, stats, reference


def ring_block_times(fa, name, dtypes=(torch.float32, torch.bfloat16)):
    """``attention_times`` at the ring block's shape, not causal (28 of a
    layer's 36 block calls), per dtype: ({kernel: {dtype: row}}, {dtype:
    the backward pair's row})."""
    block_rows, pairs = {}, {}
    for dtype in dtypes:
        rows = attention_times(fa, name, "the ring block", *RING_BLOCK, causal=False,
                               bias_kind=None, seed=31, dtype=dtype)
        pairs[str(dtype)[6:]] = rows.pop("bwd_pair")
        for kname, row in rows.items():
            block_rows.setdefault(kname, {})[str(dtype)[6:]] = row
    return block_rows, pairs


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
CONFIG2_ROUNDS = 1  # cut from the preset's 100 to 2, then 1 (PERF.md §4)
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
          and meshed["by_design"] == {BF16_KEYS[p]: MESH_SHARDS * layers for p in PASSES},
          f"22a: launches {meshed['launches']} {meshed['by_design']} on the mesh, "
          f"{plain['launches']} meshless; want {MESH_SHARDS} x {layers} of each, on "
          f"{'/'.join(BF16_KEYS.values())}")
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
    bf16) on 4 shards of the card, ``CONFIG2_ROUNDS`` of its 100 rounds,
    the loss after them evaluated below round 0's; then round 0 meshless
    on the same inputs, in waves of 8 (each the clients one shard holds in
    a wave), against the mesh's round 0."""
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
    ev, ev_s = timed(lambda: sim.evaluate_round(p, data, n_samples, wave_size=cfg["wave_size"]))
    print(f"  evaluated after {CONFIG2_ROUNDS} round(s) in {ev_s:.3f} s: {ev}")
    by_pass, _ = launches_since(fa, before)
    check(not any(by_pass.values()), f"22b: ResNet-18 launched flash kernels {by_pass}")
    check(all(math.isfinite(x) for r in rounds for x in r["loss"])
          and ev["loss"] < rounds[0]["loss"][0],
          f"22b: the loss did not fall: rounds {[r['loss'] for r in rounds]}, then evaluated "
          f"{ev['loss']}")
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
    return {"rounds": rounds, "eval": ev, "eval_s": ev_s, "n_images": n_real,
            "capacity": capacity, "data_s": data_s, "meshless_round0_s": ref_s, "band": band,
            "loss_gap": loss_gap}


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
        check(by_pass == want_launches and set(by_design) <= set(BF16_KEYS.values()),
              f"23a round {r}: launches {by_pass} {by_design}, want {want_launches} on "
              f"{'/'.join(BF16_KEYS.values())}")
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


HYBRID_BERT = (8, 64, 32, 2, 5e-3, 0.1)  # 23b, 26b: clients, per client, batch, epochs, lr, mu


def hybrid_bert_cohort():
    """23b's and 26b's BERT-base (vocab 30,522, bf16) with config 3's
    trainable head and FedProx, and phase 8's cohort on the card: ``(cfg,
    model, data, n_samples, FedSim kwargs)``."""
    from baton_tpu_torch.core.regularizers import fedprox
    from baton_tpu_torch.examples.bert_fedprox import make_data
    from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
    from baton_tpu_torch.ops.padding import stack_client_datasets

    cfg = BertConfig(vocab_size=30522, max_len=128, d_model=768, n_layers=12, n_heads=12,
                     d_ff=3072, n_classes=4)
    n_clients, per_client, batch, _, lr, mu = HYBRID_BERT
    data, n_samples = stack_client_datasets(
        make_data(np.random.default_rng(0), cfg, n_clients, per_client), batch_size=batch)
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    model = bert_classifier_model(cfg, compute_dtype=torch.bfloat16, name="bert_base_config3")
    kw = dict(batch_size=batch, learning_rate=lr, regularizer=fedprox(mu),
              trainable=lambda path, leaf: path.startswith(CONFIG3_HEAD))
    return cfg, model, data, n_samples, kw


def hybrid_bert_phase(fa):
    """Phase 23b: BERT-base (vocab 30,522, bf16) with config 3's
    trainable-head variant (the encoder frozen and placed over ``model``:
    ``b1`` split, ``b2`` once, the vocab split on 2 shards) on a 2 x 2 hybrid
    mesh of the card against the meshless round, at phase 8's cohort (8
    clients x 64 samples, batch 32, 2 epochs, lr 5e-3, FedProx mu 0.1): a
    warm-up, a timed round and a profiled one on each."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core.training import random_perms
    from baton_tpu_torch.parallel.tensor_parallel import describe_tp_sharding, is_sharded

    cfg, model, data, n_samples, kw = hybrid_bert_cohort()
    n_clients, per_client, batch, n_epochs, _, mu = HYBRID_BERT
    clients, shards = HYBRID_GRID
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


# phase 25: the ring across processes. Two processes on the one card joined
# over gloo (NCCL refuses two ranks on one device), each holding half the
# shards of a seq axis that crosses the process boundary
# (make_hybrid_mesh([], dcn_axis="seq")): example 06 at full width against
# phase 21a's one-process ring, the other kernels at a small size against
# themselves in one process, then the port's lint.

RING_PROCESSES = 2
RING_PROCESS_TOL = 1e-5  # (a): step 0's loss and each gradient against 21a's ring, relative
RING_PARAM_TOL = 1e-6  # (a): the two processes' params after the steps
RING_PROCESS_STEPS = 1  # (a): cut from 2 (PERF.md §4)
RING_SMALL = (2, 8, 4, 4096, 64)  # (b): B, Hq, Hkv, L, D
RING_SMALL_TOL = 1e-5  # (b): each kernel across processes against itself in one
RING_CHILD_TIMEOUT_S = 600  # (a)-(b): each child process
LINT_LIMIT_S = 300  # (c)


def ring_module():
    """``baton_tpu_torch.parallel.ring_attention`` (the package exports a
    function of the same name)."""
    import importlib

    return importlib.import_module("baton_tpu_torch.parallel.ring_attention")


def allclose_share(got, want, tol) -> float:
    """The largest |got - want| / (tol + tol·|want|): at most 1 where
    ``torch.allclose(got, want, rtol=tol, atol=tol)`` holds."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (tol + tol * want.abs())).max().item()


def ring_processes_long(fa, ctx, dev, mesh) -> dict:
    """Phase 25a in a child: 21a's model, params and tokens with the ring
    over ``mesh``; step 0's loss and gradients against 21a's one-process
    ring, then ``RING_PROCESS_STEPS`` steps of example 06's trainer, each
    step's launches, transport and time, the peak memory, and the largest
    gap between the two processes' params."""
    import inspect

    import torch.distributed as dist

    from baton_tpu_torch.core.training import make_local_trainer
    from baton_tpu_torch.examples import long_context_ring as ex
    from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model

    ra = ring_module()
    cfg = LlamaConfig(**ctx["config"])
    model = llama_lm_model(cfg, attention_fn=ex.make_attention_fn(mesh), remat=True)
    params = {k: v.to(dev) for k, v in ctx["params"].items()}
    toks = ctx["tokens"].to(dev)
    data = {"x": toks, "y": toks}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    grads, loss = torch.func.grad_and_value(
        lambda p: model.per_example_loss(p, data).mean())(params)
    loss = loss.item()
    step0_s = time.perf_counter() - t0
    worst, grad_gap = model_grad_gap(grads, {k: v.to(dev) for k, v in ctx["grads"].items()})
    del grads
    stamps, counts, moved = [], [], []

    def stamp(step, _):
        sync()
        stamps.append(time.perf_counter())
        counts.append(fa.launches())
        moved.append(dict(ra.transport_counts))

    trainer = make_local_trainer(model, batch_size=ctx["batch"],
                                 learning_rate=inspect.signature(ex.run).parameters["lr"].default,
                                 progress_fn=stamp)
    sync()
    fa.reset_launches()
    ra.reset_transport_counts()
    t0 = time.perf_counter()
    stepped, _, hist = trainer.train(params, data, ctx["batch"], RING_PROCESS_STEPS,
                                     generator=torch.Generator().manual_seed(1))
    by_design = {k: v for k, v in fa.launches_by_design.items() if v}
    param_gap = 0.0
    for p in stepped.values():
        both = p.detach().clone()
        dist.all_reduce(both)  # the two processes' params added
        param_gap = max(param_gap, (2 * p.detach() - both).abs().max().item())
    diffs = [{k: now[k] - (prev[k] if prev else 0) for k in now}
             for prev, now in zip([None] + counts[:-1], counts)]
    transport = [{k: now[k] - (prev[k] if prev else 0) for k in now}
                 for prev, now in zip([None] + moved[:-1], moved)]
    return {"loss": loss, "loss_gap": abs(loss - ctx["loss"]) / abs(ctx["loss"]),
            "grad_gap": grad_gap, "grad_worst": worst, "step0_s": step0_s,
            "losses": [float(x) for x in hist], "s_per_step": np.diff([t0] + stamps).tolist(),
            "launches_per_step": diffs, "launches_by_design": by_design,
            "transport_per_step": transport, "param_gap": param_gap,
            "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                               if dev.type == "cuda" else None)}


def ring_processes_small(fa, ctx, dev) -> dict:
    """Phase 25b in a child: the dense ring and the striped fn over the 8
    shards across both processes, Ulysses over 4, and ring × flash in bf16
    over 8, each against the same fn over as many shards in this process
    alone, forward and the q, k, v and bias gradients, causal with a padding
    bias (the last shards all padding); the bf16 ring's launches."""
    from baton_tpu_torch.parallel.mesh import make_mesh
    from baton_tpu_torch.parallel.multihost import make_hybrid_mesh

    ra = ring_module()
    b, hq, hkv, l, d = ctx["small"]
    gen = torch.Generator().manual_seed(25)
    base = [torch.randn(b, h, l, d, generator=gen) for h in (hq, hkv, hkv, hq)]
    keep = torch.arange(l) < (5 * l) // 8 - l // 32  # shard 4 in part, 5-7 all padding
    bias = torch.where(keep, 0.0, -1e30).expand(b, l)[:, None, None, :].contiguous().to(dev)
    out = {}
    for label, make, n, dtype in (("dense ring", ra.make_ring_attention_fn, 8, torch.float32),
                                  ("striped", ra.make_striped_attention_fn, 8, torch.float32),
                                  ("ulysses", ra.make_ulysses_attention_fn, 4, torch.float32),
                                  ("flash bf16", ra.make_flash_ring_attention_fn, 8,
                                   torch.bfloat16)):
        q, k, v, dout = (x.to(dev, dtype) for x in base)
        mesh = make_hybrid_mesh([], dcn_axis="seq", devices=[dev] * (n // RING_PROCESSES))
        across = make(mesh)
        alone = make(make_mesh(n, ("seq",), devices=[dev] * n))
        fa.reset_launches()
        got = attention_vjp(across, q, k, v, dout, bias)
        launches = fa.launches()
        by_design = {key: c for key, c in fa.launches_by_design.items() if c}
        want = attention_vjp(alone, q, k, v, dout, bias)
        shares = {what: allclose_share(g, w, RING_SMALL_TOL)
                  for what, g, w in zip(("out", "dq", "dk", "dv", "dbias"),
                                        (got[0], *got[1]), (want[0], *want[1]))}
        out[label] = {"n": n, "shares": shares, "launches": launches,
                      "launches_by_design": by_design,
                      "local_shards": [j for j, _ in mesh.local_shards("seq")]}
    return out


def ring_child(coordinator: str, rank: int, device: str, work: str) -> int:
    """Phase 25's child: ``python3 chip_smoke.py --ring-child host:port rank
    device dir``. Joins a gloo group of 2 processes, each with half the
    shards of a seq axis of 8 on ``device`` (``cuda:0`` on the card), loads
    the context the parent wrote to ``dir``, runs 25a and 25b, and prints
    one JSON line; destroys its process group on every exit."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from baton_tpu_torch.ops import flash_attention as fa
    from baton_tpu_torch.parallel.multihost import initialize_multihost, make_hybrid_mesh

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent's 21a
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    ctx = torch.load(Path(work) / "ring_ctx.pt")
    shards = ctx["n"] // RING_PROCESSES
    try:
        initialize_multihost(coordinator, RING_PROCESSES, rank, backend="gloo",
                             devices=[dev] * shards, timeout_s=120)
        mesh = make_hybrid_mesh([], dcn_axis="seq", devices=[dev] * shards)
        out = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend(),
               "local_shards": [j for j, _ in mesh.local_shards("seq")],
               "long_context": ring_processes_long(fa, ctx, dev, mesh)}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["small"] = ring_processes_small(fa, ctx, dev)
        print(json.dumps(out), flush=True)
        return 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def check_ring_processes(outs, reference, kernels=True) -> None:
    """Phase 25's checks of its two children's lines: each holds its half
    of the shards; 25a's step 0 within ``RING_PROCESS_TOL`` of the
    one-process ring's loss and gradients, finite losses, the two
    processes' params within ``RING_PARAM_TOL``; 25b's kernels within
    ``RING_SMALL_TOL`` of themselves in one process. With ``kernels`` (on
    the card), each step's launches and 25b's bf16 ring's are what this
    process's shards make, on the fp32 and bf16 designs: a process that
    ran a shard it does not hold fails here."""
    n = reference["n"]
    layers = reference["config"]["n_layers"]
    half = n // RING_PROCESSES
    check([o["rank"] for o in outs] == list(range(RING_PROCESSES))
          and [o["local_shards"] for o in outs] == [list(range(r * half, (r + 1) * half))
                                                    for r in range(RING_PROCESSES)],
          f"25: ranks and shards {[(o['rank'], o['local_shards']) for o in outs]}")
    for o in outs:
        a, rank = o["long_context"], o["rank"]
        check(a["loss_gap"] <= RING_PROCESS_TOL,
              f"25a rank {rank}: step 0 loss {a['loss']} against the one-process ring's "
              f"{reference['loss']} (relative {a['loss_gap']:.3e}, tol {RING_PROCESS_TOL})")
        check(a["grad_gap"] <= RING_PROCESS_TOL,
              f"25a rank {rank}: gradient of {a['grad_worst']} off the one-process ring's by "
              f"{a['grad_gap']:.3e} of its largest value (tol {RING_PROCESS_TOL})")
        check(len(a["losses"]) == RING_PROCESS_STEPS
              and all(math.isfinite(x) for x in a["losses"]), f"25a rank {rank}: losses "
              f"{a['losses']}")
        check(a["param_gap"] <= RING_PARAM_TOL,
              f"25a rank {rank}: the processes' params differ by {a['param_gap']:.3e}")
        for label, c in o["small"].items():
            worst = max(c["shares"], key=c["shares"].get)
            check(c["shares"][worst] <= 1.0,
                  f"25b rank {rank} {label}: {worst} off the one-process fn at "
                  f"{c['shares'][worst]:.3e} of rtol = atol = {RING_SMALL_TOL}")
        if not kernels:
            continue
        want = ring_step_launches(n, layers, remat=True, shards=o["local_shards"])
        check(a["launches_per_step"] == [want] * RING_PROCESS_STEPS
              and set(a["launches_by_design"]) == {f"{k}_tf32x3" for k in want},
              f"25a rank {rank}: launches a step {a['launches_per_step']} "
              f"{a['launches_by_design']}, want {want} (shards {o['local_shards']}) on tf32x3")
        flash = o["small"]["flash bf16"]
        calls = ring_block_calls(flash["n"], shards=flash["local_shards"])
        check(flash["launches"] == {"fwd": calls, "bwd_dkv": calls, "bwd_dq": calls}
              and set(flash["launches_by_design"]) == {BF16_KEYS[k] for k in want},
              f"25b rank {rank}: bf16 ring launches {flash['launches']} "
              f"{flash['launches_by_design']}, want {calls} each on "
              f"{'/'.join(BF16_KEYS.values())}")


def ring_processes_phase(fa, reference, device="cuda") -> dict:
    """Phase 25a-b: two children over gloo, each under a hard timeout and
    killed in ``finally``; their lines checked (``check_ring_processes``,
    the launches on the card only) and printed beside 21a's one-process
    s/step. The kernels are built (phase 1) before the children start,
    which load them."""
    coordinator = f"127.0.0.1:{free_port()}"
    n = reference["n"]
    print(f"phase 25a-b: two processes on the one card over gloo ({coordinator}), {n // 2} "
          f"shards of {device} each of a seq axis of {n}: example 06 --scale full against 21a's "
          f"one-process ring; the dense ring, striped, Ulysses and bf16 ring x flash at B, Hq, "
          f"Hkv, L, D = {RING_SMALL}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        torch.save(dict(reference, small=RING_SMALL), Path(work) / "ring_ctx.pt")
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--ring-child",
                                   coordinator, str(rank), device, work],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for rank in range(RING_PROCESSES)]
        done = []
        try:
            done = [p.communicate(timeout=RING_CHILD_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    check(all(p.returncode == 0 for p in procs), "25: the children exited "
          f"{[p.returncode for p in procs]}:\n" + "\n".join(
              f"rank {rank}:\n{err[-3000:]}" for rank, (_, err) in enumerate(done)))
    outs = [json.loads(out.strip().splitlines()[-1]) for out, _ in done]
    check_ring_processes(outs, reference, kernels=device == "cuda")
    for o in outs:
        a = o["long_context"]
        moved = a["transport_per_step"]
        print(f"  rank {o['rank']} (shards {o['local_shards']}): step 0 loss {a['loss']:.6f} "
              f"against {reference['loss']:.6f} (relative {a['loss_gap']:.2e}), gradients within "
              f"{a['grad_gap']:.2e} ({a['step0_s']:.1f} s); {RING_PROCESS_STEPS} steps: s/step "
              f"{[round(x, 4) for x in a['s_per_step']]} against the one-process ring's median "
              f"{reference['median_s_per_step']:.4f}, losses {[round(x, 4) for x in a['losses']]}"
              f"; sent across the boundary a step {[m['bytes'] for m in moved]} B in "
              f"{[m['exchanges'] for m in moved]} exchanges, transport "
              f"{[round(m['seconds'], 4) for m in moved]} s a step; peak "
              f"{a['peak_memory_gb'] or 0:.2f} GB; params {a['param_gap']:.1e} from the other "
              f"process's; launches a step {a['launches_per_step'][0]}")
        for label, c in o["small"].items():
            print(f"  rank {o['rank']} 25b {label} over {c['n']} shards: " + " ".join(
                f"{k}={v:.2e}" for k, v in c["shares"].items())
                + f" of rtol = atol = {RING_SMALL_TOL}; launches {c['launches']}")
    print(f"  the two processes took {time.perf_counter() - t0:.1f} s, start to exit")
    return {"ranks": outs}


def check_lint(rc: int, report: dict) -> None:
    """Phase 25c: the port's lint exits 0 with no finding over more than
    100 files, in a process that never imported JAX or the JAX package."""
    check(rc == 0 and report.get("rc") == 0 and report.get("findings") == 0
          and report.get("files", 0) > 100,
          f"25c: batonlint over baton_tpu_torch exited {rc}: {report}")
    check(not report.get("jax") and not report.get("baton_tpu"),
          f"25c: the lint's process imported JAX or the JAX package: {report}")


LINT_CODE = """\
import contextlib, io, json, re, runpy, sys
sys.argv = ["batonlint", "baton_tpu_torch"]
text = io.StringIO()
with contextlib.redirect_stdout(text):
    try:
        runpy.run_module("baton_tpu_torch.analysis", run_name="__main__")
        rc = 0
    except SystemExit as e:
        rc = e.code or 0
summary = re.search(r"(\\d+) finding\\(s\\), (\\d+) suppressed, (\\d+) file\\(s\\)", text.getvalue())
print(text.getvalue().strip())
print(json.dumps({"rc": rc, "findings": int(summary[1]) if summary else None,
                  "suppressed": int(summary[2]) if summary else None,
                  "files": int(summary[3]) if summary else 0,
                  "jax": "jax" in sys.modules, "baton_tpu": "baton_tpu" in sys.modules}))
sys.exit(rc)
"""


def lint_phase() -> dict:
    """Phase 25c: ``python -m baton_tpu_torch.analysis baton_tpu_torch`` in
    a process of its own (under a time limit), which must exit 0 without
    importing JAX."""
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", LINT_CODE], cwd=ROOT, capture_output=True,
                          text=True, timeout=LINT_LIMIT_S)
    lines = done.stdout.strip().splitlines()
    try:
        report = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        report = {"stdout": done.stdout[-2000:], "stderr": done.stderr[-2000:]}
    check_lint(done.returncode, report)
    seconds = time.perf_counter() - t0
    print(f"phase 25c: batonlint over baton_tpu_torch: {report['findings']} findings, "
          f"{report['suppressed']} suppressed, {report['files']} files, exit 0, JAX not "
          f"imported, {seconds:.1f} s")
    return dict(report, seconds=seconds)


# phase 26: run_rounds_fused on meshes of the one card. (a) Phase 22a's
# BERT-base cohort on 4 shards: one CUDA graph over the shards; (b) 23b's
# hybrid case on 2 x 2; (c) two processes on the card over gloo, 2 shards
# each of a clients axis of 4: two captured pieces around the round's
# all-reduce, and phase 19's DP case on the same processes.

FUSED_PROCESSES = 2  # (c)
FUSED_CHILD_TIMEOUT_S = 300  # (c): each child process
DP_MESH_COHORT = (8, 4)  # (c): phase 19's DP case a clients axis of 4 splits: clients, wave


def fused_mesh_bert_phase(fa):
    """Phase 26a: ``run_rounds_fused`` against ``run_rounds`` on phase 22a's
    BERT-base cohort over 4 shards of the card (``fused_against_loop``):
    one graph, each kernel 4 x 12 launches a round. Returns the stats, the
    fused run's launches, a round's and 26c's reference (the start and the
    fused params on the host, the config)."""
    from baton_tpu_torch import FedSim

    cfg, model, data, n_samples = bert_base_cohort()
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    sim = FedSim(model, batch_size=32, learning_rate=0.01, mesh=card_mesh(MESH_SHARDS))
    params = sim.init(torch.Generator().manual_seed(0))
    print(f"phase 26a: run_rounds_fused as one CUDA graph over a clients mesh of {MESH_SHARDS} "
          f"shards of the card against run_rounds on it (phase 22a's BERT-base cohort, "
          f"{len(n_samples)} clients x 32, bf16), {FUSED_ROUNDS} rounds from the same params "
          "and generator")
    stats, launched, per_round, p_fused = fused_against_loop(
        fa, f"26a BERT-base on {MESH_SHARDS} shards", sim, params, data, n_samples)
    want = {k: MESH_SHARDS * cfg.n_layers for k in PASSES}
    check(per_round == want and "pieces" not in sim.last_fused,
          f"26a: captured launches a round {per_round} (want {want}), {sim.last_fused}")
    reference = {"config": dataclasses.asdict(cfg),
                 "start": {k: v.cpu() for k, v in params.items()},
                 "fused": {k: v.cpu() for k, v in p_fused.items()}}
    return stats, launched, per_round, reference


def fused_hybrid_phase(fa):
    """Phase 26b: ``run_rounds_fused`` against ``run_rounds`` on 23b's case
    (BERT-base with config 3's head, the encoder frozen and placed over
    ``model``, FedProx, 8 clients x 64, 2 epochs) on a 2 x 2 hybrid mesh of
    the card: within ``FUSED_TOL``, the forward launches a round, the base
    placed in the result and bit-equal to what went in. Returns the stats
    and a round's launches."""
    from baton_tpu_torch import FedSim

    cfg, model, data, n_samples, kw = hybrid_bert_cohort()
    n_clients, per_client, _, n_epochs, _, mu = HYBRID_BERT
    clients, shards = HYBRID_GRID
    sim = FedSim(model, mesh=card_grid(clients, shards), **kw)
    params = sim.init(torch.Generator().manual_seed(0))
    frozen = {k: v.cpu() for k, v in params.items() if not k.startswith(CONFIG3_HEAD)}
    print(f"phase 26b: run_rounds_fused on a {clients} x {shards} hybrid mesh of the card against "
          f"run_rounds on it (23b: BERT-base, the encoder frozen, config 3's head, FedProx mu "
          f"{mu}, {n_clients} clients x {per_client}, {n_epochs} epochs)")
    stats, _, per_round, p_fused = fused_against_loop(
        fa, f"26b hybrid BERT on {clients} x {shards}", sim, params, data, n_samples,
        n_epochs=n_epochs)
    steps = sim.trainer.steps_per_round(data["x"].shape[1], n_epochs)
    want = hybrid_round_launches(cfg.n_layers, steps, clients, shards, backward=False)
    check(per_round == want, f"26b: captured launches a round {per_round}, want {want}")
    check_placed_base("26b", p_fused, "blocks/0/mlp/w1", "blocks/0/mlp/w2")
    stats["frozen_bit_equal"] = check_frozen_bit_equal(p_fused, frozen)
    print(f"  the frozen base: {stats['frozen_bit_equal']} tensors bit-equal to what went in")
    return stats, per_round


def fused_child(coordinator: str, rank: int, device: str, work: str) -> int:
    """Phase 26c's child: ``python3 chip_smoke.py --fused-child host:port
    rank device dir``. Joins a gloo group of 2 processes, each with 2 shards
    of ``device`` (``cuda:0`` on the card) of a clients axis of 4
    (``make_hybrid_mesh([], dcn_axis="clients")``), and on 26a's cohort (the
    BERT config the parent wrote to ``dir``) runs ``run_round`` once (a
    warm-up), then ``run_rounds`` and ``run_rounds_fused`` for
    ``FUSED_ROUNDS`` rounds from the same params and generator; writes the
    fused params to ``dir``, runs phase 19's DP case on the same mesh and
    prints one JSON line; destroys its process group on every exit."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.bert import BertConfig
    from baton_tpu_torch.ops import flash_attention as fa
    from baton_tpu_torch.parallel.multihost import initialize_multihost, make_hybrid_mesh

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent's 26a
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the two processes' shards share the host's cores
    ctx = torch.load(Path(work) / "fused_ctx.pt")
    shards = MESH_SHARDS // FUSED_PROCESSES
    try:
        initialize_multihost(coordinator, FUSED_PROCESSES, rank, backend="gloo",
                             devices=[dev] * shards, timeout_s=120)
        mesh = make_hybrid_mesh([], dcn_axis="clients", devices=[dev] * shards)
        cfg, model, data, n_samples = bert_base_cohort(cfg=BertConfig(**ctx["bert"]))
        data = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
        sim = FedSim(model, batch_size=32, learning_rate=0.01, mesh=mesh)
        params = sim.init(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        sim.run_round(params, data, n_samples, gen)  # warm-up
        runs = []  # (result, seconds, launches) of run_rounds, then of run_rounds_fused
        for run in (sim.run_rounds, sim.run_rounds_fused):
            before = launch_counts(fa)
            sync()
            t0 = time.perf_counter()
            result = run(params, data, n_samples, gen, n_rounds=FUSED_ROUNDS)
            sync()
            runs.append((result, time.perf_counter() - t0, launches_since(fa, before)))
        ((p_loop, h_loop), loop_s, _), ((p_fused, h_fused), fused_s, (launched, by_design)) = runs
        record = dict(sim.last_fused)
        # the probe's defaults in a process group: its world size
        defaults = sim.compute_probe.record_round(
            key="smoke_defaults", signature=("26c", "defaults"), train_s=fused_s,
            n_samples=float(n_samples.sum()))
        err = max((p_loop[k].float() - p_fused[k].float()).abs().max().item() for k in p_loop)
        torch.save({k: v.cpu() for k, v in p_fused.items()}, Path(work) / f"fused_rank{rank}.pt")
        # the round's sums all-reduced as one fp32 buffer: every param, the
        # loss of its one epoch, the weight
        n_sums = sum(v.numel() for v in params.values()) + 2
        out = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend(),
               "local_shards": [j for j, _ in mesh.local_shards()], "n_layers": cfg.n_layers,
               "last_fused": record, "default_record": defaults, "param_err": err,
               "loss_err": max(abs(a - b) for a, b in zip(h_loop, h_fused)),
               "bit_equal": all(torch.equal(p_loop[k], p_fused[k]) for k in p_loop)
               and h_loop == h_fused, "losses": h_fused,
               "s_per_round_loop": loop_s / FUSED_ROUNDS,
               "s_per_round_fused": fused_s / FUSED_ROUNDS,
               "all_reduce_bytes": 4 * n_sums, "launches": launched, "by_design": by_design,
               "launches_per_round": {k: n // 2 for k, n in launched.items()}}
        del p_loop, p_fused, runs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["dp"] = fused_dp_round(fa, mesh, *DP_MESH_COHORT, vit=ctx["vit"])
        print(json.dumps(out), flush=True)
        return 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def check_fused_processes(outs, params, reference, kernels=True, kind="cpu") -> dict:
    """Phase 26c's checks of its two children's lines and fused params:
    each holds its 2 shards of the 4; ``record_round``'s defaults name
    ``kind`` and count the group's 2 processes; its fused rounds within
    ``FUSED_TOL`` of ``run_rounds`` on the same two-process mesh (the DP
    case too); both ranks' params equal and within 22a's band of 26a's one-process fused
    params (``reference``). With ``kernels`` (on the card) each ran two
    captured pieces, replayed ``FUSED_ROUNDS - 1`` times, and launched each
    kernel 2 x 12 times a round, all on their bf16 designs. Returns the band."""
    check([o["rank"] for o in outs] == [0, 1] and all(o["world"] == 2 for o in outs)
          and [o["local_shards"] for o in outs] == [[0, 1], [2, 3]],
          f"26c: ranks, worlds or shards {[(o['rank'], o['local_shards']) for o in outs]}")
    for o in outs:
        record = o["last_fused"]
        check_default_record(f"26c rank {o['rank']}", o["default_record"], kind, FUSED_PROCESSES)
        check(o["param_err"] <= FUSED_TOL and o["loss_err"] <= FUSED_TOL
              and o["dp"]["param_err"] <= FUSED_TOL and o["dp"]["loss_err"] <= FUSED_TOL,
              f"26c rank {o['rank']}: fused and run_rounds differ: params {o['param_err']:.3e}, "
              f"losses {o['loss_err']:.3e}; DP {o['dp']['param_err']:.3e}, "
              f"{o['dp']['loss_err']:.3e}")
        if kernels:
            want = {k: (MESH_SHARDS // FUSED_PROCESSES) * o["n_layers"] for k in PASSES}
            check(record.get("pieces") == 2 and record["replays"] == FUSED_ROUNDS - 1
                  and o["dp"]["last_fused"].get("pieces") == 2,
                  f"26c rank {o['rank']}: not two pieces replayed: {record}, DP "
                  f"{o['dp']['last_fused']}")
            check(o["launches_per_round"] == want
                  and o["by_design"] == {BF16_KEYS[p]: 2 * n for p, n in want.items()},
                  f"26c rank {o['rank']}: launches {o['launches_per_round']} a round, "
                  f"{o['by_design']} in the fused run; want {want} a round, on "
                  f"{'/'.join(BF16_KEYS.values())}")
    check(sorted(params[0]) == sorted(params[1])
          and all(torch.equal(params[0][k], params[1][k]) for k in params[0]),
          "26c: the two processes' fused params differ")
    band = within_band(params[0], reference["fused"], reference["start"])
    check(band["inside"], f"26c: the two processes' fused params are outside 22a's band of "
          f"26a's one-process fused params: {band}")
    return band


def fused_processes_phase(fa, reference, device="cuda", vit=DP_VIT) -> dict:
    """Phase 26c: two children over gloo, each under a hard timeout and
    killed in ``finally``; their lines and params checked
    (``check_fused_processes``, the pieces and launches on the card only)
    and printed. The kernels are built (phase 1) before the children
    start, which load them."""
    coordinator = f"127.0.0.1:{free_port()}"
    shards = MESH_SHARDS // FUSED_PROCESSES
    print(f"phase 26c: two processes on the one card over gloo ({coordinator}), {shards} shards "
          f"of {device} each of a clients axis of {MESH_SHARDS}: run_rounds_fused as two captured "
          f"pieces around the round's all-reduce against run_rounds, on 26a's cohort; then "
          f"phase 19's DP case ({DP_MESH_COHORT[0]} clients in waves of {DP_MESH_COHORT[1]})")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        torch.save({"bert": reference["config"], "vit": vit}, Path(work) / "fused_ctx.pt")
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--fused-child",
                                   coordinator, str(rank), device, work],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for rank in range(FUSED_PROCESSES)]
        done = []
        try:
            done = [p.communicate(timeout=FUSED_CHILD_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        check(all(p.returncode == 0 for p in procs), "26c: the children exited "
              f"{[p.returncode for p in procs]}:\n" + "\n".join(
                  f"rank {rank}:\n{err[-3000:]}" for rank, (_, err) in enumerate(done)))
        outs = [json.loads(out.strip().splitlines()[-1]) for out, _ in done]
        params = [torch.load(Path(work) / f"fused_rank{rank}.pt")
                  for rank in range(FUSED_PROCESSES)]
    kind = torch.cuda.get_device_name() if device == "cuda" else "cpu"
    band = check_fused_processes(outs, params, reference, kernels=device == "cuda", kind=kind)
    for o in outs:
        r = o["last_fused"]
        replays = r.get("replays") or 0
        per = (lambda key: f"{r[key] / replays:.4f}" if replays and r.get(key) else "n/a")
        print(f"  rank {o['rank']} (shards {o['local_shards']}): run_rounds "
              f"{o['s_per_round_loop']:.4f} s/round, fused {o['s_per_round_fused']:.4f} s/round "
              f"over the call; replays on the device {per('replay_s')} s/round, piece A "
              f"{per('replay_a_s')}, piece B {per('replay_b_s')}; all-reduce host s a round "
              f"{[round(x, 4) for x in r.get('all_reduce_s', [])]} of "
              f"{o['all_reduce_bytes']:,} B; max |param diff| {o['param_err']:.3e}, losses "
              f"{o['loss_err']:.3e} (tol {FUSED_TOL}), bit-equal {o['bit_equal']}; "
              f"record_round without device or n_chips: n_chips "
              f"{o['default_record']['n_chips']} of world {o['world']}, "
              f"{o['default_record']['device_kind']}; flash "
              f"launches a round {o['launches_per_round']}, in the fused run {o['by_design']}; "
              f"last_fused {r}")
        dp = o["dp"]
        print(f"  rank {o['rank']} DP-SGD (sigma {CONFIG5_SIGMA}), 2-layer ViT, "
              f"{DP_MESH_COHORT[0]} clients in waves of {DP_MESH_COHORT[1]}, 3 rounds: max |param "
              f"diff| {dp['param_err']:.3e}, losses {dp['loss_err']:.3e} (tol {FUSED_TOL}; max "
              f"|param change| {dp['moved']:.3e}), bit-equal {dp['bit_equal']}; "
              f"{dp['last_fused']}")
    print(f"  the two processes' params equal; against 26a's one-process fused params "
          f"{band['max_gap']:.3e} ({band['gap_over_change']:.3e} of the largest change "
          f"{band['largest_change']:.3e}; band rtol = atol = {MESH_BAND}); the two processes "
          f"took {time.perf_counter() - t0:.1f} s, start to exit")
    return {"ranks": outs, "band": band}


def fused_mesh_phase(fa) -> dict:
    """Phase 26 (a)-(c): returns the stats with 26a's launches (the fused
    run's and a round's), 26b's a round and each 26c rank's a round."""
    torch.cuda.empty_cache()
    bert, launched, per_round, reference = timed_phase("26a", fused_mesh_bert_phase, fa)
    torch.cuda.empty_cache()
    hybrid, hybrid_per_round = timed_phase("26b", fused_hybrid_phase, fa)
    torch.cuda.empty_cache()
    processes = timed_phase("26c", fused_processes_phase, fa, reference)
    return {"bert_mesh": bert, "hybrid_bert": hybrid, "processes": processes,
            "launches_fused_mesh_bert": launched, "launches_per_round_fused_mesh_bert": per_round,
            "launches_per_round_fused_hybrid_bert": hybrid_per_round}


# phase 27: buffer donation on the card. Phase 3's BERT-base cohort with
# phase 9's FedAdam server, run_rounds_fused with donation on and off from
# identical clones, then the donation probe on the same case.

DONATION_ROUNDS = 3
DONATION_SHARE = 0.9  # the probe's delta at least this share of the donated bytes


def tree_leaves(tree) -> list:
    """The tensors of nested dicts, in order."""
    from baton_tpu_torch.parallel.partition import _flatten

    return [leaf for _, leaf in _flatten(tree)]


def traced_flash(prof) -> dict:
    """The flash kernels' launches a profiled block ran on the device, by
    pass, from the kernels' names (a graph's replays included); None where
    the profiler saw no device event."""
    totals = event_totals(prof)
    if not totals:
        return None
    passes = {"fwd": "fwd", "dkv": "bwd_dkv", "dq": "bwd_dq"}
    out = dict.fromkeys(PASSES, 0)
    for name, (count, _) in totals.items():
        m = re.search(r"(^|[^a-z_])(fwd|dkv|dq)(_mma|_wgmma|_tf32x3)?_kernel", name.lower())
        if m:
            out[passes[m.group(2)]] += count
    return out


def donation_run(fa, sim, params, sos, data, n_samples, donate: bool) -> dict:
    """``run_rounds_fused`` for ``DONATION_ROUNDS`` rounds with
    ``donate_buffers=donate`` from clones of ``params`` and ``sos``, the
    flash counts set to 0 just before it and read just after, and on the
    card under the profiler (``traced_flash``; None elsewhere). Returns the
    result, the clones it started from, their leaves' addresses before the
    run, the seconds, the launches counted and traced and ``last_fused``."""
    from baton_tpu_torch.core.optim import tree_map

    start, start_sos = (tree_map(torch.clone, tree) for tree in (params, sos))
    ptrs = [t.data_ptr() for t in tree_leaves(start) + tree_leaves(start_sos)]
    gen = torch.Generator().manual_seed(1)

    def run():
        return sim.run_rounds_fused(start, data, n_samples, gen, n_rounds=DONATION_ROUNDS,
                                    server_opt_state=start_sos, return_server_opt_state=True,
                                    donate_buffers=donate)

    fa.reset_launches()
    traced = None
    if sim.device.type == "cuda":
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            (p, history, out_sos), seconds = timed(run)
        traced = traced_flash(prof)
    else:
        (p, history, out_sos), seconds = timed(run)
    launched, by_design = fa.launches(), {k: n for k, n in fa.launches_by_design.items() if n}
    return {"params": p, "sos": out_sos, "history": history, "start": start,
            "start_sos": start_sos, "ptrs": ptrs, "seconds": seconds, "launched": launched,
            "by_design": by_design, "traced": traced, "last_fused": dict(sim.last_fused)}


def check_donation(on: dict, off: dict, params, sos, n_layers: int) -> dict:
    """Phase 27's checks: donation on and off bit-equal (params, server
    state, losses); with donation on every leaf of the caller's is the
    result's (the same storage, ``data_ptr``) and counted donated, none
    copied; with it off none is, every leaf copied and the caller's clones
    still equal to the params they were made from; each run replayed
    ``DONATION_ROUNDS - 1`` times, counted ``2 x n_layers`` launches a
    kernel (the eager round 0 and the capture), all on their bf16 designs, and, where the
    profiler saw the device, ran ``DONATION_ROUNDS x n_layers`` a kernel
    (round 0 and the replays). Returns the counts."""
    n_leaves = len(params) + len(tree_leaves(sos))
    equal = (all(torch.equal(on["params"][k], off["params"][k]) for k in params)
             and all(torch.equal(a, b) for a, b in zip(tree_leaves(on["sos"]),
                                                       tree_leaves(off["sos"])))
             and on["history"] == off["history"])
    check(equal, "27: donation on and off differ")
    results = {name: [t.data_ptr() for t in tree_leaves(run["params"]) + tree_leaves(run["sos"])]
               for name, run in (("on", on), ("off", off))}
    shared_on = sum(a == b for a, b in zip(on["ptrs"], results["on"]))
    shared_off = sum(a == b for a, b in zip(off["ptrs"], results["off"]))
    don_on, don_off = on["last_fused"]["donation"], off["last_fused"]["donation"]
    check(shared_on == n_leaves and don_on["donated"] == n_leaves and don_on["copied"] == 0,
          f"27: with donation {shared_on} of {n_leaves} caller's leaves are the result's, "
          f"{don_on['donated']} counted donated, {don_on['copied']} copied")
    check(shared_off == 0 and don_off["donated"] == 0 and don_off["copied"] == n_leaves,
          f"27: without donation {shared_off} caller's leaves are the result's, "
          f"{don_off['donated']} donated, {don_off['copied']} of {n_leaves} copied")
    kept = (all(torch.equal(off["start"][k], params[k]) for k in params)
            and all(torch.equal(a, b) for a, b in zip(tree_leaves(off["start_sos"]),
                                                      tree_leaves(sos))))
    check(kept, "27: a run without donation changed the caller's tensors")
    want = {k: 2 * n_layers for k in PASSES}
    ran = {k: DONATION_ROUNDS * n_layers for k in PASSES}
    for name, run in (("on", on), ("off", off)):
        record = run["last_fused"]
        check(record["graph"] and record["replays"] == DONATION_ROUNDS - 1,
              f"27 donation {name}: not replayed: {record}")
        check(run["launched"] == want
              and run["by_design"] == {BF16_KEYS[k]: n for k, n in want.items()},
              f"27 donation {name}: launches {run['launched']} ({run['by_design']}), want {want}"
              f" on {'/'.join(BF16_KEYS.values())}")
        check(run["traced"] is None or run["traced"] == ran,
              f"27 donation {name}: the profiler saw {run['traced']} flash launches, want {ran}")
    return {"n_leaves": n_leaves, "shared_on": shared_on, "shared_off": shared_off,
            "bit_equal": equal, "launches_traced": on["traced"]}


def check_donation_probe(plan: dict, donated_bytes: int) -> float:
    """The probe's ``delta_gb`` (GiB) against the bytes donation leaves
    unheld: at least ``DONATION_SHARE`` of them. Returns the share."""
    from baton_tpu_torch.utils.profiling import GIB

    share = plan["delta_gb"] * GIB / donated_bytes
    check(share >= DONATION_SHARE, f"27: the donation probe's delta {plan['delta_gb']:.4f} GiB is "
          f"{share:.3f} of the {donated_bytes:,} B donated (want >= {DONATION_SHARE})")
    return share


def donation_phase(fa) -> tuple:
    """Phase 27: buffer donation on the card at BERT-base width: phase 3's
    cohort (8 clients x 32, bf16) with phase 9's FedAdam server
    (``optim.adam(1e-2)``), ``DONATION_ROUNDS`` fused rounds with donation
    on and off from identical clones (``check_donation``), the donation
    probe ``fedsim_fused_donation_plan`` on the same case
    (``check_donation_probe``) and ``configure_torch_for_bench``. Returns
    the stats and the kernels line's entries of the donation-on run's flash
    launches: ``launches_donation``, those the profiler saw (round 0 and
    the replays), or without a trace ``launches_donation_eager_and_capture``
    (those the counters saw)."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core import optim
    from baton_tpu_torch.utils.profiling import (
        GIB,
        configure_torch_for_bench,
        fedsim_fused_donation_plan,
    )

    setup = configure_torch_for_bench()
    cfg, model, data, n_samples = bert_base_cohort()
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    sim = FedSim(model, batch_size=32, learning_rate=0.01, server_optimizer=optim.adam(1e-2))
    params = sim.init(torch.Generator().manual_seed(0))
    sos = sim.init_server_opt_state(params)
    donated_bytes = sum(t.numel() * t.element_size()
                        for t in tree_leaves(params) + tree_leaves(sos))
    print(f"phase 27: buffer donation, run_rounds_fused(donate_buffers=True | False) on phase 3's "
          f"BERT-base cohort ({len(n_samples)} clients x 32, bf16) with FedAdam (adam 1e-2), "
          f"{DONATION_ROUNDS} rounds from identical clones; configure_torch_for_bench(): {setup}")
    ran = {k: DONATION_ROUNDS * cfg.n_layers for k in PASSES}
    on = observed(lambda: donation_run(fa, sim, params, sos, data, n_samples, True),
                  lambda run: run["traced"], ran, "27 donation on")
    off = observed(lambda: donation_run(fa, sim, params, sos, data, n_samples, False),
                   lambda run: run["traced"], ran, "27 donation off")
    stats = check_donation(on, off, params, sos, cfg.n_layers)
    # the kernels line takes the launches the profiler saw the donation-on
    # run make; without a trace, only the eager round's and the capture's
    launched = ({"launches_donation": on["traced"]} if on["traced"] is not None
                else {"launches_donation_eager_and_capture": on["launched"]})
    del on["params"], on["sos"], on["start"], on["start_sos"], off["params"], off["sos"]
    del off["start"], off["start_sos"]
    torch.cuda.empty_cache()
    plan = fedsim_fused_donation_plan(sim, params, data, n_samples,
                                      torch.Generator().manual_seed(1), n_rounds=DONATION_ROUNDS)
    share = check_donation_probe(plan, donated_bytes)
    for name, run in (("on", on), ("off", off)):
        print(f"  donation {name}: {run['seconds']:.3f} s for {DONATION_ROUNDS} rounds (capture "
              f"{run['last_fused']['capture_s']:.3f} s); donation record "
              f"{run['last_fused']['donation']}; flash launches counted {run['by_design']}, "
              f"seen by the profiler {run['traced']}")
    print(f"  on and off bit-equal {stats['bit_equal']} (params, server state, losses); with "
          f"donation {stats['shared_on']} of {stats['n_leaves']} caller's leaves are the "
          f"result's (data_ptr), without {stats['shared_off']}; flash launches in the "
          f"donation-on run {launched}")
    print(f"  fedsim_fused_donation_plan: peak above in-use on "
          f"{plan['donate_on']['plan_gb']:.4f} GiB, off {plan['donate_off']['plan_gb']:.4f} GiB, "
          f"delta {plan['delta_gb']:.4f} GiB ({plan['delta_gb'] * GIB:,.0f} B) against the "
          f"trainable params and server state's {donated_bytes:,} B "
          f"({donated_bytes / GIB:.4f} GiB): {share:.3f} of them (want >= {DONATION_SHARE})")
    stats.update(setup=setup, plan=plan, donated_bytes=donated_bytes, delta_share=share,
                 seconds={"on": on["seconds"], "off": off["seconds"]},
                 last_fused={"on": on["last_fused"], "off": off["last_fused"]})
    return stats, launched


def hgmma_counts(library) -> dict:
    """{kernel<D>: its HGMMA (wgmma) instructions} of every kernel of the
    built library that has any, from ``cuobjdump -sass``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"\d((?:fwd|dkv|dq)_[a-z0-9]+_kernel)ILi(\d+)E", line)
            kernel = f"{m.group(1)}<{m.group(2)}>" if m else None
        elif kernel and "HGMMA" in line:
            counts[kernel] = counts.get(kernel, 0) + 1
    return counts


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
    hgmma = hgmma_counts(fa.library_path())
    print("  HGMMA instructions a kernel (cuobjdump -sass): "
          + ", ".join(f"{k} {n}" for k, n in hgmma.items()))
    check(all(hgmma.get(f"{kernel}<{d}>", 0) > 0
              for kernel in ("fwd_wgmma_kernel", "dkv_wgmma_kernel") for d in (64, 128)),
          f"phase 1: a wgmma kernel without HGMMA instructions: {hgmma}")

    phases = time.perf_counter()
    errs = kernel_phase(fa)
    if kernels_only:
        rows, extra = timing_phase(fa, name, None, None, errs["bert_base"])
        llama_rows(fa, name, rows, extra)
        # config 5's shape at a wave of 3 (B 192, the wave its full runs chose)
        config5_times = config5_timing_phase(fa, name, 3)
        extra["config5_bwd_pair_bf16"] = config5_times.pop("bwd_pair")
        block_rows, pairs = ring_block_times(fa, name)
        extra["ring_block_bwd_pair_fp32"] = pairs["float32"]
        extra["ring_block_bwd_pair_bf16"] = pairs["bfloat16"]
        for row in rows:
            row["config5_shape"] = config5_times[f"flash_{row['pass']}"]
            row["ring_block_shape"] = block_rows[f"flash_{row['pass']}"]["bfloat16"]
        rows += fp32_rows(fa, block_rows, errs["ring_block_float32"])
        print(json.dumps({"kernels": rows, "extra": extra}))
        print(f"phases 2 and 5 took {time.perf_counter() - phases:.1f} s; no result line "
              "(--kernels-only)")
        return 0
    main_launches, per_round, round_stats = bert_round_phase(fa)
    in_context_phase(fa)
    rows, extra = timing_phase(fa, name, main_launches, per_round, errs["bert_base"])
    llama_rows(fa, name, rows, extra)
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
    operations_stats = timed_phase("24", operations_phase, fa, http_stats)
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
    extra["config5_bwd_pair_bf16"] = config5_times.pop("bwd_pair")
    auto_stats = timed_phase("18", auto_wave_phase, config5_ctx)
    del config5_ctx
    fused_stats = timed_phase("19", fused_phase, fa)
    examples_stats = timed_phase("20", examples_phase)
    print(f"phases 17-20 took {time.perf_counter() - slice10:.1f} s")
    slice11 = time.perf_counter()
    ring_launches, ring_per_step, ring_rows, ring_stats, ring_reference = \
        sequence_parallel_phase(fa, name)
    print(f"phase 21 took {time.perf_counter() - slice11:.1f} s")
    slice12 = time.perf_counter()
    mesh_launches, mesh_stats = mesh_phase(fa)
    print(f"phase 22 took {time.perf_counter() - slice12:.1f} s")
    slice13 = time.perf_counter()
    hybrid_stats.update(hybrid_phase(fa))
    print(f"phases 23b-c took {time.perf_counter() - slice13:.1f} s")
    slice17 = time.perf_counter()
    torch.cuda.empty_cache()
    processes_stats = {"ring": timed_phase("25a-b", ring_processes_phase, fa, ring_reference)}
    del ring_reference
    processes_stats["lint"] = timed_phase("25c", lint_phase)
    print(f"phase 25 took {time.perf_counter() - slice17:.1f} s")
    fused_mesh_stats = timed_phase("26", fused_mesh_phase, fa)
    torch.cuda.empty_cache()
    donation_stats, donation_launches = timed_phase("27", donation_phase, fa)
    ranks = processes_stats["ring"]["ranks"]
    for row in rows:  # the bf16 kernels' other paths
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
        row["launches_ring_processes_bf16"] = [o["small"]["flash bf16"]["launches"][counter]
                                               for o in ranks]
        row["launches_fused_mesh_bert"] = fused_mesh_stats["launches_fused_mesh_bert"][counter]
        row["launches_per_round_fused_mesh_bert"] = fused_mesh_stats[
            "launches_per_round_fused_mesh_bert"][counter]
        row["launches_per_round_fused_hybrid_bert"] = fused_mesh_stats[
            "launches_per_round_fused_hybrid_bert"][counter]
        row["launches_per_round_fused_processes"] = [
            o["launches_per_round"][counter] for o in fused_mesh_stats["processes"]["ranks"]]
        row.update({key: n[counter] for key, n in donation_launches.items()})
    rows += fp32_rows(fa, ring_rows, errs["ring_block_float32"], ring_launches, ring_per_step)
    for row in rows[-3:]:  # the fp32 (tf32x3) kernels across processes, 25a
        row["launches_per_step_ring_processes"] = [
            [step[row["pass"]] for step in o["long_context"]["launches_per_step"]]
            for o in ranks]

    print(json.dumps({"round": round_stats, "resnet_round": resnet_stats, "extra": extra,
                      "config3_round": config3_stats, "resnet_optimizers": optimizer_stats,
                      "options_parity": parity_errs, "http_round": http_stats,
                      "bandwidth": bandwidth_stats, "secure": secure_stats,
                      "config1": config1_stats, "variants": variants_stats, "zoo": zoo_stats,
                      "config5": config5_stats, "auto_wave": auto_stats, "fused": fused_stats,
                      "examples": examples_stats, "sequence_parallel": ring_stats,
                      "clients_mesh": mesh_stats, "hybrid_mesh": hybrid_stats,
                      "operations_planes": operations_stats,
                      "across_processes": processes_stats, "fused_meshes": fused_mesh_stats,
                      "donation": donation_stats}))
    print(f"the smoke took {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--psum-child"]:
        sys.exit(psum_child(*sys.argv[2:3], int(sys.argv[3]), *sys.argv[4:5]))
    if sys.argv[1:2] == ["--ring-child"]:
        sys.exit(ring_child(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--fused-child"]:
        sys.exit(fused_child(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())
