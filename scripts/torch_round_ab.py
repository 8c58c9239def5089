#!/usr/bin/env python3
"""Time the port's meshless round for one checkout, to compare two checkouts
on one card.

``python3 scripts/torch_round_ab.py --root DIR [--cohort bert|config4|example06]``
imports ``baton_tpu_torch`` from ``DIR`` (default: this checkout), builds its
flash kernels, and runs one of ``chip_smoke.py``'s cohorts through
``FedSim.run_round``: ``bert`` (the default) is phase 3's (BERT-base, bf16
compute, 8 clients x 32 samples, one wave, no mesh), ``config4`` phase 16a's
(BASELINE config 4 at Llama-3-8B width and depth, LoRA rank 16, bf16 with
remat, 4 clients x 16 samples in waves of 2, about 8.5 s a round on an H100).
One warm-up round, then ``--rounds`` timed ones (default 10 for ``bert``, 3
for ``config4``) on the same params and shuffles, each closed by a device
sync. Prints one JSON line: the root, the cohort, the seconds of each timed
round, their median, the flash launches of a round by pass and the loss.
``example06`` times training steps instead of rounds: example 06's full
preset (``long_context_ring.full_preset``: a Llama-class decoder at 32,768
tokens, ring x flash over 8 shards of the card, fp32, remat) as phase 21a
of ``chip_smoke.py`` runs it, one warm-up step and ``--rounds`` timed ones
(default 4), each from one step's loss read-back to the next; it prints the
seconds of each, their median, tokens/s and the flash launches of a step
by pass and by design.
Compare two checkouts in one session on the machine, in the order A, B, B, A,
one process each. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose package is timed")
    ap.add_argument("--cohort", choices=("bert", "config4", "example06"), default="bert")
    ap.add_argument("--rounds", type=int, default=None,
                    help="timed rounds (default 10 for bert, 3 for config4) or steps "
                         "(4 for example06)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_round_ab: no CUDA device is available", file=sys.stderr)
        return 1
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    # the cohort comes from this checkout's chip_smoke.py; its functions
    # import the package from ``root``, first on the path
    spec = importlib.util.spec_from_file_location("chip_smoke_cohort", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.core.training import random_perms
    from baton_tpu_torch.ops import flash_attention as fa

    if not str(Path(fa.__file__).resolve()).startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not the package in {root}")
    fa.load_library()
    if args.cohort == "example06":
        return example06_steps(root, fa, args.rounds or 4)
    wave = None
    if args.cohort == "bert":
        _, model, data, n_samples = smoke.bert_base_cohort()
        sim = FedSim(model, batch_size=32, learning_rate=0.01)
        params = sim.init(torch.Generator().manual_seed(0))
    else:
        from baton_tpu_torch.examples import llama_lora

        cfg, batch, rank = llama_lora.FULL_CONFIG, smoke.CONFIG4_BATCH, smoke.CONFIG4_RANK
        sim, _ = llama_lora.make_sim(cfg, rank, batch, "cuda", compute_dtype=torch.bfloat16,
                                     remat=True)
        params = sim.init(torch.Generator(device="cuda").manual_seed(0))
        data, n_samples = llama_lora.client_data(cfg, smoke.CONFIG4_CLIENTS,
                                                 smoke.CONFIG4_PER_CLIENT, batch, seed=0)
        wave = smoke.config4_wave(cfg, batch, rank, smoke.CONFIG4_CLIENTS,
                                  torch.cuda.get_device_properties(0).total_memory)
    rounds = args.rounds or (10 if args.cohort == "bert" else 3)
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    n_samples = torch.as_tensor(n_samples, device="cuda")
    perms = random_perms(len(n_samples), 1, data["x"].shape[1], torch.Generator().manual_seed(1))

    def one_round():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run_round(params, data, n_samples, perms=perms, wave_size=wave)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    one_round()  # warm-up
    before = dict(fa.launches())
    res, _ = one_round()
    launches = {k: v - before.get(k, 0) for k, v in fa.launches().items()}
    times = [one_round()[1] for _ in range(rounds)]
    print(json.dumps({"root": root, "cohort": args.cohort, "s_per_round": times,
                      "median_s": float(np.median(times)),
                      "launches_per_round": launches, "loss": res.loss_history.tolist()}))
    return 0


def example06_steps(root, fa, steps) -> int:
    """Example 06's full preset for one warm-up and ``steps`` timed steps."""
    from baton_tpu_torch.examples import long_context_ring as ex

    full = dict(ex.full_preset(), n_steps=1 + steps)
    cfg = full["config"]
    stamps, counts = [], []

    def stamp(step, loss):  # after each step's loss read-back
        stamps.append(time.perf_counter())
        counts.append((fa.launches(), dict(fa.launches_by_design)))

    fa.reset_launches()
    torch.cuda.synchronize()
    losses = ex.run(**full, device="cuda", progress_fn=stamp)
    times = np.diff(stamps).tolist()
    (pass0, design0), (pass1, design1) = counts[0], counts[1]
    median = float(np.median(times))
    print(json.dumps({"root": root, "cohort": "example06", "s_per_step": times,
                      "median_s": median, "tokens_per_s": full["batch_size"] * cfg.max_len / median,
                      "launches_per_step": {k: n - pass0[k] for k, n in pass1.items()},
                      "launches_per_step_by_design": {k: n - design0[k] for k, n in design1.items()
                                                      if n != design0[k]},
                      "losses": losses}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
