#!/usr/bin/env python3
"""Time the port's meshless BERT-base round for one checkout, to compare two
checkouts on one card.

``python3 scripts/torch_round_ab.py --root DIR`` imports ``baton_tpu_torch``
from ``DIR`` (default: this checkout), builds its flash kernels, and runs
``chip_smoke.py``'s phase-3 cohort (BERT-base, bf16 compute, 8 clients x 32
samples, one wave, no mesh) through ``FedSim.run_round``: one warm-up round,
then ``--rounds`` timed ones on the same params and shuffles, each closed by
a device sync. Prints one JSON line: the root, the seconds of each timed
round, their median, the flash launches of a round by pass and the loss.
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
    ap.add_argument("--rounds", type=int, default=10)
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
    _, model, data, n_samples = smoke.bert_base_cohort()
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    n_samples = torch.as_tensor(n_samples, device="cuda")
    sim = FedSim(model, batch_size=32, learning_rate=0.01)
    params = sim.init(torch.Generator().manual_seed(0))
    perms = random_perms(len(n_samples), 1, data["x"].shape[1], torch.Generator().manual_seed(1))

    def one_round():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run_round(params, data, n_samples, perms=perms)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    one_round()  # warm-up
    before = dict(fa.launches())
    res, _ = one_round()
    launches = {k: v - before.get(k, 0) for k, v in fa.launches().items()}
    times = [one_round()[1] for _ in range(args.rounds)]
    print(json.dumps({"root": root, "s_per_round": times, "median_s": float(np.median(times)),
                      "launches_per_round": launches, "loss": res.loss_history.tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
