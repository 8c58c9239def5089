"""Advanced aggregation modes in one tour: robust, async, personalized,
clustered (the port of ``examples/08_advanced_aggregation.py``).

On one shared non-IID setup:

1. **Byzantine robustness** (``aggregator="median"``): one poisoned
   client wrecks the weighted mean but not the coordinate median.
2. **Asynchronous FedBuff** (:class:`baton_tpu_torch.parallel.FedBuff`):
   overlapping clients, buffered staleness-discounted updates.
3. **Partial personalization** (:class:`baton_tpu_torch.parallel.FedPer`):
   label-permuted shards where one global head is impossible but
   per-client heads are trivial.
4. **Clustered FL** (:class:`baton_tpu_torch.parallel.ClusteredFedSim`,
   IFCA): a two-population mixture separates into its K=2 models.

  python -m baton_tpu_torch.examples.advanced_aggregation [--scale tiny|full] [--cpu]

The data are the example's numpy draws (``make_data``). Each stage draws
its initial params from ``torch.Generator().manual_seed(seed)`` and round
``r``'s shuffles from ``round_generator`` of the generator seeded as the
example keys that stage (1 robust, 2 FedBuff, 3 personalization, 4
clustered), as the example folds ``r`` into its key. Each stage function
also takes injected shuffles (``perms``), one per round (FedBuff: one
``[buffer, epochs, capacity]`` per step).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from baton_tpu_torch import resolve_device
from baton_tpu_torch.data.synthetic import DEMO_COEF, linear_client_data
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel import ClusteredFedSim, FedBuff, FedPer, FedSim
from baton_tpu_torch.parallel.engine import round_generator

K_CLASSES, D_FEATURES = 4, 8


def make_data(n_clients=8, seed=0):
    """The example's three cohorts, drawn in its order from
    ``np.random.default_rng(seed)``: ``linear`` (the demo's linear
    clients), ``shards`` (label-permuted classification shards) and
    ``mixture`` (two linear populations, ``y = x·DEMO_COEF`` and its
    negation, at least 4 clients each), each ``(data, n_samples)``;
    ``pops`` is the mixture's population per client."""
    rng = np.random.default_rng(seed)
    linear = stack_client_datasets([linear_client_data(rng) for _ in range(n_clients)],
                                   batch_size=32)
    protos = rng.normal(size=(K_CLASSES, D_FEATURES)).astype(np.float32) * 3.0
    shards = []
    for _ in range(n_clients):
        perm = rng.permutation(K_CLASSES)
        y = rng.integers(0, K_CLASSES, size=64).astype(np.int32)
        x = protos[y] + 0.3 * rng.normal(size=(64, D_FEATURES)).astype(np.float32)
        shards.append({"x": x, "y": perm[y].astype(np.int32)})
    mixture, pops = [], []
    # IFCA needs a few clients per population to break symmetry from a
    # random init: at least 4 per population whatever the scale
    per_pop = max(n_clients // 2, 4)
    for pop, coef in ((0, DEMO_COEF), (1, -DEMO_COEF)):
        for _ in range(per_pop):
            xx = rng.normal(size=(64, 10)).astype(np.float32)
            yy = (xx @ coef + 0.1 * rng.normal(size=64)).astype(np.float32)
            mixture.append({"x": xx, "y": yy})
            pops.append(pop)
    return {"linear": linear,
            "shards": stack_client_datasets(shards, batch_size=16),
            "mixture": stack_client_datasets(mixture, batch_size=32),
            "pops": np.asarray(pops)}


def _round_kw(perms, stage_seed: int, r: int) -> dict:
    """Round ``r``'s shuffles: ``perms[r]`` when injected, else drawn from
    the round's generator."""
    if perms is not None:
        return {"perms": perms[r]}
    return {"generator": round_generator(torch.Generator().manual_seed(stage_seed), r)}


def coef_error(params, coef=DEMO_COEF) -> float:
    return float(np.max(np.abs(params["w"].detach().cpu().numpy().ravel() - coef)))


def robust_stage(data, n, spec: str, params, n_rounds: int, device="cuda",
                 perms: Optional[Sequence[torch.Tensor]] = None) -> float:
    """Stage 1: client 0's targets scaled by 1e5, ``n_rounds`` rounds of 4
    epochs under ``spec``; returns the coefficient error."""
    poisoned = dict(data)
    poisoned["y"] = data["y"].copy()
    poisoned["y"][0] *= 1e5
    sim = FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.02,
                 aggregator=spec, device=device)
    p = params
    for r in range(n_rounds):
        p = sim.run_round(p, poisoned, n, n_epochs=4, **_round_kw(perms, 1, r)).params
    return coef_error(p)


def fedbuff_stage(data, n, params, n_clients: int, n_steps: int, device="cuda",
                  perms: Optional[torch.Tensor] = None):
    """Stage 2: FedBuff, buffer 2, ``n_clients`` in flight, alpha 0.5, 2
    local epochs; returns the :class:`AsyncResult`."""
    sim = FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.02, device=device)
    fb = FedBuff(sim, buffer_size=2, concurrency=n_clients, alpha=0.5)
    generator = None if perms is not None else torch.Generator().manual_seed(2)
    return fb.run(params, data, n, generator, n_steps=n_steps, n_epochs=2, perms=perms)


def personalization_stage(data, n, params, n_rounds: int, device="cuda",
                          perms: Optional[Sequence[torch.Tensor]] = None):
    """Stage 3: ``n_rounds`` rounds of global FedAvg and of FedPer (the
    MLP's last layer personal), 2 epochs each, on the same shuffles;
    returns ``(global_acc, personalized_acc, global_params, params,
    personal_state)``."""
    sim = FedSim(mlp_classifier_model(D_FEATURES, (16,), K_CLASSES), batch_size=16,
                 learning_rate=0.1, device=device)
    pg = params
    for r in range(n_rounds):
        pg = sim.run_round(pg, data, n, n_epochs=2, **_round_kw(perms, 3, r)).params
    acc_glob = sim.evaluate_round(pg, data, n)["accuracy"]

    fp = FedPer(sim, personal=lambda path, leaf: path.startswith("1/"))
    p, pers = params, None
    for r in range(n_rounds):
        rr = fp.run_round(p, pers, data, n, n_epochs=2, **_round_kw(perms, 3, r))
        p, pers = rr.params, rr.personal_state
    acc_pers = fp.evaluate(p, pers, data, n)["accuracy"]
    return float(acc_glob), float(acc_pers), pg, p, pers


def clustered_stage(data, n, pops, clusters, n_rounds: int, device="cuda",
                    perms: Optional[Sequence[torch.Tensor]] = None):
    """Stage 4: IFCA with K=2, 2 epochs a round; returns ``(separated,
    clustered eval loss, cluster params)``."""
    sim = FedSim(linear_regression_model(10), batch_size=32, learning_rate=0.05, device=device)
    cf = ClusteredFedSim(sim, n_clusters=2)
    for r in range(n_rounds):
        rr = cf.run_round(clusters, data, n, n_epochs=2, **_round_kw(perms, 4, r))
        clusters = rr.cluster_params
    sep = bool(np.all(rr.assignments == pops) or np.all(rr.assignments == 1 - pops))
    return sep, cf.evaluate(clusters, data, n)["loss"], clusters


def run(n_clients=8, n_rounds=6, seed=0, device="cuda"):
    """The tour; returns the example's ``out`` dict (coefficient errors,
    FedBuff staleness, accuracies, separation, clustered loss)."""
    out = {}
    device = resolve_device(device)
    linear_model = linear_regression_model(10)
    data = make_data(n_clients, seed)

    def init(model):
        return {k: v.to(device) for k, v in model.init(torch.Generator().manual_seed(seed)).items()}

    lin, n = data["linear"]
    for spec in ("mean", "median"):
        err = robust_stage(lin, n, spec, init(linear_model), n_rounds, device)
        out[f"poisoned_{spec}_err"] = err
        print(f"1. poisoned cohort, aggregator={spec:7s}: coef error {err:.3g}")

    res = fedbuff_stage(lin, n, init(linear_model), n_clients, n_rounds * 8, device)
    out["fedbuff_err"] = coef_error(res.params)
    out["fedbuff_staleness"] = res.mean_staleness
    print(f"2. FedBuff async: mean staleness {res.mean_staleness:.2f}, "
          f"coef error {out['fedbuff_err']:.3g}")

    pdata, pn = data["shards"]
    mlp = mlp_classifier_model(D_FEATURES, (16,), K_CLASSES)
    acc_glob, acc_pers, *_ = personalization_stage(pdata, pn, init(mlp), n_rounds + 4, device)
    out["global_acc"] = acc_glob
    out["personalized_acc"] = acc_pers
    print(f"3. label-permuted shards: global acc {acc_glob:.3f}, "
          f"personalized acc {acc_pers:.3f}")

    cdata, cn = data["mixture"]
    clusters = ClusteredFedSim(FedSim(linear_model, device=device), 2).init_clusters(
        torch.Generator().manual_seed(seed))
    sep, loss, _ = clustered_stage(cdata, cn, data["pops"], clusters, n_rounds + 8, device)
    out["clusters_separated"] = sep
    out["clustered_loss"] = loss
    print(f"4. two-population mixture: clusters separated={sep}, "
          f"clustered eval loss {loss:.4f}")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--scale", choices=["tiny", "full"], default="tiny")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    if args.scale == "full":
        out = run(n_clients=32, n_rounds=20, device=device)
    else:
        out = run(device=device)
    assert out["poisoned_median_err"] < 1.0 < out["poisoned_mean_err"]
    assert out["fedbuff_err"] < 1.0
    assert out["personalized_acc"] > out["global_acc"]
    assert out["clusters_separated"] and out["clustered_loss"] < 1.0
