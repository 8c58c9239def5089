"""BASELINE config 5: ViT cross-silo federation with DP-SGD and secure
aggregation (the port of ``examples/05_vit_dp_secure.py``).

Two privacy layers compose:

* **DP-SGD inside each silo** (``dp=DPConfig(...)`` on the engine):
  per-example gradients are clipped to ``clip_norm`` and Gaussian noise
  is added every local step (``ops/privacy.py``; the per-example ``vmap``
  nests inside the client ``vmap``, and each client's noise comes from
  the round's generator). The RDP accountant reports the resulting
  (epsilon, delta), plain and amplified by subsampling.
* **Secure aggregation across silos** (``ops/secure_agg.py``): each
  silo's round delta is quantized to a modular integer ring and masked
  with pairwise-cancelling noise, so the server only ever sees the SUM —
  demonstrated by masking each client's delta and checking that the
  unmasked sum matches the plain sum (``err < 1e-3``).

Each round draws a Poisson cohort (``poisson_sample``) and trains it
with ``FedSim.run_round(client_indices=...)``; round ``r`` shuffles with
``round_generator(seed + 1, r)``, as the reference folds ``r`` into its
key. For the HTTP protocol with secure aggregation see
``server/http_manager.py`` (``secure_agg=True``).

  python -m baton_tpu_torch.examples.vit_dp_secure [--scale tiny|full] [--remat] [--cpu]

``--scale full`` is the reference's preset: ViT-B/16 (1,000 classes),
16 clients x 4,096 images, batch 64, 20 rounds, fp32 compute. Its data
alone is 39 GB in fp32, and one client's per-example fp32 gradients at
batch 64 are 64 x 86.6 M x 4 B = 22 GB; ``chip_smoke.py`` phase 17 runs
that shape in bf16 with remat on a cut cohort, its waves sized by
``wave_size="auto"``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from baton_tpu_torch.models.vit import ViTConfig, vit_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.ops.privacy import (
    DPConfig,
    poisson_sample,
    rdp_epsilon,
    subsampled_rdp_epsilon,
)
from baton_tpu_torch.ops.secure_agg import aggregate_masked, mask_update
from baton_tpu_torch.parallel.engine import FedSim, round_generator

LEARNING_RATE = 1e-2
FULL = dict(n_clients=16, n_per_client=4096, n_rounds=20, batch_size=64)


def make_data(rng, cfg, n_clients, n_per_client):
    """Class prototypes plus noise: ``n_clients`` datasets of
    ``n_per_client`` NHWC images, as the reference draws them."""
    protos = rng.standard_normal(
        (cfg.n_classes, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    datasets = []
    for _ in range(n_clients):
        y = rng.integers(0, cfg.n_classes, size=n_per_client).astype(np.int32)
        x = protos[y] + 0.5 * rng.standard_normal(
            (n_per_client, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
        datasets.append({"x": x, "y": y})
    return datasets


def make_sim(cfg, batch_size=8, clip_norm=1.0, noise_multiplier=0.5, remat=False,
             compute_dtype=torch.float32, device="cuda") -> FedSim:
    """The example's FedSim: the ViT (``remat`` recomputes encoder
    activations in the backward, the memory lever under per-example
    gradients) with DP-SGD, local SGD at the example's lr."""
    model = vit_model(cfg, compute_dtype=compute_dtype, remat=remat)
    return FedSim(model, batch_size=batch_size, learning_rate=LEARNING_RATE,
                  dp=DPConfig(clip_norm=clip_norm, noise_multiplier=noise_multiplier),
                  device=device)


def cohort_rate(n_clients: int) -> float:
    """Poisson sampling rate of a round's cohort (the reference's)."""
    return 1.0 if n_clients <= 2 else 0.75


def epsilons(n_rounds, n_epochs, capacity, batch_size, n_per_client, noise_multiplier,
             delta):
    """``(steps, eps, eps_amplified, q)``: the plain RDP bound over every
    local step, and the bound amplified by the ``batch_size / n_per_client``
    Poisson fraction each step touches (the standard DP-SGD approximation
    for shuffled batches)."""
    steps = n_rounds * n_epochs * (capacity // batch_size)
    q = batch_size / n_per_client
    return (steps, rdp_epsilon(noise_multiplier, steps, delta),
            subsampled_rdp_epsilon(noise_multiplier, steps, delta, q), q)


def client_deltas(sim, params, data, n_samples):
    """Each client's round delta (one epoch from ``params``, trained
    alone), numpy fp32 on the host."""
    deltas = []
    for c in range(int(len(n_samples))):
        one = {k: v[c:c + 1] for k, v in data.items()}
        res = sim.run_round(params, one, n_samples[c:c + 1],
                            torch.Generator().manual_seed(100 + c), n_epochs=1,
                            collect_client_losses=False)
        deltas.append({k: res.params[k].float().cpu().numpy() - params[k].float().cpu().numpy()
                       for k in params})
    return deltas


def secure_sum_error(deltas, seed) -> float:
    """Mask every delta, sum the masked updates as the server does, and
    return the largest gap of the unmasked sum from the plain float64
    sum."""
    n = len(deltas)
    masked = [mask_update(d, seed + 7, i, n) for i, d in enumerate(deltas)]
    unmasked = aggregate_masked(masked)
    plain = {k: sum(np.asarray(d[k], np.float64) for d in deltas) for k in deltas[0]}
    return max(float(np.max(np.abs(np.asarray(unmasked[k], np.float64) - plain[k])))
               for k in plain)


def run(n_clients=4, n_per_client=16, n_rounds=2, n_epochs=1, batch_size=8,
        clip_norm=1.0, noise_multiplier=0.5, delta=1e-5, config=None,
        seed=0, remat=False, device="cuda"):
    """Train ``n_rounds`` DP rounds on Poisson cohorts, report the
    accountant's epsilon, then check secure aggregation of one round's
    client deltas; returns ``(loss history, epsilon)``."""
    cfg = config or ViTConfig.tiny()
    rng = np.random.default_rng(seed)
    data, n_samples = stack_client_datasets(
        make_data(rng, cfg, n_clients, n_per_client), batch_size=batch_size)
    sim = make_sim(cfg, batch_size, clip_norm, noise_multiplier, remat, device=device)
    params = sim.init(torch.Generator().manual_seed(seed))
    data = {k: torch.as_tensor(v, device=sim.device) for k, v in data.items()}
    n_samples = torch.as_tensor(n_samples, device=sim.device)

    # amplification-by-subsampling needs the cohort drawn independently
    # per round, not a fixed schedule
    base = torch.Generator().manual_seed(seed + 1)
    history = []
    for r in range(n_rounds):
        cohort = poisson_sample(rng, n_clients, cohort_rate(n_clients))
        if cohort.size == 0:  # empty cohort: the round is a no-op
            continue
        res = sim.run_round(params, data, n_samples, round_generator(base, r),
                            n_epochs=n_epochs, client_indices=cohort)
        params = res.params
        history.extend(res.loss_history.tolist())

    steps, eps, eps_amp, q = epsilons(n_rounds, n_epochs, int(data["x"].shape[1]), batch_size,
                                      n_per_client, noise_multiplier, delta)
    print(f"DP-SGD: clip {clip_norm}, noise x{noise_multiplier} -> "
          f"epsilon {eps:.2f} at delta={delta} after {steps} local steps "
          f"({eps_amp:.2f} with subsampling amplification at q={q:.3f})")
    print(f"loss: {history[0]:.4f} -> {history[-1]:.4f}")

    err = secure_sum_error(client_deltas(sim, params, data, n_samples), seed)
    print(f"secure agg: masked-sum error vs plain sum {err:.2e} "
          f"(server never saw an individual update)")
    assert err < 1e-3
    return history, eps


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--scale", choices=["tiny", "full"], default="tiny")
    p.add_argument("--remat", action="store_true",
                   help="recompute encoder activations in backward (per-example DP "
                        "gradients make this the memory lever)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU instead of the CUDA card")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    if args.scale == "full":
        run(**FULL, config=ViTConfig.b16(), remat=args.remat, device=device)
    else:
        history, _ = run(remat=args.remat, device=device)
        assert np.isfinite(history[-1])
