"""Differential privacy — DP-SGD and client-level DP aggregation (the port
of ``baton_tpu/ops/privacy.py``).

Two granularities, composable:

* **Example-level DP-SGD** inside local training: per-example gradients
  are one ``torch.func.vmap`` of ``torch.func.grad_and_value`` over the
  framework's per-example loss contract (``core/model.py``), clipped to
  ``clip_norm`` each in global fp32 L2 norm, summed in fp32,
  Gaussian-noised at ``noise_multiplier * clip_norm``, and averaged over
  the **static** batch size (padding rows have exactly-zero gradients, so
  they are clipped no-ops and the lot size stays data-independent, as
  the DP analysis requires). Enabled by passing :class:`DPConfig` to the
  trainer or the engine.
* **Client-level DP** at aggregation: each client's round delta is
  clipped in global L2 norm, deltas are **uniformly** averaged (weighting
  by private sample counts would leak them into sensitivity), and
  Gaussian noise of std ``noise_multiplier * clip_norm / n_clients`` is
  added to the mean — the DP-FedAvg recipe.

Noise is drawn from an explicit ``torch.Generator`` on the tensors'
device; the estimators also take the standard-normal draws themselves
(``noise=``), which is how the trainer hands each client of a vmapped
cohort its own draws (``torch.func.vmap`` refuses random operations
inside the transform). JAX's threefry keys cannot be reproduced in
torch, so the two packages agree only where the noise is passed in or
is zero.

Accounting is Rényi-DP, numpy and ``math`` only, copied from the JAX
module: without sampling each step or round is ``(α, α/(2σ²))``-RDP
(:func:`rdp_epsilon`); with Poisson subsampling (:func:`poisson_sample`
drives cohort selection, ``FedSim.run_round(client_indices=…)`` consumes
it) the sampled Gaussian mechanism's amplified RDP is computed at integer
orders via the exact binomial expansion (:func:`sampled_gaussian_rdp`),
composed additively over steps, and converted with the tight RDP→(ε, δ)
bound (:func:`subsampled_rdp_epsilon`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Hashable DP-SGD settings.

    ``noise_multiplier`` is σ in the DP literature: noise std per step is
    ``noise_multiplier * clip_norm`` on the *summed* clipped gradients.

    **Scope of the guarantee**: the RDP accounting covers the *gradients*
    (and therefore the released model parameters). Reported training
    losses (``loss_history`` / ``RoundResult.client_losses``) are exact
    functions of the private data and are NOT privatized — treat them as
    diagnostics for trusted eyes only, or suppress them at the release
    boundary (``FedSim.run_round(collect_client_losses=False)``).
    """

    clip_norm: float
    noise_multiplier: float


def global_norm(tree: Params) -> torch.Tensor:
    """L2 norm over every leaf of a params dict, fp32."""
    return torch.sqrt(sum(leaf.float().square().sum() for leaf in tree.values()))


def clip_by_global_norm(tree: Params, max_norm) -> Params:
    """Scale ``tree`` so its global L2 norm is at most ``max_norm``."""
    norm = global_norm(tree)
    factor = torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0)
    return {k: (v.float() * factor).to(v.dtype) for k, v in tree.items()}


def _clip_factors(stacked: Params, clip_norm) -> torch.Tensor:
    """``min(1, clip / max(norm, 1e-12))`` per row of a ``[N, ...]``
    stacked dict, the norm global over its leaves in fp32."""
    sq = [g.float().square().sum(dim=tuple(range(1, g.dim()))) for g in stacked.values()]
    norms = torch.sqrt(sum(sq))
    return torch.clamp(clip_norm / norms.clamp_min(1e-12), max=1.0)


def per_example_clipped_grad_sum(loss_fn: Callable, params: Params, batch, clip_norm):
    """Returns ``(Σ_i clip(∇ loss_fn(params, example_i), clip_norm),
    per-example losses [B])``, the sums in fp32.

    ``loss_fn(params, single_example_batch) -> scalar`` where every leaf
    of the batch dict has leading dim 1. Per-example gradients are a vmap
    over the batch axis; each is clipped to ``clip_norm`` in global L2
    before summation — the DP-SGD sensitivity bound. Losses fall out of
    the same pass (no extra forward) and are NOT part of the DP guarantee
    (see :class:`DPConfig`). (The JAX function also takes a key for the
    loss; the port's models draw no randomness.)
    """

    def single(p, example):
        return loss_fn(p, {k: a[None] for k, a in example.items()})

    grads, losses = torch.func.vmap(
        torch.func.grad_and_value(single), in_dims=(None, 0))(params, dict(batch))
    factors = _clip_factors(grads, clip_norm)

    def clip_and_sum(g):
        return (g.float() * factors.reshape((-1,) + (1,) * (g.dim() - 1))).sum(0)

    return {k: clip_and_sum(g) for k, g in grads.items()}, losses


def gaussian_noise_like(tree: Params, std, generator: torch.Generator) -> Params:
    """Independent N(0, std²) per element, fp32, drawn leaf by leaf (in
    the dict's order) from ``generator`` on its device."""
    return {k: torch.randn(v.shape, generator=generator, device=generator.device,
                           dtype=torch.float32) * std for k, v in tree.items()}


def _noise_terms(tree: Params, std, generator: Optional[torch.Generator],
                 noise: Optional[Params]) -> Optional[Params]:
    """``std`` times standard normals shaped as ``tree``, fp32: ``noise``
    when given, else drawn from ``generator``; None (nothing drawn) at
    std 0 without ``noise``."""
    if noise is None:
        if std == 0:
            return None
        if generator is None:
            raise ValueError("DP noise needs a torch.Generator (or the draws as noise=)")
        return gaussian_noise_like(tree, std, generator)
    return {k: noise[k] * std for k in tree}


def dp_sgd_grads(loss_fn: Callable, params: Params, batch,
                 generator: Optional[torch.Generator], dp: DPConfig, batch_size: int,
                 noise: Optional[Params] = None):
    """The DP-SGD gradient estimator: clipped per-example sum + noise,
    averaged over the static lot size ``batch_size`` (not the count of
    real rows).

    The noise is ``noise_multiplier * clip_norm`` times standard normals:
    ``noise`` (a dict shaped as ``params``) when given, else drawn from
    ``generator``. Returns ``(grads, per_example_losses)``; gradient
    leaves keep the parameter dtypes."""
    summed, losses = per_example_clipped_grad_sum(loss_fn, params, batch, dp.clip_norm)
    noise = _noise_terms(summed, dp.noise_multiplier * dp.clip_norm, generator, noise)
    if noise is not None:
        summed = {k: g + noise[k] for k, g in summed.items()}
    return {k: (g / batch_size).to(params[k].dtype) for k, g in summed.items()}, losses


# ---------------------------------------------------------------------------
# client-level DP aggregation (DP-FedAvg)


def dp_client_deltas(stacked_params: Params, global_params: Params, clip_norm) -> Params:
    """Per-client round deltas, fp32, clipped to ``clip_norm`` in global
    L2. ``stacked_params`` has a leading client axis on every leaf."""
    deltas = {k: v.float() - global_params[k].float() for k, v in stacked_params.items()}
    factors = _clip_factors(deltas, clip_norm)
    return {k: d * factors.reshape((-1,) + (1,) * (d.dim() - 1)) for k, d in deltas.items()}


def dp_fedavg(stacked_params: Params, global_params: Params,
              generator: Optional[torch.Generator], clip_norm, noise_multiplier,
              noise: Optional[Params] = None) -> Params:
    """DP-FedAvg: uniform mean of clipped client deltas + Gaussian noise.

    Replaces sample-weighted FedAvg when client-level DP is on: weighting
    by private ``n_samples`` would make sensitivity data-dependent, so the
    mean is uniform and the noise std is ``noise_multiplier * clip_norm /
    C`` (standard normals from ``noise`` or ``generator``). Returns new
    global params (same dtypes as ``global_params``)."""
    deltas = dp_client_deltas(stacked_params, global_params, clip_norm)
    n_clients = next(iter(deltas.values())).shape[0]
    mean_delta = {k: d.mean(0) for k, d in deltas.items()}
    noise = _noise_terms(mean_delta, noise_multiplier * clip_norm / n_clients, generator, noise)
    out = {k: g.float() + mean_delta[k] for k, g in global_params.items()}
    if noise is not None:
        out = {k: v + noise[k] for k, v in out.items()}
    return {k: v.to(global_params[k].dtype) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Rényi-DP accounting (Gaussian mechanism, exact composition); numpy and
# math only, as in the JAX module

DEFAULT_ORDERS = tuple([1.25, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0,
                        16.0, 32.0, 64.0, 128.0, 256.0])


def rdp_epsilon(noise_multiplier: float, steps: int, delta: float,
                orders: Sequence[float] = DEFAULT_ORDERS) -> float:
    """(ε, δ)-DP spent by ``steps`` Gaussian mechanisms of parameter σ.

    Each step is (α, α/(2σ²))-RDP; RDP composes additively; the
    conversion ε = min_α [T·α/(2σ²) + log(1/δ)/(α−1)] uses the standard
    RDP→DP bound. Conservative under subsampling (no amplification
    claimed).
    """
    if noise_multiplier <= 0:
        return float("inf")
    sigma2 = noise_multiplier ** 2
    eps = [
        steps * a / (2.0 * sigma2) + np.log(1.0 / delta) / (a - 1.0)
        for a in orders
        if a > 1.0
    ]
    return float(min(eps))


# Integer Rényi orders: the exact SGM expansion below holds at integer α;
# the dense low range covers high-privacy regimes, the powers of two reach
# the tiny-q regimes where the optimum α is large.
INT_ORDERS = tuple(list(range(2, 33)) + [40, 48, 64, 96, 128, 192, 256, 512])


def poisson_sample(rng: np.random.Generator, n: int, q: float) -> np.ndarray:
    """Poisson sampling: each of ``n`` clients/examples independently
    joins with probability ``q``. Returns the (possibly empty) sorted
    index array — feed it to ``FedSim.run_round(client_indices=…)``.

    Host-side by design: cohort selection happens at dispatch time and
    its size varies round to round — exactly what the amplification
    theorem requires.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate must be in [0, 1], got {q}")
    return np.flatnonzero(rng.random(n) < q)


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def sampled_gaussian_rdp(
    q: float, noise_multiplier: float,
    orders: Sequence[int] = INT_ORDERS,
) -> np.ndarray:
    """Per-step RDP of the Poisson-sampled Gaussian mechanism.

    At integer order α the SGM satisfies (α, ε_α)-RDP with

        ε_α = log( Σ_{k=0}^{α} C(α,k) (1−q)^{α−k} q^k ·
                   exp(k(k−1)/(2σ²)) ) / (α−1)

    (Mironov et al. 2019, "Rényi DP of the Sampled Gaussian Mechanism",
    Thm. 4/§3.3 — the standard accountant's integer-order path). The sum
    is evaluated in log space; q=0 gives 0, q=1 recovers the unamplified
    α/(2σ²) exactly.
    """
    if noise_multiplier <= 0:
        return np.full(len(orders), np.inf)
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate must be in [0, 1], got {q}")
    sigma2 = noise_multiplier ** 2
    out = []
    for a in orders:
        if a != int(a) or a < 2:
            raise ValueError(f"integer orders >= 2 only, got {a}")
        a = int(a)
        if q == 0.0:
            out.append(0.0)
            continue
        log_terms = []
        for k in range(a + 1):
            t = k * (k - 1) / (2.0 * sigma2)
            if q < 1.0:
                t += (_log_comb(a, k) + (a - k) * math.log1p(-q)
                      + (k * math.log(q) if k else 0.0))
            elif k < a:
                continue  # q == 1: only the k == α term survives
            log_terms.append(t)
        m = max(log_terms)
        log_a = m + math.log(sum(math.exp(t - m) for t in log_terms))
        out.append(log_a / (a - 1))
    return np.asarray(out)


def rdp_to_epsilon(rdp: Sequence[float], orders: Sequence[int],
                   delta: float) -> float:
    """Tight RDP→(ε, δ) conversion, minimized over orders:

        ε = rdp_α + log((α−1)/α) − (log δ + log α)/(α−1)

    (Canonne–Kamath–Steinke 2020 refinement of the classic
    ``rdp + log(1/δ)/(α−1)`` bound — the conversion production DP-SGD
    accountants report.)
    """
    best = np.inf
    for r, a in zip(rdp, orders):
        if not np.isfinite(r):
            continue
        eps = (r + math.log1p(-1.0 / a)
               - (math.log(delta) + math.log(a)) / (a - 1))
        best = min(best, max(eps, 0.0))
    return float(best)


def subsampled_rdp_epsilon(
    noise_multiplier: float,
    steps: int,
    delta: float,
    sampling_rate: float,
    orders: Sequence[int] = INT_ORDERS,
) -> float:
    """(ε, δ) spent by ``steps`` Poisson-subsampled Gaussian mechanisms.

    The amplified counterpart of :func:`rdp_epsilon`: with sampling rate
    q = lot/population (example-level DP-SGD) or cohort/registry
    (client-level DP-FedAvg), per-step RDP shrinks roughly like q²·α/σ²
    for small q — orders of magnitude over the unamplified bound. On the
    canonical MNIST DP-SGD setting (σ=1.1, q=256/60000, 60 epochs,
    δ=1e-5) the classic conversion gives the folklore ε=3.0 to three
    digits and the tight conversion ε≈2.60 (tests/test_torch_privacy.py).
    """
    rdp = sampled_gaussian_rdp(sampling_rate, noise_multiplier, orders)
    return rdp_to_epsilon(rdp * steps, orders, delta)
