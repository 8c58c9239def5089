"""FedSim on one device (counterpart of ``baton_tpu/parallel/engine.py``).

A round broadcasts the global params, trains every client of a wave in
lockstep (``LocalTrainer.train_clients``: a ``torch.func.vmap`` over the
client axis per SGD step), and combines the clients by the aggregator:

* ``"mean"`` folds each wave into fp32 sample-weighted sums (Σ w·params,
  Σ w·losses, Σ w) that are divided once at the end — the same FedAvg as
  one big wave, since the weighted mean is associative in its sums;
* ``"trimmed:<ratio>"`` and ``"median"`` keep every client's params
  ([C, model] on the device, the price of an order statistic) and take
  the coordinate-wise trimmed mean or median of the clients that hold
  samples (``ops/aggregation.py``), unweighted.

The loss history stays sample-weighted under every aggregator. A short
wave is padded with zero-weight phantom clients. Each round leaves its
compute record (throughput, MFU, peak memory; ``obs/compute.py``) in
``last_compute``.

Ported: ``run_round`` (vmap mode, waves), ``run_rounds``,
``evaluate_round``. Not ported yet, and refused with NotImplementedError:
a device mesh, regularizers (FedProx), DP-SGD, trainable partitions
(LoRA), server optimizers (FedOpt), non-SGD local optimizers,
checkpointing and ``run_rounds_fused``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from baton_tpu_torch import resolve_device
from baton_tpu_torch.core.model import FedModel, Params
from baton_tpu_torch.core.training import LocalTrainer, make_local_trainer, random_perms
from baton_tpu_torch.obs.compute import ComputeProbe
from baton_tpu_torch.ops import aggregation as agg

log = logging.getLogger(__name__)


@dataclasses.dataclass
class RoundResult:
    params: Params
    loss_history: torch.Tensor  # [n_epochs], sample-weighted across clients
    client_losses: Optional[torch.Tensor]  # [C, n_epochs]
    n_samples_total: torch.Tensor


def client_eval_sums(model: FedModel, params, d, n):
    """One client's evaluation sums: masked loss sum, valid count and, for
    rank-1 integer labels, the correct-prediction sum."""
    losses = model.per_example_loss(params, d)
    mask = (torch.arange(losses.shape[0], device=losses.device) < n).float()
    out = {"loss_sum": (losses.float() * mask).sum(), "n": mask.sum()}
    y = d.get("y")
    if y is not None and not torch.is_floating_point(y) and y.dim() == losses.dim():
        logits = model.apply(params, d)
        correct = (logits.argmax(dim=-1) == y).float()
        out["correct_sum"] = (correct * mask).sum()
    return out


class FedSim:
    """Simulated-clients federated training on one device.

    ``data`` is a dict of ``[C, capacity, ...]`` arrays (numpy or tensors;
    see :func:`baton_tpu_torch.ops.padding.stack_client_datasets`) and
    ``n_samples`` is ``[C]``: each client's true row count and FedAvg
    weight. ``aggregator`` is ``"mean"`` (sample-weighted FedAvg),
    ``"trimmed:<ratio>"`` or ``"median"`` (module docstring).
    """

    def __init__(
        self,
        model: FedModel,
        optimizer=None,
        batch_size: int = 32,
        learning_rate: float = 1e-3,
        server_optimizer=None,
        mesh=None,
        regularizer=None,
        trainable=None,
        dp=None,
        aggregator: str = "mean",
        device="cuda",
    ):
        not_ported = {"server_optimizer": server_optimizer, "mesh": mesh,
                      "regularizer": regularizer, "trainable": trainable, "dp": dp}
        for name, value in not_ported.items():
            if value is not None:
                raise NotImplementedError(f"FedSim({name}=...) is not ported yet")
        self.aggregator = agg.parse_aggregator(aggregator)
        self.device = resolve_device(device)
        self.model = model
        self.trainer: LocalTrainer = make_local_trainer(
            model, optimizer=optimizer, batch_size=batch_size,
            learning_rate=learning_rate)
        self.compute_probe = ComputeProbe(model)
        self.last_compute: Optional[dict] = None

    def init(self, generator: torch.Generator) -> Params:
        return {k: v.to(self.device) for k, v in self.model.init(generator).items()}

    def _to_device(self, data, n_samples):
        data = {k: torch.as_tensor(v, device=self.device) for k, v in data.items()}
        return data, torch.as_tensor(n_samples, device=self.device)

    def _pad_wave(self, data, n_samples, perms, target: int):
        """Pad a short wave with zero-weight phantom clients: all-zero
        data, n = 0 (every row masked, exactly-zero grads, FedAvg weight
        0). Their shuffles only need a valid shape."""
        c = n_samples.shape[0]
        if c == target:
            return data, n_samples, perms
        pad = target - c
        data = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])]) for k, v in data.items()}
        n_samples = torch.cat([n_samples, n_samples.new_zeros(pad)])
        if perms is not None:
            perms = torch.cat([perms, perms[:1].expand(pad, *perms.shape[1:])])
        return data, n_samples, perms

    def run_round(
        self,
        params: Params,
        data: Dict,
        n_samples,
        generator: Optional[torch.Generator] = None,
        n_epochs: int = 1,
        wave_size: Optional[int] = None,
        client_indices: Optional[np.ndarray] = None,
        collect_client_losses: bool = True,
        progress_fn=None,
        perms: Optional[torch.Tensor] = None,
    ) -> RoundResult:
        """One FedAvg round; returns the new global params.

        ``perms`` [C, n_epochs, capacity] injects every client's
        per-epoch shuffle (for the selected cohort, after
        ``client_indices``); without it they are drawn from ``generator``.
        ``progress_fn(waves_done, n_waves)`` runs on the host after each
        wave and waits for the device to finish it.
        """
        data, n_samples = self._to_device(data, n_samples)
        if client_indices is not None:
            idx = torch.as_tensor(client_indices, device=self.device)
            data = {k: v[idx] for k, v in data.items()}
            n_samples = n_samples[idx]
        c = int(n_samples.shape[0])
        capacity = next(iter(data.values())).shape[1]
        if perms is None:
            perms = random_perms(c, n_epochs, capacity, generator)
        perms = perms.to(self.device)
        wave_size = c if wave_size is None else wave_size

        robust = self.aggregator[0] != "mean"
        psum_acc = lsum_acc = w_acc = None
        stacked_parts = []
        per_client = [] if collect_client_losses else None
        n_waves = -(-c // wave_size)
        t0 = time.perf_counter()
        for start in range(0, c, wave_size):
            stop = min(start + wave_size, c)
            d, n, pm = self._pad_wave(
                {k: v[start:stop] for k, v in data.items()},
                n_samples[start:stop], perms[start:stop], wave_size)
            client_params, client_losses = self.trainer.train_clients(
                params, d, n, n_epochs, pm)
            w = n.float()
            lsum = w @ client_losses.float()
            if robust:
                stacked_parts.append({k: v[: stop - start] for k, v in client_params.items()})
            else:
                psum = agg.weighted_tree_sum(client_params, w)
                if psum_acc is None:
                    psum_acc = psum
                else:
                    for k in psum_acc:
                        psum_acc[k] += psum[k]
            lsum_acc = lsum if lsum_acc is None else lsum_acc + lsum
            w_acc = w.sum() if w_acc is None else w_acc + w.sum()
            if per_client is not None:
                per_client.append(client_losses[: stop - start])
            if progress_fn is not None:
                lsum.sum().item()  # wait for the wave's device work
                progress_fn(start // wave_size + 1, n_waves)

        # the round's one device sync closes the timed window over the waves
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._record_compute(time.perf_counter() - t0, data, n_samples, capacity, wave_size,
                             n_epochs, robust)

        denom = w_acc.clamp_min(1e-9)
        if robust:
            stacked = {k: torch.cat([part[k] for part in stacked_parts]) for k in params}
            new_params = agg.aggregate_stacked(self.aggregator, stacked, n_samples, params)
        else:
            new_params = {k: (s / denom).to(params[k].dtype) for k, s in psum_acc.items()}
        return RoundResult(
            params=new_params,
            loss_history=lsum_acc / denom,
            client_losses=torch.cat(per_client) if per_client else None,
            n_samples_total=w_acc,
        )

    def _record_compute(self, train_s, data, n_samples, capacity, wave_size, n_epochs, robust):
        """Set ``last_compute`` to the round's compute record. A probe
        failure is logged and leaves it None: it never fails the round."""
        try:
            c = int(n_samples.shape[0])
            sig = (c, int(wave_size), int(n_epochs), robust,
                   tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in data.items())))
            self.last_compute = self.compute_probe.record_round(
                key="run_round", signature=sig, train_s=train_s,
                n_samples=float(n_samples.sum()), device=self.device, n_epochs=n_epochs,
                steps=c * n_epochs * -(-capacity // self.trainer.batch_size))
        except Exception:
            log.exception("compute probe failed; last_compute is None for this round")
            self.last_compute = None

    def run_rounds(self, params: Params, data, n_samples,
                   generator: Optional[torch.Generator] = None, n_rounds: int = 1,
                   n_epochs: int = 1, checkpointer=None, **kw):
        """Loop over rounds; returns ``(params, loss_history list)``."""
        if checkpointer is not None:
            raise NotImplementedError("checkpointing is not ported yet")
        data, n_samples = self._to_device(data, n_samples)
        history = []
        for _ in range(n_rounds):
            res = self.run_round(params, data, n_samples, generator,
                                 n_epochs=n_epochs, **kw)
            params = res.params
            history.extend(res.loss_history.tolist())
        return params, history

    def run_rounds_fused(self, *args, **kw):
        raise NotImplementedError("run_rounds_fused is not ported yet")

    @torch.no_grad()
    def evaluate_round(self, params: Params, data: Dict, n_samples,
                       wave_size: Optional[int] = None) -> Dict[str, float]:
        """Example-weighted federation-wide ``{"loss", "n", "accuracy"}``
        of ``params`` over every client's local data, ``wave_size``
        clients at a time."""
        data, n_samples = self._to_device(data, n_samples)
        c = int(n_samples.shape[0])
        wave = c if wave_size is None else wave_size
        sums_fn = torch.func.vmap(
            lambda d, n: client_eval_sums(self.model, params, d, n))
        totals: Dict[str, float] = {}
        for start in range(0, c, wave):
            stop = min(start + wave, c)
            d, n, _ = self._pad_wave({k: v[start:stop] for k, v in data.items()},
                                     n_samples[start:stop], None, wave)
            for k, v in sums_fn(d, n).items():
                totals[k] = totals.get(k, 0.0) + float(v.sum())
        denom = max(totals.get("n", 0.0), 1.0)
        out = {"loss": totals.get("loss_sum", 0.0) / denom, "n": denom}
        if "correct_sum" in totals:
            out["accuracy"] = totals["correct_sum"] / denom
        return out
