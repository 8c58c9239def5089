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

Options, as in the JAX engine: a local ``optimizer`` (``core/optim.py``;
plain SGD by default), a ``regularizer`` (FedProx: its anchor is the
round's global trainable params), a ``trainable`` predicate (only those
params are trained, folded and aggregated; the frozen rest is held once
and never repeated per client) and a ``server_optimizer`` (FedOpt: the
fp32 pseudo-gradient ``global - aggregate`` goes through it after the
aggregator; ``optim.sgd(1.0)`` is exactly FedAvg).

Ported: ``run_round`` (vmap mode, waves), ``run_rounds`` (with the
server optimizer's state and a checkpointer), ``evaluate_round``,
``evaluate_clients``. Not ported yet, and refused with
NotImplementedError: a device mesh, DP-SGD, ``auto_wave_size``
(``wave_size="auto"``) and ``run_rounds_fused``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from baton_tpu_torch import resolve_device
from baton_tpu_torch.core import optim
from baton_tpu_torch.core.model import FedModel, Params
from baton_tpu_torch.core.partition import PathPredicate, make_partition
from baton_tpu_torch.core.training import LocalTrainer, make_local_trainer, random_perms
from baton_tpu_torch.obs.compute import ComputeProbe
from baton_tpu_torch.ops import aggregation as agg

log = logging.getLogger(__name__)


def round_generator(generator: torch.Generator, round_idx: int) -> torch.Generator:
    """Round ``round_idx``'s generator in ``FedSim.run_rounds``: seeded
    from ``generator``'s initial seed and the round index through numpy's
    ``SeedSequence``, on ``generator``'s device. It depends on nothing
    drawn before, so round ``i`` of a resumed run draws what round ``i``
    of the uninterrupted run drew."""
    seed = np.random.SeedSequence([generator.initial_seed(), round_idx]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=generator.device).manual_seed(int(seed))


@dataclasses.dataclass
class RoundResult:
    params: Params
    loss_history: torch.Tensor  # [n_epochs], sample-weighted across clients
    client_losses: Optional[torch.Tensor]  # [C, n_epochs]
    n_samples_total: torch.Tensor
    server_opt_state: Any = None


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


def federation_eval(sums: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Example-weighted ``{"loss", "n"}`` (and ``"accuracy"``) over the
    clients' evaluation sums (``client_eval_sums``, each [C])."""
    totals = {k: float(v.sum()) for k, v in sums.items()}
    denom = max(totals.get("n", 0.0), 1.0)
    out = {"loss": totals.get("loss_sum", 0.0) / denom, "n": denom}
    if "correct_sum" in totals:
        out["accuracy"] = totals["correct_sum"] / denom
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
        optimizer: Optional[optim.GradientTransformation] = None,
        batch_size: int = 32,
        learning_rate: float = 1e-3,
        server_optimizer: Optional[optim.GradientTransformation] = None,
        mesh=None,
        regularizer=None,
        trainable: Optional[PathPredicate] = None,
        dp=None,
        aggregator: str = "mean",
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "FedSim(mesh=...) is not ported yet (ROADMAP item 11)")
        self.aggregator = agg.parse_aggregator(aggregator)
        self.device = resolve_device(device)
        self.model = model
        self.trainer: LocalTrainer = make_local_trainer(
            model, optimizer=optimizer, batch_size=batch_size,
            learning_rate=learning_rate, regularizer=regularizer, dp=dp)
        self.server_optimizer = server_optimizer
        # ``trainable(name, leaf) -> bool`` restricts training and
        # aggregation to those params; the partition is built from the
        # first params seen
        self.trainable_predicate = trainable
        self.partition = None
        self.compute_probe = ComputeProbe(model)
        self.last_compute: Optional[dict] = None

    def _split(self, params: Params):
        """(trainable, frozen); (params, None) without a partition."""
        if self.trainable_predicate is None:
            return params, None
        if self.partition is None:
            self.partition = make_partition(params, self.trainable_predicate)
            self.trainer = dataclasses.replace(self.trainer, partition=self.partition)
        return self.partition.split(params)

    def init_server_opt_state(self, params: Params):
        """The server optimizer's state over the trainable params, or None."""
        if self.server_optimizer is None:
            return None
        trainable, _ = self._split(params)
        return self.server_optimizer.init(trainable)

    def auto_wave_size(self, *args, **kw):
        raise NotImplementedError(
            "auto_wave_size is not ported yet: it reads XLA's static memory plan, which "
            "torch has no counterpart of; pass an explicit wave_size")

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
        server_opt_state=None,
        client_indices: Optional[np.ndarray] = None,
        collect_client_losses: bool = True,
        progress_fn=None,
        perms: Optional[torch.Tensor] = None,
    ) -> RoundResult:
        """One federated round; returns the new global params (all of
        them, frozen ones included) and, with a server optimizer, its new
        state (``server_opt_state`` None starts from its init).

        ``perms`` [C, n_epochs, capacity] injects every client's
        per-epoch shuffle (for the selected cohort, after
        ``client_indices``); without it they are drawn from ``generator``.
        ``progress_fn(waves_done, n_waves)`` runs on the host after each
        wave and waits for the device to finish it.
        """
        if wave_size == "auto":
            self.auto_wave_size()
        trainable, frozen = self._split(params)
        anchor = trainable if self.trainer.regularizer is not None else None
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
                trainable, d, n, n_epochs, pm, anchor=anchor, frozen=frozen)
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
            stacked = {k: torch.cat([part[k] for part in stacked_parts]) for k in trainable}
            aggregate = agg.aggregate_stacked(self.aggregator, stacked, n_samples, trainable)
        else:
            aggregate = {k: (s / denom).to(trainable[k].dtype) for k, s in psum_acc.items()}
        if self.server_optimizer is not None:
            if server_opt_state is None:
                server_opt_state = self.server_optimizer.init(trainable)
            new_params, server_opt_state = server_update(
                self.server_optimizer, trainable, aggregate, server_opt_state)
        else:
            new_params = aggregate
        if self.partition is not None:
            new_params = self.partition.merge(new_params, frozen)
        return RoundResult(
            params=new_params,
            loss_history=lsum_acc / denom,
            client_losses=torch.cat(per_client) if per_client else None,
            n_samples_total=w_acc,
            server_opt_state=server_opt_state,
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
                   generator: torch.Generator, n_rounds: int = 1,
                   n_epochs: int = 1, checkpointer=None, checkpoint_every: int = 1,
                   return_server_opt_state: bool = False, **kw):
        """Loop over rounds; returns ``(params, loss_history list)``, plus
        the server optimizer's final state when ``return_server_opt_state``
        is set, so that a chained call continues it (pass it back as
        ``server_opt_state=``).

        Round ``i`` draws from its own generator, :func:`round_generator`
        of ``generator`` and ``i`` (the reference's ``fold_in(rng, i)``), so
        a resumed run replays the randomness the uninterrupted one drew.
        With a :class:`baton_tpu_torch.utils.checkpoint.Checkpointer` the
        loop restores the latest step on entry and saves the params, the
        server optimizer's state and the history every
        ``checkpoint_every`` rounds.
        """
        data, n_samples = self._to_device(data, n_samples)
        server_opt_state = kw.pop("server_opt_state", None)
        history = []
        start = 0
        if checkpointer is not None:
            restored = checkpointer.restore(
                params, server_opt_template=self.init_server_opt_state(params))
            if restored is not None:
                params = restored.params
                server_opt_state = restored.server_opt_state
                history = list(restored.meta.get("loss_history", []))
                start = restored.step
        for i in range(start, n_rounds):
            res = self.run_round(params, data, n_samples, round_generator(generator, i),
                                 n_epochs=n_epochs, server_opt_state=server_opt_state, **kw)
            params, server_opt_state = res.params, res.server_opt_state
            history.extend(res.loss_history.tolist())
            if checkpointer is not None and (i + 1) % checkpoint_every == 0:
                checkpointer.save(i + 1, params, server_opt_state=server_opt_state,
                                  meta={"loss_history": history})
        if return_server_opt_state:
            return params, history, server_opt_state
        return params, history

    def run_rounds_fused(self, *args, **kw):
        raise NotImplementedError("run_rounds_fused is not ported yet")

    @torch.no_grad()
    def _client_eval_sums(self, params: Params, data: Dict, n_samples,
                          wave_size: Optional[int]) -> Dict[str, torch.Tensor]:
        """Every client's evaluation sums (``client_eval_sums``), each
        [C], ``wave_size`` clients at a time."""
        data, n_samples = self._to_device(data, n_samples)
        c = int(n_samples.shape[0])
        wave = c if wave_size is None else wave_size
        sums_fn = torch.func.vmap(
            lambda d, n: client_eval_sums(self.model, params, d, n))
        parts = []
        for start in range(0, c, wave):
            stop = min(start + wave, c)
            d, n, _ = self._pad_wave({k: v[start:stop] for k, v in data.items()},
                                     n_samples[start:stop], None, wave)
            parts.append({k: v[: stop - start] for k, v in sums_fn(d, n).items()})
        return {k: torch.cat([part[k] for part in parts]) for k in parts[0]}

    def evaluate_round(self, params: Params, data: Dict, n_samples,
                       wave_size: Optional[int] = None) -> Dict[str, float]:
        """Example-weighted federation-wide ``{"loss", "n", "accuracy"}``
        of ``params`` over every client's local data, ``wave_size``
        clients at a time."""
        return federation_eval(self._client_eval_sums(params, data, n_samples, wave_size))

    def evaluate_clients(self, params: Params, data: Dict, n_samples,
                         wave_size: Optional[int] = None) -> Dict[str, Any]:
        """Per-client evaluation and a fairness summary. ``per_client``
        holds numpy arrays of loss, accuracy (for integer labels) and n,
        NaN for a client without samples; ``fairness`` the mean and std
        of the metric over the clients with samples, and its tail:
        ``worst`` and ``worst_decile`` are min and p10 for accuracy but
        max and p90 for loss, so they always describe the struggling
        clients."""
        sums = {k: v.cpu().numpy() for k, v in
                self._client_eval_sums(params, data, n_samples, wave_size).items()}
        n_arr = sums["n"]
        valid = n_arr > 0
        denom = np.where(valid, n_arr, 1.0)
        per_client: Dict[str, Any] = {
            "loss": np.where(valid, sums["loss_sum"] / denom, np.nan), "n": n_arr}
        metric = "loss"
        if "correct_sum" in sums:
            per_client["accuracy"] = np.where(valid, sums["correct_sum"] / denom, np.nan)
            metric = "accuracy"
        vals = per_client[metric][valid]
        higher_is_better = metric == "accuracy"
        if vals.size:
            worst = float(np.min(vals) if higher_is_better else np.max(vals))
            worst_decile = float(np.percentile(vals, 10 if higher_is_better else 90))
        else:
            worst = worst_decile = float("nan")
        fairness = {
            "metric": metric,
            "mean": float(np.mean(vals)) if vals.size else float("nan"),
            "std": float(np.std(vals)) if vals.size else float("nan"),
            "worst": worst,
            "worst_decile": worst_decile,
            "n_clients": int(valid.sum()),
        }
        return {"per_client": per_client, "fairness": fairness}


def server_update(server_optimizer: optim.GradientTransformation, params: Params,
                  aggregate: Params, opt_state):
    """FedOpt: the pseudo-gradient ``global - aggregate`` (formed in fp32,
    cast to the param dtype) goes through the server optimizer. With
    ``optim.sgd(1.0)`` this is exactly the FedAvg assignment."""
    fp32 = {k: v.float() for k, v in params.items()}
    pseudo_grad = agg.tree_cast_like(
        agg.tree_sub(fp32, {k: v.float() for k, v in aggregate.items()}), params)
    updates, opt_state = server_optimizer.update(pseudo_grad, opt_state, params)
    return optim.apply_updates(params, updates), opt_state
