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

DP-SGD (``dp=``, ``ops/privacy.py``) runs inside local training; each
client's noise comes from the round's generator (``core/training.py``:
on the card from a device generator seeded from it, one a wave).

``wave_size="auto"`` sizes waves from the card's caching allocator
(:meth:`FedSim.auto_wave_size`): trial waves of 1 and 2 clients give a
line of peak memory against the wave, and the reference's halving search
runs over that line. ``run_rounds_fused`` captures one round's device
work as CUDA graphs and replays them (:meth:`FedSim.run_rounds_fused`).

``mesh=`` a clients mesh (``parallel/mesh.py``; the CPU's
``make_mesh(n, devices=[torch.device("cpu")] * n)``, one card's
``[torch.device("cuda", 0)] * n``, or one spanning processes from
``multihost.make_hybrid_mesh``) shards every wave over its ``clients``
axis, as the JAX engine's ``shard_map`` does; without one a round runs
the same code on a clients mesh of one shard on ``device``. Waves are
padded to a multiple of the shards with phantom clients, shard ``j`` trains its
slice through ``LocalTrainer.train_clients`` on its own device from the
globals copied there, every shard's wave is issued before any is read,
and the per-shard fp32 sums meet in one psum a round
(``ops/aggregation.py:psum``). Each client keeps the shuffle and the DP
noise rows it gets in a meshless round of the same wave. Evaluation, the
robust aggregators, ``run_rounds_fused`` (as CUDA graphs where every shard
this process holds is on its one card: one graph, or two around the
all-reduce where the mesh spans processes) and the wave sizer (trial waves
of one and two clients a shard) run on the mesh too.

A hybrid ``("clients", "model")`` mesh (:attr:`FedSim.is_hybrid`, the
``transformer-tp`` rule table) runs the same rounds with the frozen base
tensor-parallel over ``model``, as the JAX engine's ``_place_hybrid`` lays
it out: waves are multiples of the ``clients`` extent, clients shard ``j``
trains its clients on the model shards of its own line of the mesh
(``mesh.line("model", clients=j)``), the trainable globals and the
aggregate stay replicated, and with a ``trainable`` partition the frozen
leaves are placed once a round by each leaf's path
(``tensor_parallel.leaf_tp_sharding``; a leaf already placed so is kept)
and come back placed in the result, so a base is never gathered per
round. Without ``trainable`` nothing is split over ``model``. The model
functions compute the Megatron products and reductions
(``models/transformer.py``). A ``model`` axis must not cross processes
(ValueError); the ``clients`` axis may, with its one all-reduce a round.
Robust aggregators are refused on a hybrid mesh, as in JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from baton_tpu_torch import resolve_device
from baton_tpu_torch.core import optim
from baton_tpu_torch.core.model import FedModel, Params
from baton_tpu_torch.core.partition import PathPredicate, make_partition
from baton_tpu_torch.core.training import (
    LocalTrainer,
    draws_on,
    make_local_trainer,
    noise_generator,
    noise_seed,
    random_perms,
)
from baton_tpu_torch.obs.compute import ComputeProbe
from baton_tpu_torch.ops import aggregation as agg
from baton_tpu_torch.ops.padding import round_up
from baton_tpu_torch.parallel.mesh import (
    CLIENT_AXIS,
    MODEL_AXIS,
    Mesh,
    client_sharding,
    device_put,
    make_mesh,
    replicate,
    shard_client_arrays,
)
from baton_tpu_torch.parallel.partition import _flatten
from baton_tpu_torch.parallel.tensor_parallel import (
    gather_params,
    is_sharded,
    leaf_tp_sharding,
    place_params,
)
from baton_tpu_torch.utils import profiling

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


def _storage(t: torch.Tensor) -> tuple:
    """The device and address of the storage ``t`` is a view of."""
    return t.device, t.untyped_storage().data_ptr()


def graph_buffers(trees, givens, device, donate: bool, frozen=()) -> tuple:
    """The static buffers a captured round updates in place, a tree of
    them for each tree of ``trees`` (None stays None), and the record of
    how each was had: ``(buffers, record)``.

    ``givens[i]`` holds the caller's leaves ``trees[i]`` came from (None:
    none did). A leaf that is not its caller's, such as a leaf gathered
    from its placement or a state the port initialised, is the port's own
    temporary: it is its own buffer whatever ``donate`` says, and is never
    cloned again. With ``donate`` a caller's leaf is donated (it is its own
    buffer, and the round writes its result into it) where it can serve as
    one: it lies on ``device``, is contiguous, does not require grad, and
    its storage is no other leaf's and none of ``frozen`` (tensors the
    round reads, such as the frozen params). Every other leaf is cloned.
    The graph holds each leaf in its own dtype, as a clone does, so every
    dtype serves. ``record`` counts the ``donated``, ``owned`` and
    ``copied`` leaves and their bytes."""
    leaves = [v for tree in trees if tree is not None for _, v in _flatten(tree)]
    counts = collections.Counter(map(_storage, leaves))
    shared = {s for s, n in counts.items() if n > 1} | set(map(_storage, frozen))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    record = dict.fromkeys(("donated", "donated_bytes", "owned", "owned_bytes", "copied",
                            "copied_bytes"), 0)

    def buffer(v, caller=None):
        if v is not caller:
            kind = "owned"
        elif (donate and v.device == device and v.is_contiguous() and not v.requires_grad
              and _storage(v) not in shared):
            kind = "donated"
        else:
            kind, v = "copied", v.detach().to(device, copy=True)
        record[kind] += 1
        record[f"{kind}_bytes"] += v.numel() * v.element_size()
        return v

    buffers = [None if tree is None
               else optim.tree_map(buffer, tree) if given is None
               else optim.tree_map(buffer, tree, given)
               for tree, given in zip(trees, givens)]
    return buffers, record


class FedSim:
    """Simulated-clients federated training on one device or a clients mesh.

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
        self.aggregator = agg.parse_aggregator(aggregator)
        self.mesh = mesh
        if mesh is not None:
            if CLIENT_AXIS not in mesh.axis_names or any(
                    n != 1 for a, n in mesh.shape.items() if a not in (CLIENT_AXIS, MODEL_AXIS)):
                raise ValueError(f"FedSim shards over a {CLIENT_AXIS!r} axis (and a "
                                 f"{MODEL_AXIS!r} axis on a hybrid mesh); got a mesh of shape "
                                 f"{mesh.shape}")
            if MODEL_AXIS in mesh.axis_names:
                owners = np.moveaxis(mesh.process_ids, mesh.axis_names.index(MODEL_AXIS), -1)
                if (owners != owners[..., :1]).any():
                    raise ValueError(f"the {MODEL_AXIS!r} axis of the mesh crosses processes; "
                                     "keep it inside one (multihost.make_hybrid_mesh does)")
            # the mesh names the devices: the first clients shard this process
            # holds keeps the globals, the folds and the round's results
            self.device = mesh.line(CLIENT_AXIS).local_shards(CLIENT_AXIS)[0][1]
        else:
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
        # wave_size="auto" answers per cohort signature, and the line
        # behind the last measured answer (auto_wave_size)
        self._auto_wave_cache: Dict[tuple, Optional[int]] = {}
        self.wave_footprint: Optional[dict] = None
        # the last run_rounds_fused call: graph or loop, capture seconds
        self.last_fused: Optional[dict] = None

    @property
    def is_hybrid(self) -> bool:
        """True on a ``("clients", "model")`` mesh: the frozen base rides
        tensor-parallel over ``model`` while the clients spread over
        ``clients`` (BASELINE config 4: an 8B base is not replicated a
        shard)."""
        return self.mesh is not None and MODEL_AXIS in self.mesh.axis_names

    @property
    def partition_rule_set(self) -> str:
        """The name of the ``partition.DEFAULT_RULE_SETS`` table that
        places this sim's params."""
        if self.is_hybrid:
            return "transformer-tp"
        if self.mesh is not None:
            return "client-stacked"
        return "replicated"

    @property
    def _clients_mesh(self) -> Mesh:
        """The 1-D clients mesh every wave runs on: ``mesh``'s ``clients``
        axis (on a hybrid mesh, at model index 0), or without a mesh one
        shard on ``device``."""
        if self.mesh is None:
            return make_mesh(1, devices=[self.device])
        return self.mesh.line(CLIENT_AXIS)

    def _placed_frozen(self, frozen) -> list:
        """The frozen params for each clients shard this process holds. On a
        hybrid mesh each leaf is placed tensor-parallel over that shard's
        model line by its own path (JAX's ``_place_hybrid``; a leaf placed
        so already is kept, so a round's result goes into the next round
        as it is); elsewhere they are copied to each shard's device, a
        placed leaf kept as it is."""
        mesh = self._clients_mesh
        shards = mesh.local_shards(CLIENT_AXIS)
        if frozen is None:
            return [None] * len(shards)
        if not self.is_hybrid:
            return [{k: v if is_sharded(v) else v.to(d, non_blocking=True)
                     for k, v in frozen.items()} for _, d in shards]
        shardings = {k: leaf_tp_sharding(k, v, self.mesh) for k, v in frozen.items()}
        return [place_params(frozen, shardings, self.mesh.line(MODEL_AXIS, **{CLIENT_AXIS: j}))
                for j, _ in shards]

    def _globals_per_shard(self, params) -> list:
        """``params`` for each clients shard this process holds: the
        trainable part replicated (a placed leaf gathered first, as JAX's
        replicated placement gathers it), the frozen part
        :meth:`_placed_frozen`."""
        trainable, frozen = self._split(params)
        copies = replicate(gather_params(trainable), self._clients_mesh)
        if frozen is None:
            return copies
        return [self.partition.merge(t, f) for t, f in zip(copies, self._placed_frozen(frozen))]

    def _clients_per_wave_unit(self) -> int:
        """Waves are a multiple of the client axis's extent."""
        return int(self._clients_mesh.shape[CLIENT_AXIS])

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

    def auto_wave_size(self, params: Params, data, n_samples, n_epochs: int = 1,
                       budget_gb: Optional[float] = None,
                       footprint: Optional[Callable[[int], float]] = None) -> Optional[int]:
        """The largest wave whose peak device memory fits ``budget_gb``
        (GiB; default ``profiling.device_budget_gb``, the card less a
        stated headroom): ``None`` when the whole cohort fits as one wave,
        else the wave halved until it fits. Raises ``RuntimeError`` when
        not even one client fits, and ``NotImplementedError`` for robust
        aggregators (they keep every client's params, a different
        footprint: pass an explicit ``wave_size``).

        The reference reads XLA's static memory plan; torch has none, so
        ``footprint(w)`` (GiB at a wave of ``w``) is by default a line fit
        on the card: one trial wave of 1 client and one of 2 clients (one
        epoch of this round's training step each, results thrown away,
        ``profiling.fedsim_wave_footprint_gb``) give each one's peak above
        the memory in use, and ``in use + base + w * per_client`` is the
        line (left in ``wave_footprint``); ``n_epochs`` only keys the
        cache of ``wave_size="auto"``, as an epoch's peak is every
        epoch's. On the CPU there is no allocator peak and the answer is
        ``None``, as the reference answers without a plan. ``footprint``
        is the search's seam.

        On a clients mesh of ``n`` shards the waves are multiples of ``n``
        (the answer too), the trial waves hold one and two clients a shard
        and run through the sharded round, and the peak is the first
        shard's device's: where shards repeat one card it holds every
        shard's share, as the round does."""
        if self.aggregator[0] != "mean":
            raise NotImplementedError(
                "the wave sizer measures the weighted-sums wave; "
                f"aggregator={self.aggregator[0]!r} keeps every client's params, a "
                "different footprint — pass an explicit wave_size")
        unit = self._clients_per_wave_unit()
        full = round_up(int(len(n_samples)), unit)
        if footprint is None:
            footprint = self._fit_wave_footprint(params, data, n_samples)
            if footprint is None:
                return None
        if budget_gb is None:
            budget_gb = profiling.device_budget_gb(self.device)
        w = full
        while footprint(w) > budget_gb:
            if w <= unit:
                raise RuntimeError(
                    f"no wave size down to {unit} fits the {budget_gb:.3g} GiB budget (it "
                    f"needs {footprint(unit):.3g} GiB) — shrink the per-client batch or "
                    "dataset instead of risking an out-of-memory round")
            w = round_up(max(unit, w // 2), unit)
        return None if w >= full else w

    def _fit_wave_footprint(self, params, data, n_samples):
        """``footprint(w)`` for ``auto_wave_size`` from trial waves of 1
        and 2 clients a shard on the card; None off the card."""
        if self.device.type != "cuda":
            return None
        in_use = torch.cuda.memory_allocated(self.device) / profiling.GIB

        def trial(wave_size):
            """The trial wave's peak, infinite where it ran out of memory."""
            try:
                return profiling.fedsim_wave_footprint_gb(self, params, data, n_samples,
                                                          wave_size)
            except RuntimeError as e:
                if not profiling.is_oom_error(e):
                    raise
                torch.cuda.empty_cache()
                return float("inf")

        unit = self._clients_per_wave_unit()
        one, two = trial(unit), trial(2 * unit)
        if one == float("inf"):
            raise RuntimeError(f"no wave size down to {unit} fits: the trial wave of one client "
                               "a shard ran out of device memory")
        per_client = two - one  # one more client on every shard
        base = one if two == float("inf") else one - per_client
        self.wave_footprint = {"in_use_gb": in_use, "base_gb": base,
                               "per_client_gb": per_client, "trial_gb": [one, two]}
        return lambda w: in_use + (one if w <= unit else base + (w / unit) * per_client)

    def _auto_wave(self, params, data, n_samples, n_epochs) -> Optional[int]:
        """``auto_wave_size``'s answer, once per cohort signature (its
        size, the epochs, the data's shapes and dtypes)."""
        key = (int(len(n_samples)), int(n_epochs),
               tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in data.items())))
        if key not in self._auto_wave_cache:
            self._auto_wave_cache[key] = self.auto_wave_size(params, data, n_samples,
                                                             n_epochs=n_epochs)
        return self._auto_wave_cache[key]

    # live: utils/profiling.py calls it through an untyped ``sim``, which the
    # call graph cannot resolve
    def _trial_wave(self, params, data, n_samples, wave_size: int):  # batonlint: allow[BTL007]
        """One epoch of one wave of the first ``wave_size`` clients
        (phantoms past the cohort), trained and folded as ``run_round``
        does, on throwaway shuffles and noise: what
        ``profiling.fedsim_wave_footprint_gb`` measures (an epoch's peak is
        every epoch's: nothing of one is kept into the next)."""
        trainable, frozen = self._split(params)
        trainable = gather_params(trainable)
        anchor = trainable if self.trainer.regularizer is not None else None
        data, n_samples = self._to_device(data, n_samples)
        stop = min(wave_size, int(n_samples.shape[0]))
        d, n, _ = self._pad_wave({k: v[:stop] for k, v in data.items()}, n_samples[:stop],
                                 None, wave_size)
        gen = torch.Generator().manual_seed(0)
        perms = random_perms(wave_size, 1, next(iter(d.values())).shape[1], gen)
        return self._fold_waves(trainable, self._placed_frozen(frozen), anchor, d, n,
                                perms.to(self.device), wave_size, 1, [gen])

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
        robust = self.aggregator[0] != "mean"
        if robust and self.is_hybrid:
            raise NotImplementedError(
                "robust aggregators need per-client params stacked along the client axis; the "
                "hybrid clients x model mesh shards params over 'model' — run robust rounds on "
                "a pure clients mesh")
        trainable, frozen = self._split(params)
        trainable = gather_params(trainable)
        frozen_shards = self._placed_frozen(frozen)
        anchor = trainable if self.trainer.regularizer is not None else None
        data, n_samples = self._to_device(data, n_samples)
        if client_indices is not None:
            idx = torch.as_tensor(client_indices, device=self.device)
            data = {k: v[idx] for k, v in data.items()}
            n_samples = n_samples[idx]
        if wave_size == "auto":
            wave_size = self._auto_wave(params, data, n_samples, n_epochs)
        c = int(n_samples.shape[0])
        capacity = next(iter(data.values())).shape[1]
        if perms is None:
            perms = random_perms(c, n_epochs, capacity, generator)
        perms = perms.to(self.device)
        wave_size = round_up(c if wave_size is None else wave_size,
                             self._clients_per_wave_unit())

        per_client = [] if collect_client_losses else None
        t0 = time.perf_counter()
        folded, lsum, wsum = self._fold_waves(
            trainable, frozen_shards, anchor, data, n_samples, perms, wave_size, n_epochs,
            [generator] * -(-c // wave_size), robust, per_client, progress_fn)
        # the round's one device sync closes the timed window over the waves
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._record_compute(time.perf_counter() - t0, data, n_samples, capacity, wave_size,
                             n_epochs, robust)

        new_params, server_opt_state = self._aggregate(trainable, folded, n_samples, wsum,
                                                       server_opt_state, robust)
        if self.partition is not None:
            # on a hybrid mesh the frozen leaves come back placed
            new_params = self.partition.merge(
                new_params, frozen_shards[0] if self.is_hybrid else frozen)
        return RoundResult(
            params=new_params,
            loss_history=lsum / wsum.clamp_min(1e-9),
            client_losses=torch.cat(per_client) if per_client else None,
            n_samples_total=wsum,
            server_opt_state=server_opt_state,
        )

    def _fold_waves(self, trainable, frozen_shards, anchor, data, n_samples, perms,
                    wave_size: int, n_epochs: int, generators, robust: bool = False,
                    per_client=None, progress_fn=None, flat: Optional[torch.Tensor] = None):
        """Train the cohort ``wave_size`` clients at a time and fold each
        wave on the clients mesh (``kernel_specs("engine.wave_sums" |
        "engine.wave_params")``; meshless, the one shard of ``device``),
        each clients shard on its own ``frozen_shards`` entry
        (:meth:`_placed_frozen`):
        returns ``(folded, lsum [n_epochs], wsum)``, ``folded`` the fp32
        sample-weighted param sums, or under a robust aggregator the list
        of each wave's per-client params. The globals are copied to every
        shard's device once, each wave is split over the shards, every
        shard's training is issued before any result is read, and each
        shard folds its clients into its own fp32 sums; one psum at the end
        of the round adds the shards. Per-client losses (appended to
        ``per_client`` when given) and robust params are gathered in client
        order. ``generators[i]`` is wave ``i``'s generator, or under DP with
        noise a list of the shards' replicas of its noise generator (made
        before a CUDA graph's capture). Host syncs only for
        ``progress_fn``.

        With ``flat`` (``agg.flat_size(self._sums_like(trainable,
        n_epochs))`` fp32 elements on ``device``) the fold stops before the
        add across processes: the psum's local part writes the shards'
        sums into ``flat`` (:func:`agg.psum_local`, the layout of
        :meth:`_sums_like`), which is returned; :meth:`_read_sums` finishes
        it after :func:`agg.psum_across`."""
        mesh = self._clients_mesh
        n_shards = len(mesh.local_shards(CLIENT_AXIS))
        placed = {name: replicate(tree, mesh) if tree is not None else [None] * n_shards
                  for name, tree in (("params", trainable), ("anchor", anchor))}
        placed["frozen"] = [None] * n_shards if frozen_shards is None else frozen_shards
        c = int(n_samples.shape[0])
        n_waves = -(-c // wave_size)
        sums, lsums, wsums = [None] * n_shards, [None] * n_shards, [None] * n_shards
        stacked_parts = []
        for i, start in enumerate(range(0, c, wave_size)):
            stop = min(start + wave_size, c)
            d, n, pm = self._pad_wave(
                {k: v[start:stop] for k, v in data.items()},
                n_samples[start:stop], perms[start:stop], wave_size)
            d_sh = shard_client_arrays(d, mesh)
            n_sh, pm_sh = (device_put(t, client_sharding(mesh)) for t in (n, pm))
            gens, rows, after = self._shard_noise(generators[i], wave_size)
            outs = [self.trainer.train_clients(
                placed["params"][s], d_sh[s], n_sh[s], n_epochs, pm_sh[s], gens[s],
                anchor=placed["anchor"][s], frozen=placed["frozen"][s], noise_rows=rows[s])
                for s in range(n_shards)]
            after()
            for s, (client_params, client_losses) in enumerate(outs):
                w = n_sh[s].float()
                lsum, wsum = w @ client_losses.float(), w.sum()
                lsums[s] = lsum if lsums[s] is None else lsums[s] + lsum
                wsums[s] = wsum if wsums[s] is None else wsums[s] + wsum
                if not robust:
                    psum = agg.weighted_tree_sum(client_params, w)
                    if sums[s] is None:
                        sums[s] = psum
                    else:
                        for k in psum:
                            sums[s][k] += psum[k]
            real = stop - start
            if robust:
                stacked_parts.append({k: agg.gather_clients([o[0][k] for o in outs], mesh)[:real]
                                      for k in trainable})
            if per_client is not None or progress_fn is not None:
                wave_losses = agg.gather_clients([o[1] for o in outs], mesh)[:real]
                if per_client is not None:
                    per_client.append(wave_losses)
                if progress_fn is not None:
                    wave_losses.sum().item()  # wait for the wave's device work
                    progress_fn(i + 1, n_waves)
        parts = [{"p": {k: sums[s][k] for k in trainable} if sums[s] else {},
                  "l": lsums[s], "w": wsums[s]} for s in range(n_shards)]
        if flat is not None:
            return agg.psum_local(parts, mesh, out=flat)
        total = agg.psum(parts, mesh)[0]
        return (stacked_parts if robust else total["p"]), total["l"], total["w"]

    @staticmethod
    def _sums_like(trainable, n_epochs: int) -> dict:
        """The shapes of a round's sums, in the order of the psum's flat
        buffer: the fp32 param sums, the loss sums ``[n_epochs]``, the
        weight sum."""
        meta = torch.device("meta")
        return {"p": {k: torch.empty(v.shape, device=meta) for k, v in trainable.items()},
                "l": torch.empty(n_epochs, device=meta), "w": torch.empty((), device=meta)}

    def _read_sums(self, flat, like) -> tuple:
        """``(psum, lsum, wsum)`` of a round from its flat buffer of sums
        (:meth:`_fold_waves` with ``flat``, added across processes):
        views of it, in the layout ``like`` of :meth:`_sums_like`."""
        total = agg.psum_views(flat, like, self._clients_mesh)[0]
        return total["p"], total["l"], total["w"]

    def _shard_noise(self, generator, wave_size: int):
        """DP noise on the clients mesh for one wave of ``wave_size``
        clients: ``(generators, noise_rows, after)``, a generator and a
        ``train_stacked`` ``noise_rows`` for each shard this process holds,
        and a call to make once the shards have trained. Without noise
        every shard shares ``generator`` (nothing is drawn). With noise each
        shard draws the whole wave's noise from its own replica of the
        wave's noise generator (``noise_generator``; ``generator`` a list
        is the replicas, made before a CUDA graph's capture) and keeps its
        clients' rows; where that generator is ``generator`` itself,
        ``after`` advances it past the wave's draws, as a meshless wave
        leaves it."""
        shards = self._clients_mesh.local_shards(CLIENT_AXIS)
        dp = self.trainer.dp
        if dp is None or dp.noise_multiplier == 0:
            return [generator] * len(shards), [None] * len(shards), lambda: None
        per = wave_size // self._clients_per_wave_unit()
        rows = [(j * per, (j + 1) * per, wave_size) for j, _ in shards]
        if isinstance(generator, (list, tuple)):
            return list(generator), rows, lambda: None
        g = noise_generator(generator, self.device)
        replicas = [torch.Generator(device=g.device) for _ in shards]
        for r in replicas:
            r.set_state(g.get_state())
        return replicas, rows, (lambda: g.set_state(replicas[0].get_state())
                                if g is generator else None)

    def _aggregate(self, trainable, folded, n_samples, wsum, server_opt_state, robust: bool):
        """The new trainable params from a round's fold (the weighted mean,
        or the robust rule over the stacked parts), through the server
        optimizer when there is one; returns ``(params, server_opt_state)``."""
        if robust:
            stacked = {k: torch.cat([part[k] for part in folded]) for k in trainable}
            aggregate = agg.aggregate_stacked(self.aggregator, stacked, n_samples, trainable)
        else:
            denom = wsum.clamp_min(1e-9)
            aggregate = {k: (s / denom).to(trainable[k].dtype) for k, s in folded.items()}
        if self.server_optimizer is None:
            return aggregate, server_opt_state
        if server_opt_state is None:
            server_opt_state = self.server_optimizer.init(trainable)
        return server_update(self.server_optimizer, trainable, aggregate, server_opt_state)

    @property
    def _n_chips(self) -> int:
        """The chips a round runs on: the distinct (process, device) pairs
        of the mesh, so shards that repeat one card count it once."""
        if self.mesh is None:
            return 1
        return len({(int(p), str(d)) for p, d in
                    zip(self.mesh.process_ids.flat, self.mesh.devices.flat)})

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
                steps=c * n_epochs * -(-capacity // self.trainer.batch_size),
                n_chips=self._n_chips)
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

    def run_rounds_fused(self, params: Params, data, n_samples, generator: torch.Generator,
                         n_rounds: int, n_epochs: int = 1, wave_size=None,
                         server_opt_state=None, return_server_opt_state: bool = False,
                         donate_buffers: bool = True):
        """``run_rounds`` with one round's device work captured once as CUDA
        graphs and replayed; returns what ``run_rounds`` returns (no
        checkpointer). Robust aggregators are refused (the fused round
        streams weighted sums; use ``run_round``/``run_rounds``).

        Round ``i`` draws from ``round_generator(generator, i)`` as
        ``run_rounds`` does, so both get the same shuffles (and DP noise
        seeds); every draw happens on the host before capture. A round is
        three steps with no host sync in the first and the last: piece A
        (every wave's steps and the local fold of the shards' sums into one
        flat fp32 buffer, ``agg.psum_local``), the add across processes
        (``agg.psum_across``: the round's one ``all_reduce`` where the mesh
        spans processes, else nothing) and piece B (the sums read back, the
        divide, the server optimizer's step). ``run_round`` adds through the
        same ``psum_local`` in the same order. Round 0 runs the three
        eagerly on a side stream, which is also the warm-up in which cuBLAS
        and cuDNN pick their plans. Then, where the mesh does not span
        processes, A and B are captured as one ``torch.cuda.CUDAGraph`` and
        replayed for rounds 1..n-1; where it does, A and B are captured as
        two graphs and each later round replays A, runs the all-reduce
        eagerly on the buffer (it cannot be captured: gloo copies through
        the host) and replays B. Each round's shuffles are copied into the
        graph's static buffer before its replay. Under DP with noise each
        wave draws from its own device generators (one a shard), registered
        with the graph of A and seeded before every replay. The losses stay
        on the device until one sync at the end (across processes the host
        also waits for A before each all-reduce). A capture that fails
        raises: nothing falls back to the eager loop. On the CPU the same
        three steps run in a plain loop.

        A CUDA graph belongs to one card: every shard this process holds
        must lie on ``device``, with or without other processes (one
        process a card, as ``multihost.initialize_multihost`` gives); a
        process whose shards lie on several cards is refused.

        ``last_fused`` records what ran: on the CPU ``{"graph": False,
        "rounds": n}``; on the card ``"graph": True``, the capture's seconds,
        the replays and their span on the device (``replay_s``, from CUDA
        events), and
        where the mesh spans processes ``"pieces": 2``, the replays of A and
        of B on the device (``replay_a_s``, ``replay_b_s``, summed over the
        replays) and each round's ``all_reduce_s`` (host seconds from A's
        end to the reduced buffer on the card).

        ``donate_buffers`` (default True) donates the caller's trainable
        params and ``server_opt_state`` on the card, as the reference
        donates them to XLA: each leaf that can serve as the graph's static
        buffer (:func:`graph_buffers`: on ``device``, contiguous, not
        requiring grad, its storage no other leaf's and no frozen one's)
        *is* that buffer, so the globals are
        never held twice. The run updates those tensors in place and
        returns them: after the call the caller's ``params`` (and
        ``server_opt_state``) hold the result, not the old globals. Pass
        ``donate_buffers=False`` to keep them (e.g. to run again from the
        same params); every other leaf is copied either way. A leaf
        gathered from its placement on a hybrid mesh and a server state the
        port initialises are the port's own and never copied again; the
        frozen params are never donated (``partition.merge`` reads them
        after the run). ``last_fused["donation"]`` counts the donated,
        owned and copied leaves and their bytes. On
        the CPU the flag is ignored, as the reference's CPU ignores
        donation: the plain loop never writes the caller's tensors.
        """
        if self.aggregator[0] != "mean":
            raise NotImplementedError(
                "the fused rounds stream weighted sums and cannot apply the "
                f"{self.aggregator[0]!r} aggregator; use run_round/run_rounds for robust "
                "aggregation")
        if self.device.type == "cuda":
            mesh = self.mesh if self.mesh is not None else self._clients_mesh
            others = sorted({str(d) for d in mesh.local_devices() if d != self.device})
            if others:
                raise NotImplementedError(
                    f"run_rounds_fused captures CUDA graphs on one card, {self.device}, and this "
                    f"process also holds shards on {others}: one CUDA graph belongs to one "
                    "card. Run one process a card (multihost.initialize_multihost gives each "
                    "its own), or run_rounds")
        data, n_samples = self._to_device(data, n_samples)
        if wave_size == "auto":
            wave_size = self._auto_wave(params, data, n_samples, n_epochs)
        trainable, frozen = self._split(params)
        given = trainable
        trainable = gather_params(trainable)
        # the frozen base placed once for every round (on a hybrid mesh,
        # tensor-parallel; views of the base, made before any capture)
        frozen_shards = self._placed_frozen(frozen)
        c = int(n_samples.shape[0])
        capacity = next(iter(data.values())).shape[1]
        wave = round_up(c if wave_size is None else wave_size, self._clients_per_wave_unit())
        n_waves = -(-c // wave)
        dp = self.trainer.dp
        noisy = dp is not None and dp.noise_multiplier > 0
        # every round's draws, in run_round's order: the shuffles, then a
        # noise seed a wave where the noise generator lives elsewhere
        derive = noisy and not draws_on(generator, self.device)
        round_gens, perms, seeds = [], [], []
        for i in range(n_rounds):
            g = round_generator(generator, i)
            perms.append(random_perms(c, n_epochs, capacity, g))
            round_gens.append(g)
            seeds.append([noise_seed(g) for _ in range(n_waves)] if derive else None)
        given_sos = server_opt_state
        if self.server_optimizer is not None and server_opt_state is None:
            server_opt_state = self.server_optimizer.init(trainable)
        like = self._sums_like(trainable, n_epochs)

        def fold(p, pm, wave_gens, flat):
            """Piece A on ``p``: the round's waves, folded into ``flat``."""
            anchor = p if self.trainer.regularizer is not None else None
            self._fold_waves(p, frozen_shards, anchor, data, n_samples, pm, wave, n_epochs,
                             wave_gens, flat=flat)

        def finish(p, sos, flat):
            """Piece B on ``p``: (new params, new server state, losses) from
            the round's sums in ``flat``, added across processes."""
            psum, lsum, wsum = self._read_sums(flat, like)
            new, sos = self._aggregate(p, psum, n_samples, wsum, sos, robust=False)
            return new, sos, lsum / wsum.clamp_min(1e-9)

        if self.device.type != "cuda":
            history = []
            p, sos = trainable, server_opt_state
            flat = torch.empty(agg.flat_size(like), device=self.device)
            for i in range(n_rounds):
                fold(p, perms[i].to(self.device), [round_gens[i]] * n_waves, flat)
                agg.psum_across(flat, self._clients_mesh)
                p, sos, loss = finish(p, sos, flat)
                history.extend(loss.tolist())
            self.last_fused = {"graph": False, "rounds": n_rounds}
        else:
            frozen_leaves = [t for v in (frozen or {}).values()
                             for t in (v.shards if is_sharded(v) else (v,))]
            (p, sos), donation = graph_buffers([trainable, server_opt_state], [given, given_sos],
                                               self.device, donate_buffers, frozen_leaves)
            p, sos, history = self._rounds_as_graph(fold, finish, agg.flat_size(like), p, sos,
                                                    perms, seeds if derive else None, n_waves)
            self.last_fused["donation"] = donation
        if self.partition is not None:
            p = self.partition.merge(p, frozen_shards[0] if self.is_hybrid else frozen)
        if return_server_opt_state:
            return p, history, sos
        return p, history

    def _rounds_as_graph(self, fold, finish, flat_size, p, sos, perms, seeds, n_waves):
        """``run_rounds_fused`` on the card: round 0 eagerly on a side
        stream, then pieces A (``fold``) and B (``finish``) captured once,
        as one graph or, where the mesh spans processes, as two around the
        eager all-reduce, and replayed for the other rounds, each round
        writing its params and server state into ``p`` and ``sos`` (the
        static buffers, :func:`graph_buffers`). ``seeds[i]``
        seeds each wave's noise generators for round ``i`` (None: no
        noise). Returns the final params, server state and the loss
        history, read back in the run's one sync."""
        dev = self.device
        mesh = self._clients_mesh
        perm_buf = torch.empty_like(perms[0], device=dev)
        # the round's sums, allocated before any capture: A writes them, the
        # all-reduce adds them across processes in place, B reads them
        flat = torch.empty(flat_size, dtype=torch.float32, device=dev)
        # each wave's noise generator, made before the capture: one replica
        # a shard, every replica seeded alike
        n_shards = len(mesh.local_shards(CLIENT_AXIS))
        replicas = [[torch.Generator(device=dev) for _ in range(n_shards)]
                    for _ in range(n_waves)] if seeds else None
        gens = replicas if seeds else [None] * n_waves
        out = {}
        record = {"graph": True, "rounds": len(perms), "capture_s": None, "replays": 0,
                  "replay_s": None}
        pieces = 2 if mesh.spans_processes else 1
        if pieces == 2:
            record.update(pieces=2, replay_a_s=None, replay_b_s=None, all_reduce_s=[])
        stream = torch.cuda.current_stream

        def piece_a():
            fold(p, perm_buf, gens, flat)

        def across():
            """The eager all-reduce, timed from A's end to the reduced
            buffer on the card."""
            stream(dev).synchronize()
            t0 = time.perf_counter()
            agg.psum_across(flat, mesh)
            stream(dev).synchronize()
            record["all_reduce_s"].append(time.perf_counter() - t0)

        def piece_b():
            new, new_sos, loss = finish(p, sos, flat)
            for k, v in new.items():
                p[k].copy_(v)
            if sos is not None:
                optim.tree_map(lambda dst, src: dst.copy_(src), sos, new_sos)
            out["loss"] = loss

        def start_round(i):
            perm_buf.copy_(perms[i])
            if seeds:
                for wave_replicas, seed in zip(replicas, seeds[i]):
                    for g in wave_replicas:
                        g.manual_seed(seed)

        losses = []
        side = torch.cuda.Stream(dev)
        # round 0 writes the buffers (the caller's tensors where donated)
        # on the side stream: after the caller's pending work on them
        side.wait_stream(stream(dev))
        with torch.cuda.stream(side):
            start_round(0)
            piece_a()
            if pieces == 2:
                across()
            piece_b()
            losses.append(out["loss"].clone())
        stream(dev).wait_stream(side)
        if len(perms) > 1:
            graphs = [torch.cuda.CUDAGraph() for _ in range(pieces)]
            for g in (g for wave_replicas in replicas or [] for g in wave_replicas):
                graphs[0].register_generator_state(g)
            t0 = time.perf_counter()
            if pieces == 1:
                with torch.cuda.graph(graphs[0]):
                    piece_a()
                    piece_b()
            else:
                with torch.cuda.graph(graphs[0]):
                    piece_a()
                with torch.cuda.graph(graphs[1]):
                    piece_b()
            record["capture_s"] = time.perf_counter() - t0
            # the replays' span on the device, and with two pieces each
            # piece's replays, read after the sync below
            event = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
            start, end, spans = event(), event(), {"a": [], "b": []}

            def replay(name, graph):
                """``graph``'s replay, its span on the device kept under ``name``."""
                pair = (event(), event())
                pair[0].record()
                graph.replay()
                pair[1].record()
                spans[name].append(pair)

            start.record()
            for i in range(1, len(perms)):
                start_round(i)
                if pieces == 1:
                    graphs[0].replay()
                else:
                    replay("a", graphs[0])
                    across()
                    replay("b", graphs[1])
                losses.append(out["loss"].clone())
            end.record()
            record["replays"] = len(perms) - 1
        history = torch.stack(losses).reshape(-1).tolist()  # the run's one sync
        if record["replays"]:
            record["replay_s"] = start.elapsed_time(end) / 1e3
            if pieces == 2:
                for name, pairs in spans.items():
                    record[f"replay_{name}_s"] = sum(e0.elapsed_time(e1) for e0, e1 in pairs) / 1e3
        self.last_fused = record
        return p, sos, history

    @torch.no_grad()
    def _client_eval_sums(self, params: Params, data: Dict, n_samples,
                          wave_size: Optional[int]) -> Dict[str, torch.Tensor]:
        """Every client's evaluation sums (``client_eval_sums``), each
        [C], ``wave_size`` clients at a time, each wave split over the
        clients mesh's shards and the sums gathered in client order (on a
        hybrid mesh each clients shard with the frozen base placed over its
        model line, :meth:`_globals_per_shard`)."""
        data, n_samples = self._to_device(data, n_samples)
        c = int(n_samples.shape[0])
        wave = round_up(c if wave_size is None else wave_size, self._clients_per_wave_unit())

        def sums_fn(p):
            return torch.func.vmap(lambda d, n: client_eval_sums(self.model, p, d, n))

        mesh = self._clients_mesh
        placed = self._globals_per_shard(params)
        parts = []
        for start in range(0, c, wave):
            stop = min(start + wave, c)
            d, n, _ = self._pad_wave({k: v[start:stop] for k, v in data.items()},
                                     n_samples[start:stop], None, wave)
            shard_sums = [sums_fn(p)(d_s, n_s) for p, d_s, n_s in zip(
                placed, shard_client_arrays(d, mesh), device_put(n, client_sharding(mesh)))]
            sums = {k: agg.gather_clients([o[k] for o in shard_sums], mesh)
                    for k in shard_sums[0]}
            parts.append({k: v[: stop - start] for k, v in sums.items()})
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
