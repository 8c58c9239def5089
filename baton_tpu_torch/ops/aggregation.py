"""Aggregation over a stacked client axis (counterpart of
``baton_tpu/ops/aggregation.py``).

* Sample-weighted FedAvg, ``Σ_c w_c · leaf[c] / Σ_c w_c``, accumulated in
  fp32 whatever the parameter dtype.
* The robust rules: coordinate-wise trimmed mean and median, unweighted,
  selected by a spec string (:func:`parse_aggregator`) and combined by
  :func:`aggregate_stacked`.
* :class:`StreamingMean` and :class:`ShardedStreamingMean`: numpy folds of
  ``{name: array}`` updates as they arrive, copied from the JAX package.

Params are flat ``{name: tensor}`` dicts; a stacked dict has a leading
client axis on every leaf.

On a clients mesh (``parallel/mesh.py``) a value is a list of per-shard
parts, one for each shard this process holds. :func:`psum` is the one
reduction over the client axis, in two parts: :func:`psum_local` adds the
parts' fp32 values in shard order on the first shard's device into one
flat fp32 buffer, and :func:`psum_across` adds that buffer across processes
in place by one ``torch.distributed.all_reduce`` where the mesh spans them
(:func:`_all_reduce`, the only transport); :func:`psum_views` gives the
buffer back as the parts' leaves on every shard's device.
:func:`psum_weighted_mean` and :func:`psum_weighted_scalar_mean` are
FedAvg's forms of it, :func:`gather_clients` the gather of per-client
rows that rides on it.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from baton_tpu_torch.core.model import Params


def tree_stack(trees: Sequence[Params]) -> Params:
    """Stack identically named dicts along a new axis 0."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def tree_unstack(tree: Params) -> list:
    """Inverse of :func:`tree_stack`."""
    n = next(iter(tree.values())).shape[0]
    return [{k: v[i] for k, v in tree.items()} for i in range(n)]


def weighted_tree_sum(stacked: Params, weights: torch.Tensor) -> Params:
    """``Σ_c w_c · leaf[c]`` for every leaf of a ``[C, ...]``-stacked dict.
    fp32 leaves: these are partial sums for further accumulation (waves),
    and callers cast the final mean back to the parameter dtype."""
    w = weights.float()
    return {k: torch.tensordot(w, leaf.float(), dims=([0], [0]))
            for k, leaf in stacked.items()}


def weighted_tree_mean(stacked: Params, weights: torch.Tensor) -> Params:
    """The reference rule ``Σ(value · n_samples) / Σ n_samples`` in fp32,
    with the denominator clamped at 1e-9 so an all-zero cohort gives 0."""
    denom = weights.float().sum().clamp_min(1e-9)
    return {k: (s / denom).to(stacked[k].dtype)
            for k, s in weighted_tree_sum(stacked, weights).items()}


def weighted_scalar_mean(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Sample-weighted mean of per-client values ``[C, ...]`` (the loss
    history), in fp32."""
    w = weights.float()
    return torch.tensordot(w, values.float(), dims=([0], [0])) / w.sum().clamp_min(1e-9)


def _leaves(tree) -> list:
    """The tensors of a tensor or of nested dicts of tensors, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _rebuild(like, it):
    """``like``'s structure with its leaves taken in order from ``it``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, it) for k, v in like.items()}
    return next(it)


def _all_reduce(flat: torch.Tensor, group) -> None:
    """Sum ``flat``, a flat fp32 buffer, in place over the processes of
    ``group``: the client axis's only transport across processes, one
    ``torch.distributed.all_reduce`` (gloo copies a CUDA buffer through
    the host)."""
    import torch.distributed as dist

    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)


def flat_size(like) -> int:
    """The elements of :func:`psum_local`'s buffer for parts shaped as
    ``like`` (a tensor, or nested dict of tensors)."""
    return sum(t.numel() for t in _leaves(like))


def psum_local(parts: Sequence, mesh, axis: str = "clients",
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The local part of :func:`psum`: ``parts`` (one tensor, or nested dict
    of tensors, for each shard of ``axis`` this process holds, in shard
    order) added leaf by leaf in shard order, in fp32, on the first shard's
    device, into one flat fp32 buffer in the order of the leaves: ``out``
    (``flat_size(parts[0])`` elements on that device, owned by the caller,
    so that a CUDA graph's capture allocates nothing for it), else a new
    one. Returns the buffer."""
    devices = [d for _, d in mesh.local_shards(axis)]
    if len(parts) != len(devices):
        raise ValueError(f"{len(parts)} parts for the {len(devices)} shards of {axis!r} "
                         "this process holds")
    home = devices[0]
    if out is None:
        out = torch.empty(flat_size(parts[0]), dtype=torch.float32, device=home)
    elif out.numel() != flat_size(parts[0]) or out.dtype != torch.float32:
        raise ValueError(f"a buffer of {out.numel()} {out.dtype} for parts of "
                         f"{flat_size(parts[0])} fp32 elements")
    at = 0
    for shard_leaves in zip(*[_leaves(p) for p in parts]):
        n = shard_leaves[0].numel()
        acc = out[at:at + n].view(shard_leaves[0].shape)
        acc.copy_(shard_leaves[0], non_blocking=True)
        for t in shard_leaves[1:]:
            acc.add_(t.float().to(home, non_blocking=True))
        at += n
    return out


def psum_across(flat: torch.Tensor, mesh) -> torch.Tensor:
    """The part of :func:`psum` across processes: :func:`psum_local`'s
    buffer summed in place over the mesh's processes where it spans them
    (:func:`_all_reduce`), else left as it is. Returns it."""
    if mesh.spans_processes:
        _all_reduce(flat, mesh.process_group)
    return flat


def psum_views(flat: torch.Tensor, like, mesh, axis: str = "clients") -> list:
    """``flat`` read back as the leaves of ``like`` (a tensor, or nested
    dict of tensors: only their shapes are read), one copy on each shard's
    device of ``axis`` that this process holds: views of ``flat`` on its
    own device."""
    devices = [d for _, d in mesh.local_shards(axis)]
    views, at = [], 0
    for t in _leaves(like):
        views.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return [_rebuild(like, iter([v.to(d, non_blocking=True) for v in views])) for d in devices]


def psum(parts: Sequence, mesh, axis: str = "clients") -> list:
    """The sum over every shard of the mesh's ``axis`` of ``parts`` (one
    tensor, or nested dict of tensors, for each shard this process holds,
    in shard order), in fp32: added in shard order on the first shard's
    device (:func:`psum_local`), then across processes
    (:func:`psum_across`), and returned as one copy on each shard's device
    (:func:`psum_views`)."""
    return psum_views(psum_across(psum_local(parts, mesh, axis), mesh), parts[0], mesh, axis)


def gather_clients(parts: Sequence[torch.Tensor], mesh, axis: str = "clients") -> torch.Tensor:
    """The per-client rows of every shard of ``axis`` (``parts``: this
    process's ``[C_shard, ...]`` tensors, in shard order), concatenated in
    shard order on the first shard's device (one shard's rows are returned
    as they are). Across processes each one fills its own rows of a zero
    tensor and :func:`psum` adds them (exact: every row is one process's
    value plus zeros)."""
    home = mesh.local_shards(axis)[0][1]
    if not mesh.spans_processes:
        if len(parts) == 1:
            return parts[0].to(home, non_blocking=True)
        return torch.cat([p.to(home, non_blocking=True) for p in parts])
    per = parts[0].shape[0]
    full = [torch.zeros((mesh.shape[axis] * per,) + tuple(parts[0].shape[1:]),
                        dtype=torch.float32, device=d) for _, d in mesh.local_shards(axis)]
    for (j, _), f, p in zip(mesh.local_shards(axis), full, parts):
        f[j * per:(j + 1) * per] = p.float()
    return psum(full, mesh, axis)[0].to(parts[0].dtype)


def gather_client_tree(parts: Sequence, mesh, n: int, axis: str = "clients"):
    """:func:`gather_clients` leaf by leaf over per-shard nested dicts (an
    optimizer state's stack), each cut to its first ``n`` clients."""
    if isinstance(parts[0], dict):
        return {k: gather_client_tree([p[k] for p in parts], mesh, n, axis) for k in parts[0]}
    return gather_clients(parts, mesh, axis)[:n]


def psum_weighted_mean(local_stacked: Sequence[Params], local_weights: Sequence[torch.Tensor],
                       mesh, axis: str = "clients") -> list:
    """FedAvg across a sharded client axis: each shard holds ``[C_shard,
    ...]`` client params and their sample weights; the fp32 weighted mean
    is one :func:`psum` of ``(Σ_shard w·p, Σ_shard w)``. Returns the mean
    on each shard's device (fp32; callers cast with :func:`tree_cast_like`)."""
    tot = psum([{"sums": weighted_tree_sum(t, w), "w": w.float().sum()}
                for t, w in zip(local_stacked, local_weights)], mesh, axis)
    return [{k: s / t["w"].clamp_min(1e-9) for k, s in t["sums"].items()} for t in tot]


def psum_weighted_scalar_mean(values: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
                              mesh, axis: str = "clients") -> list:
    """:func:`weighted_scalar_mean` across a sharded client axis (the loss
    history): one :func:`psum` of ``(Σ_shard w·values, Σ_shard w)``."""
    tot = psum([{"l": torch.tensordot(w.float(), v.float(), dims=([0], [0])),
                 "w": w.float().sum()} for v, w in zip(values, weights)], mesh, axis)
    return [t["l"] / t["w"].clamp_min(1e-9) for t in tot]


def tree_sub(a: Params, b: Params) -> Params:
    return {k: a[k] - b[k] for k in a}


def tree_add(a: Params, b: Params) -> Params:
    return {k: a[k] + b[k] for k in a}


def tree_scale(a: Params, s) -> Params:
    return {k: v * s for k, v in a.items()}


def tree_zeros_like(a: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in a.items()}


def global_sq_dist(a: Params, b: Params) -> torch.Tensor:
    """``‖a − b‖²`` over all leaves, in fp32."""
    total = torch.zeros((), dtype=torch.float32, device=next(iter(a.values())).device)
    for k in a:
        total = total + (a[k].float() - b[k].float()).square().sum()
    return total


def trimmed_mean(stacked: Params, trim_ratio: float = 0.1) -> Params:
    """Coordinate-wise trimmed mean over the client axis: drop the
    ``int(C * trim_ratio)`` smallest and largest values of each coordinate
    (none if that would drop them all) and average the rest."""

    def one(leaf):
        c = leaf.shape[0]
        k = int(c * trim_ratio)
        srt = torch.sort(leaf.float(), dim=0).values
        kept = srt[k: c - k] if c - 2 * k > 0 else srt
        return kept.mean(dim=0).to(leaf.dtype)

    return {name: one(leaf) for name, leaf in stacked.items()}


def coordinate_median(stacked: Params) -> Params:
    """Coordinate-wise median over the client axis. For an even count it
    is the mean of the two middle values, as ``jnp.median`` gives
    (``torch.median`` would return the lower one)."""

    def one(leaf):
        c = leaf.shape[0]
        srt = torch.sort(leaf.float(), dim=0).values
        mid = srt[c // 2] if c % 2 else (srt[c // 2 - 1] + srt[c // 2]) * 0.5
        return mid.to(leaf.dtype)

    return {name: one(leaf) for name, leaf in stacked.items()}


def parse_aggregator(spec: str):
    """``"mean" | "trimmed:<ratio>" | "median"`` -> tagged tuple."""
    if spec == "mean":
        return ("mean",)
    if spec == "median":
        return ("median",)
    if spec.startswith("trimmed:"):
        ratio = float(spec.split(":", 1)[1])
        if not (0.0 <= ratio < 0.5):
            raise ValueError(f"trim ratio must be in [0, 0.5), got {ratio}")
        return ("trimmed", ratio)
    raise ValueError(
        f"unknown aggregator {spec!r}; expected 'mean', 'median', or 'trimmed:<ratio>'")


def apply_aggregator(spec, stacked: Params, weights: Optional[torch.Tensor]) -> Params:
    """Dispatch a :func:`parse_aggregator` tuple over stacked client params
    (the robust rules ignore ``weights``)."""
    if spec[0] == "trimmed":
        return trimmed_mean(stacked, spec[1])
    if spec[0] == "median":
        return coordinate_median(stacked)
    return weighted_tree_mean(stacked, weights)


def aggregate_stacked(spec, stacked: Params, n_samples, like: Params) -> Params:
    """Combine ``[C, ...]``-stacked client params into one dict typed like
    ``like``. For the robust rules, zero-sample clients are excluded first:
    their "update" is the unchanged broadcast, and enough of them would
    pull the order statistic to a no-op round (all of them are kept when
    every client is empty). The weighted mean needs no exclusion."""
    n = torch.as_tensor(n_samples)
    if spec[0] != "mean":
        keep = torch.nonzero(n.cpu() > 0).flatten()
        if keep.numel() == 0:
            keep = torch.arange(n.shape[0])
        device = next(iter(stacked.values())).device
        keep = keep.to(device)
        merged = apply_aggregator(spec, {k: v.index_select(0, keep) for k, v in stacked.items()},
                                  None)
    else:
        merged = apply_aggregator(spec, stacked, n.float())
    return tree_cast_like(merged, like)


def tree_cast_like(tree: Params, like: Params) -> Params:
    """Cast every leaf to the dtype of the same-named ``like`` leaf."""
    return {k: v.to(like[k].dtype) for k, v in tree.items()}


class StreamingMean:
    """O(model) streaming FedAvg: fold ``{name: array}`` updates as they
    arrive, keeping only ``(Σ w_c · x_c, Σ w_c)``.

    Accumulation is sequential fp32 numpy, so the result is a
    deterministic function of arrival order and matches the reference
    formula evaluated left to right in fp32. Only the ``"mean"``
    aggregator streams; the order statistics need the whole cohort.
    ``add`` and ``mean`` take an internal lock: numpy releases the GIL
    mid-ufunc, so two threads folding at once could otherwise drop an
    update.
    """

    def __init__(self) -> None:
        self._sums: Optional[dict] = None
        self._weight = np.float32(0.0)
        self.count = 0
        self._lock = threading.Lock()

    def add(self, state_dict: dict, weight: float) -> None:
        """Fold one client's update with sample weight ``weight``. After
        this returns the caller may drop the tensors."""
        w = np.float32(weight)
        with self._lock:
            if self._sums is None:
                self._sums = {k: np.asarray(v, np.float32) * w for k, v in state_dict.items()}
            else:
                for k, v in state_dict.items():
                    self._sums[k] += np.asarray(v, np.float32) * w
            self._weight = self._weight + w
            self.count += 1

    @property
    def total_weight(self) -> float:
        return float(self._weight)

    def mean(self) -> Optional[dict]:
        """``Σ w·x / max(Σ w, 1e-9)`` as fp32 arrays, or None if nothing
        was folded."""
        with self._lock:
            if self._sums is None:
                return None
            denom = np.maximum(self._weight, np.float32(1e-9))
            return {k: v / denom for k, v in self._sums.items()}


class ShardedStreamingMean:
    """N independent :class:`StreamingMean` partials, merged at ``mean()``
    (weighted sums are associative, so the merge equals the sequential
    fold up to fp32 reduction order). Same duck type as StreamingMean,
    with a ``shard=`` routing argument to ``add``."""

    def __init__(self, shards: int = 1) -> None:
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.partials = [StreamingMean() for _ in range(int(shards))]

    @property
    def shards(self) -> int:
        return len(self.partials)

    @property
    def count(self) -> int:
        return sum(p.count for p in self.partials)

    @property
    def total_weight(self) -> float:
        return float(sum(p.total_weight for p in self.partials))

    def add(self, state_dict: dict, weight: float, shard: int = 0) -> None:
        self.partials[int(shard) % len(self.partials)].add(state_dict, weight)

    def mean(self) -> Optional[dict]:
        """Merge partial ``(Σ w·x, Σ w)`` pairs, then divide once."""
        sums: Optional[dict] = None
        weight = np.float32(0.0)
        for p in self.partials:
            with p._lock:
                if p._sums is None:
                    continue
                if sums is None:
                    sums = {k: np.array(v, np.float32, copy=True) for k, v in p._sums.items()}
                else:
                    for k, v in p._sums.items():
                        sums[k] += v
                weight = weight + p._weight
        if sums is None:
            return None
        denom = np.maximum(weight, np.float32(1e-9))
        return {k: v / denom for k, v in sums.items()}
