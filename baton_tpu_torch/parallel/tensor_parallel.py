"""Tensor parallelism over the mesh's ``model`` axis (counterpart of
``baton_tpu/parallel/tensor_parallel.py``).

The JAX package annotates the params with Megatron ``PartitionSpec``s
from the ``transformer-tp`` rule table and lets GSPMD derive the
collectives. Torch has no GSPMD, so the port places the params by the
same table and computes the collectives itself:

* **A placed leaf is a** :class:`ShardedLeaf` (``core/sharded.py``, which
  depends on nothing of the port, re-exported here): the per-shard
  tensors of one param, the dim they split and the mesh axis they split
  over. Shard
  ``j`` lies on the ``j``-th device of the model axis, in shard order. It
  is a ``torch.utils._pytree`` node whose children are the shards, so
  ``torch.func.grad``, ``vmap`` and the tree helpers see the shards as
  leaves (a gradient with respect to a placed leaf is a placed leaf of
  shard gradients). It answers ``shape``, ``ndim``, ``dim()``, ``dtype``
  and ``device`` as the whole tensor would, and :meth:`ShardedLeaf.gather`
  gives the whole tensor for the few places that need it (the weights
  bridge, a check against a host copy). A replicated leaf stays a plain
  tensor.
* **The model functions compute with it** (``models/transformer.py``'s
  ``column_parallel`` / ``row_parallel`` / ``linear`` / ``embed``, which on
  a plain tensor are the dense ``x @ w`` of a meshless call): a
  column-parallel weight gives one output part a shard, each on its
  shard's device, and a row-parallel weight contracts each part with its
  shard and adds the partials with :func:`model_sum`.
* **The reduction**, :func:`model_sum` (``core/sharded.py``), adds the
  partials in shard order on the first shard's device; autograd sends its
  gradient to every shard. A mesh's model axis never crosses a process
  (``multihost.make_hybrid_mesh`` keeps it inside one, and ``FedSim``
  refuses a mesh where it does), so no collective across processes is
  needed on it.

On a ``("clients", "model")`` mesh a placed leaf holds the model shards of
one clients shard (:func:`shard_params_tp` places on the first line of the
model axis this process holds); the replicas of the other clients shards
are made where a computation needs them (:func:`place_on_line`), and on
one card or the CPU they are the same tensors: a placement is views, never
a copy of the base.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from baton_tpu_torch.core.sharded import ShardedLeaf, is_sharded, model_sum, on  # noqa: F401
from baton_tpu_torch.parallel.mesh import Mesh
from baton_tpu_torch.parallel.partition import (  # noqa: F401  (MODEL_AXIS re-exported)
    MODEL_AXIS,
    NamedSharding,
    PartitionSpec,
    RuleSet,
    _divisible,
    _map_with_path,
    dim_spec,
    replicated_spec,
    transformer_rules,
)

Params = Any


def gather_params(params: Params) -> Params:
    """``params`` with every placed leaf gathered whole (flat or nested
    dicts; plain tensors as they are)."""
    if isinstance(params, dict):
        return {k: gather_params(v) for k, v in params.items()}
    return params.gather() if is_sharded(params) else params


# ---------------------------------------------------------------------------
# the rule table's facade (JAX's API)


def transformer_tp_spec(path: str, leaf, axis: str = MODEL_AXIS) -> PartitionSpec:
    """Megatron-style PartitionSpec for one transformer param leaf, from the
    ``transformer-tp`` rule table (``partition.transformer_rules``)."""
    return transformer_rules(axis).spec_for(path, leaf)


def _rules_for(spec_fn, axis: str = MODEL_AXIS) -> Optional[RuleSet]:
    """The RuleSet behind ``spec_fn`` when it is the default table; None
    for a custom callable."""
    if spec_fn is transformer_tp_spec:
        return transformer_rules(axis)
    return None


def _custom_leaf_sharding(path, leaf, mesh, spec_fn) -> NamedSharding:
    spec = spec_fn(path, leaf)
    if spec != replicated_spec() and not _divisible(leaf, spec, mesh):
        spec = replicated_spec()
    return NamedSharding(mesh, spec)


def leaf_tp_sharding(path: str, leaf, mesh: Mesh,
                     spec_fn: Callable[[str, Any], PartitionSpec] = transformer_tp_spec
                     ) -> NamedSharding:
    """The TP sharding of one leaf by its tree path, with the replicated
    fallback for a dim that does not divide the axis."""
    rules = _rules_for(spec_fn)
    if rules is not None:
        return rules.leaf_sharding(path, leaf, mesh)
    return _custom_leaf_sharding(path, leaf, mesh, spec_fn)


def tp_sharding_tree(params: Params, mesh: Mesh,
                     spec_fn: Callable[[str, Any], PartitionSpec] = transformer_tp_spec) -> Params:
    """The sharding of every leaf of ``params``, in its structure: the
    layout a placed param keeps across steps (``place_params`` of an
    update with these shardings places it so)."""
    rules = _rules_for(spec_fn)
    if rules is not None:
        return rules.shardings(params, mesh)
    return _map_with_path(lambda p, leaf: _custom_leaf_sharding(p, leaf, mesh, spec_fn), params)


def describe_tp_sharding(params: Params, mesh: Mesh) -> Dict[str, str]:
    """``{path: spec string}``, after the divisibility fallback."""
    return transformer_rules().describe(params, mesh)


def place_on_line(leaf, sharding: NamedSharding, line: Mesh):
    """``leaf`` (a tensor or a :class:`ShardedLeaf`) placed by ``sharding``
    on ``line``, a 1-D line of ``sharding.mesh`` along the axis the spec
    names: a :class:`ShardedLeaf` over the line's devices, or for a
    replicated spec a tensor on its first device. A leaf already placed so
    is moved only where its devices differ (on one card, never), and one
    placed otherwise is gathered and placed again. Placing narrows: the
    shards of a tensor are views of it where they stay on its device."""
    split = [(dim, names) for dim, names in enumerate(sharding.spec) if names is not None]
    home = line.devices[0]
    if not split:
        return on(leaf.gather() if is_sharded(leaf) else leaf, home)
    if len(split) != 1 or split[0][1] != line.axis_names[0]:
        raise ValueError(f"a param is split over one dim along the {line.axis_names[0]!r} "
                         f"axis; got {sharding.spec}")
    (dim, axis), = split
    devices = list(line.devices)
    n = len(devices)
    if (is_sharded(leaf) and leaf.split_dim == dim and leaf.axis == axis
            and len(leaf.shards) == n):
        if leaf.devices == devices:
            return leaf
        return ShardedLeaf([on(t, d) for t, d in zip(leaf.shards, devices)], dim, axis)
    whole = leaf.gather() if is_sharded(leaf) else leaf
    if whole.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {whole.shape[dim]} does not split over the {n} "
                         f"shards of axis {axis!r}")
    size = whole.shape[dim] // n
    return ShardedLeaf([on(whole.narrow(dim, j * size, size), d) for j, d in enumerate(devices)],
                       dim, axis)


def place_params(params: Params, shardings: Params, mesh: Mesh, axis: str = MODEL_AXIS) -> Params:
    """``params`` placed by ``shardings`` (``tp_sharding_tree``'s structure)
    on the first line of ``axis`` this process holds."""
    line = mesh.local_line(axis)
    if isinstance(params, dict):
        return {k: place_params(v, shardings[k], mesh, axis) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(place_params(v, s, mesh, axis) for v, s in zip(params, shardings))
    return place_on_line(params, shardings, line)


def shard_params_tp(params: Params, mesh: Mesh,
                    spec_fn: Callable[..., PartitionSpec] = transformer_tp_spec,
                    axis: str = MODEL_AXIS) -> Params:
    """``params`` placed on ``mesh`` with tensor-parallel shardings: every
    leaf the table splits becomes a :class:`ShardedLeaf` over the first
    line of ``axis`` this process holds, every other leaf a tensor on that
    line's first device. Leaves whose dims do not divide the axis size stay
    replicated (correct, only not sharded). A custom ``spec_fn`` is called
    as ``spec_fn(path, leaf, axis)``."""
    rules = _rules_for(spec_fn, axis)
    if rules is not None:
        shardings = rules.shardings(params, mesh)
    else:
        shardings = _map_with_path(lambda p, leaf: _custom_leaf_sharding(
            p, leaf, mesh, lambda pp, ll: spec_fn(pp, ll, axis)), params)
    return place_params(params, shardings, mesh, axis)
