"""One declarative sharding layer for every parallel path (counterpart of
``baton_tpu/parallel/partition.py``).

An ordered table of ``(regex, PartitionSpec)`` rules is matched against
each param's slash-joined name (the port's flat param dicts are already
keyed so; nested dicts and lists are joined the same way), first match
wins, and gives a :class:`NamedSharding` for any :class:`Mesh`. A rule may
also require the leaf's rank (``ndim``), so stacked MoE experts
``[E, D, F]`` and a plain 2-D ``w_gate`` get different specs under one
name. Scalar leaves are always replicated. A leaf no rule matches falls
back to replicated and bumps a module-level counter that the tests hold
at zero for the shipped tables. A spec whose sharded dims do not divide
the mesh axis sizes also falls back to replicated (correct, only not
sharded).

:class:`PartitionSpec` is the port's ``jax.sharding.PartitionSpec``: a
tuple with one entry per leading dim, a mesh axis name or None (trailing
dims unnamed are replicated), printed as JAX prints it. Every other
module of ``parallel/`` builds its specs from the helpers here
(``replicated_spec`` / ``client_spec`` / ``waved_client_spec`` /
``dim_spec``); ``tests/test_torch_partition.py`` holds that no
``PartitionSpec`` is constructed anywhere else in the port.

Placing a value on a sharding (``RuleSet.place``, ``mesh.device_put``)
gives the port's one representation of a sharded value: a list of
per-shard tensors, shard ``j`` on the ``j``-th device along the sharded
axis, or for a replicated value one tensor per device of the mesh.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import threading
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

logger = logging.getLogger(__name__)

Params = Any

# Mesh axis names, defined here (the root of the parallel/ import graph);
# mesh.py re-exports them.
CLIENT_AXIS = "clients"
MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """``PartitionSpec(*axes)``: one entry per leading dim, a mesh axis
    name, a tuple of names, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(tuple(self))

    __str__ = __repr__


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec


# ---------------------------------------------------------------------------
# spec helpers: the only sanctioned PartitionSpec constructors


def replicated_spec() -> PartitionSpec:
    """Fully-replicated spec (the global model each round)."""
    return PartitionSpec()


def client_spec(axis: str = CLIENT_AXIS) -> PartitionSpec:
    """``[C, ...]`` stacked client arrays: dim 0 over the client axis."""
    return PartitionSpec(axis)


def waved_client_spec(axis: str = CLIENT_AXIS) -> PartitionSpec:
    """``[W, C, ...]`` wave-major client stacks (the fused rounds' data
    layout): dim 1 over the client axis, waves replicated."""
    return PartitionSpec(None, axis)


def dim_spec(axis: str, dim: int, ndim: int) -> PartitionSpec:
    """Shard the single dimension ``dim`` of an ``ndim``-rank array over
    ``axis``, e.g. ``dim_spec('seq', 2, 4)`` for [B, H, L, Dh] blocks."""
    if not 0 <= dim < ndim:
        raise ValueError(f"dim {dim} out of range for ndim {ndim}")
    return PartitionSpec(*(axis if i == dim else None for i in range(ndim)))


def axes_spec(*axes: Optional[str]) -> PartitionSpec:
    """``PartitionSpec(*axes)`` for a layout the helpers above do not name."""
    return PartitionSpec(*axes)


# ---------------------------------------------------------------------------
# rules


@dataclasses.dataclass(frozen=True)
class Rule:
    """One ordered rule: ``pattern`` is ``re.search``-ed against the
    slash-joined path; ``ndim``, when given, also requires the leaf's rank."""

    pattern: str
    spec: PartitionSpec
    ndim: Optional[int] = None

    def matches(self, path: str, leaf: Any) -> bool:
        if self.ndim is not None and _ndim(leaf) != self.ndim:
            return False
        return re.search(self.pattern, path) is not None


class _UnmatchedCounter:
    """Thread-safe count of leaves that fell through every rule."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._count = 0

    def bump(self, rule_set: str, path: str) -> None:
        with self._lock:
            self._count += 1
        logger.warning("partition: no rule in %r matched leaf %r; replicating", rule_set, path)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def reset(self) -> None:
        with self._lock:
            self._count = 0


#: Module-level tally of unmatched leaves across every RuleSet.
UNMATCHED = _UnmatchedCounter()


def unmatched_leaf_count() -> int:
    return UNMATCHED.count


def reset_unmatched_leaf_count() -> None:
    UNMATCHED.reset()


def _shape(leaf: Any):
    return getattr(leaf, "shape", None)


def _ndim(leaf: Any):
    shape = _shape(leaf)
    return None if shape is None else len(shape)


def _is_scalar(leaf: Any) -> bool:
    shape = _shape(leaf)
    if shape is None:
        return True
    n = 1
    for d in shape:
        n *= d
    return len(shape) == 0 or n == 1


def _divisible(leaf: Any, spec: PartitionSpec, mesh) -> bool:
    """Can ``leaf`` be split per ``spec`` on ``mesh``: each sharded dim a
    multiple of the product of its mesh axis sizes."""
    for dim, names in zip(_shape(leaf), spec):
        if names is None:
            continue
        size = 1
        for a in names if isinstance(names, tuple) else (names,):
            size *= mesh.shape[a]
        if dim % size:
            return False
    return True


def _flatten(tree, prefix: str = ""):
    """``[(path, leaf)]`` of nested dicts, lists and tuples, paths joined by
    ``/`` (a flat param dict's keys are its paths)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _map_with_path(fn, tree, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


@dataclasses.dataclass(frozen=True)
class RuleSet:
    """A named, ordered rule table: the declarative partition config.
    ``name`` is what a record of the sharding policy names."""

    name: str
    rules: Tuple[Rule, ...]

    def spec_for(self, path: str, leaf: Any) -> PartitionSpec:
        """First-match-wins spec for one leaf. Scalars are always
        replicated; unmatched leaves replicate and bump ``UNMATCHED``."""
        if _is_scalar(leaf):
            return replicated_spec()
        for rule in self.rules:
            if rule.matches(path, leaf):
                return rule.spec
        UNMATCHED.bump(self.name, path)
        return replicated_spec()

    def leaf_sharding(self, path: str, leaf: Any, mesh) -> NamedSharding:
        """The sharding of one leaf, with the divisibility fallback."""
        spec = self.spec_for(path, leaf)
        if spec != replicated_spec() and not _divisible(leaf, spec, mesh):
            spec = replicated_spec()
        return NamedSharding(mesh, spec)

    def tree_specs(self, params: Params) -> Params:
        """The spec of every leaf, in ``params``' structure (no mesh, no
        divisibility fallback)."""
        return _map_with_path(self.spec_for, params)

    def shardings(self, params: Params, mesh) -> Params:
        """The sharding of every leaf on ``mesh``, in ``params``' structure."""
        return _map_with_path(lambda p, leaf: self.leaf_sharding(p, leaf, mesh), params)

    def place(self, params: Params, mesh) -> Params:
        """``params`` placed on ``mesh`` per the rules: every leaf a list
        of per-shard tensors (``mesh.device_put``)."""
        from baton_tpu_torch.parallel.mesh import device_put

        return _map_with_path(
            lambda p, leaf: device_put(leaf, self.leaf_sharding(p, leaf, mesh)), params)

    def describe(self, params: Params, mesh=None) -> Dict[str, str]:
        """``{path: spec string}``; with a mesh, after the divisibility
        fallback (what would be placed), else the rules' outcome."""
        out: Dict[str, str] = {}
        for path, leaf in _flatten(params):
            spec = (self.leaf_sharding(path, leaf, mesh).spec if mesh is not None
                    else self.spec_for(path, leaf))
            out[path] = str(spec)
        return out


def match_partition_rules(rules: Iterable[Tuple[str, PartitionSpec]], params: Params,
                          name: str = "ad-hoc") -> Params:
    """Ordered ``(regex, spec)`` pairs to the spec of every leaf: sugar for
    ``RuleSet(...).tree_specs(...)``."""
    return RuleSet(name, tuple(Rule(pat, spec) for pat, spec in rules)).tree_specs(params)


# ---------------------------------------------------------------------------
# default rule tables per model family


def transformer_rules(axis: str = MODEL_AXIS) -> RuleSet:
    """Megatron-style table for the transformer zoo (Llama swiglu, BERT/ViT
    gelu MLP, MoE and LoRA-wrapped variants), anchored on the last path
    component, so LoRA factors (``.../a``, ``.../b``) fall to the
    replicated catch-all:

    * stacked MoE experts ``[E, D, F]``: the expert dim sharded;
    * column-parallel (output features): wq/wk/wv, w_gate/w_up, w1 (and
      b1), lm_head;
    * row-parallel (the contraction dim): wo, w_down, w2;
    * vocab-sharded embedding rows: tok_emb;
    * everything else replicated."""
    return RuleSet(
        name=f"transformer-tp[{axis}]",
        rules=(
            Rule(r"(^|/)(w_gate|w_up|w_down)$", PartitionSpec(axis, None, None), ndim=3),
            Rule(r"(^|/)(wq|wk|wv|w_gate|w_up|w1|lm_head)$", PartitionSpec(None, axis), ndim=2),
            Rule(r"(^|/)(wo|w_down|w2|tok_emb)$", PartitionSpec(axis, None), ndim=2),
            Rule(r"(^|/)b1$", PartitionSpec(axis), ndim=1),
            Rule(r".*", replicated_spec()),
        ),
    )


def client_stacked_rules(axis: str = CLIENT_AXIS) -> RuleSet:
    """``[C, ...]`` per-client stacked state: every leaf on dim 0 over the
    client axis."""
    return RuleSet(name=f"client-stacked[{axis}]", rules=(Rule(r".*", client_spec(axis)),))


def replicated_rules() -> RuleSet:
    """Everything replicated: the broadcast global model."""
    return RuleSet(name="replicated", rules=(Rule(r".*", replicated_spec()),))


#: The default rule tables, keyed by the name a record of the policy names.
DEFAULT_RULE_SETS: Dict[str, Callable[[], RuleSet]] = {
    "transformer-tp": transformer_rules,
    "client-stacked": client_stacked_rules,
    "replicated": replicated_rules,
}


# ---------------------------------------------------------------------------
# the layout table of the sharded rounds


def kernel_specs(name: str, axis: str = CLIENT_AXIS
                 ) -> Tuple[Tuple[PartitionSpec, ...], Tuple[PartitionSpec, ...]]:
    """``(in_specs, out_specs)`` of every sharded round body of the
    algorithm paths (JAX's ``shard_map`` kernels; here one process runs the
    body once a shard). Per-client stacked inputs and outputs ride the
    client axis; broadcast globals and psum-folded aggregates are
    replicated."""
    cli, rep = client_spec(axis), replicated_spec()
    table = {
        # (params, frozen, data, n, perms) -> (psum, lsum, wsum, closs)
        "engine.wave_sums": ((rep, rep, cli, cli, cli),
                             (rep, rep, rep, cli)),
        # (params, frozen, data, n, perms) -> (client_params, closs)
        "engine.wave_params": ((rep, rep, cli, cli, cli), (cli, cli)),
        # (params_stack, data, n, perms, frozen) -> (client_params, closs)
        "fedbuff.train": ((cli, cli, cli, cli, rep), (cli, cli)),
        # (cluster_params, data, n, perms) -> (new_cluster_params, assignments, closs)
        "clustered.round": ((rep, cli, cli, cli), (rep, cli, cli)),
        # (params, opt_states, data, n, perms)
        #   -> (psums, new_opt_states, lsum_w_wsum, closs)
        "stateful.round": ((rep, cli, cli, cli, cli),
                           (rep, cli, rep, cli)),
        # (personal_state, shared, data, n, perms)
        #   -> (new_pers, shared_agg, pers_mean, loss_hist, closs)
        "personalization.round": ((cli, rep, cli, cli, cli),
                                  (cli, rep, rep, rep, cli)),
    }
    return table[name]
