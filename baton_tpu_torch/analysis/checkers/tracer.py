"""BTL010 — tracer hygiene inside jit / shard_map'd functions.

Code under ``jax.jit`` / ``shard_map`` runs ONCE at trace time against
abstract tracers; host-side operations inside it either crash
(``ConcretizationTypeError``), silently capture trace-time-only values,
or — worst — force a device sync per call. Flagged inside traced
functions (including their nested ``def``s and lambdas, which are
traced too):

* ``print(...)`` — runs at trace time only; use ``jax.debug.print``;
* ``.item()`` — concretizes a tracer, forcing a blocking transfer;
* ``float(x)`` / ``int(x)`` / ``bool(x)`` on values derived from the
  traced function's parameters — concretization;
* ``np.asarray`` / ``np.array`` / ``np.copy`` on parameter-derived
  values — silently materializes the tracer on host;
* module-state mutation (``global`` declarations, writes through
  module-level names) — trace-time side effects that do not replay;
* a call into any project function — same module, another module, or a
  ``self.method()`` through class-hierarchy dispatch — whose bottom-up
  fixpoint summary (:mod:`~baton_tpu_torch.analysis.summaries`) contains one
  of the hazards above, at any depth.  ``print`` in a helper fires
  unconditionally (the helper's body is traced too); casts /
  materializers / ``.item()`` in a helper fire only when the call
  passes a traced argument, since they concretize the *caller's*
  tracer through the parameter.  The finding lands at the call site in
  the traced function and names the hazard's true location and witness
  chain.

A function counts as traced when it is decorated with
``jax.jit`` / ``jit`` / ``pmap`` / ``shard_map`` (bare or wrapped in
``partial(...)``), or when its name (or a lambda) is passed directly to
such a transform at a call site in the same module —
``jax.jit(one_client)``, ``shard_map(kernel, mesh, ...)``.

"Derived from the parameters" is intra-procedural dataflow taint, not
just name matching: taint starts at the parameters and propagates
through assignments (tuple unpacking included), ``self.*`` attribute
writes, container element writes and mutator calls (``d["k"] = x``,
``lst.append(x)`` taint the container), and call results (a call
consuming a traced value returns a traced value — the conservative
one-hop return rule), iterated to a fixpoint.  ``.shape``/``.dtype``/
``.ndim`` reads are static under tracing and cut the taint, so
``int(x.shape[0])`` stays legal.  ``self``/``cls`` themselves are NOT
tainted (a jitted method marks them static via ``static_argnums``);
only attributes explicitly written with traced values are.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from baton_tpu_torch.analysis import _astutil as au
from baton_tpu_torch.analysis.engine import Finding, ProjectChecker, register
from baton_tpu_torch.analysis.summaries import get_summaries

# dotted-name leaves that mark a JAX tracing transform
_TRANSFORMS = {"jit", "pmap", "shard_map", "vmap_of_jit"}

_NP_MATERIALIZERS = {"asarray", "array", "copy"}

_CASTS = {"float", "int", "bool", "complex"}

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _transform_name(node: ast.AST) -> Optional[str]:
    """'jit'/'pmap'/'shard_map' when ``node`` names a JAX transform
    (``jit``, ``jax.jit``, ``jax.experimental.shard_map.shard_map``)."""
    name = au.dotted_name(node)
    if name is None:
        return None
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _TRANSFORMS:
        # guard against unrelated locals named e.g. `jit`: accept bare
        # names and anything rooted in jax/functools-style modules
        return leaf
    return None


def _decorator_transform(dec: ast.AST) -> Optional[str]:
    """Transform name when a decorator traces the function: ``@jax.jit``,
    ``@partial(jax.jit, static_argnums=...)``, ``@jit``."""
    direct = _transform_name(dec)
    if direct is not None:
        return direct
    if isinstance(dec, ast.Call):
        # @jax.jit(...) / @shard_map(...) factory form
        direct = _transform_name(dec.func)
        if direct is not None:
            return direct
        # @partial(jax.jit, ...) / @functools.partial(shard_map, ...)
        fname = au.dotted_name(dec.func)
        if fname is not None and fname.rsplit(".", 1)[-1] == "partial":
            if dec.args:
                return _transform_name(dec.args[0])
    return None


@register
class TracerHygieneChecker(ProjectChecker):
    rule = "BTL010"
    title = "host-side operation inside a jit/shard_map traced function"

    def check_project(self, project) -> Iterable[Finding]:
        findings: List[Finding] = []
        summaries = get_summaries(project)
        for mod in project.modules:
            findings.extend(self._check_module(mod, project, summaries))
        return findings

    def _check_module(self, mod, project, summaries) -> List[Finding]:
        findings: List[Finding] = []
        module_names = self._module_level_names(mod.tree)

        # name -> (def node, class), for resolving jax.jit(one_client)
        defs_by_name = {}
        for _qual, cls, node in au.iter_function_defs(mod.tree):
            defs_by_name.setdefault(node.name, (node, cls))

        traced: List[tuple] = []  # (node, class_name, how)
        seen_ids: Set[int] = set()

        def mark(node, cls, how: str) -> None:
            if id(node) not in seen_ids:
                seen_ids.add(id(node))
                traced.append((node, cls, how))

        for _qual, cls, node in au.iter_function_defs(mod.tree):
            for dec in node.decorator_list:
                t = _decorator_transform(dec)
                if t is not None:
                    mark(node, cls, t)

        for call in ast.walk(mod.tree):
            if not isinstance(call, ast.Call) or not call.args:
                continue
            t = _transform_name(call.func)
            if t is None:
                continue
            target = call.args[0]
            if isinstance(target, ast.Lambda):
                mark(target, None, t)
            elif isinstance(target, ast.Name) and target.id in defs_by_name:
                node, cls = defs_by_name[target.id]
                mark(node, cls, t)

        for node, cls, how in traced:
            findings.extend(
                self._scan_traced(
                    node, cls, how, module_names, mod, project, summaries
                )
            )
        return findings

    @staticmethod
    def _module_level_names(tree: ast.Module) -> Set[str]:
        names: Set[str] = set()
        for stmt in tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                targets = [stmt.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        return names

    def _scan_traced(
        self, fn, cls, how, module_names, mod, project, summaries
    ) -> List[Finding]:
        findings: List[Finding] = []
        label = getattr(fn, "name", "<lambda>")
        where = f"in `{label}` traced by {how}"

        # everything derived from the traced function's parameters is a
        # tracer; nested defs inherit the outer params (they are traced
        # as part of the same computation). self/cls are static under
        # jit (static_argnums), so only attributes written with traced
        # values taint — see _propagate_taint.
        tainted = au.param_names(fn) - {"self", "cls"}
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, _FUNC_NODES):
                    tainted |= au.param_names(node) - {"self", "cls"}

        # intra-procedural dataflow: propagate taint through plain
        # assignments, tuple unpacking, `self.*` attributes, container
        # element writes (which taint the container), and call results
        # (any call consuming a traced value returns a traced value —
        # the conservative one-hop return rule). Iterate to a fixpoint:
        # `self._cache = x` early and `np.asarray(self._cache)` later
        # converge regardless of AST walk order.
        touches_tracer = au.make_taint_oracle(tainted)
        for _ in range(10):  # fixpoint cap; real bodies settle in 2-3
            if not au.propagate_taint(body, tainted, touches_tracer):
                break

        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Global):
                    findings.append(
                        Finding(
                            self.rule, mod.path, node.lineno,
                            node.col_offset,
                            f"`global {', '.join(node.names)}` {where}: "
                            f"trace-time side effects do not replay on "
                            f"later calls",
                        )
                    )
                elif isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for t in targets:
                        root = t
                        while isinstance(root, (ast.Attribute, ast.Subscript)):
                            root = root.value
                        if (
                            t is not root  # only dotted/indexed writes
                            and isinstance(root, ast.Name)
                            and root.id in module_names
                        ):
                            findings.append(
                                Finding(
                                    self.rule, mod.path, node.lineno,
                                    node.col_offset,
                                    f"mutation of module state "
                                    f"`{au.dotted_name(t) or root.id}` "
                                    f"{where}: happens once at trace "
                                    f"time, not per call",
                                )
                            )
                elif isinstance(node, ast.Call):
                    findings.extend(
                        self._check_call(node, where, touches_tracer, mod)
                    )
                    findings.extend(
                        self._check_call_summary(
                            node, cls, where, touches_tracer,
                            mod, project, summaries,
                        )
                    )
        return findings

    def _check_call(self, call, where, touches_tracer, mod):
        out = []
        name = au.call_name(call)
        if name == "print":
            out.append(
                Finding(
                    self.rule, mod.path, call.lineno, call.col_offset,
                    f"print() {where} runs at trace time only; use "
                    f"jax.debug.print for per-call output",
                )
            )
        elif name in _CASTS and call.args and touches_tracer(call.args[0]):
            out.append(
                Finding(
                    self.rule, mod.path, call.lineno, call.col_offset,
                    f"{name}() on a traced value {where} concretizes "
                    f"the tracer (ConcretizationTypeError or a forced "
                    f"device sync)",
                )
            )
        elif (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _NP_MATERIALIZERS
            and au.dotted_name(call.func.value) in ("np", "numpy")
            and call.args
            and touches_tracer(call.args[0])
        ):
            out.append(
                Finding(
                    self.rule, mod.path, call.lineno, call.col_offset,
                    f"np.{call.func.attr}() on a traced value {where} "
                    f"materializes the tracer on host; use jnp.{call.func.attr}",
                )
            )
        elif isinstance(call.func, ast.Attribute) and call.func.attr == "item":
            if not call.args and not call.keywords:
                out.append(
                    Finding(
                        self.rule, mod.path, call.lineno, call.col_offset,
                        f".item() {where} blocks on a device->host "
                        f"transfer per trace; return the array and "
                        f"concretize outside the jit boundary",
                    )
                )
        return out

    def _check_call_summary(
        self, call, cls, where, touches_tracer, mod, project, summaries
    ):
        """Interprocedural leg: the callee's fixpoint summary carries
        the host ops reachable through it (with witness chains)."""
        out = []
        args_tainted = any(
            touches_tracer(a) for a in call.args
        ) or any(
            kw.value is not None and touches_tracer(kw.value)
            for kw in call.keywords
        )
        for callee in project.resolve_call_multi(mod, cls, call):
            summ = summaries.get(callee.key)
            if summ is None:
                continue
            for (path, line, _c), (
                needs, _kind, msg, chain,
            ) in sorted(summ.taint_ops.items()):
                if needs and not args_tainted:
                    continue
                full = (callee.qualname,) + chain
                via = " -> ".join(f"{q}()" for q in full)
                out.append(
                    Finding(
                        self.rule, mod.path, call.lineno, call.col_offset,
                        f"call {where} reaches a host-side op via {via} "
                        f"(at {path}:{line}): {msg}",
                    )
                )
        return out
