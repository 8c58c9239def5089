"""BTL011 — undeclared buffer-donation policy on jitted state steppers.

A ``jax.jit``'d round-step/training function that takes model-state
pytrees (``params``, optimizer state, per-client anchors...) holds TWO
copies of that state live across the dispatch unless the input buffers
are donated — on real accelerators that is the difference between
fitting the flagship stage in HBM and not. Donation is also *unsafe*
exactly when the caller reuses the arrays after the call (the engine's
per-round paths retain the anchor copy for the next wave), so the
policy can't be a blanket default: it must be DECIDED per jit site.

The rule therefore flags any jit application whose target function has
a parameter named like federated model state

    params, anchors, cluster_params, personal_state,
    opt_states, opt_state, server_opt_state

when the jit call/decorator carries no ``donate_argnums`` /
``donate_argnames`` keyword. Passing an explicit ``donate_argnums=()``
records "considered, and the answer is no" and satisfies the rule; so
does a ``# batonlint: allow[BTL011]`` comment with a justification at
the jit site (or at the target's ``def`` line).

Recognized jit applications:

* decorators — ``@jax.jit``, ``@jit``, ``@jax.jit(...)``,
  ``@partial(jax.jit, ...)``;
* call sites — ``jax.jit(fn, ...)`` where ``fn`` is a same-module
  ``def``, a lambda, a ``shard_map(kernel, ...)`` expression, or a
  local name previously bound to one (the engine's
  ``sharded = shard_map(kernel, ...); jax.jit(sharded)`` shape).

``self``/``cls`` are ignored (static under ``static_argnums``), and
functions whose parameters carry none of the state names are out of
scope — donation of activations/data is a per-kernel judgement call,
not a policy this rule can audit.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional

from baton_tpu_torch.analysis import _astutil as au
from baton_tpu_torch.analysis.engine import Checker, CheckContext, Finding, register

# parameter names that mean "a model-state pytree rides this argument"
_STATE_PARAMS = frozenset({
    "params",
    "anchors",
    "cluster_params",
    "personal_state",
    "opt_states",
    "opt_state",
    "server_opt_state",
})

_DONATE_KEYWORDS = {"donate_argnums", "donate_argnames"}

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _is_jit(node: ast.AST) -> bool:
    name = au.dotted_name(node)
    return name is not None and name.rsplit(".", 1)[-1] == "jit"


def _is_shard_map(node: ast.AST) -> bool:
    name = au.dotted_name(node)
    return name is not None and name.rsplit(".", 1)[-1] == "shard_map"


def _has_donate_decision(call: Optional[ast.Call]) -> bool:
    """True when the jit application names a donation policy — ANY
    ``donate_argnums``/``donate_argnames`` keyword counts, including an
    explicit empty tuple (an audited "no")."""
    if call is None:
        return False
    return any(
        kw.arg in _DONATE_KEYWORDS for kw in call.keywords if kw.arg
    )


@register
class DonationPolicyChecker(Checker):
    rule = "BTL011"
    title = "jitted state-stepping function with no donation decision"

    def check(self, ctx: CheckContext) -> Iterable[Finding]:
        findings: List[Finding] = []

        defs_by_name: Dict[str, ast.AST] = {}
        for _qual, _cls, node in au.iter_function_defs(ctx.tree):
            defs_by_name.setdefault(node.name, node)

        # local names bound to shard_map(...) results:
        # sharded = shard_map(kernel, ...); later jax.jit(sharded)
        shardmap_bindings: Dict[str, ast.AST] = {}
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            target, value = node.targets[0], node.value
            if not (isinstance(target, ast.Name)
                    and isinstance(value, ast.Call)
                    and _is_shard_map(value.func)):
                continue
            fn = self._resolve_target(value.args[0] if value.args else None,
                                      defs_by_name, {})
            if fn is not None:
                shardmap_bindings[target.id] = fn

        seen = set()

        def audit(fn: Optional[ast.AST], site: ast.AST,
                  jit_call: Optional[ast.Call]) -> None:
            if fn is None or (id(fn), site.lineno) in seen:
                return
            seen.add((id(fn), site.lineno))
            if _has_donate_decision(jit_call):
                return
            state_args = sorted(
                (au.param_names(fn) - {"self", "cls"}) & _STATE_PARAMS
            )
            if not state_args:
                return
            label = getattr(fn, "name", "<lambda>")
            findings.append(Finding(
                self.rule, ctx.path, site.lineno, site.col_offset,
                f"jax.jit on `{label}` takes model-state pytrees "
                f"({', '.join(state_args)}) with no donation decision; "
                f"pass donate_argnums (an explicit `()` records an "
                f"audited no) or justify with # batonlint: allow[BTL011]",
                also_lines=(fn.lineno,) if fn.lineno != site.lineno else (),
            ))

        # decorator applications
        for _qual, _cls, node in au.iter_function_defs(ctx.tree):
            for dec in node.decorator_list:
                jit_call = None
                if _is_jit(dec):
                    pass  # bare @jax.jit — no keywords possible
                elif isinstance(dec, ast.Call) and _is_jit(dec.func):
                    jit_call = dec  # @jax.jit(...) factory
                elif (
                    isinstance(dec, ast.Call)
                    and (au.dotted_name(dec.func) or "").rsplit(".", 1)[-1]
                    == "partial"
                    and dec.args
                    and _is_jit(dec.args[0])
                ):
                    jit_call = dec  # @partial(jax.jit, ...)
                else:
                    continue
                audit(node, dec, jit_call)

        # call-site applications
        for call in ast.walk(ctx.tree):
            if not (isinstance(call, ast.Call) and call.args
                    and _is_jit(call.func)):
                continue
            fn = self._resolve_target(call.args[0], defs_by_name,
                                      shardmap_bindings)
            audit(fn, call, call)

        return findings

    @staticmethod
    def _resolve_target(
        target: Optional[ast.AST],
        defs_by_name: Dict[str, ast.AST],
        shardmap_bindings: Dict[str, ast.AST],
    ) -> Optional[ast.AST]:
        """The function a jit/shard_map application traces, when it is
        statically visible in this module; None for dynamic targets
        (call results, attributes) — those are out of scope."""
        if target is None:
            return None
        if isinstance(target, ast.Lambda):
            return target
        if isinstance(target, ast.Name):
            return defs_by_name.get(target.id) or shardmap_bindings.get(
                target.id
            )
        if isinstance(target, ast.Call) and _is_shard_map(target.func):
            return DonationPolicyChecker._resolve_target(
                target.args[0] if target.args else None,
                defs_by_name, shardmap_bindings,
            )
        return None
