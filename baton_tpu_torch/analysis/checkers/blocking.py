"""BTL001 — blocking calls reachable from ``async def`` in server/.

One blocking call on the manager's event loop stalls every heartbeat,
blob Range GET, and upload ack at once (the exact failure the ingest
pipeline exists to prevent). This rule flags calls that synchronously
block — ``time.sleep``, ``pickle.loads``, ``zlib.*``, file I/O,
``.block_until_ready()``, ``jax.device_get`` — when they execute ON the
loop: directly in an ``async def`` body, or inside any plain (sync)
helper the async function reaches through the project call graph.

Reachability comes from the bottom-up fixpoint summaries
(:mod:`baton_tpu_torch.analysis.summaries`): helper chains resolve across
modules and through class-hierarchy dispatch (``self.helper()`` hits
every known override), to any depth, and each finding carries the
witness chain.  The finding points at the blocking call itself — which
may be in a NON-server module when a server handler reaches into a
shared helper — and is additionally suppressible at the async caller's
call site when both live in the same file.

Work routed off the loop is not flagged: nested ``def``/``lambda``
bodies are skipped (they are the closures handed to
``asyncio.to_thread`` / ``run_in_executor`` / the ingest pool), the
routing calls themselves are awaits, and a sync frame merely *calling*
an ``async def`` (no await possible) only builds a coroutine, so
nothing behind it is considered reached.

The rule is execution-context sensitive (third pass): a SYNC function
whose context witness roots it on the event loop through a
registration — a ``PeriodicTask`` callback, ``loop.call_soon`` /
``add_done_callback`` target, or a sync route handler — is held to the
same standard as an ``async def``, while a function dispatched only to
worker threads (``to_thread`` / executor ``submit``) may legally block
and is never flagged.

The blocked-primitive tables live in
:mod:`baton_tpu_torch.analysis.summaries` (the summary extraction records
the sites); this module owns the reachability policy and reporting.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from baton_tpu_torch.analysis.engine import Finding, ProjectChecker, register
from baton_tpu_torch.analysis.summaries import (  # noqa: F401  (re-exported)
    BLOCKED_DOTTED,
    BLOCKED_METHODS,
    BLOCKED_MODULE_PREFIXES,
    BLOCKED_NAMES,
    blocked_reason,
    get_summaries,
)

_ROUTE_HINT = (
    "; route it through asyncio.to_thread / run_in_executor / the "
    "ingest pool, or suppress with '# batonlint: allow[BTL001]'"
)


@register
class BlockingCallChecker(ProjectChecker):
    rule = "BTL001"
    title = "blocking call reachable from async def in baton_tpu_torch/server/"

    def check_project(self, project) -> Iterable[Finding]:
        findings: List[Finding] = []
        summaries = get_summaries(project)
        for fn in project.functions():
            if "server" not in fn.module.parts:
                continue
            if not isinstance(fn.node, ast.AsyncFunctionDef):
                continue
            lf = summaries.locals.get(fn.key)
            if lf is not None:
                for line, col, _display, reason in lf.blocking:
                    findings.append(
                        Finding(
                            self.rule, fn.module.path, line, col,
                            f"{reason} (in `async def {fn.node.name}`)"
                            + _ROUTE_HINT,
                        )
                    )
            # transitive: sync helpers invoked from the async body run
            # on the loop too — the regression vector a direct-only
            # check misses (report_update -> _persist_pending -> disk).
            # Only SYNC callees: an async callee is an async def in its
            # own right and gets its own direct findings.
            for edge in summaries.graph.callees(fn.key):
                callee = summaries.get(edge.callee.key)
                if callee is None or callee.is_async:
                    continue
                for (path, line, col), (
                    _display, reason, chain,
                ) in sorted(callee.blocking.items()):
                    full_chain = (edge.callee.qualname,) + chain
                    via = " -> ".join(f"{q}()" for q in full_chain)
                    also = (
                        (edge.node.lineno,)
                        if path == fn.module.path else ()
                    )
                    findings.append(
                        Finding(
                            self.rule, path, line, col,
                            f"{reason} (reached from `async def "
                            f"{fn.node.name}` via {via})" + _ROUTE_HINT,
                            also_lines=also,
                        )
                    )
        # context pass: sync functions the entry-point model roots on
        # the event loop through a REGISTRATION (PeriodicTask, loop
        # callbacks, sync route handlers) block the loop exactly like
        # an async def body; thread-only functions legally block and
        # are exempt by construction (no loop witness).
        seen_sites = {(f.path, f.line, f.col) for f in findings}
        for fn in project.functions():
            if isinstance(fn.node, ast.AsyncFunctionDef):
                continue
            lf = summaries.locals.get(fn.key)
            if lf is None or not lf.blocking:
                continue
            w = summaries.witness(fn.key, "loop")
            if w is None or w.seed == "async" or not w.server:
                continue
            hop = (
                " -> ".join(f"{q}()" for q in (w.root_qual,) + w.chain)
                if w.chain else f"{w.root_qual}()"
            )
            also = (
                (w.reg_line,) if w.reg_path == fn.module.path else ()
            )
            for line, col, _display, reason in lf.blocking:
                if (fn.module.path, line, col) in seen_sites:
                    continue
                findings.append(
                    Finding(
                        self.rule, fn.module.path, line, col,
                        f"{reason} (in `{fn.qualname}`, which runs on "
                        f"the event loop: {hop} {w.reason})"
                        + _ROUTE_HINT,
                        also_lines=also,
                    )
                )
        return findings
