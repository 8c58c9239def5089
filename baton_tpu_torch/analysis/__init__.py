"""batonlint — project-native static analysis for baton_tpu_torch.

The server buys durability and a pipelined data plane by enforcing
delicate conventions *by hand*: no blocking decode/fold work on the
asyncio event loop, every request body read through a byte cap, no
``await`` of network primitives while holding a state lock, no Python
side effects inside ``jit``/``shard_map``-traced functions, and a
metrics-counter namespace that matches the declared registry. Nothing
checked any of that — ``http_worker.py`` regressed to an uncapped
``await request.read()`` within one PR of the cap landing.

This package is the machine enforcement: a stdlib-``ast`` lint engine
(:mod:`~baton_tpu_torch.analysis.engine`) with a checker registry, per-line
suppressions (``# batonlint: allow[RULE]``), text/JSON reporters, and a
CLI (``python -m baton_tpu_torch.analysis [paths]``).  Since the
whole-program layer landed (:mod:`~baton_tpu_torch.analysis.project` builds
a cross-module symbol table with class-hierarchy analysis,
:mod:`~baton_tpu_torch.analysis.callgraph` a static call graph over it, and
:mod:`~baton_tpu_torch.analysis.summaries` bottom-up fixpoint function
summaries over the call graph's SCCs), rules come in two scopes:
per-file (``Checker``) and project-wide (``ProjectChecker`` — every
file on the command line analyzed as one program).  Rules:

=======  ==============================================================
BTL000   stale suppression: a ``# batonlint: allow[RULE]`` comment
         that no longer silences any finding — stale allows hide the
         next real instance at that line
BTL001   blocking call (file I/O, ``time.sleep``, ``pickle.loads``,
         ``zlib.*``, ``.block_until_ready()``, ``jax.device_get``)
         reachable from an ``async def`` in ``baton_tpu_torch/server/`` —
         directly or through sync helpers at any call-graph depth,
         cross-module, with the witness chain  [project-wide]
BTL002   ``await`` of a network/queue primitive while holding an
         asyncio lock — lexically or through awaited coroutines'
         fixpoint summaries; lock-acquisition-order CYCLES over the
         whole-program call graph (multi-hop, cross-module ABBA
         pairs, both acquisition paths reported); ``self.*`` lock
         identity normalizes to the root ancestor class, so
         subclass-override acquisitions unify  [project-wide]
BTL003   shared-state snapshot (``self.reg.get(k)``, guarded
         attribute, one-hop helper) used after an ``await`` /
         ``to_thread`` boundary without an identity re-check — the
         abort/restart TOCTOU that downgraded secure aggregation;
         branch-sensitive: a re-check in an ``if`` whose arm
         returns/raises installs the guard, and staleness on a
         terminating branch does not leak past the merge
BTL004   async shared-state race in ``server/`` classes: a ``self.*``
         snapshot taken before an ``await`` and written back after it
         from the stale value (lost update), or a lockless write to
         an attribute that another method writes under a lock held
         across an await — fix with the lock, or compare-and-
         invalidate against the decision value  [project-wide]
BTL010   tracer hygiene inside ``@jax.jit``/``shard_map`` functions
         (``print``, ``.item()``, ``float()``/``int()`` on traced
         values, ``np.asarray``, module-state mutation); traced
         values followed by dataflow taint through assignments,
         ``self.*`` writes, containers, and call results; calls into
         project helpers (any depth, cross-module, CHA dispatch)
         whose summaries contain such ops are flagged at the call
         site with the witness chain  [project-wide]
BTL011   ``jax.jit`` applied to a round-step/training function whose
         parameters carry model-state pytrees (``params``,
         ``opt_states``, ``anchors``...) with no donation decision —
         pass ``donate_argnums`` (``()`` records an audited no) or
         suppress with a justified ``# batonlint: allow[BTL011]``
BTL020   raw ``request.read()`` / uncapped ``request.json()`` in an
         aiohttp handler (use ``utils.read_body_capped`` /
         ``utils.read_json_capped``)
BTL030   metrics counter used in ``server/`` but not declared in
         ``baton_tpu_torch/utils/metrics.py``
=======  ==============================================================

The repo itself must stay lint-clean: ``tests/test_analysis.py::
test_repo_is_lint_clean`` runs this engine over ``baton_tpu_torch/`` and
asserts zero findings, and CI runs the CLI before the test suite
(uploading the ``--json-out`` report as a build artifact).
``--changed-only`` lints the whole project but reports only files
touched per ``git diff`` — the fast pre-commit mode.  ``--cache``
persists per-file local summaries keyed by content hash
(``.batonlint_cache.json``) so unchanged files skip extraction on the
next run (hit/miss counts surface in ``--json-out``), and ``--sarif``
writes a SARIF 2.1.0 report for code-scanning UIs.
"""

from baton_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    Report,
    all_rules,
    run_paths,
    run_project_sources,
    run_source,
)
