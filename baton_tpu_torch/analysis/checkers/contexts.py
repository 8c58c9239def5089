"""BTL005/BTL006 — cross-execution-context concurrency hygiene.

Both rules consume the execution-context lattice from
:mod:`~baton_tpu_torch.analysis.summaries`: every function is rooted at the
entry points that can actually run it (``async def`` bodies, route
registrations, ``PeriodicTask``/loop callbacks -> *loop* context;
``asyncio.to_thread`` / executor ``submit`` / ``run_in_executor`` /
``threading.Thread(target=...)`` -> *thread* context), with context
propagated along execution edges of the call graph.

BTL005: instance or module state written from thread context while any
loop-context function also mutates the same state, with no common
``threading.Lock`` held around both sides (write/write on the same
group is the unambiguous race; bare reference reads are GIL-atomic and
the staleness rules own read-side windows).  Grouping is by LEAF
dotted path (``_round.acc``, not ``_round``): a fold-lane thread
mutating ``r.acc`` does not conflict with loop bookkeeping on
``r.contributors`` — disjoint leaves of the same root object are
independent state.  An ``asyncio.Lock``
explicitly does NOT count — it excludes coroutines from each other but
a worker thread never awaits it.  Constructors are exempt (the object
is not shared yet).  Accesses through stable ``self`` aliases
(``r = self._round`` captured by a fold closure) are attributed to the
underlying attribute, so executor-lane closures are visible.

BTL006: asyncio primitives (``self.X = asyncio.Event()/Queue()/...``)
touched through their non-threadsafe mutation APIs (``.set()``,
``.put_nowait()``, ``.set_result()``, ...) from thread context, and
receiver-agnostic loop-affine calls (``loop.call_soon``,
``create_task``) made from thread context.  The fix is to marshal back
onto the loop: ``loop.call_soon_threadsafe(...)`` /
``asyncio.run_coroutine_threadsafe(...)`` — both of which this rule
recognizes as safe (they are loop-callback *registrations*, not
touches).

Scope: both rules report only inside ``server/`` and ``obs/`` modules —
the runtime tiers where the loop/thread split is real.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from baton_tpu_torch.analysis.engine import Finding, ProjectChecker, register
from baton_tpu_torch.analysis.summaries import (
    CtxWitness,
    get_summaries,
    lock_identity,
)

_CTOR_NAMES = {"__init__", "__post_init__"}


def _in_scope(mod) -> bool:
    return any(p in ("server", "obs") for p in mod.parts)


def _witness_desc(w: CtxWitness) -> str:
    """Human chain for a context witness: entry point + path taken."""
    if w.chain:
        via = " -> ".join(f"{q}()" for q in w.chain)
        return f"{w.root_qual}() [{w.reason}] via {via}"
    return f"{w.root_qual}() [{w.reason}]"


def _root_of(project, fn) -> Optional[str]:
    if fn.class_name is None:
        return None
    return (
        project.root_class_name(fn.module, fn.class_name)
        or fn.class_name
    )


def _norm_locks(locks, fn, project) -> frozenset:
    return frozenset(
        x for x in (
            lock_identity(raw, fn.class_name, fn.module, project)
            for raw in locks
        ) if x is not None
    )


@register
class CrossContextStateChecker(ProjectChecker):
    rule = "BTL005"
    title = (
        "state written from thread context while the event loop also "
        "mutates it needs a shared threading.Lock (asyncio.Lock cannot "
        "exclude a thread)"
    )

    def check_project(self, project) -> Iterable[Finding]:
        summ = get_summaries(project)
        # (group_key, attr) -> {"thread_writes": [...], "loop_accesses": [...]}
        state: Dict[Tuple[str, str], Dict[str, list]] = {}

        def bucket(key: Tuple[str, str]) -> Dict[str, list]:
            return state.setdefault(
                key, {"thread_writes": [], "loop_accesses": []}
            )

        for fn in project.functions():
            lf = summ.locals.get(fn.key)
            if lf is None or not _in_scope(fn.module):
                continue
            kinds = summ.context_kinds(fn.key)
            if not kinds or fn.node.name in _CTOR_NAMES:
                continue
            accesses: List[Tuple[Tuple[str, str], int, int, bool,
                                 frozenset]] = []
            root = _root_of(project, fn)
            if root is not None:
                for attr, line, col, is_write, slocks, _al in (
                    lf.attr_accesses
                ):
                    accesses.append((
                        (f"class {root}", attr), line, col, is_write,
                        _norm_locks(slocks, fn, project),
                    ))
            for name, line, col, is_write, slocks in lf.global_accesses:
                accesses.append((
                    (f"module {fn.module.name}", name), line, col,
                    is_write, _norm_locks(slocks, fn, project),
                ))
            for key, line, col, is_write, locks in accesses:
                if not is_write:
                    continue  # write/write only: ref reads are atomic
                b = bucket(key)
                if "thread" in kinds:
                    b["thread_writes"].append((fn, line, col, locks))
                if "loop" in kinds:
                    b["loop_accesses"].append(
                        (fn, line, col, is_write, locks)
                    )

        for (group, attr), b in sorted(
            state.items(), key=lambda kv: kv[0]
        ):
            if not b["thread_writes"] or not b["loop_accesses"]:
                continue
            flagged: set = set()
            for wfn, wline, wcol, wlocks in b["thread_writes"]:
                for lfn, lline, _lcol, _lw, llocks in b["loop_accesses"]:
                    if wlocks & llocks:
                        continue  # both sides hold a common sync lock
                    if wfn.key in flagged:
                        break
                    flagged.add(wfn.key)
                    w = summ.witness(wfn.key, "thread")
                    display = (
                        f"self.{attr}" if group.startswith("class")
                        else attr
                    )
                    also = (
                        (lline,) if lfn.module.path == wfn.module.path
                        else ()
                    )
                    yield Finding(
                        "BTL005", wfn.module.path, wline, wcol,
                        f"`{display}` ({group}) is written here in "
                        f"THREAD context ({_witness_desc(w)}) while "
                        f"`{lfn.qualname}()` mutates it on the event "
                        f"loop with no common threading.Lock held on "
                        f"both sides; an asyncio.Lock does not count — "
                        f"a worker thread never awaits it. Guard both "
                        f"sides with one threading.Lock or confine the "
                        f"write to the loop via "
                        f"loop.call_soon_threadsafe(...)",
                        also_lines=also,
                    )
                    break


@register
class AsyncioFromThreadChecker(ProjectChecker):
    rule = "BTL006"
    title = (
        "asyncio primitive touched from thread context; marshal through "
        "call_soon_threadsafe / run_coroutine_threadsafe"
    )

    def check_project(self, project) -> Iterable[Finding]:
        summ = get_summaries(project)
        # asyncio primitives by (root class, attr), from any method
        prims: set = set()
        for fn in project.functions():
            lf = summ.locals.get(fn.key)
            if lf is None:
                continue
            root = _root_of(project, fn)
            if root is None:
                continue
            for attr in lf.asyncio_defs:
                prims.add((root, attr))

        for fn in project.functions():
            lf = summ.locals.get(fn.key)
            if lf is None or not _in_scope(fn.module):
                continue
            kinds = summ.context_kinds(fn.key)
            if "thread" not in kinds:
                continue
            w = summ.witness(fn.key, "thread")
            root = _root_of(project, fn)
            for attr, line, col, method in lf.asyncio_touches:
                if attr == "<loop>":
                    yield Finding(
                        "BTL006", fn.module.path, line, col,
                        f"`.{method}(...)` is loop-affine but "
                        f"`{fn.qualname}()` runs in THREAD context "
                        f"({_witness_desc(w)}); from a thread use "
                        f"loop.call_soon_threadsafe(...) or "
                        f"asyncio.run_coroutine_threadsafe(...)",
                    )
                elif root is not None and (root, attr) in prims:
                    yield Finding(
                        "BTL006", fn.module.path, line, col,
                        f"`self.{attr}.{method}()` touches an asyncio "
                        f"primitive from THREAD context "
                        f"({_witness_desc(w)}); asyncio primitives are "
                        f"not thread-safe — hand the call to the loop "
                        f"with loop.call_soon_threadsafe"
                        f"(self.{attr}.{method}, ...)",
                    )
