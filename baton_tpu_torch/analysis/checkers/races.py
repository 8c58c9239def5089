"""BTL004 — async shared-state race on ``self.*`` across an await.

asyncio gives every handler a free atomicity guarantee: between two
awaits, nothing else runs on the loop.  Both sub-patterns here are
exactly the ways server code forfeits that guarantee:

**Lost-update window** (lock-free, the ``http_manager`` shape)::

    waiters = self._waiters          # snapshot
    ...
    await self._flush(...)           # suspension: other tasks run
    self._waiters = waiters + [w]    # write-back from the STALE name

Any mutation of ``self._waiters`` performed by a task scheduled during
the suspension is silently overwritten.  Flagged when a local name
snapshots a ``self.*`` attribute, the function suspends, and the
attribute is later assigned an expression built from that stale name —
with no fresh re-read into the name and no ``is``/``is not`` identity
re-check in between.  Writes under a held asyncio lock are exempt (the
lock, not re-reading, is then the protocol — see the second pattern).

**Guarded window with a lockless accessor**::

    async with self._state_lock:     # M1: lock held ACROSS an await
        self._epoch += 1
        await self._rebalance()      #   mid-update state is observable
        self._assignments = new
    ...
    return self._assignments[k]      # M2: read WITHOUT the lock

A critical section that never suspends is loop-atomic, so lockless
readers are fine — the hazard appears exactly when the section holds
the lock across an await (that is when other tasks can run and observe
``self._epoch`` bumped but ``self._assignments`` still old).  Flagged:
any ``self.A`` access outside lock ``L`` in a class where some method
writes ``A`` under ``L`` and (per the fixpoint summaries, so the await
may live in a transitive callee) holds ``L`` across a suspension.
``__init__``/``__post_init__`` are construction-time and exempt, as is
the degenerate single-method case (writer and only accessor are the
same code under the same lock).

Lost-update scanning is **loop-sensitive**: a ``for``/``while``/
``async for`` whose body suspends is visited twice, the second pass
entering with the state the first pass left and every live snapshot
marked stale at the loop header — a snapshot hoisted above the loop is
fresh on iteration 1 but every later iteration writes back through a
value from a previous epoch.  Findings surfaced only by the repass
carry loop-carried wording.

Scope: classes in ``server/`` modules, asyncio only — ``threading``
locks (``with``, not ``async with``) guard true parallelism and are a
different rule's business.  Lock identities unify through the class
hierarchy (a lock acquired in a subclass override guards the base
attribute), and happens-before facts come from
:mod:`baton_tpu_torch.analysis.summaries`, so both patterns see through
helper calls.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from baton_tpu_torch.analysis import _astutil as au
from baton_tpu_torch.analysis.engine import Finding, ProjectChecker, register
from baton_tpu_torch.analysis.summaries import get_summaries, lock_identity

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_SUSPENDERS = (ast.Await, ast.AsyncFor)
_CTOR_NAMES = {"__init__", "__post_init__", "__set_name__"}


def _body_suspends(stmts: List[ast.stmt]) -> bool:
    """True when a loop body can suspend the task (await / async for /
    async with anywhere in it, nested functions excluded)."""
    todo: List[ast.AST] = list(stmts)
    while todo:
        n = todo.pop()
        if isinstance(n, _FUNCS):
            continue
        if isinstance(n, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
            return True
        todo.extend(ast.iter_child_nodes(n))
    return False


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id in ("self", "cls")
    ):
        return node.attr
    return None


@dataclasses.dataclass
class _Access:
    fn: object                       # FunctionInfo
    attr: str
    line: int
    col: int
    is_write: bool
    locks: FrozenSet[str]            # normalized ids held lexically


class _Snapshot:
    __slots__ = ("attr", "line", "stale_since", "dead")

    def __init__(self, attr: str, line: int) -> None:
        self.attr = attr
        self.line = line
        self.stale_since: Optional[int] = None
        self.dead = False


@register
class AsyncRaceChecker(ProjectChecker):
    rule = "BTL004"
    title = "self.* state raced across an await (lost update / lockless read)"

    def check_project(self, project) -> Iterable[Finding]:
        findings: List[Finding] = []
        summaries = get_summaries(project)
        for mod in project.modules:
            if "server" not in mod.parts:
                continue
            by_class: Dict[str, List] = {}
            for fn in mod.functions.values():
                if fn.class_name is not None:
                    by_class.setdefault(fn.class_name, []).append(fn)
            for class_name, methods in by_class.items():
                self._check_class(
                    mod, class_name, methods, project, summaries, findings
                )
        return findings

    # ------------------------------------------------------------------
    def _check_class(
        self, mod, class_name, methods, project, summaries, findings
    ) -> None:
        accesses: List[_Access] = []
        for fn in methods:
            accesses.extend(
                self._collect_accesses(fn, class_name, mod, project)
            )

        self._check_guarded_windows(
            mod, class_name, methods, accesses, summaries, findings
        )
        for fn in methods:
            if not isinstance(fn.node, ast.AsyncFunctionDef):
                continue
            if fn.node.name.split(".")[-1] in _CTOR_NAMES:
                continue
            self._scan_lost_updates(
                fn, class_name, mod, project, findings
            )

    # -- pattern 2: guarded window + lockless accessor ------------------
    def _check_guarded_windows(
        self, mod, class_name, methods, accesses, summaries, findings
    ) -> None:
        # attr -> {lock: writer_fn} where the writer holds `lock` across
        # a suspension somewhere in its frame (transitively, per the
        # summaries) AND writes attr under it lexically
        guards: Dict[str, Dict[str, object]] = {}
        for acc in accesses:
            if not acc.is_write or not acc.locks:
                continue
            summ = summaries.for_function(acc.fn)
            if summ is None:
                continue
            for lock in acc.locks:
                if lock in summ.awaits_held:
                    guards.setdefault(acc.attr, {}).setdefault(
                        lock, acc.fn
                    )
        if not guards:
            return
        for acc in accesses:
            # only lockless WRITES: a single-attr read between awaits
            # sees a loop-consistent snapshot (asyncio's free atomicity,
            # and protocols like 401->refresh tolerate staleness), but a
            # lockless write voids the mutual exclusion the locked
            # writer paid for — its update can land mid-handshake or be
            # clobbered by it
            if not acc.is_write:
                continue
            if acc.fn.qualname.split(".")[-1] in _CTOR_NAMES:
                continue
            locked = guards.get(acc.attr)
            if not locked:
                continue
            missing = [
                (lock, writer)
                for lock, writer in sorted(locked.items())
                if lock not in acc.locks and writer.key != acc.fn.key
            ]
            if not missing:
                continue
            lock, writer = missing[0]
            findings.append(
                Finding(
                    self.rule, mod.path, acc.line, acc.col,
                    f"`self.{acc.attr}` is written here without "
                    f"`{lock}`, but `{writer.qualname}` mutates it "
                    f"with that lock held across an await — this "
                    f"write can interleave with that in-flight update "
                    f"(clobbering it or being clobbered); guard it, or "
                    f"compare-and-invalidate against the value the "
                    f"decision was based on",
                )
            )

    def _collect_accesses(
        self, fn, class_name, mod, project
    ) -> List[_Access]:
        out: List[_Access] = []

        def lock_of(expr) -> Optional[str]:
            return lock_identity(expr, class_name, mod, project)

        def visit(node, held: FrozenSet[str]) -> None:
            if isinstance(node, _FUNCS):
                return
            if isinstance(node, ast.AsyncWith):
                new_held = held
                for item in node.items:
                    lid = lock_of(item.context_expr)
                    if lid is not None:
                        new_held = new_held | {lid}
                    else:
                        visit(item.context_expr, held)
                for child in node.body:
                    visit(child, new_held)
                return
            attr = _self_attr(node)
            if attr is not None:
                out.append(_Access(
                    fn, attr, node.lineno, node.col_offset,
                    isinstance(node.ctx, (ast.Store, ast.Del)), held,
                ))
            # container mutation through self.A.append(...) is a write
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
            ):
                recv = node.func.value
                r_attr = _self_attr(recv)
                if (
                    r_attr is not None
                    and node.func.attr in au.CONTAINER_MUTATORS | {
                        "pop", "popitem", "remove", "discard", "clear",
                    }
                ):
                    out.append(_Access(
                        fn, r_attr, node.lineno, node.col_offset,
                        True, held,
                    ))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.node.body:
            visit(stmt, frozenset())
        return out

    # -- pattern 1: lock-free lost-update window -------------------------
    def _scan_lost_updates(
        self, fn, class_name, mod, project, findings
    ) -> None:
        snapshots: Dict[str, _Snapshot] = {}
        loop_repass = [0]
        flagged_sites: Set[Tuple[int, int, str]] = set()

        def lock_of(expr) -> Optional[str]:
            return lock_identity(expr, class_name, mod, project)

        def walk_expr(e):
            todo = [e]
            while todo:
                n = todo.pop()
                yield n
                if not isinstance(n, _FUNCS):
                    todo.extend(ast.iter_child_nodes(n))

        def exprs_of(stmt) -> List[ast.AST]:
            if isinstance(stmt, (ast.If, ast.While)):
                return [stmt.test]
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                return [stmt.target, stmt.iter]
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                return [i.context_expr for i in stmt.items]
            if isinstance(stmt, ast.Try):
                return []
            if isinstance(stmt, _FUNCS + (ast.ClassDef,)):
                return []
            return [stmt]

        def has_suspend(nodes) -> Optional[int]:
            for e in nodes:
                for n in walk_expr(e):
                    if isinstance(n, _SUSPENDERS):
                        return n.lineno
            return None

        def uses_name(expr, name: str) -> bool:
            return any(
                isinstance(n, ast.Name) and n.id == name
                and isinstance(n.ctx, ast.Load)
                for n in walk_expr(expr)
            )

        def revalidated(nodes) -> Set[str]:
            out: Set[str] = set()
            for e in nodes:
                for n in walk_expr(e):
                    if not isinstance(n, ast.Compare):
                        continue
                    if not all(
                        isinstance(op, (ast.Is, ast.IsNot))
                        for op in n.ops
                    ):
                        continue
                    operands = [n.left] + list(n.comparators)
                    non_none = [
                        o for o in operands
                        if not (isinstance(o, ast.Constant)
                                and o.value is None)
                    ]
                    if len(non_none) < 2:
                        continue
                    for o in operands:
                        if isinstance(o, ast.Name):
                            out.add(o.id)
            return out

        def flag(name: str, snap: _Snapshot, stmt) -> None:
            snap.dead = True
            site = (stmt.lineno, stmt.col_offset, name)
            if site in flagged_sites:
                return  # already reported on an earlier loop pass
            flagged_sites.add(site)
            carried = (
                " (loop-carried: the snapshot is taken once but the "
                "loop body suspends, so every iteration after the "
                "first writes back through a stale value)"
                if loop_repass[0] else ""
            )
            findings.append(
                Finding(
                    self.rule, mod.path, stmt.lineno, stmt.col_offset,
                    f"lost-update window on `self.{snap.attr}` in "
                    f"`{fn.qualname}`: `{name}` snapshots it on line "
                    f"{snap.line}, the task suspends at the await on "
                    f"line {snap.stale_since}, and the write here "
                    f"rebuilds `self.{snap.attr}` from the stale "
                    f"`{name}` — a concurrent task's update during the "
                    f"suspension is silently overwritten; re-read "
                    f"`self.{snap.attr}` after the await (or mutate it "
                    f"in place / guard the window with a lock)" + carried,
                    also_lines=tuple(
                        x for x in (snap.line, snap.stale_since)
                        if x is not None
                    ),
                )
            )

        def visit(stmts, held: FrozenSet[str]) -> None:
            for stmt in stmts:
                if isinstance(stmt, _FUNCS + (ast.ClassDef,)):
                    continue
                header = exprs_of(stmt)

                for name in revalidated(header):
                    snap = snapshots.get(name)
                    if snap is not None:
                        snap.stale_since = None

                # stale write-back: self.A = f(name) / self.A += name
                if isinstance(stmt, (ast.Assign, ast.AugAssign)):
                    targets = (
                        stmt.targets if isinstance(stmt, ast.Assign)
                        else [stmt.target]
                    )
                    for t in targets:
                        attr = _self_attr(t)
                        if attr is None or stmt.value is None:
                            continue
                        for name, snap in snapshots.items():
                            if (
                                snap.attr == attr
                                and not snap.dead
                                and snap.stale_since is not None
                                and not held  # locked windows: BTL004b
                                and uses_name(stmt.value, name)
                            ):
                                flag(name, snap, stmt)

                line = has_suspend(header)
                if line is not None:
                    for snap in snapshots.values():
                        if not snap.dead and snap.stale_since is None:
                            snap.stale_since = line

                # (re)bindings: `name = self.A` starts/refreshes a
                # snapshot; any other rebinding stops tracking
                fresh: Set[str] = set()
                if isinstance(stmt, ast.Assign):
                    attr = _self_attr(stmt.value)
                    if attr is not None:
                        for t in stmt.targets:
                            if isinstance(t, ast.Name):
                                snapshots[t.id] = _Snapshot(
                                    attr, stmt.lineno
                                )
                                fresh.add(t.id)
                assigned: Set[str] = set()
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            assigned.add(t.id)
                elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                    if isinstance(stmt.target, ast.Name):
                        assigned.add(stmt.target.id)
                for name in assigned - fresh:
                    snapshots.pop(name, None)

                if isinstance(stmt, ast.AsyncWith):
                    new_held = held
                    for item in stmt.items:
                        lid = lock_of(item.context_expr)
                        if lid is not None:
                            new_held = new_held | {lid}
                    visit(stmt.body, new_held)
                    continue
                # loops whose body suspends: repass with iteration 1's
                # end state — a snapshot hoisted above the loop feeds a
                # repeated lost-update window on iterations 2+
                if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
                    visit(stmt.body, held)
                    if isinstance(stmt, ast.AsyncFor) or _body_suspends(
                        stmt.body
                    ):
                        for snap in snapshots.values():
                            if not snap.dead and snap.stale_since is None:
                                snap.stale_since = stmt.lineno
                        loop_repass[0] += 1
                        try:
                            visit(stmt.body, held)
                        finally:
                            loop_repass[0] -= 1
                    visit(stmt.orelse, held)
                    continue
                for block in (
                    getattr(stmt, "body", None),
                    getattr(stmt, "orelse", None),
                    getattr(stmt, "finalbody", None),
                ):
                    if isinstance(block, list):
                        visit(block, held)
                for handler in getattr(stmt, "handlers", []) or []:
                    visit(handler.body, held)

        visit(fn.node.body, frozenset())
