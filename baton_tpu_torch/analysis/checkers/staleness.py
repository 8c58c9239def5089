"""BTL003 — stale snapshot of shared state used across an await.

The bug class (ADVICE round 5, the secure-aggregation downgrade): an
async handler snapshots shared mutable state —

    st = self._secure.get(round_name)

— then crosses an ``await`` (body read, ``asyncio.to_thread``, a peer
round-trip).  During that suspension any other handler may run and
re-key the registry (aborted rounds REUSE round names), so the
snapshot now points at a dead object; committing into it or acting on
it afterwards silently diverges from the live state.  The fix pattern
this repo already uses elsewhere (``handle_secure_shares``) is an
identity re-check after the await::

    if self._secure.get(round_name) is not st:
        return web.json_response({"err": "Superseded"}, status=409)

What counts as a *snapshot source* (assignment RHS, walrus included):

* ``self.A[k]`` / ``self.A.get(k)`` — an entry of a shared registry;
* a bare ``self.A`` read where ``A`` is re-assigned by some OTHER
  method of the class (i.e. demonstrably shared-mutable state);
* a same-class/same-module helper call whose return value is, one hop
  down, such a read (``self._secure_state(name)``).

A use of the snapshot *after* a suspension point (an ``await``
expression, or entry into an ``async with`` / ``async for`` header) is
flagged unless a *revalidation* ran in between:

* an ``is``/``is not`` identity comparison of the snapshot against
  anything but ``None``, or a fresh re-read into the same name; or
* **delegated revalidation** — passing the snapshot to a same-class/
  same-module helper that itself compares that parameter (``is`` or
  ``==``) against the snapshot's source attribute (the
  compare-and-invalidate idiom: ``self._invalidate_credentials(cid)``).

A mutation committed into the snapshot in the SAME statement as the
await (``st[...].update(await ...)`` — the pre-fix ``round_start``
shape) is flagged directly: the receiver was read before the
suspension, the write lands after it.

Control flow is **branch-sensitive**: ``if``/``elif``/``else`` arms
are analyzed with forked snapshot states and merged afterwards, and an
arm that *terminates* (ends in ``return``/``raise``/``continue``/
``break``) does not leak its staleness into the fall-through path — so
a guard like ``if cached: return await self._proxy(...)`` no longer
poisons the straight-line code after it, and a re-check that returns
on mismatch validates the surviving path.

Loops are **loop-sensitive**: a ``for``/``while``/``async for`` whose
body suspends is visited twice, the second pass entering with the
state the first pass left — so a snapshot hoisted ABOVE the loop is
correctly stale on every iteration after the first, even when each
single iteration reads the name before its own await.  Findings from
the repass carry loop-carried wording.  ``try`` bodies still visit
sequentially (effects union), so genuinely-safe hits there may need a
justified ``# batonlint: allow[BTL003]``.

Scope: ``async def``s under ``server/`` only.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from baton_tpu_torch.analysis import _astutil as au
from baton_tpu_torch.analysis.engine import Checker, CheckContext, Finding, register

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_TERMINATORS = (ast.Return, ast.Raise, ast.Continue, ast.Break)


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.A`` -> ``A`` (one level only)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id in ("self", "cls")
    ):
        return node.attr
    return None


def _shared_read_source(
    node: ast.AST,
    mutable_attrs: Set[str],
    helper_sources: Dict[str, str],
    class_name: Optional[str],
) -> Optional[str]:
    """Description of the shared state ``node`` reads, or None.

    Returns e.g. ``"self._secure"`` for ``self._secure.get(k)`` /
    ``self._secure[k]``, ``"self._pending"`` for a bare mutable-attr
    read, or the helper's own source for a one-hop helper call.
    """
    # self.A[k]
    if isinstance(node, ast.Subscript):
        attr = _self_attr(node.value)
        if attr is not None:
            return f"self.{attr}"
        return None
    # self.A.get(k)
    if isinstance(node, ast.Call):
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr == "get"
        ):
            attr = _self_attr(func.value)
            if attr is not None:
                return f"self.{attr}"
        # one-hop helper: self.helper(...) / helper(...)
        qual = au.resolve_local_call(node, class_name)
        if qual is not None and qual in helper_sources:
            return helper_sources[qual]
        return None
    # bare self.A, only when A is provably shared-mutable
    attr = _self_attr(node)
    if attr is not None and attr in mutable_attrs:
        return f"self.{attr}"
    return None


def _collect_mutable_attrs(tree: ast.Module) -> Dict[Optional[str], Set[str]]:
    """Per class: attrs assigned through ``self`` in a method other
    than ``__init__`` — i.e. state that mutates over the object's
    lifetime, not just construction-time wiring."""
    out: Dict[Optional[str], Set[str]] = {}
    for qual, cls, fn in au.iter_function_defs(tree):
        if cls is None or fn.name == "__init__":
            continue
        for node in au.walk_shallow(fn):
            targets: list = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                attr = _self_attr(t)
                if attr is not None:
                    out.setdefault(cls, set()).add(attr)
    return out


def _collect_helper_sources(
    tree: ast.Module, mutable_attrs: Dict[Optional[str], Set[str]]
) -> Dict[str, str]:
    """Qualnames of functions whose return value is (one hop) a shared
    read — e.g. ``_secure_state`` returning ``self._secure.get(name)``
    possibly via a local temp."""
    sources: Dict[str, str] = {}
    for qual, cls, fn in au.iter_function_defs(tree):
        attrs = mutable_attrs.get(cls, set())
        local_src: Dict[str, str] = {}
        returns_src: Optional[str] = None
        for node in au.walk_shallow(fn):
            src = None
            if isinstance(node, ast.Assign):
                src = _shared_read_source(node.value, attrs, {}, cls)
                if src is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            local_src[t.id] = src
            elif isinstance(node, ast.Return) and node.value is not None:
                v = node.value
                src = _shared_read_source(v, attrs, {}, cls)
                if src is None and isinstance(v, ast.Name):
                    src = local_src.get(v.id)
                if src is None and isinstance(v, ast.IfExp):
                    for arm in (v.body, v.orelse):
                        src = _shared_read_source(arm, attrs, {}, cls) or (
                            local_src.get(arm.id)
                            if isinstance(arm, ast.Name) else None
                        )
                        if src:
                            break
                if src is not None:
                    returns_src = src
        if returns_src is not None:
            sources[qual] = returns_src
    return sources


def _collect_revalidators(
    tree: ast.Module,
) -> Dict[Tuple[str, int], Set[str]]:
    """``(helper_qualname, param_index) -> {snapshot sources}`` for
    helpers that compare one of their parameters (``is``/``is not`` or
    ``==``/``!=``) against a ``self.X`` read — the compare-and-
    invalidate idiom.  A caller passing a snapshot of ``self.X`` into
    such a parameter has delegated the freshness re-check."""
    out: Dict[Tuple[str, int], Set[str]] = {}
    for qual, cls, fn in au.iter_function_defs(tree):
        params = [
            a.arg
            for a in (
                list(getattr(fn.args, "posonlyargs", []))
                + list(fn.args.args)
            )
        ]
        if not params:
            continue
        index = {name: i for i, name in enumerate(params)}
        for node in au.walk_shallow(fn):
            if not isinstance(node, ast.Compare):
                continue
            if not all(
                isinstance(op, (ast.Is, ast.IsNot, ast.Eq, ast.NotEq))
                for op in node.ops
            ):
                continue
            operands = [node.left] + list(node.comparators)
            attrs = set()
            for o in operands:
                # a bare `self.X`, or the registry-read shape
                # `self.X.get(...)` (comparing the snapshot against a
                # FRESH read of the same registry)
                a = _self_attr(o)
                if a is None and isinstance(o, ast.Call):
                    func = o.func
                    if (
                        isinstance(func, ast.Attribute)
                        and func.attr == "get"
                    ):
                        a = _self_attr(func.value)
                if a is not None:
                    attrs.add(f"self.{a}")
            if not attrs:
                continue
            for o in operands:
                if isinstance(o, ast.Name) and o.id in index:
                    out.setdefault(
                        (qual, index[o.id]), set()
                    ).update(attrs)
    return out


class _Tracked:
    __slots__ = ("source", "line", "pending_since", "dead")

    def __init__(self, source: str, line: int) -> None:
        self.source = source          # e.g. "self._secure"
        self.line = line              # snapshot line
        self.pending_since: Optional[int] = None  # line of staling await
        self.dead = False             # already reported / reassigned

    def clone(self) -> "_Tracked":
        tr = _Tracked(self.source, self.line)
        tr.pending_since = self.pending_since
        tr.dead = self.dead
        return tr


def _terminates(block: List[ast.stmt]) -> bool:
    """The block can never fall through to the statement after its
    ``if``: its last statement returns/raises/continues/breaks."""
    return bool(block) and isinstance(block[-1], _TERMINATORS)


def _block_suspends(stmts: List[ast.stmt]) -> bool:
    """The block contains a suspension point outside nested defs."""
    todo: List[ast.AST] = list(stmts)
    while todo:
        n = todo.pop()
        if isinstance(n, _FUNCS):
            continue
        if isinstance(n, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
            return True
        todo.extend(ast.iter_child_nodes(n))
    return False


@register
class StaleSnapshotChecker(Checker):
    rule = "BTL003"
    title = "shared-state snapshot used across an await without re-check"

    def applies_to(self, ctx: CheckContext) -> bool:
        return "server" in ctx.parts

    def check(self, ctx: CheckContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        mutable_attrs = _collect_mutable_attrs(ctx.tree)
        helper_sources = _collect_helper_sources(ctx.tree, mutable_attrs)
        revalidators = _collect_revalidators(ctx.tree)
        for qual, cls, fn in au.iter_function_defs(ctx.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            self._check_function(
                fn, cls, mutable_attrs.get(cls, set()),
                helper_sources, revalidators, findings, ctx,
            )
        return findings

    # ------------------------------------------------------------------
    def _check_function(
        self, fn, cls, attrs, helper_sources, revalidators, findings, ctx
    ) -> None:

        loop_repass = [0]
        flagged_sites: Set[Tuple[int, int, str]] = set()

        def flag(name: str, tr: _Tracked, node: ast.AST) -> None:
            tr.dead = True
            site = (node.lineno, node.col_offset, name)
            if site in flagged_sites:
                return  # already reported on an earlier loop pass
            flagged_sites.add(site)
            carried = (
                " (loop-carried: the snapshot is taken once but the "
                "loop body suspends, so every iteration after the "
                "first acts on a stale value)"
                if loop_repass[0] else ""
            )
            findings.append(
                Finding(
                    self.rule, ctx.path, node.lineno, node.col_offset,
                    f"`{name}` snapshots `{tr.source}` (line {tr.line}) "
                    f"and is used here after the await on line "
                    f"{tr.pending_since}: the registry may have been "
                    f"re-keyed during the suspension — re-read it or "
                    f"identity-check (`{tr.source} ... is {name}`) "
                    f"before trusting the snapshot" + carried,
                    also_lines=tuple(
                        x for x in (tr.line, tr.pending_since)
                        if x is not None
                    ),
                )
            )

        def flag_same_stmt(name: str, tr: _Tracked, node: ast.AST) -> None:
            tr.dead = True
            site = (node.lineno, node.col_offset, name)
            if site in flagged_sites:
                return
            flagged_sites.add(site)
            findings.append(
                Finding(
                    self.rule, ctx.path, node.lineno, node.col_offset,
                    f"`{name}` snapshots `{tr.source}` (line {tr.line}) "
                    f"and is mutated with the result of an await in the "
                    f"same statement: the receiver was read before the "
                    f"suspension, so the write can land in a dead object "
                    f"if the registry was re-keyed — await into a local, "
                    f"identity-check the snapshot, then commit",
                    also_lines=(tr.line,),
                )
            )

        def exprs_of(stmt) -> List[ast.AST]:
            """Header expressions of a statement (not child statements,
            not nested function bodies)."""
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

        def walk_expr(e) -> Iterable[ast.AST]:
            todo = [e]
            while todo:
                n = todo.pop()
                yield n
                if not isinstance(n, _FUNCS):
                    todo.extend(ast.iter_child_nodes(n))

        def revalidated_names(nodes: List[ast.AST]) -> Set[str]:
            """Names identity-compared (is/is not) against a non-None
            operand anywhere in these expressions."""
            out: Set[str] = set()
            for e in nodes:
                for n in walk_expr(e):
                    if not isinstance(n, ast.Compare):
                        continue
                    if not all(
                        isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops
                    ):
                        continue
                    operands = [n.left] + list(n.comparators)
                    non_none = [
                        o for o in operands
                        if not (
                            isinstance(o, ast.Constant) and o.value is None
                        )
                    ]
                    if len(non_none) < 2:
                        continue  # `x is None` checks emptiness, not age
                    for o in operands:
                        if isinstance(o, ast.Name):
                            out.add(o.id)
            return out

        def delegated_revalidations(
            nodes: List[ast.AST],
        ) -> Dict[str, Set[str]]:
            """``{name: {sources}}`` for snapshot names passed into a
            helper parameter that the helper compares against that
            source — the call IS the re-check."""
            out: Dict[str, Set[str]] = {}
            for e in nodes:
                for n in walk_expr(e):
                    if not isinstance(n, ast.Call):
                        continue
                    qual = au.resolve_local_call(n, cls)
                    if qual is None:
                        continue
                    # self.helper(a) binds a to the param AFTER self
                    offset = (
                        1 if isinstance(n.func, ast.Attribute) else 0
                    )
                    for i, arg in enumerate(n.args):
                        if not isinstance(arg, ast.Name):
                            continue
                        sources = revalidators.get((qual, i + offset))
                        if sources:
                            out.setdefault(arg.id, set()).update(sources)
            return out

        def compare_nodes(nodes: List[ast.AST]) -> List[ast.AST]:
            comps = []
            for e in nodes:
                for n in walk_expr(e):
                    if isinstance(n, ast.Compare):
                        comps.append(n)
            return comps

        def uses_of(name: str, nodes: List[ast.AST]) -> List[ast.AST]:
            """Load-context occurrences of ``name`` outside identity
            compares (the compare IS the revalidation, not a use)."""
            comps = compare_nodes(nodes)
            in_comp = {
                id(n) for c in comps for n in ast.walk(c)
            }
            hits = []
            for e in nodes:
                for n in walk_expr(e):
                    if (
                        isinstance(n, ast.Name)
                        and n.id == name
                        and id(n) not in in_comp
                        and isinstance(n.ctx, ast.Load)
                    ):
                        hits.append(n)
            return hits

        def has_await(nodes: List[ast.AST]) -> Optional[ast.AST]:
            for e in nodes:
                for n in walk_expr(e):
                    if isinstance(n, ast.Await):
                        return n
            return None

        def receiver_root(expr) -> Optional[str]:
            root = expr
            while isinstance(root, (ast.Attribute, ast.Subscript)):
                root = root.value
            return root.id if isinstance(root, ast.Name) else None

        def same_stmt_commit(stmt, tracked) -> Optional[Tuple[str, ast.AST]]:
            """``st[...].xxx(await ...)`` / ``st[...] = await ...``:
            snapshot receiver mutated with an awaited value."""
            for e in exprs_of(stmt):
                for n in walk_expr(e):
                    if isinstance(n, ast.Call) and isinstance(
                        n.func, ast.Attribute
                    ):
                        root = receiver_root(n.func.value)
                        if root in tracked and any(
                            isinstance(x, ast.Await)
                            for a in (n.args + [k.value for k in n.keywords])
                            for x in walk_expr(a)
                        ):
                            return root, n
            if isinstance(stmt, ast.Assign) and any(
                isinstance(x, ast.Await) for x in walk_expr(stmt.value)
            ):
                for t in stmt.targets:
                    if isinstance(t, (ast.Subscript, ast.Attribute)):
                        root = receiver_root(t)
                        if root in tracked:
                            return root, stmt
            return None

        def snapshot_bindings(stmt) -> List[Tuple[str, str, int]]:
            """``(name, source, line)`` for snapshot assignments in the
            statement — plain assigns and walrus expressions."""
            out = []
            if isinstance(stmt, ast.Assign):
                src = _shared_read_source(
                    stmt.value, attrs, helper_sources, cls
                )
                if src is not None:
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            out.append((t.id, src, stmt.lineno))
            for e in exprs_of(stmt):
                for n in walk_expr(e):
                    if isinstance(n, ast.NamedExpr) and isinstance(
                        n.target, ast.Name
                    ):
                        src = _shared_read_source(
                            n.value, attrs, helper_sources, cls
                        )
                        if src is not None:
                            out.append((n.target.id, src, n.lineno))
            return out

        def assigned_names(stmt) -> Set[str]:
            out: Set[str] = set()
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                if isinstance(stmt.target, ast.Name):
                    out.add(stmt.target.id)
            return out

        def merge(
            arm_states: List[Tuple[Dict[str, _Tracked], bool]],
        ) -> Dict[str, _Tracked]:
            """Join the snapshot states of the arms that can fall
            through; a terminating arm contributes nothing (its
            staleness dies with it)."""
            live = [st for st, ends in arm_states if not ends]
            if not live:
                return {}
            names = set(live[0])
            for st in live[1:]:
                names &= set(st)
            out: Dict[str, _Tracked] = {}
            for name in names:
                trs = [st[name] for st in live]
                if len({tr.source for tr in trs}) != 1:
                    continue
                m = trs[0].clone()
                for tr in trs[1:]:
                    if tr.dead:
                        m.dead = True
                    if m.pending_since is None:
                        m.pending_since = tr.pending_since
                    m.line = min(m.line, tr.line)
                out[name] = m
            return out

        def visit(stmts, tracked: Dict[str, _Tracked]) -> None:
            for stmt in stmts:
                if isinstance(stmt, _FUNCS + (ast.ClassDef,)):
                    continue
                header = exprs_of(stmt)

                # 1. stale uses (statement-order approximation: the
                #    header of this statement evaluates before any
                #    await IN it suspends, so check uses first).  An
                #    identity re-check in an `if` guard whose arm
                #    terminates (`if self._round is not r: return ...`)
                #    is the full fix idiom — the author installed the
                #    protocol, so STOP tracking the snapshot; a bare
                #    compare merely resets the pending await.
                delegated = delegated_revalidations(header)
                reval = revalidated_names(header)
                guard_installed = isinstance(stmt, ast.If) and (
                    _terminates(stmt.body) or _terminates(stmt.orelse)
                )
                validated: List[str] = []
                for name, tr in list(tracked.items()):
                    if name in reval and guard_installed:
                        validated.append(name)
                        continue
                    if tr.dead or tr.pending_since is None:
                        continue
                    if name in reval:
                        tr.pending_since = None
                        continue
                    if tr.source in delegated.get(name, ()):
                        tr.pending_since = None  # helper does the check
                        continue
                    hits = uses_of(name, header)
                    if hits:
                        flag(name, tr, hits[0])
                for name in validated:
                    tracked.pop(name, None)

                # 2. same-statement commit-through-await pattern
                commit = same_stmt_commit(stmt, tracked)
                if commit is not None:
                    name, node = commit
                    tr = tracked[name]
                    if not tr.dead:
                        flag_same_stmt(name, tr, node)

                # 3. a suspension in this statement stales every
                #    snapshot: an await expression, or entering an
                #    async-with/async-for header (their __aenter__ /
                #    __anext__ suspend too)
                aw = has_await(header)
                line: Optional[int] = aw.lineno if aw is not None else None
                if line is None and isinstance(
                    stmt, (ast.AsyncWith, ast.AsyncFor)
                ):
                    line = stmt.lineno
                if line is not None:
                    for tr in tracked.values():
                        if not tr.dead and tr.pending_since is None:
                            tr.pending_since = line

                # 4. (re)bindings: fresh snapshots reset, anything else
                #    stops tracking the name
                fresh = snapshot_bindings(stmt)
                for name, src, sline in fresh:
                    tracked[name] = _Tracked(src, sline)
                for name in assigned_names(stmt) - {
                    n for n, _s, _l in fresh
                }:
                    tracked.pop(name, None)

                # 5. child blocks: `if` arms fork and merge (branch-
                #    sensitive; a terminating arm's staleness never
                #    reaches the fall-through), everything else visits
                #    sequentially (effects union — conservative)
                if isinstance(stmt, ast.If):
                    arms: List[Tuple[Dict[str, _Tracked], bool]] = []
                    for block in (stmt.body, stmt.orelse):
                        st = {
                            name: tr.clone()
                            for name, tr in tracked.items()
                        }
                        visit(block, st)
                        arms.append((st, _terminates(block)))
                    merged = merge(arms)
                    tracked.clear()
                    tracked.update(merged)
                    continue
                # loops whose body suspends: visit the body a second
                # time with iteration 1's end state — a snapshot hoisted
                # above the loop is fresh on iteration 1 but stale on
                # every later one (the repass marks it pending at the
                # loop header and re-runs the body with loop-carried
                # wording)
                if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
                    visit(stmt.body, tracked)
                    if isinstance(stmt, ast.AsyncFor) or _block_suspends(
                        stmt.body
                    ):
                        for tr in tracked.values():
                            if not tr.dead and tr.pending_since is None:
                                tr.pending_since = stmt.lineno
                        loop_repass[0] += 1
                        try:
                            visit(stmt.body, tracked)
                        finally:
                            loop_repass[0] -= 1
                    visit(stmt.orelse, tracked)
                    continue
                for block in (
                    getattr(stmt, "body", None),
                    getattr(stmt, "orelse", None),
                    getattr(stmt, "finalbody", None),
                ):
                    if isinstance(block, list):
                        visit(block, tracked)
                for handler in getattr(stmt, "handlers", []) or []:
                    visit(handler.body, tracked)

        visit(fn.body, {})
