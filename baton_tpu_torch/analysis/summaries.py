"""Bottom-up fixpoint function summaries over the project call graph.

The per-function AST walks in the checkers see one hop; this module
sees the whole program.  For every function it computes a
:class:`FnSummary` — the blocking primitives it may execute, the locks
it may acquire, the locks it holds across an await, the network awaits
it may perform, which ``self.*`` attributes it reads and mutates, and
its parameter->return taint transfer — first locally (one shallow AST
walk per function, the part that is cacheable per file content hash),
then propagated bottom-up over the call graph: strongly connected
components are condensed (Tarjan) and processed in reverse topological
order, iterating each SCC's members to a fixpoint, so mutual recursion
converges and every rule built on summaries is genuinely multi-hop.

Propagation follows execution, not just reference: an edge from a
*sync* caller into an ``async def`` does not propagate effects (the
call merely builds a coroutine object), while async->async, async->sync
and sync->sync edges do.  ``self.*`` effect sets propagate only over
``self.``/``super()`` edges — a method called on some *other* object
mutates that object's state, not the caller's.

Every site a summary carries keeps the shortest witness call chain
(qualnames below the summarized function), so checkers can report the
path a hazard travels across modules, not just its endpoint.

On top of the per-function facts this module roots the call graph at
real runtime *entry points* (route registrations, ``PeriodicTask`` and
loop callbacks, ``to_thread``/executor/``threading.Thread`` dispatch)
and propagates an execution-context lattice — ``loop``, ``thread``, or
both — along execution edges (:class:`CtxWitness`).  Context-sensitive
rules (BTL001/BTL005/BTL006/BTL007) ask :meth:`Summaries.context_kinds`
which worlds a function can run in, with a witness chain back to the
registration site for the diagnostic.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from baton_tpu_torch.analysis import _astutil as au
from baton_tpu_torch.analysis.callgraph import CallEdge, CallGraph
from baton_tpu_torch.analysis.project import ModuleInfo, Project

__all__ = [
    "BLOCKED_DOTTED",
    "BLOCKED_METHODS",
    "BLOCKED_MODULE_PREFIXES",
    "BLOCKED_NAMES",
    "CtxWitness",
    "FnSummary",
    "LocalFacts",
    "NETWORK_ATTRS",
    "NETWORK_DOTTED",
    "Site",
    "Summaries",
    "blocked_reason",
    "is_network_call",
    "lock_identity",
]

# -- blocking primitives (shared with BTL001) --------------------------
# fully-resolved dotted names that block the loop
BLOCKED_DOTTED = {
    "time.sleep": "time.sleep() blocks the event loop; await asyncio.sleep",
    "pickle.load": "pickle.load() is blocking CPU/IO work",
    "pickle.loads": "pickle.loads() is blocking CPU work",
    "jax.device_get": "jax.device_get() blocks on device transfer",
}
# any call into these modules blocks (compression is pure CPU burn)
BLOCKED_MODULE_PREFIXES = ("zlib.",)
# bare-name builtins
BLOCKED_NAMES = {"open": "open() is blocking file I/O"}
# method attributes that block regardless of receiver type
BLOCKED_METHODS = {
    "block_until_ready": ".block_until_ready() blocks on device compute",
    "read_text": "file I/O (.read_text) blocks the event loop",
    "write_text": "file I/O (.write_text) blocks the event loop",
    "read_bytes": "file I/O (.read_bytes) blocks the event loop",
    "write_bytes": "file I/O (.write_bytes) blocks the event loop",
}


def blocked_reason(call: ast.Call) -> Optional[Tuple[str, str]]:
    """``(display_name, reason)`` when the call is a blocking
    primitive, else None."""
    name = au.call_name(call)
    if name is not None:
        if name in BLOCKED_DOTTED:
            return name, BLOCKED_DOTTED[name]
        for prefix in BLOCKED_MODULE_PREFIXES:
            if name.startswith(prefix):
                return name, f"{prefix}* compression is blocking CPU work"
        if name in BLOCKED_NAMES:
            return name, BLOCKED_NAMES[name]
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in BLOCKED_METHODS:
        display = name if name is not None else f"<expr>.{func.attr}"
        return display, BLOCKED_METHODS[func.attr]
    return None


# -- network/queue await primitives (shared with BTL002) ---------------
# attribute names that mean "this await leaves the process" (HTTP verb,
# body read, queue hand-off) — receiver-agnostic by design: sessions,
# responses and queues go by many names
NETWORK_ATTRS = {
    "get", "post", "put", "patch", "delete", "head", "request",
    "read", "text", "json", "recv", "receive", "send", "send_json",
    "fetch", "connect", "join", "drain",
}
NETWORK_DOTTED = {"asyncio.sleep"}


def is_network_call(call: ast.Call) -> bool:
    dotted = au.call_name(call)
    if dotted in NETWORK_DOTTED:
        return True
    return (
        isinstance(call.func, ast.Attribute)
        and call.func.attr in NETWORK_ATTRS
    )


# -- lock identity -----------------------------------------------------
def lock_identity(
    expr_or_name,
    class_name: Optional[str],
    mod: ModuleInfo,
    project: Optional[Project] = None,
) -> Optional[str]:
    """Normalized project-wide lock identity for an ``async with``
    context expression (or its pre-extracted dotted name), or None when
    the context is not a lock.

    A "lock" is any context whose name ends with ``lock`` or ``mutex``
    — naming convention as lint contract.  Identities unify where
    references can: ``self._x_lock`` unifies under the ROOT class of
    the enclosing class's known inheritance chain (so the same
    attribute acquired in a base method and a subclass override is one
    lock), a module-global is ``pkg.mod.x_lock`` from its home module
    or through any import alias.  Locks reached through other objects'
    attributes stay module-local (no type inference)."""
    if isinstance(expr_or_name, str):
        name: Optional[str] = expr_or_name
    else:
        name = au.dotted_name(expr_or_name)
    if name is None:
        return None
    leaf = name.rsplit(".", 1)[-1].lower()
    if not (leaf.endswith("lock") or leaf.endswith("mutex")):
        return None
    root, _, rest = name.partition(".")
    if root in ("self", "cls") and rest and class_name is not None:
        owner = class_name
        if project is not None:
            owner = project.root_class_name(mod, class_name) or class_name
        return f"{owner}.{rest}"
    if rest:
        target = mod.imports.get(root)
        if target is not None:
            # module-global lock referenced through an import alias:
            # unify with its home-module bare name
            return f"{target}.{rest}"
        return f"{mod.name}:{name}"  # some other object's attribute
    return f"{mod.name}.{name}"


# -- self.* attribute access extraction --------------------------------
_SELF_MUTATORS = {
    "append", "extend", "insert", "add", "update", "setdefault", "pop",
    "popitem", "remove", "discard", "clear", "set",
}

# -- execution-context registration tables ------------------------------
# aiohttp route table: method attr -> positional index of the handler
_ROUTE_REGISTRARS = {
    "add_get": 1, "add_post": 1, "add_put": 1, "add_patch": 1,
    "add_delete": 1, "add_head": 1, "add_route": 2,
}
# loop-callback registrars: the referenced callable runs ON the loop
_LOOP_CB_REGISTRARS = {
    "call_soon": 0, "call_soon_threadsafe": 0, "add_done_callback": 0,
    "call_later": 1, "call_at": 1,
}
# thread dispatchers: the referenced callable runs OFF the loop
_THREAD_REGISTRARS = {
    "to_thread": 0,
    "submit": 0,
    "run_in_executor": 1,
    # the ingest pipeline's own executor API (server/ingest.py): both
    # hand the callable to a ThreadPoolExecutor lane
    "submit_decode": 0,
    "submit_fold": 1,
}

# asyncio primitives a `self.X = asyncio.Y()` assignment declares
_ASYNCIO_FACTORIES = {
    "Lock", "Event", "Condition", "Semaphore", "BoundedSemaphore",
    "Queue", "LifoQueue", "PriorityQueue", "Future",
}
# non-threadsafe methods of those primitives (their sync APIs — the
# ones a worker thread CAN call, incorrectly; awaited APIs need a loop)
_ASYNCIO_TOUCH_METHODS = {
    "set", "clear", "put_nowait", "get_nowait", "set_result",
    "set_exception", "release", "notify", "notify_all",
}
# loop-affine methods regardless of receiver attr bookkeeping
_LOOP_AFFINE_METHODS = {"call_soon", "call_later", "call_at", "create_task"}


def _callable_ref(expr: ast.AST) -> Optional[str]:
    """A callable *reference* expression -> raw dotted ref string
    (``functools.partial(f, ...)`` unwraps to ``f``)."""
    d = au.dotted_name(expr)
    if d is not None:
        return d
    if isinstance(expr, ast.Call):
        cn = au.call_name(expr)
        if cn is not None and cn.rsplit(".", 1)[-1] == "partial" and expr.args:
            return _callable_ref(expr.args[0])
    return None


def _alias_envs(tree: ast.Module) -> Dict[int, Dict[str, str]]:
    """Per function node (by ``id``): local names that are stable
    aliases of a bare ``self.X`` read (``r = self._round``), with the
    enclosing function's aliases inherited by nested defs — the channel
    through which a fold-lane closure mutates instance state.  A name
    also bound to anything else anywhere in the function is ambiguous
    and dropped."""
    envs: Dict[int, Dict[str, str]] = {}

    def own_bindings(fn) -> Tuple[Dict[str, str], set]:
        aliases: Dict[str, str] = {}
        shadowed: set = set(au.param_names(fn))
        for n in au.walk_shallow(fn):
            if isinstance(n, ast.Assign):
                src = None
                v = n.value
                if (
                    isinstance(v, ast.Attribute)
                    and isinstance(v.value, ast.Name)
                    and v.value.id in ("self", "cls")
                ):
                    src = v.attr
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        if src is not None and t.id not in shadowed:
                            if aliases.get(t.id, src) != src:
                                shadowed.add(t.id)
                            else:
                                aliases[t.id] = src
                        else:
                            shadowed.add(t.id)
                    else:
                        # tuple/list unpacking rebinds its Store names;
                        # a store THROUGH the name (r.x[k] = v) does not
                        # rebind r itself
                        for e in ast.walk(t):
                            if isinstance(e, ast.Name) and isinstance(
                                e.ctx, ast.Store
                            ):
                                shadowed.add(e.id)
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                if isinstance(n.target, ast.Name):
                    shadowed.add(n.target.id)
            elif isinstance(n, (ast.For, ast.AsyncFor)):
                for e in ast.walk(n.target):
                    if isinstance(e, ast.Name):
                        shadowed.add(e.id)
            elif isinstance(n, (ast.With, ast.AsyncWith)):
                for item in n.items:
                    if item.optional_vars is not None:
                        for e in ast.walk(item.optional_vars):
                            if isinstance(e, ast.Name):
                                shadowed.add(e.id)
            elif isinstance(n, ast.NamedExpr):
                if isinstance(n.target, ast.Name):
                    shadowed.add(n.target.id)
        return (
            {k: v for k, v in aliases.items() if k not in shadowed},
            shadowed,
        )

    def walk(node: ast.AST, inherited: Dict[str, str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                own, shadowed = own_bindings(child)
                env = {
                    k: v for k, v in inherited.items()
                    if k not in shadowed and k not in own
                }
                env.update(own)
                envs[id(child)] = env
                walk(child, env)
            elif isinstance(child, ast.ClassDef):
                walk(child, {})
            else:
                walk(child, inherited)

    walk(tree, {})
    return envs


def _scope_names(fn) -> Tuple[set, set, set]:
    """``(store_locals, all_locals, global_decls)`` for one function:
    names bound by Name-store/params, the same plus nested-def names,
    and names declared ``global``."""
    gdecl: set = set()
    store_locals: set = set(au.param_names(fn))
    def_names: set = set()
    for n in au.walk_shallow(fn):
        if isinstance(n, ast.Global):
            gdecl.update(n.names)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            def_names.add(n.name)
        elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            store_locals.add(n.id)
    store_locals -= gdecl
    return store_locals, store_locals | def_names, gdecl


def _self_attr_of(node: ast.AST) -> Optional[str]:
    """``self.A``/``cls.A`` (possibly deeper: ``self.A.b``) -> ``A``."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in ("self", "cls")
        ):
            return node.attr
        node = node.value
    return None


# -- local facts (cacheable) -------------------------------------------
Site = Tuple[int, int]  # (line, col) within the function's own module


@dataclasses.dataclass
class LocalFacts:
    """Per-function facts derived ONLY from that function's AST —
    content-addressable, hence what ``.batonlint_cache.json`` stores."""

    qual: str
    class_name: Optional[str]
    is_async: bool
    has_await: bool
    # ((line, col, display, reason), ...)
    blocking: Tuple[Tuple[int, int, str, str], ...] = ()
    # ((raw_dotted, line), ...) raw lock exprs from `async with`
    acquires_raw: Tuple[Tuple[str, int], ...] = ()
    # raw lock exprs held lexically at >=1 await
    awaits_held_raw: Tuple[str, ...] = ()
    # ((line, col, display), ...) awaited network/queue primitives
    network_awaits: Tuple[Tuple[int, int, str], ...] = ()
    # ((line, col, (raw_locks...)), ...) locks held at each call site
    held_at_call: Tuple[Tuple[int, int, Tuple[str, ...]], ...] = ()
    self_reads: Tuple[str, ...] = ()
    self_writes: Tuple[str, ...] = ()
    # ((needs_taint, kind, line, col, message), ...) host ops that are
    # hazards when this function executes under a jit/shard_map trace
    taint_ops: Tuple[Tuple[bool, str, int, int, str], ...] = ()
    returns_param_taint: bool = False
    # -- execution-context facts (also per-file, also cacheable) -------
    # ((attr, line, col, is_write, (sync_locks...), (async_locks...)),
    #  ...) instance-attribute accesses incl. through self-aliases
    attr_accesses: Tuple[
        Tuple[str, int, int, bool, Tuple[str, ...], Tuple[str, ...]], ...
    ] = ()
    # ((name, line, col, is_write, (sync_locks...)), ...) module-global
    # accesses (reads of module names, `global`-declared / container
    # mutation writes)
    global_accesses: Tuple[
        Tuple[str, int, int, bool, Tuple[str, ...]], ...
    ] = ()
    # self.X attrs assigned an asyncio primitive in this function
    asyncio_defs: Tuple[str, ...] = ()
    # ((attr_or_recv, line, col, method), ...) non-threadsafe asyncio
    # API touches ("<loop>" recv for call_soon/create_task et al.)
    asyncio_touches: Tuple[Tuple[str, int, int, str], ...] = ()
    # ((kind, ref, line), ...) entry-point registrations made HERE:
    # kind in {"route", "loop_cb", "thread"}, ref is the raw callable
    entry_regs: Tuple[Tuple[str, str, int], ...] = ()
    # bare/dotted names referenced outside call position (callbacks
    # passed by value) — dead-code roots
    name_refs: Tuple[str, ...] = ()

    def to_json(self) -> dict:
        return {
            "qual": self.qual,
            "class_name": self.class_name,
            "is_async": self.is_async,
            "has_await": self.has_await,
            "blocking": [list(x) for x in self.blocking],
            "acquires_raw": [list(x) for x in self.acquires_raw],
            "awaits_held_raw": list(self.awaits_held_raw),
            "network_awaits": [list(x) for x in self.network_awaits],
            "held_at_call": [
                [line, col, list(locks)]
                for line, col, locks in self.held_at_call
            ],
            "self_reads": list(self.self_reads),
            "self_writes": list(self.self_writes),
            "taint_ops": [list(x) for x in self.taint_ops],
            "returns_param_taint": self.returns_param_taint,
            "attr_accesses": [
                [a, ln, c, w, list(s), list(al)]
                for a, ln, c, w, s, al in self.attr_accesses
            ],
            "global_accesses": [
                [a, ln, c, w, list(s)]
                for a, ln, c, w, s in self.global_accesses
            ],
            "asyncio_defs": list(self.asyncio_defs),
            "asyncio_touches": [list(x) for x in self.asyncio_touches],
            "entry_regs": [list(x) for x in self.entry_regs],
            "name_refs": list(self.name_refs),
        }

    @classmethod
    def from_json(cls, data: dict) -> "LocalFacts":
        return cls(
            qual=data["qual"],
            class_name=data.get("class_name"),
            is_async=bool(data["is_async"]),
            has_await=bool(data["has_await"]),
            blocking=tuple(
                (int(a), int(b), str(c), str(d))
                for a, b, c, d in data.get("blocking", [])
            ),
            acquires_raw=tuple(
                (str(a), int(b)) for a, b in data.get("acquires_raw", [])
            ),
            awaits_held_raw=tuple(
                str(x) for x in data.get("awaits_held_raw", [])
            ),
            network_awaits=tuple(
                (int(a), int(b), str(c))
                for a, b, c in data.get("network_awaits", [])
            ),
            held_at_call=tuple(
                (int(line), int(col), tuple(str(x) for x in locks))
                for line, col, locks in data.get("held_at_call", [])
            ),
            self_reads=tuple(str(x) for x in data.get("self_reads", [])),
            self_writes=tuple(str(x) for x in data.get("self_writes", [])),
            taint_ops=tuple(
                (bool(a), str(b), int(c), int(d), str(e))
                for a, b, c, d, e in data.get("taint_ops", [])
            ),
            returns_param_taint=bool(data.get("returns_param_taint", False)),
            attr_accesses=tuple(
                (str(a), int(ln), int(c), bool(w),
                 tuple(str(x) for x in s), tuple(str(x) for x in al))
                for a, ln, c, w, s, al in data.get("attr_accesses", [])
            ),
            global_accesses=tuple(
                (str(a), int(ln), int(c), bool(w),
                 tuple(str(x) for x in s))
                for a, ln, c, w, s in data.get("global_accesses", [])
            ),
            asyncio_defs=tuple(
                str(x) for x in data.get("asyncio_defs", [])
            ),
            asyncio_touches=tuple(
                (str(a), int(b), int(c), str(d))
                for a, b, c, d in data.get("asyncio_touches", [])
            ),
            entry_regs=tuple(
                (str(a), str(b), int(c))
                for a, b, c in data.get("entry_regs", [])
            ),
            name_refs=tuple(str(x) for x in data.get("name_refs", [])),
        )


_SUSPENDERS = (ast.Await, ast.AsyncFor, ast.AsyncWith)


def compute_local_facts(mod: ModuleInfo) -> Dict[str, LocalFacts]:
    """``{qualname: LocalFacts}`` for every function in the module."""
    envs = _alias_envs(mod.tree)
    out: Dict[str, LocalFacts] = {}
    for fn_info in mod.functions.values():
        out[fn_info.qualname] = _local_facts_for(
            fn_info, envs.get(id(fn_info.node), {}), mod
        )
    return out


def _local_facts_for(
    fn_info, alias_env: Dict[str, str], mod: ModuleInfo
) -> LocalFacts:
    node = fn_info.node
    is_async = isinstance(node, ast.AsyncFunctionDef)
    blocking: List[Tuple[int, int, str, str]] = []
    acquires_raw: List[Tuple[str, int]] = []
    awaits_held_raw: set = set()
    network_awaits: List[Tuple[int, int, str]] = []
    held_at_call: List[Tuple[int, int, Tuple[str, ...]]] = []
    self_reads: set = set()
    self_writes: set = set()
    has_await = False

    attr_accesses: List[
        Tuple[str, int, int, bool, Tuple[str, ...], Tuple[str, ...]]
    ] = []
    attr_seen: set = set()
    global_accesses: List[Tuple[str, int, int, bool, Tuple[str, ...]]] = []
    global_seen: set = set()
    asyncio_defs: set = set()
    asyncio_touches: List[Tuple[str, int, int, str]] = []
    entry_regs: List[Tuple[str, str, int]] = []
    name_refs: set = set()

    store_locals, all_locals, global_decls = _scope_names(node)
    mod_globals = mod.global_names

    def is_lock_name(name: Optional[str]) -> bool:
        if name is None:
            return False
        leaf = name.rsplit(".", 1)[-1].lower()
        return leaf.endswith("lock") or leaf.endswith("mutex")

    def norm_dotted(expr: ast.AST) -> Optional[str]:
        """Dotted name with self-aliases rewritten back through self."""
        d = au.dotted_name(expr)
        if d is None:
            return None
        root, _, rest = d.partition(".")
        if root in alias_env:
            base = f"self.{alias_env[root]}"
            return f"{base}.{rest}" if rest else base
        return d

    def access_attr_of(n: ast.AST) -> Optional[str]:
        """Full dotted instance path of an access chain, through
        aliases: ``self.A.b`` -> ``A.b``; ``r.acc`` with
        ``r = self._round`` -> ``_round.acc``; subscripts are
        transparent (``r.tbl[k]`` writes into the object at
        ``_round.tbl``).  Leaf-path granularity lets a fold-lane write
        to ``_round.acc`` coexist with loop-side bookkeeping on
        ``_round.contributors`` — disjoint leaves never race."""
        parts: List[str] = []
        while isinstance(n, (ast.Attribute, ast.Subscript)):
            if isinstance(n, ast.Attribute):
                parts.append(n.attr)
            n = n.value
        if not isinstance(n, ast.Name):
            return None
        if n.id in ("self", "cls"):
            pass
        elif n.id in alias_env:
            parts.append(alias_env[n.id])
        else:
            return None
        if not parts:
            return None
        return ".".join(reversed(parts))

    def global_root_of(n: ast.AST) -> Optional[str]:
        """Module-global root name of an access chain, or None."""
        while isinstance(n, (ast.Attribute, ast.Subscript)):
            n = n.value
        if (
            isinstance(n, ast.Name)
            and n.id in mod_globals
            and n.id not in all_locals
        ):
            return n.id
        return None

    def record_attr(
        attr: str, n: ast.AST, is_write: bool,
        sheld: Tuple[str, ...], aheld: Tuple[str, ...],
    ) -> None:
        key = (attr, is_write, sheld, aheld)
        if key in attr_seen:
            return
        attr_seen.add(key)
        attr_accesses.append(
            (attr, n.lineno, n.col_offset, is_write, sheld, aheld)
        )

    def record_global(
        name: str, n: ast.AST, is_write: bool, sheld: Tuple[str, ...]
    ) -> None:
        key = (name, is_write, sheld)
        if key in global_seen:
            return
        global_seen.add(key)
        global_accesses.append(
            (name, n.lineno, n.col_offset, is_write, sheld)
        )

    def record_entry(kind: str, expr: ast.AST, line: int) -> None:
        ref = _callable_ref(expr)
        if ref is not None:
            entry_regs.append((kind, ref, line))

    def scan_call(
        n: ast.Call, sheld: Tuple[str, ...], aheld: Tuple[str, ...]
    ) -> None:
        """Entry-point registrations + asyncio touches at one call."""
        func = n.func
        leaf = None
        if isinstance(func, ast.Attribute):
            leaf = func.attr
        elif isinstance(func, ast.Name):
            leaf = func.id
        cn = au.call_name(n)
        cleaf = cn.rsplit(".", 1)[-1] if cn else leaf
        if leaf in _ROUTE_REGISTRARS:
            idx = _ROUTE_REGISTRARS[leaf]
            if len(n.args) > idx:
                record_entry("route", n.args[idx], n.lineno)
        if leaf in _LOOP_CB_REGISTRARS:
            idx = _LOOP_CB_REGISTRARS[leaf]
            if len(n.args) > idx:
                record_entry("loop_cb", n.args[idx], n.lineno)
        if cleaf == "PeriodicTask" and n.args:
            record_entry("loop_cb", n.args[0], n.lineno)
        if leaf in _THREAD_REGISTRARS:
            idx = _THREAD_REGISTRARS[leaf]
            if len(n.args) > idx:
                record_entry("thread", n.args[idx], n.lineno)
        if cleaf == "Thread":
            for kw in n.keywords:
                if kw.arg == "target":
                    record_entry("thread", kw.value, n.lineno)
        if isinstance(func, ast.Attribute):
            if func.attr in _ASYNCIO_TOUCH_METHODS:
                recv = func.value
                attr = None
                if (
                    isinstance(recv, ast.Attribute)
                    and isinstance(recv.value, ast.Name)
                    and recv.value.id in ("self", "cls")
                ):
                    attr = recv.attr
                elif isinstance(recv, ast.Name) and recv.id in alias_env:
                    attr = alias_env[recv.id]
                if attr is not None:
                    asyncio_touches.append(
                        (attr, n.lineno, n.col_offset, func.attr)
                    )
            if func.attr in _LOOP_AFFINE_METHODS:
                asyncio_touches.append(
                    ("<loop>", n.lineno, n.col_offset, func.attr)
                )

    def scan_asyncio_def(n: ast.Assign) -> None:
        if not isinstance(n.value, ast.Call):
            return
        cn = au.call_name(n.value)
        if cn is None:
            return
        root, _, fleaf = cn.rpartition(".")
        is_factory = fleaf == "create_future" or (
            fleaf in _ASYNCIO_FACTORIES
            and (
                root == "asyncio"
                or (not root and mod.imports.get(fleaf, "").startswith(
                    "asyncio."
                ))
            )
        )
        if not is_factory:
            return
        for t in n.targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id in ("self", "cls")
            ):
                asyncio_defs.add(t.attr)

    def visit(
        n: ast.AST, aheld: Tuple[str, ...], sheld: Tuple[str, ...]
    ) -> None:
        nonlocal has_await
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            return  # separate execution context (to_thread closures)
        if isinstance(n, _SUSPENDERS):
            has_await = True
            awaits_held_raw.update(aheld)
        if isinstance(n, (ast.With, ast.AsyncWith)):
            is_sync_with = isinstance(n, ast.With)
            new_aheld, new_sheld = aheld, sheld
            header = [i.context_expr for i in n.items]
            for item in n.items:
                expr = item.context_expr
                raw = norm_dotted(expr)
                if is_lock_name(raw):
                    if is_sync_with:
                        new_sheld = new_sheld + (raw,)
                        visit(expr, aheld, sheld)
                    else:
                        acquires_raw.append((raw, n.lineno))
                        new_aheld = new_aheld + (raw,)
                        attr = access_attr_of(expr)
                        if attr is not None:
                            record_attr(attr, expr, False, sheld, aheld)
                elif isinstance(expr, ast.Call):
                    if is_sync_with:
                        reason = blocked_reason(expr)
                        if reason is not None:
                            blocking.append(
                                (expr.lineno, expr.col_offset,
                                 reason[0], reason[1])
                            )
                    elif is_network_call(expr):
                        network_awaits.append(
                            (expr.lineno, expr.col_offset,
                             au.call_name(expr)
                             or f"<expr>.{expr.func.attr}")
                        )
                    held_at_call.append(
                        (expr.lineno, expr.col_offset, aheld)
                    )
                    scan_call(expr, sheld, aheld)
                    for child in ast.iter_child_nodes(expr):
                        visit(child, aheld, sheld)
                else:
                    visit(expr, aheld, sheld)
            for child in ast.iter_child_nodes(n):
                if child in header or isinstance(child, ast.withitem):
                    continue
                visit(child, new_aheld, new_sheld)
            return
        if isinstance(n, ast.Await) and isinstance(n.value, ast.Call):
            if is_network_call(n.value):
                network_awaits.append(
                    (n.value.lineno, n.value.col_offset,
                     au.call_name(n.value)
                     or f"<expr>.{n.value.func.attr}")
                )
        if isinstance(n, ast.Call):
            reason = blocked_reason(n)
            if reason is not None:
                blocking.append(
                    (n.lineno, n.col_offset, reason[0], reason[1])
                )
            held_at_call.append((n.lineno, n.col_offset, aheld))
            scan_call(n, sheld, aheld)
        if isinstance(n, ast.Attribute):
            attr = (
                n.attr
                if isinstance(n.value, ast.Name)
                and n.value.id in ("self", "cls")
                else None
            )
            is_store = isinstance(n.ctx, (ast.Store, ast.Del))
            if attr is not None:
                if is_store:
                    self_writes.add(attr)
                else:
                    self_reads.add(attr)
                record_attr(attr, n, is_store, sheld, aheld)
            elif (
                isinstance(n.value, ast.Name)
                and n.value.id in alias_env
            ):
                path = access_attr_of(n)
                if path is not None:
                    record_attr(path, n, is_store, sheld, aheld)
            if (
                isinstance(n.ctx, ast.Load)
                and isinstance(n.value, ast.Name)
                and id(n) not in callfunc_ids
            ):
                base = n.value.id
                if base in ("self", "cls"):
                    name_refs.add(f"self.{n.attr}")
                elif base not in store_locals:
                    name_refs.add(f"{base}.{n.attr}")
        if isinstance(n, ast.Name):
            if (
                isinstance(n.ctx, ast.Load)
                and n.id in mod_globals
                and n.id not in all_locals
            ):
                record_global(n.id, n, False, sheld)
            elif isinstance(n.ctx, ast.Store) and n.id in global_decls:
                record_global(n.id, n, True, sheld)
            if (
                isinstance(n.ctx, ast.Load)
                and id(n) not in callfunc_ids
                and n.id not in store_locals
            ):
                name_refs.add(n.id)
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            if isinstance(n, ast.Assign):
                scan_asyncio_def(n)
            targets = list(
                n.targets if isinstance(n, ast.Assign) else [n.target]
            )
            # unpack `a, self.x = ...` so the attribute store is seen
            for t in list(targets):
                if isinstance(t, (ast.Tuple, ast.List)):
                    targets.extend(t.elts)
            for t in targets:
                if isinstance(t, (ast.Subscript, ast.Attribute)):
                    attr = _self_attr_of(t)
                    if attr is not None:
                        self_writes.add(attr)
                    aattr = access_attr_of(t)
                    if aattr is not None:
                        record_attr(aattr, t, True, sheld, aheld)
                    g = global_root_of(t)
                    if g is not None:
                        record_global(g, t, True, sheld)
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in _SELF_MUTATORS
        ):
            attr = _self_attr_of(n.func.value)
            if attr is not None:
                self_writes.add(attr)
            aattr = access_attr_of(n.func.value)
            if aattr is not None:
                record_attr(aattr, n, True, sheld, aheld)
            g = global_root_of(n.func.value)
            if g is not None:
                record_global(g, n, True, sheld)
        for child in ast.iter_child_nodes(n):
            visit(child, aheld, sheld)

    # call-position func Name/Attribute nodes: not "references by value"
    callfunc_ids: set = set()
    for sub in au.walk_shallow(node):
        if isinstance(sub, ast.Call) and isinstance(
            sub.func, (ast.Name, ast.Attribute)
        ):
            callfunc_ids.add(id(sub.func))

    for stmt in node.body:
        visit(stmt, (), ())

    taint_ops, returns_taint = _local_taint_facts(node)
    return LocalFacts(
        qual=fn_info.qualname,
        class_name=fn_info.class_name,
        is_async=is_async,
        has_await=has_await,
        blocking=tuple(blocking),
        acquires_raw=tuple(acquires_raw),
        awaits_held_raw=tuple(sorted(awaits_held_raw)),
        network_awaits=tuple(network_awaits),
        held_at_call=tuple(held_at_call),
        self_reads=tuple(sorted(self_reads)),
        self_writes=tuple(sorted(self_writes)),
        taint_ops=taint_ops,
        returns_param_taint=returns_taint,
        attr_accesses=tuple(attr_accesses),
        global_accesses=tuple(global_accesses),
        asyncio_defs=tuple(sorted(asyncio_defs)),
        asyncio_touches=tuple(asyncio_touches),
        entry_regs=tuple(entry_regs),
        name_refs=tuple(sorted(name_refs)),
    )


def _local_taint_facts(node) -> Tuple[tuple, bool]:
    """Host-side ops in this function that become hazards under a JAX
    trace, plus whether the return value derives from the parameters.

    ``needs_taint`` ops (casts, np materializers, ``.item()``) fire
    only when the function is CALLED with traced arguments; ``print``
    is a hazard in any traced execution (it runs at trace time only)."""
    tainted = au.param_names(node) - {"self", "cls"}
    body = node.body if isinstance(node.body, list) else [node.body]
    oracle = au.make_taint_oracle(tainted)
    for _ in range(10):
        if not au.propagate_taint(body, tainted, oracle):
            break

    ops: List[Tuple[bool, str, int, int, str]] = []
    returns_taint = False
    for stmt in body:
        for n in ast.walk(stmt):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(n, ast.Return) and n.value is not None:
                if oracle(n.value):
                    returns_taint = True
            if not isinstance(n, ast.Call):
                continue
            name = au.call_name(n)
            if name == "print":
                ops.append(
                    (False, "print", n.lineno, n.col_offset,
                     "print() runs at trace time only; use "
                     "jax.debug.print for per-call output")
                )
            elif (
                name in ("float", "int", "bool", "complex")
                and n.args
                and oracle(n.args[0])
            ):
                ops.append(
                    (True, "cast", n.lineno, n.col_offset,
                     f"{name}() on a value derived from the caller's "
                     f"traced arguments concretizes the tracer")
                )
            elif (
                isinstance(n.func, ast.Attribute)
                and n.func.attr in ("asarray", "array", "copy")
                and au.dotted_name(n.func.value) in ("np", "numpy")
                and n.args
                and oracle(n.args[0])
            ):
                ops.append(
                    (True, "materialize", n.lineno, n.col_offset,
                     f"np.{n.func.attr}() on a value derived from the "
                     f"caller's traced arguments materializes the "
                     f"tracer on host; use jnp.{n.func.attr}")
                )
            elif (
                isinstance(n.func, ast.Attribute)
                and n.func.attr == "item"
                and not n.args and not n.keywords
                and oracle(n.func.value)
            ):
                ops.append(
                    (True, "item", n.lineno, n.col_offset,
                     ".item() on a value derived from the caller's "
                     "traced arguments blocks on a device->host "
                     "transfer per trace")
                )
    return tuple(ops), returns_taint


# -- execution contexts ------------------------------------------------
@dataclasses.dataclass
class CtxWitness:
    """Why a function runs in a given execution context: the entry
    point that roots it plus the shortest call chain found from there.
    ``seed`` is the entry-point flavor ("async" | "route" | "loop_cb" |
    "thread"); ``server`` is whether the REGISTERING module is part of
    the server/obs runtime (scopes BTL005/BTL006 reporting)."""

    kind: str                  # "loop" | "thread"
    root_key: str              # function key of the entry point
    root_qual: str
    reason: str                # human wording for the entry point
    seed: str
    chain: Tuple[str, ...]     # qualnames from root (exclusive) to fn
    reg_path: str              # module registering the entry point
    reg_line: int
    server: bool


# -- fixpoint summaries ------------------------------------------------
@dataclasses.dataclass
class FnSummary:
    """What one function may do, including everything reachable through
    its resolved calls.  Site dicts map ``(path, line, col)`` to a
    payload whose last element is the witness chain (qualnames below
    this function, shortest first discovered)."""

    key: str
    qualname: str
    is_async: bool
    has_await: bool                     # this frame itself suspends
    may_suspend: bool                   # suspends here or in a callee
    # (path, line, col) -> (display, reason, chain)
    blocking: Dict[tuple, tuple] = dataclasses.field(default_factory=dict)
    # (path, line, col) -> (display, chain)
    network_awaits: Dict[tuple, tuple] = dataclasses.field(
        default_factory=dict
    )
    acquires: FrozenSet[str] = frozenset()
    awaits_held: FrozenSet[str] = frozenset()
    self_reads: FrozenSet[str] = frozenset()
    self_writes: FrozenSet[str] = frozenset()
    # (path, line, col) -> (needs_taint, kind, message, chain)
    taint_ops: Dict[tuple, tuple] = dataclasses.field(default_factory=dict)
    returns_param_taint: bool = False


def _tarjan_sccs(
    keys: Sequence[str], succ: Dict[str, List[str]]
) -> List[List[str]]:
    """Iterative Tarjan: SCCs in reverse topological order (every
    successor SCC appears before its callers)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: set = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    for root in keys:
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recursed = False
            children = succ.get(node, [])
            for i in range(pi, len(children)):
                child = children[i]
                if child not in index:
                    work[-1] = (node, i + 1)
                    work.append((child, 0))
                    recursed = True
                    break
                if child in on_stack:
                    low[node] = min(low[node], index[child])
            if recursed:
                continue
            work.pop()
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return sccs


class Summaries:
    """Fixpoint summaries for every function of a project.

    ``cached_locals`` maps module path -> ``{qual: LocalFacts}`` for
    files whose content hash matched the incremental cache; those
    modules skip the local extraction walk entirely (the fixpoint
    always reruns — it is global and cheap next to parsing)."""

    def __init__(
        self,
        project: Project,
        graph: Optional[CallGraph] = None,
        cached_locals: Optional[Dict[str, Dict[str, LocalFacts]]] = None,
    ) -> None:
        self.project = project
        self.graph = graph if graph is not None else CallGraph(project)
        self.locals: Dict[str, LocalFacts] = {}
        self.local_facts_by_path: Dict[str, Dict[str, LocalFacts]] = {}
        self.cache_hits: List[str] = []
        self.cache_misses: List[str] = []
        cached_locals = cached_locals or {}
        for mod in project.modules:
            cached = cached_locals.get(mod.path)
            if cached is not None and set(cached) == set(
                fi.qualname for fi in mod.functions.values()
            ):
                facts = cached
                self.cache_hits.append(mod.path)
            else:
                facts = compute_local_facts(mod)
                self.cache_misses.append(mod.path)
            self.local_facts_by_path[mod.path] = facts
            for fi in mod.functions.values():
                lf = facts.get(fi.qualname)
                if lf is not None:
                    self.locals[fi.key] = lf
        self.by_key: Dict[str, FnSummary] = {}
        self._compute()
        # key -> {"loop": CtxWitness, "thread": CtxWitness}
        self.contexts: Dict[str, Dict[str, CtxWitness]] = {}
        self._compute_contexts()

    def get(self, key: str) -> Optional[FnSummary]:
        return self.by_key.get(key)

    def for_function(self, fn_info) -> Optional[FnSummary]:
        return self.by_key.get(fn_info.key)

    def context_kinds(self, key: str) -> FrozenSet[str]:
        """``{"loop"}``, ``{"thread"}``, both, or empty (unrooted)."""
        return frozenset(self.contexts.get(key, ()))

    def witness(self, key: str, kind: str) -> Optional[CtxWitness]:
        return self.contexts.get(key, {}).get(kind)

    # ------------------------------------------------------------------
    def _compute(self) -> None:
        project = self.project
        graph = self.graph

        # seed every function from its local facts
        for fn in project.functions():
            lf = self.locals.get(fn.key)
            if lf is None:
                continue
            mod = fn.module
            acquires = frozenset(
                x for x in (
                    lock_identity(raw, fn.class_name, mod, project)
                    for raw, _line in lf.acquires_raw
                ) if x is not None
            )
            awaits_held = frozenset(
                x for x in (
                    lock_identity(raw, fn.class_name, mod, project)
                    for raw in lf.awaits_held_raw
                ) if x is not None
            )
            summ = FnSummary(
                key=fn.key,
                qualname=fn.qualname,
                is_async=lf.is_async,
                has_await=lf.has_await,
                may_suspend=lf.has_await,
                acquires=acquires,
                awaits_held=awaits_held,
                self_reads=frozenset(lf.self_reads),
                self_writes=frozenset(lf.self_writes),
                returns_param_taint=lf.returns_param_taint,
            )
            for line, col, display, reason in lf.blocking:
                summ.blocking[(mod.path, line, col)] = (display, reason, ())
            for line, col, display in lf.network_awaits:
                summ.network_awaits[(mod.path, line, col)] = (display, ())
            for needs, kind, line, col, msg in lf.taint_ops:
                summ.taint_ops[(mod.path, line, col)] = (
                    needs, kind, msg, ()
                )
            self.by_key[fn.key] = summ

        # held locks at each call site, normalized, for awaits_held
        held_at: Dict[str, Dict[tuple, FrozenSet[str]]] = {}
        for fn in project.functions():
            lf = self.locals.get(fn.key)
            if lf is None:
                continue
            per_site: Dict[tuple, FrozenSet[str]] = {}
            for line, col, raw_locks in lf.held_at_call:
                per_site[(line, col)] = frozenset(
                    x for x in (
                        lock_identity(r, fn.class_name, fn.module, project)
                        for r in raw_locks
                    ) if x is not None
                )
            held_at[fn.key] = per_site

        succ: Dict[str, List[str]] = {
            key: sorted({e.callee.key for e in edges})
            for key, edges in graph.edges.items()
        }
        sccs = _tarjan_sccs(sorted(self.by_key), succ)

        for scc in sccs:
            # members of one SCC iterate together until stable; a
            # singleton without a self-loop stabilizes in one pass
            for _ in range(len(scc) * 2 + 1):
                changed = False
                for key in scc:
                    if self._merge_callees(key, held_at):
                        changed = True
                if not changed:
                    break

    def _merge_callees(
        self, key: str, held_at: Dict[str, Dict[tuple, FrozenSet[str]]]
    ) -> bool:
        summ = self.by_key.get(key)
        if summ is None:
            return False
        changed = False
        for edge in self.graph.callees(key):
            callee = self.by_key.get(edge.callee.key)
            if callee is None:
                continue
            # a sync frame calling an async def only builds a coroutine
            # object — nothing in the callee executes at this site
            if callee.is_async and not summ.is_async:
                continue
            chain_step = (edge.callee.qualname,)
            for site, (display, reason, chain) in callee.blocking.items():
                if site not in summ.blocking:
                    summ.blocking[site] = (
                        display, reason, chain_step + chain
                    )
                    changed = True
            for site, (display, chain) in callee.network_awaits.items():
                if site not in summ.network_awaits:
                    summ.network_awaits[site] = (
                        display, chain_step + chain
                    )
                    changed = True
            if not callee.acquires <= summ.acquires:
                summ.acquires = summ.acquires | callee.acquires
                changed = True
            new_awaits_held = callee.awaits_held
            if callee.may_suspend:
                site_held = held_at.get(key, {}).get(
                    (edge.node.lineno, edge.node.col_offset)
                )
                if site_held:
                    new_awaits_held = new_awaits_held | site_held
                if not summ.may_suspend:
                    summ.may_suspend = True
                    changed = True
            if not new_awaits_held <= summ.awaits_held:
                summ.awaits_held = summ.awaits_held | new_awaits_held
                changed = True
            if edge.via_self:
                if not callee.self_reads <= summ.self_reads:
                    summ.self_reads = summ.self_reads | callee.self_reads
                    changed = True
                if not callee.self_writes <= summ.self_writes:
                    summ.self_writes = (
                        summ.self_writes | callee.self_writes
                    )
                    changed = True
            for site, (needs, kind, msg, chain) in callee.taint_ops.items():
                if site not in summ.taint_ops:
                    summ.taint_ops[site] = (
                        needs, kind, msg, chain_step + chain
                    )
                    changed = True
        return changed

    # ------------------------------------------------------------------
    def _compute_contexts(self) -> None:
        """Root the call graph at real runtime entry points and
        propagate a {loop, thread} context lattice along execution
        edges.  Seeds: every ``async def`` runs on the loop; a callable
        registered as a route handler / loop callback / ``PeriodicTask``
        runs on the loop; one handed to ``to_thread`` / an executor /
        ``threading.Thread`` runs on a worker thread.  Propagation into
        an ``async def`` is skipped (sync frames merely build the
        coroutine; async frames carry their own loop seed), so a
        thread-context caller never taints a coroutine it schedules."""
        project = self.project
        from collections import deque

        def fn_is_async(fn) -> bool:
            lf = self.locals.get(fn.key)
            if lf is not None:
                return lf.is_async
            return isinstance(fn.node, ast.AsyncFunctionDef)

        seeds: List[Tuple[str, CtxWitness]] = []
        for fn in project.functions():
            lf = self.locals.get(fn.key)
            if lf is None:
                continue
            server = any(p in ("server", "obs") for p in fn.module.parts)
            if lf.is_async:
                seeds.append((fn.key, CtxWitness(
                    "loop", fn.key, fn.qualname, "async def", "async",
                    (), fn.module.path, fn.node.lineno, server,
                )))
            for kind, ref, line in lf.entry_regs:
                for target in project.resolve_ref(
                    fn.module, fn.class_name, ref
                ):
                    if fn_is_async(target):
                        # a coroutine function keeps its loop seed no
                        # matter who schedules or threads it
                        continue
                    if kind == "thread":
                        w = CtxWitness(
                            "thread", target.key, target.qualname,
                            f"dispatched to a worker thread by "
                            f"{fn.qualname}()", "thread", (),
                            fn.module.path, line, server,
                        )
                    else:
                        seed = "route" if kind == "route" else "loop_cb"
                        what = (
                            "registered as a route handler"
                            if kind == "route"
                            else "scheduled as a loop callback"
                        )
                        w = CtxWitness(
                            "loop", target.key, target.qualname,
                            f"{what} by {fn.qualname}()", seed, (),
                            fn.module.path, line, server,
                        )
                    seeds.append((target.key, w))

        contexts = self.contexts
        queue: "deque[Tuple[str, str]]" = deque()

        def install(key: str, w: CtxWitness) -> None:
            cur = contexts.setdefault(key, {})
            prev = cur.get(w.kind)
            if prev is None or (w.server and not prev.server):
                cur[w.kind] = w
                queue.append((key, w.kind))

        for key, w in seeds:
            install(key, w)

        while queue:
            key, kind = queue.popleft()
            w = contexts[key][kind]
            caller = self.by_key.get(key)
            for edge in self.graph.callees(key):
                callee = self.by_key.get(edge.callee.key)
                if callee is None or callee.is_async:
                    # sync->async builds a coroutine object; async
                    # callees are loop-seeded directly
                    continue
                if caller is None:
                    continue
                install(edge.callee.key, CtxWitness(
                    kind, w.root_key, w.root_qual, w.reason, w.seed,
                    w.chain + (edge.callee.qualname,),
                    w.reg_path, w.reg_line, w.server,
                ))


def get_summaries(project: Project) -> Summaries:
    """Per-run memoized summaries: checkers share one fixpoint pass."""
    summ = getattr(project, "_summaries", None)
    if summ is None:
        cached = getattr(project, "_cached_local_facts", None)
        summ = Summaries(project, cached_locals=cached)
        project._summaries = summ
    return summ
