"""Whole-program model for batonlint: modules, symbols, imports.

The per-file checkers see one ``ast.Module`` at a time; everything a
cross-module rule needs — "which function does ``secure.dh_shared_seed``
resolve to", "which class owns ``_register_lock``" — lives here.  A
:class:`Project` is built once per lint run from every file on the
command line, so project-scoped checkers (``ProjectChecker`` in the
engine) can follow calls across module boundaries.

Resolution is deliberately syntactic (no imports are executed, same
contract as the rest of batonlint):

* module names come from the filesystem when the file exists (walking
  up through ``__init__.py`` packages) and from the given path string
  for in-memory fixtures, so ``baton_tpu_torch/server/fixture.py`` is module
  ``baton_tpu_torch.server.fixture`` either way;
* ``import a.b as x`` / ``from a.b import f`` bind local aliases to
  dotted targets; relative imports resolve against the module's own
  package;
* a call resolves through (1) same-module functions/methods
  (``self.helper`` -> ``Class.helper``), (2) an imported symbol, or
  (3) ``alias.attr`` where the alias names a project module;
* since the class-hierarchy layer landed, ``self.method()`` also
  resolves through inheritance: the nearest definition up the base
  chain PLUS every override in known subclasses (class-hierarchy
  analysis — the receiver's dynamic type may be any subclass of the
  enclosing class), and ``super().method()`` resolves to the nearest
  base-class definition;
* the common reflection idioms resolve too:
  ``getattr(self, "handle_" + x)(...)`` (and the f-string spelling)
  dispatches to every method of the class hierarchy whose name starts
  with the literal prefix, and dict-literal dispatch tables —
  function-local ``tbl = {...}``, instance ``self._table = {...}``,
  or module-level ``TABLE = {...}`` whose values are resolvable
  callable references — dispatch ``tbl[k](...)`` / ``tbl.get(k)(...)``
  to every value.  Truly dynamic dispatch (computed attribute names
  with no literal prefix, HOFs through opaque objects) remains out of
  scope — a resolver miss returns ``None``/``[]`` and the caller
  degrades to per-file behavior.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, Iterable, List, Optional, Tuple

from baton_tpu_torch.analysis import _astutil as au

__all__ = ["ClassInfo", "FunctionInfo", "ModuleInfo", "Project"]


@dataclasses.dataclass
class FunctionInfo:
    """One def/async def, with enough context to name and revisit it."""

    qualname: str                 # "Class.method" or bare name
    class_name: Optional[str]
    node: ast.AST                 # FunctionDef | AsyncFunctionDef
    module: "ModuleInfo"

    @property
    def key(self) -> str:
        """Project-unique id: ``module.dotted.name:Qual.name``."""
        return f"{self.module.name}:{self.qualname}"

    @property
    def is_async(self) -> bool:
        return isinstance(self.node, ast.AsyncFunctionDef)


def _dict_literal_refs(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """Values of a dict literal as dotted callable refs, when EVERY
    non-constant value is one — the dispatch-table shape.  Returns None
    for anything else (a dict of data is not a dispatch table)."""
    if not isinstance(node, ast.Dict) or not node.values:
        return None
    refs = []
    for v in node.values:
        if isinstance(v, ast.Constant):
            return None
        d = au.dotted_name(v)
        if d is None:
            return None
        refs.append(d)
    return tuple(refs)


def _str_pattern(node: ast.AST) -> Tuple[Optional[str], Optional[str]]:
    """``(exact, prefix)`` for the attribute-name expression of a
    ``getattr`` call: a string constant gives ``exact``; ``"pre_" + x``
    and ``f"pre_{x}"`` give ``prefix``; anything else ``(None, None)``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value, None
    if (
        isinstance(node, ast.BinOp)
        and isinstance(node.op, ast.Add)
        and isinstance(node.left, ast.Constant)
        and isinstance(node.left.value, str)
    ):
        return None, node.left.value
    if (
        isinstance(node, ast.JoinedStr)
        and node.values
        and isinstance(node.values[0], ast.Constant)
        and isinstance(node.values[0].value, str)
    ):
        return None, node.values[0].value
    return None, None


@dataclasses.dataclass
class ClassInfo:
    """One class definition: enough to build the inheritance graph."""

    name: str                     # bare class name
    module: "ModuleInfo"
    node: ast.ClassDef
    base_names: Tuple[str, ...]   # raw dotted base expressions

    @property
    def key(self) -> str:
        """Project-unique id: ``module.dotted.name:ClassName``."""
        return f"{self.module.name}:{self.name}"

    def method(self, name: str) -> Optional["FunctionInfo"]:
        """The method defined ON this class (no inheritance walk)."""
        return self.module.functions.get(f"{self.name}.{name}")


class ModuleInfo:
    """One parsed source file plus its symbol table."""

    def __init__(
        self,
        path: str,
        source: str,
        tree: ast.Module,
        name: str,
        counter_registry: Optional[Tuple[frozenset, tuple]] = None,
    ) -> None:
        self.path = path
        self.posix_path = pathlib.PurePath(path).as_posix()
        self.parts = pathlib.PurePath(path).parts
        self.source = source
        self.tree = tree
        self.name = name
        self.counter_registry = counter_registry
        self.functions: Dict[str, FunctionInfo] = {}
        for qual, cls, node in au.iter_function_defs(tree):
            self.functions.setdefault(
                qual, FunctionInfo(qual, cls, node, self)
            )
        self.imports = _collect_imports(tree, name)
        self.classes: Dict[str, ClassInfo] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                bases = tuple(
                    b for b in (au.dotted_name(base) for base in node.bases)
                    if b is not None
                )
                self.classes.setdefault(
                    node.name, ClassInfo(node.name, self, node, bases)
                )
        self._global_names: Optional[frozenset] = None
        self._dispatch_tables: Optional[Dict[str, Tuple[str, ...]]] = None
        self._class_tables: Optional[
            Dict[Tuple[str, str], Tuple[str, ...]]
        ] = None

    @property
    def global_names(self) -> frozenset:
        """Module-level mutable bindings: names assigned at module scope
        that are not imports, defs, or classes — the state a worker
        thread and the event loop could race on."""
        if self._global_names is None:
            bound: set = set()
            for stmt in self.tree.body:
                targets: list = []
                if isinstance(stmt, ast.Assign):
                    targets = stmt.targets
                elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                    targets = [stmt.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        bound.add(t.id)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        bound.update(
                            e.id for e in t.elts if isinstance(e, ast.Name)
                        )
            self._global_names = frozenset(
                bound - set(self.imports) - set(self.functions)
                - set(self.classes)
            )
        return self._global_names

    @property
    def dispatch_tables(self) -> Dict[str, Tuple[str, ...]]:
        """Module-level ``NAME = {k: handler, ...}`` dict literals whose
        values are callable refs — ``{NAME: (ref, ...)}``."""
        if self._dispatch_tables is None:
            out: Dict[str, Tuple[str, ...]] = {}
            for stmt in self.tree.body:
                if not isinstance(stmt, ast.Assign):
                    continue
                refs = _dict_literal_refs(stmt.value)
                if refs is None:
                    continue
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        out.setdefault(t.id, refs)
            self._dispatch_tables = out
        return self._dispatch_tables

    @property
    def class_dispatch_tables(self) -> Dict[Tuple[str, str], Tuple[str, ...]]:
        """``self.X = {k: self.handler, ...}`` tables assigned in any
        method — ``{(class_name, attr): (ref, ...)}``."""
        if self._class_tables is None:
            out: Dict[Tuple[str, str], Tuple[str, ...]] = {}
            for fi in self.functions.values():
                if fi.class_name is None:
                    continue
                for node in au.walk_shallow(fi.node):
                    if not isinstance(node, ast.Assign):
                        continue
                    refs = _dict_literal_refs(node.value)
                    if refs is None:
                        continue
                    for t in node.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id in ("self", "cls")
                        ):
                            out.setdefault(
                                (fi.class_name, t.attr), refs
                            )
            self._class_tables = out
        return self._class_tables


def _module_name_for(path: str) -> str:
    """Dotted module name for ``path``.

    Real files walk up while ``__init__.py`` siblings exist, so
    ``/any/prefix/baton_tpu_torch/server/x.py`` -> ``baton_tpu_torch.server.x``.
    Nonexistent (fixture) paths fall back to the path string itself:
    ``fixtures/liba.py`` -> ``fixtures.liba``.
    """
    p = pathlib.Path(path)
    stem_parts: List[str] = [] if p.stem == "__init__" else [p.stem]
    if p.is_file():
        parent = p.resolve().parent
        parts = list(stem_parts)
        while (parent / "__init__.py").is_file():
            parts.insert(0, parent.name)
            parent = parent.parent
        return ".".join(parts) or p.stem
    pure = pathlib.PurePath(path)
    parts = [x for x in pure.parts[:-1] if x not in ("/", "\\", "..", ".")]
    return ".".join(parts + stem_parts) or p.stem


def _collect_imports(tree: ast.Module, module_name: str) -> Dict[str, str]:
    """``{local alias: dotted target}`` for every import in the module
    (function-level imports included — ``from . import secure`` inside a
    handler binds the same way for resolution purposes)."""
    imports: Dict[str, str] = {}
    pkg_parts = module_name.split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    imports[alias.asname] = alias.name
                else:
                    root = alias.name.split(".")[0]
                    imports.setdefault(root, root)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base_parts = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                base = ".".join(
                    base_parts + ([node.module] if node.module else [])
                )
            else:
                base = node.module or ""
            for alias in node.names:
                if alias.name == "*":
                    continue
                target = f"{base}.{alias.name}" if base else alias.name
                imports[alias.asname or alias.name] = target
    return imports


class Project:
    """All modules of one lint run, indexed by path and dotted name."""

    def __init__(self) -> None:
        self.modules: List[ModuleInfo] = []
        self.by_path: Dict[str, ModuleInfo] = {}
        self.by_name: Dict[str, ModuleInfo] = {}
        self._hier: Optional[Tuple[Dict[str, List[str]],
                                   Dict[str, List[str]],
                                   Dict[str, ClassInfo]]] = None

    @classmethod
    def from_parsed(
        cls,
        entries: Iterable[Tuple[str, str, ast.Module,
                                Optional[Tuple[frozenset, tuple]]]],
    ) -> "Project":
        """Build from ``(path, source, tree, counter_registry)`` tuples
        (the engine parses; a file that failed to parse never gets
        here)."""
        project = cls()
        for path, source, tree, registry in entries:
            mod = ModuleInfo(path, source, tree, _module_name_for(path),
                             counter_registry=registry)
            project.modules.append(mod)
            project.by_path[path] = mod
            # first module wins on a name collision (e.g. two fixture
            # trees shipping an identically-named module)
            project.by_name.setdefault(mod.name, mod)
        return project

    def functions(self) -> Iterable[FunctionInfo]:
        for mod in self.modules:
            yield from mod.functions.values()

    def function_by_dotted(self, dotted: str) -> Optional[FunctionInfo]:
        """``baton_tpu_torch.server.secure.dh_shared_seed`` -> FunctionInfo.

        Tries the longest module prefix first so ``pkg.mod.Class.method``
        resolves even when ``pkg.mod.Class`` isn't itself a module.
        """
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = self.by_name.get(".".join(parts[:i]))
            if mod is not None:
                hit = mod.functions.get(".".join(parts[i:]))
                if hit is not None:
                    return hit
        return None

    # -- class hierarchy (CHA) -----------------------------------------
    def _hierarchy(self):
        """``(parents, children, by_key)`` over every known class; built
        once per project, cycle-tolerant (a recursive base chain just
        stops unifying where the cycle closes)."""
        if self._hier is not None:
            return self._hier
        by_key: Dict[str, ClassInfo] = {}
        for mod in self.modules:
            for ci in mod.classes.values():
                by_key.setdefault(ci.key, ci)
        parents: Dict[str, List[str]] = {}
        children: Dict[str, List[str]] = {}
        for ci in by_key.values():
            for base in ci.base_names:
                parent = self._resolve_class_name(ci.module, base)
                if parent is None or parent.key == ci.key:
                    continue
                parents.setdefault(ci.key, []).append(parent.key)
                children.setdefault(parent.key, []).append(ci.key)
        self._hier = (parents, children, by_key)
        return self._hier

    def _class_by_dotted(self, dotted: str) -> Optional[ClassInfo]:
        parts = dotted.split(".")
        if len(parts) < 2:
            return None
        mod = self.by_name.get(".".join(parts[:-1]))
        if mod is None:
            return None
        return mod.classes.get(parts[-1])

    def _resolve_class_name(
        self, mod: ModuleInfo, dotted: str
    ) -> Optional[ClassInfo]:
        """A base-class expression (``Base``, ``pkg.Base``, imported
        alias) -> the ClassInfo it names, when it is a project class."""
        root, _, rest = dotted.partition(".")
        if not rest:
            ci = mod.classes.get(dotted)
            if ci is not None:
                return ci
            target = mod.imports.get(dotted)
            return self._class_by_dotted(target) if target else None
        target = mod.imports.get(root)
        if target is not None:
            return self._class_by_dotted(f"{target}.{rest}")
        return self._class_by_dotted(dotted)

    def class_info(
        self, mod: ModuleInfo, class_name: Optional[str]
    ) -> Optional[ClassInfo]:
        if class_name is None:
            return None
        return mod.classes.get(class_name)

    def ancestors(self, ci: ClassInfo) -> List[ClassInfo]:
        """Base classes of ``ci``, nearest first (BFS, cycle-safe)."""
        parents, _children, by_key = self._hierarchy()
        out: List[ClassInfo] = []
        seen = {ci.key}
        frontier = list(parents.get(ci.key, []))
        while frontier:
            nxt: List[str] = []
            for key in frontier:
                if key in seen:
                    continue
                seen.add(key)
                out.append(by_key[key])
                nxt.extend(parents.get(key, []))
            frontier = nxt
        return out

    def descendants(self, ci: ClassInfo) -> List[ClassInfo]:
        """Known subclasses of ``ci``, transitively (BFS, cycle-safe)."""
        _parents, children, by_key = self._hierarchy()
        out: List[ClassInfo] = []
        seen = {ci.key}
        frontier = list(children.get(ci.key, []))
        while frontier:
            nxt: List[str] = []
            for key in frontier:
                if key in seen:
                    continue
                seen.add(key)
                out.append(by_key[key])
                nxt.extend(children.get(key, []))
            frontier = nxt
        return out

    def root_class_name(
        self, mod: ModuleInfo, class_name: Optional[str]
    ) -> Optional[str]:
        """Bare name of the topmost known ancestor of ``class_name`` —
        the namespace ``self.attr`` state and locks unify under, so a
        lock acquired in ``Sub`` and one in ``Base`` name the same
        object when ``Sub(Base)``."""
        if class_name is None:
            return None
        ci = self.class_info(mod, class_name)
        if ci is None:
            return class_name
        chain = self.ancestors(ci)
        return chain[-1].name if chain else ci.name

    def resolve_method(
        self, ci: ClassInfo, method: str
    ) -> Optional[FunctionInfo]:
        """Nearest definition of ``method`` on ``ci`` or up its bases."""
        hit = ci.method(method)
        if hit is not None:
            return hit
        for base in self.ancestors(ci):
            hit = base.method(method)
            if hit is not None:
                return hit
        return None

    def method_candidates(
        self, ci: ClassInfo, method: str
    ) -> List[FunctionInfo]:
        """CHA dispatch set for ``self.method()`` in class ``ci``: the
        nearest inherited definition plus every override in known
        subclasses (the receiver may be any subclass instance)."""
        out: List[FunctionInfo] = []
        seen: set = set()

        def add(fn: Optional[FunctionInfo]) -> None:
            if fn is not None and fn.key not in seen:
                seen.add(fn.key)
                out.append(fn)

        add(self.resolve_method(ci, method))
        for sub in self.descendants(ci):
            add(sub.method(method))
        return out

    # -- call resolution -----------------------------------------------
    def resolve_call_multi(
        self,
        mod: ModuleInfo,
        class_name: Optional[str],
        call: ast.Call,
    ) -> List[FunctionInfo]:
        """Every function this call may statically dispatch to.

        ``self.method()``/``cls.method()`` resolve through the class
        hierarchy (nearest definition up the bases plus all subclass
        overrides); ``super().method()`` to the nearest base
        definition; everything else to at most one candidate via the
        module symbol table."""
        func = call.func
        ci = self.class_info(mod, class_name)
        # super().method(...)
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Call)
            and isinstance(func.value.func, ast.Name)
            and func.value.func.id == "super"
        ):
            if ci is None:
                return []
            own = ci.method(func.attr)
            for base in self.ancestors(ci):
                hit = base.method(func.attr)
                if hit is not None and (own is None or hit.key != own.key):
                    return [hit]
            return []
        # self.method(...) / cls.method(...)
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id in ("self", "cls")
        ):
            if ci is not None:
                hits = self.method_candidates(ci, func.attr)
                if hits:
                    return hits
            # no hierarchy info: fall through to the legacy single-shot
        single = self._resolve_call_single(mod, class_name, call)
        return [single] if single is not None else []

    def resolve_call(
        self,
        mod: ModuleInfo,
        class_name: Optional[str],
        call: ast.Call,
    ) -> Optional[FunctionInfo]:
        """Best-effort single-target resolution (primary candidate —
        the nearest-MRO definition for ``self.`` calls)."""
        hits = self.resolve_call_multi(mod, class_name, call)
        return hits[0] if hits else None

    def _resolve_call_single(
        self,
        mod: ModuleInfo,
        class_name: Optional[str],
        call: ast.Call,
    ) -> Optional[FunctionInfo]:
        local = au.resolve_local_call(call, class_name)
        if local is not None:
            hit = mod.functions.get(local)
            if hit is not None:
                return hit
            if "." not in local:
                target = mod.imports.get(local)
                if target is not None:
                    return self.function_by_dotted(target)
            return None
        dotted = au.dotted_name(call.func)
        if dotted is None or "." not in dotted:
            return None
        root, rest = dotted.split(".", 1)
        target = self.imports_target(mod, root)
        if target is None:
            return None
        return self.function_by_dotted(f"{target}.{rest}")

    def imports_target(self, mod: ModuleInfo, alias: str) -> Optional[str]:
        return mod.imports.get(alias)

    # -- reference / reflection resolution ------------------------------
    def resolve_ref(
        self, mod: ModuleInfo, class_name: Optional[str], ref: str
    ) -> List[FunctionInfo]:
        """A raw callable *reference* (not a call) -> candidate
        functions: ``"self.handle_x"`` through the class hierarchy,
        ``"run"`` to a nested/sibling def or module function or import,
        ``"mod.fn"`` through the symbol table."""
        if not ref:
            return []
        root, _, rest = ref.partition(".")
        if root in ("self", "cls") and rest and "." not in rest:
            ci = self.class_info(mod, class_name)
            if ci is not None:
                hits = self.method_candidates(ci, rest)
                if hits:
                    return hits
            if class_name is not None:
                hit = mod.functions.get(f"{class_name}.{rest}")
                return [hit] if hit is not None else []
            return []
        if not rest:  # bare name
            quals = [ref] if class_name is None else [
                f"{class_name}.{ref}", ref,
            ]
            for qual in quals:
                hit = mod.functions.get(qual)
                if hit is not None:
                    return [hit]
            target = mod.imports.get(ref)
            if target is not None:
                hit = self.function_by_dotted(target)
                return [hit] if hit is not None else []
            return []
        hit = mod.functions.get(ref)  # literal "Class.method"
        if hit is not None:
            return [hit]
        target = mod.imports.get(root)
        if target is not None:
            hit = self.function_by_dotted(f"{target}.{rest}")
            return [hit] if hit is not None else []
        hit = self.function_by_dotted(ref)
        return [hit] if hit is not None else []

    def methods_with_prefix(
        self, mod: ModuleInfo, class_name: Optional[str], prefix: str
    ) -> List[FunctionInfo]:
        """Every method in ``class_name``'s hierarchy whose name starts
        with ``prefix`` — the ``getattr(self, "handle_" + x)`` dispatch
        set.  An empty prefix resolves to nothing (that is not a
        statically-known suffix set, it is full dynamism)."""
        if not prefix or class_name is None:
            return []
        out: List[FunctionInfo] = []
        seen: set = set()

        def scan(cls_name: str, cls_mod: ModuleInfo) -> None:
            want = f"{cls_name}."
            for qual, fi in cls_mod.functions.items():
                if not qual.startswith(want):
                    continue
                method = qual[len(want):]
                if "." in method or not method.startswith(prefix):
                    continue
                if fi.key not in seen:
                    seen.add(fi.key)
                    out.append(fi)

        ci = self.class_info(mod, class_name)
        if ci is None:
            scan(class_name, mod)
            return out
        for c in [ci, *self.ancestors(ci), *self.descendants(ci)]:
            scan(c.name, c.module)
        return out

    def reflection_targets(
        self,
        mod: ModuleInfo,
        class_name: Optional[str],
        call: ast.Call,
        local_tables: Optional[Dict[str, Tuple[str, ...]]] = None,
    ) -> List[Tuple[FunctionInfo, bool]]:
        """``(callee, via_self)`` candidates for the reflection call
        shapes: ``getattr(self, "pre_" + x)(...)`` over the literal
        prefix, and dispatch-table calls ``tbl[k](...)`` /
        ``tbl.get(k)(...)`` through function-local, ``self.X``, or
        module-level dict-literal tables."""
        func = call.func
        # getattr(self, <name-expr>)(...)
        if (
            isinstance(func, ast.Call)
            and isinstance(func.func, ast.Name)
            and func.func.id == "getattr"
            and len(func.args) >= 2
            and isinstance(func.args[0], ast.Name)
            and func.args[0].id in ("self", "cls")
        ):
            exact, prefix = _str_pattern(func.args[1])
            if exact is not None:
                return [
                    (fi, True)
                    for fi in self.resolve_ref(
                        mod, class_name, f"self.{exact}"
                    )
                ]
            if prefix is not None:
                return [
                    (fi, True)
                    for fi in self.methods_with_prefix(
                        mod, class_name, prefix
                    )
                ]
            return []
        # tbl[k](...) / tbl.get(k[, default])(...)
        base: Optional[ast.AST] = None
        if isinstance(func, ast.Subscript):
            base = func.value
        elif (
            isinstance(func, ast.Call)
            and isinstance(func.func, ast.Attribute)
            and func.func.attr == "get"
        ):
            base = func.func.value
        if base is None:
            return []
        refs: Optional[Tuple[str, ...]] = None
        owner_mod, owner_class = mod, class_name
        if isinstance(base, ast.Name):
            if local_tables and base.id in local_tables:
                refs = local_tables[base.id]
            else:
                refs = mod.dispatch_tables.get(base.id)
        elif isinstance(base, ast.Attribute) and isinstance(
            base.value, ast.Name
        ):
            if base.value.id in ("self", "cls") and class_name is not None:
                ci = self.class_info(mod, class_name)
                classes = (
                    [ci, *self.ancestors(ci), *self.descendants(ci)]
                    if ci is not None else []
                )
                for c in classes:
                    refs = c.module.class_dispatch_tables.get(
                        (c.name, base.attr)
                    )
                    if refs is not None:
                        owner_mod, owner_class = c.module, c.name
                        break
                if refs is None and ci is None:
                    refs = mod.class_dispatch_tables.get(
                        (class_name, base.attr)
                    )
            else:
                target = mod.imports.get(base.value.id)
                tmod = self.by_name.get(target) if target else None
                if tmod is not None:
                    refs = tmod.dispatch_tables.get(base.attr)
                    owner_mod, owner_class = tmod, None
        if not refs:
            return []
        out: List[Tuple[FunctionInfo, bool]] = []
        seen: set = set()
        for ref in refs:
            via_self = ref.startswith(("self.", "cls."))
            for fi in self.resolve_ref(owner_mod, owner_class, ref):
                if fi.key not in seen:
                    seen.add(fi.key)
                    out.append((fi, via_self))
        return out
