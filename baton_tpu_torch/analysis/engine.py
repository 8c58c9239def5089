"""batonlint engine — file walking, suppressions, registry, reporters.

Deliberately dependency-free (stdlib ``ast`` only): the lint step must
run in CI before any heavyweight install, and importing this module
must never drag in jax/aiohttp. Checkers register themselves through
:func:`register`; :mod:`baton_tpu_torch.analysis.checkers` imports the five
rule modules for their registration side effect.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Checker",
    "CheckContext",
    "Finding",
    "ProjectChecker",
    "Report",
    "all_rules",
    "apply_baseline",
    "finding_fingerprints",
    "register",
    "run_paths",
    "run_project_sources",
    "run_source",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``also_lines`` are additional lines where a ``# batonlint:
    allow[RULE]`` comment suppresses this finding — e.g. a BTL002
    await-under-lock finding is suppressible at the ``async with
    <lock>:`` header as well as at the await itself, so one comment
    covers a whole deliberately-held lock block.
    """

    rule: str
    path: str
    line: int
    col: int
    message: str
    also_lines: Tuple[int, ...] = ()

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }


@dataclasses.dataclass
class Report:
    """Aggregate result of one lint run."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    suppressed: int = 0
    files_checked: int = 0
    errors: List[str] = dataclasses.field(default_factory=list)
    # incremental summary cache stats (run_paths with cache_path only):
    # hits = files whose per-function facts were reused by content hash
    cache_hits: int = 0
    cache_misses: int = 0
    # findings absorbed by --baseline (still real; just pre-existing)
    baselined: int = 0

    @property
    def clean(self) -> bool:
        return not self.findings and not self.errors


_ALLOW_RE = re.compile(r"#\s*batonlint:\s*allow\[([^\]]*)\]")


def _comment_lines(source: str):
    """``(lineno, comment_text)`` for every REAL comment token.

    Tokenizing (rather than regex over raw lines) keeps ``allow[...]``
    text inside docstrings and string literals — rule documentation,
    fixture sources embedded in tests — from acting as (and being
    audited as) live suppressions.  Sources that fail to tokenize fall
    back to the raw-line scan so a stray ``\\x0c`` can't disable
    suppressions wholesale."""
    import io
    import tokenize

    try:
        tokens = list(
            tokenize.generate_tokens(io.StringIO(source).readline)
        )
    except (tokenize.TokenError, IndentationError, SyntaxError,
            ValueError):
        return [
            (lineno, text)
            for lineno, text in enumerate(source.splitlines(), start=1)
            if "#" in text
        ]
    return [
        (tok.start[0], tok.string)
        for tok in tokens
        if tok.type == tokenize.COMMENT
    ]


class Suppressions:
    """Per-line ``# batonlint: allow[RULE1,RULE2]`` / ``allow[*]`` map.

    Each suppression that actually absorbs a finding is recorded in
    ``used`` (``line -> {rules it silenced}``) so the BTL000 audit can
    flag allow comments that no longer silence anything."""

    def __init__(self, source: str) -> None:
        self._by_line: Dict[int, frozenset] = {}
        self.used: Dict[int, set] = {}
        for lineno, text in _comment_lines(source):
            m = _ALLOW_RE.search(text)
            if m:
                rules = frozenset(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
                self._by_line[lineno] = rules

    def allows(self, line: int, rule: str) -> bool:
        rules = self._by_line.get(line)
        if rules is None:
            return False
        if rule == "BTL000":
            # the stale-suppression audit may only be silenced by an
            # EXPLICIT allow[BTL000]: otherwise a stale `allow[*]`
            # would absorb its own staleness finding and never surface
            return rule in rules
        return rule in rules or "*" in rules

    def match(self, finding: Finding) -> Optional[int]:
        """First line whose allow comment covers the finding, else
        None.  Marks that line as used for the finding's rule."""
        for line in (finding.line, *finding.also_lines):
            if self.allows(line, finding.rule):
                self.used.setdefault(line, set()).add(finding.rule)
                return line
        return None

    def allows_finding(self, finding: Finding) -> bool:
        return self.match(finding) is not None

    def entries(self):
        """``(line, frozenset_of_rule_tokens)`` pairs, source order."""
        return sorted(self._by_line.items())


def _normalize_registry(reg) -> Optional[dict]:
    """Metric-registry normalization for BTL030.

    Accepts the legacy 2-tuple ``(declared_counters, counter_prefixes)``
    (timer/gauge audit disabled — pre-existing fixtures keep passing)
    or the full dict shape with ``counters`` / ``counter_prefixes`` /
    ``timers`` / ``gauges`` / ``exemplar_timers`` keys, where
    ``timers``/``gauges``/``exemplar_timers`` may be None to disable
    that audit."""
    if reg is None:
        return None
    if isinstance(reg, dict):
        return {
            "counters": frozenset(reg.get("counters", ())),
            "counter_prefixes": tuple(reg.get("counter_prefixes", ())),
            "timers": (
                frozenset(reg["timers"])
                if reg.get("timers") is not None else None
            ),
            "gauges": (
                frozenset(reg["gauges"])
                if reg.get("gauges") is not None else None
            ),
            "exemplar_timers": (
                frozenset(reg["exemplar_timers"])
                if reg.get("exemplar_timers") is not None else None
            ),
        }
    names, prefixes = reg
    return {
        "counters": frozenset(names),
        "counter_prefixes": tuple(prefixes),
        "timers": None,
        "gauges": None,
        "exemplar_timers": None,
    }


class CheckContext:
    """Everything a checker may need about the file under analysis."""

    def __init__(
        self,
        path: str,
        source: str,
        tree: ast.Module,
        counter_registry=None,
    ) -> None:
        self.path = path
        self.posix_path = pathlib.PurePath(path).as_posix()
        self.parts = pathlib.PurePath(path).parts
        self.source = source
        self.tree = tree
        # BTL030: normalized metric registry dict (counters / prefixes /
        # timers / gauges), resolved by the runner from
        # baton_tpu_torch/utils/metrics.py or injected by tests (legacy
        # 2-tuple accepted).
        self.counter_registry = _normalize_registry(counter_registry)


class Checker:
    """Base class: subclasses set ``rule``/``title`` and implement
    :meth:`check`; :meth:`applies_to` scopes the rule by path."""

    rule: str = ""
    title: str = ""

    def applies_to(self, ctx: CheckContext) -> bool:
        return True

    def check(self, ctx: CheckContext) -> Iterable[Finding]:
        raise NotImplementedError


class ProjectChecker(Checker):
    """Whole-program checker: runs once per lint run against the
    :class:`~baton_tpu_torch.analysis.project.Project` (every parsed file)
    instead of once per file, and may emit findings in any of them.
    Per-line suppressions still apply — each finding is matched against
    the suppression map of the file it points into."""

    def check(self, ctx: CheckContext) -> Iterable[Finding]:
        return ()  # project checkers never run in the per-file pass

    def check_project(self, project) -> Iterable[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, Checker] = {}


def register(checker_cls):
    """Class decorator: instantiate and register a checker by rule id."""
    inst = checker_cls()
    if not inst.rule:
        raise ValueError(f"{checker_cls.__name__} has no rule id")
    if inst.rule in _REGISTRY:
        raise ValueError(f"duplicate rule id {inst.rule}")
    _REGISTRY[inst.rule] = inst
    return checker_cls


def all_rules() -> Dict[str, str]:
    """``{rule_id: one-line title}`` for every registered checker."""
    _load_checkers()
    return {rule: _REGISTRY[rule].title for rule in sorted(_REGISTRY)}


def _load_checkers() -> None:
    # import for the registration side effect; idempotent
    from baton_tpu_torch.analysis import checkers  # noqa: F401


def _select(rules: Optional[Sequence[str]]) -> List[Checker]:
    _load_checkers()
    if rules is None:
        return [_REGISTRY[r] for r in sorted(_REGISTRY)]
    unknown = sorted(set(rules) - set(_REGISTRY))
    if unknown:
        raise KeyError(f"unknown rule(s): {', '.join(unknown)}")
    return [_REGISTRY[r] for r in sorted(set(rules))]


def _run_project(
    project,
    rules: Optional[Sequence[str]],
    report: Report,
    only_paths: Optional[frozenset] = None,
) -> List[Finding]:
    """Shared core: per-file checkers over each module, then project
    checkers once over the whole :class:`Project`.  ``only_paths``
    (already-normalized path strings) restricts which files run the
    per-file pass and which files' findings are REPORTED — project
    checkers still see every module, so cross-module reasoning stays
    sound under ``--changed-only``."""
    checkers = _select(rules)
    suppressions = {m.path: Suppressions(m.source) for m in project.modules}
    findings: List[Finding] = []
    seen = set()
    crashed: set = set()

    def wanted(path: str) -> bool:
        return only_paths is None or _normalize_path(path) in only_paths

    def admit(f: Finding) -> None:
        key = (f.rule, f.path, f.line, f.col, f.message)
        if key in seen:
            return
        seen.add(key)
        # match suppressions BEFORE the --changed-only filter: usage
        # marks must be complete for the BTL000 stale-suppression audit
        # even when the finding's file isn't being reported on
        supp = suppressions.get(f.path)
        suppressed = supp is not None and supp.allows_finding(f)
        if not wanted(f.path):
            return
        if suppressed:
            report.suppressed += 1
        else:
            findings.append(f)

    for mod in project.modules:
        report.files_checked += 1
        if not wanted(mod.path):
            continue
        ctx = CheckContext(
            mod.path, mod.source, mod.tree,
            counter_registry=mod.counter_registry,
        )
        for checker in checkers:
            if isinstance(checker, ProjectChecker):
                continue
            if not checker.applies_to(ctx):
                continue
            try:
                raw = list(checker.check(ctx))
            except Exception as exc:  # a buggy checker must not kill the run
                report.errors.append(
                    f"{mod.path}: checker {checker.rule} crashed: {exc!r}"
                )
                crashed.add(checker.rule)
                continue
            for f in raw:
                admit(f)
    for checker in checkers:
        if not isinstance(checker, ProjectChecker):
            continue
        try:
            raw = list(checker.check_project(project))
        except Exception as exc:
            report.errors.append(
                f"checker {checker.rule} crashed: {exc!r}"
            )
            crashed.add(checker.rule)
            continue
        for f in raw:
            admit(f)
    if any(c.rule == "BTL000" for c in checkers):
        for f in _audit_suppressions(
            project, checkers, suppressions, crashed, wanted, only_paths
        ):
            admit(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    report.findings.extend(findings)
    return findings


def _audit_suppressions(
    project, checkers, suppressions, crashed, wanted, only_paths
) -> List[Finding]:
    """BTL000 — an ``allow[RULE]`` that silences nothing is itself a
    finding: it documents a hazard that no longer exists (or never
    did), and it will hide the next REAL instance introduced on that
    line.  Runs after every other checker so usage marks are complete.

    A named token is audited only when its rule actually ran this pass
    without crashing; ``*`` tokens are stale when the line silenced
    nothing at all.  Under ``--changed-only`` the per-file pass skips
    unchanged files, so only files in the filter are audited."""
    ran = {c.rule for c in checkers if c.rule != "BTL000"} - crashed
    out: List[Finding] = []
    for mod in project.modules:
        # files outside --changed-only never ran the per-file pass, so
        # their per-file-rule suppressions would all look stale
        if only_paths is not None and not wanted(mod.path):
            continue
        supp = suppressions.get(mod.path)
        if supp is None:
            continue
        for line, tokens in supp.entries():
            used = supp.used.get(line, set())
            for tok in sorted(tokens):
                if tok == "*":
                    if not used:
                        out.append(Finding(
                            "BTL000", mod.path, line, 0,
                            "stale suppression: `allow[*]` silences "
                            "nothing on this line; remove it",
                        ))
                elif tok in ran and tok not in used:
                    out.append(Finding(
                        "BTL000", mod.path, line, 0,
                        f"stale suppression: `allow[{tok}]` but {tok} "
                        f"no longer fires here; remove it (stale "
                        f"allows hide the next real instance)",
                    ))
    return out


def _normalize_path(path: str) -> str:
    try:
        return str(pathlib.Path(path).resolve())
    except OSError:
        return path


def _parse_entries(
    items, report: Report
) -> list:
    """``(path, source[, registry])`` -> parsed Project entries; syntax
    errors land on the report, mirroring the old per-file behavior."""
    entries = []
    for item in items:
        path, source = item[0], item[1]
        registry = item[2] if len(item) > 2 else None
        try:
            tree = ast.parse(source)
        except SyntaxError as exc:
            report.errors.append(
                f"{path}:{exc.lineno}: syntax error: {exc.msg}"
            )
            continue
        entries.append((path, source, tree, registry))
    return entries


def _build_project(entries):
    from baton_tpu_torch.analysis.project import Project

    return Project.from_parsed(entries)


def run_source(
    source: str,
    path: str = "<string>",
    rules: Optional[Sequence[str]] = None,
    counter_registry=None,
    report: Optional[Report] = None,
) -> List[Finding]:
    """Lint one source string (the unit-test entry point).

    ``path`` scopes path-sensitive rules (BTL001/BTL030 only fire under
    a ``server/`` directory), so fixtures pass paths like
    ``"baton_tpu_torch/server/x.py"``. Project-scoped rules see a one-module
    project. Returns unsuppressed findings sorted by location;
    suppressed counts land on ``report`` when given.
    """
    report = report if report is not None else Report()
    entries = _parse_entries([(path, source, counter_registry)], report)
    if not entries:
        return []
    return _run_project(_build_project(entries), rules, report)


def run_project_sources(
    files,
    rules: Optional[Sequence[str]] = None,
    report: Optional[Report] = None,
) -> List[Finding]:
    """Lint several in-memory modules as ONE project — the multi-module
    fixture entry point (cross-module lock order, import resolution).
    ``files`` is ``{path: source}`` or an iterable of ``(path, source)``;
    module names derive from the paths (``fixtures/liba.py`` imports as
    ``fixtures.liba``)."""
    report = report if report is not None else Report()
    items = files.items() if hasattr(files, "items") else list(files)
    entries = _parse_entries(list(items), report)
    return _run_project(_build_project(entries), rules, report)


def iter_python_files(paths: Sequence[str]) -> List[pathlib.Path]:
    """Expand files/directories into a sorted, deduplicated .py list."""
    out = []
    seen = set()
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            candidates = sorted(path.rglob("*.py"))
        else:
            candidates = [path]
        for c in candidates:
            if "__pycache__" in c.parts:
                continue
            key = str(c)
            if key not in seen:
                seen.add(key)
                out.append(c)
    return out


def _resolve_counter_registry(
    path: pathlib.Path,
    cache: Dict[str, Optional[dict]],
) -> Optional[dict]:
    """Find the package's declared-metric registry for a checked file.

    Walks the file's ancestors for a ``baton_tpu_torch/utils/metrics.py``
    (covering both in-repo paths and fixture trees) and parses its
    ``DECLARED_COUNTERS`` / ``DECLARED_COUNTER_PREFIXES`` /
    ``DECLARED_TIMERS`` / ``DECLARED_GAUGES`` /
    ``DECLARED_EXEMPLAR_TIMERS`` literals with
    ``ast.literal_eval`` — no import, so linting never executes package
    code. ``None`` (registry not found) disables BTL030 for the file;
    a registry without timer/gauge sets disables just those audits.
    """
    for ancestor in [path.parent, *path.parent.parents]:
        for candidate in (
            ancestor / "baton_tpu" / "utils" / "metrics.py",
            ancestor / "utils" / "metrics.py",
        ):
            key = str(candidate)
            if key in cache:
                if cache[key] is not None:
                    return cache[key]
                continue
            if not candidate.is_file():
                cache[key] = None
                continue
            cache[key] = _parse_counter_registry(candidate)
            if cache[key] is not None:
                return cache[key]
    return None


def _parse_counter_registry(
    metrics_path: pathlib.Path,
) -> Optional[dict]:
    try:
        tree = ast.parse(metrics_path.read_text(encoding="utf-8"))
    except (OSError, SyntaxError):
        return None
    names: Optional[frozenset] = None
    prefixes: tuple = ()
    timers: Optional[frozenset] = None
    gauges: Optional[frozenset] = None
    exemplar_timers: Optional[frozenset] = None
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        value = node.value
        # unwrap frozenset({...}) / tuple([...]) wrapper calls
        if (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Name)
            and value.func.id in ("frozenset", "tuple", "set")
            and len(value.args) == 1
        ):
            value = value.args[0]
        try:
            literal = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            continue
        if target.id == "DECLARED_COUNTERS":
            names = frozenset(str(x) for x in literal)
        elif target.id == "DECLARED_COUNTER_PREFIXES":
            prefixes = tuple(str(x) for x in literal)
        elif target.id == "DECLARED_TIMERS":
            timers = frozenset(str(x) for x in literal)
        elif target.id == "DECLARED_GAUGES":
            gauges = frozenset(str(x) for x in literal)
        elif target.id == "DECLARED_EXEMPLAR_TIMERS":
            exemplar_timers = frozenset(str(x) for x in literal)
    if names is None:
        return None
    return {
        "counters": names,
        "counter_prefixes": prefixes,
        "timers": timers,
        "gauges": gauges,
        "exemplar_timers": exemplar_timers,
    }


# -- finding fingerprints / baseline -----------------------------------
def _fingerprint_base(f: Finding) -> str:
    """Location-independent identity of a finding: rule + posix path +
    the message with every digit run collapsed — stable across pure
    line-number drift (the property SARIF ``partialFingerprints`` and
    ``--baseline`` need), while a finding MOVING to another file or
    changing meaning gets a new identity."""
    import hashlib

    norm_msg = re.sub(r"\d+", "#", f.message)
    posix = pathlib.PurePath(f.path).as_posix()
    return hashlib.sha256(
        f"{f.rule}\x00{posix}\x00{norm_msg}".encode("utf-8")
    ).hexdigest()[:16]


def finding_fingerprints(findings: Sequence[Finding]) -> List[str]:
    """One stable fingerprint per finding, order-aligned with the
    input.  Identical findings in one report are disambiguated with an
    ``:N`` occurrence suffix, so a report with three instances of the
    same hazard baselines exactly three — a fourth still fails."""
    counts: Dict[str, int] = {}
    out: List[str] = []
    for f in findings:
        base = _fingerprint_base(f)
        n = counts.get(base, 0)
        counts[base] = n + 1
        out.append(base if n == 0 else f"{base}:{n}")
    return out


def apply_baseline(report: Report, fingerprints) -> None:
    """Drop findings whose fingerprint appears in ``fingerprints``
    (a committed baseline); the drop count lands on
    ``report.baselined``.  New findings — absent from the baseline —
    survive and still fail the run."""
    known = frozenset(fingerprints)
    keep: List[Finding] = []
    dropped = 0
    for f, fp in zip(report.findings, finding_fingerprints(report.findings)):
        if fp in known:
            dropped += 1
        else:
            keep.append(f)
    report.findings[:] = keep
    report.baselined += dropped


CACHE_VERSION = 2  # v2: LocalFacts gained execution-context fields


def _load_summary_cache(cache_path: str, entries) -> Dict[str, dict]:
    """``{path: {qual: LocalFacts}}`` for entries whose content hash
    matches the cache file; unreadable/stale/corrupt caches are just
    misses."""
    import hashlib

    from baton_tpu_torch.analysis.summaries import LocalFacts

    try:
        data = json.loads(
            pathlib.Path(cache_path).read_text(encoding="utf-8")
        )
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict) or data.get("version") != CACHE_VERSION:
        return {}
    files = data.get("files", {})
    out: Dict[str, dict] = {}
    for path, source, _tree, _reg in entries:
        rec = files.get(path)
        if not isinstance(rec, dict):
            continue
        digest = hashlib.sha256(source.encode("utf-8")).hexdigest()
        if rec.get("hash") != digest:
            continue
        try:
            out[path] = {
                qual: LocalFacts.from_json(lf)
                for qual, lf in rec.get("functions", {}).items()
            }
        except (KeyError, TypeError, ValueError):
            continue
    return out


def _write_summary_cache(cache_path: str, project, summaries) -> None:
    import hashlib

    files = {}
    for mod in project.modules:
        facts = summaries.local_facts_by_path.get(mod.path)
        if facts is None:
            continue
        files[mod.path] = {
            "hash": hashlib.sha256(
                mod.source.encode("utf-8")
            ).hexdigest(),
            "functions": {
                qual: lf.to_json() for qual, lf in facts.items()
            },
        }
    payload = {"version": CACHE_VERSION, "files": files}
    try:
        pathlib.Path(cache_path).write_text(
            json.dumps(payload, sort_keys=True), encoding="utf-8"
        )
    except OSError:
        pass  # a read-only checkout must not fail the lint


def run_paths(
    paths: Sequence[str],
    rules: Optional[Sequence[str]] = None,
    only_paths: Optional[Sequence[str]] = None,
    cache_path: Optional[str] = None,
) -> Report:
    """Lint files/directories; the CLI and test-suite entry point.

    All files are parsed into one :class:`Project` so project-scoped
    checkers (cross-module lock order) see the whole program.
    ``only_paths`` (the ``--changed-only`` filter) restricts the
    per-file pass and the REPORTED findings to those files while the
    project pass still reads everything.

    ``cache_path`` enables the incremental summary cache: per-function
    local facts are reloaded for files whose sha256 content hash is
    unchanged (skipping their extraction walk — the global fixpoint
    always reruns) and the file is rewritten after the run.  Hit/miss
    counts land on ``report.cache_hits``/``report.cache_misses``.
    """
    report = Report()
    registry_cache: Dict[str, Optional[dict]] = {}
    files = iter_python_files(paths)
    if not files:
        report.errors.append(f"no Python files under: {', '.join(paths)}")
        return report
    items = []
    for path in files:
        try:
            source = path.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError) as exc:
            report.errors.append(f"{path}: unreadable: {exc}")
            continue
        items.append(
            (str(path), source,
             _resolve_counter_registry(path, registry_cache))
        )
    entries = _parse_entries(items, report)
    only = (
        frozenset(_normalize_path(p) for p in only_paths)
        if only_paths is not None
        else None
    )
    project = _build_project(entries)
    if cache_path is not None:
        project._cached_local_facts = _load_summary_cache(
            cache_path, entries
        )
    _run_project(project, rules, report, only_paths=only)
    if cache_path is not None:
        from baton_tpu_torch.analysis.summaries import get_summaries

        summaries = get_summaries(project)  # built by checkers or now
        report.cache_hits = len(summaries.cache_hits)
        report.cache_misses = len(summaries.cache_misses)
        _write_summary_cache(cache_path, project, summaries)
    return report


# -- reporters ---------------------------------------------------------
def format_text(report: Report) -> str:
    lines = [
        f"{f.location()}: {f.rule} {f.message}" for f in report.findings
    ]
    for err in report.errors:
        lines.append(f"error: {err}")
    baseline_note = (
        f", {report.baselined} baselined" if report.baselined else ""
    )
    lines.append(
        f"batonlint: {len(report.findings)} finding(s), "
        f"{report.suppressed} suppressed{baseline_note}, "
        f"{report.files_checked} file(s) checked"
    )
    return "\n".join(lines)


def format_json(report: Report) -> str:
    fps = finding_fingerprints(report.findings)
    findings = []
    for f, fp in zip(report.findings, fps):
        rec = f.to_json()
        rec["fingerprint"] = fp
        findings.append(rec)
    return json.dumps(
        {
            "findings": findings,
            "suppressed": report.suppressed,
            "files_checked": report.files_checked,
            "errors": list(report.errors),
            "baselined": report.baselined,
            "cache": {
                "hits": report.cache_hits,
                "misses": report.cache_misses,
            },
        },
        indent=2,
        sort_keys=True,
    )
