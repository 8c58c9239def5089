"""Dependency-free distributed span recorder with W3C ``traceparent``
propagation and Chrome ``trace_event`` export.

One federated round = one trace. The trace id is *derived* —
``sha256(f"{exp_name}/{round_name}")`` — so the manager, every worker,
and a post-crash manager incarnation all agree on it without any
coordination handshake: whoever touches the round can stamp spans into
the same trace, and a recovered manager resumes the trace its
predecessor started.

Spans cross process boundaries two ways:

- **downstream** (manager → worker): the standard ``traceparent``
  header (``00-<trace_id>-<span_id>-01``) rides every HTTP call made
  under an active span; ``trace_headers()`` builds the header dict and
  batonlint BTL031 enforces that outbound calls under a span use it.
- **upstream** (worker → manager): workers ship their *finished* spans
  as JSON to the manager's ``POST /{name}/trace_spans`` endpoint after
  delivering an update, and the manager's tracer :meth:`ingest`\\ s
  them, so ``GET /{name}/rounds/{rid}/trace`` serves the whole
  distributed round from one place.

Crash survivability: with ``spool_dir`` set, every span is appended to
``<spool_dir>/<trace_id>.jsonl`` **eagerly at span end** — a manager
killed mid-round loses its Python heap but not the spool, so the trace
exported by the recovered incarnation still shows the first
incarnation's spans and the recovery gap between them. Export merges
memory + spool, deduplicating on span id.

The active span travels via :mod:`contextvars`, so it follows awaits
and ``ensure_future`` task spawns (asyncio copies the context) without
any explicit plumbing.
"""

from __future__ import annotations

import contextvars
import hashlib
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

_TRACEPARENT_VERSION = "00"
_SPAN_KEYS = ("trace_id", "span_id", "parent_id", "name", "service",
              "start", "end", "args")

# (trace_id, span_id) of the active span in this task/thread context.
_current: contextvars.ContextVar[Optional[Tuple[str, str]]] = (
    contextvars.ContextVar("baton_trace", default=None)
)


# ---------------------------------------------------------------------------
# ids + traceparent
def make_trace_id(exp_name: str, round_name: str) -> str:
    """Deterministic 16-byte trace id for one round of one experiment."""
    digest = hashlib.sha256(f"{exp_name}/{round_name}".encode()).hexdigest()
    return digest[:32]


def root_span_id(trace_id: str) -> str:
    """Deterministic id for the round's root span, so phase spans can
    parent-link to it *before* the root is emitted (it is recorded
    retroactively at round end) and across manager incarnations."""
    return hashlib.sha256(f"{trace_id}/root".encode()).hexdigest()[:16]


def make_span_id() -> str:
    return os.urandom(8).hex()


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"{_TRACEPARENT_VERSION}-{trace_id}-{span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``traceparent`` → ``(trace_id, span_id)``, or None if malformed.
    Lenient on version/flags (future versions must still parse)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    trace_id, span_id = parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def current_context() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the active span, or None."""
    return _current.get()


def activate(trace_id: str, span_id: str) -> contextvars.Token:
    """Install a remote parent (e.g. from an incoming ``traceparent``)
    as the active span context; pair with :func:`deactivate`."""
    return _current.set((trace_id, span_id))


def deactivate(token: contextvars.Token) -> None:
    _current.reset(token)


def trace_headers(
    headers: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    """Header dict for an outbound HTTP call: the given headers plus
    ``traceparent`` for the active span (if any). batonlint BTL031
    requires outbound aiohttp calls made under an active span to build
    their headers through this helper."""
    out = dict(headers) if headers else {}
    ctx = _current.get()
    if ctx is not None:
        out["traceparent"] = format_traceparent(ctx[0], ctx[1])
    return out


# ---------------------------------------------------------------------------
class Span:
    """One timed operation. Finished (and recorded) via :meth:`end`;
    prefer ``with tracer.span(...)`` which ends on every path."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "service", "start", "args", "_token", "_ended")

    def __init__(self, tracer, name, trace_id, span_id, parent_id,
                 service, args) -> None:
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.service = service
        self.start = time.time()
        self.args: Dict[str, Any] = dict(args)
        self._token: Optional[contextvars.Token] = None
        self._ended = False

    def set(self, **kv: Any) -> None:
        self.args.update(kv)

    def end(self, end_time: Optional[float] = None) -> None:
        if self._ended:
            return
        self._ended = True
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self.tracer._record({
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "service": self.service,
            "start": self.start,
            "end": end_time if end_time is not None else time.time(),
            "args": self.args,
        })


class Tracer:
    """In-process span recorder for one service (one manager or worker
    incarnation). ``service`` labels every span; give each incarnation
    a distinct label (``manager#a1b2``) so a chaos test's two managers
    are distinguishable inside one trace. Timestamps are wall-clock
    (``time.time()``) so spans from different processes align."""

    def __init__(
        self,
        service: str,
        spool_dir: Optional[str] = None,
        max_spans: int = 50_000,
    ) -> None:
        self.service = service
        self.spool_dir = spool_dir
        self.max_spans = max_spans
        self._lock = threading.Lock()
        # trace_id -> list of finished span dicts (insertion order)
        self._spans: Dict[str, List[dict]] = {}
        self._n_spans = 0
        if spool_dir:
            os.makedirs(spool_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def start_span(
        self,
        name: str,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        span_id: Optional[str] = None,
        **args: Any,
    ) -> Span:
        """Manual span: caller owns closure on ALL paths (try/finally
        ``.end()`` — batonlint BTL031 checks this). Parent defaults to
        the active context; an explicit ``trace_id`` starts/joins that
        trace without touching the context."""
        ctx = _current.get()
        if trace_id is None:
            if ctx is not None:
                trace_id = ctx[0]
                if parent_id is None:
                    parent_id = ctx[1]
            else:
                trace_id = os.urandom(16).hex()
        elif parent_id is None and ctx is not None and ctx[0] == trace_id:
            parent_id = ctx[1]
        return Span(
            self, name, trace_id, span_id or make_span_id(), parent_id,
            self.service, args,
        )

    @contextmanager
    def span(
        self,
        name: str,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        span_id: Optional[str] = None,
        **args: Any,
    ):
        """``with tracer.span("broadcast"): ...`` — activates the span
        as the context for nested spans and outbound ``trace_headers``
        calls, and ends it on every exit path."""
        sp = self.start_span(
            name, trace_id=trace_id, parent_id=parent_id, span_id=span_id,
            **args,
        )
        sp._token = _current.set((sp.trace_id, sp.span_id))
        try:
            yield sp
        except BaseException as exc:
            sp.set(error=type(exc).__name__)
            raise
        finally:
            sp.end()

    def record_span(
        self,
        name: str,
        trace_id: str,
        start: float,
        end: float,
        span_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        **args: Any,
    ) -> None:
        """Record an already-timed span directly — e.g. the round's
        ROOT span, emitted retroactively at round end with its
        deterministic :func:`root_span_id` so the phase spans recorded
        during the round (possibly by a different, crashed incarnation)
        are already parent-linked to it."""
        self._record({
            "trace_id": trace_id,
            "span_id": span_id or make_span_id(),
            "parent_id": parent_id,
            "name": name,
            "service": self.service,
            "start": float(start),
            "end": float(end),
            "args": dict(args),
        })

    # ------------------------------------------------------------------
    def _record(self, span: dict) -> None:
        with self._lock:
            if self._n_spans < self.max_spans:
                self._spans.setdefault(span["trace_id"], []).append(span)
                self._n_spans += 1
            if self.spool_dir:
                # EAGER append: a killed process loses the heap, not the
                # spool — this line is why a recovered manager can still
                # export its predecessor's half of the round
                path = os.path.join(
                    self.spool_dir, f"{span['trace_id']}.jsonl"
                )
                with open(path, "a", encoding="utf-8") as fh:
                    fh.write(json.dumps(span) + "\n")

    def ingest(self, spans: List[dict]) -> int:
        """Record already-finished spans shipped from another process
        (the worker → manager upstream path). Malformed entries are
        dropped, not raised; returns the accepted count."""
        accepted = 0
        for raw in spans:
            if not isinstance(raw, dict):
                continue
            try:
                span = {
                    "trace_id": str(raw["trace_id"]),
                    "span_id": str(raw["span_id"]),
                    "parent_id": (
                        str(raw["parent_id"])
                        if raw.get("parent_id") else None
                    ),
                    "name": str(raw["name"])[:200],
                    "service": str(raw.get("service", "remote"))[:100],
                    "start": float(raw["start"]),
                    "end": float(raw["end"]),
                    "args": (
                        dict(raw["args"])
                        if isinstance(raw.get("args"), dict) else {}
                    ),
                }
            except (KeyError, TypeError, ValueError):
                continue
            if len(span["trace_id"]) != 32 or len(span["span_id"]) != 16:
                continue
            self._record(span)
            accepted += 1
        return accepted

    # ------------------------------------------------------------------
    def spans_for(self, trace_id: str) -> List[dict]:
        """All recorded spans for one trace: memory ∪ spool, deduped on
        span id (memory wins; a respooled duplicate is identical)."""
        with self._lock:
            spans = list(self._spans.get(trace_id, ()))
        seen = {s["span_id"] for s in spans}
        if self.spool_dir:
            path = os.path.join(self.spool_dir, f"{trace_id}.jsonl")
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            span = json.loads(line)
                        except ValueError:
                            continue  # torn tail write from a kill
                        sid = span.get("span_id")
                        if sid and sid not in seen:
                            seen.add(sid)
                            spans.append(span)
            except OSError:
                pass
        return sorted(spans, key=lambda s: s.get("start", 0.0))

    def export(self, trace_id: str) -> dict:
        """Chrome ``trace_event`` JSON for one trace — load the result
        straight into Perfetto / chrome://tracing. Each service becomes
        a named process; spans are complete ("X") events in µs."""
        spans = self.spans_for(trace_id)
        pids: Dict[str, int] = {}
        events: List[dict] = []
        for span in spans:
            service = span.get("service", "unknown")
            if service not in pids:
                pids[service] = len(pids) + 1
                events.append({
                    "ph": "M", "pid": pids[service], "tid": 0,
                    "name": "process_name", "args": {"name": service},
                })
            args = dict(span.get("args") or {})
            args["span_id"] = span["span_id"]
            if span.get("parent_id"):
                args["parent_id"] = span["parent_id"]
            events.append({
                "ph": "X",
                "pid": pids[service],
                "tid": 0,
                "name": span.get("name", "?"),
                "cat": "baton",
                "ts": span.get("start", 0.0) * 1e6,
                "dur": max(
                    0.0,
                    (span.get("end", 0.0) - span.get("start", 0.0)) * 1e6,
                ),
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def drain(self, trace_id: Optional[str] = None) -> List[dict]:
        """Pop finished spans from memory (the worker's shipping path).
        With a trace id: that trace's spans; without: everything."""
        with self._lock:
            if trace_id is None:
                out = [s for lst in self._spans.values() for s in lst]
                self._spans.clear()
            else:
                out = self._spans.pop(trace_id, [])
            self._n_spans -= len(out)
        return out


def gc_spool(
    spool_dir: Optional[str],
    *,
    max_age_s: float = 3600.0,
    max_files: int = 512,
    exempt=(),
    now: Optional[float] = None,
) -> int:
    """Bound the span spool: the spool grows one ``.jsonl`` per trace
    forever, so a retention tick deletes files older than ``max_age_s``
    (by mtime) and then the oldest beyond ``max_files`` — except traces
    in ``exempt`` (ids a retained forensics bundle still references;
    deleting those would hollow out served evidence). Returns the number
    of files removed; every error is ignored, retention is advisory."""
    if not spool_dir or not os.path.isdir(spool_dir):
        return 0
    now = time.time() if now is None else now
    exempt = set(exempt)
    entries = []  # (mtime, path, trace_id)
    try:
        names = os.listdir(spool_dir)
    except OSError:
        return 0
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        trace_id = name[:-len(".jsonl")]
        if trace_id in exempt:
            continue
        path = os.path.join(spool_dir, name)
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue
        entries.append((mtime, path, trace_id))
    entries.sort()  # oldest first
    removed = 0
    keep = []
    for mtime, path, trace_id in entries:
        if max_age_s is not None and now - mtime > max_age_s:
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
        else:
            keep.append(path)
    excess = len(keep) - max(0, int(max_files))
    for path in keep[:max(0, excess)]:
        try:
            os.remove(path)
            removed += 1
        except OSError:
            pass
    return removed
