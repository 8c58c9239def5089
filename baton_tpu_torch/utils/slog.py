"""Structured JSON logging + the per-round SLO record appender.

Two small, dependency-free pieces:

- :class:`JsonFormatter` / :func:`setup_json_logging` — one JSON object
  per log line with ``trace_id``/``span_id`` correlation fields pulled
  from the active tracing context (:mod:`baton_tpu_torch.utils.tracing`), so
  a grep for a round's trace id yields its logs across manager and
  workers.
- :class:`RoundsLog` — thread-safe appender for ``rounds.jsonl``, the
  per-round SLO summary artifact (one JSON object per finished/aborted
  round) that the ROADMAP's scenario harness consumes. Appends are a
  few hundred bytes once per round; they are written inline under a
  lock with an fsync-free flush.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from baton_tpu_torch.utils import tracing

_RESERVED = frozenset(
    logging.LogRecord(
        "", 0, "", 0, "", (), None
    ).__dict__
) | {"message", "asctime", "taskName"}


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts, level, logger, msg, any ``extra``
    fields, plus trace/span correlation from the active span context."""

    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        ctx = tracing.current_context()
        if ctx is not None:
            out["trace_id"], out["span_id"] = ctx
        for key, val in record.__dict__.items():
            if key not in _RESERVED and not key.startswith("_"):
                try:
                    json.dumps(val)
                except (TypeError, ValueError):
                    val = repr(val)
                out[key] = val
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=repr)


def setup_json_logging(
    logger: Optional[logging.Logger] = None,
    level: int = logging.INFO,
    stream: Any = None,
) -> logging.Handler:
    """Attach a JSON-formatted stream handler (idempotent per logger:
    an existing JsonFormatter handler is reused)."""
    logger = logger if logger is not None else logging.getLogger("baton_tpu")
    for handler in logger.handlers:
        if isinstance(handler.formatter, JsonFormatter):
            return handler
    handler = logging.StreamHandler(stream)
    handler.setFormatter(JsonFormatter())
    logger.addHandler(handler)
    logger.setLevel(level)
    return handler


class RoundsLog:
    """Append-only ``rounds.jsonl`` writer. Each record is one round's
    SLO summary (see :meth:`baton_tpu_torch.server.http_manager.Experiment`'s
    ``_emit_slo_record`` for the schema); ``wall_ts`` is stamped here
    so callers never race the clock."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    def append(self, record: Dict[str, Any]) -> None:
        # Crash-safety: the full line (terminator included) goes down in
        # ONE write() followed by a flush, so a reader racing the writer
        # — or a crash mid-record — can tear at most the final line,
        # never interleave two records.
        data = json.dumps(
            dict(record, wall_ts=round(time.time(), 6)), default=repr
        ) + "\n"
        with self._lock:
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(data)
                fh.flush()

    def read_all(self) -> list:
        """Parse every record back (test/harness convenience). Torn or
        malformed lines are skipped, not raised; use
        :func:`read_rounds_jsonl` when the torn-line count matters."""
        return read_rounds_jsonl(self.path)[0]

    def maybe_rotate(self, max_bytes: int) -> bool:
        """Size-bounded rotation under the appender's own lock: when the
        file exceeds ``max_bytes`` it moves to ``<path>.1`` (replacing
        any previous rotation) and appends restart fresh. One
        generation is enough — readers are torn-line-tolerant and the
        SLO harness consumes the live file within a run."""
        return maybe_rotate_jsonl(self.path, max_bytes, lock=self._lock)


def maybe_rotate_jsonl(
    path: str,
    max_bytes: int,
    lock: Optional[threading.Lock] = None,
) -> bool:
    """Rotate ``path`` to ``path.1`` when it exceeds ``max_bytes``
    (``os.replace`` — atomic on POSIX). Returns True when a rotation
    happened. Advisory: every OS error is swallowed, a retention tick
    must never take its owner down."""
    if not max_bytes or max_bytes <= 0:
        return False
    ctx = lock if lock is not None else threading.Lock()
    with ctx:
        try:
            if os.path.getsize(path) <= max_bytes:
                return False
            os.replace(path, path + ".1")
            return True
        except OSError:
            return False


def read_rounds_jsonl(path: str) -> tuple:
    """Tolerant ``rounds.jsonl`` reader: returns ``(records, n_torn)``.

    A crash mid-append (or a reader racing the writer's final line) can
    leave a torn trailing line; report it rather than raising so an SLO
    evaluation over a crashed run still sees every complete record.
    """
    records, n_torn = [], 0
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    n_torn += 1
    except OSError:
        pass
    return records, n_torn
