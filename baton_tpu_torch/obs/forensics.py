"""Anomaly-triggered forensics bundles: capture the deep evidence *in
the moment*, because after the fact it is gone.

When a ``capture: true`` alert fires (:mod:`baton_tpu_torch.obs.alerts`),
the manager arms a capture for the **next round** and, when that round
finishes, packages one **bundle** — a content-addressed manifest of
evidence sections:

``jax_profile``
    a programmatic ``jax.profiler`` trace of the training step that ran
    while armed (armed via :func:`baton_tpu_torch.utils.profiling
    .arm_forensics_trace`, consumed by the worker's local-train call
    site; graceful no-op off-TPU and in processes where no step ran);
``task_stacks``
    an asyncio all-tasks stack dump of the capturing process — the
    "what was the loop doing" evidence for loop-lag pages;
``loop_lag``
    the loop-lag histogram snapshot (p50/p95/p99 + buckets);
``fleet_slice``
    the fleet-ledger classification slice for the implicated clients
    (the round's stragglers, or every non-healthy client);
``round_trace``
    the round's Chrome-trace export (every span across tiers);
``metric_history``
    the metrics-history window around the capture.

**Null-with-reason invariant** (same rule as :mod:`baton_tpu_torch.obs
.compute`): a section that could not be captured is ``null`` with a
sibling ``<section>_reason`` string — a silent hole in a forensics
bundle would read as "nothing happened" exactly when something did.
:func:`build_manifest` enforces it by construction and
:func:`validate_manifest` re-checks any manifest.

Bundles are **content-addressed**: the digest is the SHA-256 of the
canonical manifest JSON, served at ``GET /{name}/forensics/{digest}``.
The store keeps a bounded ring (oldest evicted); trace ids referenced
by retained bundles are exempted from the trace-spool GC
(:func:`baton_tpu_torch.utils.tracing.gc_spool`).

Pure stdlib; jax is only touched by the profiling wrappers this module
deliberately does not import.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import threading
import traceback
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set

from baton_tpu_torch.obs.compute import validate_record

__all__ = [
    "EVIDENCE_SECTIONS",
    "ForensicsStore",
    "build_manifest",
    "validate_manifest",
    "dump_asyncio_tasks",
    "profile_dir_summary",
]

#: every evidence section a bundle carries (present or null-with-reason)
EVIDENCE_SECTIONS = (
    "jax_profile",
    "task_stacks",
    "loop_lag",
    "fleet_slice",
    "round_trace",
    "metric_history",
)

_DEFAULT_REASONS = {
    "jax_profile": "no training step ran through the armed profiler",
    "task_stacks": "no running event loop to dump",
    "loop_lag": "loop-lag histogram not recorded on this node",
    "fleet_slice": "no fleet ledger on this node",
    "round_trace": "no trace recorded for the captured round",
    "metric_history": "metrics history ring empty",
}


def dump_asyncio_tasks(limit: int = 200) -> List[dict]:
    """Stack dump of every task on the current event loop — the
    "what was the process doing when the alert fired" evidence. Must be
    called from loop context; raises RuntimeError outside one (callers
    turn that into a ``*_reason``)."""
    out: List[dict] = []
    current = asyncio.current_task()
    for task in list(asyncio.all_tasks())[:limit]:
        frames = []
        for fr in task.get_stack(limit=12):
            frames.append(
                f"{fr.f_code.co_filename}:{fr.f_lineno} "
                f"{fr.f_code.co_name}"
            )
        coro = task.get_coro()
        out.append({
            "name": task.get_name(),
            "coro": getattr(coro, "__qualname__", repr(coro)),
            "current": task is current,
            "done": task.done(),
            "stack": frames,
        })
    return out


def profile_dir_summary(log_dir: Optional[str]) -> Optional[dict]:
    """What an armed ``jax.profiler`` capture actually produced: the
    directory plus every file (relative path + bytes). None when the
    directory is absent or empty — callers record the reason."""
    if not log_dir or not os.path.isdir(log_dir):
        return None
    files = []
    total = 0
    for root, _dirs, names in os.walk(log_dir):
        for name in names:
            full = os.path.join(root, name)
            try:
                size = os.path.getsize(full)
            except OSError:
                size = 0
            files.append({
                "path": os.path.relpath(full, log_dir),
                "bytes": size,
            })
            total += size
    if not files:
        return None
    files.sort(key=lambda f: f["path"])
    return {"log_dir": log_dir, "files": files, "total_bytes": total}


def validate_manifest(manifest: dict) -> List[str]:
    """Violations of the bundle contract (empty list = valid): every
    declared evidence section present in ``sections``, and every null
    section excused by a ``<name>_reason`` sibling."""
    bad: List[str] = []
    sections = manifest.get("sections")
    if not isinstance(sections, dict):
        return ["manifest has no `sections` object"]
    for name in EVIDENCE_SECTIONS:
        if name not in sections:
            bad.append(f"evidence section {name!r} missing entirely")
    bad.extend(validate_record(sections))
    return bad


def build_manifest(
    *,
    rule: str,
    severity: str = "warn",
    round_name: Optional[str] = None,
    trace_id: Optional[str] = None,
    node: str = "manager",
    armed_ts: Optional[float] = None,
    captured_ts: Optional[float] = None,
    sections: Optional[Dict[str, Any]] = None,
    reasons: Optional[Dict[str, str]] = None,
) -> dict:
    """Assemble one bundle manifest. ``sections`` holds whatever
    evidence WAS captured; anything absent or None becomes
    null-with-reason (caller-supplied ``reasons`` first, then the
    section's stock reason). Raises if the result would break the
    invariant — unreachable via this builder, kept as a guard."""
    sections = sections or {}
    reasons = reasons or {}
    body: Dict[str, Any] = {}
    for name in EVIDENCE_SECTIONS:
        val = sections.get(name)
        if val is not None:
            body[name] = val
        else:
            body[name] = None
            body[f"{name}_reason"] = (
                reasons.get(name) or _DEFAULT_REASONS[name]
            )
    manifest = {
        "rule": rule,
        "severity": severity,
        "round": round_name,
        "trace_id": trace_id,
        "node": node,
        "armed_ts": armed_ts,
        "captured_ts": captured_ts,
        "sections_present": sum(
            1 for name in EVIDENCE_SECTIONS if body[name] is not None
        ),
        "sections": body,
    }
    if round_name is None:
        manifest["round_reason"] = reasons.get(
            "round", "captured outside a finished round"
        )
    if trace_id is None:
        manifest["trace_id_reason"] = reasons.get(
            "trace_id", "no trace id for the captured round"
        )
    if armed_ts is None:
        manifest["armed_ts_reason"] = "capture was not pre-armed"
    if captured_ts is None:
        manifest["captured_ts_reason"] = "capture time unrecorded"
    violations = validate_manifest(manifest)
    if violations:  # by-construction guard
        raise ValueError(
            f"forensics manifest breaks null-with-reason: {violations}"
        )
    return manifest


class ForensicsStore:
    """Bounded, content-addressed bundle store.

    ``put`` digests the canonical manifest JSON (sha256, 32 hex chars —
    same shape as trace ids) and retains the newest ``max_bundles``;
    with a ``dir_path`` each manifest is also persisted as
    ``<digest>.json`` (one write + atomic rename) so bundles survive a
    process restart and ride CI artifact uploads. Thread-safe."""

    def __init__(
        self,
        dir_path: Optional[str] = None,
        max_bundles: int = 16,
    ) -> None:
        self.dir_path = dir_path
        self.max_bundles = max(1, int(max_bundles))
        self._bundles: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()
        if dir_path:
            os.makedirs(dir_path, exist_ok=True)

    @staticmethod
    def digest_of(manifest: dict) -> str:
        blob = json.dumps(
            {k: v for k, v in manifest.items() if k != "digest"},
            sort_keys=True, default=repr,
        ).encode("utf-8")
        return hashlib.sha256(blob).hexdigest()[:32]

    def put(self, manifest: dict) -> str:
        violations = validate_manifest(manifest)
        if violations:
            raise ValueError(
                f"refusing to store invalid forensics bundle: {violations}"
            )
        digest = self.digest_of(manifest)
        stored = dict(manifest, digest=digest)
        evicted: List[str] = []
        with self._lock:
            self._bundles[digest] = stored
            self._bundles.move_to_end(digest)
            while len(self._bundles) > self.max_bundles:
                old, _ = self._bundles.popitem(last=False)
                evicted.append(old)
        if self.dir_path:
            path = os.path.join(self.dir_path, f"{digest}.json")
            tmp = f"{path}.tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(stored, fh, indent=2, default=repr)
                fh.write("\n")
            os.replace(tmp, path)
            for old in evicted:
                try:
                    os.remove(os.path.join(self.dir_path, f"{old}.json"))
                except OSError:
                    pass
        return digest

    def get(self, digest: str) -> Optional[dict]:
        with self._lock:
            found = self._bundles.get(digest)
            if found is not None:
                return found
        if self.dir_path:
            path = os.path.join(self.dir_path, f"{digest}.json")
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    return json.load(fh)
            except (OSError, ValueError):
                return None
        return None

    def list_bundles(self) -> List[dict]:
        """Newest-first index (digest + headline fields, no sections)."""
        with self._lock:
            items = list(self._bundles.values())
        return [
            {
                "digest": b.get("digest"),
                "rule": b.get("rule"),
                "severity": b.get("severity"),
                "round": b.get("round"),
                "trace_id": b.get("trace_id"),
                "captured_ts": b.get("captured_ts"),
                "sections_present": b.get("sections_present"),
            }
            for b in reversed(items)
        ]

    def referenced_trace_ids(self) -> Set[str]:
        """Trace ids any retained bundle still points at — the spool-GC
        exemption set (a GC'd round trace would hollow out the bundle's
        ``round_trace`` evidence)."""
        with self._lock:
            return {
                b["trace_id"] for b in self._bundles.values()
                if b.get("trace_id")
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._bundles)


def safe_repr_exc(exc: BaseException) -> str:
    """One-line capture-failure description for ``*_reason`` fields."""
    line = traceback.format_exception_only(type(exc), exc)
    return (line[-1].strip() if line else repr(exc))[:200]
