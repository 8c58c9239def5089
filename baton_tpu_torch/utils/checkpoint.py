"""Round-granular checkpoint/resume (the port of
``baton_tpu/utils/checkpoint.py``).

The full experiment state — global params, server optimizer state
(FedOpt), round counter, loss history, and any ``extra`` state of a
federation mode — is written per round and restored on boot, so a
manager restart resumes the federation where it stopped.

The reference writes orbax checkpoints; this port writes one
``torch.save`` file per step (``<directory>/<step>.pt``), first to a
temporary name, flushed to disk and then moved into place with
``os.replace`` (the directory flushed after it), so a step exists whole
or not at all, across a host crash too. Should the newest step still
not load, ``restore()`` falls back to the step before it. The API is the
reference's. Orbax's files are not read here, nor are these files
readable by orbax.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import threading
from typing import Any, Optional

import numpy as np
import torch

Params = Any

_STEP_FILE = re.compile(r"^(\d+)\.pt$")

log = logging.getLogger(__name__)


@dataclasses.dataclass
class RestoredState:
    """What :meth:`Checkpointer.restore` hands back."""

    step: int
    params: Params
    server_opt_state: Any
    meta: dict
    extra: Any = None


def _to_cpu(tree):
    """Nested dicts/lists/tuples with their tensors (and numpy arrays)
    moved to CPU tensors."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    return tree


def _like(saved, template):
    """``saved`` laid out as ``template``: each tensor on the template's
    device (numpy where the template holds numpy)."""
    if template is None:
        return saved
    if isinstance(template, dict):
        return {k: _like(saved[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(s, t) for s, t in zip(saved, template))
    if isinstance(template, torch.Tensor):
        return saved.to(template.device)
    if isinstance(template, np.ndarray):
        return saved.numpy()
    return saved


class Checkpointer:
    """Save/restore federated experiment state per round.

    ``directory`` is created if needed; the newest ``max_to_keep`` steps
    are kept and older ones deleted. Every save is synchronous: a
    checkpoint either fully exists or not at all (temporary file, fsync,
    ``os.replace``).
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        # saves may come from several threads (the HTTP manager saves off
        # its event loop): one at a time, so pruning never races a write
        self._lock = threading.Lock()
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    # ------------------------------------------------------------------
    def save(
        self,
        step: int,
        params: Params,
        server_opt_state: Any = None,
        meta: Optional[dict] = None,
        wait: bool = True,
        extra: Any = None,
    ) -> None:
        """``extra`` is any additional tree riding the checkpoint — the
        slot for federation-mode state the globals don't capture (a FedPer
        personal stack, stateful clients' optimizer states, clustered
        params). ``wait`` is accepted for the reference's API; every save
        here has finished when it returns."""
        del wait
        items = {"params": _to_cpu(params), "meta": dict(meta or {})}
        if server_opt_state is not None:
            items["server_opt"] = _to_cpu(server_opt_state)
        if extra is not None:
            items["extra"] = _to_cpu(extra)
        tmp = os.path.join(self.directory, f".{int(step)}.pt.tmp")
        with self._lock:
            with open(tmp, "wb") as f:
                torch.save(items, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))
            dir_fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(self._path(old))

    # ------------------------------------------------------------------
    def all_steps(self):
        return sorted(
            int(m.group(1))
            for m in map(_STEP_FILE.match, os.listdir(self.directory))
            if m is not None
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        params_template: Params,
        server_opt_template: Any = None,
        step: Optional[int] = None,
        extra_template: Any = None,
    ) -> Optional[RestoredState]:
        """Restore ``step`` (default: the latest step that loads; an
        unreadable newer one is logged and passed over). Returns None when
        the directory holds no checkpoints — callers fall through to fresh
        init. Templates give each tensor's device. A step saved without
        server optimizer state (the HTTP manager's) restores with
        ``server_opt_state=None``, so a FedOpt run pointed at it starts
        its optimizer afresh; the same holds for ``extra``."""
        if step is not None:
            saved = self._load(step)
        else:
            steps = self.all_steps()
            if not steps:
                return None
            for step in reversed(steps):
                try:
                    saved = self._load(step)
                    break
                except Exception as e:  # torch.load raises EOF, zip or pickle errors
                    if step == steps[0]:
                        raise
                    log.warning("checkpoint step %d does not load (%s); "
                                "trying the step before it", step, e)
        server_opt = None
        if server_opt_template is not None and "server_opt" in saved:
            server_opt = _like(saved["server_opt"], server_opt_template)
        extra = None
        if extra_template is not None and "extra" in saved:
            extra = _like(saved["extra"], extra_template)
        return RestoredState(
            step=int(step),
            params=_like(saved["params"], params_template),
            server_opt_state=server_opt,
            meta=saved["meta"] or {},
            extra=extra,
        )

    def _load(self, step: int) -> dict:
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Nothing is in flight once ``save`` returns; kept for the
        reference's API."""

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
