"""Run a reference test module's cases against the port's carried copies
(not a test module).

:func:`port_cases` compiles ``tests/<file>`` with the port's import
rewrite (``baton_tpu.`` -> ``baton_tpu_torch.``) and returns its test
functions and fixtures, for a ``tests/test_torch_*.py`` module to expose
with ``globals().update(...)``. A case that does not apply to the port
(a socket case, the JAX package's pytree bridge) is left out with its
reason. An edit to the reference's cases reaches the port's run at once.

Where a case meets the port at a seam (a JAX key where the port takes a
``torch.Generator``, an entry point that needs ``device="cpu"`` on this
machine, a socket test that must run under a wall-clock limit), ``seams``
replaces the reference's text: each ``(old, new)`` pair must match the
source at least once, so a change of the reference shows as an error
here rather than as a case that silently no longer reaches the port.
"""

from __future__ import annotations

import re
from pathlib import Path

TESTS = Path(__file__).resolve().parent


def rewrite(source: str) -> str:
    """The import rewrite the port applies to a carried module."""
    return re.sub(r"\bbaton_tpu(?=[./])", "baton_tpu_torch", source)


def port_cases(ref_file: str, left_out: dict, seams=(), extra_globals=None) -> dict:
    """The names ``tests/<ref_file>`` defines, compiled against the port,
    without the cases in ``left_out`` ({test name: why it does not
    apply}), with every ``(old, new)`` of ``seams`` replaced in the
    rewritten source and ``extra_globals`` defined beside its own."""
    path = TESTS / ref_file
    source = rewrite(path.read_text())
    for old, new in seams:
        if old not in source:
            raise KeyError(f"{ref_file} no longer holds {old!r}")
        source = source.replace(old, new)
    ns = {"__name__": "port_" + path.stem, "__file__": str(path), **(extra_globals or {})}
    exec(compile(source, str(path), "exec"), ns)
    for name in left_out:
        if not name.startswith("test_") or name not in ns:
            raise KeyError(f"{ref_file} has no case {name}")
        del ns[name]
    return {k: v for k, v in ns.items() if not k.startswith("__")}
