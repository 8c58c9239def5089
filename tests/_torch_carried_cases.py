"""Run a reference test module's cases against the port's carried copies
(not a test module).

:func:`port_cases` compiles ``tests/<file>`` with the port's import
rewrite (``baton_tpu.`` -> ``baton_tpu_torch.``) and returns its test
functions and fixtures, for a ``tests/test_torch_*.py`` module to expose
with ``globals().update(...)``. A case that does not apply to the port
(a socket case, the JAX package's pytree bridge) is left out with its
reason. An edit to the reference's cases reaches the port's run at once.
"""

from __future__ import annotations

import re
from pathlib import Path

TESTS = Path(__file__).resolve().parent


def rewrite(source: str) -> str:
    """The import rewrite the port applies to a carried module."""
    return re.sub(r"\bbaton_tpu(?=[./])", "baton_tpu_torch", source)


def port_cases(ref_file: str, left_out: dict) -> dict:
    """The names ``tests/<ref_file>`` defines, compiled against the port,
    without the cases in ``left_out`` ({test name: why it does not
    apply})."""
    path = TESTS / ref_file
    ns = {"__name__": "port_" + path.stem, "__file__": str(path)}
    exec(compile(rewrite(path.read_text()), str(path), "exec"), ns)
    for name in left_out:
        if not name.startswith("test_") or name not in ns:
            raise KeyError(f"{ref_file} has no case {name}")
        del ns[name]
    return {k: v for k, v in ns.items() if not k.startswith("__")}
