"""batonlint rule modules — importing this package registers them all.

Adding a checker: create a module here, subclass
:class:`baton_tpu_torch.analysis.engine.Checker`, decorate it with
``@register``, and import the module below. Give the rule a stable
``BTLxxx`` id (001-009 event-loop, 010-019 JAX, 020-029 wire, 030-039
observability) and add known-bad/known-good fixtures to
``tests/test_analysis.py``.
"""

from baton_tpu_torch.analysis.checkers import (  # noqa: F401
    alertrules,
    blocking,
    contexts,
    counters,
    deadcode,
    donation,
    exemplars,
    locks,
    races,
    runbooks,
    spans,
    staleness,
    suppressions,
    tracer,
    wirecap,
)
