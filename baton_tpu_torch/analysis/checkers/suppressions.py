"""BTL000 — stale ``# batonlint: allow[...]`` suppression.

A suppression that silences nothing is a finding in its own right: it
documents a hazard that no longer exists (or never did), and — worse —
it will silently absorb the NEXT real instance of that rule introduced
on its line.  Every rule upgrade that fixes a false positive should
therefore be paired with deleting the allows it obsoletes; BTL000
enforces that pairing.

The audit itself lives in the engine (:func:`~baton_tpu_torch.analysis.
engine._audit_suppressions`) because it needs the complete
suppression-usage marks from every other checker's pass; this class
only registers the rule id so ``--select BTL000`` and the rule table
work.  A named token is audited only when its rule ran this pass
without crashing, ``allow[*]`` is stale when the line silenced nothing,
and ``allow[BTL000]`` tokens are never audited (no sound way to
self-audit) — which also means a justified-but-currently-quiet allow
can be kept by adding BTL000 to its token list.
"""

from __future__ import annotations

from typing import Iterable

from baton_tpu_torch.analysis.engine import (
    Checker,
    CheckContext,
    Finding,
    register,
)


@register
class StaleSuppressionChecker(Checker):
    rule = "BTL000"
    title = "allow[...] suppression that no longer silences anything"

    def check(self, ctx: CheckContext) -> Iterable[Finding]:
        return ()  # engine-integrated: see _audit_suppressions
