"""BTL020 — uncapped request-body reads in aiohttp handlers.

``await request.read()`` / ``await request.json()`` buffer the entire
body in memory before any size check runs — one oversized (or
malicious) POST can OOM the manager and take the whole cohort down
with it. Every ingest path must go through
``baton_tpu_torch.server.utils.read_body_capped`` /
``read_json_capped``, which enforce both a Content-Length precheck and
a streamed hard cut-off and surface a 413.

The rule flags awaited ``.read()`` / ``.json()`` / ``.text()`` /
``.post()`` calls on a receiver that names an aiohttp request
(``request``, ``req``, ``self.request``, ``web_request``) anywhere
under ``server/``. The capped helpers themselves carry a
``# batonlint: allow[BTL020]`` at the one spot that legitimately
performs the raw read.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from baton_tpu_torch.analysis import _astutil as au
from baton_tpu_torch.analysis.engine import Checker, CheckContext, Finding, register

_BODY_METHODS = {"read", "json", "text", "post"}
_REQUEST_NAMES = {"request", "req", "web_request", "http_request"}


def _is_request_receiver(expr: ast.AST) -> bool:
    name = au.dotted_name(expr)
    if name is None:
        return False
    leaf = name.rsplit(".", 1)[-1]
    return leaf in _REQUEST_NAMES


@register
class WireCapChecker(Checker):
    rule = "BTL020"
    title = "uncapped aiohttp request-body read in baton_tpu_torch/server/"

    def applies_to(self, ctx: CheckContext) -> bool:
        return "server" in ctx.parts

    def check(self, ctx: CheckContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Await):
                continue
            call = node.value
            if not isinstance(call, ast.Call):
                continue
            func = call.func
            if not (
                isinstance(func, ast.Attribute)
                and func.attr in _BODY_METHODS
                and _is_request_receiver(func.value)
            ):
                continue
            recv = au.dotted_name(func.value)
            findings.append(
                Finding(
                    self.rule, ctx.path, call.lineno, call.col_offset,
                    f"uncapped `await {recv}.{func.attr}()` buffers an "
                    f"unbounded request body; use read_body_capped / "
                    f"read_json_capped (413 on oversize) or suppress "
                    f"with '# batonlint: allow[BTL020]'",
                )
            )
        return findings
