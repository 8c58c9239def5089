"""SARIF 2.1.0 reporter for batonlint.

One ``run`` with batonlint as the tool driver, one ``result`` per
finding, one ``reportingDescriptor`` per registered rule, and one
``toolExecutionNotification`` per engine error — enough for code
scanning UIs to ingest findings with stable rule ids and clickable
regions.  Columns are 1-based in SARIF; batonlint columns are 0-based
AST offsets, hence the ``+1``.
"""

from __future__ import annotations

import json
import pathlib

from baton_tpu_torch.analysis.engine import (
    Report,
    all_rules,
    finding_fingerprints,
)

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def _artifact_uri(path: str) -> str:
    return pathlib.PurePath(path).as_posix()


def sarif_dict(report: Report) -> dict:
    rules = all_rules()
    results = []
    fps = finding_fingerprints(report.findings)
    for f, fp in zip(report.findings, fps):
        results.append({
            "ruleId": f.rule,
            "level": "warning",
            "message": {"text": f.message},
            "partialFingerprints": {"batonlintFingerprint/v1": fp},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": _artifact_uri(f.path),
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {
                        "startLine": f.line,
                        "startColumn": f.col + 1,
                    },
                },
            }],
        })
    notifications = [
        {
            "level": "error",
            "message": {"text": err},
        }
        for err in report.errors
    ]
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "batonlint",
                    "informationUri":
                        "https://github.com/baton-tpu/baton-tpu",
                    "rules": [
                        {
                            "id": rule,
                            "shortDescription": {"text": title},
                        }
                        for rule, title in sorted(rules.items())
                    ],
                },
            },
            "originalUriBaseIds": {
                "SRCROOT": {"uri": "file:///"},
            },
            "invocations": [{
                "executionSuccessful": not report.errors,
                "toolExecutionNotifications": notifications,
            }],
            "results": results,
        }],
    }


def format_sarif(report: Report) -> str:
    return json.dumps(sarif_dict(report), indent=2, sort_keys=True)
