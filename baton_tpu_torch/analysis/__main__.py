"""batonlint CLI: ``python -m baton_tpu_torch.analysis [paths...]``.

Exit codes: 0 clean, 1 findings, 2 engine/usage errors — so CI can
fail the build on any finding while distinguishing broken invocations.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
from typing import List, Optional

from baton_tpu_torch.analysis.engine import (
    all_rules,
    apply_baseline,
    finding_fingerprints,
    format_json,
    format_text,
    run_paths,
)


def _load_baseline(path: str) -> Optional[List[str]]:
    """Committed baseline fingerprints: ``{"version": 1,
    "fingerprints": [...]}`` (a bare JSON list is also accepted);
    None on unreadable/malformed input."""
    try:
        data = json.loads(
            pathlib.Path(path).read_text(encoding="utf-8")
        )
    except (OSError, ValueError):
        return None
    if isinstance(data, list):
        return [str(x) for x in data]
    if isinstance(data, dict) and isinstance(
        data.get("fingerprints"), list
    ):
        return [str(x) for x in data["fingerprints"]]
    return None


def _git_changed_files() -> Optional[List[str]]:
    """Python files touched vs HEAD (staged + unstaged + untracked),
    absolute paths; None when git is unavailable — the caller falls
    back to a full lint rather than silently checking nothing."""
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=30,
        )
        if top.returncode != 0:
            return None
        root = pathlib.Path(top.stdout.strip())
        out: List[str] = []
        for cmd in (
            ["git", "diff", "--name-only", "HEAD", "--"],
            ["git", "ls-files", "--others", "--exclude-standard"],
        ):
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=30, cwd=root
            )
            if proc.returncode != 0:
                return None
            out.extend(
                str(root / line)
                for line in proc.stdout.splitlines()
                if line.endswith(".py")
            )
        return sorted(set(out))
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m baton_tpu_torch.analysis",
        description=(
            "batonlint: AST invariant checks for event-loop, wire-cap, "
            "lock, JAX-tracer, and metrics hygiene"
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=["baton_tpu"],
        help="files or directories to lint (default: baton_tpu)",
    )
    parser.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="report format (default: text)",
    )
    parser.add_argument(
        "--select",
        action="append",
        metavar="RULE",
        help="run only these rule ids (repeatable, e.g. --select BTL020)",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule table and exit",
    )
    parser.add_argument(
        "--changed-only",
        action="store_true",
        help=(
            "report findings only in files changed per git (diff vs "
            "HEAD + untracked); the whole project is still loaded so "
            "cross-module rules stay sound"
        ),
    )
    parser.add_argument(
        "--json-out",
        metavar="FILE",
        help="additionally write the JSON report to FILE (CI artifact)",
    )
    parser.add_argument(
        "--sarif",
        metavar="FILE",
        help="additionally write a SARIF 2.1.0 report to FILE",
    )
    parser.add_argument(
        "--baseline",
        metavar="FILE",
        help=(
            "fail only on findings whose fingerprint is absent from "
            "this committed baseline (see --write-baseline); "
            "baselined findings are counted, not printed"
        ),
    )
    parser.add_argument(
        "--write-baseline",
        metavar="FILE",
        help=(
            "write the current findings' fingerprints to FILE and "
            "exit 0 — the debt snapshot --baseline diffs against"
        ),
    )
    parser.add_argument(
        "--cache",
        metavar="FILE",
        nargs="?",
        const=".batonlint_cache.json",
        default=None,
        help=(
            "incremental summary cache keyed by file content hash "
            "(default file when given bare: .batonlint_cache.json); "
            "hit/miss counts appear in the JSON report"
        ),
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, title in all_rules().items():
            print(f"{rule}  {title}")
        return 0

    only_paths = None
    if args.changed_only:
        only_paths = _git_changed_files()
        if only_paths is None:
            print(
                "batonlint: --changed-only: git unavailable, "
                "linting everything",
                file=sys.stderr,
            )

    try:
        report = run_paths(args.paths, rules=args.select,
                           only_paths=only_paths,
                           cache_path=args.cache)
    except KeyError as exc:
        print(f"batonlint: {exc.args[0]}", file=sys.stderr)
        return 2

    if args.write_baseline:
        payload = {
            "version": 1,
            "fingerprints": sorted(
                finding_fingerprints(report.findings)
            ),
        }
        try:
            pathlib.Path(args.write_baseline).write_text(
                json.dumps(payload, indent=2) + "\n", encoding="utf-8"
            )
        except OSError as exc:
            print(
                f"batonlint: cannot write {args.write_baseline}: {exc}",
                file=sys.stderr,
            )
            return 2
        print(
            f"batonlint: baseline of {len(report.findings)} "
            f"fingerprint(s) written to {args.write_baseline}"
        )
        return 0

    if args.baseline:
        fingerprints = _load_baseline(args.baseline)
        if fingerprints is None:
            print(
                f"batonlint: unreadable baseline {args.baseline}",
                file=sys.stderr,
            )
            return 2
        apply_baseline(report, fingerprints)

    if args.json_out:
        try:
            pathlib.Path(args.json_out).write_text(
                format_json(report) + "\n", encoding="utf-8"
            )
        except OSError as exc:
            print(f"batonlint: cannot write {args.json_out}: {exc}",
                  file=sys.stderr)
            return 2

    if args.sarif:
        from baton_tpu_torch.analysis.sarif import format_sarif

        try:
            pathlib.Path(args.sarif).write_text(
                format_sarif(report) + "\n", encoding="utf-8"
            )
        except OSError as exc:
            print(f"batonlint: cannot write {args.sarif}: {exc}",
                  file=sys.stderr)
            return 2

    print(format_json(report) if args.format == "json" else format_text(report))
    if report.errors:
        return 2
    return 0 if not report.findings else 1


if __name__ == "__main__":
    sys.exit(main())
