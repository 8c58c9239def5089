"""Live fleet ops console: ``python -m baton_tpu_torch.ops``.

Polls the root manager and any number of edges over plain HTTP —
``GET …/metrics``, ``GET …/fleet/health`` — plus (optionally) the
manager's ``rounds.jsonl``, and renders a top-like terminal view:
round throughput, per-tier phase counters, the compute plane (per-node
MFU, samples/sec/chip, peak HBM, recompile-storm flag from the
``compute_*`` gauges), and every known client with its fleet-health
classification (healthy / slow / flaky / degrading / inactive) and the
reason string the anomaly scorer produced.

Live mode polls metrics history as a DELTA: each refresh passes the
previous poll's ``ts`` as ``/metrics/history?since=<ts>`` so only new
samples cross the wire, never the full ring.

Two modes:

- **live** (default): clear-screen redraw every ``--interval`` seconds
  until interrupted — the operator's ``top`` for a federation.
- **``--once --json``**: one poll, machine-readable JSON on stdout
  (including each node's ``/alerts`` state), exit 0 only when every
  polled node answered AND no ``severity: page`` alert is firing
  anywhere in the fleet — usable as a CI smoke probe
  (``scripts/smoke_trace.py`` runs exactly this).

stdlib-only on purpose (``urllib``, no aiohttp, no asyncio): the
console must work from any operator shell that can ``python -m``, even
one without the serving stack's event-loop context.

URLs name the experiment base, e.g. ``http://127.0.0.1:8473/fedmodel``
— the console appends ``/metrics`` and ``/fleet/health`` itself.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

__all__ = ["fetch_json", "poll_node", "poll_fleet", "firing_alerts",
           "render", "main"]

#: severity order for the client table (worst first)
_STATUS_ORDER = {"slow": 0, "flaky": 1, "degrading": 2, "healthy": 3,
                 "inactive": 4}
_STATUS_COLOR = {"slow": "\x1b[31m", "flaky": "\x1b[35m",
                 "degrading": "\x1b[33m", "healthy": "\x1b[32m",
                 "inactive": "\x1b[2m"}
_RESET = "\x1b[0m"


def fetch_json(url: str, timeout_s: float = 3.0) -> Optional[dict]:
    """GET one JSON document; None on any transport/decode failure —
    a dead node is a *row* in the console, never a crash."""
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except (urllib.error.URLError, OSError, ValueError):
        return None


def poll_node(
    base_url: str,
    timeout_s: float = 3.0,
    history_since: Optional[float] = None,
) -> dict:
    """One node's ``/metrics`` + ``/fleet/health``, tagged with
    reachability (``up``) so the renderer can show dead tiers.
    ``history_since`` additionally fetches the metrics-history DELTA
    (``/metrics/history?since=<ts>``) — only samples newer than the
    previous poll, never the full ring."""
    base = base_url.rstrip("/")
    metrics = fetch_json(f"{base}/metrics", timeout_s)
    health = fetch_json(f"{base}/fleet/health", timeout_s)
    out = {
        "url": base,
        "up": metrics is not None,
        "metrics": metrics,
        "health": health,
        # alerting plane (None against a pre-alerts node — renderable)
        "alerts": fetch_json(f"{base}/alerts", timeout_s),
        # runbook/actuation plane (None against a pre-runbooks node)
        "runbooks": fetch_json(f"{base}/runbooks", timeout_s),
        # replication plane (None against a non-HA node — renderable)
        "replication": fetch_json(f"{base}/replication", timeout_s),
    }
    if history_since is not None:
        out["history"] = fetch_json(
            f"{base}/metrics/history?since={history_since:.6f}", timeout_s
        )
    return out


def _tail_rounds(path: Optional[str], n: int = 5) -> List[dict]:
    if not path:
        return []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            lines = fh.readlines()
    except OSError:
        return []
    out: List[dict] = []
    for line in lines[-n:]:
        try:
            out.append(json.loads(line))
        except ValueError:
            continue  # torn final line from a crash mid-append
    return out


def poll_fleet(
    root: str,
    edges: List[str],
    rounds_path: Optional[str] = None,
    timeout_s: float = 3.0,
    history_since: Optional[float] = None,
) -> dict:
    """The full console state for one poll — also the ``--json``
    payload, so the interactive view and the CI probe can never
    drift apart. ``history_since`` (the previous poll's ``ts``) makes
    the root poll fetch only new metrics-history samples."""
    return {
        "ts": round(time.time(), 3),
        "root": poll_node(root, timeout_s, history_since=history_since),
        "edges": [poll_node(e, timeout_s) for e in edges],
        "rounds_tail": _tail_rounds(rounds_path),
    }


# -- rendering ---------------------------------------------------------
def _fmt_s(v: Any) -> str:
    if isinstance(v, (int, float)):
        return f"{v:8.3f}s"
    return "       --"


def _counter(node: dict, name: str) -> float:
    m = node.get("metrics") or {}
    return float((m.get("counters") or {}).get(name, 0.0))


def _gauge(node: dict, name: str) -> Optional[float]:
    m = node.get("metrics") or {}
    v = (m.get("gauges") or {}).get(name)
    return float(v) if isinstance(v, (int, float)) else None


def _fmt_num(v: Any, fmt: str = "{:.3f}") -> str:
    if isinstance(v, (int, float)):
        return fmt.format(v)
    return "--"


def _compute_line(node: dict, label: str) -> Optional[str]:
    """The per-node compute pane row: last-round MFU / throughput /
    HBM gauges plus the recompile-storm flag. None when the node has
    never published a compute gauge (pre-compute managers stay
    renderable)."""
    mfu = _gauge(node, "compute_mfu")
    sps = _gauge(node, "compute_samples_per_sec_per_chip")
    hbm = _gauge(node, "compute_peak_hbm_gb")
    steps = _gauge(node, "compute_steps")
    reporters = _gauge(node, "compute_reporters")
    storm = _gauge(node, "compute_recompile_storm")
    if all(v is None for v in (mfu, sps, hbm, steps, reporters, storm)):
        return None
    storm_s = "STORM" if storm else "no"
    return (
        f"  compute[{label}]: mfu={_fmt_num(mfu)}  "
        f"sps/chip={_fmt_num(sps, '{:.1f}')}  "
        f"hbm={_fmt_num(hbm, '{:.2f}')}GiB  "
        f"steps={_fmt_num(steps, '{:.0f}')}  "
        f"reporters={_fmt_num(reporters, '{:.0f}')}  "
        f"recompile-storm={storm_s}"
    )


def _replication_line(node: dict, label: str) -> Optional[str]:
    """The per-node replication pane row: role / epoch / WAL positions
    / standby lag. None when the node has no ``/replication`` endpoint
    or HA is not configured (pre-replication managers stay
    renderable)."""
    rep = node.get("replication")
    if not isinstance(rep, dict) or rep.get("role") is None:
        return None
    role = str(rep.get("role", "?"))
    epoch = rep.get("epoch")
    wal = rep.get("wal") or {}
    parts = [
        f"  replication[{label}]: role={role}",
        f"epoch={_fmt_num(epoch, '{:.0f}')}",
    ]
    if role == "active":
        targets = wal.get("targets") or {}
        shipped = wal.get("min_shipped_offset")
        parts.append(f"standbys={len(targets)}")
        parts.append(f"shipped_offset={_fmt_num(shipped, '{:.0f}')}")
    else:
        parts.append(
            f"applied_offset={_fmt_num(wal.get('applied_offset'), '{:.0f}')}")
        parts.append(f"lag={_fmt_num(wal.get('lag_s'))}s")
    lease = rep.get("lease") or {}
    if lease:
        parts.append(f"lease_holder={lease.get('holder', '?')}")
    return "  ".join(parts)


def firing_alerts(state: dict, severity: Optional[str] = None) -> List[dict]:
    """Every firing alert across the polled fleet (root + edges),
    optionally filtered by severity — the CI probe's page check and the
    alert pane share this one extractor."""
    out: List[dict] = []
    for node in [state["root"]] + list(state["edges"]):
        alerts = node.get("alerts") or {}
        for rule in alerts.get("rules") or []:
            if rule.get("state") != "firing":
                continue
            if severity is not None and rule.get("severity") != severity:
                continue
            out.append(dict(rule, node=alerts.get("node", node["url"])))
    return out


def _alert_pane(state: dict, paint) -> List[str]:
    """The alert pane: firing rules first (page severity painted red),
    then pending ones; silent when the whole fleet is quiet."""
    lines: List[str] = []
    rows: List[tuple] = []
    for node in [state["root"]] + list(state["edges"]):
        alerts = node.get("alerts") or {}
        label = alerts.get("node", node["url"])
        for rule in alerts.get("rules") or []:
            if rule.get("state") in ("firing", "pending"):
                rows.append((0 if rule["state"] == "firing" else 1,
                             label, rule))
    if not rows:
        return lines
    rows.sort(key=lambda r: (r[0], r[1], r[2].get("name", "")))
    lines.append("  alerts:")
    for _, label, rule in rows:
        sev = rule.get("severity", "warn")
        text = (
            f"    {rule.get('state', '?').upper():<8} "
            f"[{sev}] {label}: {rule.get('name')} "
            f"({rule.get('metric')} {rule.get('op')} "
            f"{rule.get('threshold')}; value={rule.get('value')}, "
            f"episodes={rule.get('episodes', 0)})"
        )
        if rule.get("state") == "firing":
            text = paint("slow" if sev == "page" else "degrading", text)
        lines.append(text)
    return lines


def _runbook_pane(state: dict, paint) -> List[str]:
    """The actuations pane: ACTIVE remediations first (painted — an
    actuating fleet is a fleet being steered), then pending ones, each
    with its trigger and how many times the manager applied it; silent
    when no rule is loaded or everything is idle."""
    lines: List[str] = []
    rows: List[tuple] = []
    for node in [state["root"]] + list(state["edges"]):
        rb = node.get("runbooks") or {}
        label = rb.get("node", node["url"])
        for rule in rb.get("rules") or []:
            if rule.get("state") in ("active", "pending"):
                rows.append((0 if rule["state"] == "active" else 1,
                             label, rule))
    if not rows:
        return lines
    rows.sort(key=lambda r: (r[0], r[1], r[2].get("name", "")))
    lines.append("  actuations:")
    for _, label, rule in rows:
        text = (
            f"    {rule.get('state', '?').upper():<8} "
            f"{label}: {rule.get('name')} -> {rule.get('action')} "
            f"(on {rule.get('trigger')}; value={rule.get('value')}, "
            f"applied={rule.get('actuations', 0)}x, "
            f"episodes={rule.get('episodes', 0)})"
        )
        if rule.get("state") == "active":
            text = paint("degrading", text)
        lines.append(text)
    return lines


def _client_rows(health: Optional[dict], via: str) -> List[tuple]:
    rows = []
    for cid, info in ((health or {}).get("clients") or {}).items():
        rows.append((
            _STATUS_ORDER.get(info.get("status"), 9), cid, via, info
        ))
    return rows


def render(state: dict, color: bool = True) -> str:
    """One frame of the top-like view as a string (the caller owns the
    clear-screen escape so tests can snapshot frames)."""

    def paint(status: str, text: str) -> str:
        if not color:
            return text
        return f"{_STATUS_COLOR.get(status, '')}{text}{_RESET}"

    root = state["root"]
    lines: List[str] = []
    stamp = time.strftime("%H:%M:%S", time.localtime(state["ts"]))
    up = "up" if root["up"] else paint("slow", "DOWN")
    lines.append(
        f"baton fleet console  {stamp}  root={root['url']} [{up}]  "
        f"edges={sum(1 for e in state['edges'] if e['up'])}"
        f"/{len(state['edges'])} up"
    )
    lines.append(
        f"  rounds finished={_counter(root, 'rounds_finished'):.0f}  "
        f"updates={_counter(root, 'updates_received'):.0f}  "
        f"edge partials={_counter(root, 'updates_received_edge_partial'):.0f}  "
        f"fleet obs={_counter(root, 'fleet_observations'):.0f}"
    )
    for e in state["edges"]:
        phases = "  ".join(
            f"{k.split('edge_phase_')[-1]}={_counter(e, k):.2f}s"
            for k in ("edge_phase_fold_s", "edge_phase_settle_s")
        ) if e["up"] else "unreachable"
        node = ((e.get("health") or {}).get("node")) or e["url"]
        mark = "" if e["up"] else " [DOWN]"
        lines.append(f"  {node}{mark}: "
                     f"folded={_counter(e, 'edge_updates_folded'):.0f}  "
                     f"shipped={_counter(e, 'edge_partials_shipped'):.0f}  "
                     f"{phases}")

    compute_rows = [_compute_line(root, "root")]
    for e in state["edges"]:
        node = ((e.get("health") or {}).get("node")) or e["url"]
        compute_rows.append(_compute_line(e, node))
    compute_rows = [r for r in compute_rows if r]
    if compute_rows:
        storming = any("STORM" in r for r in compute_rows)
        lines.extend(paint("slow", r) if ("STORM" in r and color) else r
                     for r in compute_rows)
        if storming:
            lines.append(paint("slow", "  !! recompile storm in the "
                                       "last round — check input "
                                       "shape churn"))

    rep_line = _replication_line(root, "root")
    if rep_line:
        lines.append(rep_line)

    alert_lines = _alert_pane(state, paint)
    if alert_lines:
        lines.extend(alert_lines)
    runbook_lines = _runbook_pane(state, paint)
    if runbook_lines:
        lines.extend(runbook_lines)

    summary = ((root.get("health") or {}).get("summary")) or {}
    if summary:
        lines.append(
            "  health: " + "  ".join(
                paint(k, f"{k}={summary.get(k, 0)}")
                for k in ("healthy", "slow", "flaky", "degrading",
                          "inactive")
            ) + f"  total={summary.get('total', 0)}"
        )
    lines.append("")
    lines.append(f"  {'CLIENT':<28} {'VIA':<10} {'STATUS':<10} "
                 f"{'TRAIN':>9} {'ROUNDS':>6} {'MISS':>4}  REASON")
    rows = _client_rows(root.get("health"), "root")
    for e in state["edges"]:
        rows += _client_rows(e.get("health"),
                             ((e.get("health") or {}).get("node")) or "edge")
    rows.sort(key=lambda r: (r[0], r[1]))
    for _, cid, via, info in rows:
        status = info.get("status", "?")
        lines.append(
            f"  {cid:<28.28} {via:<10.10} "
            + paint(status, f"{status:<10}")
            + f" {_fmt_s(info.get('train_s_median'))}"
            f" {info.get('rounds_seen', 0):>6}"
            f" {info.get('missed', 0):>4}"
            f"  {info.get('reason', '')}"
        )
    tail = state.get("rounds_tail") or []
    if tail:
        lines.append("")
        lines.append("  recent rounds:")
        for r in tail:
            why = r.get("straggler_why") or {}
            why_s = ("  why: " + "; ".join(
                f"{c}: {w}" for c, w in sorted(why.items())
            )) if why else ""
            comp = r.get("compute") or {}
            comp_s = ""
            if isinstance(comp, dict) and comp:
                comp_s = (
                    f"  mfu={_fmt_num(comp.get('mfu'))}"
                    f" sps/chip="
                    f"{_fmt_num(comp.get('samples_per_sec_per_chip'), '{:.1f}')}"
                    f" compile={_fmt_num(comp.get('compile_s'))}s"
                )
                if comp.get("recompile_storms"):
                    comp_s += f" storms={comp['recompile_storms']}"
            lines.append(
                f"    {r.get('round')}: {r.get('outcome')} "
                f"{float(r.get('duration_s') or 0.0):.2f}s "
                f"reporters={r.get('reporters')}"
                f"/{r.get('participants')}{why_s}{comp_s}"
            )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m baton_tpu_torch.ops",
        description="live fleet health console (root + edges)",
    )
    ap.add_argument("--root", required=True,
                    help="experiment base URL, e.g. "
                         "http://127.0.0.1:8473/fedmodel")
    ap.add_argument("--edges", default="",
                    help="comma-separated edge base URLs")
    ap.add_argument("--rounds", default=None,
                    help="path to the manager's rounds.jsonl (optional; "
                         "adds the recent-rounds pane)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll interval in live mode (default 2s)")
    ap.add_argument("--timeout", type=float, default=3.0,
                    help="per-request HTTP timeout")
    ap.add_argument("--once", action="store_true",
                    help="poll once and exit (exit 1 if a node is down)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the raw poll state as JSON (implies no "
                         "ANSI); with --once this is the CI probe mode")
    args = ap.parse_args(argv)

    edges = [e.strip() for e in args.edges.split(",") if e.strip()]
    last_ts: Optional[float] = None
    while True:
        state = poll_fleet(args.root, edges, args.rounds, args.timeout,
                           history_since=last_ts)
        last_ts = state["ts"]
        all_up = state["root"]["up"] and all(
            e["up"] for e in state["edges"]
        )
        if args.as_json:
            print(json.dumps(state, indent=2, default=repr))
        else:
            if not args.once:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print(render(state, color=sys.stdout.isatty()))
        if args.once:
            # the CI probe fails on a dead node OR a firing page-severity
            # alert anywhere in the fleet — liveness alone is not health
            pages = firing_alerts(state, severity="page")
            if pages and not args.as_json:
                for rule in pages:
                    print(f"PAGE firing: {rule.get('node')}: "
                          f"{rule.get('name')}")
            return 0 if (all_up and not pages) else 1
        try:
            time.sleep(max(0.2, args.interval))
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
