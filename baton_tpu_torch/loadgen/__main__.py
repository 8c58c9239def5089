"""CLI: run one scenario and gate on its SLOs.

    python -m baton_tpu_torch.loadgen benchmarks/scenarios/diurnal_churn.json

Runs the scenario end to end (real manager + workers on loopback),
evaluates the scenario's ``slo`` block over the recorded telemetry, and
writes ``slo_report.json`` next to the other artifacts. Exit code 0
when every assertion passes and nothing regressed vs the committed
baseline; 1 on an SLO failure or baseline regression; 2 on a config
error — so CI can use this directly as a regression gate.

The managers and workers hold their params on ``--device``: the card by
default, the CPU only when asked for with ``--device cpu``. Without a GPU
and without that flag the run raises; it never falls back.
"""

import argparse
import asyncio
import json
import logging
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m baton_tpu_torch.loadgen",
        description="open-loop traffic scenario runner + SLO gate",
    )
    ap.add_argument("scenario", help="path to a benchmarks/scenarios/*.json")
    ap.add_argument("--artifacts", default=None,
                    help="artifact dir (default: artifacts/loadgen_<name>)")
    ap.add_argument("--device", default="cuda",
                    help="where the managers and workers hold their params "
                         "(default: cuda)")
    ap.add_argument("--tick", type=float, default=0.1,
                    help="driver tick interval in seconds")
    args = ap.parse_args(argv)

    # imported here: these pull in torch
    from baton_tpu_torch.loadgen.engine import run_scenario
    from baton_tpu_torch.loadgen.scenario import ScenarioError, load_scenario
    from baton_tpu_torch.loadgen.slo import evaluate_slo, write_report
    from baton_tpu_torch.obs.alerts import read_alerts_jsonl
    from baton_tpu_torch.obs.runbooks import read_runbooks_jsonl
    from baton_tpu_torch.utils.slog import read_rounds_jsonl, setup_json_logging

    setup_json_logging(level=logging.INFO)
    try:
        scenario = load_scenario(args.scenario)
    except (OSError, ScenarioError) as exc:
        print(f"scenario error: {exc}", file=sys.stderr)
        return 2

    artifacts = args.artifacts or os.path.join(
        "artifacts", f"loadgen_{scenario.name}"
    )
    summary = asyncio.run(run_scenario(scenario, artifacts, tick_s=args.tick,
                                       device=args.device))

    rounds_path = os.path.join(artifacts, "rounds.jsonl")
    records, n_torn = read_rounds_jsonl(rounds_path)
    with open(os.path.join(artifacts, "manager_metrics.json"),
              encoding="utf-8") as fh:
        snapshot = json.load(fh)
    with open(os.path.join(artifacts, "loadgen_metrics.json"),
              encoding="utf-8") as fh:
        loadgen_snapshot = json.load(fh)
    with open(os.path.join(artifacts, "worker_metrics.json"),
              encoding="utf-8") as fh:
        fleet_snapshot = json.load(fh)
    edge_snapshot = None
    edge_metrics_path = os.path.join(artifacts, "edge_metrics.json")
    if os.path.exists(edge_metrics_path):
        with open(edge_metrics_path, encoding="utf-8") as fh:
            edge_snapshot = json.load(fh)
    history = None
    history_path = os.path.join(artifacts, "metrics_history.json")
    if os.path.exists(history_path):
        with open(history_path, encoding="utf-8") as fh:
            history = json.load(fh).get("history")
    # the alert lifecycle stream backs the ``alert:*`` SLO namespace;
    # alerting disabled → no file → [] (alert: addresses resolve to 0)
    alerts_path = os.path.join(artifacts, "alerts.jsonl")
    alert_events = (read_alerts_jsonl(alerts_path)[0]
                    if os.path.exists(alerts_path) else [])
    # the actuation lifecycle stream backs ``runbook:*`` the same way;
    # runbooks disabled → no file → [] (runbook: addresses resolve to 0)
    runbooks_path = os.path.join(artifacts, "runbooks.jsonl")
    runbook_events = (read_runbooks_jsonl(runbooks_path)[0]
                      if os.path.exists(runbooks_path) else [])
    # per-class participation shares (``fairness:*``) come from the
    # fleet ledger's final health snapshot; deliberately NOT
    # absence-is-zero — see slo.derive_fairness_metrics
    fleet_health = None
    fleet_health_path = os.path.join(artifacts, "fleet_health.json")
    if os.path.exists(fleet_health_path):
        with open(fleet_health_path, encoding="utf-8") as fh:
            fleet_health = json.load(fh)
    try:
        report = evaluate_slo(
            scenario.slo, records, snapshot,
            loadgen_snapshot=loadgen_snapshot,
            fleet_snapshot=fleet_snapshot,
            edge_snapshot=edge_snapshot,
            history=history,
            alert_events=alert_events,
            fleet_health=fleet_health,
            runbook_events=runbook_events,
            n_torn=n_torn,
            exclude_rounds=summary["warmup_round_names"],
            scenario_name=scenario.name,
        )
    except (OSError, ScenarioError) as exc:
        print(f"baseline error: {exc}", file=sys.stderr)
        return 2
    report_path = os.path.join(artifacts, "slo_report.json")
    write_report(report, report_path)

    n_fail = sum(1 for a in report["assertions"] if a["status"] != "pass")
    n_reg = (report["baseline"] or {}).get("regressions", 0)
    verdict = "PASS" if report["pass"] else "FAIL"
    print(
        f"[{verdict}] scenario={scenario.name} "
        f"rounds={report['rounds_evaluated']} "
        f"(+{report['rounds_excluded_warmup']} warmup) "
        f"assertions={len(report['assertions']) - n_fail}"
        f"/{len(report['assertions'])} pass "
        f"baseline_regressions={n_reg} torn_lines={report['torn_lines']} "
        f"report={report_path}"
    )
    for a in report["assertions"]:
        if a["status"] != "pass":
            print(f"  assertion {a['status']}: {a['metric']} {a['op']} "
                  f"{a['value']} (observed: {a['observed']})")
    if report["baseline"]:
        for r in report["baseline"]["results"]:
            if r["regression"]:
                print(f"  regression: {r['metric']} baseline={r['baseline']} "
                      f"observed={r['observed']} "
                      f"({r.get('note') or 'beyond tolerance'})")
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
