"""The loadgen in the port: ``tests/test_loadgen.py``'s cases against
``baton_tpu_torch/loadgen/`` (the scenario parser, the SLO evaluator and
two short federations of the engine on the CPU), and the CLI
``python -m baton_tpu_torch.loadgen --device cpu`` on a scenario with two
edges, one of which it kills.

The engine binds its servers' ports with its own close-and-rebind
``_free_port`` and ``web.TCPSite``; ``_torch_sockets.engine_sockets`` puts
bound-before-use sockets in their place, and every run is under its own
wall-clock limit.
"""

import asyncio
import json
import logging

from _torch_carried_cases import port_cases
from _torch_sockets import engine_sockets, run_bounded

# a run of the engine: a few seconds of scenario, its warm-up and drain
ENGINE_LIMIT_S = 120.0


def run_engine_bounded(run_scenario, scn, artifacts, tick_s):
    """The reference's ``asyncio.run(run_scenario(...))`` on the CPU, on
    bound-before-use sockets and under a wall-clock limit."""
    with engine_sockets():
        return run_bounded(
            lambda: run_scenario(scn, artifacts, tick_s=tick_s, device="cpu"),
            limit_s=ENGINE_LIMIT_S)


globals().update(port_cases(
    "test_loadgen.py",
    {"test_committed_scenarios_parse":
         "it reads the benchmark folder (benchmarks/scenarios/), which no "
         "test of the port reads"},
    seams=(
        ("summary = asyncio.run(run_scenario(scn, artifacts, tick_s=tick_s))",
         "summary = run_engine_bounded(run_scenario, scn, artifacts, tick_s)"),
    ),
    extra_globals={"run_engine_bounded": run_engine_bounded},
))


# ----------------------------------------------------------------------
# the CLI on the CPU, through an edge tier that loses an edge

EDGE_LOSS = {
    "name": "edge_loss_t",
    "seed": 11,
    "model": {"dim": 6},
    "workers": {"count": 4, "heartbeat_time": 0.3, "batch_size": 16,
                "min_batches": 1, "max_batches": 1},
    "edges": {"count": 2, "flush_after_s": 2.0, "heartbeat_time": 0.5,
              "retry_s": 60.0},
    "manager": {"round_timeout": 3.0, "client_ttl": 6.0},
    "rounds": {"interval_s": 0.8, "warmup": 1},
    "phases": [
        {"name": "steady", "duration_s": 2.5},
        {"name": "edge_loss", "duration_s": 3.0, "kill_edges": [1]},
    ],
    "slo": {"assertions": [
        {"metric": "rounds.total", "op": ">=", "value": 3},
        {"metric": "loadgen:scenario_rounds_forced_end", "op": "==", "value": 0},
        {"metric": "loadgen:scenario_edges_killed", "op": "==", "value": 1},
        {"metric": "counter:updates_received_edge_partial", "op": ">=", "value": 1},
        {"metric": "edge:counter:edge_partials_shipped", "op": ">=", "value": 1},
    ]},
}


def test_cli_runs_an_edge_scenario_on_the_cpu_when_asked(tmp_path, capsys):
    from baton_tpu_torch.loadgen.__main__ import main

    path = tmp_path / "edge_loss_t.json"
    path.write_text(json.dumps(EDGE_LOSS))
    artifacts = tmp_path / "artifacts"
    argv = [str(path), "--device", "cpu", "--artifacts", str(artifacts), "--tick", "0.05"]
    logger = logging.getLogger("baton_tpu")
    handlers, level = list(logger.handlers), logger.level
    try:
        with engine_sockets():
            rc = run_bounded(lambda: asyncio.to_thread(main, argv), limit_s=ENGINE_LIMIT_S)
    finally:
        logger.handlers[:], logger.level = handlers, level
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[PASS] scenario=edge_loss_t" in out
    report = json.loads((artifacts / "slo_report.json").read_text())
    assert report["pass"] and len(report["assertions"]) == 5
    # the killed edge's workers fell back to the root directly
    fleet = json.loads((artifacts / "worker_metrics.json").read_text())
    assert fleet["counters"].get("edge_route_fallbacks", 0) > 0
    # the workers' compute records reach the SLO's compute:* namespace with
    # the reference's keys: each measured, or null with its reason
    from baton_tpu_torch.loadgen.slo import derive_compute_metrics
    from baton_tpu_torch.utils.slog import read_rounds_jsonl

    records, _ = read_rounds_jsonl(str(artifacts / "rounds.jsonl"))
    metrics, skips = derive_compute_metrics(records)
    assert metrics["compute:rounds_with_compute"] > 0
    for key in ("compile_s_max", "steps_total", "samples_per_sec_per_chip_mean"):
        assert f"compute:{key}" in metrics, key
    # the CPU has no allocator statistics and the linear model no FLOP count
    assert skips["compute:peak_hbm_gb_max"] and skips["compute:mfu_mean"]
