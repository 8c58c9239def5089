"""Open-loop production-traffic scenario harness.

"Millions of users" is a traffic *shape* — diurnal availability, client
churn, stragglers, heterogeneous device speeds, flaky networks — not
just a client count. This package drives a real manager + N in-process
workers over the actual HTTP protocol with that shape, then turns the
telemetry the manager records (``rounds.jsonl``, ``/metrics`` histograms) into
a machine-checkable verdict:

- :mod:`baton_tpu_torch.loadgen.scenario` — declarative scenario configs
  (``benchmarks/scenarios/*.json``): phases with availability curves,
  churn rates, faults, device-speed multipliers, and SLO assertions.
- :mod:`baton_tpu_torch.loadgen.engine` — the open-loop driver: rounds are
  started on a fixed clock regardless of whether the previous one
  finished (423 refusals are themselves a measured signal), while a
  ticker modulates worker availability and churns the fleet.
- :mod:`baton_tpu_torch.loadgen.slo` — the evaluator/CI gate: parses
  ``rounds.jsonl`` + the manager metrics snapshot, checks the
  scenario's SLO assertions and deltas vs a committed baseline, and
  writes ``slo_report.json``.

Run:  ``python -m baton_tpu_torch.loadgen benchmarks/scenarios/<name>.json``
"""

from baton_tpu_torch.loadgen.scenario import Scenario, ScenarioError, load_scenario
from baton_tpu_torch.loadgen.slo import evaluate_slo

__all__ = ["Scenario", "ScenarioError", "load_scenario", "evaluate_slo"]
