"""The framework-free modules the port carries over from ``baton_tpu``
equal their sources once the import rewrite (``baton_tpu.`` ->
``baton_tpu_torch.``, and ``baton_tpu/`` in paths named in comments) is
undone, so an edit on either side shows here.

``DIFFERENCES`` names every deliberate difference: a pattern matching the
reference source text exactly once, and the port's text that replaces it.
"""

import ast
import re
from pathlib import Path

import pytest

from _torch_carried_cases import rewrite

ROOT = Path(__file__).resolve().parents[1]

CARRIED = [
    "data/datasets.py",
    "server/__init__.py",
    "server/secure.py",
    "server/utils.py",
    "server/wire.py",
    "server/blobs.py",
    "server/registry.py",
    "server/rounds.py",
    "server/ingest.py",
    "server/fleet.py",
    "server/journal.py",
    "server/topology.py",
    "server/replication.py",
    "utils/tracing.py",
    "utils/metrics.py",
    "utils/slog.py",
    "utils/faults.py",
    "obs/alerts.py",
    "obs/forensics.py",
    "obs/runbooks.py",
    "server/edge.py",
    "ops/console.py",
    "ops/__main__.py",
    "loadgen/__init__.py",
    "loadgen/scenario.py",
    "loadgen/slo.py",
    "loadgen/engine.py",
    "loadgen/__main__.py",
    "analysis/__init__.py",
    "analysis/__main__.py",
    "analysis/_astutil.py",
    "analysis/callgraph.py",
    "analysis/checkers/__init__.py",
    "analysis/checkers/alertrules.py",
    "analysis/checkers/blocking.py",
    "analysis/checkers/contexts.py",
    "analysis/checkers/counters.py",
    "analysis/checkers/deadcode.py",
    "analysis/checkers/donation.py",
    "analysis/checkers/exemplars.py",
    "analysis/checkers/locks.py",
    "analysis/checkers/races.py",
    "analysis/checkers/runbooks.py",
    "analysis/checkers/spans.py",
    "analysis/checkers/staleness.py",
    "analysis/checkers/suppressions.py",
    "analysis/checkers/tracer.py",
    "analysis/checkers/wirecap.py",
    "analysis/engine.py",
    "analysis/project.py",
    "analysis/sarif.py",
    "analysis/summaries.py",
]

# The loadgen driver's one seam is the device: the root managers and the
# workers it builds hold their params on ``device`` (``run_scenario`` and
# ``ScenarioRunner``, the card by default; ``--device`` of the CLI, which
# took ``--platform`` for ``JAX_PLATFORMS``), and the comments that said the
# warm-up rounds compile XLA say what they warm on the card. The trainer
# takes no device: it trains where the worker's params live.
_ENGINE = [(
    re.escape("Warm-up rounds (XLA compile) run before the scenario clock starts with\n"
              "everything available and no faults;"),
    "Warm-up rounds (CUDA context, cuDNN/cuBLAS plans, first blob fetch) run\n"
    "before the scenario clock starts with everything available and no faults;",
), (
    re.escape("from baton_tpu_torch.core.training import make_local_trainer\n"),
    "from baton_tpu_torch import resolve_device\n"
    "from baton_tpu_torch.core.training import make_local_trainer\n",
), (
    re.escape('''    dict (also written to ``scenario_summary.json``)."""

    def __init__(self, scenario: Scenario, artifacts_dir: str,
                 tick_s: float = 0.1) -> None:
        self.scenario = scenario
'''),
    '''    dict (also written to ``scenario_summary.json``). The root managers
    and the workers hold their params on ``device``, the card unless the
    caller asks for the CPU."""

    def __init__(self, scenario: Scenario, artifacts_dir: str,
                 tick_s: float = 0.1, device="cuda") -> None:
        self.device = resolve_device(device)
        self.scenario = scenario
''',
), (
    re.escape("        exp = Manager(sapp).register_experiment(\n"
              "            self._model, name=scn.name,\n"),
    "        exp = Manager(sapp).register_experiment(\n"
    "            self._model, name=scn.name, device=self.device,\n",
), (
    re.escape("            name=scn.name, port=_free_port(),\n"),
    "            name=scn.name, port=_free_port(), device=self.device,\n",
), (
    re.escape("        self._exp = Manager(mapp).register_experiment(\n"
              "            self._model, name=scn.name,\n"),
    "        self._exp = Manager(mapp).register_experiment(\n"
    "            self._model, name=scn.name, device=self.device,\n",
), (
    re.escape("        # warm-up: compile + first blob fetch outside the scenario clock\n"),
    "        # warm-up: CUDA context, cuDNN/cuBLAS plans and first blob fetch\n"
    "        # outside the scenario clock\n",
), (
    re.escape("(compile time is a harness\n"),
    "(first-call set-up is a harness\n",
), (
    re.escape('''                       tick_s: float = 0.1) -> dict:
    return await ScenarioRunner(scenario, artifacts_dir, tick_s=tick_s).run()'''),
    '''                       tick_s: float = 0.1, device="cuda") -> dict:
    return await ScenarioRunner(scenario, artifacts_dir, tick_s=tick_s,
                                device=device).run()''',
)]

_LOADGEN_MAIN = [(
    re.escape('''The harness measures the serving path, not the accelerator: training is
tiny linear models, so JAX is pinned to CPU by default
(``--platform keep`` preserves the environment's choice).
'''),
    '''The managers and workers hold their params on ``--device``: the card by
default, the CPU only when asked for with ``--device cpu``. Without a GPU
and without that flag the run raises; it never falls back.
''',
), (
    re.escape('''    ap.add_argument("--platform", default="cpu",
                    help="JAX_PLATFORMS for the run; 'keep' leaves the "
                         "environment alone (default: cpu)")
'''),
    '''    ap.add_argument("--device", default="cuda",
                    help="where the managers and workers hold their params "
                         "(default: cuda)")
''',
), (
    re.escape('''    if args.platform != "keep":
        os.environ["JAX_PLATFORMS"] = args.platform

    # import after the platform pin: these pull in jax
'''),
    "    # imported here: these pull in torch\n",
), (
    re.escape("summary = asyncio.run(run_scenario(scenario, artifacts, tick_s=args.tick))"),
    "summary = asyncio.run(run_scenario(scenario, artifacts, tick_s=args.tick,\n"
    "                                       device=args.device))",
)]

# The loadgen package's docstring no longer names the change request that
# made the telemetry it reads.
_LOADGEN_INIT = [(
    re.escape("telemetry PR 6 records (``rounds.jsonl``"),
    "telemetry the manager records (``rounds.jsonl``",
)]

# batonlint's docstrings no longer name the change requests that made the
# code they describe.
_ANALYSIS = {
    "analysis/__init__.py": [(
        re.escape("PRs 1-3 bought durability and a pipelined data plane by enforcing"),
        "The server buys durability and a pipelined data plane by enforcing",
    )],
    "analysis/checkers/blocking.py": [(
        re.escape("(the exact failure PR 3's ingest\npipeline exists to prevent)"),
        "(the exact failure the ingest\npipeline exists to prevent)",
    )],
    "analysis/checkers/exemplars.py": [(
        re.escape("PR 9's fleet health plane links"),
        "The fleet health plane links",
    )],
}

# A worker's app cleanup waited for its heartbeat tick, which retries a
# stopped manager forever: ``stop(cancel=True)`` cancels the tick instead
# (tests/test_torch_http_worker.py shows the hang it removes). And two
# comments no longer name the change requests that introduced the code.
DIFFERENCES = {
    **_ANALYSIS,
    "loadgen/__init__.py": _LOADGEN_INIT,
    "loadgen/engine.py": _ENGINE,
    "loadgen/__main__.py": _LOADGEN_MAIN,
    "server/ingest.py": [(
        r"The v2 data plane \([^)\n]*\) made",
        "The v2 data plane made",
    )],
    "server/utils.py": [(
        r"Two layers of enforcement \([^—\n]*— the old",
        "Two layers of enforcement (the old",
    ), (
        re.escape('''    async def stop(self) -> None:
        self._stop.set()
        if self._loop_task is not None:
            with suppress(asyncio.CancelledError):'''),
        '''    async def stop(self, cancel: bool = False) -> None:
        """Signal the schedule to end and wait for it. ``cancel`` also
        cancels a tick in flight instead of waiting for it: at shutdown a
        tick may be retrying a peer that is already gone, and would never
        end (a worker's heartbeat against a stopped manager)."""
        self._stop.set()
        if self._loop_task is not None:
            if cancel:
                self._loop_task.cancel()
            with suppress(asyncio.CancelledError):''',
    )],
}


@pytest.mark.parametrize("module", CARRIED)
def test_carried_module_equals_its_source(module):
    expected = rewrite((ROOT / "baton_tpu" / module).read_text())
    for pattern, port_text in DIFFERENCES.get(module, []):
        expected, n = re.subn(pattern, lambda m: port_text, expected)
        assert n == 1, f"{module}: the reference changed at {pattern!r}"
    got = (ROOT / "baton_tpu_torch" / module).read_text()
    assert got == expected, f"baton_tpu_torch/{module} differs from baton_tpu/{module}"


def test_every_difference_names_a_carried_module():
    assert set(DIFFERENCES) <= set(CARRIED)


# ``ops/compression.py``'s numpy half: the downlink's encode and
# reconstruction must stay bit-identical across the packages (a worker
# checks its reconstruction against the round blob's digest), so each
# function is its source's text
NUMPY_COMPRESSION = ["_leaf_k", "dequantize_state_dict", "parse_delta_spec",
                     "delta_encode_state_dict", "apply_delta_state_dict"]


def _function_source(path, name):
    source = path.read_text()
    node = next(n for n in ast.parse(source).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    return ast.get_source_segment(source, node)


@pytest.mark.parametrize("name", NUMPY_COMPRESSION)
def test_numpy_compression_function_equals_its_source(name):
    got = _function_source(ROOT / "baton_tpu_torch/ops/compression.py", name)
    assert got == _function_source(ROOT / "baton_tpu/ops/compression.py", name)
