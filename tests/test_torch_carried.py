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
]

# A worker's app cleanup waited for its heartbeat tick, which retries a
# stopped manager forever: ``stop(cancel=True)`` cancels the tick instead
# (tests/test_torch_http_worker.py shows the hang it removes). And two
# comments no longer name the change requests that introduced the code.
DIFFERENCES = {
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
