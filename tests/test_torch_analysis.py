"""batonlint in the port: ``tests/test_analysis.py``'s cases against the
carried copy ``baton_tpu_torch/analysis/`` (every case, through the import
rewrite; its ``test_repo_is_lint_clean`` lints the JAX package's tree with
the port's analyzer), and the port's own tree linted clean by it:
``python -m baton_tpu_torch.analysis baton_tpu_torch`` needs no JAX."""

import pathlib
import subprocess
import sys

from _torch_carried_cases import port_cases

from baton_tpu_torch.analysis import run_paths

REPO = pathlib.Path(__file__).resolve().parents[1]

globals().update(port_cases("test_analysis.py", {}))


def test_port_is_lint_clean():
    """Zero unsuppressed findings over ``baton_tpu_torch/`` with the port's
    own analyzer."""
    report = run_paths([str(REPO / "baton_tpu_torch")])
    details = "\n".join(
        f"{f.location()}: {f.rule} {f.message}" for f in report.findings
    ) + "\n".join(report.errors)
    assert report.clean, f"batonlint findings:\n{details}"
    assert report.files_checked > 100


def test_port_lint_cli_runs_without_jax():
    """The CLI over the port exits 0, and its process never imports JAX or
    the JAX package."""
    code = ("import runpy, sys\n"
            "sys.argv = ['batonlint', 'baton_tpu_torch']\n"
            "try:\n"
            "    runpy.run_module('baton_tpu_torch.analysis', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "else:\n"
            "    rc = 0\n"
            "assert 'jax' not in sys.modules and 'baton_tpu' not in sys.modules\n"
            "sys.exit(rc)\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-2000:]
    assert "0 finding(s)" in done.stdout
