"""The port's profiler hooks (``baton_tpu_torch/utils/profiling.py``) with
the reference's semantics: ``profile_trace`` is a no-op unless a directory
is given or ``BATON_TPU_PROFILE`` is set; a forensics arm is consumed by
exactly one ``forensics_trace`` block, and a profiler that fails to start
is swallowed (the block still runs); ``timed`` returns the result and its
seconds."""

import json

import pytest
import torch

from baton_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _work():
    return {"y": torch.ones(4, 4) @ torch.ones(4, 4)}


def test_profile_trace_is_a_no_op_unless_asked(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.ENV_VAR, raising=False)
    with profiling.profile_trace():
        _work()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv(profiling.ENV_VAR, str(tmp_path / "env"))
    with profiling.profile_trace():
        with profiling.annotate("region"):
            _work()
    trace = json.loads((tmp_path / "env" / profiling.TRACE_FILE).read_text())
    assert any(e.get("name") == "region" for e in trace["traceEvents"])


def test_forensics_arm_is_consumed_once(tmp_path):
    assert not profiling.forensics_armed()
    with profiling.forensics_trace() as log_dir:
        assert log_dir is None
    profiling.arm_forensics_trace(str(tmp_path / "first"))
    profiling.arm_forensics_trace(str(tmp_path / "cap"))  # re-arming re-points
    assert profiling.forensics_armed()
    with profiling.forensics_trace() as log_dir:
        _work()
    assert log_dir == str(tmp_path / "cap")
    assert (tmp_path / "cap" / profiling.TRACE_FILE).is_file()
    assert not (tmp_path / "first").exists()
    assert not profiling.forensics_armed()
    with profiling.forensics_trace() as log_dir:
        assert log_dir is None


def test_a_profiler_that_fails_is_swallowed(tmp_path, monkeypatch):
    def broken(*args, **kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    profiling.arm_forensics_trace(str(tmp_path / "cap"))
    ran = []
    with profiling.forensics_trace() as log_dir:
        ran.append(_work())
    assert log_dir is None and len(ran) == 1
    assert not profiling.forensics_armed()


def test_timed_returns_the_result_and_its_seconds():
    out, seconds = profiling.timed(_work)
    assert torch.equal(out["y"], torch.full((4, 4), 4.0))
    assert seconds >= 0.0
    with pytest.raises(ZeroDivisionError):
        profiling.timed(lambda: 1 / 0)
