"""The benchmark's set-up and probes in ``baton_tpu_torch/utils/profiling.py``
on the CPU.

``resolve_artifact_path`` against the JAX package's on the same files (a
run with hardware results, a prior with them that sends the lesser run to a
``_failed`` sibling, an unreadable prior, a prior without an extension);
``configure_torch_for_bench(device="cpu")`` applying the sweep at its one
path (a ``gpu`` sweep moves the flash dispatcher, a TPU sweep does not,
a malformed one does not raise, none at all changes nothing); and the
device rule: without a GPU, ``device="cuda"`` and
``fedsim_fused_donation_plan`` raise, nothing falls back to the CPU."""

import json

import numpy as np
import pytest
import torch

from baton_tpu.utils.profiling import resolve_artifact_path as jax_resolve_artifact_path
from baton_tpu_torch import FedSim
from baton_tpu_torch.core import optim
from baton_tpu_torch.models import transformer
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.utils import profiling

needs_no_gpu = pytest.mark.skipif(torch.cuda.is_available(),
                                  reason="checks the refusal where no GPU is present")


def _has_results(prior):
    return any(r.get("ms") is not None for r in prior["results"])


@pytest.mark.parametrize("case", ["run_succeeded", "prior_succeeded", "prior_failed",
                                  "prior_unreadable", "prior_missing", "no_extension"])
def test_resolve_artifact_path_against_jax(tmp_path, case):
    out = tmp_path / ("sweep" if case == "no_extension" else "sweep.json")
    prior = {"results": [{"ms": 1.5}]}
    if case == "prior_failed":
        prior = {"results": [{"ms": None}]}
    if case == "prior_unreadable":
        out.write_text("{not json")
    elif case != "prior_missing":
        out.write_text(json.dumps(prior))
    run_ok = case == "run_succeeded"
    got = profiling.resolve_artifact_path(str(out), run_ok, _has_results)
    assert got == jax_resolve_artifact_path(str(out), run_ok, _has_results)
    want = {"prior_succeeded": str(tmp_path / "sweep_failed.json"),
            "no_extension": str(tmp_path / "sweep_failed.json")}.get(case, str(out))
    assert got == want


@pytest.fixture
def dispatcher(monkeypatch, tmp_path):
    """The flash dispatcher's state restored after the test, and the sweep
    path pointed at a file of the test's own."""
    monkeypatch.setattr(transformer, "_FLASH_MIN_LEN", transformer._FLASH_MIN_LEN)
    monkeypatch.setattr(transformer, "_FLASH_BLOCKS", transformer._FLASH_BLOCKS)
    path = tmp_path / "attention_sweep_gpu.json"
    monkeypatch.setattr(profiling, "ATTENTION_SWEEP", path)
    return path


def _sweep(platform):
    return {"platform": platform, "results": [
        {"L": 128, "dense_ms": 1.0, "flash": {"64x64": 2.0}},
        {"L": 256, "dense_ms": 3.0, "flash": {"64x64": 1.0}}]}


@pytest.mark.parametrize("artifact,moved", [
    (_sweep("gpu"), True), (_sweep("tpu"), False), ("{malformed", False),
    ({"platform": "gpu", "results": [{"L": "a"}, {"L": 2}]}, False), (None, False)])
def test_configure_torch_for_bench_applies_only_a_gpu_sweep(dispatcher, artifact, moved):
    before = (transformer._FLASH_MIN_LEN, transformer._FLASH_BLOCKS)
    if artifact is not None:
        dispatcher.write_text(artifact if isinstance(artifact, str) else json.dumps(artifact))
    out = profiling.configure_torch_for_bench(device="cpu")
    after = (transformer._FLASH_MIN_LEN, transformer._FLASH_BLOCKS)
    assert after == ((256, (64, 64)) if moved else before)
    assert out["device"] == "cpu" and out["kernels"] is None
    assert out["sweep"] == (None if artifact is None else str(dispatcher))
    if moved:
        assert out["dispatch"] == (256, (64, 64))


def test_the_sweep_path_is_the_repos_benchmarks_folder():
    root = profiling.Path(profiling.__file__).resolve().parents[2]
    assert profiling.ATTENTION_SWEEP == root / "benchmarks" / "attention_sweep_gpu.json"


@needs_no_gpu
def test_configure_torch_for_bench_needs_a_gpu_for_cuda(dispatcher):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.configure_torch_for_bench()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.configure_torch_for_bench(device="cuda")


def test_fused_donation_plan_needs_a_gpu():
    """A FedSim on the CPU is refused whether or not a card is present."""
    rng = np.random.default_rng(0)
    data = {"x": torch.from_numpy(rng.normal(size=(2, 8, 3)).astype(np.float32)),
            "y": torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))}
    n = torch.tensor([8, 5])
    sim = FedSim(linear_regression_model(3), batch_size=8, server_optimizer=optim.adam(0.1),
                 device="cpu")
    params = sim.init(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in params.items()}
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        profiling.fedsim_fused_donation_plan(sim, params, data, n,
                                             torch.Generator().manual_seed(1))
    assert sim.last_fused is None or "donation" not in sim.last_fused
    assert all(torch.equal(params[k], before[k]) for k in params)
