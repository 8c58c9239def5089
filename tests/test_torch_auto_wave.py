"""``FedSim.auto_wave_size`` and ``wave_size="auto"`` of the port on the
CPU, the cases of ``tests/test_engine.py``'s auto-wave test through the
search's ``footprint`` seam: ``None`` at a wide budget, a halved wave at
a tight one, ``RuntimeError`` when nothing fits, ``NotImplementedError``
for a robust aggregator, and one cache entry for repeated ``"auto"``
rounds. On the CPU there is no allocator peak, so the default answer is
the whole cohort. The line fitted from the trial waves (``_fit_wave_footprint``)
is checked with the card's measurements stubbed: its slope and intercept,
an out-of-memory second trial leaving one client a wave, and an
out-of-memory first trial refused. And the measurements themselves:
``is_oom_error``, ``device_budget_gb`` and ``fedsim_wave_footprint_gb``
off the card."""

import numpy as np
import pytest
import torch

from baton_tpu_torch import FedSim
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _setup(aggregator="mean"):
    rng = np.random.default_rng(0)
    datasets = [{"x": rng.normal(size=(8, 6)).astype(np.float32),
                 "y": rng.normal(size=(8,)).astype(np.float32)} for _ in range(8)]
    data, n = stack_client_datasets(datasets, batch_size=8)
    sim = FedSim(linear_regression_model(6), batch_size=8, learning_rate=0.1,
                 aggregator=aggregator, device="cpu")
    return sim, sim.init(torch.Generator().manual_seed(0)), data, n


def line(w):  # GiB: 1 of fixed cost and 1 a client
    return 1.0 + w


def test_auto_wave_size_halves_until_the_line_fits():
    sim, params, data, n = _setup()
    # the CPU has no allocator peak: the whole cohort, as the reference without a plan
    assert sim.auto_wave_size(params, data, n, budget_gb=64.0) is None
    assert sim.auto_wave_size(params, data, n, budget_gb=64.0, footprint=line) is None
    # a budget under the full cohort's 9 GiB: halved at least once
    assert sim.auto_wave_size(params, data, n, budget_gb=6.0, footprint=line) == 4
    assert sim.auto_wave_size(params, data, n, budget_gb=3.5, footprint=line) == 2
    assert sim.auto_wave_size(params, data, n, budget_gb=2.0, footprint=line) == 1
    with pytest.raises(RuntimeError, match="no wave size"):
        sim.auto_wave_size(params, data, n, budget_gb=1e-12, footprint=line)


def test_auto_wave_size_refuses_robust_aggregators():
    sim, params, data, n = _setup("median")
    with pytest.raises(NotImplementedError, match="wave_size"):
        sim.auto_wave_size(params, data, n, budget_gb=64.0)


def test_auto_rounds_cache_one_answer_per_cohort_signature(monkeypatch):
    sim, params, data, n = _setup()
    asked = []
    real = sim.auto_wave_size

    def counted(*a, **kw):
        asked.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(sim, "auto_wave_size", counted)
    res = sim.run_round(params, data, n, torch.Generator().manual_seed(1), wave_size="auto")
    assert np.isfinite(res.loss_history.numpy()).all()
    assert len(sim._auto_wave_cache) == 1
    sim.run_round(res.params, data, n, torch.Generator().manual_seed(2), wave_size="auto")
    assert len(sim._auto_wave_cache) == 1 and len(asked) == 1  # same shapes: a hit
    # a cohort of another size is another signature
    sim.run_round(res.params, data, n, torch.Generator().manual_seed(3), wave_size="auto",
                  client_indices=np.array([0, 2, 5]))
    assert len(sim._auto_wave_cache) == 2 and len(asked) == 2
    # the cached answer sizes the waves: a wave of 4 equals the one-wave round
    sim._auto_wave_cache = {k: 4 for k in sim._auto_wave_cache}
    perms = torch.stack([torch.randperm(8, generator=torch.Generator().manual_seed(c))[None]
                         for c in range(8)])
    four = sim.run_round(params, data, n, wave_size="auto", perms=perms)
    whole = sim.run_round(params, data, n, perms=perms)
    for k in whole.params:
        torch.testing.assert_close(four.params[k], whole.params[k], rtol=1e-5, atol=1e-6)
    assert len(asked) == 2


def _on_a_card(monkeypatch, sim, trials):
    """``sim`` seen as on a card whose trial waves peak at ``trials[w]``
    GiB above 0.5 GiB in use (an exception instance is raised)."""
    def footprint(s, params, data, n_samples, wave_size):
        got = trials[wave_size]
        if isinstance(got, BaseException):
            raise got
        return got

    monkeypatch.setattr(profiling, "fedsim_wave_footprint_gb", footprint)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0.5 * profiling.GIB)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    sim.device = torch.device("cuda")


def test_the_fitted_line_from_two_trial_waves(monkeypatch):
    sim, params, data, n = _setup()
    _on_a_card(monkeypatch, sim, {1: 3.0, 2: 5.0})
    # 0.5 in use + 1 + 2 a client: 17.5 GiB at 8, 9.5 at 4
    assert sim.auto_wave_size(params, data, n, budget_gb=10.0) == 4
    assert sim.wave_footprint == {"in_use_gb": 0.5, "base_gb": 1.0, "per_client_gb": 2.0,
                                  "trial_gb": [3.0, 5.0]}
    assert sim.auto_wave_size(params, data, n, budget_gb=20.0) is None
    with pytest.raises(RuntimeError, match="no wave size"):
        sim.auto_wave_size(params, data, n, budget_gb=3.0)


def test_out_of_memory_trials(monkeypatch):
    sim, params, data, n = _setup()
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    _on_a_card(monkeypatch, sim, {1: 3.0, 2: oom})
    assert sim.auto_wave_size(params, data, n, budget_gb=70.0) == 1
    _on_a_card(monkeypatch, sim, {1: oom, 2: 5.0})
    with pytest.raises(RuntimeError, match="no wave size down to 1"):
        sim.auto_wave_size(params, data, n, budget_gb=70.0)
    _on_a_card(monkeypatch, sim, {1: ValueError("not memory"), 2: 5.0})
    with pytest.raises(ValueError, match="not memory"):
        sim.auto_wave_size(params, data, n, budget_gb=70.0)


def test_the_measurements(monkeypatch):
    assert profiling.is_oom_error(torch.cuda.OutOfMemoryError("x"))
    assert not profiling.is_oom_error(RuntimeError("x"))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1e9, 80 * profiling.GIB))
    assert profiling.device_budget_gb("cuda") == pytest.approx(80 * (1 - profiling.DEVICE_HEADROOM))
    sim, params, data, n = _setup()
    assert profiling.fedsim_wave_footprint_gb(sim, params, data, n, 2) is None
    # the trial wave is the round's own wave on throwaway draws: its fold is finite
    psum, lsum, wsum = sim._trial_wave(params, data, n, 3)
    assert float(wsum) == 24.0 and torch.isfinite(lsum).all()
    assert sorted(psum) == sorted(params)
