"""BASELINE config 5 on the CPU: the port of example 05
(``baton_tpu_torch/examples/vit_dp_secure.py``) under the example's own
assertions (``err < 1e-3`` for the secure sum, a finite history) at its
tiny preset and at ``tests/test_examples.py``'s size, its accountant
against the JAX example's numbers (1e-12), its secure sum seeing a
tampered update, and ``wave_size="auto"`` on its cohort (the whole
cohort off the card)."""

import numpy as np
import pytest
import torch

from baton_tpu.ops import privacy as jpriv
from baton_tpu_torch.examples import vit_dp_secure as example
from baton_tpu_torch.models.vit import ViTConfig
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.ops.secure_agg import dequantize

torch.set_num_threads(1)


def test_tiny_preset_passes_the_examples_gates(capsys):
    history, eps = example.run(device="cpu")
    assert np.isfinite(history[-1]) and eps > 0
    out = capsys.readouterr().out
    assert "secure agg: masked-sum error" in out and "epsilon" in out


def test_the_reference_test_size():
    history, eps = example.run(n_clients=3, n_per_client=8, n_rounds=1, noise_multiplier=0.5,
                               device="cpu")
    assert np.isfinite(history[-1])
    assert eps > 0


@pytest.mark.parametrize("rounds,epochs,cap,batch,per,sigma", [
    (2, 1, 16, 8, 16, 0.5), (20, 1, 4096, 64, 4096, 0.5), (3, 2, 24, 8, 20, 1.1)])
def test_epsilons_are_the_reference_accountants(rounds, epochs, cap, batch, per, sigma):
    steps, eps, eps_amp, q = example.epsilons(rounds, epochs, cap, batch, per, sigma, 1e-5)
    assert steps == rounds * epochs * (cap // batch) and q == batch / per
    assert abs(eps - jpriv.rdp_epsilon(sigma, steps, 1e-5)) <= 1e-12
    assert abs(eps_amp - jpriv.subsampled_rdp_epsilon(sigma, steps, 1e-5, q)) <= 1e-12
    assert eps_amp < eps


def test_secure_sum_sees_a_tampered_update():
    rng = np.random.default_rng(0)
    deltas = [{"w": rng.normal(size=(3, 4)).astype(np.float32) * 0.01} for _ in range(3)]
    assert example.secure_sum_error(deltas, 0) < 1e-3
    masked = [example.mask_update(d, 7, i, len(deltas)) for i, d in enumerate(deltas)]
    # one masked update is noise to the server: far from its own plaintext
    assert np.abs(dequantize(masked[0])["w"] - deltas[0]["w"]).max() > 100.0
    masked[1]["w"] = masked[1]["w"] + np.uint32(1 << 20)  # tampered in flight
    unmasked = example.aggregate_masked(masked)
    plain = sum(d["w"].astype(np.float64) for d in deltas)
    assert np.abs(unmasked["w"] - plain).max() > 1e-3


def test_auto_wave_on_the_examples_cohort():
    cfg = ViTConfig.tiny()
    rng = np.random.default_rng(0)
    data, n = stack_client_datasets(example.make_data(rng, cfg, 3, 8), batch_size=4)
    sim = example.make_sim(cfg, batch_size=4, device="cpu")
    params = sim.init(torch.Generator().manual_seed(0))
    res = sim.run_round(params, data, n, torch.Generator().manual_seed(1), wave_size="auto",
                        client_indices=np.array([0, 2]))
    assert torch.isfinite(res.loss_history).all()
    assert list(sim._auto_wave_cache.values()) == [None]
