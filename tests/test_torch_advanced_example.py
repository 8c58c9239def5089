"""The port of ``examples/08_advanced_aggregation.py``
(``baton_tpu_torch/examples/advanced_aggregation.py``): its ``run()``
passes the gates of ``tests/test_examples.py::test_advanced_aggregation``
on the CPU, and its FedBuff and FedPer stages agree with the JAX
example's on the JAX example's own inputs.

The JAX example runs with its ``FedBuff``, ``FedPer`` and ``FedSim``
wrapped to record what each call was given and gave back; its clustered
stage stops at the first round (its data recorded). The port's
``make_data`` equals the arrays the example drew; the port's stages run
from the example's initial weights with the permutations JAX drew from
the example's keys, and land within the reference's 5e-2 band of it
(the staleness exactly)."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from baton_tpu_torch.examples import advanced_aggregation as example
from _torch_variants import BAND, assert_params_close, fedbuff_perms, round_perms, to_port

torch.set_num_threads(1)

N_CLIENTS, N_ROUNDS = 4, 4


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def jax_example():
    """Run the JAX example at the test's size through its clustered
    stage's first round; returns what each wrapped call saw."""
    spec = importlib.util.spec_from_file_location(
        "advanced_aggregation_jax",
        Path(__file__).resolve().parents[1] / "examples" / "08_advanced_aggregation.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    seen = {"fedsim": [], "fedper": []}

    class FedSim(m.FedSim):
        def run_round(self, params, data, n, rng, **kw):
            res = super().run_round(params, data, n, rng, **kw)
            seen["fedsim"].append((self.model.name, params, data, n, rng, res))
            return res

        def evaluate_round(self, params, data, n):
            out = super().evaluate_round(params, data, n)
            seen["global_eval"] = out
            return out

    class FedBuff(m.FedBuff):
        def run(self, params, data, n, rng, n_steps, n_epochs=1):
            res = super().run(params, data, n, rng, n_steps, n_epochs)
            seen["fedbuff"] = (params, data, n, rng, n_steps, n_epochs, res)
            return res

    class FedPer(m.FedPer):
        def run_round(self, params, pers, data, n, rng, n_epochs=1):
            res = super().run_round(params, pers, data, n, rng, n_epochs)
            seen["fedper"].append((params, data, n, rng, res))
            seen["fedper_paths"] = self.partition.trainable_paths
            return res

        def evaluate(self, *args):
            out = super().evaluate(*args)
            seen["fedper_eval"] = out
            return out

    class ClusteredFedSim(m.ClusteredFedSim):
        def run_round(self, clusters, data, n, rng, n_epochs=1):
            seen["mixture"] = (data, n)
            raise _Stop

    m.FedSim, m.FedBuff, m.FedPer, m.ClusteredFedSim = (FedSim, FedBuff, FedPer,
                                                        ClusteredFedSim)
    with pytest.raises(_Stop):
        m.run(n_clients=N_CLIENTS, n_rounds=N_ROUNDS)
    return seen


def test_run_passes_the_examples_gates():
    out = example.run(n_clients=N_CLIENTS, n_rounds=N_ROUNDS, device="cpu")
    assert out["poisoned_median_err"] < 1.0 < out["poisoned_mean_err"]
    assert out["fedbuff_err"] < 1.5
    assert out["personalized_acc"] > out["global_acc"]
    assert out["clusters_separated"] and out["clustered_loss"] < 1.0


def test_make_data_draws_the_examples_arrays(jax_example):
    data = example.make_data(N_CLIENTS, 0)
    for name, (jdata, jn) in (("linear", jax_example["fedbuff"][1:3]),
                              ("shards", jax_example["fedper"][0][1:3]),
                              ("mixture", jax_example["mixture"])):
        got, n = data[name]
        np.testing.assert_array_equal(n, np.asarray(jn), err_msg=name)
        assert sorted(got) == sorted(jdata)
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(jdata[k]), err_msg=f"{name} {k}")


def test_fedbuff_stage_matches_the_jax_examples(jax_example):
    params, jdata, jn, rng, n_steps, n_epochs, jres = jax_example["fedbuff"]
    data, n = example.make_data(N_CLIENTS, 0)["linear"]
    perms = fedbuff_perms(rng, n_steps, 2, n_epochs, data["x"].shape[1])
    res = example.fedbuff_stage(data, n, to_port(params), N_CLIENTS, n_steps, "cpu", perms=perms)
    assert res.version == jres.version == N_ROUNDS * 8
    assert res.mean_staleness == jres.mean_staleness
    assert_params_close(res.params, jres.params, BAND)
    np.testing.assert_allclose(res.loss_history, jres.loss_history, rtol=BAND, atol=BAND)


def test_personalization_stage_matches_the_jax_examples(jax_example):
    rounds = jax_example["fedper"]
    data, n = example.make_data(N_CLIENTS, 0)["shards"]
    perms = [round_perms(rng, N_CLIENTS, 2, data["x"].shape[1]) for _, _, _, rng, _ in rounds]
    acc_glob, acc_pers, p_glob, p, pers = example.personalization_stage(
        data, n, to_port(rounds[0][0]), len(rounds), "cpu", perms=perms)
    jglobal = [r for r in jax_example["fedsim"] if r[0] == "mlp"]
    assert len(jglobal) == len(rounds) == N_ROUNDS + 4
    for (_, _, _, _, jrng, _), (_, _, _, rng, _) in zip(jglobal, rounds):
        assert np.array_equal(jax.random.key_data(jrng), jax.random.key_data(rng))
    assert_params_close(p_glob, jglobal[-1][-1].params, BAND)
    jlast = rounds[-1][-1]
    assert_params_close(p, jlast.params, BAND)
    assert_params_close(pers, dict(zip(jax_example["fedper_paths"], jlast.personal_state)), BAND)
    assert acc_glob == pytest.approx(jax_example["global_eval"]["accuracy"], abs=BAND)
    assert acc_pers == pytest.approx(jax_example["fedper_eval"]["accuracy"], abs=BAND)
    assert acc_pers > acc_glob
