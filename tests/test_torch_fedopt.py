"""The port's FedSim options against JAX's on BERT-tiny: three clients,
one without samples, the same weights and the permutations JAX draws from
each round's key. Server ``sgd(1.0)`` is FedAvg; server Adam over three
rounds with its state threaded; server momentum (FedAvgM); FedProx; a
trainable head (frozen leaves bit-equal); the median aggregator under a
server optimizer. Params 1e-4, losses 1e-5, as the round tests of
``test_torch_engine.py``.

The server's Adam here is FedAdam with its adaptivity ``tau = eps = 1e-3``
(Reddi et al., "Adaptive Federated Optimization", ICLR 2021). With optax's
default ``eps = 1e-8`` its step ``lr * g / (|g| + eps)`` turns a one-ulp
difference in the aggregate (~2e-9 at |w| ~ 0.03; the two packages sum in
other orders) into up to ~1e-3 wherever the pseudo-gradient is that
small, so no two correct implementations agree there to 1e-4. On
identical inputs the default is held to optax at 1e-6
(``test_torch_optim.py``).

Also: ``make_partition`` selects JAX's names and its errors,
``evaluate_clients`` against JAX (1e-5, NaN for a client without
samples), chained ``run_rounds`` carrying the server state, and the
one option still refused (the mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baton_tpu.core.partition import make_partition as jax_make_partition
from baton_tpu.core.regularizers import fedprox as jax_fedprox
from baton_tpu.models.bert import BertConfig as JaxBertConfig
from baton_tpu.models.bert import bert_classifier_model as jax_bert
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu_torch import FedSim
from baton_tpu_torch.core import optim
from baton_tpu_torch.core.partition import make_partition
from baton_tpu_torch.core.regularizers import fedprox
from baton_tpu_torch.core.training import random_perms
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.ops.privacy import DPConfig
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel.mesh import make_mesh
from _torch_variants import jax_round_perms

torch.set_num_threads(1)

BATCH, L, EPOCHS, LR = 4, 16, 2, 0.05
SIZES = (7, 0, 8)
TAU = 1e-3  # FedAdam's eps (module docstring)


def head(path, leaf):
    return path.startswith(("pooler/", "head/"))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    datasets = []
    for n in SIZES:
        lengths = rng.integers(1, L + 1, n)
        datasets.append({
            "x": rng.integers(0, 128, (n, L)).astype(np.int32),
            "attn_mask": (np.arange(L)[None] < lengths[:, None]).astype(np.float32),
            "y": rng.integers(0, 4, n).astype(np.int32),
        })
    data, n_samples = stack_client_datasets(datasets, batch_size=BATCH)
    jmodel = jax_bert(JaxBertConfig.tiny())
    jparams = jmodel.init(jax.random.key(0))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jax_to_state(jparams).items()}
    return data, n_samples, jmodel, jparams, bert_classifier_model(BertConfig.tiny()), tparams


def _rounds(setup, n_rounds, jax_kw, port_kw, aggregator="mean"):
    """``n_rounds`` rounds in both packages, the server state threaded;
    returns the pairs (port result, JAX result) of every round."""
    data, n_samples, jmodel, jparams, tmodel, tparams = setup
    jsim = JaxFedSim(jmodel, batch_size=BATCH, learning_rate=LR, aggregator=aggregator, **jax_kw)
    tsim = FedSim(tmodel, batch_size=BATCH, learning_rate=LR, aggregator=aggregator,
                  device="cpu", **port_kw)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jstate = tstate = None
    out = []
    for r in range(n_rounds):
        key = jax.random.key(10 + r)
        jres = jsim.run_round(jparams, jdata, jnp.asarray(n_samples), key, n_epochs=EPOCHS,
                              server_opt_state=jstate)
        perms = torch.from_numpy(jax_round_perms(key, len(SIZES), EPOCHS, data["x"].shape[1]))
        tres = tsim.run_round(tparams, data, n_samples, n_epochs=EPOCHS, perms=perms,
                              server_opt_state=tstate)
        out.append((tres, jres))
        jparams, jstate, tparams, tstate = jres.params, jres.server_opt_state, tres.params, \
            tres.server_opt_state
    return out


def _assert_round_matches(tres, jres):
    np.testing.assert_allclose(tres.loss_history.numpy(), np.asarray(jres.loss_history),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tres.client_losses.numpy(), np.asarray(jres.client_losses),
                               rtol=1e-5, atol=1e-5)
    want = jax_to_state(jres.params)
    assert list(tres.params) == list(want)
    for name, w in want.items():
        np.testing.assert_allclose(tres.params[name].numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_server_sgd_one_is_fedavg(setup):
    data, n_samples, _, _, tmodel, tparams = setup
    perms = torch.from_numpy(jax_round_perms(jax.random.key(3), len(SIZES), EPOCHS,
                                             data["x"].shape[1]))
    plain = FedSim(tmodel, batch_size=BATCH, learning_rate=LR, device="cpu").run_round(
        tparams, data, n_samples, n_epochs=EPOCHS, perms=perms)
    fedopt = FedSim(tmodel, batch_size=BATCH, learning_rate=LR, device="cpu",
                    server_optimizer=optim.sgd(1.0)).run_round(
        tparams, data, n_samples, n_epochs=EPOCHS, perms=perms)
    assert fedopt.server_opt_state == {} and plain.server_opt_state is None
    for name in tparams:
        torch.testing.assert_close(fedopt.params[name], plain.params[name], rtol=1e-6,
                                   atol=1e-7)
    [(tres, jres)] = _rounds(setup, 1, dict(server_optimizer=optax.sgd(1.0)),
                             dict(server_optimizer=optim.sgd(1.0)))
    _assert_round_matches(tres, jres)


def test_server_adam_three_rounds_match_jax(setup):
    rounds = _rounds(setup, 3, dict(server_optimizer=optax.adam(1e-2, eps=TAU)),
                     dict(server_optimizer=optim.adam(1e-2, eps=TAU)))
    for tres, jres in rounds:
        _assert_round_matches(tres, jres)
    tstate, jstate = rounds[-1][0].server_opt_state, rounds[-1][1].server_opt_state[0]
    assert tstate["count"].dtype == torch.int32
    assert int(tstate["count"]) == int(jstate.count) == 3
    for field in ("mu", "nu"):
        for name, want in jax_to_state(getattr(jstate, field)).items():
            np.testing.assert_allclose(tstate[field][name].numpy(), want, rtol=1e-4,
                                       atol=1e-4, err_msg=f"{field} {name}")


def test_server_momentum_matches_jax(setup):
    rounds = _rounds(setup, 2, dict(server_optimizer=optax.sgd(1.0, momentum=0.9)),
                     dict(server_optimizer=optim.sgd(1.0, momentum=0.9)))
    for tres, jres in rounds:
        _assert_round_matches(tres, jres)


@pytest.mark.parametrize("option", ["fedprox", "local_adam"])
def test_local_options_round_matches_jax(setup, option):
    jkw, tkw = {"fedprox": (dict(regularizer=jax_fedprox(0.1)), dict(regularizer=fedprox(0.1))),
                "local_adam": (dict(optimizer=optax.adam(1e-3)),
                               dict(optimizer=optim.adam(1e-3)))}[option]
    [(tres, jres)] = _rounds(setup, 1, jkw, tkw)
    _assert_round_matches(tres, jres)


def test_trainable_head_round_matches_jax_and_keeps_frozen_leaves(setup):
    tparams = setup[5]
    [(tres, jres)] = _rounds(setup, 1, dict(trainable=head, regularizer=jax_fedprox(0.1)),
                             dict(trainable=head, regularizer=fedprox(0.1)))
    _assert_round_matches(tres, jres)
    for name, v in tparams.items():
        if head(name, v):
            assert not torch.equal(tres.params[name], v), name
        else:
            assert torch.equal(tres.params[name], v), name


def test_median_with_server_adam_matches_jax(setup):
    rounds = _rounds(setup, 2, dict(server_optimizer=optax.adam(1e-2, eps=TAU)),
                     dict(server_optimizer=optim.adam(1e-2, eps=TAU)), aggregator="median")
    for tres, jres in rounds:
        _assert_round_matches(tres, jres)


def test_everything_together_matches_jax(setup):
    rounds = _rounds(
        setup, 2,
        dict(optimizer=optax.sgd(LR, momentum=0.9), regularizer=jax_fedprox(0.1),
             trainable=head, server_optimizer=optax.adam(1e-2, eps=TAU)),
        dict(optimizer=optim.sgd(LR, momentum=0.9), regularizer=fedprox(0.1),
             trainable=head, server_optimizer=optim.adam(1e-2, eps=TAU)))
    for tres, jres in rounds:
        _assert_round_matches(tres, jres)
    assert set(rounds[-1][0].server_opt_state["mu"]) == {"pooler/w", "pooler/b", "head/w",
                                                          "head/b"}


def test_partition_selects_jax_names_and_round_trips(setup):
    _, _, _, jparams, _, tparams = setup
    for predicate in (head, lambda path, leaf: "attn" in path,
                      lambda path, leaf: getattr(leaf, "ndim", 0) == 1):
        jpart = jax_make_partition(jparams, predicate)
        tpart = make_partition(tparams, predicate)
        assert sorted(tpart.trainable_paths) == sorted(jpart.trainable_paths)
        assert sorted(tpart.frozen_paths) == sorted(jpart.frozen_paths)
        assert tpart.n_trainable == jpart.n_trainable
        trainable, frozen = tpart.split(tparams)
        merged = tpart.merge(trainable, frozen)
        assert list(merged) == list(tparams)
        assert all(merged[k] is tparams[k] for k in tparams)


def test_partition_errors(setup):
    tparams = setup[5]
    with pytest.raises(ValueError, match="no trainable leaves"):
        make_partition(tparams, lambda path, leaf: False)
    part = make_partition(tparams, head)
    trainable, frozen = part.split(tparams)
    with pytest.raises(ValueError, match="leaves"):
        part.split({k: v for k, v in tparams.items() if k != "head/b"})
    with pytest.raises(ValueError, match="leaves"):
        part.split({("x" + k if k == "head/b" else k): v for k, v in tparams.items()})
    with pytest.raises(ValueError, match="both halves"):
        part.merge(trainable, None)
    with pytest.raises(ValueError, match="expected"):
        part.merge(frozen, trainable)


def test_evaluate_clients_matches_jax(setup):
    data, n_samples, jmodel, jparams, tmodel, tparams = setup
    jout = JaxFedSim(jmodel, batch_size=BATCH).evaluate_clients(
        jparams, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(n_samples))
    tout = FedSim(tmodel, batch_size=BATCH, device="cpu").evaluate_clients(
        tparams, data, n_samples, wave_size=2)
    assert set(tout["per_client"]) == set(jout["per_client"]) == {"loss", "accuracy", "n"}
    for k, want in jout["per_client"].items():
        got = tout["per_client"][k]
        assert np.isnan(got[1]) or k == "n"
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=k)
    assert tout["fairness"]["metric"] == jout["fairness"]["metric"] == "accuracy"
    assert tout["fairness"]["n_clients"] == jout["fairness"]["n_clients"] == 2
    for k in ("mean", "std", "worst", "worst_decile"):
        assert tout["fairness"][k] == pytest.approx(jout["fairness"][k], rel=1e-5, abs=1e-5), k


def test_chained_run_rounds_carry_the_server_state(setup):
    """Chained calls carrying ``server_opt_state`` equal one call. Every
    call numbers its rounds from 0 (round ``i`` shuffles with
    ``round_generator(generator, i)``), so the shuffles are fixed here
    (``perms=``) and only the server state tells the runs apart."""
    data, n_samples, _, _, tmodel, tparams = setup
    sim = FedSim(tmodel, batch_size=BATCH, learning_rate=LR, device="cpu",
                 server_optimizer=optim.adam(1e-2))
    capacity = next(iter(data.values())).shape[1]
    perms = torch.stack([torch.randperm(capacity, generator=torch.Generator().manual_seed(c))[None]
                         for c in range(len(SIZES))])
    whole = sim.run_rounds(tparams, data, n_samples, torch.Generator().manual_seed(7),
                           n_rounds=3, n_epochs=1, return_server_opt_state=True, perms=perms)
    gen = torch.Generator().manual_seed(7)
    p, h1, state = sim.run_rounds(tparams, data, n_samples, gen, n_rounds=1,
                                  return_server_opt_state=True, perms=perms)
    p, h2, state = sim.run_rounds(p, data, n_samples, gen, n_rounds=2, server_opt_state=state,
                                  return_server_opt_state=True, perms=perms)
    assert h1 + h2 == whole[1]
    assert int(state["count"]) == int(whole[2]["count"]) == 3
    optim.tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                   (p, state), (whole[0], whole[2]))
    # without the state the second call restarts the moments: another result
    p2, _ = sim.run_rounds(sim.run_rounds(tparams, data, n_samples,
                                          torch.Generator().manual_seed(7), perms=perms)[0],
                           data, n_samples, torch.Generator().manual_seed(7), n_rounds=2,
                           perms=perms)
    assert any(not torch.equal(p2[k], whole[0][k]) for k in p2)


def test_init_server_opt_state_covers_the_trainable_params(setup):
    tmodel, tparams = setup[4], setup[5]
    assert FedSim(tmodel, device="cpu").init_server_opt_state(tparams) is None
    state = FedSim(tmodel, device="cpu", trainable=head,
                   server_optimizer=optim.sgd(1.0, momentum=0.9)).init_server_opt_state(tparams)
    assert sorted(state["trace"]) == ["head/b", "head/w", "pooler/b", "pooler/w"]
    assert all(not v.any() for v in state["trace"].values())


def test_refused_options(setup):
    """Only a mesh with a ``model`` axis is still refused: ``dp=`` builds a
    DP trainer, and ``wave_size="auto"`` answers the whole cohort off the
    card, so its round equals the one-wave round."""
    data, n_samples, _, _, tmodel, tparams = setup
    with pytest.raises(NotImplementedError):
        FedSim(tmodel, mesh=make_mesh(2, ("clients", "model"), devices=["cpu"] * 2))
    dp = DPConfig(clip_norm=1.0, noise_multiplier=0.5)
    assert FedSim(tmodel, device="cpu", dp=dp).trainer.dp == dp
    sim = FedSim(tmodel, batch_size=BATCH, learning_rate=LR, device="cpu")
    assert sim.auto_wave_size(tparams, data, n_samples) is None
    perms = random_perms(len(n_samples), 1, data["x"].shape[1], torch.Generator().manual_seed(0))
    auto = sim.run_round(tparams, data, n_samples, wave_size="auto", perms=perms)
    whole = sim.run_round(tparams, data, n_samples, perms=perms)
    assert all(torch.equal(auto.params[k], whole.params[k]) for k in whole.params)
