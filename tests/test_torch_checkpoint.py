"""Checkpoint/resume in the port (``baton_tpu_torch/utils/checkpoint.py``):
the ``Checkpointer`` cases of ``tests/test_aux_subsystems.py`` (the
reference's orbax checkpoints are ``torch.save`` files here), the HTTP
manager's restart from ``checkpoint_dir``, ``FedSim.run_rounds`` resumed
after 2 of 4 rounds (equal to the uninterrupted run to the bit), and 4
rounds of ``run_rounds`` against the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web

from baton_tpu.models.cnn import cnn_mnist_model as jax_cnn
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu.server.state import state_dict_to_params as jax_from_state
from baton_tpu_torch import FedSim
from baton_tpu_torch.core import optim
from baton_tpu_torch.data.synthetic import synthetic_image_clients
from baton_tpu_torch.models.cnn import cnn_mnist_model
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel.engine import round_generator
from baton_tpu_torch.server.http_manager import Manager
from baton_tpu_torch.server.state import params_to_state_dict
from baton_tpu_torch.utils.checkpoint import Checkpointer

torch.set_num_threads(1)


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# tests/test_aux_subsystems.py's Checkpointer cases


def test_checkpoint_roundtrip(tmp_path):
    params = linear_regression_model(6).init(torch.Generator().manual_seed(0))
    opt = optim.adam(1e-3)
    # a state a few steps in (a non-zero count and moments)
    opt_state = opt.init(params)
    for _ in range(3):
        _, opt_state = opt.update({k: torch.ones_like(v) for k, v in params.items()},
                                  opt_state, params)

    with Checkpointer(str(tmp_path / "ckpt")) as ck:
        ck.save(3, params, server_opt_state=opt_state,
                meta={"n_rounds": 3, "loss_history": [1.0, 0.5]})
        assert ck.latest_step() == 3

        template = {k: torch.zeros_like(v) for k, v in params.items()}
        restored = ck.restore(template, server_opt_template=opt.init(template))
        assert restored is not None and restored.step == 3
        _equal_trees(restored.params, params)
        assert restored.meta["loss_history"] == [1.0, 0.5]
        # optimizer state roundtrips leaf-for-leaf (FedOpt resume)
        _equal_trees(restored.server_opt_state, opt_state)


def test_checkpoint_restore_empty_dir(tmp_path):
    with Checkpointer(str(tmp_path / "empty")) as ck:
        assert ck.latest_step() is None
        assert ck.restore({"w": torch.zeros(2)}) is None


def test_checkpoint_max_to_keep(tmp_path):
    params = {"w": torch.arange(4.0)}
    with Checkpointer(str(tmp_path / "gc"), max_to_keep=2) as ck:
        for step in range(5):
            ck.save(step, params, meta={})
        assert ck.all_steps() == [3, 4]


def test_a_step_exists_whole_or_not_at_all(tmp_path):
    """A save writes a temporary file and moves it into place: a file left
    half written by a crash is no step, and a finished save leaves no
    temporary file behind."""
    directory = tmp_path / "atomic"
    with Checkpointer(str(directory)) as ck:
        ck.save(1, {"w": torch.ones(3)})
        (directory / ".2.pt.tmp").write_bytes(b"half a checkpoint")
        assert ck.all_steps() == [1] and ck.latest_step() == 1
        ck.save(2, {"w": torch.full((3,), 2.0)})
        assert sorted(os.listdir(directory)) == ["1.pt", "2.pt"]
        assert torch.equal(ck.restore({"w": torch.zeros(3)}).params["w"], torch.full((3,), 2.0))


@pytest.mark.parametrize("damage", [b"", b"PK\x03\x04 half a zip", "truncated"])
def test_restore_passes_over_an_unreadable_latest_step(tmp_path, damage):
    """A newest step that does not load (empty, garbage or cut short, as a
    host crash before the data reached the disk could leave it) is passed
    over for the step before it; asked for by number, it still raises."""
    directory = tmp_path / "damaged"
    with Checkpointer(str(directory)) as ck:
        ck.save(1, {"w": torch.ones(3)}, meta={"loss_history": [1.0]})
        ck.save(2, {"w": torch.full((3,), 2.0)}, meta={"loss_history": [1.0, 0.5]})
        whole = (directory / "2.pt").read_bytes()
        if damage == "truncated":
            damage = whole[: len(whole) // 2]
        (directory / "2.pt").write_bytes(damage)
        restored = ck.restore({"w": torch.zeros(3)})
        assert restored.step == 1 and restored.meta == {"loss_history": [1.0]}
        assert torch.equal(restored.params["w"], torch.ones(3))
        with pytest.raises(Exception):
            ck.restore({"w": torch.zeros(3)}, step=2)
        (directory / "1.pt").write_bytes(b"")
        with pytest.raises(Exception):
            ck.restore({"w": torch.zeros(3)})


def test_checkpoint_without_server_opt_state_restores_none(tmp_path):
    """The HTTP manager saves no server optimizer state: a FedOpt run
    pointed at such a checkpoint gets None back and starts its optimizer
    afresh, instead of failing."""
    params = linear_regression_model(4).init(torch.Generator().manual_seed(1))
    with Checkpointer(str(tmp_path / "plain")) as ck:
        ck.save(2, params, meta={"n_rounds": 2})
        restored = ck.restore(params, server_opt_template=optim.adam(1e-2).init(params))
    assert restored.server_opt_state is None and restored.step == 2


def _fake_round(exp, n_epoch=2, scale=0.5):
    """Drive one complete round through the round machine directly, with
    a single synthetic client reporting scaled params."""
    exp.rounds.start_round(n_epoch=n_epoch)
    exp.rounds.client_start("c0")
    state = {
        k: v * scale for k, v in params_to_state_dict(exp.params).items()
    }
    exp.rounds.client_end("c0", {
        "state_dict": state,
        "n_samples": 8.0,
        "loss_history": [float(e) for e in range(n_epoch)],
    })
    exp.end_round()


def test_experiment_checkpoint_resume(tmp_path):
    ckdir = str(tmp_path / "exp_ck")
    model = linear_regression_model(4)

    app = web.Application()
    exp = Manager(app).register_experiment(
        model, name="exp", start_background_tasks=False, checkpoint_dir=ckdir,
        device="cpu",
    )
    _fake_round(exp)
    _fake_round(exp)
    saved_params = params_to_state_dict(exp.params)
    saved_losses = [float(x) for x in exp.rounds.loss_history]
    assert exp.rounds.n_rounds == 2
    exp.checkpointer.close()

    # "manager restart": a brand-new process state restores everything
    app2 = web.Application()
    exp2 = Manager(app2).register_experiment(
        model, name="exp", start_background_tasks=False, checkpoint_dir=ckdir,
        device="cpu",
    )
    assert exp2.rounds.n_rounds == 2
    assert [float(x) for x in exp2.rounds.loss_history] == saved_losses
    for k, v in params_to_state_dict(exp2.params).items():
        np.testing.assert_array_equal(v, saved_params[k])
    assert all(v.device.type == "cpu" for v in exp2.params.values())
    # and the round machine is usable (round names continue the sequence)
    name = exp2.rounds.start_round(n_epoch=1)
    assert name.endswith("00002")
    exp2.rounds.abort_round()
    exp2.checkpointer.close()


# ----------------------------------------------------------------------
# FedSim.run_rounds with a checkpointer


def _cohort(rng, n_clients=3, n_per_client=10, batch=4):
    datasets = synthetic_image_clients(rng, n_clients, n_per_client=n_per_client, image_size=8)
    datasets[1] = {k: v[:7] for k, v in datasets[1].items()}  # unequal weights
    return stack_client_datasets(datasets, batch_size=batch)


def _sim():
    return FedSim(cnn_mnist_model(image_size=8, width=4), batch_size=4, device="cpu",
                  optimizer=optim.sgd(0.05, momentum=0.9),
                  server_optimizer=optim.adam(1e-2))


def test_checkpoint_extra_tree_roundtrip(tmp_path):
    """The ``extra`` slot carries federation-mode state (a personal stack,
    clients' optimizer states): restored bit for bit, and a round resumed
    from the restored state equals one from the state in memory."""
    data, n_samples = _cohort(np.random.default_rng(0))
    sim = _sim()
    params = sim.init(torch.Generator().manual_seed(0))
    res = sim.run_round(params, data, n_samples, torch.Generator().manual_seed(1))
    personal = {"head": {k: torch.stack([v, 2 * v]) for k, v in res.params.items()
                         if k.startswith("dense")},
                "opt": res.server_opt_state}

    with Checkpointer(str(tmp_path / "ck")) as ck:
        ck.save(1, res.params, extra=personal, meta={"mode": "personal"})
        restored = ck.restore(res.params, extra_template=personal)
    assert restored.step == 1 and restored.meta["mode"] == "personal"
    _equal_trees(restored.extra, personal)

    def next_round(state):
        return sim.run_round(state, data, n_samples, torch.Generator().manual_seed(2),
                             server_opt_state=res.server_opt_state).params

    _equal_trees(next_round(restored.params), next_round(res.params))

    # a checkpoint WITHOUT extra restores cleanly with extra=None
    with Checkpointer(str(tmp_path / "ck2")) as ck2:
        ck2.save(1, res.params)
        assert ck2.restore(res.params, extra_template=personal).extra is None


def test_run_rounds_resumed_after_two_rounds_equals_four_to_the_bit(tmp_path):
    data, n_samples = _cohort(np.random.default_rng(1))
    params = _sim().init(torch.Generator().manual_seed(0))
    gen_seed = 11
    whole, whole_hist = _sim().run_rounds(params, data, n_samples,
                                          torch.Generator().manual_seed(gen_seed),
                                          n_rounds=4, n_epochs=2)
    ck = Checkpointer(str(tmp_path / "rounds"))
    _, first = _sim().run_rounds(params, data, n_samples, torch.Generator().manual_seed(gen_seed),
                                 n_rounds=2, n_epochs=2, checkpointer=ck)
    assert ck.all_steps() == [1, 2] and len(first) == 4
    # the stop: a new FedSim and a new Checkpointer on the same directory
    resumed, hist = _sim().run_rounds(params, data, n_samples,
                                      torch.Generator().manual_seed(gen_seed),
                                      n_rounds=4, n_epochs=2,
                                      checkpointer=Checkpointer(str(tmp_path / "rounds")))
    _equal_trees(resumed, whole)
    assert hist == whole_hist
    # the FedAdam state rode along: without it the resumed run differs
    restart, _ = _sim().run_rounds(
        Checkpointer(str(tmp_path / "rounds")).restore(params, step=2).params,
        data, n_samples, torch.Generator().manual_seed(gen_seed), n_rounds=2, n_epochs=2)
    assert any(not torch.equal(restart[k], whole[k]) for k in whole)


def test_round_generators_depend_on_the_seed_and_round_only():
    a = torch.Generator().manual_seed(3)
    torch.rand(5, generator=a)  # draws do not move the derivation
    draws = [torch.randperm(50, generator=round_generator(a, i)) for i in range(3)]
    again = [torch.randperm(50, generator=round_generator(torch.Generator().manual_seed(3), i))
             for i in range(3)]
    assert all(torch.equal(x, y) for x, y in zip(draws, again))
    assert not torch.equal(draws[0], draws[1])
    other = torch.randperm(50, generator=round_generator(torch.Generator().manual_seed(4), 0))
    assert not torch.equal(other, draws[0])


# ----------------------------------------------------------------------
# against the JAX package


def test_run_rounds_matches_the_jax_package():
    """4 rounds of 1 epoch, one batch a client (the shuffle then only
    reorders a batch's sum, so torch's generators and JAX's threefry give
    the same rounds), from the same weights: within 1e-4."""
    rng = np.random.default_rng(2)
    datasets = synthetic_image_clients(rng, 3, n_per_client=8, image_size=8)
    datasets[2] = {k: v[:5] for k, v in datasets[2].items()}
    data, n_samples = stack_client_datasets(datasets, batch_size=8)
    jmodel = jax_cnn(image_size=8, width=4)
    tsim = FedSim(cnn_mnist_model(image_size=8, width=4), batch_size=8,
                  learning_rate=0.05, device="cpu")
    tparams = tsim.init(torch.Generator().manual_seed(0))
    jparams = jax_from_state(jmodel.init(jax.random.key(0)), params_to_state_dict(tparams))
    jsim = JaxFedSim(jmodel, batch_size=8, learning_rate=0.05)
    jout, jhist = jsim.run_rounds(jparams, {k: jnp.asarray(v) for k, v in data.items()},
                                  jnp.asarray(n_samples), jax.random.key(1), n_rounds=4)
    tout, thist = tsim.run_rounds(tparams, data, n_samples, torch.Generator().manual_seed(1),
                                  n_rounds=4)
    np.testing.assert_allclose(thist, jhist, rtol=1e-4, atol=1e-4)
    moved = 0.0
    for name, want in jax_to_state(jout).items():
        np.testing.assert_allclose(tout[name].numpy(), want, rtol=1e-4, atol=1e-4, err_msg=name)
        moved = max(moved, float(np.abs(want - params_to_state_dict(tparams)[name]).max()))
    assert moved > 1e-2  # the rounds moved the params
