"""Buffer donation in the port: ``FedSim.run_rounds_fused(donate_buffers=)``
and ``LocalTrainer.train_with_opt_state``.

On the CPU the fused rounds run a plain loop that never writes the
caller's tensors, so both flags give JAX's fused run under the same flag
(FedAdam on the server, from the same weights and data; one batch a client,
so each epoch's shuffle only reorders a sum and JAX's keys need not be
reproduced) within 1e-5, and leave the caller's params and server state as
they were. The card's buffers come from ``graph_buffers``, whose rule is
held here on CPU tensors: a donatable leaf, of any dtype, is its own
buffer; a non-contiguous one, one that requires grad and one whose storage
another leaf or a frozen leaf shares are cloned; the port's
own leaves (a leaf gathered from its placement, a server state it made)
are never cloned again. ``train_with_opt_state`` passes views, not copies,
and its result is bit-equal to the copies' with the caller's tensors
unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baton_tpu.models.mlp import mlp_classifier_model as jax_mlp
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu_torch import FedSim
from baton_tpu_torch.core import optim
from baton_tpu_torch.core.sharded import ShardedLeaf
from baton_tpu_torch.core.training import make_local_trainer, stack_copies
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel.engine import graph_buffers
from _torch_variants import assert_params_close, to_port

torch.set_num_threads(1)

TOL = 1e-5


def _clone(tree):
    return optim.tree_map(lambda v: v.clone(), tree)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
        return
    assert torch.equal(a, b)


@pytest.mark.parametrize("donate", [True, False])
def test_fused_rounds_against_jax_under_each_donation_flag(donate):
    """Both packages' fused rounds with a FedAdam server from the same
    weights and server state, 4 rounds of 2 epochs in two waves, under the
    same ``donate_buffers``: params, server moments and losses within 1e-5,
    and the port's caller's params and server state unchanged."""
    rng = np.random.default_rng(5)
    sizes = (16, 7, 0, 16, 12)
    datasets = [{"x": rng.normal(size=(s, 6)).astype(np.float32),
                 "y": rng.integers(0, 3, s).astype(np.int32)} for s in sizes]
    data, n = stack_client_datasets(datasets, batch_size=16)
    assert data["x"].shape[1] == 16  # one batch a client
    jm = jax_mlp(6, (8,), 3)
    jsim = JaxFedSim(jm, batch_size=16, learning_rate=0.05, server_optimizer=optax.adam(0.05))
    jparams = jm.init(jax.random.key(0))
    params = to_port(jparams)  # before JAX's run, which may donate jparams
    jp, jh, jsos = jsim.run_rounds_fused(
        jparams, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(n),
        jax.random.key(1), n_rounds=4, n_epochs=2, wave_size=3,
        server_opt_state=optax.adam(0.05).init(jparams), return_server_opt_state=True,
        donate_buffers=donate)
    sim = FedSim(mlp_classifier_model(6, (8,), 3), batch_size=16, learning_rate=0.05,
                 server_optimizer=optim.adam(0.05), device="cpu")
    sos = sim.init_server_opt_state(params)
    before, sos_before = _clone(params), _clone(sos)
    p, h, s = sim.run_rounds_fused(params, data, n, torch.Generator().manual_seed(1),
                                   n_rounds=4, n_epochs=2, wave_size=3, server_opt_state=sos,
                                   return_server_opt_state=True, donate_buffers=donate)
    assert_params_close(p, jp, TOL)
    np.testing.assert_allclose(h, jh, rtol=TOL, atol=1e-6)
    inner = jsos[0]
    assert int(s["count"]) == int(inner.count) == 4
    assert_params_close(s["mu"], inner.mu, TOL)
    assert_params_close(s["nu"], inner.nu, TOL)
    _assert_same(params, before)
    _assert_same(sos, sos_before)
    assert all(p[k].data_ptr() != params[k].data_ptr() for k in p)
    assert sim.last_fused == {"graph": False, "rounds": 4}


def _leaves():
    gen = torch.Generator().manual_seed(0)
    return {"a": torch.randn(4, 3, generator=gen), "b": torch.randn(5, generator=gen)}


def _buffers(leaves, donate=True, frozen=()):
    (buffers,), record = graph_buffers([leaves], [leaves], "cpu", donate, frozen)
    return buffers, record


def test_a_donatable_leaf_is_its_own_buffer():
    leaves = _leaves()
    buffers, record = _buffers(leaves)
    assert all(buffers[k] is leaves[k] for k in leaves)
    assert record == {"donated": 2, "donated_bytes": 4 * 17, "owned": 0, "owned_bytes": 0,
                      "copied": 0, "copied_bytes": 0}


def test_without_donation_every_callers_leaf_is_copied():
    leaves = _leaves()
    buffers, record = _buffers(leaves, donate=False)
    for k in leaves:
        assert buffers[k].data_ptr() != leaves[k].data_ptr()
        assert torch.equal(buffers[k], leaves[k])
    assert record["copied"] == 2 and record["copied_bytes"] == 4 * 17
    assert record["donated"] == 0


@pytest.mark.parametrize("fault", ["non_contiguous", "requires_grad", "shared_storage",
                                   "disjoint_views", "shares_a_frozen_storage"])
def test_a_leaf_that_cannot_serve_as_a_buffer_is_copied(fault):
    """The faulty leaf ``a`` is cloned (its buffer equal to it, in its own
    memory); ``b`` is still donated, but where ``a``'s storage is ``b``'s
    (overlapping or not: the rule compares storages)."""
    leaves, frozen = _leaves(), []
    if fault == "non_contiguous":
        leaves["a"] = torch.randn(3, 4).t()
    elif fault == "requires_grad":
        leaves["a"].requires_grad_(True)
    elif fault == "shared_storage":
        leaves["a"] = leaves["b"][1:4]
    elif fault == "disjoint_views":
        base = torch.arange(10.0)
        leaves = {"a": base[:4], "b": base[4:]}
    else:
        frozen = [leaves["a"].view(-1)[2:5]]
    buffers, record = _buffers(leaves, frozen=frozen)
    assert buffers["a"] is not leaves["a"] and buffers["a"].data_ptr() != leaves["a"].data_ptr()
    assert torch.equal(buffers["a"], leaves["a"].detach())
    assert not buffers["a"].requires_grad
    donated_b = fault not in ("shared_storage", "disjoint_views")
    assert (buffers["b"] is leaves["b"]) == donated_b
    assert record["copied"] == (1 if donated_b else 2)
    assert record["donated"] == int(donated_b)


def test_a_leaf_of_any_dtype_serves():
    """The graph holds each leaf in its own dtype, as a clone would: a bf16
    leaf and an int64 count are donated as they are."""
    leaves = {"a": torch.randn(4, 3).bfloat16(), "count": torch.zeros((), dtype=torch.int64)}
    buffers, record = _buffers(leaves)
    assert all(buffers[k] is leaves[k] for k in leaves)
    assert record["donated"] == 2 and record["copied"] == 0


@pytest.mark.parametrize("donate", [True, False])
def test_the_ports_own_leaves_are_never_cloned_again(donate):
    """A leaf gathered from its placement and a server state the port
    initialised are their own buffers under both flags; the caller's other
    leaves follow the flag, a caller's server state as well."""
    sim = FedSim(mlp_classifier_model(6, (8,), 3), batch_size=16,
                 server_optimizer=optim.adam(0.05), device="cpu")
    params = sim.init(torch.Generator().manual_seed(0))
    given = dict(params)
    w = given["0/w"]
    given["0/w"] = ShardedLeaf([w[:, :4].contiguous(), w[:, 4:].contiguous()], 1)
    gathered = {k: v.gather() if isinstance(v, ShardedLeaf) else v for k, v in given.items()}
    own_sos = sim.server_optimizer.init(gathered)
    (p, sos), record = graph_buffers([gathered, own_sos], [given, None], "cpu", donate)
    assert p["0/w"] is gathered["0/w"]
    assert all(sos_leaf is own for sos_leaf, own in zip(
        [sos["count"], *sos["mu"].values(), *sos["nu"].values()],
        [own_sos["count"], *own_sos["mu"].values(), *own_sos["nu"].values()]))
    others = [k for k in params if k != "0/w"]
    assert all((p[k] is params[k]) == donate for k in others)
    assert record["owned"] == 1 + 1 + 2 * len(params)
    assert record["donated"] == (len(others) if donate else 0)

    callers_sos = sim.server_optimizer.init(gathered)
    (_, sos), record = graph_buffers([gathered, callers_sos], [given, callers_sos], "cpu",
                                     donate)
    assert (sos["mu"]["0/b"] is callers_sos["mu"]["0/b"]) == donate
    assert record["copied"] == (0 if donate else len(others) + 1 + 2 * len(params))
    assert graph_buffers([gathered, None], [given, None], "cpu", donate)[0][1] is None


def test_frozen_leaves_are_read_not_donated():
    """With a trainable part, a trainable leaf that shares storage with a
    frozen one is copied: the frozen params are read after the run."""
    sim = FedSim(mlp_classifier_model(6, (8,), 3), batch_size=16, device="cpu",
                 trainable=lambda name, leaf: name.startswith("1/"))
    params = sim.init(torch.Generator().manual_seed(0))
    params["1/b"] = params["0/b"][:3]  # a trainable view into a frozen leaf
    trainable, frozen = sim._split(params)
    (p,), record = graph_buffers([trainable], [trainable], "cpu", True, list(frozen.values()))
    assert p["1/w"] is params["1/w"]
    assert p["1/b"] is not params["1/b"] and record["copied"] == 1


def _trainer_case():
    rng = np.random.default_rng(2)
    model = mlp_classifier_model(6, (8,), 3)
    trainer = make_local_trainer(model, optimizer=optim.adam(0.01), batch_size=8)
    params = model.init(torch.Generator().manual_seed(0))
    state = trainer.optimizer.init(params)
    state = optim.tree_map(lambda v: v + 0.01 if v.is_floating_point() else v + 3, state)
    data = {"x": torch.from_numpy(rng.normal(size=(24, 6)).astype(np.float32)),
            "y": torch.from_numpy(rng.integers(0, 3, 24).astype(np.int64))}
    perm = torch.stack([torch.randperm(24, generator=torch.Generator().manual_seed(e))
                        for e in range(3)])
    return trainer, params, state, data, perm


def test_train_with_opt_state_passes_views_and_matches_the_copies():
    """The result is bit-equal to ``train_stacked`` from ``repeat`` copies,
    and the caller's params and state are unchanged."""
    trainer, params, state, data, perm = _trainer_case()
    before, state_before = _clone(params), _clone(state)
    p, s, losses = trainer.train_with_opt_state(params, state, data, 17, n_epochs=3, perm=perm)
    wp, ws, wl = trainer.train_stacked(
        stack_copies(params, 1), stack_copies(state, 1), {k: v[None] for k, v in data.items()},
        torch.as_tensor([17]), 3, perm[None])
    _assert_same(p, optim.tree_map(lambda v: v[0], wp))
    _assert_same(s, optim.tree_map(lambda v: v[0], ws))
    assert torch.equal(losses, wl[0])
    _assert_same(params, before)
    _assert_same(state, state_before)
    assert int(s["count"]) == 3 + 3 * 3  # 3 epochs of 3 batches from a count of 3


def test_train_with_opt_state_hands_train_stacked_views(monkeypatch):
    trainer, params, state, data, perm = _trainer_case()
    seen = {}
    real = type(trainer).train_stacked

    def spy(self, p, s, *args, **kw):
        seen["p"], seen["s"] = p, s
        return real(self, p, s, *args, **kw)

    monkeypatch.setattr(type(trainer), "train_stacked", spy)
    trainer.train_with_opt_state(params, state, data, 17, n_epochs=1, perm=perm[:1])
    assert all(seen["p"][k].data_ptr() == params[k].data_ptr() for k in params)
    assert all(seen["s"]["mu"][k].data_ptr() == state["mu"][k].data_ptr() for k in params)
    assert seen["s"]["count"].shape == (1,)
