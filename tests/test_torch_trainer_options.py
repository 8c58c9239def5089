"""The port's LocalTrainer options against JAX's ``train``: local
momentum, local Adam, FedProx (mu 0.1), a trainable head, and all of
them at once, on a tiny MLP and a tiny BERT (2 layers, d 32), 2 epochs,
the same weights, data and (injected) shuffles. The capacity leaves at
least one all-padding batch a epoch, so the gate on the optimizer state
is exercised: Adam's count must equal JAX's, and the number of batches
with samples. Params, losses and optimizer state within 1e-5.

Also: ``progress_fn`` fires once per epoch with JAX's losses,
``steps_per_round`` equals JAX's, ``train_with_opt_state`` continues a
state, ``make_evaluator`` matches JAX's, and a frozen leaf comes back
from a partitioned round untouched."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baton_tpu.core.partition import make_partition as jax_make_partition
from baton_tpu.core.regularizers import fedprox as jax_fedprox
from baton_tpu.core.training import make_evaluator as jax_make_evaluator
from baton_tpu.core.training import make_local_trainer as jax_trainer
from baton_tpu.models.bert import BertConfig as JaxBertConfig
from baton_tpu.models.bert import bert_classifier_model as jax_bert
from baton_tpu.models.mlp import mlp_classifier_model as jax_mlp
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu_torch.core import optim
from baton_tpu_torch.core.partition import make_partition
from baton_tpu_torch.core.regularizers import fedprox
from baton_tpu_torch.core.training import make_evaluator, make_local_trainer
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.ops.privacy import DPConfig

torch.set_num_threads(1)

BATCH, EPOCHS, TOL = 4, 2, 1e-5
CAPACITY, N = 6 * BATCH, 5  # at most 5 of the 6 batches hold a sample
L = 16

HEADS = {"mlp": lambda path, leaf: path.startswith("1/"),
         "bert": lambda path, leaf: path.startswith(("pooler/", "head/"))}

# option -> (JAX trainer kwargs, port trainer kwargs, trainable head?)
OPTIONS = {
    "momentum": (lambda: dict(optimizer=optax.sgd(0.05, momentum=0.9)),
                 lambda: dict(optimizer=optim.sgd(0.05, momentum=0.9)), False),
    "adam": (lambda: dict(optimizer=optax.adam(1e-3)),
             lambda: dict(optimizer=optim.adam(1e-3)), False),
    "fedprox": (lambda: dict(learning_rate=0.05, regularizer=jax_fedprox(0.1)),
                lambda: dict(learning_rate=0.05, regularizer=fedprox(0.1)), False),
    "head": (lambda: dict(learning_rate=0.05), lambda: dict(learning_rate=0.05), True),
    "all": (lambda: dict(optimizer=optax.adam(1e-3), regularizer=jax_fedprox(0.1)),
            lambda: dict(optimizer=optim.adam(1e-3), regularizer=fedprox(0.1)), True),
}


def jax_perms(rng, n_epochs, capacity):
    """The permutations the JAX trainer draws from ``rng``
    (core/training.py:205-206, 228): [n_epochs, capacity]."""
    return np.stack([
        np.asarray(jax.random.permutation(jax.random.split(er)[0], capacity))
        for er in jax.random.split(rng, n_epochs)
    ])


def _data(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "mlp":
        data = {"x": rng.normal(size=(CAPACITY, 8)).astype(np.float32),
                "y": rng.integers(0, 4, CAPACITY).astype(np.int32)}
    else:
        lengths = rng.integers(1, L + 1, CAPACITY)
        data = {"x": rng.integers(0, 128, (CAPACITY, L)).astype(np.int32),
                "attn_mask": (np.arange(L)[None] < lengths[:, None]).astype(np.float32),
                "y": rng.integers(0, 4, CAPACITY).astype(np.int32)}
    for v in data.values():
        v[N:] = 0  # padding rows are zeros, as stack_client_datasets makes them
    return data


@pytest.fixture(scope="module", params=["mlp", "bert"])
def models(request):
    kind = request.param
    if kind == "mlp":
        jmodel, tmodel = jax_mlp(8, (16,), 4), mlp_classifier_model(8, (16,), 4)
    else:
        jmodel = jax_bert(JaxBertConfig.tiny())
        tmodel = bert_classifier_model(BertConfig.tiny())
    jparams = jmodel.init(jax.random.key(0))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jax_to_state(jparams).items()}
    return kind, jmodel, jparams, tmodel, tparams


def _named(tree, paths):
    """A JAX pytree (or a partition's leaf list) as {name: numpy}."""
    if isinstance(tree, list) and paths is not None:
        return {p: np.asarray(v) for p, v in zip(paths, tree)}
    return jax_to_state(tree)


def _run_both(models, option):
    kind, jmodel, jparams, tmodel, tparams = models
    jkw, tkw, head = (f() if callable(f) else f for f in OPTIONS[option])
    data = _data(kind, 1)
    rng = jax.random.key(2)

    jpart = jax_make_partition(jparams, HEADS[kind]) if head else None
    jtrainable, jfrozen = jpart.split(jparams) if head else (jparams, None)
    jtrainer = jax_trainer(jmodel, batch_size=BATCH, partition=jpart, **jkw)
    janchor = jtrainable if "regularizer" in jkw else None
    jp, jstate, jloss = jtrainer.train(jtrainable, {k: jnp.asarray(v) for k, v in data.items()},
                                       jnp.asarray(N), rng, EPOCHS, janchor, jfrozen)

    tpart = make_partition(tparams, HEADS[kind]) if head else None
    ttrainable, tfrozen = tpart.split(tparams) if head else (tparams, None)
    ttrainer = make_local_trainer(tmodel, batch_size=BATCH, partition=tpart, **tkw)
    perm = torch.from_numpy(jax_perms(rng, EPOCHS, CAPACITY))
    tp, tstate, tloss = ttrainer.train(
        ttrainable, {k: torch.from_numpy(v) for k, v in data.items()}, N, EPOCHS,
        anchor=ttrainable if "regularizer" in tkw else None, frozen=tfrozen, perm=perm)
    paths = jpart.trainable_paths if head else None
    return dict(jp=_named(jp, paths), jstate=jstate, jloss=np.asarray(jloss), tp=tp,
                tstate=tstate, tloss=tloss.numpy(), paths=paths, perm=perm,
                tparams=tparams, tfrozen=tfrozen)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_train_matches_jax(models, option):
    r = _run_both(models, option)
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=TOL, atol=TOL)
    assert set(r["tp"]) == set(r["jp"])
    for name, want in r["jp"].items():
        np.testing.assert_allclose(r["tp"][name].numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=name)
    moved = max(float((r["tp"][k] - r["tparams"][k]).abs().max()) for k in r["tp"])
    assert moved > 1e-4
    inner = r["jstate"][0]
    if hasattr(inner, "mu"):
        # the gate: the count is the number of batches with samples, fewer
        # than the steps taken
        with_samples = int(sum((r["perm"][e].reshape(-1, BATCH) < N).any(1).sum()
                               for e in range(EPOCHS)))
        assert int(r["tstate"]["count"]) == int(inner.count) == with_samples < EPOCHS * 6
        for field in ("mu", "nu"):
            for name, want in _named(getattr(inner, field), r["paths"]).items():
                np.testing.assert_allclose(r["tstate"][field][name].numpy(), want,
                                           rtol=TOL, atol=TOL, err_msg=f"{field} {name}")
    elif hasattr(inner, "trace"):
        for name, want in _named(inner.trace, r["paths"]).items():
            np.testing.assert_allclose(r["tstate"]["trace"][name].numpy(), want,
                                       rtol=TOL, atol=TOL, err_msg=f"trace {name}")
    if r["tfrozen"] is not None:
        assert set(r["tp"]) | set(r["tfrozen"]) == set(r["tparams"])
        assert not set(r["tp"]) & set(r["tfrozen"])


def test_progress_fn_reports_each_epoch_with_jax_losses(models):
    kind, jmodel, jparams, tmodel, tparams = models
    data = _data(kind, 3)
    rng = jax.random.key(4)
    jcalls, tcalls = [], []
    jtrainer = jax_trainer(jmodel, batch_size=BATCH, learning_rate=0.05,
                           progress_fn=lambda e, loss: jcalls.append((int(e), float(loss))))
    _, _, jloss = jtrainer.train(jparams, {k: jnp.asarray(v) for k, v in data.items()},
                                 jnp.asarray(N), rng, EPOCHS)
    jax.effects_barrier()
    ttrainer = make_local_trainer(tmodel, batch_size=BATCH, learning_rate=0.05,
                                  progress_fn=lambda e, loss: tcalls.append((e, loss)))
    ttrainer.train(tparams, {k: torch.from_numpy(v) for k, v in data.items()}, N, EPOCHS,
                   perm=torch.from_numpy(jax_perms(rng, EPOCHS, CAPACITY)))
    assert [e for e, _ in tcalls] == [e for e, _ in jcalls] == list(range(EPOCHS))
    assert all(isinstance(loss, float) for _, loss in tcalls)
    np.testing.assert_allclose([x for _, x in tcalls], np.asarray(jloss), rtol=TOL, atol=TOL)
    np.testing.assert_allclose([x for _, x in tcalls], [x for _, x in jcalls],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("capacity,n_epochs", [(8, 1), (24, 2), (12, 3)])
def test_steps_per_round_and_signature_match_jax(models, capacity, n_epochs):
    kind, jmodel, _, tmodel, _ = models
    jt = jax_trainer(jmodel, batch_size=BATCH)
    tt = make_local_trainer(tmodel, batch_size=BATCH)
    assert tt.steps_per_round(capacity, n_epochs) == jt.steps_per_round(capacity, n_epochs)
    data = _data(kind, 0)
    tsig = tt.train_signature({k: torch.from_numpy(v) for k, v in data.items()}, n_epochs)
    jsig = jt.train_signature({k: jnp.asarray(v) for k, v in data.items()}, n_epochs)
    assert tsig[1:] == jsig[1:]
    assert [(k, s) for k, s, _ in tsig[0]] == [(k, s) for k, s, _ in jsig[0]]


def test_train_with_opt_state_continues_the_state(models):
    """Two calls of one epoch each, the state threaded, equal one call of
    two epochs; JAX's ``train_with_opt_state`` on the first call's state
    agrees."""
    kind, jmodel, jparams, tmodel, tparams = models
    data = {k: torch.from_numpy(v) for k, v in _data(kind, 5).items()}
    perm = torch.stack([torch.randperm(CAPACITY, generator=torch.Generator().manual_seed(e))
                        for e in range(2)])
    trainer = make_local_trainer(tmodel, optimizer=optim.adam(1e-3), batch_size=BATCH)
    both, both_state, both_loss = trainer.train(tparams, data, N, 2, perm=perm)
    p, state, loss0 = trainer.train(tparams, data, N, 1, perm=perm[:1])
    p, state, loss1 = trainer.train_with_opt_state(p, state, data, N, 1, perm=perm[1:])
    torch.testing.assert_close(torch.cat([loss0, loss1]), both_loss, rtol=0, atol=0)
    optim.tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                   (p, state), (both, both_state))
    assert trainer.init_opt_state(tparams)["count"] == 0


def test_make_evaluator_matches_jax(models):
    kind, jmodel, jparams, tmodel, tparams = models
    data = _data(kind, 6)
    data["mask"] = (np.arange(CAPACITY) < N).astype(np.float32)
    jout = jax_make_evaluator(jmodel)(jparams, {k: jnp.asarray(v) for k, v in data.items()},
                                      jax.random.key(0))
    tout = make_evaluator(tmodel)(tparams, {k: torch.from_numpy(v) for k, v in data.items()})
    assert set(tout) == set(jout) == {"loss", "accuracy"}
    for k in jout:
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=TOL, atol=TOL)


def test_a_regularizer_or_partition_needs_its_params(models):
    kind, _, _, tmodel, tparams = models
    data = {k: torch.from_numpy(v) for k, v in _data(kind, 0).items()}
    with pytest.raises(ValueError, match="anchor"):
        make_local_trainer(tmodel, batch_size=BATCH, regularizer=fedprox(0.1)).train(
            tparams, data, N)
    part = make_partition(tparams, HEADS[kind])
    trainable, _ = part.split(tparams)
    with pytest.raises(ValueError, match="frozen"):
        make_local_trainer(tmodel, batch_size=BATCH, partition=part).train(trainable, data, N)
    # DP-SGD's noise needs its generator
    with pytest.raises(ValueError, match="Generator"):
        make_local_trainer(tmodel, batch_size=BATCH, dp=DPConfig(1.0, 0.5)).train(
            tparams, data, N)
