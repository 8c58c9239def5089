"""The port's optimizer layer (``core/optim.py``) against optax itself:
plain SGD, momentum 0.9, Nesterov, Adam with its defaults, with
``b1=0.8, b2=0.99, eps=1e-6`` and with ``eps_root=1e-8``, five steps of seeded gradients, on one
client's leaves and on a stacked ``[C, ...]`` cohort (optax under
``jax.vmap``). Params, updates and state within 1e-6 (rtol and atol);
Adam's int32 step count equal."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baton_tpu_torch.core import optim

torch.set_num_threads(1)

SHAPES = {"dense/w": (3, 5), "dense/b": (5,), "scale": ()}
C, STEPS, TOL = 4, 5, 1e-6

OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.1), lambda: optim.sgd(0.1)),
    "momentum": (lambda: optax.sgd(0.1, momentum=0.9), lambda: optim.sgd(0.1, momentum=0.9)),
    "nesterov": (lambda: optax.sgd(0.1, momentum=0.9, nesterov=True),
                 lambda: optim.sgd(0.1, momentum=0.9, nesterov=True)),
    "adam": (lambda: optax.adam(1e-2), lambda: optim.adam(1e-2)),
    "adam_b1_b2_eps": (lambda: optax.adam(1e-2, b1=0.8, b2=0.99, eps=1e-6),
                       lambda: optim.adam(1e-2, b1=0.8, b2=0.99, eps=1e-6)),
    "adam_eps_root": (lambda: optax.adam(1e-2, eps_root=1e-8),
                      lambda: optim.adam(1e-2, eps_root=1e-8)),
}


def _draws(lead):
    rng = np.random.default_rng(0)
    params = {k: np.asarray(rng.normal(size=lead + s), np.float32) for k, s in SHAPES.items()}
    grads = [{k: np.asarray(rng.normal(size=lead + s) * 10.0 ** rng.integers(-4, 1), np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _port_state(state):
    """The port's state as a tuple in the order of optax's state fields."""
    if "count" in state:
        return (state["count"], state["mu"], state["nu"])
    if "trace" in state:
        return (state["trace"],)
    return ()


def _optax_state(state):
    """The fields of the first state of optax's chain (the second, the
    learning rate's scale, holds nothing)."""
    inner = state[0]
    if hasattr(inner, "mu"):
        return (inner.count, inner.mu, inner.nu)
    if hasattr(inner, "trace"):
        return (inner.trace,)
    return ()


def _close(got, want, what):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], f"{what}/{k}")
        return
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_matches_optax(name, stacked):
    make_optax, make_port = OPTIMIZERS[name]
    lead = (C,) if stacked else ()
    params, grads = _draws(lead)
    jopt, topt = make_optax(), make_port()
    jinit, jupdate = jopt.init, jopt.update
    if stacked:
        jinit, jupdate = jax.vmap(jinit), jax.vmap(jupdate)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js = jinit(jp)
    # a stacked cohort's state: every client's init, stacked (count [C])
    ts = topt.init({k: v[0] for k, v in tp.items()} if stacked else tp)
    if stacked:
        ts = optim.tree_map(lambda v: v.unsqueeze(0).repeat(C, *([1] * v.dim())), ts)
    for step, g in enumerate(grads):
        ju, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = optim.apply_updates(tp, tu)
        _close(tu, ju, f"step {step} updates")
        _close(tp, jp, f"step {step} params")
        for i, (got, want) in enumerate(zip(_port_state(ts), _optax_state(js), strict=True)):
            _close(got, want, f"step {step} state {i}")
    if name.startswith("adam"):
        assert ts["count"].dtype == torch.int32
        assert ts["count"].tolist() == ([STEPS] * C if stacked else STEPS)


def test_apply_updates_keeps_the_param_dtype():
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    out = optim.apply_updates(p, {"w": torch.full((3,), 1e-3, dtype=torch.float32)})
    want = optax.apply_updates({"w": jnp.ones(3, jnp.bfloat16)},
                               {"w": jnp.full((3,), 1e-3, jnp.float32)})
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  np.asarray(want["w"]).astype(np.float32))


def test_states_are_not_mutated():
    """``update`` is pure: the state it was given reads the same after."""
    topt = optim.adam(1e-2)
    params, grads = _draws(())
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    state = topt.update({k: torch.from_numpy(v) for k, v in grads[0].items()},
                        topt.init(tp), tp)[1]
    before = optim.tree_map(torch.clone, state)
    topt.update({k: torch.from_numpy(v) for k, v in grads[1].items()}, state, tp)
    optim.tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), state, before)
