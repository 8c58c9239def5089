"""Sequence parallelism across processes on the CPU: a ``seq`` axis of 4
that crosses the boundary of two gloo processes, 2 shards each
(``tests/_torch_ring_child.py``), against the same calls in one process of
the port on the same numpy inputs (within 1e-6) and against the JAX
package's kernels on its 8-device virtual CPU mesh sharded 4 ways
(tests/test_torch_ring_attention_jax.py's tolerances: fp32 outputs 1e-5,
gradients 1e-4, bf16 2e-2; JAX's flash in interpret mode). The cases: the
dense ring, ring × flash (its plain path), striped and Ulysses, causal and
not, GQA, padded key biases with whole shards of padding, forward and the
vjp of a drawn cotangent for q, k, v and the bias; the flash ring under
``vmap(grad)`` over 2 clients; one training step of a 2-layer Llama
decoder (its loss and every gradient equal to one process's within 1e-6,
so a gradient multiplied by the number of processes fails, and both
processes' params equal afterwards); and each process computing only the
blocks of the shards it holds. Both children run under a hard timeout and
are killed in ``finally``."""

import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ring_child as child
from baton_tpu_torch.parallel.mesh import make_mesh

CHILD_TIMEOUT_S = 120
ONE_PROCESS_TOL = 1e-6
JAX_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}

torch.set_num_threads(1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The two children's JSON lines and arrays, in rank order."""
    out_dir = tmp_path_factory.mktemp("ring")
    coord = f"127.0.0.1:{free_port()}"
    script = os.path.join(os.path.dirname(__file__), "_torch_ring_child.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(script)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, script, coord, "2", str(rank), str(out_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            assert p.returncode == 0, f"child failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs, [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(2)]


def _one_process_mesh():
    return make_mesh(child.AXIS, ("seq",), devices=[torch.device("cpu")] * child.AXIS)


@functools.lru_cache(maxsize=None)
def _one_process_case(name):
    return child.run_case(name, _one_process_mesh())


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """JAX's output and its vjp of the case's cotangent (numpy fp32)."""
    import importlib

    import jax
    import jax.numpy as jnp

    from baton_tpu.parallel.mesh import make_mesh as jax_make_mesh

    # the module (the package exports a function of the same name)
    jra = importlib.import_module("baton_tpu.parallel.ring_attention")

    kind, *_, causal, _, dtype = child.CASES[name]
    q, k, v, dout, bias = child.case_arrays(name)
    make = {"ring": jra.make_ring_attention_fn, "flash": jra.make_flash_ring_attention_fn,
            "striped": jra.make_striped_attention_fn,
            "ulysses": jra.make_ulysses_attention_fn}[kind]
    fn = make(jax_make_mesh(child.AXIS, axis_names=("seq",)))
    jd = getattr(jnp, dtype)
    args = [jnp.asarray(a).astype(jd) for a in (q, k, v)]
    if bias is None:
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, causal=causal), *args)
    else:
        args.append(jnp.asarray(bias))
        out, vjp = jax.vjp(lambda q, k, v, b: fn(q, k, v, bias=b, causal=causal), *args)
    grads = vjp(jnp.asarray(dout).astype(jd))
    res = {"out": np.asarray(out, np.float32)}
    res.update(zip(("dq", "dk", "dv", "dbias"), (np.asarray(g, np.float32) for g in grads)))
    return res


def _of(arrays, prefix):
    return {k[len(prefix) + 1:]: a for k, a in arrays.items() if k.startswith(prefix + "/")}


def test_each_process_holds_its_two_shards(children):
    outs, _ = children
    assert [o["rank"] for o in outs] == [0, 1] and all(o["world"] == 2 for o in outs)
    assert [o["local_shards"] for o in outs] == [[0, 1], [2, 3]]


@pytest.mark.parametrize("name", list(child.CASES))
def test_processes_match_one_process(children, name):
    """Every process returns the whole output and the whole gradients, and
    they equal one process's run of the same seam."""
    _, arrays = children
    want = _one_process_case(name)
    for rank in range(2):
        got = _of(arrays[rank], name)
        assert set(got) == set(want)
        for what, w in want.items():
            np.testing.assert_allclose(got[what], w, rtol=ONE_PROCESS_TOL, atol=ONE_PROCESS_TOL,
                                       err_msg=f"rank {rank} {what}")


@pytest.mark.parametrize("name", list(child.CASES))
def test_processes_match_the_jax_kernels(children, name):
    _, arrays = children
    tol_out, tol_grad = JAX_TOL[child.CASES[name][-1]]
    want = _jax_case(name)
    got = _of(arrays[0], name)
    assert set(got) == set(want)
    for what, w in want.items():
        tol = tol_out if what == "out" else tol_grad
        assert np.isfinite(got[what]).all(), what
        np.testing.assert_allclose(got[what], w, rtol=tol, atol=tol, err_msg=what)


def test_flash_ring_under_vmap_of_grad_across_processes(children):
    _, arrays = children
    want = child.run_vmap_grad(_one_process_mesh())
    for rank in range(2):
        got = _of(arrays[rank], "vmap")
        for what, w in want.items():
            np.testing.assert_allclose(got[what], w, rtol=ONE_PROCESS_TOL, atol=ONE_PROCESS_TOL,
                                       err_msg=f"rank {rank} {what}")


@pytest.mark.parametrize("kind", list(child.LLAMA))
def test_llama_step_across_processes_equals_one_process(children, kind):
    """The loss and every gradient of step 0 within 1e-6 of one process's
    (a gather whose backward summed over the processes would double each
    gradient), and both processes' params equal after the step."""
    _, arrays = children
    want = child.run_llama_step(kind, _one_process_mesh())
    got = [_of(arrays[rank], f"llama_{kind}") for rank in range(2)]
    assert set(got[0]) == set(want) and any(k.startswith("grad/") for k in want)
    for rank in range(2):
        for what, w in want.items():
            np.testing.assert_allclose(got[rank][what], w, rtol=ONE_PROCESS_TOL,
                                       atol=ONE_PROCESS_TOL, err_msg=f"rank {rank} {what}")
    for what in want:
        if what.startswith("param/"):
            np.testing.assert_array_equal(got[0][what], got[1][what], err_msg=what)


def test_a_process_computes_only_the_shards_it_holds(children):
    """A causal ring over 4 shards makes 1 + 2 block calls for shards 0-1
    and 3 + 4 for shards 2-3 (10 = 4 + 4·3/2 in all), each pass; a process
    that ran every shard would make 10. The dense ring places only the
    process's own query shards."""
    outs, _ = children
    assert [o["calls"]["fwd"] for o in outs] == [3, 7]
    assert [o["calls"]["bwd"] for o in outs] == [3, 7]
    assert [o["calls"]["dense_shards"] for o in outs] == [[0, 1], [2, 3]]


def test_blocks_cross_the_process_boundary(children):
    """The block calls above moved bytes between the processes: the ring's
    steps, the output's gather and the gradients' gather."""
    outs, _ = children
    for o in outs:
        assert o["transport"]["bytes"] > 0 and o["transport"]["exchanges"] > 0


def test_a_ring_needs_equal_shards_a_process_and_this_process_shards():
    """The exchanges split evenly over the processes: an axis that gives
    them unequal shard counts is refused, as is a call with other than
    this process's shard count."""
    from baton_tpu_torch.parallel.mesh import Mesh
    from baton_tpu_torch.parallel.ring_attention import (
        make_ring_attention_fn,
        ring_attention,
    )

    cpu = torch.device("cpu")
    uneven = Mesh(np.array([cpu] * 3, dtype=object), ("seq",), process_ids=[0, 0, 1])
    q = torch.zeros(1, 2, 12, 4)
    with pytest.raises(ValueError, match="unequal shard counts"):
        make_ring_attention_fn(uneven)(q, q, q)
    shards = list(torch.chunk(q, 3, dim=2))
    with pytest.raises(ValueError, match="holds 4 shards"):
        ring_attention(shards, shards, shards, mesh=_one_process_mesh())
