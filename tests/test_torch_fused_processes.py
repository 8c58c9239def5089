"""``FedSim.run_rounds_fused`` across two processes over gloo on the CPU,
each holding 4 shards of a clients axis of 8 (the child:
``tests/_torch_fused_child.py``; free ports, ``CUDA_VISIBLE_DEVICES=""``,
each child under a hard timeout and killed in ``finally``). On the CPU a
fused round runs its three steps as plain calls: piece A (the waves and
the local fold into one flat fp32 buffer, ``agg.psum_local``), the
all-reduce across the processes (``agg.psum_across``) and piece B (the
sums read back, the divide, the server step); the card captures A and B as
two CUDA graphs around the eager all-reduce (``chip_smoke.py`` phase 26c).

For every case of the child (the linear model; the MLP classifier with
FedAdam; FedProx; DP-SGD with a binding clip and no noise; DP-SGD with
noise; a tiny LoRA Llama on ``make_hybrid_mesh([("model", 2)],
dcn_axis="clients")``), three rounds of two epochs in two waves, one batch
a client: the fused rounds bit-equal to ``run_rounds`` on the same
two-process mesh, params and loss histories; both ranks' results equal;
within 1e-5 of the port's fused rounds in one process on 8 CPU shards (4 x
2 for LoRA); and within 1e-5 of JAX's ``run_rounds_fused`` on its 8
virtual CPU devices (4 x 2 for LoRA) from the same weights (one batch a
client: each epoch's shuffle only reorders the rows of one sum, so JAX's
keys need not be reproduced). The noised DP case is held to all but JAX's:
its noise comes from JAX's own keys. Also the split psum: its three parts
in a row give exactly ``psum``'s result, in one process and across the
two."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baton_tpu.core.regularizers import fedprox as jax_fedprox
from baton_tpu.models.linear import linear_regression_model as jax_linear
from baton_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from baton_tpu.models.llama import llama_lm_model as jax_llama
from baton_tpu.models.llama import llama_lora_target as jax_target
from baton_tpu.models.lora import lora_trainable as jax_lora_trainable
from baton_tpu.models.lora import lora_wrap as jax_lora_wrap
from baton_tpu.models.mlp import mlp_classifier_model as jax_mlp
from baton_tpu.ops.privacy import DPConfig as JaxDPConfig
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.parallel.mesh import make_mesh as jax_make_mesh
from baton_tpu_torch import FedSim
from baton_tpu_torch.ops import aggregation as agg
from baton_tpu_torch.parallel.mesh import make_mesh
from baton_tpu_torch.parallel.tensor_parallel import gather_params
from _torch_fused_child import CASES, N_EPOCHS, ROUNDS, cohort, lora_config, mesh_of
from _torch_variants import assert_params_close, to_port

torch.set_num_threads(1)

CHILD_TIMEOUT_S = 120
TOL = 1e-5
CPU8 = [torch.device("cpu")] * 8


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_case(case: str):
    """JAX's model and FedSim keywords for a case (as the child's)."""
    if case == "lora":
        model = jax_lora_wrap(jax_llama(lora_config(JaxLlamaConfig)), rank=2, target=jax_target)
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                                 ("clients", "model"))
        return model, dict(batch_size=4, learning_rate=0.05, trainable=jax_lora_trainable,
                           mesh=mesh)
    model = jax_linear(6) if case == "linear" else jax_mlp(6, (8,), 3)
    kw = dict(batch_size=16, learning_rate=0.05, mesh=jax_make_mesh(8))
    kw.update({"linear": {}, "mlp_fedadam": {"server_optimizer": optax.adam(0.05)},
               "fedprox": {"regularizer": jax_fedprox(0.1)},
               "dp": {"dp": JaxDPConfig(clip_norm=0.05, noise_multiplier=0.0)},
               "dp_noise": {}}[case])
    return model, kw


def _one_process(case: str, params: dict) -> dict:
    """The port's fused rounds of a case in one process on 8 CPU shards
    (clients 4 x model 2 for LoRA)."""
    model, data, n, kw, wave = cohort(case)
    sim = FedSim(model, mesh=mesh_of(case, CPU8), **kw)
    p, h = sim.run_rounds_fused(params, data, n, torch.Generator().manual_seed(1),
                                n_rounds=ROUNDS, n_epochs=N_EPOCHS, wave_size=wave)
    return {"params": gather_params(p), "history": h}


def _jax_fused(case: str, jparams) -> tuple:
    """JAX's ``run_rounds_fused`` of a case on its 8 virtual CPU devices."""
    _, data, n, _, wave = cohort(case)
    jmodel, jkw = _jax_case(case)
    return JaxFedSim(jmodel, **jkw).run_rounds_fused(
        jparams, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(n),
        jax.random.key(1), n_rounds=ROUNDS, n_epochs=N_EPOCHS, wave_size=wave,
        donate_buffers=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two children's JSON lines and results, in rank order, and what
    they are held against: JAX's initial params, the port's one-process
    fused rounds and JAX's fused rounds of each case, computed here while
    the children run."""
    tmp = tmp_path_factory.mktemp("fused_processes")
    jax_params = {case: _jax_case(case)[0].init(jax.random.key(0)) for case in CASES}
    params = {case: to_port(p) for case, p in jax_params.items()}
    params_path = tmp / "params.pt"
    torch.save(params, params_path)
    coord = f"127.0.0.1:{free_port()}"
    child = os.path.join(os.path.dirname(__file__), "_torch_fused_child.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(child)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               CUDA_VISIBLE_DEVICES="")
    outs = [tmp / f"rank{rank}.pt" for rank in range(2)]
    procs = [subprocess.Popen([sys.executable, child, coord, "2", str(rank), str(params_path),
                               str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for rank, out in enumerate(outs)]
    lines = []
    try:
        one = {case: _one_process(case, params[case]) for case in CASES}
        jx = {case: _jax_fused(case, jax_params[case]) for case in CASES if case != "dp_noise"}
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            assert p.returncode == 0, f"child failed:\n{err[-3000:]}"
            lines.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return {"lines": lines, "ranks": [torch.load(out) for out in outs], "one_process": one,
            "jax": jx}


def _equal(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def _close(got: dict, want: dict, tol: float = TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=tol, atol=tol, msg=k)


def test_split_psum_in_one_process():
    """``psum_local``, ``psum_across`` and ``psum_views`` in a row are
    ``psum`` bit for bit on 4 CPU shards (a bf16 leaf and a scalar among
    the leaves), the local part into the caller's buffer; a buffer of the
    wrong size is refused."""
    mesh = make_mesh(4, devices=CPU8[:4])
    gen = torch.Generator().manual_seed(0)
    parts = [{"p": {"w": torch.randn(6, 5, generator=gen),
                    "b": torch.randn(5, generator=gen).bfloat16()},
              "l": torch.randn(2, generator=gen), "w": torch.rand((), generator=gen)}
             for _ in range(4)]
    buf = torch.full((agg.flat_size(parts[0]),), float("nan"))
    assert agg.psum_local(parts, mesh, out=buf) is buf
    assert agg.psum_across(buf, mesh) is buf  # one process: nothing to add
    split = agg.psum_views(buf, parts[0], mesh)
    whole = agg.psum(parts, mesh)
    assert len(split) == len(whole) == 4
    for s, w in zip(split, whole):
        for a, b in zip(agg._leaves(s), agg._leaves(w)):
            assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    want = parts[0]["p"]["w"]
    for part in parts[1:]:
        want = want + part["p"]["w"]
    assert torch.equal(split[0]["p"]["w"], want)
    with pytest.raises(ValueError, match="buffer"):
        agg.psum_local(parts, mesh, out=torch.empty(buf.numel() + 1))


def test_split_psum_across_two_processes(runs):
    lines = runs["lines"]
    assert [o["rank"] for o in lines] == [0, 1]
    assert all(o["ok"] and o["world"] == 2 and o["split_psum"] for o in lines)


def test_record_round_defaults_count_the_process_group(runs):
    """``record_round`` with neither ``device`` nor ``n_chips`` in each of
    the two gloo processes: the CPU, and the group's world size as the
    run's count, which the per-chip rate divides by."""
    from baton_tpu_torch.obs.compute import validate_record

    for line in runs["lines"]:
        rec = line["default_record"]
        assert validate_record(rec) == []
        assert rec["n_chips"] == line["world"] == 2 and rec["device_kind"] == "cpu"
        assert rec["samples_per_sec_per_chip"] == round(8 / 0.5 / 2, 3)
        assert rec["peak_hbm_gb"] is None and rec["peak_hbm_gb_reason"]


@pytest.mark.parametrize("case", CASES)
def test_fused_rounds_across_processes_equal_run_rounds(runs, case):
    for line, res in zip(runs["lines"], runs["ranks"]):
        r = res[case]
        assert _equal(r["fused"]["params"], r["loop"]["params"])
        assert r["fused"]["history"] == r["loop"]["history"]
        assert len(r["fused"]["history"]) == ROUNDS * N_EPOCHS
        assert line["last_fused"][case] == {"graph": False, "rounds": ROUNDS}


@pytest.mark.parametrize("case", CASES)
def test_both_ranks_agree(runs, case):
    r0, r1 = runs["ranks"]
    assert _equal(r0[case]["fused"]["params"], r1[case]["fused"]["params"])
    assert r0[case]["fused"]["history"] == r1[case]["fused"]["history"]


@pytest.mark.parametrize("case", CASES)
def test_against_one_process_fused_rounds(runs, case):
    """The two processes' fused rounds against the port's fused rounds in
    one process on 8 CPU shards (clients 4 x model 2 for LoRA)."""
    got, want = runs["ranks"][0][case]["fused"], runs["one_process"][case]
    _close(got["params"], want["params"])
    np.testing.assert_allclose(got["history"], want["history"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", [c for c in CASES if c != "dp_noise"])
def test_against_jax_fused_rounds(runs, case):
    """The two processes' fused rounds against JAX's ``run_rounds_fused``
    on its 8 virtual CPU devices from the same weights, one batch a
    client."""
    got = runs["ranks"][0][case]["fused"]
    jp, jh = runs["jax"][case]
    assert_params_close(got["params"], jp, TOL)
    np.testing.assert_allclose(got["history"], jh, rtol=TOL, atol=TOL)
