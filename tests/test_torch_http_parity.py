"""The HTTP round of the port held against the JAX package's on the CPU,
and each package's worker under the other's manager over BTW1: the
streamed fold of the uploads (the default) and the buffered merge.

Every federation starts from the same global params (``params=``) and
gives each worker the same numpy data. Each client holds at most one
batch, so the per-epoch shuffle (JAX's threefry against a torch
generator) only reorders a batch's sum. Global params must agree within
1e-5 after two rounds of two epochs.

Every test runs under its own wall-clock limit and binds ephemeral ports
through sockets it keeps open (``_torch_sockets``).
"""

import jax
import numpy as np
import pytest
import torch
from aiohttp import ClientSession, web

from _torch_sockets import listen, run_bounded, serve, wait_until
from baton_tpu.core.training import make_local_trainer as jax_trainer
from baton_tpu.data.synthetic import linear_client_data, synthetic_image_clients
from baton_tpu.models.cnn import cnn_mnist_model as jax_cnn
from baton_tpu.models.linear import linear_regression_model as jax_linear
from baton_tpu.server.http_manager import Manager as JaxManager
from baton_tpu.server.http_worker import ExperimentWorker as JaxWorker
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu.server.state import state_dict_to_params as jax_from_state
from baton_tpu_torch.core.training import make_local_trainer
from baton_tpu_torch.models.cnn import cnn_mnist_model
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.server.http_manager import Manager
from baton_tpu_torch.server.http_worker import ExperimentWorker
from baton_tpu_torch.server.state import params_to_state_dict

torch.set_num_threads(1)

TOL = 1e-5
N_ROUNDS, N_EPOCH, BATCH = 2, 2, 32

SIZES = (32, 25, 9)  # unequal: the aggregate's weights matter


def _cut(datasets):
    return [{k: v[:n] for k, v in d.items()} for d, n in zip(datasets, SIZES, strict=True)]


# name -> (JAX model, port model, learning rate, data of 3 clients)
CASES = {
    "linear": (lambda: jax_linear(10), lambda: linear_regression_model(10), 0.02,
               lambda rng: _cut([linear_client_data(rng, min_batches=1, max_batches=1)
                                 for _ in range(3)])),
    "cnn": (lambda: jax_cnn(image_size=8, width=4), lambda: cnn_mnist_model(image_size=8, width=4),
            0.05, lambda rng: _cut(synthetic_image_clients(rng, 3, n_per_client=32,
                                                           image_size=8))),
}


def _setup(case):
    make_jax, make_port, lr, make_data = CASES[case]
    data = make_data(np.random.default_rng(3))
    init = params_to_state_dict(make_port().init(torch.Generator().manual_seed(0)))
    return make_jax, make_port, lr, data, init


def federation(case, manager_pkg, worker_pkgs, **manager_kw):
    """Run N_ROUNDS over HTTP: a ``manager_pkg`` manager ("jax" or
    "torch", built with ``manager_kw``) and one worker per entry of
    ``worker_pkgs``; returns the final global params as a flat numpy state
    dict."""
    make_jax, make_port, lr, data, init = _setup(case)
    jax_model, port_model = make_jax(), make_port()
    name = port_model.name

    async def main():
        sock, mport = listen()
        app = web.Application()
        if manager_pkg == "jax":
            template = jax_model.init(jax.random.key(0))
            exp = JaxManager(app).register_experiment(
                jax_model, name=name, params=jax_from_state(template, init), round_timeout=60.0,
                **manager_kw)
        else:
            exp = Manager(app).register_experiment(
                port_model, name=name, params={k: torch.from_numpy(v) for k, v in init.items()},
                round_timeout=60.0, device="cpu", **manager_kw)
        runners = [await serve(app, sock)]
        jax_shared = jax_trainer(jax_model, batch_size=BATCH, learning_rate=lr)
        for pkg, d in zip(worker_pkgs, data):
            wsock, wport = listen()
            wapp = web.Application()
            common = dict(name=name, port=wport, heartbeat_time=30.0,
                          get_data=lambda d=d: (d, d["x"].shape[0]))
            if pkg == "jax":
                JaxWorker(wapp, jax_model, f"127.0.0.1:{mport}", trainer=jax_shared, **common)
            else:
                ExperimentWorker(wapp, port_model, f"127.0.0.1:{mport}", device="cpu",
                                 trainer=make_local_trainer(port_model, batch_size=BATCH,
                                                            learning_rate=lr), **common)
            runners.append(await serve(wapp, wsock))
        assert await wait_until(lambda: len(exp.registry) == len(worker_pkgs))
        async with ClientSession() as session:
            for r in range(N_ROUNDS):
                url = f"http://127.0.0.1:{mport}/{name}/start_round?n_epoch={N_EPOCH}"
                async with session.get(url) as resp:
                    assert resp.status == 200
                    acks = await resp.json()
                assert len(acks) == len(worker_pkgs) and all(acks.values()), acks
                assert await wait_until(lambda: exp.rounds.n_rounds == r + 1, timeout_s=40.0)
        out = jax_to_state(exp.params) if manager_pkg == "jax" else params_to_state_dict(exp.params)
        for runner in runners:
            await runner.cleanup()
        return out

    return run_bounded(main)


def _max_gap(a, b):
    assert set(a) == set(b)
    return max(float(np.max(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))))
               for k in a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_round_matches_the_jax_round(case):
    want = federation(case, "jax", ["jax"] * 3)
    got = federation(case, "torch", ["torch"] * 3)
    init = _setup(case)[4]
    assert _max_gap(got, init) > 1e-3  # the rounds moved the params
    assert _max_gap(got, want) <= TOL


def test_torch_worker_under_a_jax_manager():
    want = federation("linear", "jax", ["jax"] * 3)
    got = federation("linear", "jax", ["torch", "jax", "torch"])
    assert _max_gap(got, want) <= TOL


def test_jax_worker_under_a_torch_manager():
    want = federation("linear", "torch", ["torch"] * 3)
    got = federation("linear", "torch", ["jax", "torch", "jax"])
    assert _max_gap(got, want) <= TOL


def test_buffered_merge_matches_the_jax_package():
    """``streaming_aggregation=False``: the manager stacks the uploads and
    merges them with the aggregator (torch.stack + apply_aggregator in
    the port, jnp.stack in the reference)."""
    want = federation("cnn", "jax", ["jax"] * 3, streaming_aggregation=False)
    got = federation("cnn", "torch", ["torch"] * 3, streaming_aggregation=False)
    assert _max_gap(got, want) <= TOL

