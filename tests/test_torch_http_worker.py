"""The port's ``ExperimentWorker`` at its torch seams, on the CPU.

* Init and shuffles come from explicit generators: a worker's round
  equals ``LocalTrainer.train`` replayed from the broadcast with a
  generator seeded ``rng_seed + 1``, exactly, for two workers training
  on concurrent threads of one process.
* An app cleanup returns while a heartbeat tick is retrying a manager
  that has stopped: the reference's worker waited for that tick, which
  never ends (the stall of ``test_replication.py``'s failover case).

Every test runs under its own wall-clock limit and binds ephemeral ports
through sockets it keeps open (``_torch_sockets``).
"""

import asyncio
import time

import aiohttp
import numpy as np
import torch
from aiohttp import web

from _torch_sockets import listen, run_bounded, serve, wait_until
from baton_tpu_torch.core.training import make_local_trainer
from baton_tpu_torch.data.synthetic import linear_client_data
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.ops.padding import pad_dataset, round_up
from baton_tpu_torch.server.http_manager import Manager
from baton_tpu_torch.server.http_worker import ExperimentWorker
from baton_tpu_torch.server.state import params_to_state_dict

torch.set_num_threads(1)


def test_worker_round_equals_direct_training_from_its_generators():
    model = linear_regression_model(10)
    rng = np.random.default_rng(4)
    # 3 batches each: the shuffle decides which samples share a step
    datasets = [linear_client_data(rng, min_batches=2, max_batches=2) for _ in range(2)]
    datasets = [{k: v[:70] for k, v in d.items()} for d in datasets]
    seeds, lr, n_epoch = (7, 7), 0.02, 3

    async def main():
        sock, mport = listen()
        app = web.Application()
        exp = Manager(app).register_experiment(model, name="seeded", round_timeout=60.0,
                                               device="cpu")
        start = {k: v.clone() for k, v in exp.params.items()}
        runners, workers = [await serve(app, sock)], []
        for d, seed in zip(datasets, seeds):
            wsock, wport = listen()
            wapp = web.Application()
            w = ExperimentWorker(wapp, model, f"127.0.0.1:{mport}", name="seeded", port=wport,
                                 heartbeat_time=30.0, rng_seed=seed, device="cpu",
                                 trainer=make_local_trainer(model, batch_size=32,
                                                            learning_rate=lr),
                                 get_data=lambda d=d: (d, d["x"].shape[0]))
            workers.append(w)
            runners.append(await serve(wapp, wsock))
        init = model.init(torch.Generator().manual_seed(seeds[0]))
        assert all(torch.equal(workers[0].params[k], init[k]) for k in init)
        uploads = []
        orig = ExperimentWorker.report_update

        async def record(self, round_name, n_samples, loss_history, **kw):
            uploads.append((self, params_to_state_dict(self.params), list(loss_history)))
            await orig(self, round_name, n_samples, loss_history, **kw)

        for w in workers:
            w.report_update = record.__get__(w)
        assert await wait_until(lambda: len(exp.registry) == 2)
        async with aiohttp.ClientSession() as session:
            url = f"http://127.0.0.1:{mport}/seeded/start_round?n_epoch={n_epoch}"
            async with session.get(url) as resp:
                assert resp.status == 200
        assert await wait_until(lambda: exp.rounds.n_rounds == 1)
        for r in runners:
            await r.cleanup()
        return start, workers, uploads, exp

    start, workers, uploads, exp = run_bounded(main)
    assert len(uploads) == 2
    trainer = make_local_trainer(model, batch_size=32, learning_rate=lr)
    for w, sd, losses in uploads:
        d = datasets[workers.index(w)]
        padded, n = pad_dataset(d, round_up(d["x"].shape[0], 32))
        batch = {k: torch.as_tensor(v) for k, v in padded.items()}
        gen = torch.Generator().manual_seed(seeds[workers.index(w)] + 1)
        want, _, want_losses = trainer.train(start, batch, n, n_epoch, generator=gen)
        for k in want:
            np.testing.assert_array_equal(sd[k], want[k].numpy())
        np.testing.assert_array_equal(losses, want_losses.numpy())
    # the same seed, different data: the shuffles were drawn alike but the
    # uploads differ, and the aggregate is their sample-weighted mean
    n = np.array([70.0, 70.0], np.float32)
    for k in start:
        mean = (uploads[0][1][k] * n[0] + uploads[1][1][k] * n[1]) / n.sum()
        np.testing.assert_allclose(exp.params[k].numpy(), mean, rtol=0, atol=1e-6)


def test_cleanup_returns_while_a_heartbeat_retries_a_stopped_manager():
    model = linear_regression_model(10)

    async def main():
        sock, mport = listen()
        app = web.Application()
        exp = Manager(app).register_experiment(model, name="hb", device="cpu")
        mrunner = await serve(app, sock)
        wsock, wport = listen()
        wapp = web.Application()
        worker = ExperimentWorker(
            wapp, model, f"127.0.0.1:{mport}", name="hb", port=wport, heartbeat_time=0.05,
            device="cpu", get_data=lambda: ({"x": np.zeros((4, 10), np.float32),
                                              "y": np.zeros((4, 1), np.float32)}, 4))
        wrunner = await serve(wapp, wsock)
        assert await wait_until(lambda: len(exp.registry) == 1)
        await mrunner.cleanup()
        # ticks come every 0.05 s: one now fails and sits in its retry
        # backoff (1 s, then 2, 4, ... capped at 60, for ever)
        await asyncio.sleep(0.3)
        t0 = time.perf_counter()
        await wrunner.cleanup()
        return time.perf_counter() - t0

    assert run_bounded(main, limit_s=30.0) < 5.0
