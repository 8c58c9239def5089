"""The HTTP protocol cases of ``tests/test_http_protocol.py`` against the
port's ``Manager`` and ``ExperimentWorker`` on the CPU (``device="cpu"``).

(a) the manager's endpoints through an in-process aiohttp TestClient:
routes and the 400/401/410/423 codes, the malformed upload, the culled
round and the outsider's upload; (b) federations over loopback sockets:
two workers converging on the demo's coefficients, per-epoch progress
while a round runs, the simulated cohort, the median aggregator against a
byzantine worker, the cohort fraction, and the demo's manager and
workers.

Every test runs under its own wall-clock limit (``_torch_sockets``), and
every server binds an ephemeral port through a socket it keeps open.
"""

import asyncio
import time
import types

import aiohttp
import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from _torch_sockets import listen, run_bounded, serve, wait_until
from baton_tpu_torch.core.training import make_local_trainer
from baton_tpu_torch.data.synthetic import DEMO_COEF, linear_client_data
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.server import wire
from baton_tpu_torch.server.http_manager import Manager
from baton_tpu_torch.server.http_worker import ExperimentWorker
from baton_tpu_torch.server.state import params_to_state_dict

torch.set_num_threads(1)


# ----------------------------------------------------------------------
# (a) manager endpoint surface


async def _manager_client():
    app = web.Application()
    exp = Manager(app).register_experiment(
        linear_regression_model(4), name="exp", start_background_tasks=False,
        device="cpu",
    )
    client = TestClient(TestServer(app))
    await client.start_server()
    return client, exp


def test_register_heartbeat_clients_routes():
    async def main():
        client, exp = await _manager_client()
        resp = await client.get("/exp/register", json={"port": 9999})
        assert resp.status == 200
        creds = await resp.json()
        assert creds["client_id"].startswith("client_exp_")
        resp = await client.get(
            "/exp/heartbeat", json={"client_id": creds["client_id"], "key": creds["key"]})
        assert resp.status == 200
        resp = await client.get(
            "/exp/heartbeat", json={"client_id": creds["client_id"], "key": "bad"})
        assert resp.status == 401
        resp = await client.get("/exp/clients")
        listed = await resp.json()
        assert len(listed) == 1 and "key" not in listed[0]
        await client.close()

    run_bounded(main)


def test_start_round_validation_and_no_clients():
    async def main():
        client, exp = await _manager_client()
        resp = await client.get("/exp/start_round?n_epoch=bogus")
        assert resp.status == 400
        # zero registered clients: the round aborts and releases its lock
        resp = await client.get("/exp/start_round?n_epoch=1")
        assert resp.status == 200
        assert await resp.json() == {}
        resp = await client.get("/exp/start_round?n_epoch=1")
        assert resp.status == 200
        await client.close()

    run_bounded(main)


def test_update_auth_and_stale_round():
    async def main():
        client, exp = await _manager_client()
        resp = await client.post("/exp/update?client_id=ghost&key=k", data=b"x")
        assert resp.status == 401
        resp = await client.get("/exp/register", json={"port": 1})
        creds = await resp.json()
        qs = f"?client_id={creds['client_id']}&key={creds['key']}"

        # authenticated but no round in progress -> 410
        body = wire.encode(
            params_to_state_dict(exp.params),
            {"update_name": "update_exp_99999", "n_samples": 1, "loss_history": []})
        resp = await client.post("/exp/update" + qs, data=body)
        assert resp.status == 410

        exp.rounds.start_round(n_epoch=1)
        exp.rounds.client_start(creds["client_id"])
        resp = await client.post("/exp/update" + qs, data=b"not-a-payload")
        assert resp.status == 400

        # the right round: accepted, and the lone report is the aggregate
        before = exp.params["w"].clone()
        new_sd = {k: v + 1.0 for k, v in params_to_state_dict(exp.params).items()}
        body = wire.encode(new_sd, {"update_name": exp.rounds.round_name, "n_samples": 10,
                                    "loss_history": [0.5]})
        resp = await client.post("/exp/update" + qs, data=body)
        assert resp.status == 200
        torch.testing.assert_close(exp.params["w"], before + 1.0, rtol=1e-6, atol=0)
        assert exp.params["w"].device.type == "cpu"
        assert not exp.rounds.in_progress
        assert exp.rounds.loss_history == [0.5]
        resp = await client.get("/exp/loss_history")
        assert await resp.json() == [0.5]
        await client.close()

    run_bounded(main)


def test_malformed_state_dict_rejected_at_upload():
    async def main():
        client, exp = await _manager_client()
        resp = await client.get("/exp/register", json={"port": 1})
        creds = await resp.json()
        qs = f"?client_id={creds['client_id']}&key={creds['key']}"
        exp.rounds.start_round(n_epoch=1)
        exp.rounds.client_start(creds["client_id"])
        meta = {"update_name": exp.rounds.round_name, "n_samples": 5, "loss_history": [1.0]}
        # missing tensors
        resp = await client.post("/exp/update" + qs,
                                 data=wire.encode({"w": np.ones((2, 1), np.float32)}, meta))
        assert resp.status == 400
        # wrong shape
        sd = params_to_state_dict(exp.params)
        sd["w"] = np.ones((9, 9), np.float32)
        resp = await client.post("/exp/update" + qs, data=wire.encode(sd, meta))
        assert resp.status == 400
        assert exp.rounds.in_progress
        await client.close()

    run_bounded(main)


def test_all_participants_culled_releases_round():
    async def main():
        client, exp = await _manager_client()
        resp = await client.get("/exp/register", json={"port": 1})
        creds = await resp.json()
        exp.rounds.start_round(n_epoch=1)
        exp.rounds.client_start(creds["client_id"])
        exp.registry.drop(creds["client_id"])
        exp.rounds.drop_client(creds["client_id"])
        exp._maybe_finish()
        assert not exp.rounds.in_progress
        resp = await client.get("/exp/start_round?n_epoch=1")
        assert resp.status == 200  # not 423
        await client.close()

    run_bounded(main)


def test_round_in_progress_423():
    async def main():
        client, exp = await _manager_client()
        resp = await client.get("/exp/register", json={"port": 1})
        creds = await resp.json()
        exp.rounds.start_round(n_epoch=1)
        exp.rounds.client_start(creds["client_id"])
        resp = await client.get("/exp/start_round?n_epoch=1")
        assert resp.status == 423
        await client.close()

    run_bounded(main)


def test_unsampled_client_upload_rejected_410():
    async def main():
        client, exp = await _manager_client()
        a = await (await client.get("/exp/register", json={"port": 1})).json()
        b = await (await client.get("/exp/register", json={"port": 2})).json()
        exp.rounds.start_round(n_epoch=1)
        exp.rounds.client_start(a["client_id"])  # only A participates
        body = wire.encode(params_to_state_dict(exp.params),
                           {"update_name": exp.rounds.round_name, "n_samples": 5,
                            "loss_history": [1.0]})
        resp = await client.post(f"/exp/update?client_id={b['client_id']}&key={b['key']}",
                                 data=body)
        assert resp.status == 410
        assert exp.rounds.in_progress
        resp = await client.post(f"/exp/update?client_id={a['client_id']}&key={a['key']}",
                                 data=body)
        assert resp.status == 200
        assert not exp.rounds.in_progress
        await client.close()

    run_bounded(main)


# ----------------------------------------------------------------------
# (b) federations over loopback sockets


async def _start_manager(model, name, **kw):
    sock, port = listen()
    app = web.Application()
    exp = Manager(app).register_experiment(model, name=name, round_timeout=60.0,
                                           device="cpu", **kw)
    return exp, port, await serve(app, sock)


async def _start_worker(model, mport, data, cls=ExperimentWorker, **kw):
    sock, port = listen()
    app = web.Application()
    kw.setdefault("heartbeat_time", 30.0)
    worker = cls(app, model, f"127.0.0.1:{mport}", port=port, device="cpu",
                 get_data=lambda d=data: (d, d["x"].shape[0]), **kw)
    return worker, await serve(app, sock)


async def _rounds(session, mport, name, exp, n_rounds, n_epoch, workers=()):
    """Drive ``n_rounds`` through ``start_round`` and wait for each to end
    (and for every worker to be idle again); returns the acks."""
    acks = []
    for _ in range(n_rounds):
        async with session.get(
                f"http://127.0.0.1:{mport}/{name}/start_round?n_epoch={n_epoch}") as resp:
            assert resp.status == 200
            acks.append(await resp.json())
        assert await wait_until(lambda: not exp.rounds.in_progress
                                and not any(w.round_in_progress for w in workers))
    return acks


def test_end_to_end_federation_two_workers():
    async def main():
        model = linear_regression_model(10)
        nprng = np.random.default_rng(0)
        exp, mport, mrunner = await _start_manager(model, "lineartest")
        workers, runners = [], [mrunner]
        for _ in range(2):
            data = linear_client_data(nprng, min_batches=2, max_batches=3)
            w, r = await _start_worker(
                model, mport, data, heartbeat_time=1.0,
                trainer=make_local_trainer(model, batch_size=32, learning_rate=0.02))
            workers.append(w)
            runners.append(r)
        assert await wait_until(lambda: len(exp.registry) == 2)
        async with aiohttp.ClientSession() as session:
            acks = await _rounds(session, mport, "lineartest", exp, 5, 4, workers)
            assert all(all(a.values()) for a in acks)
            async with session.get(f"http://127.0.0.1:{mport}/lineartest/loss_history") as resp:
                history = await resp.json()
        assert len(history) == 20  # 5 rounds x 4 epochs
        assert history[-1] < history[0]
        np.testing.assert_allclose(exp.params["w"].numpy().ravel(), DEMO_COEF, atol=2.0)
        assert all(w.n_updates == 5 for w in workers)
        assert all(v.device.type == "cpu" for w in workers for v in w.params.values())
        for r in runners:
            await r.cleanup()

    run_bounded(main)


def test_worker_metrics_update_mid_round():
    """The worker's GET /{name}/metrics shows per-epoch progress while its
    multi-epoch run is still going (LocalTrainer.progress_fn)."""

    async def main():
        model = linear_regression_model(10)
        data = linear_client_data(np.random.default_rng(5), min_batches=2, max_batches=3)
        exp, mport, mrunner = await _start_manager(model, "lineartest")
        worker, wrunner = await _start_worker(
            model, mport, data,
            trainer=make_local_trainer(model, batch_size=32, learning_rate=0.02))
        worker.enable_progress_metrics()
        orig = worker._on_epoch_progress

        def slowed(i, loss):
            # hold the training thread briefly per epoch so the event loop
            # provably interleaves polls with a running round
            orig(i, loss)
            time.sleep(0.03)

        worker._on_epoch_progress = slowed
        assert await wait_until(lambda: len(exp.registry) == 1)
        n_epoch, seen = 20, []
        async with aiohttp.ClientSession() as session:
            async with session.get(
                    f"http://127.0.0.1:{mport}/lineartest/start_round?n_epoch={n_epoch}") as resp:
                assert resp.status == 200
            for _ in range(2000):
                async with session.get(
                        f"http://127.0.0.1:{worker.port}/lineartest/metrics") as resp:
                    snap = await resp.json()
                seen.append(snap["gauges"].get("train_epoch", 0))
                if not exp.rounds.in_progress:
                    break
                await asyncio.sleep(0.01)
        assert not exp.rounds.in_progress
        assert any(0 < e < n_epoch for e in seen), seen
        snap = worker.metrics.snapshot()
        assert snap["gauges"]["train_epoch"] == n_epoch
        assert snap["counters"]["train_epochs_completed"] == n_epoch
        await wrunner.cleanup()
        await mrunner.cleanup()

    run_bounded(main)


def test_simulated_cohort_round_with_wave_progress():
    """A manager with an attached FedSim cohort and no real workers runs
    full rounds; the per-wave heartbeat lands in its metrics."""

    async def main():
        from baton_tpu_torch import FedSim
        from baton_tpu_torch.ops.padding import stack_client_datasets

        model = linear_regression_model(10)
        nprng = np.random.default_rng(2)
        data, n_samples = stack_client_datasets(
            [linear_client_data(nprng, min_batches=2, max_batches=2) for _ in range(6)],
            batch_size=32)
        app = web.Application()
        exp = Manager(app).register_experiment(
            model, name="simtest", round_timeout=60.0, start_background_tasks=False,
            device="cpu")
        with pytest.raises(ValueError, match="simulated cohort runs on"):
            exp.attach_simulator(types.SimpleNamespace(device=torch.device("meta")),
                                 data, n_samples)
        sim = FedSim(model, batch_size=32, learning_rate=0.02, device="cpu")
        exp.attach_simulator(sim, data, n_samples, wave_size=2)
        client = TestClient(TestServer(app))
        await client.start_server()
        hist = []
        for r in range(2):
            resp = await client.get("/simtest/start_round?n_epoch=3")
            assert resp.status == 200
            assert await resp.json() == {"__simulated__": True}
            assert await wait_until(lambda: not exp.rounds.in_progress)
            if r == 0:
                snap = await (await client.get("/simtest/metrics")).json()
                # 6 clients / wave_size 2 = 3 waves, all reported
                assert snap["gauges"]["sim_waves_total"] == 3
                assert snap["gauges"]["sim_wave"] == 3
            hist = await (await client.get("/simtest/loss_history")).json()
            assert len(hist) == 3 * (r + 1) and all(np.isfinite(hist))
        assert hist[-1] < hist[0]
        await client.close()

    run_bounded(main)


def test_byzantine_worker_defeated_by_median_aggregator():
    """3 honest workers and one uploading 1e6-scaled weights under a huge
    claimed weight: with aggregator="median" the global model still
    converges toward the demo coefficients."""

    class ByzantineWorker(ExperimentWorker):
        async def report_update(self, round_name, n_samples, loss_history, **kw):
            self.params = {k: v * 1e6 for k, v in self.params.items()}
            await super().report_update(round_name, 10_000, loss_history, **kw)

    async def main():
        model = linear_regression_model(10)
        nprng = np.random.default_rng(11)
        exp, mport, mrunner = await _start_manager(model, "byz", aggregator="median")
        shared = make_local_trainer(model, batch_size=32, learning_rate=0.02)
        runners, workers = [mrunner], []
        for i in range(4):
            data = linear_client_data(nprng, min_batches=2, max_batches=2)
            w, r = await _start_worker(model, mport, data,
                                       cls=ByzantineWorker if i == 3 else ExperimentWorker,
                                       name="byz", trainer=shared)
            workers.append(w)
            runners.append(r)
        assert await wait_until(lambda: len(exp.registry) == 4)
        async with aiohttp.ClientSession() as session:
            await _rounds(session, mport, "byz", exp, 6, 4, workers)
        err = float(np.max(np.abs(exp.params["w"].numpy().ravel() - DEMO_COEF)))
        assert err < 5.0, err
        for r in runners:
            await r.cleanup()

    run_bounded(main)


def test_cohort_fraction_samples_subset_per_round():
    """cohort_fraction=0.5 over 4 workers notifies exactly 2 a round;
    different rounds draw different cohorts; the federation converges."""

    async def main():
        model = linear_regression_model(10)
        nprng = np.random.default_rng(12)
        exp, mport, mrunner = await _start_manager(model, "coh", cohort_fraction=0.5)
        shared = make_local_trainer(model, batch_size=32, learning_rate=0.02)
        runners, workers = [mrunner], []
        for _ in range(4):
            data = linear_client_data(nprng, min_batches=2, max_batches=2)
            w, r = await _start_worker(model, mport, data, name="coh", trainer=shared)
            workers.append(w)
            runners.append(r)
        assert await wait_until(lambda: len(exp.registry) == 4)
        async with aiohttp.ClientSession() as session:
            acks = await _rounds(session, mport, "coh", exp, 8, 4, workers)
        assert all(len(a) == 2 and all(a.values()) for a in acks), acks
        # seeded sampling: 8 identical draws of 2-of-4 has probability (1/6)^7
        assert len({frozenset(a) for a in acks}) > 1
        assert sum(w.n_updates for w in workers) == 16
        np.testing.assert_allclose(exp.params["w"].numpy().ravel(), DEMO_COEF, atol=2.0)
        for r in runners:
            await r.cleanup()

    run_bounded(main)


def test_demo_manager_and_workers_run_rounds():
    """``python -m baton_tpu_torch.demo`` (``build_app``) on the CPU: a
    manager and two workers on loopback run the reference demo's rounds
    (``start_round?n_epoch=8``) and the loss falls."""
    from baton_tpu_torch import demo

    async def main():
        msock, mport = listen()
        mapp, port = demo.build_app(["manager", "127.0.0.1", str(mport), "--cpu"])
        assert port == mport
        runners = [await serve(mapp, msock)]
        for _ in range(2):
            wsock, wport = listen()
            wapp, _ = demo.build_app(["worker", f"127.0.0.1:{mport}", str(wport), "--cpu"])
            runners.append(await serve(wapp, wsock))
        async with aiohttp.ClientSession() as session:
            base = f"http://127.0.0.1:{mport}/lineartest/"

            async def clients():
                async with session.get(base + "clients") as resp:
                    return await resp.json()

            for _ in range(500):
                if len(await clients()) == 2:
                    break
                await asyncio.sleep(0.02)
            for r in range(3):
                async with session.get(base + "start_round?n_epoch=8") as resp:
                    assert resp.status == 200
                    assert len(await resp.json()) == 2
                for _ in range(1000):
                    async with session.get(base + "loss_history") as resp:
                        history = await resp.json()
                    if len(history) == 8 * (r + 1):
                        break
                    await asyncio.sleep(0.02)
                assert len(history) == 8 * (r + 1)
        for runner in runners:
            await runner.cleanup()
        return history

    history = run_bounded(main)
    assert all(np.isfinite(history)) and history[-1] < 0.5 * history[0]
