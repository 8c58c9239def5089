"""The edge tier in the port: ``tests/test_edge.py``'s cases against
``baton_tpu_torch/server/edge.py`` and the port's HTTP pair on the CPU,
the blob (Range/ETag) and ``/relay/`` seams between the edge and the
port's root, and the JAX package's edge tier against the port's on the
same uploads.

Both packages fold an edge's cohort in numpy fp32 (``StreamingMean``) and
merge the edges' partials at the root in the same order, so the two roots'
new params agree within rtol 1e-6 when the same updates are posted in the
same order to two edges in front of each package's root.
"""

import numpy as np
from aiohttp import web

import _torch_cpu
from _torch_carried_cases import port_cases
from _torch_sockets import (
    SOCKET_SEAMS,
    listen,
    reserve_port,
    run_bounded,
    serve,
    tcp_site,
    wait_until,
)

globals().update(port_cases(
    "test_edge.py", {},
    seams=(
        _torch_cpu.SEAMS["Manager"],
        _torch_cpu.SEAMS["ExperimentWorker"],
        *SOCKET_SEAMS,  # servers on sockets bound before use
        ("port=free_port(),", "port=reserve_port(),"),
        # every socket case under its own wall-clock limit
        ("asyncio.run(main())", "run_bounded(main)"),
    ),
    extra_globals={"run_bounded": run_bounded, "reserve_port": reserve_port,
                   "tcp_site": tcp_site},
))


# ----------------------------------------------------------------------
# the JAX package's edge tier against the port's on the same uploads

NAME, DIM, COHORT = "xedge", 6, 2   # two edges of two workers each


def _uploads(seed=3):
    """Four workers' fixed uploads: (state dict, n_samples), from a seed."""
    rng = np.random.default_rng(seed)
    return [({"w": rng.normal(size=(DIM, 1)).astype(np.float32),
              "b": rng.normal(size=(1,)).astype(np.float32)},
             float(rng.integers(8, 64))) for _ in range(2 * COHORT)]


async def _fake_worker(envelopes):
    """A worker's callback that accepts every ``round_start`` and keeps
    its envelope; the test posts the worker's update itself."""
    async def round_start(request):
        envelopes.append(await request.json())
        return web.Response(text="OK")

    app = web.Application()
    app.router.add_post(f"/{NAME}/round_start", round_start)
    sock, port = listen()
    return await serve(app, sock), port


async def _edge_tier_round(Manager, EdgeAggregator, wire, linear_regression_model, uploads):
    """One round of a root behind two edges of ``COHORT`` posted workers
    each; returns the root's new params as numpy."""
    import aiohttp

    mapp = web.Application()
    exp = Manager(mapp).register_experiment(
        linear_regression_model(DIM), name=NAME, round_timeout=30.0, client_ttl=300.0)
    msock, mport = listen()
    runners = [await serve(mapp, msock)]
    edges, eports = [], []
    for i in range(2):
        esock, eport = listen()
        eapp = web.Application()
        edges.append(EdgeAggregator(eapp, f"127.0.0.1:{mport}", name=NAME, port=eport,
                                    edge_name=f"e{i}", ship_settle_s=0.05,
                                    flush_after_s=15.0, heartbeat_time=5.0))
        runners.append(await serve(eapp, esock))
        eports.append(eport)
    envelopes = []
    creds = []
    try:
        async with aiohttp.ClientSession() as s:
            for i in range(2 * COHORT):
                runner, wport = await _fake_worker(envelopes)
                runners.insert(0, runner)
                async with s.get(f"http://127.0.0.1:{eports[i // COHORT]}/{NAME}/register",
                                 json={"url": f"http://127.0.0.1:{wport}/{NAME}/"}) as resp:
                    assert resp.status == 200, await resp.text()
                    creds.append(await resp.json())
            assert await wait_until(lambda: len(exp.registry) == 2 * COHORT + 2)
            async with s.get(f"http://127.0.0.1:{mport}/{NAME}/start_round?n_epoch=1") as resp:
                assert resp.status == 200, await resp.text()
            assert await wait_until(lambda: len(envelopes) == 2 * COHORT and all(
                e._round is not None and len(e._round.notified) == COHORT for e in edges))
            round_name = envelopes[0]["update_name"]
            # edge 0's cohort first, its partial shipped, then edge 1's
            for i, (sd, n) in enumerate(uploads):
                edge = edges[i // COHORT]
                body = wire.encode(sd, {"update_name": round_name, "n_samples": n,
                                        "loss_history": [0.5], "update_id": f"u{i}"})
                async with s.post(
                        f"http://127.0.0.1:{eports[i // COHORT]}/{NAME}/update"
                        f"?client_id={creds[i]['client_id']}&key={creds[i]['key']}",
                        data=body, headers={"Content-Type": wire.CONTENT_TYPE}) as resp:
                    assert resp.status == 200, await resp.text()
                if i % COHORT == COHORT - 1:
                    assert await wait_until(lambda: edge._round.shipped)
            assert await wait_until(lambda: exp.rounds.n_rounds == 1
                                    and not exp.rounds.in_progress)
        assert [e.metrics.snapshot()["counters"].get("edge_partials_shipped") for e in edges] \
            == [1, 1]
        snap = exp.metrics_snapshot()["counters"]
        assert snap.get("updates_received_edge_partial") == 2
        return {k: np.asarray(v, np.float32) for k, v in exp.params.items()}
    finally:
        for runner in runners:
            await runner.cleanup()


async def _blob_and_relay_seams(ranges):
    """A port root behind one edge with one posted worker: the root's and
    the edge's answers to the same round blob GET under each of ``ranges``
    (None: no Range header), and the callback the root holds for the
    worker."""
    import aiohttp

    from baton_tpu_torch.models.linear import linear_regression_model
    from baton_tpu_torch.server.edge import EdgeAggregator

    mapp = web.Application()
    exp = _torch_cpu.Manager(mapp).register_experiment(
        linear_regression_model(DIM), name=NAME, round_timeout=30.0, client_ttl=300.0)
    msock, mport = listen()
    esock, eport = listen()
    eapp = web.Application()
    EdgeAggregator(eapp, f"127.0.0.1:{mport}", name=NAME, port=eport, edge_name="e0",
                   heartbeat_time=5.0)
    runners = [await serve(eapp, esock), await serve(mapp, msock)]
    envelopes = []
    try:
        runner, wport = await _fake_worker(envelopes)
        runners.insert(0, runner)
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://127.0.0.1:{eport}/{NAME}/register",
                             json={"url": f"http://127.0.0.1:{wport}/{NAME}/"}) as resp:
                creds = await resp.json()
            assert await wait_until(lambda: len(exp.registry) == 2)
            async with s.get(f"http://127.0.0.1:{mport}/{NAME}/start_round?n_epoch=1") as resp:
                assert resp.status == 200, await resp.text()
            assert await wait_until(lambda: len(envelopes) == 1)
            digest = envelopes[0]["blob"]["digest"]
            answers = []
            for rng in ranges:
                got = []
                for port in (mport, eport):
                    async with s.get(
                            f"http://127.0.0.1:{port}/{NAME}/round_blob/{digest}"
                            f"?client_id={creds['client_id']}&key={creds['key']}",
                            headers={} if rng is None else {"Range": rng}) as resp:
                        got.append((resp.status, await resp.read(),
                                    {h: resp.headers.get(h)
                                     for h in ("ETag", "Content-Range", "Accept-Ranges")}))
                answers.append(got)
        return answers, exp.registry[creds["client_id"]].url, eport, envelopes[0]["blob"]["size"]
    finally:
        for runner in runners:
            await runner.cleanup()


def test_edge_keeps_the_roots_blob_contract_and_relays_the_callback():
    """Two seams where the edge's copy could drift from the port's root: a
    worker fetching the round blob gets the same status, bytes, ETag and
    Content-Range from the edge as from the root, whole, resumed, as a
    window and out of range; and the root's callback for a worker that
    registered through the edge is the edge's ``/relay/`` route."""
    ranges = [None, "bytes=0-", "bytes=10-", "bytes=5-20", "bytes=99999999-", "pages=1-2"]
    answers, callback, eport, size = run_bounded(lambda: _blob_and_relay_seams(ranges))
    statuses = [root[0] for root, _ in answers]
    assert statuses == [200, 206, 206, 206, 416, 416]
    for rng, (root, edge) in zip(ranges, answers):
        assert edge == root, rng
    assert len(answers[0][0][1]) == size and answers[3][0][2]["Content-Range"] == \
        f"bytes 5-20/{size}"
    assert callback == f"http://127.0.0.1:{eport}/{NAME}/relay/"


def test_jax_and_port_edge_tiers_merge_the_same_uploads_alike():
    from baton_tpu.models.linear import linear_regression_model as jax_linear
    from baton_tpu.server import wire as jax_wire
    from baton_tpu.server.edge import EdgeAggregator as JaxEdge
    from baton_tpu.server.http_manager import Manager as JaxManager
    from baton_tpu_torch.models.linear import linear_regression_model as torch_linear
    from baton_tpu_torch.server import wire as torch_wire
    from baton_tpu_torch.server.edge import EdgeAggregator as TorchEdge

    uploads = _uploads()
    jax_params = run_bounded(lambda: _edge_tier_round(
        JaxManager, JaxEdge, jax_wire, jax_linear, uploads))
    torch_params = run_bounded(lambda: _edge_tier_round(
        _torch_cpu.Manager, TorchEdge, torch_wire, torch_linear, uploads))
    # the float64 fold of the uploads, which both roots' fp32 folds round
    total = sum(n for _, n in uploads)
    want = {k: sum(np.float64(n) * sd[k] for sd, n in uploads) / total for k in ("w", "b")}
    assert set(jax_params) == set(torch_params) == {"w", "b"}
    for k in want:
        np.testing.assert_allclose(torch_params[k], jax_params[k], rtol=1e-6, atol=0)
        np.testing.assert_allclose(torch_params[k], want[k], rtol=1e-5, atol=1e-6)

