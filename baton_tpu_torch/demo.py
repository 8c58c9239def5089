"""End-to-end demo of the port — the CLI of the repository's ``demo.py``
(itself the reference demo's, demo.py:62-77), on the card by default.

  python -m baton_tpu_torch.demo manager <host> <port> [--secure] [--cpu]
                 [--aggregator SPEC] [--cohort FRAC] [--quantize-broadcast BITS]
  python -m baton_tpu_torch.demo worker  <manager-host:port> <port> [--cpu]
                 [--compress SPEC]

Manager flags:
  --secure              Bonawitz double-masking secure aggregation
                        (server/secure.py): uploads are masked tensors the
                        manager cannot read individually.
  --aggregator SPEC     "mean" (default, reference semantics),
                        "median", or "trimmed:<ratio>" — Byzantine-robust.
  --cohort FRAC         FedAvg's C: sample this fraction of registered
                        clients per round instead of notifying everyone.
  --quantize-broadcast BITS
                        8 or 16: ship each round's weights stochastically
                        quantized (4x/2x smaller downlink).
Worker flags:
  --compress SPEC       "topk:<frac>[:q8|q16]": upload sparse round
                        deltas with error feedback instead of full
                        weights (ops/compression.py); the top-k runs on
                        the worker's device.
Either role:
  --cpu                 run on the host CPU; without it the manager's
                        params and the worker's training live on the
                        CUDA card, and the demo refuses to start without
                        one.

Same shape as the reference: the manager hosts the "lineartest"
experiment (a 10→1 linear regressor); each worker invents
``32·randint(5,20)`` samples of ``y = p·X`` for the fixed coefficient
vector and trains locally with SGD lr=0.001, batch 32.

Drive it exactly like the reference:
  curl 'http://<host>:<port>/lineartest/start_round?n_epoch=8'
  curl 'http://<host>:<port>/lineartest/loss_history'
"""

import argparse


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m baton_tpu_torch.demo", usage=__doc__, add_help=False
    )
    p.add_argument("role", choices=["manager", "worker"])
    p.add_argument("host")  # worker quirk kept: this is the MANAGER address
    p.add_argument("port", type=int)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--secure", action="store_true")
    p.add_argument("--aggregator", default="mean")
    p.add_argument("--cohort", type=float, default=1.0)
    p.add_argument("--quantize-broadcast", type=int, default=None,
                   choices=(8, 16), dest="quantize_broadcast")
    p.add_argument("--compress", default=None)
    return p


def build_app(argv=None):
    """Parse ``argv`` and build the role's aiohttp app (not yet serving):
    ``(app, port)``. Bad flags exit with the usage text."""
    parser = _build_parser()
    args = parser.parse_args(argv)
    # validate flag VALUES up front so a typo prints the usage, not a
    # library traceback from deep inside Experiment/worker construction
    from baton_tpu_torch.ops.aggregation import parse_aggregator
    from baton_tpu_torch.server.http_worker import _parse_compress

    try:
        parse_aggregator(args.aggregator)
        _parse_compress(args.compress)
        if not (0.0 < args.cohort <= 1.0):
            raise ValueError(f"--cohort must be in (0, 1], got {args.cohort}")
        if args.secure and args.aggregator != "mean":
            raise ValueError(
                "--secure needs --aggregator mean (the server only sees "
                "the masked sum)"
            )
    except ValueError as e:
        parser.error(str(e))
    manager_only = {
        "--secure": args.secure,
        "--aggregator": args.aggregator != "mean",
        "--cohort": args.cohort != 1.0,
        "--quantize-broadcast": args.quantize_broadcast is not None,
    }
    if args.role == "worker" and any(manager_only.values()):
        # manager-side policies: a worker follows whatever the round
        # broadcast demands, so silently accepting these would mislead
        bad = [k for k, v in manager_only.items() if v]
        parser.error(f"worker does not take {', '.join(bad)}")
    if args.role == "manager" and args.compress is not None:
        parser.error("--compress is a worker flag")

    import secrets

    import numpy as np
    from aiohttp import web

    from baton_tpu_torch import resolve_device
    from baton_tpu_torch.core.training import make_local_trainer
    from baton_tpu_torch.data.synthetic import linear_client_data
    from baton_tpu_torch.models.linear import linear_regression_model
    from baton_tpu_torch.server.http_manager import Manager
    from baton_tpu_torch.server.http_worker import ExperimentWorker

    device = resolve_device("cpu" if args.cpu else "cuda")
    model = linear_regression_model(10)  # name="lineartest"
    app = web.Application()
    if args.role == "manager":
        Manager(app).register_experiment(
            model,
            round_timeout=600.0,
            aggregator=args.aggregator,
            secure_agg=args.secure,
            cohort_fraction=args.cohort,
            broadcast_quantize_bits=args.quantize_broadcast,
            device=device,
        )
    else:
        nprng = np.random.default_rng()

        def get_data():
            data = linear_client_data(nprng)
            return data, data["x"].shape[0]

        worker = ExperimentWorker(
            app,
            model,
            manager=args.host,  # reference quirk kept: worker's 2nd arg is the manager address
            port=args.port,
            trainer=make_local_trainer(model, batch_size=32, learning_rate=0.001),
            get_data=get_data,
            compress=args.compress,
            # unique per process: quantizer rounding noise must be
            # independent across workers or the cohort mean's error
            # stops shrinking with N (ops/compression.py seed note)
            rng_seed=secrets.randbits(31),
            device=device,
        )
        # per-epoch progress at GET /{name}/metrics (user-supplied
        # trainers don't get the hook automatically)
        worker.enable_progress_metrics()
    return app, args.port


def main(argv=None) -> None:
    from aiohttp import web

    app, port = build_app(argv)
    web.run_app(app, port=port)


if __name__ == "__main__":
    main()
