"""The port's entry points with ``device="cpu"`` as their default (not a
test module), for the reference's cases run against the port through
``_torch_carried_cases.port_cases``: the port's own default is the card,
and the tests run on the CPU."""

from __future__ import annotations

import functools

from baton_tpu_torch.parallel import engine
from baton_tpu_torch.server import http_manager, http_worker, state


class Manager(http_manager.Manager):
    def register_experiment(self, *args, device="cpu", **kw):
        return super().register_experiment(*args, device=device, **kw)


class ExperimentWorker(http_worker.ExperimentWorker):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


class FedSim(engine.FedSim):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


state_dict_to_params = functools.partial(state.state_dict_to_params, device="cpu")

# the seams that put these in place of the port's own, by import line
SEAMS = {
    name: (f"from baton_tpu_torch.{module} import {name}", f"from _torch_cpu import {name}")
    for module, name in (("server.http_manager", "Manager"),
                         ("server.http_worker", "ExperimentWorker"),
                         ("parallel.engine", "FedSim"),
                         ("server.state", "state_dict_to_params"))
}
