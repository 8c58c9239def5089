"""Fleet health in the port: ``tests/test_fleet.py``'s cases against the
port's ``server/fleet.py``, the loadgen's ``history:*`` namespace and a
three-tier federation (root, edge, workers) of the port on the CPU."""

import _torch_cpu
from _torch_carried_cases import port_cases
from _torch_sockets import SOCKET_SEAMS, reserve_port, run_bounded, tcp_site

globals().update(port_cases(
    "test_fleet.py", {},
    seams=(
        _torch_cpu.SEAMS["Manager"],
        _torch_cpu.SEAMS["ExperimentWorker"],
        # servers on sockets bound before use
        SOCKET_SEAMS[1],
        ("10, _free_port()", "10, reserve_port()"),
        ("= _free_port()", "= reserve_port()"),
        ("port=_free_port(),", "port=reserve_port(),"),
        # every socket case under its own wall-clock limit
        ("asyncio.run(main())", "run_bounded(main)"),
    ),
    extra_globals={"run_bounded": run_bounded, "reserve_port": reserve_port,
                   "tcp_site": tcp_site},
))
