"""The alert plane in the port: ``tests/test_alerts.py``'s cases against
the port's ``obs/alerts.py``, ``obs/forensics.py``, the loadgen's
``alert:*`` namespace, the ops console's alert pane and an edge tier of
the port's HTTP pair on the CPU."""

import _torch_cpu
from _torch_carried_cases import port_cases
from _torch_sockets import SOCKET_SEAMS, reserve_port, run_bounded, tcp_site

globals().update(port_cases(
    "test_alerts.py", {},
    seams=(
        _torch_cpu.SEAMS["Manager"],
        _torch_cpu.SEAMS["ExperimentWorker"],
        # servers on sockets bound before use
        SOCKET_SEAMS[1],
        ("= _free_port()", "= reserve_port()"),
        ("port=_free_port(),", "port=reserve_port(),"),
        # every socket case under its own wall-clock limit
        ("asyncio.run(main())", "run_bounded(main)"),
    ),
    extra_globals={"run_bounded": run_bounded, "reserve_port": reserve_port,
                   "tcp_site": tcp_site},
))
