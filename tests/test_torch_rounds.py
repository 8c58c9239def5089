"""``tests/test_rounds.py``'s cases against the port's
``server/rounds.py``."""

from _torch_carried_cases import port_cases

globals().update(port_cases("test_rounds.py", {}))
