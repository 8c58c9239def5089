"""``tests/test_registry.py``'s cases against the port's
``server/registry.py``."""

from _torch_carried_cases import port_cases

globals().update(port_cases("test_registry.py", {}))
