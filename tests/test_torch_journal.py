"""``tests/test_journal.py``'s cases against the port's
``server/journal.py``."""

from _torch_carried_cases import port_cases

globals().update(port_cases("test_journal.py", {}))
