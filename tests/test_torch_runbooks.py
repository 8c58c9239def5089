"""Runbooks in the port: ``tests/test_runbooks.py``'s cases against the
port's ``obs/runbooks.py``, ``server/rounds.py`` and the loadgen's
``runbook:*`` and ``fairness:*`` namespaces."""

from _torch_carried_cases import port_cases

globals().update(port_cases("test_runbooks.py", {}))
