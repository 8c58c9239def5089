"""``tests/test_tracing.py``'s socket-free cases against the port's
``utils/tracing.py``, ``utils/metrics.py`` and ``utils/slog.py``. Its
three federation cases bind their ports by closing and re-binding a
socket, without a time limit of their own, and are left out; the port's
HTTP round is covered by test_torch_http_protocol.py."""

from _torch_carried_cases import port_cases

_SOCKETS = "a federation over sockets bound by free_port(), without its own time limit"

globals().update(port_cases("test_tracing.py", {
    "test_full_round_trace_chunked_upload_and_429": _SOCKETS,
    "test_trace_spans_endpoint_auth_and_validation": _SOCKETS,
    "test_trace_spans_both_manager_incarnations_and_recovery_gap": _SOCKETS,
}))
