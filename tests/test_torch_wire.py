"""``tests/test_wire.py``'s cases against the port's ``server/wire.py`` and
``server/utils.py``."""

from _torch_carried_cases import port_cases

_BRIDGE = ("the JAX package's pytree bridge; the port's flat-dict bridge, which "
           "takes a device, is held by test_torch_state.py")

globals().update(port_cases("test_wire.py", {
    "test_state_dict_bridging_roundtrip": _BRIDGE,
    "test_state_dict_missing_and_mismatched_tensors": _BRIDGE,
}))
