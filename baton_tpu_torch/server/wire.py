"""Tensor wire format for the control plane.

The reference ships pickled PyTorch state_dicts over HTTP
(manager.py:85,98; worker.py:92,117) — unpickling network bytes on both
sides. SURVEY §2.8 flags this for redesign. The native format here,
``BTW1``, is safetensors-shaped: a JSON header describing dtype/shape/
offset per tensor plus a raw little-endian payload — zero-copy decode,
no code execution on parse.

    b"BTW1" | uint32 header_len (LE) | header JSON | raw tensor bytes

Header: ``{"meta": {...json-safe metadata...},
"tensors": {name: {"dtype": str, "shape": [...], "offset": int}}}``.

Pickle *decode* compatibility with reference workers is retained behind
an explicit ``allow_pickle=True`` opt-in (demo parity only — the demo
protocol is pickle, SURVEY §2.8).
"""

from __future__ import annotations

import json
import pickle
import struct
from typing import Any, Dict, Mapping, Tuple

import numpy as np

MAGIC = b"BTW1"
CONTENT_TYPE = "application/x-baton-tensors"
PICKLE_CONTENT_TYPE = "application/x-pickle"

_ALLOWED_DTYPES = {
    "float16",
    "bfloat16",
    "float32",
    "float64",
    "int8",
    "int16",
    "int32",
    "int64",
    "uint8",
    "uint16",
    "uint32",
    "uint64",
    "bool",
}


def _np_dtype(name: str):
    # whitelist BEFORE np.dtype: an attacker-controlled header string
    # must not reach the dtype constructor (arbitrary names raise
    # TypeError past the 400 path, and exotic dtypes like 'V<n>'/'object'
    # have no business on this wire)
    if name not in _ALLOWED_DTYPES:
        raise ValueError(f"disallowed tensor dtype {name!r}")
    if name == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def encode(tensors: Mapping[str, np.ndarray], meta: Dict[str, Any]) -> bytes:
    """Serialize ``{name: array}`` + JSON-safe metadata to BTW1 bytes.

    Exact-size allocation: the header is laid out first, then the
    output buffer is allocated once at its final size and tensor bytes
    are written into it through numpy views — no per-tensor ``tobytes``
    copies, no BytesIO growth doubling, no final concatenation. This
    matters when the manager encodes a round blob of a large model.
    """
    header: Dict[str, Any] = {"meta": meta, "tensors": {}}
    arrs = []
    offset = 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        dtype_name = (
            "bfloat16" if arr.dtype.name == "bfloat16" else arr.dtype.name
        )
        if dtype_name not in _ALLOWED_DTYPES:
            raise ValueError(f"unsupported tensor dtype {arr.dtype} for {name!r}")
        header["tensors"][name] = {
            "dtype": dtype_name,
            "shape": list(arr.shape),
            "offset": offset,
        }
        arrs.append(arr)
        offset += arr.nbytes
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    body_start = len(MAGIC) + 4 + len(hdr)
    out = bytearray(body_start + offset)
    out[: len(MAGIC)] = MAGIC
    struct.pack_into("<I", out, len(MAGIC), len(hdr))
    out[len(MAGIC) + 4 : body_start] = hdr
    pos = body_start
    for arr in arrs:
        if arr.nbytes:
            dst = np.frombuffer(out, np.uint8, count=arr.nbytes, offset=pos)
            dst[:] = arr.reshape(-1).view(np.uint8)
        pos += arr.nbytes
    return bytes(out)


def is_btw1(data) -> bool:
    """Cheap magic sniff — admission paths (chunked-upload first frames,
    disk-reloaded outbox slots) reject non-BTW1 bytes before buffering
    or decoding anything."""
    return bytes(data[:4]) == MAGIC


def decode(data: bytes) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Parse BTW1 bytes → (tensors, meta). No code execution.

    Zero-copy: each returned array is an ``np.frombuffer`` view into
    ``data``'s buffer, not a copy — decoding a 100 MB payload allocates
    ~0 additional tensor memory (tests/test_wire.py asserts this). The
    views keep ``data`` alive; callers that need to outlive the request
    body don't need to do anything special, the refcount handles it.

    Contract for attacker-controlled input: any malformed payload —
    truncated, bit-flipped, wrong lengths — raises ``ValueError`` (or a
    ``json``/``Key``/``Index`` error the server's 400 path equally
    catches); never anything that escapes a standard except clause, and
    never interpretation of the bytes as code (fuzzed in
    tests/test_wire.py)."""
    if data[:4] != MAGIC:
        raise ValueError("not a BTW1 payload")
    try:
        (hdr_len,) = struct.unpack("<I", data[4:8])
    except struct.error as e:
        raise ValueError(f"truncated BTW1 header: {e}") from e
    # explicit bounds check: a declared header length past the end of
    # the buffer must fail as "truncated", not as whatever json makes of
    # a silently-short slice
    if 8 + hdr_len > len(data):
        raise ValueError(
            f"truncated BTW1 header: declares {hdr_len} bytes, "
            f"{len(data) - 8} available"
        )
    header = json.loads(data[8 : 8 + hdr_len].decode("utf-8"))
    # explicit structural validation: a crafted VALID-JSON header with
    # wrong types (null tensors, float shapes, string offsets) must hit
    # the same ValueError contract as corrupt bytes, not leak TypeError/
    # AttributeError past it
    if not isinstance(header, dict) or not isinstance(
        header.get("tensors"), dict
    ):
        raise ValueError("BTW1 header is not {tensors: {...}}")
    body = memoryview(data)[8 + hdr_len :]
    tensors: Dict[str, np.ndarray] = {}
    for name, info in header["tensors"].items():
        if not isinstance(info, dict):
            raise ValueError(f"bad tensor entry for {name!r}")
        dtype = _np_dtype(info.get("dtype"))
        shape = info.get("shape")
        offset = info.get("offset")
        # `type(..) is int` on purpose: bool is an int subclass and JSON
        # true/false must not pass as dimensions/offsets
        if (
            not isinstance(shape, list)
            or not all(type(s) is int and s >= 0 for s in shape)
            or type(offset) is not int
            or offset < 0
        ):
            raise ValueError(f"bad shape/offset for {name!r}")
        shape = tuple(shape)
        # size math in unbounded Python ints, bounds-checked against the
        # actual body BEFORE any numpy call — crafted huge dims must not
        # reach C-long conversions (OverflowError escapes the contract)
        count = 1
        for s in shape:
            count *= s
        nbytes = count * dtype.itemsize
        if offset + nbytes > len(body):
            raise ValueError(f"tensor {name!r} extends past the payload")
        arr = np.frombuffer(body[offset : offset + nbytes], dtype=dtype).reshape(shape)
        tensors[name] = arr
    meta = header.get("meta", {})
    if not isinstance(meta, dict):
        raise ValueError("BTW1 meta is not a dict")
    return tensors, meta


def decode_any(
    body: bytes, content_type: str | None = None, allow_pickle: bool = False
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Decode a round_start/update body: BTW1 natively, pickle only when
    explicitly allowed (reference-demo compatibility)."""
    if body[:4] == MAGIC:
        return decode(body)
    if not allow_pickle:
        raise ValueError(
            "refusing non-BTW1 payload (enable allow_pickle for reference-"
            "protocol compatibility)"
        )
    obj = pickle.loads(body)
    meta = {k: v for k, v in obj.items() if k != "state_dict"}
    tensors = {
        k: _to_numpy(v) for k, v in obj.get("state_dict", {}).items()
    }
    return tensors, meta


def encode_pickle(tensors: Mapping[str, np.ndarray], meta: Dict[str, Any]) -> bytes:
    """Reference-protocol body: pickled {state_dict, **meta} with numpy
    values (torch tensors on the reference side pickle-compatibly map to
    arrays via __array__)."""
    obj = dict(meta)
    obj["state_dict"] = {k: np.asarray(v) for k, v in tensors.items()}
    return pickle.dumps(obj)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    # torch.Tensor and friends expose __array__ / .numpy()
    numpy_fn = getattr(v, "numpy", None)
    if callable(numpy_fn):
        try:
            return np.asarray(numpy_fn())
        except (TypeError, RuntimeError):
            pass
    return np.asarray(v)
