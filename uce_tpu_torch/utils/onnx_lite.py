"""Minimal ONNX initializer reader without the ``onnx`` package
(uce_tpu/utils/onnx_lite.py, copied).

The NudeNet converter (``uce_tpu_torch/tools/convert_nudenet.py``) needs
only the weights of ``320n.onnx``: the graph's initializer TensorProtos.
This decodes the protobuf wire format for exactly that path
(ModelProto.graph -> GraphProto.initializer -> TensorProto {dims,
data_type, name, raw_data | typed data}) with numpy and ``struct``; the
card's machine has neither ``onnx`` nor ``onnxruntime``.

Wire format: varint (0), 64-bit (1), length-delimited (2) and 32-bit (5)
fields, as in the protobuf encoding documentation.
"""

from __future__ import annotations

import struct

import numpy as np

# TensorProto.DataType values we support (onnx.proto)
_DTYPES = {
    1: np.dtype(np.float32),
    2: np.dtype(np.uint8),
    3: np.dtype(np.int8),
    6: np.dtype(np.int32),
    7: np.dtype(np.int64),
    10: np.dtype(np.float16),
    11: np.dtype(np.float64),
}


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes.

    value is: int for varint(0)/fixed64(1)/fixed32(5), bytes for
    length-delimited(2).
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _packed_or_scalar_ints(wire, val):
    if wire == 0:
        return [val]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    """TensorProto -> (name, array). Fields: 1 dims, 2 data_type, 4
    float_data, 5 int32_data, 7 int64_data, 8 name, 9 raw_data, 10 string?,
    (typed data arrays are packed little-endian per onnx.proto)."""
    dims: list[int] = []
    dtype_code = 1
    name = ""
    raw = None
    floats = b""
    doubles = b""
    ints: list[int] = []
    for field, wire, val in _fields(buf):
        if field == 1:
            dims.extend(_packed_or_scalar_ints(wire, val))
        elif field == 2 and wire == 0:
            dtype_code = val
        elif field == 4:
            floats += val if wire == 2 else struct.pack("<I", val)
        elif field in (5, 7):  # int32_data / int64_data (varint-packed)
            ints.extend(_packed_or_scalar_ints(wire, val))
        elif field == 8 and wire == 2:
            name = val.decode("utf-8")
        elif field == 9 and wire == 2:
            raw = val
        elif field == 11:
            doubles += val if wire == 2 else struct.pack("<Q", val)
    if dtype_code not in _DTYPES:
        raise ValueError(f"tensor '{name}': unsupported data_type "
                         f"{dtype_code}")
    dt = _DTYPES[dtype_code]
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dt.newbyteorder("<"))
    elif floats:
        arr = np.frombuffer(floats, dtype="<f4")
    elif doubles:
        arr = np.frombuffer(doubles, dtype="<f8")
    elif ints:
        arr = np.asarray(ints, dtype=np.uint64).astype(dt, copy=False)
    else:
        arr = np.zeros(0, dtype=dt)
    return name, arr.astype(dt, copy=False).reshape(dims)


def read_initializers(path_or_bytes) -> dict[str, np.ndarray]:
    """ONNX file -> {initializer name: numpy array}."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    graph = None
    for field, wire, val in _fields(data):  # ModelProto
        if field == 7 and wire == 2:  # graph
            graph = val
    if graph is None:
        raise ValueError("no GraphProto (field 7) found — not an ONNX model?")
    out: dict[str, np.ndarray] = {}
    for field, wire, val in _fields(graph):  # GraphProto
        if field == 5 and wire == 2:  # initializer
            name, arr = _parse_tensor(val)
            out[name] = arr
    return out
