"""Minimal ONNX weight extractor — no onnx/onnxruntime dependency.

SuperPoint and LightGlue weights come as .onnx files; this reads just
enough of the protobuf wire format to pull the initializer tensors
(name -> numpy array) for the converters in `models/superpoint.py` and
`loop/detect.py`.

Wire format facts used: ModelProto.graph = field 7 (message),
GraphProto.initializer = field 5 (repeated TensorProto), TensorProto fields:
dims = 1 (varint, repeated), data_type = 2 (varint), float_data = 4
(packed), name = 8 (bytes), raw_data = 9 (bytes).
"""

from __future__ import annotations

import struct

import numpy as np

_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
           7: np.int64, 10: np.float16, 11: np.float64}


def _read_varint(buf, i):
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf):
    """Yield (field_number, wire_type, value_bytes_or_int) over a message."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:                      # varint
            v, i = _read_varint(buf, i)
            yield field, wt, v
        elif wt == 2:                    # length-delimited
            ln, i = _read_varint(buf, i)
            yield field, wt, buf[i:i + ln]
            i += ln
        elif wt == 5:                    # 32-bit
            yield field, wt, buf[i:i + 4]
            i += 4
        elif wt == 1:                    # 64-bit
            yield field, wt, buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _parse_tensor(buf):
    dims, dtype, name, raw, floats = [], 1, "", None, []
    for field, wt, v in _fields(buf):
        if field == 1 and wt == 0:
            dims.append(v)
        elif field == 1 and wt == 2:     # packed dims
            i = 0
            while i < len(v):
                d, i = _read_varint(v, i)
                dims.append(d)
        elif field == 2:
            dtype = v
        elif field == 8:
            name = v.decode()
        elif field == 9:
            raw = v
        elif field == 4 and wt == 2:     # packed float_data
            floats = list(struct.unpack(f"<{len(v) // 4}f", v))
        elif field == 4 and wt == 5:
            floats.append(struct.unpack("<f", v)[0])
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    else:
        arr = np.asarray(floats, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def load_onnx_initializers(path):
    """-> dict name -> numpy array of every initializer in the graph."""
    with open(path, "rb") as f:
        model = f.read()
    out = {}

    def walk_graph(gbuf):
        for field, wt, v in _fields(gbuf):
            if field == 5 and wt == 2:           # initializer
                name, arr = _parse_tensor(v)
                out[name] = arr

    for field, wt, v in _fields(model):
        if field == 7 and wt == 2:               # ModelProto.graph
            walk_graph(v)
    return out
