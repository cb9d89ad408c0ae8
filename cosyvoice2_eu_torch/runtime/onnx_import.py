"""Minimal ONNX weight extraction (no onnxruntime / onnx package needed).

The port's own copy of ``cosyvoice2_eu_tpu/runtime/onnx_import.py``
(numpy only).

The reference ships its speech tokenizer and speaker model as ONNX binaries
(speech_tokenizer_v2.onnx / campplus.onnx, reference:
cosy_repo/cosyvoice/cli/frontend.py:190-197).  This module walks the protobuf
wire format directly and extracts all initializer tensors (name -> numpy
array) plus the node list (op_type, inputs, outputs), enough to map weights
onto the models in models/speech_tokenizer.py and models/campplus.py.

Implements just the protobuf subset ONNX uses: varints, length-delimited
submessages, repeated packed ints.  Field numbers follow onnx.proto3:
  ModelProto.graph = 7
  GraphProto.node = 1, .initializer = 5, .input = 11, .output = 12
  NodeProto.input = 1, .output = 2, .op_type = 4, .attribute = 5
  AttributeProto.name = 1, .f = 2, .i = 3, .s = 4, .t = 5, .floats = 7,
             .ints = 8
  TensorProto.dims = 1, .data_type = 2, .float_data = 4, .int64_data = 7,
             .name = 8, .raw_data = 9
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple

import numpy as np

# onnx.TensorProto.DataType -> numpy
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not (b & 0x80):
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wtype == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield field, wtype, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims, dtype, name = [], 1, ""
    raw = None
    float_data, int64_data = [], []
    for field, wtype, val in _fields(buf):
        if field == 1:  # dims (varint or packed)
            if wtype == 0:
                dims.append(val)
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    dims.append(v)
        elif field == 2 and wtype == 0:
            dtype = val
        elif field == 4:  # float_data (packed 32-bit)
            float_data.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 7:  # int64_data
            if wtype == 0:
                int64_data.append(val)
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int64_data.append(v)
        elif field == 8 and wtype == 2:
            name = val.decode("utf-8", errors="replace")
        elif field == 9 and wtype == 2:
            raw = val
    np_dtype = _DTYPES.get(dtype, np.float32)
    shape = tuple(dims)
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype).reshape(shape)
    elif float_data:
        arr = np.asarray(float_data, np.float32).reshape(shape)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64).reshape(shape)
    else:
        arr = np.zeros(shape, np_dtype)
    return name, arr


def _signed64(v: int) -> int:
    """Protobuf int64 varints are two's-complement; recover the sign."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attribute(buf: bytes) -> Tuple[str, object]:
    """AttributeProto -> (name, value); value is float/int/bytes/ndarray/list."""
    name = ""
    f_val = i_val = s_val = t_val = None
    a_type = None  # AttributeProto.type (field 20): proto3 omits zero-valued
    # scalars, so e.g. an explicit axis=0 arrives with type=INT but NO field-3
    # payload; without consulting the type we'd mis-return the empty ints list.
    floats: list[float] = []
    ints: list[int] = []
    for field, wtype, val in _fields(buf):
        if field == 1 and wtype == 2:
            name = val.decode("utf-8", errors="replace")
        elif field == 20 and wtype == 0:
            a_type = val
        elif field == 2 and wtype == 5:
            f_val = struct.unpack("<f", val)[0]
        elif field == 3 and wtype == 0:
            i_val = _signed64(val)
        elif field == 4 and wtype == 2:
            s_val = val
        elif field == 5 and wtype == 2:
            t_val = _parse_tensor(val)[1]
        elif field == 7:  # floats
            if wtype == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 8:  # ints
            if wtype == 0:
                ints.append(_signed64(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(_signed64(v))
    for v in (t_val, f_val, i_val, s_val):
        if v is not None:
            return name, v
    # Scalar attribute with its value field absent (proto3 zero default).
    if a_type == 1:  # FLOAT
        return name, 0.0
    if a_type == 2:  # INT
        return name, 0
    if a_type == 3:  # STRING
        return name, b""
    if floats or a_type == 6:
        return name, floats
    return name, ints


def _parse_node(buf: bytes) -> dict:
    node = {"input": [], "output": [], "op_type": "", "name": "", "attrs": {}}
    for field, wtype, val in _fields(buf):
        if field == 1 and wtype == 2:
            node["input"].append(val.decode("utf-8", errors="replace"))
        elif field == 2 and wtype == 2:
            node["output"].append(val.decode("utf-8", errors="replace"))
        elif field == 3 and wtype == 2:
            node["name"] = val.decode("utf-8", errors="replace")
        elif field == 4 and wtype == 2:
            node["op_type"] = val.decode("utf-8", errors="replace")
        elif field == 5 and wtype == 2:
            k, v = _parse_attribute(val)
            node["attrs"][k] = v
    return node


def _value_info_name(buf: bytes) -> str:
    for field, wtype, val in _fields(buf):
        if field == 1 and wtype == 2:
            return val.decode("utf-8", errors="replace")
    return ""


def _value_info_elem_type(buf: bytes) -> int:
    """TensorProto.DataType of a ValueInfoProto, or 0 when absent.
    ValueInfoProto.type = 2 -> TypeProto.tensor_type = 1 -> elem_type = 1."""
    for field, wtype, val in _fields(buf):
        if field == 2 and wtype == 2:  # TypeProto
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:  # TypeProto.Tensor
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 0:  # elem_type
                            return int(v3)
    return 0


def load_onnx(path: str) -> dict:
    """Returns {'initializers': {name: ndarray}, 'nodes': [node dicts],
    'inputs': [names], 'outputs': [names]} (graph inputs minus initializers
    are the runtime feeds)."""
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wtype, val in _fields(model):
        if field == 7 and wtype == 2:
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no GraphProto found (field 7)")
    initializers, nodes = {}, []
    inputs, outputs = [], []
    input_types: dict[str, int] = {}
    for field, wtype, val in _fields(graph):
        if field == 5 and wtype == 2:
            name, arr = _parse_tensor(val)
            initializers[name] = arr
        elif field == 1 and wtype == 2:
            nodes.append(_parse_node(val))
        elif field == 11 and wtype == 2:
            name = _value_info_name(val)
            inputs.append(name)
            input_types[name] = _value_info_elem_type(val)
        elif field == 12 and wtype == 2:
            outputs.append(_value_info_name(val))
    inputs = [n for n in inputs if n not in initializers]
    return {
        "initializers": initializers,
        "nodes": nodes,
        "inputs": inputs,
        "outputs": outputs,
        # graph-input TensorProto.DataType by name (0 = unknown); used by
        # simplify_graph's dtype inference to judge Cast transparency
        "input_types": {k: v for k, v in input_types.items() if k in inputs},
    }
