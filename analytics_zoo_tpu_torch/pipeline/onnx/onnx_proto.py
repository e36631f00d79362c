"""Minimal ONNX protobuf wire-format codec (a copy of
analytics_zoo_tpu/pipeline/onnx/onnx_proto.py; numpy only).

Covers the ModelProto subset every real exporter emits: graph nodes with
attributes, tensor initializers, typed graph inputs/outputs.  Field
numbers follow onnx/onnx.proto; decoding is a plain tag-walk, unknown
fields are skipped.

Two differences from the JAX package's copy, neither visible in what it
decodes or encodes: the decoder walks a memoryview of the file, so an
initializer's `raw_data` becomes a numpy view of the caller's bytes (no
copy; a BERT-base file holds about 440 MB of it), and the encoder joins
its parts once instead of growing a bytes object field by field.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.utils.tf_example import (
    _len_delim,
    _read_varint,
    _tag,
    _varint,
    to_signed as _signed,
    to_str as _str,
    walk_fields as _walk,
)

# TensorProto.DataType -> numpy
DTYPE = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
         5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
         10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}
DTYPE_REV = {np.dtype(v): k for k, v in DTYPE.items()}


def _packed_varints(buf) -> List[int]:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(_signed(v))
    return out


# ---------------------------------------------------------------------------
# decoded model structure
# ---------------------------------------------------------------------------

@dataclass
class Attribute:
    name: str = ""
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    t: Optional[np.ndarray] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)
    type: int = 0

    @property
    def value(self):
        # AttributeProto.AttributeType: 1 FLOAT 2 INT 3 STRING 4 TENSOR
        # 6 FLOATS 7 INTS 8 STRINGS.  proto3 serializers OMIT zero-valued
        # scalars on the wire (type says INT but no i field), so a typed
        # attribute with a missing scalar means 0, not "absent".
        if self.type == 1:
            return self.f if self.f is not None else 0.0
        if self.type == 2:
            return self.i if self.i is not None else 0
        if self.type == 3:
            return self.s if self.s is not None else b""
        return {4: self.t, 6: self.floats, 7: self.ints,
                8: self.strings}.get(self.type)


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Attribute] = field(default_factory=dict)


@dataclass
class Graph:
    name: str = ""
    nodes: List[Node] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[Tuple[str, Optional[List[int]]]] = field(
        default_factory=list)
    outputs: List[str] = field(default_factory=list)


@dataclass
class Model:
    ir_version: int = 0
    opset: int = 0
    producer: str = ""
    graph: Graph = field(default_factory=Graph)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _decode_tensor(buf) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = 1
    name = ""
    raw = None
    floats: List[float] = []
    ints: List[int] = []
    for fnum, wire, v in _walk(buf):
        if fnum == 1:
            dims.extend(_packed_varints(v) if wire == 2 else [_signed(v)])
        elif fnum == 2:
            dtype = v
        elif fnum == 4:  # float_data, packed
            floats.extend(struct.unpack(f"<{len(v) // 4}f", v)
                          if wire == 2
                          else struct.unpack("<f", v))
        elif fnum in (5, 7):  # int32_data / int64_data
            ints.extend(_packed_varints(v) if wire == 2 else [_signed(v)])
        elif fnum == 8:
            name = _str(v)
        elif fnum == 9:
            raw = v
        elif fnum == 10:  # double_data
            floats.extend(struct.unpack(f"<{len(v) // 8}d", v))
    np_dtype = DTYPE.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, np_dtype)
    else:
        arr = np.asarray(ints, np_dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _decode_attribute(buf) -> Attribute:
    a = Attribute()
    for fnum, wire, v in _walk(buf):
        if fnum == 1:
            a.name = _str(v)
        elif fnum == 2:
            a.f = struct.unpack("<f", v)[0]
        elif fnum == 3:
            a.i = _signed(v)
        elif fnum == 4:
            a.s = bytes(v)
        elif fnum == 5:
            a.t = _decode_tensor(v)[1]
        elif fnum == 7:
            a.floats.extend(struct.unpack(f"<{len(v) // 4}f", v)
                            if wire == 2 else struct.unpack("<f", v))
        elif fnum == 8:
            a.ints.extend(_packed_varints(v) if wire == 2
                          else [_signed(v)])
        elif fnum == 9:
            a.strings.append(bytes(v))
        elif fnum == 20:
            a.type = v
    if a.type == 0:  # older exporters omit type; infer it
        for t, val in ((1, a.f), (2, a.i), (3, a.s), (4, a.t)):
            if val is not None:
                a.type = t
                break
        else:
            a.type = 7 if a.ints else (6 if a.floats
                                       else (8 if a.strings else 0))
    return a


def _decode_node(buf) -> Node:
    n = Node()
    for fnum, _, v in _walk(buf):
        if fnum == 1:
            n.inputs.append(_str(v))
        elif fnum == 2:
            n.outputs.append(_str(v))
        elif fnum == 3:
            n.name = _str(v)
        elif fnum == 4:
            n.op_type = _str(v)
        elif fnum == 5:
            a = _decode_attribute(v)
            n.attrs[a.name] = a
    return n


def _decode_value_info(buf) -> Tuple[str, Optional[List[int]]]:
    name, shape = "", None
    for fnum, _, v in _walk(buf):
        if fnum == 1:
            name = _str(v)
        elif fnum == 2:  # TypeProto
            for f2, _, v2 in _walk(v):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _walk(v2):
                        if f3 == 2:  # TensorShapeProto
                            shape = []
                            for f4, _, v4 in _walk(v3):
                                if f4 == 1:  # Dimension
                                    dim = -1
                                    for f5, w5, v5 in _walk(v4):
                                        if f5 == 1:
                                            dim = _signed(v5)
                                    shape.append(dim)
    return name, shape


def _decode_graph(buf) -> Graph:
    g = Graph()
    for fnum, _, v in _walk(buf):
        if fnum == 1:
            g.nodes.append(_decode_node(v))
        elif fnum == 2:
            g.name = _str(v)
        elif fnum == 5:
            name, arr = _decode_tensor(v)
            g.initializers[name] = arr
        elif fnum == 11:
            g.inputs.append(_decode_value_info(v))
        elif fnum == 12:
            g.outputs.append(_decode_value_info(v)[0])
    return g


def decode_model(data) -> Model:
    """Decode ModelProto bytes.  Initializers stored as `raw_data` are
    read-only numpy views of `data`."""
    m = Model()
    for fnum, wire, v in _walk(memoryview(data)):
        if fnum == 1:
            m.ir_version = v
        elif fnum == 2:
            m.producer = _str(v)
        elif fnum == 7:
            m.graph = _decode_graph(v)
        elif fnum == 8:  # OperatorSetIdProto
            for f2, _, v2 in _walk(v):
                if f2 == 2:
                    m.opset = max(m.opset, v2)
    return m


# ---------------------------------------------------------------------------
# encode (fixtures / interop exports)
# ---------------------------------------------------------------------------

def _enc_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    parts = [_tag(1, 0) + _varint(d) for d in arr.shape]
    parts.append(_tag(2, 0) + _varint(DTYPE_REV[arr.dtype]))
    parts.append(_len_delim(8, name.encode()))
    parts.append(_tag(9, 2) + _varint(arr.nbytes))
    parts.append(arr.tobytes())
    return b"".join(parts)


def _enc_attr(name: str, value) -> bytes:
    out = _len_delim(1, name.encode())
    if isinstance(value, bool):
        out += _tag(3, 0) + _varint(int(value)) + _tag(20, 0) + _varint(2)
    elif isinstance(value, (int, np.integer)):
        out += _tag(3, 0) + _varint(int(value) & (2**64 - 1)) \
            + _tag(20, 0) + _varint(2)
    elif isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value) \
            + _tag(20, 0) + _varint(1)
    elif isinstance(value, (bytes, str)):
        v = value.encode() if isinstance(value, str) else value
        out += _len_delim(4, v) + _tag(20, 0) + _varint(3)
    elif isinstance(value, np.ndarray):
        out += _len_delim(5, _enc_tensor("", value)) \
            + _tag(20, 0) + _varint(4)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            for f in value:
                out += _tag(7, 5) + struct.pack("<f", f)
            out += _tag(20, 0) + _varint(6)
        elif value and isinstance(value[0], (bytes, str)):
            for s in value:
                out += _len_delim(
                    9, s.encode() if isinstance(s, str) else s)
            out += _tag(20, 0) + _varint(8)   # AttributeProto.STRINGS
        else:
            for i in value:
                out += _tag(8, 0) + _varint(int(i) & (2**64 - 1))
            out += _tag(20, 0) + _varint(7)
    else:
        raise TypeError(f"unsupported attribute value {value!r}")
    return out


def _enc_node(op_type: str, inputs, outputs, attrs=None, name="") -> bytes:
    out = b""
    for i in inputs:
        out += _len_delim(1, i.encode())
    for o in outputs:
        out += _len_delim(2, o.encode())
    if name:
        out += _len_delim(3, name.encode())
    out += _len_delim(4, op_type.encode())
    for k, v in (attrs or {}).items():
        out += _len_delim(5, _enc_attr(k, v))
    return out


def _enc_value_info(name: str, shape, elem_type: int = 1) -> bytes:
    dims = b""
    for d in (shape or []):
        dims += _len_delim(1, _tag(1, 0) + _varint(d))
    tensor_type = _tag(1, 0) + _varint(elem_type) + _len_delim(2, dims)
    return _len_delim(1, name.encode()) \
        + _len_delim(2, _len_delim(1, tensor_type))


def encode_model(nodes: List[Tuple], initializers: Dict[str, np.ndarray],
                 inputs: List[Tuple[str, List[int]]],
                 outputs: List[str], opset: int = 13) -> bytes:
    """nodes: (op_type, inputs, outputs[, attrs]) tuples.  Returns
    serialized ModelProto bytes readable by any ONNX runtime."""
    g = []
    for spec in nodes:
        op, ins, outs = spec[0], spec[1], spec[2]
        attrs = spec[3] if len(spec) > 3 else None
        g.append(_len_delim(1, _enc_node(op, ins, outs, attrs)))
    g.append(_len_delim(2, b"graph"))
    for name, arr in initializers.items():
        g.append(_len_delim(5, _enc_tensor(name, arr)))
    for name, shape in inputs:
        g.append(_len_delim(11, _enc_value_info(name, shape)))
    for name in outputs:
        g.append(_len_delim(12, _enc_value_info(name, None)))
    n = sum(len(p) for p in g)
    return b"".join([_tag(1, 0) + _varint(8),  # ir_version
                     _len_delim(2, b"analytics_zoo_tpu"),
                     _tag(7, 2) + _varint(n)] + g
                    + [_len_delim(8, _len_delim(1, b"") + _tag(2, 0)
                                  + _varint(opset))])
