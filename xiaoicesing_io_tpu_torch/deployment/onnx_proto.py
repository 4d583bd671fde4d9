"""Minimal ONNX protobuf wire-format writer/reader (no onnx dependency).

Copy of the JAX package's ``deployment/onnx_proto.py``.  The reference
DiffSinger ships ``.onnx`` graphs for OpenUTAU
(``deployment/exporters/acoustic_exporter.py:333-390``); the port depends on
neither the ``onnx`` package nor ``onnxruntime``, so the
ModelProto subset we emit is serialized by hand against the (stable,
append-only) ``onnx.proto3`` schema:

    ModelProto{ir_version=1, producer_name=2, graph=7, opset_import=8}
    GraphProto{node=1, name=2, initializer=5, input=11, output=12, value_info=13}
    NodeProto{input=1, output=2, name=3, op_type=4, attribute=5, domain=7}
    AttributeProto{name=1, f=2, i=3, s=4, t=5, g=6, floats=7, ints=8, type=20}
    TensorProto{dims=1, data_type=2, name=8, raw_data=9}
    ValueInfoProto{name=1, type=2}; TypeProto{tensor_type=1};
    TypeProto.Tensor{elem_type=1, shape=2}; TensorShapeProto{dim=1};
    Dimension{dim_value=1, dim_param=2}; OperatorSetIdProto{domain=1, version=2}

The reader parses the same subset back (used by the in-repo numpy executor,
``onnx_run.py``, to verify exported artifacts round-trip without
onnxruntime).  Files written here load in stock ``onnx``/onnxruntime — the
wire format is standard protobuf.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

# ONNX TensorProto.DataType
FLOAT, UINT8, INT8, INT32, INT64, BOOL = 1, 2, 3, 6, 7, 9
FLOAT16, DOUBLE, BFLOAT16 = 10, 11, 16

NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.float64): DOUBLE,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.float16): FLOAT16,
}
ONNX_TO_NP = {v: k for k, v in NP_TO_ONNX.items()}

# AttributeProto.AttributeType
A_FLOAT, A_INT, A_STRING, A_TENSOR, A_GRAPH = 1, 2, 3, 4, 5
A_FLOATS, A_INTS, A_STRINGS = 6, 7, 8


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------

def _varint(value: int) -> bytes:
    """Unsigned varint; negative ints use 64-bit two's complement."""
    if value < 0:
        value += 1 << 64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field_no: int, wire: int) -> bytes:
    return _varint((field_no << 3) | wire)


def _len_field(field_no: int, payload: bytes) -> bytes:
    return _tag(field_no, 2) + _varint(len(payload)) + payload


def _varint_field(field_no: int, value: int) -> bytes:
    return _tag(field_no, 0) + _varint(value)


def _float_field(field_no: int, value: float) -> bytes:
    return _tag(field_no, 5) + struct.pack("<f", value)


def _packed_varints(field_no: int, values) -> bytes:
    payload = b"".join(_varint(int(v)) for v in values)
    return _len_field(field_no, payload)


# ---------------------------------------------------------------------------
# writer-side model
# ---------------------------------------------------------------------------

@dataclass
class Tensor:
    name: str
    array: np.ndarray

    def serialize(self) -> bytes:
        # a 0-d array stays 0-d (``ascontiguousarray`` alone returns 1-d):
        # ONNX reads a scalar where a Loop's condition or a Gather's index
        # must be one
        a = np.ascontiguousarray(self.array).reshape(np.shape(self.array))
        dt = NP_TO_ONNX[a.dtype]
        out = b""
        for d in a.shape:
            out += _varint_field(1, d)
        out += _varint_field(2, dt)
        out += _len_field(8, self.name.encode())
        out += _len_field(9, a.tobytes())
        return out


@dataclass
class Attr:
    name: str
    value: Union[float, int, str, bytes, Tensor, "Graph", list]
    kind: Optional[int] = None  # inferred when None

    def serialize(self) -> bytes:
        out = _len_field(1, self.name.encode())
        v, kind = self.value, self.kind
        if kind is None:
            if isinstance(v, bool):
                kind = A_INT
            elif isinstance(v, float):
                kind = A_FLOAT
            elif isinstance(v, int):
                kind = A_INT
            elif isinstance(v, (str, bytes)):
                kind = A_STRING
            elif isinstance(v, Tensor):
                kind = A_TENSOR
            elif isinstance(v, Graph):
                kind = A_GRAPH
            elif isinstance(v, (list, tuple, np.ndarray)):
                v = list(v)
                kind = A_FLOATS if (v and isinstance(v[0], float)) else A_INTS
            else:
                raise TypeError(f"attr {self.name}: {type(v)}")
        if kind == A_FLOAT:
            out += _float_field(2, float(v))
        elif kind == A_INT:
            out += _varint_field(3, int(v))
        elif kind == A_STRING:
            out += _len_field(4, v.encode() if isinstance(v, str) else v)
        elif kind == A_TENSOR:
            out += _len_field(5, v.serialize())
        elif kind == A_GRAPH:
            out += _len_field(6, v.serialize())
        elif kind == A_FLOATS:
            payload = b"".join(struct.pack("<f", float(x)) for x in v)
            out += _len_field(7, payload)
        elif kind == A_INTS:
            out += _packed_varints(8, v)
        else:
            raise TypeError(f"attr {self.name}: kind {kind}")
        out += _varint_field(20, kind)
        return out


@dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, object] = field(default_factory=dict)
    name: str = ""

    def serialize(self) -> bytes:
        out = b""
        for i in self.inputs:
            out += _len_field(1, i.encode())
        for o in self.outputs:
            out += _len_field(2, o.encode())
        if self.name:
            out += _len_field(3, self.name.encode())
        out += _len_field(4, self.op_type.encode())
        for k, v in self.attrs.items():
            a = v if isinstance(v, Attr) else Attr(k, v)
            out += _len_field(5, a.serialize())
        return out


def _value_info(name: str, elem_type: int, shape) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _len_field(1, _len_field(2, d.encode()))
        else:
            dims += _len_field(1, _varint_field(1, int(d)))
    tensor_type = _varint_field(1, elem_type) + _len_field(2, dims)
    type_proto = _len_field(1, tensor_type)
    return _len_field(1, name.encode()) + _len_field(2, type_proto)


@dataclass
class Graph:
    name: str
    nodes: List[Node]
    inputs: List[tuple]   # (name, elem_type, shape) — shape entries int|str
    outputs: List[tuple]
    initializers: List[Tensor] = field(default_factory=list)

    def serialize(self) -> bytes:
        # one join: repeated ``+=`` would copy a full-width graph's hundreds
        # of MB of weights once per field
        out = [_len_field(1, n.serialize()) for n in self.nodes]
        out.append(_len_field(2, self.name.encode()))
        out += [_len_field(5, t.serialize()) for t in self.initializers]
        out += [_len_field(11, _value_info(name, et, shape)) for name, et, shape in self.inputs]
        out += [_len_field(12, _value_info(name, et, shape)) for name, et, shape in self.outputs]
        return b"".join(out)


def build_model(graph: Graph, opset: int = 17,
                producer: str = "xiaoicesing_io_tpu_torch") -> bytes:
    out = _varint_field(1, 8)  # ir_version 8
    out += _len_field(2, producer.encode())
    out += _len_field(7, graph.serialize())
    out += _len_field(8, _len_field(1, b"") + _varint_field(2, opset))
    return out


# ---------------------------------------------------------------------------
# reader (same subset)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if result >= 1 << 63:
                result -= 1 << 64
            return result, pos
        shift += 7


def _read_fields(buf: bytes):
    """Yield (field_no, wire, value) over a protobuf message body."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field_no, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            v = buf[pos : pos + n]
            pos += n
        elif wire == 5:
            v = struct.unpack("<f", buf[pos : pos + 4])[0]
            pos += 4
        elif wire == 1:
            v = struct.unpack("<d", buf[pos : pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"wire type {wire}")
        yield field_no, wire, v


def parse_tensor(buf: bytes) -> Tensor:
    dims, dtype, name, raw = [], FLOAT, "", b""
    float_data, int64_data, int32_data = [], [], []
    for f, w, v in _read_fields(buf):
        if f == 1:
            if w == 0:
                dims.append(v)
            else:  # packed
                p = 0
                while p < len(v):
                    d, p = _read_varint(v, p)
                    dims.append(d)
        elif f == 2:
            dtype = v
        elif f == 4:
            if w == 2:
                float_data.extend(np.frombuffer(v, "<f4").tolist())
            else:
                float_data.append(v)
        elif f == 5:
            if w == 2:
                p = 0
                while p < len(v):
                    d, p = _read_varint(v, p)
                    int32_data.append(d)
            else:
                int32_data.append(v)
        elif f == 7:
            if w == 2:
                p = 0
                while p < len(v):
                    d, p = _read_varint(v, p)
                    int64_data.append(d)
            else:
                int64_data.append(v)
        elif f == 8:
            name = v.decode()
        elif f == 9:
            raw = v
    np_dt = ONNX_TO_NP[dtype]
    if raw:
        a = np.frombuffer(raw, np_dt).reshape(dims)
    elif float_data:
        a = np.asarray(float_data, np_dt).reshape(dims)
    elif int64_data:
        a = np.asarray(int64_data, np_dt).reshape(dims)
    elif int32_data:
        a = np.asarray(int32_data, np_dt).reshape(dims)
    else:
        a = np.zeros(dims, np_dt)
    return Tensor(name, a)


def _parse_attr(buf: bytes):
    name, kind = "", None
    fields = {}
    for f, w, v in _read_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 20:
            kind = v
        else:
            fields.setdefault(f, []).append((w, v))

    def first(f):
        return fields[f][0][1]

    if kind == A_FLOAT:
        return name, first(2)
    if kind == A_INT:
        return name, first(3)
    if kind == A_STRING:
        return name, first(4).decode()
    if kind == A_TENSOR:
        return name, parse_tensor(first(5))
    if kind == A_GRAPH:
        return name, parse_graph(first(6))
    if kind == A_FLOATS:
        out = []
        for w, v in fields.get(7, []):
            if w == 2:
                out.extend(np.frombuffer(v, "<f4").tolist())
            else:
                out.append(v)
        return name, out
    if kind == A_INTS:
        out = []
        for w, v in fields.get(8, []):
            if w == 2:
                p = 0
                while p < len(v):
                    d, p = _read_varint(v, p)
                    out.append(d)
            else:
                out.append(v)
        return name, out
    raise ValueError(f"attribute {name}: kind {kind}")


def _parse_node(buf: bytes) -> Node:
    n = Node("", [], [], {})
    for f, w, v in _read_fields(buf):
        if f == 1:
            n.inputs.append(v.decode())
        elif f == 2:
            n.outputs.append(v.decode())
        elif f == 3:
            n.name = v.decode()
        elif f == 4:
            n.op_type = v.decode()
        elif f == 5:
            k, val = _parse_attr(v)
            n.attrs[k] = val
    return n


def _parse_value_info(buf: bytes):
    name, elem, shape = "", None, []
    for f, w, v in _read_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:
            for f2, _, v2 in _read_fields(v):
                if f2 != 1:
                    continue
                for f3, _, v3 in _read_fields(v2):
                    if f3 == 1:
                        elem = v3
                    elif f3 == 2:
                        for f4, _, v4 in _read_fields(v3):
                            if f4 != 1:
                                continue
                            entry = None
                            for f5, _, v5 in _read_fields(v4):
                                if f5 == 1:
                                    entry = v5
                                elif f5 == 2:
                                    entry = v5.decode()
                            shape.append(entry)
    return name, elem, shape


def parse_graph(buf: bytes) -> Graph:
    g = Graph("", [], [], [], [])
    for f, w, v in _read_fields(buf):
        if f == 1:
            g.nodes.append(_parse_node(v))
        elif f == 2:
            g.name = v.decode()
        elif f == 5:
            g.initializers.append(parse_tensor(v))
        elif f == 11:
            g.inputs.append(_parse_value_info(v))
        elif f == 12:
            g.outputs.append(_parse_value_info(v))
    return g


def parse_model(buf: bytes):
    """-> (Graph, {"ir_version": int, "opset": int, "producer": str})."""
    meta = {}
    graph = None
    for f, w, v in _read_fields(buf):
        if f == 1:
            meta["ir_version"] = v
        elif f == 2:
            meta["producer"] = v.decode()
        elif f == 7:
            graph = parse_graph(v)
        elif f == 8:
            for f2, _, v2 in _read_fields(v):
                if f2 == 2:
                    meta["opset"] = v2
    return graph, meta
