"""The ONNX file format's messages, written and read with `utils/pbwire.py` by their field numbers.

Counterpart of `drone_yolo_tpu/export/onnx.proto` and its generated `onnx_pb2.py`, without
`google.protobuf`: the nine messages of that subset of the public ONNX schema (ModelProto, GraphProto,
NodeProto, AttributeProto, TensorProto, ValueInfoProto, TypeProto, TensorShapeProto, OperatorSetIdProto,
with TypeProto.Tensor and TensorShapeProto.Dimension). Each message class lists its fields as
(number, name, type, label). Serialization follows proto3 as `google.protobuf` does it, so that the
same message gives the same bytes: fields in field-number order; a plain scalar only when it is not
its default; an `optional` scalar, a oneof member and a submessage whenever set; repeated numbers
packed, repeated strings and messages one field each; a negative int as its 64-bit two's complement.
Parsing skips fields the schema lacks, so files from other writers read too.
"""

from __future__ import annotations

import struct

from drone_yolo_tpu_torch.utils import pbwire as pb

# labels
PLAIN, OPTIONAL, REPEATED, ONEOF = "plain", "optional", "repeated", "oneof"
_NUMERIC = ("int64", "int32", "float")


class Message:
    """A protobuf message by its `FIELDS`: (number, name, type, label); type is "string", "bytes", "int64",
    "int32", "float" or the name of a message class of this module."""

    FIELDS: tuple = ()

    def __init__(self, **values):
        for _, name, _, label in self.FIELDS:
            setattr(self, name, [] if label == REPEATED else None)
        names = {f[1] for f in self.FIELDS}
        for k, v in values.items():
            if k not in names:
                raise AttributeError(f"{type(self).__name__} has no field {k!r}")
            setattr(self, k, list(v) if isinstance(v, (list, tuple)) else v)

    def __eq__(self, other):
        return type(self) is type(other) and all(getattr(self, f[1]) == getattr(other, f[1]) for f in self.FIELDS)

    # -- writing -----------------------------------------------------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out = bytearray()
        for number, name, typ, label in sorted(self.FIELDS):
            v = getattr(self, name)
            if label == REPEATED:
                if typ in ("int64", "int32"):
                    out += pb.packed_int64_field(number, v)
                elif typ == "float":
                    out += pb.packed_float_field(number, v)
                else:
                    for item in v:
                        out += _encode(number, typ, item)
            elif v is not None and (label != PLAIN or typ not in (*_NUMERIC, "string", "bytes") or v):
                out += _encode(number, typ, v)
        return bytes(out)

    # -- reading -----------------------------------------------------------------------------------------------------
    @classmethod
    def FromString(cls, buf: bytes) -> Message:
        msg = cls()
        by_number = {f[0]: f for f in cls.FIELDS}
        for number, wire, v in pb.fields(buf):
            if number not in by_number:
                continue  # a field this subset of the schema lacks
            _, name, typ, label = by_number[number]
            value = _decode(typ, wire, v, label == REPEATED)
            if label == REPEATED:
                getattr(msg, name).extend(value if isinstance(value, list) else [value])
            else:
                setattr(msg, name, value)
        return msg


def _encode(number: int, typ: str, v) -> bytes:
    if typ in ("int64", "int32"):
        return pb.int_field(number, v)
    if typ == "float":
        return pb.float_field(number, v)
    if typ == "string":
        return pb.bytes_field(number, v.encode())
    if typ == "bytes":
        return pb.bytes_field(number, bytes(v))
    return pb.bytes_field(number, v.SerializeToString())  # a nested message: its encoding, length-delimited


def _decode(typ: str, wire: int, v, repeated: bool):
    if typ in ("int64", "int32"):
        if wire == pb.LEN:
            if not repeated:
                raise ValueError(f"malformed message: a packed {typ} where one value belongs")
            return pb.unpack_int64(v)
        if wire != pb.VARINT:
            raise ValueError(f"malformed message: {typ} with wire type {wire}")
        return pb.signed(v)
    if typ == "float":
        if wire == pb.LEN:
            if not repeated:
                raise ValueError("malformed message: a packed float where one value belongs")
            return pb.unpack_float(v)
        if wire != pb.I32:
            raise ValueError(f"malformed message: float with wire type {wire}")
        return struct.unpack("<f", v)[0]
    if wire != pb.LEN:
        raise ValueError(f"malformed message: {typ} with wire type {wire}")
    if typ == "string":
        return bytes(v).decode()
    if typ == "bytes":
        return bytes(v)
    return globals()[typ].FromString(v)


class AttributeProto(Message):
    UNDEFINED, FLOAT, INT, STRING, TENSOR, GRAPH, FLOATS, INTS, STRINGS, TENSORS, GRAPHS = range(11)
    FIELDS = ((1, "name", "string", PLAIN), (2, "f", "float", OPTIONAL), (3, "i", "int64", OPTIONAL),
              (4, "s", "bytes", OPTIONAL), (5, "t", "TensorProto", PLAIN), (7, "floats", "float", REPEATED),
              (8, "ints", "int64", REPEATED), (9, "strings", "bytes", REPEATED), (20, "type", "int32", OPTIONAL))


class ValueInfoProto(Message):
    FIELDS = ((1, "name", "string", PLAIN), (2, "type", "TypeProto", PLAIN), (3, "doc_string", "string", PLAIN))


class NodeProto(Message):
    FIELDS = ((1, "input", "string", REPEATED), (2, "output", "string", REPEATED), (3, "name", "string", PLAIN),
              (4, "op_type", "string", PLAIN), (5, "attribute", "AttributeProto", REPEATED),
              (6, "doc_string", "string", PLAIN), (7, "domain", "string", PLAIN))


class ModelProto(Message):
    FIELDS = ((1, "ir_version", "int64", OPTIONAL), (2, "producer_name", "string", PLAIN),
              (3, "producer_version", "string", PLAIN), (4, "domain", "string", PLAIN),
              (5, "model_version", "int64", PLAIN), (6, "doc_string", "string", PLAIN), (7, "graph", "GraphProto", PLAIN),
              (8, "opset_import", "OperatorSetIdProto", REPEATED))


class GraphProto(Message):
    FIELDS = ((1, "node", "NodeProto", REPEATED), (2, "name", "string", PLAIN),
              (5, "initializer", "TensorProto", REPEATED), (10, "doc_string", "string", PLAIN),
              (11, "input", "ValueInfoProto", REPEATED), (12, "output", "ValueInfoProto", REPEATED),
              (13, "value_info", "ValueInfoProto", REPEATED))


class TensorProto(Message):
    UNDEFINED, FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64 = range(14)
    # data_location (14) is not in the JAX package's subset: it is read so that a file whose weights lie outside it
    # is refused by name
    FIELDS = ((1, "dims", "int64", REPEATED), (2, "data_type", "int32", OPTIONAL), (4, "float_data", "float", REPEATED),
              (5, "int32_data", "int32", REPEATED), (6, "string_data", "bytes", REPEATED),
              (7, "int64_data", "int64", REPEATED), (8, "name", "string", PLAIN), (9, "raw_data", "bytes", PLAIN),
              (14, "data_location", "int32", PLAIN))


class Dimension(Message):
    """TensorShapeProto.Dimension: the oneof of a fixed size and a symbolic one."""

    FIELDS = ((1, "dim_value", "int64", ONEOF), (2, "dim_param", "string", ONEOF))


class TensorShapeProto(Message):
    FIELDS = ((1, "dim", "Dimension", REPEATED),)


class TensorType(Message):
    """TypeProto.Tensor."""

    FIELDS = ((1, "elem_type", "int32", OPTIONAL), (2, "shape", "TensorShapeProto", PLAIN))


class TypeProto(Message):
    FIELDS = ((1, "tensor_type", "TensorType", ONEOF),)


class OperatorSetIdProto(Message):
    FIELDS = ((1, "domain", "string", PLAIN), (2, "version", "int64", OPTIONAL))
