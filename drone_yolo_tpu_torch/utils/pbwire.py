"""Minimal protobuf wire-format codec: the KServe-v2 gRPC messages and the ONNX file format.

Counterpart of `drone_yolo_tpu/utils/pbwire.py`, with the encoders the ONNX writer
(`export/onnx_pb.py`) needs besides: float (fixed32), packed float, signed varints and nested
messages. The public wire rules: varint keys `field << 3 | wire`, length-delimited fields,
packed repeated scalars. Unknown fields are skipped by the readers, so a peer may send richer
messages than they read; malformed input raises ValueError. A nested message is `bytes_field` of its
encoding, written when set even if empty, as protobuf writes a present submessage.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple

# wire types
VARINT, I64, LEN, I32 = 0, 1, 2, 5


def encode_varint(v: int) -> bytes:
    """Encode a non-negative int as a protobuf base-128 varint."""
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_int(v: int) -> bytes:
    """An int32 or int64 as a varint: a negative value as its 64-bit two's complement (10 bytes), as protobuf does."""
    return encode_varint(v & 0xFFFFFFFFFFFFFFFF)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Decode a varint at `pos`; returns (value, next_pos). Raises ValueError
    on truncated or over-long (>10 byte / >64 bit) input."""
    result = shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise ValueError("truncated message: varint runs past end of buffer")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("malformed message: varint exceeds 64 bits")


def signed(v: int) -> int:
    """A decoded varint as a signed 64-bit int."""
    return v - (1 << 64) if v >= 1 << 63 else v


def key(field: int, wire: int) -> bytes:
    """Encode a field key varint: `field_number << 3 | wire_type`."""
    return encode_varint(field << 3 | wire)


def bytes_field(field: int, data: bytes) -> bytes:
    """Encode a length-delimited (LEN) field: key + length varint + payload."""
    return key(field, LEN) + encode_varint(len(data)) + data


def string_field(field: int, s: str) -> bytes:
    """Encode a UTF-8 string field; empty strings encode to nothing (proto3 default)."""
    return bytes_field(field, s.encode()) if s else b""


def int_field(field: int, v: int) -> bytes:
    """Encode an int32/int64/enum field (always written: the caller decides presence)."""
    return key(field, VARINT) + encode_int(int(v))


def float_field(field: int, v: float) -> bytes:
    """Encode a float field as fixed32 little-endian (always written: the caller decides presence)."""
    return key(field, I32) + struct.pack("<f", v)


def packed_int64_field(field: int, values) -> bytes:
    """Encode a packed repeated int64 field (two's-complement varints)."""
    payload = b"".join(encode_int(v) for v in values)
    return bytes_field(field, payload) if len(values) else b""


def packed_float_field(field: int, values) -> bytes:
    """Encode a packed repeated float field (fixed32 little-endian)."""
    return bytes_field(field, struct.pack(f"<{len(values)}f", *values)) if len(values) else b""


def fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Iterate (field_number, wire_type, value). LEN values are bytes; VARINT
    values are ints; I32/I64 raw bytes. Unknown wire types raise."""
    pos, n = 0, len(buf)
    while pos < n:
        k, pos = decode_varint(buf, pos)
        field, wire = k >> 3, k & 7
        if wire == VARINT:
            v, pos = decode_varint(buf, pos)
        elif wire == LEN:
            ln, pos = decode_varint(buf, pos)
            if pos + ln > n:
                raise ValueError(f"truncated message: LEN field {field} wants {ln} bytes, {n - pos} remain")
            v = buf[pos : pos + ln]
            pos += ln
        elif wire == I64:
            if pos + 8 > n:
                raise ValueError(f"truncated message: I64 field {field} past end of buffer")
            v = buf[pos : pos + 8]
            pos += 8
        elif wire == I32:
            if pos + 4 > n:
                raise ValueError(f"truncated message: I32 field {field} past end of buffer")
            v = buf[pos : pos + 4]
            pos += 4
        else:  # wire 3/4 (groups) are not used by proto3
            raise ValueError(f"unsupported wire type {wire} for field {field}")
        yield field, wire, v


def unpack_int64(payload: bytes) -> List[int]:
    """Packed repeated int64 payload -> list (two's-complement for negatives)."""
    out, pos = [], 0
    while pos < len(payload):
        v, pos = decode_varint(payload, pos)
        out.append(signed(v))
    return out


def unpack_float(payload: bytes) -> List[float]:
    """Packed repeated float payload -> list."""
    if len(payload) % 4:
        raise ValueError(f"malformed message: packed float payload of {len(payload)} bytes")
    return list(struct.unpack(f"<{len(payload) // 4}f", payload))
