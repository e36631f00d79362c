"""Protobuf wire-format helpers (a copy of the part of
analytics_zoo_tpu/utils/tf_example.py that TensorBoard's `Event` /
`Summary` encoding needs): varints, tags, length-delimited fields and a
field walker."""

from __future__ import annotations


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def to_signed(v: int) -> int:
    """Two's-complement view of a decoded uint64 varint."""
    return v - (1 << 64) if v >= 1 << 63 else v


def walk_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message
    payload.  Length-delimited and fixed-width values come back as
    bytes, varints as ints."""
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 1:
            v = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield fnum, wire, v
