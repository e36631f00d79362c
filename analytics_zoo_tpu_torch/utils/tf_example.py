"""Protobuf wire-format helpers (a copy of the part of
analytics_zoo_tpu/utils/tf_example.py that TensorBoard's `Event` /
`Summary` encoding and the TFRecord image datasets need): varints,
tags, length-delimited fields, a field walker, and the
`tf.train.Example` codec (`encode_example` / `decode_example`)."""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Union

import numpy as np


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


def _encode_feature(value) -> bytes:
    """value: bytes / str -> BytesList; ints -> Int64List;
    floats -> FloatList; lists/ndarrays of same."""
    if isinstance(value, (bytes, str)):
        value = [value]
    elif isinstance(value, np.ndarray):
        value = value.ravel().tolist()
    elif not isinstance(value, (list, tuple)):
        value = [value]
    if not value:
        return _len_delim(3, b"")  # empty Int64List
    first = value[0]
    if isinstance(first, (bytes, str)):
        payload = b"".join(
            _len_delim(1, v.encode() if isinstance(v, str) else v)
            for v in value)
        return _len_delim(1, payload)  # BytesList
    if isinstance(first, (int, np.integer)):
        packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                          for v in value)
        return _len_delim(3, _tag(1, 2) + _varint(len(packed)) + packed)
    packed = struct.pack(f"<{len(value)}f", *[float(v) for v in value])
    return _len_delim(2, _tag(1, 2) + _varint(len(packed)) + packed)


def encode_example(features: Dict[str, Any]) -> bytes:
    """Encode {name: value} into a serialized tf.train.Example."""
    entries = b""
    for name, value in features.items():
        feat = _encode_feature(value)
        entry = _len_delim(1, name.encode()) + _len_delim(2, feat)
        entries += _len_delim(1, entry)  # Features.feature map entry
    return _len_delim(1, entries)  # Example.features


def _decode_list(buf: bytes, kind: int):
    """Decode BytesList/FloatList/Int64List payload -> python list."""
    out: List[Union[bytes, float, int]] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        wire = tag & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            chunk = buf[pos:pos + ln]
            pos += ln
            if kind == 1:  # BytesList value
                out.append(chunk)
            elif kind == 2:  # packed floats
                out.extend(struct.unpack(f"<{ln // 4}f", chunk))
            else:  # packed varint int64
                p = 0
                while p < ln:
                    v, p = _read_varint(chunk, p)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    out.append(v)
        elif wire == 0:  # unpacked int64
            v, pos = _read_varint(buf, pos)
            if v >= 1 << 63:
                v -= 1 << 64
            out.append(v)
        elif wire == 5:  # unpacked float
            out.append(struct.unpack("<f", buf[pos:pos + 4])[0])
            pos += 4
        else:
            raise ValueError(f"unexpected wire type {wire}")
    return out


def decode_example(data: bytes) -> Dict[str, List]:
    """Serialized Example -> {name: list of bytes/float/int}."""
    out: Dict[str, List] = {}
    pos = 0
    # Example: features field 1
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        ln, pos = _read_varint(data, pos)
        if tag >> 3 != 1:
            pos += ln
            continue
        features = data[pos:pos + ln]
        pos += ln
        fpos = 0
        while fpos < len(features):
            ftag, fpos = _read_varint(features, fpos)
            fln, fpos = _read_varint(features, fpos)
            entry = features[fpos:fpos + fln]
            fpos += fln
            # map entry: key field 1 (string), value field 2 (Feature)
            name, feat = "", b""
            epos = 0
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                eln, epos = _read_varint(entry, epos)
                chunk = entry[epos:epos + eln]
                epos += eln
                if etag >> 3 == 1:
                    name = chunk.decode()
                else:
                    feat = chunk
            # Feature: oneof field 1/2/3
            if feat:
                vtag, vpos = _read_varint(feat, 0)
                vln, vpos = _read_varint(feat, vpos)
                kind = vtag >> 3
                out[name] = _decode_list(feat[vpos:vpos + vln], kind)
            else:
                out[name] = []
    return out
