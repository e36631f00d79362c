"""TFRecord framing in pure Python (a copy of the part of
analytics_zoo_tpu/utils/tfrecord.py that TensorBoard event files need):

    uint64le  length
    uint32le  masked_crc32c(length bytes)
    bytes     data[length]
    uint32le  masked_crc32c(data)

CRC32C (Castagnoli) is table-driven and reflected, in Python: event
records are small.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator

# reflected Castagnoli polynomial
_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def write_record(f: BinaryIO, data: bytes):
    header = struct.pack("<Q", len(data))
    f.write(header)
    f.write(struct.pack("<I", masked_crc32c(header)))
    f.write(data)
    f.write(struct.pack("<I", masked_crc32c(data)))


def read_records(f: BinaryIO, verify: bool = True) -> Iterator[bytes]:
    while True:
        header = f.read(8)
        if not header:
            return  # clean EOF on a record boundary
        if len(header) < 8:
            raise IOError("corrupt TFRecord: truncated length header")
        (length,) = struct.unpack("<Q", header)
        hcrc_raw = f.read(4)
        if len(hcrc_raw) < 4:
            raise IOError("corrupt TFRecord: truncated length crc")
        (hcrc,) = struct.unpack("<I", hcrc_raw)
        if verify and masked_crc32c(header) != hcrc:
            raise IOError("corrupt TFRecord: bad length crc")
        data = f.read(length)
        if len(data) < length:
            raise IOError("corrupt TFRecord: truncated payload")
        dcrc_raw = f.read(4)
        if len(dcrc_raw) < 4:
            raise IOError("corrupt TFRecord: truncated data crc")
        (dcrc,) = struct.unpack("<I", dcrc_raw)
        if verify and masked_crc32c(data) != dcrc:
            raise IOError("corrupt TFRecord: bad data crc")
        yield data


class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, data: bytes):
        write_record(self._f, data)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecord_file(path: str, verify: bool = True) -> Iterator[bytes]:
    with open(path, "rb") as f:
        yield from read_records(f, verify)
