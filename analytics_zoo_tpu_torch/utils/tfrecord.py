"""TFRecord framing in pure Python (a copy of the part of
analytics_zoo_tpu/utils/tfrecord.py that TensorBoard event files need):

    uint64le  length
    uint32le  masked_crc32c(length bytes)
    bytes     data[length]
    uint32le  masked_crc32c(data)

CRC32C (Castagnoli) dispatches to the native slicing-by-8 kernel
(`analytics_zoo_tpu_torch.native`, built with g++ at first use) when it
loads, else runs the table-driven reflected version in Python
(`py_crc32c`), as JAX's utils/tfrecord.py:39-55 does.
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


def py_crc32c(data: bytes, crc: int = 0) -> int:
    """The plain CRC32C: one table step a byte."""
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_native_crc = None
_native_checked = False


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C through the native kernel when its library loads, else
    `py_crc32c`.  Inputs under 4 KiB stay in Python until the library is
    loaded: the first native call may run g++, which must not land in
    the path of a small record."""
    global _native_crc, _native_checked
    if _native_crc is None and len(data) < 4096:
        return py_crc32c(data, crc)
    if not _native_checked:
        _native_checked = True
        from analytics_zoo_tpu_torch import native
        if native.available():
            _native_crc = native.crc32c
    if _native_crc is not None:
        return _native_crc(data, crc)
    return py_crc32c(data, crc)


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
