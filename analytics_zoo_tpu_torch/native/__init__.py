"""Native (C++) host-runtime kernels, loaded with ctypes (a port of
analytics_zoo_tpu/native/).

`zoo_native.cpp` is built at first use with

    g++ -O3 -shared -fPIC -std=c++17 zoo_native.cpp
        -o .kernel_build/libzoo_native-<hash>.so

into `.kernel_build/` at the checkout's root (listed in .gitignore), as
`ops/kernels/_build.py` builds the CUDA sources.  The file name carries
a hash of the source and the flags, so an edited source is rebuilt and
a stale library is never loaded; the compiler writes a temporary file
that `os.replace` installs atomically, so worker processes that start
together and race to build never load half a file.

Every entry point keeps the JAX package's pure-Python fallback for a
host with no `g++`; `available()` says which path runs.

Exports:
  crc32c(data, crc=0)            slicing-by-8 CRC32C
  tfrecord_scan(buf)             validate and index a whole TFRecord file
  csv_to_f32(text, cols, sep)    numeric CSV -> float32 matrix
  available()                    whether the native library loaded
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger("analytics_zoo_tpu_torch")

SRC = Path(__file__).resolve().parent / "zoo_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".kernel_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library is built to: the hash of the source and the
    flags is in its name."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libzoo_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)    # atomic: concurrent builds race safely
    except BaseException:
        os.unlink(tmp)
        raise


def _load() -> Optional[ctypes.CDLL]:
    """Build (once per source hash) and dlopen the library; None when
    there is no toolchain (the Python fallbacks run then)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("native kernels unavailable (%s); using the "
                           "Python fallbacks", e)
            return None
        lib.zoo_crc32c.restype = ctypes.c_uint32
        lib.zoo_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                   ctypes.c_uint32]
        lib.zoo_tfrecord_scan.restype = ctypes.c_int64
        lib.zoo_tfrecord_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64)]
        lib.zoo_csv_to_f32.restype = ctypes.c_int64
        lib.zoo_csv_to_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64)]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (building it now
    if it is not)."""
    return _load() is not None


def crc32c(data: bytes, crc: int = 0) -> int:
    lib = _load()
    if lib is None:
        from analytics_zoo_tpu_torch.utils.tfrecord import py_crc32c
        return py_crc32c(data, crc)
    data = bytes(data)
    return lib.zoo_crc32c(data, len(data), crc)


def tfrecord_scan(buf: bytes) -> List[Tuple[int, int]]:
    """Validate every record's CRCs and return [(offset, length)] into
    `buf`.  Raises IOError on corruption (the Python reader's
    contract)."""
    lib = _load()
    if lib is None:
        return py_tfrecord_scan(buf)
    buf = bytes(buf)
    err = ctypes.c_uint64(0)
    # a counting pass first (max_records=0): an index sized for the worst
    # case up front would cost more memory than the file
    empty = (ctypes.c_uint64 * 1)()
    n = lib.zoo_tfrecord_scan(buf, len(buf), empty, empty, 0,
                              ctypes.byref(err))
    if n < 0:
        raise IOError(f"corrupt TFRecord at byte {err.value}")
    offsets = (ctypes.c_uint64 * max(n, 1))()
    lengths = (ctypes.c_uint64 * max(n, 1))()
    n2 = lib.zoo_tfrecord_scan(buf, len(buf), offsets, lengths, n,
                               ctypes.byref(err))
    if n2 != n:
        raise IOError("TFRecord changed between scan passes")
    return [(offsets[i], lengths[i]) for i in range(n)]


def py_tfrecord_scan(buf: bytes) -> List[Tuple[int, int]]:
    """The plain version of `tfrecord_scan`."""
    import io

    from analytics_zoo_tpu_torch.utils.tfrecord import read_records
    out = []
    pos = 0
    for rec in read_records(io.BytesIO(buf), verify=True):
        out.append((pos + 12, len(rec)))
        pos += 12 + len(rec) + 4
    return out


def py_csv_to_f32(text: bytes, cols: int, sep: bytes = b",",
                  max_rows: Optional[int] = None) -> np.ndarray:
    """The plain version of `csv_to_f32`."""
    if isinstance(text, str):
        text = text.encode()
    if max_rows is None:
        max_rows = text.count(b"\n") + 1
    rows = [r for r in text.decode().splitlines() if r.strip()]
    parsed = []
    for i, r in enumerate(rows[:max_rows]):
        fields = r.split(sep.decode())
        if len(fields) != cols:      # the native kernel's contract
            raise ValueError(f"malformed CSV row {i}: expected {cols} "
                             f"fields, got {len(fields)}")
        parsed.append([float(v) for v in fields])
    return np.asarray(parsed, np.float32).reshape(-1, cols)


def csv_to_f32(text: bytes, cols: int, sep: bytes = b",",
               max_rows: Optional[int] = None) -> np.ndarray:
    """Parse numeric CSV bytes into a [rows, cols] float32 array."""
    if isinstance(text, str):
        text = text.encode()
    lib = _load()
    if lib is None:
        return py_csv_to_f32(text, cols, sep, max_rows)
    if max_rows is None:
        max_rows = text.count(b"\n") + 1
    out = np.empty((max_rows, cols), np.float32)
    err = ctypes.c_uint64(0)
    n = lib.zoo_csv_to_f32(
        text, len(text), sep[0:1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_rows, cols, ctypes.byref(err))
    if n < 0:
        raise ValueError(f"malformed CSV at byte {err.value}")
    return out[:n]


__all__ = ["available", "crc32c", "csv_to_f32", "library_path",
           "py_csv_to_f32", "py_tfrecord_scan", "tfrecord_scan"]
