"""Append-only framed stream log, the durable byte layer of the
streaming data plane (a port of analytics_zoo_tpu/serving/streaming/
log.py; reference: Cluster Serving's Redis-stream ingestion).  The log
is a directory of segment files:

    <dir>/seg-<first_record_id>.log       (appended, then rotated)

Each record is one frame::

    +------ 20-byte header (big-endian) ------+---------+
    | magic u16 | rsvd u16 | id u64 | len u32 | crc u32 | payload |
    +-----------------------------------------+---------+

`crc` is CRC32C (the native host kernel, `analytics_zoo_tpu_torch.
native`) over the header's id and length fields and the payload, so a
bit flip in either is caught.  Record ids are assigned by the log,
contiguous from 1.  The bytes on disk are the JAX package's: a segment
either package writes, the other reads.

Durability: every append is flushed to the OS before its id is returned
(a killed process loses nothing it was told got in); fsync is batched,
every `fsync_every_n` appends or on `sync()`, so `durable_id` says how
far the power-loss horizon has advanced.  Recovery (at open) walks
every frame, checks magic and CRC, and truncates at the first torn
frame: a crash mid-append (or the ``torn_write`` fault action at
``stream.append`` / ``stream.fsync``) costs only the unsynced tail,
never a committed prefix.  Both sites pass ``path`` = the segment
directory, so ``torn_write`` truncates a real segment mid-frame.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.native import crc32c
from analytics_zoo_tpu_torch.resilience.faults import fault_point

#: frame header: magic, reserved, record id, payload length, CRC32C
_HEADER = struct.Struct(">HHQII")
HEADER_SIZE = _HEADER.size
MAGIC = 0x5A4C        # "ZL" — zoo log
_SEG_PREFIX = "seg-"
_SEG_SUFFIX = ".log"


def _frame_crc(record_id: int, payload: bytes) -> int:
    head = struct.pack(">QI", record_id, len(payload))
    return crc32c(payload, crc32c(head))


def encode_frame(record_id: int, payload: bytes) -> bytes:
    """One wire frame (exposed for tests that build torn tails)."""
    return _HEADER.pack(MAGIC, 0, record_id, len(payload),
                        _frame_crc(record_id, payload)) + payload


class StreamLog:
    """Segmented append-only record log with CRC-validated recovery.

    Thread-safe.  `append` returns the record id; `read(id)` returns
    the payload; `drop_through(id)` deletes whole segments whose
    records are all <= id (retention — driven by the consumer groups'
    min durable cursor in stream.py)."""

    def __init__(self, path: str, *, segment_bytes: int = 4 << 20,
                 fsync_every_n: int = 8):
        if segment_bytes < HEADER_SIZE + 1:
            raise ValueError("segment_bytes too small for one frame")
        if fsync_every_n < 1:
            raise ValueError("fsync_every_n must be >= 1")
        self.path = path
        self.segment_bytes = int(segment_bytes)
        self.fsync_every_n = int(fsync_every_n)
        os.makedirs(path, exist_ok=True)
        self._lock = threading.RLock()
        #: record id -> (segment path, payload offset, payload length)
        self._index: Dict[int, Tuple[str, int, int]] = {}
        self._last_id = 0
        self._durable_id = 0
        self._unsynced = 0
        self._torn_frames = 0
        self._fh = None                     # active segment, append mode
        self._active: Optional[str] = None
        self._read_fhs: Dict[str, object] = {}
        self._recover()

    # -- recovery ------------------------------------------------------

    def _segments(self) -> List[str]:
        out = [fn for fn in os.listdir(self.path)
               if fn.startswith(_SEG_PREFIX) and fn.endswith(_SEG_SUFFIX)]
        return sorted(os.path.join(self.path, fn) for fn in out)

    def _recover(self) -> None:
        """Scan every segment, index valid frames, truncate torn tails.
        A torn frame (short header, bad magic, short payload, CRC
        mismatch) ends its segment: the file is repaired by truncation
        and the scan moves to the next segment."""
        for seg in self._segments():
            with open(seg, "rb") as f:
                data = f.read()
            off, good = 0, 0
            while True:
                head = data[off:off + HEADER_SIZE]
                if len(head) < HEADER_SIZE:
                    torn = len(head) > 0
                    break
                magic, _rsvd, rid, length, crc = _HEADER.unpack(head)
                payload = data[off + HEADER_SIZE:
                               off + HEADER_SIZE + length]
                if (magic != MAGIC or len(payload) < length
                        or _frame_crc(rid, payload) != crc):
                    torn = True
                    break
                self._index[rid] = (seg, off + HEADER_SIZE, length)
                self._last_id = max(self._last_id, rid)
                off += HEADER_SIZE + length
                good = off
            if torn:
                self._torn_frames += 1
                with open(seg, "r+b") as f:
                    f.truncate(good)
        # reopen the last segment for append when it still has room
        segs = self._segments()
        if segs and os.path.getsize(segs[-1]) < self.segment_bytes:
            self._active = segs[-1]
            self._fh = open(self._active, "ab")
        # everything that survived recovery is on disk by definition
        self._durable_id = self._last_id

    # -- append path ---------------------------------------------------

    def _rotate(self) -> None:
        if self._fh is not None:
            os.fsync(self._fh.fileno())
            self._fh.close()
        first = self._last_id + 1
        self._active = os.path.join(
            self.path, f"{_SEG_PREFIX}{first:020d}{_SEG_SUFFIX}")
        self._fh = open(self._active, "ab")

    def append(self, payload: bytes) -> int:
        """Durably append one record; returns its id.  The frame is
        flushed to the OS before returning (kill-safe); fsync happens
        every `fsync_every_n` appends (power-safe horizon =
        `durable_id`)."""
        if not isinstance(payload, (bytes, bytearray)):
            raise TypeError("stream payloads are bytes")
        with self._lock:
            fault_point("stream.append", path=self.path,
                        record_id=self._last_id + 1)
            if self._fh is None or \
                    self._fh.tell() >= self.segment_bytes:
                self._rotate()
            rid = self._last_id + 1
            off = self._fh.tell()
            self._fh.write(encode_frame(rid, bytes(payload)))
            self._fh.flush()
            self._index[rid] = (self._active, off + HEADER_SIZE,
                                len(payload))
            self._last_id = rid
            self._unsynced += 1
            if self._unsynced >= self.fsync_every_n:
                self.sync()
            return rid

    def sync(self) -> None:
        """Advance the fsync horizon to the last appended record."""
        with self._lock:
            if self._fh is None or self._unsynced == 0:
                return
            fault_point("stream.fsync", path=self.path,
                        record_id=self._last_id)
            os.fsync(self._fh.fileno())
            self._durable_id = self._last_id
            self._unsynced = 0

    # -- read path -----------------------------------------------------

    def read(self, record_id: int) -> bytes:
        with self._lock:
            seg, off, length = self._index[record_id]
            fh = self._read_fhs.get(seg)
            if fh is None:
                fh = self._read_fhs[seg] = open(seg, "rb")
            fh.seek(off)
            return fh.read(length)

    def __contains__(self, record_id: int) -> bool:
        return record_id in self._index

    def ids(self) -> List[int]:
        with self._lock:
            return sorted(self._index)

    @property
    def last_id(self) -> int:
        return self._last_id

    @property
    def durable_id(self) -> int:
        return self._durable_id

    @property
    def torn_frames(self) -> int:
        """Frames discarded by recovery (counted, never silently)."""
        return self._torn_frames

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    # -- retention -----------------------------------------------------

    def drop_through(self, record_id: int) -> int:
        """Delete whole segments whose every record is <= `record_id`
        (all-groups-durable).  The active segment is never deleted.
        Returns the number of records dropped."""
        dropped = 0
        with self._lock:
            by_seg: Dict[str, List[int]] = {}
            for rid, (seg, _o, _l) in self._index.items():
                by_seg.setdefault(seg, []).append(rid)
            for seg, rids in by_seg.items():
                if seg == self._active or max(rids) > record_id:
                    continue
                fh = self._read_fhs.pop(seg, None)
                if fh is not None:
                    fh.close()
                os.unlink(seg)
                for rid in rids:
                    del self._index[rid]
                dropped += len(rids)
        return dropped

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                if self._unsynced:
                    os.fsync(self._fh.fileno())
                    self._durable_id = self._last_id
                    self._unsynced = 0
                self._fh.close()
                self._fh = None
            for fh in self._read_fhs.values():
                fh.close()
            self._read_fhs.clear()
