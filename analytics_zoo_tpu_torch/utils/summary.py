"""TensorBoard event files, pure Python (a copy of
analytics_zoo_tpu/utils/summary.py).

An event file is TFRecord framing (utils/tfrecord.py) around Event
protos; only three fields matter for scalar summaries:

    Event   { double wall_time=1; int64 step=2;
              string file_version=3; Summary summary=5; }
    Summary { repeated Value value=1; }
    Value   { string tag=1; float simple_value=2; }

Files written here open in TensorBoard; `load_scalars` reads them back.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.utils.tf_example import (
    _len_delim,
    _tag,
    _varint,
    to_signed as _signed,
    walk_fields as _walk,
)
from analytics_zoo_tpu_torch.utils.tfrecord import (
    TFRecordWriter,
    read_tfrecord_file,
)


def _encode_event(wall_time: float, step: Optional[int] = None,
                  file_version: Optional[str] = None,
                  scalars: Optional[Dict[str, float]] = None) -> bytes:
    out = _tag(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _tag(2, 0) + _varint(int(step) & (2**64 - 1))
    if file_version is not None:
        out += _len_delim(3, file_version.encode())
    if scalars:
        summary = b""
        for tag_name, value in scalars.items():
            val = (_len_delim(1, tag_name.encode())
                   + _tag(2, 5) + struct.pack("<f", float(value)))
            summary += _len_delim(1, val)
        out += _len_delim(5, summary)
    return out


class SummaryWriter:
    """Append-only scalar event writer for one run directory."""

    _seq = 0

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        # pid + per-process sequence keep two writers in the same second
        # from truncating each other's file
        SummaryWriter._seq += 1
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}"
                 f".{SummaryWriter._seq}")
        self.path = os.path.join(logdir, fname)
        self._w = TFRecordWriter(self.path)
        self._w.write(_encode_event(time.time(),
                                    file_version="brain.Event:2"))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None):
        self.add_scalars({tag: value}, step, wall_time)

    def add_scalars(self, scalars: Dict[str, float], step: int,
                    wall_time: Optional[float] = None):
        self._w.write(_encode_event(wall_time or time.time(),
                                    step=step, scalars=scalars))
        self._w.flush()

    def close(self):
        self._w.close()


def load_scalars(logdir: str) -> Dict[str, List[Tuple[int, float, float]]]:
    """{tag: [(step, wall_time, value), ...]} over every event file in
    `logdir`."""
    out: Dict[str, List[Tuple[int, float, float]]] = {}
    for fname in sorted(os.listdir(logdir)):
        if "tfevents" not in fname:
            continue
        for rec in read_tfrecord_file(os.path.join(logdir, fname)):
            wall, step, summary = 0.0, 0, None
            for fnum, wire, v in _walk(rec):
                if fnum == 1:
                    wall = struct.unpack("<d", v)[0]
                elif fnum == 2:
                    step = _signed(v)
                elif fnum == 5:
                    summary = v
            if summary is None:
                continue
            for fnum, _, val in _walk(summary):
                if fnum != 1:
                    continue
                tag_name, simple = None, None
                for f2, w2, v2 in _walk(val):
                    if f2 == 1:
                        tag_name = v2.decode()
                    elif f2 == 2 and w2 == 5:
                        simple = struct.unpack("<f", v2)[0]
                if tag_name is not None and simple is not None:
                    out.setdefault(tag_name, []).append(
                        (step, wall, simple))
    return out
