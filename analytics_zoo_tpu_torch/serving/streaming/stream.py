"""Durable stream with crash-replay consumer groups, the queue layer of
the streaming data plane (a port of analytics_zoo_tpu/serving/
streaming/stream.py; reference: Cluster Serving's Redis streams and
consumer groups).  `DurableStream` puts per-group delivery state over
the framed `StreamLog`:

* ``enqueue(payload)`` appends under bounded-buffer backpressure: once
  the slowest group's lag reaches ``max_backlog`` the stream answers
  `StreamBacklogFull` (HTTP 429) with a ``retry_after_s`` from the
  observed ack drain rate, which the server sends as Retry-After.
* ``dequeue(group, consumer)`` leases the oldest deliverable records to
  one consumer until a visibility deadline.  Leases live in memory on
  purpose: a consumer (or the process) that dies lets the deadline lapse
  and the records replay to survivors under the same record id
  (`attempts` counts deliveries).
* ``ack(group, ids)`` durably advances the group's cursor: the group
  file is written tmp -> fsync -> rename, so an ack happened wholly or
  not at all; a late ack (after expiry and replay) and a double ack are
  no-ops.

Every clock read of a lease deadline or an ack time goes through the
stream's `clock` (default `time.monotonic`), which a test can replace;
a long poll (`dequeue`'s `block_s`) waits in real time.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from bisect import bisect_right
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

from analytics_zoo_tpu_torch.observability import get_registry
from analytics_zoo_tpu_torch.resilience.faults import fault_point
from analytics_zoo_tpu_torch.serving.streaming.log import StreamLog

_GROUP_NAME = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")
_STREAM_NAME = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


class StreamBacklogFull(RuntimeError):
    """Enqueue refused: the slowest consumer group's lag reached the
    stream's `max_backlog` bound (HTTP 429 — serving/errors.py).
    Carries `retry_after_s`, the drain-rate estimate of when capacity
    frees up, surfaced as the Retry-After header."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class StreamRecord:
    """One leased delivery: the record id is stable across replays;
    `attempts` is 1 on first delivery and grows per redelivery."""

    __slots__ = ("record_id", "payload", "attempts")

    def __init__(self, record_id: int, payload: bytes, attempts: int):
        self.record_id = record_id
        self.payload = payload
        self.attempts = attempts

    def __repr__(self):
        return (f"StreamRecord(id={self.record_id}, "
                f"attempts={self.attempts}, "
                f"len={len(self.payload)})")


class _Group:
    """Per-group delivery state.  `cursor` (all ids <= it are acked)
    and the out-of-order `acked` set are durable; leases and attempt
    counts are in-memory — losing them IS the replay semantics."""

    __slots__ = ("name", "path", "cursor", "acked", "leases",
                 "attempts", "lag")

    def __init__(self, name: str, path: str):
        self.name = name
        self.path = path
        self.cursor = 0
        self.acked: set = set()
        #: record id -> (consumer, monotonic deadline)
        self.leases: Dict[int, tuple] = {}
        self.attempts: Dict[int, int] = {}
        self.lag = 0                      # unacked records, kept live

    def load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
            self.cursor = int(doc.get("cursor", 0))
            self.acked = {int(x) for x in doc.get("acked", [])}
        except FileNotFoundError:
            pass
        except (OSError, ValueError):
            # a corrupt group file (outside the tmp->rename protocol's
            # threat model) degrades to at-least-once: cursor 0, full
            # replay — never a crash, never silent loss
            self.cursor = 0
            self.acked = set()

    def persist(self) -> None:
        tmp = f"{self.path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"cursor": self.cursor,
                       "acked": sorted(self.acked)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


class DurableStream:
    """File-backed durable queue with consumer groups (module doc)."""

    def __init__(self, path: str, *, name: Optional[str] = None,
                 segment_bytes: int = 4 << 20,
                 fsync_every_n: int = 8,
                 max_backlog: int = 1024,
                 visibility_timeout_s: float = 30.0,
                 retention: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        if max_backlog < 1:
            raise ValueError("max_backlog must be >= 1")
        if visibility_timeout_s <= 0:
            raise ValueError("visibility_timeout_s must be > 0")
        self.path = path
        self.name = name or os.path.basename(os.path.normpath(path))
        self.max_backlog = int(max_backlog)
        self.visibility_timeout_s = float(visibility_timeout_s)
        self.retention = retention
        self._clock = clock or time.monotonic
        self.log = StreamLog(os.path.join(path, "segments"),
                             segment_bytes=segment_bytes,
                             fsync_every_n=fsync_every_n)
        self._groups_dir = os.path.join(path, "groups")
        os.makedirs(self._groups_dir, exist_ok=True)
        self._cond = threading.Condition()
        self._groups: Dict[str, _Group] = {}
        self._ack_times: deque = deque(maxlen=256)
        self._closed = False
        for fn in sorted(os.listdir(self._groups_dir)):
            if fn.endswith(".json"):
                self._group(fn[:-len(".json")])
        reg = get_registry()
        self._c_appends = reg.counter(
            "stream_appends_total",
            help="records appended to durable streams")
        self._c_bytes = reg.counter(
            "stream_append_bytes_total",
            help="payload bytes appended to durable streams")
        self._c_acked = reg.counter(
            "stream_acked_total",
            help="records durably acked by consumer groups")
        self._c_redeliver = reg.counter(
            "stream_redeliveries_total",
            help="records re-leased after a lease expired "
                 "(dead-consumer replay)")
        self._c_backpressure = reg.counter(
            "stream_backpressure_total",
            help="enqueues refused with StreamBacklogFull")

    # -- group plumbing ------------------------------------------------

    def _group(self, name: str) -> _Group:
        if not _GROUP_NAME.match(name or ""):
            raise ValueError(f"bad group name {name!r}")
        g = self._groups.get(name)
        if g is None:
            g = _Group(name, os.path.join(self._groups_dir,
                                          f"{name}.json"))
            g.load()
            g.lag = sum(1 for rid in self.log.ids()
                        if rid > g.cursor and rid not in g.acked)
            self._groups[name] = g
        return g

    # -- enqueue (backpressure) ----------------------------------------

    def backlog(self) -> int:
        """Records the slowest group still has to ack (all retained
        records when no group exists yet — nothing is draining)."""
        with self._cond:
            return self._backlog_locked()

    def _backlog_locked(self) -> int:
        if self._groups:
            return max(g.lag for g in self._groups.values())
        return len(self.log)

    def _drain_retry_after(self, backlog: int) -> float:
        """Retry-After from the observed ack drain rate: how long
        until one slot frees at the current pace, clamped to
        [0.05s, 10s] so a bad estimate cannot park a client."""
        if len(self._ack_times) >= 2:
            span = self._ack_times[-1] - self._ack_times[0]
            if span > 0:
                rate = (len(self._ack_times) - 1) / span
                excess = max(1, backlog - self.max_backlog + 1)
                return min(10.0, max(0.05, excess / rate))
        return 1.0

    def enqueue(self, payload: bytes) -> int:
        """Durably append one record; returns its id.  Raises
        `StreamBacklogFull` (with `retry_after_s`) at the bound."""
        with self._cond:
            if self._closed:
                raise RuntimeError(f"stream {self.name!r} is closed")
            backlog = self._backlog_locked()
            if backlog >= self.max_backlog:
                self._c_backpressure.inc()
                raise StreamBacklogFull(
                    f"stream {self.name!r} backlog {backlog} >= "
                    f"max_backlog {self.max_backlog}",
                    retry_after_s=self._drain_retry_after(backlog))
            rid = self.log.append(bytes(payload))
            for g in self._groups.values():
                g.lag += 1
            self._c_appends.inc()
            self._c_bytes.inc(len(payload))
            self._cond.notify_all()
            return rid

    def sync(self) -> None:
        self.log.sync()

    # -- dequeue (lease) -----------------------------------------------

    def dequeue(self, group: str, consumer: str,
                max_records: int = 1,
                visibility_s: Optional[float] = None,
                block_s: float = 0.0) -> List[StreamRecord]:
        """Lease up to `max_records` of the oldest deliverable records
        to `consumer`, long-polling up to `block_s` when none are
        ready.  A deliverable record is unacked and either never
        leased or past its previous lease's visibility deadline
        (replay — `attempts` grows, the id does not change)."""
        if max_records < 1:
            raise ValueError("max_records must be >= 1")
        vis = (self.visibility_timeout_s if visibility_s is None
               else float(visibility_s))
        deadline = time.monotonic() + max(0.0, block_s)
        with self._cond:
            fault_point("stream.lease", stream=self.name, group=group,
                        consumer=consumer)
            g = self._group(group)
            while True:
                recs = self._claim_locked(g, consumer, max_records, vis)
                if recs:
                    return recs
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    return []
                # bounded wait: a lease can expire with no notify
                self._cond.wait(min(remaining, 0.05))

    def _claim_locked(self, g: _Group, consumer: str, max_records: int,
                      vis: float) -> List[StreamRecord]:
        out: List[StreamRecord] = []
        t = self._clock()
        ids = self.log.ids()
        for rid in ids[bisect_right(ids, g.cursor):]:
            if len(out) >= max_records:
                break
            if rid in g.acked:
                continue
            lease = g.leases.get(rid)
            if lease is not None:
                if lease[1] > t:
                    continue            # held by a live consumer
                self._c_redeliver.inc()
            g.leases[rid] = (consumer, t + vis)
            g.attempts[rid] = g.attempts.get(rid, 0) + 1
            out.append(StreamRecord(rid, self.log.read(rid),
                                    g.attempts[rid]))
        return out

    def release(self, group: str, record_id: int) -> None:
        """Drop a lease early (a consumer declining work) — the record
        becomes immediately deliverable again."""
        with self._cond:
            g = self._group(group)
            g.leases.pop(record_id, None)
            self._cond.notify_all()

    # -- ack -----------------------------------------------------------

    def ack(self, group: str,
            record_ids: Union[int, Iterable[int]]) -> int:
        """Durably ack records for `group`; returns how many were
        NEWLY acked (late/double acks are idempotent no-ops).  The
        group cursor advances over contiguous acked ids — and over
        ids missing from the log (torn-lost or retained away), which
        must not wedge the cursor."""
        if isinstance(record_ids, int):
            record_ids = (record_ids,)
        with self._cond:
            g = self._group(group)
            ids = [int(r) for r in record_ids]
            fault_point("stream.ack", stream=self.name, group=group,
                        record_ids=ids)
            for rid in ids:
                if rid > self.log.last_id:
                    # validate BEFORE mutating anything: a bad id in a
                    # batch must not leave half the batch acked only
                    # in memory
                    raise ValueError(
                        f"ack of unknown record {rid} (last id "
                        f"{self.log.last_id})")
            n_new = 0
            t = self._clock()
            for rid in ids:
                if rid <= g.cursor or rid in g.acked:
                    g.leases.pop(rid, None)
                    continue
                g.acked.add(rid)
                g.leases.pop(rid, None)
                g.attempts.pop(rid, None)
                if rid in self.log:
                    # lag counts unacked records PRESENT in the log; an
                    # ack of an id already retained away (a group
                    # created after retention passed it) must not
                    # underflow it
                    g.lag -= 1
                n_new += 1
                self._ack_times.append(t)
            if n_new:
                while True:
                    nxt = g.cursor + 1
                    if nxt in g.acked:
                        g.acked.discard(nxt)
                    elif nxt <= self.log.last_id and \
                            nxt not in self.log:
                        pass              # lost/retained id: skip over
                    else:
                        break
                    g.cursor = nxt
                g.persist()
                self._c_acked.inc(n_new)
                if self.retention:
                    self._retain_locked()
                self._cond.notify_all()
            return n_new

    def _retain_locked(self) -> None:
        if not self._groups:
            return
        floor = min(g.cursor for g in self._groups.values())
        if floor > 0:
            self.log.drop_through(floor)

    # -- introspection -------------------------------------------------

    def lag(self, group: str) -> int:
        with self._cond:
            return self._group(group).lag

    def stats(self) -> Dict[str, Any]:
        """One /stats row per group plus log-level counters — the
        backlog/lag view an operator pages on (docs/streaming.md)."""
        with self._cond:
            t = self._clock()
            return {
                "last_id": self.log.last_id,
                "durable_id": self.log.durable_id,
                "records_retained": len(self.log),
                "backlog": self._backlog_locked(),
                "max_backlog": self.max_backlog,
                "torn_frames_recovered": self.log.torn_frames,
                "groups": {
                    name: {
                        "cursor": g.cursor,
                        "lag": g.lag,
                        "leased": sum(1 for _c, d in g.leases.values()
                                      if d > t),
                    } for name, g in sorted(self._groups.items())},
            }

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self.log.close()
            self._cond.notify_all()


class StreamHub:
    """Named durable streams under one root directory — what a
    `ServingServer(stream_hub=...)` exposes at ``/streams/<name>/*``.
    Streams are created on first use with the hub's defaults."""

    def __init__(self, root: str, **stream_kwargs):
        self.root = root
        self._kwargs = stream_kwargs
        self._streams: Dict[str, DurableStream] = {}
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)
        for fn in sorted(os.listdir(root)):
            if os.path.isdir(os.path.join(root, fn)):
                self.get(fn)

    def get(self, name: str) -> DurableStream:
        if not _STREAM_NAME.match(name or ""):
            raise ValueError(f"bad stream name {name!r}")
        with self._lock:
            s = self._streams.get(name)
            if s is None:
                s = DurableStream(os.path.join(self.root, name),
                                  name=name, **self._kwargs)
                self._streams[name] = s
            return s

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._streams)

    def total_backlog(self) -> int:
        with self._lock:
            return sum(s.backlog() for s in self._streams.values())

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {name: s.stats()
                    for name, s in sorted(self._streams.items())}

    def close(self) -> None:
        with self._lock:
            for s in self._streams.values():
                s.close()
