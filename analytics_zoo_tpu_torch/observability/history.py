"""Metrics history plane (a copy of analytics_zoo_tpu/observability/
history.py): durable time-series recording + replay.

Every other signal in the stack is a point-in-time scrape (/metrics,
/stats, fleet harvest) or a post-hoc artifact (timeline, flight
bundle).  This module records metric HISTORY — the substrate "is
attainment degrading", "is the queue growing" and the future
autoscaling controller all stand on (controller decisions must be
deterministic from a recorded trace).

Three pieces:

* `SampleLog` — an append-only CRC32C-framed sample log under
  ``observability_dir/history/<proc>/`` (the stream-log frame idiom
  with its own magic, ``0x5A48`` "ZH"): tmp-less appends flushed
  per sample, batched fsync, recovery truncates at the first torn
  frame.  A SIGKILL'd replica's history survives it — same contract as
  the telemetry spool, but a time SERIES instead of a last snapshot.
  Retention drops oldest whole segments once the per-process directory
  exceeds `OrcaContext.metrics_history_max_bytes`.

* `MetricsRecorder` — samples registries into a bounded in-memory ring
  and (when `observability_dir` is set) the durable log, on the
  `OrcaContext.metrics_history_interval_s` cadence via `maybe_record()`
  hooks in the hot loops, or forced via `sample()` (what
  ``GET /metrics/history`` does).  Each sample also steps the attached
  `AlertEngine` (observability/alerts.py).

* `HistoryReader` — merges per-process sample logs onto one wall clock
  and serves derived series: counter rates (reset-safe), gauge deltas,
  windowed quantile summaries.  All derived-series math in this module
  is a PURE function of the recorded samples — no wall-clock reads —
  so a recorded trace replayed in CI reproduces byte-identical output
  (the replay contract).  Frames are byte-identical to the JAX
  package's, so each package's `HistoryReader` reads the other's logs.

One sample is one JSON object::

    {"ts": <wall s>, "proc": "<name>", "seq": <n>,
     "counters": {name: value}, "gauges": {name: value}}

`ts` is ``time.time()`` wall clock — the ONLY clock in this module,
read at record time only; everything downstream works off sample
timestamps.
"""

from __future__ import annotations

import json
import os
import re
import struct
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

from analytics_zoo_tpu_torch.utils.tfrecord import crc32c
from analytics_zoo_tpu_torch.observability.registry import (
    MetricsRegistry, get_registry, nearest_rank, now)

#: frame header: magic, reserved, sample seq, payload length, CRC32C
_HEADER = struct.Struct(">HHQII")
HEADER_SIZE = _HEADER.size
MAGIC = 0x5A48        # "ZH" — zoo history (streaming log uses "ZL")
_SEG_PREFIX = "hist-"
_SEG_SUFFIX = ".log"
RING_SIZE = 512

_PROC_RE = re.compile(r"[^A-Za-z0-9_.-]")


def _sanitize_proc(proc: str) -> str:
    return _PROC_RE.sub("_", str(proc)) or "proc"


def _frame_crc(seq: int, payload: bytes) -> int:
    head = struct.pack(">QI", seq, len(payload))
    return crc32c(payload, crc32c(head))


def encode_frame(seq: int, payload: bytes) -> bytes:
    """One wire frame (exposed for tests that build torn tails)."""
    return _HEADER.pack(MAGIC, 0, seq, len(payload),
                        _frame_crc(seq, payload)) + payload


class SampleLog:
    """Segmented append-only sample log with CRC-validated recovery.

    Append durability: every frame is flushed to the OS before
    `append` returns (a SIGKILL loses nothing already recorded);
    fsync is batched every `fsync_every_n` appends, so power-loss
    durability is bounded, not per-sample.  Retention is by whole
    oldest segments once the directory exceeds `max_bytes` — the
    append path never rewrites committed bytes."""

    def __init__(self, path: str, *, segment_bytes: int = 256 << 10,
                 max_bytes: Optional[int] = None,
                 fsync_every_n: int = 16):
        if segment_bytes < HEADER_SIZE + 1:
            raise ValueError("segment_bytes too small for one frame")
        self.path = path
        self.segment_bytes = int(segment_bytes)
        self.max_bytes = max_bytes
        self.fsync_every_n = max(1, int(fsync_every_n))
        os.makedirs(path, exist_ok=True)
        self._lock = threading.RLock()
        self._last_seq = 0
        self._unsynced = 0
        self._torn_frames = 0
        self._dropped_segments = 0
        self._fh = None
        self._active: Optional[str] = None
        self._recover()

    # -- recovery ------------------------------------------------------

    def _segments(self) -> List[str]:
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        out = [fn for fn in names
               if fn.startswith(_SEG_PREFIX) and fn.endswith(_SEG_SUFFIX)]
        return sorted(os.path.join(self.path, fn) for fn in out)

    def _recover(self) -> None:
        """Scan every segment; truncate each at its first torn frame
        (short header, bad magic, short payload, CRC mismatch)."""
        for seg in self._segments():
            with open(seg, "rb") as f:
                data = f.read()
            off, good, torn = 0, 0, False
            while True:
                head = data[off:off + HEADER_SIZE]
                if len(head) < HEADER_SIZE:
                    torn = len(head) > 0
                    break
                magic, _rsvd, seq, length, crc = _HEADER.unpack(head)
                payload = data[off + HEADER_SIZE:
                               off + HEADER_SIZE + length]
                if (magic != MAGIC or len(payload) < length
                        or _frame_crc(seq, payload) != crc):
                    torn = True
                    break
                self._last_seq = max(self._last_seq, seq)
                off += HEADER_SIZE + length
                good = off
            if torn:
                self._torn_frames += 1
                with open(seg, "r+b") as f:
                    f.truncate(good)
        segs = self._segments()
        if segs and os.path.getsize(segs[-1]) < self.segment_bytes:
            self._active = segs[-1]
            self._fh = open(self._active, "ab")

    # -- append --------------------------------------------------------

    def _rotate_locked(self) -> None:
        if self._fh is not None:
            os.fsync(self._fh.fileno())
            self._fh.close()
        first = self._last_seq + 1
        self._active = os.path.join(
            self.path, f"{_SEG_PREFIX}{first:020d}{_SEG_SUFFIX}")
        self._fh = open(self._active, "ab")
        self._retain_locked()

    def _retain_locked(self) -> None:
        segs = self._segments()
        if self.max_bytes is None or len(segs) < 2:
            return
        sizes = {s: os.path.getsize(s) for s in segs}
        total = sum(sizes.values())
        for seg in segs[:-1]:          # never the active segment
            if total <= self.max_bytes:
                break
            try:
                os.unlink(seg)
            except OSError:
                break
            total -= sizes[seg]
            self._dropped_segments += 1

    def append(self, payload: bytes) -> int:
        """Append one frame; returns its sequence number.  The frame
        is flushed (not necessarily fsynced) before returning."""
        with self._lock:
            if (self._fh is None
                    or self._fh.tell() + HEADER_SIZE + len(payload)
                    > self.segment_bytes):
                self._rotate_locked()
            seq = self._last_seq + 1
            self._fh.write(encode_frame(seq, payload))
            self._fh.flush()
            self._last_seq = seq
            self._unsynced += 1
            if self._unsynced >= self.fsync_every_n:
                os.fsync(self._fh.fileno())
                self._unsynced = 0
            return seq

    def sync(self) -> None:
        with self._lock:
            if self._fh is not None:
                os.fsync(self._fh.fileno())
                self._unsynced = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None

    def size_bytes(self) -> int:
        with self._lock:
            return sum(os.path.getsize(s) for s in self._segments())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"last_seq": self._last_seq,
                    "torn_frames": self._torn_frames,
                    "dropped_segments": self._dropped_segments,
                    "bytes": sum(os.path.getsize(s)
                                 for s in self._segments())}

    @staticmethod
    def read_dir(path: str) -> List[Tuple[int, bytes]]:
        """Read every valid frame under `path` as (seq, payload),
        WITHOUT repairing torn tails (readers may race a live writer;
        a torn tail just ends that segment's scan).  Pure file I/O —
        no clocks."""
        out: List[Tuple[int, bytes]] = []
        try:
            names = os.listdir(path)
        except OSError:
            return out
        segs = sorted(os.path.join(path, fn) for fn in names
                      if fn.startswith(_SEG_PREFIX)
                      and fn.endswith(_SEG_SUFFIX))
        for seg in segs:
            try:
                with open(seg, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            off = 0
            while True:
                head = data[off:off + HEADER_SIZE]
                if len(head) < HEADER_SIZE:
                    break
                magic, _rsvd, seq, length, crc = _HEADER.unpack(head)
                payload = data[off + HEADER_SIZE:
                               off + HEADER_SIZE + length]
                if (magic != MAGIC or len(payload) < length
                        or _frame_crc(seq, payload) != crc):
                    break
                out.append((seq, payload))
                off += HEADER_SIZE + length
        return out


# -- recorder ----------------------------------------------------------


def _encode_sample(sample: Dict[str, Any]) -> bytes:
    return json.dumps(sample, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


class MetricsRecorder:
    """Samples registries into a bounded ring + the durable log.

    `sample()` is the forced path (endpoints, tests); `maybe_sample()`
    is the hot-loop hook, gated on `interval_s` via the sanctioned
    monotonic clock — an unarmed call is one comparison."""

    def __init__(self, proc: Optional[str] = None,
                 registries: Iterable[MetricsRegistry] = (),
                 families: Optional[Tuple[str, ...]] = None,
                 interval_s: Optional[float] = None,
                 ring_size: int = RING_SIZE,
                 base_dir: Optional[str] = None,
                 max_bytes: Optional[int] = None,
                 alerts: Any = None):
        from analytics_zoo_tpu_torch.common.context import OrcaContext
        self.proc = _sanitize_proc(proc if proc is not None
                                   else f"pid{os.getpid()}")
        self.families = families
        if interval_s is None:
            interval_s = OrcaContext.metrics_history_interval_s
        self.interval_s = interval_s
        if base_dir is None:
            base_dir = OrcaContext.observability_dir
        self.alerts = alerts
        self._extra: List[MetricsRegistry] = list(registries)
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=ring_size)
        self._lock = threading.Lock()
        self._last_sample = 0.0
        self._seq = 0
        self._log: Optional[SampleLog] = None
        if base_dir:
            if max_bytes is None:
                max_bytes = OrcaContext.metrics_history_max_bytes
            self._log = SampleLog(
                os.path.join(base_dir, "history", self.proc),
                max_bytes=max_bytes)
            self._seq = self._log._last_seq

    def add_registries(self, registries: Iterable[MetricsRegistry]):
        """Idempotent by identity — hot loops pass their registry on
        every call and only the first registers it."""
        with self._lock:
            for reg in registries:
                if reg is not get_registry() and \
                        all(reg is not r for r in self._extra):
                    self._extra.append(reg)

    def _collect(self) -> Dict[str, Dict[str, float]]:
        """Merged sample across the global registry + extras; first
        wins on a name collision (the merged_prometheus_text rule)."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        with self._lock:
            regs = [get_registry()] + list(self._extra)
        for reg in regs:
            try:
                vals = reg.sample_values(self.families)
            except Exception:
                continue
            for k, v in vals["counters"].items():
                counters.setdefault(k, v)
            for k, v in vals["gauges"].items():
                gauges.setdefault(k, v)
        return {"counters": counters, "gauges": gauges}

    def sample(self, wall_ts: Optional[float] = None) -> Dict[str, Any]:
        """Take one forced sample: ring + durable log + alert step."""
        vals = self._collect()
        ts = time.time() if wall_ts is None else float(wall_ts)
        with self._lock:
            self._seq += 1
            doc = {"ts": round(ts, 6), "proc": self.proc,
                   "seq": self._seq,
                   "counters": vals["counters"],
                   "gauges": vals["gauges"]}
            self._ring.append(doc)
            self._last_sample = now()
        if self._log is not None:
            try:
                self._log.append(_encode_sample(doc))
            except Exception:
                pass       # history must never take the hot loop down
        self._tick_metrics()
        if self.alerts is not None:
            try:
                self.alerts.step(self.tail())
            except Exception:
                pass
        return doc

    def maybe_sample(self) -> bool:
        """Interval-gated sample; False when disarmed or not due."""
        if self.interval_s is None:
            return False
        with self._lock:
            due = now() - self._last_sample >= self.interval_s
        if not due:
            return False
        self.sample()
        return True

    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            samples = list(self._ring)
        return samples if n is None else samples[-n:]

    def _tick_metrics(self) -> None:
        try:
            reg = get_registry()
            reg.counter("metrics_history_samples_total",
                        help="history samples recorded").inc()
            if self._log is not None:
                st = self._log.stats()
                reg.gauge("metrics_history_bytes",
                          help="on-disk sample log size").set(
                              st["bytes"])
                dropped = reg.counter(
                    "metrics_history_dropped_segments_total",
                    help="history segments dropped by retention")
                behind = st["dropped_segments"] - dropped.value
                if behind > 0:
                    dropped.inc(behind)
        except Exception:
            pass

    def close(self) -> None:
        if self._log is not None:
            self._log.close()


# -- reader / derived series (all pure functions of the samples) -------


def decode_samples(frames: Iterable[Tuple[int, bytes]]
                   ) -> List[Dict[str, Any]]:
    out = []
    for _seq, payload in frames:
        try:
            doc = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            continue
        if isinstance(doc, dict) and "ts" in doc:
            out.append(doc)
    return out


def merge_samples(*sample_lists: Iterable[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """Merge per-source sample lists onto one wall clock, dedup by
    (proc, seq) — a live process's ring overlaps its own disk log."""
    seen: set = set()
    merged: List[Dict[str, Any]] = []
    for samples in sample_lists:
        for s in samples:
            key = (s.get("proc"), s.get("seq"))
            if key in seen:
                continue
            seen.add(key)
            merged.append(s)
    merged.sort(key=lambda s: (s.get("ts", 0.0), str(s.get("proc")),
                               s.get("seq", 0)))
    return merged


def _points(samples: List[Dict[str, Any]], name: str, table: str
            ) -> List[Tuple[float, str, float]]:
    out = []
    for s in samples:
        v = s.get(table, {}).get(name)
        if v is not None:
            out.append((s["ts"], s.get("proc", ""), float(v)))
    return out


def series_names(samples: List[Dict[str, Any]],
                 family: Optional[str] = None) -> List[str]:
    names: set = set()
    for s in samples:
        names.update(s.get("counters", {}))
        names.update(s.get("gauges", {}))
    if family:
        names = {n for n in names if n.startswith(family)}
    return sorted(names)


def counter_rate(samples: List[Dict[str, Any]], name: str
                 ) -> List[Dict[str, Any]]:
    """Per-proc consecutive-sample rate (/s).  Counter-reset-safe:
    a decrease (process restart) contributes the new value as the
    delta rather than a negative rate."""
    out: List[Dict[str, Any]] = []
    last: Dict[str, Tuple[float, float]] = {}
    for ts, proc, v in _points(samples, name, "counters"):
        prev = last.get(proc)
        if prev is not None and ts > prev[0]:
            delta = v - prev[1] if v >= prev[1] else v
            out.append({"ts": ts, "proc": proc,
                        "value": round(delta / (ts - prev[0]), 9)})
        last[proc] = (ts, v)
    return out


def gauge_delta(samples: List[Dict[str, Any]], name: str
                ) -> List[Dict[str, Any]]:
    """Per-proc consecutive gauge deltas (signed)."""
    out: List[Dict[str, Any]] = []
    last: Dict[str, float] = {}
    for ts, proc, v in _points(samples, name, "gauges"):
        if proc in last:
            out.append({"ts": ts, "proc": proc,
                        "value": round(v - last[proc], 9)})
        last[proc] = v
    return out


def window_quantiles(samples: List[Dict[str, Any]], name: str,
                     window_s: float) -> List[Dict[str, Any]]:
    """Windowed summaries of a gauge (or counter level), buckets
    anchored at the FIRST sample's ts (not the wall clock — replay
    determinism)."""
    pts = _points(samples, name, "gauges") or \
        _points(samples, name, "counters")
    if not pts or window_s <= 0:
        return []
    t0 = pts[0][0]
    buckets: Dict[int, List[float]] = {}
    for ts, _proc, v in pts:
        buckets.setdefault(int((ts - t0) // window_s), []).append(v)
    out = []
    for idx in sorted(buckets):
        vals = sorted(buckets[idx])
        out.append({
            "ts_start": round(t0 + idx * window_s, 6),
            "ts_end": round(t0 + (idx + 1) * window_s, 6),
            "n": len(vals),
            "min": round(vals[0], 9), "max": round(vals[-1], 9),
            "p50": round(nearest_rank(vals, 0.50), 9),
            "p90": round(nearest_rank(vals, 0.90), 9),
            "p99": round(nearest_rank(vals, 0.99), 9),
        })
    return out


DERIVE_KINDS = ("rate", "delta", "quantiles")


def derive_series(samples: List[Dict[str, Any]], name: str, kind: str,
                  window_s: Optional[float] = None
                  ) -> List[Dict[str, Any]]:
    if kind == "rate":
        return counter_rate(samples, name)
    if kind == "delta":
        return gauge_delta(samples, name)
    if kind == "quantiles":
        return window_quantiles(samples, name, window_s or 10.0)
    raise ValueError(f"unknown derive kind {kind!r}; "
                     f"one of {DERIVE_KINDS}")


def history_payload(samples: List[Dict[str, Any]], *,
                    family: Optional[str] = None,
                    since: Optional[float] = None,
                    derive: Optional[str] = None,
                    window_s: Optional[float] = None,
                    fleet: bool = False,
                    enabled: bool = True) -> Dict[str, Any]:
    """The GET /metrics/history response body — a pure function of
    the samples (the JAX package's schema)."""
    if since is not None:
        samples = [s for s in samples if s.get("ts", 0.0) >= since]
    if family:
        trimmed = []
        for s in samples:
            c = {k: v for k, v in s.get("counters", {}).items()
                 if k.startswith(family)}
            g = {k: v for k, v in s.get("gauges", {}).items()
                 if k.startswith(family)}
            if c or g:
                trimmed.append({"ts": s["ts"], "proc": s.get("proc"),
                                "seq": s.get("seq"),
                                "counters": c, "gauges": g})
        samples = trimmed
    names = series_names(samples, family)
    payload: Dict[str, Any] = {
        "enabled": enabled,
        "fleet": fleet,
        "family": family,
        "since": since,
        "n_samples": len(samples),
        "procs": sorted({str(s.get("proc")) for s in samples}),
        "names": names,
        "samples": samples,
    }
    if derive:
        payload["derive"] = derive
        payload["series"] = {
            n: derive_series(samples, n, derive, window_s)
            for n in names}
    return payload


class HistoryReader:
    """Merges every process's sample log under
    ``<base_dir>/history/`` onto one wall clock.  Read-only and safe
    against live writers (a torn tail ends that segment's scan; it
    never repairs)."""

    def __init__(self, base_dir: Optional[str] = None):
        if base_dir is None:
            from analytics_zoo_tpu_torch.common.context import OrcaContext
            base_dir = OrcaContext.observability_dir
        self.root = os.path.join(base_dir, "history") if base_dir \
            else None

    def procs(self) -> List[str]:
        if not self.root:
            return []
        try:
            return sorted(
                d for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d)))
        except OSError:
            return []

    def read_samples(self, procs: Optional[List[str]] = None,
                     since: Optional[float] = None,
                     family: Optional[str] = None
                     ) -> List[Dict[str, Any]]:
        lists = []
        for proc in (procs if procs is not None else self.procs()):
            frames = SampleLog.read_dir(
                os.path.join(self.root, _sanitize_proc(proc)))
            lists.append(decode_samples(frames))
        merged = merge_samples(*lists)
        if since is not None:
            merged = [s for s in merged if s.get("ts", 0.0) >= since]
        if family:
            merged = [s for s in merged
                      if any(k.startswith(family)
                             for k in s.get("counters", {}))
                      or any(k.startswith(family)
                             for k in s.get("gauges", {}))]
        return merged


# -- process-global recorder ------------------------------------------

_recorder: Optional[MetricsRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder(proc: Optional[str] = None,
                 registries: Iterable[MetricsRegistry] = ()
                 ) -> Optional[MetricsRecorder]:
    """The process recorder, created on first call AFTER the
    `metrics_history_interval_s` knob is set (None while disarmed —
    the unarmed hot-loop cost is one global read)."""
    global _recorder
    rec = _recorder
    if rec is None:
        from analytics_zoo_tpu_torch.common.context import OrcaContext
        if OrcaContext.metrics_history_interval_s is None:
            return None
        with _recorder_lock:
            if _recorder is None:
                from analytics_zoo_tpu_torch.observability.alerts import (
                    AlertEngine, builtin_rules)
                _recorder = MetricsRecorder(
                    proc=proc, alerts=AlertEngine(builtin_rules()))
            rec = _recorder
    if registries:
        rec.add_registries(registries)
    return rec


def maybe_record(registries: Iterable[MetricsRegistry] = ()) -> bool:
    """Hot-loop hook: sample if armed and due.  Never raises."""
    try:
        rec = get_recorder(registries=registries)
        return rec.maybe_sample() if rec is not None else False
    except Exception:
        return False


def reset_recorder() -> None:
    """Drop the process recorder (tests)."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None:
            try:
                _recorder.close()
            except Exception:
                pass
        _recorder = None
