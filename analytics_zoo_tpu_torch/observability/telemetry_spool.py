"""Durable telemetry spooling (a copy of analytics_zoo_tpu/observability/
telemetry_spool.py): a dying worker's last snapshot survives.

Every participating loop (in the port, the generation engine's; in
JAX's package also stream consumers, elastic members and dryrun
children) periodically rewrites ONE file::

    <OrcaContext.observability_dir>/telemetry/<proc>/snapshot.json

containing its metric exposition text, a span-ring tail, a request-log
tail, its SLO snapshot and its tail exemplars (observability/
exemplars.py), plus wall/monotonic clock anchors.  Writes
use the crash-consistent idiom of the checkpoint commit and the
stream group cursor (tmp → flush → fsync → rename), so a SIGKILL at any
instant leaves either the previous or the new *complete* snapshot —
never a torn one.  Retention is exactly one file per process (rename
replaces in place) and the encoded snapshot is bounded by
``OrcaContext.telemetry_spool_max_bytes`` (span/request tails are halved
until it fits; the exposition text is always kept whole).

`FleetAggregator` (observability/fleet.py) harvests these snapshots next
to live registries, which is how a SIGKILL'd worker's counters still sum
into `GET /metrics?fleet=1` and its spans still render in the fleet
timeline.

Spooling is armed only when ``OrcaContext.observability_dir`` is set;
`maybe_spool()` is cheap enough for hot loops when it is not (one
attribute read).
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from analytics_zoo_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
    merged_prometheus_text,
    now,
)

__all__ = [
    "TelemetrySpool",
    "get_spool",
    "maybe_spool",
    "read_snapshots",
    "reset_spools",
    "telemetry_dir",
]

#: span-ring / request-log tail lengths captured per snapshot (before
#: any byte-cap halving)
SPOOL_SPAN_TAIL = 256
SPOOL_REQUEST_TAIL = 64

_PROC_SAFE = re.compile(r"[^A-Za-z0-9_.:-]+")


def _sanitize_proc(proc: str) -> str:
    s = _PROC_SAFE.sub("-", str(proc)).strip("-.")
    return (s or "proc")[:64]


def telemetry_dir(base_dir: Optional[str] = None) -> Optional[str]:
    """``<observability_dir>/telemetry`` (None when spooling is off)."""
    if base_dir is None:
        from analytics_zoo_tpu_torch.common.context import OrcaContext
        base_dir = OrcaContext.observability_dir
    if base_dir is None:
        return None
    return os.path.join(str(base_dir), "telemetry")


class TelemetrySpool:
    """Periodic crash-safe snapshot writer for one process/loop."""

    def __init__(self, proc: str,
                 base_dir: Optional[str] = None,
                 registries: Iterable[MetricsRegistry] = (),
                 interval_s: Optional[float] = None,
                 max_bytes: Optional[int] = None):
        from analytics_zoo_tpu_torch.common.context import OrcaContext
        self.proc = _sanitize_proc(proc)
        tdir = telemetry_dir(base_dir)
        if tdir is None:
            raise ValueError(
                "telemetry spooling needs OrcaContext.observability_dir "
                "(or an explicit base_dir)")
        self.dir = os.path.join(tdir, self.proc)
        self.path = os.path.join(self.dir, "snapshot.json")
        self.registries: Tuple[MetricsRegistry, ...] = tuple(registries)
        self.interval_s = (OrcaContext.telemetry_spool_interval_s
                           if interval_s is None else float(interval_s))
        self.max_bytes = (OrcaContext.telemetry_spool_max_bytes
                          if max_bytes is None else int(max_bytes))
        self.seq = 0
        self._last_write: Optional[float] = None
        self._lock = threading.Lock()
        reg = get_registry()
        self._c_writes = reg.counter(
            "telemetry_spool_writes_total",
            help="spool snapshots committed (tmp->fsync->rename)")
        self._c_errors = reg.counter(
            "telemetry_spool_errors_total",
            help="spool snapshot writes that failed (never raised)")
        self._g_bytes = reg.gauge(
            "telemetry_spool_bytes",
            help="size of the last committed spool snapshot")

    # ------------------------------------------------------------------

    def snapshot_doc(self) -> Dict[str, Any]:
        """The snapshot payload — also the shape `FleetAggregator` uses
        for the LIVE process, so live and spooled sources merge through
        one code path."""
        import time

        from analytics_zoo_tpu_torch.observability import request_log, tracing
        from analytics_zoo_tpu_torch.observability.slo import get_slo_tracker

        from analytics_zoo_tpu_torch.observability.exemplars import (
            get_exemplar_store,
        )

        regs = (get_registry(),) + self.registries
        doc: Dict[str, Any] = {
            "proc": self.proc,
            "pid": os.getpid(),
            "seq": self.seq,
            "wall_ts": time.time(),
            "exposition": merged_prometheus_text(*regs),
            "spans": tracing.recent_spans(SPOOL_SPAN_TAIL),
            "requests": request_log.get_request_log().records(
                SPOOL_REQUEST_TAIL, include_active=True),
            "slo": get_slo_tracker().snapshot(),
            # tail exemplars ride the same crash-safe commit: a
            # SIGKILL'd replica's worst-request forensics survive and
            # merge into the fleet /blame view
            "exemplars": get_exemplar_store().snapshot(),
        }
        return doc

    def _encode_bounded(self, doc: Dict[str, Any]) -> bytes:
        """JSON-encode, halving the span/request/exemplar tails until
        the blob fits ``max_bytes`` (exposition is never trimmed)."""
        while True:
            blob = json.dumps(doc, default=str).encode("utf-8")
            if len(blob) <= self.max_bytes:
                return blob
            spans = doc.get("spans") or []
            reqs = doc.get("requests") or []
            exemplars = doc.get("exemplars") or []
            if not spans and not reqs and not exemplars:
                return blob  # exposition-only floor; kept whole
            doc["spans"] = spans[: len(spans) // 2]
            doc["requests"] = reqs[: len(reqs) // 2]
            # exemplars are sorted slowest-first: halving keeps the
            # worst offenders
            doc["exemplars"] = exemplars[: len(exemplars) // 2]
            doc["truncated"] = True

    def write(self) -> bool:
        """Commit one snapshot now.  Never raises; returns success."""
        with self._lock:
            return self._write_locked()

    def _write_locked(self) -> bool:
        try:
            doc = self.snapshot_doc()
            blob = self._encode_bounded(doc)
            os.makedirs(self.dir, exist_ok=True)
            tmp = f"{self.path}.tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except Exception:
            self._c_errors.inc()
            return False
        self.seq += 1
        self._last_write = now()
        self._c_writes.inc()
        self._g_bytes.set(len(blob))
        return True

    def _due(self) -> bool:
        return (self._last_write is None
                or now() - self._last_write >= self.interval_s)

    def maybe_write(self) -> bool:
        """Time-gated `write` — at most one snapshot per `interval_s`.
        The gate is re-checked UNDER the lock: N threads racing the
        unlocked fast path must collapse to one write per interval,
        not serialize into N redundant commits (each an fsync+rename —
        its race is tested on a fake clock)."""
        if not self._due():
            return False         # cheap unlocked fast path
        with self._lock:
            if not self._due():
                return False
            return self._write_locked()


# ----------------------------------------------------------------------
# Module-level registry of spools, for one-line wiring in hot loops
# ----------------------------------------------------------------------

_spools: Dict[str, TelemetrySpool] = {}
_spools_lock = threading.Lock()


def get_spool(proc: str,
              registries: Iterable[MetricsRegistry] = ()
              ) -> Optional[TelemetrySpool]:
    """The process-wide spool for `proc` (created on first use), or
    None while `OrcaContext.observability_dir` is unset."""
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    if OrcaContext.observability_dir is None:
        return None
    key = _sanitize_proc(proc)
    with _spools_lock:
        sp = _spools.get(key)
        if sp is None:
            sp = TelemetrySpool(proc, registries=registries)
            _spools[key] = sp
        return sp


def maybe_spool(proc: str,
                registries: Iterable[MetricsRegistry] = ()) -> bool:
    """One-line hot-loop hook: snapshot `proc` if spooling is armed and
    the interval elapsed.  Cheap no-op otherwise."""
    sp = get_spool(proc, registries)
    if sp is None:
        return False
    return sp.maybe_write()


def reset_spools() -> None:
    """Forget cached spools (tests, or after re-pointing
    observability_dir)."""
    with _spools_lock:
        _spools.clear()


def read_snapshots(base_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Harvest every `telemetry/<proc>/snapshot.json` under the
    observability dir.  Unreadable/torn files are skipped (the rename
    commit makes torn files impossible from *this* writer, but the dir
    is operator-visible)."""
    tdir = telemetry_dir(base_dir)
    out: List[Dict[str, Any]] = []
    if tdir is None or not os.path.isdir(tdir):
        return out
    for proc in sorted(os.listdir(tdir)):
        path = os.path.join(tdir, proc, "snapshot.json")
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict):
            doc.setdefault("proc", proc)
            out.append(doc)
    return out
