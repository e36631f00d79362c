"""Tail exemplar forensics (a copy of analytics_zoo_tpu/observability/
exemplars.py): bounded deep captures of the worst requests.

The blame rollup (observability/blame.py) says WHICH phase dominates
the tail; an operator debugging a p99.9 incident then needs one
concrete victim with everything attached.  This module keeps a bounded
store of **exemplars**: for every SLO-violating request — and, filling
the remaining slots, the top-k-slowest — a single JSON document
holding the phase ledger, the full lifecycle record (event tail
included), the span tree slice, the dispatch-ledger slice and the
scheduler decisions that overlapped the request's lifetime.

Capture policy (`consider`, called from `blame.observe_finished` for
every closed record):

* a request that violated any effective SLO target for its
  model/tenant is ALWAYS captured (when the store is full, the
  smallest-e2e non-violating exemplar is evicted first, then the
  smallest-e2e violator);
* otherwise the request is captured while free slots remain, or when
  its e2e exceeds the store's current minimum (classic top-k).

Bounds: at most `OrcaContext.exemplar_count` exemplars live at once,
and each document is JSON-size-bounded to
`OrcaContext.exemplar_max_bytes` by halving its tails (events,
spans, dispatch rows, scheduler rows) until it fits — the same
degrade-don't-die idiom as the telemetry spool.

Crash-safety: the store's `snapshot()` rides in every telemetry-spool
document (replica SIGKILL mid-decode still leaves its exemplars on
disk), the fleet aggregator harvests spooled exemplars into the fleet
/blame view, GET /debug/requests/<id> serves one exemplar, the
timeline export renders each as a per-request waterfall (pid 9), and
flight bundles embed the store.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.observability.registry import get_registry

#: hard floor for the byte bound — below this even a bare ledger
#: cannot be represented honestly
_MIN_BYTES = 2048


def _knobs() -> Dict[str, int]:
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    return {"count": int(OrcaContext.exemplar_count),
            "max_bytes": max(_MIN_BYTES,
                             int(OrcaContext.exemplar_max_bytes))}


def _slo_violations(snap: Dict[str, Any]) -> List[str]:
    """Dimensions whose measured latency exceeded the effective SLO
    target for this record's model/tenant (empty when unconfigured)."""
    try:
        from analytics_zoo_tpu_torch.observability.slo import get_slo_tracker
        targets = get_slo_tracker().effective_targets(
            model=snap.get("model"), tenant=snap.get("tenant"))
    except Exception:
        return []
    out = []
    for dim, target in targets.items():
        v = snap.get(dim)
        if v is not None and target is not None and v > float(target):
            out.append(dim)
    return sorted(out)


def _span_slice(snap: Dict[str, Any], n: int = 16) -> List[Dict[str, Any]]:
    """Completed spans belonging to this request: matched by the
    request_id attr first, then wall-window overlap, newest first."""
    try:
        from analytics_zoo_tpu_torch.observability.tracing import recent_spans
        spans = recent_spans(512)
    except Exception:
        return []
    rid = snap.get("request_id")
    w0 = snap.get("wall_enqueue") or 0.0
    w1 = w0 + (snap.get("e2e_s") or 0.0)
    mine, overlapping = [], []
    for s in spans:
        if (s.get("attrs") or {}).get("request_id") == rid:
            mine.append(s)
        else:
            ts = s.get("start_ts") or 0.0
            dur = s.get("duration_s") or 0.0
            if ts <= w1 and ts + dur >= w0:
                overlapping.append(s)
    return (mine + overlapping)[:n]


def _dispatch_slice(snap: Dict[str, Any], n: int = 64
                    ) -> List[Dict[str, Any]]:
    """Dispatch-ledger calls inside the request's wall window — what
    the device was actually running while this request waited/ran."""
    try:
        from analytics_zoo_tpu_torch.observability import profiling
        calls = profiling.recent_calls()
    except Exception:
        return []
    w0 = snap.get("wall_enqueue") or 0.0
    w1 = w0 + (snap.get("e2e_s") or 0.0)
    rows = [{"family": fam, "ts": round(ts, 6),
             "dur_s": round(dur, 6), "tokens": tok}
            for fam, ts, dur, tok in calls
            if w0 <= ts <= w1 + 1e-6]
    return rows[-n:]


def _sched_slice(snap: Dict[str, Any], n: int = 32
                 ) -> List[Dict[str, Any]]:
    """Flight-ring scheduler decisions (sched_*) inside the request's
    wall window — why lanes filled/emptied around this request."""
    try:
        from analytics_zoo_tpu_torch.observability import flight_recorder
        ring = flight_recorder.ring_contents()
    except Exception:
        return []
    w0 = snap.get("wall_enqueue") or 0.0
    w1 = w0 + (snap.get("e2e_s") or 0.0)
    rows = [e for e in ring
            if str(e.get("kind", "")).startswith("sched_")
            and w0 <= (e.get("ts") or 0.0) <= w1 + 1e-6]
    return rows[-n:]


def _bounded(doc: Dict[str, Any], max_bytes: int) -> Dict[str, Any]:
    """Halve the document's tails until its JSON fits `max_bytes` —
    keep the newest half of each list (the interesting end), never
    drop the ledger itself."""
    def size(d: Dict[str, Any]) -> int:
        return len(json.dumps(d, default=str).encode("utf-8"))

    tails = ("spans", "dispatch", "sched")
    for _ in range(24):
        if size(doc) <= max_bytes:
            return doc
        shrunk = False
        for key in tails:
            lst = doc.get(key)
            if isinstance(lst, list) and len(lst) > 1:
                doc[key] = lst[-(len(lst) // 2):]
                shrunk = True
        rec = doc.get("record")
        if isinstance(rec, dict):
            ev = rec.get("events")
            if isinstance(ev, list) and len(ev) > 2:
                rec["events"] = ev[:1] + ev[-(len(ev) // 2):]
                shrunk = True
        if not shrunk:
            for key in tails:
                doc[key] = []
            rec = doc.get("record")
            if isinstance(rec, dict):
                rec["events"] = []
            doc["truncated"] = True
            return doc
    doc["truncated"] = True
    return doc


class ExemplarStore:
    """Bounded per-process store of tail exemplars, keyed by
    request_id."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_id: Dict[str, Dict[str, Any]] = {}
        reg = get_registry()
        self._c_captured = reg.counter(
            "exemplars_captured_total",
            help="tail exemplars captured (SLO violations + "
                 "top-k-slowest)")
        self._c_evicted = reg.counter(
            "exemplars_evicted_total",
            help="exemplars evicted to make room for worse requests")
        reg.gauge("exemplars_held", fn=lambda: len(self._by_id),
                  help="exemplars currently held in the bounded store")

    # ------------------------------------------------------------------

    def consider(self, ledger: Dict[str, Any],
                 snap: Dict[str, Any]) -> bool:
        """Offer one closed request; returns True when captured.
        Called from blame.observe_finished — must never raise."""
        try:
            knobs = _knobs()
            cap = knobs["count"]
            if cap <= 0:
                return False
            violations = _slo_violations(snap)
            e2e = float(ledger.get("e2e_s") or 0.0)
            evicted = False
            with self._lock:
                if len(self._by_id) >= cap:
                    victim = self._eviction_victim(bool(violations), e2e)
                    if victim is None:
                        return False
                    del self._by_id[victim]
                    evicted = True
            doc = _bounded({
                "request_id": snap.get("request_id"),
                "reason": ("slo_violation" if violations else "slowest"),
                "violations": violations,
                "captured_wall_ts": round(
                    (snap.get("wall_enqueue") or 0.0)
                    + (snap.get("e2e_s") or 0.0), 6),
                "ledger": ledger,
                "record": snap,
                "spans": _span_slice(snap),
                "dispatch": _dispatch_slice(snap),
                "sched": _sched_slice(snap),
            }, knobs["max_bytes"])
            with self._lock:
                self._by_id[str(snap.get("request_id"))] = doc
            self._c_captured.inc()
            if evicted:
                self._c_evicted.inc()
            return True
        except Exception:
            return False

    def _eviction_victim(self, incoming_violates: bool,
                         incoming_e2e: float) -> Optional[str]:
        """Under the lock: pick who leaves (None = drop the incoming).
        Non-violating exemplars go before violators; within a class the
        smallest e2e goes first; the incoming request must beat its
        victim's e2e unless it is a violator displacing a
        non-violator."""
        def e2e_of(d: Dict[str, Any]) -> float:
            return float((d.get("ledger") or {}).get("e2e_s") or 0.0)

        non_viol = [(e2e_of(d), rid) for rid, d in self._by_id.items()
                    if d.get("reason") != "slo_violation"]
        viol = [(e2e_of(d), rid) for rid, d in self._by_id.items()
                if d.get("reason") == "slo_violation"]
        if incoming_violates:
            if non_viol:
                return min(non_viol)[1]
            if viol and min(viol)[0] < incoming_e2e:
                return min(viol)[1]
            return None
        if non_viol and min(non_viol)[0] < incoming_e2e:
            return min(non_viol)[1]
        return None

    # readers ----------------------------------------------------------

    def get(self, request_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            doc = self._by_id.get(str(request_id))
            return dict(doc) if doc is not None else None

    def ids(self) -> List[str]:
        """Held request ids, slowest first."""
        with self._lock:
            items = list(self._by_id.items())
        items.sort(key=lambda kv: -float(
            (kv[1].get("ledger") or {}).get("e2e_s") or 0.0))
        return [rid for rid, _d in items]

    def snapshot(self) -> List[Dict[str, Any]]:
        """All held exemplars, slowest first — the spool/flight-bundle
        payload."""
        with self._lock:
            docs = list(self._by_id.values())
        return sorted(docs, key=lambda d: -float(
            (d.get("ledger") or {}).get("e2e_s") or 0.0))

    def index(self) -> Dict[str, Any]:
        """The GET /debug/requests index body: one summary row per
        exemplar, slowest first."""
        rows = []
        for d in self.snapshot():
            led = d.get("ledger") or {}
            rows.append({
                "request_id": d.get("request_id"),
                "reason": d.get("reason"),
                "violations": d.get("violations"),
                "e2e_s": led.get("e2e_s"),
                "model": led.get("model"),
                "tenant": led.get("tenant"),
                "replica": led.get("replica"),
                "dominant_phase": max(
                    (led.get("phases") or {"": 0.0}).items(),
                    key=lambda kv: kv[1])[0] or None,
            })
        return {"count": len(rows), "exemplars": rows}

    def count(self) -> int:
        with self._lock:
            return len(self._by_id)

    def reset(self) -> None:
        with self._lock:
            self._by_id.clear()


# ----------------------------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[ExemplarStore] = None


def get_exemplar_store() -> ExemplarStore:
    """The process-global exemplar store."""
    global _global
    with _global_lock:
        if _global is None:
            _global = ExemplarStore()
        return _global


def reset_exemplar_store() -> ExemplarStore:
    """Drop and re-create the global store (tests) against the CURRENT
    global registry."""
    global _global
    with _global_lock:
        _global = None
    return get_exemplar_store()
