"""Latency blame plane (a copy of analytics_zoo_tpu/observability/
blame.py): per-request critical-path attribution.

The lifecycle log (request_log.py) records *what* happened to a
request; this module answers *why its e2e was what it was*: every
finished request's end-to-end latency is decomposed into an additive
**phase ledger** — seconds attributed to each of the `PHASES` below,
summing to e2e within `OrcaContext.blame_tolerance` (the goodput-style
invariant: nothing hides, the residual is itself a named phase).  The
fleet question ("what dominates our p99.9 — queueing or compute?") is
answered by the rolling **blame rollup**: per-phase latency shares and
per-request-phase-seconds percentiles, sliced by model/tenant/replica,
served at GET /blame, summarized in /stats, merged across processes by
`FleetAggregator.fleet_blame` (the `blame_*_seconds_total` counters
sum exactly) and sampled into the metrics history recorder so a
future autoscaler can read blame from a recorded trace.

How the ledger is derived: the engine/scheduler/router attribute
*exact accumulated seconds* onto the request record as work happens
(`request_log.attribute` — per prefill chunk, per decode round a lane
participated in, per host-tier restore, per verify round split into
its useful and overhead fractions), and the record's timestamps
partition the remaining wall:

* ``queue_wait``        — enqueue → first admission, minus any seeded
  quota/requeue wait;
* ``quota_throttle``    — pre-admission wall spent throttled by a
  tenant quota (seeded via ``blame_seed`` at submit by retrying
  callers, e.g. the durable-stream consumer);
* ``prefill_compute``   — summed per-chunk prefill walls;
* ``decode_active``     — summed decode-round walls the lane rode
  (incl. the accepted fraction of verify rounds);
* ``spec_verify_overhead`` — the rejected-draft fraction of verify
  round walls (`(k - accepted) / (k + 1)` of each round);
* ``host_restore``      — host-tier KV restore walls for this
  request's blocks (restores run inside admission / resume, so their
  wall is carved out of ``queue_wait`` / ``preempted``, never the
  running window);
* ``preempted``         — preempt → resume gaps (exact, from the
  record's pause bookkeeping — not the pow2-sampled events);
* ``requeue``           — replica-death requeue gap (seeded by the
  router when it re-places a casualty);
* ``decode_blocked_on_batch`` — the residual of the post-admission
  wall: admitted but waiting on co-batched work (other lanes'
  prefills, scheduling overhead).

Additivity is by construction: the first eight phases are measured,
the ninth is the clamped residual; the ledger flags `additive_ok =
False` (and `blame_additivity_violations_total` ticks) only when
attributed compute exceeds the observed running wall by more than the
tolerance — which is exactly the "blame math is wrong" signal.

`EVENT_PHASE_MAP` maps every request-log event kind into exactly one
ledger phase (boundary markers map to the phase they open or close); the port's tests keep it, the kinds the port emits and
the phases its serving code attributes inside `PHASES`, which equals
the JAX package's.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
    nearest_rank,
)

#: the additive decomposition of one request's e2e, in waterfall order
PHASES = (
    "queue_wait",
    "quota_throttle",
    "requeue",
    "prefill_compute",
    "host_restore",
    "decode_active",
    "spec_verify_overhead",
    "preempted",
    "decode_blocked_on_batch",
)

#: every request-log event kind → the ONE ledger phase it belongs to.
#: Duration-bearing kinds (prefill, host_restore, quota_throttle,
#: requeue) attribute directly; boundary markers map to the phase they
#: open or close (enqueue/admit bound queue_wait, preempt/resume bound
#: preempted, finish/evicted/stream_error close the active decode
#: window, reject/stuck end a wait that never ran).  The JAX
#: package's map, router and stream kinds included.
EVENT_PHASE_MAP: Dict[str, str] = {
    "enqueue": "queue_wait",
    "admit": "queue_wait",
    "replica_dispatch": "queue_wait",
    "reject": "queue_wait",
    "stuck": "queue_wait",
    "quota_throttle": "quota_throttle",
    "requeue": "requeue",
    "prefill": "prefill_compute",
    "prefix_hit": "prefill_compute",
    "first_token": "prefill_compute",
    "host_restore": "host_restore",
    "decode": "decode_active",
    "finish": "decode_active",
    "evicted": "decode_active",
    "stream_error": "decode_active",
    "spec_propose": "spec_verify_overhead",
    "spec_accept": "spec_verify_overhead",
    "preempt": "preempted",
    "resume": "preempted",
    # stream-delivery lifecycle markers on `strm-*` pseudo-requests
    # (serving/streaming/): enqueue/lease sit in the delivery queue,
    # ack closes the active window like finish does
    "stream_enqueue": "queue_wait",
    "stream_lease": "queue_wait",
    "stream_ack": "decode_active",
}

#: rolling rollup window (finished requests)
DEFAULT_WINDOW = 512

#: absolute additivity slack for sub-millisecond e2e (a relative
#: tolerance alone is meaningless at that scale)
_ABS_SLACK_S = 1e-4


def _tolerance() -> float:
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    return OrcaContext.blame_tolerance


def phase_ledger(snap: Dict[str, Any],
                 tolerance: Optional[float] = None) -> Dict[str, Any]:
    """Derive one finished record snapshot's additive phase ledger.

    Pure function of the snapshot (replay-safe: no clock reads) — the
    same record always yields the same ledger, whether computed live
    at finish or later from a spooled/exemplared copy."""
    tol = _tolerance() if tolerance is None else float(tolerance)
    t_enq = snap.get("t_enqueue")
    t_fin = snap.get("t_finish")
    t_adm = snap.get("t_admit")
    e2e = (t_fin - t_enq) if (t_fin is not None
                              and t_enq is not None) else 0.0
    acc = dict(snap.get("blame") or {})
    quota = max(0.0, float(acc.get("quota_throttle", 0.0)))
    requeue = max(0.0, float(acc.get("requeue", 0.0)))
    preempted = max(0.0, float(acc.get("preempted", 0.0)))
    prefill = max(0.0, float(acc.get("prefill_compute", 0.0)))
    decode = max(0.0, float(acc.get("decode_active", 0.0)))
    restore = max(0.0, float(acc.get("host_restore", 0.0)))
    spec = max(0.0, float(acc.get("spec_verify_overhead", 0.0)))
    wait_end = t_adm if t_adm is not None else t_fin
    pre_admit = (max(0.0, wait_end - t_enq)
                 if (wait_end is not None and t_enq is not None)
                 else 0.0)
    # the seeded waits happened before admission; clamp them into the
    # pre-admission window so a bogus seed cannot push queue_wait < 0
    quota = min(quota, pre_admit)
    requeue = min(requeue, max(0.0, pre_admit - quota))
    # host-tier restore walls accrue inside scheduler.admit() BEFORE
    # the admit stamp (fresh admissions) or inside the preempt→resume
    # gap (resumed lanes), so they belong to the pre-running windows:
    # carve them out of queue_wait / preempted rather than counting
    # them against the running wall, which would double-charge the
    # restore seconds and trip the additivity flag whenever the
    # restore wall exceeds the blocked residual (a window's first
    # restore may pay a cold dispatch on a loaded host).  Any remainder that fits neither window is a
    # genuine over-attribution and stays in the running comparison.
    restore_pre = min(restore, max(0.0, pre_admit - quota - requeue))
    restore_gap = min(restore - restore_pre, preempted)
    queue_wait = max(0.0, pre_admit - quota - requeue - restore_pre)
    running = max(0.0, e2e - pre_admit - preempted)
    attributed = (prefill + decode + spec
                  + (restore - restore_pre - restore_gap))
    blocked = max(0.0, running - attributed)
    phases = {
        "queue_wait": queue_wait,
        "quota_throttle": quota,
        "requeue": requeue,
        "prefill_compute": prefill,
        "host_restore": restore,
        "decode_active": decode,
        "spec_verify_overhead": spec,
        "preempted": max(0.0, preempted - restore_gap),
        "decode_blocked_on_batch": blocked,
    }
    total = sum(phases.values())
    slack = max(tol * e2e, _ABS_SLACK_S)
    return {
        "request_id": snap.get("request_id"),
        "status": snap.get("status"),
        "finish_reason": snap.get("finish_reason"),
        "model": snap.get("model"),
        "tenant": snap.get("tenant"),
        "replica": snap.get("replica"),
        "request_class": snap.get("request_class"),
        "e2e_s": round(e2e, 6),
        "total_s": round(total, 6),
        "phases": {p: round(v, 6) for p, v in phases.items()},
        "additive_ok": abs(total - e2e) <= slack,
        "tolerance": tol,
    }


def _phase_stats(entries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-phase share + p50/p99/p99.9 of per-request phase seconds
    over `entries` (each a ledger)."""
    total_e2e = sum(e["e2e_s"] for e in entries) or 0.0
    out: Dict[str, Any] = {}
    for p in PHASES:
        vals = sorted(e["phases"].get(p, 0.0) for e in entries)
        tot = sum(vals)
        out[p] = {
            "share": round(tot / total_e2e, 6) if total_e2e else 0.0,
            "p50": round(nearest_rank(vals, 0.50), 6),
            "p99": round(nearest_rank(vals, 0.99), 6),
            "p999": round(nearest_rank(vals, 0.999), 6),
        }
    return out


class BlameTracker:
    """Rolling-window blame rollup + exact fleet-mergeable counters.

    `observe()` takes one finished request's ledger: the window feeds
    the percentile rollup (and the `blame_queue_share_p99` /
    `blame_tail_phase_code` gauges the alert engine watches);
    the `blame_<phase>_seconds_total` counters accumulate exact
    attributed seconds, so the fleet aggregator's counter sum equals
    the per-replica registries' sum exactly."""

    def __init__(self, window: int = DEFAULT_WINDOW,
                 registry: Optional[MetricsRegistry] = None):
        self.window = int(window)
        self._lock = threading.Lock()
        self._window: "deque[Dict[str, Any]]" = deque(maxlen=window)
        reg = registry if registry is not None else get_registry()
        self._reg = reg
        self._c_requests = reg.counter(
            "blame_requests_total",
            help="finished requests whose phase ledger was derived")
        self._c_violations = reg.counter(
            "blame_additivity_violations_total",
            help="ledgers whose phases failed to sum to e2e within "
                 "OrcaContext.blame_tolerance")
        self._c_phase = {
            p: reg.counter(
                "blame_" + p + "_seconds_total",
                help=f"seconds attributed to the {p} phase, summed "
                     "over finished requests (family "
                     "blame_<phase>_seconds_total; merged exactly "
                     "across the fleet)")
            for p in PHASES}
        reg.gauge(
            "blame_queue_share_p99", fn=self.queue_share_p99,
            help="queue_wait share of the window's p99-slowest "
                 "requests' e2e (the scale-out signal: high = "
                 "queue-dominated tail)")
        reg.gauge(
            "blame_tail_phase_code", fn=self.tail_phase_code,
            help="index into blame.PHASES of the phase dominating the "
                 "p99 tail (-1 before any finished request); the "
                 "blame_shift alert watches this for changes")

    # ------------------------------------------------------------------

    def observe(self, ledger: Dict[str, Any]) -> None:
        with self._lock:
            self._window.append(ledger)
        self._c_requests.inc()
        if not ledger.get("additive_ok", True):
            self._c_violations.inc()
        for p, c in self._c_phase.items():
            v = float(ledger["phases"].get(p, 0.0))
            if v > 0:
                c.inc(v)

    def _entries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._window)

    # gauge callbacks --------------------------------------------------

    def queue_share_p99(self) -> float:
        """queue_wait seconds / e2e seconds over the requests at or
        above the window's p99 e2e (0.0 on an empty window)."""
        entries = self._entries()
        if not entries:
            return 0.0
        e2es = sorted(e["e2e_s"] for e in entries)
        cut = nearest_rank(e2es, 0.99)
        tail = [e for e in entries if e["e2e_s"] >= cut]
        tot = sum(e["e2e_s"] for e in tail)
        if tot <= 0:
            return 0.0
        q = sum(e["phases"].get("queue_wait", 0.0) for e in tail)
        return q / tot

    def tail_phase_code(self) -> float:
        """PHASES index of the phase with the largest total seconds
        over the p99-slowest requests (-1.0 on an empty window)."""
        entries = self._entries()
        if not entries:
            return -1.0
        e2es = sorted(e["e2e_s"] for e in entries)
        cut = nearest_rank(e2es, 0.99)
        tail = [e for e in entries if e["e2e_s"] >= cut]
        totals = [sum(e["phases"].get(p, 0.0) for e in tail)
                  for p in PHASES]
        best = max(range(len(PHASES)), key=lambda i: totals[i])
        return float(best)

    # readers ----------------------------------------------------------

    def rollup(self) -> Dict[str, Any]:
        """The GET /blame payload body: window-wide phase stats plus
        the model/tenant/replica slices."""
        entries = self._entries()
        by_model: Dict[str, List[Dict[str, Any]]] = {}
        by_tenant: Dict[str, List[Dict[str, Any]]] = {}
        by_replica: Dict[str, List[Dict[str, Any]]] = {}
        for e in entries:
            if e.get("model"):
                by_model.setdefault(str(e["model"]), []).append(e)
            if e.get("tenant"):
                by_tenant.setdefault(str(e["tenant"]), []).append(e)
            if e.get("replica"):
                by_replica.setdefault(str(e["replica"]), []).append(e)
        code = self.tail_phase_code()
        return {
            "phases": list(PHASES),
            "window": self.window,
            "requests_in_window": len(entries),
            "requests_total": int(self._c_requests.value),
            "additivity_violations": int(self._c_violations.value),
            "tolerance": _tolerance(),
            "dominant_tail_phase": (PHASES[int(code)]
                                    if code >= 0 else None),
            "queue_share_p99": round(self.queue_share_p99(), 6),
            "rollup": _phase_stats(entries),
            "by_model": {k: _phase_stats(v)
                         for k, v in sorted(by_model.items())},
            "by_tenant": {k: _phase_stats(v)
                          for k, v in sorted(by_tenant.items())},
            "by_replica": {k: _phase_stats(v)
                           for k, v in sorted(by_replica.items())},
        }

    def stats_block(self) -> Dict[str, Any]:
        """The compact /stats block: headline numbers only."""
        r = self.rollup()
        return {
            "requests": r["requests_total"],
            "in_window": r["requests_in_window"],
            "dominant_tail_phase": r["dominant_tail_phase"],
            "queue_share_p99": r["queue_share_p99"],
            "additivity_violations": r["additivity_violations"],
        }

    def reset(self) -> None:
        with self._lock:
            self._window.clear()


# ----------------------------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[BlameTracker] = None


def get_blame_tracker() -> BlameTracker:
    """The process-global blame tracker (created against the current
    global registry on first use)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = BlameTracker()
        return _global


def reset_blame_tracker() -> BlameTracker:
    """Drop and re-create the global tracker (tests) against the
    CURRENT global registry."""
    global _global
    with _global_lock:
        _global = None
    return get_blame_tracker()


def observe_finished(snap: Dict[str, Any]) -> None:
    """Hot-path hook called by `request_log.finish` with the closed
    record's snapshot: derive the ledger, feed the rollup, and offer
    the request to the exemplar store.  Never raises into the engine;
    only successfully finished requests feed the rollup (errors and
    rejects would poison the shares), but every closed record is
    offered as an exemplar candidate."""
    try:
        ledger = phase_ledger(snap)
        if snap.get("status") == "finished":
            get_blame_tracker().observe(ledger)
        from analytics_zoo_tpu_torch.observability.exemplars import (
            get_exemplar_store,
        )
        get_exemplar_store().consider(ledger, snap)
    except Exception:
        pass


def blame_payload() -> Dict[str, Any]:
    """The GET /blame body."""
    return get_blame_tracker().rollup()
