"""Per-request lifecycle log (a copy of analytics_zoo_tpu/
observability/request_log.py): the request-scoped half of the
observability planes.

One bounded record per generation request, keyed by its `request_id`
(the id the HTTP layer echoes as `X-Request-Id`), holding a bounded
event timeline:

    enqueue -> admit -> prefill -> first_token -> (sampled decode rounds)
            -> preempt/resume ... -> finish | reject

and, at finish, the latency decomposition continuous-batching
schedulers are judged on:

* **TTFT** — time to first token (`first_token - enqueue`),
* **TPOT** — time per output token after the first
  (`(last_token - first_token) / (n_tokens - 1)`),
* **queue wait** — `admit - enqueue`,
* **e2e** — `finish - enqueue`,

feeding the `request_ttft_seconds` / `request_tpot_seconds` /
`request_queue_wait_seconds` / `request_e2e_seconds` histograms, the
SLO tracker (slo.py) and, through `blame.observe_finished`, the latency
blame plane (blame.py), which decomposes the e2e into an additive phase
ledger from the record's exact `blame` second-accumulators
(`attribute()`).

Round accounting is speculation-exact: `n_rounds` counts every
scheduling round (prefill chunks and decode participations), split into
`n_decode_rounds` (plain rounds and rider lanes of a verify dispatch,
one emitted token each) and `n_spec_rounds` (verify rounds on drafted
lanes, whose emitted tokens count into `n_spec_tokens`).  A cleanly
finished request satisfies ``n_tokens == 1 + n_decode_rounds +
n_spec_tokens`` (the leading 1 is the token prefill emits).

Boundedness: finished records live in a ring of
`OrcaContext.request_log_size` entries; a record stores at most
`MAX_EVENTS_PER_REQUEST` events (overflow is counted, not kept), and
decode rounds are stored at powers of two (rounds 1, 2, 4, 8, ...), so
a long generation stores O(log n) events while the counts stay exact.
Event timestamps are monotone per record, `ttft <= e2e`, and a
preempted-then-resumed request keeps ONE id.

The hot-loop entry points (`event` / `decode_round` / `token` /
`attribute` / `finish`) never raise into the engine.  Timestamps are
taken on the monotonic `observability.now` clock, with one wall-clock
anchor per request at enqueue.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
    now,
)

#: per-record event cap; lifecycle events are few, decode rounds are
#: pow2-sampled, so this is only reached by pathological churn
MAX_EVENTS_PER_REQUEST = 48

#: event kinds that count as a scheduling round (device work on behalf
#: of the request); decode rounds are counted via `decode_round`
_ROUND_KINDS = ("prefill",)

#: blame phases `start(blame_seed=...)` accepts: waits that happened
#: BEFORE this record existed (quota retry loops, replica-death
#: requeue) and must still land inside the e2e decomposition
_SEEDABLE_PHASES = ("quota_throttle", "requeue")


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


def sanitize_request_id(rid: str) -> str:
    """Clamp a client-supplied id to something safe to echo in an HTTP
    header and store as a key: [A-Za-z0-9_.:-], max 64 chars."""
    cleaned = "".join(
        c if c.isalnum() or c in "_.:-" else "_" for c in str(rid))
    return cleaned[:64] or new_request_id()


class RequestRecord:
    """One request's host-side lifecycle state.  Mutated only under the
    owning RequestLog's lock."""

    __slots__ = ("request_id", "prompt_len", "max_new_tokens", "status",
                 "finish_reason", "wall_enqueue", "t_enqueue", "t_admit",
                 "t_first_token", "t_last_token", "t_finish", "n_tokens",
                 "n_rounds", "n_preempts", "events", "n_events_dropped",
                 "model", "tenant", "request_class",
                 # the blame accumulators (the blame plane's)
                 "blame", "replica", "t_paused", "paused_phase",
                 "n_decode_rounds", "n_spec_rounds", "n_spec_tokens",
                 "in_spec_round")

    def __init__(self, request_id: str, prompt_len: int,
                 max_new_tokens: int, model: Optional[str] = None,
                 tenant: Optional[str] = None,
                 request_class: str = "interactive"):
        t = now()
        self.request_id = request_id
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        #: control-plane attribution: the serving "model@version" label,
        #: the quota tenant and the request class (the dimensions JAX's
        #: SLO judge keys on)
        self.model = model
        self.tenant = tenant
        self.request_class = request_class
        self.status = "queued"
        self.finish_reason: Optional[str] = None
        self.wall_enqueue = time.time()   # the one wall anchor
        self.t_enqueue = t
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_last_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self.n_tokens = 0
        self.n_rounds = 0
        self.n_preempts = 0
        self.events: List[Dict[str, Any]] = [
            {"kind": "enqueue", "t": t, "prompt_len": prompt_len}]
        self.n_events_dropped = 0
        #: exact attributed seconds per blame phase, the measured side
        #: of the additive e2e decomposition
        self.blame: Dict[str, float] = {}
        #: router attribution (set by the replica_dispatch event)
        self.replica: Optional[str] = None
        #: open not-running interval (preempt → resume/finish)
        self.t_paused: Optional[float] = None
        self.paused_phase: Optional[str] = None
        #: speculation-exact decode accounting (module docstring)
        self.n_decode_rounds = 0
        self.n_spec_rounds = 0
        self.n_spec_tokens = 0
        self.in_spec_round = False

    # ------------------------------------------------------------------

    def _append(self, kind: str, fields: Dict[str, Any]) -> None:
        if len(self.events) >= MAX_EVENTS_PER_REQUEST:
            self.n_events_dropped += 1
            return
        e: Dict[str, Any] = {"kind": kind, "t": now()}
        e.update(fields)
        self.events.append(e)

    def _wall(self, t: Optional[float]) -> Optional[float]:
        """Monotonic timestamp → wall time via the enqueue anchor."""
        if t is None:
            return None
        return self.wall_enqueue + (t - self.t_enqueue)

    def _attribute(self, phase: str, dur_s: float) -> None:
        self.blame[phase] = (self.blame.get(phase, 0.0)
                             + max(0.0, float(dur_s)))

    def _close_pause(self, t: float) -> None:
        """Fold an open preempt/pause interval into the blame dict."""
        if self.t_paused is None:
            return
        self._attribute(self.paused_phase or "preempted",
                        t - self.t_paused)
        self.t_paused = None
        self.paused_phase = None

    # derived latencies (None until the defining events exist) --------

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_enqueue

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_enqueue

    @property
    def tpot_s(self) -> Optional[float]:
        if self.t_first_token is None or self.n_tokens < 2:
            return None
        return ((self.t_last_token - self.t_first_token)
                / (self.n_tokens - 1))

    @property
    def e2e_s(self) -> Optional[float]:
        if self.t_finish is None:
            return None
        return self.t_finish - self.t_enqueue

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly copy: event timestamps both monotone (`t`, for
        ordering/duration math) and wall (`ts`, for the timeline)."""
        rnd = lambda v: None if v is None else round(v, 6)  # noqa: E731
        return {
            "request_id": self.request_id,
            "status": self.status,
            "finish_reason": self.finish_reason,
            "prompt_len": self.prompt_len,
            "max_new_tokens": self.max_new_tokens,
            "model": self.model,
            "tenant": self.tenant,
            "request_class": self.request_class,
            "replica": self.replica,
            "wall_enqueue": round(self.wall_enqueue, 6),
            "t_enqueue": self.t_enqueue,
            "t_admit": self.t_admit,
            "t_first_token": self.t_first_token,
            "t_last_token": self.t_last_token,
            "t_finish": self.t_finish,
            "n_tokens": self.n_tokens,
            "n_rounds": self.n_rounds,
            "n_decode_rounds": self.n_decode_rounds,
            "n_spec_rounds": self.n_spec_rounds,
            "n_spec_tokens": self.n_spec_tokens,
            "n_preempts": self.n_preempts,
            "n_events_dropped": self.n_events_dropped,
            "queue_wait_s": rnd(self.queue_wait_s),
            "ttft_s": rnd(self.ttft_s),
            "tpot_s": rnd(self.tpot_s),
            "e2e_s": rnd(self.e2e_s),
            "blame": {k: round(v, 6)
                      for k, v in sorted(self.blame.items())},
            "events": [
                dict(e, ts=round(self._wall(e["t"]), 6))
                for e in self.events],
        }


class RequestLog:
    """Bounded request-lifecycle store: active requests in a dict,
    finished ones in a ring of `capacity` records."""

    def __init__(self, capacity: int = 256,
                 registry: Optional[MetricsRegistry] = None):
        self.capacity = capacity
        self._lock = threading.RLock()
        self._active: Dict[str, RequestRecord] = {}
        self._finished: "deque[RequestRecord]" = deque(maxlen=capacity)
        reg = registry if registry is not None else get_registry()
        self._h_ttft = reg.histogram(
            "request_ttft_seconds",
            help="per-request time to first token (enqueue → first "
                 "sampled token)")
        self._h_tpot = reg.histogram(
            "request_tpot_seconds",
            help="per-request time per output token after the first")
        self._h_queue = reg.histogram(
            "request_queue_wait_seconds",
            help="per-request wait from enqueue to first admission")
        self._h_e2e = reg.histogram(
            "request_e2e_seconds",
            help="per-request end-to-end latency (enqueue → finish)")
        self._c_rejected = reg.counter(
            "request_rejected_total",
            help="requests rejected before running (bad input, too "
                 "large, queue full)")
        self._c_dropped = reg.counter(
            "request_events_dropped_total",
            help="per-request lifecycle events dropped by the "
                 "bounded-timeline cap")
        reg.gauge("request_active", fn=lambda: len(self._active),
                  help="requests currently queued or running in the "
                       "lifecycle log")

    # ------------------------------------------------------------------
    # hot-path entry points (never raise)
    # ------------------------------------------------------------------

    def start(self, request_id: Optional[str] = None,
              prompt_len: int = 0, max_new_tokens: int = 0,
              model: Optional[str] = None,
              tenant: Optional[str] = None,
              request_class: str = "interactive",
              blame_seed: Optional[Dict[str, float]] = None) -> str:
        """Create the record at enqueue time; returns the (possibly
        uniquified) request id the engine should carry.  `model` /
        `tenant` / `request_class` attribute the record to the control
        plane's dimensions (SLO judging keys on them at finish).

        `blame_seed` ({phase: seconds} over `_SEEDABLE_PHASES`) records
        wall the request already spent waiting BEFORE this record was
        created — a quota-throttled retry loop, a replica-death
        requeue.  The enqueue anchor is backdated by the seeded total
        so e2e includes that wait, and the seconds land in the blame
        dict so the phase ledger stays additive."""
        rid = (sanitize_request_id(request_id)
               if request_id is not None else new_request_id())
        with self._lock:
            if rid in self._active:   # client-supplied duplicate
                rid = f"{rid}-{new_request_id()[:4]}"
            rec = RequestRecord(
                rid, int(prompt_len), int(max_new_tokens),
                model=model, tenant=tenant,
                request_class=str(request_class))
            if blame_seed:
                seeded = 0.0
                for phase in _SEEDABLE_PHASES:
                    v = float(blame_seed.get(phase, 0.0) or 0.0)
                    if v <= 0.0:
                        continue
                    rec._attribute(phase, v)
                    rec._append(phase, {"seconds": round(v, 6),
                                        "seeded": True})
                    seeded += v
                # backdate the anchors: the request's clock started
                # when the CLIENT's wait did, not at this resubmit.
                # Event timestamps stay untouched (still monotone, and
                # _wall maps them to their true wall moments).
                rec.t_enqueue -= seeded
                rec.wall_enqueue -= seeded
            self._active[rid] = rec
        return rid

    def event(self, request_id: Optional[str], kind: str,
              **fields) -> None:
        """Append one lifecycle event.  `admit` stamps the queue-wait
        boundary (first admission only), `preempt` bumps the preemption
        count and opens a paused interval, `admit`/`resume` close it
        into the blame dict, round-bearing kinds bump `n_rounds`."""
        if request_id is None:
            return
        try:
            with self._lock:
                rec = self._active.get(request_id)
                if rec is None:
                    return
                if kind == "admit" and rec.t_admit is None:
                    rec.t_admit = now()
                    rec.status = "running"
                elif kind == "resume":
                    rec.status = "running"
                elif kind == "preempt":
                    rec.n_preempts += 1
                    rec.status = "preempted"
                    if rec.t_paused is None:
                        rec.t_paused = now()
                        rec.paused_phase = "preempted"
                elif kind == "replica_dispatch":
                    rec.replica = fields.get("replica") or rec.replica
                if kind in ("admit", "resume"):
                    rec._close_pause(now())
                if kind in _ROUND_KINDS:
                    rec.n_rounds += 1
                rec._append(kind, fields)
        except Exception:
            pass

    def decode_round(self, request_id: Optional[str],
                     spec: bool = False) -> None:
        """One decode-step participation.  Counted exactly; stored as
        an event only at power-of-two round numbers (bounded log).

        `spec=True` marks a speculative verify round on a drafted lane
        (counts into `n_spec_rounds`; the tokens the engine emits until
        the next round boundary count into `n_spec_tokens`).  Rider
        lanes and plain decode rounds use the default (one emitted
        token each, counted into `n_decode_rounds`)."""
        if request_id is None:
            return
        try:
            with self._lock:
                rec = self._active.get(request_id)
                if rec is None:
                    return
                rec.n_rounds += 1
                if spec:
                    rec.n_spec_rounds += 1
                else:
                    rec.n_decode_rounds += 1
                rec.in_spec_round = spec
                n = rec.n_rounds
                if n & (n - 1) == 0:   # 1, 2, 4, 8, ...
                    rec._append("decode", {"round": n, "spec": spec})
        except Exception:
            pass

    def token(self, request_id: Optional[str]) -> None:
        """One emitted token: first/last timestamps + exact count (and,
        inside a speculative verify round, the exact spec-token count —
        emission-time counting respects an eos mid-burst)."""
        if request_id is None:
            return
        try:
            with self._lock:
                rec = self._active.get(request_id)
                if rec is None:
                    return
                t = now()
                rec.n_tokens += 1
                if rec.in_spec_round:
                    rec.n_spec_tokens += 1
                rec.t_last_token = t
                if rec.t_first_token is None:
                    rec.t_first_token = t
                    rec._append("first_token", {})
        except Exception:
            pass

    def attribute(self, request_id: Optional[str], phase: str,
                  dur_s: float) -> None:
        """Add `dur_s` seconds of `phase` to the request's blame dict —
        the exact accumulators the phase ledger is derived from (the
        pow2-sampled events are forensic, not the math).  Callers: the
        engine's prefill/decode/verify loops and the host-tier restore
        path."""
        if request_id is None or dur_s <= 0.0:
            return
        try:
            with self._lock:
                rec = self._active.get(request_id)
                if rec is None:
                    return
                rec._attribute(phase, dur_s)
        except Exception:
            pass

    def finish(self, request_id: Optional[str], reason: str) -> None:
        """Close the record: derive latencies, feed the histograms, the
        SLO tracker and the blame plane, move it to the finished
        ring."""
        if request_id is None:
            return
        try:
            with self._lock:
                rec = self._active.pop(request_id, None)
                if rec is None:
                    return
                rec.t_finish = now()
                rec._close_pause(rec.t_finish)
                rec.finish_reason = reason
                rec.status = ("error" if reason.startswith("error")
                              else "finished")
                rec._append("finish", {"reason": reason})
                if rec.n_events_dropped:
                    self._c_dropped.inc(rec.n_events_dropped)
                self._finished.append(rec)
                measures = {
                    "ttft_s": rec.ttft_s,
                    "tpot_s": rec.tpot_s,
                    "queue_wait_s": rec.queue_wait_s,
                    "e2e_s": rec.e2e_s,
                }
                model, tenant = rec.model, rec.tenant
                is_shadow = rec.request_class == "shadow"
                snap = rec.snapshot()
            # metric, SLO and blame work outside the lock: nothing below
            # touches the record again.  Shadow duplicates keep their
            # latency OUT of the primary histograms, SLO window and
            # blame rollup: the shadow tracker judges them under the
            # shadow_ metric prefix
            from analytics_zoo_tpu_torch.observability.slo import (
                get_shadow_slo_tracker,
                get_slo_tracker,
            )
            if is_shadow:
                get_shadow_slo_tracker().observe(
                    measures, model=model, tenant=tenant)
                return
            if measures["ttft_s"] is not None:
                self._h_ttft.record(measures["ttft_s"])
            if measures["tpot_s"] is not None:
                self._h_tpot.record(measures["tpot_s"])
            if measures["queue_wait_s"] is not None:
                self._h_queue.record(measures["queue_wait_s"])
            if measures["e2e_s"] is not None:
                self._h_e2e.record(measures["e2e_s"])
            get_slo_tracker().observe(measures, model=model,
                                      tenant=tenant)
            from analytics_zoo_tpu_torch.observability import blame
            blame.observe_finished(snap)
        except Exception:
            pass

    def reject(self, request_id: Optional[str], code: int,
               reason: str) -> None:
        """A request that never made it into the engine (bad payload,
        too large, queue full): leave a findable rejected record."""
        if request_id is None:
            return
        try:
            with self._lock:
                rec = self._active.pop(request_id, None)
                if rec is None:
                    rec = RequestRecord(request_id, 0, 0)
                rec.t_finish = now()
                rec.status = "rejected"
                rec.finish_reason = reason
                rec._append("reject", {"code": code, "reason": reason})
                self._finished.append(rec)
            self._c_rejected.inc()
        except Exception:
            pass

    # ------------------------------------------------------------------
    # readers
    # ------------------------------------------------------------------

    def get(self, request_id: str) -> Optional[Dict[str, Any]]:
        """Snapshot of one record (active or finished), or None."""
        with self._lock:
            rec = self._active.get(request_id)
            if rec is None:
                for r in reversed(self._finished):
                    if r.request_id == request_id:
                        rec = r
                        break
            return rec.snapshot() if rec is not None else None

    def records(self, n: Optional[int] = None,
                include_active: bool = True) -> List[Dict[str, Any]]:
        """Snapshots, oldest finished first then active; at most `n`."""
        with self._lock:
            recs = list(self._finished)
            if include_active:
                recs += sorted(self._active.values(),
                               key=lambda r: r.t_enqueue)
        if n is not None:
            recs = recs[-int(n):]
        return [r.snapshot() for r in recs]

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def finished_count(self) -> int:
        with self._lock:
            return len(self._finished)


# ----------------------------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[RequestLog] = None


def get_request_log() -> RequestLog:
    """The process-global request log (capacity from
    `OrcaContext.request_log_size`, read at creation)."""
    global _global
    with _global_lock:
        if _global is None:
            from analytics_zoo_tpu_torch.common.context import OrcaContext
            _global = RequestLog(capacity=OrcaContext.request_log_size)
        return _global


def reset_request_log() -> RequestLog:
    """Drop and re-create the global log (tests) against the CURRENT
    global registry and `OrcaContext.request_log_size`."""
    global _global
    with _global_lock:
        _global = None
    return get_request_log()


# module-level conveniences mirroring flight_recorder's style ----------

def start(request_id: Optional[str] = None, prompt_len: int = 0,
          max_new_tokens: int = 0, model: Optional[str] = None,
          tenant: Optional[str] = None,
          request_class: str = "interactive",
          blame_seed: Optional[Dict[str, float]] = None) -> str:
    return get_request_log().start(request_id, prompt_len,
                                   max_new_tokens, model=model,
                                   tenant=tenant,
                                   request_class=request_class,
                                   blame_seed=blame_seed)


def event(request_id: Optional[str], kind: str, **fields) -> None:
    get_request_log().event(request_id, kind, **fields)


def decode_round(request_id: Optional[str], spec: bool = False) -> None:
    get_request_log().decode_round(request_id, spec=spec)


def token(request_id: Optional[str]) -> None:
    get_request_log().token(request_id)


def attribute(request_id: Optional[str], phase: str,
              dur_s: float) -> None:
    get_request_log().attribute(request_id, phase, dur_s)


def finish(request_id: Optional[str], reason: str) -> None:
    get_request_log().finish(request_id, reason)


def reject(request_id: Optional[str], code: int, reason: str) -> None:
    get_request_log().reject(request_id, code, reason)


def get(request_id: str) -> Optional[Dict[str, Any]]:
    return get_request_log().get(request_id)


def records(n: Optional[int] = None,
            include_active: bool = True) -> List[Dict[str, Any]]:
    return get_request_log().records(n, include_active)
