"""Chrome-trace-event timeline export (a copy of analytics_zoo_tpu/
observability/timeline.py): everything on one clock.

Debugging an iteration-level scheduler needs a single time axis where
request lifecycles, decode/prefill/train step slices with their
goodput decomposition, flight-ring happenings and memory watermarks
line up.  This module merges the four in-process rings —

* completed spans (observability/tracing.py),
* fenced goodput step slices (observability/goodput.py's timeline
  ring; training steps land here too, so an SPMD fit draws the same
  tracks as serving),
* request lifecycles (observability/request_log.py),
* flight-recorder events and memory samples —

into the Chrome **Trace Event Format** (the JSON the Perfetto UI and
``chrome://tracing`` load directly): ``{"traceEvents": [...]}`` with
``ph: "X"`` complete slices, ``"i"`` instants, ``"C"`` counter tracks
and ``"M"`` metadata naming the pid/tid rows.  Timestamps are wall
time in microseconds; request slices are placed via each record's
single wall anchor so per-request phases stay internally monotone, and
the exporter sorts all events so the stream is globally monotone (the
schema JAX's ``scripts/check_timeline_schema.py`` validates).

Row layout (pids are stable so saved traces diff cleanly):

| pid | track |
|---|---|
| 1 `spans`     | one tid per thread that completed spans |
| 2 `goodput`   | one tid per StepClock (train + generation loops) |
| 3 `requests`  | one tid per request: queued/prefill/decode slices, preempt/resume instants |
| 4 `events`    | flight-ring instants |
| 5 `memory`    | ``memory_bytes`` (host RSS, the card's allocated and reserved bytes) + provider counter tracks |
| 6 `replicas`  | one tid per router replica: dispatch instants (which replica served which request — serving/distributed/router.py) |
| 7 `kv_dma`    | one tid per engine/replica lane: ``host_spill`` / ``host_restore`` X slices for host-tier KV copies (serving/generation/host_tier.py) |
| 8 `dispatch`  | one tid per dispatch-ledger program family: fenced work X slices + ``compile`` instants with the signature diff (observability/profiling.py) |
| 9 `blame`     | one tid per captured tail exemplar: its blame-ledger phases drawn as a sequential waterfall from enqueue (observability/blame.py + exemplars.py) |

Serving: `ServingServer` exposes the export as ``GET /timeline``
(forcing a fresh memory sample first), and every flight-recorder
bundle writes a sibling ``*.trace.json`` — an operator opens a crash's
last seconds in Perfetto directly from the bundle directory.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

PID_SPANS = 1
PID_GOODPUT = 2
PID_REQUESTS = 3
PID_EVENTS = 4
PID_MEMORY = 5
PID_REPLICAS = 6
PID_KV_DMA = 7
PID_DISPATCH = 8
PID_BLAME = 9

_PROCESS_NAMES = {
    PID_SPANS: "spans",
    PID_GOODPUT: "goodput",
    PID_REQUESTS: "requests",
    PID_EVENTS: "events",
    PID_MEMORY: "memory",
    PID_REPLICAS: "replicas",
    PID_KV_DMA: "kv_dma",
    PID_DISPATCH: "dispatch",
    PID_BLAME: "blame",
}

#: total event cap per export — /timeline must stay a bounded payload
MAX_EVENTS = 20_000


def _us(ts_s: float) -> int:
    return int(ts_s * 1e6)


def _meta(pid: int, tid: int, kind: str, name: str) -> Dict[str, Any]:
    return {"ph": "M", "name": kind, "pid": pid, "tid": tid,
            "args": {"name": name}}


def _span_events(spans_n: int) -> (List[Dict[str, Any]],
                                   Dict[int, str]):
    from analytics_zoo_tpu_torch.observability.tracing import recent_spans

    events: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}
    for span in reversed(recent_spans(spans_n)):   # oldest first
        if span.get("duration_s") is None:
            continue
        thread = str(span.get("thread", "?"))
        tid = tids.setdefault(thread, len(tids) + 1)
        args = {k: v for k, v in span.get("attrs", {}).items()}
        args["span_id"] = span.get("span_id")
        if span.get("parent_id"):
            args["parent_id"] = span["parent_id"]
        events.append({
            "ph": "X", "name": span["name"], "cat": "span",
            "pid": PID_SPANS, "tid": tid,
            "ts": _us(span["start_ts"]),
            "dur": max(0, _us(span["duration_s"])),
            "args": args,
        })
    return events, {tid: thread for thread, tid in tids.items()}


def _goodput_events(steps_n: Optional[int]) -> (List[Dict[str, Any]],
                                                Dict[int, str]):
    from analytics_zoo_tpu_torch.observability.goodput import recent_steps

    events: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}
    for step in recent_steps(steps_n):
        clock = step["clock"]
        tid = tids.setdefault(clock, len(tids) + 1)
        args: Dict[str, Any] = dict(step.get("buckets", {}))
        if step.get("cold"):
            args["cold"] = True
        events.append({
            "ph": "X", "name": clock, "cat": "goodput",
            "pid": PID_GOODPUT, "tid": tid,
            "ts": _us(step["ts"]),
            "dur": max(0, _us(step["dur_s"])),
            "args": args,
        })
    return events, {tid: clock for clock, tid in tids.items()}


#: lifecycle kinds drawn as instants on the request row (phase slices
#: cover the rest)
_REQUEST_INSTANTS = ("preempt", "resume", "reject", "stuck",
                     "stream_error")


def _request_events(requests_n: Optional[int]
                    ) -> (List[Dict[str, Any]], Dict[int, str]):
    from analytics_zoo_tpu_torch.observability.request_log import records

    events: List[Dict[str, Any]] = []
    tid_names: Dict[int, str] = {}
    import time as _time
    now_wall = _time.time()
    for i, rec in enumerate(records(requests_n)):
        tid = i + 1
        tid_names[tid] = rec["request_id"]
        anchor_wall = rec["wall_enqueue"]
        anchor_mono = rec["t_enqueue"]

        def wall(t_mono, _aw=anchor_wall, _am=anchor_mono):
            return None if t_mono is None else _aw + (t_mono - _am)

        t_admit = wall(rec["t_admit"])
        t_first = wall(rec["t_first_token"])
        t_finish = wall(rec["t_finish"])
        end = t_finish if t_finish is not None else now_wall
        phases = []
        if t_admit is not None:
            phases.append(("queued", anchor_wall, t_admit))
            phases.append(("prefill", t_admit,
                           t_first if t_first is not None else end))
        else:
            phases.append(("queued", anchor_wall, end))
        if t_first is not None:
            phases.append(("decode", t_first, end))
        args = {"request_id": rec["request_id"],
                "prompt_len": rec["prompt_len"],
                "n_tokens": rec["n_tokens"],
                "n_rounds": rec["n_rounds"],
                "status": rec["status"]}
        if rec.get("finish_reason"):
            args["finish_reason"] = rec["finish_reason"]
        for name, t0, t1 in phases:
            events.append({
                "ph": "X", "name": name, "cat": "request",
                "pid": PID_REQUESTS, "tid": tid,
                "ts": _us(t0), "dur": max(0, _us(t1 - t0)),
                "args": args,
            })
        for e in rec["events"]:
            if e["kind"] not in _REQUEST_INSTANTS:
                continue
            inst_args = {k: v for k, v in e.items()
                         if k not in ("t", "ts")}
            events.append({
                "ph": "i", "name": e["kind"], "cat": "request",
                "pid": PID_REQUESTS, "tid": tid,
                "ts": _us(e["ts"]), "s": "t",
                "args": inst_args,
            })
    return events, tid_names


def _replica_events(requests_n: Optional[int]
                    ) -> (List[Dict[str, Any]], Dict[int, str]):
    """Router dispatch instants regrouped BY REPLICA (pid 6): one row
    per replica shows its admission pattern over time — skewed
    least-loaded routing is visible at a glance next to the
    per-request rows."""
    from analytics_zoo_tpu_torch.observability.request_log import records

    events: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}
    for rec in records(requests_n):
        for e in rec["events"]:
            if e.get("kind") != "replica_dispatch":
                continue
            replica = str(e.get("replica", "?"))
            tid = tids.setdefault(replica, len(tids) + 1)
            events.append({
                "ph": "i", "name": "dispatch", "cat": "replica",
                "pid": PID_REPLICAS, "tid": tid,
                "ts": _us(e["ts"]), "s": "t",
                "args": {"request_id": rec["request_id"],
                         "replica": replica},
            })
    return events, {tid: name for name, tid in tids.items()}


def _kv_dma_events(dma_n: Optional[int]
                   ) -> (List[Dict[str, Any]], Dict[int, str]):
    """Host-tier KV copies (pid 7): one X slice per spill/restore,
    one tid per engine/replica lane — the DMA-hiding story of the
    hierarchical KV cache drawn next to the decode rounds it overlaps
    (serving/generation/host_tier.py's module ring)."""
    from analytics_zoo_tpu_torch.serving.generation.host_tier import (
        dma_events,
    )

    events: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}
    for e in dma_events(dma_n):
        lane = str(e.get("lane", "engine"))
        tid = tids.setdefault(lane, len(tids) + 1)
        dur = float(e.get("dur_s", 0.0))
        events.append({
            "ph": "X", "name": e.get("kind", "host_copy"),
            "cat": "kv_dma", "pid": PID_KV_DMA, "tid": tid,
            "ts": _us(float(e["ts"]) - dur),
            "dur": max(0, _us(dur)),
            "args": {"nbytes": int(e.get("nbytes", 0)),
                     "lane": lane},
        })
    return events, {tid: lane for lane, tid in tids.items()}


def _dispatch_events(calls_n: Optional[int]) -> (List[Dict[str, Any]],
                                                 Dict[int, str]):
    from analytics_zoo_tpu_torch.observability import profiling

    events: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}
    for family, ts, dur, tokens in profiling.recent_calls(calls_n):
        tid = tids.setdefault(family, len(tids) + 1)
        args: Dict[str, Any] = {}
        if tokens:
            args["tokens"] = int(tokens)
        events.append({
            "ph": "X", "name": family, "cat": "dispatch",
            "pid": PID_DISPATCH, "tid": tid,
            "ts": _us(ts - dur), "dur": max(0, _us(dur)),
            "args": args,
        })
    for ev in profiling.compile_events(calls_n):
        family = ev.get("family", "?")
        tid = tids.setdefault(family, len(tids) + 1)
        args = {"n": ev.get("n"), "compile_s": ev.get("compile_s"),
                "callsite": ev.get("callsite", "")}
        diff = ev.get("diff")
        if diff:
            args["diff"] = "; ".join(
                f"{d['path']}: {d['old']} -> {d['new']}"
                for d in diff[:4])
        events.append({
            "ph": "i", "name": "compile", "cat": "dispatch",
            "pid": PID_DISPATCH, "tid": tid,
            "ts": _us(ev.get("ts", 0.0)), "s": "t", "args": args,
        })
    return events, {tid: family for family, tid in tids.items()}


def _blame_events(exemplars_n: Optional[int]
                  ) -> (List[Dict[str, Any]], Dict[int, str]):
    """Per-request blame waterfalls (pid 9): each captured tail
    exemplar gets one row with its ledger phases laid end-to-end from
    the request's wall enqueue.  The phases are *attribution buckets*,
    not re-measured intervals — drawing them sequentially in canonical
    phase order turns the additive decomposition (which sums to e2e by
    contract) into a waterfall whose total width IS the request's e2e,
    directly comparable against the raw pid-3 request slices above."""
    from analytics_zoo_tpu_torch.observability.blame import PHASES
    from analytics_zoo_tpu_torch.observability.exemplars import (
        get_exemplar_store,
    )

    events: List[Dict[str, Any]] = []
    tid_names: Dict[int, str] = {}
    docs = get_exemplar_store().snapshot()
    if exemplars_n is not None:
        docs = docs[:int(exemplars_n)]
    for i, doc in enumerate(docs):
        ledger = doc.get("ledger") or {}
        phases = ledger.get("phases") or {}
        rec = doc.get("record") or {}
        anchor = rec.get("wall_enqueue")
        if anchor is None:
            continue
        tid = i + 1
        tid_names[tid] = str(doc.get("request_id", "?"))
        cursor = float(anchor)
        for phase in PHASES:
            dur = float(phases.get(phase, 0.0))
            if dur <= 0.0:
                continue
            events.append({
                "ph": "X", "name": phase, "cat": "blame",
                "pid": PID_BLAME, "tid": tid,
                "ts": _us(cursor), "dur": max(0, _us(dur)),
                "args": {"request_id": str(doc.get("request_id", "?")),
                         "reason": doc.get("reason", "?"),
                         "share": round(
                             dur / max(ledger.get("e2e_s") or dur,
                                       1e-9), 4)},
            })
            cursor += dur
    return events, tid_names


def _ring_events(ring_n: Optional[int]) -> List[Dict[str, Any]]:
    from analytics_zoo_tpu_torch.observability.flight_recorder import (
        ring_contents,
    )

    events: List[Dict[str, Any]] = []
    entries = ring_contents()
    if ring_n is not None:
        entries = entries[-int(ring_n):]
    for entry in entries:
        args = {k: v for k, v in entry.items()
                if k not in ("ts", "kind")
                and isinstance(v, (str, int, float, bool))}
        events.append({
            "ph": "i", "name": entry.get("kind", "event"),
            "cat": "flight_ring", "pid": PID_EVENTS, "tid": 1,
            "ts": _us(entry.get("ts", 0.0)), "s": "t", "args": args,
        })
    return events


def _memory_events(samples_n: Optional[int]) -> List[Dict[str, Any]]:
    from analytics_zoo_tpu_torch.observability import memory

    events: List[Dict[str, Any]] = []
    for s in memory.samples(samples_n):
        ts = _us(s["ts"])
        events.append({
            "ph": "C", "name": "memory_bytes", "cat": "memory",
            "pid": PID_MEMORY, "tid": 1, "ts": ts,
            "args": {
                "host_rss": float(s.get("host_rss_bytes", 0)),
                "device_allocated": float(
                    s.get("device_allocated_bytes", 0)),
                "device_reserved": float(
                    s.get("device_reserved_bytes", 0)),
            },
        })
        pool = {k: float(v) for k, v in s.items()
                if k not in ("ts", "host_rss_bytes",
                             "device_allocated_bytes",
                             "device_reserved_bytes")}
        if pool:
            events.append({
                "ph": "C", "name": "memory_pools", "cat": "memory",
                "pid": PID_MEMORY, "tid": 1, "ts": ts, "args": pool,
            })
    return events


def export_timeline(spans_n: int = 512,
                    steps_n: Optional[int] = None,
                    requests_n: Optional[int] = None,
                    ring_n: Optional[int] = None,
                    samples_n: Optional[int] = None
                    ) -> Dict[str, Any]:
    """Build the Chrome-trace document from the live in-process rings.
    Every section is guarded: a failing source contributes nothing
    rather than taking the export down."""
    events: List[Dict[str, Any]] = []
    metas: List[Dict[str, Any]] = []

    def _section(fn, *args):
        try:
            return fn(*args)
        except Exception:
            return [], {}

    span_ev, span_tids = _section(_span_events, spans_n)
    good_ev, good_tids = _section(_goodput_events, steps_n)
    req_ev, req_tids = _section(_request_events, requests_n)
    repl_ev, repl_tids = _section(_replica_events, requests_n)
    dma_ev, dma_tids = _section(_kv_dma_events, None)
    disp_ev, disp_tids = _section(_dispatch_events, None)
    blame_ev, blame_tids = _section(_blame_events, None)
    try:
        ring_ev = _ring_events(ring_n)
    except Exception:
        ring_ev = []
    try:
        mem_ev = _memory_events(samples_n)
    except Exception:
        mem_ev = []

    used_pids = set()
    for ev_list in (span_ev, good_ev, req_ev, repl_ev, dma_ev,
                    disp_ev, blame_ev, ring_ev, mem_ev):
        events.extend(ev_list)
        used_pids.update(e["pid"] for e in ev_list)

    for pid in sorted(used_pids):
        metas.append(_meta(pid, 0, "process_name",
                           _PROCESS_NAMES.get(pid, f"pid{pid}")))
    for tid, name in sorted(span_tids.items()):
        metas.append(_meta(PID_SPANS, tid, "thread_name", name))
    for tid, name in sorted(good_tids.items()):
        metas.append(_meta(PID_GOODPUT, tid, "thread_name", name))
    for tid, name in sorted(req_tids.items()):
        metas.append(_meta(PID_REQUESTS, tid, "thread_name", name))
    for tid, name in sorted(repl_tids.items()):
        metas.append(_meta(PID_REPLICAS, tid, "thread_name", name))
    for tid, name in sorted(dma_tids.items()):
        metas.append(_meta(PID_KV_DMA, tid, "thread_name", name))
    for tid, name in sorted(disp_tids.items()):
        metas.append(_meta(PID_DISPATCH, tid, "thread_name", name))
    for tid, name in sorted(blame_tids.items()):
        metas.append(_meta(PID_BLAME, tid, "thread_name", name))
    if any(e["pid"] == PID_EVENTS for e in ring_ev):
        metas.append(_meta(PID_EVENTS, 1, "thread_name",
                           "flight_ring"))
    if mem_ev:
        metas.append(_meta(PID_MEMORY, 1, "thread_name", "samplers"))

    # a globally sorted stream keeps `ts` monotone — the property the
    # schema validator pins and sequential consumers rely on
    events.sort(key=lambda e: e["ts"])
    if len(events) > MAX_EVENTS:
        events = events[-MAX_EVENTS:]
    return {
        "traceEvents": metas + events,
        "displayTimeUnit": "ms",
        "otherData": {"exporter": "analytics_zoo_tpu_torch.observability"
                                  ".timeline"},
    }


def timeline_json(**kw) -> str:
    return json.dumps(export_timeline(**kw),
                      separators=(",", ":"))


def write_timeline(path: str, **kw) -> str:
    """Dump the current timeline to `path` (the flight-recorder bundle
    sibling); returns the path."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(timeline_json(**kw))
    return path
