"""Fleet aggregation (a copy of analytics_zoo_tpu/observability/fleet.py):
one view over every process and replica.

A deployment is a fleet: router replicas own private
registries (isolation is enforced), stream consumers and elastic
members run — and die — in other processes.  `FleetAggregator` merges
all of it back into one pane:

* **sources** = the local process, each live router replica / consumer
  registry handed in, and every spooled snapshot harvested from
  ``<observability_dir>/telemetry/<proc>/snapshot.json``
  (observability/telemetry_spool.py).  Spooled snapshots written by the
  *current* process are skipped — the live harvest already covers it —
  so nothing is double-counted.
* **metrics** (`fleet_prometheus_text`): counters are summed across
  sources into single unlabeled rows (the fleet total equals the
  per-source scrapes exactly); gauges and histogram summaries are
  emitted per source with a ``source="<name>"`` label, because a mean
  of gauges is a lie.
* **timeline** (`fleet_timeline`): one Chrome-trace document, one pid
  per source (process/replica), every event placed on the wall clock
  via each source's own anchors, plus flow events (``ph s/t/f``)
  stitching spans that share a ``trace_id`` across pids — the rendered
  form of cross-process trace propagation
  (observability/trace_context.py).
* **SLO** (`fleet_slo`): per-source attainment snapshots, per-replica
  attainment derived from the request log's ``replica_dispatch``
  events, and a judged-request-weighted fleet rollup.
* **blame** (`fleet_blame` / `fleet_exemplar`): the exact fleet sum of
  the ``blame_*_seconds_total`` counters plus every source's tail
  exemplars — a SIGKILL'd replica's worst-request forensics arrive
  through its spool snapshot like its counters do.

Served by `ServingServer` as ``GET /metrics?fleet=1``,
``GET /timeline?fleet=1``, ``GET /blame?fleet=1``,
``GET /debug/requests/<id>`` and the ``"fleet"`` block of
``GET /stats``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
    merged_prometheus_text,
    parse_prometheus_text,
)
from analytics_zoo_tpu_torch.observability.telemetry_spool import (
    SPOOL_REQUEST_TAIL,
    SPOOL_SPAN_TAIL,
    read_snapshots,
)

__all__ = [
    "FleetAggregator",
    "labeled_prometheus_text",
]

#: pid offset of the first source in a fleet timeline (single-process
#: timelines use pids 1..6; keeping fleet pids disjoint makes the two
#: trace families impossible to confuse in a viewer)
FLEET_PID_BASE = 100

_US = 1_000_000


def _us(ts_s: float) -> int:
    return int(round(float(ts_s) * _US))


def labeled_prometheus_text(text: str, labels: Dict[str, str]) -> str:
    """Re-emit exposition `text` with `labels` folded into every sample
    line (comment lines pass through).  How per-replica registries are
    made scrape-visible without colliding with the process-global
    series of the same name."""
    if not labels:
        return text
    pairs = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    out: List[str] = []
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            out.append(line)
            continue
        try:
            key, val = stripped.rsplit(None, 1)
            float(val)
        except ValueError:
            out.append(line)
            continue
        if key.endswith("}"):
            out.append(f"{key[:-1]},{pairs}}} {val}")
        else:
            out.append(f"{key}{{{pairs}}} {val}")
    return "\n".join(out) + ("\n" if out else "")


class FleetAggregator:
    """Merge live registries + spooled snapshots into one fleet view.

    `live` is a sequence of ``(source_name, registries)`` pairs for
    same-process sources with isolated registries (router replicas,
    in-process consumers).  The local process itself is always a source
    (named `local_name`, covering `local_registries` — default the
    process-global registry).  `router` (a `ReplicaRouter`) adds one
    live source per replica, read at each harvest.
    """

    def __init__(self,
                 live: Sequence[Tuple[str, Iterable[MetricsRegistry]]] = (),
                 local_registries: Optional[
                     Iterable[MetricsRegistry]] = None,
                 local_name: str = "local",
                 observability_dir: Optional[str] = None,
                 include_spooled: bool = True,
                 router: Optional[Any] = None):
        self._live = [(str(n), tuple(regs)) for n, regs in live]
        self.local_name = str(local_name)
        self._local_regs = (tuple(local_registries)
                            if local_registries is not None
                            else (get_registry(),))
        self._dir = observability_dir
        self._include_spooled = include_spooled
        self._router = router
        reg = get_registry()
        self._c_harvests = reg.counter(
            "fleet_harvests_total",
            help="fleet aggregations served (metrics/timeline/slo)")
        self._g_sources = reg.gauge(
            "fleet_sources",
            help="sources merged into the last fleet view (live + "
                 "spooled)")
        self._g_spooled = reg.gauge(
            "fleet_spooled_sources",
            help="spooled (non-live) snapshot sources in the last "
                 "fleet view")

    @classmethod
    def from_server(cls, server: Any) -> "FleetAggregator":
        """Build over a `ServingServer`: local = server registry +
        process-global; one live source per router replica."""
        return cls(local_registries=(server.registry, get_registry()),
                   router=getattr(server, "router", None))

    # ------------------------------------------------------------------
    # harvesting
    # ------------------------------------------------------------------

    def sources(self) -> List[Dict[str, Any]]:
        """One dict per source.  Live sources carry registry refs; the
        local source also carries the span ring / request log; spooled
        sources carry their snapshot doc verbatim."""
        from analytics_zoo_tpu_torch.observability import request_log, tracing
        from analytics_zoo_tpu_torch.observability.exemplars import (
            get_exemplar_store,
        )
        from analytics_zoo_tpu_torch.observability.slo import get_slo_tracker
        import time

        srcs: List[Dict[str, Any]] = [{
            "name": self.local_name,
            "kind": "live",
            "pid": os.getpid(),
            "regs": self._local_regs,
            "wall_ts": time.time(),
            "spans": tracing.recent_spans(SPOOL_SPAN_TAIL),
            "requests": request_log.get_request_log().records(
                SPOOL_REQUEST_TAIL, include_active=True),
            "slo": get_slo_tracker().snapshot(),
            "exemplars": get_exemplar_store().snapshot(),
        }]
        live = list(self._live)
        if self._router is not None:
            # read at harvest time: replicas may come after this
            # aggregator was built
            live.extend((r.name, (r.engine.registry,))
                        for r in self._router.replicas)
        for name, regs in live:
            srcs.append({"name": name, "kind": "live",
                         "pid": os.getpid(), "regs": regs,
                         "spans": [], "requests": [], "slo": None,
                         "exemplars": []})
        if self._include_spooled:
            me = os.getpid()
            for doc in read_snapshots(self._dir):
                if doc.get("pid") == me:
                    continue   # live harvest already covers this process
                srcs.append({
                    "name": f"spool:{doc.get('proc', '?')}",
                    "kind": "spool",
                    "pid": doc.get("pid"),
                    "wall_ts": doc.get("wall_ts"),
                    "exposition": doc.get("exposition", ""),
                    "spans": doc.get("spans") or [],
                    "requests": doc.get("requests") or [],
                    "slo": doc.get("slo"),
                    "exemplars": doc.get("exemplars") or [],
                })
        self._g_sources.set(len(srcs))
        self._g_spooled.set(
            sum(1 for s in srcs if s["kind"] == "spool"))
        self._c_harvests.inc()
        return srcs

    @staticmethod
    def _exposition(src: Dict[str, Any]) -> str:
        if "regs" in src:
            return merged_prometheus_text(*src["regs"])
        return src.get("exposition", "") or ""

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------

    def fleet_prometheus_text(self) -> str:
        """The GET /metrics?fleet=1 body: summed counters, labeled
        gauges/summaries."""
        srcs = self.sources()
        parsed = [(s["name"], parse_prometheus_text(self._exposition(s)))
                  for s in srcs]
        sums: Dict[str, float] = {}
        types: Dict[str, str] = {}
        others: Dict[str, List[Tuple[str, Dict[str, Any]]]] = {}
        for sname, metrics in parsed:
            for mname, entry in metrics.items():
                mtype = entry.get("type", "")
                types.setdefault(mname, mtype)
                if mtype == "counter":
                    sums[mname] = sums.get(mname, 0.0) + float(
                        entry.get("value", 0.0))
                else:
                    others.setdefault(mname, []).append((sname, entry))
        n_spool = sum(1 for s in srcs if s["kind"] == "spool")
        lines: List[str] = [
            f"# fleet: {len(srcs)} sources ({n_spool} spooled); "
            "counters summed, gauges/summaries labeled by source",
        ]
        for mname in sorted(sums):
            lines.append(f"# TYPE {mname} counter")
            lines.append(f"{mname} {sums[mname]:g}")
        for mname in sorted(others):
            mtype = types.get(mname) or "gauge"
            lines.append(f"# TYPE {mname} {mtype}")
            for sname, entry in others[mname]:
                label = f'source="{sname}"'
                for q, v in sorted(
                        (entry.get("quantiles") or {}).items()):
                    lines.append(
                        f'{mname}{{{label},quantile="{q:g}"}} {v:g}')
                if "value" in entry:
                    lines.append(f"{mname}{{{label}}} "
                                 f"{entry['value']:g}")
                for field in ("sum", "count", "max", "records"):
                    if field in entry:
                        lines.append(f"{mname}_{field}{{{label}}} "
                                     f"{entry[field]:g}")
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------------
    # timeline
    # ------------------------------------------------------------------

    def fleet_timeline(self) -> Dict[str, Any]:
        """One Chrome-trace doc over all sources: pid per source, wall
        clock everywhere, flow events stitching shared trace_ids."""
        from analytics_zoo_tpu_torch.observability.timeline import MAX_EVENTS

        srcs = self.sources()
        events: List[Dict[str, Any]] = []
        metas: List[Dict[str, Any]] = []
        # (trace_id) -> [(wall_ts, pid, tid)] for flow stitching
        flows: Dict[str, List[Tuple[float, int, int]]] = {}
        source_names: Dict[int, str] = {}

        for i, src in enumerate(srcs):
            pid = FLEET_PID_BASE + i
            source_names[pid] = src["name"]
            metas.append({"ph": "M", "name": "process_name", "pid": pid,
                          "tid": 0,
                          "args": {"name": f"{src['kind']}:"
                                           f"{src['name']}"}})
            tids: Dict[str, int] = {}
            for sp in src.get("spans") or []:
                start = sp.get("start_ts")
                dur = sp.get("duration_s")
                if start is None:
                    continue
                tname = str(sp.get("thread") or "main")
                tid = tids.setdefault(tname, len(tids) + 1)
                ev = {"ph": "X", "name": str(sp.get("name", "span")),
                      "cat": "span", "pid": pid, "tid": tid,
                      "ts": _us(start),
                      "dur": max(1, _us(dur or 0.0)),
                      "args": {k: sp.get(k) for k in
                               ("span_id", "parent_id", "trace_id")
                               if sp.get(k) is not None}}
                attrs = sp.get("attrs") or {}
                if attrs:
                    ev["args"]["attrs"] = attrs
                events.append(ev)
                tr = sp.get("trace_id")
                if tr:
                    flows.setdefault(str(tr), []).append(
                        (float(start), pid, tid))
            req_tid_base = len(tids) + 1
            for j, rec in enumerate(src.get("requests") or []):
                wall0 = rec.get("wall_enqueue")
                t0 = rec.get("t_enqueue")
                if wall0 is None or t0 is None:
                    continue
                tid = req_tid_base + (j % 16)
                t_end = rec.get("t_finish")
                end_wall = (wall0 + (t_end - t0)
                            if t_end is not None else None)
                if end_wall is not None:
                    events.append({
                        "ph": "X", "name": str(rec.get("request_id")),
                        "cat": "request", "pid": pid, "tid": tid,
                        "ts": _us(wall0),
                        "dur": max(1, _us(end_wall - wall0)),
                        "args": {
                            "status": rec.get("status"),
                            "finish_reason": rec.get("finish_reason"),
                            "n_tokens": rec.get("n_tokens"),
                        }})
                for e in rec.get("events") or []:
                    kind = e.get("kind")
                    if kind in ("enqueue", "token"):
                        continue   # too chatty for a fleet view
                    ts = e.get("ts")
                    if ts is None:
                        continue
                    args = {k: v for k, v in e.items()
                            if k not in ("kind", "t", "ts")}
                    args["request_id"] = rec.get("request_id")
                    events.append({
                        "ph": "i", "s": "t",
                        "name": str(kind), "cat": "request",
                        "pid": pid, "tid": tid, "ts": _us(ts),
                        "args": args})
            for tname, tid in sorted(tids.items(), key=lambda kv: kv[1]):
                metas.append({"ph": "M", "name": "thread_name",
                              "pid": pid, "tid": tid,
                              "args": {"name": f"spans:{tname}"}})
            used_req_tids = sorted({e["tid"] for e in events
                                    if e["pid"] == pid
                                    and e["tid"] >= req_tid_base
                                    and e["ph"] != "M"})
            for tid in used_req_tids:
                metas.append({"ph": "M", "name": "thread_name",
                              "pid": pid, "tid": tid,
                              "args": {"name": f"requests:"
                                               f"{tid - req_tid_base}"}})
            if src["kind"] == "live" and src["name"] == self.local_name:
                # the host-tier DMA ring is process-local, so only the
                # local source can vouch for these copies
                dma_tid_base = req_tid_base + 16
                dma_tids: Dict[str, int] = {}
                try:
                    from analytics_zoo_tpu_torch.serving.generation.host_tier \
                        import dma_events
                    for e in dma_events():
                        dur = float(e.get("dur_s", 0.0) or 0.0)
                        lane = str(e.get("lane", "engine"))
                        tid = dma_tids.setdefault(
                            lane, dma_tid_base + len(dma_tids))
                        events.append({
                            "ph": "X",
                            "name": str(e.get("kind", "host_copy")),
                            "cat": "kv_dma", "pid": pid, "tid": tid,
                            "ts": _us(float(e["ts"]) - dur),
                            "dur": max(1, _us(dur)),
                            "args": {"nbytes": int(e.get("nbytes", 0)),
                                     "lane": lane}})
                except Exception:
                    pass   # host tier absent/broken: no DMA lane
                for lane, tid in sorted(dma_tids.items(),
                                        key=lambda kv: kv[1]):
                    metas.append({"ph": "M", "name": "thread_name",
                                  "pid": pid, "tid": tid,
                                  "args": {"name": f"kv_dma:{lane}"}})

        # flow events: one flow per trace_id that touches >= 2 pids
        for tr, points in sorted(flows.items()):
            pids_touched = {p for _, p, _ in points}
            if len(pids_touched) < 2:
                continue
            points.sort()
            fid = int(tr[:8], 16) if _is_hex(tr[:8]) else (
                abs(hash(tr)) & 0x7FFFFFFF)
            for k, (wall, pid, tid) in enumerate(points):
                ph = ("s" if k == 0
                      else "f" if k == len(points) - 1 else "t")
                ev = {"ph": ph, "cat": "trace",
                      "name": f"trace:{tr[:8]}", "id": fid,
                      "pid": pid, "tid": tid, "ts": _us(wall)}
                if ph == "f":
                    ev["bp"] = "e"
                events.append(ev)

        events.sort(key=lambda e: e.get("ts", 0))
        if len(events) > MAX_EVENTS:
            events = events[-MAX_EVENTS:]
        return {
            "traceEvents": metas + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "exporter": "analytics_zoo_tpu_torch.observability.fleet",
                "fleet": True,
                "sources": {str(p): n
                            for p, n in sorted(source_names.items())},
            },
        }

    # ------------------------------------------------------------------
    # metrics history
    # ------------------------------------------------------------------

    def fleet_history(self, *, family: Optional[str] = None,
                      since: Optional[float] = None,
                      derive: Optional[str] = None,
                      window_s: Optional[float] = None
                      ) -> Dict[str, Any]:
        """The GET /metrics/history?fleet=1 body: every process's
        durable sample log under ``<observability_dir>/history/``
        merged onto one wall clock with the local recorder's live ring
        (dedup by (proc, seq) — a live process's ring overlaps its own
        log).  A SIGKILL'd replica's recorded history merges exactly
        like a live one — same contract as the spool harvest above."""
        from analytics_zoo_tpu_torch.common.context import OrcaContext
        from analytics_zoo_tpu_torch.observability import history

        base_dir = self._dir or OrcaContext.observability_dir
        reader = history.HistoryReader(base_dir)
        disk = reader.read_samples()
        rec = history.get_recorder()
        ring = rec.tail() if rec is not None else []
        merged = history.merge_samples(disk, ring)
        self._c_harvests.inc()
        return history.history_payload(
            merged, family=family, since=since, derive=derive,
            window_s=window_s, fleet=True,
            enabled=OrcaContext.metrics_history_interval_s is not None
            or bool(merged))

    # ------------------------------------------------------------------
    # blame
    # ------------------------------------------------------------------

    def fleet_blame(self) -> Dict[str, Any]:
        """The GET /blame?fleet=1 body: the local rollup plus the
        EXACT fleet counter merge — `blame_<phase>_seconds_total` /
        `blame_requests_total` are float counters, so summing the
        per-source expositions reproduces the per-replica registries'
        totals bit-for-bit (same contract as `fleet_prometheus_text`)
        — and every source's tail-exemplar index (a SIGKILL'd
        replica's exemplars arrive via its spool snapshot)."""
        from analytics_zoo_tpu_torch.observability import blame

        srcs = self.sources()
        counters: Dict[str, float] = {}
        for s in srcs:
            parsed = parse_prometheus_text(self._exposition(s))
            for mname, entry in parsed.items():
                if not mname.startswith(("blame_", "exemplars_")):
                    continue
                if entry.get("type") != "counter":
                    continue
                counters[mname] = (counters.get(mname, 0.0)
                                   + float(entry.get("value", 0.0)))
        exemplar_rows: List[Dict[str, Any]] = []
        for s in srcs:
            for d in s.get("exemplars") or []:
                led = d.get("ledger") or {}
                phases = led.get("phases") or {}
                exemplar_rows.append({
                    "request_id": d.get("request_id"),
                    "source": s["name"],
                    "reason": d.get("reason"),
                    "e2e_s": led.get("e2e_s"),
                    "dominant_phase": (max(phases.items(),
                                           key=lambda kv: kv[1])[0]
                                       if phases else None),
                })
        exemplar_rows.sort(key=lambda r: -(r.get("e2e_s") or 0.0))
        return {
            "local": blame.blame_payload(),
            "counters": {k: counters[k] for k in sorted(counters)},
            "sources": len(srcs),
            "exemplars": exemplar_rows[:64],
        }

    def fleet_exemplar(self, request_id: str
                       ) -> Optional[Dict[str, Any]]:
        """One exemplar by request id, searched across every source
        (live store first, then spooled snapshots) — the fleet half of
        GET /debug/requests/<id>."""
        from analytics_zoo_tpu_torch.observability.exemplars import (
            get_exemplar_store,
        )

        doc = get_exemplar_store().get(request_id)
        if doc is not None:
            doc["source"] = self.local_name
            return doc
        for s in self.sources():
            if s["kind"] != "spool":
                continue
            for d in s.get("exemplars") or []:
                if str(d.get("request_id")) == str(request_id):
                    d = dict(d)
                    d["source"] = s["name"]
                    return d
        return None

    # ------------------------------------------------------------------
    # SLO
    # ------------------------------------------------------------------

    def fleet_slo(self) -> Dict[str, Any]:
        """Per-source SLO snapshots, per-replica attainment (judged from
        the request log against the current targets) and a
        judged-weighted fleet rollup."""
        from analytics_zoo_tpu_torch.common.context import OrcaContext

        srcs = self.sources()
        per_source: Dict[str, Any] = {}
        judged_total = 0
        met_weighted = 0.0
        violations_total = 0
        for s in srcs:
            snap = s.get("slo")
            per_source[s["name"]] = snap
            if not snap:
                continue
            att = snap.get("attainment")
            n = snap.get("requests_in_window") or 0
            if att is not None and n:
                judged_total += n
                met_weighted += att * n
            violations_total += int(snap.get("violations_total") or 0)
        out: Dict[str, Any] = {
            "sources": per_source,
            "fleet": {
                "sources": len(srcs),
                "requests_in_window": judged_total,
                "attainment": (round(met_weighted / judged_total, 4)
                               if judged_total else None),
                "violations_total": violations_total,
            },
        }
        targets = OrcaContext.slo_targets
        if self._router is not None and targets:
            out["replicas"] = self._replica_attainment(targets)
        return out

    def _replica_attainment(
            self, targets: Dict[str, float]) -> Dict[str, Any]:
        """Judge finished requests per dispatched replica against the
        current targets (replicas share the process SLO tracker, so
        per-replica attainment is re-derived from the log)."""
        from analytics_zoo_tpu_torch.observability import request_log

        per: Dict[str, Dict[str, int]] = {}
        for rec in request_log.get_request_log().records(
                include_active=False):
            replica = None
            for e in rec.get("events") or []:
                if e.get("kind") == "replica_dispatch":
                    replica = e.get("replica")   # the last dispatch wins
            if replica is None:
                continue
            verdict = None
            for dim, target in targets.items():
                v = rec.get(dim)
                if v is None:
                    continue
                ok = v <= float(target)
                verdict = (verdict if verdict is not None else True) \
                    and ok
            if verdict is None:
                continue
            row = per.setdefault(str(replica), {"judged": 0, "met": 0})
            row["judged"] += 1
            row["met"] += 1 if verdict else 0
        return {name: {"judged": row["judged"],
                       "attainment": round(row["met"] / row["judged"], 4)}
                for name, row in sorted(per.items())}


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
        return True
    except ValueError:
        return False
