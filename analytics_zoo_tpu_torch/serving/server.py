"""Serving HTTP front end with request batching (counterpart of
analytics_zoo_tpu/serving/server.py; reference: Cluster Serving's
`FlinkInference.map` dynamic batching, `ClusterServing.scala:57-70`, with
the akka-http front end).

One process: a ThreadingHTTPServer accepts requests; a batcher thread
drains the request queue, packs up to `max_batch_size` records into one
batch (bounded by `batch_timeout_ms`, or by the adaptive deadline),
runs the `InferenceModel` and fans the results back out.  The HTTP
contract is the JAX package's: the same routes, JSON keys, status codes
and headers, so either package's client works against either server.

Endpoints:
  POST /predict  — {"inputs": [enc, ...]} -> {"outputs": [...]} (enc the
                   codec's base64 ndarray), or an Arrow IPC body
                   (Content-Type `codec.ARROW_CONTENT_TYPE`) answered in
                   Arrow; one record (joins the dynamic batch) or a
                   pre-batched array.  A failed batch is a 500 with the
                   error.
  POST /enqueue  — {"uri": id, "inputs": [...]}; the result is fetched
  GET  /result/<uri> — {"status": "pending" | "ok" | "error" |
                   "expired", ...}: results live `result_ttl_s`, at most
                   `max_results` of them (oldest evicted first), and an
                   evicted uri answers "expired".
  POST /generate — streamed generation (needs a `generation_engine`):
                   {"tokens", "max_new_tokens", "temperature", "top_k",
                   "eos_id"} -> chunked application/x-ndjson, one
                   {"token": id} line per sampled token, then {"done":
                   true, "n_tokens", "finish_reason", "request_id"}.  The
                   client's X-Request-Id (sanitized) or a new id is echoed
                   on every response; 400 malformed, 404 no engine, 413
                   can never fit, 503 shed (the queue bound or the SLO
                   shedder, `OrcaContext.slo_shed_attainment`; with
                   Retry-After and "retry_after_s" from the engine's
                   drain estimate; 429 with Retry-After for a tenant over
                   its quota).  A stream that dies mid-flight ends with
                   an {"error"} line.  X-Tenant (or "tenant") charges the
                   tenant's quota bucket (`OrcaContext.tenant_quotas`)
                   and slices the SLO and blame planes; "request_class"
                   ("interactive" | "batch" | "shadow") sets the
                   scheduler priority.  With `router=` the request goes
                   through the ReplicaRouter's least-loaded admission;
                   with `model_registry=` X-Model (or "model") resolves a
                   registered model through its A/B and shadow policies,
                   and the response's X-Model is the model@version that
                   served it (404 for an unknown model).
  POST /streams/<name>/enqueue — durable ingest (needs a `stream_hub`):
                   the JSON body is appended as one CRC-framed record of
                   the stream's log before the 200 ({"status": "queued",
                   "uri", "stream", "record_id"}); a full backlog is a
                   429 StreamBacklogFull with Retry-After from the
                   groups' drain rate.
  POST /streams/<name>/dequeue — a consumer group's long-poll lease:
                   {"group", "consumer", "max_records", "block_s"} ->
                   {"records": [{"record_id", "attempts", "doc"}]}; a
                   record not acked within the visibility timeout
                   replays to another consumer.
  POST /streams/<name>/ack — {"group", "record_ids"} advances the
                   group's durable cursor ({"acked": n}).
  GET  /healthz  — liveness and records served
  GET  /stats    — JSON snapshot: counters, batcher queue depth, the
                   replica count, the per-op timer summaries, the goodput
                   ratio, the engine's lanes, the worker pool's, the
                   router's per-replica rows, the streams' backlog and
                   lag, the registry's table and the shadow SLO, the
                   tenant ledger, the dispatch ledger's rows, and with a
                   generation target the `requests` (SLO attainment) and
                   `blame` blocks, with a router or `observability_dir`
                   the `fleet` block
  GET  /metrics  — Prometheus text: this server's registry (the
                   `serving_*` timers, counters and gauges) merged with
                   the process registry, and each router replica's
                   registry under a replica="<name>" label (?fleet=0
                   leaves them out); ?fleet=1 the `FleetAggregator` view
                   (counters summed over this process, the replicas and
                   every spooled snapshot, gauges labeled by source)
  GET  /metrics/history — the metrics history (observability/history.py):
                   a forced sample, then the recorder's ring
                   (?family=&since=&derive=rate|delta|quantiles&window=;
                   ?fleet=1 every process's sample log merged; another
                   derive is a 400)
  GET  /spans    — the newest completed spans (?n=, default 100)
  GET  /goodput  — the goodput step tables and the process ratio
  GET  /slo      — the SLO snapshot (targets, attainment, violations)
  GET  /dispatch — the dispatch ledger (families, compile events, MFU)
  GET  /blame    — the latency blame rollup (?fleet=1: counters summed
                   over the fleet and its worst exemplars)
  GET  /debug/requests[/<id>] — the tail exemplars' index, or one
                   request's dossier (404 for an unknown id)
  GET  /timeline — the Chrome-trace timeline (?fleet=1: one pid a
                   source, flows across shared traces)

Tracing: a client's W3C `traceparent` on /generate, /predict and
/enqueue parents the handler's span (`serving.generate`,
`serving.http_request`), and a `traceparent` of that span's trace is
echoed on the response, sheds included; the batcher's
`serving.run_batch` span takes the first request's span as its parent
across the queue hop.  X-Model and X-Tenant are echoed on every
response.  /predict and /enqueue charge X-Tenant at the door (the
worker pool's `AdmissionCore`, or the server's own), 429 with
Retry-After when over quota.

Back ends: `model` (an `InferenceModel`) or `worker_pool` (a
`WorkerPool` of model processes) serves /predict and /enqueue;
`generation_engine`, `router` (a `ReplicaRouter`) or `model_registry`
(a `ModelRegistry`) serves /generate; `stream_hub` (a `StreamHub`) the
/streams routes.  `start(http=False)` runs the batcher alone, for a gRPC
front end (grpc_frontend.py) that is the only ingress.
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote

import numpy as np

from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.observability import (
    FleetAggregator,
    MetricsRegistry,
    blame_payload,
    current_span,
    export_timeline,
    get_blame_tracker,
    get_exemplar_store,
    get_registry,
    get_shadow_slo_tracker,
    get_slo_tracker,
    goodput_tables,
    history,
    labeled_prometheus_text,
    memory,
    merged_prometheus_text,
    now,
    process_goodput_ratio,
    profiling,
    recent_spans,
    request_log,
    trace,
    trace_context,
)
from analytics_zoo_tpu_torch.serving.codec import (
    ARROW_CONTENT_TYPE,
    decode_arrow_tensors,
    decode_ndarray,
    encode_arrow_tensors,
    encode_ndarray,
)
from analytics_zoo_tpu_torch.serving.control_plane.admission import (
    AdmissionCore,
    get_tenant_ledger,
)
from analytics_zoo_tpu_torch.serving.errors import (
    ModelNotFound,
    QueueFull,
    ReplicaStopped,
    RequestTooLarge,
    TenantQuotaExceeded,
    http_status_for,
)
from analytics_zoo_tpu_torch.serving.timer import Timer

_log = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("inputs", "event", "outputs", "error", "t_enqueue",
                 "span")

    def __init__(self, inputs: Tuple[np.ndarray, ...], span=None):
        self.inputs = inputs
        self.event = threading.Event()
        self.outputs = None
        self.error: Optional[str] = None
        self.t_enqueue = now()
        # the submitting side's open span: the batcher's run_batch span
        # takes it as parent, since contextvars do not cross the queue
        self.span = span if span is not None else current_span()


class ServingServer:
    """start() serves until stop(); thread-safe for concurrent clients.

    `model` (an `InferenceModel`) or `worker_pool` (a `WorkerPool`)
    serves /predict and /enqueue; `generation_engine` (a
    `GenerationEngine`), `router` (a `ReplicaRouter`) or `model_registry`
    (a `ModelRegistry`) serves /generate, started and stopped with the
    server; `stream_hub` (a `StreamHub`, whose lifetime is its
    creator's: stop() leaves it open) serves /streams.  The batcher
    waits for stragglers min(`batch_timeout_ms`, `adaptive_k` x the EMA
    of the request gaps) when `adaptive_batching`, the full window
    otherwise, and never when the batch is already full."""

    def __init__(self, model=None, host: str = "127.0.0.1", port: int = 0,
                 max_batch_size: int = 32, batch_timeout_ms: float = 5.0,
                 result_ttl_s: float = 600.0, max_results: int = 10_000,
                 worker_pool=None, generation_engine=None, router=None,
                 stream_hub=None, model_registry=None,
                 adaptive_batching: bool = True, adaptive_k: float = 2.0):
        if model is None and worker_pool is None and \
                generation_engine is None and router is None and \
                stream_hub is None and model_registry is None:
            raise ValueError("need a model, a worker_pool, a "
                             "generation_engine, a router, a "
                             "stream_hub or a model_registry")
        if router is not None and generation_engine is not None:
            raise ValueError("pass either generation_engine= or "
                             "router=, not both — the router owns its "
                             "own engine replicas")
        if model_registry is not None and (
                generation_engine is not None or router is not None):
            raise ValueError("pass either model_registry= or a bare "
                             "generation_engine=/router= — register "
                             "the engine as a version instead")
        self.model = model
        self.worker_pool = worker_pool
        self.generation_engine = generation_engine
        self.router = router
        self.stream_hub = stream_hub
        self.model_registry = model_registry
        self._predict = (worker_pool.predict if worker_pool is not None
                         else model.predict if model is not None else None)
        # the tenant gate of /predict and /enqueue: the pool's
        # AdmissionCore (its max_queue applies too), else the door's own
        # over the shared ledger; /generate charges in the engine
        if worker_pool is not None:
            self._door_admission = worker_pool.admission
        elif self._predict is not None:
            self._door_admission = AdmissionCore()
        else:
            self._door_admission = None
        self.max_batch_size = max_batch_size
        self.batch_timeout_s = batch_timeout_ms / 1e3
        self.adaptive_batching = bool(adaptive_batching)
        self.adaptive_k = float(adaptive_k)
        self._ema_gap_s = self.batch_timeout_s
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        # async results are evicted after result_ttl_s or when the store
        # exceeds max_results (oldest first); evicted uris leave a
        # bounded tombstone so pollers see "expired", not "pending"
        self._results: Dict[str, Tuple[float, Any]] = {}
        self._expired: Dict[str, float] = {}
        self._result_ttl_s = result_ttl_s
        self._max_results = max_results
        self._results_lock = threading.Lock()
        self._stop = threading.Event()
        self._batches_run = 0
        # batches may complete on concurrent executor threads
        self._stats_lock = threading.Lock()
        # per-server registry, merged with the process registry at
        # /metrics
        self.registry = MetricsRegistry()
        self.timer = Timer(registry=self.registry, prefix="serving_")
        self._c_requests = self.registry.counter(
            "serving_requests_total", help="HTTP requests handled")
        self._c_http_errors = self.registry.counter(
            "serving_http_errors_total",
            help="HTTP responses with status >= 400")
        self._c_records = self.registry.counter(
            "serving_records_served_total",
            help="records returned by successful batches")
        self._c_batches = self.registry.counter(
            "serving_batches_total", help="device batches run")
        self.registry.gauge(
            "serving_queue_depth", fn=self._queue.qsize,
            help="requests waiting in the dynamic batcher queue")
        self.registry.gauge(
            "serving_replicas", fn=self.replicas,
            help="model replicas behind this server")
        if worker_pool is not None:
            self.registry.gauge(
                "serving_worker_utilization", fn=worker_pool.utilization,
                help="fraction of worker-pool replicas busy")
        if stream_hub is not None:
            # the server's registry: a second server with its own hub
            # must not inherit this one's callback
            self.registry.gauge(
                "stream_backlog_depth", fn=stream_hub.total_backlog,
                help="unconsumed records across this server's durable "
                     "streams (slowest consumer group per stream)")
        self._httpd = None
        self._http_started = False
        self._requested_addr = (host, port)
        self.host, self.port = host, port
        self._threads: List[threading.Thread] = []
        self._fleet_agg: Optional[FleetAggregator] = None

    # ------------------------------------------------------------------
    # the HTTP handler
    # ------------------------------------------------------------------

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 so /generate can stream Transfer-Encoding:
            # chunked; every other response sends Content-Length
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                _log.debug("%s %s", self.client_address[0], fmt % args)

            def _json(self, code: int, payload: Dict[str, Any],
                      request_id: Optional[str] = None,
                      headers: Optional[Dict[str, str]] = None):
                self._body(code, json.dumps(payload).encode(),
                           "application/json", request_id=request_id,
                           headers=headers)

            def _body(self, code: int, body: bytes, ctype: str,
                      request_id: Optional[str] = None,
                      headers: Optional[Dict[str, str]] = None):
                server._c_requests.inc()
                if code >= 400:
                    server._c_http_errors.inc()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if request_id is not None:
                    self.send_header("X-Request-Id", request_id)
                for k, v in server._echo(self.headers, headers).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                fleet = "fleet=1" in query
                if path == "/healthz":
                    self._json(200, {"status": "ok",
                                     "records_served": server.records_served,
                                     "replicas": server.replicas(),
                                     "batches_run": server._batches_run})
                elif path.startswith("/metrics/history"):
                    self._history(parse_qs(query))
                elif path == "/metrics":
                    if fleet:
                        text = server.fleet().fleet_prometheus_text()
                    else:
                        text = merged_prometheus_text(server.registry,
                                                      get_registry())
                        if (server.router is not None
                                and "fleet=0" not in query):
                            # each replica's own registry, labeled
                            for r in server.router.replicas:
                                text += labeled_prometheus_text(
                                    r.engine.registry.prometheus_text(),
                                    {"replica": r.name})
                    self._body(200, text.encode(),
                               "text/plain; version=0.0.4")
                elif path == "/stats":
                    self._json(200, server.stats())
                elif path.startswith("/goodput"):
                    self._json(200, {
                        "goodput_ratio": round(process_goodput_ratio(), 4),
                        "clocks": goodput_tables()})
                elif path.startswith("/slo"):
                    self._json(200, get_slo_tracker().snapshot())
                elif path.startswith("/dispatch"):
                    self._json(200, profiling.ledger_snapshot())
                elif path.startswith("/blame"):
                    self._json(200, server.fleet().fleet_blame() if fleet
                               else blame_payload())
                elif path.startswith("/debug/requests"):
                    rid = unquote(path[len("/debug/requests"):].strip("/"))
                    if not rid:
                        self._json(200, get_exemplar_store().index())
                        return
                    doc = server.fleet().fleet_exemplar(rid)
                    if doc is None:
                        self._json(404, {"error": "no exemplar for "
                                         "request id", "request_id": rid})
                    else:
                        self._json(200, doc)
                elif path.startswith("/timeline"):
                    # a fresh memory point in every export
                    memory.maybe_sample(force=True)
                    doc = (server.fleet().fleet_timeline() if fleet
                           else export_timeline())
                    self._body(200, json.dumps(doc).encode(),
                               "application/json")
                elif path.startswith("/spans"):
                    try:
                        n = int(parse_qs(query).get("n", ["100"])[0])
                    except ValueError:
                        n = 100
                    self._json(200, {"spans": recent_spans(n)})
                elif self.path.startswith("/result/"):
                    self._json(200, server._result(
                        self.path[len("/result/"):]))
                else:
                    self._json(404, {"error": "not found"})

            def _history(self, q: Dict[str, List[str]]):
                """GET /metrics/history: a forced sample first, so the
                answer always holds a current point; then the recorder's
                ring, or with ?fleet=1 every process's sample log merged
                with it.  Disarmed (no interval set, nothing recorded):
                enabled false, no samples."""
                def number(key):
                    try:
                        return float(q[key][0])
                    except (KeyError, ValueError, IndexError):
                        return None

                family = (q.get("family") or [None])[0]
                derive = (q.get("derive") or [None])[0]
                if derive and derive not in history.DERIVE_KINDS:
                    self._json(400, {
                        "error": f"derive must be one of "
                                 f"{list(history.DERIVE_KINDS)}"})
                    return
                rec = history.get_recorder(registries=(server.registry,))
                if rec is not None:
                    rec.sample()
                if (q.get("fleet") or ["0"])[0] == "1":
                    payload = server.fleet().fleet_history(
                        family=family, since=number("since"),
                        derive=derive, window_s=number("window"))
                else:
                    payload = history.history_payload(
                        rec.tail() if rec is not None else [],
                        family=family, since=number("since"),
                        derive=derive, window_s=number("window"),
                        enabled=rec is not None)
                self._json(200, payload)

            def _chunk(self, text: str):
                data = text.encode()
                self.wfile.write(f"{len(data):x}\r\n".encode() + data
                                 + b"\r\n")
                self.wfile.flush()

            def _generate(self, body: bytes):
                """Streamed generation: each sampled token goes out as
                its own chunk as the engine emits it."""
                eng = server._generation_target()
                if eng is None:
                    self._json(404, {"error": "no generation engine "
                                     "behind this server"})
                    return
                rid = request_log.sanitize_request_id(
                    self.headers.get("X-Request-Id")
                    or request_log.new_request_id())
                model = self.headers.get("X-Model") or None
                tenant = self.headers.get("X-Tenant") or None
                # a client's traceparent makes the serving.generate span
                # a child of the caller's trace instead of a root
                tparent = trace_context.extract_headers(self.headers)

                def reject(code: int, msg: str,
                           retry_after_s: Optional[float] = None):
                    # a refused request stays findable in the log
                    request_log.reject(rid, code, msg)
                    payload = {"error": msg, "request_id": rid}
                    headers = (
                        {trace_context.TRACEPARENT_HEADER:
                         tparent.traceparent()}
                        if tparent is not None else None)
                    if code in (429, 503):
                        # every shed carries a comeback hint, which the
                        # client's RetryPolicy honours
                        ra = retry_after_s if retry_after_s else 1.0
                        payload["retry_after_s"] = round(ra, 3)
                        headers = dict(headers or {},
                                       **{"Retry-After": f"{ra:.3f}"})
                    self._json(code, payload, request_id=rid,
                               headers=headers)

                try:
                    req = json.loads(body)
                    tokens = [int(t) for t in req["tokens"]]
                except Exception as e:
                    reject(400, f"bad request: {e}")
                    return
                model = model or req.get("model") or None
                tenant = tenant or req.get("tenant") or None
                # one span covers admission and streaming (the router's
                # dispatch and re-queue spans nest under it); its context
                # goes back to the client as a traceparent
                span_kw = ({"parent": tparent}
                           if tparent is not None else {})
                with trace("serving.generate", prompt=len(tokens),
                           request_id=rid, **span_kw) as span:
                    kw = dict(
                        max_new_tokens=int(req.get("max_new_tokens", 32)),
                        temperature=float(req.get("temperature", 0.0)),
                        top_k=int(req.get("top_k", 0)),
                        eos_id=(int(req["eos_id"])
                                if req.get("eos_id") is not None else None),
                        request_id=rid, tenant=tenant)
                    if req.get("request_class") is not None:
                        kw["request_class"] = str(req["request_class"])
                    if server.model_registry is not None:
                        kw["model"] = model
                    try:
                        stream = eng.submit(tokens, **kw)
                    except RequestTooLarge as e:
                        reject(413, str(e))
                        return
                    except (QueueFull, TenantQuotaExceeded) as e:
                        # 503 from the queue and SLO gates, 429 from a
                        # tenant bucket: the router must not shop an
                        # over-quota request around (the ledger is
                        # process-wide)
                        reject(http_status_for(e), str(e),
                               retry_after_s=e.retry_after_s)
                        return
                    except ModelNotFound as e:
                        reject(404, str(e))
                        return
                    except ReplicaStopped as e:
                        reject(503, str(e))
                        return
                    except ValueError as e:
                        reject(400, str(e))
                        return
                    rid = stream.request_id or rid
                    span.attrs["request_id"] = rid
                    server._c_requests.inc()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.send_header("X-Request-Id", rid)
                    # the registry stamps the model@version that serves
                    served = dict(server._traceparent(span))
                    served_model = getattr(stream, "model_label",
                                           None) or model
                    if served_model:
                        served["X-Model"] = served_model
                    if tenant:
                        served["X-Tenant"] = tenant
                    for k, v in server._echo(self.headers, served).items():
                        self.send_header(k, v)
                    self.end_headers()
                    n = 0
                    try:
                        for tok in stream:
                            self._chunk(json.dumps({"token": tok}) + "\n")
                            n += 1
                        self._chunk(json.dumps(
                            {"done": True, "n_tokens": n,
                             "finish_reason": stream.finish_reason,
                             "request_id": rid}) + "\n")
                    except Exception as e:
                        # the stream died mid-flight (engine stopped,
                        # stream timeout): end the chunked body with an
                        # error line, not a torn connection
                        _log.warning("generate %s failed: %s: %s", rid,
                                     type(e).__name__, e)
                        request_log.event(
                            rid, "stream_error",
                            error=f"{type(e).__name__}: {e}")
                        try:
                            self._chunk(json.dumps(
                                {"error": f"{type(e).__name__}: {e}",
                                 "request_id": rid}) + "\n")
                        except OSError:
                            return
                    self.wfile.write(b"0\r\n\r\n")

            def _streams(self, body: bytes):
                """POST /streams/<name>/{enqueue,dequeue,ack}.  A
                record's lifecycle is logged under the id
                ``strm-<stream>-<record id>``, the id the in-process
                generation consumer uses, so one trail covers enqueue ->
                lease -> ack whichever side consumed it."""
                from analytics_zoo_tpu_torch.serving.streaming import (
                    StreamBacklogFull,
                )
                if server.stream_hub is None:
                    self._json(404, {"error": "no stream hub behind "
                                     "this server"})
                    return
                parts = self.path.strip("/").split("/")
                if len(parts) != 3 or parts[2] not in (
                        "enqueue", "dequeue", "ack"):
                    self._json(404, {"error": "use /streams/<name>/"
                                     "{enqueue,dequeue,ack}"})
                    return
                _, name, verb = parts
                try:
                    req = json.loads(body) if body else {}
                except Exception as e:
                    self._json(400, {"error": f"bad json: {e}"})
                    return
                try:
                    stream = server.stream_hub.get(name)
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                group = str(req.get("group", "default"))
                try:
                    if verb == "enqueue":
                        self._stream_enqueue(stream, name, req, body)
                    elif verb == "dequeue":
                        recs = stream.dequeue(
                            group, str(req.get("consumer", "consumer-0")),
                            max_records=int(req.get("max_records", 1)),
                            block_s=min(float(req.get("block_s", 0.0)),
                                        30.0))
                        out = []
                        for r in recs:
                            try:
                                doc = json.loads(r.payload)
                            except ValueError:
                                # a payload enqueued through the
                                # in-process API: shipped opaque
                                doc = {"payload_b64": base64.b64encode(
                                    r.payload).decode("ascii")}
                            request_log.event(
                                f"strm-{name}-{r.record_id}",
                                "stream_lease", stream=name, group=group,
                                attempts=r.attempts)
                            out.append({"record_id": r.record_id,
                                        "attempts": r.attempts, "doc": doc})
                        self._json(200, {"records": out, "group": group})
                    else:
                        ids = [int(r) for r in req.get("record_ids", [])]
                        n = stream.ack(group, ids)
                        for r in ids:
                            request_log.event(f"strm-{name}-{r}",
                                              "stream_ack", stream=name,
                                              group=group)
                        self._json(200, {"acked": n, "group": group})
                except StreamBacklogFull as e:
                    ra = e.retry_after_s
                    self._json(http_status_for(e),
                               {"error": str(e),
                                "retry_after_s": round(ra, 3)},
                               headers={"Retry-After": f"{ra:.3f}"})
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                except Exception as e:
                    # injected faults (the stream.* sites) and I/O
                    # errors: the taxonomy's status, never a torn
                    # connection
                    self._json(http_status_for(e),
                               {"error": f"{type(e).__name__}: {e}"})

            def _stream_enqueue(self, stream, name: str, req, body: bytes):
                """Append the body as one record; a traceparent header
                (or the ambient context) is stamped on the record
                document, so whoever leases it, now or after a crash
                replay, continues the trace."""
                tparent = trace_context.extract_headers(self.headers)
                if (body and isinstance(req, dict)
                        and trace_context.RECORD_FIELD not in req):
                    trace_context.inject_record(req, tparent)
                    if trace_context.RECORD_FIELD in req:
                        body = json.dumps(req).encode()
                record_id = stream.enqueue(body)
                rid = f"strm-{name}-{record_id}"
                fields = dict(stream=name, record_id=record_id)
                if tparent is not None:
                    fields["traceparent"] = tparent.traceparent()
                request_log.event(rid, "stream_enqueue", **fields)
                self._json(200, {"status": "queued", "uri": req.get("uri"),
                                 "stream": name, "record_id": record_id},
                           request_id=rid,
                           headers=({trace_context.TRACEPARENT_HEADER:
                                     tparent.traceparent()}
                                    if tparent is not None else None))

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if self.path == "/generate":
                    self._generate(body)
                    return
                if self.path.startswith("/streams/"):
                    self._streams(body)
                    return
                if server._predict is None:
                    self._json(400, {"error": "this server has no "
                                     "predict model (generation-only)"})
                    return
                tenant = self.headers.get("X-Tenant") or None
                if tenant is not None:
                    # the tenant's bucket is charged once, here at the
                    # door: the batcher mixes tenants in one batch
                    try:
                        server._door_admission.admit(
                            server._queue.qsize(), tenant=tenant)
                    except (QueueFull, TenantQuotaExceeded) as e:
                        ra = e.retry_after_s or 1.0
                        self._json(http_status_for(e),
                                   {"error": str(e),
                                    "retry_after_s": round(ra, 3)},
                                   headers={"Retry-After": f"{ra:.3f}"})
                        return
                arrow = (self.headers.get("Content-Type", "")
                         .startswith(ARROW_CONTENT_TYPE))
                if arrow:
                    req = {}
                    try:
                        inputs = tuple(decode_arrow_tensors(body))
                        if not inputs:
                            raise ValueError("no inputs")
                    except Exception as e:
                        self._json(400, {"error": f"bad arrow: {e}"})
                        return
                else:
                    try:
                        req = json.loads(body)
                    except Exception as e:
                        self._json(400, {"error": f"bad json: {e}"})
                        return
                    try:
                        inputs = tuple(decode_ndarray(x)
                                       for x in req.get("inputs", []))
                        if not inputs:
                            raise ValueError("no inputs")
                    except Exception as e:
                        self._json(400, {"error": str(e)})
                        return
                if self.path not in ("/predict", "/enqueue"):
                    self._json(404, {"error": "not found"})
                    return
                # a client's traceparent (the header, or the record
                # field an /enqueue body carries) parents the handler's
                # span; the batch it joins links back to that span
                tparent = (trace_context.extract_headers(self.headers)
                           or trace_context.extract_record(req))
                with trace_context.bind(tparent), trace(
                        "serving.http_request", path=self.path,
                        records=len(inputs[0])) as span:
                    echo = server._traceparent(span)
                    if self.path == "/predict":
                        out, err = server._submit(inputs)
                    else:
                        uri = (req.get("uri")
                               or f"req-{time.monotonic_ns()}")
                        with server._results_lock:
                            # a re-used uri must not inherit a stale
                            # tombstone or a previous request's
                            # unfetched result
                            server._expired.pop(uri, None)
                            server._results.pop(uri, None)
                        threading.Thread(
                            target=server._submit_async,
                            args=(uri, inputs, span), daemon=True).start()
                if self.path == "/enqueue":
                    self._json(200, {"status": "queued", "uri": uri},
                               headers=echo)
                elif err:
                    self._json(500, {"error": err}, headers=echo)
                elif arrow:
                    self._body(200, encode_arrow_tensors(list(out)),
                               ARROW_CONTENT_TYPE, headers=echo)
                else:
                    self._json(200, {"outputs": [
                        encode_ndarray(o) for o in out]}, headers=echo)

        return Handler

    def _generation_target(self):
        """What /generate submits to: the registry, the router or the
        engine (None without one)."""
        return (self.model_registry if self.model_registry is not None
                else self.router if self.router is not None
                else self.generation_engine)

    def replicas(self) -> int:
        """Model replicas behind the server: the pool's workers, the
        router's engines, else 1."""
        if self.worker_pool is not None:
            return self.worker_pool.n_workers
        if self.router is not None:
            return len(self.router.replicas)
        return 1

    @staticmethod
    def _traceparent(span) -> Dict[str, str]:
        """The `traceparent` header naming `span` in its trace."""
        return {trace_context.TRACEPARENT_HEADER: trace_context.TraceContext(
            span.trace_id, span.span_id).traceparent()}

    @staticmethod
    def _echo(request_headers, headers: Optional[Dict[str, str]]
              ) -> Dict[str, str]:
        """`headers` plus the client's X-Model / X-Tenant, echoed back on
        every response unless the handler set them itself."""
        out = dict(headers or {})
        for h in ("X-Model", "X-Tenant"):
            v = request_headers.get(h)
            if v and h not in out:
                out[h] = v
        return out

    # ------------------------------------------------------------------
    # the batcher
    # ------------------------------------------------------------------

    def _submit(self, inputs: Tuple[np.ndarray, ...], span=None):
        """A single-record (or pre-batched) request joins the dynamic
        batch; blocks until its results are ready.  `span` (default the
        current one) parents the batch's span."""
        p = _Pending(inputs, span)
        self._queue.put(p)
        p.event.wait()
        return p.outputs, p.error

    def _submit_async(self, uri: str, inputs, span=None):
        out, err = self._submit(inputs, span)
        payload = ({"status": "error", "error": err} if err else
                   {"status": "ok",
                    "outputs": [encode_ndarray(o) for o in out]})
        t = time.monotonic()
        with self._results_lock:
            for k in [k for k, (t0, _) in self._results.items()
                      if t - t0 > self._result_ttl_s]:
                del self._results[k]
                self._expired[k] = t
            while len(self._results) >= self._max_results:
                # dicts iterate in insertion order: evict the oldest
                k = next(iter(self._results))
                del self._results[k]
                self._expired[k] = t
            while len(self._expired) > self._max_results:
                del self._expired[next(iter(self._expired))]
            self._expired.pop(uri, None)
            self._results[uri] = (t, payload)

    def _result(self, uri: str) -> Dict[str, Any]:
        """GET /result/<uri>: the result (handed out once), "expired" for
        an evicted uri, else "pending"."""
        with self._results_lock:
            if uri in self._results:
                return self._results.pop(uri)[1]
            if uri in self._expired:
                return {"status": "expired"}
        return {"status": "pending"}

    @property
    def records_served(self) -> int:
        if self.worker_pool is not None:
            return self.worker_pool.records_served
        return self.model.records_served if self.model is not None else 0

    def _batcher(self):
        """Drain the queue into batches.  Batches run concurrently, up
        to the pool's workers or the model's `supported_concurrent_num`
        on an executor, with a semaphore of twice that bounding the
        batches in flight (so the executor's queue cannot grow without
        bound under overload).  A pool gets an executor even at one
        worker: its batch runs in another process."""
        executor = gate = None
        n_conc = (self.worker_pool.n_workers if self.worker_pool is not None
                  else getattr(self.model, "supported_concurrent_num", 1))
        if self.worker_pool is not None or n_conc > 1:
            executor = ThreadPoolExecutor(max_workers=n_conc)
            gate = threading.Semaphore(2 * n_conc)
        # adaptive deadline state: EMA of the gaps between the requests'
        # enqueue times, seeded at the full window
        last_enq = None

        def observe(p: _Pending):
            nonlocal last_enq
            if last_enq is not None:
                gap = max(p.t_enqueue - last_enq, 0.0)
                self._ema_gap_s += 0.2 * (gap - self._ema_gap_s)
            last_enq = p.t_enqueue

        try:
            while not self._stop.is_set():
                try:
                    first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                batch = [first]
                observe(first)
                # flush on full first: records already waiting never pay
                # a straggler window
                while len(batch) < self.max_batch_size:
                    try:
                        p = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    batch.append(p)
                    observe(p)
                window = self.batch_timeout_s
                if self.adaptive_batching:
                    window = min(window, self.adaptive_k * self._ema_gap_s)
                deadline = time.monotonic() + window
                while len(batch) < self.max_batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        p = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    batch.append(p)
                    observe(p)
                if executor is None:
                    self._run_batch(batch)
                    continue
                # polled, so stop() still ends this thread when every
                # slot is held
                while not self._stop.is_set():
                    if gate.acquire(timeout=0.05):
                        fut = executor.submit(self._run_batch, batch)
                        fut.add_done_callback(lambda _f: gate.release())
                        break
                else:
                    for p in batch:
                        p.error = "server stopped"
                        p.event.set()
        finally:
            if executor is not None:
                executor.shutdown(wait=False)

    def _run_batch(self, batch: List[_Pending]):
        # on the batcher or an executor thread: the span links to the
        # first request's span explicitly, as the contextvar did not
        # follow it across the queue
        with trace("serving.run_batch", parent=batch[0].span,
                   batch_size=len(batch)) as span:
            try:
                sizes = [len(p.inputs[0]) for p in batch]
                span.attrs["records"] = sum(sizes)
                # timings are recorded only on success: the mixed-shape
                # fallback re-runs per request
                t0 = now()
                stacked = tuple(np.concatenate([p.inputs[i] for p in batch])
                                for i in range(len(batch[0].inputs)))
                t1 = now()
                outs = self._predict(*stacked)
                t2 = now()
                self.timer.record(
                    "queue_wait",
                    sum(t0 - p.t_enqueue for p in batch) / len(batch),
                    sum(sizes))
                self.timer.record("batch_assemble", t1 - t0, sum(sizes))
                self.timer.record("predict", t2 - t1, sum(sizes))
                span.attrs["predict_s"] = round(t2 - t1, 6)
                self._c_records.inc(sum(sizes))
                self._c_batches.inc()
                with self._stats_lock:
                    self._batches_run += 1
                if not isinstance(outs, tuple):
                    outs = (outs,)
                off = 0
                for p, n in zip(batch, sizes):
                    p.outputs = [o[off:off + n] for o in outs]
                    off += n
                    p.event.set()
            except Exception as e:
                # mixed shapes in one batch: fall back to per request
                if len(batch) > 1:
                    for p in batch:
                        self._run_batch([p])
                    return
                batch[0].error = f"{type(e).__name__}: {e}"
                _log.warning("batch of %d records failed: %s",
                             len(batch[0].inputs[0]), batch[0].error)
                batch[0].event.set()

    def stats(self) -> Dict[str, Any]:
        """The GET /stats payload: counters, the batcher's queue depth
        and window, the replica count, the per-op timer summaries, the
        goodput ratio, the engine's lanes, the pool's and the router's
        rows, the streams, the registry and the tenant ledger, the
        dispatch ledger's rows; with a generation target the `requests`
        and `blame` blocks, with a router or `observability_dir` the
        `fleet` block (JAX server.py:1151-1245)."""
        out: Dict[str, Any] = {
            "records_served": self.records_served,
            "batches_run": self._batches_run,
            "queue_depth": self._queue.qsize(),
            "replicas": self.replicas(),
            "timers": self.timer.summary(),
            "goodput_ratio": round(process_goodput_ratio(), 4),
            "batcher": {
                "adaptive": self.adaptive_batching,
                "window_s": self.batch_timeout_s,
                "ema_interarrival_s": round(self._ema_gap_s, 6),
            },
        }
        if self.worker_pool is not None:
            out["worker_pool"] = {
                "n_workers": self.worker_pool.n_workers,
                "busy": self.worker_pool.busy_workers,
                "utilization": self.worker_pool.utilization(),
                "per_worker_served": self.worker_pool.per_worker_served(),
            }
        if self.router is not None:
            out["router"] = self.router.stats()
        eng = self.generation_engine
        if eng is not None:
            out["generation"] = {
                "active_slots": len(eng.scheduler.running()),
                "max_slots": eng.max_slots,
                "queue_depth": len(eng.scheduler.waiting),
                "cache_occupancy": eng.cache.allocator.occupancy(),
                "preemptions": eng.scheduler.n_preemptions,
                "tokens_total": eng.n_tokens,
            }
        ledger = profiling.ledger_snapshot()
        if ledger["families"]:
            # GET /dispatch's rows and MFU without the compile tail
            ledger.pop("compile_events", None)
            out["dispatch"] = ledger
        if self.stream_hub is not None:
            out["streams"] = self.stream_hub.stats()
        if self.model_registry is not None:
            out["registry"] = self.model_registry.stats()
            # shadow traffic judged apart: a slow candidate never dents
            # the primary attainment below
            out["shadow"] = get_shadow_slo_tracker().snapshot()
        if OrcaContext.tenant_quotas is not None:
            out["tenants"] = get_tenant_ledger().stats()
        if self._generation_target() is not None:
            rl = request_log.get_request_log()
            slo = get_slo_tracker().snapshot()
            out["requests"] = {
                "active": rl.active_count(),
                "finished_in_ring": rl.finished_count(),
                "slo_attainment": slo["attainment"],
                "slo_attainment_by_model": slo["attainment_by_model"],
                "slo_attainment_by_tenant": slo["attainment_by_tenant"],
                "slo_targets": slo["targets"],
            }
            # the full rollup is GET /blame's
            out["blame"] = get_blame_tracker().stats_block()
        if (self.router is not None
                or OrcaContext.observability_dir is not None):
            # per-source attainment, live and spooled, per-replica
            # attainment, and the judged-weighted fleet number
            out["fleet"] = self.fleet().fleet_slo()
        return out

    def fleet(self) -> FleetAggregator:
        """The server's FleetAggregator (made once, so the fleet_*
        counters tell one story)."""
        if self._fleet_agg is None:
            self._fleet_agg = FleetAggregator.from_server(self)
        return self._fleet_agg

    # ------------------------------------------------------------------

    def start(self, block: bool = False, http: bool = True):
        """Start the batcher, the generation target's loops and, with
        `http`, the HTTP listener (`http=False` runs the batcher alone,
        for a gRPC front end that is the only ingress: no port is
        bound); with `block`, serve until stop()."""
        self._stop.clear()
        t1 = threading.Thread(target=self._batcher, daemon=True,
                              name="serving-batcher")
        t1.start()
        self._threads = [t1]
        target = self._generation_target()
        if target is not None:
            target.ensure_started()
        if http:
            if self._httpd is None:
                self._httpd = _HTTPServer(self._requested_addr,
                                          self._handler_class())
                self.host, self.port = self._httpd.server_address[:2]
            t2 = threading.Thread(target=self._httpd.serve_forever,
                                  daemon=True, name="serving-http")
            t2.start()
            self._http_started = True
            self._threads.append(t2)
        if block:
            self._threads[-1].join()
        return self

    def stop(self):
        self._stop.set()
        target = self._generation_target()
        if target is not None:
            target.stop()
        if self._httpd is not None:
            if self._http_started:
                self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._http_started = False
        # wake requests still queued behind the stopped batcher: their
        # handler threads wait on event.wait() with no timeout
        try:
            while True:
                p = self._queue.get_nowait()
                p.error = "server stopped"
                p.event.set()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []


class _HTTPServer(ThreadingHTTPServer):
    # the default backlog of 5 would refuse a burst of concurrent
    # clients, the point of a batching server
    request_queue_size = 128
    daemon_threads = True
