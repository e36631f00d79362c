"""Stream consumers: both serving back ends draining a `DurableStream`
as a consumer group (a port of analytics_zoo_tpu/serving/streaming/
consumer.py; reference: Cluster Serving's Flink consumers pulling from
the Redis stream).

A consumer is a daemon thread in a group: it leases records, runs its
back end, appends the result to an OUT stream, and only then acks, so a
replica dying mid-record lets the lease expire and a survivor replays
the record under the same record id.  For generation the request id is
``strm-<stream>-<record id>``, stable across replays, so enqueue ->
lease -> generate (perhaps re-queued across router replicas) -> ack is
one request-lifecycle trail (``stream_lease`` / ``stream_ack`` events).

At-least-once is the contract: a consumer killed after its result
append but before its ack replays the record, so result readers dedupe
by `uri` / record id."""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from analytics_zoo_tpu_torch.observability import (
    log_event,
    maybe_record,
    maybe_spool,
    request_log,
    trace,
    trace_context,
)
from analytics_zoo_tpu_torch.serving.codec import decode_record, encode_record
from analytics_zoo_tpu_torch.serving.streaming.stream import DurableStream


class StreamConsumer:
    """One group member: a daemon loop leasing records from `stream`,
    calling ``handler(record_doc, record)`` and acking on success.
    A raising handler leaves the record leased (it replays after the
    visibility deadline); `release_on_error=True` releases it
    immediately instead.  `kill()` models a replica death: the loop
    stops WITHOUT acking or releasing in-flight work."""

    def __init__(self, stream: DurableStream, group: str,
                 consumer: str,
                 handler: Callable[[Dict[str, Any], Any],
                                   Optional[Dict[str, Any]]],
                 out_stream: Optional[DurableStream] = None,
                 max_records: int = 1,
                 visibility_s: Optional[float] = None,
                 poll_s: float = 0.05,
                 release_on_error: bool = False):
        self.stream = stream
        self.group = group
        self.consumer = consumer
        self.handler = handler
        self.out_stream = out_stream
        self.max_records = max_records
        self.visibility_s = visibility_s
        self.poll_s = poll_s
        self.release_on_error = release_on_error
        self.records_handled = 0
        self.errors = 0
        self._stop = threading.Event()
        self._killed = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StreamConsumer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"stream-consumer-{self.group}-{self.consumer}")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                recs = self.stream.dequeue(
                    self.group, self.consumer,
                    max_records=self.max_records,
                    visibility_s=self.visibility_s,
                    block_s=self.poll_s)
            except Exception as e:
                log_event("stream_consumer_error",
                          group=self.group, consumer=self.consumer,
                          error=f"{type(e).__name__}: {e}")
                time.sleep(self.poll_s)
                continue
            for rec in recs:
                if self._stop.is_set():
                    return            # killed mid-batch: no ack
                self._handle(rec)
            # durable telemetry: this loop's last metrics/spans
            # survive a SIGKILL (no-op while observability_dir is
            # unset; time-gated otherwise)
            maybe_spool(f"consumer-{self.group}-{self.consumer}")
            maybe_record()

    def _handle(self, rec) -> None:
        try:
            doc = decode_record(rec.payload)
            # the record document carries its trace across the
            # process boundary: bind it so the handler's spans (and
            # any router dispatch under them) join the enqueuer's
            # trace — including a replay leased after a crash
            tparent = trace_context.extract_record(doc)
            with trace_context.bind(tparent):
                with trace("stream.consume",
                           stream=self.stream.name, group=self.group,
                           record_id=rec.record_id,
                           attempts=rec.attempts):
                    result = self.handler(doc, rec)
                if isinstance(result, dict):
                    trace_context.inject_record(result, tparent)
        except Exception as e:
            self.errors += 1
            log_event("stream_handler_error", group=self.group,
                      consumer=self.consumer, record_id=rec.record_id,
                      attempts=rec.attempts,
                      error=f"{type(e).__name__}: {e}")
            if self.release_on_error:
                self.stream.release(self.group, rec.record_id)
            return
        if self._killed:
            return                    # death between work and ack
        if self.out_stream is not None and result is not None:
            self.out_stream.enqueue(encode_record(result))
        self.stream.ack(self.group, rec.record_id)
        self.records_handled += 1

    def stop(self, timeout: float = 5.0) -> None:
        """Graceful stop: finish (and ack) the in-flight record."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def kill(self) -> None:
        """Abrupt replica death for tests/the overload harness: the
        in-flight record is NEVER acked — its lease expires and the
        record replays to a surviving group member."""
        self._killed = True
        self._stop.set()


def predict_consumer(stream: DurableStream, predict_fn: Callable,
                     out_stream: Optional[DurableStream] = None,
                     group: str = "predict",
                     consumer: str = "predict-0",
                     batch_size: int = 8,
                     **kw) -> StreamConsumer:
    """Batch-prediction group member over `predict_fn` (an
    `InferenceModel.predict` or `WorkerPool.predict`).  Record docs
    are the client enqueue payload: ``{"uri": ..., "inputs": [enc,
    ...]}``; the result doc is ``{"uri", "record_id", "outputs"}``.
    A replica death mid-predict (ReplicaDiedMidPredict et al) leaves
    the record unacked — the pool respawns, the lease expires, the
    record replays."""
    import numpy as np

    from analytics_zoo_tpu_torch.serving.codec import (
        decode_ndarray,
        encode_ndarray,
    )

    def handle(doc: Dict[str, Any], rec) -> Dict[str, Any]:
        inputs = tuple(np.asarray(decode_ndarray(x))
                       for x in doc.get("inputs", []))
        if not inputs:
            raise ValueError(f"record {rec.record_id}: no inputs")
        # tenant attribution travels ON the record (client.py stamps
        # it, like the traceparent) — the leasing process charges the
        # same bucket a front-door request would, replay included
        tenant = doc.get("tenant")
        if tenant is not None:
            try:
                outs = predict_fn(*inputs, tenant=str(tenant))
            except TypeError:
                # plain predict callable without admission kwargs
                outs = predict_fn(*inputs)
        else:
            outs = predict_fn(*inputs)
        if not isinstance(outs, tuple):
            outs = (outs,)
        return {"uri": doc.get("uri"), "record_id": rec.record_id,
                "outputs": [encode_ndarray(np.asarray(o))
                            for o in outs]}

    return StreamConsumer(stream, group, consumer, handle,
                          out_stream=out_stream,
                          max_records=batch_size, **kw).start()


def generation_consumer(stream: DurableStream, engine,
                        out_stream: Optional[DurableStream] = None,
                        group: str = "generate",
                        consumer: str = "generate-0",
                        **kw) -> StreamConsumer:
    """Token-generation group member over `engine` (a
    GenerationEngine, a ReplicaRouter or a control-plane
    ModelRegistry — all expose ``submit``).  Record docs: ``{"uri",
    "tokens", "max_new_tokens", "temperature", "top_k", "eos_id"}``
    plus optional ``"model"`` (registry routing) and ``"tenant"``
    (quota + SLO attribution) fields, stamped by the client like the
    traceparent.  The request id is derived from the RECORD
    id, so a replayed record re-enters the engine under the same
    lifecycle trail — composing with the router's own mid-stream
    death requeue (docs/distributed-serving.md)."""

    def handle(doc: Dict[str, Any], rec) -> Dict[str, Any]:
        rid = f"strm-{stream.name}-{rec.record_id}"
        kw: Dict[str, Any] = dict(
            max_new_tokens=int(doc.get("max_new_tokens", 32)),
            temperature=float(doc.get("temperature", 0.0)),
            top_k=int(doc.get("top_k", 0)),
            eos_id=(int(doc["eos_id"])
                    if doc.get("eos_id") is not None else None),
            request_id=rid)
        # control-plane attribution rides the record document (the
        # same idiom as the traceparent field): the leasing process —
        # engine, router or registry — charges the tenant's bucket
        # and routes the named model, replay included
        if doc.get("tenant") is not None:
            kw["tenant"] = str(doc["tenant"])
        if doc.get("model") is not None and hasattr(engine, "set_ab"):
            # only a ModelRegistry target routes by name
            kw["model"] = str(doc["model"])
        gen = engine.submit([int(t) for t in doc["tokens"]], **kw)
        rid = getattr(gen, "request_id", None) or rid
        request_log.event(rid, "stream_lease",
                          stream=stream.name,
                          record_id=rec.record_id,
                          attempts=rec.attempts)
        toks = gen.tokens() if hasattr(gen, "tokens") else list(gen)
        request_log.event(rid, "stream_ack", stream=stream.name,
                          record_id=rec.record_id)
        return {"uri": doc.get("uri"), "record_id": rec.record_id,
                "request_id": rid, "tokens": [int(t) for t in toks],
                "finish_reason": getattr(gen, "finish_reason", None)}

    return StreamConsumer(stream, group, consumer, handle,
                          out_stream=out_stream, max_records=1,
                          **kw).start()
