"""Serving python client (a port of analytics_zoo_tpu/serving/client.py;
reference: `pyzoo/zoo/serving/client.py` — `InputQueue.enqueue/predict`
:95,157 and `OutputQueue.dequeue` :247,251).

The wire is the serving server's HTTP API (either package's server):

    input_q = InputQueue(host, port)
    input_q.enqueue("my-img", t=np.array(...))      # async
    out = OutputQueue(host, port).dequeue("my-img")  # poll result

    preds = input_q.predict(np.array(...))           # sync
    tokens = input_q.generate_tokens(prompt, max_new_tokens=32)

A call made inside a span (or under `trace_context.bind`) carries its
W3C `traceparent` header, so the server's span joins the caller's
trace; /enqueue's body carries it as a record field too.  The
`traceparent` a /generate response echoes lands in `last_traceparent`.
The durable-stream side: `enqueue(stream="name")` appends to the
server's crash-safe stream log, and `OutputQueue.consume` /
`OutputQueue.ack` drain a stream as a consumer group.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Any, Dict, Optional

import numpy as np

from analytics_zoo_tpu_torch.observability import trace_context
from analytics_zoo_tpu_torch.serving.codec import (
    decode_ndarray,
    encode_ndarray,
)


def _post(url: str, payload: Dict[str, Any], timeout: float = 60.0,
          headers: Optional[Dict[str, str]] = None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        # error responses carry a JSON body ({"error": ...}) — surface it
        body = e.read()
        try:
            return json.loads(body)
        except Exception:
            raise e from None


def _post_bytes(url: str, blob: bytes, content_type: str,
                timeout: float = 60.0,
                headers: Optional[Dict[str, str]] = None) -> bytes:
    """Raw-body POST sharing _post's error-body handling (error
    responses are JSON even on binary endpoints)."""
    req = urllib.request.Request(
        url, data=blob, headers=dict({"Content-Type": content_type},
                                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read()
    except urllib.error.HTTPError as e:
        try:
            err = json.loads(e.read()).get("error", str(e))
        except Exception:
            err = str(e)
        raise RuntimeError(f"serving error: {err}") from None


def _get(url: str, timeout: float = 60.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


class InputQueue:
    def __init__(self, host: str = "127.0.0.1", port: int = 10020,
                 codec: str = "json", model: Optional[str] = None,
                 tenant: Optional[str] = None):
        """`codec`: "json" (base64 ndarrays, the reference client
        default) or "arrow" (Arrow IPC binary tensors — the reference's
        Arrow serialization, smaller and faster on big payloads).

        `model` / `tenant` attribute every request this queue sends: they
        ride as X-Model / X-Tenant headers (and as record fields on the
        durable-stream path); the server resolves X-Model through its
        ModelRegistry's A/B and shadow policies and charges X-Tenant's
        quota bucket.  Both can be overridden per call."""
        if codec not in ("json", "arrow"):
            raise ValueError("codec must be 'json' or 'arrow'")
        self.base = f"http://{host}:{port}"
        self.codec = codec
        self.model = model
        self.tenant = tenant

    def _attribution(self, model: Optional[str],
                     tenant: Optional[str]) -> Dict[str, str]:
        """X-Model/X-Tenant headers from the per-call override or the
        queue's defaults (empty when neither is set)."""
        headers: Dict[str, str] = {}
        model = model if model is not None else self.model
        tenant = tenant if tenant is not None else self.tenant
        if model:
            headers["X-Model"] = str(model)
        if tenant:
            headers["X-Tenant"] = str(tenant)
        return headers

    def predict(self, *inputs: np.ndarray, batched: bool = False):
        """Synchronous prediction.  By default each input is ONE record
        (no batch dim) — the server adds it to a dynamic batch; pass
        batched=True to send pre-batched [n, ...] arrays."""
        arrays = [np.asarray(a) for a in inputs]
        if not batched:
            arrays = [a[None] for a in arrays]
        headers = trace_context.inject_headers(
            self._attribution(None, None))
        if self.codec == "arrow":
            from analytics_zoo_tpu_torch.serving.codec import (
                ARROW_CONTENT_TYPE,
                decode_arrow_tensors,
                encode_arrow_tensors,
            )
            outs = decode_arrow_tensors(_post_bytes(
                f"{self.base}/predict", encode_arrow_tensors(arrays),
                ARROW_CONTENT_TYPE, headers=headers))
        else:
            resp = _post(f"{self.base}/predict",
                         {"inputs": [encode_ndarray(a) for a in arrays]},
                         headers=headers)
            if "error" in resp:
                raise RuntimeError(f"serving error: {resp['error']}")
            outs = [decode_ndarray(o) for o in resp["outputs"]]
        if not batched:
            outs = [o[0] for o in outs]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def predict_image(self, image, resize=None):
        """Predict on ONE image given as a file path or raw JPEG/PNG
        bytes — the reference's base64-image payload
        (pyzoo/zoo/serving/client.py:157, decoded server-side like
        PreProcessing.decodeImage).  The server sees a float32
        [1, H, W, C] pixel array (0-255); `resize` [H, W] resizes
        server-side before the model."""
        from analytics_zoo_tpu_torch.serving.codec import encode_image

        resp = _post(f"{self.base}/predict",
                     {"inputs": [encode_image(image, resize=resize)]})
        if "error" in resp:
            raise RuntimeError(f"serving error: {resp['error']}")
        outs = [decode_ndarray(o)[0] for o in resp["outputs"]]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def generate(self, tokens, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None, timeout: float = 300.0,
                 request_id: Optional[str] = None, retry=None,
                 model: Optional[str] = None,
                 tenant: Optional[str] = None):
        """Streaming generation client for POST /generate: a generator
        yielding token ids AS THE SERVER SAMPLES THEM (chunked ndjson
        lines decoded incrementally — first token arrives at decode
        latency, not request latency).  After exhaustion
        `self.last_generate` holds the final {"done", "n_tokens",
        "finish_reason"} line.  Raises RuntimeError on a server-side
        error, including mid-stream ones.

        `request_id` (optional) is sent as the X-Request-Id header;
        the id the server echoed back — success or error — lands in
        `self.last_request_id`.

        `retry` (a `resilience.RetryPolicy`) bounds re-submission when
        the server sheds (503) or the connection is refused: the
        client sleeps the server's Retry-After hint when one is sent
        (capped at the policy's `max_backoff_s`), else the policy's
        deterministic backoff, and re-sends the SAME X-Request-Id so
        the whole journey shares one id.  Retries happen only before
        the first token — a broken stream is never silently re-run.  A
        429 (a tenant over quota, from the JAX server) retries the same
        way.

        `model` / `tenant` (or the queue's defaults) ride as
        X-Model / X-Tenant; the server's echoed X-Model lands in
        `self.last_model`, its echoed `traceparent` in
        `self.last_traceparent`."""
        payload = {"tokens": [int(t) for t in tokens],
                   "max_new_tokens": max_new_tokens,
                   "temperature": temperature, "top_k": top_k,
                   "eos_id": eos_id}
        if retry is not None and request_id is None:
            # a stable id across attempts is the point of retrying
            import uuid
            request_id = f"cli-{uuid.uuid4().hex[:12]}"
        headers = {"Content-Type": "application/json"}
        headers.update(self._attribution(model, tenant))
        if request_id is not None:
            headers["X-Request-Id"] = str(request_id)
        # a call from inside a span (or under trace_context.bind) stamps
        # its context: the server's serving.generate span joins the
        # trace, the same across retries like X-Request-Id
        trace_context.inject_headers(headers)
        self.last_request_id = None
        self.last_traceparent = None
        self.last_model = None
        self.last_retries = 0
        max_attempts = retry.max_attempts if retry is not None else 1
        resp = None
        for attempt in range(1, max_attempts + 1):
            req = urllib.request.Request(
                f"{self.base}/generate",
                data=json.dumps(payload).encode(), headers=headers)
            try:
                resp = urllib.request.urlopen(req, timeout=timeout)
                break
            except urllib.error.HTTPError as e:
                self.last_request_id = e.headers.get("X-Request-Id")
                self.last_traceparent = e.headers.get(
                    trace_context.TRACEPARENT_HEADER)
                retry_after = e.headers.get("Retry-After")
                try:
                    err = json.loads(e.read()).get("error", str(e))
                except Exception:
                    err = str(e)
                if retry is None or e.code not in (429, 503) or \
                        attempt >= max_attempts:
                    raise RuntimeError(
                        f"serving error: {err}") from None
                delay = retry.backoff(attempt)
                if retry_after:
                    try:
                        # honor the server's estimate, bounded by the
                        # policy so a bad hint cannot park the client;
                        # spread() jitters it (when the policy says so)
                        # so a mass shed doesn't come back as one wave
                        delay = retry.spread(float(retry_after),
                                             attempt)
                    except ValueError:
                        pass
                retry.record_retry(e)
                self.last_retries += 1
                time.sleep(delay)
            except urllib.error.URLError as e:
                # connection refused/reset before any response
                if retry is None or attempt >= max_attempts:
                    raise
                retry.record_retry(e)
                self.last_retries += 1
                time.sleep(retry.backoff(attempt))
        self.last_request_id = resp.headers.get("X-Request-Id")
        self.last_model = resp.headers.get("X-Model")
        self.last_traceparent = resp.headers.get(
            trace_context.TRACEPARENT_HEADER)
        with resp:
            for raw in resp:           # http.client de-chunks for us
                msg = json.loads(raw)
                if "error" in msg:
                    raise RuntimeError(
                        f"serving error: {msg['error']}")
                if msg.get("done"):
                    self.last_generate = msg
                    return
                yield msg["token"]
        raise RuntimeError("generation stream ended without a "
                           "done marker")

    def generate_tokens(self, tokens, **kw):
        """Blocking convenience: drain `generate` into a list."""
        return list(self.generate(tokens, **kw))

    def enqueue(self, uri: str, stream: Optional[str] = None,
                retry=None, timeout: float = 60.0,
                model: Optional[str] = None,
                tenant: Optional[str] = None, **inputs) -> str:
        """Async enqueue of one record (reference InputQueue.enqueue);
        fetch via OutputQueue.dequeue(uri).  `model` / `tenant` (or the
        queue's defaults) ride as headers; the trace context rides as the
        header and as the body's record field.

        Durable mode: ``stream="name"`` appends the record to the
        server's crash-safe stream log (POST /streams/<name>/enqueue):
        the 200 means the frame is in the log, so a crash after it
        replays the record instead of losing it.  The record id lands in
        `self.last_record_id`.  `model` / `tenant` also ride as fields of
        the record document, so whichever consumer leases it carries the
        same attribution.  When the consumer groups cannot keep up the
        server sheds with 429 and Retry-After; `retry` (a
        `resilience.RetryPolicy`) backs off by that hint (jittered by
        `retry.spread` when the policy says so) and sends again."""
        attribution = self._attribution(model, tenant)
        arrays = [np.asarray(a)[None] for a in inputs.values()]
        payload = trace_context.inject_record(
            {"uri": uri, "inputs": [encode_ndarray(a) for a in arrays]})
        if stream is None:
            resp = _post(f"{self.base}/enqueue", payload, timeout=timeout,
                         headers=trace_context.inject_headers(attribution))
            if resp.get("status") != "queued":
                raise RuntimeError(f"enqueue failed: {resp}")
            return resp["uri"]
        self.last_record_id = None
        if attribution.get("X-Model"):
            payload["model"] = attribution["X-Model"]
        if attribution.get("X-Tenant"):
            payload["tenant"] = attribution["X-Tenant"]
        stream_headers = trace_context.inject_headers(
            dict({"Content-Type": "application/json"}, **attribution))
        max_attempts = retry.max_attempts if retry is not None else 1
        for attempt in range(1, max_attempts + 1):
            req = urllib.request.Request(
                f"{self.base}/streams/{stream}/enqueue",
                data=json.dumps(payload).encode(), headers=stream_headers)
            try:
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    resp = json.loads(r.read())
                self.last_record_id = resp.get("record_id")
                return uri
            except urllib.error.HTTPError as e:
                retry_after = e.headers.get("Retry-After")
                try:
                    err = json.loads(e.read()).get("error", str(e))
                except Exception:
                    err = str(e)
                if retry is None or e.code not in (429, 503) or \
                        attempt >= max_attempts:
                    raise RuntimeError(f"enqueue failed: {err}") from None
                delay = retry.backoff(attempt)
                if retry_after:
                    try:
                        delay = retry.spread(float(retry_after), attempt)
                    except ValueError:
                        pass
                retry.record_retry(e)
                time.sleep(delay)
        raise RuntimeError("enqueue failed: retries exhausted")


class OutputQueue:
    def __init__(self, host: str = "127.0.0.1", port: int = 10020):
        self.base = f"http://{host}:{port}"

    def dequeue(self, uri: str, timeout: float = 30.0,
                poll_interval: float = 0.01):
        """Poll until the async result for `uri` is ready (reference
        OutputQueue.dequeue over Redis)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            resp = _get(f"{self.base}/result/{uri}")
            if resp.get("status") == "ok":
                outs = [decode_ndarray(o)[0] for o in resp["outputs"]]
                return outs[0] if len(outs) == 1 else tuple(outs)
            if resp.get("status") == "error":
                raise RuntimeError(f"serving error: {resp['error']}")
            time.sleep(poll_interval)
        raise TimeoutError(f"no result for {uri} within {timeout}s")

    def ack(self, stream: str, group: str, record_ids) -> int:
        """Ack leased records (POST /streams/<s>/ack); `consume` does
        this itself, this is for callers driving the dequeue route."""
        resp = _post(f"{self.base}/streams/{stream}/ack",
                     {"group": group,
                      "record_ids": [int(r) for r in record_ids]})
        if "error" in resp:
            raise RuntimeError(f"serving error: {resp['error']}")
        return int(resp.get("acked", 0))

    def consume(self, stream: str, group: str = "default",
                consumer: str = "consumer-0", n: Optional[int] = None,
                block_s: float = 1.0, decode: bool = True,
                timeout: float = 30.0):
        """Consumer-group generator over a durable stream: long-poll
        dequeue (POST /streams/<s>/dequeue) as `group` / `consumer`,
        yielding ``(record_id, doc)`` pairs, each acked only when the
        caller comes back for the next one: a loop body that raises (or
        a consumer that dies mid-record) leaves its record unacked, and
        the stream replays it after the lease expires, under the same
        id.  `n` bounds the records consumed; ``n=None`` drains until a
        `block_s` long poll comes back empty.  ``decode=True`` runs each
        doc through `codec.decode_record` (base64 ndarrays -> arrays)."""
        from analytics_zoo_tpu_torch.serving.codec import decode_record

        yielded = 0
        while n is None or yielded < n:
            resp = _post(f"{self.base}/streams/{stream}/dequeue",
                         {"group": group, "consumer": consumer,
                          "max_records": 1, "block_s": block_s},
                         timeout=timeout + block_s)
            if "error" in resp:
                raise RuntimeError(f"serving error: {resp['error']}")
            recs = resp.get("records", [])
            if not recs:
                if n is None:
                    return           # drained
                continue             # a bounded consume keeps waiting
            for r in recs:
                doc = decode_record(r["doc"]) if decode else r["doc"]
                yield r["record_id"], doc
                # the caller came back: the record is processed
                yielded += 1
                self.ack(stream, group, [r["record_id"]])
