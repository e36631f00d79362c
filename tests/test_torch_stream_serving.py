"""The port's serving front end over this slice's back ends, against the
JAX package's on the CPU.

* /streams/<name>/{enqueue,dequeue,ack} and the client's
  `enqueue(stream=)`, `OutputQueue.ack` and `consume`: the same calls
  against JAX's server and the port's, each over its own `StreamHub`,
  give the same statuses and JSON bodies (the 429 of a full backlog with
  its Retry-After, a bad name's 400, a route without a hub's 404), and
  either package's client works against either server.
* Durable ingest drained by `predict_consumer` over a worker pool and by
  an engine's `consume_stream`: every accepted record comes out once,
  its output equal to the back end's own (exactly for generation, 1e-6
  for NCF scores), and a record's generation request id is
  ``strm-<stream>-<id>``.
* /generate behind X-Tenant: 429 with Retry-After once the tenant's
  bucket is empty; a `ModelRegistry` resolves X-Model (the response
  names the model@version, 404 for an unknown model).
* `start_serving` with ``replicas=2`` serves from two worker processes,
  and with ``protocol="both"`` the gRPC front end answers what HTTP
  does; the gRPC wire bytes are JAX's (`encode_predict_request` and the
  other encoders).

One worker pool (start_serving's) and one small engine per module; one
torch thread."""

import json
import socket
import urllib.request

import numpy as np
import pytest
import torch

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from _torch_generation_cases import jax_params, port_engine, port_model
from analytics_zoo_tpu.serving import ServingServer as JaxServer
from analytics_zoo_tpu.serving import grpc_frontend as jax_grpc
from analytics_zoo_tpu.serving.client import (
    InputQueue as JaxInputQueue,
    OutputQueue as JaxOutputQueue,
)
from analytics_zoo_tpu.serving.streaming import StreamHub as JaxHub
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
from analytics_zoo_tpu_torch.observability import request_log
from analytics_zoo_tpu_torch.observability.registry import MetricsRegistry
from analytics_zoo_tpu_torch.serving import (
    InferenceModel,
    InputQueue,
    OutputQueue,
    ServingConfig,
    ServingServer,
    grpc_frontend,
    start_serving,
    stop_serving,
)
from analytics_zoo_tpu_torch.serving.control_plane import (
    ModelRegistry,
    reset_tenant_ledger,
)
from analytics_zoo_tpu_torch.serving.streaming import (
    StreamHub,
    predict_consumer,
)

TOL = 1e-6
NCF = dict(user_count=50, item_count=40, class_num=2, user_embed=8,
           item_embed=8, hidden_layers=(16, 8), mf_embed=4)
HTTP_TIMEOUT = 30


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    torch.manual_seed(0)
    path = str(tmp_path_factory.mktemp("ncf"))
    NeuralCF(**NCF, device="cpu").save_model(path)
    rng = np.random.default_rng(5)
    u = rng.integers(1, NCF["user_count"] + 1, 12).astype(np.int32)
    i = rng.integers(1, NCF["item_count"] + 1, 12).astype(np.int32)
    want = InferenceModel().load_model(path, device="cpu").predict(u, i)
    return path, u, i, want


@pytest.fixture(scope="module")
def served(saved):
    """start_serving with 2 worker processes and both protocols."""
    servers = start_serving(ServingConfig(
        modelPath=saved[0], port=0, grpcPort=0, replicas=2,
        protocol="both", batchTimeoutMs=1.0, maxBatchSize=16),
        device="cpu")
    yield servers
    stop_serving(servers)


@pytest.fixture(scope="module")
def lm():
    return port_model(jax_params())


def engine(lm):
    return port_engine(lm, max_slots=4, block_size=8, max_context=64,
                       registry=MetricsRegistry())


def _call(srv, path, payload=None, headers=None):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


# ----------------------------------------------------------------------
# /streams against JAX's server
# ----------------------------------------------------------------------

def _stream_scene(srv, iq, oq):
    """One scripted run of the stream routes and the client; every
    answer, in order."""
    out = []
    for k in range(3):
        iq.enqueue(f"rec-{k}", stream="s", x=np.arange(k + 2,
                                                       dtype=np.float32))
        out.append(iq.last_record_id)
    code, headers, body = _call(srv, "/streams/s/enqueue", {"uri": "over"})
    out.append((code, json.loads(body), "Retry-After" in headers))
    code, _, body = _call(srv, "/streams/s/dequeue",
                          {"group": "g", "consumer": "a",
                           "max_records": 2})
    recs = json.loads(body)["records"]
    out.append((code, [(r["record_id"], r["attempts"], r["doc"]["uri"])
                       for r in recs]))
    out.append(oq.ack("s", "g", [recs[0]["record_id"]]))
    out.append(oq.ack("s", "g", [recs[0]["record_id"]]))   # a no-op
    got = list(oq.consume("s", group="h", consumer="c", block_s=0.0))
    out.append([(rid, doc["uri"], doc["inputs"][0].tolist())
                for rid, doc in got])
    out.append(_call(srv, "/streams/bad%20name/enqueue", {})[0])
    out.append(_call(srv, "/streams/s/peek", {})[0])
    code, _, body = _call(srv, "/streams/s/ack",
                          {"group": "g", "record_ids": [99]})
    out.append((code, json.loads(body)))
    return out


def test_the_stream_routes_answer_as_jax_does(tmp_path):
    port_srv = ServingServer(stream_hub=StreamHub(str(tmp_path / "p"),
                                                  max_backlog=3)).start()
    jax_srv = JaxServer(stream_hub=JaxHub(str(tmp_path / "j"),
                                          max_backlog=3), port=0).start()
    try:
        got = _stream_scene(port_srv, InputQueue(port_srv.host,
                                                 port_srv.port),
                            OutputQueue(port_srv.host, port_srv.port))
        # JAX's server driven by the port's client, and the reverse
        want = _stream_scene(jax_srv, InputQueue(jax_srv.host,
                                                 jax_srv.port),
                             JaxOutputQueue(jax_srv.host, jax_srv.port))
        assert got == want
        assert got[:3] == [1, 2, 3]
        assert got[3][0] == 429 and got[3][2]
        # the client sends one record: a batch of 1
        assert got[7] == [(1, "rec-0", [[0.0, 1.0]]),
                          (2, "rec-1", [[0.0, 1.0, 2.0]]),
                          (3, "rec-2", [[0.0, 1.0, 2.0, 3.0]])]
        assert got[8:10] == [400, 404]
        stats = json.loads(_call(port_srv, "/stats")[2])
        assert stats["streams"]["s"]["groups"]["h"]["lag"] == 0
        jq = JaxInputQueue(port_srv.host, port_srv.port)
        jq.enqueue("from-jax", stream="t", x=np.ones(2, np.float32))
        assert jq.last_record_id == 1
        code, headers, _ = _call(port_srv, "/streams/t/enqueue", {"a": 1})
        assert code == 200 and headers["X-Request-Id"] == "strm-t-2"
    finally:
        port_srv.stop()
        jax_srv.stop()
    nohub = ServingServer(model=InferenceModel()).start()
    try:
        assert _call(nohub, "/streams/s/enqueue", {})[0] == 404
    finally:
        nohub.stop()


# ----------------------------------------------------------------------
# durable ingest drained by both back ends
# ----------------------------------------------------------------------

def test_predict_consumer_drains_into_the_worker_pool(served, saved,
                                                      tmp_path):
    path, u, i, want = saved
    pool = served["pool"]
    hub = StreamHub(str(tmp_path / "hub"))
    srv = ServingServer(stream_hub=hub).start()
    try:
        iq = InputQueue(srv.host, srv.port)
        for k in range(len(u)):
            iq.enqueue(f"r{k}", stream="in", user=u[k], item=i[k])
        consumer = predict_consumer(hub.get("in"), pool.predict,
                                    out_stream=hub.get("out"),
                                    batch_size=4, poll_s=0.01)
        results = list(OutputQueue(srv.host, srv.port).consume(
            "out", group="reader", n=len(u), block_s=1.0))
        consumer.stop()
    finally:
        srv.stop()
    by_uri = {doc["uri"]: doc for _, doc in results}
    assert sorted(by_uri) == sorted(f"r{k}" for k in range(len(u)))
    for k in range(len(u)):
        np.testing.assert_allclose(by_uri[f"r{k}"]["outputs"][0],
                                   want[k:k + 1], atol=TOL)
    assert hub.get("in").lag("predict") == 0
    hub.close()


def test_an_engine_consumes_a_stream_under_stable_ids(lm, tmp_path):
    eng = engine(lm).ensure_started()
    hub = StreamHub(str(tmp_path / "hub"))
    from analytics_zoo_tpu_torch.serving.codec import encode_record
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7]]
    try:
        ids = [hub.get("gen").enqueue(encode_record(
            {"uri": f"p{k}", "tokens": p, "max_new_tokens": 5}))
            for k, p in enumerate(prompts)]
        consumer = eng.consume_stream(hub.get("gen"),
                                      out_stream=hub.get("done"),
                                      poll_s=0.01)
        out = hub.get("done")
        import time
        t0 = time.monotonic()
        while out.log.last_id < len(prompts):
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        consumer.stop()
        docs = [json.loads(out.log.read(r)) for r in out.log.ids()]
        single = engine(lm)
        for doc in docs:
            k = int(doc["uri"][1:])
            assert doc["request_id"] == f"strm-gen-{ids[k]}"
            assert doc["tokens"] == single.generate(prompts[k],
                                                    max_new_tokens=5)
            # the lease is on the request's trail (the ack lands after
            # the record closed, as in JAX)
            kinds = [e["kind"] for e in
                     request_log.get(doc["request_id"])["events"]]
            assert "stream_lease" in kinds
        assert hub.get("gen").lag("generate") == 0
    finally:
        eng.stop()
        hub.close()


# ----------------------------------------------------------------------
# /generate: tenants and the registry
# ----------------------------------------------------------------------

def test_generate_sheds_an_over_quota_tenant_with_429(lm):
    reset_tenant_ledger()
    OrcaContext.tenant_quotas = {"free": {"rate": 0.01, "burst": 2}}
    srv = ServingServer(generation_engine=engine(lm)).start()
    try:
        q = InputQueue(srv.host, srv.port, tenant="free")
        assert len(q.generate_tokens([1, 2, 3], max_new_tokens=2)) == 2
        assert len(q.generate_tokens([1, 2, 3], max_new_tokens=2)) == 2
        code, headers, body = _call(srv, "/generate",
                                    {"tokens": [1, 2, 3]},
                                    {"X-Tenant": "free"})
        assert code == 429 and headers["X-Tenant"] == "free"
        assert float(headers["Retry-After"]) > 1.0
        assert json.loads(body)["retry_after_s"] > 1.0
        # another tenant, and the request class, go through
        code, _, _ = _call(srv, "/generate",
                           {"tokens": [1, 2], "request_class": "batch"},
                           {"X-Tenant": "gold"})
        assert code == 200
        code, _, _ = _call(srv, "/generate",
                           {"tokens": [1, 2], "request_class": "bulk"})
        assert code == 400
        stats = json.loads(_call(srv, "/stats")[2])
        assert stats["tenants"]["free"]["shed"] == 1
    finally:
        srv.stop()
        OrcaContext.tenant_quotas = None
        reset_tenant_ledger()


def test_generate_resolves_x_model_through_the_registry(lm):
    reg = ModelRegistry(metrics_registry=MetricsRegistry())
    reg.register("chat", "v1", engine(lm), warm=False)
    reg.register("chat", "v2", engine(lm), warm=False)
    srv = ServingServer(model_registry=reg).start()
    try:
        q = InputQueue(srv.host, srv.port, model="chat")
        toks = q.generate_tokens([4, 5, 6], max_new_tokens=3)
        assert q.last_model == "chat@v1" and len(toks) == 3
        reg.hot_swap("chat", "v2")
        assert q.generate_tokens([4, 5, 6], max_new_tokens=3) == toks
        assert q.last_model == "chat@v2"
        code, _, body = _call(srv, "/generate", {"tokens": [1]},
                              {"X-Model": "poem"})
        assert code == 404 and "poem" in json.loads(body)["error"]
        stats = json.loads(_call(srv, "/stats")[2])
        assert stats["registry"]["models"]["chat"]["serving"] == "v2"
        assert "shadow" in stats
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="model_registry"):
        ServingServer(model_registry=reg, generation_engine=engine(lm))


# ----------------------------------------------------------------------
# start_serving: the worker pool and gRPC
# ----------------------------------------------------------------------

def test_start_serving_with_two_replicas_and_both_protocols(served, saved):
    path, u, i, want = saved
    srv = served["http"]
    assert served["model"] is None and served["pool"].n_workers == 2
    http = InputQueue(srv.host, srv.port).predict(u, i, batched=True)
    np.testing.assert_allclose(http, want, atol=TOL)
    g = grpc_frontend.GrpcInputQueue(srv.host, served["grpc"].port)
    try:
        np.testing.assert_array_equal(
            g.predict(u.astype(np.float32), i.astype(np.float32),
                      batched=True),
            InputQueue(srv.host, srv.port).predict(
                u.astype(np.float32), i.astype(np.float32), batched=True))
        np.testing.assert_allclose(
            g.predict(np.float32(u[0]), np.float32(i[0])), want[0],
            atol=TOL)
    finally:
        g.close()
    health = json.loads(_call(srv, "/healthz")[2])
    assert health["replicas"] == 2


def test_a_grpc_only_config_binds_no_http_port(saved):
    servers = start_serving(ServingConfig(
        modelPath=saved[0], port=0, grpcPort=0, protocol="grpc",
        batchTimeoutMs=1.0), device="cpu")
    try:
        assert "http" not in servers and servers["_batcher"]._httpd is None
        g = grpc_frontend.GrpcInputQueue("127.0.0.1",
                                         servers["grpc"].port)
        try:
            np.testing.assert_allclose(
                g.predict(saved[1].astype(np.float32),
                          saved[2].astype(np.float32), batched=True),
                saved[3], atol=TOL)
        finally:
            g.close()
    finally:
        stop_serving(servers)
    with socket.socket() as s:
        s.settimeout(5)
        assert s.connect_ex(("127.0.0.1", servers["grpc"].port)) != 0


@pytest.mark.parametrize("shapes", [[(3,)], [(2, 3), (2,)], [(1, 2, 2)],
                                    [()]])
def test_grpc_wire_bytes_equal_jax(shapes):
    rng = np.random.default_rng(len(shapes))
    arrays = tuple(rng.standard_normal(s).astype(np.float32)
                   for s in shapes)
    req = grpc_frontend.encode_predict_request(arrays)
    assert req == jax_grpc.encode_predict_request(arrays)
    for a, b in zip(grpc_frontend.decode_predict_request(req), arrays):
        np.testing.assert_array_equal(a, b.reshape(a.shape))
    resp = grpc_frontend.encode_predict_response(arrays)
    assert resp == jax_grpc.encode_predict_response(arrays)
    assert grpc_frontend.decode_predict_response(resp)[1] is None
    err = grpc_frontend.encode_predict_response(None, "ValueError: bad")
    assert err == jax_grpc.encode_predict_response(None, "ValueError: bad")
    assert grpc_frontend.decode_predict_response(err) == \
        ([], "ValueError: bad")
