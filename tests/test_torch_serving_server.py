"""The port's serving front end (`analytics_zoo_tpu_torch.serving.server`)
against the JAX package's, on the CPU: a small MLP (4 -> 8 -> 3, ReLU)
with the same weights behind JAX's `ServingServer` (flax module,
`InferenceModel.load_flax`) and the port's (torch module,
`InferenceModel.load_module`).

The same requests, sent as raw HTTP, give the same status codes, the
same JSON keys and outputs within 1e-5 (the same f32 arithmetic in
another library): /predict with one record and pre-batched, in JSON and
in Arrow, /enqueue then /result (a result handed out once, then
"pending"; an evicted one "expired"), and the error cases (bad JSON, no
inputs, a wrong width, unknown paths, /predict on a generation-only
server).  Concurrent single records run in fewer batches than requests,
/metrics' `serving_*` families are JAX's, the tracing routes answer
with JAX's keys, and each package's client works against the other's
server.

Every server binds port 0 and is stopped in a `finally` block; every
HTTP call has a timeout of at most 30 s (`_clamp_timeouts` caps the
clients' longer defaults)."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import torch.nn as nn

import flax.linen as fnn
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.observability import get_registry as jax_registry
from analytics_zoo_tpu.observability import (
    parse_prometheus_text as jax_parse,
)
from analytics_zoo_tpu.serving.client import (
    InputQueue as JaxInputQueue,
    OutputQueue as JaxOutputQueue,
)
from analytics_zoo_tpu.serving.codec import encode_ndarray as jax_encode
from analytics_zoo_tpu.serving.inference_model import (
    InferenceModel as JaxInferenceModel,
)
from analytics_zoo_tpu.serving.server import ServingServer as JaxServer
from analytics_zoo_tpu_torch.observability import parse_prometheus_text
from analytics_zoo_tpu_torch.serving import (
    InferenceModel,
    InputQueue,
    OutputQueue,
    ServingServer,
)
from analytics_zoo_tpu_torch.serving.codec import (
    ARROW_CONTENT_TYPE,
    decode_ndarray,
)

TOL = 1e-5
HTTP_TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def _clamp_timeouts(monkeypatch):
    """Cap every urlopen's timeout at HTTP_TIMEOUT (the clients default
    to 60 s and more)."""
    real = urllib.request.urlopen

    def urlopen(*args, timeout=HTTP_TIMEOUT, **kw):
        return real(*args, timeout=min(timeout, HTTP_TIMEOUT), **kw)
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)


class _JaxMlp(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = fnn.relu(fnn.Dense(8, name="hidden")(x))
        return fnn.Dense(3, name="out")(h)


def _models():
    params = _JaxMlp().init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))["params"]
    jim = JaxInferenceModel(supported_concurrent_num=2,
                            max_batch_size=16).load_flax(_JaxMlp(), params)
    p = jax.tree_util.tree_map(np.asarray, params)
    mlp = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 3))
    with torch.no_grad():
        for lin, name in ((mlp[0], "hidden"), (mlp[2], "out")):
            lin.weight.copy_(torch.from_numpy(p[name]["kernel"].T.copy()))
            lin.bias.copy_(torch.from_numpy(p[name]["bias"].copy()))
    pim = InferenceModel(supported_concurrent_num=2,
                         max_batch_size=16).load_module(mlp)
    return jim, pim


@pytest.fixture(scope="module")
def servers():
    jim, pim = _models()
    started = []
    try:
        for cls, im in ((JaxServer, jim), (ServingServer, pim)):
            started.append(cls(im, max_batch_size=8,
                               batch_timeout_ms=2.0).start())
        yield started
    finally:
        for srv in started:
            srv.stop()


def _http(srv, method, path, body=None, ctype="application/json",
          headers=None):
    """(status, headers, body bytes) of one request to `srv`."""
    data = (body if isinstance(body, (bytes, type(None)))
            else json.dumps(body).encode())
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}", data=data, method=method,
        headers=dict({"Content-Type": ctype}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _both(servers, method, path, body=None, **kw):
    return [_http(s, method, path, body, **kw) for s in servers]


def _records(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)


def _outputs(body):
    return [decode_ndarray(o) for o in json.loads(body)["outputs"]]


@pytest.mark.parametrize("n", [1, 5], ids=["record", "pre_batched"])
def test_predict_json_matches_jax(servers, n):
    x = _records(n, seed=n)
    (cj, _, bj), (cp, _, bp) = _both(servers, "POST", "/predict",
                                     {"inputs": [jax_encode(x)]})
    assert cj == cp == 200
    assert json.loads(bj).keys() == json.loads(bp).keys()
    (oj,), (op,) = _outputs(bj), _outputs(bp)
    assert op.dtype == oj.dtype and op.shape == oj.shape == (n, 3)
    np.testing.assert_allclose(op, oj, atol=TOL)


@pytest.mark.parametrize("n", [1, 5], ids=["record", "pre_batched"])
def test_predict_arrow_matches_jax(servers, n):
    pytest.importorskip("pyarrow")
    from analytics_zoo_tpu.serving.codec import (
        decode_arrow_tensors as jax_decode_arrow,
        encode_arrow_tensors as jax_encode_arrow,
    )
    blob = jax_encode_arrow([_records(n, seed=10 + n)])
    (cj, hj, bj), (cp, hp, bp) = _both(servers, "POST", "/predict", blob,
                                       ctype=ARROW_CONTENT_TYPE)
    assert cj == cp == 200
    assert hj["Content-Type"] == hp["Content-Type"] == ARROW_CONTENT_TYPE
    (oj,), (op,) = jax_decode_arrow(bj), jax_decode_arrow(bp)
    np.testing.assert_allclose(op, oj, atol=TOL)


def _poll(srv, uri, deadline_s=HTTP_TIMEOUT):
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        code, _, body = _http(srv, "GET", f"/result/{uri}")
        doc = json.loads(body)
        if doc["status"] != "pending":
            return code, doc
        time.sleep(0.01)
    raise AssertionError(f"{uri} still pending")


def test_enqueue_and_result_match_jax(servers):
    x = _records(1, seed=3)
    docs = []
    for srv in servers:
        code, _, body = _http(srv, "POST", "/enqueue",
                              {"uri": "u-1", "inputs": [jax_encode(x)]})
        assert code == 200
        docs.append((json.loads(body), _poll(srv, "u-1"),
                     json.loads(_http(srv, "GET", "/result/u-1")[2])))
    (qj, (cj, rj), againj), (qp, (cp, rp), againp) = docs
    assert qj == qp == {"status": "queued", "uri": "u-1"}
    assert cj == cp == 200 and rj.keys() == rp.keys()
    np.testing.assert_allclose(decode_ndarray(rp["outputs"][0]),
                               decode_ndarray(rj["outputs"][0]), atol=TOL)
    # a result is handed out once
    assert againj == againp == {"status": "pending"}


def _wait_stored(srv, uri, deadline_s=HTTP_TIMEOUT):
    """Wait until `srv` holds `uri`'s result in its result store, read
    without handing the result out."""
    t_end = time.monotonic() + deadline_s
    while uri not in srv._results:
        if time.monotonic() > t_end:
            raise AssertionError(f"{uri} never stored")
        time.sleep(0.005)


def test_expired_uri_matches_jax():
    jim, pim = _models()
    started = []
    try:
        docs = []
        for cls, im in ((JaxServer, jim), (ServingServer, pim)):
            # a TTL of 0: storing the next result evicts the older ones;
            # "old" is stored before "new" is enqueued, so the two never
            # share a batch and "old" is older when "new" is stored
            srv = cls(im, result_ttl_s=0.0)
            started.append(srv.start())
            for uri in ("old", "new"):
                assert _http(srv, "POST", "/enqueue", {
                    "uri": uri, "inputs": [jax_encode(_records(1))]})[0] \
                    == 200
                _wait_stored(srv, uri)
            _poll(srv, "new")
            docs.append(json.loads(_http(srv, "GET", "/result/old")[2]))
        assert docs[0] == docs[1] == {"status": "expired"}
    finally:
        for srv in started:
            srv.stop()


@pytest.mark.parametrize("method,path,body,ctype", [
    ("POST", "/predict", b"{not json", "application/json"),
    ("POST", "/predict", {"inputs": []}, "application/json"),
    ("POST", "/predict", {"inputs": [jax_encode(np.ones((1, 5),
                                                        np.float32))]},
     "application/json"),
    ("POST", "/predict", b"not arrow", ARROW_CONTENT_TYPE),
    ("GET", "/nowhere", None, "application/json"),
    ("POST", "/nowhere", {"inputs": [jax_encode(np.ones((1, 4),
                                                        np.float32))]},
     "application/json"),
], ids=["bad_json", "no_inputs", "wrong_width", "bad_arrow", "unknown_get",
        "unknown_post"])
def test_errors_match_jax(servers, method, path, body, ctype):
    if ctype == ARROW_CONTENT_TYPE:
        pytest.importorskip("pyarrow")
    (cj, _, bj), (cp, _, bp) = _both(servers, method, path, body,
                                     ctype=ctype)
    assert cj == cp and cj >= 400
    assert json.loads(bj).keys() == json.loads(bp).keys() == {"error"}


@pytest.mark.parametrize("path", [
    "/spans", "/goodput", "/slo", "/timeline", "/dispatch", "/blame",
    "/debug/requests", "/metrics/history"])
def test_routes_not_ported_answer_404(servers, path):
    """The tracing routes, once 404 in the port, answer as JAX's do:
    200 with the same top-level keys."""
    (cj, _, bj), (cp, _, bp) = _both(servers, "GET", path)
    assert cj == cp == 200
    assert json.loads(bp).keys() == json.loads(bj).keys()


def test_wrong_width_is_a_serving_error_in_both_clients(servers):
    for srv in servers:
        for q in (JaxInputQueue(srv.host, srv.port),
                  InputQueue(srv.host, srv.port)):
            with pytest.raises(RuntimeError, match="serving error"):
                q.predict(np.ones(5, np.float32))


class _IdleEngine:
    """A stand-in generation engine: /predict never reaches it."""

    def ensure_started(self):
        return self

    def stop(self):
        pass


def test_predict_on_generation_only_server_matches_jax():
    started = []
    try:
        for cls in (JaxServer, ServingServer):
            started.append(cls(generation_engine=_IdleEngine()).start())
        (cj, _, bj), (cp, _, bp) = _both(
            started, "POST", "/predict", {"inputs": [jax_encode(_records(1))]})
        assert cj == cp == 400
        assert json.loads(bj) == json.loads(bp)
    finally:
        for srv in started:
            srv.stop()


def test_echoes_model_and_tenant_as_jax(servers):
    hdrs = {"X-Model": "mlp@1", "X-Tenant": "acme"}
    for code, headers, _ in _both(servers, "POST", "/predict",
                                  {"inputs": [jax_encode(_records(1))]},
                                  headers=hdrs):
        assert code == 200
        assert headers["X-Model"] == "mlp@1"
        assert headers["X-Tenant"] == "acme"


def test_concurrent_records_share_batches():
    _, pim = _models()
    srv = ServingServer(pim, max_batch_size=16, batch_timeout_ms=200.0,
                        adaptive_batching=False)
    try:
        srv.start()
        n = 12
        x = _records(n, seed=5)
        gate = threading.Barrier(n)
        got = [None] * n

        def client(i):
            q = InputQueue(srv.host, srv.port)
            gate.wait(timeout=HTTP_TIMEOUT)
            got[i] = q.predict(x[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT)
        stats = json.loads(_http(srv, "GET", "/stats")[2])
        np.testing.assert_allclose(np.stack(got), pim.predict(x), atol=TOL)
        assert stats["records_served"] == n
        assert 1 <= stats["batches_run"] < n
        assert stats["timers"]["predict"]["records"] == n
    finally:
        srv.stop()


def _serving_families(text, parse):
    return {k for k in parse(text) if k.startswith("serving_")}


def test_metrics_families_match_jax(servers):
    for srv in servers:
        InputQueue(srv.host, srv.port).predict(_records(1)[0])
    texts = [_http(s, "GET", "/metrics")[2].decode() for s in servers]
    jax_names = _serving_families(texts[0], jax_parse)
    # families other JAX code put in its process registry are not the
    # server's
    jax_names -= (_serving_families(jax_registry().prometheus_text(),
                                    jax_parse)
                  - _serving_families(servers[0].registry.prometheus_text(),
                                      jax_parse))
    port_names = _serving_families(texts[1], parse_prometheus_text)
    assert port_names == jax_names
    assert {"serving_queue_wait_seconds", "serving_predict_seconds",
            "serving_batch_assemble_seconds", "serving_records_served_total",
            "serving_batches_total", "serving_queue_depth"} <= port_names
    assert (_both(servers, "GET", "/healthz")[1][1]["Content-Type"]
            == "application/json")


@pytest.mark.parametrize("client", ["jax_client_port_server",
                                    "port_client_jax_server"])
def test_clients_work_across_packages(servers, client):
    if client == "jax_client_port_server":
        srv, iq, oq = servers[1], JaxInputQueue, JaxOutputQueue
    else:
        srv, iq, oq = servers[0], InputQueue, OutputQueue
    x = _records(4, seed=7)
    _, pim = _models()
    want = pim.predict(x)
    q = iq(srv.host, srv.port)
    np.testing.assert_allclose(q.predict(x[0]), want[0], atol=TOL)
    np.testing.assert_allclose(q.predict(x, batched=True), want, atol=TOL)
    assert q.enqueue(f"x-{client}", t=x[1]) == f"x-{client}"
    np.testing.assert_allclose(
        oq(srv.host, srv.port).dequeue(f"x-{client}", timeout=HTTP_TIMEOUT),
        want[1], atol=TOL)
