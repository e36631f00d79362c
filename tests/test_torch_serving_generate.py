"""POST /generate of the port's `ServingServer` against the JAX
package's, on the CPU: the small `CausalLM` of
tests/_torch_generation_cases.py (JAX weights converted into the port)
behind both servers, greedy decoding (the only mode whose tokens match
across the two packages' samplers).

* The ndjson lines are equal, the `done` line included.
* X-Request-Id is sanitized the same way and echoed.
* 400 (malformed), 404 (no engine), 413 (can never fit) and 503 with
  Retry-After (from `max_queue`, and from a ``serving.admission``
  ``refuse`` plan, after which a client with a `RetryPolicy` gets the
  whole stream) answer as JAX's server does.
* A ``poison_request`` plan at ``generation.decode`` evicts only its
  victim; the survivors' streams equal their unpoisoned streams and
  JAX's under the same plan.
* A stream that dies mid-flight ends in an error line, as in JAX.
* `GenerationEngine.retry_after_s` follows JAX's formula on set decode
  histories.

Every server binds port 0 and is stopped in a `finally` block; every
HTTP call has a timeout of at most 30 s."""

import functools
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_generation_cases import (
    VOCAB,
    jax_engine,
    jax_params,
    port_engine,
    port_model,
)
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from analytics_zoo_tpu.serving.client import InputQueue as JaxInputQueue
from analytics_zoo_tpu.serving.server import ServingServer as JaxServer
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.resilience import RetryPolicy
from analytics_zoo_tpu_torch.serving import InputQueue, ServingServer

HTTP_TIMEOUT = 30.0
GEOMETRY = dict(max_slots=4, block_size=8, max_context=64)
PROMPTS = [[3, 14, 15, 9, 2], [26, 5], [35, 8, 9, 7, 9, 3, 2, 38], [46]]
NEW = 12

_params = functools.lru_cache(maxsize=None)(jax_params)


@pytest.fixture(autouse=True)
def _clamp_timeouts(monkeypatch):
    real = urllib.request.urlopen

    def urlopen(*args, timeout=HTTP_TIMEOUT, **kw):
        return real(*args, timeout=min(timeout, HTTP_TIMEOUT), **kw)
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)


@pytest.fixture(autouse=True)
def _no_plans():
    yield
    OrcaContext.fault_plan = None
    JaxContext.fault_plan = None


@pytest.fixture(scope="module")
def servers():
    params = _params()
    started = []
    try:
        started.append(JaxServer(generation_engine=jax_engine(
            params, **GEOMETRY)).start())
        started.append(ServingServer(generation_engine=port_engine(
            port_model(params), **GEOMETRY)).start())
        yield started
    finally:
        for srv in started:
            srv.stop()


def _post(srv, path, body, headers=None):
    """(status, headers, body bytes) of a POST to `srv`."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}", data=data,
        headers=dict({"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _lines(body):
    return [json.loads(x) for x in body.decode().splitlines()]


def _generate(srv, prompt, rid, n=NEW):
    return _post(srv, "/generate", {"tokens": prompt, "max_new_tokens": n},
                 headers={"X-Request-Id": rid})


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_greedy_lines_match_jax(servers, i):
    rid = f"greedy-{i}"
    (cj, hj, bj), (cp, hp, bp) = (_generate(s, PROMPTS[i], rid)
                                  for s in servers)
    assert cj == cp == 200
    assert hj["Content-Type"] == hp["Content-Type"] == "application/x-ndjson"
    assert hj["X-Request-Id"] == hp["X-Request-Id"] == rid
    lj, lp = _lines(bj), _lines(bp)
    assert lp == lj
    assert lp[-1] == {"done": True, "n_tokens": NEW,
                      "finish_reason": "length", "request_id": rid}
    assert servers[1].generation_engine.generate(
        PROMPTS[i], max_new_tokens=NEW) == [x["token"] for x in lp[:-1]]


@pytest.mark.parametrize("rid,want", [
    ("a b/c?d", "a_b_c_d"),
    ("x" * 80, "x" * 64),
    ("ok-1.2:3_4", "ok-1.2:3_4"),
])
def test_request_id_sanitized_as_jax(servers, rid, want):
    got = [_generate(s, [1, 2], rid, n=2) for s in servers]
    for code, headers, body in got:
        assert code == 200
        assert headers["X-Request-Id"] == want
        assert _lines(body)[-1]["request_id"] == want


def test_new_request_id_when_none_sent(servers):
    for srv in servers:
        code, headers, body = _post(srv, "/generate", {"tokens": [1, 2],
                                                       "max_new_tokens": 2})
        assert code == 200
        rid = headers["X-Request-Id"]
        assert len(rid) == 16 and _lines(body)[-1]["request_id"] == rid


@pytest.mark.parametrize("body,code", [
    (b"{not json", 400),
    ({"max_new_tokens": 4}, 400),
    ({"tokens": [VOCAB + 5], "max_new_tokens": 4}, 400),
    ({"tokens": [], "max_new_tokens": 4}, 400),
    ({"tokens": list(range(1, 60)), "max_new_tokens": 10}, 413),
], ids=["bad_json", "no_tokens", "out_of_vocab", "empty", "too_large"])
def test_rejections_match_jax(servers, body, code):
    got = [_post(s, "/generate", body, headers={"X-Request-Id": "rej"})
           for s in servers]
    (cj, hj, bj), (cp, hp, bp) = got
    assert cj == cp == code
    assert hj["X-Request-Id"] == hp["X-Request-Id"] == "rej"
    assert json.loads(bj).keys() == json.loads(bp).keys() == {
        "error", "request_id"}


class _Predictor:
    """A stand-in model: /generate never reaches it."""
    supported_concurrent_num = 1
    records_served = 0

    def predict(self, *inputs):
        return inputs[0]


def test_no_engine_is_404_as_jax():
    started = []
    try:
        for cls in (JaxServer, ServingServer):
            started.append(cls(_Predictor()).start())
        (cj, _, bj), (cp, _, bp) = (_post(s, "/generate", {"tokens": [1]})
                                    for s in started)
        assert cj == cp == 404
        assert json.loads(bj) == json.loads(bp)
    finally:
        for srv in started:
            srv.stop()


def _assert_shed(code, headers, body):
    assert code == 503
    doc = json.loads(body)
    assert doc.keys() == {"error", "request_id", "retry_after_s"}
    assert 0.05 <= float(headers["Retry-After"]) <= 10.0
    assert doc["retry_after_s"] == round(float(headers["Retry-After"]), 3)


def test_queue_full_is_503_with_retry_after_as_jax(servers):
    engines = [s.generation_engine for s in servers]
    try:
        for eng in engines:
            eng.max_queue = 0
        for srv in servers:
            _assert_shed(*_generate(srv, [1, 2], "shed"))
    finally:
        for eng in engines:
            eng.max_queue = None


@pytest.mark.parametrize("package", ["jax", "port"])
def test_admission_refusal_then_retry(servers, package):
    srv, ctx, client, policy = (
        (servers[0], JaxContext, JaxInputQueue, JaxRetryPolicy)
        if package == "jax" else
        (servers[1], OrcaContext, InputQueue, RetryPolicy))
    want = servers[1].generation_engine.generate(PROMPTS[0],
                                                 max_new_tokens=NEW)
    # a decode measured: Retry-After comes from the cadence, not 0.5
    ctx.fault_plan = {"faults": [{"site": "serving.admission", "at": 1,
                                  "times": 1, "action": "refuse"}]}
    _assert_shed(*_generate(srv, [1, 2], "refused"))
    ctx.fault_plan = {"faults": [{"site": "serving.admission", "at": 1,
                                  "times": 2, "action": "refuse"}]}
    q = client(srv.host, srv.port)
    got = q.generate_tokens(PROMPTS[0], max_new_tokens=NEW,
                            retry=policy(max_attempts=4, backoff_s=0.01))
    assert got == want
    assert q.last_retries == 2 and q.last_generate["n_tokens"] == NEW


def test_poisoned_request_evicts_only_its_victim(servers):
    ids = ["victim", "keep-1", "keep-2", "keep-3"]
    streams = {}
    for srv in servers:
        eng = srv.generation_engine
        # pause the loop so that the four requests are admitted in one
        # round and the poisoned decode round holds all of them
        eng.stop()
        out = {}

        def client(rid, prompt, srv=srv, out=out):
            code, _, body = _generate(srv, prompt, rid)
            out[rid] = (code, _lines(body))

        threads = [threading.Thread(target=client, args=(rid, p))
                   for rid, p in zip(ids, PROMPTS)]
        for t in threads:
            t.start()
        t_end = time.monotonic() + HTTP_TIMEOUT
        while len(eng.scheduler.waiting) < len(ids):
            assert time.monotonic() < t_end, "requests never queued"
            time.sleep(0.005)
        plan = {"faults": [{"site": "generation.decode", "at": 2,
                            "action": "poison_request",
                            "request_id": "victim"}]}
        JaxContext.fault_plan = plan
        OrcaContext.fault_plan = plan
        eng.ensure_started()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT)
        streams[srv] = out
        JaxContext.fault_plan = OrcaContext.fault_plan = None
    sj, sp = streams[servers[0]], streams[servers[1]]
    assert sp == sj
    code, lines = sp["victim"]
    assert code == 200 and lines[-1]["finish_reason"].startswith(
        "error: evicted (injected decode failure poisoning request "
        "'victim')")
    assert lines[-1]["n_tokens"] < NEW
    eng = servers[1].generation_engine
    for rid, prompt in zip(ids[1:], PROMPTS[1:]):
        code, lines = sp[rid]
        assert code == 200 and lines[-1]["finish_reason"] == "length"
        assert [x["token"] for x in lines[:-1]] == eng.generate(
            prompt, max_new_tokens=NEW)
    # the engine serves on
    code, _, body = _generate(servers[1], PROMPTS[0], "after")
    assert code == 200 and _lines(body)[-1]["n_tokens"] == NEW
    assert eng.n_evictions == 1


def test_dead_stream_ends_in_an_error_line_as_jax(servers):
    """A stream that dies mid-flight (here: no token within the stream's
    timeout, the engine's loop stopped) ends with an {"error"} line on
    a whole chunked body, not a torn connection; both clients raise."""
    got = []
    for srv, client in zip(servers, (JaxInputQueue, InputQueue)):
        eng = srv.generation_engine
        submit = eng.submit
        eng.stop()
        eng.submit = functools.partial(submit, stream_timeout=0.2)
        try:
            code, _, body = _generate(srv, [1, 2], "dies", n=4)
            with pytest.raises(RuntimeError, match="serving error"):
                client(srv.host, srv.port).generate_tokens(
                    [1, 2], max_new_tokens=4, timeout=HTTP_TIMEOUT)
        finally:
            del eng.submit
            eng.ensure_started()
        assert code == 200
        got.append(_lines(body))
    assert got[0] == got[1]
    assert got[1][-1].keys() == {"error", "request_id"}
    assert got[1][-1]["request_id"] == "dies"


@pytest.mark.parametrize("walls,depth", [
    ((), 0), ((), 3), ((0.01, 0.03), 0), ((0.01, 0.03), 2),
    ((0.001,), 0), ((4.0, 6.0), 3),
], ids=["cold", "cold_deep", "cadence", "cadence_deep", "floor", "cap"])
def test_retry_after_follows_jax_formula(walls, depth):
    params = _params()
    jeng = jax_engine(params, **GEOMETRY)
    peng = port_engine(port_model(params), **GEOMETRY)
    for w in walls:
        jeng._h_decode.record(w)
        peng.decode_seconds.append(w)
    for i in range(depth):
        jeng.submit([1 + i], max_new_tokens=2)
        peng.submit([1 + i], max_new_tokens=2)
    want = (0.5 if not walls else
            min(10.0, max(0.05, (depth + 1) * float(np.mean(walls)))))
    assert peng.retry_after_s() == pytest.approx(jeng.retry_after_s(),
                                                 rel=1e-12)
    assert peng.retry_after_s() == pytest.approx(want, rel=1e-12)
