"""The port's serving planes over HTTP (analytics_zoo_tpu_torch/serving/
server.py and client.py with the SLO, blame, exemplar, timeline,
history, spool and fleet planes armed) against the JAX package's, on
the CPU: the small `CausalLM` of tests/_torch_generation_cases.py (JAX
weights converted into the port) behind each package's `ServingServer`.

* The same greedy requests, each with a client `traceparent` and some
  with X-Tenant, give identical ndjson streams; each response echoes a
  `traceparent` of the client's trace, and the server's
  `serving.generate` span is the client span's child.
* The eight tracing routes (/spans, /goodput, /slo, /timeline,
  /dispatch, /blame, /debug/requests, /metrics/history), their
  ?fleet=1 forms, /metrics?fleet=1 and the `requests`, `blame` and
  `fleet` blocks of /stats answer with JAX's keys; /timeline passes
  `validate_timeline`; an unknown exemplar id and a bad `derive` get
  JAX's 404 and 400 bodies.
* Either package's client against the other's server carries and reads
  back the trace; `traceparent` values parse, format and ride headers,
  environments and record documents as in JAX.
* The SLO shedder's 503 (body, Retry-After, echoed `traceparent`) is
  JAX's, with the same request admitted before it.

Every server binds port 0 and is stopped in a `finally` block; every
HTTP call has a timeout of at most 30 s."""

import importlib.util
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from _torch_generation_cases import (
    assert_greedy,
    jax_engine,
    jax_params,
    port_engine,
    port_model,
)
from _torch_observability_cases import reset_planes
from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.serving.client import InputQueue as JaxInputQueue
from analytics_zoo_tpu.serving.server import ServingServer as JaxServer
from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.serving import InputQueue, ServingServer

HTTP_TIMEOUT = 30.0
GEOMETRY = dict(max_slots=4, block_size=8, max_context=64)
NEW = 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _validator():
    spec = importlib.util.spec_from_file_location(
        "azt_timeline_lint_serving",
        os.path.join(ROOT, "scripts", "check_timeline_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.validate_timeline


def _prompts(seed=5, n=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 61, int(rng.integers(2, 20))).tolist()
            for _ in range(n)]


def _traceparent(rng):
    return "00-{}-{}-01".format(
        "".join(f"{b:02x}" for b in rng.integers(1, 256, 16)),
        "".join(f"{b:02x}" for b in rng.integers(1, 256, 8)))


@pytest.fixture(autouse=True)
def _clamp_timeouts(monkeypatch):
    real = urllib.request.urlopen

    def urlopen(*args, timeout=HTTP_TIMEOUT, **kw):
        return real(*args, timeout=min(timeout, HTTP_TIMEOUT), **kw)
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)


def _arm(tmp, slo=None):
    for name, ctx in (("jax", JaxContext), ("port", OrcaContext)):
        ctx.observability_dir = os.path.join(tmp, name)
        ctx.slo_targets = slo
        ctx.metrics_history_interval_s = 0.05


def _disarm():
    for ctx in (JaxContext, OrcaContext):
        ctx.observability_dir = None
        ctx.slo_targets = None
        ctx.slo_shed_attainment = None
        ctx.metrics_history_interval_s = None


@pytest.fixture(scope="module")
def params():
    return jax_params()


def _post(srv, path, body, headers=None):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}", data=data,
        headers=dict({"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _get(srv, path):
    try:
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}{path}",
                timeout=HTTP_TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def served(params, tmp_path_factory):
    """Both servers, armed, after the same traced requests."""
    reset_planes()
    _arm(str(tmp_path_factory.mktemp("planes")),
         slo={"ttft_s": 30.0, "tpot_s": 30.0})
    rng = np.random.default_rng(11)
    reqs = [(p, _traceparent(rng), "acme" if i % 3 == 0 else None)
            for i, p in enumerate(_prompts())]
    started = []
    try:
        started.append(JaxServer(generation_engine=jax_engine(
            params, **GEOMETRY)).start())
        started.append(ServingServer(generation_engine=port_engine(
            port_model(params), **GEOMETRY)).start())
        answers = []
        for srv in started:
            got = []
            for i, (prompt, tp, tenant) in enumerate(reqs):
                headers = {"X-Request-Id": f"p{i}", "traceparent": tp}
                if tenant:
                    headers["X-Tenant"] = tenant
                got.append(_post(srv, "/generate",
                                 {"tokens": prompt, "max_new_tokens": NEW},
                                 headers))
            answers.append(got)
        yield started, reqs, answers
    finally:
        for srv in started:
            srv.stop()
        _disarm()
        reset_planes()


def _lines(body):
    return [json.loads(x) for x in body.decode().splitlines()]


def _generate_span(**match):
    """The port's `serving.generate` span whose fields (or attrs)
    match: the handler closes it just after the client has read the
    last line, so it is polled for."""
    deadline = time.monotonic() + HTTP_TIMEOUT
    while True:
        for s in obs.recent_spans(512):
            fields = dict(s, **s["attrs"])
            if s["name"] == "serving.generate" and all(
                    fields.get(k) == v for k, v in match.items()):
                return s
        assert time.monotonic() < deadline, match
        time.sleep(0.01)


def test_streams_and_traces_match_jax(served):
    (jsrv, psrv), reqs, (want, got) = served
    for (prompt, tp, _t), (cj, hj, bj), (cp, hp, bp) in zip(reqs, want,
                                                           got):
        assert cj == cp == 200
        assert _lines(bp) == _lines(bj)
        trace_id, span_id = tp.split("-")[1:3]
        for h in (hj, hp):
            echoed = h["traceparent"].split("-")
            assert echoed[1] == trace_id and echoed[2] != span_id
        assert_greedy(psrv.generation_engine.model, prompt,
                      [x["token"] for x in _lines(bp)[:-1]])
    for i, (_p, tp, _t) in enumerate(reqs):
        s = _generate_span(request_id=f"p{i}")
        assert (s["trace_id"], s["parent_id"]) == tuple(tp.split("-")[1:3])


TRACEPARENTS = [
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "0123456789abcdef" + "-" + "fedcba9876543210" + "-00",
    "  00-" + "AB" * 16 + "-" + "CD" * 8 + "-01  ",
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "00" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "cd" * 7 + "-01",
    "00-" + "zz" * 16 + "-" + "cd" * 8 + "-01",
    "00-abc-def", "", None, 17]


@pytest.mark.parametrize("value", TRACEPARENTS, ids=range(len(TRACEPARENTS)))
def test_traceparent_round_trips_match_jax(value):
    got = obs.parse_traceparent(value)
    want = jobs.parse_traceparent(value)
    assert (got and got.to_dict()) == (want and want.to_dict())
    if got is None:
        return
    assert obs.parse_traceparent(got.traceparent()) == got
    assert got.traceparent() == want.traceparent()
    tc = obs.trace_context
    for carrier, extract in (
            (tc.inject_headers({}, got), tc.extract_headers),
            (tc.inject_env({}, got), tc.from_env),
            (tc.inject_record({"uri": "u"}, got), tc.extract_record)):
        assert extract(carrier) == got
    assert jobs.trace_context.extract_headers(
        tc.inject_headers({}, got)).to_dict() == got.to_dict()
    with tc.bind(got):
        assert tc.current_trace_context() == got
        with obs.trace("child") as span:
            assert (span.trace_id, span.parent_id) == (got.trace_id,
                                                       got.span_id)
    assert tc.current_trace_context() is None


ROUTES = ["/spans?n=5", "/goodput", "/slo", "/dispatch", "/blame",
          "/blame?fleet=1", "/debug/requests", "/timeline",
          "/timeline?fleet=1", "/metrics/history",
          "/metrics/history?fleet=1&derive=rate&family=generation_tokens",
          "/metrics/history?derive=quantiles&window=0.5"]


@pytest.mark.parametrize("route", ROUTES)
def test_routes_answer_with_jax_keys(served, route):
    (jsrv, psrv), _reqs, _answers = served
    (cj, bj), (cp, bp) = _get(jsrv, route), _get(psrv, route)
    assert cj == cp == 200
    dj, dp = json.loads(bj), json.loads(bp)
    assert dp.keys() == dj.keys()
    if route.startswith("/timeline"):
        assert _validator()(dp) == []
    if route == "/slo":
        assert dp["requests_judged"] == dj["requests_judged"] == len(
            _reqs)
        assert dp["attainment_by_tenant"] == dj["attainment_by_tenant"] \
            == {"acme": 1.0}
    if route == "/debug/requests":
        assert sorted(r["request_id"] for r in dp["exemplars"]) == \
            sorted(r["request_id"] for r in dj["exemplars"])
        assert dp["exemplars"][0].keys() == dj["exemplars"][0].keys()
    if route.startswith("/metrics/history"):
        assert dp["enabled"] and dp["n_samples"] >= 1


def test_history_rate_has_points(served):
    (_j, psrv), _reqs, _answers = served
    _code, body = _get(psrv, "/metrics/history?derive=rate&family="
                             "generation_tokens_total")
    doc = json.loads(body)
    assert len(doc["series"]["generation_tokens_total"]) >= 2


def test_dossier_and_errors_match_jax(served):
    (jsrv, psrv), _reqs, _answers = served
    (_, bj), (_, bp) = _get(jsrv, "/debug/requests/p0"), _get(
        psrv, "/debug/requests/p0")
    dj, dp = json.loads(bj), json.loads(bp)
    assert dp.keys() == dj.keys()
    assert dp["ledger"]["phases"].keys() == dj["ledger"]["phases"].keys()
    assert dp["ledger"]["additive_ok"] and dp["source"] == "local"
    for path, code in (("/debug/requests/nobody", 404),
                       ("/metrics/history?derive=median", 400)):
        (cj, bj), (cp, bp) = _get(jsrv, path), _get(psrv, path)
        assert cj == cp == code
        assert json.loads(bp) == json.loads(bj)


def test_stats_blocks_and_fleet_metrics(served):
    (jsrv, psrv), reqs, _answers = served
    sj = json.loads(_get(jsrv, "/stats")[1])
    sp = json.loads(_get(psrv, "/stats")[1])
    for block in ("requests", "blame", "fleet"):
        assert sp[block].keys() == sj[block].keys(), block
    assert sp["requests"]["slo_attainment_by_tenant"] == {"acme": 1.0}
    assert sp["blame"]["requests"] == len(reqs)
    assert sp["blame"]["additivity_violations"] == 0
    assert {"goodput_ratio", "dispatch"} <= sp.keys()
    fleet = obs.parse_prometheus_text(
        _get(psrv, "/metrics?fleet=1")[1].decode())
    local = obs.parse_prometheus_text(_get(psrv, "/metrics")[1].decode())
    # the spool this process wrote is its own: the fleet is the local sum
    assert fleet["generation_tokens_total"]["value"] == \
        local["generation_tokens_total"]["value"] == \
        psrv.generation_engine.n_tokens


def test_clients_carry_the_trace_both_ways(served):
    (jsrv, psrv), _reqs, _answers = served
    prompt = [3, 1, 4, 1, 5]
    with jobs.trace("jax.client") as jspan:
        q = JaxInputQueue(psrv.host, psrv.port)
        jtoks = q.generate_tokens(prompt, max_new_tokens=3)
    assert q.last_traceparent.split("-")[1] == jspan.trace_id
    with obs.trace("port.client") as pspan:
        p = InputQueue(jsrv.host, jsrv.port)
        ptoks = p.generate_tokens(prompt, max_new_tokens=3)
    assert p.last_traceparent.split("-")[1] == pspan.trace_id
    assert jtoks == ptoks
    tp = obs.TraceContext("ab" * 16, "cd" * 8)
    with obs.trace_context.bind(tp):
        p = InputQueue(psrv.host, psrv.port)
        p.generate_tokens(prompt, max_new_tokens=2)
        assert p.last_traceparent.split("-")[1] == "ab" * 16
    span = _generate_span(trace_id="ab" * 16)
    assert span["parent_id"] == "cd" * 8


def test_slo_shed_over_http_matches_jax(params):
    """Fresh engines (no decode timed, so Retry-After is 0.5 s in both):
    with the loops stopped one request waits, the trackers judge three
    slow requests, and the next request is shed with JAX's 503."""
    reset_planes()
    started, waiting, got = [], [], []
    try:
        started.append(JaxServer(generation_engine=jax_engine(
            params, **GEOMETRY)).start())
        started.append(ServingServer(generation_engine=port_engine(
            port_model(params), **GEOMETRY)).start())
        for srv, o, ctx in zip(started, (jobs, obs),
                               (JaxContext, OrcaContext)):
            eng = srv.generation_engine
            eng.stop()
            eng.slo_shed_min_queue = 1
            t = threading.Thread(target=_post, args=(
                srv, "/generate", {"tokens": [1, 2], "max_new_tokens": 2},
                {"X-Request-Id": "first"}))
            t.start()
            waiting.append(t)
            deadline = time.monotonic() + 20
            while not eng.scheduler.waiting and time.monotonic() < deadline:
                time.sleep(0.01)
            ctx.slo_targets = {"ttft_s": 0.1}
            ctx.slo_shed_attainment = 0.99
            for ttft in (0.5, 0.05, 0.7):
                o.get_slo_tracker().observe({"ttft_s": ttft})
            tp = "00-" + "12" * 16 + "-" + "34" * 8 + "-01"
            code, headers, body = _post(
                srv, "/generate", {"tokens": [5, 6], "max_new_tokens": 2},
                {"X-Request-Id": "shed", "traceparent": tp})
            got.append((code, headers["Retry-After"], headers["traceparent"],
                        json.loads(body)))
            ctx.slo_shed_attainment = None
            eng.ensure_started()
        for t in waiting:
            t.join(timeout=HTTP_TIMEOUT)
    finally:
        for srv in started:
            srv.stop()
        _disarm()
        reset_planes()
    assert got[0] == got[1]
    code, retry_after, tp, body = got[1]
    assert code == 503 and float(retry_after) == 0.5
    assert tp == "00-" + "12" * 16 + "-" + "34" * 8 + "-01"
    assert body["error"].startswith("shedding under SLO pressure")
    assert body["request_id"] == "shed" and body["retry_after_s"] == 0.5
