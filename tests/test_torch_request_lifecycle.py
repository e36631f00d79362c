"""The port's request lifecycle log (analytics_zoo_tpu_torch/
observability/request_log.py), as the generation engine and its
scheduler feed it, held against the JAX package's: both engines serve
the same greedy prompts, under the same request ids, on the same tiny
`CausalLM` (JAX's weights converted by `convert.py`, the cached trees
of `tests/_torch_generation_cases.py`), and every request's record must
agree: the sequence of events with their fields (their clock readings
aside), the token, round, decode-round, speculative and preemption
counts, the status and the finish reason (exact: these are counts and
names).  Three scenes: plain whole-prompt prefill; a pool small enough
to preempt lanes, whose records keep one id through preempt and resume;
prefix caching with chunked prefill and speculative decoding.

Also: the ring of finished records stays bounded at
`OrcaContext.request_log_size`, keeping the newest, in both packages;
a refused `/generate` request of the port's server is in the log under
the client's `X-Request-Id`, with the record JAX's `reject` writes.
"""

import gc
import json
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from _torch_generation_cases import (
    CFG,
    jax_engine,
    jax_params,
    port_engine,
    port_model,
)
from _torch_observability_cases import reset_planes
from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.serving import ServingServer


@pytest.fixture(autouse=True, scope="module")
def _reset_both_packages():
    reset_planes()
    yield
    reset_planes()


@pytest.fixture(scope="module")
def weights():
    params = jax_params()
    return params, port_model(params)


def _requests(seed, n, lo, hi, new):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG["vocab"], int(rng.integers(lo, hi)))
             .tolist(), new) for _ in range(n)]


_SHARED = np.random.default_rng(9).integers(0, CFG["vocab"], 24).tolist()

#: (engine arguments, requests) of each scene
SCENES = {
    "plain": (dict(max_slots=4, block_size=8, max_context=64),
              _requests(1, 6, 3, 30, 9)),
    "preempted": (dict(max_slots=4, block_size=8, max_context=64,
                       num_blocks=10), _requests(2, 5, 18, 22, 16)),
    "prefix_chunked_speculative": (
        dict(max_slots=4, block_size=8, max_context=96,
             prefix_caching=True, chunked_prefill=True,
             prefill_token_budget=16, speculative_decoding=True,
             speculative_k=4),
        [(_SHARED + p, n) for p, n in _requests(3, 5, 2, 20, 20)]),
}

#: event fields read off the clock, which differ between the engines
_CLOCK_FIELDS = ("t", "ts", "dur_s")


def _serve(engine, reqs):
    streams = [engine.submit(p, max_new_tokens=n, request_id=f"req-{i}")
               for i, (p, n) in enumerate(reqs)]
    engine.run_until_idle()
    return [s.tokens() for s in streams], [s.request_id for s in streams]


def _record(log, rid):
    rec = log.get(rid)
    events = [{k: v for k, v in e.items() if k not in _CLOCK_FIELDS}
              for e in rec["events"]]
    counts = {k: rec[k] for k in (
        "request_id", "status", "finish_reason", "prompt_len",
        "max_new_tokens", "n_tokens", "n_rounds", "n_decode_rounds",
        "n_spec_rounds", "n_spec_tokens", "n_preempts",
        "n_events_dropped")}
    return events, counts, rec


@pytest.mark.parametrize("scene", list(SCENES))
def test_records_match_jax(weights, scene):
    params, model = weights
    geom, reqs = SCENES[scene]
    reset_planes()
    want, want_ids = _serve(jax_engine(params, **geom), reqs)
    got, got_ids = _serve(port_engine(model, **geom), reqs)
    assert got == want and got_ids == want_ids
    for rid, toks in zip(got_ids, got):
        g_events, g_counts, rec = _record(obs.get_request_log(), rid)
        w_events, w_counts, _ = _record(jobs.get_request_log(), rid)
        assert g_events == w_events, rid
        assert g_counts == w_counts, rid
        assert rec["n_tokens"] == len(toks)
        assert rec["finish_reason"] == "length"
        if not rec["n_preempts"]:
            # a resumed request's record also counts the token of its
            # recomputed prefill, in both packages
            assert rec["n_tokens"] == \
                1 + rec["n_decode_rounds"] + rec["n_spec_tokens"]
        assert rec["queue_wait_s"] <= rec["ttft_s"] <= rec["e2e_s"]
        t = [e["t"] for e in rec["events"]]
        assert t == sorted(t)
    recs = [obs.request_log.get(rid) for rid in got_ids]
    kinds = {e["kind"] for r in recs for e in r["events"]}
    if scene == "preempted":
        preempted = [r for r in recs if r["n_preempts"]]
        assert preempted and {"preempt", "resume"} <= kinds
        # one record per request, whatever its preemptions
        assert obs.get_request_log().finished_count() == len(reqs)
    if scene == "prefix_chunked_speculative":
        assert {"prefix_hit", "spec_propose", "spec_accept"} <= kinds
        assert sum(r["n_spec_rounds"] for r in recs) > 0


def test_ring_stays_bounded_at_request_log_size(weights):
    _params, model = weights
    saved = OrcaContext.request_log_size, JaxContext.request_log_size
    OrcaContext.request_log_size = JaxContext.request_log_size = 3
    try:
        reset_planes()
        engine = port_engine(model, max_slots=2, block_size=8,
                             max_context=64)
        _tokens, ids = _serve(engine, _requests(4, 5, 3, 12, 4))
        jlog = jobs.get_request_log()
        for rid in ids:         # JAX's log driven through the same ids
            jlog.start(rid, prompt_len=3, max_new_tokens=4)
            jlog.token(rid)
            jlog.finish(rid, "length")
        for log in (obs.get_request_log(), jlog):
            assert log.capacity == 3 and log.finished_count() == 3
            assert [r["request_id"] for r in log.records()] == ids[-3:]
            assert log.get(ids[0]) is None
    finally:
        OrcaContext.request_log_size, JaxContext.request_log_size = saved
        reset_planes()


def test_a_dropped_engine_is_collected(weights):
    """The `kv_pool` memory provider does not keep its engine (its model
    and KV pool) alive: once the caller drops a stopped engine it is
    collected, and the next sample drops the provider."""
    _params, model = weights
    saved = OrcaContext.watchdog_deadline_s
    OrcaContext.watchdog_deadline_s = 60.0
    try:
        reset_planes()
        engine = port_engine(model, max_slots=2, block_size=8,
                             max_context=64)
        streams = [engine.submit(p, max_new_tokens=n)
                   for p, n in _requests(5, 2, 3, 12, 3)]
        engine.ensure_started()
        assert all(len(s.tokens()) == 3 for s in streams)
        engine.stop()
        assert "kv_pool_blocks_capacity" in obs.memory.sample()
        ref = weakref.ref(engine)
        del engine, streams
        gc.collect()
        assert ref() is None
        assert not any(k.startswith("kv_pool_")
                       for k in obs.memory.sample())
        assert "kv_pool" not in obs.memory._providers
    finally:
        OrcaContext.watchdog_deadline_s = saved
        reset_planes()


def _post(srv, body: bytes, rid: str):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}/generate", data=body,
        headers={"Content-Type": "application/json", "X-Request-Id": rid},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode().splitlines()[-1])
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_refused_generate_requests_are_in_the_log(weights):
    _params, model = weights
    reset_planes()
    engine = port_engine(model, max_slots=2, block_size=8, max_context=64)
    srv = ServingServer(generation_engine=engine).start()
    try:
        assert _post(srv, b"{not json", "bad-1")[0] == 400
        engine.max_queue = 0              # every request is shed
        code, body = _post(srv, json.dumps(
            {"tokens": [1, 2, 3], "max_new_tokens": 2}).encode(), "shed-1")
        assert code == 503 and body["request_id"] == "shed-1"
        engine.max_queue = None
        code, body = _post(srv, json.dumps(
            {"tokens": [1, 2, 3], "max_new_tokens": 2}).encode(), "ok-1")
        assert code == 200 and body["finish_reason"] == "length"
    finally:
        srv.stop()
        engine.stop()
    jlog = jobs.get_request_log()
    for rid, code in (("bad-1", 400), ("shed-1", 503)):
        rec = obs.request_log.get(rid)
        assert rec["status"] == "rejected"
        reject = rec["events"][-1]
        assert reject["kind"] == "reject" and reject["code"] == code
        jlog.reject(rid, code, reject["reason"])
        want = jlog.get(rid)
        assert [e["kind"] for e in rec["events"]] == \
            [e["kind"] for e in want["events"]]
        assert (rec["status"], rec["finish_reason"]) == \
            (want["status"], want["finish_reason"])
    assert obs.get_registry().counter("request_rejected_total").value == 2
    ok = obs.request_log.get("ok-1")
    assert ok["status"] == "finished" and ok["n_tokens"] == 2
