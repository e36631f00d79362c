"""The port's replica router (analytics_zoo_tpu_torch/serving/
distributed/router.py) against the JAX package's, on the CPU.

Two small `CausalLM` engines a package, the port's built from the JAX
weights through `convert.causal_lm_from_flax`
(tests/_torch_generation_cases.py):

* placements: the same submissions, with the engines stepped between
  them and a replica drained, land on the same replicas in both
  packages (least-loaded over the live gauges, round-robin ties);
* the routed greedy streams equal JAX's router's, token for token;
* a replica stopped mid-stream re-queues its request once on the other
  replica under the same id, and the stream still equals the single
  engine's;
* a fully drained router sheds with `QueueFull` and a positive
  `retry_after_s`;
* `FleetAggregator(router=)` gives one live source and one SLO row per
  replica, and the server's /stats, /metrics (replica-labeled rows) and
  /generate front the router;
* `ReplicaRouter.build` gives every replica one shared host KV tier of
  `OrcaContext.kv_host_tier_bytes` (JAX router.py:284-293), and replica
  1 restores from it a prefix that replica 0 spilled, with the stream a
  single engine's and the restore count JAX's;
* phase-aware routing (`OrcaContext.router_phase_aware`): the replicas'
  phases, the prefill replica's write-through, the placements, the
  phase counters and the streams equal JAX's router's on the same
  submissions.

Token streams are compared exactly; the engines run at one torch
thread."""

import json
import urllib.request

import pytest

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from _torch_generation_cases import (
    VOCAB,
    jax_engine,
    jax_params,
    port_engine,
    port_model,
)
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.observability.registry import (
    MetricsRegistry as JaxRegistry,
)
from analytics_zoo_tpu.serving.distributed import (
    ReplicaRouter as JaxRouter,
)
from analytics_zoo_tpu.serving.generation.host_tier import (
    HostKVTier as JaxTier,
)
from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.observability.registry import MetricsRegistry
from analytics_zoo_tpu_torch.serving import ServingServer
from analytics_zoo_tpu_torch.serving.distributed import ReplicaRouter
from analytics_zoo_tpu_torch.serving.errors import QueueFull
from analytics_zoo_tpu_torch.serving.generation import GenerationEngine
from analytics_zoo_tpu_torch.serving.generation.host_tier import HostKVTier

GEOM = dict(max_slots=2, block_size=8, max_context=64)
PROMPTS = [[(7 * i + j) % VOCAB for j in range(3 + i % 5)]
           for i in range(8)]


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module")
def lm(params):
    return port_model(params)


def port_engines(lm, n=2):
    return [port_engine(lm, registry=MetricsRegistry(), **GEOM)
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_router(params):
    return JaxRouter([jax_engine(params, **GEOM) for _ in range(2)])


def test_every_replica_needs_its_own_registry(lm):
    shared = MetricsRegistry()
    engines = [GenerationEngine(lm, registry=shared, device="cpu", **GEOM)
               for _ in range(2)]
    with pytest.raises(ValueError, match="own MetricsRegistry"):
        ReplicaRouter(engines)
    with pytest.raises(ValueError):
        ReplicaRouter([])
    r = ReplicaRouter.build(lm, n_replicas=2, warmup=False, device="cpu",
                            **GEOM)
    assert [x.name for x in r.replicas] == ["replica-0", "replica-1"]
    assert [x.engine.spool_name for x in r.replicas] == \
        ["replica-0", "replica-1"]
    with pytest.raises(ValueError, match="n_replicas"):
        ReplicaRouter.build(lm, device="cpu")     # serving_replicas 0


def _placements(router):
    """Submit, step, drain and submit again; the replica of each
    admission and the streams, drained."""
    placed, streams = [], []

    def submit(p, n=4):
        s = router.submit(p, max_new_tokens=n)
        placed.append(s.replica_name)
        streams.append(s)

    for p in PROMPTS[:3]:
        submit(p)
    for r in router.replicas:
        r.engine.step()                 # prefill: lanes and blocks held
    for p in PROMPTS[3:6]:
        submit(p)
    router.drain("replica-0")
    submit(PROMPTS[6])
    router.undrain("replica-0")
    submit(PROMPTS[7], n=2)
    router.run_until_idle()
    return placed, [s.tokens() for s in streams]


def test_placements_and_streams_equal_jax(lm, jax_router):
    got = _placements(ReplicaRouter(port_engines(lm)))
    want = _placements(jax_router)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert set(got[0]) == {"replica-0", "replica-1"}
    assert got[0][6] == "replica-1"               # replica-0 drained


def test_a_fully_drained_router_sheds_with_retry_after(lm):
    router = ReplicaRouter(port_engines(lm))
    router.drain()
    with pytest.raises(QueueFull, match="no active replica") as exc:
        router.submit([1, 2, 3], max_new_tokens=2)
    assert exc.value.retry_after_s > 0
    router.undrain()
    s = router.submit([1, 2, 3], max_new_tokens=2)
    router.run_until_idle()
    assert s.tokens()


def test_a_replica_stopped_mid_stream_requeues_under_the_same_id(lm):
    single = port_engines(lm, 1)[0]
    prompt = PROMPTS[5]
    want = single.generate(prompt, max_new_tokens=12)
    router = ReplicaRouter(port_engines(lm))
    retries = obs.get_registry().counter("resilience_retries_total")
    before = retries.value
    try:
        rs = router.submit(prompt, max_new_tokens=12, request_id="rq-1")
        first = rs.replica_name
        victim = next(r for r in router.replicas if r.name == first)
        survivor = next(r for r in router.replicas if r is not victim)
        # the serving replica decodes a few tokens, then stops under the
        # stream (its request finishes with an error)
        for _ in range(3):
            victim.engine.step()
        victim.engine.stop()
        survivor.engine.ensure_started()
        got = list(rs)
        assert rs.replica_name == survivor.name != first
        assert rs.request_id == "rq-1"
        assert got == want
        assert retries.value == before + 1
        assert router.stats()["requeues"] == 1
        router.heartbeat()
        assert victim.state == "dead"
        # a dead replica never admits again
        for _ in range(3):
            assert router.submit([1, 2], max_new_tokens=1).replica_name \
                == survivor.name
    finally:
        router.stop()


def _get(srv, path):
    with urllib.request.urlopen(f"http://{srv.host}:{srv.port}{path}",
                                timeout=30) as r:
        return r.status, r.read()


def test_the_fleet_and_the_server_front_the_router(lm):
    OrcaContext.slo_targets = {"e2e_s": 60.0}
    obs.reset_slo_tracker()
    obs.reset_request_log()             # this test's records alone
    router = ReplicaRouter(port_engines(lm))
    srv = ServingServer(router=router).start()
    try:
        from analytics_zoo_tpu_torch.serving import InputQueue
        q = InputQueue(srv.host, srv.port)
        outs = [q.generate_tokens(p, max_new_tokens=3, timeout=30)
                for p in PROMPTS[:4]]
        assert all(len(o) == 3 for o in outs)
        stats = json.loads(_get(srv, "/stats")[1])
        assert stats["replicas"] == 2
        rows = stats["router"]["replicas"]
        assert [r["replica"] for r in rows] == ["replica-0", "replica-1"]
        assert sum(r["served"] for r in rows) == 4
        assert set(stats["fleet"]["replicas"]) == {"replica-0",
                                                   "replica-1"}
        assert sum(v["judged"] for v in
                   stats["fleet"]["replicas"].values()) == 4
        text = _get(srv, "/metrics")[1].decode()
        for name in ("replica-0", "replica-1"):
            assert f'generation_requests_total{{replica="{name}"}}' in text
        assert "router_requests_total" in text
        assert 'replica="' not in _get(srv, "/metrics?fleet=0")[1].decode()
        agg = obs.FleetAggregator(router=router, include_spooled=False)
        assert [s["name"] for s in agg.sources()] == \
            ["local", "replica-0", "replica-1"]
        # a drained router: 503 with Retry-After over HTTP
        router.drain()
        req = urllib.request.Request(
            f"http://{srv.host}:{srv.port}/generate",
            data=json.dumps({"tokens": [1, 2]}).encode())
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 503
        assert float(exc.value.headers["Retry-After"]) > 0
        router.undrain()
    finally:
        srv.stop()
        OrcaContext.slo_targets = None
        obs.reset_slo_tracker()


# ---------------------------------------- the shared host tier, phases

TIER_BYTES = 1 << 20
#: a prompt of three whole blocks, and one that extends it
LONG = [(5 * j + 1) % VOCAB for j in range(24)]


@pytest.fixture
def knobs():
    """Sets context knobs through their setters and restores them after:
    a setter stores its value on the class itself, where it shadows the
    metaclass's default, so patching that default would not hold."""
    saved = (OrcaContext.kv_host_tier_bytes,
             OrcaContext.router_phase_aware, JaxContext.router_phase_aware)
    yield
    (OrcaContext.kv_host_tier_bytes, OrcaContext.router_phase_aware,
     JaxContext.router_phase_aware) = saved


def test_build_shares_one_host_tier(lm, knobs):
    OrcaContext.kv_host_tier_bytes = TIER_BYTES
    r = ReplicaRouter.build(lm, n_replicas=2, warmup=False, device="cpu",
                            prefix_caching=True, **GEOM)
    tiers = [x.engine.host_tier for x in r.replicas]
    assert tiers[0] is not None and tiers[0] is tiers[1]
    assert tiers[0].capacity_bytes == TIER_BYTES
    # a caller's own tier (or none) is left as given
    mine = HostKVTier(TIER_BYTES)
    r = ReplicaRouter.build(lm, n_replicas=2, warmup=False, device="cpu",
                            prefix_caching=True, kv_host_tier=mine, **GEOM)
    assert all(x.engine.host_tier is mine for x in r.replicas)


def _spill_then_restore(engines, restored):
    """Replica 0 serves LONG and evicts its cached blocks into the shared
    tier; replica 1 then serves LONG + 2 tokens.  Returns replica 1's
    stream and its restores."""
    first = engines[0].submit(LONG, max_new_tokens=2)
    engines[0].run_until_idle()
    first.tokens()
    assert engines[0].prefix_cache.evict(10) == 3
    before = restored()
    s = engines[1].submit(LONG + [3, 4], max_new_tokens=4)
    engines[1].run_until_idle()
    return s.tokens(), restored() - before


def test_replica_one_restores_what_replica_zero_spilled(lm, params):
    kw = dict(GEOM, prefix_caching=True)
    tier = HostKVTier(TIER_BYTES)
    engines = [port_engine(lm, registry=MetricsRegistry(), kv_host_tier=tier,
                           **kw) for _ in range(2)]
    ReplicaRouter(engines)
    got, n = _spill_then_restore(
        engines, lambda: engines[1].n_host_restores)
    jreg = JaxRegistry()
    jtier = JaxTier(TIER_BYTES, registry=jreg)
    jengines = [jax_engine(params, kv_host_tier=jtier, **kw)
                for _ in range(2)]
    JaxRouter(jengines)
    want, jn = _spill_then_restore(
        jengines,
        lambda: jreg.counter("kv_host_restored_total").value)
    assert n == jn == 3 and tier.n_spilled == 3
    assert got == want
    assert got == port_engine(lm, **GEOM).generate(LONG + [3, 4],
                                                   max_new_tokens=4)


def _phase_run(router):
    """Long prompts (prefill-heavy), short ones (decode-heavy) and a
    long prompt again once it is cached: the replica of each, the
    streams and the phase counters."""
    prompts = [LONG, [1, 2, 3], LONG[:20] + [9], [4, 5], LONG + [7],
               [6, 7, 8, 9]]
    placed, streams = [], []
    for p in prompts:
        s = router.submit(p, max_new_tokens=3)
        placed.append(s.replica_name)
        streams.append(s)
        router.run_until_idle()
    reg = router.registry
    counts = (reg.counter("router_phase_prefill_total").value,
              reg.counter("router_phase_decode_total").value)
    return placed, [s.tokens() for s in streams], counts


def test_phase_aware_routing_equals_jax(lm, params, knobs):
    OrcaContext.router_phase_aware = True
    JaxContext.router_phase_aware = True
    kw = dict(GEOM, prefix_caching=True)
    tier = HostKVTier(TIER_BYTES)
    router = ReplicaRouter(
        [port_engine(lm, registry=MetricsRegistry(), kv_host_tier=tier,
                     **kw) for _ in range(2)], registry=MetricsRegistry())
    jtier = JaxTier(TIER_BYTES, registry=JaxRegistry())
    jrouter = JaxRouter([jax_engine(params, kv_host_tier=jtier, **kw)
                         for _ in range(2)], registry=JaxRegistry())
    assert router.phase_aware and jrouter.phase_aware
    assert [r.phase for r in router.replicas] == \
        [r.phase for r in jrouter.replicas] == ["prefill", "decode"]
    assert router.replicas[0].engine.prefix_cache.host_write_through
    assert not router.replicas[1].engine.prefix_cache.host_write_through
    got, want = _phase_run(router), _phase_run(jrouter)
    assert got == want
    assert got[2][0] > 0 and got[2][1] > 0
    assert [row["phase"] for row in router.stats()["replicas"]] == \
        ["prefill", "decode"]
    # the prefill replica's blocks reached the shared tier without an
    # eviction
    assert tier.n_spilled > 0
    # one replica: nothing to split
    assert not ReplicaRouter(port_engines(lm, 1)).phase_aware
