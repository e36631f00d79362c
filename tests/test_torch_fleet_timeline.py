"""The port's telemetry spool, fleet view and timeline export
(analytics_zoo_tpu_torch/observability/telemetry_spool.py, fleet.py,
timeline.py) against the JAX package's, on the CPU.

* The spool's write race on the shared fake clock: threads racing
  `maybe_write` in one interval commit one snapshot, in both packages
  alike (no sleeps: the clock moves only when the test ticks it).
* A snapshot spooled by JAX and one spooled by the port merge in the
  port's `FleetAggregator` with the local process: every counter of
  /metrics?fleet=1 is the exact sum over the three sources, the blame
  counters too, and a spooled exemplar is found by id.
* One scripted scene (spans, fenced goodput steps, request lifecycles
  with a preemption and a rejection, dispatch work, host-tier copies,
  flight-ring instants, a memory sample, the exemplars it captures)
  exports a timeline in each package that passes
  `scripts/check_timeline_schema.py::validate_timeline`, with the same
  event counts by category and phase as JAX's; the fleet timeline
  passes it too.
* `FleetAggregator(router=...)` reads each replica's registry as a live
  source, at every harvest (tests/test_torch_router.py holds it over a
  real router)."""

import collections
import importlib.util
import json
import os
import threading

import pytest

from _torch_observability_cases import FakeClock, patch_clock, reset_planes
from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.observability.registry import (
    MetricsRegistry as JaxRegistry,
)
from analytics_zoo_tpu.serving.generation import host_tier as jax_tier
from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.observability.registry import MetricsRegistry
from analytics_zoo_tpu_torch.serving.generation import host_tier

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _validator():
    spec = importlib.util.spec_from_file_location(
        "azt_timeline_lint_torch",
        os.path.join(ROOT, "scripts", "check_timeline_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.validate_timeline


validate_timeline = _validator()

PKGS = {"jax": (jobs, JaxContext, JaxRegistry, jax_tier),
        "port": (obs, OrcaContext, MetricsRegistry, host_tier)}


@pytest.fixture(autouse=True)
def _planes():
    reset_planes()
    yield
    for ctx in (OrcaContext, JaxContext):
        ctx.observability_dir = None
        ctx.slo_targets = None
    reset_planes()


@pytest.mark.parametrize("threads", [2, 8])
def test_spool_write_race_on_the_fake_clock(tmp_path, threads):
    counts = {}
    for name, (o, _ctx, _reg, _tier) in PKGS.items():
        with patch_clock(FakeClock()) as clock:
            spool = o.TelemetrySpool(name, base_dir=str(tmp_path / name),
                                     interval_s=1.0)
            wrote = []
            for tick in (0.0, 0.5, 0.5, 0.25, 1.0):
                clock.tick(tick)
                gate = threading.Barrier(threads)

                def race():
                    gate.wait()
                    wrote.append(spool.maybe_write())
                pool = [threading.Thread(target=race)
                        for _ in range(threads)]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join()
            counts[name] = (sum(wrote), spool.seq)
            with open(spool.path) as f:
                assert json.load(f)["seq"] == spool.seq - 1
    # the first race writes, a second one a full interval later, and the
    # last one (1.25 s after that)
    assert counts["port"] == counts["jax"] == (3, 3)


def _spool_as_other_process(o, reg_cls, base, proc, pid, tokens, blame_s):
    """Spool a snapshot whose registry counted `tokens`, then stamp it
    with another pid, as a worker process's spool would be."""
    reg = reg_cls()
    reg.counter("generation_tokens_total").inc(tokens)
    # the blame tracker's counters live in the process registry
    o.get_registry().counter("blame_queue_wait_seconds_total").inc(blame_s)
    spool = o.TelemetrySpool(proc, base_dir=base, registries=(reg,))
    assert spool.write()
    with open(spool.path) as f:
        doc = json.load(f)
    doc["pid"] = pid
    doc["exemplars"] = [{"request_id": f"{proc}-slow", "reason": "slowest",
                         "ledger": {"e2e_s": 2.5,
                                    "phases": {"queue_wait": 2.0,
                                               "decode_active": 0.5}}}]
    with open(spool.path, "w") as f:
        json.dump(doc, f)


def test_jax_and_port_spools_merge_exactly(tmp_path):
    base = str(tmp_path)
    _spool_as_other_process(jobs, JaxRegistry, base, "jax-worker", -1, 5.0,
                            0.375)
    _spool_as_other_process(obs, MetricsRegistry, base, "port-worker", -2,
                            7.0, 0.25)
    local = MetricsRegistry()
    local.counter("generation_tokens_total").inc(11.0)
    local.counter("blame_queue_wait_seconds_total").inc(0.125)
    agg = obs.FleetAggregator(local_registries=(local,),
                              observability_dir=base)
    fleet = obs.parse_prometheus_text(agg.fleet_prometheus_text())
    assert fleet["generation_tokens_total"]["value"] == 23.0
    blame = agg.fleet_blame()
    assert blame["counters"]["blame_queue_wait_seconds_total"] == 0.75
    assert blame["sources"] == 3
    assert [r["request_id"] for r in blame["exemplars"]] == \
        ["jax-worker-slow", "port-worker-slow"]
    doc = agg.fleet_exemplar("jax-worker-slow")
    assert doc["source"] == "spool:jax-worker"
    assert agg.fleet_exemplar("nobody") is None
    slo = agg.fleet_slo()
    assert set(slo["sources"]) == {"local", "spool:jax-worker",
                                   "spool:port-worker"}
    assert slo["fleet"]["sources"] == 3
    # the same sum through JAX's aggregator over the same directory
    jlocal = JaxRegistry()
    jlocal.counter("generation_tokens_total").inc(11.0)
    jfleet = jobs.parse_prometheus_text(jobs.FleetAggregator(
        local_registries=(jlocal,),
        observability_dir=base).fleet_prometheus_text())
    assert jfleet["generation_tokens_total"]["value"] == 23.0


def test_router_waits_for_item_7():
    """Named for the refusal it replaced: a router's replicas are live
    sources, read when the fleet is harvested."""
    class Replica:
        def __init__(self, name, value):
            self.name = name
            self.engine = type("E", (), {})()
            self.engine.registry = obs.MetricsRegistry()
            self.engine.registry.counter("generation_tokens_total").inc(value)

    router = type("R", (), {"replicas": [Replica("replica-0", 3.0)]})()
    agg = obs.FleetAggregator(local_registries=(obs.MetricsRegistry(),),
                              include_spooled=False, router=router)
    router.replicas.append(Replica("replica-1", 4.0))
    names = [s["name"] for s in agg.sources()]
    assert names == ["local", "replica-0", "replica-1"]
    fleet = obs.parse_prometheus_text(agg.fleet_prometheus_text())
    assert fleet["generation_tokens_total"]["value"] == 7.0


def _scene(name, tmp_path, clock):
    """One scripted scene through a package's planes; returns its
    timeline and fleet timeline."""
    o, ctx, _reg, tier = PKGS[name]
    reset_planes()
    tier.reset_dma()
    ctx.observability_dir = str(tmp_path / name)
    ctx.slo_targets = {"ttft_s": 0.1}
    rl = o.request_log
    with o.trace("serving.generate", request_id="q0"):
        clock.tick(0.25)
        with o.trace("inner"):
            clock.tick(0.125)
    c = o.step_clock("generation_decode")
    for i in range(4):
        rec = c.begin(force_fence=True)
        clock.tick(0.0625)
        rec.lap("host_input")
        rec.cold = i == 0
        clock.tick(0.125)
        rec.lap("compile" if rec.cold else "device_compute")
        rec.end()
        o.profiling.record_work("decode", 0.125, tokens=4)
    for i in range(3):
        rid = f"q{i}"
        rl.start(rid, prompt_len=5, max_new_tokens=3)
        clock.tick(0.03125)
        rl.event(rid, "admit", slot=i)
        o.flight_recorder.record("sched_admit", request_id=rid, slot=i)
        clock.tick(0.0625 * (i + 1))
        rl.attribute(rid, "prefill_compute", 0.0625 * (i + 1))
        rl.event(rid, "prefill", tokens=5)
        rl.token(rid)
        if i == 1:
            rl.event(rid, "preempt")
            clock.tick(0.125)
            rl.event(rid, "resume")
        for _ in range(2):
            clock.tick(0.015625)
            rl.decode_round(rid)
            rl.attribute(rid, "decode_active", 0.015625)
            rl.token(rid)
        rl.finish(rid, "length")
    rl.start("q3", prompt_len=9, max_new_tokens=3)
    rl.get_request_log().reject("q3", 503, "queue full")
    tier.record_dma("host_spill", 0.001, 4096)
    tier.record_dma("host_restore", 0.002, 4096)
    o.memory.register_provider("kv_pool", lambda: {"blocks_used": 3,
                                                   "blocks_capacity": 8})
    o.memory.maybe_sample(force=True)
    doc = o.export_timeline()
    fleet = o.FleetAggregator(observability_dir=str(tmp_path / name)
                              ).fleet_timeline()
    o.memory.unregister_provider("kv_pool")
    return doc, fleet


def _counts(doc):
    return collections.Counter(
        (e.get("cat"), e["ph"]) for e in doc["traceEvents"]
        if e["ph"] != "M")


def test_timeline_of_one_scene_matches_jax(tmp_path):
    docs = {}
    for name in PKGS:
        with patch_clock(FakeClock()) as clock:
            docs[name] = _scene(name, tmp_path, clock)
    for name, (doc, fleet) in docs.items():
        assert validate_timeline(doc) == [], name
        assert validate_timeline(fleet) == [], name
    got, want = _counts(docs["port"][0]), _counts(docs["jax"][0])
    assert got == want
    for cat in ("span", "goodput", "request", "kv_dma", "dispatch",
                "flight_ring", "memory", "blame"):
        assert any(c == cat for c, _ph in got), cat
    assert _counts(docs["port"][1]) == _counts(docs["jax"][1])
    mem = [e for e in docs["port"][0]["traceEvents"]
           if e.get("name") == "memory_bytes"]
    renamed = {obs.RENAMED_FROM_JAX.get(k, k) for e in
               docs["jax"][0]["traceEvents"]
               if e.get("name") == "memory_bytes" for k in e["args"]}
    assert {k for e in mem for k in e["args"]} == renamed | {
        "device_reserved"}
