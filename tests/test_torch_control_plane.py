"""The port's serving control plane (analytics_zoo_tpu_torch/serving/
control_plane/) against the JAX package's, on the CPU.

* `AdmissionCore`: one scripted sequence of queue depths, SLO
  attainments, tenants, request classes, fault-plan refusals and clock
  moves gets the same decisions, priorities, messages and Retry-After
  from both packages' cores (exactly; the quota buckets run on fake
  clocks).
* `TokenBucket` on a fake clock; the engine's quota gate (429 with the
  refill time, shadow never charged, other tenants unlimited), its
  request classes as scheduler priorities, and the shed messages living
  in admission.py alone.
* `ModelRegistry`: registration refused without the port's checkpoint
  commit marker, a swap refused once the marker is gone, the
  ``registry.swap`` fault leaving the pointer unmoved, a swap mid-decode
  finishing the old stream on the old version, rollback, retire and the
  model-name rules.
* `WeightedAB` and `ShadowSampler` make JAX's picks for the same seed;
  the registry's A/B split follows them; shadow duplicates are judged on
  the shadow SLO tracker only.

Engines are the port's, built from a JAX-initialised `CausalLM`
(tests/_torch_generation_cases.py) on the CPU at one torch thread."""

import json
import os
import time
import types

import pytest

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from _torch_observability_cases import FakeClock
from _torch_generation_cases import (
    assert_greedy,
    jax_params,
    port_engine,
    port_model,
)
from analytics_zoo_tpu import observability as jax_obs
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.serving.control_plane import admission as jax_adm
from analytics_zoo_tpu.serving.control_plane import routing as jax_routing
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.observability import (
    get_registry,
    get_shadow_slo_tracker,
    reset_slo_tracker,
)
from analytics_zoo_tpu_torch.observability.registry import MetricsRegistry
from analytics_zoo_tpu_torch.resilience.faults import FaultInjected
from analytics_zoo_tpu_torch.serving.control_plane import (
    CLASS_PRIORITY,
    AdmissionCore,
    ModelRegistry,
    ShadowSampler,
    TokenBucket,
    WeightedAB,
    get_tenant_ledger,
    reset_tenant_ledger,
)
from analytics_zoo_tpu_torch.serving.control_plane import (
    admission as port_adm,
)
from analytics_zoo_tpu_torch.serving.errors import (
    ModelNotFound,
    QueueFull,
    TenantQuotaExceeded,
    UncommittedCheckpointError,
    http_status_for,
)

PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "analytics_zoo_tpu_torch")
KNOBS = ("tenant_quotas", "slo_targets", "slo_shed_attainment",
         "fault_plan")


@pytest.fixture(autouse=True)
def clean_control_plane():
    saved = {ctx: {k: getattr(ctx, k) for k in KNOBS}
             for ctx in (OrcaContext, JaxContext)}
    reset_tenant_ledger()
    jax_adm.reset_tenant_ledger()
    yield
    for ctx, knobs in saved.items():
        for k, v in knobs.items():
            setattr(ctx, k, v)
    reset_tenant_ledger()
    jax_adm.reset_tenant_ledger()
    reset_slo_tracker()


@pytest.fixture(scope="module")
def lm():
    return port_model(jax_params())


def engine(lm, **kw):
    return port_engine(lm, max_slots=4, block_size=8, max_context=64,
                       registry=MetricsRegistry(), **kw)


def committed_ckpt(tmp_path, name):
    """A directory with the commit marker the port's checkpoint protocol
    writes last (`<path>.commit`)."""
    p = tmp_path / name
    p.mkdir()
    (tmp_path / f"{name}.commit").write_text(
        json.dumps({"name": name, "wall_time": 0.0}))
    return str(p)


# ----------------------------------------------------------------------
# AdmissionCore
# ----------------------------------------------------------------------

#: (queue depth, SLO attainment or None, tenant, class, clock step)
SEQUENCE = [
    (0, None, None, "interactive", 0.0),
    (0, None, "acme", "interactive", 0.0),
    (1, None, "acme", "batch", 0.0),
    (1, None, "acme", "interactive", 0.0),       # bucket empty: 429
    (1, None, "acme", "shadow", 0.0),            # shadow never charged
    (2, None, "other", "interactive", 0.0),      # unlimited tenant
    (3, None, "acme", "interactive", 0.0),       # max_queue: 503
    (1, 0.5, "acme", "interactive", 0.1),        # SLO shed (depth >= 1)
    (0, 0.5, "acme", "interactive", 1.0),        # depth 0: no SLO shed
    (0, 0.99, None, "interactive", 0.0),
    (1, None, "acme", "interactive", 2.0),       # refilled
    (1, None, "gold", "interactive", 0.0),       # injected 503
    (1, None, "gold", "batch", 0.0),             # injected quota 429
    (1, None, "gold", "batch", 0.0),
    (0, float("nan"), "gold", "interactive", 0.0),   # nan: no shed
]


def run_sequence(adm_mod, ctx, obs_target, monkeypatch, clock, ledger):
    """Each step's outcome through one package's AdmissionCore."""
    ctx.tenant_quotas = {"acme": {"rate": 1.0, "burst": 2.0},
                         "gold": 5.0}
    ctx.slo_targets = {"ttft_s": 1.0}
    ctx.slo_shed_attainment = 0.9
    ctx.fault_plan = {"faults": [
        {"site": "serving.admission", "at": 10, "action": "refuse"},
        {"site": "admission.quota", "at": 7, "action": "refuse"}]}
    att = {"v": None}
    tracker = types.SimpleNamespace(attainment=lambda: att["v"])
    monkeypatch.setattr(obs_target, "get_slo_tracker", lambda: tracker)
    core = adm_mod.AdmissionCore(max_queue=3, slo_shed_min_queue=1,
                                 retry_after=lambda: 0.25, ledger=ledger)
    out = []
    for depth, a, tenant, cls, dt in SEQUENCE:
        clock.tick(dt)
        att["v"] = float("nan") if a is None else a
        try:
            out.append(("admit", core.admit(depth, tenant=tenant,
                                            request_class=cls)))
        except (adm_mod.QueueFull, adm_mod.TenantQuotaExceeded) as e:
            out.append((type(e).__name__, str(e),
                        round(e.retry_after_s, 9)))
    ctx.fault_plan = None
    return out, ledger.stats()


def test_admission_decisions_equal_jax(monkeypatch):
    port_clock, jax_clock = FakeClock(), FakeClock()
    got = run_sequence(port_adm, OrcaContext, port_adm, monkeypatch,
                       port_clock, port_adm.TenantLedger(port_clock))
    monkeypatch.setattr(jax_adm, "time",
                        types.SimpleNamespace(monotonic=jax_clock))
    want = run_sequence(jax_adm, JaxContext, jax_obs, monkeypatch,
                        jax_clock, jax_adm.TenantLedger())
    assert got == want
    kinds = [o[0] for o in got[0]]
    assert kinds == ["admit", "admit", "admit", "TenantQuotaExceeded",
                     "admit", "admit", "QueueFull", "QueueFull",
                     "admit", "admit", "admit", "QueueFull",
                     "TenantQuotaExceeded", "admit", "admit"]
    assert got[0][3][2] == 0.05 * 20            # the bucket's 1 s refill
    assert got[0][2] == ("admit", CLASS_PRIORITY["batch"])


def test_token_bucket_on_a_fake_clock():
    clock = FakeClock()
    b = TokenBucket(rate=8.0, burst=2.0, clock=clock)
    assert b.take() and b.take() and not b.take()
    assert b.eta() == 0.125
    clock.tick(0.0625)
    assert not b.take() and b.eta() == 0.0625
    clock.tick(0.0625)
    assert b.take()
    clock.tick(100.0)
    assert b.tokens <= 2.0 and b.take() and b.take() and not b.take()
    with pytest.raises(ValueError):
        TokenBucket(rate=0.0, burst=1.0)


def test_admit_returns_the_class_priority_and_validates():
    core = AdmissionCore(max_queue=2)
    assert CLASS_PRIORITY == {"interactive": 0, "batch": 1, "shadow": 2}
    assert [core.admit(0, request_class=c) for c in CLASS_PRIORITY] \
        == [0, 1, 2]
    with pytest.raises(ValueError, match="unknown request class"):
        core.admit(0, request_class="bulk")
    with pytest.raises(QueueFull, match="max_queue=2") as exc:
        core.admit(2)
    assert exc.value.retry_after_s > 0


def test_the_shed_messages_live_in_admission_alone():
    """engine.py and worker_pool.py delegate to the AdmissionCore; they
    carry no second admission policy."""
    literals = ("requests already waiting", "shedding under SLO pressure")
    with open(os.path.join(PKG, "serving", "control_plane",
                           "admission.py"), encoding="utf-8") as f:
        core = f.read()
    assert all(lit in core for lit in literals)
    for rel in (("serving", "generation", "engine.py"),
                ("serving", "worker_pool.py")):
        with open(os.path.join(PKG, *rel), encoding="utf-8") as f:
            src = f.read()
        assert not any(lit in src for lit in literals), rel


def test_the_engine_quota_gate_sheds_429(lm):
    clock = FakeClock()
    reset_tenant_ledger(clock)
    OrcaContext.tenant_quotas = {"acme": {"rate": 0.5, "burst": 2}}
    eng = engine(lm)
    prompt = [3, 1, 4, 1, 5]
    ok = [eng.submit(prompt, max_new_tokens=2, tenant="acme")
          for _ in range(2)]
    with pytest.raises(TenantQuotaExceeded) as exc:
        eng.submit(prompt, max_new_tokens=2, tenant="acme")
    assert http_status_for(exc.value) == 429
    assert exc.value.retry_after_s == pytest.approx(2.0)
    assert not isinstance(exc.value, QueueFull)
    ok.append(eng.submit(prompt, max_new_tokens=2, tenant="acme",
                         request_class="shadow"))
    ok.append(eng.submit(prompt, max_new_tokens=2, tenant="other"))
    ok.append(eng.submit(prompt, max_new_tokens=2))
    clock.tick(2.0)
    ok.append(eng.submit(prompt, max_new_tokens=2, tenant="acme"))
    eng.run_until_idle()
    assert all(s.tokens() for s in ok)
    row = get_tenant_ledger().stats()["acme"]
    assert (row["admitted"], row["shed"], row["rate"]) == (3, 1, 0.5)
    OrcaContext.fault_plan = {"faults": [
        {"site": "admission.quota", "at": 1, "action": "refuse"}]}
    with pytest.raises(TenantQuotaExceeded, match="injected quota"):
        eng.submit(prompt, max_new_tokens=2, tenant="zed")


def test_request_classes_order_the_queue(lm):
    eng = engine(lm)
    subs = [("batch", "b0"), ("shadow", "s0"), ("interactive", "i0"),
            ("batch", "b1"), ("interactive", "i1")]
    streams = [eng.submit([1, 2, 3], max_new_tokens=2, request_class=c,
                          request_id=rid) for c, rid in subs]
    assert [s.request_id for s in eng.scheduler.waiting] == \
        ["i0", "i1", "b0", "b1", "s0"]
    eng.run_until_idle()
    assert all(s.tokens() for s in streams)


# ----------------------------------------------------------------------
# ModelRegistry
# ----------------------------------------------------------------------

def test_registration_needs_the_commit_marker(lm, tmp_path):
    reg = ModelRegistry(metrics_registry=MetricsRegistry())
    eng = engine(lm)
    torn = tmp_path / "ckpt-torn"
    torn.mkdir()
    with pytest.raises(UncommittedCheckpointError) as exc:
        reg.register("chat", "v1", eng, checkpoint=str(torn))
    assert http_status_for(exc.value) == 409 and reg.models() == []
    mv = reg.register("chat", "v1", eng,
                      checkpoint=committed_ckpt(tmp_path, "ckpt-ok"),
                      warm=False)
    assert mv.state == "ready" and reg.serving_version("chat") == "v1"
    assert eng.model_label == "chat@v1"
    with pytest.raises(ValueError, match="already registered"):
        reg.register("chat", "v1", eng, warm=False)


def test_a_marker_lost_after_registration_refuses_the_swap(lm, tmp_path):
    reg = ModelRegistry(metrics_registry=MetricsRegistry())
    reg.register("chat", "v1", engine(lm), warm=False)
    ckpt = committed_ckpt(tmp_path, "ckpt-v2")
    reg.register("chat", "v2", engine(lm), checkpoint=ckpt, warm=False)
    os.remove(ckpt + ".commit")
    with pytest.raises(UncommittedCheckpointError,
                       match="lost its commit marker"):
        reg.hot_swap("chat", "v2")
    assert reg.serving_version("chat") == "v1"
    for model, version in (("chat", "v9"), ("nope", "v1")):
        with pytest.raises(ModelNotFound):
            reg.hot_swap(model, version)
    assert reg.stats()["swap_refused"] == 3
    (tmp_path / "ckpt-v2.commit").write_text("{}")
    reg.hot_swap("chat", "v2")
    assert reg.serving_version("chat") == "v2"
    assert reg.stats()["swaps"] == 1
    OrcaContext.fault_plan = {"faults": [
        {"site": "registry.swap", "at": 1, "action": "raise"}]}
    with pytest.raises(FaultInjected):
        reg.rollback("chat")
    OrcaContext.fault_plan = None
    assert reg.serving_version("chat") == "v2"     # all or nothing
    assert reg.rollback("chat").version == "v1"
    assert reg.stats()["rollbacks"] == 1


def test_a_swap_mid_decode_finishes_on_the_old_version(lm):
    reg = ModelRegistry(metrics_registry=MetricsRegistry())
    e1, e2 = engine(lm), engine(lm)
    reg.register("chat", "v1", e1)                  # warm
    reg.register("chat", "v2", e2, warm=False)
    prompt = [7, 11, 13, 17, 19, 23, 29]
    old = reg.submit(prompt, max_new_tokens=6, request_id="old-rid")
    assert old.model_label == "chat@v1" and e1.scheduler.has_work()
    reg.hot_swap("chat", "v2")
    new = reg.submit(prompt, max_new_tokens=6, request_id="new-rid")
    assert new.model_label == "chat@v2"
    assert reg.stats()["models"]["chat"]["versions"]["v1"]["state"] == \
        "draining"
    e1.run_until_idle()
    e2.run_until_idle()
    assert old.request_id == "old-rid"
    assert_greedy(lm, prompt, old.tokens())
    assert_greedy(lm, prompt, new.tokens())
    assert reg.stats()["models"]["chat"]["versions"]["v1"]["state"] == \
        "ready"


def test_retire_and_the_model_name_rules(lm):
    reg = ModelRegistry(metrics_registry=MetricsRegistry())
    e1, e2 = engine(lm), engine(lm)
    reg.register("chat", "v1", e1, warm=False)
    reg.register("chat", "v2", e2, warm=False)
    with pytest.raises(ValueError, match="serving version"):
        reg.retire("chat", "v1")
    reg.retire("chat", "v2")
    assert reg.stats()["models"]["chat"]["versions"]["v2"]["state"] == \
        "retired"
    s = reg.submit([1, 2, 3], max_new_tokens=2)
    e1.run_until_idle()
    assert s.tokens()
    reg.register("code", "v1", engine(lm), warm=False)
    with pytest.raises(ModelNotFound, match="names no model"):
        reg.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(ModelNotFound):
        reg.submit([1, 2, 3], max_new_tokens=2, model="poem")


# ----------------------------------------------------------------------
# A/B and shadow routing
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 99])
def test_ab_and_shadow_picks_equal_jax(seed):
    weights = {"v1": 0.7, "v2": 0.2, "v3": 0.1}
    got, want = WeightedAB(weights, seed), jax_routing.WeightedAB(
        weights, seed)
    assert [got.choose() for _ in range(200)] == \
        [want.choose() for _ in range(200)]
    for fraction in (0.0, 0.25, 1.0):
        got = ShadowSampler("v2", fraction, seed)
        want = jax_routing.ShadowSampler("v2", fraction, seed)
        assert [got.sample() for _ in range(200)] == \
            [want.sample() for _ in range(200)]
    for bad in ({}, {"v1": 0.0}, {"v1": -1.0, "v2": 2.0}):
        with pytest.raises(ValueError):
            WeightedAB(bad)
    with pytest.raises(ValueError):
        ShadowSampler("v2", 1.5)


def test_the_registry_ab_split_follows_the_seed(lm):
    reg = ModelRegistry(metrics_registry=MetricsRegistry())
    e1, e2 = engine(lm), engine(lm)
    reg.register("chat", "v1", e1, warm=False)
    reg.register("chat", "v2", e2, warm=False)
    with pytest.raises(ModelNotFound):
        reg.set_ab("chat", {"v9": 1.0})
    reg.set_ab("chat", {"v1": 0.7, "v2": 0.3}, seed=5)
    streams = [reg.submit([1 + i % 50, 2, 3], max_new_tokens=2)
               for i in range(24)]
    e1.run_until_idle()
    e2.run_until_idle()
    assert all(s.tokens() for s in streams)
    picks = jax_routing.WeightedAB({"v1": 0.7, "v2": 0.3}, seed=5)
    assert [s.model_label for s in streams] == \
        [f"chat@{picks.choose()}" for _ in streams]
    reg.set_ab("chat", None)
    s = reg.submit([1, 2, 3], max_new_tokens=2)
    e1.run_until_idle()
    assert s.model_label == "chat@v1" and s.tokens()


def _wait(cond, timeout=20.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.01)


def test_shadow_duplicates_land_on_the_shadow_tracker_only(lm):
    OrcaContext.slo_targets = {"e2e_s": 1e-9}      # nothing meets it
    primary = reset_slo_tracker()
    shadow = get_shadow_slo_tracker()
    shadow_before = shadow.snapshot()["requests_judged"]
    reg = ModelRegistry(metrics_registry=MetricsRegistry())
    e1, e2 = engine(lm), engine(lm)
    reg.register("chat", "v1", e1, warm=False)
    reg.register("chat", "v2", e2, warm=False)
    reg.set_shadow("chat", "v2", fraction=1.0)
    c_shadow = get_registry().counter("shadow_requests_total")
    before = c_shadow.value
    prompt = [5, 8, 13, 21, 34, 55]
    s = reg.submit(prompt, max_new_tokens=4, request_id="prim")
    assert c_shadow.value == before + 1
    assert [q.request_id for q in e2.scheduler.waiting] == ["shadow-prim"]
    assert e2.scheduler.waiting[0].priority == CLASS_PRIORITY["shadow"]
    e1.run_until_idle()
    e2.run_until_idle()
    assert_greedy(lm, prompt, s.tokens())
    _wait(lambda: shadow.snapshot()["requests_judged"] > shadow_before)
    # the primary tracker judged the primary alone, and its violation
    # counter (what the SLO shedder reads) ticked once, for it
    assert primary.snapshot()["requests_judged"] == 1
    assert primary._c_violations.value == 1
