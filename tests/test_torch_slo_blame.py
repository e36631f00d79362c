"""The port's SLO tracker, latency blame plane and tail exemplars
(analytics_zoo_tpu_torch/observability/slo.py, blame.py, exemplars.py)
against the JAX package's, on the CPU.

One scripted stream of request records, drawn from a numpy seed, goes
through both packages' request logs under the shared fake clock
(`tests/_torch_observability_cases.py`): admissions, prefill and
decode attributions, preemptions, host-tier restores, seeded quota
waits, model and tenant attribution, shadow requests, errors and
rejections.  Exact on every count and every second (the same clock
readings through the same arithmetic): the SLO snapshots (primary and
shadow), the blame payload and its /stats block, each record's phase
ledger (which sums to its e2e within `blame_tolerance`), and the
exemplar index with each dossier's ledger, reason and record.

Also: the nine settings these planes read, with JAX's defaults and
ValueErrors; the SLO shedder's refusals in JAX's order, with JAX's
message and Retry-After; and a static check that every phase the
port's serving code attributes, and every phase `blame.py` maps, is in
the port's `PHASES`, which equals JAX's."""

import ast
import json
import os

import numpy as np
import pytest

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from _torch_generation_cases import (
    jax_engine,
    jax_params,
    port_engine,
    port_model,
)
from _torch_observability_cases import FakeClock, patch_clock, reset_planes
from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.serving.generation.engine import (
    QueueFull as JaxQueueFull,
)
from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.serving.errors import QueueFull

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "analytics_zoo_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _reset_both_packages():
    reset_planes()
    yield
    reset_planes()


#: the nine settings: (name, JAX's default, a valid value, bad values)
SETTINGS = [
    ("slo_targets", None, {"ttft_s": 0.5, "model:m": {"e2e_s": 2.0}},
     [{"nope_s": 1.0}, {"ttft_s": 0.0}, {"tenant:": {"ttft_s": 1.0}},
      {"model:m": {"bad": 1.0}}]),
    ("blame_tolerance", 0.05, 0.1, [0.0, 1.5, -0.1]),
    ("exemplar_count", 16, 4, [-1]),
    ("exemplar_max_bytes", 64 * 1024, 4096, [2047, 0]),
    ("metrics_history_interval_s", None, 0.25, [0.0, -1.0]),
    ("metrics_history_max_bytes", 8 * 1024 * 1024, 4096, [4095]),
    ("telemetry_spool_interval_s", 1.0, 0.0, [-0.5]),
    ("telemetry_spool_max_bytes", 1024 * 1024, 4096, [4095]),
    ("slo_shed_attainment", None, 0.9, [0.0, 1.01, -1.0]),
]


def _raised(ctx, name, value):
    try:
        setattr(ctx, name, value)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name,default,good,bad", SETTINGS,
                         ids=[s[0] for s in SETTINGS])
def test_settings_match_jax(name, default, good, bad):
    assert getattr(OrcaContext, name) == getattr(JaxContext, name) \
        == default
    try:
        for ctx in (OrcaContext, JaxContext):
            setattr(ctx, name, good)
        assert getattr(OrcaContext, name) == getattr(JaxContext, name)
        for value in bad:
            got = _raised(OrcaContext, name, value)
            assert got is not None and got == _raised(JaxContext, name,
                                                       value), value
            assert getattr(OrcaContext, name) == getattr(JaxContext, name)
    finally:
        for ctx in (OrcaContext, JaxContext):
            setattr(ctx, name, default)


# ----------------------------------------------------------------------
# one scripted record stream through both request logs
# ----------------------------------------------------------------------

#: (SLO targets, exemplar_count, exemplar_max_bytes) of each scene
SCENES = {
    "targets": ({"ttft_s": 0.05, "tpot_s": 0.012}, 16, 64 * 1024),
    "keyed_few_exemplars": ({"ttft_s": 0.08, "e2e_s": 0.4,
                             "model:lm@2": {"ttft_s": 0.03},
                             "tenant:acme": {"e2e_s": 0.25}}, 3, 64 * 1024),
    "no_targets_small_dossiers": (None, 5, 2048),
}


def _plan(seed, n=24):
    """The request stream: one dict of draws a request (dyadic seconds,
    so both packages' sums are exact)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(dict(
            rid=f"r{i}",
            prompt=int(rng.integers(4, 200)),
            new=int(rng.integers(1, 12)),
            model=[None, "lm@1", "lm@2"][int(rng.integers(3))],
            tenant=[None, "acme", "beta"][int(rng.integers(3))],
            klass="shadow" if rng.random() < 0.1 else "interactive",
            seed_s=(float(rng.integers(1, 8)) / 64
                    if rng.random() < 0.2 else 0.0),
            queue=float(rng.integers(0, 16)) / 256,
            prefill=float(rng.integers(1, 16)) / 256,
            decode=float(rng.integers(1, 8)) / 512,
            blocked=float(rng.integers(0, 4)) / 512,
            preempt=float(rng.integers(1, 8)) / 128
            if rng.random() < 0.2 else 0.0,
            restore=float(rng.integers(1, 4)) / 512
            if rng.random() < 0.2 else 0.0,
            end=["length", "length", "eos", "error: boom",
                 "reject"][int(rng.integers(5))]))
    return out


def _drive(o, clock, plan):
    """Feed one package's request log the plan, each request inside a
    span carrying its id."""
    rl = o.request_log
    for r in plan:
        rid = r["rid"]
        with o.trace("request", request_id=rid):
            rl.start(rid, prompt_len=r["prompt"], max_new_tokens=r["new"],
                     model=r["model"], tenant=r["tenant"],
                     request_class=r["klass"],
                     blame_seed=({"quota_throttle": r["seed_s"]}
                                 if r["seed_s"] else None))
            clock.tick(r["queue"])
            if r["end"] == "reject":
                rl.get_request_log().reject(rid, 503, "queue full")
                continue
            if r["restore"]:
                # a restore runs inside admission, before the stamp
                clock.tick(r["restore"])
                rl.attribute(rid, "host_restore", r["restore"])
            rl.event(rid, "admit", slot=0)
            clock.tick(r["prefill"])
            rl.attribute(rid, "prefill_compute", r["prefill"])
            rl.event(rid, "prefill", tokens=r["prompt"])
            rl.token(rid)
            for k in range(r["new"] - 1):
                if k == 1 and r["preempt"]:
                    rl.event(rid, "preempt")
                    clock.tick(r["preempt"])
                    rl.event(rid, "resume")
                clock.tick(r["decode"] + r["blocked"])
                rl.decode_round(rid)
                rl.attribute(rid, "decode_active", r["decode"])
                rl.token(rid)
            rl.finish(rid, r["end"])


def _wall_free(snap):
    return {k: v for k, v in snap.items()
            if k not in ("wall_enqueue", "events")}


def _run_scene(o, ctx, clock, scene, plan):
    targets, count, max_bytes = SCENES[scene]
    reset_planes()
    ctx.slo_targets = targets
    ctx.exemplar_count = count
    ctx.exemplar_max_bytes = max_bytes
    try:
        _drive(o, clock, plan)
        store = o.get_exemplar_store()
        out = dict(
            slo=o.get_slo_tracker().snapshot(),
            shadow=o.get_shadow_slo_tracker().snapshot(),
            blame=o.blame_payload(),
            stats=o.get_blame_tracker().stats_block(),
            ledgers={r["rid"]: o.phase_ledger(
                o.request_log.get_request_log().get(r["rid"]))
                for r in plan},
            index=store.index(),
            docs=[(d["request_id"], d["reason"], d["violations"],
                   d["ledger"], _wall_free(d["record"]),
                   len(json.dumps(d, default=str)), d.get("truncated"))
                  for d in store.snapshot()],
            counters={k: v for k, v in o.get_registry().sample_values()
                      ["counters"].items()
                      if k.startswith(("slo_", "shadow_slo_", "blame_",
                                       "exemplars_"))})
    finally:
        ctx.slo_targets = None
        ctx.exemplar_count = 16
        ctx.exemplar_max_bytes = 64 * 1024
    return out


@pytest.mark.parametrize("scene", list(SCENES))
def test_record_stream_matches_jax(scene):
    plan = _plan(seed=list(SCENES).index(scene))
    with patch_clock(FakeClock()) as clock:
        want = _run_scene(jobs, JaxContext, clock, scene, plan)
    with patch_clock(FakeClock()) as clock:
        got = _run_scene(obs, OrcaContext, clock, scene, plan)
    for key in ("slo", "shadow", "blame", "stats", "ledgers", "index",
                "counters"):
        assert got[key] == want[key], key
    targets, _count, max_bytes = SCENES[scene]
    assert [d[:5] for d in got["docs"]] == [d[:5] for d in want["docs"]]
    for doc in got["docs"]:
        assert doc[5] <= max_bytes or doc[6]
    # the SLO judges every closed request, errors too; the blame rollup
    # the finished ones; shadow requests only the shadow tracker
    closed = [r for r in plan if r["end"] != "reject"]
    judged = [r for r in closed if r["klass"] != "shadow"]
    assert got["blame"]["requests_total"] == len(
        [r for r in judged if not r["end"].startswith("error")])
    if targets:
        assert got["slo"]["requests_judged"] == len(judged)
        assert got["shadow"]["requests_judged"] == len(closed) - len(judged)
    assert got["index"]["count"] == min(SCENES[scene][1], len(judged))


def test_every_ledger_sums_to_e2e():
    """Each closed record's phases sum to its e2e within the tolerance
    (exactly, on the dyadic clock), the residual named; JAX's
    `phase_ledger` of the port's snapshot is the port's."""
    plan = _plan(seed=7, n=40)
    with patch_clock(FakeClock()) as clock:
        reset_planes()
        _drive(obs, clock, plan)
    log = obs.request_log.get_request_log()
    for r in plan:
        snap = log.get(r["rid"])
        led = obs.phase_ledger(snap)
        assert led == jobs.phase_ledger(snap)
        assert led["additive_ok"], led
        assert sum(led["phases"].values()) == pytest.approx(
            led["e2e_s"], abs=1e-5)
        if r["end"] in ("length", "eos"):
            assert led["phases"]["decode_blocked_on_batch"] == \
                pytest.approx(r["blocked"] * (r["new"] - 1), abs=1e-5)
    assert obs.get_blame_tracker().stats_block()[
        "additivity_violations"] == 0


# ----------------------------------------------------------------------
# the SLO shedder
# ----------------------------------------------------------------------

GEOMETRY = dict(max_slots=4, block_size=8, max_context=64)


@pytest.fixture(scope="module")
def engines():
    params = jax_params()
    return params, port_model(params)


@pytest.mark.parametrize("max_queue,min_queue", [(None, 2), (5, 3), (2, 4)],
                         ids=["slo_only", "slo_first", "max_queue_first"])
def test_slo_shed_matches_jax(engines, max_queue, min_queue):
    """Both engines, loops not started: the trackers judge the same bad
    requests, then the same submits queue until the same shed, with
    JAX's message and Retry-After (no decode measured yet: 0.5 s)."""
    params, model = engines
    reset_planes()
    got = []
    for o, ctx, eng, qf in (
            (jobs, JaxContext, jax_engine(
                params, max_queue=max_queue, slo_shed_min_queue=min_queue,
                **GEOMETRY), JaxQueueFull),
            (obs, OrcaContext, port_engine(
                model, max_queue=max_queue, slo_shed_min_queue=min_queue,
                **GEOMETRY), QueueFull)):
        ctx.slo_targets = {"ttft_s": 0.1}
        ctx.slo_shed_attainment = 0.9
        try:
            assert eng.slo_shed_min_queue == min_queue
            for ttft in (0.05, 0.5, 0.7):
                o.get_slo_tracker().observe({"ttft_s": ttft})
            taken = 0
            with pytest.raises(qf) as e:
                for i in range(8):
                    eng.submit([1, 2, 3], max_new_tokens=2,
                               request_id=f"s{i}")
                    taken += 1
            got.append((taken, str(e.value), e.value.retry_after_s,
                        o.get_slo_tracker().attainment()))
        finally:
            ctx.slo_targets = None
            ctx.slo_shed_attainment = None
    assert got[0] == got[1]
    assert got[1][0] == min(min_queue, max_queue or min_queue)
    assert got[1][2] == 0.5


def test_shed_needs_targets_and_threshold(engines):
    """Disarmed (either setting None): the queue takes every request."""
    _params, model = engines
    reset_planes()
    obs.get_slo_tracker()
    for targets, thr in (({"ttft_s": 0.1}, None), (None, 0.9)):
        OrcaContext.slo_targets = targets
        OrcaContext.slo_shed_attainment = thr
        try:
            eng = port_engine(model, slo_shed_min_queue=1, **GEOMETRY)
            obs.get_slo_tracker().observe({"ttft_s": 1.0})
            for i in range(6):
                eng.submit([1, 2], max_new_tokens=2)
        finally:
            OrcaContext.slo_targets = None
            OrcaContext.slo_shed_attainment = None


# ----------------------------------------------------------------------
# the blame phases, statically
# ----------------------------------------------------------------------

def _str_consts(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, ast.IfExp):
        return _str_consts(node.body) + _str_consts(node.orelse)
    return []


def _attributed_and_emitted():
    """The phases the port's serving code passes to
    `request_log.attribute` or as `blame_seed` keys, and the kinds it
    passes to `request_log.event` / `_append`."""
    phases, kinds = set(), set()
    roots = [os.path.join(PORT, "serving"),
             os.path.join(PORT, "observability")]
    for root in roots:
        for dirpath, dirnames, files in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in files:
                if not fn.endswith(".py"):
                    continue
                with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                    tree = ast.parse(f.read())
                for node in ast.walk(tree):
                    if not isinstance(node, ast.Call):
                        continue
                    func = node.func
                    attr = getattr(func, "attr", getattr(func, "id", None))
                    if attr == "attribute" and len(node.args) >= 2 and \
                            root.endswith("serving"):
                        phases.update(_str_consts(node.args[1]))
                    elif attr == "event" and len(node.args) >= 2:
                        kinds.update(_str_consts(node.args[1]))
                    elif attr == "_append" and node.args:
                        kinds.update(_str_consts(node.args[0]))
                    for kw in node.keywords:
                        if kw.arg == "blame_seed" and \
                                isinstance(kw.value, ast.Dict):
                            for k in kw.value.keys:
                                phases.update(_str_consts(k))
    return phases, kinds


def test_blame_phases_are_closed():
    from analytics_zoo_tpu_torch.observability import blame
    from analytics_zoo_tpu_torch.observability.request_log import (
        _SEEDABLE_PHASES,
    )
    assert blame.PHASES == jobs.PHASES
    assert blame.EVENT_PHASE_MAP == jobs.blame.EVENT_PHASE_MAP
    phases, kinds = _attributed_and_emitted()
    assert phases, "no attribution found in serving/"
    assert phases <= set(blame.PHASES), phases - set(blame.PHASES)
    assert set(_SEEDABLE_PHASES) <= set(blame.PHASES)
    assert set(blame.EVENT_PHASE_MAP.values()) <= set(blame.PHASES)
    kinds = {k for k in kinds if k.isidentifier() and k.islower()}
    assert kinds <= set(blame.EVENT_PHASE_MAP) | {"token"}, \
        kinds - set(blame.EVENT_PHASE_MAP)
