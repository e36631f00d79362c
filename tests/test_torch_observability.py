"""The port's observability planes (analytics_zoo_tpu_torch/
observability/) held against the JAX package's on one scripted
sequence of calls: tracing, events, goodput, memory, the flight
recorder and the watchdog, with each package's clock (`now`, in every
module that reads it) patched to the same fake clock.

Compared exactly (every number there comes from the fake clock or the
script, so the tolerance is 0): the span trees (names, parent links,
attrs, errors, durations), the event lines without their wall-clock
`ts` (span lines without their ids and wall-clock start), the goodput
tables, the memory samples' fields after the renames, and the flight
bundles' keys and ring kinds after the renames (`RENAMED_FROM_JAX`).
The watchdog trips once on a short deadline in both packages.
`nonfinite_leaves` / `localize_nonfinite` name the same leaves, in the
same order, for the same arrays (numpy for JAX, torch for the port).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.context import OrcaContext
from _torch_chronos_cases import one_torch_thread  # noqa: F401
from _torch_observability_cases import (
    FakeClock,
    patch_clock,
    reset_planes,
)

#: the observability settings the script sets, restored after each test
_SETTINGS = ("observability_dir", "goodput_sample_every",
             "memory_sample_interval_s", "watchdog_deadline_s")


@pytest.fixture(autouse=True, scope="module")
def _reset_both_packages():
    reset_planes()
    yield
    reset_planes()


@pytest.fixture(autouse=True)
def _settings():
    saved = [(ctx, {k: getattr(ctx, k) for k in _SETTINGS})
             for ctx in (OrcaContext, JaxContext)]
    yield
    for ctx, values in saved:
        for k, v in values.items():
            setattr(ctx, k, v)
    reset_planes()


def _script(o, ctx, directory, clock):
    """One sequence of calls on a package's planes; returns what the
    test compares."""
    reset_planes()
    ctx.observability_dir = directory
    ctx.goodput_sample_every = 2
    ctx.memory_sample_interval_s = 0.5
    with o.trace("outer", job="a"):
        clock.tick(0.5)
        with o.trace("inner", i=1):
            clock.tick(0.25)
            o.annotate(k=2)
            o.log_event("thing", n=3, x=np.float32(1.5), tags=["a", "b"])
        with pytest.raises(ValueError):
            with o.trace("fails"):
                clock.tick(0.125)
                raise ValueError("boom")
    c = o.step_clock("spmd_train")
    for i in range(5):
        rec = c.begin()
        clock.tick(0.0625)
        rec.lap("host_input")
        rec.cold = i == 0
        clock.tick(0.125)
        rec.lap("compile" if rec.cold else None)
        if rec.fenced:
            clock.tick(0.25)
            rec.lap("device_compute")
        clock.tick(0.03125)
        rec.end()
    c.attribute("checkpoint", 0.375)
    o.memory.register_provider(
        "kv_pool", lambda: {"blocks_used": 3, "blocks_capacity": 8})
    sample = o.memory.sample()
    o.flight_recorder.record("custom", a=1, secret_token="xyz")
    o.close_sink()
    path = o.flight_recorder.dump("scripted", extra={"k": 1})
    with open(path) as f:
        bundle = json.load(f)
    with open(os.path.join(directory, "events.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return dict(spans=o.recent_spans(100), lines=lines,
                goodput=o.goodput_tables(), sample=sample,
                memory=o.memory.snapshot(), bundle=bundle)


def _tree(spans):
    """Span rows with parent links by name, oldest first."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], by_id.get(s["parent_id"]), s["attrs"],
             s.get("error"), s["duration_s"]) for s in reversed(spans)]


def _line(d):
    d = {k: v for k, v in d.items() if k != "ts"}
    if d["kind"] == "span":
        for k in ("span_id", "parent_id", "trace_id", "start_ts"):
            d.pop(k)
    return d


def _renamed(keys):
    return {obs.RENAMED_FROM_JAX.get(k, k) for k in keys}


def test_scripted_planes_match_jax(tmp_path):
    clock = FakeClock()
    with patch_clock(clock):
        want = _script(jobs, JaxContext, str(tmp_path / "jax"), clock)
        got = _script(obs, OrcaContext, str(tmp_path / "port"), clock)
    assert _tree(got["spans"]) == _tree(want["spans"])
    assert [s[0] for s in _tree(got["spans"])] == ["inner", "fails",
                                                   "outer"]
    assert [_line(d) for d in got["lines"]] == \
        [_line(d) for d in want["lines"]]
    assert got["goodput"] == want["goodput"]
    table = got["goodput"]["spmd_train"]
    assert table["fenced_steps"] == 3 and table["steps"] == 5
    # the fenced buckets sum to the fenced wall (plus the attribution)
    assert sum(table["buckets_s"].values()) == pytest.approx(
        table["fenced_wall_s"] + 0.375, abs=1e-9)
    # memory: JAX's live-buffer field is the port's allocated bytes,
    # beside which the port keeps the reserved bytes
    jax_fields = _renamed(
        k.replace("jax_live_buffer_bytes", "device_allocated_bytes")
        for k in want["sample"])
    assert set(got["sample"]) == jax_fields | {"device_reserved_bytes"}
    for k in ("kv_pool_blocks_used", "kv_pool_blocks_capacity"):
        assert got["sample"][k] == want["sample"][k]
    assert got["memory"]["n_samples"] == want["memory"]["n_samples"]
    # the bundle: JAX's keys, "jax" renamed; the same ring, redacted
    assert set(got["bundle"]) == _renamed(want["bundle"]) \
        == set(obs.flight_recorder.BUNDLE_KEYS) | {"extra"}
    assert [e["kind"] for e in got["bundle"]["ring"]] == \
        [e["kind"] for e in want["bundle"]["ring"]]
    custom = [e for e in got["bundle"]["ring"] if e["kind"] == "custom"]
    assert custom[0]["secret_token"] == "<redacted>"
    assert got["bundle"]["torch"]["version"] == torch.__version__
    assert got["bundle"]["goodput"] == want["bundle"]["goodput"]
    # the serving planes' sections: no history recorded, no alert, no
    # finished request, and a Perfetto sibling written beside each bundle
    for k in ("history_tail", "alerts_active", "exemplars"):
        assert got["bundle"][k] == want["bundle"][k]
    for b in (got["bundle"], want["bundle"]):
        assert b["timeline_path"].endswith(".trace.json")
        assert os.path.isfile(b["timeline_path"])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_watchdog_trips_once_on_a_short_deadline(tmp_path, pkg):
    o, ctx = (jobs, JaxContext) if pkg == "jax" else (obs, OrcaContext)
    ctx.observability_dir = str(tmp_path)
    clock = FakeClock()
    with patch_clock(clock):
        reset_planes()
        wd = o.maybe_watchdog("estimator_fit", deadline_s=0.2)
        tripped = []
        wd.on_stall = tripped.append
        wd.arm()
        try:
            clock.tick(0.1)
            wd.beat()
            clock.tick(0.5)
            for _ in range(200):
                if wd.stalls:
                    break
                wd._stop.wait(0.01)
            # one dump per episode, however long it lasts
            clock.tick(5.0)
            wd._stop.wait(0.2)
        finally:
            wd.stop()
    assert wd.stalls == 1 and tripped == [pytest.approx(0.5)]
    assert o.get_registry().counter("watchdog_stall_total").value == 1
    bundles = o.flight_recorder.find_bundles(str(tmp_path))
    with open(bundles[-1]) as f:
        bundle = json.load(f)
    assert bundle["reason"] == "watchdog_stall"
    assert bundle["extra"] == {"watchdog": "estimator_fit",
                               "stalled_s": 0.5, "deadline_s": 0.2}


def test_watchdog_is_off_without_a_deadline():
    for o, ctx in ((jobs, JaxContext), (obs, OrcaContext)):
        ctx.watchdog_deadline_s = None
        assert o.maybe_watchdog("generation") is None
        ctx.watchdog_deadline_s = 3.0
        wd = o.maybe_watchdog("generation")
        assert wd.deadline_s == 3.0 and wd.name == "generation"


def _arrays():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    a[1, 2] = np.nan
    a[2, 0] = np.inf
    b = rng.normal(size=5).astype(np.float32)
    c = np.array([[np.nan, 1.0]], np.float32)
    return {"params": {"z_head": {"bias": c, "kernel": a},
                       "a_embed": {"embedding": b}},
            "predictions": [b, c],
            "loss": np.float32(np.nan),
            "ids": np.arange(4, dtype=np.int32)}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


def test_nonfinite_localization_matches_jax():
    arrays = _arrays()
    want = jobs.localize_nonfinite(_to(arrays, jnp.asarray))
    got = obs.localize_nonfinite(
        _to(arrays, lambda a: torch.from_numpy(np.array(a))))
    assert got == want
    assert [f["path"] for f in got] == [
        "params:['z_head']['bias']", "params:['z_head']['kernel']",
        "predictions:[1]", "loss:"]
    assert got[1]["nan"] == got[1]["inf"] == 1
    # the cap, and a leaf-level walk with a prefix
    assert obs.localize_nonfinite(arrays, max_leaves=2) == \
        jobs.localize_nonfinite(arrays, max_leaves=2)
    assert obs.nonfinite_leaves(arrays["params"], prefix="p") == \
        jobs.nonfinite_leaves(arrays["params"], prefix="p")


#: the port files whose timing goes through `observability.now`, as JAX's
#: whole package does (scripts/check_no_ad_hoc_timers.py); the rest of
#: the port is not held to it yet
_ONE_CLOCK = ("orca/learn/spmd.py", "orca/learn/estimator.py",
              "serving/generation/engine.py",
              "serving/generation/scheduler.py")


def test_one_clock_in_the_instrumented_files():
    obs_dir = os.path.dirname(obs.__file__)
    paths = [os.path.join(os.path.dirname(obs_dir), p) for p in _ONE_CLOCK]
    paths += [os.path.join(obs_dir, f) for f in sorted(os.listdir(obs_dir))
              if f.endswith(".py") and f != "registry.py"]
    hits = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                if "perf_counter" in line:
                    hits.append(f"{path}:{lineno}: {line.strip()}")
    assert len(paths) == 4 + 18 and not hits, hits
