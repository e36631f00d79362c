"""The port's metrics history plane and alert engine
(analytics_zoo_tpu_torch/observability/history.py, alerts.py) against
the JAX package's, on the CPU.

* A frame is byte-identical (the same header and CRC32C: the port's
  table CRC against JAX's), and each package's `HistoryReader` reads
  the other's sample log as its own.
* Torn-tail recovery: a log cut mid-header or mid-payload, or with a
  flipped payload bit or a foreign magic, is truncated at the same byte
  by both packages, which then read and resume it alike.
* The derive kinds (rate, delta, quantiles) and the /metrics/history
  payload are equal on the same samples; an unknown kind is JAX's
  ValueError.
* The built-in rule names are JAX's, and `evaluate` gives the same
  verdicts, byte for byte, on synthetic traces drawn from numpy seeds
  that make every rule kind fire and resolve, with every clock made to
  raise (the evaluation reads only the samples).
* The recorder's cadence on the shared fake clock, its samples of the
  same registries, and `get_recorder` disarmed until the interval is
  set, as JAX's.

Exact throughout: the same bytes and the same float arithmetic."""

import json
import os
import shutil
import time

import numpy as np
import pytest

from _torch_observability_cases import FakeClock, patch_clock, reset_planes
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.observability import alerts as jalerts
from analytics_zoo_tpu.observability import history as jhistory
from analytics_zoo_tpu.observability.registry import (
    MetricsRegistry as JaxRegistry,
)
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.observability import alerts, history
from analytics_zoo_tpu_torch.observability.registry import MetricsRegistry

T0 = 1_700_000_000.0

PKGS = {"jax": (jhistory, jalerts, JaxContext, JaxRegistry),
        "port": (history, alerts, OrcaContext, MetricsRegistry)}


@pytest.fixture(autouse=True, scope="module")
def _reset_both_packages():
    reset_planes()
    yield
    reset_planes()


@pytest.mark.parametrize("seq,n", [(1, 0), (2, 1), (77, 300), (2**40, 4096)])
def test_frames_are_byte_identical(seq, n):
    payload = np.random.default_rng(seq % 1000).integers(
        0, 256, n, dtype=np.uint8).tobytes()
    assert history.encode_frame(seq, payload) == \
        jhistory.encode_frame(seq, payload)
    assert history.MAGIC == jhistory.MAGIC
    assert history.HEADER_SIZE == jhistory.HEADER_SIZE


def _samples(seed, n=40, procs=("a", "b")):
    """Synthetic recorder samples: counters that grow (one resets),
    gauges that wander, on two procs sharing a wall clock."""
    rng = np.random.default_rng(seed)
    out = []
    level = {p: 0.0 for p in procs}
    for k in range(n):
        for j, p in enumerate(procs):
            level[p] += float(rng.integers(0, 9))
            if p == "b" and k == n // 2:
                level[p] = 1.0          # a restart
            out.append({
                "ts": round(T0 + 0.25 * k + 0.01 * j, 6), "proc": p,
                "seq": k + 1,
                "counters": {"generation_tokens_total": level[p],
                             "blame_queue_wait_seconds_total":
                                 level[p] / 8},
                "gauges": {"generation_queue_depth":
                           float(rng.integers(0, 6)),
                           "slo_attainment_ratio":
                           float(rng.integers(0, 5)) / 4}})
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_reader_reads_the_others_log(tmp_path, writer):
    hmod = PKGS[writer][0]
    samples = _samples(1, n=12)
    for proc in ("a", "b"):
        log = hmod.SampleLog(str(tmp_path / "history" / proc),
                             segment_bytes=2048)
        for s in samples:
            if s["proc"] == proc:
                log.append(hmod._encode_sample(s))
        log.close()
    got = history.HistoryReader(str(tmp_path)).read_samples()
    want = jhistory.HistoryReader(str(tmp_path)).read_samples()
    assert got == want == sorted(samples, key=lambda s: (s["ts"],
                                                         s["proc"]))
    assert history.HistoryReader(str(tmp_path)).procs() == ["a", "b"]
    assert len(os.listdir(tmp_path / "history" / "a")) > 1   # rotated


def _cut(path, kind):
    """Damage the last frame of a segment as a crash or a bad disk
    would."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    last = len(data) - len(history.encode_frame(5, b'{"i": 4}'))
    if kind == "short_header":
        data = data[:last + 7]
    elif kind == "short_payload":
        data = data[:-3]
    elif kind == "bad_crc":
        data[-2] ^= 0x10
    elif kind == "bad_magic":
        data[last] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))


@pytest.mark.parametrize("kind", ["short_header", "short_payload",
                                  "bad_crc", "bad_magic"])
def test_torn_tail_recovery_matches_jax(tmp_path, kind):
    src = tmp_path / "src"
    log = history.SampleLog(str(src))
    for i in range(5):
        log.append(json.dumps({"i": i}).encode())
    log.close()
    seg = os.path.join(src, os.listdir(src)[0])
    _cut(seg, kind)
    results = []
    for name in ("jax", "port"):
        d = tmp_path / name
        shutil.copytree(src, d)
        hmod = PKGS[name][0]
        read_before = hmod.SampleLog.read_dir(str(d))
        rec = hmod.SampleLog(str(d))
        stats = rec.stats()
        seq = rec.append(b"post")
        rec.close()
        with open(os.path.join(d, os.listdir(d)[0]), "rb") as f:
            results.append((read_before, stats, seq, f.read()))
    assert results[0] == results[1]
    read_before, stats, seq, _ = results[1]
    assert [s for s, _p in read_before] == [1, 2, 3, 4]
    assert stats["torn_frames"] == 1 and seq == 5


@pytest.mark.parametrize("kind", list(history.DERIVE_KINDS) + [None])
def test_derived_series_and_payload_match_jax(kind):
    samples = _samples(2)
    for name in history.series_names(samples):
        if kind is not None:
            assert history.derive_series(samples, name, kind, 1.0) == \
                jhistory.derive_series(samples, name, kind, 1.0)
    kw = dict(family="generation_", since=T0 + 2.0, derive=kind,
              window_s=1.5, fleet=True)
    assert history.history_payload(samples, **kw) == \
        jhistory.history_payload(samples, **kw)
    assert history.merge_samples(samples[::2], samples) == \
        jhistory.merge_samples(samples[::2], samples)


def test_unknown_derive_kind_raises_as_jax():
    for hmod in (history, jhistory):
        with pytest.raises(ValueError) as e:
            hmod.derive_series(_samples(3), "x", "median")
    assert str(e.value) == "unknown derive kind 'median'; one of " \
        "('rate', 'delta', 'quantiles')"


def test_builtin_rule_names_are_jax():
    assert alerts.BUILTIN_ALERTS == jalerts.BUILTIN_ALERTS
    assert [(r.name, r.metric, r.kind, r.params, r.for_s, r.clear_s,
             r.cooldown_s, r.severity) for r in alerts.builtin_rules()] == \
        [(r.name, r.metric, r.kind, r.params, r.for_s, r.clear_s,
          r.cooldown_s, r.severity) for r in jalerts.builtin_rules()]
    with pytest.raises(ValueError, match="unknown kind"):
        alerts.AlertRule("x", metric="m", kind="median")


def _alert_trace(seed, n=160):
    """A recorded trace that makes each rule kind fire and resolve:
    attainment collapses and recovers (burn rate), the queue grows then
    drains (slope), goodput and the hit rates sag under traffic (floor),
    compiles storm, the dominant blame phase changes (shift)."""
    rng = np.random.default_rng(seed)
    out = []
    hits = misses = rounds = compiles = 0.0
    for k in range(n):
        ts = T0 + k
        bad = n // 4 <= k < n // 2
        dh = float(rng.integers(0, 3)) if bad else 8.0
        dm = 10.0 if bad else float(rng.integers(0, 2))
        hits += dh
        misses += dm
        rounds += 5.0
        compiles += 2.0 if bad else 0.0
        out.append({
            "ts": ts, "proc": "p", "seq": k + 1,
            "counters": {"prefix_cache_hits_total": hits,
                         "prefix_cache_misses_total": misses,
                         "speculation_rounds_total": rounds,
                         "compile_events_total": compiles},
            "gauges": {
                "slo_attainment_ratio": (float(rng.integers(0, 3)) / 4
                                         if bad else 1.0),
                "generation_queue_depth": (float(k - n // 4)
                                           if bad else 0.0),
                "goodput_ratio": 0.2 if bad else 0.9,
                "prefix_cache_hit_rate": dh / (dh + dm),
                "speculation_acceptance_rate": 0.05 if bad else 0.6,
                "blame_tail_phase_code": (0.0 if k < n // 2 else 3.0)}})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alert_verdicts_match_jax(monkeypatch, seed):
    samples = _alert_trace(seed)

    def no_clock(*_a, **_k):
        raise AssertionError("the evaluation read a clock")
    monkeypatch.setattr(time, "time", no_clock)
    monkeypatch.setattr(time, "monotonic", no_clock)
    monkeypatch.setattr(time, "perf_counter", no_clock)
    got = alerts.AlertEngine(alerts.builtin_rules()).evaluate(samples)
    want = jalerts.AlertEngine(jalerts.builtin_rules()).evaluate(samples)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    fired = {e["rule"] for e in got["events"] if e["state"] == "firing"}
    resolved = {e["rule"] for e in got["events"]
                if e["state"] == "resolved"}
    assert fired == set(alerts.BUILTIN_ALERTS)
    assert resolved >= {"slo_burn_rate", "goodput_floor",
                        "queue_depth_growth"}


def _recorder_run(name, tmp_path, clock):
    hmod, _amod, ctx, reg_cls = PKGS[name]
    reg = reg_cls()
    c = reg.counter("t_tokens_total")
    g = reg.gauge("t_depth")
    rec = hmod.MetricsRecorder(proc="p", registries=(reg,),
                               families=("t_",), interval_s=0.25,
                               base_dir=str(tmp_path / name),
                               max_bytes=4096)
    due = []
    for k in range(12):
        c.inc(k)
        g.set(float(k % 3))
        due.append(rec.maybe_sample())
        clock.tick(0.125)
    rec.sample(wall_ts=T0)
    rec.close()
    tail = [{k: v for k, v in s.items() if k != "ts"} for s in rec.tail()]
    return due, tail, [s for s, _ in hmod.SampleLog.read_dir(
        str(tmp_path / name / "history" / "p"))]


def test_recorder_cadence_matches_jax(tmp_path):
    with patch_clock(FakeClock()) as clock:
        want = _recorder_run("jax", tmp_path, clock)
    with patch_clock(FakeClock()) as clock:
        got = _recorder_run("port", tmp_path, clock)
    assert got == want
    assert sum(got[0]) == 6 and got[2] == list(range(1, 8))


def test_get_recorder_disarmed_until_interval_set(tmp_path):
    try:
        for _hmod, _a, ctx, _r in PKGS.values():
            ctx.metrics_history_interval_s = None
        history.reset_recorder()
        assert history.get_recorder() is None
        assert history.maybe_record() is False
        OrcaContext.metrics_history_interval_s = 0.25
        OrcaContext.observability_dir = str(tmp_path)
        rec = history.get_recorder()
        assert rec is history.get_recorder()
        assert isinstance(rec.alerts, alerts.AlertEngine)
        assert history.maybe_record() is True      # the first is due
        assert history.maybe_record() is False
        assert os.listdir(tmp_path / "history") == [rec.proc]
        # the recorder counts its samples in the process registry
        assert rec.sample()["counters"][
            "metrics_history_samples_total"] >= 1.0
    finally:
        OrcaContext.metrics_history_interval_s = None
        OrcaContext.observability_dir = None
        history.reset_recorder()
