"""The port's durable streaming data plane (analytics_zoo_tpu_torch/
serving/streaming/) against the JAX package's, on the CPU.

* The log's bytes are JAX's: a segment directory written by either
  package's `StreamLog` is read by the other's, and a whole stream (its
  segments and its groups' durable cursors) reopens across packages.
* Torn-tail recovery: the last frame cut at every byte keeps the same
  ids, the same torn count and the same truncated size in both.
* Rotation and retention drop the same segments.
* Leases, acks, late acks and dead-consumer replay run under a fake
  clock (`DurableStream(clock=...)`): a lease expires when the test
  moves the clock, with no sleep.
* `StreamBacklogFull` is a 429 whose Retry-After comes from the ack
  drain rate on that clock.
* The ``stream.*`` fault sites at every phase, a SIGKILL mid-stream and
  a consumer killed mid-record lose no accepted record.
* The open-loop traces equal JAX's for the same seed, element for
  element, and `run_open_loop` reports the same keys.

Every comparison here is exact."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from _torch_observability_cases import FakeClock
from analytics_zoo_tpu.serving.streaming import log as jax_log
from analytics_zoo_tpu.serving.streaming import open_loop as jax_open_loop
from analytics_zoo_tpu.serving.streaming import stream as jax_stream
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.resilience.faults import SimulatedCrash
from analytics_zoo_tpu_torch.serving.errors import http_status_for
from analytics_zoo_tpu_torch.serving.streaming import (
    DurableStream,
    StreamBacklogFull,
    StreamConsumer,
    StreamHub,
    bursty_trace,
    poisson_trace,
    run_open_loop,
)
from analytics_zoo_tpu_torch.serving.streaming.log import (
    HEADER_SIZE,
    StreamLog,
    encode_frame,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    OrcaContext.fault_plan = None


LOGS = {"jax": jax_log.StreamLog, "port": StreamLog}


# -- the framed log ----------------------------------------------------


def test_frames_are_the_jax_package_bytes():
    rng = np.random.default_rng(0)
    for rid in (1, 2, 1000, 2 ** 40):
        payload = rng.integers(0, 256, int(rng.integers(0, 5000)),
                               dtype=np.uint8).tobytes()
        assert encode_frame(rid, payload) == \
            jax_log.encode_frame(rid, payload)
    assert HEADER_SIZE == jax_log.HEADER_SIZE == 20


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_a_segment_written_by_one_package_reads_in_the_other(
        tmp_path, writer, reader):
    rng = np.random.default_rng(1)
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(0, 300, 40)]
    d = str(tmp_path / "log")
    frame = len(encode_frame(1, b"x" * 150))
    w = LOGS[writer](d, segment_bytes=3 * frame, fsync_every_n=3)
    ids = [w.append(p) for p in payloads]
    w.close()
    r = LOGS[reader](d)
    assert r.ids() == ids == list(range(1, 41))
    assert [r.read(i) for i in ids] == payloads
    assert r.torn_frames == 0
    # appends go on in the other package, and the first reads them
    assert r.append(b"from-the-reader") == 41
    r.close()
    again = LOGS[writer](d)
    assert again.read(41) == b"from-the-reader"
    assert len(os.listdir(d)) > 1          # rotated segments
    again.close()


def test_a_whole_stream_reopens_across_packages(tmp_path):
    """Segments and the groups' durable cursors: a JAX stream with acks
    (in and out of order) reopens in the port with the same lag and
    replays the same unacked ids, and the port's acks read back in
    JAX."""
    d = str(tmp_path / "s")
    js = jax_stream.DurableStream(d, name="s")
    for i in range(6):
        js.enqueue(json.dumps({"i": i}).encode())
    js.dequeue("g", "c", max_records=6)
    js.ack("g", [1, 2, 4])
    js.close()
    ps = DurableStream(d, name="s")
    assert ps.lag("g") == 3
    assert ps.stats()["groups"]["g"]["cursor"] == 2
    assert [r.record_id for r in ps.dequeue("g", "c", max_records=9)] \
        == [3, 5, 6]
    assert json.loads(ps.log.read(5)) == {"i": 4}
    ps.ack("g", [3, 5])
    ps.close()
    js2 = jax_stream.DurableStream(d, name="s")
    assert js2.lag("g") == 1
    assert js2.stats()["groups"]["g"]["cursor"] == 5
    js2.close()


def test_torn_tail_recovery_stops_at_the_same_offset(tmp_path):
    payloads = [b"alpha", b"bravo-bravo", b"charlie"]
    frame3 = encode_frame(3, payloads[2])
    for cut in range(len(frame3) + 1):
        seen = {}
        for name, cls in LOGS.items():
            d = str(tmp_path / f"{name}-{cut}")
            log = cls(d)
            for p in payloads:
                log.append(p)
            log.close()
            seg = os.path.join(d, os.listdir(d)[0])
            with open(seg, "r+b") as f:
                f.truncate(os.path.getsize(seg) - len(frame3) + cut)
            log2 = cls(d)
            seen[name] = (log2.ids(), log2.torn_frames,
                          os.path.getsize(seg))
            if cut < len(frame3):
                assert log2.append(b"replacement") == 3
            log2.close()
        assert seen["port"] == seen["jax"], cut
        whole = cut == len(frame3)
        assert seen["port"][0] == ([1, 2, 3] if whole else [1, 2])
        assert seen["port"][1] == (1 if 0 < cut < len(frame3) else 0)


def test_a_flipped_byte_mid_segment_ends_it_in_both(tmp_path):
    for name, cls in LOGS.items():
        d = str(tmp_path / name)
        log = cls(d)
        for p in (b"one", b"two", b"three"):
            log.append(p)
        log.close()
        seg = os.path.join(d, os.listdir(d)[0])
        off = len(encode_frame(1, b"one")) + HEADER_SIZE
        with open(seg, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
        log2 = cls(d)
        assert log2.ids() == [1] and log2.torn_frames == 1, name
        log2.close()


def test_rotation_and_retention_drop_the_same_segments(tmp_path):
    frame = len(encode_frame(1, b"x" * 10))
    seen = {}
    for name, cls in LOGS.items():
        d = str(tmp_path / name)
        log = cls(d, segment_bytes=frame * 2, fsync_every_n=1)
        for _ in range(7):
            log.append(b"x" * 10)
        segs = sorted(fn for fn in os.listdir(d) if fn.endswith(".log"))
        drops = [log.drop_through(k) for k in (4, 6, 7)]
        seen[name] = (segs, drops, log.ids(), sorted(os.listdir(d)))
        log.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == [4, 2, 0] and seen["port"][2] == [7]


# -- consumer groups, on a fake clock ----------------------------------


def test_leases_acks_and_replay_on_a_fake_clock(tmp_path):
    clock = FakeClock()
    s = DurableStream(str(tmp_path / "s"), visibility_timeout_s=5.0,
                      clock=clock)
    s.enqueue(b"work")
    a = s.dequeue("g", "dead-consumer")
    assert (a[0].record_id, a[0].attempts) == (1, 1)
    assert s.dequeue("g", "survivor") == []       # leased elsewhere
    assert s.stats()["groups"]["g"]["leased"] == 1
    clock.tick(4.99)
    assert s.dequeue("g", "survivor") == []
    clock.tick(0.02)                              # the lease lapsed
    b = s.dequeue("g", "survivor")
    assert (b[0].record_id, b[0].attempts) == (1, 2)
    assert s.ack("g", b[0].record_id) == 1
    assert s.ack("g", a[0].record_id) == 0        # a late ack: a no-op
    assert s.lag("g") == 0
    # a replayed record acked first by the dead consumer counts once
    s.enqueue(b"w2")
    a2 = s.dequeue("g", "a")
    clock.tick(6.0)
    b2 = s.dequeue("g", "b")
    assert b2[0].record_id == a2[0].record_id == 2
    assert s.ack("g", a2[0].record_id) == 1
    assert s.ack("g", b2[0].record_id) == 0
    # release: immediately deliverable again, no clock move
    s.enqueue(b"w3")
    c = s.dequeue("g", "c")
    s.release("g", c[0].record_id)
    assert s.dequeue("g", "d")[0].attempts == 2
    s.close()


def test_the_same_sequence_in_both_packages(tmp_path, monkeypatch):
    """One scripted sequence of enqueues, leases, clock moves and acks:
    the same deliveries, attempts, ack counts and stats.  JAX's stream
    reads `time.monotonic` through its module's `time`, which the test
    replaces there alone."""
    import types

    def run(s, clock):
        out = []
        for i in range(5):
            s.enqueue(b"r%d" % i)
        out.append([(r.record_id, r.attempts)
                    for r in s.dequeue("g", "a", max_records=3)])
        clock.tick(1.0)
        out.append(s.ack("g", [2]))
        out.append([(r.record_id, r.attempts)
                    for r in s.dequeue("g", "b", max_records=5)])
        clock.tick(1.5)
        out.append([(r.record_id, r.attempts)
                    for r in s.dequeue("g", "c", max_records=5)])
        out.append(s.ack("g", [1, 3, 4, 5]))
        st = s.stats()
        out.append((st["groups"], st["backlog"], st["last_id"]))
        s.close()
        return out

    port_clock, jax_clock = FakeClock(), FakeClock()
    got = run(DurableStream(str(tmp_path / "port"),
                            visibility_timeout_s=2.0, clock=port_clock),
              port_clock)
    monkeypatch.setattr(jax_stream, "time",
                        types.SimpleNamespace(monotonic=jax_clock))
    want = run(jax_stream.DurableStream(str(tmp_path / "jax"),
                                        visibility_timeout_s=2.0),
               jax_clock)
    assert got == want
    assert got[3] == [(1, 2), (3, 2)]      # 4 and 5 still leased to b


def test_two_consumers_never_hold_the_same_record(tmp_path):
    s = DurableStream(str(tmp_path / "s"), visibility_timeout_s=30.0)
    for i in range(40):
        s.enqueue(b"r%d" % i)
    held = {"a": [], "b": []}
    barrier = threading.Barrier(2)

    def consume(name):
        barrier.wait()
        while True:
            recs = s.dequeue("g", name, max_records=3)
            if not recs:
                return
            held[name].extend(r.record_id for r in recs)

    ts = [threading.Thread(target=consume, args=(n,)) for n in held]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert set(held["a"]) & set(held["b"]) == set()
    assert sorted(held["a"] + held["b"]) == list(range(1, 41))
    s.close()


def test_an_unknown_ack_changes_nothing(tmp_path):
    s = DurableStream(str(tmp_path / "s"))
    s.enqueue(b"a")
    s.enqueue(b"b")
    s.dequeue("g", "c", max_records=2)
    with pytest.raises(ValueError):
        s.ack("g", [1, 99])
    assert s.lag("g") == 2
    assert s.stats()["groups"]["g"]["cursor"] == 0
    assert s.ack("g", [1, 2]) == 2
    s.close()


def test_backlog_full_is_a_429_with_the_drain_rate(tmp_path):
    clock = FakeClock()
    s = DurableStream(str(tmp_path / "s"), max_backlog=3, clock=clock)
    for _ in range(3):
        s.enqueue(b"x")
    with pytest.raises(StreamBacklogFull) as ei:
        s.enqueue(b"overflow")
    assert ei.value.retry_after_s == 1.0          # no drain seen yet
    assert http_status_for(ei.value) == 429
    for r in s.dequeue("g", "c", max_records=3):
        clock.tick(0.5)                           # an ack every 0.5 s
        s.ack("g", r.record_id)
    for _ in range(3):
        s.enqueue(b"y")
    with pytest.raises(StreamBacklogFull) as ei:
        s.enqueue(b"overflow")
    # 2 acks a second, one slot to free: 0.5 s
    assert ei.value.retry_after_s == pytest.approx(0.5)
    s.close()


def test_retention_follows_the_slowest_group(tmp_path):
    frame = len(encode_frame(1, b"x" * 10))
    s = DurableStream(str(tmp_path / "s"), segment_bytes=frame * 2,
                      fsync_every_n=1)
    for _ in range(6):
        s.enqueue(b"x" * 10)
    s.dequeue("fast", "c", max_records=6)
    s.dequeue("slow", "c", max_records=2)
    s.ack("fast", [1, 2, 3, 4, 5, 6])
    assert s.stats()["records_retained"] == 6
    s.ack("slow", [1, 2])
    assert s.stats()["records_retained"] == 4
    s.close()


def test_the_hub_names_and_reloads(tmp_path):
    root = str(tmp_path / "hub")
    hub = StreamHub(root, max_backlog=8)
    hub.get("a").enqueue(b"1")
    hub.get("b").enqueue(b"2")
    hub.get("b").enqueue(b"3")
    for bad in ("../escape", ""):
        with pytest.raises(ValueError):
            hub.get(bad)
    assert hub.names() == ["a", "b"] and hub.total_backlog() == 3
    hub.close()
    hub2 = StreamHub(root)
    assert hub2.names() == ["a", "b"]
    assert hub2.get("b").log.last_id == 2
    hub2.close()


# -- faults at every phase, a SIGKILL, a consumer killed ---------------


@pytest.mark.parametrize("site,action", [
    ("stream.append", "crash"), ("stream.append", "torn_write"),
    ("stream.fsync", "crash"), ("stream.fsync", "torn_write"),
    ("stream.lease", "crash"), ("stream.ack", "crash")])
def test_a_fault_at_every_stream_phase_recovers(tmp_path, site, action):
    d = str(tmp_path / "s")
    clock = FakeClock()
    s = DurableStream(d, name="s", fsync_every_n=2, clock=clock)
    accepted = [s.enqueue(b"pre-%d" % i) for i in range(3)]
    s.ack("g", s.dequeue("g", "c0")[0].record_id)
    OrcaContext.fault_plan = {"faults": [{"site": site,
                                          "action": action}]}
    with pytest.raises(SimulatedCrash):
        if site in ("stream.append", "stream.fsync"):
            while True:
                accepted.append(s.enqueue(b"doomed"))
        elif site == "stream.lease":
            s.dequeue("g", "c0")
        else:
            s.ack("g", s.dequeue("g", "c0")[0].record_id)
    OrcaContext.fault_plan = None
    s.close()
    s2 = DurableStream(d, name="s")
    surviving = set(s2.log.ids())
    cursor = s2.stats()["groups"]["g"]["cursor"]
    assert cursor >= 1
    if action == "crash":
        assert all(r in surviving or r <= cursor for r in accepted)
    else:
        assert s2.log.torn_frames <= 1
        assert sorted(surviving) == list(range(1, len(surviving) + 1))
    replay = [r.record_id for r in s2.dequeue("g", "c1", max_records=10)]
    assert replay == [r for r in sorted(surviving) if r > cursor]
    if replay:
        s2.ack("g", replay)
    assert s2.lag("g") == 0
    s2.close()


def test_a_torn_fsync_truncates_at_the_last_good_frame(tmp_path):
    """The phase 25 (d) scene: ``torn_write`` at ``stream.fsync`` halves
    the segment mid-frame; recovery keeps the whole frames before the
    tear, counts it, and the stream goes on."""
    d = str(tmp_path / "s")
    # 7 equal frames when the fsync fires: half the segment is mid-frame
    s = DurableStream(d, name="s", fsync_every_n=7)
    for i in range(6):
        s.enqueue(b"payload-%02d" % i)
    OrcaContext.fault_plan = {"faults": [{"site": "stream.fsync",
                                          "action": "torn_write"}]}
    with pytest.raises(SimulatedCrash):
        s.enqueue(b"payload-06")
    OrcaContext.fault_plan = None
    s.close()
    seg = os.path.join(d, "segments", os.listdir(
        os.path.join(d, "segments"))[0])
    s2 = DurableStream(d, name="s")
    ids = s2.log.ids()
    frame = len(encode_frame(1, b"payload-00"))
    assert ids == [1, 2, 3]
    assert s2.log.torn_frames == 1
    assert os.path.getsize(seg) == len(ids) * frame
    assert s2.enqueue(b"after") == len(ids) + 1
    s2.close()


_KILL_CHILD = r"""
import sys
from analytics_zoo_tpu_torch.serving.streaming import DurableStream

s = DurableStream(sys.argv[1], name="k", fsync_every_n=4)
i = 0
while True:
    i += 1
    print(s.enqueue(("rec-%06d" % i).encode()), flush=True)
"""


def test_a_sigkill_mid_stream_loses_no_accepted_record(tmp_path):
    d = str(tmp_path / "s")
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD, d], stdout=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    accepted = []
    try:
        while len(accepted) < 25:
            line = proc.stdout.readline()
            assert line, "the child died early"
            accepted.append(int(line))
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
    s = DurableStream(d, name="k")
    surviving = set(s.log.ids())
    assert [r for r in accepted if r not in surviving] == []
    assert s.log.torn_frames <= 1
    assert [r.record_id for r in s.dequeue(
        "g", "c", max_records=len(surviving))] == sorted(surviving)
    s.close()


def _wait(cond, timeout=20.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.005)


def test_a_consumer_killed_mid_record_replays_the_same_id(tmp_path):
    clock = FakeClock()
    s = DurableStream(str(tmp_path / "in"), visibility_timeout_s=5.0,
                      clock=clock)
    out = DurableStream(str(tmp_path / "out"))
    seen, done = [], []
    hold = threading.Event()

    def slow(doc, rec):
        seen.append((rec.record_id, rec.attempts))
        hold.wait(10.0)
        return {"done": rec.record_id}

    def fast(doc, rec):
        done.append((rec.record_id, rec.attempts))
        return {"done": rec.record_id}

    c1 = StreamConsumer(s, "g", "victim", slow, out_stream=out,
                        poll_s=0.01).start()
    s.enqueue(json.dumps({"v": 1}).encode())
    _wait(lambda: seen)
    c1.kill()
    hold.set()
    c1.stop(timeout=5)
    assert out.log.last_id == 0                  # nothing emitted
    c2 = StreamConsumer(s, "g", "survivor", fast, out_stream=out,
                        poll_s=0.01).start()
    time.sleep(0.05)
    assert done == []                            # the lease still holds
    clock.tick(5.01)
    _wait(lambda: done)
    c2.stop(timeout=5)
    assert done == [(seen[0][0], 2)]
    assert s.lag("g") == 0 and out.log.last_id == 1
    assert json.loads(out.log.read(1))["done"] == seen[0][0]
    s.close()
    out.close()


# -- the open-loop harness ---------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_open_loop_traces_equal_jax(seed):
    for rate, dur in ((50.0, 4.0), (3.5, 20.0), (400.0, 0.5)):
        assert poisson_trace(rate, dur, seed) == \
            jax_open_loop.poisson_trace(rate, dur, seed)
        for b in (0.5, 4.0):
            assert bursty_trace(rate, dur, seed, burstiness=b) == \
                jax_open_loop.bursty_trace(rate, dur, seed, burstiness=b)
    assert poisson_trace(0, 1, seed) == [] == bursty_trace(1, 0, seed)
    with pytest.raises(ValueError):
        bursty_trace(1.0, 1.0, seed, burstiness=0)


def test_run_open_loop_reports_jax_keys():
    arrivals = poisson_trace(200.0, 0.25, seed=3)

    def submit(i):
        if i % 4 == 0:
            return {"status": "shed", "retry_after": True}
        return {"status": "ok"}

    got = run_open_loop(submit, arrivals, slo_s=5.0)
    want = jax_open_loop.run_open_loop(submit, arrivals, slo_s=5.0)
    assert got.keys() == want.keys()
    n_shed = len(range(0, len(arrivals), 4))
    for r in (got, want):
        assert r["offered"] == len(arrivals)
        assert r["shed"] == r["shed_with_retry_after"] == n_shed
        assert r["admitted"] == r["completed_ok"] == len(arrivals) - n_shed
        assert r["attainment_admitted"] == 1.0
