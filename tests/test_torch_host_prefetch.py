"""Host-input double buffering in the port's train engine
(analytics_zoo_tpu_torch/orca/learn/spmd.py `_HostPrefetcher` and
`PinnedRing`, `OrcaContext.host_input_prefetch`), against the JAX
engine's `_HostPrefetcher` (analytics_zoo_tpu/orca/learn/spmd.py):
the staging order at each depth, a fit whose losses do not depend on
the depth, and the pinned ring's slot reuse, event waits and growth.

The ring's copies to the card run only there (`chip_smoke.py` phase 13
(b) holds a depth-2 fit bitwise against a depth-0 one on an H100); here
the ring's bookkeeping runs with host buffers and stand-in events."""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.orca.learn.spmd import SPMDEngine
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.orca.data import XShards
from analytics_zoo_tpu_torch.orca.learn import Estimator, spmd


@pytest.fixture(autouse=True)
def _depth():
    prev = OrcaContext.host_input_prefetch
    yield
    OrcaContext.host_input_prefetch = prev


class _Eng:
    put_batch = staticmethod(lambda b: ("staged", b))


def _drain(pre, restage):
    out = []
    while (b := pre.pop()) is not None:
        out.append(b)
        if restage:
            pre.stage(1)
    return out


@pytest.mark.parametrize("depth", [0, 1, 2, 7])
def test_prefetcher_order_and_exhaustion_match_jax(depth):
    """Staged up front (depth batches), popped in order, `stage` past
    the end a no-op, then None; JAX's prefetcher does the same."""
    items = list(range(5))
    calls = []

    def put(b):
        calls.append(b)
        return ("staged", b)

    port = spmd._HostPrefetcher(put, iter(items), depth)
    want = SPMDEngine._HostPrefetcher(_Eng(), iter(items), depth)
    assert len(port._staged) == len(want._staged) == min(depth, 5)
    assert calls == items[:min(depth, 5)]
    got = _drain(port, depth > 0)
    assert got == _drain(want, depth > 0) == [("staged", i) for i in items]
    port.stage(3)
    assert port.pop() is None and len(calls) == 5


def test_prefetcher_stages_the_next_batch_after_the_step():
    """At depth 2 the loop pops batch k, runs its step, then stages
    batch k + 2: a trace of the order of puts and steps."""
    trace = []

    def put(b):
        trace.append(f"put{b}")
        return b

    pre = spmd._HostPrefetcher(put, iter(range(4)), 2)
    while (b := pre.pop()) is not None:
        trace.append(f"step{b}")
        pre.stage(1)
    assert trace == ["put0", "put1", "step0", "put2", "step1", "put3",
                     "step2", "step3"]


def _fit(depth, data, epochs=2):
    OrcaContext.host_input_prefetch = depth
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Embedding(50, 8), torch.nn.Flatten(),
                                torch.nn.Linear(8, 2))
    est = Estimator.from_torch(model, loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=1e-2,
                               metrics=["accuracy"])
    est.fit(data, epochs=epochs, batch_size=16)
    preds = est.predict(data, batch_size=16)
    ev = est.evaluate(data, batch_size=16)
    return ([s["loss"] for s in est.train_summary],
            [dict(s) for s in est.engine.last_steps], preds, ev)


@pytest.mark.parametrize("as_shards", [False, True], ids=["arrays", "xshards"])
def test_fit_is_identical_at_every_depth(as_shards):
    """Per-step stats, epoch losses, predictions and evaluation equal
    bit for bit at depths 0 to 3 (shuffled, ragged last batch)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 50, (85, 1))
    y = (x[:, 0] % 2).astype(np.int32)
    data = XShards.partition({"x": x, "y": y}, 6) if as_shards \
        else {"x": x, "y": y}
    runs = [_fit(d, data) for d in (0, 1, 2, 3)]
    for run in runs[1:]:
        assert run[0] == runs[0][0] and run[1] == runs[0][1]
        np.testing.assert_array_equal(run[2], runs[0][2])
        assert run[3] == runs[0][3]
    assert runs[0][0][1] < runs[0][0][0]


def test_host_input_prefetch_validates_as_jax_does():
    with pytest.raises(ValueError, match=">= 0"):
        OrcaContext.host_input_prefetch = -1
    OrcaContext.host_input_prefetch = "3"
    assert OrcaContext.host_input_prefetch == 3


def test_cpu_engine_stages_with_put_batch():
    """On the CPU staging is `torch.from_numpy` (`put_batch`) at every
    depth, with no ring."""
    eng = spmd.TrainEngine(torch.nn.Linear(2, 1), spmd.Optimizer(
        torch.optim.SGD, dict(lr=0.1)))
    for depth in (0, 2):
        OrcaContext.host_input_prefetch = depth
        put, d = eng._stager()
        assert put == eng.put_batch and d == depth and eng.ring is None


class _Event:
    """A stand-in CUDA event: busy until `done` is set."""

    def __init__(self, log):
        self.log, self.done = log, False

    def query(self):
        return self.done

    def synchronize(self):
        self.log.append("wait")
        self.done = True

    def record(self):
        self.log.append("record")
        self.done = False


class _HostRing(spmd.PinnedRing):
    """The ring's bookkeeping with host buffers and stand-in events."""

    def __init__(self, slots):
        super().__init__(torch.device("cpu"), slots)
        self.log = []

    def _alloc(self, nbytes):
        self.log.append(f"alloc{nbytes}")
        return torch.empty(nbytes, dtype=torch.uint8)

    def _event(self):
        return _Event(self.log)


def _batch(rng, rows):
    return {"features": (rng.integers(0, 9, (rows, 3)).astype(np.int32),
                         rng.normal(size=(rows,)).astype(np.float32)),
            "labels": (rng.integers(0, 2, rows).astype(np.int64),),
            "mask": np.ones(rows, np.float32)}


def test_pinned_ring_reuses_slots_after_their_event():
    rng = np.random.default_rng(1)
    ring = _HostRing(3)
    bufs = []
    for k in range(7):
        b = _batch(rng, 8)
        staged = ring.put(b)
        for got, want in zip((*staged["features"], *staged["labels"],
                              staged["mask"]),
                             (*b["features"], *b["labels"], b["mask"])):
            assert got.dtype == torch.from_numpy(want).dtype
            np.testing.assert_array_equal(got.numpy(), want)
        bufs.append(ring.buffers[k % 3].data_ptr())
    # round robin over 3 slots, each buffer allocated once
    assert bufs[:3] == bufs[3:6] and len(set(bufs[:3])) == 3
    assert sum(e.startswith("alloc") for e in ring.log) == 3
    # from the 4th put on, each reuse waits on its slot's copy first
    assert ring.waits == 4 and ring.puts == 7
    assert ring.log.count("wait") == 4 and ring.log.count("record") == 7
    first_wait = ring.log.index("wait")
    assert ring.log[first_wait - 1] == "record"     # the third put's


def test_pinned_ring_counts_no_wait_for_a_finished_copy():
    rng = np.random.default_rng(2)
    ring = _HostRing(2)
    for _ in range(2):
        ring.put(_batch(rng, 4))
    for ev in ring.events:
        ev.done = True
    ring.put(_batch(rng, 4))
    assert ring.waits == 0


def test_pinned_ring_grows_only_when_a_batch_outgrows_its_slot():
    rng = np.random.default_rng(3)
    ring = _HostRing(1)
    ring.put(_batch(rng, 8))
    small = ring.nbytes
    ring.put(_batch(rng, 4))
    assert ring.nbytes == small
    ring.put(_batch(rng, 64))
    assert ring.nbytes > small
    assert sum(e.startswith("alloc") for e in ring.log) == 2
    # every array starts on an aligned offset
    assert small % spmd.PinnedRing.ALIGN == 0
    assert ring.stats() == {"slots": 1, "bytes": ring.nbytes, "puts": 3,
                            "waits": 2}


def test_pinned_ring_stages_every_dtype_as_put_batch_does():
    """bool, float64, int8 and an empty array, one slot written over:
    each staged tensor equals `put_batch`'s, dtype and shape included."""
    rng = np.random.default_rng(4)
    eng = spmd.TrainEngine(torch.nn.Linear(2, 1), spmd.Optimizer(
        torch.optim.SGD, dict(lr=0.1)))
    ring = _HostRing(1)
    for rows in (5, 3):
        b = {"features": (rng.integers(0, 2, (rows, 2)).astype(bool),
                          rng.normal(size=(rows, 3, 2)),
                          np.zeros((rows, 0), np.float32)),
             "labels": (rng.integers(-9, 9, rows).astype(np.int8),),
             "mask": np.ones(rows, np.float32)}
        got, want = ring.put(b), eng.put_batch(b)
        for key in ("features", "labels"):
            for g, w in zip(got[key], want[key]):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert torch.equal(g, w)
        assert torch.equal(got["mask"], want["mask"])
