"""The port's worker pool (analytics_zoo_tpu_torch/serving/
worker_pool.py) on the CPU: one pool of 2 worker processes with
``device="cpu"`` for the module, serving a saved NeuralCF
(`ZooModel.save_model`'s format).

* Each worker is its own interpreter (its own pid) that sees no card;
  the pool's predictions equal the in-process `InferenceModel`'s on the
  same saved weights (|diff| <= 1e-6: both sides run the same f32 ops
  at one torch thread); batches run on both workers.
* The workers' kernel launch counts read back over the pipe (all 0 on
  the CPU, where the kernels' plain versions run) and reset.
* A worker killed under the pool answers `ReplicaDiedMidPredict` for
  that batch alone; the pool respawns it and serves on.
* `ServingServer(worker_pool=)` serves /predict from the workers, counts
  2 replicas in /healthz and /stats, and sheds an over-quota
  X-Tenant with 429 and Retry-After at the door.
* A pool asked for the card (the default) on a machine without one
  raises instead of serving on the CPU; `max_queue` sheds at the
  checkout through the pool's `AdmissionCore`."""

import json
import os
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
from analytics_zoo_tpu_torch.serving import (
    InferenceModel,
    InputQueue,
    ServingServer,
    WorkerPool,
)
from analytics_zoo_tpu_torch.serving.control_plane import (
    reset_tenant_ledger,
)
from analytics_zoo_tpu_torch.serving.errors import (
    QueueFull,
    ReplicaDiedMidPredict,
)

TOL = 1e-6
NCF = dict(user_count=50, item_count=40, class_num=2, user_embed=8,
           item_embed=8, hidden_layers=(16, 8), mf_embed=4)
#: the workers' torch threads, as the test process's
WORKER_ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    torch.manual_seed(0)
    path = str(tmp_path_factory.mktemp("ncf"))
    NeuralCF(**NCF, device="cpu").save_model(path)
    rng = np.random.default_rng(2)
    u = rng.integers(1, NCF["user_count"] + 1, 16).astype(np.int32)
    i = rng.integers(1, NCF["item_count"] + 1, 16).astype(np.int32)
    want = InferenceModel().load_model(path, device="cpu").predict(u, i)
    return path, u, i, want


@pytest.fixture(scope="module")
def pool(saved):
    p = WorkerPool(saved[0], n_workers=2, device="cpu",
                   worker_env=WORKER_ENV, max_batch_size=16)
    yield p
    p.stop()


def test_workers_are_processes_of_their_own_and_predict_alike(pool, saved):
    path, u, i, want = saved
    pids = pool.pids()
    assert len(set(pids)) == 2 and os.getpid() not in pids
    got = [None] * 6

    def run(k):
        got[k] = pool.predict(u[k:k + 10], i[k:k + 10])

    threads = [threading.Thread(target=run, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for k in range(6):
        np.testing.assert_allclose(got[k], want[k:k + 10], atol=TOL)
    assert all(n > 0 for n in pool.per_worker_served())
    assert pool.records_served >= 60


def test_the_launch_counts_read_back_from_each_worker(pool, saved):
    pool.reset_launch_counts()
    counts = pool.launch_counts()
    assert len(counts) == 2
    for c in counts:
        assert c["counts"] and set(c["counts"].values()) == {0}
        assert c["by_body"]["paged_decode"]
    pool.predict(saved[1], saved[2])
    assert all(set(c["counts"].values()) == {0}
               for c in pool.launch_counts())


def test_a_killed_worker_fails_its_batch_alone(pool, saved):
    path, u, i, want = saved
    victim = pool.pids()[0]
    os.kill(victim, signal.SIGKILL)
    died, ok = 0, 0
    for _ in range(4):
        try:
            np.testing.assert_allclose(pool.predict(u, i), want, atol=TOL)
            ok += 1
        except ReplicaDiedMidPredict:
            died += 1
    assert (died, ok) == (1, 3)
    assert victim not in pool.pids() and len(pool.pids()) == 2
    np.testing.assert_allclose(pool.predict(u, i), want, atol=TOL)


def _post(srv, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}",
        data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_the_server_serves_predict_from_the_pool(pool, saved):
    path, u, i, want = saved
    reset_tenant_ledger()
    OrcaContext.tenant_quotas = {"free": {"rate": 0.01, "burst": 1}}
    srv = ServingServer(worker_pool=pool, batch_timeout_ms=1.0).start()
    try:
        q = InputQueue(srv.host, srv.port)
        np.testing.assert_allclose(q.predict(u, i, batched=True), want,
                                   atol=TOL)
        np.testing.assert_allclose(q.predict(u[0], i[0]), want[0],
                                   atol=TOL)
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["replicas"] == 2
        assert stats["worker_pool"]["n_workers"] == 2
        assert stats["tenants"]["free"]["burst"] == 1
        from analytics_zoo_tpu_torch.serving.codec import encode_ndarray
        body = {"inputs": [encode_ndarray(u[:2]), encode_ndarray(i[:2])]}
        code, _, _ = _post(srv, "/predict", body, {"X-Tenant": "free"})
        assert code == 200
        code, headers, out = _post(srv, "/predict", body,
                                   {"X-Tenant": "free"})
        assert code == 429 and float(headers["Retry-After"]) > 0
        assert out["retry_after_s"] > 0
    finally:
        srv.stop()
        OrcaContext.tenant_quotas = None
        reset_tenant_ledger()


def test_the_checkout_queue_is_bounded_by_the_admission_core(pool, saved):
    pool.admission.max_queue = 0
    try:
        with pytest.raises(QueueFull, match="max_queue=0"):
            pool.predict(saved[1], saved[2])
    finally:
        pool.admission.max_queue = None


def test_a_worker_asked_for_the_card_raises_without_one(saved):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed to load"):
        WorkerPool(saved[0], n_workers=1, worker_env=WORKER_ENV)
    assert time.monotonic() - t0 < 120
