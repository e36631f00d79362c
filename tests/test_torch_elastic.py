"""The port's elastic restart driver (analytics_zoo_tpu_torch/resilience/
elastic.py) on the CPU, with the scenarios of JAX's
tests/test_elastic_restart.py and its heartbeat files:

* a member killed in epoch 3 is restarted from the newest committed
  checkpoint and ends bitwise on an uninterrupted run's weights; the
  attempt ledger says so;
* one member's death fences the whole gang: the healthy member's next
  heartbeat raises `WorkerCancelled`, and the restarted gang ends
  bitwise on the uninterrupted weights;
* a stalled member is found past its heartbeat deadline and restarted.
  The driver's clock is a fake one that moves only when the test moves
  it (the wedged member moves it past the deadline), so the detection
  is the driver's next poll, never a race with the wall clock;
* an exhausted restart budget raises `ElasticRestartExceeded`, its
  backoff slept on the driver's clock;
* `touch_heartbeat` writes JAX's file, under JAX's name, and a process
  member (a fresh interpreter that sees no card) SIGKILLed in epoch 3
  resumes to the uninterrupted weights bitwise.

The job is `tests/_torch_elastic_cases.py` at one torch thread."""

import os
import subprocess
import sys
import time

import pytest
import torch

from analytics_zoo_tpu.resilience import elastic as jax_elastic
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.orca.learn.checkpoint import has_commit_marker
from analytics_zoo_tpu_torch.resilience import (
    ElasticRestartExceeded,
    ElasticTrainingDriver,
    RetryPolicy,
    WorkerCancelled,
    touch_heartbeat,
)

import _torch_elastic_cases as cases
from _torch_chronos_cases import one_torch_thread  # noqa: F401

CASES = os.path.abspath(cases.__file__)
REPO = os.path.dirname(os.path.dirname(CASES))
NEVER = float("inf")
#: hits: epochs 0-1 are 8 steps, so hit 10 is epoch 2, step 1
KILL_AT = 10


class FakeClock:
    """The driver's clock: it reads the time `advance` set, and its
    `sleep` records the wait and yields the thread (so members run)
    without moving the time."""

    def __init__(self):
        self.t = 0.0
        self.slept = []

    def monotonic(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt

    def sleep(self, dt: float) -> None:
        self.slept.append(dt)
        time.sleep(0.0005)


@pytest.fixture(autouse=True)
def _no_plan():
    OrcaContext.fault_plan = None
    yield
    OrcaContext.fault_plan = None


def _job(d):
    return lambda ctx: cases.run_job(d, ctx.resume_checkpoint, ctx.heartbeat)


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("full"))
    drv = ElasticTrainingDriver(_job(d), checkpoint_dir=d,
                                heartbeat_timeout_s=NEVER, clock=FakeClock())
    state = drv.run()[0]
    assert drv.restarts == 0 and drv.history[-1]["ok"]
    return state


def _policy(name, attempts=3):
    return RetryPolicy(max_attempts=attempts, backoff_s=0.05, name=name)


def test_kill_resume_is_bitwise(tmp_path, uninterrupted):
    d = str(tmp_path)
    OrcaContext.fault_plan = {"faults": [
        {"site": "train.step", "at": KILL_AT, "action": "raise"}]}
    clock = FakeClock()
    drv = ElasticTrainingDriver(_job(d), checkpoint_dir=d,
                                restart=_policy("test_kill"),
                                heartbeat_timeout_s=NEVER, clock=clock)
    got = drv.run()[0]
    assert drv.restarts == 1
    assert drv.history[0]["ok"] is False and drv.history[0]["dead"] == [0]
    assert drv.history[0]["resume"] is None
    assert drv.history[1]["ok"] is True
    assert drv.history[1]["resume"].endswith("ckpt-1")
    assert has_commit_marker(os.path.join(d, "ckpt-1"))
    assert 0.05 in clock.slept          # the backoff, on the driver's clock
    _equal(got, uninterrupted)


def test_gang_death_fences_every_member(tmp_path, uninterrupted):
    """Member 1 dies at its 6th step on the first attempt; member 0
    waits there to be fenced, so the fence is certain, not a race."""
    d = str(tmp_path)
    fenced = []

    def member(ctx):
        def beat():
            try:
                ctx.heartbeat()
            except WorkerCancelled:
                fenced.append((ctx.worker_id, ctx.attempt))
                raise

        def on_step(epoch, step):
            if ctx.attempt > 1 or epoch * cases.STEPS + step != 5:
                return
            if ctx.worker_id == 1:
                raise RuntimeError("member 1 lost")
            while not ctx.cancelled:
                time.sleep(0.001)
            beat()

        # one checkpoint writer a gang
        ckpt = d if ctx.worker_id == 0 else os.path.join(d, "member1")
        os.makedirs(ckpt, exist_ok=True)
        resume = ctx.resume_checkpoint
        return cases.run_job(ckpt, resume, beat, on_step)

    drv = ElasticTrainingDriver([member, member], checkpoint_dir=d,
                                restart=_policy("test_gang"),
                                heartbeat_timeout_s=NEVER,
                                clock=FakeClock(), drain_timeout_s=30.0)
    results = drv.run()
    assert drv.restarts == 1
    assert drv.history[0]["dead"] == [1]
    assert fenced == [(0, 1)]
    for state in results:
        _equal(state, uninterrupted)


def test_stall_is_detected_and_recovered(tmp_path, uninterrupted):
    d = str(tmp_path)
    beats = []

    def member(ctx):
        def on_step(epoch, step):
            if ctx.attempt == 1 and epoch * cases.STEPS + step == 9:
                # wedged: no heartbeat for 6 s of the driver's clock,
                # until the driver fences it
                beats.append(clock.t)
                clock.advance(6.0)
                while not ctx.cancelled:
                    time.sleep(0.001)
                ctx.heartbeat()

        return cases.run_job(d, ctx.resume_checkpoint, ctx.heartbeat,
                             on_step)

    clock = FakeClock()
    drv = ElasticTrainingDriver(member, checkpoint_dir=d,
                                heartbeat_timeout_s=5.0,
                                restart=_policy("test_stall"), clock=clock)
    got = drv.run()[0]
    assert drv.restarts == 1
    assert drv.history[0]["stalled"] == [0] and drv.history[0]["dead"] == []
    assert drv.history[1]["resume"].endswith("ckpt-1")
    assert beats == [0.0] and clock.t == 6.0
    _equal(got, uninterrupted)


def test_exhausted_budget_raises(tmp_path):
    d = str(tmp_path)
    OrcaContext.fault_plan = {"faults": [
        {"site": "train.step", "at": 1, "times": 99, "action": "raise"}]}
    drv = ElasticTrainingDriver(_job(d), checkpoint_dir=d,
                                restart=_policy("test_budget", 2),
                                heartbeat_timeout_s=NEVER, clock=FakeClock())
    with pytest.raises(ElasticRestartExceeded,
                       match="injected worker failure"):
        drv.run()
    assert drv.restarts == 1
    assert [h["ok"] for h in drv.history] == [False, False]


def test_heartbeat_files_are_jaxs(tmp_path):
    port = touch_heartbeat(str(tmp_path / "port"), 3)
    jax = jax_elastic.touch_heartbeat(str(tmp_path / "jax"), 3)
    assert os.path.basename(port) == os.path.basename(jax) == "heartbeat-3"
    assert os.path.relpath(port, tmp_path / "port") == \
        os.path.relpath(jax, tmp_path / "jax")
    t0 = os.path.getmtime(port)
    os.utime(port, (t0 - 100, t0 - 100))
    assert touch_heartbeat(str(tmp_path / "port"), 3) == port
    assert os.path.getmtime(port) > t0 - 100


def test_process_member_killed_resumes_bitwise(tmp_path, uninterrupted):
    d, hb = str(tmp_path / "ckpt"), str(tmp_path / "hb")
    os.makedirs(d)
    out = str(tmp_path / "final.pt")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)

    def spawn(wid, resume, attempt):
        return subprocess.Popen(
            [sys.executable, CASES, d, out, str(attempt), resume or "", hb,
             str(wid), "2:1"], env=env)

    drv = ElasticTrainingDriver(1, spawn=spawn, checkpoint_dir=d,
                                heartbeat_dir=hb, heartbeat_timeout_s=120.0,
                                restart=_policy("test_process"))
    assert drv.run() == [None]
    assert drv.restarts == 1
    assert drv.history[0]["dead"] == [0]
    assert "rc=-9" in drv.history[0]["errors"][0]
    assert drv.history[1]["resume"].endswith("ckpt-1")
    assert os.path.exists(os.path.join(hb, "heartbeat-0"))
    _equal(torch.load(out, weights_only=True), uninterrupted)
