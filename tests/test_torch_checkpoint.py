"""The port's checkpoint commit protocol (analytics_zoo_tpu_torch/orca/
learn/checkpoint.py), held to the JAX package's crash matrix
(tests/test_checkpoint_crash.py) over the same sites, and the
Estimator's checkpoint surface (`save` / `load`, `save_checkpoint`,
`load_orca_checkpoint(version=)`, `resume_latest`, `SeveralIteration`
naming), as the JAX tests of tests/test_estimator.py hold it.

A kill at every phase of write -> rename -> commit marker leaves the
previous committed version the latest, loaded bit for bit; a marker
without its directory is not committed; a crashed writer's temp dir is
invisible and swept by the next save; a failed background write raises
on drain.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.orca.learn import (
    Estimator,
    SeveralIteration,
    optimizers,
)
from analytics_zoo_tpu_torch.orca.learn.checkpoint import (
    COMMIT_SUFFIX,
    async_save_enabled,
    find_latest_checkpoint,
    has_commit_marker,
    load_checkpoint,
    save_checkpoint,
    write_committed,
)
from analytics_zoo_tpu_torch.resilience import (
    BackgroundCheckpointer,
    CheckpointWriteError,
    SimulatedCrash,
)

#: the JAX matrix's sites and actions (test_checkpoint_crash.py)
CRASH_SITES = [
    ("checkpoint.before_write", "crash"),
    ("checkpoint.mid_write", "torn_write"),
    ("checkpoint.before_rename", "crash"),
    ("checkpoint.before_commit", "crash"),
]


def _state(scale=1.0):
    r = np.random.default_rng(11)
    return {"w": torch.from_numpy((scale * r.normal(size=(6, 4)))
                                  .astype(np.float32)),
            "nested": {"step": torch.tensor(scale * 7, dtype=torch.float32),
                       "gen": torch.arange(8, dtype=torch.uint8)},
            "count": int(scale * 3)}


def _equal(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


@pytest.fixture(autouse=True)
def _clean_context():
    OrcaContext.fault_plan = None
    yield
    OrcaContext.fault_plan = None


@pytest.mark.parametrize("site,action", CRASH_SITES,
                         ids=[s for s, _ in CRASH_SITES])
def test_kill_at_every_phase_preserves_latest_committed(
        tmp_path, site, action):
    d = str(tmp_path)
    baseline = _state()
    p0 = save_checkpoint(os.path.join(d, "ckpt-0"), baseline)
    assert has_commit_marker(p0)
    OrcaContext.fault_plan = {"faults": [{"site": site, "action": action}]}
    with pytest.raises(SimulatedCrash):
        save_checkpoint(os.path.join(d, "ckpt-1"), _state(scale=2.0))
    OrcaContext.fault_plan = None
    latest = find_latest_checkpoint(d)
    assert latest == p0, (latest, sorted(os.listdir(d)))
    assert _equal(load_checkpoint(latest), baseline)


def test_crash_after_commit_loses_nothing(tmp_path):
    d = str(tmp_path)
    save_checkpoint(os.path.join(d, "ckpt-0"), _state())
    newer = _state(scale=3.0)
    OrcaContext.fault_plan = {"faults": [
        {"site": "checkpoint.after_commit", "action": "crash"}]}
    with pytest.raises(SimulatedCrash):
        save_checkpoint(os.path.join(d, "ckpt-1"), newer)
    OrcaContext.fault_plan = None
    latest = find_latest_checkpoint(d)
    assert latest.endswith("ckpt-1")
    assert _equal(load_checkpoint(latest), newer)


def test_meta_rides_the_commit_and_torn_dirs_are_skipped(tmp_path):
    d = str(tmp_path)
    save_checkpoint(os.path.join(d, "ckpt-0"), _state(),
                    meta={"epoch": 4, "step": 40})
    OrcaContext.fault_plan = {"faults": [
        {"site": "checkpoint.before_commit", "action": "crash"}]}
    with pytest.raises(SimulatedCrash):
        save_checkpoint(os.path.join(d, "ckpt-1"), _state())
    OrcaContext.fault_plan = None
    assert os.path.isdir(os.path.join(d, "ckpt-1"))       # marker-less
    assert find_latest_checkpoint(d).endswith("ckpt-0")
    with open(os.path.join(d, "ckpt-0.meta.json")) as f:
        assert json.load(f)["epoch"] == 4
    with open(os.path.join(d, "ckpt-0" + COMMIT_SUFFIX)) as f:
        assert json.load(f)["meta"] == {"epoch": 4, "step": 40}


def test_marker_without_directory_is_not_committed(tmp_path):
    d = str(tmp_path)
    p0 = save_checkpoint(os.path.join(d, "ckpt-0"), _state())
    save_checkpoint(os.path.join(d, "ckpt-1"), _state())
    shutil.rmtree(os.path.join(d, "ckpt-1"))
    assert os.path.exists(os.path.join(d, "ckpt-1" + COMMIT_SUFFIX))
    assert not has_commit_marker(os.path.join(d, "ckpt-1"))
    assert find_latest_checkpoint(d) == p0


def test_stale_temp_swept_and_invisible(tmp_path):
    d = str(tmp_path)
    OrcaContext.fault_plan = {"faults": [
        {"site": "checkpoint.before_rename", "action": "crash"}]}
    with pytest.raises(SimulatedCrash):
        write_committed(os.path.join(d, "ckpt-0"), _state())
    OrcaContext.fault_plan = None
    assert [n for n in os.listdir(d) if n.startswith(".tmp-")]
    with pytest.raises(FileNotFoundError):
        find_latest_checkpoint(d)
    write_committed(os.path.join(d, "ckpt-0"), _state())
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]
    assert find_latest_checkpoint(d).endswith("ckpt-0")


def test_background_writer_failure_surfaces_on_drain(tmp_path):
    """The writer snapshots on submit (a later in-place change does not
    reach the file), a fault inside the write raises on drain once, and
    the same writer commits the next save."""
    d = str(tmp_path)
    save_checkpoint(os.path.join(d, "ckpt-0"), _state())
    writer = BackgroundCheckpointer()
    OrcaContext.fault_plan = {"faults": [
        {"site": "checkpoint.before_commit", "action": "crash"}]}
    writer.submit(os.path.join(d, "ckpt-1"), _state(scale=2.0))
    with pytest.raises(CheckpointWriteError, match="injected crash"):
        writer.drain()
    writer.drain()                       # raised once
    OrcaContext.fault_plan = None
    assert find_latest_checkpoint(d).endswith("ckpt-0")
    state = _state(scale=3.0)
    want = _state(scale=3.0)
    writer.submit(os.path.join(d, "ckpt-2"), state)
    state["w"].add_(1.0)                 # after the snapshot
    writer.drain()
    assert writer.last_snapshot_s is not None and writer.last_write_s
    assert find_latest_checkpoint(d).endswith("ckpt-2")
    assert _equal(load_checkpoint(os.path.join(d, "ckpt-2")), want)
    writer.close()


def test_async_gate(monkeypatch):
    monkeypatch.delenv("ZOO_ASYNC_CHECKPOINT", raising=False)
    assert not async_save_enabled("cpu")
    assert async_save_enabled("cuda")
    monkeypatch.setenv("ZOO_ASYNC_CHECKPOINT", "0")
    assert not async_save_enabled("cuda")
    monkeypatch.setenv("ZOO_ASYNC_CHECKPOINT", "1")
    assert async_save_enabled("cpu")


@pytest.mark.parametrize("env", ["0", "1"], ids=["sync", "background"])
def test_save_checkpoint_paths_load_the_same(tmp_path, monkeypatch, env):
    monkeypatch.setenv("ZOO_ASYNC_CHECKPOINT", env)
    p = save_checkpoint(os.path.join(str(tmp_path), "ckpt-3"), _state(),
                        meta={"epoch": 1})
    assert find_latest_checkpoint(str(tmp_path)) == p   # drains first
    assert _equal(load_checkpoint(p), _state())


# ------------------------------------------------ the Estimator's surface

def _data(n=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return {"x": x, "y": ((x[:, 0] > 0) + (x[:, 1] > 0)).astype(np.int32)}


def _estimator(model_dir=None):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 3))
    return Estimator.from_torch(
        model, loss="sparse_categorical_crossentropy",
        optimizer=optimizers.AdamWeightDecay(
            1e-2, learningrate_schedule=optimizers.Warmup(2, 30)),
        metrics=["accuracy"], model_dir=model_dir)


def _params(est):
    return [p.detach().clone() for p in est.get_model().parameters()]


def test_estimator_save_load_round_trip(tmp_path):
    """A fresh Estimator loading a saved one evaluates identically, and
    its next epoch matches the saved one's bit for bit: the optimizer's
    moments and step, the schedule's count and the step are restored."""
    data = _data()
    est = _estimator()
    est.fit(data, epochs=2, batch_size=8)
    path = est.save(os.path.join(str(tmp_path), "saved"))
    before = est.evaluate(data, batch_size=8)
    fresh = _estimator().load(path)
    assert fresh.evaluate(data, batch_size=8) == before
    assert fresh.engine.step == est.engine.step == 12
    assert float(fresh.engine.schedule.count) == 12.0
    est.fit(data, epochs=1, batch_size=8, shuffle=False)
    fresh.fit(data, epochs=1, batch_size=8, shuffle=False)
    for a, b in zip(_params(est), _params(fresh)):
        assert torch.equal(a, b)


def test_load_orca_checkpoint_version(tmp_path):
    d = str(tmp_path)
    est = _estimator(d)
    est.fit(_data(), epochs=1, batch_size=8)
    first = _params(est)
    est.fit(_data(), epochs=1, batch_size=8)
    assert sorted(n for n in os.listdir(d) if n.startswith("ckpt-")
                  and "." not in n) == ["ckpt-12", "ckpt-6"]
    fresh = _estimator().load_orca_checkpoint(d, version=6)
    for a, b in zip(_params(fresh), first):
        assert torch.equal(a, b)
    latest = _estimator().load_orca_checkpoint(d)
    for a, b in zip(_params(latest), _params(est)):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        _estimator().load_orca_checkpoint(d, version=7)


def test_resume_latest_restores_the_epoch_cursor(tmp_path):
    d = str(tmp_path)
    assert _estimator(d).resume_latest() is None     # nothing yet
    est = _estimator(d)
    est.fit(_data(), epochs=3, batch_size=8)
    fresh = _estimator(d)
    assert fresh.resume_latest().endswith("ckpt-18")
    assert fresh.epoch == 3 and fresh.engine.host_step == 18
    for a, b in zip(_params(fresh), _params(est)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="model_dir"):
        _estimator().resume_latest()


def test_several_iteration_checkpoints_mid_epoch(tmp_path):
    """Step-granular triggers fire inside the epoch and name each
    checkpoint by the loop-local step (host_step commits at the epoch's
    end), as JAX test_estimator.py's test does; each sidecar carries
    the epochs completed at save time."""
    d = str(tmp_path)
    est = _estimator(d)
    est.fit(_data(n=128), epochs=2, batch_size=16,
            checkpoint_trigger=SeveralIteration(3))
    ckpts = sorted((int(n.split("-")[1]) for n in os.listdir(d)
                    if n.startswith("ckpt-") and "." not in n))
    assert ckpts == [3, 6, 9, 12, 15]
    with open(os.path.join(d, "ckpt-6.meta.json")) as f:
        assert json.load(f) == {"epoch": 0, "step": 6}
    with open(os.path.join(d, "ckpt-9.meta.json")) as f:
        assert json.load(f) == {"epoch": 1, "step": 9}


def test_learning_rate_is_the_engines_own_after_a_load(tmp_path):
    """The optimizer's state comes from the checkpoint, its learning
    rate from the Estimator's configuration (JAX's optimizer state holds
    none): a scheduled checkpoint loads into a constant-rate Estimator,
    which keeps its float rate, and back into a scheduled one, which
    keeps reading its schedule's tensor."""
    data = _data()
    sched = _estimator()
    sched.fit(data, epochs=1, batch_size=8)
    path = sched.save(os.path.join(str(tmp_path), "s"))
    const = Estimator.from_torch(
        sched.get_model(), loss="sparse_categorical_crossentropy",
        optimizer="adamw", learning_rate=1e-3).load(path)
    assert all(g["lr"] == 1e-3 for g in const.engine.opt.param_groups)
    const.fit(data, epochs=1, batch_size=8)
    back = _estimator().load(const.save(os.path.join(str(tmp_path), "c")))
    assert all(g["lr"] is back.engine.schedule.lr
               for g in back.engine.opt.param_groups)
    assert float(back.engine.schedule.count) == 0.0   # const had none
    back.fit(data, epochs=1, batch_size=8)
    assert float(back.engine.schedule.count) == 6.0


def test_background_submits_from_many_threads_all_commit(tmp_path):
    """Eight threads (more than this machine's cores) submit 5 saves
    each through one writer, with a short switch interval: every save
    commits with its own content, none is dropped by a race between a
    drain and the next enqueue."""
    import sys
    import threading
    writer = BackgroundCheckpointer()
    d = str(tmp_path)
    errors = []

    def work(t):
        try:
            for i in range(5):
                writer.submit(os.path.join(d, f"ckpt-{t * 10 + i}"),
                              {"w": torch.full((64,), float(t * 10 + i))})
        except BaseException as e:     # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    writer.drain()
    writer.close()
    assert not errors
    for t in range(8):
        for i in range(5):
            path = os.path.join(d, f"ckpt-{t * 10 + i}")
            assert has_commit_marker(path), path
            assert torch.equal(load_checkpoint(path)["w"],
                               torch.full((64,), float(t * 10 + i)))


_TRIGGERS = {"max-iteration-4": ("MaxIteration", 4),
             "min-loss-above": ("MinLoss", 10.0),
             "min-loss-below": ("MinLoss", 0.0),
             "several-iteration-2": ("SeveralIteration", 2)}


@pytest.mark.parametrize("case", list(_TRIGGERS))
def test_triggers_write_the_checkpoints_jax_writes(tmp_path, case):
    """The copied triggers fire where the JAX Estimator's do, quirks
    included: `MinLoss` reads the last epoch's loss, so once it is under
    the bound it fires at every later step as well as at epoch ends.
    Two epochs of three steps; the checkpoint names must match."""
    import flax.linen as fnn
    import jax.numpy as jnp

    from analytics_zoo_tpu import init_orca_context
    from analytics_zoo_tpu.orca.learn import trigger as jax_trigger
    from analytics_zoo_tpu.orca.learn.estimator import (
        Estimator as JaxEstimator,
    )
    from analytics_zoo_tpu_torch.orca.learn import trigger

    class _JaxMLP(fnn.Module):
        @fnn.compact
        def __call__(self, x, training: bool = False):
            return fnn.Dense(3, name="fc2")(
                jnp.tanh(fnn.Dense(16, name="fc1")(x)))

    name, arg = _TRIGGERS[case]
    data = _data(n=24)

    def written(d):
        return sorted(int(n.split("-")[1]) for n in os.listdir(d)
                      if n.startswith("ckpt-") and "." not in n)

    init_orca_context(cluster_mode="local")
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jest = JaxEstimator.from_flax(_JaxMLP(),
                                  loss="sparse_categorical_crossentropy",
                                  optimizer="adam", learning_rate=1e-2,
                                  model_dir=str(jd))
    jest.fit(data, epochs=2, batch_size=8,
             checkpoint_trigger=getattr(jax_trigger, name)(arg))
    est = _estimator(str(pd))
    est.fit(data, epochs=2, batch_size=8,
            checkpoint_trigger=getattr(trigger, name)(arg))
    want = written(jd) if jd.exists() else []
    got = written(pd) if pd.exists() else []
    assert got == want
    if case == "min-loss-below":
        assert got == []
    with pytest.raises(TypeError, match="not a Trigger"):
        trigger.Trigger.resolve("EveryEpoch")
