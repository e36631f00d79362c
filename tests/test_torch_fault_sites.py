"""The fault plan's evaluation sites and its "nan" action in the port
(analytics_zoo_tpu_torch/resilience/faults.py, orca/learn/spmd.py,
serving/generation/host_tier.py), against the JAX package's on the CPU:

* `eval.step` and `eval.epoch` fire where JAX's do: the per-site hit
  counts of a `fit` with validation and an `evaluate` equal JAX's on the
  DRAM store; on the DEVICE store the `*.epoch` counts do (JAX's epoch
  scan fires no `train.step`, the port's loop does: ROADMAP Known
  differences), and an `eval.step` raise escapes `evaluate` in both;
* "nan" at `train.step` poisons that batch, the step is skipped (the
  sentinel names it, its count is JAX's) and the final parameters equal
  JAX's at f32 1e-5 (the resilience tests' tolerance); the parameters
  after the skipped step are bitwise those before it;
* "nan" (and a raise) at `generation.host_restore` counts a failed
  restore and drops the entry, as JAX's tier does;
* `Fault.describe`, `FaultPlan.snapshot` and `BackgroundCheckpointer.busy`
  equal JAX's."""

import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.observability.registry import (
    MetricsRegistry as JaxRegistry,
)
from analytics_zoo_tpu.orca.learn import checkpoint as jax_ckpt
from analytics_zoo_tpu.orca.learn.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.resilience import (
    BackgroundCheckpointer as JaxCheckpointer,
    FaultPlan as JaxPlan,
    SimulatedWorkerFailure as JaxFailure,
)
from analytics_zoo_tpu.serving.generation.host_tier import (
    HostKVTier as JaxTier,
)
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.orca.learn import checkpoint as port_ckpt
from analytics_zoo_tpu_torch.resilience import (
    BackgroundCheckpointer,
    FaultPlan,
    SimulatedWorkerFailure,
)
from analytics_zoo_tpu_torch.resilience.faults import ACTIONS, KNOWN_SITES
from analytics_zoo_tpu_torch.serving.generation.host_tier import HostKVTier

from _torch_chronos_cases import one_torch_thread  # noqa: F401

F32_TOL = 1e-5
#: a fault that never fires: arms the plan, so every site counts hits
_COUNT_ONLY = {"site": "eval.epoch", "at": 10 ** 6, "action": "raise"}


@pytest.fixture(autouse=True)
def _context():
    saved = (OrcaContext.train_data_store, JaxContext.train_data_store,
             OrcaContext.nonfinite_watchdog)
    yield
    OrcaContext.fault_plan = None
    JaxContext.fault_plan = None
    (OrcaContext.train_data_store, JaxContext.train_data_store,
     OrcaContext.nonfinite_watchdog) = saved


class _JaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x, training: bool = False):
        return fnn.Dense(3, name="fc2")(jnp.tanh(fnn.Dense(8, name="fc1")(x)))


class _MLP(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.fc1, self.fc2 = torch.nn.Linear(4, 8), torch.nn.Linear(8, 3)
        with torch.no_grad():
            for name in ("fc1", "fc2"):
                layer = getattr(self, name)
                layer.weight.copy_(torch.from_numpy(tree[name]["kernel"].T))
                layer.bias.copy_(torch.from_numpy(tree[name]["bias"]))

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


def _tree(seed=2):
    rng = np.random.default_rng(seed)
    return {n: {"kernel": rng.normal(size=s).astype(np.float32),
                "bias": (0.1 * rng.normal(size=s[1])).astype(np.float32)}
            for n, s in (("fc1", (4, 8)), ("fc2", (8, 3)))}


def _data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return {"x": x, "y": ((x[:, 0] > 0) + (x[:, 1] > 0)).astype(np.int32)}


def _estimators():
    tree = _tree()
    init_orca_context(cluster_mode="local")
    jest = JaxEstimator.from_flax(
        _JaxMLP(), loss="sparse_categorical_crossentropy", optimizer="adam",
        learning_rate=1e-2)
    jest.set_params(jax.tree_util.tree_map(jnp.asarray, tree))
    est = Estimator.from_torch(_MLP(tree),
                               loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=1e-2)
    return jest, est


def test_sites_and_actions_are_jaxs():
    from analytics_zoo_tpu.resilience import faults as jax_faults
    assert ACTIONS == jax_faults.ACTIONS
    assert KNOWN_SITES == jax_faults.KNOWN_SITES


@pytest.mark.parametrize("store", ["DRAM", "DEVICE"])
def test_eval_sites_fire_where_jaxs_do(store):
    jest, est = _estimators()
    data, val = _data(), _data(24, seed=1)
    hits = {}
    for name, ctx, e in (("jax", JaxContext, jest), ("port", OrcaContext,
                                                     est)):
        ctx.train_data_store = store
        ctx.fault_plan = {"faults": [_COUNT_ONLY]}
        e.fit(data, epochs=2, batch_size=8, validation_data=val)
        e.evaluate(val, batch_size=8)
        hits[name] = dict(ctx.fault_plan.hits)
        ctx.fault_plan = None
    if store == "DRAM":
        assert hits["port"] == hits["jax"]
        assert hits["port"]["eval.step"] > 0
    else:
        epochs = {k: v for k, v in hits["jax"].items()
                  if k.endswith(".epoch")}
        assert epochs and {k: hits["port"].get(k) for k in epochs} == epochs
    # an eval.step raise escapes evaluate in both
    JaxContext.fault_plan = {"faults": [{"site": "eval.step", "at": 1,
                                         "action": "raise"}]}
    OrcaContext.fault_plan = {"faults": [{"site": "eval.step", "at": 1,
                                          "action": "raise"}]}
    JaxContext.train_data_store = OrcaContext.train_data_store = "DRAM"
    with pytest.raises(JaxFailure):
        jest.evaluate(val, batch_size=8)
    with pytest.raises(SimulatedWorkerFailure):
        est.evaluate(val, batch_size=8)


def test_nan_at_train_step_skips_the_step_as_jax():
    jest, est = _estimators()
    data = _data()
    plan = {"faults": [{"site": "train.step", "at": 3, "action": "nan"}]}
    JaxContext.fault_plan = plan
    jest.fit(data, epochs=2, batch_size=8, shuffle=False)
    OrcaContext.fault_plan = plan
    OrcaContext.nonfinite_watchdog = True
    est.fit(data, epochs=2, batch_size=8, shuffle=False)
    # the poisoned step counts as the epoch's one NaN step in both
    assert [s.get("nan_steps") for s in est.train_summary] == \
        [s.get("nan_steps") for s in jest.train_summary]
    assert est.train_summary[0]["nan_steps"] == 1.0
    want = jax.device_get(jest.get_model())
    for n in ("fc1", "fc2"):
        layer = getattr(est.get_model(), n)
        np.testing.assert_allclose(layer.weight.detach().numpy().T,
                                   np.asarray(want[n]["kernel"]),
                                   atol=F32_TOL, rtol=0)
        np.testing.assert_allclose(layer.bias.detach().numpy(),
                                   np.asarray(want[n]["bias"]),
                                   atol=F32_TOL, rtol=0)


def test_parameters_after_a_nan_step_are_those_before_it():
    _, est = _estimators()
    data = _data()
    est.fit(data, epochs=1, batch_size=8, shuffle=False)   # builds
    before = {}
    OrcaContext.fault_plan = {"faults": [{"site": "train.step", "at": 3,
                                          "action": "nan"}]}
    OrcaContext.nonfinite_watchdog = True
    eng = est.engine
    real = eng.train_step

    def step(batch):
        before[eng.step] = [p.detach().clone() for p in eng.params]
        return real(batch)

    eng.train_step = step
    est.fit(data, epochs=1, batch_size=8, shuffle=False)
    after = [p.detach() for p in eng.params]
    # the plan's 3rd hit is this fit's 3rd step (`before` is keyed by
    # the engine's step count before each step): the 4th step started
    # from the 3rd's starting parameters
    first = min(before)
    for a, b in zip(before[first + 2], before[first + 3]):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b)
                   for a, b in zip(before[first + 1], before[first + 2]))
    assert est.train_summary[-1]["nan_steps"] == 1.0
    assert len(after) == len(before[first])


class _Geometry:
    """The pool geometry `bind_geometry` reads."""

    def __init__(self, kv, block_size):
        self.kv, self.block_size, self.kv_scale = kv, block_size, None


@pytest.mark.parametrize("action", ["nan", "raise"])
def test_failed_host_restore_is_counted_as_jaxs(action):
    L, bs, h, d = 2, 4, 2, 8
    kv = np.random.default_rng(0).normal(size=(L, 2, bs, h, d)).astype(
        np.float32)
    key = tuple(range(bs))
    jreg = JaxRegistry()
    jtier, tier = JaxTier(1 << 20, registry=jreg), HostKVTier(1 << 20)
    jtier.bind_geometry(_Geometry(np.zeros((L, 2, 8, h, d), np.float32), bs))
    tier.bind_geometry(_Geometry(torch.zeros(L, 2, 8, h, d), bs))
    assert jtier.put(key, kv, None) and tier.put(key, torch.from_numpy(kv),
                                                 None)
    plan = {"faults": [{"site": "generation.host_restore", "at": 1,
                        "action": action}]}
    JaxContext.fault_plan, OrcaContext.fault_plan = plan, plan
    assert jtier.fetch(key) is None and tier.fetch(key) is None
    assert tier.n_restore_failed == \
        jreg.counter("kv_host_restore_failed_total").value == 1
    assert len(tier) == len(jtier) == 0
    # the next fetch is an ordinary miss
    assert jtier.fetch(key) is None and tier.fetch(key) is None
    assert tier.n_restore_failed == 1


def test_describe_and_snapshot_equal_jaxs():
    faults = [{"site": "train.step", "at": 2, "action": "raise",
               "times": 2},
              {"site": "eval.epoch", "at": 1, "action": "stall",
               "delay_s": 0.0},
              {"site": "checkpoint.mid_write", "action": "crash",
               "prob": 0.5, "times": 9}]
    jplan, plan = JaxPlan(faults, seed=3), FaultPlan(faults, seed=3)
    assert plan.snapshot() == jplan.snapshot()
    for site in ("train.step",) * 4 + ("eval.epoch",) * 2:
        jf, f = jplan.hit(site, {}), plan.hit(site)
        assert (jf is None) == (f is None)
        if f is not None:
            assert f.describe() == jf.describe()
    assert plan.snapshot() == jplan.snapshot()
    assert plan.snapshot()[0]["fired"] == 2


def test_checkpointer_busy_equals_jaxs(tmp_path, monkeypatch):
    """`busy` is True from a submit until its write is done, in both;
    each writer is held inside its write by an event."""
    for pkg, mod, writer, state in (
            ("jax", jax_ckpt, JaxCheckpointer(registry=JaxRegistry()),
             {"w": np.ones(3, np.float32)}),
            ("port", port_ckpt, BackgroundCheckpointer(),
             {"w": torch.ones(3)})):
        gate, entered = threading.Event(), threading.Event()
        real = mod.write_committed

        def held(*args, _real=real, **kwargs):
            entered.set()
            assert gate.wait(30)
            return _real(*args, **kwargs)

        monkeypatch.setattr(mod, "write_committed", held)
        assert writer.busy() is False, pkg
        writer.submit(str(tmp_path / pkg / "ckpt-1"), state)
        assert entered.wait(30), pkg
        assert writer.busy() is True, pkg
        gate.set()
        writer.drain()
        assert writer.busy() is False, pkg
