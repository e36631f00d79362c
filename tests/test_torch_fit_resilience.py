"""`Estimator.fit`'s retry loop in the port (analytics_zoo_tpu_torch/
orca/learn/estimator.py), held to the JAX `fit` (estimator.py:211-433):

  * a fault at `train.step` in epoch 2 under the default `EveryEpoch`
    trigger: one retry, and the final parameters bitwise those of an
    uninterrupted fit, dropout on, on the DRAM and the DEVICE stores
    (the checkpoint carries the optimizer, the schedule's count and the
    dropout generator's state);
  * the same fault plans on the port and on the JAX Estimator (f32, no
    dropout, a small MLP, shuffled): the same retries, epoch cursor and
    steps, and final parameters at f32 1e-5 (`test_torch_estimator.py`'s
    tolerance), for a fault in epoch 2, a fault before any checkpoint
    exists, and a fault after a mid-epoch `SeveralIteration` checkpoint,
    whose restore re-runs the whole epoch from that state, as JAX does;
  * an exhausted budget raises; `NaNLossError` is never retried; without
    `model_dir` the failure is raised.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.orca.learn import SeveralIteration as JaxSeveral
from analytics_zoo_tpu.orca.learn.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.convert import bert_from_flax, init_bert_params
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from analytics_zoo_tpu_torch.orca.learn import (
    Estimator,
    NaNLossError,
    SeveralIteration,
)
from analytics_zoo_tpu_torch.resilience import SimulatedWorkerFailure
# one torch thread: the bitwise resume gate then compares two fits whose
# CPU reductions cannot split differently between them, whatever the
# other workers of the run are doing
from _torch_chronos_cases import one_torch_thread  # noqa: F401

F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _context():
    saved = (OrcaContext.failure_retry_interval_s,
             OrcaContext.train_data_store,
             JaxContext.failure_retry_interval_s)
    OrcaContext.failure_retry_interval_s = 0.0
    JaxContext.failure_retry_interval_s = 0.0
    yield
    OrcaContext.fault_plan = None
    JaxContext.fault_plan = None
    (OrcaContext.failure_retry_interval_s, OrcaContext.train_data_store,
     JaxContext.failure_retry_interval_s) = saved


def _raise_at(hit, times=1):
    return {"faults": [{"site": "train.step", "at": hit, "action": "raise",
                        "times": times}]}


# ------------------------------------------- resume is bitwise, dropout on

CFG = dict(vocab=100, hidden_size=32, n_head=2, n_block=2,
           intermediate_size=64, max_position_len=32)


def _bert_data(n=40, t=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab"], (n, t)).astype(np.int32)
    seg = (np.arange(t)[None] >= t // 2).astype(np.int32).repeat(n, 0)
    lens = rng.integers(t // 2, t + 1, n)
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    return {"x": [ids, seg, mask],
            "y": (ids[:, 0] < CFG["vocab"] // 2).astype(np.int32)}


def _bert_fit(model_dir, plan=None):
    cfg = dict(CFG, num_classes=2)
    model = BERTClassifier(**CFG, attn_impl="flash", device="cpu")
    model.load_state_dict(bert_from_flax(init_bert_params(cfg, seed=4), cfg))
    est = Estimator.from_torch(model, optimizer="adamw", learning_rate=1e-3,
                               model_dir=model_dir, seed=3)
    OrcaContext.fault_plan = plan
    est.fit(_bert_data(), epochs=2, batch_size=8, shuffle=True)
    OrcaContext.fault_plan = None
    return est


@pytest.mark.parametrize("store", ["DRAM", "DEVICE"])
def test_fault_in_epoch_two_resumes_bitwise(tmp_path, store):
    """Five steps an epoch; the fault kills step 3 of epoch 2 (hit 8).
    The retry restores ckpt-5 (epoch 1's end) and re-runs epoch 2."""
    OrcaContext.train_data_store = store
    ref = _bert_fit(None)
    est = _bert_fit(str(tmp_path), _raise_at(8))
    assert est.retries == 1 and est.epoch == 2
    assert est.engine.host_step == est.engine.step == 10
    assert [s["loss"] for s in est.train_summary[-1:]] == \
        [s["loss"] for s in ref.train_summary[-1:]]
    for (name, a), b in zip(est.get_model().named_parameters(),
                            ref.get_model().parameters()):
        assert torch.equal(a, b), name
    assert torch.equal(est.engine.generator.get_state(),
                       ref.engine.generator.get_state())


# ------------------------------------------------ against the JAX Estimator

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


def _mlp_data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return {"x": x, "y": ((x[:, 0] > 0) + (x[:, 1] > 0)).astype(np.int32)}


# scenario: (port trigger, JAX trigger, hit of train.step that raises)
_SCENARIOS = {
    "epoch-2-every-epoch": (None, None, 8),
    "before-any-checkpoint": (None, None, 3),
    "after-a-mid-epoch-checkpoint": (SeveralIteration(3),
                                     JaxSeveral(3), 9),
}


@pytest.mark.parametrize("case", list(_SCENARIOS))
def test_fault_plan_matches_the_jax_estimator(tmp_path, case):
    """Two epochs of five steps (batch 8 of 40 rows, shuffled), Adam
    1e-2.  In the last scenario ckpt-6 (step 1 of epoch 2) is the newest
    when step 4 of epoch 2 (hit 9) fails: its sidecar says one epoch
    done, so epoch 2 re-runs whole from step 6's state, and the fit ends
    at step 11, not 10."""
    trigger, jtrigger, hit = _SCENARIOS[case]
    tree, data = _tree(), _mlp_data()
    init_orca_context(cluster_mode="local")
    jest = JaxEstimator.from_flax(
        _JaxMLP(), loss="sparse_categorical_crossentropy", optimizer="adam",
        learning_rate=1e-2, model_dir=str(tmp_path / "jax"))
    jest.set_params(jax.tree_util.tree_map(jnp.asarray, tree))
    JaxContext.fault_plan = _raise_at(hit)
    jest.fit(data, epochs=2, batch_size=8, shuffle=True,
             checkpoint_trigger=jtrigger)
    JaxContext.fault_plan = None
    est = Estimator.from_torch(
        _MLP(tree), loss="sparse_categorical_crossentropy",
        optimizer="adam", learning_rate=1e-2,
        model_dir=str(tmp_path / "port"))
    OrcaContext.fault_plan = _raise_at(hit)
    est.fit(data, epochs=2, batch_size=8, shuffle=True,
            checkpoint_trigger=trigger)
    OrcaContext.fault_plan = None
    assert est.retries == jest.retries == 1
    assert est.epoch == jest.epoch == 2
    assert est.engine.host_step == jest._engine.host_step
    if case == "after-a-mid-epoch-checkpoint":
        assert est.engine.host_step == 11
    np.testing.assert_allclose([s["loss"] for s in est.train_summary],
                               [s["loss"] for s in jest.train_summary],
                               atol=F32_TOL, rtol=0)
    want = jax.device_get(jest.get_model())
    for n in ("fc1", "fc2"):
        layer = getattr(est.get_model(), n)
        np.testing.assert_allclose(layer.weight.detach().numpy().T,
                                   np.asarray(want[n]["kernel"]),
                                   atol=F32_TOL, rtol=0)
        np.testing.assert_allclose(layer.bias.detach().numpy(),
                                   np.asarray(want[n]["bias"]),
                                   atol=F32_TOL, rtol=0)


def _mlp_estimator(model_dir=None):
    return Estimator.from_torch(_MLP(_tree()),
                                loss="sparse_categorical_crossentropy",
                                optimizer="adam", learning_rate=1e-2,
                                model_dir=model_dir)


def test_exhausted_budget_raises(tmp_path):
    est = _mlp_estimator(str(tmp_path))
    OrcaContext.fault_plan = _raise_at(3, times=3)
    with pytest.raises(SimulatedWorkerFailure):
        est.fit(_mlp_data(), epochs=2, batch_size=8, max_failures=2)
    assert est.retries == 2


def test_nan_loss_error_is_not_retried(tmp_path):
    data = _mlp_data()
    data["x"][8:16] = np.nan
    est = _mlp_estimator(str(tmp_path))
    with pytest.raises(NaNLossError, match="1 training step"):
        est.fit(data, epochs=2, batch_size=8, shuffle=False,
                nan_policy="raise")
    assert est.retries == 0
    # a NaN epoch is a failed one: no checkpoint was written for it
    assert not [n for n in tmp_path.iterdir()]


def test_without_model_dir_the_failure_is_raised():
    est = _mlp_estimator()
    OrcaContext.fault_plan = _raise_at(3)
    with pytest.raises(SimulatedWorkerFailure):
        est.fit(_mlp_data(), epochs=2, batch_size=8)
    assert est.retries == 0


def test_retry_policy_matches_the_jax_policy():
    """The copied `RetryPolicy`: the same backoff schedules (plain and
    seeded full jitter) and the same retry decisions as the JAX one."""
    from analytics_zoo_tpu.resilience.retry import RetryPolicy as JaxPolicy
    from analytics_zoo_tpu_torch.resilience import RetryPolicy
    for kw in (dict(max_attempts=6, backoff_s=0.5, max_backoff_s=3.0),
               dict(max_attempts=5, backoff_s=0.2, jitter="full", seed=7)):
        ours, theirs = RetryPolicy(**kw), JaxPolicy(**kw)
        assert ours.delays() == theirs.delays()
        assert [ours.spread(2.0, a) for a in range(1, 4)] == \
            [theirs.spread(2.0, a) for a in range(1, 4)]
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"

    policy = RetryPolicy(max_attempts=3, backoff_s=0.1)
    assert policy.run(flaky, retryable=(OSError,),
                      sleep=slept.append) == "done"
    assert slept == [0.1, 0.2]
    with pytest.raises(ValueError):
        policy.run(lambda: (_ for _ in ()).throw(ValueError("no")),
                   retryable=(OSError,), sleep=slept.append)
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)


def test_fault_plan_validates_and_fires_deterministically():
    from analytics_zoo_tpu_torch.resilience import FaultPlan
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan([{"site": "train.batch", "action": "raise"}])
    with pytest.raises(ValueError, match="unknown fault action"):
        FaultPlan([{"site": "train.step", "action": "explode"}])
    plan = FaultPlan([{"site": "train.step", "at": 2, "action": "raise",
                       "times": 2}])
    fired = [plan.hit("train.step") is not None for _ in range(5)]
    assert fired == [False, True, True, False, False]
    seeded = [FaultPlan([{"site": "train.epoch", "action": "crash",
                          "prob": 0.5, "times": 99}], seed=3)
              for _ in range(2)]
    draws = [[p.hit("train.epoch") is not None for _ in range(20)]
             for p in seeded]
    assert draws[0] == draws[1] and 0 < sum(draws[0]) < 20
