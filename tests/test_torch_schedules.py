"""Learning-rate schedules in the port (`Poly`, `Exponential`, `Step`,
`Warmup`, analytics_zoo_tpu_torch/orca/learn/optimizers.py) against the
JAX package's (optax's schedules):

  * each schedule's learning rate at every step count 0 ... max + 5, in
    f32, within 2 ulps of `Schedule.build(lr)` of the JAX package (the
    same f32 formulas; XLA's and PyTorch's cos and pow may round the
    last bit apart);
  * a fit with `Warmup` + `AdamWeightDecay` against the JAX
    `Estimator.from_flax` on a small MLP: per-step losses and the final
    parameters at f32 1e-5 (the same f32 arithmetic in other orders,
    `test_torch_estimator.py`'s tolerance), and the first step, at lr 0,
    leaves the parameters bitwise as they were;
  * a fit with a non-finite batch: the skipped step keeps the schedule's
    count, as optax keeps its state, so the losses and parameters after
    it match JAX's at the same tolerance.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu.orca.learn import optimizers as jax_optimizers
from analytics_zoo_tpu.orca.learn.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.orca.learn import optimizers

F32_TOL = 1e-5
#: the peak rate of the AdamW fits, test_torch_estimator.py's adamw
#: rate: Adam's first steps move every weight by about the rate, so
#: rounding apart grows with it (at 5e-2, eight steps at a constant rate
#: already part by 9.2e-6 of the 1e-5 gate)
LR = 1e-2

# (name, constructor arguments, the last step the schedule moves at)
_SCHEDULES = {
    "poly-half": ("Poly", (0.5, 20), 20),
    "poly-two": ("Poly", (2.0, 15), 15),
    "exponential": ("Exponential", (5, 0.9), 30),
    "exponential-staircase": ("Exponential", (4, 0.7, True), 30),
    "step": ("Step", (3, 0.5), 20),
    "warmup": ("Warmup", (5, 20), 20),
    "warmup-end-value": ("Warmup", (3, 12, 1e-4), 12),
}


@pytest.mark.parametrize("case", list(_SCHEDULES))
def test_schedule_values_match_optax(case):
    name, args, last = _SCHEDULES[case]
    base_lr = 2e-3
    want_fn = getattr(jax_optimizers, name)(*args).build(base_lr)
    got_fn = getattr(optimizers, name)(*args).build(base_lr)
    counts = np.arange(last + 6)
    want = np.asarray([want_fn(jnp.asarray(c, jnp.int32)) for c in counts],
                      np.float32)
    got = np.asarray([got_fn(torch.tensor(float(c))).item()
                      for c in counts], np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    assert len(set(want.tolist())) > 3        # the schedule moves


def test_lr_schedule_state_skips_with_the_step():
    """The device state alone: lr is read at the count before the
    increment, and a step that is not taken keeps the count."""
    sched = optimizers.LRSchedule(optimizers.Warmup(2, 6).build(1.0),
                                  "cpu")
    seen = []
    for taken in (1.0, 0.0, 1.0, 1.0):
        sched.before_step()
        seen.append(float(sched.lr))
        sched.after_step(torch.tensor(taken))
    assert seen == [0.0, 0.5, 0.5, 1.0]
    assert float(sched.count) == 3.0


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

    def tree(self):
        return {n: {"kernel": getattr(self, n).weight.detach().numpy().T,
                    "bias": getattr(self, n).bias.detach().numpy()}
                for n in ("fc1", "fc2")}


def _tree(seed=2):
    rng = np.random.default_rng(seed)
    return {n: {"kernel": rng.normal(size=s).astype(np.float32),
                "bias": (0.1 * rng.normal(size=s[1])).astype(np.float32)}
            for n, s in (("fc1", (4, 8)), ("fc2", (8, 3)))}


def _data(n=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return x, (x[:, 0] > 0).astype(np.int32) + (x[:, 1] > 0)


def _fit_both(x, y, epochs, batch):
    tree = _tree()
    init_orca_context(cluster_mode="local")
    jest = JaxEstimator.from_flax(
        _JaxMLP(), loss="sparse_categorical_crossentropy",
        optimizer=jax_optimizers.AdamWeightDecay(
            LR, learningrate_schedule=jax_optimizers.Warmup(3, 10)))
    jest.set_params(jax.tree_util.tree_map(jnp.asarray, tree))
    jest.fit({"x": x, "y": y}, epochs=epochs, batch_size=batch,
             shuffle=False)
    est = Estimator.from_torch(
        _MLP(tree), loss="sparse_categorical_crossentropy",
        optimizer=optimizers.AdamWeightDecay(
            LR, learningrate_schedule=optimizers.Warmup(3, 10)))
    return tree, jest, est


def _assert_params(est, jest):
    got, want = est.get_model().tree(), jax.device_get(jest.get_model())
    for n in ("fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[n][leaf],
                                       np.asarray(want[n][leaf]),
                                       atol=F32_TOL, rtol=0,
                                       err_msg=f"{n}.{leaf}")


def test_warmup_fit_matches_the_jax_estimator():
    """Eight epochs of one step each (so each epoch's loss is a step's):
    the first step at lr 0 moves nothing, the rest follow optax."""
    x, y = _data()
    tree, jest, est = _fit_both(x, y, 8, 24)
    est.fit({"x": x, "y": y}, epochs=1, batch_size=24, shuffle=False)
    for n, leaves in est.get_model().tree().items():
        for leaf, v in leaves.items():
            assert np.array_equal(v, tree[n][leaf]), f"{n}.{leaf}"
    est.fit({"x": x, "y": y}, epochs=7, batch_size=24, shuffle=False)
    np.testing.assert_allclose([s["loss"] for s in est.train_summary],
                               [s["loss"] for s in jest.train_summary],
                               atol=F32_TOL, rtol=0)
    _assert_params(est, jest)
    assert float(est.engine.schedule.count) == 8.0
    moved = max(np.abs(est.get_model().tree()[n][leaf] - tree[n][leaf]).max()
                for n in tree for leaf in tree[n])
    assert moved > 1e-3


def test_skipped_step_keeps_the_schedule_count():
    """Three batches an epoch, the second non-finite, two epochs: four
    steps taken, two skipped; the count stands at 4 and every loss and
    parameter follows JAX, which keeps optax's count on the skip."""
    x, y = _data()
    x[8:16] = np.nan
    _, jest, est = _fit_both(x, y, 2, 8)
    est.fit({"x": x, "y": y}, epochs=2, batch_size=8, shuffle=False)
    assert [s["nan_steps"] for s in est.train_summary] == \
        [s["nan_steps"] for s in jest.train_summary] == [1.0, 1.0]
    assert float(est.engine.schedule.count) == 4.0
    assert est.engine.step == 6
    np.testing.assert_allclose([s["loss"] for s in est.train_summary],
                               [s["loss"] for s in jest.train_summary],
                               atol=F32_TOL, rtol=0)
    _assert_params(est, jest)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_schedules_drive_sgd_and_adam(name):
    """`Step` on SGD with momentum and `Poly` on Adam against the JAX
    Estimator: two epochs of three steps, losses and final parameters
    at f32 1e-5."""
    x, y = _data()
    tree = _tree()
    if name == "sgd":
        mk = lambda mod: mod.SGD(0.2, momentum=0.9,  # noqa: E731
                                 learningrate_schedule=mod.Step(2, 0.5))
    else:
        mk = lambda mod: mod.Adam(5e-2,  # noqa: E731
                                  learningrate_schedule=mod.Poly(2.0, 5))
    init_orca_context(cluster_mode="local")
    jest = JaxEstimator.from_flax(_JaxMLP(),
                                  loss="sparse_categorical_crossentropy",
                                  optimizer=mk(jax_optimizers))
    jest.set_params(jax.tree_util.tree_map(jnp.asarray, tree))
    jest.fit({"x": x, "y": y}, epochs=2, batch_size=8, shuffle=False)
    est = Estimator.from_torch(_MLP(tree),
                               loss="sparse_categorical_crossentropy",
                               optimizer=mk(optimizers))
    est.fit({"x": x, "y": y}, epochs=2, batch_size=8, shuffle=False)
    np.testing.assert_allclose([s["loss"] for s in est.train_summary],
                               [s["loss"] for s in jest.train_summary],
                               atol=F32_TOL, rtol=0)
    _assert_params(est, jest)
