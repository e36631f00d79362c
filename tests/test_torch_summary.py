"""Train and validation summaries in the port: the TensorBoard event
writer (analytics_zoo_tpu_torch/utils/summary.py over the copied
`tfrecord.py` framing and `tf_example.py` wire format), the Estimator's
`set_tensorboard`, `val_summary` and its getters, against the JAX
package's, and `fit(profile=True)` / `fit(profiler_dir=...)`.

`val_summary` rows are held to the JAX Estimator's on the same weights
and data at f32 1e-5 (`test_torch_estimator.py`'s tolerance)."""

import json
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu.orca.learn.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.utils import summary as jax_summary
from analytics_zoo_tpu_torch.orca.learn import Estimator, optimizers
from analytics_zoo_tpu_torch.utils import summary, tfrecord

F32_TOL = 1e-5


def test_crc32c_and_record_framing(tmp_path):
    assert tfrecord.crc32c(b"123456789") == 0xE3069283
    path = str(tmp_path / "r.tfrecord")
    with tfrecord.TFRecordWriter(path) as w:
        for rec in (b"", b"a", b"x" * 5000):
            w.write(rec)
    assert list(tfrecord.read_tfrecord_file(path)) == [b"", b"a",
                                                       b"x" * 5000]
    with open(path, "r+b") as f:
        f.seek(13)
        f.write(b"\xff")
    with pytest.raises(IOError, match="crc"):
        list(tfrecord.read_tfrecord_file(path))


def test_event_file_round_trip(tmp_path):
    """Scalars written by the port read back through the port's reader
    and the JAX package's, and a JAX-written file through the port's."""
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    w = summary.SummaryWriter(ours)
    w.add_scalars({"loss": 0.5, "accuracy": 0.25}, step=3)
    w.add_scalar("loss", 0.125, step=-7, wall_time=12.5)
    w.close()
    got = summary.load_scalars(ours)
    assert [(s, v) for s, _, v in got["loss"]] == [(3, 0.5), (-7, 0.125)]
    assert got["loss"][1][1] == 12.5
    assert [(s, v) for s, _, v in got["accuracy"]] == [(3, 0.25)]
    assert jax_summary.load_scalars(ours) == got
    jw = jax_summary.SummaryWriter(theirs)
    jw.add_scalars({"loss": 1.5}, step=9, wall_time=1.0)
    jw.close()
    assert summary.load_scalars(theirs) == jax_summary.load_scalars(theirs)


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


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return {"x": x, "y": ((x[:, 0] > 0) + (x[:, 1] > 0)).astype(np.int32)}


def _estimator():
    return Estimator.from_torch(_MLP(_tree()),
                                loss="sparse_categorical_crossentropy",
                                optimizer="adam", learning_rate=1e-2,
                                metrics=["accuracy"])


def test_validation_summary_matches_the_jax_estimator(tmp_path):
    """Three epochs with validation data of 21 rows (a ragged last
    batch): one row per epoch, the same keys as JAX's, the same values,
    each equal to `evaluate` after its epoch; the getters give (step,
    value) pairs; `set_tensorboard` writes both splits."""
    train, val = _data(40, 0), _data(21, 1)
    init_orca_context(cluster_mode="local")
    jest = JaxEstimator.from_flax(
        _JaxMLP(), loss="sparse_categorical_crossentropy", optimizer="adam",
        learning_rate=1e-2, metrics=["accuracy"])
    jest.set_params(jax.tree_util.tree_map(jnp.asarray, _tree()))
    jest.fit(train, epochs=3, batch_size=8, validation_data=val,
             shuffle=False)
    est = _estimator().set_tensorboard(str(tmp_path), "app")
    evals = []
    for _ in range(3):
        est.fit(train, epochs=1, batch_size=8, validation_data=val,
                shuffle=False)
        evals.append(est.evaluate(val, batch_size=8))
    assert len(est.val_summary) == len(jest.val_summary) == 3
    for got, want, ev in zip(est.val_summary, jest.val_summary, evals):
        assert sorted(got) == sorted(want)
        assert got["epoch"] == want["epoch"] and got["step"] == want["step"]
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(got[k], want[k], atol=F32_TOL,
                                       rtol=0, err_msg=k)
            assert got[k] == ev[k]
    assert est.get_validation_summary("loss") == \
        [(s["step"], s["loss"]) for s in est.val_summary]
    assert [s for s, _ in est.get_train_summary("loss")] == [5, 10, 15]
    for split, rows in (("train", est.train_summary),
                        ("validation", est.val_summary)):
        scalars = summary.load_scalars(str(tmp_path / "app" / split))
        assert [s for s, _, _ in scalars["loss"]] == [5, 10, 15]
        np.testing.assert_allclose([v for _, _, v in scalars["loss"]],
                                   [r["loss"] for r in rows], rtol=1e-6)


def test_profile_fills_profile_stats():
    est = Estimator.from_torch(
        _MLP(_tree()), loss="sparse_categorical_crossentropy",
        optimizer=optimizers.Adam(1e-2, learningrate_schedule=optimizers
                                  .Exponential(2, 0.5, stair_case=True)))
    est.fit(_data(40, 0), epochs=2, batch_size=8, profile=True)
    assert [r["step"] for r in est.profile_stats] == list(range(1, 11))
    assert all(r["step_time_s"] > 0 for r in est.profile_stats)
    assert [r["lr"] for r in est.profile_stats[:5]] == \
        [float(np.float32(v)) for v in (1e-2, 1e-2, 5e-3, 5e-3, 2.5e-3)]
    assert est.engine.last_profile == est.profile_stats[5:]
    est.fit(_data(40, 0), epochs=1, batch_size=8)
    assert len(est.profile_stats) == 10 and est.engine.last_profile == []


def test_profiler_dir_writes_a_trace(tmp_path):
    est = _estimator()
    est.fit(_data(16, 0), epochs=1, batch_size=8,
            profiler_dir=str(tmp_path))
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(traces) == 1 and est.engine.host_step == 2
    with open(tmp_path / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
