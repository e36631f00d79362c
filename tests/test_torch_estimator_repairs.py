"""Two repairs of the port's `Estimator.from_torch`, each held against
the JAX `Estimator.from_torch` on the same torch module and numpy data.

1. A skipped (non-finite) step leaves the module's buffers as they were:
   `nn.Sequential(nn.Linear(4, 3), nn.BatchNorm1d(3))`, SGD 0.1, batch
   8, no shuffle, 16 rows of which the last 8 are NaN (a batch of 8, so
   that the JAX step on the tests' 8 CPU devices pads no row into the
   BatchNorm statistics).  Both packages
   skip step 2; BatchNorm's running mean and variance, its count
   (`num_batches_tracked` against JAX's `batch_stats` `_count`), the
   reported loss and `predict` afterwards agree, on the DRAM and the
   DEVICE store.  The same holds when the BatchNorm runs under
   `torch.utils.checkpoint` (the remat path: its recomputed forward
   updates the buffers again).
2. The eight torch criteria JAX maps (CrossEntropyLoss, MSELoss,
   L1Loss, BCEWithLogitsLoss, SmoothL1Loss with its beta, HuberLoss
   with its delta, NLLLoss, BCELoss) give JAX's loss at learning rate 0
   and JAX's predictions after one step at 1e-2; every refused
   configuration raises JAX's ValueError, with the same message.

Tolerance: 1e-5 absolute throughout, the same f32 arithmetic in other
orders on the two sides."""

import copy
import re

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.utils import checkpoint as torch_checkpoint

import jax

from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.orca.learn.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.orca.learn.torch_adapter import (
    resolve_torch_loss,
)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _stores():
    init_orca_context(cluster_mode="local")
    prev = OrcaContext.train_data_store, JaxContext.train_data_store
    yield
    OrcaContext.train_data_store, JaxContext.train_data_store = prev


def _bn_model():
    torch.manual_seed(0)
    return nn.Sequential(nn.Linear(4, 3), nn.BatchNorm1d(3))


def _nan_rows():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    x[8:] = np.nan
    y = rng.integers(0, 3, 16).astype(np.int32)
    return x, y


def _fit_both(model, store):
    x, y = _nan_rows()
    OrcaContext.train_data_store = store
    JaxContext.train_data_store = store
    je = JaxEstimator.from_torch(copy.deepcopy(model),
                                 loss="sparse_categorical_crossentropy",
                                 optimizer="sgd", learning_rate=0.1)
    je.fit({"x": x, "y": y}, epochs=1, batch_size=8, shuffle=False)
    pe = Estimator.from_torch(model, loss="sparse_categorical_crossentropy",
                              optimizer="sgd", learning_rate=0.1)
    pe.fit({"x": x, "y": y}, epochs=1, batch_size=8, shuffle=False)
    return je, pe, x


@pytest.mark.parametrize("store", ["DRAM", "DEVICE"])
def test_skipped_step_keeps_batchnorm_buffers(store):
    model = _bn_model()
    je, pe, x = _fit_both(model, store)
    assert je.train_summary[-1]["nan_steps"] == 1.0
    assert pe.train_summary[-1]["nan_steps"] == 1.0
    np.testing.assert_allclose(pe.train_summary[-1]["loss"],
                               je.train_summary[-1]["loss"], atol=TOL)
    stats = jax.tree_util.tree_map(
        np.asarray, je.get_model_state())["batch_stats"]
    bn = model[1]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["1_mean"],
                               atol=TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["1_var"],
                               atol=TOL)
    assert int(bn.num_batches_tracked) == int(stats["1_count"]) == 1
    got = pe.predict({"x": x[:8]})
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, je.predict({"x": x[:8]}), atol=TOL)


class _RematBN(nn.Module):
    """Linear, then BatchNorm under `torch.utils.checkpoint`: the
    backward recomputes the BatchNorm forward, updating its buffers a
    second time."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 3)
        self.bn = nn.BatchNorm1d(3)

    def forward(self, x):
        return torch_checkpoint.checkpoint(self.bn, self.lin(x),
                                           use_reentrant=False)


@pytest.mark.parametrize("store", ["DRAM", "DEVICE"])
def test_skipped_step_keeps_buffers_under_remat(store):
    x, y = _nan_rows()
    OrcaContext.train_data_store = store
    torch.manual_seed(0)
    model = _RematBN()
    clean = copy.deepcopy(model)
    Estimator.from_torch(model, loss="sparse_categorical_crossentropy",
                         optimizer="sgd", learning_rate=0.1).fit(
        {"x": x, "y": y}, epochs=1, batch_size=8, shuffle=False)
    # the reference: the finite first batch alone
    Estimator.from_torch(clean, loss="sparse_categorical_crossentropy",
                         optimizer="sgd", learning_rate=0.1).fit(
        {"x": x[:8], "y": y[:8]}, epochs=1, batch_size=8, shuffle=False)
    for (name, got), (_, want) in zip(model.named_buffers(),
                                      clean.named_buffers()):
        assert torch.equal(got, want), name
    assert int(model.bn.num_batches_tracked) == 2   # recomputed once


def _criterion_cases():
    rng = np.random.default_rng(1)
    cls = rng.integers(0, 3, 10).astype(np.int32)
    reg = rng.normal(size=(10, 3)).astype(np.float32)
    bits = rng.integers(0, 2, (10, 3)).astype(np.float32)
    return {
        "CrossEntropyLoss": (nn.CrossEntropyLoss(), None, cls),
        "MSELoss": (nn.MSELoss(), None, reg),
        "L1Loss": (nn.L1Loss(), None, reg),
        "BCEWithLogitsLoss": (nn.BCEWithLogitsLoss(), None, bits),
        "SmoothL1Loss": (nn.SmoothL1Loss(beta=0.5), None, reg),
        "HuberLoss": (nn.HuberLoss(delta=0.7), None, reg),
        "NLLLoss": (nn.NLLLoss(), nn.LogSoftmax(dim=-1), cls),
        "BCELoss": (nn.BCELoss(), nn.Sigmoid(), bits),
    }


@pytest.mark.parametrize("name", sorted(_criterion_cases()))
def test_torch_criterion_matches_jax(name):
    crit, head, y = _criterion_cases()[name]
    x = np.random.default_rng(2).normal(size=(10, 4)).astype(np.float32)
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(4, 3),
                          *([head] if head is not None else []))
    # lr 0: the losses alone, over 3 batches with a padded last one
    for lr, batch in ((0.0, 4), (1e-2, 10)):
        mj, mp = copy.deepcopy(model), copy.deepcopy(model)
        je = JaxEstimator.from_torch(mj, loss=crit, optimizer="sgd",
                                     learning_rate=lr)
        je.fit({"x": x, "y": y}, epochs=1, batch_size=batch, shuffle=False)
        pe = Estimator.from_torch(mp, loss=crit, optimizer="sgd",
                                  learning_rate=lr)
        pe.fit({"x": x, "y": y}, epochs=1, batch_size=batch, shuffle=False)
        np.testing.assert_allclose(pe.train_summary[-1]["loss"],
                                   je.train_summary[-1]["loss"], atol=TOL)
    # after the one step at 1e-2
    np.testing.assert_allclose(pe.predict({"x": x}), je.predict({"x": x}),
                               atol=TOL)


@pytest.mark.parametrize("crit", [
    nn.CrossEntropyLoss(weight=torch.ones(3)),
    nn.CrossEntropyLoss(ignore_index=0),
    nn.CrossEntropyLoss(label_smoothing=0.1),
    nn.MSELoss(reduction="sum"),
    nn.TripletMarginLoss(),
], ids=["weight", "ignore_index", "label_smoothing", "reduction",
        "unmapped"])
def test_refused_criteria_raise_as_jax(crit):
    from analytics_zoo_tpu.orca.learn.torch_adapter import (
        resolve_torch_loss as jax_resolve,
    )
    with pytest.raises(ValueError) as want:
        jax_resolve(crit)
    with pytest.raises(ValueError) as got:
        resolve_torch_loss(crit)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        Estimator.from_torch(nn.Linear(4, 3), loss=crit)


def test_names_and_callables_pass_through():
    def per_example(preds, labels):
        return (preds[0] - labels[0]).abs().mean(dim=-1)
    assert resolve_torch_loss(None) is None
    assert resolve_torch_loss("mae") == "mae"
    assert resolve_torch_loss(per_example) is per_example
