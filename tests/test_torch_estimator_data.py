"""`Estimator.fit`, `evaluate` and `predict` of the port fed XShards and
DataFrames (`feature_cols` / `label_cols`), held against the JAX
`Estimator.from_flax` on the same converted weights and the same numpy
data: `examples/ncf_dataframe.py`'s setup (NeuralCF on user / item
columns, Adam) at a small size, on the DRAM and DISK tiers, shuffled and
not, and the DEVICE store's streaming fallback.

Tolerance: f32 on both sides (compute_dtype f32), epoch losses, final
parameters and predictions within 1e-5 absolute, the same f32
arithmetic summed in other orders through 2 epochs of Adam at learning
rate 1e-3 (`test_torch_recommendation.py`'s gate).  The batches
themselves are equal bit for bit (`test_torch_streaming_data.py`)."""

import logging

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.orca.data import XShards as JaxXShards
from analytics_zoo_tpu.orca.learn.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.convert import ncf_from_flax
from analytics_zoo_tpu_torch.models import recommendation as rec
from analytics_zoo_tpu_torch.orca.data import XShards
from analytics_zoo_tpu_torch.orca.learn import Estimator

TOL = 1e-5
NCF_KW = dict(user_count=40, item_count=30, class_num=2, user_embed=6,
              item_embed=5, hidden_layers=(16, 8), mf_embed=4)
LR, EPOCHS, BATCH = 1e-3, 2, 16


@pytest.fixture(autouse=True)
def _stores():
    prev = OrcaContext.train_data_store, JaxContext.train_data_store
    yield
    OrcaContext.train_data_store, JaxContext.train_data_store = prev


def _frame(n=90, seed=0):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"user": rng.integers(1, 41, n).astype(np.int32),
                       "item": rng.integers(1, 31, n).astype(np.int32)})
    df["label"] = ((df.user * 31 + df.item) % 2).astype(np.int32)
    return df


def _estimators(store):
    """The JAX and the port Estimator from the same NeuralCF weights."""
    init_orca_context(cluster_mode="local")
    JaxContext.train_data_store = OrcaContext.train_data_store = store
    jm = jrec.NeuralCF(**NCF_KW, compute_dtype=jnp.float32)
    ids = np.ones(4, np.int32)
    params = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.PRNGKey(0), ids, ids)["params"])
    jest = JaxEstimator.from_flax(
        jm, loss="sparse_categorical_crossentropy", optimizer="adam",
        learning_rate=LR, metrics=["accuracy"])
    jest.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    model = rec.NeuralCF(**NCF_KW, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(ncf_from_flax(params))
    est = Estimator.from_torch(model, loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=LR,
                               metrics=["accuracy"])
    return jest, est


def _check(jest, est, jpreds, preds):
    got = [s["loss"] for s in est.train_summary]
    want = [s["loss"] for s in jest.train_summary]
    assert len(got) == EPOCHS and abs(got[1] - got[0]) > 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    want_state = ncf_from_flax(jax.device_get(jest.get_model()))
    for name, w in want_state.items():
        np.testing.assert_allclose(est.get_model().state_dict()[name].numpy(),
                                   w.numpy(), rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_allclose(preds, np.asarray(jpreds), rtol=0, atol=TOL)


def _split(df, cuts):
    edges = [0, *cuts, len(df)]
    return [df.iloc[a:b] for a, b in zip(edges, edges[1:])]


@pytest.mark.parametrize("store", ["DRAM", "DISK_2"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_fit_from_xshards_matches_the_jax_estimator(store, shuffle):
    """7 dict shards of 90 rows at batch 16: batches span shard edges."""
    df = _frame()
    u, i, y = (df[c].to_numpy() for c in ("user", "item", "label"))
    jest, est = _estimators(store)
    jest.fit(JaxXShards.partition({"x": [u, i], "y": y}, num_shards=7),
             epochs=EPOCHS, batch_size=BATCH, shuffle=shuffle)
    est.fit(XShards.partition({"x": [u, i], "y": y}, num_shards=7),
            epochs=EPOCHS, batch_size=BATCH, shuffle=shuffle)
    assert est.engine.host_step == EPOCHS * 6
    jev = jest.evaluate(JaxXShards.partition({"x": [u, i], "y": y}, 3),
                        batch_size=BATCH)
    ev = est.evaluate(XShards.partition({"x": [u, i], "y": y}, 3),
                      batch_size=BATCH)
    assert ev.keys() == jev.keys()
    for k in ev:
        assert abs(ev[k] - jev[k]) <= TOL, (k, ev, jev)
    # predictions in the input's row order, as from the arrays
    preds = est.predict(XShards.partition({"x": [u, i]}, 5), batch_size=BATCH)
    np.testing.assert_array_equal(
        preds, est.predict({"x": [u, i]}, batch_size=BATCH))
    _check(jest, est, jest.predict(JaxXShards.partition({"x": [u, i]}, 5),
                                   batch_size=BATCH), preds)


@pytest.mark.parametrize("as_shards", [False, True], ids=["frame", "shards"])
def test_fit_from_a_dataframe_matches_the_jax_estimator(as_shards):
    """`examples/ncf_dataframe.py`'s calls, positionally: fit(df, epochs,
    batch_size, feature_cols, label_cols), with validation data; then
    evaluate and predict with the columns."""
    df = _frame()
    data = (lambda cls: cls(_split(df, [31, 64]))) if as_shards \
        else (lambda cls: df)
    cols, label = ["user", "item"], ["label"]
    jest, est = _estimators("DRAM")
    jest.fit(data(JaxXShards), EPOCHS, BATCH, cols, label,
             validation_data=data(JaxXShards))
    est.fit(data(XShards), EPOCHS, BATCH, cols, label,
            validation_data=data(XShards))
    assert len(est.val_summary) == EPOCHS
    for got, want in zip(est.val_summary, jest.val_summary):
        assert abs(got["loss"] - want["loss"]) <= TOL
    ev = est.evaluate(data(XShards), BATCH, cols, label)
    jev = jest.evaluate(data(JaxXShards), BATCH, cols, label)
    assert abs(ev["loss"] - jev["loss"]) <= TOL
    preds = est.predict(data(XShards), BATCH, cols)
    assert preds.shape == (len(df), 2)
    _check(jest, est, jest.predict(data(JaxXShards), BATCH, cols), preds)
    with pytest.raises(ValueError, match="label_cols"):
        est.fit(df, 1, BATCH, cols)


def test_device_store_streams_xshards_with_a_warning(caplog):
    """Under the DEVICE store an XShards fit streams from the host, as
    JAX's does (estimator.py:475-479): the warning is logged, no upload
    is cached, and the losses are the DRAM store's."""
    df = _frame()
    u, i, y = (df[c].to_numpy() for c in ("user", "item", "label"))
    jest, est = _estimators("DEVICE")
    with caplog.at_level(logging.WARNING, logger="analytics_zoo_tpu_torch"):
        est.fit(XShards.partition({"x": [u, i], "y": y}, num_shards=7),
                epochs=EPOCHS, batch_size=BATCH, shuffle=False)
    assert any("ignored for streaming input" in r.getMessage()
               for r in caplog.records)
    assert not est._device_cache and est.device_cache_hits == 0
    jest.fit(JaxXShards.partition({"x": [u, i], "y": y}, num_shards=7),
             epochs=EPOCHS, batch_size=BATCH, shuffle=False)
    _, dram = _estimators("DRAM")
    dram.fit({"x": [u, i], "y": y}, epochs=EPOCHS, batch_size=BATCH,
             shuffle=False)
    assert [s["loss"] for s in est.train_summary] == \
        [s["loss"] for s in dram.train_summary]
    _check(jest, est, jest.predict({"x": [u, i]}, batch_size=BATCH),
           est.predict({"x": [u, i]}, batch_size=BATCH))


@pytest.mark.parametrize("loss,metric", [
    ("binary_crossentropy", "binary_accuracy"), ("mse", "mae"),
    ("hinge", "mse"), ("rank_hinge", "accuracy")])
def test_registry_losses_train_as_in_jax(loss, metric):
    """A one-logit NeuralCF fit through both Estimators with a loss and a
    metric of the new registry entries; the ragged last batch (90 rows at
    16) reaches rank_hinge's pair mask."""
    df = _frame()
    u, i, y = (df[c].to_numpy() for c in ("user", "item", "label"))
    kw = dict(NCF_KW, class_num=1)
    init_orca_context(cluster_mode="local")
    JaxContext.train_data_store = OrcaContext.train_data_store = "DRAM"
    jm = jrec.NeuralCF(**kw, compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.array, jm.init(
        jax.random.PRNGKey(1), u[:4], i[:4])["params"])
    jest = JaxEstimator.from_flax(jm, loss=loss, optimizer="adam",
                                  learning_rate=LR, metrics=[metric])
    jest.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    model = rec.NeuralCF(**kw, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(ncf_from_flax(params))
    est = Estimator.from_torch(model, loss=loss, optimizer="adam",
                               learning_rate=LR, metrics=[metric])
    data = {"x": [u, i], "y": y.astype(np.float32)}
    jest.fit(data, epochs=EPOCHS, batch_size=BATCH, shuffle=False)
    est.fit(data, epochs=EPOCHS, batch_size=BATCH, shuffle=False)
    for got, want in zip(est.train_summary, jest.train_summary):
        for k in ("loss", metric):
            assert abs(got[k] - want[k]) <= TOL, (k, got, want)
    _check(jest, est, jest.predict({"x": [u, i]}, batch_size=BATCH),
           est.predict({"x": [u, i]}, batch_size=BATCH))
