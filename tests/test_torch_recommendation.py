"""The port's recommendation family (analytics_zoo_tpu_torch/models/
recommendation/) held against the JAX package's on the same weights
(converted by `convert.*_from_flax`) and the same numpy inputs:
NeuralCF, WideAndDeep and SessionRecommender forward, then training
through `Estimator.from_torch(...).fit` against the JAX
`Estimator.from_flax` on the DRAM store (with shuffle: both draw the
host permutation from seed + epoch) and on the DEVICE store (without),
and the feature utilities against the JAX module's.

Tolerances, each with its reason:
  * f32 (compute_dtype f32 on both sides): 1e-5 absolute on logits,
    epoch losses and final parameters, the same f32 arithmetic summed in
    other orders (through 2 epochs of Adam at learning rate 1e-3 for the
    fits);
  * bf16 (the JAX default compute_dtype): logits 0.05 absolute,
    `test_torch_bert.py`'s bf16 gate (both sides round the Dense inputs,
    weights and outputs to bf16, accumulating in f32 in other orders);
  * the utilities: exact."""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.orca.learn.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.convert import (
    ncf_from_flax,
    session_recommender_from_flax,
    wide_and_deep_from_flax,
)
from analytics_zoo_tpu_torch.models import recommendation as rec
from analytics_zoo_tpu_torch.orca.learn import Estimator

F32_TOL, BF16_TOL = 1e-5, 0.05
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
NCF_KW = dict(user_count=20, item_count=30, class_num=2, user_embed=6,
              item_embed=5, hidden_layers=(16, 8), mf_embed=4)
CI_KW = dict(wide_base_cols=["occupation", "gender"], wide_base_dims=[5, 3],
             wide_cross_cols=["age_gender"], wide_cross_dims=[7],
             indicator_cols=["genres", "gender"], indicator_dims=[4, 3],
             embed_cols=["userId", "itemId"], embed_in_dims=[11, 13],
             embed_out_dims=[6, 5], continuous_cols=["age"])
SESSION_KW = dict(item_count=50, item_embed=8, rnn_hidden_layers=(6, 4),
                  session_length=5, mlp_hidden_layers=(7, 3),
                  history_length=3)


@pytest.fixture(autouse=True)
def _stores():
    prev = OrcaContext.train_data_store, JaxContext.train_data_store
    yield
    OrcaContext.train_data_store, JaxContext.train_data_store = prev


def _params(jax_module, *inputs, seed=0):
    return jax.tree_util.tree_map(
        np.array, jax_module.init(jax.random.PRNGKey(seed), *inputs)["params"])


def _ncf_ids(rng, n):
    # 0 and ids past the counts: both sides clip them
    u = rng.integers(0, NCF_KW["user_count"] + 5, n).astype(np.int32)
    i = rng.integers(0, NCF_KW["item_count"] + 5, n).astype(np.int32)
    u[:2], i[:2] = (0, NCF_KW["user_count"] + 7), (NCF_KW["item_count"] + 9, 0)
    return u, i


def _wide_deep_rows(rng, n, ci_kw=CI_KW):
    dims = (ci_kw["wide_base_dims"] + ci_kw["wide_cross_dims"]
            + ci_kw["indicator_dims"] + ci_kw["embed_in_dims"])
    # ids from -1 to past each dim: both sides clip them
    ids = np.stack([rng.integers(-1, d + 2, n) for d in dims], axis=1)
    cont = rng.normal(size=(n, len(ci_kw["continuous_cols"])))
    return np.concatenate([ids, cont], axis=1).astype(np.float32)


def _sessions(rng, n):
    count = SESSION_KW["item_count"]
    s = rng.integers(0, count + 3, (n, SESSION_KW["session_length"]))
    h = rng.integers(0, count + 3, (n, SESSION_KW["history_length"]))
    return s.astype(np.int32), h.astype(np.int32)


def _close(got, want, dtype):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_TOL if dtype == "f32" else BF16_TOL)


@pytest.mark.parametrize("include_mf", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ncf_forward_matches_jax(dtype, include_mf):
    tdt, jdt = DTYPES[dtype]
    u, i = _ncf_ids(np.random.default_rng(0), 64)
    jm = jrec.NeuralCF(**NCF_KW, include_mf=include_mf, compute_dtype=jdt)
    p = _params(jm, u, i)
    want = np.asarray(jm.apply({"params": p}, u, i))
    m = rec.NeuralCF(**NCF_KW, include_mf=include_mf, compute_dtype=tdt,
                     device="cpu")
    m.load_state_dict(ncf_from_flax(p))
    got = m(torch.from_numpy(u), torch.from_numpy(i))
    assert got.dtype == torch.float32 and got.shape == (64, 2)
    _close(got.detach().numpy(), want, dtype)


def test_ncf_head_takes_rows_h_then_mf():
    # a head whose mf rows are zero sees only the MLP: the converted
    # head is not transposed or reordered
    u, i = _ncf_ids(np.random.default_rng(1), 16)
    jm = jrec.NeuralCF(**NCF_KW, compute_dtype=jnp.float32)
    p = _params(jm, u, i)
    p["head"]["kernel"][NCF_KW["hidden_layers"][-1]:] = 0.0
    m = rec.NeuralCF(**NCF_KW, compute_dtype=torch.float32, device="cpu")
    m.load_state_dict(ncf_from_flax(p))
    head = m.head.weight.detach()
    assert float(head[:, NCF_KW["hidden_layers"][-1]:].abs().max()) == 0.0
    np.testing.assert_allclose(
        m(torch.from_numpy(u), torch.from_numpy(i)).detach().numpy(),
        np.asarray(jm.apply({"params": p}, u, i)), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
def test_wide_and_deep_forward_matches_jax(model_type, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _wide_deep_rows(np.random.default_rng(2), 48)
    jm = jrec.WideAndDeep(column_info=jrec.ColumnFeatureInfo(**CI_KW),
                          hidden_layers=(8, 4), model_type=model_type,
                          compute_dtype=jdt)
    p = _params(jm, x)
    want = np.asarray(jm.apply({"params": p}, x))
    m = rec.WideAndDeep(rec.ColumnFeatureInfo(**CI_KW), hidden_layers=(8, 4),
                        model_type=model_type, compute_dtype=tdt,
                        device="cpu")
    m.load_state_dict(wide_and_deep_from_flax(p))
    _close(m(torch.from_numpy(x)).detach().numpy(), want, dtype)


def test_wide_and_deep_raises_as_jax_does():
    x = np.zeros((2, 1), np.float32)
    ci_kw = dict(wide_base_cols=["a"], wide_base_dims=[4])
    with pytest.raises(ValueError, match="unsupported model_type"):
        jrec.WideAndDeep(column_info=jrec.ColumnFeatureInfo(**ci_kw),
                         model_type="wide_deep").init(
            jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="unsupported model_type"):
        rec.WideAndDeep(rec.ColumnFeatureInfo(**ci_kw),
                        model_type="wide_deep", device="cpu")
    # a missing tower
    for model_type, kw in (("deep", ci_kw),
                           ("wide", dict(continuous_cols=["c"]))):
        with pytest.raises(ValueError, match="tower needs"):
            jrec.WideAndDeep(column_info=jrec.ColumnFeatureInfo(**kw),
                             model_type=model_type).init(
                jax.random.PRNGKey(0), x)
        with pytest.raises(ValueError, match="tower needs"):
            rec.WideAndDeep(rec.ColumnFeatureInfo(**kw),
                            model_type=model_type, device="cpu")


@pytest.mark.parametrize("include_history", [True, False])
def test_session_recommender_forward_matches_jax(include_history):
    s, h = _sessions(np.random.default_rng(3), 24)
    jm = jrec.SessionRecommender(**SESSION_KW,
                                 include_history=include_history)
    inputs = (s, h) if include_history else (s,)
    p = _params(jm, *inputs)
    want = np.asarray(jm.apply({"params": p}, *inputs))
    m = rec.SessionRecommender(**SESSION_KW, include_history=include_history,
                               device="cpu")
    m.load_state_dict(session_recommender_from_flax(p))
    got = m(*(torch.from_numpy(a) for a in inputs))
    assert got.shape == (24, SESSION_KW["item_count"] + 1)
    _close(got.detach().numpy(), want, "f32")


def test_converters_reject_unknown_entries():
    u, i = _ncf_ids(np.random.default_rng(4), 4)
    p = _params(jrec.NeuralCF(**NCF_KW), u, i)
    p["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="extra"):
        ncf_from_flax(p)
    s, h = _sessions(np.random.default_rng(4), 4)
    p = _params(jrec.SessionRecommender(**SESSION_KW), s)
    del p["gru_cell_0"]["hz"]
    with pytest.raises(ValueError, match="gru_cell_0"):
        session_recommender_from_flax(p)


# ----------------------------------------------------------------------
# training through the Estimator
# ----------------------------------------------------------------------

LR, EPOCHS, BATCH = 1e-3, 2, 16


def _fit_both(jax_module, port_module, params, convert, data, store,
              shuffle):
    """Two epochs of Adam through both Estimators from the same weights;
    returns the epoch losses and final state_dicts, JAX's converted."""
    init_orca_context(cluster_mode="local")
    JaxContext.train_data_store = OrcaContext.train_data_store = store
    jest = JaxEstimator.from_flax(
        jax_module, loss="sparse_categorical_crossentropy",
        optimizer="adam", learning_rate=LR, metrics=["accuracy"])
    jest.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    jest.fit(data, epochs=EPOCHS, batch_size=BATCH, shuffle=shuffle)
    port_module.load_state_dict(convert(params))
    est = Estimator.from_torch(port_module,
                               loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=LR,
                               metrics=["accuracy"])
    est.fit(data, epochs=EPOCHS, batch_size=BATCH, shuffle=shuffle)
    if store == "DEVICE":
        assert len(est._device_cache) == 1
    else:
        assert not est._device_cache
    losses = ([s["loss"] for s in jest.train_summary],
              [s["loss"] for s in est.train_summary])
    return losses, convert(jax.device_get(jest.get_model())), \
        port_module.state_dict()


def _check_fit(losses, want_state, got_state):
    want, got = losses
    assert len(got) == EPOCHS
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert abs(got[1] - got[0]) > 1e-3        # two different epochs
    assert set(got_state) == set(want_state)
    for name, w in want_state.items():
        np.testing.assert_allclose(got_state[name].numpy(), w.numpy(),
                                   rtol=0, atol=F32_TOL, err_msg=name)


STORES = [("DRAM", True), ("DEVICE", False)]


@pytest.mark.parametrize("store,shuffle", STORES)
def test_ncf_fit_matches_the_jax_estimator(store, shuffle):
    rng = np.random.default_rng(5)
    u, i = _ncf_ids(rng, 70)        # 5 steps an epoch, the last ragged
    y = ((u + i) % 2).astype(np.int32)
    jm = jrec.NeuralCF(**NCF_KW, compute_dtype=jnp.float32)
    _check_fit(*_fit_both(
        jm, rec.NeuralCF(**NCF_KW, compute_dtype=torch.float32,
                         device="cpu"),
        _params(jm, u, i), ncf_from_flax, {"x": [u, i], "y": y}, store,
        shuffle))


@pytest.mark.parametrize("store,shuffle", STORES)
def test_wide_and_deep_fit_matches_the_jax_estimator(store, shuffle):
    rng = np.random.default_rng(6)
    x = _wide_deep_rows(rng, 70)
    y = (x[:, 0] > x[:, 3]).astype(np.int32)
    jm = jrec.WideAndDeep(column_info=jrec.ColumnFeatureInfo(**CI_KW),
                          hidden_layers=(8, 4), compute_dtype=jnp.float32)
    _check_fit(*_fit_both(
        jm, rec.WideAndDeep(rec.ColumnFeatureInfo(**CI_KW),
                            hidden_layers=(8, 4),
                            compute_dtype=torch.float32, device="cpu"),
        _params(jm, x), wide_and_deep_from_flax, {"x": x, "y": y}, store,
        shuffle))


@pytest.mark.parametrize("store,shuffle", STORES)
def test_session_recommender_fit_matches_the_jax_estimator(store, shuffle):
    # the GRU's hidden-side r and z biases must stay at zero under Adam,
    # or the trained gates drift from flax's (one bias per gate)
    s, h = _sessions(np.random.default_rng(7), 70)
    y = s[:, -1] % (SESSION_KW["item_count"] + 1)
    jm = jrec.SessionRecommender(**SESSION_KW, include_history=True)
    port = rec.SessionRecommender(**SESSION_KW, include_history=True,
                                  device="cpu")
    losses, want, got = _fit_both(
        jm, port, _params(jm, s, h), session_recommender_from_flax,
        {"x": [s, h], "y": y}, store, shuffle)
    _check_fit(losses, want, got)
    for j, width in enumerate(SESSION_KW["rnn_hidden_layers"]):
        assert float(got[f"gru.{j}.bias_hh_l0"][:2 * width].abs().max()) \
            == 0.0


# ----------------------------------------------------------------------
# feature utilities, against the JAX module's
# ----------------------------------------------------------------------

def _frame(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "userId": rng.integers(0, 11, n), "itemId": rng.integers(0, 13, n),
        "occupation": rng.integers(0, 5, n), "gender": rng.integers(0, 3, n),
        "age_gender": rng.integers(0, 7, n), "genres": rng.integers(0, 4, n),
        "age": rng.random(n).astype(np.float32),
        "label": rng.integers(1, 3, n)})


@pytest.mark.parametrize("content", [
    "abc", 42, ["abc", "def", "abc"], np.array([3, 17, 3]),
    pd.Series(["x", "y", "z"]), (1.5, "2")])
def test_hash_bucket_matches_jax(content):
    want = jrec.hash_bucket(content, bucket_size=97, start=3)
    got = rec.hash_bucket(content, bucket_size=97, start=3)
    np.testing.assert_array_equal(got, want)
    assert type(got) is type(want)


def test_vocab_and_boundaries_match_jax():
    vocab = ["a", "b", "c"]
    for sth in ("b", "z", ["c", "z", "a"], pd.Series(["a", "q"])):
        np.testing.assert_array_equal(
            rec.categorical_from_vocab_list(sth, vocab, start=1),
            jrec.categorical_from_vocab_list(sth, vocab, start=1))
    bnds = [18, 25, 35]
    for target in (17, 25, 99, "?", None, "30",
                   [17, 99, "?", 25.0], pd.Series([17, 99, "?"]),
                   np.array([1.0, np.nan, 40.0])):
        want = jrec.get_boundaries(target, bnds, default=-1, start=1)
        got = rec.get_boundaries(target, bnds, default=-1, start=1)
        np.testing.assert_array_equal(got, want)
        assert type(got) is type(want)


def test_negative_samples_match_jax():
    df = pd.DataFrame({"userId": [1, 1, 2, 3], "itemId": [1, 2, 1, 4],
                       "label": [5, 4, 3, 2]})
    pd.testing.assert_frame_equal(
        rec.get_negative_samples(df, neg_num=3, item_count=6, seed=2),
        jrec.get_negative_samples(df, neg_num=3, item_count=6, seed=2))
    dense = pd.DataFrame({"userId": [1] * 3, "itemId": [1, 2, 3],
                          "label": [5] * 3})
    with pytest.warns(UserWarning, match="dropped"):
        got = rec.get_negative_samples(dense, neg_num=2, item_count=3)
    assert len(got) == 0


def test_wide_deep_features_match_jax():
    df = _frame()
    jci, ci = jrec.ColumnFeatureInfo(**CI_KW), rec.ColumnFeatureInfo(**CI_KW)
    assert ci.feature_cols == jci.feature_cols
    np.testing.assert_array_equal(rec.get_wide_indices(df, ci),
                                  jrec.get_wide_indices(df, jci))
    np.testing.assert_array_equal(rec.get_wide_indices(df.iloc[3], ci),
                                  jrec.get_wide_indices(df.iloc[3], jci))
    for frame in (df, df.iloc[2]):
        for got, want in zip(rec.get_deep_tensors(frame, ci),
                             jrec.get_deep_tensors(frame, jci), strict=True):
            np.testing.assert_array_equal(got, want)
    for model_type in ("wide", "deep", "wide_n_deep"):
        np.testing.assert_array_equal(
            rec.rows_to_features(df, ci, model_type),
            jrec.rows_to_features(df, jci, model_type))
    with pytest.raises(TypeError, match="Unsupported"):
        rec.rows_to_features(df, ci, "wide_deep")
    got = rec.to_user_item_feature(df.iloc[5], ci)
    want = jrec.to_user_item_feature(df.iloc[5], jci)
    assert (got.user_id, got.item_id, got.label) == \
        (want.user_id, want.item_id, want.label)
    np.testing.assert_array_equal(got.sample, want.sample)
    feats, label = rec.row_to_sample(df.iloc[0], ci)
    assert label == jrec.row_to_sample(df.iloc[0], jci)[1]
    big = pd.DataFrame({"userId": [2 ** 24 + 1], "itemId": [1],
                        "age": [0.5]})
    deep = rec.ColumnFeatureInfo(embed_cols=["userId"],
                                 embed_in_dims=[2 ** 25],
                                 embed_out_dims=[4], continuous_cols=["age"])
    with pytest.raises(ValueError, match="2\\*\\*24"):
        rec.rows_to_features(big, deep, model_type="deep")
    with pytest.raises(ValueError, match="2\\*\\*24"):
        rec.get_deep_tensors(big, deep)


def test_package_exports_the_jax_names():
    exported = {n for n in dir(jrec) if not n.startswith("_")
                and not isinstance(getattr(jrec, n), type(jrec))}
    assert exported <= set(dir(rec)), exported - set(dir(rec))
