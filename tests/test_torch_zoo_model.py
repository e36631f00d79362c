"""The port's model surface (analytics_zoo_tpu_torch/models/common/
zoo_model.py and models/recommendation/recommender.py): `ZooModel`'s
estimator, fit, evaluate and predict, `save_model` / `load_model`
(identical predictions), the unported encryption raising, and the
ranking calls (`predict_user_item_pair`, `recommend_for_user`,
`recommend_for_item`) against the JAX models' on the same f32 weights,
from a `UserItemFeature` list and from a DataFrame.  Last, in a fresh
interpreter where pandas cannot be imported, the recommendation package
and chip_smoke.py import, and NeuralCF fits and ranks on the CPU.

Tolerances: predicted classes and the ranked (user, item) order exact;
probabilities 1e-6 absolute (the same f32 forward summed in other
orders, then one softmax); a reloaded model's predictions exact."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu_torch.convert import (
    ncf_from_flax,
    wide_and_deep_from_flax,
)
from analytics_zoo_tpu_torch.models import recommendation as rec
from analytics_zoo_tpu_torch.models.common import ZooModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROB_TOL = 1e-6
NCF_KW = dict(user_count=12, item_count=15, class_num=2, user_embed=6,
              item_embed=5, hidden_layers=(16, 8), mf_embed=4)
CI_KW = dict(wide_base_cols=["gender"], wide_base_dims=[3],
             wide_cross_cols=["age_gender"], wide_cross_dims=[7],
             indicator_cols=["genres"], indicator_dims=[4],
             embed_cols=["userId", "itemId"], embed_in_dims=[13, 16],
             embed_out_dims=[6, 5], continuous_cols=["age"])


def _models(name):
    """(port model on the CPU, JAX model, its flax params) with the same
    f32 weights."""
    init_orca_context(cluster_mode="local")
    if name == "ncf":
        jm = jrec.NeuralCF(**NCF_KW, compute_dtype=jnp.float32)
        ids = np.ones(2, np.int32)
        p = jm.init(jax.random.PRNGKey(0), ids, ids)["params"]
        m = rec.NeuralCF(**NCF_KW, compute_dtype=torch.float32, device="cpu")
        m.load_state_dict(ncf_from_flax(jax.device_get(p)))
    else:
        jm = jrec.WideAndDeep(column_info=jrec.ColumnFeatureInfo(**CI_KW),
                              hidden_layers=(8,), compute_dtype=jnp.float32)
        x = np.zeros((2, len(jrec.ColumnFeatureInfo(**CI_KW).feature_cols)),
                     np.float32)
        p = jm.init(jax.random.PRNGKey(1), x)["params"]
        m = rec.WideAndDeep(rec.ColumnFeatureInfo(**CI_KW), hidden_layers=(8,),
                            compute_dtype=torch.float32, device="cpu")
        m.load_state_dict(wide_and_deep_from_flax(jax.device_get(p)))
    jm.estimator().set_params(p)
    return m, jm


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    n = 60
    return pd.DataFrame({
        "userId": rng.integers(1, 13, n), "itemId": rng.integers(1, 16, n),
        "gender": rng.integers(0, 3, n), "age_gender": rng.integers(0, 7, n),
        "genres": rng.integers(0, 4, n),
        "age": rng.random(n).astype(np.float32),
        "label": rng.integers(1, 3, n)})


def _pairs(name, df):
    """The same pairs as a UserItemFeature list and as a DataFrame."""
    if name == "ncf":
        feats = [rec.UserItemFeature(u, i, None)
                 for u, i in zip(df.userId, df.itemId)]
        return feats, df[["userId", "itemId"]]
    ci = rec.ColumnFeatureInfo(**CI_KW)
    feats = [rec.to_user_item_feature(r, ci) for _, r in df.iterrows()]
    frame = df[["userId", "itemId"]].copy()
    frame["sample"] = [f.sample for f in feats]
    return feats, frame


def _same(got, want):
    assert [(p.user_id, p.item_id, p.prediction) for p in got] == \
        [(p.user_id, p.item_id, p.prediction) for p in want]
    np.testing.assert_allclose([p.probability for p in got],
                               [p.probability for p in want],
                               rtol=0, atol=PROB_TOL)


@pytest.mark.parametrize("form", ["features", "frame"])
@pytest.mark.parametrize("name", ["ncf", "wide_and_deep"])
def test_ranking_matches_the_jax_model(name, form):
    m, jm = _models(name)
    feats, frame = _pairs(name, _frame())
    pairs = feats if form == "features" else frame
    _same(m.predict_user_item_pair(pairs), jm.predict_user_item_pair(pairs))
    for k in (1, 3):
        top = m.recommend_for_user(pairs, max_items=k)
        _same(top, jm.recommend_for_user(pairs, max_items=k))
        _same(m.recommend_for_item(pairs, max_users=k),
              jm.recommend_for_item(pairs, max_users=k))
        counts = {}
        for p in top:
            counts[p.user_id] = counts.get(p.user_id, 0) + 1
        assert all(c <= k for c in counts.values())
        keys = [(p.prediction, p.probability) for p in top]
        assert keys == sorted(keys, reverse=True)


def test_ranking_of_ties_keeps_the_input_order():
    class Fixed(rec.NeuralCF):
        # items 1 and 3 tie; item 2 is confidently negative
        def predict(self, data, **kw):
            items = np.asarray(data["x"][1])
            return np.where(items[:, None] == 2, np.array([[3.0, 0.0]]),
                            np.array([[0.0, 0.85]]))

    m = Fixed(**NCF_KW, device="cpu")
    pairs = [rec.UserItemFeature(u, i, None) for u in (2, 1) for i in
             (3, 2, 1)]
    top = m.recommend_for_user(pairs, max_items=2)
    assert [(p.user_id, p.item_id) for p in top] == \
        [(2, 3), (2, 1), (1, 3), (1, 1)]
    assert m.recommend_for_user(pairs, max_items=1)[0].prediction == 2
    assert m.predict_user_item_pair([]) == []
    assert m.recommend_for_item([], max_users=2) == []


def test_wide_and_deep_ranking_needs_feature_rows():
    m, _ = _models("wide_and_deep")
    with pytest.raises(ValueError, match="feature rows"):
        m.predict_user_item_pair([rec.UserItemFeature(1, 2, None)])


def _models_to_save():
    yield rec.NeuralCF(**NCF_KW, device="cpu"), \
        lambda n, rng: [rng.integers(1, 13, n), rng.integers(1, 16, n)]
    ci = rec.ColumnFeatureInfo(**CI_KW)
    yield rec.WideAndDeep(ci, hidden_layers=(8, 4), device="cpu"), \
        lambda n, rng: [np.concatenate(
            [rng.integers(0, 3, (n, 5)), rng.random((n, 1))],
            1).astype(np.float32)]
    yield rec.SessionRecommender(item_count=20, item_embed=8,
                                 rnn_hidden_layers=(6, 4), session_length=5,
                                 include_history=True, history_length=3,
                                 mlp_hidden_layers=(7,), device="cpu"), \
        lambda n, rng: [rng.integers(0, 21, (n, 5)),
                        rng.integers(0, 21, (n, 3))]


def _plain(config):
    return {k: vars(v) if isinstance(v, rec.ColumnFeatureInfo) else v
            for k, v in config.items()}


@pytest.mark.parametrize("index", [0, 1, 2])
def test_save_then_load_predicts_identically(tmp_path, index):
    model, inputs = list(_models_to_save())[index]
    rng = np.random.default_rng(index)
    x = inputs(40, rng)
    n_out = model.predict({"x": x}).shape[-1]
    y = rng.integers(0, n_out, 40).astype(np.int32)
    est = model.estimator(learning_rate=1e-2)
    assert model._require_estimator() is est
    model.fit({"x": x, "y": y}, epochs=2, batch_size=16)
    assert est.engine.host_step == 6
    ev = model.evaluate({"x": x, "y": y}, batch_size=16)
    assert set(ev) == {"loss", "accuracy"}
    want = model.predict({"x": x}, batch_size=16)
    path = model.save_model(str(tmp_path / "m"))
    assert sorted(os.listdir(path)) == ["config.pkl", "weights.pt"]
    loaded = type(model).load_model(path, device="cpu")
    assert _plain(loaded.get_config()) == _plain(model.get_config())
    np.testing.assert_array_equal(loaded.predict({"x": x}, batch_size=16),
                                  want)
    # a reloaded model trains on
    loaded.fit({"x": x, "y": y}, epochs=1, batch_size=16)


def test_load_checks_the_class(tmp_path):
    path = rec.NeuralCF(**NCF_KW, device="cpu").save_model(str(tmp_path))
    with pytest.raises(ValueError, match="holds a NeuralCF"):
        rec.SessionRecommender.load_model(path, device="cpu")


def test_encryption_is_not_ported_yet(tmp_path):
    """Encryption at rest is ported now (tests/test_torch_encrypt.py
    holds the bytes against JAX's): an encrypted save leaves no weights
    in the clear, and its load needs the key (JAX's ValueError)."""
    model = rec.NeuralCF(**NCF_KW, device="cpu")
    path = model.save_model(str(tmp_path / "m"), encrypt_key="secret")
    assert not os.path.exists(os.path.join(path, "weights.pt"))
    with pytest.raises(ValueError, match="pass decrypt_key"):
        rec.NeuralCF.load_model(path, device="cpu")
    back = rec.NeuralCF.load_model(path, decrypt_key="secret", device="cpu")
    for (name, a), b in zip(back.state_dict().items(),
                            model.state_dict().values()):
        assert torch.equal(a, b), name


def test_models_are_zoo_models_and_raise_without_a_card(monkeypatch):
    for cls in (rec.NeuralCF, rec.WideAndDeep, rec.SessionRecommender):
        assert issubclass(cls, ZooModel)
        assert issubclass(cls, torch.nn.Module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rec.NeuralCF(**NCF_KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rec.SessionRecommender(item_count=5)


_NO_PANDAS = r"""
import sys
sys.modules["pandas"] = None
import numpy as np
import analytics_zoo_tpu_torch.models.recommendation as rec
import chip_smoke
from analytics_zoo_tpu_torch.common.context import OrcaContext
OrcaContext.train_data_store = "DEVICE"
rng = np.random.default_rng(0)
u = rng.integers(1, 21, 200).astype(np.int32)
i = rng.integers(1, 31, 200).astype(np.int32)
model = rec.NeuralCF(20, 30, hidden_layers=(8,), device="cpu")
model.fit({"x": [u, i], "y": ((u + i) % 2).astype(np.int32)}, epochs=2,
          batch_size=64)
pairs = [rec.UserItemFeature(a, b, None) for a in (1, 2) for b in range(1, 9)]
top = model.recommend_for_user(pairs, max_items=3)
assert len(top) == 6 and len(model._estimator._device_cache) == 1
assert len(rec.hash_bucket(["a", "b"])) == 2
print("PANDAS" , "pandas" in sys.modules and sys.modules["pandas"] is not None)
"""


def test_package_and_chip_smoke_import_without_pandas():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", _NO_PANDAS], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PANDAS False" in proc.stdout, proc.stdout
