"""The port's Keras-style API (analytics_zoo_tpu_torch/keras/) and
`Estimator.from_keras`, on the CPU.

* The public names of `keras` and `keras.layers` equal the JAX
  package's.
* The 12 tests of `test_keras_api.py` on the port (built with
  `device="cpu"`), thresholds unchanged.
* The same first step as JAX: for the Sequential MLP and the two-tower
  NCF toy, one `fit` step (dropout 0) from the same weights (JAX's
  `init`, carried by `convert.keras_from_flax` through a deferred
  `set_params`) gives JAX's `Estimator.from_keras` loss and weights.
* Building on the first batch, whichever of fit / evaluate / predict
  comes first; `set_params`, `load` and `resume_latest` before it; a
  compiled model's loss, optimizer and metrics unless overridden;
  `keras_from_flax` and `keras_to_flax` inverse to each other; the
  autograd vocabulary and `CustomLoss`.

Tolerances: the first step's loss within 1e-5 and the weights after it
within 1e-5 absolute (f32 on both sides, the same arithmetic summed in
other orders, through one Adam step of learning rate 1e-2); round trips
exact.
"""

import types

import numpy as np
import pytest
import torch

import jax

import analytics_zoo_tpu.keras as jax_keras
from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu.keras import engine as jax_engine
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.keras import optimizers as jax_optimizers
from analytics_zoo_tpu.orca.learn.estimator import Estimator as JaxEstimator
import analytics_zoo_tpu_torch.keras as port_keras
from analytics_zoo_tpu_torch.convert import keras_from_flax, keras_to_flax
from analytics_zoo_tpu_torch.keras import Input, Model, Sequential, optimizers
from analytics_zoo_tpu_torch.keras import autograd as A
from analytics_zoo_tpu_torch.keras import engine as port_engine
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.orca.learn import Estimator

STEP_TOL = 1e-5
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache():
    """The JAX reference fits compile without `.jax_cache_tests`, as in
    `test_torch_estimator.py` (a train step loaded back from the cache in
    a contended run has aborted a worker)."""
    from jax._src import compilation_cache

    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_compilation_cache_dir", prev)
    compilation_cache.reset_cache()


def _public(mod):
    """(names of non-module attributes, names of re-exported modules)."""
    names = {n for n in dir(mod) if not n.startswith("_")}
    values = {n for n in names if not isinstance(getattr(mod, n),
                                                 types.ModuleType)}
    return values, names - values


def test_public_names_match_jax():
    jv, jm = _public(jax_keras)
    pv, pm = _public(port_keras)
    assert jv == pv == {"Input", "Layer", "Model", "Sequential"}
    for name in ("layers", "objectives", "metrics", "optimizers"):
        assert name in jm and name in pm
    jv, _ = _public(JL)
    pv, _ = _public(L)
    assert jv == pv


# ----------------------------------------------------------------------
# test_keras_api.py on the port
# ----------------------------------------------------------------------

def test_sequential_mlp_fit():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 10)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    model = Sequential([L.Dense(32, activation="relu"), L.Dropout(0.1),
                        L.Dense(2)], **CPU)
    model.compile(optimizer=optimizers.Adam(learning_rate=1e-2),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit(x, y, batch_size=32, nb_epoch=5)
    stats = model.evaluate(x, y, batch_size=32)
    assert stats["accuracy"] > 0.85, stats


def _ncf_toy(Lm, Input_, M, **kw):
    u_in, i_in = Input_(shape=(), name="user"), Input_(shape=(), name="item")
    u_emb = Lm.Flatten()(Lm.Embedding(50, 16)(u_in))
    i_emb = Lm.Flatten()(Lm.Embedding(30, 16)(i_in))
    h = Lm.Concat()([u_emb, i_emb])
    h = Lm.Dense(32, activation="relu")(h)
    return M(input=[u_in, i_in], output=Lm.Dense(2)(h), **kw)


def _ncf_data(n=300):
    rng = np.random.default_rng(0)
    user = rng.integers(0, 50, n)
    item = rng.integers(0, 30, n)
    return user, item, ((user + item) % 2).astype(np.int32)


def test_functional_two_tower_ncf_style():
    user, item, y = _ncf_data()
    model = _ncf_toy(L, Input, Model, **CPU)
    model.compile(optimizer=optimizers.Adam(learning_rate=1e-2),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit({"x": [user, item], "y": y}, batch_size=32, nb_epoch=6)
    stats = model.evaluate({"x": [user, item], "y": y})
    assert stats["accuracy"] > 0.8, stats
    assert model.predict({"x": [user, item]}).shape == (300, 2)


def test_operator_sugar_autograd_style():
    a, b = Input(shape=(4,)), Input(shape=(4,))
    model = Model(input=[a, b], output=L.Dense(3)((a + b) * 2.0), **CPU)
    model.compile(optimizer="sgd", loss="mse")
    preds = model.predict({"x": [np.ones((16, 4), np.float32),
                                 np.zeros((16, 4), np.float32)]},
                          batch_size=8)
    assert preds.shape == (16, 3)


def test_conv_pool_batchnorm_stack():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8, 8, 3)).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int32)
    model = Sequential([
        L.Conv2D(8, 3, border_mode="same", activation="relu"),
        L.BatchNormalization(), L.MaxPooling2D(2),
        L.GlobalAveragePooling2D(), L.Dense(2)], **CPU)
    model.compile(optimizer=optimizers.Adam(learning_rate=1e-2),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit(x, y, batch_size=16, nb_epoch=3)
    assert model.predict(x, batch_size=16).shape == (64, 2)


def test_lstm_sequence_classification():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 12, 6)).astype(np.float32)
    y = (x[:, :, 0].mean(axis=1) > 0).astype(np.int32)
    model = Sequential([L.LSTM(16), L.Dense(2)], **CPU)
    model.compile(optimizer=optimizers.Adam(learning_rate=1e-2),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit(x, y, batch_size=32, nb_epoch=4)
    stats = model.evaluate(x, y)
    assert stats["accuracy"] > 0.7, stats


def test_bidirectional_and_timedistributed():
    x = np.random.default_rng(0).normal(size=(32, 5, 4)).astype(np.float32)
    model = Sequential([L.Bidirectional(L.GRU(8, return_sequences=True)),
                        L.TimeDistributed(L.Dense(3))], **CPU)
    model.compile(optimizer="adam", loss="mse")
    assert model.predict(x, batch_size=16).shape == (32, 5, 3)


def test_transformer_layer_forward():
    ids = np.random.default_rng(0).integers(0, 100, size=(8, 16)).astype(
        np.int32)
    t_in = Input(shape=(16,))
    h = L.TransformerLayer(vocab=100, hidden_size=32, n_head=4, seq_len=16,
                           n_block=2)(t_in)
    model = Model(input=t_in, output=L.Dense(2)(L.Lambda(
        lambda a: a[:, 0])(h)), **CPU)
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    assert model.predict(ids, batch_size=8).shape == (8, 2)


def test_bert_layer_outputs():
    b, t = 4, 12
    ids = np.random.default_rng(0).integers(0, 50, size=(b, t)).astype(
        np.int32)
    seg = np.zeros((b, t), np.int32)
    pos = np.tile(np.arange(t), (b, 1)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    inputs = [Input(shape=(t,)) for _ in range(4)]
    seq, pooled = L.BERT(vocab=50, hidden_size=24, n_block=2, n_head=3,
                         intermediate_size=48, seq_len=t)(inputs)
    model = Model(input=inputs, output=[seq, pooled], **CPU)
    model.compile(optimizer="adam", loss="mse")
    out_seq, out_pooled = model.predict({"x": [ids, seg, pos, mask]},
                                        batch_size=4)
    assert out_seq.shape == (b, t, 24) and out_pooled.shape == (b, 24)


def test_shared_layer_weight_sharing():
    a, b = Input(shape=(6,)), Input(shape=(6,))
    shared = L.Dense(4)
    model = Model(input=[a, b], output=shared(a) + shared(b), **CPU)
    model.compile(optimizer="sgd", loss="mse")
    x, z = np.ones((8, 6), np.float32), np.zeros((8, 6), np.float32)
    p1 = model.predict({"x": [x, z]}, batch_size=8)
    p2 = model.predict({"x": [z, x]}, batch_size=8)
    np.testing.assert_allclose(p1, p2, rtol=1e-5)
    params = model.get_weights()
    assert sum(1 for k in params if "dense" in k) == 1, list(params)


def test_rsub_rdiv_sugar():
    x_in = Input(shape=(3,))
    model = Model(input=x_in, output=1.0 - x_in, **CPU)
    preds = model.predict(np.full((8, 3), 0.25, np.float32), batch_size=8)
    np.testing.assert_allclose(preds, 0.75)
    model = Model(input=x_in, output=2.0 / x_in, **CPU)
    np.testing.assert_allclose(model.predict(
        np.full((8, 3), 0.25, np.float32), batch_size=8), 8.0)


def test_predict_without_compile():
    model = Sequential([L.Dense(2)], **CPU)
    assert model.predict(np.ones((8, 3), np.float32),
                         batch_size=8).shape == (8, 2)


def test_bidirectional_last_step_uses_final_backward_state():
    x = np.random.default_rng(0).normal(size=(4, 6, 3)).astype(np.float32)
    bi = Sequential([L.Bidirectional(L.GRU(5))], **CPU)
    bi.compile(optimizer="sgd", loss="mse")
    p = bi.predict(x, batch_size=4)
    assert p.shape == (4, 10)
    # the backward half is the backward cell's state after the whole
    # reversed sequence: the return_sequences variant's step 0
    gm = bi._ensure_estimator().get_model()
    seq = Sequential([L.Bidirectional(L.GRU(5, return_sequences=True))],
                     **CPU).to_torch().build(x[:1])
    sd = {k.replace(gm.net.layers()[0].name,
                    seq.net.layers()[0].name): v
          for k, v in gm.state_dict().items()}
    seq.load_state_dict(sd)
    full = seq.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(p[:, :5], full[:, -1, :5], atol=1e-6)
    np.testing.assert_allclose(p[:, 5:], full[:, 0, 5:], atol=1e-6)


# ----------------------------------------------------------------------
# the first step against JAX's Estimator.from_keras
# ----------------------------------------------------------------------

def _mlp(Lm, M, **kw):
    return M([Lm.Dense(32, activation="relu"), Lm.Dropout(0.0),
              Lm.Dense(2)], **kw)


def _first_step(build_jax, build_port, x, y, n):
    """(JAX loss, port loss, JAX params, port params) after one Adam
    step over the whole dataset from the same weights."""
    init_orca_context(cluster_mode="local")
    jax_engine.reset_name_scope()
    jm = build_jax()
    port_engine.reset_name_scope()
    pm = build_port()
    for m, opt in ((jm, jax_optimizers), (pm, optimizers)):
        m.compile(optimizer=opt.Adam(learning_rate=1e-2),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    feats = x if isinstance(x, list) else [x]
    fm = jm.to_flax()
    params0 = fm.init({"params": jax.random.PRNGKey(3),
                       "dropout": jax.random.PRNGKey(4)},
                      *[a[:1] for a in feats])["params"]
    params0 = jax.tree_util.tree_map(np.asarray, params0)
    data = {"x": x, "y": y}

    jest = JaxEstimator.from_keras(jm)
    jest.set_params(params0)
    jest.fit(data, epochs=1, batch_size=n)
    est = Estimator.from_keras(pm)
    est.set_params(lambda sd: keras_from_flax(est.get_model(), params0))
    est.fit(data, epochs=1, batch_size=n)
    assert est.engine.host_step == 1
    return (jest.train_summary[-1]["loss"], est.train_summary[-1]["loss"],
            jax.tree_util.tree_map(np.asarray, jest.get_model()),
            keras_to_flax(est.get_model())[0])


def _assert_trees_close(got, want, tol):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        err = float(np.abs(np.asarray(g) - np.asarray(w)).max())
        assert err <= tol, (jax.tree_util.keystr(path), err)


def test_mlp_first_step_matches_jax_from_keras():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(128, 10)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    jl, pl, jp, pp = _first_step(
        lambda: _mlp(JL, jax_keras.Sequential),
        lambda: _mlp(L, Sequential, **CPU), x, y, 128)
    assert abs(jl - pl) <= STEP_TOL, (jl, pl)
    _assert_trees_close(pp, jp, STEP_TOL)


def test_ncf_toy_first_step_matches_jax_from_keras():
    user, item, y = _ncf_data(256)
    jl, pl, jp, pp = _first_step(
        lambda: _ncf_toy(JL, jax_engine.Input, jax_keras.Model),
        lambda: _ncf_toy(L, Input, Model, **CPU), [user, item], y, 256)
    assert abs(jl - pl) <= STEP_TOL, (jl, pl)
    _assert_trees_close(pp, jp, STEP_TOL)


# ----------------------------------------------------------------------
# building on the first batch, deferred calls, compile's settings
# ----------------------------------------------------------------------

def _xy(n=64):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    return x, (x[:, 0] > 0).astype(np.int32)


@pytest.mark.parametrize("first", ["fit", "evaluate", "predict"])
def test_builds_on_the_first_batch_of_any_call(first):
    x, y = _xy()
    port_engine.reset_name_scope()
    model = Sequential([L.Dense(3), L.BatchNormalization(), L.Dense(2)],
                       **CPU)
    est = Estimator.from_keras(model, loss="sparse_categorical_crossentropy")
    assert est.engine is None and not est.get_model().built
    assert est.get_model_state() == {}
    if first == "fit":
        est.fit({"x": x, "y": y}, batch_size=16)
    elif first == "evaluate":
        assert "loss" in est.evaluate({"x": x, "y": y}, batch_size=16)
    else:
        assert est.predict(x, batch_size=16).shape == (64, 2)
    gm = est.get_model()
    assert gm.built and est.engine is not None
    assert gm.dense_1.weight.shape == (3, 5)
    assert set(est.get_model_state()) == {"batchnormalization_1.running_mean",
                                          "batchnormalization_1.running_var"}


def test_build_draws_from_the_estimator_seed():
    x, _ = _xy()
    outs = []
    for seed in (0, 0, 1):
        est = Estimator.from_keras(Sequential([L.Dense(4)], **CPU),
                                   seed=seed)
        outs.append(est.predict(x, batch_size=64))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.allclose(outs[0], outs[2])
    # and leaves the caller's random state as it was
    torch.manual_seed(5)
    want = torch.rand(3)
    torch.manual_seed(5)
    Estimator.from_keras(Sequential([L.Dense(4)], **CPU)).predict(x)
    assert torch.equal(torch.rand(3), want)


def test_compiled_settings_are_used_unless_overridden():
    model = Sequential([L.Dense(2)], **CPU)
    model.compile(optimizer=optimizers.SGD(learning_rate=0.5), loss="mse",
                  metrics=["mae"])
    est = Estimator.from_keras(model)
    x, y = _xy()
    yf = np.stack([y, 1 - y], 1).astype(np.float32)
    est.fit({"x": x, "y": yf}, batch_size=64)
    assert "mae" in est.train_summary[-1]
    assert est.engine.opt.param_groups[0]["lr"] == 0.5
    est2 = Estimator.from_keras(model, loss="sparse_categorical_crossentropy",
                                metrics=["accuracy"], learning_rate=0.25,
                                optimizer="sgd")
    est2.fit({"x": x, "y": y}, batch_size=64)
    assert "accuracy" in est2.train_summary[-1]
    assert est2.engine.opt.param_groups[0]["lr"] == 0.25
    with pytest.raises(ValueError, match="mesh"):
        Estimator.from_keras(model, shard_rules={"kernel": "tp"})


def test_fit_without_compile_raises():
    model = Sequential([L.Dense(2)], **CPU)
    with pytest.raises(RuntimeError, match="compile"):
        model.fit(np.ones((4, 3), np.float32), np.zeros(4, np.int32))


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Sequential([L.Dense(2)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(Input(), L.Dense(2)(Input()))


def _trained(tmp_path=None):
    x, y = _xy()
    model = Sequential([L.Dense(8, activation="relu"), L.Dense(2)], **CPU)
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    est = Estimator.from_keras(model, model_dir=tmp_path and str(tmp_path))
    est.fit({"x": x, "y": y}, epochs=2, batch_size=16)
    return model, est, x


def test_save_then_load_before_fit(tmp_path):
    model, est, x = _trained()
    path = est.save(str(tmp_path / "ckpt"))
    fresh = Estimator.from_keras(model)
    fresh.load(path)                      # queued: no weights yet
    assert fresh.engine is None
    np.testing.assert_array_equal(fresh.predict(x), est.predict(x))
    with pytest.raises(RuntimeError, match="not seen data"):
        Estimator.from_keras(model).save(str(tmp_path / "other"))


def test_resume_latest_before_fit(tmp_path):
    model, est, x = _trained(tmp_path)
    fresh = Estimator.from_keras(model, model_dir=str(tmp_path))
    assert fresh.resume_latest() is not None
    assert fresh.epoch == 2 and fresh.engine is None
    np.testing.assert_array_equal(fresh.predict(x), est.predict(x))


def test_deferred_calls_replay_in_call_order(tmp_path):
    model, est, x = _trained()
    path = est.save(str(tmp_path / "ckpt"))
    zeros = {k: torch.zeros_like(v) for k, v in
             est.get_model().state_dict().items()}
    fresh = Estimator.from_keras(model)
    fresh.set_params(zeros).load(path)    # the load wins
    np.testing.assert_array_equal(fresh.predict(x), est.predict(x))
    fresh = Estimator.from_keras(model)
    fresh.load(path).set_params(zeros)    # the set_params wins
    assert not fresh.predict(x).any()


def test_keras_converters_round_trip():
    """keras_from_flax(keras_to_flax(sd)) is sd, over a graph of every
    kind of module the converter handles, and JAX's tree survives the
    other way, in both block layouts of the encoder."""
    def graph(Lm, eng, M, **kw):
        ids, x, seq = eng.Input(), eng.Input(), eng.Input()
        h = Lm.TransformerLayer(vocab=20, hidden_size=8, n_head=2,
                                seq_len=6, n_block=2)(ids)
        h = Lm.LayerNormalization()(Lm.Select(1, 0)(h))
        c = Lm.GlobalMaxPooling2D()(Lm.BatchNormalization()(
            Lm.Conv2D(4, 3, border_mode="same")(x)))
        r = Lm.Bidirectional(Lm.GRU(3))(Lm.TimeDistributed(Lm.Dense(4))(seq))
        r = Lm.Concat()([r, Lm.LSTM(2)(seq), Lm.SimpleRNN(2)(seq)])
        out = Lm.Dense(2)(Lm.Concat()([h, c, r, Lm.PReLU()(r)]))
        return M([ids, x, seq], out, **kw)

    rng = np.random.default_rng(0)
    xs = [rng.integers(0, 20, (2, 6)).astype(np.int32),
          rng.normal(size=(2, 5, 5, 3)).astype(np.float32),
          rng.normal(size=(2, 4, 3)).astype(np.float32)]
    jax_engine.reset_name_scope()
    jm = graph(JL, jax_engine, jax_keras.Model)
    port_engine.reset_name_scope()
    pm = graph(L, port_engine, Model, **CPU)
    v = jax.jit(jm.to_flax().init)({"params": jax.random.PRNGKey(0),
                                    "dropout": jax.random.PRNGKey(1)}, *xs)
    gm = pm.to_torch().build(*xs)
    sd = keras_from_flax(gm, v["params"], v["batch_stats"])
    gm.load_state_dict(sd)
    for stacked in (True, False):
        params, stats = keras_to_flax(gm, stacked=stacked)
        _assert_trees_close(stats, jax.tree_util.tree_map(
            np.asarray, v["batch_stats"]), 0.0)
        back = keras_from_flax(gm, params, stats)
        assert sorted(back) == sorted(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k
    _assert_trees_close(keras_to_flax(gm)[0], jax.tree_util.tree_map(
        np.asarray, v["params"]), 0.0)
    with pytest.raises(ValueError, match="unknown"):
        keras_from_flax(gm, {**v["params"], "dense_9": {}}, v["batch_stats"])
    with pytest.raises(ValueError, match="missing"):
        keras_from_flax(gm, {k: t for k, t in v["params"].items()
                             if k != "prelu_1"}, v["batch_stats"])


# ----------------------------------------------------------------------
# the autograd vocabulary and CustomLoss (test_keras_layer_breadth.py)
# ----------------------------------------------------------------------

def test_custom_loss_trains_model():
    loss = A.CustomLoss(lambda y_true, y_pred:
                        A.abs(y_true - y_pred[:, 0]) * 2.0)
    x = np.linspace(-1, 1, 128).astype(np.float32)[:, None]
    y = 3.0 * x[:, 0]
    model = Sequential([L.Dense(1)], **CPU)
    est = Estimator.from_keras(model, loss=loss, optimizer="adam",
                               learning_rate=5e-2)
    est.fit({"x": x, "y": y}, epochs=40, batch_size=32)
    assert est.evaluate({"x": x, "y": y}, batch_size=32)["loss"] < 0.3


def test_custom_loss_rejects_scalar_expressions():
    loss = A.CustomLoss(lambda t, p: A.mean(A.abs(t - p)))
    with pytest.raises(ValueError, match="PER-EXAMPLE"):
        loss(torch.ones(4), torch.zeros(4))


def test_autograd_vocabulary_matches_jax():
    from analytics_zoo_tpu.keras import autograd as JA
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(4, 2)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    cases = {
        "mean": ((a,), {"axis": 1}), "sum": ((a,), {}), "abs": ((a,), {}),
        "square": ((a,), {}), "exp": ((a,), {}), "softsign": ((a,), {}),
        "softplus": ((a,), {}), "l2_normalize": ((a,), {"axis": 0}),
        "mm": ((a, b), {}), "dot": ((a, b), {}),
        "maximum": ((a, 0.1), {}), "minimum": ((a, a[::-1].copy()), {}),
        "clip": ((a, -0.5, 0.5), {}), "expand_dims": ((a, 1), {}),
        "pow": ((np.abs(a), 1.5), {}), "sqrt": ((np.abs(a),), {}),
        "log": ((np.abs(a) + 0.1,), {}),
    }
    for name, (args, kw) in cases.items():
        want = np.asarray(getattr(JA, name)(*args, **kw))
        targs = [torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                 for x in args]
        got = getattr(A, name)(*targs, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    got = A.stack([ta, ta], axis=1).numpy()
    np.testing.assert_array_equal(got, np.asarray(JA.stack([a, a], axis=1)))
    assert A.epsilon() == JA.epsilon()
    del tb
