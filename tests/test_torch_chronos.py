"""The port's Chronos AutoTS path against the JAX package's: TSDataset
on the same DataFrames; the TCN, LSTM and Seq2Seq forecasters on the
same weights (carried across by `convert.*_forecaster_from_flax`):
predictions within 1e-5 x max(1, |JAX|) and the first step's
gradients, with dropout 0, within 1e-4 of each tensor's largest;
save / load; `AutoTSEstimator`'s trial configs and its `TSPipeline`;
and the import path with no pandas.  One JAX program a forecaster
gives its predictions, loss and gradients.  The tests run at one torch
thread (`one_torch_thread`, `_torch_chronos_cases.py`)."""

import os
import pickle
import subprocess
import sys
from functools import lru_cache

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from analytics_zoo_tpu.chronos.autots import autotsestimator as jax_autots
from analytics_zoo_tpu.chronos.autots import AutoTSEstimator as JaxAutoTS
from analytics_zoo_tpu.chronos.data import TSDataset as JaxTSDataset
from analytics_zoo_tpu.chronos import forecaster as jax_fc
from analytics_zoo_tpu.orca.automl import hp as jax_hp
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.chronos import forecaster as port_fc
from analytics_zoo_tpu_torch.chronos.autots import (
    AutoTSEstimator,
    TSPipeline,
)
from analytics_zoo_tpu_torch.chronos.autots import autotsestimator
from analytics_zoo_tpu_torch.chronos.data import TSDataset
from analytics_zoo_tpu_torch.orca.automl import hp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: f32 predictions: |port - JAX| <= TOL * max(1, |JAX|)
TOL = 1e-5
#: first-step gradients: |port - JAX| <= GRAD_TOL * max |JAX| per tensor
GRAD_TOL = 1e-4


def _series_df(n=200, ids=None, seed=0):
    t = pd.date_range("2020-01-01", periods=n, freq="h")
    rng = np.random.default_rng(seed)

    def one(i=None):
        df = pd.DataFrame({
            "ts": t,
            "value": np.sin(np.arange(n) / 12) + 0.05 * rng.normal(size=n),
            "extra": rng.normal(size=n)})
        if i is not None:
            df["id"] = i
        return df
    if ids:
        return pd.concat([one(i) for i in ids], ignore_index=True)
    return one()


# ----------------------------------------------------------------------
# TSDataset
# ----------------------------------------------------------------------

def _split(cls):
    parts = cls.from_pandas(_series_df(200, ids=["a", "b"]), dt_col="ts",
                            target_col="value", id_col="id",
                            extra_feature_col="extra", with_split=True,
                            val_ratio=0.1, test_ratio=0.2)
    out = [p.df for p in parts]
    train = parts[0].roll(lookback=24, horizon=2)
    return out + list(train.to_numpy())


def _clean(cls):
    df = _series_df(100)
    df.loc[5, "value"] = np.nan
    df.loc[[0, 40, 41], "extra"] = np.nan
    df = pd.concat([df, df.iloc[[10, 30]]], ignore_index=True)
    out = []
    for mode in ("last", "const", "linear"):
        ts = cls.from_pandas(df, dt_col="ts", target_col="value",
                             extra_feature_col="extra")
        ts.deduplicate().impute(mode=mode, const_num=-1.0)
        out.append(ts.df)
    ts.resample("2h")
    out.append(ts.df)
    ts.resample("3h", merge_mode="max")
    return out + [ts.df]


def _features(cls):
    ts = cls.from_pandas(_series_df(60, ids=["a", "b"]), dt_col="ts",
                         target_col="value", id_col="id",
                         extra_feature_col="extra")
    ts.gen_dt_feature()
    ts.gen_dt_feature(["HOUR", "IS_WEEKEND", "MINUTE"],
                      one_hot_features=["WEEKDAY", "IS_AWAKE"])
    ts.gen_rolling_feature(4)
    ts.gen_rolling_feature(3, settings=["median", "sum"])
    for settings in ("minimal", "efficient", "comprehensive"):
        ts.gen_global_feature(settings=settings)
    ts.impute("const", 0.0)
    x, y = ts.roll(lookback=12, horizon=1).to_numpy()
    return [ts.df, list(ts.feature_col), x, y, ts.input_feature_num,
            ts.output_target_num]


def _scaling(cls):
    from sklearn.preprocessing import MinMaxScaler
    out = []
    for scaler in (None, MinMaxScaler()):
        df = _series_df(100)
        df["value"] = df["value"] * 10 + 100
        ts = cls.from_pandas(df, dt_col="ts", target_col="value",
                             extra_feature_col="extra")
        ts.scale(scaler)
        out.append(ts.df.copy())
        out.append(ts.unscale_numpy(
            ts.df["value"].to_numpy()[:12].reshape(2, 6, 1)))
        out.append(ts.unscale().df)
    return out


def _rolls(cls):
    ts = cls.from_pandas(_series_df(80), dt_col="ts", target_col="value",
                         extra_feature_col="extra")
    out = []
    for lookback, horizon in ((10, 3), (6, [1, 4]), (5, 0)):
        x, y = ts.roll(lookback, horizon).to_numpy()
        out += [x, y]
    x, y = ts.roll(8, 2, feature_col=[], target_col=["extra"]).to_numpy()
    batches = list(ts.to_loader(batch_size=16, roll=True, lookback=10,
                                horizon=2, shuffle=True, seed=3))
    full = list(ts.to_loader(batch_size=16, drop_last=True, shuffle=False))
    return out + [x, y] + [a for b in batches + full for a in b]


def _parquet(cls, tmp_path):
    p = str(tmp_path / f"{cls.__module__.split('.')[0]}.parquet")
    _series_df(60).to_parquet(p)
    ts = cls.from_parquet(p, dt_col="ts", target_col="value",
                          extra_feature_col="extra")
    parts = cls.from_parquet(p, dt_col="ts", target_col="value",
                             with_split=True, test_ratio=0.25)
    return [ts.df, list(ts.feature_col),
            *ts.roll(lookback=12, horizon=3).to_numpy(),
            *[q.df for q in parts]]


TS_CASES = {"split": _split, "clean": _clean, "features": _features,
            "scaling": _scaling, "rolls": _rolls, "parquet": _parquet}


def _same(got, want):
    assert type(got) is type(want) or np.isscalar(got)
    if isinstance(got, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    elif isinstance(got, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("case", sorted(TS_CASES))
def test_tsdataset_equals_jax(case, tmp_path):
    fn = TS_CASES[case]
    args = (tmp_path,) if case == "parquet" else ()
    got, want = fn(TSDataset, *args), fn(JaxTSDataset, *args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def test_tsdataset_refusals_as_jax():
    def calls(cls):
        ts = cls.from_pandas(_series_df(20), dt_col="ts", target_col="value")
        return [lambda: ts.impute(mode="mean"),
                lambda: ts.gen_dt_feature(["CENTURY"]),
                lambda: ts.gen_dt_feature(["YEAR"], one_hot_features=["YEAR"]),
                lambda: ts.gen_rolling_feature(3, settings="bogus"),
                lambda: ts.gen_global_feature(settings="bogus"),
                lambda: ts.roll(lookback=20, horizon=1),
                lambda: ts.to_loader(roll=True),
                lambda: cls.from_pandas(_series_df(20), "ts",
                                        "value").unscale(),
                lambda: cls.from_pandas(_series_df(20), "ts",
                                        "value").to_numpy()]
    for got, want in zip(calls(TSDataset), calls(JaxTSDataset)):
        with pytest.raises(Exception) as w:
            want()
        with pytest.raises(type(w.value)) as g:
            got()
        assert str(g.value) == str(w.value)


# ----------------------------------------------------------------------
# forecasters
# ----------------------------------------------------------------------

#: (JAX class, port class, keywords, converter): small widths, two
#: features in and out, dropout 0 for the gradient comparison
FORECASTERS = {
    "tcn": (jax_fc.TCNForecaster, port_fc.TCNForecaster,
            dict(past_seq_len=10, future_seq_len=2, num_channels=[4, 6],
                 kernel_size=3, dropout=0.0),
            convert.tcn_forecaster_from_flax, convert.tcn_forecaster_to_flax),
    "lstm": (jax_fc.LSTMForecaster, port_fc.LSTMForecaster,
             dict(past_seq_len=10, future_seq_len=2, hidden_dim=[5, 4],
                  dropout=0.0),
             convert.lstm_forecaster_from_flax,
             convert.lstm_forecaster_to_flax),
    "seq2seq": (jax_fc.Seq2SeqForecaster, port_fc.Seq2SeqForecaster,
                dict(past_seq_len=10, future_seq_len=3, lstm_hidden_dim=5,
                     lstm_layer_num=2),
                convert.seq2seq_forecaster_from_flax,
                convert.seq2seq_forecaster_to_flax),
}
FEATURES = dict(input_feature_num=2, output_feature_num=2)


def _windows(name, n=24, seed=0):
    kw = FORECASTERS[name][2]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, kw["past_seq_len"], 2)).astype(np.float32)
    y = rng.normal(size=(n, kw["future_seq_len"], 2)).astype(np.float32)
    return x, y


@lru_cache(maxsize=None)
def jax_reference(name):
    """(flax params as numpy, predictions, loss, gradients as numpy) of
    the JAX forecaster's module on `_windows(name)`, from one jitted
    program."""
    jax_cls, _, kw, _, _ = FORECASTERS[name]
    module = jax_cls(**kw, **FEATURES)._build_module()
    x, y = _windows(name)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    @jax.jit
    def run(p):
        def loss(p):
            out = module.apply({"params": p}, x)
            return jnp.mean((out - y) ** 2), out
        (value, out), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return out, value, grads

    out, value, grads = run(params)
    to_np = jax.tree_util.tree_map(np.asarray, (params, out, value, grads))
    return to_np


def _port(name, **extra):
    _, port_cls, kw, _, _ = FORECASTERS[name]
    return port_cls(**dict(kw, **extra), **FEATURES, device="cpu")


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bound = tol * np.maximum(1.0, np.abs(want))
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


@pytest.mark.parametrize("name", sorted(FORECASTERS))
def test_forecaster_matches_jax(name):
    params, want, want_loss, want_grads = jax_reference(name)
    _, _, _, from_flax, to_flax = FORECASTERS[name]
    fc = _port(name)
    fc._estimator().set_params(from_flax(params))
    x, y = _windows(name)
    # predictions through the forecaster's Estimator, in ragged batches
    _close(fc.predict((x, None), batch_size=7), want, TOL)
    # the first step's loss and gradients on the module
    model = fc._estimator().get_model()
    model.train()
    out = model(torch.from_numpy(x))
    loss = ((out - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    _close(loss.item(), want_loss, TOL)
    grads = to_flax({k: p.grad for k, p in model.named_parameters()})
    got_leaves = jax.tree_util.tree_leaves_with_path(grads)
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    assert len(got_leaves) == len(want_leaves)
    for path, g in got_leaves:
        w = want_leaves[path]
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= GRAD_TOL * scale, (path, scale)
    # the converters are each other's inverse
    back = to_flax(model.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_lstm_dropout_follows_every_layer():
    """JAX drops after every layer whose rate is nonzero, the last one
    included (torch's nn.LSTM(dropout=) would skip the last)."""
    fc = _port("lstm", dropout=[0.0, 0.5])
    model = fc._estimator().get_model()
    x = torch.from_numpy(_windows("lstm")[0])
    model.eval()
    ref = model(x)
    model.train()
    gen = torch.Generator().manual_seed(0)
    assert not torch.equal(model(x, generator=gen), ref)
    fc = _port("lstm", dropout=[0.5, 0.0])
    model = fc._estimator().get_model()
    model.train()
    assert not torch.equal(model(x, generator=gen),
                           model.eval()(x))
    assert fc.dropout == [0.5, 0.0] and fc._config()["layer_num"] == 2


@pytest.mark.parametrize("name", sorted(FORECASTERS))
def test_forecaster_fits_saves_and_loads(name, tmp_path):
    x, y = _windows(name, n=64, seed=1)
    fc = _port(name, lr=1e-2)
    fc.fit((x, y), epochs=3, batch_size=32)
    est = fc._estimator()
    losses = [s["loss"] for s in est.train_summary]
    assert len(losses) == 3 and losses[-1] < losses[0]
    stats = fc.evaluate({"x": x, "y": y})
    assert set(stats) == {"loss", "mse"}
    path = fc.save(str(tmp_path / f"{name}.pkl"))
    with open(path, "rb") as f:
        payload = pickle.load(f)
    # torch's layout, as numpy
    assert payload["class"] == type(fc).__name__
    sd = fc._estimator().get_model().state_dict()
    assert set(payload["params"]) == set(sd)
    for k, v in payload["params"].items():
        assert isinstance(v, np.ndarray) and v.shape == tuple(sd[k].shape)
    loaded = type(fc).load(path, device="cpu")
    np.testing.assert_array_equal(loaded.predict((x, None)),
                                  fc.predict((x, None)))
    assert loaded._config() == fc._config()
    # an unfitted forecaster saves no parameters
    empty = _port(name).save(str(tmp_path / "empty.pkl"))
    assert type(fc).load(empty, device="cpu")._est is None


def test_tsdataset_input_and_the_roll_cache():
    """JAX's `test_predict_roll_does_not_poison_fit` and the TSDataset
    input paths of `test_tcn_forecaster_and_save_load`."""
    ts = TSDataset.from_pandas(_series_df(120), dt_col="ts",
                               target_col="value")
    fc = port_fc.LSTMForecaster(past_seq_len=12, input_feature_num=1,
                                output_feature_num=1, hidden_dim=8,
                                lr=1e-2, device="cpu")
    preds = fc.predict(ts)
    assert preds.shape == (120 - 12 + 1, 1, 1)
    assert (ts.lookback, ts.horizon) == (12, 0)
    fc.fit(ts, epochs=1, batch_size=32)         # re-rolls at horizon 1
    assert (ts.lookback, ts.horizon) == (12, 1)
    assert "mse" in fc.evaluate(ts)
    tcn = port_fc.TCNForecaster(past_seq_len=24, future_seq_len=2,
                                num_channels=[8, 8], device="cpu")
    tcn.fit(ts, epochs=1, batch_size=32)
    assert tcn.predict(ts).shape == (120 - 24 + 1, 2, 1)


def test_xshards_input_and_no_card_refused(monkeypatch):
    """An XShardsTSDataset streams into fit / evaluate / predict (it
    was refused before the rest of Chronos was ported); without a card
    the forecasters and AutoTS refuse to start."""
    from analytics_zoo_tpu_torch.chronos.data.experimental import (
        XShardsTSDataset,
    )
    df = _series_df(40, ids=["a", "b"]).drop(columns="extra")
    ds = XShardsTSDataset.from_pandas(df, dt_col="ts", target_col="value",
                                      id_col="id", num_shards=2)
    ds.roll(6, 1)
    fc = port_fc.TCNForecaster(past_seq_len=10, future_seq_len=2,
                               num_channels=[4], device="cpu")
    fc.fit(ds, epochs=1, batch_size=16)
    assert set(fc.evaluate(ds)) == {"loss", "mse"}
    assert fc.predict(ds).shape == (2 * (40 - 10 + 1), 2, 1)
    # the forecaster's rolls leave the caller's as it was
    assert (ds.lookback, ds.horizon) == (6, 1)
    with pytest.raises(ValueError, match="requires targets"):
        fc.fit((np.zeros((2, 10, 2), np.float32), None))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in FORECASTERS:
        _, port_cls, kw, _, _ = FORECASTERS[name]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cls(**kw, **FEATURES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AutoTSEstimator(model="tcn")


# ----------------------------------------------------------------------
# AutoTS
# ----------------------------------------------------------------------

@pytest.mark.parametrize("model", ["lstm", "tcn", "seq2seq", "arima",
                                   "prophet"])
def test_default_space_equals_jax(model):
    import random

    got = autotsestimator._default_space(model)
    want = jax_autots._default_space(model)
    assert got.keys() == want.keys()
    r1, r2 = random.Random(4), random.Random(4)
    assert [hp.sample_config(got, r1) for _ in range(20)] == \
        [jax_hp.sample_config(want, r2) for _ in range(20)]
    # the classical legs take their default spaces too (they were
    # refused before their forecasters were ported)
    assert AutoTSEstimator(model=model, device="cpu").search_space.keys() \
        == want.keys()


def test_autots_trial_configs_equal_jax_and_the_pipeline_round_trips(
        tmp_path):
    """The same search through both packages' AutoTSEstimator: the same
    trial configs (sampling is pure Python); the port's pipeline
    predicts as its best forecaster and survives save / load."""
    def split(cls):
        df = _series_df(160)
        df["value"] = df["value"] * 10 + 100
        train, _, test = cls.from_pandas(
            df, dt_col="ts", target_col="value", with_split=True,
            test_ratio=0.2)
        train.scale()
        test.scale(train.scaler, fit=False)
        return train, test

    def space(mod):
        return {"hidden_units": mod.choice([4, 6]), "levels": 2,
                "kernel_size": mod.choice([2, 3]),
                "lr": mod.loguniform(5e-3, 2e-2), "dropout": 0.0}

    train, test = split(JaxTSDataset)
    want = JaxAutoTS(model="tcn", past_seq_len=12, search_space=space(
        jax_hp))
    want.fit(train, epochs=1, n_sampling=2, batch_size=32)
    train, test = split(TSDataset)
    auto = AutoTSEstimator(model="tcn", past_seq_len=12,
                           search_space=space(hp), device="cpu")
    pipe = auto.fit(train, epochs=1, n_sampling=2, batch_size=32)
    assert [r["config"] for r in auto._trials] == \
        [r["config"] for r in want._trials]
    assert auto.get_best_config() in [r["config"] for r in auto._trials]
    assert isinstance(pipe, TSPipeline)
    assert isinstance(pipe.forecaster, port_fc.TCNForecaster)
    assert pipe.forecaster.device == torch.device("cpu")
    # predictions in the data's units: the best forecaster's, unscaled
    x, _ = test.roll(12, 1).to_numpy()
    preds = pipe.predict(test)
    raw = pipe.forecaster.predict((x, None))
    np.testing.assert_allclose(preds, test.unscale_numpy(raw), rtol=1e-6)
    assert 80 < float(np.median(preds)) < 120
    stats = pipe.evaluate(test)
    assert set(stats) == {"mse", "mae"} and stats["mse"] < 100
    pipe.save(str(tmp_path / "pipe"))
    loaded = TSPipeline.load(str(tmp_path / "pipe"), device="cpu")
    np.testing.assert_array_equal(loaded.predict(test), preds)
    assert loaded.best_config == pipe.best_config
    # fit on, through the pipeline
    pipe.fit(train, epochs=1, batch_size=32)
    assert len(pipe.forecaster._estimator().train_summary) == 2


def test_autots_lstm_and_seq2seq_on_numpy():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 8, 1)).astype(np.float32)
    y = x[:, -1:, :] * 0.5
    for model, space in (("lstm", {"hidden_dim": 4, "layer_num":
                                   hp.choice([1, 2]), "lr": 1e-2,
                                   "dropout": 0.1}),
                         ("seq2seq", {"lstm_hidden_dim": 4,
                                      "lstm_layer_num": 1, "lr": 1e-2})):
        auto = AutoTSEstimator(model=model, past_seq_len=8,
                               search_space=space, device="cpu")
        pipe = auto.fit((x, y), epochs=2, n_sampling=2, batch_size=16)
        assert pipe.scaler is None and auto.input_feature_num == 1
        assert pipe.predict((x, None)).shape == (64, 1, 1)
        assert "mse" in pipe.evaluate((x, y))


_NO_PANDAS = r"""
import sys
sys.modules["pandas"] = None        # any import of pandas now fails
sys.modules["sklearn"] = None
import numpy as np
import torch
torch.set_num_threads(1)
from analytics_zoo_tpu_torch.chronos.forecaster import (
    ARIMAForecaster, LSTMForecaster, MTNetForecaster, ProphetForecaster,
    Seq2SeqForecaster, TCMFForecaster, TCNForecaster)
from analytics_zoo_tpu_torch.chronos.autots import (
    AutoTSEstimator, TSPipeline)
from analytics_zoo_tpu_torch.chronos.autots.model import AutoARIMA
from analytics_zoo_tpu_torch.chronos.detector.anomaly import (
    AEDetector, DBScanDetector, ThresholdDetector)
from analytics_zoo_tpu_torch.chronos.simulator import DPGANSimulator
from analytics_zoo_tpu_torch.orca.automl import AutoEstimator, hp
from analytics_zoo_tpu_torch.orca.automl.gbdt import (
    GBDTRegressor, xgboost_backend)
from analytics_zoo_tpu_torch.orca.automl.xgboost import AutoXGBRegressor
from analytics_zoo_tpu_torch.chronos import data
from analytics_zoo_tpu_torch.chronos.data import experimental
rng = np.random.default_rng(0)
series = np.sin(np.arange(200) / 6).astype(np.float32)
idx = np.arange(24)[None] + np.arange(176)[:, None]
x, y = series[idx][..., None], series[idx[:, -1] + 1][:, None, None]
fc = TCNForecaster(past_seq_len=24, num_channels=[8, 8], lr=1e-2,
                   device="cpu").fit((x, y), epochs=2, batch_size=32)
assert fc.predict((x, None)).shape == (176, 1, 1)
pipe = AutoTSEstimator(model="tcn", past_seq_len=24, device="cpu",
                       search_space={"hidden_units": 4, "levels": 2,
                                     "lr": hp.choice([1e-2, 5e-3])}).fit(
    (x, y), epochs=1, n_sampling=2)
assert isinstance(pipe, TSPipeline)
# the rest of Chronos and AutoML, Prophet, DBSCAN and XShards aside
mt = MTNetForecaster(long_series_num=2, series_length=8, cnn_hid_size=4,
                     rnn_hid_size=4, device="cpu").fit((x, y), epochs=1)
assert mt.predict((x, None)).shape == (176, 1, 1)
tcmf = TCMFForecaster(rank=2, tcn_lookback=6, num_channels_X=(4,),
                      num_channels_Y=(4,), device="cpu").fit(
    {"y": np.stack([series, np.cos(np.arange(200) / 5)])[:, :60]},
    epochs=2)
assert tcmf.predict(horizon=3).shape == (2, 3)
taxi = 100 + 10 * np.sin(2 * np.pi * np.arange(200) / 7) \
    + rng.normal(size=200)
assert ARIMAForecaster(p=1, q=1, m=7).fit(taxi[:-14], taxi[-14:])["mse"] > 0
best = AutoARIMA(m=7).fit(taxi[:-14], taxi[-14:], n_sampling=2)
assert best.get_best_model().predict(14).shape == (14,)
arima = AutoTSEstimator(model="arima", device="cpu").fit(
    taxi[:-14], validation_data=taxi[-14:], n_sampling=2)
assert set(arima.evaluate(taxi[-14:])) == {"mse", "mae"}
lags = np.stack([taxi[i:i + 176] for i in range(24)], axis=1)
xgb = AutoXGBRegressor().fit((lags, taxi[24:]), search_space={
    "max_depth": hp.choice([2, 3])}, n_sampling=2, rounds_per_epoch=5)
assert xgboost_backend().GBDTRegressor is GBDTRegressor
assert xgb.predict(lags).shape == (176,)
spiky = series.copy()
spiky[100] = 8.0
assert 100 in ThresholdDetector().set_params(threshold=(-2, 2)).fit(
    spiky).anomaly_indexes()
ae = AEDetector(roll_len=10, epochs=1, device="cpu").fit(spiky)
assert ae.score().shape == (200,)
sim = DPGANSimulator(seq_len=24, feature_dim=1, noise_dim=4, hidden=8,
                     device="cpu").fit(x, epochs=1, batch_size=64)
assert sim.generate(4)[1].shape == (4, 24, 1)
assert ProphetForecaster()._state is None
print("OK", sys.modules["pandas"], sys.modules["sklearn"])
"""


def test_chronos_runs_without_pandas():
    """A fresh interpreter where `import pandas` (and sklearn) fails:
    the forecasters, AutoTS and the search engine import, and a TCN and
    a TCN search fit on numpy windows on the CPU; so do MTNet, TCMF,
    ARIMA with AutoARIMA and AutoTS's ARIMA leg, AutoXGBoost's GBDT,
    the threshold and AE detectors and the simulator (Prophet, DBSCAN
    and XShardsTSDataset import, and need pandas or sklearn to run)."""
    out = subprocess.run([sys.executable, "-c", _NO_PANDAS], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "OK None None"
