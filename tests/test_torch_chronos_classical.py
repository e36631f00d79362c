"""The port's host-side Chronos and AutoML against the JAX package's:
the native SARIMA, Prophet, their searches (AutoARIMA, AutoProphet) and
AutoTSEstimator's classical legs with their TSPipeline, the histogram
GBDT and AutoXGBoost, the threshold and DBSCAN detectors.  Both
packages run the same numpy and scipy code on the same float64 data,
so each output here equals JAX's exactly (`assert_array_equal`,
`assert_frame_equal(check_exact=True)`, trial tables with ==); none
needed the 1e-12 relative fallback scipy's optimizer might have called
for.  The AE detector's autoencoder on JAX's weights: scores within
1e-5 x max(1, |JAX|), the same anomaly indexes, the first step's
gradients within 1e-4 of each tensor's largest."""

from functools import lru_cache

import numpy as np
import pandas as pd
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from _torch_chronos_cases import (  # noqa: F401
    close,
    grads_close,
    one_torch_thread,
    same,
)
from analytics_zoo_tpu.chronos.autots import AutoTSEstimator as JaxAutoTS
from analytics_zoo_tpu.chronos.autots import TSPipeline as JaxPipeline
from analytics_zoo_tpu.chronos.autots.model import (
    AutoARIMA as JaxAutoARIMA,
    AutoProphet as JaxAutoProphet,
)
from analytics_zoo_tpu.chronos.data import TSDataset as JaxTSDataset
from analytics_zoo_tpu.chronos.detector.anomaly import detectors as jax_det
from analytics_zoo_tpu.chronos.forecaster import arima_forecaster as jax_arima
from analytics_zoo_tpu.chronos.forecaster import (
    prophet_forecaster as jax_prophet,
)
from analytics_zoo_tpu.orca.automl import gbdt as jax_gbdt
from analytics_zoo_tpu.orca.automl import hp as jax_hp
from analytics_zoo_tpu.orca.automl import xgboost as jax_xgb
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.chronos.autots import AutoTSEstimator
from analytics_zoo_tpu_torch.chronos.autots import TSPipeline
from analytics_zoo_tpu_torch.chronos.autots.model import (
    AutoARIMA,
    AutoProphet,
)
from analytics_zoo_tpu_torch.chronos.data import TSDataset
from analytics_zoo_tpu_torch.chronos.detector.anomaly import detectors
from analytics_zoo_tpu_torch.chronos.forecaster import arima_forecaster
from analytics_zoo_tpu_torch.chronos.forecaster import prophet_forecaster
from analytics_zoo_tpu_torch.orca.automl import gbdt, hp
from analytics_zoo_tpu_torch.orca.automl import xgboost as port_xgb


def _taxi_like(n=400, m=7, seed=0):
    """Trend, a weekly season and AR(1) noise (JAX's test_arima.py
    series, the nyc-taxi shape)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    season = 10.0 * np.sin(2 * np.pi * t / m) + 4.0 * np.cos(4 * np.pi * t / m)
    noise = np.zeros(n)
    e = rng.normal(0, 1.0, n)
    for i in range(1, n):
        noise[i] = 0.6 * noise[i - 1] + e[i]
    return 100.0 + 0.05 * t + season + noise


def _frame(n=300, seed=8, freq="D"):
    return pd.DataFrame({"ds": pd.date_range("2021-01-01", periods=n,
                                             freq=freq),
                         "y": _taxi_like(n=n, seed=seed)})


# ----------------------------------------------------------------------
# ARIMA
# ----------------------------------------------------------------------

def test_arima_helpers_equal_jax():
    rng = np.random.default_rng(1)
    for _ in range(10):
        raw = rng.normal(0, 3.0, rng.integers(1, 5))
        same(arima_forecaster._pacf_to_ar(raw), jax_arima._pacf_to_ar(raw))
    same(arima_forecaster._poly_mul_seasonal([0.5, -0.2], [0.3], 4),
           jax_arima._poly_mul_seasonal([0.5, -0.2], [0.3], 4))
    for y in (rng.normal(size=300), np.cumsum(rng.normal(size=300)),
              np.tile(rng.normal(0, 5, 7), 40) + rng.normal(0, .3, 280)):
        assert arima_forecaster._estimate_d(y) == jax_arima._estimate_d(y)
        assert arima_forecaster._estimate_D(y, 7) == \
            jax_arima._estimate_D(y, 7)


def _arima_run(mod, cfg, y, tmp_path):
    fc = mod.ARIMAForecaster(**cfg)
    out = [fc.fit(y[:-14], y[-14:]), fc.predict(14),
           fc.predict(14, with_interval=True), fc.predict(7, rolling=True),
           fc.evaluate(y[-14:], metrics=["mse", "mae"]),
           fc.evaluate(y[-14:], metrics=["mse"], rolling=True)]
    fc.model.extend(y[-14:-10])
    out.append(fc.predict(3))
    fc.save(str(tmp_path / f"{mod.__name__}.pkl"))
    return fc, out


@pytest.mark.parametrize("cfg", [
    dict(p=2, q=1, P=1, Q=0, m=7), dict(p=1, q=1, seasonality_mode=False),
    dict(p=0, q=0, P=0, Q=0, d=1, D=1)], ids=["seasonal", "plain", "none"])
def test_arima_forecaster_equals_jax(cfg, tmp_path):
    y = _taxi_like(seed=4)
    fc, got = _arima_run(arima_forecaster, cfg, y, tmp_path)
    jfc, want = _arima_run(jax_arima, cfg, y, tmp_path)
    same(got, want)
    # a checkpoint of either package restores in the port
    for path in tmp_path.iterdir():
        loaded = arima_forecaster.ARIMAForecaster.load(str(path),
                                                       device="cpu")
        same(loaded.predict(5), jfc.predict(5))
    for call in (lambda m: m.ARIMAForecaster().predict(3),
                 lambda m: m.ARIMAForecaster().evaluate([1.0]),
                 lambda m: m._SARIMA(3, 0, 3, 1, 0, 1, 7).fit(y[:20])):
        with pytest.raises(Exception) as w:
            call(jax_arima)
        with pytest.raises(type(w.value)) as g:
            call(arima_forecaster)
        assert str(g.value) == str(w.value)


def _search(auto, *args, **kw):
    auto.fit(*args, **kw)
    return auto


def test_auto_arima_equals_jax():
    y = _taxi_like(seed=6)
    got = _search(AutoARIMA(m=7), y[:-28], y[-28:], n_sampling=4)
    want = _search(JaxAutoARIMA(m=7), y[:-28], y[-28:], n_sampling=4)
    assert got._trials == want._trials
    assert got.get_best_config() == want.get_best_config()
    same(got.get_best_model().predict(28),
           want.get_best_model().predict(28))


# ----------------------------------------------------------------------
# Prophet
# ----------------------------------------------------------------------

def _holidays():
    days = pd.date_range("2021-01-01", periods=12, freq="30D")
    return pd.concat([
        pd.DataFrame({"holiday": "payday", "ds": days, "lower_window": 0,
                      "upper_window": 1}),
        pd.DataFrame({"holiday": "xmas",
                      "ds": pd.to_datetime(["2021-12-25"])})],
        ignore_index=True)


PROPHET_CASES = {
    "additive": (dict(), dict()),
    "multiplicative": (dict(seasonality_mode="multiplicative"), dict()),
    "holidays": (dict(holidays=_holidays(), holidays_prior_scale=3.0),
                 dict(n=360, seed=11)),
    "hourly": (dict(daily_seasonality=True), dict(n=240, freq="h")),
}


def _prophet_run(mod, case, tmp_path):
    kw, data = PROPHET_CASES[case]
    df = _frame(**data)
    train, test = df.iloc[:-28], df.iloc[-28:]
    fc = mod.ProphetForecaster(**kw)
    out = [fc.fit(train, test), fc.predict(horizon=28),
           fc.predict(horizon=5, freq="D"),
           fc.evaluate(test, metrics=["mse", "mae", "smape"]),
           fc.fit(df)]
    path = str(tmp_path / f"{mod.__name__}.pkl")
    fc.save(path)
    return path, out


@pytest.mark.parametrize("case", sorted(PROPHET_CASES))
def test_prophet_forecaster_equals_jax(case, tmp_path):
    path, got = _prophet_run(prophet_forecaster, case, tmp_path)
    jpath, want = _prophet_run(jax_prophet, case, tmp_path)
    same(got, want)
    loaded = prophet_forecaster.ProphetForecaster.load(jpath, device="cpu")
    same(loaded.predict(7), jax_prophet.ProphetForecaster.load(
        path).predict(7))


def test_prophet_refusals_as_jax():
    df = _frame(n=40)
    neg = df.assign(y=-df["y"])
    for call in (
            lambda m: m.ProphetForecaster().predict(3),
            lambda m: m.ProphetForecaster().fit(
                df.rename(columns={"y": "v"})),
            lambda m: m.ProphetForecaster(seasonality_mode="divisive"),
            lambda m: m.ProphetForecaster(holidays=df),
            lambda m: m.ProphetForecaster(
                seasonality_mode="multiplicative").fit(neg),
            lambda m: m.ProphetForecaster._holiday_cols(pd.DataFrame({
                "holiday": "bad", "ds": pd.to_datetime(["2021-01-01"]),
                "lower_window": 1, "upper_window": 0}))):
        with pytest.raises(Exception) as w:
            call(jax_prophet)
        with pytest.raises(type(w.value)) as g:
            call(prophet_forecaster)
        assert str(g.value) == str(w.value)


def test_auto_prophet_equals_jax():
    df = _frame(n=250, seed=10)
    args = (df.iloc[:-21], df.iloc[-21:])
    got = _search(AutoProphet(), *args, n_sampling=3)
    want = _search(JaxAutoProphet(), *args, n_sampling=3)
    assert got._trials == want._trials
    assert got.get_best_config() == want.get_best_config()
    same(got.get_best_model().predict(21),
           want.get_best_model().predict(21))


# ----------------------------------------------------------------------
# AutoTSEstimator's classical legs
# ----------------------------------------------------------------------

def _leg(model, tsd_cls, auto_cls, tmp_path, **device):
    y = _taxi_like(seed=7)
    df = pd.DataFrame({"dt": pd.date_range("2020-01-01", periods=len(y),
                                           freq="D"), "value": y})
    train = tsd_cls.from_pandas(df.iloc[:-28], dt_col="dt",
                                target_col="value")
    val = tsd_cls.from_pandas(df.iloc[-28:], dt_col="dt",
                              target_col="value")
    est = auto_cls(model=model, metric="mse", **device)
    pipe = est.fit(train, validation_data=val, n_sampling=3)
    path = pipe.save(str(tmp_path / f"{auto_cls.__module__}-{model}"))
    return est, pipe, path, [pipe.predict(28), pipe.evaluate(val)]


@pytest.mark.parametrize("model", ["arima", "prophet"])
def test_autots_classical_legs_equal_jax(model, tmp_path):
    """AutoTSEstimator(model="arima" | "prophet").fit returns a
    TSPipeline whose predict and evaluate equal JAX's on the same
    series, and that survives save / load."""
    est, pipe, path, got = _leg(model, TSDataset, AutoTSEstimator,
                                tmp_path, device="cpu")
    jest, jpipe, _, want = _leg(model, JaxTSDataset, JaxAutoTS, tmp_path)
    assert est._trials == jest._trials
    assert est.get_best_config() == jest.get_best_config()
    same(got, want)
    assert type(pipe.forecaster).__name__ == (
        "ARIMAForecaster" if model == "arima" else "ProphetForecaster")
    loaded = TSPipeline.load(path, device="cpu")
    same(loaded.predict(28), got[0])
    # the pipeline fits on, on the raw series
    data = (_taxi_like(seed=9) if model == "arima" else _frame(seed=9))
    same(pipe.fit(data).predict(7), jpipe.fit(data).predict(7))
    assert isinstance(jpipe, JaxPipeline)


def test_autots_classical_refusals_as_jax():
    df = _frame(n=100)
    scaled = JaxTSDataset.from_pandas(df, dt_col="ds", target_col="y")
    scaled.scale()
    port_scaled = TSDataset.from_pandas(df, dt_col="ds", target_col="y")
    port_scaled.scale()
    cases = [
        (lambda: JaxAutoTS(model="prophet", search_space={
            "n_changepoints": jax_hp.randint(5, 50)}).fit(df, n_sampling=1),
         lambda: AutoTSEstimator(model="prophet", device="cpu",
                                 search_space={"n_changepoints":
                                               hp.randint(5, 50)}).fit(
             df, n_sampling=1)),
        (lambda: JaxAutoTS(model="arima").fit(scaled),
         lambda: AutoTSEstimator(model="arima", device="cpu").fit(
             port_scaled)),
        (lambda: JaxAutoTS(model="prophet").fit(df[["y"]]),
         lambda: AutoTSEstimator(model="prophet", device="cpu").fit(
             df[["y"]]))]
    for want_call, got_call in cases:
        with pytest.raises(Exception) as w:
            want_call()
        with pytest.raises(type(w.value)) as g:
            got_call()
        assert str(g.value) == str(w.value)


# ----------------------------------------------------------------------
# GBDT and AutoXGBoost
# ----------------------------------------------------------------------

def _gbdt_data(kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, 4))
    if kind == "regression":
        return x, np.sin(2 * x[:, 0]) + x[:, 1] ** 2
    if kind == "binary":
        return x, np.where(x[:, 0] * x[:, 1] > 0, 7, 3)
    return x, (np.digitize(x[:, 0], [-0.5, 0.5]) + 10).astype(np.int64)


def _gbdt_run(mod, kind):
    x, y = _gbdt_data(kind)
    cls = mod.GBDTRegressor if kind == "regression" else mod.GBDTClassifier
    first = cls(n_estimators=6, max_depth=3, learning_rate=0.3,
                min_child_weight=2.0, gamma=0.01).fit(x, y)
    more = cls(n_estimators=4, max_depth=3).fit(x, y, xgb_model=first)
    out = [first.predict(x), more.predict(x), more.n_trees]
    if kind != "regression":
        out.append(more.predict_proba(x))
    return out


@pytest.mark.parametrize("kind", ["regression", "binary", "multiclass"])
def test_gbdt_equals_jax(kind):
    same(_gbdt_run(gbdt, kind), _gbdt_run(jax_gbdt, kind))
    # no xgboost here: the native trees back the wrappers, as in JAX
    assert gbdt.xgboost_backend() is gbdt
    assert jax_gbdt.xgboost_backend() is jax_gbdt


@pytest.mark.parametrize("cls", ["AutoXGBRegressor", "AutoXGBClassifier"])
def test_auto_xgboost_equals_jax(cls):
    kind = "regression" if cls == "AutoXGBRegressor" else "binary"
    x, y = _gbdt_data(kind, seed=1)
    vx, vy = _gbdt_data(kind, seed=2)

    def run(mod, hp_mod):
        auto = getattr(mod, cls)(learning_rate=0.3)
        auto.fit((x, y), (vx, vy), search_space={
            "max_depth": hp_mod.choice([2, 3, 4]),
            "min_child_weight": hp_mod.uniform(0.5, 2.0)},
            n_sampling=3, epochs=2, rounds_per_epoch=3)
        return auto

    got, want = run(port_xgb, hp), run(jax_xgb, jax_hp)
    assert got._engine.trial_table() == want._engine.trial_table()
    assert got.get_best_config() == want.get_best_config()
    same(got.predict(vx), want.predict(vx))
    with pytest.raises(ValueError) as w:
        getattr(jax_xgb, cls)(metric="r2")
    with pytest.raises(ValueError) as g:
        getattr(port_xgb, cls)(metric="r2")
    assert str(g.value) == str(w.value)


# ----------------------------------------------------------------------
# anomaly detectors
# ----------------------------------------------------------------------

def _spiky(n=300, seed=0):
    y = np.sin(np.arange(n) / 10).astype(np.float32)
    y[[50, 120]] = [10.0, -6.0]
    y += 0.01 * np.random.default_rng(seed).normal(size=n).astype(
        np.float32)
    return y


def test_threshold_and_dbscan_detectors_equal_jax():
    y = _spiky()
    pred = np.roll(y, 1)
    for params, args in ((dict(threshold=(-2, 2)), (y,)),
                         (dict(threshold=2.0), (y,)),
                         (dict(ratio=0.05), (y, pred)),
                         (dict(threshold=0.5), (y, pred))):
        got = detectors.ThresholdDetector().set_params(**params).fit(*args)
        want = jax_det.ThresholdDetector().set_params(**params).fit(*args)
        same([got.score(), got.anomaly_indexes()],
               [want.score(), want.anomaly_indexes()])
    got = detectors.DBScanDetector(eps=0.3, min_samples=4).fit(y)
    want = jax_det.DBScanDetector(eps=0.3, min_samples=4).fit(y)
    same([got.score(), got.anomaly_indexes()],
           [want.score(), want.anomaly_indexes()])
    assert {50, 120} <= set(got.anomaly_indexes())
    for mod in (detectors, jax_det):
        with pytest.raises(RuntimeError, match="call fit first"):
            mod.DBScanDetector().score()


class _FlaxAE(fnn.Module):
    """JAX's AEDetector autoencoder (a class local to its fit)."""

    hidden: int

    @fnn.compact
    def __call__(self, x):
        h = fnn.tanh(fnn.Dense(self.hidden, name="enc")(x))
        return fnn.Dense(x.shape[-1], name="dec")(h)


@lru_cache(maxsize=None)
def jax_ae(roll_len=24):
    """(windows, params, reconstructions, loss, gradients) of JAX's
    autoencoder on the standardized windows of `_spiky()`."""
    det = jax_det.AEDetector(roll_len=roll_len)
    flat = _spiky()
    idx = np.arange(roll_len)[None, :] + np.arange(
        len(flat) - roll_len + 1)[:, None]
    windows = flat[idx]
    win = (windows - windows.mean()) / (windows.std() + 1e-8)
    mod = _FlaxAE(max(2, int(roll_len * det.compress_rate)))
    params = jax.jit(mod.init)(jax.random.PRNGKey(0), win)["params"]

    @jax.jit
    def run(p):
        def loss(p):
            out = mod.apply({"params": p}, win)
            return jnp.mean((out - win) ** 2), out
        (value, out), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return out, value, grads

    return jax.tree_util.tree_map(np.asarray, (win, params, *run(params)))


def test_ae_detector_matches_jax():
    """On JAX's weights: the standardized windows bitwise, the scores
    within 1e-5 x max(1, |JAX|) and JAX's anomaly indexes (JAX's
    scoring applied to its own reconstructions), the first step's
    loss and gradients."""
    win, params, recon, loss, grads = jax_ae()
    det = detectors.AEDetector(roll_len=24, device="cpu")
    flat, got_win = det._windows(_spiky())
    same(got_win, win)
    det._est = det._estimator(24)
    det._est.set_params(convert.ae_detector_from_flax(params))
    det._scores = det._score(flat, got_win)
    want = np.zeros(len(flat), np.float32)
    want[23:] = ((recon - win) ** 2).mean(axis=1)
    close(det.score(), want)
    ref = jax_det.AEDetector(roll_len=24)
    ref._scores = want
    same(det.anomaly_indexes(), ref.anomaly_indexes())
    model = det._est.get_model()
    x = torch.from_numpy(win)
    value = ((model(x) - x) ** 2).mean()
    value.backward()
    close(value.item(), loss)
    grads_close(convert.ae_detector_to_flax(
        {k: p.grad for k, p in model.named_parameters()}), grads)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           convert.ae_detector_to_flax(model.state_dict()),
                           params)


def test_ae_detector_finds_the_spike_and_starts_alike():
    """JAX's test_ae_detector on the port; its weights are drawn on the
    CPU, so a detector starts from the same weights on every device."""
    y = np.sin(np.arange(300) / 10).astype(np.float32)
    y[120] = 6.0
    det = detectors.AEDetector(roll_len=10, ratio=0.02, epochs=8,
                               device="cpu").fit(y)
    assert any(110 <= i <= 129 for i in det.anomaly_indexes())
    a = detectors.AEDetector(roll_len=10, device="cpu")._estimator(10)
    b = detectors.AEDetector(roll_len=10, device="cpu")._estimator(10)
    for k, v in a.get_model().state_dict().items():
        assert torch.equal(v, b.get_model().state_dict()[k])
    with pytest.raises(ValueError, match="shorter than roll_len"):
        detectors.AEDetector(roll_len=10, device="cpu").fit(y[:5])
    with pytest.raises(RuntimeError, match="call fit first"):
        detectors.AEDetector(device="cpu").score()
