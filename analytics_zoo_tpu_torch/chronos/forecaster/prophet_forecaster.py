"""Prophet-style forecaster (counterpart of
analytics_zoo_tpu/chronos/forecaster/prophet_forecaster.py): a native
numpy re-implementation of Prophet's decomposition, on the host as in
JAX, the same code on the same float64 data.

y(t) = g(t) + s(t) + h(t) + e: g a piecewise-linear trend over
automatic changepoints, s Fourier seasonalities (auto-enabled from the
data's span and cadence by Prophet's rule), h one indicator column per
(holiday, window offset) of a Prophet-format holiday frame, matched by
calendar date.  Fit is one ridge regression in closed form whose
per-block L2 strengths are the priors' MAP form (1 / prior_scale^2).
`seasonality_mode="multiplicative"` fits log(y) with the same machinery
and exponentiates on predict.  Intervals: the residual sigma plus a
trend uncertainty from the changepoint slopes, projected over the
horizon.

Frames in, frames out: pandas is imported inside the functions that
take or make a DataFrame, never when this module is imported (the
forecaster package imports every forecaster, and the card machine has
no pandas).
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np

_DAY_S = 86400.0


class ProphetForecaster:
    """JAX's ProphetForecaster surface: fit takes a pandas frame with
    'ds'/'y' columns, predict extends the frame `horizon` periods ahead
    at `freq` and returns a frame with ds / trend / yhat / yhat_lower /
    yhat_upper."""

    def __init__(self, changepoint_prior_scale: float = 0.05,
                 seasonality_prior_scale: float = 10.0,
                 holidays_prior_scale: float = 10.0,
                 seasonality_mode: str = "additive",
                 changepoint_range: float = 0.8,
                 n_changepoints: int = 25,
                 yearly_seasonality="auto", weekly_seasonality="auto",
                 daily_seasonality="auto", metric: str = "mse",
                 holidays: Optional["pd.DataFrame"] = None):
        if seasonality_mode not in ("additive", "multiplicative"):
            raise ValueError(
                f"seasonality_mode {seasonality_mode!r} not in "
                "('additive', 'multiplicative')")
        if holidays is not None and not {"holiday", "ds"} <= set(
                holidays.columns):
            raise ValueError(
                "holidays must be a frame with 'holiday' and 'ds' "
                "columns (optional lower_window/upper_window) — the "
                "fbprophet format")
        self.holidays = holidays
        self.config = dict(
            changepoint_prior_scale=float(changepoint_prior_scale),
            seasonality_prior_scale=float(seasonality_prior_scale),
            holidays_prior_scale=float(holidays_prior_scale),
            seasonality_mode=seasonality_mode,
            changepoint_range=float(changepoint_range),
            n_changepoints=int(n_changepoints),
            yearly=yearly_seasonality, weekly=weekly_seasonality,
            daily=daily_seasonality, metric=metric)
        self._state: Optional[Dict] = None

    # -- design matrix -------------------------------------------------

    @staticmethod
    def _fourier(t_days: np.ndarray, period_days: float,
                 order: int) -> np.ndarray:
        x = 2.0 * np.pi * t_days[:, None] / period_days
        k = np.arange(1, order + 1)[None, :]
        return np.concatenate([np.sin(x * k), np.cos(x * k)], axis=1)

    def _design(self, t_days: np.ndarray, st: Dict) -> np.ndarray:
        cols = [np.ones_like(t_days)[:, None], t_days[:, None] / st["span"]]
        for c in st["changepoints"]:
            cols.append(np.maximum(t_days - c, 0.0)[:, None] / st["span"])
        for period, order in st["seasonalities"]:
            cols.append(self._fourier(t_days, period, order))
        if st.get("holiday_cols"):
            # calendar-date match: works at fit AND at any forecast
            # horizon (offsets were folded into the date sets)
            day_ord = np.floor(st["t0_epoch_days"] + t_days
                               + 1e-9).astype(np.int64)
            for _label, days in st["holiday_cols"]:
                cols.append(np.isin(day_ord, days)
                            .astype(np.float64)[:, None])
        return np.concatenate(cols, axis=1)

    @staticmethod
    def _holiday_cols(holidays: Optional["pd.DataFrame"]):
        """Prophet-format holiday frame -> [(label, sorted day-ordinal
        array)] — one indicator column per (holiday name, window
        offset), the exact column structure fbprophet builds."""
        import pandas as pd

        if holidays is None or not len(holidays):
            return []

        def _win(row, col):
            # per-ROW windows, like fbprophet; absent column or NaN
            # (e.g. pd.concat of frames with and without window cols)
            # means offset 0
            v = row.get(col)
            return 0 if v is None or pd.isna(v) else int(v)

        out = []
        for name, grp in holidays.groupby("holiday", sort=True):
            by_off: Dict[int, list] = {}
            for _, row in grp.iterrows():
                day = int((pd.Timestamp(row["ds"]).normalize()
                           - pd.Timestamp(0)).days)
                lo = _win(row, "lower_window")
                hi = _win(row, "upper_window")
                if lo > 0 or hi < 0 or lo > hi:
                    raise ValueError(
                        f"holiday {name!r}: lower_window must be <= 0 "
                        f"<= upper_window (got {lo}, {hi})")
                for off in range(lo, hi + 1):
                    by_off.setdefault(off, []).append(day + off)
            for off in sorted(by_off):
                out.append((f"{name}{off:+d}" if off else str(name),
                            np.unique(np.asarray(by_off[off],
                                                 np.int64))))
        return out

    # -- fit -----------------------------------------------------------

    def fit(self, data: pd.DataFrame,
            validation_data: Optional[pd.DataFrame] = None
            ) -> Dict[str, float]:
        import pandas as pd

        for frame, name in ((data, "data"),
                            (validation_data, "validation_data")):
            if frame is not None and not {"ds", "y"} <= set(frame.columns):
                raise ValueError(
                    f"{name} should be a pandas dataframe that has at "
                    "least 2 columns 'ds' and 'y'")
        if validation_data is None:
            # same convention as ARIMAForecaster: hold out a ~10% tail
            # so fit always returns a metric (AutoProphet relies on it)
            cut = max(len(data) - max(len(data) // 10, 1), 8)
            data, validation_data = data.iloc[:cut], data.iloc[cut:]
        ds = pd.to_datetime(data["ds"]).to_numpy()
        y = np.asarray(data["y"], np.float64)
        multiplicative = self.config["seasonality_mode"] == "multiplicative"
        if multiplicative:
            if (y <= 0).any():
                raise ValueError(
                    "seasonality_mode='multiplicative' fits log(y) and "
                    "needs strictly positive y")
            y = np.log(y)
        t0 = ds[0]
        t_days = (ds - t0) / np.timedelta64(1, "D")
        span = max(float(t_days[-1]), 1e-9)
        cadence = float(np.median(np.diff(t_days))) if len(t_days) > 1 else 1.0

        def _auto(flag, enabled):
            return bool(enabled) if flag == "auto" else bool(flag)

        seasonalities: List = []
        if _auto(self.config["yearly"], span >= 2 * 365.25):
            seasonalities.append((365.25, 10))
        if _auto(self.config["weekly"], span >= 14 and cadence < 7):
            seasonalities.append((7.0, 3))
        if _auto(self.config["daily"], span >= 2 and cadence < 1):
            seasonalities.append((1.0, 4))

        cp_range = self.config["changepoint_range"]
        n_cp = min(self.config["n_changepoints"],
                   max(len(t_days) // 3 - 1, 0))
        cps = (np.quantile(t_days, np.linspace(0, cp_range, n_cp + 2)[1:-1])
               if n_cp > 0 else np.zeros(0))

        hol_cols = self._holiday_cols(self.holidays)
        n_seas = sum(2 * order for _p, order in seasonalities)
        st = {"t0": t0, "span": span, "cadence": cadence,
              "changepoints": cps, "seasonalities": seasonalities,
              "holiday_cols": hol_cols,
              "t0_epoch_days": float(
                  (t0 - np.datetime64(0, "ns"))
                  / np.timedelta64(1, "D")),
              "multiplicative": multiplicative,
              "y_scale": max(float(np.abs(y).max()), 1e-9)}
        X = self._design(t_days, st)
        # per-block ridge strengths: MAP form of Prophet's priors
        lam = np.zeros(X.shape[1])
        i = 2
        lam[i:i + len(cps)] = 1.0 / self.config[
            "changepoint_prior_scale"] ** 2
        i += len(cps)
        lam[i:i + n_seas] = 1.0 / self.config[
            "seasonality_prior_scale"] ** 2
        i += n_seas
        lam[i:] = 1.0 / self.config["holidays_prior_scale"] ** 2
        ys = y / st["y_scale"]
        beta = np.linalg.solve(X.T @ X + np.diag(lam), X.T @ ys)
        resid = ys - X @ beta
        st["beta"] = beta
        st["sigma"] = float(resid.std() * st["y_scale"])
        # trend-uncertainty scale: typical changepoint slope magnitude
        deltas = beta[2:2 + len(cps)]
        st["delta_scale"] = (float(np.abs(deltas).mean())
                             * st["y_scale"] / span if len(deltas) else 0.0)
        st["t_last"] = float(t_days[-1])
        self._state = st

        metric = self.config["metric"]
        val = self.evaluate(validation_data, metrics=[metric])
        return {metric: val[0]}

    # -- predict / evaluate -------------------------------------------

    def _predict_at(self, t_days: np.ndarray):
        """-> (yhat, trend, lower, upper) in ORIGINAL units (the
        multiplicative mode exponentiates its log-space fit here, which
        makes the interval asymmetric as it should be)."""
        st = self._state
        X = self._design(t_days, st)
        yhat = X @ st["beta"] * st["y_scale"]
        trend = X[:, :2 + len(st["changepoints"])] @ \
            st["beta"][:2 + len(st["changepoints"])] * st["y_scale"]
        # widen with extrapolated trend uncertainty past the train end
        extra = np.maximum(t_days - st["t_last"], 0.0)
        width = 1.96 * np.sqrt(st["sigma"] ** 2
                               + (st["delta_scale"] * extra) ** 2)
        lower, upper = yhat - width, yhat + width
        if st.get("multiplicative"):
            yhat, trend = np.exp(yhat), np.exp(trend)
            lower, upper = np.exp(lower), np.exp(upper)
        return yhat, trend, lower, upper

    def predict(self, horizon: int = 24,
                freq: Optional[str] = None) -> pd.DataFrame:
        """Forecast `horizon` periods past the training end: a frame
        with the yhat columns.  `freq=None` (default) steps at the
        trained cadence: an hourly series forecasts the next `horizon`
        hours; pass a pandas freq string ("D", "H", ...) to override."""
        if self._state is None:
            raise RuntimeError(
                "You must call fit or restore first before calling "
                "predict!")
        import pandas as pd

        st = self._state
        if freq is None:
            # cadence is a float-days median; round off the nanosecond
            # dust so hourly data steps exactly 1h
            freq = pd.to_timedelta(st["cadence"], unit="D").round("ms")
        last = (pd.Timestamp(st["t0"])
                + pd.to_timedelta(st["t_last"], unit="D")).round("ms")
        ds = pd.date_range(last, periods=int(horizon) + 1,
                           freq=freq)[1:]
        t_days = (ds.to_numpy() - st["t0"]) / np.timedelta64(1, "D")
        yhat, trend, lower, upper = self._predict_at(t_days)
        return pd.DataFrame({"ds": ds, "trend": trend, "yhat": yhat,
                             "yhat_lower": lower,
                             "yhat_upper": upper})

    def evaluate(self, validation_data: pd.DataFrame,
                 metrics: List[str] = ("mse",)) -> List[float]:
        if validation_data is None:
            raise ValueError("Input invalid validation_data of None")
        if self._state is None:
            raise RuntimeError(
                "You must call fit or restore first before calling "
                "evaluate!")
        import pandas as pd

        from analytics_zoo_tpu_torch.orca.automl.metrics import Evaluator
        ds = pd.to_datetime(validation_data["ds"]).to_numpy()
        y = np.asarray(validation_data["y"], np.float64)
        t_days = (ds - self._state["t0"]) / np.timedelta64(1, "D")
        yhat, _, _, _ = self._predict_at(t_days)
        return [float(np.mean(Evaluator.evaluate(m, y, yhat)))
                for m in metrics]

    # -- persistence ---------------------------------------------------

    def save(self, checkpoint_file: str):
        if self._state is None:
            raise RuntimeError(
                "You must call fit or restore first before calling save!")
        with open(checkpoint_file, "wb") as f:
            pickle.dump({"config": self.config, "state": self._state,
                         "holidays": self.holidays}, f)

    def restore(self, checkpoint_file: str):
        with open(checkpoint_file, "rb") as f:
            blob = pickle.load(f)
        self.config = blob["config"]
        self._state = blob["state"]
        self.holidays = blob.get("holidays")
        return self

    @classmethod
    def load(cls, checkpoint_file: str, device=None) -> "ProphetForecaster":
        """TSPipeline.load's entry point; `device` is unused (the model
        is host numpy)."""
        fc = cls()
        fc.restore(checkpoint_file)
        return fc
