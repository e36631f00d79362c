"""TSDataset: the time-series data container (counterpart of
analytics_zoo_tpu/chronos/data/tsdataset.py): `from_pandas` with its
chronological split, `from_parquet`, `impute`, `deduplicate`,
`resample`, `gen_dt_feature`, `gen_rolling_feature`,
`gen_global_feature`, `scale` / `unscale` / `unscale_numpy`, `roll`,
`to_numpy`, `to_loader`.  Pure pandas and numpy, the JAX module's
semantics; `roll`, `to_numpy`, `to_loader` and `unscale_numpy` give
numpy, which the forecasters stage to the device.

pandas is imported inside the functions that take or build a
DataFrame, and sklearn's `StandardScaler` inside `scale`: the port's
import path loads neither, so the forecasters, AutoTS and the search
engine import and run on numpy windows where pandas is missing.

>>> import numpy as np, pandas as pd
>>> from analytics_zoo_tpu_torch.chronos.data.tsdataset import TSDataset
>>> df = pd.DataFrame({
...     "dt": pd.date_range("2021-01-01", periods=6, freq="D"),
...     "value": [1.0, 2.0, np.nan, 4.0, 5.0, 6.0]})
>>> ts = TSDataset.from_pandas(df, dt_col="dt", target_col="value")
>>> x, y = ts.impute(mode="last").roll(lookback=3,
...                                    horizon=1).to_numpy()
>>> x.shape, y.shape
((3, 3, 1), (3, 1, 1))
>>> float(x[1, 1, 0])    # the imputed gap carried the last value
2.0
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

_DT_FEATURES = {
    "MINUTE": lambda s: s.dt.minute,
    "HOUR": lambda s: s.dt.hour,
    "DAY": lambda s: s.dt.day,
    "DAYOFYEAR": lambda s: s.dt.dayofyear,
    "WEEKDAY": lambda s: s.dt.weekday,
    "WEEKOFYEAR": lambda s: s.dt.isocalendar().week.astype(np.int64),
    "MONTH": lambda s: s.dt.month,
    "YEAR": lambda s: s.dt.year,
    "IS_AWAKE": lambda s: ((s.dt.hour >= 6) & (s.dt.hour <= 23)
                           ).astype(np.int64),
    "IS_BUSY_HOURS": lambda s: s.dt.hour.isin([7, 8, 9, 17, 18, 19]
                                              ).astype(np.int64),
    "IS_WEEKEND": lambda s: (s.dt.weekday >= 5).astype(np.int64),
}

#: fixed one-hot ranges so indicator columns are stable across splits;
#: features absent here (YEAR, DAYOFYEAR, WEEKOFYEAR) have no bounded
#: calendar range and cannot be one-hotted consistently across splits
_DT_ONE_HOT_RANGES = {
    "MINUTE": (0, 59), "HOUR": (0, 23), "DAY": (1, 31),
    "WEEKDAY": (0, 6), "MONTH": (1, 12), "IS_AWAKE": (0, 1),
    "IS_BUSY_HOURS": (0, 1), "IS_WEEKEND": (0, 1),
}

_ROLLING_SETTINGS = {
    "minimal": ["mean", "std", "min", "max"],
    "comprehensive": ["mean", "std", "min", "max", "median", "sum",
                      "skew", "kurt"],
}


def _global_stats(v: np.ndarray, settings: str) -> dict:
    """Per-series global statistics (the reference's tsfresh
    extract_features; tsfresh is not a dependency, so the standard
    aggregate families are built in, vectorized numpy)."""
    out = {
        "mean": float(np.mean(v)), "std": float(np.std(v)),
        "min": float(np.min(v)), "max": float(np.max(v)),
        "median": float(np.median(v)), "length": float(v.size),
    }
    if settings == "minimal":
        return out
    d = np.diff(v) if v.size > 1 else np.zeros(1)
    out.update({
        "sum": float(np.sum(v)),
        "abs_energy": float(np.dot(v, v)),
        "mean_abs_change": float(np.mean(np.abs(d))),
        "mean_change": float(np.mean(d)),
        "count_above_mean": float(np.sum(v > v.mean())),
        "count_below_mean": float(np.sum(v < v.mean())),
        "last_location_of_maximum": float(
            1.0 - np.argmax(v[::-1]) / v.size),
        "first_location_of_maximum": float(np.argmax(v) / v.size),
    })
    if settings == "efficient":
        return out
    # comprehensive: distribution shape + trend + autocorrelation
    sd = out["std"]
    c = v - v.mean()
    out.update({
        "skewness": float(np.mean(c ** 3) / sd ** 3) if sd > 0 else 0.0,
        "kurtosis": float(np.mean(c ** 4) / sd ** 4 - 3.0)
        if sd > 0 else 0.0,
        "autocorr_lag1": float(np.dot(c[:-1], c[1:])
                               / (np.dot(c, c) or 1.0))
        if v.size > 1 else 0.0,
        "linear_trend_slope": float(np.polyfit(
            np.arange(v.size), v, 1)[0]) if v.size > 1 else 0.0,
        "quantile_25": float(np.quantile(v, 0.25)),
        "quantile_75": float(np.quantile(v, 0.75)),
    })
    return out


def _as_list(x) -> List[str]:
    if x is None:
        return []
    return [x] if isinstance(x, str) else list(x)


class TSDataset:
    def __init__(self, df: "pd.DataFrame", dt_col: str,
                 target_col: List[str], id_col: Optional[str],
                 feature_col: List[str]):
        self.df = df
        self.dt_col = dt_col
        self.target_col = list(target_col)
        self.id_col = id_col
        self.feature_col = list(feature_col)
        self.scaler = None
        self.numpy_x = None
        self.numpy_y = None
        self.lookback = None
        self.horizon = None

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @staticmethod
    def from_pandas(df: "pd.DataFrame", dt_col: str,
                    target_col: Union[str, Sequence[str]],
                    id_col: Optional[str] = None,
                    extra_feature_col: Union[str, Sequence[str], None] = None,
                    with_split: bool = False, val_ratio: float = 0,
                    test_ratio: float = 0.1):
        """Build a TSDataset (or (train, val, test) split chronologically,
        reference tsdataset.py:80)."""
        import pandas as pd

        target_col = _as_list(target_col)
        feature_col = _as_list(extra_feature_col)
        df = df.copy()
        df[dt_col] = pd.to_datetime(df[dt_col])
        df = df.sort_values(
            [id_col, dt_col] if id_col else [dt_col]).reset_index(drop=True)

        if not with_split:
            return TSDataset(df, dt_col, target_col, id_col, feature_col)

        def split_one(g):
            n = len(g)
            n_test = int(n * test_ratio)
            n_val = int(n * val_ratio)
            n_train = n - n_val - n_test
            return (g.iloc[:n_train], g.iloc[n_train:n_train + n_val],
                    g.iloc[n_train + n_val:])

        if id_col:
            parts = ([], [], [])
            for _, g in df.groupby(id_col, sort=False):
                for i, piece in enumerate(split_one(g)):
                    parts[i].append(piece)
            frames = [pd.concat(p).reset_index(drop=True) for p in parts]
        else:
            frames = [p.reset_index(drop=True) for p in split_one(df)]
        return tuple(TSDataset(f, dt_col, target_col, id_col, feature_col)
                     for f in frames)

    @staticmethod
    def from_parquet(path: str, dt_col: str,
                     target_col: Union[str, Sequence[str]],
                     id_col: Optional[str] = None,
                     extra_feature_col: Union[str, Sequence[str],
                                              None] = None,
                     with_split: bool = False, val_ratio: float = 0,
                     test_ratio: float = 0.1, columns=None):
        """Build a TSDataset from a parquet file/dir (reference
        tsdataset.py:163), reading only the needed columns."""
        import pandas as pd

        if columns is None:
            columns = ([dt_col] + _as_list(target_col)
                       + (_as_list(id_col)) + _as_list(extra_feature_col))
        df = pd.read_parquet(path, columns=columns)
        return TSDataset.from_pandas(
            df, dt_col, target_col, id_col=id_col,
            extra_feature_col=extra_feature_col, with_split=with_split,
            val_ratio=val_ratio, test_ratio=test_ratio)

    def _groups(self):
        if self.id_col:
            return [g for _, g in self.df.groupby(self.id_col, sort=False)]
        return [self.df]

    def _apply_per_group(self, fn):
        import pandas as pd

        groups = [fn(g.copy()) for g in self._groups()]
        self.df = pd.concat(groups).reset_index(drop=True)
        return self

    # ------------------------------------------------------------------
    # cleaning / preprocessing (reference data/utils/{impute,resample}.py)
    # ------------------------------------------------------------------

    def impute(self, mode: str = "last", const_num: float = 0.0):
        cols = self.target_col + self.feature_col

        def _one(g):
            if mode == "last":
                g[cols] = g[cols].ffill().bfill()
            elif mode == "const":
                g[cols] = g[cols].fillna(const_num)
            elif mode == "linear":
                g[cols] = g[cols].interpolate(
                    method="linear", limit_direction="both")
            else:
                raise ValueError(f"unknown impute mode '{mode}'")
            return g
        return self._apply_per_group(_one)

    def deduplicate(self):
        keys = [self.id_col, self.dt_col] if self.id_col else [self.dt_col]
        self.df = self.df.drop_duplicates(
            subset=keys, keep="last").reset_index(drop=True)
        return self

    def resample(self, interval: str, merge_mode: str = "mean"):
        cols = self.target_col + self.feature_col

        def _one(g):
            ident = g[self.id_col].iloc[0] if self.id_col else None
            g = g.set_index(self.dt_col)
            agg = getattr(g[cols].resample(interval), merge_mode)()
            agg = agg.reset_index()
            if self.id_col:
                agg[self.id_col] = ident
            return agg
        return self._apply_per_group(_one)

    def gen_dt_feature(self, features: Optional[Sequence[str]] = None,
                       one_hot_features: Optional[Sequence[str]] = None):
        """Append datetime-derived feature columns (reference
        gen_dt_feature).  Features named in `one_hot_features` expand to
        0/1 indicator columns `<F>_<value>` instead of ordinal ints
        (reference one_hot_features parameter)."""
        features = list(features) if features else [
            "HOUR", "DAY", "WEEKDAY", "MONTH", "IS_WEEKEND"]
        one_hot = set(one_hot_features or [])
        unknown = one_hot - set(features)
        features += sorted(unknown)  # one-hot-only features still apply
        for f in features:
            if f not in _DT_FEATURES:
                raise ValueError(f"unknown dt feature '{f}'; "
                                 f"known: {sorted(_DT_FEATURES)}")
            vals = _DT_FEATURES[f](self.df[self.dt_col])
            if f in one_hot:
                if f not in _DT_ONE_HOT_RANGES:
                    raise ValueError(
                        f"'{f}' has no bounded calendar range; one-hot "
                        "columns derived from the data would differ "
                        "between train/test splits")
                lo, hi = _DT_ONE_HOT_RANGES[f]
                for v in range(lo, hi + 1):
                    col = f"{f}_{v}"
                    self.df[col] = (vals == v).astype(np.int64)
                    if col not in self.feature_col:
                        self.feature_col.append(col)
            else:
                self.df[f] = vals
                if f not in self.feature_col:
                    self.feature_col.append(f)
        return self

    def gen_rolling_feature(self, window_size: int,
                            settings: Union[str, Sequence[str]]
                            = "minimal"):
        """Append rolling statistics of every target column over a
        trailing window (the reference's tsfresh-backed
        gen_rolling_feature; tsfresh is not a dependency, so the standard
        aggregate set is built in).  `settings`: "minimal"
        (mean/std/min/max) | "comprehensive" (+median/sum/skew/kurt) |
        an explicit list of pandas rolling aggregates.  The first
        window_size-1 rows per series hold NaN — impute() or drop before
        roll()."""
        if isinstance(settings, str):
            try:
                aggs = _ROLLING_SETTINGS[settings]
            except KeyError:
                raise ValueError(
                    f"unknown settings '{settings}'; known: "
                    f"{sorted(_ROLLING_SETTINGS)} or a list of pandas "
                    "rolling aggregates")
        else:
            aggs = list(settings)

        def _one(g):
            for c in self.target_col:
                roll = g[c].rolling(window_size)
                for agg in aggs:
                    g[f"{c}_rolling_{agg}_{window_size}"] = \
                        getattr(roll, agg)()
            return g

        self._apply_per_group(_one)
        for c in self.target_col:
            for agg in aggs:
                col = f"{c}_rolling_{agg}_{window_size}"
                if col not in self.feature_col:
                    self.feature_col.append(col)
        return self

    def gen_global_feature(self, settings: str = "comprehensive"):
        """Append per-series global statistics of each target column,
        broadcast to every row of that series (reference
        gen_global_feature, tsdataset.py:358 — tsfresh-backed there;
        built-in numpy aggregate families here).  `settings`: "minimal" |
        "efficient" | "comprehensive" (growing stat sets)."""
        if settings not in ("minimal", "efficient", "comprehensive"):
            raise ValueError(
                f"settings must be minimal/efficient/comprehensive, "
                f"got '{settings}'")
        new_cols = set()

        def _one(g):
            for c in self.target_col:
                stats = _global_stats(
                    g[c].to_numpy(np.float64), settings)
                for name, val in stats.items():
                    col = f"{c}__{name}"
                    g[col] = val
                    new_cols.add(col)
            return g

        self._apply_per_group(_one)
        for col in sorted(new_cols):
            if col not in self.feature_col:
                self.feature_col.append(col)
        return self

    # ------------------------------------------------------------------
    # scaling (reference tsdataset.py:467)
    # ------------------------------------------------------------------

    def scale(self, scaler=None, fit: bool = True):
        if scaler is None:
            from sklearn.preprocessing import StandardScaler
            scaler = StandardScaler()
        cols = self.target_col + self.feature_col
        if fit:
            scaler.fit(self.df[cols])
        self.df[cols] = scaler.transform(self.df[cols])
        self.scaler = scaler
        return self

    def unscale(self):
        if self.scaler is None:
            raise RuntimeError("scale() was never called")
        cols = self.target_col + self.feature_col
        self.df[cols] = self.scaler.inverse_transform(self.df[cols])
        return self

    def unscale_numpy(self, data: np.ndarray) -> np.ndarray:
        """Unscale model output [batch, horizon, n_targets] (reference
        tsdataset.unscale_numpy)."""
        if self.scaler is None:
            raise RuntimeError("scale() was never called")
        n_t = len(self.target_col)
        scale = getattr(self.scaler, "scale_", None)
        if scale is None:
            raise ValueError("scaler has no scale_ attribute")
        mean = getattr(self.scaler, "mean_", None)
        if mean is None:  # MinMaxScaler
            mins = self.scaler.min_[:n_t]
            return (data - mins) / self.scaler.scale_[:n_t]
        return data * scale[:n_t] + mean[:n_t]

    # ------------------------------------------------------------------
    # windowing (reference tsdataset.py:707 roll + utils/roll.py)
    # ------------------------------------------------------------------

    def roll(self, lookback: int, horizon: Union[int, Sequence[int]],
             feature_col: Optional[Sequence[str]] = None,
             target_col: Optional[Sequence[str]] = None):
        feature_col = (list(feature_col) if feature_col is not None
                       else self.feature_col)
        target_col = (list(target_col) if target_col is not None
                      else self.target_col)
        horizons = ([horizon] if isinstance(horizon, int)
                    else list(horizon))
        max_h = max(horizons) if horizons != [0] else 0
        xs, ys = [], []
        in_cols = target_col + feature_col
        for g in self._groups():
            arr_x = g[in_cols].to_numpy(np.float32)
            arr_y = g[target_col].to_numpy(np.float32)
            n = len(g) - lookback - max_h + 1
            if n <= 0:
                continue
            idx = np.arange(lookback)[None, :] + np.arange(n)[:, None]
            xs.append(arr_x[idx])
            if max_h:
                if isinstance(horizon, int):
                    h_idx = (np.arange(horizon)[None, :] + lookback
                             + np.arange(n)[:, None])
                else:
                    h_idx = (np.asarray(horizons)[None, :] - 1 + lookback
                             + np.arange(n)[:, None])
                ys.append(arr_y[h_idx])
        if not xs:
            raise ValueError("series shorter than lookback + horizon")
        self.numpy_x = np.concatenate(xs)
        self.numpy_y = np.concatenate(ys) if ys else None
        self.lookback = lookback
        self.horizon = horizon
        return self

    def to_numpy(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if self.numpy_x is None:
            raise RuntimeError("call roll(lookback, horizon) first")
        return self.numpy_x, self.numpy_y

    def to_pandas(self) -> "pd.DataFrame":
        return self.df.copy()

    def to_loader(self, batch_size: int = 32, *, roll: bool = False,
                  lookback: Optional[int] = None,
                  horizon: Union[int, Sequence[int], None] = None,
                  shuffle: bool = True, seed: int = 0,
                  drop_last: bool = False):
        """Batch iterator over the rolled windows (the reference's
        to_torch_data_loader, tsdataset.py:596; as in the JAX package it
        yields (x, y) numpy batches ready for Estimator/forecaster
        trainers).

        With `roll=True`, rolls with the given lookback/horizon first."""
        if roll:
            if lookback is None or horizon is None:
                raise ValueError(
                    "roll=True needs lookback= and horizon=")
            self.roll(lookback, horizon)
        if self.numpy_x is None:
            raise RuntimeError(
                "call roll(lookback, horizon) first, or pass roll=True "
                "with lookback/horizon")
        x, y = self.numpy_x, self.numpy_y

        def _iter():
            n = len(x)
            order = np.arange(n)
            if shuffle:
                np.random.default_rng(seed).shuffle(order)
            stop = (n - n % batch_size) if drop_last else n
            for lo in range(0, stop, batch_size):
                sel = order[lo:lo + batch_size]
                yield (x[sel], y[sel] if y is not None else None)
        return _iter()

    # convenience accessors used by forecasters
    @property
    def input_feature_num(self):
        return len(self.target_col) + len(self.feature_col)

    @property
    def output_target_num(self):
        return len(self.target_col)
