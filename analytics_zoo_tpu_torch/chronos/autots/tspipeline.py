"""TSPipeline (counterpart of
analytics_zoo_tpu/chronos/autots/tspipeline.py): the fitted best
forecaster with the scaler of its training data; predict / evaluate in
the data's original units (`_unscale`), fit on, save and load.

Nothing here imports pandas or TSDataset at module top: a TSDataset is
recognised through `sys.modules` (`base.is_tsdataset`).  An ARIMA or
Prophet pipeline (the classical legs, told apart by the forecaster's
class name) takes the horizon to `predict`, the raw series (or a ds/y
frame) to `fit` and `evaluate`.  `load(path, device)` rebuilds the
forecaster on `device` (None: the CUDA card; the classical forecasters
ignore it).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from analytics_zoo_tpu_torch.chronos.forecaster.base import (
    _shape_y,
    is_tsdataset,
)


class TSPipeline:
    def __init__(self, forecaster, best_config: Dict, scaler=None):
        self.forecaster = forecaster
        self.best_config = best_config
        self.scaler = scaler

    def _xy(self, data):
        if is_tsdataset(data):
            if data.numpy_x is None:
                data.roll(self.forecaster.past_seq_len,
                          self.forecaster.future_seq_len)
            return data.to_numpy()
        return data

    def _unscale(self, arr: np.ndarray) -> np.ndarray:
        """Map model-space values back to original units (reference
        TSPipeline._tsdataset_unscale)."""
        if self.scaler is None:
            return arr
        n_t = self.forecaster.output_feature_num
        mean = getattr(self.scaler, "mean_", None)
        scale = getattr(self.scaler, "scale_", None)
        if mean is not None:          # StandardScaler
            return arr * scale[:n_t] + mean[:n_t]
        mins = getattr(self.scaler, "min_", None)
        if mins is not None:          # MinMaxScaler
            return (arr - mins[:n_t]) / scale[:n_t]
        return arr

    def _is_arima(self) -> bool:
        return type(self.forecaster).__name__ == "ARIMAForecaster"

    def _is_prophet(self) -> bool:
        return type(self.forecaster).__name__ == "ProphetForecaster"

    @staticmethod
    def _frame(data) -> "pd.DataFrame":
        """ds/y frame for the Prophet path (a TSDataset's datetime col +
        first target, or a frame already carrying ds/y).  Scaled
        TSDatasets are rejected for the same reason as `_series`."""
        import pandas as pd

        if is_tsdataset(data):
            if getattr(data, "scaler", None) is not None:
                raise ValueError(
                    "the Prophet pipeline operates on the raw series — "
                    "don't scale() the TSDataset (classical models fit "
                    "their own level/variance)")
            return pd.DataFrame({
                "ds": pd.to_datetime(data.df[data.dt_col]),
                "y": data.df[data.target_col[0]].to_numpy(np.float64)})
        if not {"ds", "y"} <= set(getattr(data, "columns", ())):
            raise ValueError(
                "prophet data must be a TSDataset or a frame with "
                "'ds'/'y' columns")
        return data

    @staticmethod
    def _series(data) -> np.ndarray:
        """1-D target series for the ARIMA path (a TSDataset's first
        target column, or any array-like).  Scaled TSDatasets are
        rejected: this path reads df values directly and has no
        unscale hook, so accepting one would silently forecast in
        scaled units."""
        if is_tsdataset(data):
            if getattr(data, "scaler", None) is not None:
                raise ValueError(
                    "the ARIMA pipeline operates on the raw series — "
                    "don't scale() the TSDataset (classical models fit "
                    "their own level/variance)")
            return data.df[data.target_col[0]].to_numpy(np.float64)
        return np.asarray(data, np.float64).reshape(-1)

    def fit(self, data, epochs: int = 1, batch_size: int = 32):
        if self._is_arima():
            self.forecaster.fit(self._series(data))
            return self
        if self._is_prophet():
            self.forecaster.fit(self._frame(data))
            return self
        x, y = self._xy(data)
        self.forecaster.fit((x, y), epochs=epochs, batch_size=batch_size)
        return self

    def predict(self, data, batch_size: int = 32):
        """Predictions in ORIGINAL units when the training TSDataset was
        scaled.  For an ARIMA/Prophet pipeline `data` is the horizon
        (int)."""
        if self._is_arima():
            return self.forecaster.predict(int(data))
        if self._is_prophet():
            # freq defaults to the trained cadence inside the
            # forecaster, so hourly pipelines forecast hours, not days
            return self.forecaster.predict(horizon=int(data))
        x, _ = self._xy(data)
        preds = self.forecaster.predict((x, None), batch_size=batch_size)
        return self._unscale(preds)

    def evaluate(self, data, batch_size: int = 32):
        """Metrics in original units (predictions and targets unscaled
        before comparison).  For an ARIMA pipeline `data` is the
        held-out continuation series; for Prophet, a ds/y frame (or
        TSDataset) covering the held-out span."""
        if self._is_arima():
            mse, mae = self.forecaster.evaluate(self._series(data),
                                                metrics=["mse", "mae"])
            return {"mse": mse, "mae": mae}
        if self._is_prophet():
            mse, mae = self.forecaster.evaluate(self._frame(data),
                                                metrics=["mse", "mae"])
            return {"mse": mse, "mae": mae}
        x, y = self._xy(data)
        if self.scaler is None:
            return self.forecaster.evaluate((x, y), batch_size=batch_size)
        preds = self._unscale(
            self.forecaster.predict((x, None), batch_size=batch_size))
        y = self._unscale(_shape_y(
            y, self.forecaster.future_seq_len,
            self.forecaster.output_feature_num))
        diff = preds - y
        return {"mse": float((diff ** 2).mean()),
                "mae": float(np.abs(diff).mean())}

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.forecaster.save(os.path.join(path, "forecaster.pkl"))
        with open(os.path.join(path, "pipeline.pkl"), "wb") as f:
            pickle.dump({"best_config": self.best_config,
                         "scaler": self.scaler,
                         "forecaster_class":
                             type(self.forecaster).__name__}, f)
        return path

    @staticmethod
    def load(path: str, device=None) -> "TSPipeline":
        with open(os.path.join(path, "pipeline.pkl"), "rb") as f:
            meta = pickle.load(f)
        from analytics_zoo_tpu_torch.chronos import forecaster as fmod
        cls = getattr(fmod, meta["forecaster_class"])
        fc = cls.load(os.path.join(path, "forecaster.pkl"), device=device)
        return TSPipeline(fc, meta["best_config"], meta["scaler"])
