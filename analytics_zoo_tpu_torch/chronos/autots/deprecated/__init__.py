"""The deprecated zouwu AutoTS API (counterpart of
analytics_zoo_tpu/chronos/autots/deprecated/): `AutoTSTrainer` /
`TimeSequencePredictor` with `Recipe` presets, and `load_ts_pipeline`,
over the port's AutoTSEstimator and TSPipeline.

The dataframe-first surface (`AutoTSTrainer(dt_col=...,
target_col=...).fit(train_df)` -> a pipeline) maps onto
`AutoTSEstimator` and `TSDataset`; a recipe is a (model, search space,
sampling budget) preset.  Each entry point warns with a
DeprecationWarning naming the replacement, and takes `device` (None:
the CUDA card, or a raise), passed to the estimator and the loader.
pandas is needed by what takes a DataFrame, and imported there.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Union

from analytics_zoo_tpu_torch.chronos.autots.autotsestimator import (
    AutoTSEstimator,
)
from analytics_zoo_tpu_torch.chronos.autots.tspipeline import TSPipeline
from analytics_zoo_tpu_torch.chronos.data.tsdataset import TSDataset
from analytics_zoo_tpu_torch.orca.automl import hp


class Recipe:
    """Search preset: model family + space + sampling budget."""

    model = "lstm"
    n_sampling = 1
    epochs = 1

    def search_space(self) -> Dict:
        return {}


class SmokeRecipe(Recipe):
    """Tiny sanity search."""

    def search_space(self):
        return {"hidden_dim": hp.choice([16]),
                "layer_num": hp.choice([1]),
                "lr": hp.choice([3e-3]),
                "batch_size": hp.choice([32])}


class RandomRecipe(Recipe):
    """Random sampling over the LSTM space."""

    def __init__(self, num_rand_samples: int = 4):
        self.n_sampling = num_rand_samples
        self.epochs = 3

    def search_space(self):
        return {"hidden_dim": hp.choice([16, 32, 64]),
                "layer_num": hp.choice([1, 2]),
                "lr": hp.loguniform(1e-3, 1e-2),
                "batch_size": hp.choice([32, 64])}


class LSTMGridRandomRecipe(Recipe):
    """Grid over LSTM widths x random rest."""

    def __init__(self, num_rand_samples: int = 1,
                 hidden_dim: Optional[List[int]] = None,
                 layer_num: Optional[List[int]] = None):
        if num_rand_samples > 1:
            warnings.warn(
                "grid-mode search samples the non-grid axes once so "
                "combos compare like with like (SearchEngine grid "
                "semantics); num_rand_samples > 1 has no effect — use "
                "RandomRecipe for a sampled search", stacklevel=2)
        self.n_sampling = num_rand_samples
        self.epochs = 3
        self._hidden = hidden_dim or [16, 32]
        self._layers = layer_num or [1, 2]

    def search_space(self):
        return {"hidden_dim": hp.grid_search(self._hidden),
                "layer_num": hp.grid_search(self._layers),
                "lr": hp.choice([3e-3]),
                "batch_size": hp.choice([32])}


class _ZouwuPipeline(TSPipeline):
    """Dataframe-first TSPipeline: the deprecated surface passed raw
    dataframes to fit/predict/evaluate, so this wrapper rebuilds the
    TSDataset from the trainer's column spec (re-applying the
    pipeline's fitted scaler, if any) before delegating."""

    def __init__(self, base: TSPipeline, dt_col: str,
                 target_col: List[str], extra: List[str]):
        super().__init__(base.forecaster, base.best_config, base.scaler)
        self._cols = (dt_col, list(target_col), list(extra))

    def _wrap(self, data, horizon: Optional[int] = None):
        import pandas as pd

        if not isinstance(data, pd.DataFrame):
            return data
        dt, tgt, extra = self._cols
        tsd = TSDataset.from_pandas(data, dt_col=dt, target_col=tgt,
                                    extra_feature_col=extra or None)
        if self.scaler is not None:
            # the forecaster lives in scaled space — raw-unit inputs
            # must go through the SAME fitted scaler
            tsd.scale(self.scaler, fit=False)
        if horizon is not None:
            tsd.roll(self.forecaster.past_seq_len, horizon)
        return tsd

    def fit(self, data, **kw):
        return super().fit(self._wrap(data), **kw)

    def predict(self, data, **kw):
        # horizon=0: inference-only windows — every full lookback
        # window forecasts, INCLUDING the newest one (the old API's
        # "forecast the future from the latest data" contract); the
        # training horizon would consume the last rows as y-targets
        return super().predict(self._wrap(data, horizon=0), **kw)

    def evaluate(self, data, **kw):
        return super().evaluate(self._wrap(data), **kw)


def _warn(old: str):
    warnings.warn(
        f"{old} is deprecated (it was already deprecated in Analytics "
        "Zoo); use analytics_zoo_tpu_torch.chronos.autots."
        "AutoTSEstimator instead", DeprecationWarning, stacklevel=3)


class AutoTSTrainer:
    """Dataframe-first AutoTS over `dt_col`/`target_col` columns."""

    def __init__(self, horizon: int = 1, dt_col: str = "datetime",
                 target_col: Union[str, List[str]] = "value",
                 extra_features_col: Optional[List[str]] = None,
                 past_seq_len: int = 24, name: str = "automl",
                 device=None, **_):
        # subclasses warn under their own name (correct stack depth)
        if type(self) is AutoTSTrainer:
            _warn("AutoTSTrainer")
        self.horizon = horizon
        self.dt_col = dt_col
        self.target_col = ([target_col] if isinstance(target_col, str)
                           else list(target_col))
        self.extra_features_col = list(extra_features_col or [])
        self.past_seq_len = past_seq_len
        self.device = device

    def _tsdataset(self, df):
        return TSDataset.from_pandas(
            df, dt_col=self.dt_col, target_col=self.target_col,
            extra_feature_col=self.extra_features_col or None)

    def fit(self, train_df, validation_df=None, metric: str = "mse",
            recipe: Optional[Recipe] = None) -> TSPipeline:
        recipe = recipe or SmokeRecipe()
        est = AutoTSEstimator(
            model=recipe.model, search_space=recipe.search_space(),
            past_seq_len=self.past_seq_len,
            future_seq_len=self.horizon, metric=metric, device=self.device)
        train = self._tsdataset(train_df)
        val = (self._tsdataset(validation_df)
               if validation_df is not None else None)
        base = est.fit(train, validation_data=val,
                       epochs=recipe.epochs,
                       n_sampling=recipe.n_sampling)
        return _ZouwuPipeline(base, self.dt_col, self.target_col,
                              self.extra_features_col)


class TimeSequencePredictor(AutoTSTrainer):
    """The same flow under the older name (`future_seq_len`
    naming)."""

    def __init__(self, future_seq_len: int = 1, dt_col: str = "datetime",
                 target_col: Union[str, List[str]] = "value",
                 extra_features_col: Optional[List[str]] = None, **kw):
        _warn("TimeSequencePredictor")
        kw.pop("name", None)
        kw.pop("logs_dir", None)
        super().__init__(horizon=future_seq_len, dt_col=dt_col,
                         target_col=target_col,
                         extra_features_col=extra_features_col, **kw)


def load_ts_pipeline(path: str, dt_col: Optional[str] = None,
                     target_col: Union[str, List[str], None] = None,
                     extra_features_col: Optional[List[str]] = None,
                     device=None) -> TSPipeline:
    """Pass the column spec to get back the dataframe-first wrapper;
    without it the plain TSPipeline (TSDataset/array inputs) is
    returned, its forecaster on `device`."""
    _warn("load_ts_pipeline")
    base = TSPipeline.load(path, device=device)
    if dt_col is not None and target_col is not None:
        tgt = [target_col] if isinstance(target_col, str) \
            else list(target_col)
        return _ZouwuPipeline(base, dt_col, tgt,
                              list(extra_features_col or []))
    return base
