"""AutoProphet (counterpart of
analytics_zoo_tpu/chronos/autots/model/auto_prophet.py): a search over
the native Prophet's prior scales and changepoint range on the port's
SearchEngine, on the host as in JAX."""

from __future__ import annotations

from typing import Dict, Optional

from analytics_zoo_tpu_torch.chronos.forecaster.prophet_forecaster import (
    ProphetForecaster,
)
from analytics_zoo_tpu_torch.orca.automl import hp
from analytics_zoo_tpu_torch.orca.automl.search_engine import SearchEngine


class AutoProphet:
    """Search over changepoint/seasonality prior scales and the
    changepoint range."""

    def __init__(self, changepoint_prior_scale=None,
                 seasonality_prior_scale=None, changepoint_range=None,
                 metric: str = "mse", name: str = "auto_prophet",
                 **prophet_config):
        self.search_space = {
            "changepoint_prior_scale":
                changepoint_prior_scale if changepoint_prior_scale
                is not None else hp.loguniform(0.001, 0.5),
            "seasonality_prior_scale":
                seasonality_prior_scale if seasonality_prior_scale
                is not None else hp.loguniform(0.01, 10.0),
            "changepoint_range":
                changepoint_range if changepoint_range is not None
                else hp.uniform(0.8, 0.95),
        }
        self.metric = metric
        self.name = name
        self.extra = dict(prophet_config)
        self._best = None

    def fit(self, data, validation_data=None, n_sampling: int = 8,
            search_algorithm: str = "random"):
        """data / validation_data: pandas frames with 'ds'/'y'."""
        from analytics_zoo_tpu_torch.orca.automl.metrics import Evaluator
        mode = Evaluator.get_metric_mode(self.metric)

        def trainable(config, state, add_epochs):
            if state is not None:
                return state, state[1]
            fc = ProphetForecaster(
                changepoint_prior_scale=float(
                    config["changepoint_prior_scale"]),
                seasonality_prior_scale=float(
                    config["seasonality_prior_scale"]),
                changepoint_range=float(config["changepoint_range"]),
                metric=self.metric, **self.extra)
            stats = fc.fit(data, validation_data)
            score = float(stats[self.metric])
            return (fc, score), score

        engine = SearchEngine(trainable, self.search_space,
                              metric_mode=mode, n_sampling=n_sampling,
                              epochs=1, search_algorithm=search_algorithm)
        self._best = engine.run()
        self._trials = engine.trial_table()
        return self

    def get_best_model(self) -> ProphetForecaster:
        if self._best is None:
            raise RuntimeError("call fit first")
        return self._best.state[0]

    def get_best_config(self) -> Dict:
        if self._best is None:
            raise RuntimeError("call fit first")
        return dict(self._best.config)
