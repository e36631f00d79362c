"""AutoARIMA (counterpart of
analytics_zoo_tpu/chronos/autots/model/auto_arima.py): a search over
the native seasonal ARIMA's orders on the port's SearchEngine, on the
host as in JAX."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from analytics_zoo_tpu_torch.chronos.forecaster.arima_forecaster import (
    ARIMAForecaster,
)
from analytics_zoo_tpu_torch.orca.automl import hp
from analytics_zoo_tpu_torch.orca.automl.search_engine import SearchEngine


class AutoARIMA:
    """Search over (p, q, P, Q, m, seasonal) for the native
    ARIMAForecaster.  Each argument is a fixed value or an hp sampling
    expression."""

    def __init__(self, p=None, q=None, seasonal=True, P=None, Q=None,
                 m: int = 7, metric: str = "mse",
                 name: str = "auto_arima", **arima_config):
        self.search_space = {
            "p": p if p is not None else hp.randint(0, 3),
            "q": q if q is not None else hp.randint(0, 3),
            "seasonal": seasonal,
            "P": P if P is not None else hp.randint(0, 2),
            "Q": Q if Q is not None else hp.randint(0, 2),
            "m": m,
        }
        self.metric = metric
        self.name = name
        self.extra = dict(arima_config)
        self._best = None

    def fit(self, data, validation_data=None, n_sampling: int = 8,
            metric_threshold: Optional[float] = None,
            search_algorithm: str = "random"):
        """data / validation_data: 1-D numpy arrays.  Each trial fits
        one full CSS ARIMA: a trial is one "epoch", so the ASHA schedule
        is a flat race, right for closed-form-ish fits."""
        data = np.asarray(data, np.float64).reshape(-1)
        if validation_data is not None:
            validation_data = np.asarray(validation_data,
                                         np.float64).reshape(-1)

        from analytics_zoo_tpu_torch.orca.automl.metrics import Evaluator
        mode = Evaluator.get_metric_mode(self.metric)

        def trainable(config, state, add_epochs):
            if state is not None:       # ARIMA has no incremental epochs
                return state, state[1]
            fc = ARIMAForecaster(
                p=int(config["p"]), q=int(config["q"]),
                seasonality_mode=bool(config["seasonal"]),
                P=int(config["P"]), Q=int(config["Q"]),
                m=int(config["m"]), metric=self.metric, **self.extra)
            try:
                stats = fc.fit(data, validation_data)
                score = float(stats[self.metric])
            except ValueError:
                # an order too rich for the series length loses the race
                # instead of killing the search
                fc = None
                score = float("inf") if mode == "min" else float("-inf")
            return (fc, score), score

        engine = SearchEngine(trainable, self.search_space,
                              metric_mode=mode, n_sampling=n_sampling,
                              epochs=1, search_algorithm=search_algorithm)
        self._best = engine.run()
        self._trials = engine.trial_table()
        return self

    def get_best_model(self) -> ARIMAForecaster:
        if self._best is None:
            raise RuntimeError("call fit first")
        model = self._best.state[0]
        if model is None:
            raise RuntimeError(
                "no sampled ARIMA order could be fitted (every trial "
                "found the series too short for its (p,q)(P,Q,m) span) "
                "— provide a longer series or a smaller search space")
        return model

    def get_best_config(self) -> Dict:
        if self._best is None:
            raise RuntimeError("call fit first")
        return dict(self._best.config)
