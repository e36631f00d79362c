"""AutoXGBoost (counterpart of analytics_zoo_tpu/orca/automl/xgboost.py):
`AutoXGBClassifier` / `AutoXGBRegressor`, a hyperparameter search over
boosted trees on the port's SearchEngine (its thread backend), each
ASHA rung adding `rounds_per_epoch` boosting rounds by warm start.  The
trees are the xgboost package's where it is installed, else the native
histogram GBDT (`orca/automl/gbdt.py`), on the host as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from analytics_zoo_tpu_torch.orca.automl.gbdt import xgboost_backend
from analytics_zoo_tpu_torch.orca.automl.search_engine import SearchEngine


_CLF_METRICS: Dict[str, tuple] = {
    # name -> (score_fn(pred, y), mode)
    "error": (lambda p, y: float((p != y).mean()), "min"),
    "accuracy": (lambda p, y: float((p == y).mean()), "max"),
}
_REG_METRICS: Dict[str, tuple] = {
    "mse": (lambda p, y: float(np.mean((p - y) ** 2)), "min"),
    "rmse": (lambda p, y: float(np.sqrt(np.mean((p - y) ** 2))), "min"),
    "mae": (lambda p, y: float(np.mean(np.abs(p - y))), "min"),
}


class _AutoXGBBase:
    _cls_attr = None
    _metrics: Dict[str, tuple] = {}
    _default_metric = ""

    def __init__(self, metric: Optional[str] = None,
                 metric_mode: Optional[str] = None, **fixed_params):
        metric = metric or self._default_metric
        if metric not in self._metrics:
            raise ValueError(
                f"unknown metric '{metric}' for {type(self).__name__}; "
                f"known: {sorted(self._metrics)}")
        self.metric = metric
        self._score, default_mode = self._metrics[metric]
        self.metric_mode = metric_mode or default_mode
        self.fixed_params = fixed_params
        self.best_model = None
        self.best_config: Optional[Dict] = None
        self._engine: Optional[SearchEngine] = None

    def fit(self, data, validation_data=None, *, search_space: Dict,
            n_sampling: int = 4, epochs: int = 1,
            rounds_per_epoch: int = 50, parallelism: int = 1):
        """data/validation_data: (x, y) ndarray tuples.  `epochs` are
        ASHA rungs; each adds `rounds_per_epoch` boosting rounds via
        xgboost warm-start, so early stopping prunes cheap short models
        before the full round budget is spent."""
        cls = getattr(xgboost_backend(), self._cls_attr)
        x, y = (np.asarray(a) for a in data)
        vx, vy = ((np.asarray(a) for a in validation_data)
                  if validation_data is not None else (x, y))
        score = self._score

        def trainable(config, state, add_epochs):
            params = {**self.fixed_params, **config}
            params.pop("n_estimators", None)
            model = cls(n_estimators=rounds_per_epoch * add_epochs,
                        **params)
            model.fit(x, y, xgb_model=(state.get_booster()
                                       if state is not None else None))
            return model, score(model.predict(vx), vy)

        self._engine = SearchEngine(
            trainable, search_space, metric_mode=self.metric_mode,
            n_sampling=n_sampling, epochs=epochs,
            parallelism=parallelism, backend="thread")
        best = self._engine.run()
        self.best_model = best.state
        self.best_config = dict(best.config)
        return self

    def predict(self, x):
        if self.best_model is None:
            raise RuntimeError("call fit first")
        return self.best_model.predict(np.asarray(x))

    def get_best_model(self):
        return self.best_model

    def get_best_config(self):
        return self.best_config


class AutoXGBClassifier(_AutoXGBBase):
    _cls_attr = "XGBClassifier"
    _metrics = _CLF_METRICS
    _default_metric = "error"


class AutoXGBRegressor(_AutoXGBBase):
    _cls_attr = "XGBRegressor"
    _metrics = _REG_METRICS
    _default_metric = "mse"
