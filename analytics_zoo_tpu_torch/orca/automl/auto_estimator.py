"""AutoEstimator (counterpart of
analytics_zoo_tpu/orca/automl/auto_estimator.py): model creator +
search space -> the best fitted model.

`AutoEstimator.from_torch(model_creator)` (and `from_keras`, the same
call) takes `model_creator(config) -> Estimator`, an
`analytics_zoo_tpu_torch.orca.learn.Estimator` built with the config's
hyperparameters, or anything with fit / evaluate.  The JAX package's
`from_flax` takes a flax module, which the port cannot import, so the
port has no `from_flax`.  With `backend="process"` the best trial comes
back from its worker as numpy parameters and buffers, and the parent
rebuilds it: `model_creator(config)` (on the parent's device) and
`set_params` with both, where JAX sets `_params` / `_model_state`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from analytics_zoo_tpu_torch.orca.automl.search_engine import (
    SearchEngine,
    Trial,
)


class _EstimatorTrainable:
    """Picklable trainable: a module-level class, so the process
    backend can ship it to spawned workers; the model and data creators
    themselves must be picklable for that path."""

    def __init__(self, model_creator, data, val, metric, batch_size,
                 feature_cols, label_cols, fit_kwargs):
        self.model_creator = model_creator
        self.data = data
        self.val = val
        self.metric = metric
        self.batch_size = batch_size
        self.feature_cols = feature_cols
        self.label_cols = label_cols
        self.fit_kwargs = fit_kwargs

    def __call__(self, config, state, add_epochs):
        est = state if state is not None else self.model_creator(config)
        bs = int(config.get("batch_size", self.batch_size))
        est.fit(self.data, epochs=add_epochs, batch_size=bs,
                feature_cols=self.feature_cols,
                label_cols=self.label_cols, **self.fit_kwargs)
        stats = est.evaluate(self.val, batch_size=bs,
                             feature_cols=self.feature_cols,
                             label_cols=self.label_cols)
        if self.metric not in stats:
            raise KeyError(
                f"metric '{self.metric}' not in evaluate() stats "
                f"{sorted(stats)}")
        return est, stats[self.metric]


def _state_dict(params, model_state) -> Dict[str, Any]:
    """An exported (parameters, buffers) pair as one state_dict of
    tensors, for `set_params`."""
    import torch

    merged = dict(params)
    merged.update(model_state)
    return {k: torch.as_tensor(v) for k, v in merged.items()}


class AutoEstimator:
    """`model_creator(config) -> Estimator`.  The search minimizes or
    maximizes `metric` on the validation data."""

    def __init__(self, model_creator: Callable[[Dict], Any],
                 metric: str = "loss", metric_mode: str = "min"):
        self.model_creator = model_creator
        self.metric = metric
        self.metric_mode = metric_mode
        self.best_trial: Optional[Trial] = None
        self._engine: Optional[SearchEngine] = None

    @staticmethod
    def from_torch(model_creator: Callable[[Dict], Any], *,
                   metric: str = "loss", metric_mode: str = "min"
                   ) -> "AutoEstimator":
        """`model_creator(config)` returns an orca Estimator built from a
        torch module with the config's hyperparameters applied."""
        return AutoEstimator(model_creator, metric, metric_mode)

    # the reference's naming: a Keras model's Estimator is made the same
    # way (`Estimator.from_keras` inside the creator)
    from_keras = from_torch

    def fit(self, data, *, validation_data=None, search_space: Dict,
            n_sampling: int = 4, epochs: int = 1, batch_size: int = 32,
            grace_epochs: int = 1, feature_cols=None, label_cols=None,
            parallelism: int = 1, backend: str = "thread",
            search_alg: str = "random", **fit_kwargs):
        """Run the search.  `parallelism` / `backend` control concurrent
        trials (`SearchEngine`); with backend="process" the creators
        must be picklable, and build their models on the CPU."""
        val = validation_data if validation_data is not None else data
        trainable = _EstimatorTrainable(
            self.model_creator, data, val, self.metric, batch_size,
            feature_cols, label_cols, fit_kwargs)

        self._engine = SearchEngine(
            trainable, search_space, metric_mode=self.metric_mode,
            n_sampling=n_sampling, epochs=epochs,
            grace_epochs=grace_epochs, parallelism=parallelism,
            backend=backend, search_algorithm=search_alg)
        self.best_trial = self._engine.run()
        if parallelism > 1 and backend == "process":
            # the engine raises if the export failed; an Estimator's
            # export is rebuilt here with the trained weights, a raw
            # picklable state passes through unchanged
            kind, payload = self.best_trial.state
            if kind == "estimator":
                est = self.model_creator(self.best_trial.config)
                est.set_params(_state_dict(*payload))
                self.best_trial.state = est
            else:
                self.best_trial.state = payload
        return self

    def get_best_model(self):
        if self.best_trial is None:
            raise RuntimeError("call fit first")
        return self.best_trial.state

    def get_best_config(self) -> Dict:
        if self.best_trial is None:
            raise RuntimeError("call fit first")
        return dict(self.best_trial.config)

    def get_trial_table(self):
        return self._engine.trial_table() if self._engine else []
