"""AutoTSEstimator (counterpart of
analytics_zoo_tpu/chronos/autots/autotsestimator.py): builds a model's
search space, runs the AutoML search engine over forecasters made from
the sampled configs, and returns a `TSPipeline` of the best one.

`model` is "lstm", "tcn" or "seq2seq", whose forecasters train on
`device` (None: the CUDA card, or a raise), or one of the classical
legs, "arima" and "prophet": AutoARIMA / AutoProphet search the raw
target series (a TSDataset's first target, or an array; a ds/y frame
for Prophet) on the host, as in JAX, and the pipeline wraps the best
ARIMAForecaster / ProphetForecaster.  Trials run on the
`SearchEngine`'s default backend, as in JAX: one at a time in this
process.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

from analytics_zoo_tpu_torch.chronos.autots.tspipeline import TSPipeline
from analytics_zoo_tpu_torch.chronos.forecaster.base import is_tsdataset
from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.orca.automl import hp
from analytics_zoo_tpu_torch.orca.automl.search_engine import SearchEngine


def _default_space(model: str) -> Dict:
    if model == "lstm":
        return {"hidden_dim": hp.choice([16, 32, 64]),
                "layer_num": hp.choice([1, 2]),
                "lr": hp.loguniform(1e-3, 1e-2),
                "dropout": hp.uniform(0.0, 0.2)}
    if model == "tcn":
        return {"hidden_units": hp.choice([16, 30, 48]),
                "levels": hp.choice([2, 3]),
                "kernel_size": hp.choice([2, 3]),
                "lr": hp.loguniform(1e-3, 1e-2),
                "dropout": hp.uniform(0.0, 0.2)}
    if model == "seq2seq":
        return {"lstm_hidden_dim": hp.choice([16, 32, 64]),
                "lstm_layer_num": hp.choice([1, 2]),
                "lr": hp.loguniform(1e-3, 1e-2)}
    if model == "arima":
        # order grid for the NATIVE seasonal ARIMA (reference preset:
        # pyzoo/zoo/chronos/autots/model/auto_arima.py:1)
        return {"p": hp.randint(0, 3), "q": hp.randint(0, 3),
                "P": hp.randint(0, 2), "Q": hp.randint(0, 2),
                "seasonal": True, "m": 7}
    if model == "prophet":
        # prior-scale space for the NATIVE Prophet (reference preset:
        # pyzoo/zoo/chronos/autots/model/auto_prophet.py:51-57)
        return {"changepoint_prior_scale": hp.loguniform(0.001, 0.5),
                "seasonality_prior_scale": hp.loguniform(0.01, 10.0),
                "changepoint_range": hp.uniform(0.8, 0.95)}
    raise ValueError(
        f"unknown model '{model}'; known: lstm, tcn, seq2seq, arima, "
        "prophet")


class AutoTSEstimator:
    def __init__(self, model: str = "lstm",
                 search_space: Optional[Dict] = None,
                 past_seq_len: Union[int, None] = 24,
                 future_seq_len: int = 1,
                 input_feature_num: Optional[int] = None,
                 output_target_num: Optional[int] = None,
                 metric: str = "mse", metric_mode: str = "min",
                 device=None):
        self.model = model.lower()
        self.search_space = search_space or _default_space(self.model)
        self.past_seq_len = past_seq_len
        self.future_seq_len = future_seq_len
        self.input_feature_num = input_feature_num
        self.output_target_num = output_target_num
        self.metric = metric
        self.metric_mode = metric_mode
        self.device = resolve_device(device)
        self._best = None

    def _make_forecaster(self, config: Dict):
        lr = float(config.get("lr", 1e-3))
        common = dict(past_seq_len=self.past_seq_len,
                      future_seq_len=self.future_seq_len,
                      input_feature_num=self.input_feature_num,
                      output_feature_num=self.output_target_num,
                      lr=lr, device=self.device)
        if self.model == "lstm":
            from analytics_zoo_tpu_torch.chronos.forecaster import (
                LSTMForecaster)
            return LSTMForecaster(
                hidden_dim=int(config.get("hidden_dim", 32)),
                layer_num=int(config.get("layer_num", 1)),
                dropout=float(config.get("dropout", 0.1)), **common)
        if self.model == "tcn":
            from analytics_zoo_tpu_torch.chronos.forecaster import (
                TCNForecaster)
            levels = int(config.get("levels", 2))
            width = int(config.get("hidden_units", 30))
            return TCNForecaster(
                num_channels=[width] * levels,
                kernel_size=int(config.get("kernel_size", 3)),
                dropout=float(config.get("dropout", 0.1)), **common)
        if self.model == "seq2seq":
            from analytics_zoo_tpu_torch.chronos.forecaster import (
                Seq2SeqForecaster)
            return Seq2SeqForecaster(
                lstm_hidden_dim=int(config.get("lstm_hidden_dim", 32)),
                lstm_layer_num=int(config.get("lstm_layer_num", 1)),
                **common)
        raise ValueError(f"unknown model '{self.model}'")

    def fit(self, data, validation_data=None, epochs: int = 5,
            batch_size: int = 32, n_sampling: int = 4,
            grace_epochs: int = 1) -> TSPipeline:
        if self.model == "arima":
            return self._fit_arima(data, validation_data, n_sampling)
        if self.model == "prophet":
            return self._fit_prophet(data, validation_data, n_sampling)
        scaler = None
        if is_tsdataset(data):
            scaler = data.scaler
            if self.input_feature_num is None:
                self.input_feature_num = data.input_feature_num
            if self.output_target_num is None:
                self.output_target_num = data.output_target_num
            data.roll(self.past_seq_len, self.future_seq_len)
            x, y = data.to_numpy()
        else:
            x, y = data
        # torch needs the widths flax infers from the first batch
        if self.input_feature_num is None:
            self.input_feature_num = int(x.shape[-1])
        if self.output_target_num is None:
            self.output_target_num = int(y.shape[-1])
        if validation_data is not None:
            if is_tsdataset(validation_data):
                validation_data.roll(self.past_seq_len, self.future_seq_len)
                vx, vy = validation_data.to_numpy()
            else:
                vx, vy = validation_data
        else:
            vx, vy = x, y

        def trainable(config, state, add_epochs):
            fc = state or self._make_forecaster(config)
            bs = int(config.get("batch_size", batch_size))
            fc.fit((x, y), epochs=add_epochs, batch_size=bs)
            stats = fc.evaluate((vx, vy), batch_size=bs)
            return fc, stats[self.metric]

        engine = SearchEngine(trainable, self.search_space,
                              metric_mode=self.metric_mode,
                              n_sampling=n_sampling, epochs=epochs,
                              grace_epochs=grace_epochs)
        self._best = engine.run()
        self._trials = engine.trial_table()
        return TSPipeline(forecaster=self._best.state,
                          best_config=dict(self._best.config),
                          scaler=scaler)

    def _fit_arima(self, data, validation_data, n_sampling: int
                   ) -> TSPipeline:
        """Classical-model leg: search ARIMA orders over the raw target
        series (no windowing) and return an ARIMA-backed TSPipeline."""
        from analytics_zoo_tpu_torch.chronos.autots.model import AutoARIMA

        train = TSPipeline._series(data)
        val = (TSPipeline._series(validation_data)
               if validation_data is not None else None)
        space = dict(self.search_space)
        auto = AutoARIMA(p=space.get("p"), q=space.get("q"),
                         seasonal=space.get("seasonal", True),
                         P=space.get("P"), Q=space.get("Q"),
                         m=int(space.get("m", 7)), metric=self.metric)
        auto.fit(train, val, n_sampling=n_sampling)
        self._best = auto._best
        self._trials = auto._trials
        return TSPipeline(forecaster=auto.get_best_model(),
                          best_config=auto.get_best_config(),
                          scaler=None)

    def _fit_prophet(self, data, validation_data, n_sampling: int
                     ) -> TSPipeline:
        """Classical-model leg: search Prophet prior scales over the
        raw ds/y frame (no windowing)."""
        from analytics_zoo_tpu_torch.chronos.autots.model import AutoProphet
        from analytics_zoo_tpu_torch.orca.automl.hp import SampleSpace

        train = TSPipeline._frame(data)
        val = (TSPipeline._frame(validation_data)
               if validation_data is not None else None)
        space = dict(self.search_space)
        searched = ("changepoint_prior_scale",
                    "seasonality_prior_scale", "changepoint_range")
        extras = {k: v for k, v in space.items() if k not in searched}
        # extras go VERBATIM into the ProphetForecaster constructor: an
        # hp.* object there would never be sampled (it would reach
        # int()/float() as-is, or silently pin a value the user asked
        # to search) — refuse instead of misbehaving
        bad = [k for k, v in extras.items()
               if isinstance(v, SampleSpace)]
        if bad:
            raise ValueError(
                f"prophet leg only searches {searched}; {bad} must be "
                "static values (or use AutoProphet directly with a "
                "custom trainable)")
        auto = AutoProphet(
            changepoint_prior_scale=space.get("changepoint_prior_scale"),
            seasonality_prior_scale=space.get("seasonality_prior_scale"),
            changepoint_range=space.get("changepoint_range"),
            metric=self.metric, **extras)
        auto.fit(train, val, n_sampling=n_sampling)
        self._best = auto._best
        self._trials = auto._trials
        return TSPipeline(forecaster=auto.get_best_model(),
                          best_config=auto.get_best_config(),
                          scaler=None)

    def get_best_config(self) -> Dict:
        if self._best is None:
            raise RuntimeError("call fit first")
        return dict(self._best.config)
