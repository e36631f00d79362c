"""Forecaster base (counterpart of
analytics_zoo_tpu/chronos/forecaster/base.py): fit / predict /
evaluate / save / load over the port's Estimator.

A forecaster resolves its device when it is made
(`resolve_device(device)`: None is the CUDA card, or a raise), builds
its torch module there on first use, its weights drawn from `seed`, and
trains it through `Estimator.from_torch(module, loss="mse",
optimizer=..., learning_rate=lr, metrics=["mse"], seed=seed)`, where
JAX uses `from_flax`.  Data: (x, y) tuples, {"x", "y"} dicts, or a
`TSDataset` (rolled here with the forecaster's lookback and horizon
unless its cached roll matches them: a predict-time horizon-0 roll never
poisons a later fit), or an `XShardsTSDataset`, rolled per shard and
streamed into the Estimator shard by shard (`_as_stream`), the caller's
roll state left as it was.  Both classes are looked up in
`sys.modules`, so importing this module loads no pandas.  `save` pickles the
config and the parameters as numpy, in torch's layout (JAX pickles its
flax tree); `load(path, device)` rebuilds the forecaster and restores
them through `Estimator.set_params`.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

from analytics_zoo_tpu_torch.device import resolve_device

#: the modules holding TSDataset and XShardsTSDataset, read from
#: sys.modules only
_TSDATASET = "analytics_zoo_tpu_torch.chronos.data.tsdataset"
_XSHARDS_TSDATASET = \
    "analytics_zoo_tpu_torch.chronos.data.experimental.xshards_tsdataset"


def is_tsdataset(data) -> bool:
    """Whether `data` is a port TSDataset (never imports pandas)."""
    mod = sys.modules.get(_TSDATASET)
    return mod is not None and isinstance(data, mod.TSDataset)


def is_xshards_tsdataset(data) -> bool:
    """Whether `data` is a port XShardsTSDataset (never imports it)."""
    mod = sys.modules.get(_XSHARDS_TSDATASET)
    return mod is not None and isinstance(data, mod.XShardsTSDataset)


def _resolve_data(data, lookback=None, horizon=None):
    """Accept (x, y) tuples, dict {'x','y'}, or a rolled/rollable
    TSDataset.  A cached roll is reused only when it matches the requested
    lookback/horizon — a predict-time roll (horizon=0) must never poison a
    later fit/evaluate, and a different forecaster's window length must
    never leak through."""
    if is_tsdataset(data):
        cache_ok = (data.numpy_x is not None
                    and (lookback is None or data.lookback == lookback)
                    and (horizon is None or data.horizon == horizon))
        if not cache_ok:
            if lookback is None or horizon is None:
                raise ValueError(
                    "TSDataset not rolled; call data.roll(lookback, horizon) "
                    "or construct the forecaster with past_seq_len/"
                    "future_seq_len")
            data.roll(lookback, horizon)
        x, y = data.to_numpy()
        return x, y
    if isinstance(data, dict):
        return data.get("x"), data.get("y")
    if isinstance(data, tuple):
        return data
    return data, None


class BaseForecaster:
    """Subclasses build their torch module in `_build_module(device)`."""

    loss = "mse"
    metrics = ("mse",)

    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_feature_num: int, output_feature_num: int,
                 optimizer: str = "adam", lr: float = 1e-3, seed: int = 0,
                 device=None):
        self.past_seq_len = past_seq_len
        self.future_seq_len = future_seq_len
        self.input_feature_num = input_feature_num
        self.output_feature_num = output_feature_num
        self._optimizer = optimizer
        self._lr = lr
        self._seed = seed
        self.device = resolve_device(device)
        self._est = None

    def _build_module(self, device: torch.device) -> torch.nn.Module:
        raise NotImplementedError

    def _estimator(self):
        if self._est is None:
            from analytics_zoo_tpu_torch.orca.learn.estimator import Estimator
            devices = [self.device] if self.device.type == "cuda" else []
            # the weights are drawn from `seed`, leaving the caller's
            # generators as they were
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed(self._seed)
                module = self._build_module(self.device)
            self._est = Estimator.from_torch(
                module, loss=self.loss, optimizer=self._optimizer,
                learning_rate=self._lr, metrics=list(self.metrics),
                seed=self._seed)
        return self._est

    def _as_stream(self, data, horizon):
        """An XShardsTSDataset's {"x", "y"} shards, rolled with this
        forecaster's lookback and `horizon`, to stream into the
        Estimator (None for other data).  The caller's roll state is
        restored afterwards: a predict-time horizon-0 roll never poisons
        the user's own later `to_xshards()` (`to_xshards` captures
        lookback and horizon by value, so restoring them after it is
        safe although the shard transforms run lazily)."""
        if not is_xshards_tsdataset(data):
            return None
        prev = (data.lookback, data.horizon)
        try:
            return data.roll(self.past_seq_len, horizon).to_xshards()
        finally:
            data.lookback, data.horizon = prev

    def fit(self, data, epochs: int = 1, batch_size: int = 32, **kwargs):
        stream = self._as_stream(data, self.future_seq_len)
        if stream is not None:
            self._estimator().fit(stream, epochs=epochs,
                                  batch_size=batch_size, **kwargs)
            return self
        x, y = _resolve_data(data, self.past_seq_len, self.future_seq_len)
        if y is None:
            raise ValueError("fit requires targets")
        y = _shape_y(y, self.future_seq_len, self.output_feature_num)
        self._estimator().fit({"x": x, "y": y}, epochs=epochs,
                              batch_size=batch_size, **kwargs)
        return self

    def predict(self, data, batch_size: int = 32):
        # horizon 0: the newest windows — the forecast past the end of
        # the observed data — are kept, not dropped for lack of future
        # rows
        stream = self._as_stream(data, 0)
        if stream is not None:
            return self._estimator().predict(stream, batch_size=batch_size)
        x, _ = _resolve_data(data, self.past_seq_len, 0)
        return self._estimator().predict({"x": x}, batch_size=batch_size)

    def evaluate(self, data, batch_size: int = 32):
        stream = self._as_stream(data, self.future_seq_len)
        if stream is not None:
            return self._estimator().evaluate(stream, batch_size=batch_size)
        x, y = _resolve_data(data, self.past_seq_len, self.future_seq_len)
        if y is None:
            raise ValueError("evaluate requires targets")
        y = _shape_y(y, self.future_seq_len, self.output_feature_num)
        return self._estimator().evaluate({"x": x, "y": y},
                                          batch_size=batch_size)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        params = None
        if self._est is not None:
            params = {k: v.detach().cpu().numpy() for k, v in
                      self._est.get_model().state_dict().items()}
        payload = {"config": self._config(), "class": type(self).__name__,
                   "params": params}
        with open(path, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        return path

    def _config(self):
        return dict(past_seq_len=self.past_seq_len,
                    future_seq_len=self.future_seq_len,
                    input_feature_num=self.input_feature_num,
                    output_feature_num=self.output_feature_num,
                    optimizer=self._optimizer, lr=self._lr)

    @classmethod
    def _from_config(cls, config: dict, device):
        return cls(**config, device=device)

    @classmethod
    def load(cls, path: str, device=None):
        """The forecaster saved at `path`, on `device` (None: the CUDA
        card)."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        model = cls._from_config(payload["config"], device)
        if payload["params"] is not None:
            model._estimator().set_params(
                {k: torch.from_numpy(v) for k, v in
                 payload["params"].items()})
        return model


def _shape_y(y: np.ndarray, horizon: int, n_out: int) -> np.ndarray:
    y = np.asarray(y, np.float32)
    if y.ndim == 1:
        y = y[:, None]
    if y.ndim == 2:
        y = y[:, :, None] if y.shape[1] == horizon else y[:, None, :]
    return y
