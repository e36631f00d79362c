"""The model-zoo base (counterpart of
analytics_zoo_tpu/models/common/zoo_model.py:18-127): a mixin over
`torch.nn.Module` with the convenience surface of the reference's
ZooModel (train, predict, save, load) on the port's Estimator.

A model records its constructor fields in `self._config` (what
`get_config` returns and `load_model` rebuilds it from), and its
`device` apart from them: a loaded model goes on the device its caller
names.  `save_model` writes the `state_dict` (`weights.pt`) and
`config.pkl`; encryption at rest (the JAX `serving/encrypt.py`) is not
ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import torch

_WEIGHTS = "weights.pt"
_CONFIG = "config.pkl"


def _no_encryption(key) -> None:
    if key is not None:
        raise NotImplementedError(
            "weights encrypted at rest are not ported yet (ROADMAP Queue "
            "1); save and load without a key")


class ZooModel:
    """Mixin over torch modules.  Subclasses set `self._config` and may
    override `default_loss` / `default_metrics`."""

    default_loss = "sparse_categorical_crossentropy"
    default_metrics = ("accuracy",)

    def estimator(self, *, optimizer="adam", learning_rate=None, loss=None,
                  metrics=None, **kwargs):
        """A new `Estimator.from_torch` over this module (keywords as
        there), kept as the one `fit` / `predict` / `evaluate` use."""
        from analytics_zoo_tpu_torch.orca.learn.estimator import Estimator
        est = Estimator.from_torch(
            self, loss=loss or self.default_loss, optimizer=optimizer,
            learning_rate=learning_rate,
            metrics=list(metrics) if metrics is not None
            else list(self.default_metrics), **kwargs)
        self._estimator = est
        return est

    def _require_estimator(self):
        est = getattr(self, "_estimator", None)
        return est if est is not None else self.estimator()

    def fit(self, data, **kwargs):
        return self._require_estimator().fit(data, **kwargs)

    def predict(self, data, **kwargs):
        return self._require_estimator().predict(data, **kwargs)

    def evaluate(self, data, **kwargs):
        return self._require_estimator().evaluate(data, **kwargs)

    def get_config(self) -> Dict[str, Any]:
        """The constructor fields, without `device`."""
        return dict(self._config)

    def save_model(self, path: str, encrypt_key: str = None) -> str:
        """Write the weights and the constructor fields under `path`."""
        _no_encryption(encrypt_key)
        os.makedirs(path, exist_ok=True)
        torch.save({k: v.detach().cpu() for k, v in self.state_dict().items()},
                   os.path.join(path, _WEIGHTS))
        with open(os.path.join(path, _CONFIG), "wb") as f:
            pickle.dump({"class": type(self).__name__,
                         "config": self.get_config()}, f)
        return path

    @classmethod
    def load_model(cls, path: str, decrypt_key: str = None, device=None):
        """The model `save_model` wrote under `path`, on `device` (None =
        the CUDA card).  `config.pkl` is unpickled: load only what this
        program saved."""
        _no_encryption(decrypt_key)
        with open(os.path.join(path, _CONFIG), "rb") as f:
            meta = pickle.load(f)
        if meta["class"] != cls.__name__:
            raise ValueError(f"{path} holds a {meta['class']}, not a "
                             f"{cls.__name__}")
        model = cls(**meta["config"], device=device)
        state = torch.load(os.path.join(path, _WEIGHTS),
                           map_location=model.device_, weights_only=True)
        model.load_state_dict(state)
        return model
