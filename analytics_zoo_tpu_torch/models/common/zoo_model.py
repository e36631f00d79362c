"""The model-zoo base (counterpart of
analytics_zoo_tpu/models/common/zoo_model.py:18-127): a mixin over
`torch.nn.Module` with the convenience surface of the reference's
ZooModel (train, predict, save, load) on the port's Estimator.

A model records its constructor fields in `self._config` (what
`get_config` returns and `load_model` rebuilds it from), and its
`device` apart from them: a loaded model goes on the device its caller
names.  `save_model` writes the `state_dict` (`weights.pt`, or with
`encrypt_key` the same bytes encrypted at rest as `weights.pt.enc`,
`serving/encrypt.py`) and `config.pkl`; loaders prefer the encrypted
file, as JAX's do (zoo_model.py:61-127).
"""

from __future__ import annotations

import io
import os
import pickle
from typing import Any, Dict

import torch

_WEIGHTS = "weights.pt"
_ENCRYPTED = _WEIGHTS + ".enc"
_CONFIG = "config.pkl"


def read_state(path: str, decrypt_key: str = None, map_location=None):
    """The state_dict a `save_model` directory holds: `weights.pt.enc`
    decrypted with `decrypt_key` when it exists (JAX's
    `_read_weights`: a missing key raises ValueError), else
    `weights.pt`."""
    enc = os.path.join(path, _ENCRYPTED)
    if os.path.exists(enc):
        if decrypt_key is None:
            raise ValueError(
                f"{enc} is encrypted at rest; pass decrypt_key")
        from analytics_zoo_tpu_torch.serving.encrypt import decrypt_bytes
        with open(enc, "rb") as f:
            blob = decrypt_bytes(f.read(), decrypt_key)
        return torch.load(io.BytesIO(blob), map_location=map_location,
                          weights_only=True)
    return torch.load(os.path.join(path, _WEIGHTS),
                      map_location=map_location, weights_only=True)


def write_model(path: str, state_dict, class_name: str,
                config: Dict[str, Any], encrypt_key: str = None) -> str:
    """The `save_model` directory for a state_dict, a class name and
    the constructor fields: `weights.pt` (or `weights.pt.enc`, encrypted
    at rest with `encrypt_key`) and `config.pkl`.  A re-save removes the
    other variant, which loaders would otherwise prefer or fall back
    to."""
    os.makedirs(path, exist_ok=True)
    buf = io.BytesIO()
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, buf)
    blob = buf.getvalue()
    if encrypt_key is not None:
        from analytics_zoo_tpu_torch.serving.encrypt import encrypt_bytes
        blob = encrypt_bytes(blob, encrypt_key)
        name, other = _ENCRYPTED, _WEIGHTS
    else:
        name, other = _WEIGHTS, _ENCRYPTED
    with open(os.path.join(path, name), "wb") as f:
        f.write(blob)
    if os.path.exists(os.path.join(path, other)):
        os.remove(os.path.join(path, other))
    with open(os.path.join(path, _CONFIG), "wb") as f:
        pickle.dump({"class": class_name, "config": config}, f)
    return path


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
        """Write the weights and the constructor fields under `path`
        (`write_model`); with `encrypt_key` the weights are encrypted at
        rest: load them with the same key."""
        return write_model(path, self.state_dict(), type(self).__name__,
                           self.get_config(), encrypt_key)

    @classmethod
    def load_model(cls, path: str, decrypt_key: str = None, device=None):
        """The model `save_model` wrote under `path`, on `device` (None =
        the CUDA card), decrypting encrypted weights with `decrypt_key`.
        `config.pkl` is unpickled: load only what this program saved."""
        with open(os.path.join(path, _CONFIG), "rb") as f:
            meta = pickle.load(f)
        if meta["class"] != cls.__name__:
            raise ValueError(f"{path} holds a {meta['class']}, not a "
                             f"{cls.__name__}")
        model = cls(**meta["config"], device=device)
        model.load_state_dict(read_state(path, decrypt_key, model.device_))
        return model
