"""Anomaly detectors (counterpart of
analytics_zoo_tpu/chronos/detector/anomaly/detectors.py): `fit(y)`,
then `score()` and `anomaly_indexes()`.

* `ThresholdDetector`: numpy, on the host as in JAX.
* `AEDetector`: a dense tanh autoencoder over rolled, standardized
  windows, trained on the port's Estimator on `device` (None: the CUDA
  card, or a raise); a point's score is the reconstruction error of the
  window it ends.  The autoencoder's weights are drawn on the CPU from
  a fixed seed and then moved, so the same detector starts from the
  same weights on every device.
* `DBScanDetector`: sklearn's DBSCAN, imported inside `fit`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    Dense,
)


class ThresholdDetector:
    """Threshold on |y - y_hat| or on absolute bounds."""

    def __init__(self):
        self.th = (-np.inf, np.inf)
        self.ratio = 0.01
        self._scores = None

    def set_params(self, mode: str = "default", ratio: float = 0.01,
                   threshold=(-np.inf, np.inf)):
        self.ratio = ratio
        self.th = threshold
        return self

    def fit(self, y: np.ndarray, y_pred: Optional[np.ndarray] = None):
        y = np.asarray(y, np.float32).ravel()
        if y_pred is not None:
            err = np.abs(y - np.asarray(y_pred, np.float32).ravel())
            if np.isscalar(self.th) or isinstance(self.th, float):
                cut = float(self.th)
            else:
                cut = np.quantile(err, 1 - self.ratio)
            self._scores = (err > cut).astype(np.float32) * err
        else:
            if np.isscalar(self.th):
                lo, hi = -np.inf, float(self.th)
            else:
                lo, hi = self.th
            out = (y < lo) | (y > hi)
            self._scores = out.astype(np.float32) * np.abs(y)
        return self

    def score(self) -> np.ndarray:
        if self._scores is None:
            raise RuntimeError("call fit first")
        return self._scores

    def anomaly_indexes(self) -> np.ndarray:
        return np.nonzero(self.score() > 0)[0]


class AE(nn.Module):
    """flax's `Dense(hidden), tanh, Dense(width)` (`enc`, `dec`)."""

    def __init__(self, width: int, hidden: int, device=None):
        super().__init__()
        self.enc = Dense(width, hidden, device=device)
        self.dec = Dense(hidden, width, device=device)

    def forward(self, x):
        return self.dec(torch.tanh(self.enc(x.float())))


class AEDetector:
    """Autoencoder reconstruction-error detector over rolled windows;
    the anomalies are the `ratio` largest reconstruction errors."""

    #: the seed of the autoencoder's weights (JAX's Estimator default)
    seed = 0

    def __init__(self, roll_len: int = 24, ratio: float = 0.1,
                 compress_rate: float = 0.8, batch_size: int = 100,
                 epochs: int = 20, lr: float = 1e-3, device=None):
        self.roll_len = roll_len
        self.ratio = ratio
        self.compress_rate = compress_rate
        self.batch_size = batch_size
        self.epochs = epochs
        self.lr = lr
        self.device = resolve_device(device)
        self._est = None
        self._scores = None

    def _windows(self, y: np.ndarray):
        """(the flat series, its standardized windows [n, roll_len])."""
        flat = np.asarray(y, np.float32).ravel()
        n = len(flat) - self.roll_len + 1
        if self.roll_len > 1:
            if n <= 0:
                raise ValueError("series shorter than roll_len")
            idx = np.arange(self.roll_len)[None, :] + np.arange(n)[:, None]
            windows = flat[idx]
        else:
            windows = flat[:, None]
        mu, sd = windows.mean(), windows.std() + 1e-8
        return flat, (windows - mu) / sd

    def _estimator(self, width: int):
        """The autoencoder's Estimator, its weights drawn on the CPU."""
        from analytics_zoo_tpu_torch.orca.learn.estimator import Estimator
        hidden = max(2, int(width * self.compress_rate))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            module = AE(width, hidden).to(self.device)
        return Estimator.from_torch(module, loss="mse", optimizer="adam",
                                    learning_rate=self.lr, seed=self.seed)

    def _score(self, flat: np.ndarray, win_n: np.ndarray) -> np.ndarray:
        """Each point's score: the mean squared reconstruction error of
        the window it ends (0 for the first roll_len - 1 points)."""
        recon = self._est.predict({"x": win_n}, batch_size=self.batch_size)
        scores = np.zeros(len(flat), np.float32)
        scores[self.roll_len - 1:] = ((recon - win_n) ** 2).mean(axis=1)
        return scores

    def fit(self, y: np.ndarray):
        flat, win_n = self._windows(y)
        self._est = self._estimator(win_n.shape[1])
        self._est.fit({"x": win_n, "y": win_n}, epochs=self.epochs,
                      batch_size=self.batch_size)
        self._scores = self._score(flat, win_n)
        return self

    def score(self) -> np.ndarray:
        if self._scores is None:
            raise RuntimeError("call fit first")
        return self._scores

    def anomaly_indexes(self) -> np.ndarray:
        s = self.score()
        k = max(1, int(len(s) * self.ratio))
        return np.sort(np.argsort(s)[-k:])


class DBScanDetector:
    """DBSCAN outlier detector: the points sklearn's DBSCAN labels -1
    are anomalies."""

    def __init__(self, eps: float = 0.5, min_samples: int = 5, **kwargs):
        self.eps = eps
        self.min_samples = min_samples
        self.kwargs = kwargs
        self._labels = None

    def fit(self, y: np.ndarray):
        from sklearn.cluster import DBSCAN
        y = np.asarray(y, np.float32).reshape(-1, 1)
        self._labels = DBSCAN(eps=self.eps, min_samples=self.min_samples,
                              **self.kwargs).fit_predict(y)
        return self

    def score(self) -> np.ndarray:
        if self._labels is None:
            raise RuntimeError("call fit first")
        return (self._labels == -1).astype(np.float32)

    def anomaly_indexes(self) -> np.ndarray:
        return np.nonzero(self.score() > 0)[0]
