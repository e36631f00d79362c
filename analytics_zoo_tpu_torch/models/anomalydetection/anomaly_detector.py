"""LSTM anomaly detector (counterpart of
analytics_zoo_tpu/models/anomalydetection/anomaly_detector.py:20-59;
reference scala `models/anomalydetection/AnomalyDetector.scala`): stacked
LSTMs regressing the next point of a time series; the anomalies are the
points with the largest prediction error (`detect_anomalies`).

Each of `hidden_layers` is one `recurrent.lstm` (flax's
`OptimizedLSTMCell` under `nn.RNN`), over every position; dropout
between them (its mask from the engine's `generator` in training), the
last one's final step into a one-unit head.  All f32.  `unroll` and
`detect_anomalies` are the JAX module's numpy.  Weights come from a
flax tree through `convert.anomaly_detector_from_flax`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.keras.layers.self_attention import dropout
from analytics_zoo_tpu_torch.models.common import recurrent
from analytics_zoo_tpu_torch.models.common.zoo_model import ZooModel
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    Dense,
)


class AnomalyDetector(ZooModel, nn.Module):
    """x [b, unroll, features] -> prediction [b, 1] f32."""

    default_loss = "mse"
    default_metrics = ("mse",)

    def __init__(self, hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2),
                 feature_dim: int = 1, device=None):
        nn.Module.__init__(self)
        self._config = dict(hidden_layers=tuple(hidden_layers),
                            dropouts=tuple(dropouts),
                            feature_dim=feature_dim)
        self.device_ = dev = resolve_device(device)
        self.dropouts = tuple(dropouts)
        widths = [feature_dim, *hidden_layers]
        self.lstm = nn.ModuleList(recurrent.lstm(a, b, dev)
                                  for a, b in zip(widths, widths[1:]))
        self.head = Dense(widths[-1], 1, device=dev)

    def flax_layout(self):
        """(to_flax(state_dict), from_flax(tree)): the JAX module's
        param tree (`convert.anomaly_detector_to_flax` and
        `anomaly_detector_from_flax`)."""
        from analytics_zoo_tpu_torch import convert
        return (convert.anomaly_detector_to_flax,
                convert.anomaly_detector_from_flax)

    def forward(self, x, generator=None):
        x = x.float()
        for i, (cell, rate) in enumerate(zip(self.lstm, self.dropouts)):
            x = cell(x)[0]
            if i < len(self.lstm) - 1:
                x = dropout(x, rate, self.training, generator)
        return self.head(x[:, -1])

    @staticmethod
    def unroll(data: np.ndarray, unroll_length: int):
        """Sliding windows: series [n, d] -> (windows [m, unroll, d],
        targets [m]) (reference `unroll`, anomaly_detector.py)."""
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[:, None]
        m = len(data) - unroll_length
        if m <= 0:
            raise ValueError("series shorter than unroll_length")
        idx = np.arange(unroll_length)[None, :] + np.arange(m)[:, None]
        return data[idx], data[unroll_length:, 0]


def detect_anomalies(y_true, y_pred, anomaly_size: int = 5):
    """Top-`anomaly_size` largest absolute errors are anomalies (reference
    `detectAnomalies`).  Returns indices of anomalous points."""
    err = np.abs(np.asarray(y_true).ravel() - np.asarray(y_pred).ravel())
    k = min(anomaly_size, len(err))
    return np.argsort(err)[-k:][::-1]
