"""LSTM forecaster (counterpart of
analytics_zoo_tpu/chronos/forecaster/lstm_forecaster.py): stacked
LSTMs over the lookback window, a dense head onto the horizon.

Each layer is one `recurrent.lstm` (flax's `OptimizedLSTMCell` under
`nn.RNN`, over every step).  JAX applies dropout after every layer
whose rate is nonzero, the last one included; torch's
`nn.LSTM(dropout=)` drops only between layers, so the dropout here is a
step of its own after each layer, its mask drawn from the Estimator's
generator in training.  The head reads the last step.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from analytics_zoo_tpu_torch.chronos.forecaster.base import BaseForecaster
from analytics_zoo_tpu_torch.keras.layers.self_attention import dropout
from analytics_zoo_tpu_torch.models.common import recurrent
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    Dense,
)


class VanillaLSTM(nn.Module):
    """x [batch, time, input_feature_num] -> [batch, horizon,
    output_num] f32."""

    def __init__(self, input_feature_num: int, hidden_dim: Sequence[int],
                 dropout: Sequence[float], horizon: int, output_num: int,
                 device=None):
        super().__init__()
        widths = [input_feature_num, *hidden_dim]
        self.lstm = nn.ModuleList(recurrent.lstm(a, b, device)
                                  for a, b in zip(widths, widths[1:]))
        self.rates = tuple(dropout)
        self.horizon, self.output_num = horizon, output_num
        self.head = Dense(widths[-1], horizon * output_num, device=device)

    def forward(self, x, generator=None):
        x = x.float()
        for i, cell in enumerate(self.lstm):
            x = cell(x)[0]
            if i < len(self.rates) and self.rates[i]:
                x = dropout(x, self.rates[i], self.training, generator)
        out = self.head(x[:, -1])
        return out.reshape(-1, self.horizon, self.output_num)


class LSTMForecaster(BaseForecaster):
    def __init__(self, past_seq_len: int, input_feature_num: int = 1,
                 output_feature_num: int = 1, hidden_dim=32, layer_num=1,
                 dropout=0.1, future_seq_len: int = 1, **kwargs):
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, **kwargs)
        self.hidden_dim = ([hidden_dim] * layer_num
                           if isinstance(hidden_dim, int) else
                           list(hidden_dim))
        self.dropout = ([dropout] * layer_num
                        if isinstance(dropout, (int, float)) else
                        list(dropout))

    def _build_module(self, device):
        return VanillaLSTM(self.input_feature_num, tuple(self.hidden_dim),
                           tuple(self.dropout), self.future_seq_len,
                           self.output_feature_num, device=device)

    def _config(self):
        cfg = super()._config()
        cfg.update(hidden_dim=self.hidden_dim, dropout=self.dropout,
                   layer_num=len(self.hidden_dim))
        return cfg

    @classmethod
    def _from_config(cls, config: dict, device):
        # hidden_dim is already the per-layer list
        config = dict(config)
        config.pop("layer_num", None)
        return cls(**config, device=device)
