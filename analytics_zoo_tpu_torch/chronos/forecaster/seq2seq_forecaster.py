"""Seq2Seq forecaster (counterpart of
analytics_zoo_tpu/chronos/forecaster/seq2seq_forecaster.py): an LSTM
encoder over the lookback, an LSTM decoder rolled out over the horizon.

The encoder is a stack of one-layer LSTMs (`recurrent.lstm`), each
layer's final state kept.  The decoder is a closed loop over `horizon`
steps with one `nn.LSTMCell` a layer (`recurrent.lstm_cell`), starting
from the encoder's states: its first input is the encoder's top output
at the last step, each later input the top decoder cell's hidden state
(not the head's output, JAX seq2seq_forecaster.py:38-46), and the head
maps each step's top hidden state to the outputs.  flax's carry is
(c, h), torch's state (h, c).
"""

from __future__ import annotations

import torch
from torch import nn

from analytics_zoo_tpu_torch.chronos.forecaster.base import BaseForecaster
from analytics_zoo_tpu_torch.models.common import recurrent
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    Dense,
)


class Seq2SeqForecastNet(nn.Module):
    """x [batch, time, input_feature_num] -> [batch, horizon,
    output_num] f32."""

    def __init__(self, input_feature_num: int, lstm_hidden_dim: int,
                 lstm_layer_num: int, horizon: int, output_num: int,
                 device=None):
        super().__init__()
        w = lstm_hidden_dim
        self.enc_cells = nn.ModuleList(
            recurrent.lstm(input_feature_num if i == 0 else w, w, device)
            for i in range(lstm_layer_num))
        self.dec_cells = nn.ModuleList(
            recurrent.lstm_cell(w, w, device) for _ in range(lstm_layer_num))
        self.horizon = horizon
        self.head = Dense(w, output_num, device=device)

    def forward(self, x):
        h = x.float()
        states = []
        for cell in self.enc_cells:
            h, (h_n, c_n) = cell(h)
            states.append((h_n[0], c_n[0]))
        step_in = h[:, -1]
        outs = []
        for _ in range(self.horizon):
            z = step_in
            for i, cell in enumerate(self.dec_cells):
                states[i] = cell(z, states[i])
                z = states[i][0]
            outs.append(self.head(z))
            step_in = z
        return torch.stack(outs, dim=1)


class Seq2SeqForecaster(BaseForecaster):
    def __init__(self, past_seq_len: int, future_seq_len: int = 1,
                 input_feature_num: int = 1, output_feature_num: int = 1,
                 lstm_hidden_dim: int = 64, lstm_layer_num: int = 2,
                 **kwargs):
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, **kwargs)
        self.lstm_hidden_dim = lstm_hidden_dim
        self.lstm_layer_num = lstm_layer_num

    def _build_module(self, device):
        return Seq2SeqForecastNet(
            self.input_feature_num, self.lstm_hidden_dim,
            self.lstm_layer_num, self.future_seq_len,
            self.output_feature_num, device=device)

    def _config(self):
        cfg = super()._config()
        cfg.update(lstm_hidden_dim=self.lstm_hidden_dim,
                   lstm_layer_num=self.lstm_layer_num)
        return cfg
