"""TCN forecaster (counterpart of
analytics_zoo_tpu/chronos/forecaster/tcn_forecaster.py): stacked
dilated causal conv blocks with residuals, a dense head onto the
horizon.

Block i has dilation 2^i.  Each causal conv is `F.pad` on the left by
(kernel_size - 1) * dilation, then `nn.Conv1d(dilation=...)` with no
padding, so output t sees inputs <= t only (flax's `nn.Conv` on the
padded input, padding "VALID").  The blocks run on NCW tensors; the
forecaster takes and returns NWC ([batch, time, features]) as JAX's
does.  A 1x1 `downsample` conv maps the residual only where a block
changes the width.  The head reads the last step and reshapes to
[batch, horizon, output_feature_num].  flax's conv kernel (k, in, out)
is torch's weight (out, in, k) (`convert.tcn_forecaster_from_flax`).
Dropout draws its masks from the Estimator's generator in training.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.chronos.forecaster.base import BaseForecaster
from analytics_zoo_tpu_torch.keras.layers.self_attention import dropout
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    Dense,
    _lecun_normal_,
)


def _conv(in_ch: int, out_ch: int, kernel: int, dilation: int,
          device) -> nn.Conv1d:
    """flax's `nn.Conv(out_ch, (kernel,), kernel_dilation=dilation)`:
    lecun-normal kernel, zero bias."""
    conv = nn.Conv1d(in_ch, out_ch, kernel, dilation=dilation,
                     device=device)
    _lecun_normal_(conv.weight, in_ch * kernel)
    nn.init.zeros_(conv.bias)
    return conv


class _TemporalBlock(nn.Module):
    def __init__(self, in_ch: int, channels: int, kernel_size: int,
                 dilation: int, dropout: float, device):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.rate = dropout
        self.conv1 = _conv(in_ch, channels, kernel_size, dilation, device)
        self.conv2 = _conv(channels, channels, kernel_size, dilation, device)
        self.downsample = (_conv(in_ch, channels, 1, 1, device)
                           if in_ch != channels else None)

    def forward(self, x, generator=None):
        y = torch.relu(self.conv1(F.pad(x, (self.pad, 0))))
        y = dropout(y, self.rate, self.training, generator)
        y = torch.relu(self.conv2(F.pad(y, (self.pad, 0))))
        y = dropout(y, self.rate, self.training, generator)
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + res)


class TCN(nn.Module):
    """x [batch, time, input_feature_num] -> [batch, horizon,
    output_num] f32."""

    def __init__(self, input_feature_num: int, num_channels: Sequence[int],
                 kernel_size: int, dropout: float, horizon: int,
                 output_num: int, device=None):
        super().__init__()
        widths = [input_feature_num, *num_channels]
        self.blocks = nn.ModuleList(
            _TemporalBlock(a, b, kernel_size, 2 ** i, dropout, device)
            for i, (a, b) in enumerate(zip(widths, widths[1:])))
        self.horizon, self.output_num = horizon, output_num
        self.head = Dense(widths[-1], horizon * output_num, device=device)

    def forward(self, x, generator=None):
        h = x.float().transpose(1, 2)            # NWC -> NCW
        for block in self.blocks:
            h = block(h, generator)
        out = self.head(h[:, :, -1])
        return out.reshape(-1, self.horizon, self.output_num)


class TCNForecaster(BaseForecaster):
    def __init__(self, past_seq_len: int, future_seq_len: int = 1,
                 input_feature_num: int = 1, output_feature_num: int = 1,
                 num_channels=(30, 30, 30), kernel_size: int = 3,
                 dropout: float = 0.1, **kwargs):
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, **kwargs)
        self.num_channels = list(num_channels)
        self.kernel_size = kernel_size
        self.dropout = dropout

    def _build_module(self, device):
        return TCN(self.input_feature_num, tuple(self.num_channels),
                   self.kernel_size, self.dropout, self.future_seq_len,
                   self.output_feature_num, device=device)

    def _config(self):
        cfg = super()._config()
        cfg.update(num_channels=self.num_channels,
                   kernel_size=self.kernel_size, dropout=self.dropout)
        return cfg
