"""ConvLSTM2D and ConvLSTM3D (counterpart of
analytics_zoo_tpu/keras/layers/convolutional_recurrent.py), channels-
last: [b, t, *spatial, c] -> [b, t, *spatial, filters] (or the last
step with return_sequences=False).

flax's `ConvLSTMCell` has no torch counterpart; this is its source's
step: two convolutions of 4 * filters outputs, `ih` over the input and
`hh` over h, each with a bias, "SAME" padded, stride 1; their sum split
in the order (i, g, f, o); f = sigmoid(f + 1) (the forget bias added in
the forward pass); c' = f * c + sigmoid(i) * tanh(g); h' = sigmoid(o) *
tanh(c').  The carry starts at zeros.  `ih` runs over every step at
once (time folded into the batch), `hh` once a step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.conv import ConvND, _tup
from analytics_zoo_tpu_torch.keras.layers.core import floating


class _ConvLSTMCell(nn.Module):
    def __init__(self, in_ch: int, filters: int, kernel: Tuple[int, ...],
                 device=None):
        super().__init__()
        ones = (1,) * len(kernel)
        self.filters = filters
        self.ih = ConvND(in_ch, 4 * filters, kernel, ones, device=device)
        self.hh = ConvND(filters, 4 * filters, kernel, ones, device=device)

    def forward(self, x):
        x = floating(x)
        b, t = x.shape[:2]
        gx = self.ih(x.reshape((b * t,) + tuple(x.shape[2:])))
        gx = gx.reshape((b, t) + tuple(gx.shape[1:]))
        h = x.new_zeros(gx.shape[:1] + gx.shape[2:-1] + (self.filters,))
        c = torch.zeros_like(h)
        outs = []
        for step in range(t):
            i, g, f, o = (gx[:, step] + self.hh(h)).chunk(4, dim=-1)
            c = torch.sigmoid(f + 1) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1)


class _ConvLSTMND(Layer):
    """The shared recurrence; 2-D and 3-D differ in the kernel's rank."""

    _rank = 2

    def __init__(self, filters: int, kernel_size, strides=1,
                 return_sequences: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.filters = filters
        self.kernel_size = _tup(kernel_size, self._rank)
        if _tup(strides, self._rank) != (1,) * self._rank:
            raise ValueError(
                f"{type(self).__name__} supports stride 1 only "
                "(matching flax ConvLSTMCell; the reference's strided "
                "variant subsamples inputs before the recurrence)")
        self.return_sequences = return_sequences

    def build(self, x):
        return _ConvLSTMCell(x.shape[-1], self.filters, self.kernel_size,
                             x.device)

    def apply(self, m, x, training=False, generator=None, impl="auto"):
        out = m(x)
        return out if self.return_sequences else out[:, -1]


class ConvLSTM2D(_ConvLSTMND):
    """Input [b, t, h, w, c]."""

    _rank = 2


class ConvLSTM3D(_ConvLSTMND):
    """Input [b, t, d, h, w, c]."""

    _rank = 3
