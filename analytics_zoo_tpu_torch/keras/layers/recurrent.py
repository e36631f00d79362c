"""Recurrent layers (counterpart of analytics_zoo_tpu/keras/layers/
recurrent.py): LSTM, GRU, SimpleRNN, Bidirectional and TimeDistributed.

The cells are flax's `OptimizedLSTMCell`, `GRUCell` and `SimpleCell`,
held as one-layer `nn.LSTM` / `nn.GRU` / `nn.RNN` in flax's gate
layout (`models/common/recurrent.py`), run over every position (flax's
`nn.RNN` is given no lengths).  With the default activation (tanh), and
a `SimpleRNN`'s relu, the sequence goes through torch's fused RNN
(cuDNN on the card); a cell `activation` that cuDNN cannot take runs a
plain loop of flax's cell equations over the same weights.
`go_backwards` reverses the input in time; `return_sequences=False`
keeps the last step.  `Bidirectional`'s last step is the forward
cell's final state beside the backward cell's final state (after it
has read the whole reversed sequence), as JAX's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.core import (
    floating, get_activation)
from analytics_zoo_tpu_torch.models.common import recurrent


class Recurrent(nn.Module):
    """One flax cell (`kind` "lstm", "gru" or "simple") over x [b, t, f]
    -> every step's output [b, t, width].  `activation` None is flax's
    default tanh."""

    def __init__(self, kind: str, fan_in: int, width: int,
                 activation: Optional[Callable] = None, device=None):
        super().__init__()
        if kind == "simple" and activation is F.relu:
            # flax's SimpleCell(activation_fn=relu) is torch's relu RNN
            self.cell = recurrent.simple(fan_in, width, device, "relu")
            activation = None
        else:
            self.cell = recurrent.make(kind, fan_in, width, device)
        self.kind, self.activation = kind, activation

    def forward(self, x):
        x = floating(x)
        if self.activation is None:
            return self.cell(x)[0]
        return self._loop(x)

    def _loop(self, x):
        """flax's cell equations, one step at a time."""
        act = self.activation
        cell = self.cell
        w = cell.hidden_size
        gi = F.linear(x, cell.weight_ih_l0, cell.bias_ih_l0)  # [b, t, g*w]
        h = x.new_zeros(x.shape[0], w)
        c = x.new_zeros(x.shape[0], w)
        outs = []
        for t in range(x.shape[1]):
            gh = F.linear(h, cell.weight_hh_l0, cell.bias_hh_l0)
            if self.kind == "lstm":
                i, f, g, o = (gi[:, t] + gh).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * act(g)
                h = torch.sigmoid(o) * act(c)
            elif self.kind == "gru":
                xr, xz, xn = gi[:, t].chunk(3, dim=-1)
                hr, hz, hn = gh.chunk(3, dim=-1)
                r = torch.sigmoid(xr + hr)
                z = torch.sigmoid(xz + hz)
                n = act(xn + r * hn)
                h = (1.0 - z) * n + z * h
            else:
                h = act(gi[:, t] + gh)
            outs.append(h)
        return torch.stack(outs, dim=1)


class _RNNBase(Layer):
    kind = "lstm"

    def __init__(self, output_dim: int, activation=None,
                 return_sequences: bool = False,
                 go_backwards: bool = False, name: Optional[str] = None, **_):
        super().__init__(name)
        self.output_dim = output_dim
        # the cell's own activation (the reference's meaning), not a
        # transform of the outputs; tanh is the cell's default
        act = get_activation(activation) if activation is not None else None
        self.cell_activation = None if act is torch.tanh else act
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards

    def make_cell(self, fan_in: int, device) -> Recurrent:
        return Recurrent(self.kind, fan_in, self.output_dim,
                         self.cell_activation, device)

    def build(self, x):
        return self.make_cell(x.shape[-1], x.device)

    def apply(self, m, x, training=False, generator=None, impl="auto"):
        if self.go_backwards:
            x = x.flip(1)
        y = m(x)
        return y if self.return_sequences else y[:, -1]


class LSTM(_RNNBase):
    kind = "lstm"


class GRU(_RNNBase):
    kind = "gru"


class SimpleRNN(_RNNBase):
    kind = "simple"


class _Bidirectional(nn.Module):
    def __init__(self, layer: _RNNBase, fan_in: int, device=None):
        super().__init__()
        self.fwd = layer.make_cell(fan_in, device)
        self.bwd = layer.make_cell(fan_in, device)

    def forward(self, x):
        return self.fwd(x), self.bwd(x.flip(1))


class Bidirectional(Layer):
    """Runs the wrapped recurrent layer forward and backward and merges
    (concat, sum, ave or mul)."""

    def __init__(self, layer: _RNNBase, merge_mode: str = "concat",
                 name: Optional[str] = None):
        super().__init__(name)
        self.layer = layer
        self.merge_mode = merge_mode.lower()

    def build(self, x):
        return _Bidirectional(self.layer, x.shape[-1], x.device)

    def apply(self, m, x, training=False, generator=None, impl="auto"):
        y_f, y_b_rev = m(x)             # y_b_rev[:, -1]: the full sequence
        if self.layer.return_sequences:
            y_f_out, y_b_out = y_f, y_b_rev.flip(1)
        else:
            y_f_out, y_b_out = y_f[:, -1], y_b_rev[:, -1]
        if self.merge_mode == "concat":
            return torch.cat([y_f_out, y_b_out], dim=-1)
        if self.merge_mode == "sum":
            return y_f_out + y_b_out
        if self.merge_mode in ("ave", "average"):
            return (y_f_out + y_b_out) / 2
        if self.merge_mode == "mul":
            return y_f_out * y_b_out
        raise ValueError(f"unknown merge_mode '{self.merge_mode}'")


class TimeDistributed(Layer):
    """Apply a layer at every timestep: fold time into batch, apply,
    unfold.  Its module is the inner layer's, under the inner layer's
    name (as flax names it)."""

    def __init__(self, layer: Layer, name: Optional[str] = None):
        super().__init__(name)
        self.layer = layer

    @property
    def module_name(self) -> str:
        return self.layer.module_name

    @property
    def draws(self) -> bool:
        return self.layer.draws

    @staticmethod
    def _fold(x):
        return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))

    def build(self, x):
        return self.layer.build(self._fold(x))

    def apply(self, m, x, training=False, generator=None, impl="auto"):
        y = self.layer.apply(m, self._fold(x), training=training,
                             generator=generator, impl=impl)
        return y.reshape(tuple(x.shape[:2]) + tuple(y.shape[1:]))

    def call(self, x, training=False, **kw):
        # kw: the graph's generator, where the inner layer draws
        y = self.layer.call(self._fold(x), training=training, **kw)
        return y.reshape(tuple(x.shape[:2]) + tuple(y.shape[1:]))
