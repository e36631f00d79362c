"""Advanced activation layers (counterpart of
analytics_zoo_tpu/keras/layers/advanced_activations.py): LeakyReLU,
ELU, ThresholdedReLU, PReLU, SReLU and RReLU.  Learned parameters are
per channel (the last axis), named as flax names them."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.core import RandomLayer


class LeakyReLU(Layer):
    def __init__(self, alpha: float = 0.3, name: Optional[str] = None):
        super().__init__(name)
        self.alpha = alpha

    def call(self, x, training=False):
        return F.leaky_relu(x, self.alpha)


class ELU(Layer):
    def __init__(self, alpha: float = 1.0, name: Optional[str] = None):
        super().__init__(name)
        self.alpha = alpha

    def call(self, x, training=False):
        return F.elu(x, self.alpha)


class ThresholdedReLU(Layer):
    """x if x > theta else 0."""

    def __init__(self, theta: float = 1.0, name: Optional[str] = None):
        super().__init__(name)
        self.theta = theta

    def call(self, x, training=False):
        return torch.where(x > self.theta, x, 0.0)


class _PReLUModule(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((c,), 0.25, device=device))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class PReLU(Layer):
    """Per-channel learned negative slope (0.25 at init)."""

    def build(self, x):
        return _PReLUModule(x.shape[-1], x.device)


class _SReLUModule(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.t_left = nn.Parameter(torch.zeros(c, device=device))
        self.a_left = nn.Parameter(torch.full((c,), 0.2, device=device))
        self.t_right = nn.Parameter(torch.ones(c, device=device))
        self.a_right = nn.Parameter(torch.ones(c, device=device))

    def forward(self, x):
        tl, tr = self.t_left, self.t_right
        below = tl + self.a_left * (x - tl)
        above = tr + self.a_right * (x - tr)
        return torch.where(x < tl, below, torch.where(x > tr, above, x))


class SReLU(Layer):
    """S-shaped rectifier with four learned per-channel parameters."""

    def build(self, x):
        return _SReLUModule(x.shape[-1], x.device)


class RReLU(RandomLayer):
    """Randomized leaky ReLU: in training the negative-side slope of each
    element is drawn from U(lower, upper); in eval it is (lower +
    upper) / 2."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 name: Optional[str] = None):
        super().__init__(name)
        self.lower, self.upper = lower, upper

    def draw(self, x, training, generator):
        if training:
            a = torch.empty_like(x).uniform_(self.lower, self.upper,
                                             generator=generator)
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)
