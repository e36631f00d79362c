"""Normalization layers (counterpart of
analytics_zoo_tpu/keras/layers/normalization.py), channels-last.

* `BatchNormalization` is flax's `nn.BatchNorm` over the last axis:
  the image zoo's `BatchNorm` (momentum * old + (1 - momentum) * batch,
  the biased batch variance; running statistics in buffers) with the
  channel axis moved to 1 and back.  Keras's defaults, momentum 0.99 and
  epsilon 1e-3.
* `LayerNormalization` is `ops.normalization.LayerNorm`: the Triton
  kernels K1 (forward) and K1b (backward) on the card, their plain
  versions on the CPU.
* `LRN2D` sums x^2 over a window of `n` channels, `WithinChannelLRN2D`
  over a size x size spatial window of each channel, both zero-padded
  by XLA's "SAME" rule as JAX's `reduce_window`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    BatchNorm)
from analytics_zoo_tpu_torch.ops.normalization import LayerNorm


class ChannelsLastBatchNorm(BatchNorm):
    """`BatchNorm` over the last axis of x [b, ..., c]."""

    def forward(self, x):
        return super().forward(x.movedim(-1, 1)).movedim(1, -1)


class BatchNormalization(Layer):
    """Running statistics in the module's buffers, moved in training
    steps."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 name: Optional[str] = None, **_):
        super().__init__(name)
        self.epsilon = epsilon
        self.momentum = momentum

    def build(self, x):
        return ChannelsLastBatchNorm(x.shape[-1], self.momentum,
                                     self.epsilon, x.device)


class LayerNormalization(Layer):
    def __init__(self, epsilon: float = 1e-6, name: Optional[str] = None):
        super().__init__(name)
        self.epsilon = epsilon

    def build(self, x):
        return LayerNorm(x.shape[-1], eps=self.epsilon, device=x.device)

    def apply(self, m, x, training=False, generator=None, impl="auto"):
        return m(x, impl)


def _window_sum(x, window):
    """Sum of x [b, c, *spatial] over `window` (stride 1) with XLA's
    "SAME" zero padding."""
    pads = []
    for k in reversed(window):
        pads += [(k - 1) // 2, k - 1 - (k - 1) // 2]
    x = F.pad(x, pads)
    pool = {1: F.avg_pool1d, 2: F.avg_pool2d}[len(window)]
    n = 1
    for k in window:
        n *= k
    return pool(x, window, 1) * n


class LRN2D(Layer):
    """Cross-channel local response normalization on [b, h, w, c]:
    y = x / (k + alpha/n * sum over an n-window of channels of x^2)^beta."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5,
                 name: Optional[str] = None, **_):
        super().__init__(name)
        self.alpha, self.k, self.beta, self.n = alpha, k, beta, n

    def call(self, x, training=False):
        sq = x.square().reshape(-1, 1, x.shape[-1])
        s = _window_sum(sq, (self.n,)).reshape(x.shape)
        return x / torch.pow(self.k + self.alpha / self.n * s, self.beta)


class WithinChannelLRN2D(Layer):
    """Within-channel local response normalization on [b, h, w, c]:
    each value over (1 + alpha/size^2 * sum of x^2 over a size x size
    window of its channel)^beta."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, name: Optional[str] = None, **_):
        super().__init__(name)
        self.size, self.alpha, self.beta = size, alpha, beta

    def call(self, x, training=False):
        if x.dim() != 4:
            raise ValueError(
                f"WithinChannelLRN2D expects [b, h, w, c], got "
                f"{tuple(x.shape)}")
        s = _window_sum(x.square().permute(0, 3, 1, 2),
                        (self.size, self.size)).permute(0, 2, 3, 1)
        denom = 1.0 + self.alpha / (self.size * self.size) * s
        return x / torch.pow(denom, self.beta)
