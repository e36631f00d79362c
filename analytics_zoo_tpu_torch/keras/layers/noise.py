"""Noise and structured-dropout layers (counterpart of
analytics_zoo_tpu/keras/layers/noise.py): GaussianDropout and
SpatialDropout1D/2D/3D.  Each draws from the generator it is applied
with in training and is the identity in eval."""

from __future__ import annotations

from typing import Optional

import torch

from analytics_zoo_tpu_torch.keras.layers.core import RandomLayer


class GaussianDropout(RandomLayer):
    """Multiplicative 1-centered gaussian noise of std sqrt(p / (1 -
    p))."""

    def __init__(self, p: float, name: Optional[str] = None):
        super().__init__(name)
        self.p = p

    def draw(self, x, training, generator):
        if not training or self.p <= 0:
            return x
        stddev = (self.p / (1.0 - self.p)) ** 0.5
        noise = torch.randn(x.shape, dtype=x.dtype, device=x.device,
                            generator=generator)
        return x * (1.0 + stddev * noise)


class _SpatialDropout(RandomLayer):
    """Drops whole channels: one keep draw per (batch, channel), shared
    over the `broadcast_axes`."""

    broadcast_axes = (1,)

    def __init__(self, p: float, name: Optional[str] = None):
        super().__init__(name)
        self.p = p

    def draw(self, x, training, generator):
        if not training or self.p <= 0:
            return x
        shape = list(x.shape)
        for a in self.broadcast_axes:
            shape[a] = 1
        keep = torch.empty(shape, dtype=x.dtype, device=x.device
                           ).bernoulli_(1.0 - self.p, generator=generator)
        return x * keep / (1.0 - self.p)


class SpatialDropout1D(_SpatialDropout):
    """[b, t, c]: the mask is shared over time."""

    broadcast_axes = (1,)


class SpatialDropout2D(_SpatialDropout):
    """NHWC: the mask is shared over H and W."""

    broadcast_axes = (1, 2)


class SpatialDropout3D(_SpatialDropout):
    """NDHWC: the mask is shared over D, H and W."""

    broadcast_axes = (1, 2, 3)
