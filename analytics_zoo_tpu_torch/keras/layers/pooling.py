"""Pooling layers (counterpart of analytics_zoo_tpu/keras/layers/
pooling.py), channels-last: flax's `max_pool` / `avg_pool`, whose
"SAME" padding is XLA's (asymmetric where the total is odd), with -inf
for the max and zeros counted in the mean for the average."""

from __future__ import annotations

from typing import Optional, Tuple

import torch.nn.functional as F

from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.conv import (
    IntOrPair, _flat, _pad, _tup)
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    same_padding)

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


class _PoolND(Layer):
    ndim = 2
    mode = "max"

    def __init__(self, pool_size: IntOrPair = 2, strides=None,
                 border_mode: str = "valid", name: Optional[str] = None):
        super().__init__(name)
        self.pool_size = _tup(pool_size, self.ndim)
        self.strides = _tup(strides, self.ndim) if strides is not None \
            else self.pool_size
        self.padding = _pad(border_mode)

    def call(self, x, training=False):
        x = x.movedim(-1, 1)
        if self.padding == "SAME":
            pairs = [same_padding(n, k, s) for n, k, s in
                     zip(x.shape[2:], self.pool_size, self.strides)]
            x = F.pad(x, _flat(pairs),
                      value=float("-inf") if self.mode == "max" else 0.0)
        pool = (_MAX if self.mode == "max" else _AVG)[self.ndim]
        return pool(x, self.pool_size, self.strides).movedim(1, -1)


class MaxPooling1D(_PoolND):
    ndim, mode = 1, "max"


class MaxPooling2D(_PoolND):
    ndim, mode = 2, "max"


class MaxPooling3D(_PoolND):
    ndim, mode = 3, "max"


class AveragePooling1D(_PoolND):
    ndim, mode = 1, "avg"


class AveragePooling2D(_PoolND):
    ndim, mode = 2, "avg"


class AveragePooling3D(_PoolND):
    ndim, mode = 3, "avg"


class _GlobalPool(Layer):
    axes: Tuple[int, ...] = (1,)
    mode = "max"

    def call(self, x, training=False):
        if self.mode == "max":
            return x.amax(dim=self.axes)
        return x.mean(dim=self.axes)


class GlobalMaxPooling1D(_GlobalPool):
    axes, mode = (1,), "max"


class GlobalAveragePooling1D(_GlobalPool):
    axes, mode = (1,), "avg"


class GlobalMaxPooling2D(_GlobalPool):
    axes, mode = (1, 2), "max"


class GlobalAveragePooling2D(_GlobalPool):
    axes, mode = (1, 2), "avg"


class GlobalMaxPooling3D(_GlobalPool):
    axes, mode = (1, 2, 3), "max"


class GlobalAveragePooling3D(_GlobalPool):
    axes, mode = (1, 2, 3), "avg"
