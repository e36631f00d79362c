"""keras2 layer vocabulary of the port (counterpart of
analytics_zoo_tpu/keras2/layers): Dense, Activation, Dropout, Flatten,
Conv1D, Conv2D, Cropping1D, LocallyConnected1D, the Maximum / Minimum /
Average merges and their functional forms, and the 1-D and global
poolings, as signature adapters over `analytics_zoo_tpu_torch.keras.
layers`."""

from __future__ import annotations

from typing import Optional

from analytics_zoo_tpu_torch.keras import layers as K1

# identical signatures in both APIs — re-exported as-is
from analytics_zoo_tpu_torch.keras.layers import (  # noqa: F401
    Activation,
    AveragePooling1D,
    Average,
    Cropping1D,
    Flatten,
    GlobalAveragePooling1D,
    GlobalAveragePooling2D,
    GlobalMaxPooling1D,
    LocallyConnected1D,
    Maximum,
    Minimum,
    MaxPooling1D,
)


class Dense(K1.Dense):
    """keras2 Dense: `units` instead of `output_dim`."""

    def __init__(self, units: int, activation=None,
                 use_bias: bool = True, name: Optional[str] = None,
                 **kwargs):
        super().__init__(units, activation=activation,
                         use_bias=use_bias, name=name, **kwargs)


class Dropout(K1.Dropout):
    """keras2 Dropout: `rate` instead of `p`."""

    def __init__(self, rate: float, name: Optional[str] = None, **_):
        super().__init__(rate, name=name)


class Conv1D(K1.Conv1D):
    """keras2 Conv1D: filters / kernel_size / strides / padding naming;
    dilation_rate supported."""

    def __init__(self, filters: int, kernel_size: int, strides: int = 1,
                 padding: str = "valid", activation=None,
                 use_bias: bool = True, dilation_rate: int = 1,
                 name: Optional[str] = None, **kwargs):
        super().__init__(filters, kernel_size, subsample=strides,
                         border_mode=padding, activation=activation,
                         use_bias=use_bias, dilation=dilation_rate,
                         name=name, **kwargs)


class Conv2D(K1.Conv2D):
    """keras2 Conv2D, channels-last (NHWC) as the JAX package's; the
    reference's data_format="channels_first" is not reproduced."""

    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding: str = "valid", activation=None,
                 use_bias: bool = True, dilation_rate=1,
                 name: Optional[str] = None, **kwargs):
        ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        super().__init__(filters, ks[0], ks[1], subsample=strides,
                         border_mode=padding, activation=activation,
                         use_bias=use_bias, dilation=dilation_rate,
                         name=name, **kwargs)


def maximum(inputs, **kwargs):
    """Functional Maximum."""
    return Maximum(**kwargs)(inputs)


def minimum(inputs, **kwargs):
    return Minimum(**kwargs)(inputs)


def average(inputs, **kwargs):
    return Average(**kwargs)(inputs)
