"""Convolution layers (counterpart of analytics_zoo_tpu/keras/layers/
conv.py): Convolution1D/2D/3D, the atrous and shared variants,
Deconvolution2D, SeparableConv2D, ZeroPadding, UpSampling and Cropping
at 1-D, 2-D and 3-D.

Layout is channels-last (NWC / NHWC / NDHWC), as flax's: `ConvND`
moves the channels to axis 1 for torch's convolution and back.
`border_mode="same"` is XLA's SAME, asymmetric where the total is odd
(low = total // 2, the image zoo's `same_padding` over the dilated
kernel).  The weight is torch's (out, in / groups, *kernel), the flax
kernel (*kernel, in / groups, out) permuted; lecun-normal at init, zero
bias.  `Deconvolution2D` is flax's `ConvTranspose`: `lax.conv_transpose`
with the kernel not flipped, a convolution of the input dilated by the
strides and padded by lax's rule (`transpose_padding`); its weight is
laid out as a Conv's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.core import (
    floating, get_activation, lecun_normal_)
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    same_padding)

IntOrPair = Union[int, Sequence[int]]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _tup(v: IntOrPair, n: int) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    assert len(t) == n, f"expected {n} values, got {t}"
    return t


def _pad(border_mode: str):
    return {"same": "SAME", "valid": "VALID"}[border_mode.lower()]


def _flat(pairs) -> list:
    """F.pad's list (last axis first) of per-axis (low, high) pairs."""
    out = []
    for lo, hi in reversed(pairs):
        out += [lo, hi]
    return out


class ConvND(nn.Module):
    """flax `nn.Conv(out_ch, kernel, strides, padding, kernel_dilation,
    feature_group_count=groups, use_bias)` over channels-last x."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, ...],
                 strides: Tuple[int, ...], padding: str = "SAME",
                 dilation: Optional[Tuple[int, ...]] = None,
                 bias: bool = True, groups: int = 1, device=None):
        super().__init__()
        self.kernel, self.strides, self.padding = kernel, strides, padding
        self.dilation = dilation or (1,) * len(kernel)
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                               *kernel, device=device))
        fan_in = in_ch // groups
        for k in kernel:
            fan_in *= k
        lecun_normal_(self.weight, fan_in)
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if bias else None)

    def forward(self, x):
        x = floating(x).movedim(-1, 1)
        if self.padding == "SAME":
            pairs = [same_padding(n, (k - 1) * d + 1, s) for n, k, s, d in
                     zip(x.shape[2:], self.kernel, self.strides,
                         self.dilation)]
            x = F.pad(x, _flat(pairs))
        y = _CONV[len(self.kernel)](x, self.weight, self.bias, self.strides,
                                    0, self.dilation, self.groups)
        return y.movedim(1, -1)


class _ConvND(Layer):
    ndim = 2

    def __init__(self, nb_filter: int, kernel_size, activation=None,
                 subsample=1, border_mode: str = "valid",
                 use_bias: bool = True, dilation=1,
                 name: Optional[str] = None, **_):
        super().__init__(name)
        self.nb_filter = nb_filter
        self.kernel_size = _tup(kernel_size, self.ndim)
        self.strides = _tup(subsample, self.ndim)
        self.padding = _pad(border_mode)
        self.activation = get_activation(activation)
        self.use_bias = use_bias
        self.dilation = _tup(dilation, self.ndim)

    def build(self, x):
        return ConvND(x.shape[-1], self.nb_filter, self.kernel_size,
                      self.strides, self.padding, self.dilation,
                      self.use_bias, device=x.device)

    def apply(self, m, x, training=False, generator=None, impl="auto"):
        return self.activation(m(x))


class Conv1D(_ConvND):
    ndim = 1

    def __init__(self, nb_filter, filter_length=3, **kwargs):
        super().__init__(nb_filter, filter_length, **kwargs)


class Conv2D(_ConvND):
    ndim = 2

    def __init__(self, nb_filter, nb_row=3, nb_col=None, **kwargs):
        ks = (nb_row, nb_col if nb_col is not None else nb_row) \
            if isinstance(nb_row, int) else nb_row
        super().__init__(nb_filter, ks, **kwargs)


class Conv3D(_ConvND):
    ndim = 3

    def __init__(self, nb_filter, kernel_size=3, **kwargs):
        super().__init__(nb_filter, kernel_size, **kwargs)


class AtrousConvolution1D(Conv1D):
    """Dilated 1-D convolution (keras-1 naming for `dilation_rate`)."""

    def __init__(self, nb_filter, filter_length=3, atrous_rate=1,
                 **kwargs):
        super().__init__(nb_filter, filter_length,
                         dilation=atrous_rate, **kwargs)


class AtrousConvolution2D(Conv2D):
    """Dilated 2-D convolution."""

    def __init__(self, nb_filter, nb_row=3, nb_col=None, atrous_rate=1,
                 **kwargs):
        super().__init__(nb_filter, nb_row, nb_col,
                         dilation=atrous_rate, **kwargs)


class ShareConvolution2D(Conv2D):
    """The reference's Conv2D with workspace buffers shared across
    replicas: mathematically Conv2D; the name is kept for the API."""


Convolution1D = Conv1D
Convolution2D = Conv2D
Convolution3D = Conv3D


def transpose_padding(kernel: int, stride: int, padding: str
                      ) -> Tuple[int, int]:
    """lax.conv_transpose's (low, high) padding of one axis over the
    input dilated by `stride` (jax `_conv_transpose_padding`)."""
    if padding == "SAME":
        pad_len = kernel + stride - 2
        low = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    else:
        pad_len = kernel + stride - 2 + max(kernel - stride, 0)
        low = kernel - 1
    return low, pad_len - low


class ConvTransposeND(ConvND):
    """flax `nn.ConvTranspose(out_ch, kernel, strides, padding)` over
    channels-last x (module docstring)."""

    def __init__(self, in_ch: int, out_ch: int, kernel, strides,
                 padding: str = "SAME", device=None):
        super().__init__(in_ch, out_ch, kernel, strides, padding,
                         device=device)

    def forward(self, x):
        x = floating(x).movedim(-1, 1)
        b, c, *sizes = x.shape
        if any(s > 1 for s in self.strides):
            dilated = x.new_zeros(b, c, *[(n - 1) * s + 1 for n, s in
                                          zip(sizes, self.strides)])
            dilated[(slice(None), slice(None))
                    + tuple(slice(None, None, s) for s in self.strides)] = x
            x = dilated
        pairs = [transpose_padding(k, s, self.padding)
                 for k, s in zip(self.kernel, self.strides)]
        y = _CONV[len(self.kernel)](F.pad(x, _flat(pairs)), self.weight,
                                    self.bias)
        return y.movedim(1, -1)


class Deconvolution2D(Layer):
    """Transposed 2-D convolution."""

    def __init__(self, nb_filter: int, nb_row: int = 3,
                 nb_col: Optional[int] = None, activation=None,
                 subsample=1, border_mode: str = "valid",
                 name: Optional[str] = None, **_):
        super().__init__(name)
        self.nb_filter = nb_filter
        self.kernel_size = (nb_row, nb_col if nb_col is not None else nb_row)
        self.strides = _tup(subsample, 2)
        self.padding = _pad(border_mode)
        self.activation = get_activation(activation)

    def build(self, x):
        return ConvTransposeND(x.shape[-1], self.nb_filter, self.kernel_size,
                               self.strides, self.padding, x.device)

    def apply(self, m, x, training=False, generator=None, impl="auto"):
        return self.activation(m(x))


class _SeparableConv(nn.Module):
    def __init__(self, in_ch: int, filters: int, kernel, depth_multiplier,
                 strides, padding, device=None):
        super().__init__()
        self.depthwise = ConvND(in_ch, in_ch * depth_multiplier, kernel,
                                strides, padding, groups=in_ch, device=device)
        self.pointwise = ConvND(in_ch * depth_multiplier, filters, (1, 1),
                                (1, 1), device=device)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class SeparableConv2D(Layer):
    """Depthwise conv followed by a 1x1 pointwise conv."""

    def __init__(self, nb_filter: int, nb_row: int = 3,
                 nb_col: Optional[int] = None, activation=None,
                 depth_multiplier: int = 1, subsample=1,
                 border_mode: str = "valid", name: Optional[str] = None, **_):
        super().__init__(name)
        self.nb_filter = nb_filter
        self.kernel_size = (nb_row, nb_col if nb_col is not None else nb_row)
        self.depth_multiplier = depth_multiplier
        self.strides = _tup(subsample, 2)
        self.padding = _pad(border_mode)
        self.activation = get_activation(activation)

    def build(self, x):
        return _SeparableConv(x.shape[-1], self.nb_filter, self.kernel_size,
                              self.depth_multiplier, self.strides,
                              self.padding, x.device)

    def apply(self, m, x, training=False, generator=None, impl="auto"):
        return self.activation(m(x))


def _zero_pad(x, pairs):
    """x [b, *spatial, c] zero-padded by per-spatial-axis pairs."""
    return F.pad(x, [0, 0] + _flat(pairs))


class ZeroPadding1D(Layer):
    def __init__(self, padding: IntOrPair = 1, name: Optional[str] = None):
        super().__init__(name)
        self.padding = _tup(padding, 2) if not isinstance(padding, int) \
            else (padding, padding)

    def call(self, x, training=False):
        return _zero_pad(x, (self.padding,))


class ZeroPadding2D(Layer):
    def __init__(self, padding: IntOrPair = 1, name: Optional[str] = None):
        super().__init__(name)
        p = _tup(padding, 2) if not isinstance(padding, int) \
            else (padding, padding)
        self.padding = ((p[0], p[0]), (p[1], p[1]))

    def call(self, x, training=False):
        return _zero_pad(x, self.padding)


class ZeroPadding3D(Layer):
    def __init__(self, padding=(1, 1, 1), name: Optional[str] = None):
        super().__init__(name)
        p = _tup(padding, 3)
        self.padding = tuple((v, v) for v in p)

    def call(self, x, training=False):
        return _zero_pad(x, self.padding)


class UpSampling1D(Layer):
    def __init__(self, length: int = 2, name: Optional[str] = None):
        super().__init__(name)
        self.length = length

    def call(self, x, training=False):
        return x.repeat_interleave(self.length, dim=1)


class UpSampling2D(Layer):
    def __init__(self, size=(2, 2), name: Optional[str] = None):
        super().__init__(name)
        self.size = _tup(size, 2)

    def call(self, x, training=False):
        x = x.repeat_interleave(self.size[0], dim=1)
        return x.repeat_interleave(self.size[1], dim=2)


class UpSampling3D(Layer):
    def __init__(self, size=(2, 2, 2), name: Optional[str] = None):
        super().__init__(name)
        self.size = _tup(size, 3)

    def call(self, x, training=False):
        for axis, k in zip((1, 2, 3), self.size):
            x = x.repeat_interleave(k, dim=axis)
        return x


def _crop(x, pairs):
    """x [b, *spatial, c] with (front, back) cut from each spatial axis."""
    idx = [slice(None)]
    for axis, (a, b) in enumerate(pairs, start=1):
        idx.append(slice(a, x.shape[axis] - b or None))
    return x[tuple(idx)]


class Cropping1D(Layer):
    def __init__(self, cropping=(1, 1), name: Optional[str] = None):
        super().__init__(name)
        self.cropping = _tup(cropping, 2)

    def call(self, x, training=False):
        return _crop(x, (self.cropping,))


class Cropping2D(Layer):
    def __init__(self, cropping=((0, 0), (0, 0)), name: Optional[str] = None):
        super().__init__(name)
        self.cropping = cropping

    def call(self, x, training=False):
        return _crop(x, self.cropping)


class Cropping3D(Layer):
    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)),
                 name: Optional[str] = None):
        super().__init__(name)
        self.cropping = cropping

    def call(self, x, training=False):
        return _crop(x, self.cropping)
