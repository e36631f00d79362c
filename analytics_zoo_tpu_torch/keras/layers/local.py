"""Locally-connected layers: convolution with unshared weights per output
position (counterpart of analytics_zoo_tpu/keras/layers/local.py).

The patches come from `F.unfold` in lax's `conv_general_dilated_patches`
order (input channel major, then the kernel's rows and columns), and are
contracted against the per-position kernel bank `kernel [positions,
patch, filters]` (flax's layout; lecun-normal) plus `bias [positions,
filters]` in one einsum, VALID padding, channels-last.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.conv import _tup
from analytics_zoo_tpu_torch.keras.layers.core import (
    floating, get_activation, lecun_normal_)


def _pair(v):
    return _tup(v, 2) if not isinstance(v, int) else (v, v)


class _Local(nn.Module):
    """Unshared 2-D patches (kernel, strides) over x [b, c, h, w]."""

    def __init__(self, c: int, out_hw: Tuple[int, int],
                 ksize: Tuple[int, int], strides: Tuple[int, int],
                 filters: int, device=None):
        super().__init__()
        self.ksize, self.strides = ksize, strides
        positions = out_hw[0] * out_hw[1]
        pk = c * ksize[0] * ksize[1]
        self.kernel = nn.Parameter(torch.empty(positions, pk, filters,
                                               device=device))
        # flax's lecun_normal of a (P, pk, F) kernel: the leading axis
        # counts as receptive field, fan_in = P * pk
        lecun_normal_(self.kernel, positions * pk)
        self.bias = nn.Parameter(torch.zeros(positions, filters,
                                             device=device))

    def forward(self, x):
        patches = F.unfold(floating(x), self.ksize, stride=self.strides)
        return torch.einsum("bkp,pkf->bpf", patches, self.kernel) + self.bias


def _out(n: int, k: int, s: int) -> int:
    return (n - k) // s + 1


class LocallyConnected2D(Layer):
    def __init__(self, filters: int, kernel_size, strides=1,
                 activation=None, name: Optional[str] = None):
        super().__init__(name)
        self.filters = filters
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.activation = get_activation(activation)

    def build(self, x):
        out_hw = tuple(_out(n, k, s) for n, k, s in
                       zip(x.shape[1:3], self.kernel_size, self.strides))
        return _Local(x.shape[-1], out_hw, self.kernel_size, self.strides,
                      self.filters, x.device)

    def apply(self, m, x, training=False, generator=None, impl="auto"):
        b, h, w, _ = x.shape
        oh, ow = (_out(n, k, s) for n, k, s in
                  zip((h, w), self.kernel_size, self.strides))
        y = m(x.permute(0, 3, 1, 2)).reshape(b, oh, ow, self.filters)
        return self.activation(y)


class LocallyConnected1D(Layer):
    def __init__(self, filters: int, kernel_size: int, strides: int = 1,
                 activation=None, name: Optional[str] = None):
        super().__init__(name)
        self.filters = filters
        self.kernel_size = kernel_size
        self.strides = strides
        self.activation = get_activation(activation)

    def build(self, x):
        ot = _out(x.shape[1], self.kernel_size, self.strides)
        return _Local(x.shape[-1], (ot, 1), (self.kernel_size, 1),
                      (self.strides, 1), self.filters, x.device)

    def apply(self, m, x, training=False, generator=None, impl="auto"):
        # [b, t, c] as a width-1 image [b, c, t, 1]
        return self.activation(m(x.permute(0, 2, 1)[..., None]))
