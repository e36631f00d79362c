"""What the JAX image models take from flax, where torch does it another
way (used by the classifiers here and by `objectdetection/`).

* `BatchNorm`: flax's `nn.BatchNorm(dtype=float32)`.  The input is
  taken to f32 and normalized by torch's fused batch norm over every
  axis but the channel, with the biased batch variance; in training the
  running statistics (`running_mean`, `running_var` buffers, what
  `snapshot_buffers` / `restore_buffers` cover) move as momentum * old
  + (1 - momentum) * batch, momentum 0.99 (torch's 0.01) and the biased
  batch variance (torch's BatchNorm keeps the unbiased one), recovered
  from the kernel's rstd as rstd^-2 - eps; eps 1e-5.  Flax computes the
  variance as E[x^2] - E[x]^2 in f32; torch's kernels sum otherwise
  (Welford), which agrees to f32 rounding save where a channel's mean
  is large against its spread.
* `Conv`: flax's `nn.Conv` on NCHW tensors, computing in `dtype` (input,
  weight and bias cast to it); padding "SAME" as XLA pads it, low =
  total // 2 and high the rest, so a strided 3x3 on an even input pads
  (0, 1) where torch's `padding=1` pads (1, 1); "VALID"; or explicit
  ((top, bottom), (left, right)).
* `max_pool`: flax's `nn.max_pool`, its "SAME" padding XLA's with -inf.
* `Dense`: flax's `nn.Dense(dtype=...)` (input, weight and bias cast to
  `dtype`).

The models take NHWC images as the JAX ones do and permute them to
NCHW at the boundary, which leaves the data in channels-last strides
(cuDNN's NHWC kernels on the card); wherever a flax model reshapes an
NHWC tensor they permute back first, so the flatten orders are JAX's.
Initializers are flax's defaults: lecun-normal (truncated) kernels,
zero biases, BatchNorm scale one and bias zero.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

#: the channels of the images the models take
RGB = 3


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x, kernel, stride, padding):
    """((top, bottom), (left, right)) of `padding` for x [b, c, h, w]."""
    if padding == "SAME":
        return tuple(same_padding(n, k, s) for n, k, s in
                     zip(x.shape[2:], kernel, stride))
    if padding == "VALID":
        return (0, 0), (0, 0)
    return tuple(tuple(p) for p in padding)


def _lecun_normal_(w: torch.Tensor, fan_in: int) -> None:
    # flax's lecun_normal: truncated normal at +-2 std, variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class Conv(nn.Module):
    """flax `nn.Conv(out_ch, kernel, stride, padding, use_bias=bias,
    feature_group_count=groups, dtype=dtype)` over x [b, in_ch, h, w]."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1,
                 padding="SAME", bias: bool = True, groups: int = 1,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.kernel, self.stride = _pair(kernel), _pair(stride)
        self.padding, self.groups, self.dtype = padding, groups, dtype
        kh, kw = self.kernel
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch // groups, kh, kw, device=device))
        _lecun_normal_(self.weight, in_ch // groups * kh * kw)
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if bias else None)

    def forward(self, x):
        (t, b), (left, r) = _pads(x, self.kernel, self.stride, self.padding)
        if t == b and left == r:
            pad = (t, left)
        else:
            x, pad = F.pad(x, (left, r, t, b)), 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.stride, pad, 1, self.groups)


def max_pool(x, window, stride, padding: Union[str, Sequence] = "VALID"):
    """flax `nn.max_pool` over x [b, c, h, w]: "SAME" pads with -inf."""
    window, stride = _pair(window), _pair(stride)
    (t, b), (left, r) = _pads(x, window, stride, padding)
    if t or b or left or r:
        x = F.pad(x, (left, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class Dense(nn.Linear):
    """flax `nn.Dense(out_features, dtype=dtype)`: input, weight and bias
    cast to `dtype`."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, out_features, device=device)
        self.dtype = dtype
        _lecun_normal_(self.weight, in_features)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def _stats_dtype(x) -> torch.dtype:
    """f32, or x's dtype where it is wider (flax promotes to at least
    f32)."""
    return torch.promote_types(x.dtype, torch.float32)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum, epsilon, dtype=float32)` over the
    channel axis 1 (module docstring): f32 out."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x):
        x = x.to(_stats_dtype(x))
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        y, mean, rstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        m = self.momentum
        with torch.no_grad():
            var = rstd.pow(-2) - self.eps
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y


def image_layout(prefix: str = ""):
    """(to_flax(state_dict), from_flax(tree)) of an image model whose
    modules are named as the flax ones under `prefix` of its state_dict
    (`convert.image_to_flax` / `image_from_flax`, the params alone)."""
    from analytics_zoo_tpu_torch import convert
    return (lambda sd: convert.image_to_flax(sd, prefix)[0],
            lambda tree: convert.image_from_flax(tree, None, prefix))


def to_nchw(x):
    """NHWC images -> NCHW with channels-last strides (no copy)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    """NCHW -> NHWC (no copy), as a flax model's tensors are laid out."""
    return x.permute(0, 2, 3, 1)
