"""Elementwise and tensor-utility layers (counterpart of
analytics_zoo_tpu/keras/layers/elementwise.py): the reference's "torch
utility" vocabulary, from Exp to SelectTable.  Dims count the batch
axis where the reference's do (Narrow, Select, Squeeze, ExpandDim, Max,
Expand).  `ResizeBilinear` is `jax.image.resize(..., "bilinear")`:
half-pixel centers, and a triangle kernel widened by the scale where it
shrinks an axis (torch's antialiased bilinear).  `GaussianSampler`
draws from the generator in training and returns the mean in eval."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.core import Linear, RandomLayer


class _Unary(Layer):
    _fn = staticmethod(lambda x: x)

    def call(self, x, training=False):
        return type(self)._fn(x)


class Exp(_Unary):
    _fn = staticmethod(torch.exp)


class Log(_Unary):
    _fn = staticmethod(torch.log)


class Sqrt(_Unary):
    _fn = staticmethod(torch.sqrt)


class Square(_Unary):
    _fn = staticmethod(torch.square)


class Negative(_Unary):
    _fn = staticmethod(torch.negative)


class Identity(_Unary):
    pass


class Power(Layer):
    def __init__(self, power: float, scale: float = 1.0,
                 shift: float = 0.0, name: Optional[str] = None):
        super().__init__(name)
        self.power, self.scale, self.shift = power, scale, shift

    def call(self, x, training=False):
        return torch.pow(self.scale * x + self.shift, self.power)


class AddConstant(Layer):
    def __init__(self, constant: float, name: Optional[str] = None):
        super().__init__(name)
        self.constant = constant

    def call(self, x, training=False):
        return x + self.constant


class MulConstant(Layer):
    def __init__(self, constant: float, name: Optional[str] = None):
        super().__init__(name)
        self.constant = constant

    def call(self, x, training=False):
        return x * self.constant


class _ScaleModule(nn.Module):
    """Per-channel `scale` (ones) and `bias` (zeros), either optional."""

    def __init__(self, c: int, scale: bool = True, bias: bool = True,
                 device=None):
        super().__init__()
        self.scale = (nn.Parameter(torch.ones(c, device=device))
                      if scale else None)
        self.bias = (nn.Parameter(torch.zeros(c, device=device))
                     if bias else None)

    def forward(self, x):
        if self.scale is not None:
            x = x * self.scale
        if self.bias is not None:
            x = x + self.bias
        return x


class Scale(Layer):
    """Learned per-channel scale + bias."""

    def build(self, x):
        return _ScaleModule(x.shape[-1], device=x.device)


class CMul(Layer):
    """Learned per-channel multiplier."""

    def build(self, x):
        return _ScaleModule(x.shape[-1], bias=False, device=x.device)


class CAdd(Layer):
    """Learned per-channel bias."""

    def build(self, x):
        return _ScaleModule(x.shape[-1], scale=False, device=x.device)


class Masking(Layer):
    """Zero the timesteps equal to mask_value in every feature
    (downstream layers see zeros; no implicit mask propagation)."""

    def __init__(self, mask_value: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.mask_value = mask_value

    def call(self, x, training=False):
        keep = (x != self.mask_value).any(dim=-1, keepdim=True)
        return x * keep


class Squeeze(Layer):
    def __init__(self, dim: int, name: Optional[str] = None):
        super().__init__(name)
        self.dim = dim

    def call(self, x, training=False):
        if x.shape[self.dim] != 1:
            raise ValueError(f"Squeeze: dim {self.dim} of {tuple(x.shape)} "
                             "is not 1")
        return x.squeeze(self.dim)


class ExpandDim(Layer):
    def __init__(self, dim: int, name: Optional[str] = None):
        super().__init__(name)
        self.dim = dim

    def call(self, x, training=False):
        return x.unsqueeze(self.dim)


class Narrow(Layer):
    """`length` elements from `offset` along `dim`."""

    def __init__(self, dim: int, offset: int, length: int = 1,
                 name: Optional[str] = None):
        super().__init__(name)
        self.dim, self.offset, self.length = dim, offset, length

    def call(self, x, training=False):
        idx = [slice(None)] * x.dim()
        idx[self.dim] = slice(self.offset, self.offset + self.length)
        return x[tuple(idx)]


class Select(Layer):
    """Index `index` along `dim`, dropping the axis."""

    def __init__(self, dim: int, index: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.dim, self.index = dim, index

    def call(self, x, training=False):
        return x.select(self.dim, self.index)


class HardTanh(Layer):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.min_value, self.max_value = min_value, max_value

    def call(self, x, training=False):
        return torch.clamp(x, self.min_value, self.max_value)


class HardShrink(Layer):
    def __init__(self, value: float = 0.5, name: Optional[str] = None):
        super().__init__(name)
        self.value = value

    def call(self, x, training=False):
        return torch.where(x.abs() > self.value, x, 0.0)


class SoftShrink(Layer):
    def __init__(self, value: float = 0.5, name: Optional[str] = None):
        super().__init__(name)
        self.value = value

    def call(self, x, training=False):
        return torch.sign(x) * torch.clamp_min(x.abs() - self.value, 0.0)


class Threshold(Layer):
    """x if x > th else value."""

    def __init__(self, th: float = 1e-6, value: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.th, self.value = th, value

    def call(self, x, training=False):
        return torch.where(x > self.th, x, self.value)


class _MaxoutModule(nn.Module):
    def __init__(self, d: int, output_dim: int, nb_feature: int,
                 device=None):
        super().__init__()
        self.output_dim, self.nb_feature = output_dim, nb_feature
        # flax's auto-named inner Dense
        self.Dense_0 = Linear(d, output_dim * nb_feature, device=device)

    def forward(self, x):
        h = self.Dense_0(x)
        h = h.reshape(tuple(x.shape[:-1]) + (self.nb_feature,
                                             self.output_dim))
        return h.amax(dim=-2)


class MaxoutDense(Layer):
    """Max over `nb_feature` linear pieces."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 name: Optional[str] = None):
        super().__init__(name)
        self.output_dim, self.nb_feature = output_dim, nb_feature

    def build(self, x):
        return _MaxoutModule(x.shape[-1], self.output_dim, self.nb_feature,
                             x.device)


class ResizeBilinear(Layer):
    """Bilinear resize of NHWC images (module docstring)."""

    def __init__(self, output_height: int, output_width: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.oh, self.ow = output_height, output_width

    def call(self, x, training=False):
        shrinks = self.oh < x.shape[1] or self.ow < x.shape[2]
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(self.oh, self.ow),
                          mode="bilinear", align_corners=False,
                          antialias=shrinks)
        return y.permute(0, 2, 3, 1)


class GaussianSampler(RandomLayer):
    """VAE reparameterization, inputs [mean, log_var]: mean +
    exp(log_var / 2) * N(0, 1) in training, mean in eval."""

    def draw(self, mean, log_var, training, generator):
        if not training:
            return mean
        eps = torch.randn(mean.shape, dtype=mean.dtype, device=mean.device,
                          generator=generator)
        return mean + torch.exp(0.5 * log_var) * eps


class BinaryThreshold(Layer):
    """1.0 where x > value else 0.0."""

    def __init__(self, value: float = 1e-6, name: Optional[str] = None):
        super().__init__(name)
        self.value = value

    def call(self, x, training=False):
        return (x > self.value).float()


class _MulModule(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        # one learnable scalar, 1.0 at init (the identity)
        self.weight = nn.Parameter(torch.ones(1, device=device))

    def forward(self, x):
        return x * self.weight


class Mul(Layer):
    """Learnable single-scalar multiplier."""

    def build(self, x):
        return _MulModule(x.device)


class Max(Layer):
    """Max over `dim`, the axis kept at size 1 (values only)."""

    def __init__(self, dim: int, name: Optional[str] = None, **_):
        super().__init__(name)
        self.dim = dim

    def call(self, x, training=False):
        return x.amax(dim=self.dim, keepdim=True)


class Expand(Layer):
    """Broadcast size-1 dims up to `tgt_sizes` (-1 keeps the input's
    size)."""

    def __init__(self, tgt_sizes: Sequence[int],
                 name: Optional[str] = None):
        super().__init__(name)
        self.tgt_sizes = tuple(int(s) for s in tgt_sizes)

    def call(self, x, training=False):
        if len(self.tgt_sizes) != x.dim():
            raise ValueError(
                f"Expand tgt_sizes {self.tgt_sizes} rank != input rank "
                f"{x.dim()}")
        tgt = tuple(x.shape[i] if s == -1 else s
                    for i, s in enumerate(self.tgt_sizes))
        return x.expand(tgt)


class GetShape(Layer):
    """The input's shape as an int32 vector, batch dim included."""

    def call(self, x, training=False):
        return torch.tensor(tuple(x.shape), dtype=torch.int32,
                            device=x.device)


class SplitTensor(Layer):
    """Split along `dim` into `num_splits` equal parts: a layer of
    `num_splits` outputs."""

    def __init__(self, dim: int, num_splits: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.dim, self.num_splits = dim, num_splits
        self.n_outputs = num_splits

    def call(self, x, training=False):
        if x.shape[self.dim] % self.num_splits:
            raise ValueError(f"SplitTensor: dim {self.dim} of "
                             f"{tuple(x.shape)} does not split into "
                             f"{self.num_splits} equal parts")
        return tuple(x.chunk(self.num_splits, dim=self.dim))


class SelectTable(Layer):
    """Input `index` (0-based) of a list of inputs."""

    def __init__(self, index: int, name: Optional[str] = None):
        super().__init__(name)
        self.index = index

    def call(self, *xs, training=False):
        return xs[self.index]
