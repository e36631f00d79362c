"""Core layers (counterpart of analytics_zoo_tpu/keras/layers/core.py):
Dense, Dropout, GaussianNoise, Activation, Flatten, Reshape, Permute,
RepeatVector, Lambda, Highway and SparseDense.

Parameters are drawn as flax draws them: lecun-normal (truncated)
kernels and zero biases.  A `Linear` keeps torch's layout (`weight
[out, in]`, the flax kernel transposed).  `Dense` is `F.linear` plus
its activation and never goes through a kernel of ours (the JAX Keras
`Dense` is a plain `nn.Dense`).  Random layers draw from the
`generator` they are applied with, in training only.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.self_attention import dropout


def _identity(x):
    return x


def _softmax(x):
    return F.softmax(x, dim=-1)


def _log_softmax(x):
    return F.log_softmax(x, dim=-1)


def _gelu(x):
    # flax's nn.gelu is the tanh form
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "relu": F.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": F.hardsigmoid,
    "softmax": _softmax,
    "log_softmax": _log_softmax,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": _gelu,
    "swish": F.silu,
    "silu": F.silu,
    "leakyrelu": F.leaky_relu,
    "leaky_relu": F.leaky_relu,
    "linear": _identity,
    None: _identity,
}


def get_activation(act) -> Callable:
    if callable(act):
        return act
    try:
        return _ACTIVATIONS[act.lower() if isinstance(act, str) else act]
    except KeyError:
        raise ValueError(f"unknown activation '{act}'; "
                         f"known: {sorted(k for k in _ACTIVATIONS if k)}")


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at +-2 std, of variance
    1 / fan_in after the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def floating(x):
    """x promoted as flax promotes an integer input against f32 params."""
    return x if x.is_floating_point() else x.float()


class Linear(nn.Linear):
    """flax `nn.Dense(features, use_bias=bias)` on the last axis."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        lecun_normal_(self.weight, in_features)
        if bias:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return super().forward(floating(x))


class Dense(Layer):
    """Fully-connected layer on the last dim."""

    def __init__(self, output_dim: int, activation=None, use_bias: bool = True,
                 name: Optional[str] = None, **_):
        super().__init__(name)
        self.output_dim = output_dim
        self.activation = get_activation(activation)
        self.use_bias = use_bias

    def build(self, x):
        return Linear(x.shape[-1], self.output_dim, self.use_bias, x.device)

    def apply(self, m, x, training=False, generator=None, impl="auto"):
        return self.activation(m(x))


class RandomLayer(Layer):
    """A stateless layer that draws from the graph's generator in
    training: `draw(*xs, training, generator)`."""

    draws = True

    def call(self, *xs, training=False, generator=None):
        if training and generator is None:
            raise ValueError("a random layer in training mode draws from an "
                             "explicit torch.Generator: pass generator=..., "
                             "or run in eval mode")
        return self.draw(*xs, training=training, generator=generator)

    def draw(self, *xs, training, generator):
        raise NotImplementedError


class Dropout(RandomLayer):
    def __init__(self, p: float, name: Optional[str] = None):
        super().__init__(name)
        self.p = p

    def draw(self, x, training, generator):
        return dropout(x, self.p, training, generator)


class GaussianNoise(RandomLayer):
    """x + sigma * N(0, 1) in training, x in eval."""

    def __init__(self, sigma: float, name: Optional[str] = None):
        super().__init__(name)
        self.sigma = sigma

    def draw(self, x, training, generator):
        if not training:
            return x
        noise = torch.randn(x.shape, dtype=x.dtype, device=x.device,
                            generator=generator)
        return x + self.sigma * noise


class Activation(Layer):
    def __init__(self, activation, name: Optional[str] = None):
        super().__init__(name)
        self.activation = get_activation(activation)

    def call(self, x, training=False):
        return self.activation(x)


class Flatten(Layer):
    def call(self, x, training=False):
        return x.reshape(x.shape[0], -1)


class Reshape(Layer):
    def __init__(self, target_shape: Sequence[int],
                 name: Optional[str] = None):
        super().__init__(name)
        self.target_shape = tuple(target_shape)

    def call(self, x, training=False):
        return x.reshape((x.shape[0],) + self.target_shape)


class Permute(Layer):
    """Permute non-batch dims; `dims` is 1-indexed like keras."""

    def __init__(self, dims: Sequence[int], name: Optional[str] = None):
        super().__init__(name)
        self.dims = tuple(dims)

    def call(self, x, training=False):
        return x.permute((0,) + self.dims)


class RepeatVector(Layer):
    def __init__(self, n: int, name: Optional[str] = None):
        super().__init__(name)
        self.n = n

    def call(self, x, training=False):
        return x[:, None, :].repeat_interleave(self.n, dim=1)


class Lambda(Layer):
    """Wrap an arbitrary function of torch tensors."""

    def __init__(self, function: Callable, name: Optional[str] = None):
        super().__init__(name)
        self.function = function

    def call(self, *xs, training=False):
        return self.function(*xs)


class _Highway(nn.Module):
    def __init__(self, d: int, activation: Callable, device=None):
        super().__init__()
        self.activation = activation
        self.transform = Linear(d, d, device=device)
        self.gate = Linear(d, d, device=device)

    def forward(self, x):
        h = self.activation(self.transform(x))
        t = torch.sigmoid(self.gate(x))
        return t * h + (1 - t) * x


class Highway(Layer):
    """y = t * h(Wx+b) + (1-t) * x."""

    def __init__(self, activation="tanh", name: Optional[str] = None):
        super().__init__(name)
        self.activation = get_activation(activation)

    def build(self, x):
        return _Highway(x.shape[-1], self.activation, x.device)


class _SparseDenseModule(nn.Module):
    """`kernel [input_dim, output_dim]` (flax's layout: the layer
    gathers its rows) from glorot_uniform, `bias` zeros."""

    def __init__(self, input_dim: int, output_dim: int, use_bias: bool,
                 device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(input_dim, output_dim,
                                               device=device))
        limit = math.sqrt(6.0 / (input_dim + output_dim))
        nn.init.uniform_(self.kernel, -limit, limit)
        self.bias = (nn.Parameter(torch.zeros(output_dim, device=device))
                     if use_bias else None)

    def forward(self, indices, values):
        mask = (indices >= 0)[..., None]
        rows = self.kernel[indices.long().clamp_min(0)]          # [b,k,out]
        y = torch.where(mask, rows * values[..., None], 0.0).sum(dim=-2)
        return y if self.bias is None else y + self.bias


class SparseDense(Layer):
    """Dense over a fixed-width COO bag per row: inputs `indices` [b, k]
    (feature ids, -1 = padding) and `values` [b, k], a masked
    gather-sum of kernel rows."""

    def __init__(self, output_dim: int, input_dim: int, activation=None,
                 use_bias: bool = True, name: Optional[str] = None, **_):
        super().__init__(name)
        self.output_dim, self.input_dim = output_dim, input_dim
        self.activation = get_activation(activation)
        self.use_bias = use_bias

    def build(self, indices, values):
        return _SparseDenseModule(self.input_dim, self.output_dim,
                                  self.use_bias, indices.device)

    def apply(self, m, indices, values, training=False, generator=None,
              impl="auto"):
        return self.activation(m(indices, values))
