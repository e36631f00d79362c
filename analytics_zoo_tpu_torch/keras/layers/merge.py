"""Merge layers and the ops of the engine's operator sugar (counterpart
of analytics_zoo_tpu/keras/layers/merge.py)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.keras.engine import Layer, _auto_name


class Merge(Layer):
    """N-ary merge: sum, mul, ave, max, min, concat, dot or cos."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1,
                 name: Optional[str] = None):
        super().__init__(name)
        self.mode = mode.lower()
        self.concat_axis = concat_axis

    def call(self, *xs, training=False):
        if self.mode in ("sum", "add"):
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out
        if self.mode in ("mul", "multiply"):
            out = xs[0]
            for x in xs[1:]:
                out = out * x
            return out
        if self.mode in ("ave", "average"):
            return sum(xs) / len(xs)
        if self.mode == "max":
            out = xs[0]
            for x in xs[1:]:
                out = torch.maximum(out, x)
            return out
        if self.mode == "min":
            out = xs[0]
            for x in xs[1:]:
                out = torch.minimum(out, x)
            return out
        if self.mode in ("concat", "concatenate"):
            return torch.cat(xs, dim=self.concat_axis)
        if self.mode == "dot":
            a, b = xs
            return (a * b).sum(dim=-1, keepdim=True)
        if self.mode == "cos":
            a, b = xs
            na = torch.linalg.norm(a, dim=-1, keepdim=True)
            nb = torch.linalg.norm(b, dim=-1, keepdim=True)
            return (a * b).sum(dim=-1, keepdim=True) / (na * nb + 1e-8)
        raise ValueError(f"unknown merge mode '{self.mode}'")


def merge(inputs, mode: str = "sum", concat_axis: int = -1,
          name: Optional[str] = None):
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(inputs)


def _named(mode):
    class _M(Merge):
        def __init__(self, name: Optional[str] = None, **kw):
            super().__init__(mode=mode, name=name, **kw)
    # the class name sets the auto-name prefix: Add() is "sum_1", as in
    # the JAX package
    _M.__name__ = mode.capitalize()
    return _M


Add = _named("sum")
Multiply = _named("mul")
Average = _named("ave")
Maximum = _named("max")
Minimum = _named("min")
Dot = _named("dot")


class Concat(Merge):
    def __init__(self, axis: int = -1, name: Optional[str] = None):
        super().__init__(mode="concat", concat_axis=axis, name=name)


class _BinaryOp(Layer):
    def __init__(self, fn: Callable, opname: str):
        super().__init__(_auto_name(f"{opname}_op"))
        self.fn = fn

    def call(self, a, b, training=False):
        return self.fn(a, b)


class _UnaryOp(Layer):
    def __init__(self, fn: Callable, opname: str):
        super().__init__(_auto_name(f"{opname}_op"))
        self.fn = fn

    def call(self, a, training=False):
        return self.fn(a)


class _Const(Layer):
    """A python/numpy constant lifted into the graph: a 0-d tensor for a
    number (it takes the other operand's dtype, as a weakly typed jax
    scalar does), an array at 32 bits (jax's default) otherwise."""

    def __init__(self, value):
        super().__init__(_auto_name("const"))
        self.value = value

    def __call__(self):
        from analytics_zoo_tpu_torch.keras.engine import Node, SymTensor
        return SymTensor(Node(self, []))

    def call(self, training=False, device=None):
        v = np.asarray(self.value)
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        elif v.dtype == np.int64:
            v = v.astype(np.int32)
        return torch.as_tensor(v, device=device)
