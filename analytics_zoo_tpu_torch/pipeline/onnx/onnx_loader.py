"""ONNX graph -> torch module (counterpart of
analytics_zoo_tpu/pipeline/onnx/onnx_loader.py).

The decoded graph is interpreted inside ONE `nn.Module`, op by op, with
the same 87 op names as the JAX package's table.  Initializers that feed
a weight slot of a compute op (Gemm / Conv / MatMul / BatchNorm scale
and bias / PRelu / the recurrent weights) become `nn.Parameter`s under
JAX's safe names (`.` and `/` as `_`), so the imported model trains on
the card; BatchNorm running statistics become buffers, which `fit`
leaves as they are, as JAX's frozen `batch_stats`.  Every other
initializer stays a host numpy array, so that shape-like consumers
(Reshape, Slice, Pad, Resize, ...) read it without a device round trip;
a compute op that reads one gets it from a device copy made on first
use and kept as a non-persistent buffer.  ONNX's NCHW layout is torch's
own, so Conv and the pools run on it directly.

Static shapes.  JAX's module reads every shape-like input through
`np.asarray`: called eagerly any value works, while under `jit` (every
JAX Estimator step) a value computed by a `jnp` op is a tracer and
raises NotImplementedError.  The port keeps both: a value is static if
it is a host numpy array (a graph constant, or the result of an op that
JAX computes with numpy methods on numpy inputs: Identity, Dropout,
Cast, Reshape, Flatten, Slice, Gemm, Sum, Mean and the global pools),
and every op JAX computes with `jnp` returns a tensor.  A module built
with `static_shapes=True` (what `Estimator.from_onnx` builds) raises
JAX's NotImplementedError where a shape-like input is a tensor; with
the default False it reads the tensor back to the host, as JAX's eager
call does.  Constants follow JAX with 64-bit types off: a float64
constant or feed becomes float32 on the device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.pipeline.onnx.onnx_proto import (
    DTYPE,
    Model,
    Node,
    decode_model,
)

_OPS: Dict[str, Callable] = {}


def _op(name):
    def deco(fn):
        _OPS[name] = fn
        return fn
    return deco


def _attr(node: Node, name: str, default=None):
    a = node.attrs.get(name)
    return default if a is None else a.value


def _is_np(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic))


def _host_dtype(dtype: np.dtype) -> np.dtype:
    """The numpy dtype a host value takes on the device: JAX's with
    64-bit types off for floats (float64 -> float32); integers keep
    int64, torch's index type (unsigned ones as int64)."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        return np.dtype(np.float32)
    if dtype in (np.uint16, np.uint32, np.uint64):
        return np.dtype(np.int64)
    return dtype


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype, after `_host_dtype`."""
    return torch.from_numpy(np.empty(0, _host_dtype(np_dtype))).dtype


def _static_ints(mod, x, what: str) -> List[int]:
    """Shape-like inputs as Python ints (module docstring: a tensor
    raises under `static_shapes`)."""
    return [int(v) for v in mod.host(x, what).ravel()]


def _pads_pairs(pads: Sequence[int], n_spatial: int):
    """ONNX pads [x1b, x2b, ..., x1e, x2e, ...] -> [(b, e), ...]."""
    if not pads:
        return [(0, 0)] * n_spatial
    return [(pads[i], pads[i + n_spatial]) for i in range(n_spatial)]


def _flat_pads(pairs) -> List[int]:
    """[(b, e)] per dim, first dim first -> F.pad's last-dim-first list."""
    out: List[int] = []
    for b, e in reversed(pairs):
        out += [b, e]
    return out


# -- elementwise / activation ------------------------------------------------

def _softsign(x):
    return x / (1 + torch.abs(x))


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


for _name, _fn in [
        ("Relu", F.relu), ("Sigmoid", torch.sigmoid),
        ("Tanh", torch.tanh), ("Exp", torch.exp), ("Log", torch.log),
        ("Sqrt", torch.sqrt), ("Neg", torch.neg), ("Abs", torch.abs),
        ("Floor", torch.floor), ("Ceil", torch.ceil), ("Erf", torch.erf),
        ("Softplus", _softplus), ("Softsign", _softsign),
        ("Sign", torch.sign), ("Sin", torch.sin), ("Cos", torch.cos),
        ("Reciprocal", torch.reciprocal), ("Round", torch.round)]:
    _OPS[_name] = (lambda fn: lambda mod, node, x: fn(mod.t(x)))(_fn)

_OPS["Identity"] = lambda mod, node, x: x

for _name, _fn in [("Add", torch.add), ("Sub", torch.sub),
                   ("Mul", torch.mul), ("Div", torch.true_divide),
                   ("Pow", torch.pow), ("Max", torch.maximum),
                   ("Min", torch.minimum), ("Equal", torch.eq),
                   ("Greater", torch.gt), ("Less", torch.lt),
                   ("GreaterOrEqual", torch.ge),
                   ("LessOrEqual", torch.le),
                   ("And", torch.logical_and), ("Or", torch.logical_or)]:
    _OPS[_name] = (lambda fn: lambda mod, node, a, b:
                   fn(mod.t(a), mod.t(b)))(_fn)
_OPS["Not"] = lambda mod, node, x: torch.logical_not(mod.t(x))
_OPS["Where"] = lambda mod, node, c, a, b: torch.where(
    mod.t(c).bool(), mod.t(a), mod.t(b))


@_op("LeakyRelu")
def _leaky(mod, node, x):
    return F.leaky_relu(mod.t(x), _attr(node, "alpha", 0.01))


@_op("Elu")
def _elu(mod, node, x):
    return F.elu(mod.t(x), _attr(node, "alpha", 1.0))


@_op("Selu")
def _selu(mod, node, x):
    return F.selu(mod.t(x))


@_op("PRelu")
def _prelu(mod, node, x, slope):
    x = mod.t(x)
    return torch.where(x >= 0, x, x * mod.t(slope))


@_op("HardSigmoid")
def _hard_sigmoid(mod, node, x):
    a = _attr(node, "alpha", 0.2)
    b = _attr(node, "beta", 0.5)
    return torch.clamp(a * mod.t(x) + b, 0.0, 1.0)


@_op("Clip")
def _clip(mod, node, x, lo=None, hi=None):
    lo = _attr(node, "min", lo)
    hi = _attr(node, "max", hi)
    x = mod.t(x)
    # jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi)
    if lo is not None:
        x = torch.maximum(x, mod.t(np.asarray(lo, np.float32))
                          if isinstance(lo, float) else mod.t(lo))
    if hi is not None:
        x = torch.minimum(x, mod.t(np.asarray(hi, np.float32))
                          if isinstance(hi, float) else mod.t(hi))
    return x


@_op("Softmax")
def _softmax(mod, node, x):
    return torch.softmax(mod.t(x), dim=_attr(node, "axis", -1))


@_op("LogSoftmax")
def _log_softmax(mod, node, x):
    return torch.log_softmax(mod.t(x), dim=_attr(node, "axis", -1))


@_op("Gelu")
def _gelu(mod, node, x):
    tanh = _attr(node, "approximate", b"none") == b"tanh"
    return F.gelu(mod.t(x), approximate="tanh" if tanh else "none")


# -- linear algebra ----------------------------------------------------------

@_op("MatMul")
def _matmul(mod, node, a, b):
    return torch.matmul(mod.t(a), mod.t(b))


@_op("Gemm")
def _gemm(mod, node, a, b, c=None):
    alpha = _attr(node, "alpha", 1.0)
    beta = _attr(node, "beta", 1.0)
    if not all(_is_np(v) for v in (a, b, c) if v is not None):
        a, b, c = mod.t(a), mod.t(b), mod.t(c)
    if _attr(node, "transA", 0):
        a = a.T
    if _attr(node, "transB", 0):
        b = b.T
    out = alpha * (a @ b)
    if c is not None:
        out = out + beta * c
    return out


# -- conv / pooling ----------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def same_pads(sizes, kernel, strides, dilations=None, lower: bool = False):
    """(b, e) per spatial dim of SAME padding (XLA's, TF's): the odd
    pixel at the end, or at the beginning with `lower` (ONNX's
    SAME_LOWER)."""
    out = []
    for size, k, s, d in zip(sizes, kernel, strides,
                             dilations or [1] * len(sizes)):
        eff_k = (k - 1) * d + 1
        out_size = -(-size // s)
        total = max((out_size - 1) * s + eff_k - size, 0)
        small, big = total // 2, total - total // 2
        out.append((big, small) if lower else (small, big))
    return out


def conv_nd(x, w, b, strides, pairs, dilations, groups):
    """N-d convolution of NC... `x` with explicit (b, e) pads per
    spatial dim (F.pad only where they are asymmetric)."""
    n_sp = x.dim() - 2
    if all(p == q for p, q in pairs):
        return _CONV[n_sp](x, w, b, tuple(strides), [p for p, _ in pairs],
                           tuple(dilations), groups)
    x = F.pad(x, _flat_pads(pairs))
    return _CONV[n_sp](x, w, b, tuple(strides), 0, tuple(dilations),
                       groups)


@_op("Conv")
def _conv(mod, node, x, w, b=None):
    x, w = mod.t(x), mod.t(w)
    n_sp = x.dim() - 2
    strides = list(_attr(node, "strides", [1] * n_sp))
    dilations = list(_attr(node, "dilations", [1] * n_sp))
    groups = _attr(node, "group", 1)
    auto_pad = (_attr(node, "auto_pad", b"NOTSET") or b"NOTSET").decode()
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        pairs = same_pads(x.shape[2:], w.shape[2:], strides, dilations,
                          auto_pad == "SAME_LOWER")
    else:
        pairs = _pads_pairs(_attr(node, "pads", []), n_sp)
    out = conv_nd(x, w, None, strides, pairs, dilations, groups)
    if b is not None:
        out = out + mod.t(b).reshape((1, -1) + (1,) * n_sp)
    return out


def window_sum(x, ks, strides):
    """Sums over VALID windows of the trailing len(ks) dims of NC...
    `x` (1-3 spatial dims)."""
    n_sp = len(ks)
    if n_sp == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1, ks[0]), (1, strides[0]),
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if n_sp == 2 else F.avg_pool3d
    return pool(x, tuple(ks), tuple(strides), divisor_override=1)


def window_max(x, ks, strides):
    n_sp = len(ks)
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[n_sp]
    return pool(x, tuple(ks), tuple(strides))


def padded_max(x, flat, ks, strides):
    """Max over windows of NC... `x` padded with -inf by `flat` (F.pad's
    list)."""
    return window_max(F.pad(x, flat, value=-math.inf) if any(flat) else x,
                      ks, strides)


def padded_mean(x, flat, ks, strides, count_pad: bool = False):
    """Mean over windows of NC... `x` zero-padded by `flat` (F.pad's
    list): over the window's elements inside `x`, or over the whole
    window with `count_pad` (lax.reduce_window's sums)."""
    s = window_sum(F.pad(x, flat) if any(flat) else x, ks, strides)
    if count_pad:
        return s / float(np.prod(ks))
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return s / window_sum(F.pad(ones, flat) if any(flat) else ones, ks,
                          strides)


def _pool(mod, x, node, is_avg):
    x = mod.t(x)
    ks = list(_attr(node, "kernel_shape"))
    strides = list(_attr(node, "strides", list(ks)))
    flat = _flat_pads(_pads_pairs(_attr(node, "pads", []), x.dim() - 2))
    if not is_avg:
        return padded_max(x, flat, ks, strides)
    return padded_mean(x, flat, ks, strides,
                       bool(_attr(node, "count_include_pad", 0)))


@_op("MaxPool")
def _maxpool(mod, node, x):
    return _pool(mod, x, node, False)


@_op("AveragePool")
def _avgpool(mod, node, x):
    return _pool(mod, x, node, True)


@_op("GlobalAveragePool")
def _gap(mod, node, x):
    if _is_np(x):
        return x.mean(axis=tuple(range(2, x.ndim)), keepdims=True)
    return x.mean(dim=tuple(range(2, x.dim())), keepdim=True)


@_op("GlobalMaxPool")
def _gmp(mod, node, x):
    if _is_np(x):
        return x.max(axis=tuple(range(2, x.ndim)), keepdims=True)
    return x.amax(dim=tuple(range(2, x.dim())), keepdim=True)


@_op("BatchNormalization")
def _batchnorm(mod, node, x, scale, bias, mean, var):
    x = mod.t(x)
    eps = _attr(node, "epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mod.t(mean).reshape(shape)) / torch.sqrt(
        mod.t(var).reshape(shape) + eps) * mod.t(scale).reshape(shape) \
        + mod.t(bias).reshape(shape)


@_op("InstanceNormalization")
def _instancenorm(mod, node, x, scale, bias):
    x = mod.t(x)
    eps = _attr(node, "epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mu = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mu) / torch.sqrt(var + eps) * mod.t(scale).reshape(shape) \
        + mod.t(bias).reshape(shape)


@_op("LRN")
def _lrn(mod, node, x):
    x = mod.t(x)
    size = _attr(node, "size")
    alpha = _attr(node, "alpha", 1e-4)
    beta = _attr(node, "beta", 0.75)
    k = _attr(node, "bias", 1.0)
    half = size // 2
    return x / torch.pow(
        k + alpha / size * channel_window_sum(x * x, half, size - 1 - half),
        beta)


def channel_window_sum(sq, lo: int, hi: int):
    """Sum over channels c - lo .. c + hi (dim 1) of `sq`, zero beyond
    the edges (lax.reduce_window over a padded channel axis)."""
    c = sq.shape[1]
    pairs = [(0, 0), (lo, hi)] + [(0, 0)] * (sq.dim() - 2)
    padded = F.pad(sq, _flat_pads(pairs))
    out = padded.narrow(1, 0, c)
    for j in range(1, lo + hi + 1):
        out = out + padded.narrow(1, j, c)
    return out


@_op("Dropout")
def _dropout(mod, node, x, *unused):
    return x  # inference semantics; training dropout is the engine's job


# -- shape ops ---------------------------------------------------------------

@_op("Reshape")
def _reshape(mod, node, x, shape=None):
    if shape is None:
        shape = _attr(node, "shape")
    target = _static_ints(mod, shape, "Reshape target shape")
    # ONNX: 0 means "copy input dim"
    target = [x.shape[i] if s == 0 else s for i, s in enumerate(target)]
    return x.reshape(target)


@_op("Flatten")
def _flatten(mod, node, x):
    axis = _attr(node, "axis", 1)
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return x.reshape(lead, -1)


@_op("Transpose")
def _transpose(mod, node, x):
    x = mod.t(x)
    perm = _attr(node, "perm")
    return x.permute(*perm) if perm else x.permute(
        *reversed(range(x.dim())))


@_op("Squeeze")
def _squeeze(mod, node, x, axes=None):
    x = mod.t(x)
    if axes is None:
        axes = _attr(node, "axes")
    if axes is None:
        return x.squeeze()
    dims = tuple(_static_ints(mod, axes, "Squeeze axes"))
    for d in dims:
        if x.shape[d] != 1:
            raise ValueError(f"cannot select an axis to squeeze out which "
                             f"has size not equal to one: axis {d} of "
                             f"shape {tuple(x.shape)}")
    return x.squeeze(dims)


@_op("Unsqueeze")
def _unsqueeze(mod, node, x, axes=None):
    x = mod.t(x)
    if axes is None:
        axes = _attr(node, "axes")
    for a in sorted(_static_ints(mod, axes, "Unsqueeze axes")):
        x = x.unsqueeze(a)
    return x


@_op("Concat")
def _concat(mod, node, *xs):
    return torch.cat([mod.t(x) for x in xs], dim=_attr(node, "axis", 0))


@_op("Split")
def _split(mod, node, x, split=None):
    x = mod.t(x)
    axis = _attr(node, "axis", 0)
    if split is None:
        split = _attr(node, "split")
    if split is None:
        n = len(node.outputs)
        if x.shape[axis] % n:
            raise ValueError("array split does not result in an equal "
                             f"division: {x.shape[axis]} into {n}")
        return tuple(torch.split(x, x.shape[axis] // n, dim=axis))
    sizes = np.cumsum(_static_ints(mod, split, "Split sizes"))[:-1]
    return tuple(torch.tensor_split(x, sizes.tolist(), dim=axis))


def _slice_axis(x, axis: int, start: int, stop: int, step: int):
    """x[..., start:stop:step, ...] on `axis`, Python's rules (negative
    steps included)."""
    s, e, st = slice(start, stop, step).indices(x.shape[axis])
    if st > 0:
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(s, e, st)
        return x[tuple(idx)]
    return x.index_select(axis, torch.arange(s, e, st, device=x.device))


@_op("Slice")
def _slice(mod, node, x, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset<10 keeps these as attributes
        starts = _attr(node, "starts")
        ends = _attr(node, "ends")
        axes = _attr(node, "axes")
    starts = _static_ints(mod, starts, "Slice starts")
    ends = _static_ints(mod, ends, "Slice ends")
    axes = (_static_ints(mod, axes, "Slice axes") if axes is not None
            else list(range(len(starts))))
    steps = (_static_ints(mod, steps, "Slice steps") if steps is not None
             else [1] * len(starts))
    if _is_np(x):
        idx = [slice(None)] * x.ndim
        for s, e, a, st in zip(starts, ends, axes, steps):
            idx[a] = slice(s, e, st)
        return x[tuple(idx)]
    for s, e, a, st in zip(starts, ends, axes, steps):
        x = _slice_axis(x, a % x.dim(), s, e, st)
    return x


def take(x, indices, axis: int):
    """jnp.take(x, indices, axis): negative indices count from the end."""
    axis %= x.dim()
    n = x.shape[axis]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + n, idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


@_op("Gather")
def _gather(mod, node, x, indices):
    return take(mod.t(x), mod.t(indices), _attr(node, "axis", 0))


def _pad_axis_indices(n: int, b: int, e: int, mode: str) -> np.ndarray:
    return np.pad(np.arange(n), (b, e), mode=mode)


@_op("Pad")
def _pad(mod, node, x, pads=None, value=None, axes=None):
    x = mod.t(x)
    if pads is None:
        pads = _attr(node, "pads")
    pads = _static_ints(mod, pads, "Pad widths")
    n = x.dim()
    if axes is not None:                 # opset>=18 per-axis pads
        ax = [a % n for a in _static_ints(mod, axes, "Pad axes")]
        full = [0] * (2 * n)
        for j, a in enumerate(ax):
            full[a] = pads[j]
            full[a + n] = pads[j + len(ax)]
        pads = full
    width = [(pads[i], pads[i + n]) for i in range(n)]
    # negative pads CROP (ONNX spec): pad the positive parts, slice off
    # the negative ones
    pos = [(max(b, 0), max(e, 0)) for b, e in width]
    mode = (_attr(node, "mode", b"constant") or b"constant").decode()
    if mode == "constant":
        cv = (float(mod.host(value, "Pad value").ravel()[0])
              if value is not None else 0.0)
        if any(b or e for b, e in pos):
            x = F.pad(x, _flat_pads(pos), value=cv)
    else:
        np_mode = {"reflect": "reflect", "edge": "edge"}[mode]
        for axis, (b, e) in enumerate(pos):
            if b or e:
                idx = _pad_axis_indices(x.shape[axis], b, e, np_mode)
                x = x.index_select(axis, torch.from_numpy(idx).to(x.device))
    if any(b < 0 or e < 0 for b, e in width):
        idx = tuple(
            slice(-b if b < 0 else 0,
                  (e if e < 0 else None))
            for b, e in width)
        x = x[idx]
    return x


@_op("Expand")
def _expand(mod, node, x, shape):
    x = mod.t(x)
    return torch.broadcast_to(x, np.broadcast_shapes(
        tuple(x.shape), tuple(_static_ints(mod, shape, "Expand shape"))))


@_op("Shape")
def _shape(mod, node, x):
    return torch.tensor(tuple(x.shape), dtype=torch.int64,
                        device=mod.device)


@_op("Cast")
def _cast(mod, node, x):
    dt = DTYPE[_attr(node, "to")]
    if _is_np(x):
        return x.astype(dt)
    return x.to(torch_dtype(dt))


_OPS["Sum"] = lambda mod, node, *xs: _variadic_sum(mod, xs)
_OPS["Mean"] = lambda mod, node, *xs: _variadic_sum(mod, xs) / len(xs)


def _variadic_sum(mod, xs):
    if not all(_is_np(x) for x in xs):
        xs = [mod.t(x) for x in xs]
    return sum(xs[1:], xs[0])


@_op("ConstantOfShape")
def _constant_of_shape(mod, node, shape):
    val = _attr(node, "value")
    val = np.asarray(val) if val is not None else np.zeros(1, np.float32)
    return torch.full(
        tuple(_static_ints(mod, shape, "ConstantOfShape shape")),
        val.ravel()[0].item(), dtype=torch_dtype(val.dtype),
        device=mod.device)


@_op("Range")
def _range(mod, node, start, limit, delta):
    # ONNX Range is defined for float tensors too (fractional grids
    # from torch exports): keep the native scalar values, no int()
    def scalar(v, what):
        return mod.host(v, f"Range {what}").reshape(()).item()

    s = scalar(start, "start")
    l = scalar(limit, "limit")
    d = scalar(delta, "delta")
    dtype = (torch_dtype(start.dtype) if _is_np(start) else start.dtype)
    return torch.arange(s, l, d, dtype=dtype, device=mod.device)


@_op("Tile")
def _tile(mod, node, x, repeats):
    return torch.tile(mod.t(x),
                      tuple(_static_ints(mod, repeats, "Tile repeats")))


def _linear_weights(i: int, o: int, antialias: bool) -> np.ndarray:
    """jax.image.resize's triangle-kernel weight matrix [i, o] for one
    axis (`compute_weight_mat`, scale o / i, no translation), in f32."""
    scale = o / i
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = max(inv_scale, np.float32(1.0)) if antialias \
        else np.float32(1.0)
    sample_f = ((np.arange(o, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(i, dtype=np.float32)[:, None]
               ) / kernel_scale
    weights = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(
        np.float32).eps), weights / np.where(total != 0, total,
                                             np.float32(1)), 0)
    inside = (sample_f >= -0.5) & (sample_f <= i - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


@_op("Resize")
def _resize(mod, node, x, roi=None, scales=None, sizes=None):
    """Image resize (opset 11+ input layout; opset 10's single `scales`
    input also lands here).  Modes: nearest / linear.  Nearest is exact
    for every ONNX coordinate/rounding convention via per-axis index
    gather; linear + (pytorch_)half_pixel applies jax.image.resize's
    triangle-kernel weights axis by axis."""
    mode = (_attr(node, "mode", b"nearest") or b"nearest").decode()
    ct = (_attr(node, "coordinate_transformation_mode",
                b"half_pixel") or b"half_pixel").decode()
    nearest_mode = (_attr(node, "nearest_mode", b"round_prefer_floor")
                    or b"round_prefer_floor").decode()
    if scales is None and sizes is None and roi is not None:
        # opset-10 layout: the second input IS scales (no roi yet)
        scales, roi = roi, None
    if scales is not None:
        scales = mod.host(scales, "Resize scales")
    if sizes is not None:
        sizes = mod.host(sizes, "Resize sizes")
    ndim = len(x.shape)
    axes = _attr(node, "axes")
    if axes is not None:
        # opset-18: scales/sizes cover only these axes — expand to full
        # rank so the zips below stay aligned
        axes = [int(a) % ndim for a in axes]
        if sizes is not None and np.size(sizes):
            per_axis = dict(zip(axes, _static_ints(mod, sizes,
                                                   "Resize sizes")))
            sizes = np.asarray([per_axis.get(d, x.shape[d])
                                for d in range(ndim)], np.int64)
        elif scales is not None and np.size(scales):
            per_axis = dict(zip(axes, scales.ravel().tolist()))
            scales = np.asarray([per_axis.get(d, 1.0)
                                 for d in range(ndim)], np.float32)
    if sizes is not None and np.size(sizes):
        out_shape = tuple(_static_ints(mod, sizes, "Resize sizes"))
        scl = [o / i for o, i in zip(out_shape, x.shape)]
    else:
        if scales is None or not np.size(scales):
            raise NotImplementedError("Resize needs scales or sizes")
        scl = [float(s) for s in scales.ravel()]
        out_shape = tuple(int(np.floor(i * s))
                          for i, s in zip(x.shape, scl))
    if mode == "nearest":
        # exact per-axis index gather for every ONNX nearest convention
        out = x
        for ax, (o, i) in enumerate(zip(out_shape, x.shape)):
            if o == i:
                continue
            xo = np.arange(o, dtype=np.float64)
            s = scl[ax]
            if ct == "asymmetric":
                xr = xo / s
            elif ct in ("half_pixel", "pytorch_half_pixel"):
                xr = (xo + 0.5) / s - 0.5
                if ct == "pytorch_half_pixel" and o == 1:
                    xr = np.zeros_like(xo)
            elif ct == "align_corners":
                xr = (xo * ((i - 1) / (o - 1)) if o > 1
                      else np.zeros_like(xo))
            else:
                raise NotImplementedError(
                    f"Resize nearest with coordinate_transformation_"
                    f"mode {ct!r} is not supported")
            if nearest_mode == "floor":
                idx = np.floor(xr)
            elif nearest_mode == "ceil":
                idx = np.ceil(xr)
            elif nearest_mode == "round_prefer_floor":
                idx = np.ceil(xr - 0.5)
            elif nearest_mode == "round_prefer_ceil":
                idx = np.floor(xr + 0.5)
            else:
                raise NotImplementedError(
                    f"Resize nearest_mode {nearest_mode!r}")
            idx = idx.astype(np.int64).clip(0, i - 1)
            out = mod.t(out).index_select(
                ax, torch.from_numpy(idx).to(mod.device))
        return out
    elif mode == "linear":
        if ct not in ("half_pixel", "pytorch_half_pixel"):
            raise NotImplementedError(
                f"Resize linear with {ct!r} is not supported (export "
                "with align_corners=False for half_pixel)")
    else:
        raise NotImplementedError(f"Resize mode {mode!r}")
    # ONNX Resize defaults antialias=0 (jax.image.resize's default
    # antialiases on downscale): honor the attribute
    antialias = bool(_attr(node, "antialias", 0))
    out = mod.t(x)
    for ax, (o, i) in enumerate(zip(out_shape, x.shape)):
        if o == i:
            continue
        w = torch.from_numpy(_linear_weights(i, o, antialias)).to(
            device=out.device, dtype=out.dtype)
        out = torch.movedim(torch.tensordot(out, w, dims=([ax], [0])),
                            -1, ax)
    return out


def _rnn_dirs(node, default_acts):
    """Direction handling shared by LSTM/GRU: -> [reverse?] flags, one
    per ONNX num_direction.  Also rejects non-default `activations` and
    `clip`: the step loops below hard-code sigmoid/tanh."""
    direction = (_attr(node, "direction", b"forward")
                 or b"forward").decode()
    if _attr(node, "layout", 0):
        raise NotImplementedError("RNN layout=1 (batch-first) is not "
                                  "supported; export with layout=0")
    if _attr(node, "clip") is not None:
        raise NotImplementedError("RNN cell clipping (clip attribute) "
                                  "is not supported")
    dirs = {"forward": [False], "reverse": [True],
            "bidirectional": [False, True]}[direction]
    acts = _attr(node, "activations")
    if acts is not None:
        got = [a.decode().lower() if isinstance(a, bytes)
               else str(a).lower() for a in acts]
        want = [a.lower() for a in default_acts] * len(dirs)
        if got != want:
            raise NotImplementedError(
                f"RNN activations {got} are not supported; only the "
                f"defaults {want} are implemented")
    return dirs


@_op("LSTM")
def _lstm_op(mod, node, x, w, r, b=None, seq_lens=None,
             init_h=None, init_c=None, p=None):
    """ONNX LSTM (gate order i, o, f, c; default activations
    sigmoid/tanh/tanh).  x [seq, batch, in]; W [D, 4H, in];
    R [D, 4H, H]; B [D, 8H].  Peepholes are not supported."""
    if seq_lens is not None:
        raise NotImplementedError("LSTM sequence_lens is not supported")
    if p is not None:
        raise NotImplementedError("LSTM peepholes are not supported")
    hidden = int(_attr(node, "hidden_size"))
    dirs = _rnn_dirs(node, ("Sigmoid", "Tanh", "Tanh"))
    x, w, r = mod.t(x), mod.t(w), mod.t(r)
    b, init_h, init_c = mod.t(b), mod.t(init_h), mod.t(init_c)
    seq, batch, _ = x.shape

    def run(rev, d):
        wd, rd = w[d].T, r[d].T                     # [in,4H], [H,4H]
        bias = (b[d][:4 * hidden] + b[d][4 * hidden:]
                if b is not None else 0.0)
        h = (init_h[d] if init_h is not None
             else x.new_zeros((batch, hidden)))
        c = (init_c[d] if init_c is not None
             else x.new_zeros((batch, hidden)))
        ys = []
        for s in (reversed(range(seq)) if rev else range(seq)):
            g = x[s] @ wd + h @ rd + bias
            i_, o_, f_, g_ = torch.chunk(g, 4, dim=-1)
            c = torch.sigmoid(f_) * c + torch.sigmoid(i_) * torch.tanh(g_)
            h = torch.sigmoid(o_) * torch.tanh(c)
            ys.append(h)
        if rev:
            ys.reverse()
        return torch.stack(ys), h, c

    per_dir = [run(rev, d) for d, rev in enumerate(dirs)]
    y = torch.stack([o[0] for o in per_dir], dim=1)  # [seq, D, b, H]
    y_h = torch.stack([o[1] for o in per_dir], dim=0)
    y_c = torch.stack([o[2] for o in per_dir], dim=0)
    return y, y_h, y_c


@_op("GRU")
def _gru_op(mod, node, x, w, r, b=None, seq_lens=None, init_h=None):
    """ONNX GRU (gate order z, r, h).  `linear_before_reset=1` is the
    torch-export convention; both variants are implemented."""
    if seq_lens is not None:
        raise NotImplementedError("GRU sequence_lens is not supported")
    hidden = int(_attr(node, "hidden_size"))
    lbr = int(_attr(node, "linear_before_reset", 0))
    dirs = _rnn_dirs(node, ("Sigmoid", "Tanh"))
    x, w, r = mod.t(x), mod.t(w), mod.t(r)
    b, init_h = mod.t(b), mod.t(init_h)
    seq, batch, _ = x.shape

    def run(rev, d):
        wd, rd = w[d].T, r[d].T                     # [in,3H], [H,3H]
        wb = b[d][:3 * hidden] if b is not None else x.new_zeros(
            3 * hidden)
        rb = b[d][3 * hidden:] if b is not None else x.new_zeros(
            3 * hidden)
        rbz, rbr, rbh = torch.chunk(rb, 3)
        rd_h = torch.chunk(rd, 3, dim=1)[2]
        h = (init_h[d] if init_h is not None
             else x.new_zeros((batch, hidden)))
        ys = []
        for s in (reversed(range(seq)) if rev else range(seq)):
            gx = x[s] @ wd + wb                     # [b, 3H]
            gh = h @ rd                             # [b, 3H]
            xz, xr, xh = torch.chunk(gx, 3, dim=-1)
            hz, hr, hh = torch.chunk(gh, 3, dim=-1)
            z = torch.sigmoid(xz + hz + rbz)
            rt = torch.sigmoid(xr + hr + rbr)
            if lbr:
                n = torch.tanh(xh + rt * (hh + rbh))
            else:
                n = torch.tanh(xh + (rt * h) @ rd_h + rbh)
            h = (1.0 - z) * n + z * h
            ys.append(h)
        if rev:
            ys.reverse()
        return torch.stack(ys), h

    per_dir = [run(rev, d) for d, rev in enumerate(dirs)]
    y = torch.stack([o[0] for o in per_dir], dim=1)
    y_h = torch.stack([o[1] for o in per_dir], dim=0)
    return y, y_h


# -- reductions --------------------------------------------------------------

def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


_REDUCERS = {
    "ReduceMean": lambda x, dim, keepdim: torch.mean(
        x if x.is_floating_point() else x.float(), dim=dim,
        keepdim=keepdim),
    "ReduceSum": lambda x, dim, keepdim: torch.sum(x, dim=dim,
                                                   keepdim=keepdim),
    "ReduceMax": lambda x, dim, keepdim: torch.amax(x, dim=dim,
                                                    keepdim=keepdim),
    "ReduceMin": lambda x, dim, keepdim: torch.amin(x, dim=dim,
                                                    keepdim=keepdim),
    "ReduceProd": _prod,
    "ReduceL1": lambda x, dim, keepdim: torch.sum(torch.abs(x), dim=dim,
                                                  keepdim=keepdim),
    "ReduceL2": lambda x, dim, keepdim: torch.sqrt(torch.sum(
        x * x, dim=dim, keepdim=keepdim)),
    "ReduceLogSumExp": lambda x, dim, keepdim: torch.logsumexp(
        x, dim=dim, keepdim=keepdim),
}


def _reduce(fn):
    def impl(mod, node, x, axes=None):
        x = mod.t(x)
        if axes is None:
            axes = _attr(node, "axes")
        keep = bool(_attr(node, "keepdims", 1))
        if axes is None:
            dims = tuple(range(x.dim()))
        else:
            dims = tuple(int(a) % max(x.dim(), 1)
                         for a in np.asarray(mod.host(axes,
                                                      "reduction axes")
                                             ).ravel())
            if not dims:        # jnp reduces over no axis
                return x
        return fn(x, dims, keep)
    return impl


for _name, _fn in _REDUCERS.items():
    _OPS[_name] = _reduce(_fn)


@_op("ArgMin")
def _argmin(mod, node, x):
    return torch.argmin(mod.t(x), dim=_attr(node, "axis", 0),
                        keepdim=bool(_attr(node, "keepdims", 1)))


@_op("ArgMax")
def _argmax(mod, node, x):
    return torch.argmax(mod.t(x), dim=_attr(node, "axis", 0),
                        keepdim=bool(_attr(node, "keepdims", 1)))


@_op("Constant")
def _constant(mod, node):
    return mod.t(_attr(node, "value"))


# ---------------------------------------------------------------------------
# interpreter module
# ---------------------------------------------------------------------------

#: ops whose tensor inputs (beyond the data input) are trainable weights
_WEIGHT_SLOTS = {
    "Conv": (1, 2), "ConvTranspose": (1, 2), "Gemm": (1, 2),
    "MatMul": (1,), "BatchNormalization": (1, 2),
    "InstanceNormalization": (1, 2), "PRelu": (1,),
    "LSTM": (1, 2, 3), "GRU": (1, 2, 3),
}
#: BatchNorm running stats: buffers, not trained by the optimizer
_STAT_SLOTS = {"BatchNormalization": (3, 4)}


def safe_name(name: str) -> str:
    """JAX's flax name of an initializer."""
    return name.replace(".", "_").replace("/", "_")


def slot_names(graph) -> Tuple[set, set]:
    """(weight-slot initializer names, BatchNorm statistic names)."""
    param_names, stat_names = set(), set()
    for node in graph.nodes:
        for slot in _WEIGHT_SLOTS.get(node.op_type, ()):
            if slot < len(node.inputs) \
                    and node.inputs[slot] in graph.initializers:
                param_names.add(node.inputs[slot])
        for slot in _STAT_SLOTS.get(node.op_type, ()):
            if slot < len(node.inputs) \
                    and node.inputs[slot] in graph.initializers:
                stat_names.add(node.inputs[slot])
    return param_names, stat_names - param_names


def to_torch(arr, device) -> torch.Tensor:
    """A copy of host array `arr` on `device` (`_host_dtype`)."""
    arr = np.asarray(arr)
    dt = _host_dtype(arr.dtype)
    if dt != arr.dtype:
        arr = arr.astype(dt)
    return torch.tensor(arr, device=device)


class OnnxModule(nn.Module):
    """Interprets a decoded ONNX graph with torch ops (module docstring).
    `forward(*feeds)` takes the graph's non-initializer inputs in order
    (tensors, or numpy arrays copied to the module's device) and returns
    its output, or a tuple of them.  `frozen=True` keeps every
    initializer a constant (`GraphNet.freeze`)."""

    def __init__(self, model: Model, device=None,
                 static_shapes: bool = False, frozen: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.model = model
        self.static_shapes = static_shapes
        g = model.graph
        self.register_buffer("_anchor", torch.empty(0, device=device),
                             persistent=False)
        param_names, stat_names = (set(), set()) if frozen \
            else slot_names(g)
        #: initializer name -> attribute name, for parameters and stats
        self.bound: Dict[str, str] = {}
        #: id of a host constant -> (the array, its device copy's name)
        self._consts: Dict[int, Tuple[np.ndarray, str]] = {}
        self.feed_names = [name for name, _ in g.inputs
                           if name not in g.initializers]
        for name, arr in g.initializers.items():
            if name in param_names or name in stat_names:
                safe = safe_name(name)
                if hasattr(self, safe):
                    raise ValueError(f"initializer {name!r} clashes with "
                                     f"the module attribute {safe!r}")
                t = to_torch(arr, device)
                if name in param_names:
                    self.register_parameter(safe, nn.Parameter(t))
                else:
                    self.register_buffer(safe, t)
                self.bound[name] = safe
            else:
                self._note_const(arr)
        for node in g.nodes:
            if node.op_type == "Constant" and "value" in node.attrs:
                self._note_const(node.attrs["value"].value)

    def _note_const(self, arr) -> None:
        if isinstance(arr, np.ndarray):
            self._consts[id(arr)] = (arr, f"_const_{len(self._consts)}")

    @property
    def device(self) -> torch.device:
        return self._anchor.device

    def t(self, x):
        """`x` as a tensor on the module's device: a graph constant's
        device copy is made once and kept as a non-persistent buffer."""
        if x is None or isinstance(x, torch.Tensor):
            return x if x is None or x.device == self.device \
                else x.to(self.device)
        entry = self._consts.get(id(x))
        if entry is None or entry[0] is not x:
            return to_torch(x, self.device)
        cached = self._buffers.get(entry[1])
        if cached is None:
            # a normal tensor even when first made under inference_mode,
            # so that a later training step can use it
            with torch.inference_mode(False):
                cached = to_torch(x, self.device)
            self.register_buffer(entry[1], cached, persistent=False)
        return cached

    def host(self, x, what: str) -> np.ndarray:
        """A shape-like input as a host array: a graph constant as it
        is; a tensor read back, or NotImplementedError under
        `static_shapes`."""
        if not isinstance(x, torch.Tensor):
            return np.asarray(x)
        if self.static_shapes:
            raise NotImplementedError(
                f"data-dependent {what} is not supported (the module "
                "reads shape-like inputs from graph constants only, as "
                "the JAX module under jit does; the value is a tensor "
                "computed at run time)")
        return x.detach().cpu().numpy()

    def forward(self, *args):
        g = self.model.graph
        if len(args) != len(self.feed_names):
            raise ValueError(
                f"graph expects {len(self.feed_names)} inputs "
                f"{self.feed_names}, got {len(args)}")
        env: Dict[str, object] = {}
        for name, a in zip(self.feed_names, args):
            env[name] = a.to(self.device) if isinstance(a, torch.Tensor) \
                else to_torch(a, self.device)
        for name, arr in g.initializers.items():
            safe = self.bound.get(name)
            env[name] = arr if safe is None else getattr(self, safe)

        for node in g.nodes:
            fn = _OPS.get(node.op_type)
            if fn is None:
                raise NotImplementedError(
                    f"ONNX op '{node.op_type}' is not supported "
                    f"(supported: {sorted(_OPS)})")
            ins = []
            for i in node.inputs:
                if not i:
                    ins.append(None)
                elif i in env:
                    ins.append(env[i])
                else:
                    raise ValueError(
                        f"tensor '{i}' consumed by {node.op_type} was "
                        "never produced (optional secondary op outputs "
                        "are not supported)")
            result = fn(self, node, *ins)
            if isinstance(result, (tuple, list)):
                for oname, val in zip(node.outputs, result):
                    env[oname] = val
            else:
                # single-array result: bind the primary output only
                # (e.g. MaxPool's optional Indices stays unbound)
                env[node.outputs[0]] = result
        outs = [self.t(env[o]) for o in g.outputs]
        return outs[0] if len(outs) == 1 else tuple(outs)


def read_bytes(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()


def load_onnx(path_or_bytes, device=None, static_shapes: bool = False
              ) -> Tuple[OnnxModule, Model]:
    """Decode an .onnx file (path or bytes) into an interpreting torch
    module on `device` (None = the CUDA card, raising without one), and
    the decoded model.  To train it: `Estimator.from_onnx(path, ...)`."""
    model = decode_model(read_bytes(path_or_bytes))
    if not model.graph.nodes:
        raise ValueError("decoded ONNX model has no graph nodes")
    return OnnxModule(model, device=device,
                      static_shapes=static_shapes), model
