"""Int8 weight quantization for serving (counterpart of
analytics_zoo_tpu/serving/quantize.py).

The numpy half is the JAX module's, over a param tree in the flax
layout: symmetric int8 per output channel (the last axis), the maximum
taken over every other axis, so a scan-stacked leaf (BERT's
`blocks/...`, [n_block, ...]) gets one scale per channel shared by all
its layers; leaves with fewer than `min_ndim` dims or `min_size`
elements stay float.  `dequantize_params` is its torch twin:
`(int8.float() * scale)` rounded to `dtype` on the leaf's device.

`quantize_module` applies it to a port module: the module's weights go
to the flax layout through the model's own converter pair (its
`flax_layout()`; a module without one is taken as unstacked leaves),
are quantized there, and the int8 values and their scales come back
onto the module's own parameters through the inverse converter.  Each
quantized parameter then holds its int8 values on its device, and a
parametrization (`Dequantize`) rebuilds it on every read, so a forward
dequantizes layer by layer as it reaches each weight.  The rebuilt
weight is `bf16(q * scale)`, as JAX's served forward sees it
(inference_model.py:59-97); it keeps the parameter's dtype (f32, which
holds every bf16 value exactly), so every layer computes in the dtype
it computes in unquantized, as flax's promotion does, except an
embedding table, which stays bf16: flax's `Embed` looks up in its
table's dtype.  Unquantized parameters and buffers (norm scales and
biases, BatchNorm's running statistics) stay as they are.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

_QKEY = "__int8__"


def _quantize_leaf(w: np.ndarray) -> Dict[str, Any]:
    """Symmetric per-output-channel (last axis) int8 quantization."""
    axes = tuple(range(w.ndim - 1))
    amax = np.max(np.abs(w), axis=axes, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {_QKEY: q, "scale": scale}


def is_quantized_leaf(node: Any) -> bool:
    return isinstance(node, dict) and _QKEY in node


def quantize_params(params, *, min_size: int = 512, min_ndim: int = 2
                    ) -> Tuple[Any, Dict[str, float]]:
    """Quantize every float weight array with >= `min_ndim` dims and
    >= `min_size` elements (kernels/embeddings; biases and norm scales
    stay float).  Returns (quantized tree, stats) where stats reports
    original/quantized byte sizes and the compression ratio."""
    stats = {"orig_bytes": 0, "quant_bytes": 0}

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        arr = np.asarray(node)
        nbytes = arr.size * arr.dtype.itemsize
        stats["orig_bytes"] += nbytes
        if (arr.ndim >= min_ndim and arr.size >= min_size
                and np.issubdtype(arr.dtype, np.floating)):
            q = _quantize_leaf(arr.astype(np.float32))
            stats["quant_bytes"] += q[_QKEY].size + q["scale"].size * 4
            return q
        stats["quant_bytes"] += nbytes
        return node

    qtree = walk(params)
    stats["compression"] = (stats["orig_bytes"]
                            / max(stats["quant_bytes"], 1))
    return qtree, stats


def dequantize_params(qparams, dtype: torch.dtype = torch.float32):
    """A float param tree of torch tensors from a quantized one: each
    quantized leaf `(q.float() * scale).to(dtype)` on q's device (pass
    torch.bfloat16 for what serving uses), the other leaves as they
    are."""
    def walk(node):
        if is_quantized_leaf(node):
            q = torch.as_tensor(node[_QKEY])
            scale = torch.as_tensor(node["scale"], device=q.device)
            return (q.float() * scale).to(dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(qparams)


def quantized_size_bytes(qparams) -> int:
    """Total serialized weight bytes of a (possibly mixed) tree."""
    total = 0

    def walk(node):
        nonlocal total
        if is_quantized_leaf(node):
            total += node[_QKEY].size + node["scale"].size * 4
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            arr = np.asarray(node)
            total += arr.size * arr.dtype.itemsize

    walk(qparams)
    return total


# ----------------------------------------------------------------------
# the port's modules
# ----------------------------------------------------------------------

class Dequantize(nn.Module):
    """The parametrization of one quantized parameter: its int8 values
    times `scale` (broadcast over them), rounded to bf16, as `dtype`."""

    def __init__(self, scale: torch.Tensor, dtype: torch.dtype):
        super().__init__()
        self.register_buffer("scale", scale)
        self.dtype = dtype

    def forward(self, q):
        return (q.float() * self.scale).to(torch.bfloat16).to(self.dtype)


def _generic_layout(module: nn.Module) -> Tuple[Callable, Callable]:
    """A module with no JAX counterpart as unstacked flax leaves: a
    Linear weight transposed to (in, out), a Conv weight permuted to
    (k..., in, out), every other parameter as it is."""
    def moves(name):
        owner = module.get_submodule(name.rpartition(".")[0])
        if not name.endswith("weight"):
            return None
        if isinstance(owner, nn.Linear):
            return (0, 1), (1, 0)
        if isinstance(owner, nn.modules.conv._ConvNd):
            return (0, 1), (-1, -2)
        return None

    def to_flax(state_dict):
        tree = {}
        for name, _ in module.named_parameters():
            arr = state_dict[name].detach().float().cpu().numpy()
            axes = moves(name)
            if axes:
                arr = np.moveaxis(arr, *axes)
            tree[name] = np.ascontiguousarray(arr)
        return tree

    def from_flax(tree):
        out = {}
        for name, arr in tree.items():
            axes = moves(name)
            if axes:
                arr = np.moveaxis(arr, axes[1], axes[0])
            out[name] = torch.from_numpy(np.ascontiguousarray(arr))
        return out

    return to_flax, from_flax


def flax_layout(module: nn.Module) -> Tuple[Callable, Callable]:
    """(to_flax(state_dict) -> flax param tree of numpy f32,
    from_flax(tree) -> {parameter name: tensor}) for `module`: the
    model's own `flax_layout()` (the JAX layout of its counterpart:
    BERT's scan-stacked blocks, the recommendation and image models)
    where it has one, else `_generic_layout`'s."""
    own = getattr(module, "flax_layout", None)
    return own() if own is not None else _generic_layout(module)


def _fill(qtree, quantized: Callable, other: Callable):
    """The quantized tree with each quantized leaf `quantized(q, scale)`
    and each other leaf `other(arr)`."""
    if is_quantized_leaf(qtree):
        return quantized(qtree[_QKEY], qtree["scale"])
    if isinstance(qtree, dict):
        return {k: _fill(v, quantized, other) for k, v in qtree.items()}
    return other(np.asarray(qtree))


def _compress(scale: np.ndarray) -> np.ndarray:
    """`scale` (one value per element of a parameter) reduced to size 1
    along every axis it is constant on: a shape that broadcasts back to
    the same values."""
    for ax in range(scale.ndim):
        first = np.take(scale, [0], axis=ax)
        if np.array_equal(scale, np.broadcast_to(first, scale.shape)):
            scale = first
    return np.ascontiguousarray(scale)


def quantize_module(module: nn.Module) -> Dict[str, float]:
    """Quantize `module`'s weights in place as JAX's `quantize_params`
    quantizes its flax tree (with its defaults, in the module's
    `flax_layout`); returns its stats.  Each quantized parameter
    becomes its int8 values on its device under a `Dequantize`
    parametrization; scales equal in value share one tensor (the layers
    of a stacked leaf share theirs).  The int8 values cross the
    converter as int8; each scale crosses it broadcast over its
    leaf (a view until the converter copies it, as it copies every
    leaf) and comes back reduced to its channel axis."""
    to_flax, from_flax = flax_layout(module)
    qtree, stats = quantize_params(to_flax(module.state_dict()))
    values = from_flax(_fill(qtree, lambda q, s: q,
                             lambda a: np.zeros(a.shape, np.int8)))
    scales = from_flax(_fill(
        qtree, lambda q, s: np.broadcast_to(s, q.shape),
        lambda a: np.broadcast_to(np.float32(np.nan), a.shape)))
    del qtree
    shared: Dict[Any, torch.Tensor] = {}
    for name, scale in scales.items():
        scale = scale.numpy()
        # a scale is > 0; float leaves come out NaN, and constants a
        # converter puts in (the GRU's zero r and z biases) 0
        quantized = scale > 0
        if not quantized.any():
            continue
        if not quantized.all():
            raise ValueError(f"{name} mixes quantized and float leaves")
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        param = getattr(owner, leaf)
        scale = _compress(scale)
        key = (scale.shape, scale.tobytes(), param.device)
        if key not in shared:
            shared[key] = torch.from_numpy(scale).to(param.device)
        # int8 values, or their exact f32 copies where a converter casts
        q = values[name].to(torch.int8).to(param.device)
        dtype = (torch.bfloat16 if isinstance(owner, nn.Embedding)
                 else param.dtype)
        owner._parameters[leaf] = nn.Parameter(q, requires_grad=False)
        parametrize.register_parametrization(
            owner, leaf, Dequantize(shared[key], dtype), unsafe=True)
        if isinstance(owner, nn.RNNBase) and not getattr(
                owner, "_dequantize_hook", False):
            # an RNN reads its weights from a list made when they were
            # set: remake it from the parametrized ones each forward
            owner.register_forward_pre_hook(
                lambda m, args: m._init_flat_weights())
            owner._dequantize_hook = True
    return stats


def resident_bytes(module: nn.Module) -> int:
    """Bytes of the module's tensors (parameters and buffers, each
    storage once) as they lie on their devices."""
    seen, total = set(), 0
    for t in list(module.parameters()) + list(module.buffers()):
        key = (t.device, t.untyped_storage().data_ptr())
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total
