"""Dense + bias + GELU — the one dispatch point for the transformer MLP's
fused first projection (counterpart of analytics_zoo_tpu/ops/dense.py).

impl="auto": a CUDA tensor goes to the CUDA kernel
(`ops/kernels/fused_dense.py`, any m, k and n), a CPU tensor to the
plain version, which computes what the TPU kernel computes (f32
accumulator, f32 bias and GELU, one cast).  impl="reference" forces the
plain version, impl="kernel" the kernel (which raises on a CPU tensor).
Either way one autograd Function carries the op; its backward is the
JAX package's `_dense_gelu_vjp_bwd` (ops/pallas/fused_dense.py:120-132)
in plain PyTorch, on every device: the pre-activation recomputed in x's
dtype rather than saved, the tanh-GELU derivative (PyTorch's own
`gelu_backward`, one f32 elementwise pass), then two matrix products
and a column sum (plain XLA in the JAX package too).

`DenseGelu` is the module twin of the JAX `DenseGelu`: a Linear-layout
`weight [out, in]` and `bias [out]` (the flax "kernel" transposed and
"bias"), with `nn.Dense`'s dtype promotion — x, weight and bias are all
cast to `dtype` before the op (to their common type when it is None).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from analytics_zoo_tpu_torch.ops.kernels.fused_dense import (
    dense_bias_gelu_reference,
    fused_dense_gelu,
)


class _DenseGelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, weight, bias, impl):
        if impl == "kernel":
            y = fused_dense_gelu(x2, weight, bias)
        else:
            y = dense_bias_gelu_reference(x2, weight, bias)
        ctx.save_for_backward(x2, weight, bias)
        return y

    @staticmethod
    def backward(ctx, g):
        x2, weight, bias = ctx.saved_tensors
        pre = torch.addmm(bias, x2, weight.t())       # in x's dtype
        # g * d gelu_tanh(pre) / d pre in f32, one elementwise pass (the
        # derivative `jax.nn.gelu(approximate=True)` differentiates to)
        dy = torch.ops.aten.gelu_backward(g.float(), pre.float(),
                                          approximate="tanh").to(x2.dtype)
        return dy @ weight, dy.t() @ x2, dy.sum(0), None


def dense_bias_gelu(x, weight, bias, *, impl: str = "auto"):
    """gelu_tanh(x @ weight.T + bias): x [..., k], weight [n, k], bias
    [n], all of one dtype.  Returns [..., n] in that dtype.
    Differentiable in x, weight and bias."""
    if impl == "auto":
        impl = "kernel" if x.is_cuda else "reference"
    if impl not in ("kernel", "reference"):
        raise ValueError(f"unknown dense_bias_gelu impl {impl!r}; use "
                         "'auto', 'kernel' or 'reference'")
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    if impl == "kernel":
        x2, weight, bias = x2.contiguous(), weight.contiguous(), \
            bias.contiguous()
    y = _DenseGelu.apply(x2, weight, bias, impl)
    return y.reshape(*x.shape[:-1], weight.shape[0])


class DenseGelu(nn.Module):
    """`nn.Dense(features, dtype=dtype)` + tanh-GELU as one op."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        nn.init.normal_(self.weight, std=in_features ** -0.5)

    def forward(self, x, impl: str = "auto"):
        dtype = self.dtype
        if dtype is None:
            dtype = torch.promote_types(
                torch.promote_types(x.dtype, self.weight.dtype),
                self.bias.dtype)
        return dense_bias_gelu(x.to(dtype), self.weight.to(dtype),
                               self.bias.to(dtype), impl=impl)
