"""Dense + bias + GELU — the one dispatch point for the transformer MLP's
fused first projection (counterpart of analytics_zoo_tpu/ops/dense.py).

impl="auto": a CUDA tensor goes to the CUDA kernel
(`ops/kernels/fused_dense.py`, any m, k and n), a CPU tensor to the
plain version, which computes what the TPU kernel computes (f32
accumulator, f32 bias and GELU, one cast).  impl="reference" forces the
plain version, impl="kernel" the kernel (which raises on a CPU tensor).

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


def dense_bias_gelu(x, weight, bias, *, impl: str = "auto"):
    """gelu_tanh(x @ weight.T + bias): x [..., k], weight [n, k], bias
    [n], all of one dtype.  Returns [..., n] in that dtype."""
    if impl == "auto":
        impl = "kernel" if x.is_cuda else "reference"
    if impl == "reference":
        return dense_bias_gelu_reference(x, weight, bias)
    if impl != "kernel":
        raise ValueError(f"unknown dense_bias_gelu impl {impl!r}; use "
                         "'auto', 'kernel' or 'reference'")
    k = x.shape[-1]
    y = fused_dense_gelu(x.reshape(-1, k).contiguous(), weight.contiguous(),
                         bias.contiguous())
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
