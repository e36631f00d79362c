"""LayerNorm — the one dispatch point for layer normalization
(counterpart of analytics_zoo_tpu/ops/normalization.py).

impl="auto": a CUDA tensor goes to the Triton kernels
(`ops/kernels/layer_norm.py`, forward K1 and backward K1b, any rows and
any d), a CPU tensor to the plain versions of the same formulas.
impl="reference" forces the plain versions (the tests and
`chip_smoke.py` use them as the yardstick of correctness); impl="kernel"
forces the kernels, which raise on a CPU tensor.  Either way one
autograd Function carries the op, as the JAX custom_vjp does
(`_layer_norm_vjp_fwd` / `_bwd`, ops/pallas/layer_norm.py:149-162): the
forward saves x, the scale and its own per-row mean and rstd, the
backward returns dx at x's dtype and dscale/dbias at the params' dtype.
The epsilon default is 1e-6, the JAX package's (PyTorch's own LayerNorm
defaults to 1e-5).
"""

from __future__ import annotations

import torch
from torch import nn

from analytics_zoo_tpu_torch.ops.kernels.layer_norm import (
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_fwd_reference,
)

_IMPLS = ("kernel", "reference")


def _passes(impl):
    """(forward, backward) of `impl`, looked up when called."""
    if impl == "kernel":
        return layer_norm_fwd, layer_norm_bwd
    return layer_norm_fwd_reference, layer_norm_bwd_reference


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype, impl):
        fwd, _ = _passes(impl)
        d = x.shape[-1]
        x2 = x.reshape(-1, d)
        y, mean, rstd = fwd(x2, scale, bias, eps, out_dtype)
        ctx.save_for_backward(x2, scale, mean, rstd)
        ctx.impl, ctx.shape, ctx.bias_dtype = impl, x.shape, bias.dtype
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x2, scale, mean, rstd = ctx.saved_tensors
        _, bwd = _passes(ctx.impl)
        g2 = g.reshape(x2.shape)
        if g2.stride(-1) != 1:
            g2 = g2.contiguous()
        dx, dscale, dbias = bwd(x2, scale, mean, rstd, g2)
        return (dx.reshape(ctx.shape), dscale.to(scale.dtype),
                dbias.to(ctx.bias_dtype), None, None, None)


def layer_norm(x, scale, bias, *, eps: float = 1e-6, impl: str = "auto",
               out_dtype=None):
    """LayerNorm over the last axis of `x` [..., d]; `scale`/`bias` are
    [d].  Output dtype defaults to the promotion of the three inputs'.
    Differentiable in x, scale and bias."""
    if impl == "auto":
        impl = "kernel" if x.is_cuda else "reference"
    if impl not in _IMPLS:
        raise ValueError(f"unknown layer_norm impl {impl!r}; use 'auto', "
                         "'kernel' or 'reference'")
    if impl == "kernel" and x.stride(-1) != 1:
        x = x.contiguous()
    return _LayerNorm.apply(x, scale, bias, float(eps), out_dtype, impl)


class LayerNorm(nn.Module):
    """LayerNorm with params `weight` (ones) and `bias` (zeros) — the
    JAX module's "scale"/"bias" — routed through `layer_norm`."""

    def __init__(self, d: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x, impl: str = "auto"):
        return layer_norm(x, self.weight, self.bias, eps=self.eps,
                          impl=impl)
