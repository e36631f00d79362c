"""LayerNorm — the one dispatch point for layer normalization
(counterpart of analytics_zoo_tpu/ops/normalization.py).

impl="auto": a CUDA tensor goes to the Triton kernel
(`ops/kernels/layer_norm.py`, any rows and any d), a CPU tensor to the
plain version of the same formula.  impl="reference" forces the plain
version (the tests and `chip_smoke.py` use it as the yardstick of
correctness); impl="kernel" forces the kernel, which raises on a CPU
tensor.  The epsilon default is 1e-6, the JAX package's (PyTorch's own
LayerNorm defaults to 1e-5).
"""

from __future__ import annotations

import torch
from torch import nn

from analytics_zoo_tpu_torch.ops.kernels.layer_norm import (
    layer_norm_fwd,
    layer_norm_fwd_reference,
)


def layer_norm(x, scale, bias, *, eps: float = 1e-6, impl: str = "auto",
               out_dtype=None):
    """LayerNorm over the last axis of `x` [..., d]; `scale`/`bias` are
    [d].  Output dtype defaults to the promotion of the three inputs'."""
    if impl == "auto":
        impl = "kernel" if x.is_cuda else "reference"
    if impl == "reference":
        y, _, _ = layer_norm_fwd_reference(x, scale, bias, eps, out_dtype)
        return y
    if impl != "kernel":
        raise ValueError(f"unknown layer_norm impl {impl!r}; use 'auto', "
                         "'kernel' or 'reference'")
    d = x.shape[-1]
    y, _, _ = layer_norm_fwd(x.reshape(-1, d), scale, bias, eps, out_dtype)
    return y.reshape(x.shape)


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
