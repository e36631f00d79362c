"""Fused dense + bias + tanh-GELU: the CUDA kernel `csrc/fused_dense.cu`
and its plain PyTorch version.

Replaces the TPU kernel `_mm_fwd` / `_mm_kernel` in
analytics_zoo_tpu/ops/pallas/fused_dense.py (pallas_call at :84):
gelu_tanh(x @ w + b) with an f32 accumulator, the bias and GELU in f32
and one cast to the output dtype, so the [m, n] pre-activation never
reaches device memory.  The weight is in PyTorch's Linear layout
[n, k] (the flax kernel [k, n] transposed).  At the serving shapes the
kernel is bound by the tensor cores; the source says how its design
meets that.  The kernel has three bodies (`body` picks one: TMA + wgmma
for bf16 where TMA can read the operands, a cp.async + mma.sync body for
the other bf16 shapes, FFMA for f32), and the wrapper counts launches
per body in `fused_dense_gelu.launches_by_body`.
`ops.dense.dense_bias_gelu` is the one dispatch point.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from analytics_zoo_tpu_torch.ops.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's bodies, as the C entry point numbers them
BODIES = {"f32": 0, "cp_async": 1, "sm90": 2}
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point, built on first use, with its signature set."""
    fn = _build.load("fused_dense").fused_dense_gelu
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 4 + [ctypes.c_int] * 4 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, x, weight, bias, out) -> int:
    """Call the C entry point on the current stream with body `name`;
    returns its CUDA status."""
    m, k = x.shape
    fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), m, weight.shape[0], k, BODIES[name], stream)


def fused_dense_gelu(x, weight, bias):
    """Launch the CUDA kernel: x [m, k], weight [n, k], bias [n], all
    contiguous, of one dtype (f32 or bf16) and on one CUDA device.
    Returns gelu_tanh(x @ weight.T + bias) [m, n] in that dtype.  Any m,
    k and n.  Raises on anything else."""
    if not x.is_cuda:
        raise ValueError("fused_dense_gelu launches a CUDA kernel; x is on "
                         f"{x.device} (CPU tensors take "
                         "dense_bias_gelu_reference)")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x has dtype {x.dtype}; the kernel takes "
                         "float32 or bfloat16")
    if x.dim() != 2 or weight.dim() != 2 or bias.dim() != 1:
        raise ValueError(f"expected x [m, k], weight [n, k], bias [n]; got "
                         f"{tuple(x.shape)}, {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)}")
    m, k = x.shape
    n = weight.shape[0]
    for name, t, shape in (("weight", weight, (n, k)), ("bias", bias, (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                             f"{x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    name = body(x, weight)
    rc = _launch(name, x, weight, bias, out)
    if rc != 0:
        raise RuntimeError(f"fused_dense_gelu kernel launch failed ({name} "
                           f"body): CUDA error {rc}")
    _build.count_launch(fused_dense_gelu, name)
    return out


fused_dense_gelu.launches = 0
#: launches per body, beside the total
fused_dense_gelu.launches_by_body = dict.fromkeys(BODIES, 0)


def body(x, weight) -> str:
    """Which body of the kernel takes these operands: "f32" for f32;
    for bf16 "sm90" (TMA + wgmma) where TMA can read x and weight and
    write the output (k and n multiples of 8, so rows are 16-byte
    strided, and 16-byte aligned bases; the wrapper's output is), else
    "cp_async"."""
    if x.dtype == torch.float32:
        return "f32"
    k, n = x.shape[-1], weight.shape[0]
    if k % 8 == 0 and n % 8 == 0 and x.data_ptr() % 16 == 0 \
            and weight.data_ptr() % 16 == 0:
        return "sm90"
    return "cp_async"


def gelu_tanh(y):
    """The tanh-form GELU the TPU kernel's epilogue computes
    (`_gelu_tanh`, fused_dense.py:42), operation for operation."""
    return 0.5 * y * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * (y + 0.044715 * (y * y * y))))


def dense_bias_gelu_reference(x, weight, bias):
    """The plain version, what the TPU kernel computes: the product
    accumulated in f32, the f32 bias added, tanh-GELU in f32, then one
    cast to x's dtype.  x [..., k], weight [n, k], bias [n]."""
    y = torch.matmul(x.float(), weight.float().t()) + bias.float()
    return gelu_tanh(y).to(x.dtype)
