"""LayerNorm forward: a Triton kernel and its plain PyTorch version.

Replaces the TPU kernel `_ln_fwd` / `_ln_fwd_kernel` in
analytics_zoo_tpu/ops/pallas/layer_norm.py (pallas_call at :82) and
computes what it computes, in the same order: f32 statistics with the
fast variance max(0, E[x^2] - E[x]^2), y = (x - mu) * (rstd * scale) +
bias, plus the per-row mean and rstd [rows, 1] f32 that a backward
needs.

Bound: memory.  It reads x once and writes y once (rows * d * 2 *
itemsize bytes, plus scale/bias and the two statistics) against ~8
FLOPs per element, so its least time is those bytes over 3.35 TB/s.
Design: one program per row with the whole row in registers
(BLOCK_D = next power of two >= d, the tail masked), so x is read from
device memory once and nothing but y, mean and rstd is written; any
rows and any d, with no shape-based fallback.

`triton` is imported, and the kernel built, on the first launch only;
its compile cache goes to `.kernel_build/triton` unless
TRITON_CACHE_DIR says otherwise.
"""

import functools
import os

import torch

from analytics_zoo_tpu_torch.ops.kernels import _build


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build the Triton kernel (first launch only).  `tl` is bound at
    module level because Triton resolves the names a kernel uses in its
    module's globals."""
    global tl
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def ln_fwd_kernel(x_ptr, w_ptr, b_ptr, y_ptr, mean_ptr, rstd_ptr,
                      stride_x, stride_y, d, eps,
                      BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                    other=0.0).to(tl.float32)
        mu = tl.sum(x, axis=0) / d
        var = tl.maximum(tl.sum(x * x, axis=0) / d - mu * mu, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = (x - mu) * (rstd * w) + b
        tl.store(y_ptr + row * stride_y + cols,
                 y.to(y_ptr.dtype.element_ty), mask=mask)
        tl.store(mean_ptr + row, mu)
        tl.store(rstd_ptr + row, rstd)

    return triton, ln_fwd_kernel


def layer_norm_fwd(x, scale, bias, eps: float = 1e-6, out_dtype=None):
    """Launch the Triton kernel on `x` [rows, d] (rows contiguous in d)
    with `scale`/`bias` [d], all on one CUDA device.  Returns
    (y [rows, d] at out_dtype, mean [rows, 1] f32, rstd [rows, 1] f32).
    Raises on anything else."""
    if not x.is_cuda:
        raise ValueError("layer_norm_fwd launches a Triton kernel; x is "
                         f"on {x.device} (CPU tensors take "
                         "layer_norm_fwd_reference)")
    if x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"x must be [rows, d] with unit stride in d, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    rows, d = x.shape
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or tuple(t.shape) != (d,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{d}] tensor on "
                             f"{x.device}")
    if out_dtype is None:
        out_dtype = torch.promote_types(
            torch.promote_types(x.dtype, scale.dtype), bias.dtype)
    y = torch.empty((rows, d), dtype=out_dtype, device=x.device)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0 or d == 0:
        return y, mean, rstd
    triton, kernel = _kernel()
    block_d = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(rows,)](x, scale, bias, y, mean, rstd, x.stride(0),
                        y.stride(0), d, float(eps), BLOCK_D=block_d,
                        num_warps=min(max(block_d // 256, 1), 16))
    layer_norm_fwd.launches += 1
    return y, mean, rstd


layer_norm_fwd.launches = 0


def layer_norm_fwd_reference(x, scale, bias, eps: float = 1e-6,
                             out_dtype=None):
    """The plain version (JAX's `_xla_layer_norm`,
    ops/normalization.py:33-43, operation for operation), with the same
    outputs as the kernel: (y, mean [rows, 1], rstd [rows, 1])."""
    if out_dtype is None:
        out_dtype = torch.promote_types(
            torch.promote_types(x.dtype, scale.dtype), bias.dtype)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mu * mu,
                          0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu) * (rstd * scale) + bias
    return y.to(out_dtype), mu, rstd
