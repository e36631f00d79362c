"""LayerNorm forward and backward: two Triton kernels and their plain
PyTorch versions.

K1, `layer_norm_fwd`, replaces the TPU kernel `_ln_fwd` /
`_ln_fwd_kernel` in analytics_zoo_tpu/ops/pallas/layer_norm.py
(pallas_call at :82) and computes what it computes, in the same order:
f32 statistics with the fast variance max(0, E[x^2] - E[x]^2), y = (x -
mu) * (rstd * scale) + bias, plus the per-row mean and rstd [rows, 1]
f32 that the backward reuses.

K1b, `layer_norm_bwd`, replaces `_ln_bwd` / `_ln_bwd_kernel` (pallas_call
at :111): dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
with xhat = (x - mu) * rstd and dxhat = g * scale, plus per-row-block
partial sums of dscale = sum g * xhat and dbias = sum g, reduced by one
`sum(0)` outside as the JAX wrapper does (:139); no atomics, so the
result is deterministic.

Bound: memory, both.  The forward reads x once and writes y once (rows
* d * 2 * itemsize bytes, plus scale/bias and the two statistics); the
backward reads x and g and writes dx (rows * d * 3 * itemsize) against
~12 FLOPs per element; so each one's least time is its bytes over 3.35
TB/s.  Design: the forward runs one program per row with the whole row
in registers (BLOCK_D = next power of two >= d, the tail masked), so x
is read from device memory once and nothing but y, mean and rstd is
written.  The backward runs one program per block of ROWS rows, the
scale and the two partial sums in registers, one row at a time, and
writes one [d] partial of each sum per program; rows past the end (any
row count, 8 or 100) are masked, never a fallback.  Any rows and any d.

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

    @triton.jit
    def ln_bwd_kernel(x_ptr, w_ptr, mean_ptr, rstd_ptr, g_ptr, dx_ptr,
                      dw_ptr, db_ptr, rows, stride_x, stride_g, stride_dx,
                      d, ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        dw = tl.zeros([BLOCK_D], dtype=tl.float32)
        db = tl.zeros([BLOCK_D], dtype=tl.float32)
        for i in range(ROWS):
            row = pid.to(tl.int64) * ROWS + i
            live = row < rows
            m = cmask & live
            x = tl.load(x_ptr + row * stride_x + cols, mask=m,
                        other=0.0).to(tl.float32)
            g = tl.load(g_ptr + row * stride_g + cols, mask=m,
                        other=0.0).to(tl.float32)
            mu = tl.load(mean_ptr + row, mask=live, other=0.0)
            rs = tl.load(rstd_ptr + row, mask=live, other=0.0)
            xhat = (x - mu) * rs
            dxhat = g * w          # 0 in masked columns and rows
            c1 = tl.sum(dxhat, axis=0) / d
            c2 = tl.sum(dxhat * xhat, axis=0) / d
            dx = rs * (dxhat - c1 - xhat * c2)
            tl.store(dx_ptr + row * stride_dx + cols,
                     dx.to(dx_ptr.dtype.element_ty), mask=m)
            dw += g * xhat
            db += g
        tl.store(dw_ptr + pid * d + cols, dw, mask=cmask)
        tl.store(db_ptr + pid * d + cols, db, mask=cmask)

    return triton, ln_fwd_kernel, ln_bwd_kernel


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
    triton, kernel, _ = _kernel()
    block_d = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(rows,)](x, scale, bias, y, mean, rstd, x.stride(0),
                        y.stride(0), d, float(eps), BLOCK_D=block_d,
                        num_warps=min(max(block_d // 256, 1), 16))
    _build.count_launch(layer_norm_fwd)
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


def _rows_per_program(rows: int) -> int:
    """Rows each backward program walks: a power of two (few kernel
    variants) leaving about 512 programs, 4 per SM, capped at 64."""
    per = -(-rows // 512)
    return min(64, 1 << (per - 1).bit_length())


def layer_norm_bwd(x, scale, mean, rstd, g):
    """Launch the Triton backward on `x` [rows, d] (unit stride in d),
    `scale` [d], the forward's `mean`/`rstd` [rows, 1] f32 and the
    output's cotangent `g` [rows, d] (unit stride in d), all on one CUDA
    device.  Returns (dx [rows, d] at x's dtype, dscale [d] f32, dbias
    [d] f32).  Raises on anything else."""
    if not x.is_cuda:
        raise ValueError("layer_norm_bwd launches a Triton kernel; x is "
                         f"on {x.device} (CPU tensors take "
                         "layer_norm_bwd_reference)")
    if x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"x must be [rows, d] with unit stride in d, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    rows, d = x.shape
    if tuple(g.shape) != (rows, d) or g.stride(1) != 1 \
            or g.device != x.device:
        raise ValueError(f"g must be [{rows}, {d}] with unit stride in d on "
                         f"{x.device}")
    if scale.device != x.device or tuple(scale.shape) != (d,) \
            or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous [{d}] tensor on "
                         f"{x.device}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if tuple(t.shape) != (rows, 1) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{rows}, 1] "
                             f"float32 tensor on {x.device}")
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if rows == 0 or d == 0:
        zeros = torch.zeros(d, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    triton, _, kernel = _kernel()
    per = _rows_per_program(rows)
    nprog = -(-rows // per)
    dw = torch.empty((nprog, d), dtype=torch.float32, device=x.device)
    db = torch.empty((nprog, d), dtype=torch.float32, device=x.device)
    block_d = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(nprog,)](x, scale, mean, rstd, g, dx, dw, db, rows,
                         x.stride(0), g.stride(0), dx.stride(0), d,
                         ROWS=per, BLOCK_D=block_d,
                         num_warps=min(max(block_d // 256, 1), 16))
    _build.count_launch(layer_norm_bwd)
    return dx, dw.sum(0), db.sum(0)


layer_norm_bwd.launches = 0


def layer_norm_bwd_reference(x, scale, mean, rstd, g):
    """The plain version of `layer_norm_bwd` (`_ln_bwd_kernel`'s math
    over all rows at once), with the same outputs."""
    xf = x.float()
    gf = g.float()
    xhat = (xf - mean) * rstd
    dxhat = gf * scale.float()
    c1 = dxhat.mean(dim=-1, keepdim=True)
    c2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxhat - c1 - xhat * c2)
    return dx.to(x.dtype), (gf * xhat).sum(0), gf.sum(0)
