"""Paged decode attention: the CUDA kernel `csrc/paged_decode.cu` and
its plain PyTorch version.

Replaces the TPU kernel `paged_decode_pallas` / `_kernel` in
analytics_zoo_tpu/ops/pallas/paged_attention.py.  The kernel is bound
to memory (it reads each lane's cached K/V rows once); the source says
how its design meets that bound.  `ops.attention.paged_decode_attention`
is the one dispatch point: the kernel for CUDA tensors, the plain
version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from analytics_zoo_tpu_torch.ops.kernels import _build

_HEAD_DIMS = (32, 64, 128, 256)


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point, built on first use, with its signature set
    (ctypes would otherwise pass each pointer as a 32-bit int)."""
    fn = _build.load("paged_decode").paged_decode
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check(t, name, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_decode(q, new_k, new_v, k_pool, v_pool, block_tables, ctx_len,
                 k_scale=None, v_scale=None):
    """Launch the CUDA kernel.  q, new_k, new_v: [S, h, d] f32;
    k_pool / v_pool: [num_blocks, block_size, h, d] f32, or int8 with
    k_scale / v_scale [num_blocks, block_size] f32; block_tables
    [S, max_blocks] int32; ctx_len [S] int32; all contiguous on one
    CUDA device.  Returns [S, h, d] f32.  Raises on anything else."""
    if not q.is_cuda:
        raise ValueError("paged_decode launches a CUDA kernel; q is on "
                         f"{q.device} (CPU tensors take "
                         "paged_decode_reference)")
    dev = q.device
    s, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; one of "
                         f"{_HEAD_DIMS}")
    nb, bs = k_pool.shape[:2]
    mb = block_tables.shape[1] if block_tables.dim() == 2 else -1
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    pool_dtype = torch.int8 if quantized else torch.float32
    for name, t in (("q", q), ("new_k", new_k), ("new_v", new_v)):
        _check(t, name, (s, h, d), torch.float32, dev)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        _check(t, name, (nb, bs, h, d), pool_dtype, dev)
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(t, name, (nb, bs), torch.float32, dev)
    _check(block_tables, "block_tables", (s, mb), torch.int32, dev)
    _check(ctx_len, "ctx_len", (s,), torch.int32, dev)
    out = torch.empty((s, h, d), dtype=torch.float32, device=dev)
    if s == 0:
        return out
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
                k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr() if quantized else None,
                v_scale.data_ptr() if quantized else None,
                block_tables.data_ptr(), ctx_len.data_ptr(),
                out.data_ptr(), s, h, d, bs, mb, int(quantized),
                1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA "
                           f"error {rc}")
    _build.count_launch(paged_decode)
    return out


paged_decode.launches = 0


def paged_decode_reference(q, new_k, new_v, k_pool, v_pool, block_tables,
                           ctx_len, k_scale=None, v_scale=None,
                           compute_dtype=torch.float32):
    """The plain version (JAX's XLA fallback, ops/attention.py:147-162):
    gather each lane's context from the pool by block table, dequantize
    when scales ride along, and run `dot_product_attention`'s
    KV-cache read path over [context ; new token]."""
    from analytics_zoo_tpu_torch.ops.attention import (
        _paged_dequant,
        dot_product_attention,
    )
    s, h, d = q.shape
    nb, bs = k_pool.shape[:2]
    flat_k = k_pool.reshape(nb * bs, h, d)
    flat_v = v_pool.reshape(nb * bs, h, d)
    fk_scale = (None if k_scale is None
                else k_scale.reshape(nb * bs).float())
    fv_scale = (None if v_scale is None
                else v_scale.reshape(nb * bs).float())
    tok_idx = (block_tables.long()[:, :, None] * bs
               + torch.arange(bs, device=q.device)[None, None, :]
               ).reshape(s, -1)
    out = dot_product_attention(
        q[:, None], new_k[:, None], new_v[:, None],
        compute_dtype=compute_dtype,
        ctx_k=_paged_dequant(flat_k, fk_scale, tok_idx),
        ctx_v=_paged_dequant(flat_v, fv_scale, tok_idx),
        ctx_len=ctx_len)
    return out[:, 0]
