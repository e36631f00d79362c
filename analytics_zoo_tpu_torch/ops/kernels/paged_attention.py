"""Paged decode attention: the CUDA kernel `csrc/paged_decode.cu` and
its plain PyTorch version.

Replaces the TPU kernel `paged_decode_pallas` / `_kernel` in
analytics_zoo_tpu/ops/pallas/paged_attention.py, and reads the pool in
its own dtype (f32, f16, bf16, or int8 with per-slot scales) as that
kernel does.  The kernel is bound to memory (it reads each lane's cached
K/V rows once); the source says how its design meets that bound.  It
has two bodies, chosen here (`body`) and counted apart
(`paged_decode.launches_by_body`): `split` (the Hopper design) and
`rows` (for a pool a bulk copy cannot read).  `ops.attention.paged_decode_attention`
is the one dispatch point: the kernel for CUDA tensors, the plain
version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from analytics_zoo_tpu_torch.ops.kernels import _build

_HEAD_DIMS = (32, 64, 128, 256)
#: the pool dtypes, as the C entry point numbers them
POOLS = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
         torch.int8: 3}
#: the kernel's bodies, as the C entry point numbers them
BODIES = {"split": 0, "rows": 1}
#: K and V bytes a stage of the split body's ring aims at (the fastest of
#: the sizes tried on an H100 at GPT-2 small's decode)
UNIT_BYTES = 48 * 1024
#: the most tokens of one chunk (its int8 scales sit in shared memory)
MAX_CHUNK_TOKENS = 1024


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point, built on first use, with its signature set
    (ctypes would otherwise pass each pointer as a 32-bit int)."""
    fn = _build.load("paged_decode").paged_decode
    ptr = ctypes.c_void_p
    fn.argtypes = ([ptr] * 12 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ptr])
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


def check_args(q, new_k, new_v, k_pool, v_pool, block_tables, ctx_len,
               k_scale=None, v_scale=None) -> bool:
    """The kernel's checks of shapes, dtypes and devices (every tensor on
    q's device), on any device: raises ValueError on what the kernel does
    not take.  The pool is f32, f16, bf16, or int8 with both scales;
    returns whether it is quantized."""
    dev = q.device
    if q.dim() != 3:
        raise ValueError(f"q must be [S, h, d], got {tuple(q.shape)}")
    s, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; one of "
                         f"{_HEAD_DIMS}")
    if s > 65535:
        raise ValueError(f"{s} lanes; the kernel's grid takes 65535")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_pool.dim() != 4:
        raise ValueError(f"k_pool must be [num_blocks, block_size, h, d], "
                         f"got {tuple(k_pool.shape)}")
    nb, bs = k_pool.shape[:2]
    mb = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if quantized != (k_pool.dtype == torch.int8) \
            or k_pool.dtype not in POOLS:
        raise ValueError(f"k_pool has dtype {k_pool.dtype}; the kernel "
                         "takes f32, f16 or bf16, or int8 with k_scale "
                         "and v_scale")
    for name, t in (("q", q), ("new_k", new_k), ("new_v", new_v)):
        _check(t, name, (s, h, d), torch.float32, dev)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        _check(t, name, (nb, bs, h, d), k_pool.dtype, dev)
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(t, name, (nb, bs), torch.float32, dev)
    _check(block_tables, "block_tables", (s, mb), torch.int32, dev)
    _check(ctx_len, "ctx_len", (s,), torch.int32, dev)
    return quantized


def body(k_pool, v_pool) -> str:
    """Which body takes this pool: "split" (bulk copies of whole tokens,
    all heads a block: at most 32 heads, pool bases 16-byte aligned;
    every row of d * itemsize bytes is a multiple of 16), else "rows"."""
    aligned = k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0
    return "split" if k_pool.shape[2] <= 32 and aligned else "rows"


@functools.lru_cache(maxsize=None)
def plan(s, h, d, bs, mb, itemsize, sms):
    """(chunk_blocks, n_chunks, unit) of the split body, from the shapes
    alone (the host never reads ctx_len): chunks of pool blocks such
    that s lanes of a full table give about one block an SM (at most
    MAX_CHUNK_TOKENS tokens a chunk; the fastest of the sizes tried on
    an H100 at 8 lanes of 64), and units of whole tokens of one
    pool block holding about UNIT_BYTES of K and V, a multiple of the
    tokens a warp scores at once where that fits."""
    tok = h * d * itemsize
    per_pass = 32 // min(32, d * itemsize // 16)
    unit = max(1, min(bs, UNIT_BYTES // (2 * tok)))
    if unit >= per_pass:
        unit -= unit % per_pass
    cb = max(1, min(mb, -(-s * mb // sms),
                    max(1, MAX_CHUNK_TOKENS // bs)))
    return cb, -(-mb // cb), unit


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_counts_lock = threading.Lock()
_counts: dict = {}


def _lane_counts(dev, stream, s: int):
    """The split body's per-lane counters on `stream`, zero between
    launches (each launch's merge resets its lanes), kept per (device,
    stream): launches on one stream run in order."""
    key = (dev.index, stream)
    with _counts_lock:
        t = _counts.get(key)
        if t is None or t.numel() < s:
            t = torch.zeros(max(s, 64), dtype=torch.int32, device=dev)
            _counts[key] = t
        return t


def _launch(name, q, new_k, new_v, k_pool, v_pool, block_tables, ctx_len,
            k_scale, v_scale, out) -> int:
    """Call the C entry point on the current stream with body `name`;
    returns its CUDA status."""
    s, h, d = q.shape
    nb, bs = k_pool.shape[:2]
    mb = block_tables.shape[1]
    dev = q.device
    quantized = k_scale is not None
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cb, nc, unit = plan(s, h, d, bs, mb, k_pool.element_size(),
                            _sms(dev.index))
        part = counts = None
        if name == "split":
            part = torch.empty(s * nc * h * (d + 2), dtype=torch.float32,
                               device=dev)
            counts = _lane_counts(dev, stream, s)
        return fn(q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
                  k_pool.data_ptr(), v_pool.data_ptr(),
                  k_scale.data_ptr() if quantized else None,
                  v_scale.data_ptr() if quantized else None,
                  block_tables.data_ptr(), ctx_len.data_ptr(),
                  out.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if counts is None else counts.data_ptr(),
                  s, h, d, bs, mb, POOLS[k_pool.dtype], BODIES[name], cb,
                  nc, unit, 1.0 / math.sqrt(d), stream)


def paged_decode(q, new_k, new_v, k_pool, v_pool, block_tables, ctx_len,
                 k_scale=None, v_scale=None):
    """Launch the CUDA kernel.  q, new_k, new_v: [S, h, d] f32;
    k_pool / v_pool: [num_blocks, block_size, h, d] f32, f16 or bf16, or
    int8 with k_scale / v_scale [num_blocks, block_size] f32;
    block_tables [S, max_blocks] int32; ctx_len [S] int32; all
    contiguous on one CUDA device.  Returns [S, h, d] f32.  Raises on
    anything else."""
    if not q.is_cuda:
        raise ValueError("paged_decode launches a CUDA kernel; q is on "
                         f"{q.device} (CPU tensors take "
                         "paged_decode_reference)")
    check_args(q, new_k, new_v, k_pool, v_pool, block_tables, ctx_len,
               k_scale, v_scale)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.shape[0] == 0:
        return out
    name = body(k_pool, v_pool)
    rc = _launch(name, q, new_k, new_v, k_pool, v_pool, block_tables,
                 ctx_len, k_scale, v_scale, out)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed ({name} "
                           f"body): CUDA error {rc}")
    _build.count_launch(paged_decode, name)
    return out


paged_decode.launches = 0
#: launches per body, beside the total
paged_decode.launches_by_body = dict.fromkeys(BODIES, 0)


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
