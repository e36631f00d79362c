"""Flash attention: the CUDA kernels `csrc/flash_fwd.cu` (forward) and
`csrc/flash_bwd.cu` (backward), and their plain PyTorch versions.

The forward replaces the TPU kernel `_flash_fwd` / `_fwd_kernel` in
analytics_zoo_tpu/ops/pallas/flash_attention.py (pallas_call at :444)
and computes all of it: the kv_mask, an additive bias broadcast over
batch and/or heads, causal masking, attention dropout from the
positional hash, the output and the pre-dropout logsumexp.  The plain
version is a copy of `_reference_attn` (:845) with `_hash_bits` (:238)
and `drop_keep_mask` (:262), so both give bit-identical keep masks.

The backward replaces `_flash_bwd`'s three TPU kernels, one wrapper
each: dQ (`flash_bwd_dq`, pallas_call at :741), dK/dV (`flash_bwd_dkv`,
:825) and the bias's gradient (`flash_bwd_dbias`, :807, launched only
when the bias needs one); `flash_bwd_reference` is their plain version.

All take q, k, v as [b, t, h, d] (the kernels read the three thirds of a
fused qkv projection in place); the forward returns (out [b, t, h, d] at
q's dtype, lse [b*h, t] f32).  `ops.attention.flash_attention` is the one
dispatch point, with the argument checks of the JAX function and the
autograd Function over both passes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from analytics_zoo_tpu_torch.ops.kernels import _build

NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point, built on first use, with its signature set."""
    fn = _build.load("flash_fwd").flash_fwd
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([ptr] * 8 + [i32] * 4 + [ctypes.c_longlong] * 3
                   + [i32] * 5 + [ctypes.c_float] * 2 + [ptr])
    fn.restype = ctypes.c_int
    return fn


def kernel_strides(x):
    """x's strides as the kernels take them: a size-1 dimension's stride
    enters no address, so it is read as the dense layout's, and views
    that differ only there (a slice of a batch of one) share a layout."""
    out, step = [], 1
    for n, s in zip(reversed(x.shape), reversed(x.stride())):
        out.append(step if n == 1 else s)
        step *= n
    return tuple(reversed(out))


def kernel_layout_ok(q, k, v) -> bool:
    """Whether the kernel reads q, k, v as they are: one set of strides
    (`kernel_strides`) with unit stride in d and, for bf16, 16-byte
    aligned rows."""
    strides = kernel_strides(q)
    if not (strides == kernel_strides(k) == kernel_strides(v)) \
            or strides[3] != 1:
        return False
    if q.dtype == torch.bfloat16:
        return (all(s % 8 == 0 for s in strides[:3])
                and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    return True


def _bias_mode(bias, b, h) -> int:
    """The kernel's bias_mode: which of b*h, h, b or 1 leads the bias
    (`_bias_spec`'s projection of the grid's bh index)."""
    per_head, batched = bias.shape[1] == h, bias.shape[0] == b
    if per_head and batched:
        return 1
    if per_head:
        return 2
    if batched:
        return 3
    return 4


def _check(q, k, v, kv_mask, bias, seed3, dropout, name):
    """The argument checks every flash kernel shares; returns the
    kernel's bias_mode (0 without a bias)."""
    if not q.is_cuda:
        raise ValueError(f"{name} launches a CUDA kernel; q is on "
                         f"{q.device} (CPU tensors take the plain version)")
    return check_args(q, k, v, kv_mask, bias, seed3, dropout)


def check_args(q, k, v, kv_mask=None, bias=None, seed3=None,
               dropout: float = 0.0) -> int:
    """The kernels' checks of shapes, dtypes, layouts and devices (every
    tensor on q's device), on any device: raises ValueError on what no
    kernel takes, else returns the bias_mode (0 without a bias).  b*h is
    not bounded: the grids are 1-D; b*h*t must index in 32 bits."""
    b, t, h, d = q.shape
    dev = q.device
    if q.dtype not in _DTYPES:
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes float32 "
                         "or bfloat16")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; one of {_HEAD_DIMS}")
    for nm, x in (("k", k), ("v", v)):
        if tuple(x.shape) != (b, t, h, d) or x.dtype != q.dtype \
                or x.device != dev:
            raise ValueError(f"{nm} is {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}; expected q's {q.dtype} "
                             f"{(b, t, h, d)} on {dev}")
    if not kernel_layout_ok(q, k, v):
        raise ValueError("q, k, v must share strides with unit stride in d "
                         "(and 16-byte aligned rows in bf16)")
    if kv_mask is not None and (
            tuple(kv_mask.shape) != (b, t) or kv_mask.dtype != torch.int32
            or kv_mask.device != dev or not kv_mask.is_contiguous()):
        raise ValueError("kv_mask must be a contiguous [b, t] int32 tensor "
                         f"on {dev}")
    bias_mode = 0
    if bias is not None:
        if bias.dim() != 4 or bias.shape[0] not in (1, b) \
                or bias.shape[1] not in (1, h) \
                or tuple(bias.shape[2:]) != (t, t) \
                or bias.dtype != torch.float32 or bias.device != dev \
                or not bias.is_contiguous():
            raise ValueError(f"bias must be a contiguous [1|{b}, 1|{h}, {t}, "
                             f"{t}] float32 tensor on {dev}")
        bias_mode = _bias_mode(bias, b, h)
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout {dropout} not in [0, 1)")
    if dropout > 0.0 and (seed3 is None or tuple(seed3.shape) != (3,)
                          or seed3.dtype != torch.int32
                          or seed3.device != dev):
        raise ValueError("dropout > 0 needs seed3, an int32 [3] tensor on "
                         f"{dev}")
    if b * h * t > 2 ** 31 - 1:
        raise ValueError(f"b*h*t = {b * h * t} rows of lse pass 2^31 - 1")
    return bias_mode


def _dropout_args(dropout):
    """(dropout on, keep threshold, rescale) as the kernels take them."""
    return (int(dropout > 0.0), int(dropout * 0x7FFFFFFF),
            1.0 / (1.0 - dropout))


def flash_fwd(q, k, v, kv_mask=None, bias=None, seed3=None,
              causal: bool = False, dropout: float = 0.0):
    """Launch the CUDA kernel.  q, k, v: [b, t, h, d] f32 or bf16 on one
    CUDA device, laid out as `kernel_layout_ok` says; head_dim 32, 64 or
    128.  kv_mask: [b, t] int32 contiguous (0 = padding).  bias:
    [1|b, 1|h, t, t] f32 contiguous.  seed3: int32 [3] (seed, q offset,
    k offset) when dropout > 0.  Returns (out [b, t, h, d] contiguous at
    q's dtype, lse [b*h, t] f32).  Raises on anything else."""
    dropout = float(dropout)
    bias_mode = _check(q, k, v, kv_mask, bias, seed3, dropout, "flash_fwd")
    b, t, h, d = q.shape
    dev = q.device
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    sb, st, sh, _ = kernel_strides(q)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if kv_mask is None else kv_mask.data_ptr(),
                None if bias is None else bias.data_ptr(),
                seed3.data_ptr() if dropout > 0.0 else None,
                out.data_ptr(), lse.data_ptr(), b, h, t, d, sb, sh, st,
                _DTYPES[q.dtype], int(causal), bias_mode,
                *_dropout_args(dropout), 1.0 / (d ** 0.5), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    _build.count_launch(flash_fwd)
    return out, lse


flash_fwd.launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    """The backward's C entry point, built on first use."""
    fn = _build.load("flash_bwd").flash_bwd
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([i32] + [ptr] * 13 + [i32] * 4 + [ctypes.c_longlong] * 3
                   + [i32] * 5 + [ctypes.c_float] * 2 + [i32] * 4 + [ptr])
    fn.restype = ctypes.c_int
    return fn


def _bwd_launch(kind, wrapper, q, k, v, dout, lse, delta, kv_mask, bias,
                seed3, causal, dropout, outs, dbias=None, bias_split=None):
    """Check the arguments and launch one backward kernel (kind 0 dQ, 1
    dK/dV, 2 dbias) writing into `outs` / `dbias`."""
    dropout = float(dropout)
    bias_mode = _check(q, k, v, kv_mask, bias, seed3, dropout, wrapper.__name__)
    b, t, h, d = q.shape
    for name, x, shape, dtype in (("dout", dout, (b, t, h, d), q.dtype),
                                  ("lse", lse, (b * h, t), torch.float32),
                                  ("delta", delta, (b * h, t), torch.float32)):
        if tuple(x.shape) != shape or x.dtype != dtype \
                or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                             f"tensor on {q.device}")
    if q.numel() == 0:
        return
    lead, reps, mul_l, mul_r = bias_split or (0, 0, 0, 0)
    sb, st, sh, _ = kernel_strides(q)
    dq, dk, dv = outs
    fn = _bwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(kind, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                None if kv_mask is None else kv_mask.data_ptr(),
                None if bias is None else bias.data_ptr(),
                seed3.data_ptr() if dropout > 0.0 else None,
                *(None if x is None else x.data_ptr()
                  for x in (dq, dk, dv, dbias)),
                b, h, t, d, sb, sh, st,
                _DTYPES[q.dtype], int(causal), bias_mode,
                *_dropout_args(dropout), 1.0 / (d ** 0.5), lead, reps, mul_l,
                mul_r, stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {rc}")
    _build.count_launch(wrapper)


def flash_bwd_dq(q, k, v, dout, lse, delta, kv_mask=None, bias=None,
                 seed3=None, causal: bool = False, dropout: float = 0.0):
    """Launch K4a: dq [b, t, h, d] contiguous at q's dtype.  q, k, v,
    kv_mask, bias, seed3 as `flash_fwd` takes them; dout [b, t, h, d]
    contiguous at q's dtype; lse (the forward's) and delta = rowsum(dO *
    O) - dlse, [b*h, t] f32 contiguous.  Raises on anything else."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch(0, flash_bwd_dq, q, k, v, dout, lse, delta, kv_mask, bias,
                seed3, causal, dropout, (dq, None, None))
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, dout, lse, delta, kv_mask=None, bias=None,
                  seed3=None, causal: bool = False, dropout: float = 0.0):
    """Launch K4b: (dk, dv) [b, t, h, d] contiguous at q's dtype; the
    arguments as `flash_bwd_dq` takes them."""
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch(1, flash_bwd_dkv, q, k, v, dout, lse, delta, kv_mask, bias,
                seed3, causal, dropout, (None, dk, dv))
    return dk, dv


flash_bwd_dkv.launches = 0


def bias_split(bias_shape, b, h):
    """(lead, reps, mul_l, mul_r): the collapsed bias's planes and the
    broadcast replicas of each, replica r of plane l being bh = mul_l * l
    + mul_r * r (`_flash_bwd`'s split, flash_attention.py:760-767)."""
    per_head, batched = bias_shape[1] == h, bias_shape[0] == b
    if per_head and batched:
        return b * h, 1, 1, 0
    if batched:
        return b, h, h, 1
    if per_head:
        return h, b, 1, h
    return 1, b * h, 0, 1


def flash_bwd_dbias(q, k, v, dout, lse, delta, kv_mask=None, bias=None,
                    seed3=None, causal: bool = False, dropout: float = 0.0):
    """Launch K5: the bias's gradient, f32 at the bias's own shape
    [1|b, 1|h, t, t] (broadcast replicas summed in the kernel); the
    arguments as `flash_bwd_dq` takes them, the bias required."""
    if bias is None:
        raise ValueError("flash_bwd_dbias needs the bias")
    b, _, h, _ = q.shape
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    _bwd_launch(2, flash_bwd_dbias, q, k, v, dout, lse, delta, kv_mask,
                bias, seed3, causal, dropout, (None, None, None), dbias,
                bias_split(tuple(bias.shape), b, h))
    return dbias


flash_bwd_dbias.launches = 0


def flash_bwd(q, k, v, dout, lse, delta, kv_mask=None, bias=None,
              seed3=None, causal: bool = False, dropout: float = 0.0,
              bias_grad: bool = False):
    """The backward through the three kernels: (dq, dk, dv, dbias), the
    dbias pass launched only with `bias_grad` (else None)."""
    args = (q, k, v, dout, lse, delta, kv_mask, bias, seed3, causal, dropout)
    dq = flash_bwd_dq(*args)
    dbias = flash_bwd_dbias(*args) if bias_grad else None
    dk, dv = flash_bwd_dkv(*args)
    return dq, dk, dv, dbias


def _wrap32(x):
    """The int32 value an int64 tensor wraps to, kept as int64 (int32
    arithmetic that wraps, as JAX's does)."""
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def _hash_bits(seed, bh, q_pos, k_pos):
    """Copy of the JAX `_hash_bits`: the int32 avalanche hash of a global
    attention coordinate.  Arguments are int tensors (or ints) that
    broadcast; the arithmetic runs in int64 and wraps to int32 after
    every step, and `>>` is arithmetic, so the bits equal JAX's.
    Returns int32."""
    def i64(x):
        return _wrap32(torch.as_tensor(x).to(torch.int64))

    h = _wrap32(i64(seed) + _wrap32(i64(bh) * 0x27D4EB2F)
                + _wrap32(i64(q_pos) * -0x61C88647)     # 0x9E3779B9
                + _wrap32(i64(k_pos) * 0x2545F491))
    h = h ^ (h >> 15)
    h = _wrap32(h * 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _wrap32(h * 0x297A2D39)
    h = h ^ (h >> 15)
    return h.to(torch.int32)


def drop_keep_mask(seed, bh, q_pos, k_pos, rate: float):
    """Copy of the JAX `drop_keep_mask`: True where a probability is
    kept under dropout at `rate`."""
    bits = _hash_bits(seed, bh, q_pos, k_pos) & 0x7FFFFFFF
    return bits >= int(rate * 0x7FFFFFFF)


def _reference_attn(q, k, v, causal: bool, kv_mask=None, bias=None,
                    dropout: float = 0.0, seed=None):
    """Copy of the JAX `_reference_attn`: q, k, v [bh, t, d]; kv_mask
    [bh, t]; bias [bh, t, t]; seed int [3].  Returns (out [bh, t, d] at
    v's dtype, lse [bh, t, 1] f32)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    keep = None
    t = q.shape[1]
    if causal:
        keep = torch.ones((t, t), dtype=torch.bool,
                          device=q.device).tril()[None]
    if kv_mask is not None:
        valid = (kv_mask != 0)[:, None, :]
        keep = valid if keep is None else (keep & valid)
    if keep is not None:
        s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-20)
    lse = m + torch.log(l)
    p = p / l
    if dropout > 0.0:
        ar = torch.arange(t, device=q.device)
        b_idx = torch.arange(q.shape[0], device=q.device)[:, None, None]
        keep_d = drop_keep_mask(seed[0], b_idx, seed[1] + ar[None, :, None],
                                seed[2] + ar[None, None, :], dropout)
        p = torch.where(keep_d, p * (1.0 / (1.0 - dropout)), 0.0)
    return torch.einsum("bts,bsd->btd", p.to(v.dtype), v), lse


def flash_fwd_reference(q, k, v, kv_mask=None, bias=None, seed3=None,
                        causal: bool = False, dropout: float = 0.0):
    """The plain version, with the kernel's arguments and outputs:
    `_reference_attn` over the [b*h, t, d] layout the TPU kernel sees,
    the kv_mask repeated over heads and the bias broadcast to [b*h, t,
    t]."""
    b, t, h, d = q.shape

    def to_bh(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d)

    mask_bh = None
    if kv_mask is not None:
        mask_bh = kv_mask.to(torch.int32).repeat_interleave(h, dim=0)
    bias_bh = None
    if bias is not None:
        bias_bh = bias.expand(b, h, t, t).reshape(b * h, t, t)
    seed = None if seed3 is None else seed3.to(torch.int64)
    out, lse = _reference_attn(to_bh(q), to_bh(k), to_bh(v), causal,
                               mask_bh, bias_bh, float(dropout), seed)
    out = out.reshape(b, h, t, d).permute(0, 2, 1, 3).to(q.dtype)
    return out, lse[..., 0]


def flash_bwd_reference(q, k, v, dout, lse, delta, kv_mask=None, bias=None,
                        seed3=None, causal: bool = False, dropout: float = 0.0,
                        bias_grad: bool = False):
    """The plain version of `flash_bwd`, with its arguments and outputs:
    the Pallas backward's math (`_flash_bwd` with `_recompute_p`) over
    the whole [b*h, t, t] matrices.  p = exp(s - lse) with masked entries
    exactly 0; dp = dO v^T, dropped and rescaled by the forward's keep
    mask, as p is for dV (p~); ds = p (dp - delta); ds and p~ rounded to
    q's dtype before their products, as the kernels round them."""
    b, t, h, d = q.shape
    scale = 1.0 / (d ** 0.5)

    def to_bh(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).float()

    def from_bh(x):
        return x.reshape(b, h, t, d).permute(0, 2, 1, 3).to(q.dtype)

    qf, kf, vf, gf = to_bh(q), to_bh(k), to_bh(v), to_bh(dout)
    s = torch.einsum("btd,bsd->bts", qf, kf) * scale
    if bias is not None:
        s = s + bias.float().expand(b, h, t, t).reshape(b * h, t, t)
    p = torch.exp(s - lse[..., None])
    keep = None
    if causal:
        keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()[None]
    if kv_mask is not None:
        valid = (kv_mask != 0).repeat_interleave(h, dim=0)[:, None, :]
        keep = valid if keep is None else (keep & valid)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    dp = torch.einsum("btd,bsd->bts", gf, vf)
    p_v = p
    if dropout > 0.0:
        seed = seed3.to(torch.int64)
        ar = torch.arange(t, device=q.device)
        bh_idx = torch.arange(b * h, device=q.device)[:, None, None]
        keep_d = drop_keep_mask(seed[0], bh_idx, seed[1] + ar[None, :, None],
                                seed[2] + ar[None, None, :], dropout)
        inv = 1.0 / (1.0 - dropout)
        p_v = torch.where(keep_d, p * inv, 0.0)
        dp = torch.where(keep_d, dp * inv, 0.0)
    ds = p * (dp - delta[..., None])
    ds_c = ds.to(q.dtype).float()
    dq = torch.einsum("bts,bsd->btd", ds_c, kf) * scale
    dk = torch.einsum("bts,btd->bsd", ds_c, qf) * scale
    dv = torch.einsum("bts,btd->bsd", p_v.to(q.dtype).float(), gf)
    dbias = None
    if bias_grad:
        full = ds.reshape(b, h, t, t)
        dims = [i for i in (0, 1) if bias.shape[i] == 1]
        dbias = (full.sum(dim=dims, keepdim=True) if dims else full)
    return from_bh(dq), from_bh(dk), from_bh(dv), dbias
