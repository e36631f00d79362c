"""Attention ops (counterpart of analytics_zoo_tpu/ops/attention.py).

`dot_product_attention` is the plain attention every consumer calls:
the full path (causal and/or additive mask) and the KV-cache read path
(`ctx_k/ctx_v/ctx_len`), masked fills at -1e9, f32 softmax, f32 out.

`paged_decode_attention` is the serving decode path (q_len=1 per lane
against a paged KV block pool) and its one dispatch point: a CUDA
tensor goes to the CUDA kernel (`ops/kernels/paged_attention.py`), a
CPU tensor to the plain version — the block-table gather followed by
the KV-cache read path above, which is the JAX package's XLA fallback.
"""

from __future__ import annotations

import math

import torch

from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
    paged_decode,
    paged_decode_reference,
)


def dot_product_attention(q, k, v, mask=None, causal: bool = False,
                          compute_dtype=torch.float32, ctx_k=None,
                          ctx_v=None, ctx_len=None):
    """q, k, v: [batch, time, heads, head_dim].  `mask` is an additive
    float mask broadcastable to [batch, heads, q_time, k_time].
    Returns [batch, time, heads, head_dim] f32.

    KV-cache read path: `ctx_k`/`ctx_v` [batch, ctx, heads, head_dim]
    hold the cached keys/values of the tokens preceding q (garbage past
    `ctx_len` [batch]); q/k/v carry only the new tokens, at absolute
    positions ctx_len..ctx_len+time-1, and attend causally over
    [ctx ; new] with the padding columns masked.  `mask`/`causal` are
    ignored on this path."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q = q.to(compute_dtype)
    k = k.to(compute_dtype)
    v = v.to(compute_dtype)

    if ctx_k is not None:
        c = ctx_k.shape[1]
        ctx_len = torch.as_tensor(ctx_len, device=q.device).long()
        keys = torch.cat([ctx_k.to(compute_dtype), k], dim=1)
        vals = torch.cat([ctx_v.to(compute_dtype), v], dim=1)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, keys).float() * scale
        col = torch.arange(c + t, device=q.device)[None, :]
        # cached col j sits at position j; new col c+j2 is the token at
        # ctx_len+j2
        k_pos = torch.where(col < c, col, ctx_len[:, None] + (col - c))
        q_pos = ctx_len[:, None] + torch.arange(t, device=q.device)[None]
        valid = ((k_pos[:, None, :] <= q_pos[:, :, None])
                 & ((col >= c) | (col < ctx_len[:, None]))[:, None, :])
        scores = scores.masked_fill(~valid[:, None], -1e9)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(compute_dtype), vals)
        return out.float()

    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        causal_mask = torch.ones((t, t), dtype=torch.bool,
                                 device=q.device).tril()
        scores = scores.masked_fill(~causal_mask[None, None], -1e9)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(compute_dtype), v)
    return out.float()


def _paged_dequant(flat, flat_scale, tok_idx):
    """Gather token rows from a flat [ntok, h, d] pool view and
    dequantize when a flat [ntok] scale vector rides along."""
    ctx = flat[tok_idx]                                  # [S, C, h, d]
    if flat_scale is not None:
        ctx = ctx.float() * flat_scale[tok_idx][:, :, None, None]
    return ctx


def paged_decode_attention(q, new_k, new_v, k_pool, v_pool, block_tables,
                           ctx_len, *, k_scale=None, v_scale=None,
                           impl: str = "auto",
                           compute_dtype=torch.float32):
    """Decode-step attention of one new token per lane over its paged
    KV cache — the generation engine's hot path.

    q / new_k / new_v: [S, heads, head_dim] — lane s's pending token
    (it attends to itself as well as the cache).  k_pool / v_pool:
    [num_blocks, block_size, heads, head_dim] (block 0 is the null
    block); int8 pools pass `k_scale`/`v_scale` [num_blocks, block_size]
    f32.  block_tables: [S, max_blocks] int32; ctx_len: [S] int32 —
    cached position p of lane s lives at block_tables[s, p // bs], slot
    p % bs; entries at or past ctx_len are masked.  Returns
    [S, heads, head_dim] f32.

    impl: "auto" (the kernel for CUDA tensors, the plain version for
    CPU tensors) | "kernel" | "reference".  The kernel computes in f32
    whatever `compute_dtype` says, as the TPU kernel does."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "reference"
    if impl == "reference":
        return paged_decode_reference(
            q, new_k, new_v, k_pool, v_pool, block_tables, ctx_len,
            k_scale=k_scale, v_scale=v_scale, compute_dtype=compute_dtype)
    if impl != "kernel":
        raise ValueError(f"unknown paged_decode_attention impl {impl!r}; "
                         "use 'auto', 'kernel' or 'reference'")
    return paged_decode(
        q.float().contiguous(), new_k.float().contiguous(),
        new_v.float().contiguous(), k_pool, v_pool,
        block_tables.to(torch.int32).contiguous(),
        ctx_len.to(torch.int32).contiguous(), k_scale=k_scale,
        v_scale=v_scale)
