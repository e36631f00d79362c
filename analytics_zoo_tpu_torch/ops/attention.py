"""Attention ops (counterpart of analytics_zoo_tpu/ops/attention.py).

`dot_product_attention` is the plain attention every consumer calls:
the full path (causal and/or additive mask) and the KV-cache read path
(`ctx_k/ctx_v/ctx_len`), masked fills at -1e9, f32 softmax, f32 out.

`flash_attention` is the tiled online-softmax attention (key mask,
broadcast bias, causal, positional-hash dropout, logsumexp) and its one
dispatch point: a CUDA tensor goes to the CUDA kernels
(`ops/kernels/flash_attention.py`: the forward, and the dQ, dK/dV and
dbias backward passes), a CPU tensor to their plain versions (the
forward a copy of the JAX package's `_reference_attn`).  One autograd
Function carries both passes on both devices, as the JAX custom_vjp
does (`_flash_vjp_fwd` / `_bwd`, flash_attention.py:901-926).

`paged_decode_attention` is the serving decode path (q_len=1 per lane
against a paged KV block pool) and its one dispatch point: a CUDA
tensor goes to the CUDA kernel (`ops/kernels/paged_attention.py`), a
CPU tensor to the plain version — the block-table gather followed by
the KV-cache read path above, which is the JAX package's XLA fallback.

`paged_verify_attention` is the speculative verify read (q_len > 1 per
lane against the pool).  The JAX package runs it through its XLA gather
path on every backend (no Pallas kernel), and so does the port, on both
devices: the gather and `dot_product_attention`'s KV-cache read path.
"""

from __future__ import annotations

import math

import torch

from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
    flash_bwd,
    flash_bwd_reference,
    flash_fwd,
    flash_fwd_reference,
    kernel_layout_ok,
)
from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
    paged_decode,
    paged_decode_reference,
)


def dot_product_attention(q, k, v, mask=None, causal: bool = False,
                          dropout_rate: float = 0.0, generator=None,
                          compute_dtype=torch.float32, ctx_k=None,
                          ctx_v=None, ctx_len=None):
    """q, k, v: [batch, time, heads, head_dim].  `mask` is an additive
    float mask broadcastable to [batch, heads, q_time, k_time].
    Returns [batch, time, heads, head_dim] f32.

    dropout_rate > 0 with a `generator` (a torch.Generator on q's device)
    drops attention probabilities, kept ones scaled by 1 / (1 - rate),
    as the JAX function does with its rng (its masks come from another
    generator, so the two agree as distributions only).

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
        if dropout_rate > 0.0:
            raise ValueError("dropout is not supported on the KV-cache "
                             "read path (decode is inference-only)")
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
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.empty_like(probs).bernoulli_(1.0 - dropout_rate,
                                                  generator=generator)
        probs = probs * keep / (1.0 - dropout_rate)
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


def paged_verify_attention(q, new_k, new_v, k_pool, v_pool, block_tables,
                           ctx_len, *, k_scale=None, v_scale=None,
                           impl: str = "auto",
                           compute_dtype=torch.float32):
    """Verify-step attention of T > 1 new tokens per lane over its paged
    KV cache — speculative decoding's scoring pass.

    q / new_k / new_v: [S, T, heads, head_dim] — lane s's pending token
    and its T-1 drafted tokens at positions ctx_len[s]..ctx_len[s]+T-1;
    they attend causally over [cached context ; themselves].  k_pool /
    v_pool / block_tables / ctx_len / k_scale / v_scale: as in
    `paged_decode_attention`.  Returns [S, T, heads, head_dim] f32.

    impl: "auto" | "reference"; both run the same plain gather path (no
    kernel of this read exists, in JAX or here)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown paged_verify_attention impl {impl!r}; "
                         "use 'auto' or 'reference'")
    s, t, h, d = q.shape
    nb, bs = k_pool.shape[:2]
    flat_k = k_pool.reshape(nb * bs, h, d)
    flat_v = v_pool.reshape(nb * bs, h, d)
    fk_scale = None if k_scale is None else k_scale.reshape(nb * bs).float()
    fv_scale = None if v_scale is None else v_scale.reshape(nb * bs).float()
    tok_idx = (block_tables.long()[:, :, None] * bs
               + torch.arange(bs, device=q.device)[None, None, :]
               ).reshape(s, -1)
    return dot_product_attention(
        q, new_k, new_v, compute_dtype=compute_dtype,
        ctx_k=_paged_dequant(flat_k, fk_scale, tok_idx),
        ctx_v=_paged_dequant(flat_v, fv_scale, tok_idx),
        ctx_len=ctx_len)


class _Flash(torch.autograd.Function):
    """Differentiable in q, k, v and the bias, through both outputs: an
    lse cotangent folds into delta (d lse_i / d s_ij = p_ij)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_mask, seed3, causal, dropout, impl):
        fwd = flash_fwd if impl == "kernel" else flash_fwd_reference
        out, lse = fwd(q, k, v, kv_mask, bias, seed3, causal, dropout)
        ctx.save_for_backward(q, k, v, bias, kv_mask, seed3, out, lse)
        ctx.set_materialize_grads(False)
        ctx.args = (causal, dropout, impl)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, bias, kv_mask, seed3, out, lse = ctx.saved_tensors
        causal, dropout, impl = ctx.args
        b, t, h, _ = q.shape
        if dout is None:
            dout = torch.zeros_like(out)
        dout = dout.to(q.dtype).contiguous()
        # delta = rowsum(dO * O) - dlse, [b*h, t]: a plain op, as in JAX
        delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1) \
            .reshape(b * h, t)
        if dlse is not None:
            delta = delta - dlse.float()
        bwd = flash_bwd if impl == "kernel" else flash_bwd_reference
        dq, dk, dv, dbias = bwd(q, k, v, dout, lse, delta.contiguous(),
                                kv_mask, bias, seed3, causal, dropout,
                                bias_grad=ctx.needs_input_grad[3])
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, dbias, None, None, None, None, None


def flash_attention(q, k, v, *, kv_mask=None, bias=None, causal: bool = False,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    dropout_generator=None, dropout_pos=None,
                    return_lse: bool = False, impl: str = "auto"):
    """Flash attention over [batch, t, heads, head_dim] (BTHD, as
    `dot_product_attention`), with the JAX `flash_attention`'s
    arguments and checks.  Returns out [b, t, h, d] at q's dtype, and
    with `return_lse` also the pre-dropout logsumexp [b, t, h] f32.

    kv_mask: [b, t] key validity (cast to int32, then nonzero = attend),
    broadcast over heads; a fully masked row gives zeros.  bias: additive
    [1|b, 1|h, t, t], broadcast in place.  dropout_rate > 0 needs
    `dropout_seed` (an int32 scalar or [1] tensor) or a
    `dropout_generator` (a torch.Generator) that draws one;
    `dropout_pos=(q_off, k_off)` shifts the hash to global positions.

    impl: "auto" (the kernels for CUDA tensors, the plain versions for
    CPU tensors) | "kernel" | "reference".  The kernels take any t and
    head_dim 32, 64 or 128.  Differentiable in q, k, v and the bias
    (whose gradient comes back at its own shape and dtype), through out
    and lse; the kernels read q, k, v in place on both passes, so views
    of one fused qkv projection stay views."""
    b, t, h, d = q.shape
    dropout_rate = float(dropout_rate)
    if dropout_rate < 0.0 or dropout_rate >= 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} not in [0, 1)")
    seed3 = None
    if dropout_rate > 0.0:
        if dropout_seed is not None:
            seed = torch.as_tensor(dropout_seed, device=q.device).to(
                torch.int32).reshape(1)
        elif dropout_generator is not None:
            seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,),
                                 generator=dropout_generator,
                                 dtype=torch.int32,
                                 device=dropout_generator.device
                                 ).to(q.device)
        else:
            raise ValueError("dropout_rate > 0 needs dropout_seed or "
                             "dropout_generator")
        q_off, k_off = dropout_pos if dropout_pos is not None else (0, 0)
        # int offsets are filled on the device: a copy from the host
        # would synchronize the stream on every call
        seed3 = torch.cat([seed] + [
            off.to(device=q.device, dtype=torch.int32).reshape(1)
            if torch.is_tensor(off) else
            torch.full((1,), int(off), dtype=torch.int32, device=q.device)
            for off in (q_off, k_off)])
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, t):
            raise ValueError(
                f"kv_mask shape {tuple(kv_mask.shape)} != (batch, t) = "
                f"({b}, {t}); note q/k/v are [batch, t, heads, d] (BTHD), "
                "not BHTD")
        kv_mask = kv_mask.to(torch.int32)
    if bias is not None:
        if bias.dim() != 4 or bias.shape[0] not in (1, b) \
                or tuple(bias.shape[2:]) != (t, t) \
                or bias.shape[1] not in (1, h):
            raise ValueError(
                f"bias shape {tuple(bias.shape)} != (1|batch, 1|heads, t, t)"
                f" = (1|{b}, 1|{h}, {t}, {t})")
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "reference"
    if impl == "kernel":
        if not kernel_layout_ok(q, k, v):
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if kv_mask is not None:
            kv_mask = kv_mask.contiguous()
        if bias is not None:
            bias = bias.float().contiguous()
    elif impl != "reference":
        raise ValueError(f"unknown flash_attention impl {impl!r}; use "
                         "'auto', 'kernel' or 'reference'")
    out, lse = _Flash.apply(q, k, v, bias, kv_mask, seed3, causal,
                            dropout_rate, impl)
    if not return_lse:
        return out
    return out, lse.reshape(b, h, t).permute(0, 2, 1)
