"""Transformer layers (counterpart of
analytics_zoo_tpu/keras/layers/self_attention.py): `MultiHeadAttention`,
`TransformerBlock` and the post-LN `TransformerEncoder` BERT is built on.

Mixed precision as in the JAX package: with compute_dtype bf16 the four
dense outputs (qkv, proj, fc1, fc2) and the attention operands are bf16,
while the params, the embeddings, every LayerNorm, the residual adds and
the pooler stay f32.  Every LayerNorm goes through
`ops.normalization.layer_norm`, fc1 + GELU through
`ops.dense.dense_bias_gelu`, and attention through `ops.attention`.

Inference only: no dropout and no remat (the training slice adds them).
`impl` passes through to the ops: "auto" (kernels for CUDA tensors) or
"reference" for the plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.ops.attention import (
    dot_product_attention,
    flash_attention,
)
from analytics_zoo_tpu_torch.ops.dense import DenseGelu
from analytics_zoo_tpu_torch.ops.normalization import LayerNorm

_ATTN_IMPLS = ("auto", "einsum", "flash")


def _dense(layer: nn.Linear, x, dtype):
    """`nn.Dense(dtype=dtype)`: inputs and params cast to `dtype`."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class MultiHeadAttention(nn.Module):
    """attn_impl: "einsum" (`dot_product_attention`), "flash"
    (`flash_attention`: the CUDA kernel on the card) or "auto" (flash
    at t >= 4096, else einsum, the JAX rule).  `mask` is a [b, t]
    key-validity mask (1 = attend) or a pre-built additive
    [1|b, 1|h, t, t] bias."""

    def __init__(self, hidden_size: int, n_head: int, causal: bool = False,
                 compute_dtype=torch.bfloat16, attn_impl: str = "auto",
                 device=None):
        super().__init__()
        if attn_impl == "ring":
            raise NotImplementedError(
                "attn_impl='ring' (sequence-parallel ring attention) is "
                "ported with the parallel-axes slice (ROADMAP Queue 1); "
                "use 'einsum' or 'flash'")
        if attn_impl not in _ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; use one of "
                             f"{_ATTN_IMPLS}")
        if hidden_size % n_head:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of n_head {n_head}")
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.causal = causal
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size, device=device)
        self.proj = nn.Linear(hidden_size, hidden_size, device=device)

    def forward(self, x, mask=None, impl: str = "auto"):
        b, t, _ = x.shape
        hid, cd = self.hidden_size, self.compute_dtype
        qkv = _dense(self.qkv, x, cd)
        # jnp.split(qkv, 3, -1), then [b, t, h, dh]: views, no copies
        q, k, v = (a.reshape(b, t, self.n_head, hid // self.n_head)
                   for a in qkv.split(hid, dim=-1))
        # a 2-D mask is [b, t] key validity, any other a pre-built
        # additive bias
        key_mask = mask if mask is not None and mask.dim() == 2 else None
        attn = self.attn_impl
        if attn == "auto":
            attn = "flash" if t >= 4096 else "einsum"
        if attn == "flash":
            # the factored [b, t] mask, not the additive form made from it
            out = flash_attention(
                q, k, v, causal=self.causal, kv_mask=key_mask,
                bias=None if key_mask is not None else mask, impl=impl)
        else:
            if key_mask is not None:
                mask = (1.0 - key_mask[:, None, None, :].float()) * -1e9
            out = dot_product_attention(q, k, v, mask=mask,
                                        causal=self.causal, compute_dtype=cd)
        return _dense(self.proj, out.reshape(b, t, hid), cd)


class TransformerBlock(nn.Module):
    """Post-LN block: x = ln1(x + attn(x)); x = ln2(x + fc2(gelu(fc1
    x))), with fc1 + GELU as one `DenseGelu`."""

    def __init__(self, hidden_size: int, n_head: int, intermediate_size: int,
                 causal: bool = False, attn_impl: str = "auto",
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.attn = MultiHeadAttention(hidden_size, n_head, causal,
                                       compute_dtype, attn_impl, device)
        self.ln1 = LayerNorm(hidden_size, device=device)
        self.fc1 = DenseGelu(hidden_size, intermediate_size,
                             dtype=compute_dtype, device=device)
        self.fc2 = nn.Linear(intermediate_size, hidden_size, device=device)
        self.ln2 = LayerNorm(hidden_size, device=device)

    def forward(self, x, mask=None, impl: str = "auto"):
        a = self.attn(x, mask, impl)
        x = self.ln1(x + a.to(x.dtype), impl)
        f = _dense(self.fc2, self.fc1(x, impl), self.compute_dtype)
        return self.ln2(x + f.to(x.dtype), impl)


class TransformerEncoder(nn.Module):
    """Embeddings (token + position [+ segment]), `embed_ln`, n_block
    post-LN blocks and an optional tanh pooler over the first token.
    Returns x [b, t, hidden] f32, or (x, pooled [b, hidden]) with the
    pooler.  The constructor fields are the JAX module's (no dropout or
    remat: inference only); `device` follows the port's rule (None =
    the CUDA card, raising without one)."""

    def __init__(self, vocab: int, hidden_size: int, n_head: int,
                 n_block: int, intermediate_size: int,
                 max_position_len: int = 512, n_segments: int = 0,
                 causal: bool = False, with_pooler: bool = False,
                 attn_impl: str = "auto", compute_dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.n_block = n_block
        self.with_pooler = with_pooler
        self.token_embed = nn.Embedding(vocab, hidden_size, device=device)
        self.position_embed = nn.Embedding(max_position_len, hidden_size,
                                           device=device)
        self.segment_embed = (nn.Embedding(n_segments, hidden_size,
                                           device=device)
                              if n_segments else None)
        self.embed_ln = LayerNorm(hidden_size, device=device)
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden_size, n_head, intermediate_size, causal,
                             attn_impl, compute_dtype, device)
            for _ in range(n_block))
        self.pooler = (nn.Linear(hidden_size, hidden_size, device=device)
                       if with_pooler else None)

    def forward(self, input_ids, segment_ids=None, position_ids=None,
                attention_mask=None, impl: str = "auto"):
        ids = input_ids.long()
        b, t = ids.shape
        x = self.token_embed(ids)
        if position_ids is None:
            position_ids = torch.arange(t, device=ids.device)[None, :]
        x = x + self.position_embed(position_ids.long())
        if self.segment_embed is not None:
            if segment_ids is None:
                segment_ids = torch.zeros_like(ids)
            x = x + self.segment_embed(segment_ids.long())
        x = self.embed_ln(x, impl)
        for blk in self.blocks:
            x = blk(x, attention_mask, impl)
        if self.pooler is not None:
            return x, torch.tanh(self.pooler(x[:, 0]))
        return x
