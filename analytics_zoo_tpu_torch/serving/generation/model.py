"""Causal decoder LM for the generation engine (counterpart of
analytics_zoo_tpu/serving/generation/model.py).

A GPT-style stack: token + position embeddings, an `embed_ln`, post-LN
blocks (qkv → attention → proj, residual, ln1; fc1 → tanh-GELU → fc2,
residual, ln2) and an untied `lm_head`.  Every LayerNorm goes through
`ops.normalization.layer_norm` and attention through `ops.attention`
in every mode:

* prefill — pass `token_mask` [batch, t] (1 = real token): full causal
  attention over the bucket-padded prompt;
* paged decode (t == 1) — pass `kv_pool` [n_block, 2, num_blocks,
  block_size, heads, head_dim], `block_tables` [batch, max_blocks],
  `ctx_len` [batch] (and `kv_scale` [n_block, 2, num_blocks,
  block_size] for an int8 pool): each new token attends over its block
  table and itself through `paged_decode_attention`;
* paged verify (t > 1, the same arguments): the t new tokens attend
  causally over the block table and themselves through
  `paged_verify_attention` (speculative decoding's scoring pass);
* concat read (the parity oracle) — pass `ctx_k`/`ctx_v` [n_block,
  batch, ctx, heads, head_dim] gathered from the pool and `ctx_len`.

Every call returns (logits [batch, t, vocab] f32, new_k, new_v
[n_block, batch, t, heads, head_dim] f32); the model never writes the
pool — the engine quantizes and scatters the new keys/values.

`impl` passes through to the ops: "auto" (kernels for CUDA tensors),
or "reference" for the plain versions.  The engine never passes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.ops.attention import (
    dot_product_attention,
    paged_decode_attention,
    paged_verify_attention,
)
from analytics_zoo_tpu_torch.ops.normalization import LayerNorm

#: GPT-2 small's published widths (12 blocks, 768 hidden, 12 heads)
GPT2_SMALL = dict(vocab=50257, hidden_size=768, n_head=12, n_block=12,
                  intermediate_size=3072, max_position_len=1024)


class _Block(nn.Module):

    def __init__(self, hidden: int, intermediate: int, device):
        super().__init__()
        self.qkv = nn.Linear(hidden, 3 * hidden, device=device)
        self.proj = nn.Linear(hidden, hidden, device=device)
        self.ln1 = LayerNorm(hidden, device=device)
        self.fc1 = nn.Linear(hidden, intermediate, device=device)
        self.fc2 = nn.Linear(intermediate, hidden, device=device)
        self.ln2 = LayerNorm(hidden, device=device)


class CausalLM(nn.Module):
    """input_ids/positions [batch, t] -> (logits [batch, t, vocab],
    new_k, new_v [n_block, batch, t, heads, head_dim]).  The
    constructor fields are the JAX module's; `device` follows the
    port's rule (None = the CUDA card, raising without one)."""

    def __init__(self, vocab: int, hidden_size: int = 64, n_head: int = 4,
                 n_block: int = 2, intermediate_size: int = 256,
                 max_position_len: int = 2048,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        if hidden_size % n_head:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of n_head {n_head}")
        self.vocab = vocab
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.n_block = n_block
        self.intermediate_size = intermediate_size
        self.max_position_len = max_position_len
        self.compute_dtype = compute_dtype
        self.token_embed = nn.Embedding(vocab, hidden_size, device=device)
        self.position_embed = nn.Embedding(max_position_len, hidden_size,
                                           device=device)
        self.embed_ln = LayerNorm(hidden_size, device=device)
        self.blocks = nn.ModuleList(
            _Block(hidden_size, intermediate_size, device)
            for _ in range(n_block))
        self.lm_head = nn.Linear(hidden_size, vocab, device=device)

    def _dense(self, layer: nn.Linear, x):
        # nn.Dense(dtype=compute_dtype): inputs and params cast to the
        # compute dtype (no-ops at the default f32)
        cd = self.compute_dtype
        return F.linear(x.to(cd), layer.weight.to(cd), layer.bias.to(cd))

    def forward(self, input_ids, positions, token_mask=None, ctx_k=None,
                ctx_v=None, ctx_len=None, kv_pool=None, kv_scale=None,
                block_tables=None, impl: str = "auto"):
        b, t = input_ids.shape
        h = self.n_head
        hd = self.hidden_size // h
        cd = self.compute_dtype
        x = self.token_embed(input_ids.long()) \
            + self.position_embed(positions.long())
        x = self.embed_ln(x, impl)

        additive_mask = None
        if token_mask is not None:
            additive_mask = (1.0 - token_mask[:, None, None, :].float()) \
                * -1e9

        new_k, new_v = [], []
        for i, blk in enumerate(self.blocks):
            qkv = self._dense(blk.qkv, x)
            q, k, v = (a.reshape(b, t, h, hd)
                       for a in qkv.split(self.hidden_size, dim=-1))
            new_k.append(k.float())
            new_v.append(v.float())
            if kv_pool is not None and t == 1:
                a = paged_decode_attention(
                    q[:, 0], k[:, 0], v[:, 0], kv_pool[i, 0],
                    kv_pool[i, 1], block_tables, ctx_len,
                    k_scale=None if kv_scale is None else kv_scale[i, 0],
                    v_scale=None if kv_scale is None else kv_scale[i, 1],
                    impl=impl, compute_dtype=cd)[:, None]
            elif kv_pool is not None:
                a = paged_verify_attention(
                    q, k, v, kv_pool[i, 0], kv_pool[i, 1], block_tables,
                    ctx_len,
                    k_scale=None if kv_scale is None else kv_scale[i, 0],
                    v_scale=None if kv_scale is None else kv_scale[i, 1],
                    impl=impl, compute_dtype=cd)
            elif ctx_k is not None:
                a = dot_product_attention(
                    q, k, v, compute_dtype=cd, ctx_k=ctx_k[i],
                    ctx_v=ctx_v[i], ctx_len=ctx_len)
            else:
                a = dot_product_attention(q, k, v, mask=additive_mask,
                                          causal=True, compute_dtype=cd)
            a = self._dense(blk.proj, a.reshape(b, t, self.hidden_size))
            x = blk.ln1(x + a.to(x.dtype), impl)
            f = F.gelu(self._dense(blk.fc1, x), approximate="tanh")
            f = self._dense(blk.fc2, f)
            x = blk.ln2(x + f.to(x.dtype), impl)

        logits = self.lm_head(x)
        return logits.float(), torch.stack(new_k), torch.stack(new_v)
