"""Transformer layers (counterpart of
analytics_zoo_tpu/keras/layers/self_attention.py): `MultiHeadAttention`,
`RelativePositionBias`, `TransformerBlock` and the post-LN
`TransformerEncoder` BERT is built on.

Mixed precision as in the JAX package: with compute_dtype bf16 the four
dense outputs (qkv, proj, fc1, fc2) and the attention operands are bf16,
while the params, the embeddings, every LayerNorm, the residual adds and
the pooler stay f32.  Every LayerNorm goes through
`ops.normalization.layer_norm`, fc1 + GELU through
`ops.dense.dense_bias_gelu`, and attention through `ops.attention`; all
three are differentiable, their backward passes kernels on the card.

Dropout as in the JAX layers, on while the module is in training mode
(`self.training`): attention dropout inside flash (the positional hash,
its seed drawn from the generator) or einsum, residual dropout on the
attention and MLP outputs, embedding dropout after `embed_ln`.  Every
keep mask comes from the `generator` (a torch.Generator on the module's
device) passed to `forward`, never from the global RNG; training mode
with a dropout rate and no generator raises.  `impl` passes through to
the ops: "auto" (kernels for CUDA tensors) or "reference" for the plain
versions.

`TransformerEncoder(remat=True)` runs each block under
`torch.utils.checkpoint` (non-reentrant), the JAX `nn.remat`: the
backward pass recomputes the block's forward instead of keeping its
activations.  The recompute draws every dropout mask and flash seed
again from a fork of the generator at the block's entry state, so it
replays the forward exactly, while the training generator stays where
the forward left it (the next step draws what it would without remat).
`remat_policy` chooses what is saved instead of recomputed: None
nothing; "dots" the products without batch dimensions (`aten.mm` /
`aten.addmm`: the qkv, proj and fc2 projections), as JAX's
`dots_with_no_batch_dims_saveable`; "dots_all" every product, the
batched ones of the einsum attention (`aten.bmm`) too, as
`dots_saveable`.  Kernel launches (LayerNorm, fused dense + GELU, flash)
are not aten products, so they are recomputed under every policy, as a
`pallas_call` is in JAX.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.ops.attention import (
    dot_product_attention,
    flash_attention,
)
from analytics_zoo_tpu_torch.ops.dense import DenseGelu
from analytics_zoo_tpu_torch.ops.normalization import LayerNorm

_ATTN_IMPLS = ("auto", "einsum", "flash")
_REMAT_POLICIES = (None, "dots", "dots_all")


def _remat_context(policy):
    """The `context_fn` of `torch.utils.checkpoint` for a remat policy."""
    if policy is None:
        return torch_checkpoint.noop_context_fn
    aten = torch.ops.aten
    saved = [aten.mm.default, aten.addmm.default]
    if policy == "dots_all":
        saved += [aten.bmm.default, aten.baddbmm.default]
    return partial(torch_checkpoint.create_selective_checkpoint_contexts,
                   saved)


def remat_block(block, x, mask, impl: str, generator, policy=None):
    """`block(x, mask, impl, generator)` under non-reentrant
    `torch.utils.checkpoint`, its recompute drawing from a fork of
    `generator` at its state on entry (a host read of the seed and
    offset, no device sync)."""
    entry = generator.get_state() if generator is not None else None
    calls = []

    def run(x, mask):
        gen = generator
        if calls and entry is not None:
            # the recompute: replay the forward's draws from a fork, and
            # leave the training generator where the forward left it
            gen = torch.Generator(device=generator.device)
            gen.set_state(entry)
        calls.append(1)
        return block(x, mask, impl, gen)

    return torch_checkpoint.checkpoint(
        run, x, mask, use_reentrant=False, preserve_rng_state=False,
        context_fn=_remat_context(policy))


def _dense(layer: nn.Linear, x, dtype):
    """`nn.Dense(dtype=dtype)`: inputs and params cast to `dtype`."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def _check_generator(rate: float, generator) -> None:
    if rate > 0.0 and generator is None:
        raise ValueError("dropout in training mode draws its keep masks "
                         "from an explicit torch.Generator: pass "
                         "generator=..., or call .eval()")


def dropout(x, rate: float, training: bool, generator=None):
    """`nn.Dropout(rate)(x, deterministic=not training)`: in training,
    each element kept with probability 1 - rate (mask drawn from
    `generator`) and scaled by 1 / (1 - rate); otherwise x itself."""
    if not training or rate == 0.0:
        return x
    _check_generator(rate, generator)
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


class MultiHeadAttention(nn.Module):
    """attn_impl: "einsum" (`dot_product_attention`), "flash"
    (`flash_attention`: the CUDA kernels on the card) or "auto" (flash
    at t >= 4096, else einsum, the JAX rule).  `mask` is a [b, t]
    key-validity mask (1 = attend) or a pre-built additive
    [1|b, 1|h, t, t] bias (differentiable: a learnable bias trains
    through flash's dbias pass)."""

    def __init__(self, hidden_size: int, n_head: int, attn_dropout: float = 0.0,
                 causal: bool = False, compute_dtype=torch.bfloat16,
                 attn_impl: str = "auto", device=None):
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
        self.attn_dropout = attn_dropout
        self.causal = causal
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size, device=device)
        self.proj = nn.Linear(hidden_size, hidden_size, device=device)

    def forward(self, x, mask=None, impl: str = "auto", generator=None):
        b, t, _ = x.shape
        hid, cd = self.hidden_size, self.compute_dtype
        rate = self.attn_dropout if self.training else 0.0
        _check_generator(rate, generator)
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
                bias=None if key_mask is not None else mask,
                dropout_rate=rate, dropout_generator=generator, impl=impl)
        else:
            if key_mask is not None:
                mask = (1.0 - key_mask[:, None, None, :].float()) * -1e9
            out = dot_product_attention(q, k, v, mask=mask,
                                        causal=self.causal,
                                        dropout_rate=rate,
                                        generator=generator,
                                        compute_dtype=cd)
        return _dense(self.proj, out.reshape(b, t, hid), cd)


class RelativePositionBias(nn.Module):
    """T5-style bucketed relative-position attention bias: a learnable
    [n_head, num_buckets] table (`weight`, the JAX param "rel_bias",
    N(0, 0.02^2) at init) gathered into a [1, n_head, t, t] additive
    bias for `MultiHeadAttention`'s `mask` or `flash_attention`'s
    `bias`; its gradient reaches the table through flash's dbias pass
    and the gather's scatter-add."""

    def __init__(self, n_head: int, num_buckets: int = 32,
                 max_distance: int = 128, causal: bool = False, device=None):
        super().__init__()
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.causal = causal
        self.weight = nn.Parameter(
            0.02 * torch.randn(n_head, num_buckets, device=device))

    @staticmethod
    def bucket(rel_pos, num_buckets: int, max_distance: int, causal: bool):
        """T5's log-spaced distance buckets for rel_pos = k_pos - q_pos
        (int [t, t] -> int64 bucket ids [t, t]), in f32 as the JAX
        function computes them."""
        n = torch.as_tensor(rel_pos).to(torch.int64)
        if causal:
            n = -torch.clamp_max(n, 0)       # only the past exists
            offset = 0
        else:
            num_buckets //= 2                # each sign gets half
            offset = torch.where(n > 0, num_buckets, 0)
            n = n.abs()
        max_exact = num_buckets // 2
        log_big = max_exact + (
            torch.log(n.clamp_min(1).float() / max_exact)
            / math.log(max_distance / max_exact)
            * (num_buckets - max_exact)).to(torch.int64)
        big = torch.clamp_max(log_big, num_buckets - 1)
        return offset + torch.where(n < max_exact, n, big)

    def forward(self, t: int):
        pos = torch.arange(t, device=self.weight.device)
        ids = self.bucket(pos[None, :] - pos[:, None], self.num_buckets,
                          self.max_distance, self.causal)     # [t, t]
        return self.weight[:, ids][None]                      # [1, h, t, t]


class TransformerBlock(nn.Module):
    """Post-LN block: x = ln1(x + drop(attn(x))); x = ln2(x + drop(fc2(
    gelu(fc1 x)))), with fc1 + GELU as one `DenseGelu`."""

    def __init__(self, hidden_size: int, n_head: int, intermediate_size: int,
                 attn_dropout: float = 0.0, residual_dropout: float = 0.0,
                 causal: bool = False, attn_impl: str = "auto",
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.residual_dropout = residual_dropout
        self.attn = MultiHeadAttention(hidden_size, n_head, attn_dropout,
                                       causal, compute_dtype, attn_impl,
                                       device)
        self.ln1 = LayerNorm(hidden_size, device=device)
        self.fc1 = DenseGelu(hidden_size, intermediate_size,
                             dtype=compute_dtype, device=device)
        self.fc2 = nn.Linear(intermediate_size, hidden_size, device=device)
        self.ln2 = LayerNorm(hidden_size, device=device)

    def forward(self, x, mask=None, impl: str = "auto", generator=None):
        a = self.attn(x, mask, impl, generator)
        a = dropout(a, self.residual_dropout, self.training, generator)
        x = self.ln1(x + a.to(x.dtype), impl)
        f = _dense(self.fc2, self.fc1(x, impl), self.compute_dtype)
        f = dropout(f, self.residual_dropout, self.training, generator)
        return self.ln2(x + f.to(x.dtype), impl)


class TransformerEncoder(nn.Module):
    """Embeddings (token + position [+ segment]), `embed_ln`, embedding
    dropout, n_block post-LN blocks and an optional tanh pooler over the
    first token.  Returns x [b, t, hidden] f32, or (x, pooled [b,
    hidden]) with the pooler.  The constructor fields are the JAX
    module's, dropouts at its defaults (0.1), `remat` and `remat_policy`
    included (module docstring); `device` follows the port's rule (None
    = the CUDA card, raising without one)."""

    def __init__(self, vocab: int, hidden_size: int, n_head: int,
                 n_block: int, intermediate_size: int,
                 max_position_len: int = 512, n_segments: int = 0,
                 embedding_dropout: float = 0.1, attn_dropout: float = 0.1,
                 residual_dropout: float = 0.1, causal: bool = False,
                 with_pooler: bool = False, attn_impl: str = "auto",
                 compute_dtype=torch.bfloat16, remat: bool = False,
                 remat_policy=None, device=None):
        super().__init__()
        if remat_policy not in _REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {remat_policy!r}; "
                "use None, 'dots' or 'dots_all'")
        if remat_policy is not None and not remat:
            raise ValueError(
                "remat_policy is set but remat=False: the policy would be "
                "silently ignored; enable remat or drop it")
        self.remat = remat
        self.remat_policy = remat_policy
        device = resolve_device(device)
        self.n_block = n_block
        self.with_pooler = with_pooler
        self.embedding_dropout = embedding_dropout
        self.token_embed = nn.Embedding(vocab, hidden_size, device=device)
        self.position_embed = nn.Embedding(max_position_len, hidden_size,
                                           device=device)
        self.segment_embed = (nn.Embedding(n_segments, hidden_size,
                                           device=device)
                              if n_segments else None)
        self.embed_ln = LayerNorm(hidden_size, device=device)
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden_size, n_head, intermediate_size,
                             attn_dropout, residual_dropout, causal,
                             attn_impl, compute_dtype, device)
            for _ in range(n_block))
        self.pooler = (nn.Linear(hidden_size, hidden_size, device=device)
                       if with_pooler else None)

    def forward(self, input_ids, segment_ids=None, position_ids=None,
                attention_mask=None, impl: str = "auto", generator=None):
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
        x = dropout(x, self.embedding_dropout, self.training, generator)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = remat_block(blk, x, attention_mask, impl, generator,
                                self.remat_policy)
            else:
                x = blk(x, attention_mask, impl, generator)
        if self.pooler is not None:
            return x, torch.tanh(self.pooler(x[:, 0]))
        return x
