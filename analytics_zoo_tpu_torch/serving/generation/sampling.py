"""Token sampling for the decode step (counterpart of
analytics_zoo_tpu/serving/generation/sampling.py).

Sampling params are per-slot tensors, so lanes with different settings
share one step.  The draw comes from an explicit `torch.Generator`; it
gives other numbers than the JAX key of the same seed, so only greedy
decoding (`argmax`, first index on ties in both frameworks) matches the
JAX package token for token.
"""

from __future__ import annotations

import torch


def sample_tokens(logits, generator, temperature, top_k):
    """Next-token ids [slots] (int32) from `logits` [slots, vocab].

    temperature [slots] f32 — <= 0 selects greedy (argmax) for that
    slot; top_k [slots] int32 — > 0 restricts sampling to the k highest
    logits for that slot, 0 disables the filter.  One categorical draw
    per slot from `generator` (on the logits' device)."""
    vocab = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    # per-slot top-k threshold: the k-th largest logit (k=0 → the
    # smallest, i.e. no filtering)
    desc = torch.sort(logits, dim=-1, descending=True).values
    kk = torch.clamp(torch.where(top_k > 0, top_k,
                                 torch.full_like(top_k, vocab)),
                     1, vocab) - 1
    thresh = torch.gather(desc, -1, kk[:, None].long())
    filtered = logits.masked_fill(logits < thresh, float("-inf"))
    scaled = filtered / torch.clamp_min(temperature, 1e-6)[:, None]
    probs = torch.softmax(scaled.float(), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature > 0.0, sampled, greedy).to(torch.int32)
