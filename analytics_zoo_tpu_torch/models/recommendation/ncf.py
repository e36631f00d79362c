"""Neural Collaborative Filtering (counterpart of
analytics_zoo_tpu/models/recommendation/ncf.py:25-62; reference scala
`models/recommendation/NeuralCF.scala:45-110`): GMF (the elementwise
product of matrix-factorization embeddings) beside an MLP tower over
the concatenated user and item embeddings, into a `class_num` head.

The casts are the flax module's: ids clipped to `clip(id - 1, 0,
count - 1)` (the reference counts from 1); four f32 embedding tables;
the MLP input `cat[mlp_u, mlp_i]` cast to `compute_dtype`, each hidden
Dense + ReLU in `compute_dtype` with its weight and bias cast to it and
the bias added after the product (`dense`, as flax's `Dense(dtype=...)`);
the MF branch `mf_u * mf_i` in f32, then cast; the head an f32 Dense
over `cat[h, mf]` cast to f32.  The embedding gradients are dense: the
Estimator's Adam (optax's) moves every row each step, as a sparse
update would not.  Weights come from a flax tree through
`convert.ncf_from_flax`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.common.zoo_model import ZooModel
from analytics_zoo_tpu_torch.models.recommendation.recommender import (
    Recommender,
)


def embedding(num: int, features: int, device) -> nn.Embedding:
    """An f32 table drawn as flax's default Embed init (std
    1/sqrt(features))."""
    table = nn.Embedding(num, features, device=device)
    nn.init.normal_(table.weight, std=features ** -0.5)
    return table


def linear(fan_in: int, fan_out: int, device) -> nn.Linear:
    """An f32 Linear drawn as flax's default Dense init (lecun normal,
    zero bias)."""
    lin = nn.Linear(fan_in, fan_out, device=device)
    nn.init.trunc_normal_(lin.weight, std=fan_in ** -0.5,
                          a=-2 * fan_in ** -0.5, b=2 * fan_in ** -0.5)
    nn.init.zeros_(lin.bias)
    return lin


def dense(x, lin: nn.Linear, dtype: torch.dtype):
    """flax `Dense(dtype=dtype)`: input, weight and bias cast to `dtype`,
    the bias added to the product in `dtype`."""
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


class NeuralCF(ZooModel, Recommender, nn.Module):
    """(user_ids [b], item_ids [b]) -> logits [b, class_num] f32."""

    def __init__(self, user_count: int, item_count: int, class_num: int = 2,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        nn.Module.__init__(self)
        self._config = dict(user_count=user_count, item_count=item_count,
                            class_num=class_num, user_embed=user_embed,
                            item_embed=item_embed,
                            hidden_layers=tuple(hidden_layers),
                            include_mf=include_mf, mf_embed=mf_embed,
                            compute_dtype=compute_dtype)
        self.device_ = dev = resolve_device(device)
        self.user_count, self.item_count = user_count, item_count
        self.include_mf = include_mf
        self.compute_dtype = compute_dtype
        self.mlp_user_embed = embedding(user_count, user_embed, dev)
        self.mlp_item_embed = embedding(item_count, item_embed, dev)
        widths = [user_embed + item_embed, *hidden_layers]
        self.hidden = nn.ModuleList(linear(a, b, dev)
                                    for a, b in zip(widths, widths[1:]))
        if include_mf:
            self.mf_user_embed = embedding(user_count, mf_embed, dev)
            self.mf_item_embed = embedding(item_count, mf_embed, dev)
        self.head = linear(widths[-1] + (mf_embed if include_mf else 0),
                           class_num, dev)

    def forward(self, user_ids, item_ids):
        u = (user_ids.reshape(-1).long() - 1).clamp(0, self.user_count - 1)
        i = (item_ids.reshape(-1).long() - 1).clamp(0, self.item_count - 1)
        h = torch.cat([self.mlp_user_embed(u), self.mlp_item_embed(i)],
                      dim=-1).to(self.compute_dtype)
        for lin in self.hidden:
            h = torch.relu(dense(h, lin, self.compute_dtype))
        if self.include_mf:
            mf = self.mf_user_embed(u) * self.mf_item_embed(i)
            h = torch.cat([h, mf.to(self.compute_dtype)], dim=-1)
        return F.linear(h.float(), self.head.weight, self.head.bias)
