"""Wide & Deep (counterpart of
analytics_zoo_tpu/models/recommendation/wide_and_deep.py:26-140;
reference scala `models/recommendation/WideAndDeep.scala`): a wide
tower of sparse linear cross features and a deep tower of embeddings
and continuous columns, summed into one head, laid out by a
`ColumnFeatureInfo`.

The wide tower is a sum of per-column [dim, class_num] gathers (the
sparse one-hot product, with no sparse tensor), in column order onto
f32 zeros.  The deep tower concatenates one-hot indicator columns
(`F.one_hot`), embeddings and the continuous columns, casts them to
`compute_dtype`, runs `deep_fc_j` Dense + ReLU in `compute_dtype`, and
adds an f32 `deep_head`.  Weights come from a flax tree through
`convert.wide_and_deep_from_flax`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.common.zoo_model import ZooModel
from analytics_zoo_tpu_torch.models.recommendation.ncf import (
    dense,
    embedding,
    linear,
)
from analytics_zoo_tpu_torch.models.recommendation.recommender import (
    Recommender,
)


class ColumnFeatureInfo:
    """Which input columns feed which tower (the reference's
    ColumnFeatureInfo, wide_and_deep.py)."""

    def __init__(self, wide_base_cols=(), wide_base_dims=(),
                 wide_cross_cols=(), wide_cross_dims=(),
                 indicator_cols=(), indicator_dims=(),
                 embed_cols=(), embed_in_dims=(), embed_out_dims=(),
                 continuous_cols=(), label="label"):
        self.wide_base_cols = list(wide_base_cols)
        self.wide_base_dims = list(wide_base_dims)
        self.wide_cross_cols = list(wide_cross_cols)
        self.wide_cross_dims = list(wide_cross_dims)
        self.indicator_cols = list(indicator_cols)
        self.indicator_dims = list(indicator_dims)
        self.embed_cols = list(embed_cols)
        self.embed_in_dims = list(embed_in_dims)
        self.embed_out_dims = list(embed_out_dims)
        self.continuous_cols = list(continuous_cols)
        self.label = label

    @property
    def wide_dims(self):
        return self.wide_base_dims + self.wide_cross_dims

    @property
    def feature_cols(self):
        """Column order the model's input expects."""
        return (self.wide_base_cols + self.wide_cross_cols
                + self.indicator_cols + self.embed_cols
                + self.continuous_cols)


class WideAndDeep(ZooModel, Recommender, nn.Module):
    """Input: ONE array [batch, n_features] whose columns are ordered as
    `column_info.feature_cols`: wide_base, wide_cross, indicator, embed
    (categorical ids), then continuous floats.  -> logits [batch,
    class_num] f32."""

    def __init__(self, column_info: ColumnFeatureInfo, class_num: int = 2,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 model_type: str = "wide_n_deep",
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        nn.Module.__init__(self)
        if model_type not in ("wide", "deep", "wide_n_deep"):
            raise ValueError(
                f"unsupported model_type '{model_type}'; expected "
                "'wide', 'deep', or 'wide_n_deep'")
        ci = column_info
        self.wide = model_type in ("wide", "wide_n_deep")
        self.deep = model_type in ("deep", "wide_n_deep")
        if self.deep and not (ci.indicator_cols or ci.embed_cols
                              or ci.continuous_cols):
            raise ValueError(
                "deep tower needs at least one indicator/embed/continuous "
                "column in column_info")
        if self.wide and not ci.wide_dims:
            raise ValueError("wide tower needs wide_base/wide_cross columns")
        self._config = dict(column_info=column_info, class_num=class_num,
                            hidden_layers=tuple(hidden_layers),
                            model_type=model_type,
                            compute_dtype=compute_dtype)
        self.device_ = dev = resolve_device(device)
        self.ci = ci
        self.class_num = class_num
        self.compute_dtype = compute_dtype
        self.wide_embed = nn.ModuleList(
            embedding(int(d), class_num, dev) for d in ci.wide_dims) \
            if self.wide else nn.ModuleList()
        self.deep_embed = nn.ModuleList()
        self.deep_fc = nn.ModuleList()
        if self.deep:
            self.deep_embed.extend(
                embedding(int(i), int(o), dev)
                for i, o in zip(ci.embed_in_dims, ci.embed_out_dims))
            widths = [sum(ci.indicator_dims) + sum(ci.embed_out_dims)
                      + len(ci.continuous_cols), *hidden_layers]
            self.deep_fc.extend(linear(a, b, dev)
                                for a, b in zip(widths, widths[1:]))
            self.deep_head = linear(widths[-1], class_num, dev)

    def _pair_features(self, users, items, feats):
        # the ranking input is the stacked per-pair feature rows (built by
        # rows_to_features), not bare ids
        if feats is None:
            raise ValueError(
                "WideAndDeep ranking needs per-pair feature rows; build "
                "them with rows_to_features/to_user_item_feature")
        return [np.asarray(feats, np.float32)]

    def forward(self, features):
        ci = self.ci
        n_wide, n_ind = len(ci.wide_dims), len(ci.indicator_cols)
        n_emb, n_cont = len(ci.embed_cols), len(ci.continuous_cols)
        ids = features[:, :n_wide + n_ind + n_emb].long()
        logits = torch.zeros(features.shape[0], self.class_num,
                             device=features.device)
        if self.wide:
            for j, table in enumerate(self.wide_embed):
                logits = logits + table(
                    ids[:, j].clamp(0, ci.wide_dims[j] - 1))
        if self.deep:
            parts = [F.one_hot(ids[:, n_wide + j].clamp(0, d - 1), d).float()
                     for j, d in enumerate(ci.indicator_dims)]
            off = n_wide + n_ind
            parts += [table(ids[:, off + j].clamp(0, ci.embed_in_dims[j] - 1))
                      for j, table in enumerate(self.deep_embed)]
            if n_cont:
                off += n_emb
                parts.append(features[:, off:off + n_cont].float())
            h = torch.cat(parts, dim=-1).to(self.compute_dtype)
            for lin in self.deep_fc:
                h = torch.relu(dense(h, lin, self.compute_dtype))
            logits = logits + F.linear(h.float(), self.deep_head.weight,
                                       self.deep_head.bias)
        return logits
