"""Session-based recommender (counterpart of
analytics_zoo_tpu/models/recommendation/session_recommender.py:20-51;
reference scala `models/recommendation/SessionRecommender.scala`): a
GRU over the session's recent item clicks, optionally beside an MLP
over a longer purchase history, into logits over the item vocabulary
(`item_count + 1` classes, index 0 the padding id).  All f32.

Each of `rnn_hidden_layers` is one `nn.GRU(batch_first=True)` (the
widths differ, so one stacked GRU cannot hold them), standing in for
flax's `nn.RNN(GRUCell)`: both compute
`n = tanh(W_in x + b_in + r * (W_hn h + b_hn))` from a zero state.
flax's r and z gates have one bias, on the input side; the GRU's
hidden-side biases of r and z (`bias_hh_l0[:2w]`) are zero, and a
gradient hook keeps them there, so the optimizer moves only the bias
flax has.  Weights come from a flax tree through
`convert.session_recommender_from_flax`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.common.zoo_model import ZooModel
from analytics_zoo_tpu_torch.models.recommendation.ncf import (
    embedding,
    linear,
)


def _gru(fan_in: int, width: int, device) -> nn.GRU:
    """A one-layer GRU drawn as flax's GRUCell init (lecun normal input
    weights, orthogonal recurrent weights per gate, zero biases), its
    r and z hidden-side biases held at zero."""
    gru = nn.GRU(fan_in, width, batch_first=True, device=device)
    with torch.no_grad():
        nn.init.trunc_normal_(gru.weight_ih_l0, std=fan_in ** -0.5,
                              a=-2 * fan_in ** -0.5, b=2 * fan_in ** -0.5)
        for g in range(3):
            nn.init.orthogonal_(gru.weight_hh_l0[g * width:(g + 1) * width])
        gru.bias_ih_l0.zero_()
        gru.bias_hh_l0.zero_()
    keep = torch.ones(3 * width, device=device)
    keep[:2 * width] = 0.0
    gru.bias_hh_l0.register_hook(lambda g: g * keep)
    return gru


class SessionRecommender(ZooModel, nn.Module):
    """(session_items [b, session_length][, history_items [b,
    history_length]]) -> logits [b, item_count + 1] f32."""

    def __init__(self, item_count: int, item_embed: int = 100,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 10, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 history_length: int = 5, device=None):
        nn.Module.__init__(self)
        self._config = dict(item_count=item_count, item_embed=item_embed,
                            rnn_hidden_layers=tuple(rnn_hidden_layers),
                            session_length=session_length,
                            include_history=include_history,
                            mlp_hidden_layers=tuple(mlp_hidden_layers),
                            history_length=history_length)
        self.device_ = dev = resolve_device(device)
        self.item_count = item_count
        self.include_history = include_history
        self.session_embed = embedding(item_count + 1, item_embed, dev)
        widths = [item_embed, *rnn_hidden_layers]
        self.gru = nn.ModuleList(_gru(a, b, dev)
                                 for a, b in zip(widths, widths[1:]))
        head_in = widths[-1]
        if include_history:
            self.history_embed = embedding(item_count + 1, item_embed, dev)
            mlp = [history_length * item_embed, *mlp_hidden_layers]
            self.mlp = nn.ModuleList(linear(a, b, dev)
                                     for a, b in zip(mlp, mlp[1:]))
            head_in += mlp[-1]
        self.head = linear(head_in, item_count + 1, dev)

    def forward(self, session_items, history_items=None):
        x = self.session_embed(session_items.long().clamp(0, self.item_count))
        for gru in self.gru:
            x, _ = gru(x)
        h = x[:, -1]
        if self.include_history:
            if history_items is None:
                raise ValueError("include_history=True needs history_items")
            hist = self.history_embed(
                history_items.long().clamp(0, self.item_count))
            hist = hist.reshape(hist.shape[0], -1)
            for lin in self.mlp:
                hist = torch.relu(lin(hist))
            h = torch.cat([h, hist], dim=-1)
        return self.head(h)
