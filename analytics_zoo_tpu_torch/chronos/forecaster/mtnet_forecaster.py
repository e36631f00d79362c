"""MTNet forecaster (counterpart of
analytics_zoo_tpu/chronos/forecaster/mtnet_forecaster.py): the input
window is `long_series_num` memory chunks and one short-term chunk of
`series_length` steps each; each chunk is encoded by a conv, an additive
attention over time and a GRU; attention over the memory encodings,
conditioned on the short-term encoding, gives the context; a linear
autoregressive head over the last `ar_window_size` target steps is
added.

* The conv is flax's `Conv(k=3, padding="SAME")`: `nn.Conv1d(padding=1)`
  on NCW, a pad of one on each side (not the TCN's causal left pad).
* The time attention is a softmax over the steps; the sequence is
  multiplied by it.  The GRU is `recurrent.gru` (flax's GRUCell); its
  last step is the chunk's encoding.
* ONE memory encoder, shared by every chunk: JAX vmaps it with shared
  params and one dropout key; here the chunks are folded into the
  batch and share one dropout mask per row.  The short-term encoder
  has weights of its own.
* The memory attention's logits are scaled by 1/sqrt(rnn_hid).  JAX
  sows the weights into "intermediates"; here the module keeps the last
  forward's weights, detached, as `memory_attention` [batch,
  long_series_num].
* The AR head is flax's `DenseGeneral(features=(horizon,), axis=1)`:
  a Linear(ar, horizon) over the time axis of x[:, -ar:, :target],
  whose kernel is flax's transposed.

The module's flax tree maps to its state_dict by
`convert.mtnet_forecaster_from_flax` / `_to_flax`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from analytics_zoo_tpu_torch.chronos.forecaster.base import BaseForecaster
from analytics_zoo_tpu_torch.keras.layers.self_attention import dropout
from analytics_zoo_tpu_torch.models.common import recurrent
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    Dense,
    _lecun_normal_,
)


class _ChunkEncoder(nn.Module):
    """conv + time attention + GRU over chunks [b, T, D] -> [b, H]."""

    def __init__(self, in_dim: int, cnn_hid: int, rnn_hid: int,
                 rate: float, device):
        super().__init__()
        self.rate = rate
        self.conv = nn.Conv1d(in_dim, cnn_hid, 3, padding=1, device=device)
        _lecun_normal_(self.conv.weight, in_dim * 3)
        nn.init.zeros_(self.conv.bias)
        self.attn_proj = Dense(cnn_hid, cnn_hid, device=device)
        self.attn = Dense(cnn_hid, 1, device=device)
        self.gru = recurrent.gru(cnn_hid, rnn_hid, device)

    def forward(self, x, generator=None, chunks: int = 1):
        """x [b * chunks, T, D], chunk-major within each row: the
        `chunks` of a row share one dropout mask."""
        h = torch.relu(self.conv(x.transpose(1, 2))).transpose(1, 2)
        if self.training and self.rate:
            mask = dropout(h.new_ones((h.shape[0] // chunks, 1)
                                      + h.shape[1:]),
                           self.rate, True, generator)
            h = (h.unflatten(0, (-1, chunks)) * mask).flatten(0, 1)
        score = self.attn(torch.tanh(self.attn_proj(h)))
        h = h * torch.softmax(score, dim=1)
        return self.gru(h)[0][:, -1]


class MTNet(nn.Module):
    """x [batch, (long_series_num + 1) * series_length, feature_dim] ->
    [batch, horizon, target_num] f32."""

    def __init__(self, feature_dim: int, long_series_num: int,
                 series_length: int, ar_window: int, cnn_hid: int,
                 rnn_hid: int, horizon: int, target_num: int,
                 dropout: float, device=None):
        super().__init__()
        self.n, self.t = long_series_num, series_length
        self.ar_window, self.rnn_hid = ar_window, rnn_hid
        self.horizon, self.target_num = horizon, target_num
        self.mem_encoder = _ChunkEncoder(feature_dim, cnn_hid, rnn_hid,
                                         dropout, device)
        self.short_encoder = _ChunkEncoder(feature_dim, cnn_hid, rnn_hid,
                                           dropout, device)
        self.head = Dense(2 * rnn_hid, horizon * target_num, device=device)
        self.ar = (Dense(ar_window, horizon, device=device)
                   if ar_window > 0 else None)
        #: the last forward's memory attention [batch, long_series_num]
        self.memory_attention = None

    def forward(self, x, generator=None):
        x = x.float()
        n, t = self.n, self.t
        b, total, d = x.shape
        if total != (n + 1) * t:
            raise ValueError(
                f"MTNet input needs {(n + 1) * t} steps "
                f"({n} memory chunks + 1 short chunk of {t}), got {total}")
        mem = x[:, :n * t].reshape(b * n, t, d)
        m = self.mem_encoder(mem, generator, n).reshape(b, n, -1)
        u = self.short_encoder(x[:, n * t:], generator)
        logits = torch.einsum("bnh,bh->bn", m, u) / math.sqrt(self.rnn_hid)
        attn = torch.softmax(logits, dim=1)
        self.memory_attention = attn.detach()
        context = torch.einsum("bn,bnh->bh", attn, m)
        out = self.head(torch.cat([context, u], dim=-1))
        out = out.reshape(b, self.horizon, self.target_num)
        if self.ar is not None:
            ar_in = x[:, -self.ar_window:, :self.target_num]
            out = out + self.ar(ar_in.transpose(1, 2)).transpose(1, 2)
        return out


class MTNetForecaster(BaseForecaster):
    """JAX's constructor (`target_dim`, `feature_dim`, `long_series_num`,
    `series_length`, `ar_window_size`, `cnn_hid_size`, `rnn_hid_size`,
    `horizon`, `dropout`, `optimizer`, `lr`, `seed`) and `device`.  The
    model takes windows of `(long_series_num + 1) * series_length`
    steps."""

    loss = "mse"
    metrics = ("mse", "mae")

    def __init__(self, target_dim: int = 1, feature_dim: int = 1,
                 long_series_num: int = 4, series_length: int = 8,
                 ar_window_size: int = 4, cnn_hid_size: int = 32,
                 rnn_hid_size: int = 32, horizon: int = 1,
                 dropout: float = 0.1, optimizer: str = "adam",
                 lr: float = 1e-3, seed: int = 0, device=None):
        past = (long_series_num + 1) * series_length
        super().__init__(past_seq_len=past, future_seq_len=horizon,
                         input_feature_num=feature_dim,
                         output_feature_num=target_dim,
                         optimizer=optimizer, lr=lr, seed=seed,
                         device=device)
        self.long_series_num = long_series_num
        self.series_length = series_length
        self.ar_window_size = min(ar_window_size, past)
        self.cnn_hid_size = cnn_hid_size
        self.rnn_hid_size = rnn_hid_size
        self.dropout = dropout

    def _build_module(self, device):
        return MTNet(self.input_feature_num, self.long_series_num,
                     self.series_length, self.ar_window_size,
                     self.cnn_hid_size, self.rnn_hid_size,
                     self.future_seq_len, self.output_feature_num,
                     self.dropout, device=device)

    def _config(self):
        return dict(target_dim=self.output_feature_num,
                    feature_dim=self.input_feature_num,
                    long_series_num=self.long_series_num,
                    series_length=self.series_length,
                    ar_window_size=self.ar_window_size,
                    cnn_hid_size=self.cnn_hid_size,
                    rnn_hid_size=self.rnn_hid_size,
                    horizon=self.future_seq_len, dropout=self.dropout,
                    optimizer=self._optimizer, lr=self._lr)
