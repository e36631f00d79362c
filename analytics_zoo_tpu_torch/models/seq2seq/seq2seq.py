"""Seq2Seq encoder-decoder (counterpart of
analytics_zoo_tpu/models/seq2seq/seq2seq.py:23-90; reference scala
`models/seq2seq/{Seq2seq,RNNEncoder,RNNDecoder,Bridge}.scala`): stacked
RNN encoder, a bridge mapping the encoder's final states into the
decoder's initial ones, stacked RNN decoder, optional dense generator
head.  All f32.

Each layer is one `recurrent.lstm` / `recurrent.gru` (flax's
`OptimizedLSTMCell` / `GRUCell` under `nn.RNN`).  The dense bridge maps
each layer's carry leaf by leaf in flax's `tree_flatten` order: an LSTM
carry is flax's (c, h), so `bridge_dense.i.0` maps c and
`bridge_dense.i.1` maps h (torch's LSTM state is (h, c)); a GRU carry
is one leaf.  `forward(encoder_seq, decoder_seq)` is teacher-forced;
`infer` decodes greedily, each decoder cell stepped once a step and the
generator's output fed back in (a Python loop).  torch needs the input
widths flax infers: `input_dim` (the encoder's), `decoder_input_dim`
(the decoder's; None: `input_dim`).  Weights come from a flax tree
through `convert.seq2seq_from_flax`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.common import recurrent
from analytics_zoo_tpu_torch.models.common.zoo_model import ZooModel
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    Dense,
)


class Seq2Seq(ZooModel, nn.Module):
    """(encoder_seq [b, t_enc, input_dim], decoder_seq [b, t_dec,
    decoder_input_dim]) -> [b, t_dec, output_dim or hidden_size] f32."""

    default_loss = "mse"
    default_metrics = ("mse",)

    def __init__(self, hidden_size: int = 64, num_layers: int = 1,
                 output_dim: Optional[int] = None, bridge: str = "dense",
                 cell_type: str = "lstm", input_dim: int = 1,
                 decoder_input_dim: Optional[int] = None, device=None):
        nn.Module.__init__(self)
        self._config = dict(hidden_size=hidden_size, num_layers=num_layers,
                            output_dim=output_dim, bridge=bridge,
                            cell_type=cell_type, input_dim=input_dim,
                            decoder_input_dim=decoder_input_dim)
        self.device_ = dev = resolve_device(device)
        if bridge not in ("dense", "passthrough"):
            raise ValueError(f"unknown bridge '{bridge}'")
        self.bridge, self.cell_type = bridge, cell_type
        dec_in = input_dim if decoder_input_dim is None else decoder_input_dim

        def stack(fan_in):
            return nn.ModuleList(
                recurrent.make(cell_type, fan_in if i == 0 else hidden_size,
                               hidden_size, dev)
                for i in range(num_layers))
        self.enc_cells = stack(input_dim)
        self.dec_cells = stack(dec_in)
        if bridge == "dense":
            n_leaves = 2 if cell_type == "lstm" else 1
            self.bridge_dense = nn.ModuleList(
                nn.ModuleList(Dense(hidden_size, hidden_size, device=dev)
                              for _ in range(n_leaves))
                for _ in range(num_layers))
        self.generator = (Dense(hidden_size, output_dim, device=dev)
                          if output_dim is not None else None)

    def flax_layout(self):
        """(to_flax(state_dict), from_flax(tree)): the JAX module's
        param tree (`convert.seq2seq_to_flax` and `seq2seq_from_flax`)."""
        from analytics_zoo_tpu_torch import convert
        return convert.seq2seq_to_flax, convert.seq2seq_from_flax

    def _encode(self, enc_seq):
        x = enc_seq.float()
        states = []
        for cell in self.enc_cells:
            x, state = cell(x)
            states.append(state)
        if self.bridge == "dense":
            if self.cell_type == "lstm":
                # flax's carry (c, h): leaf 0 is c, leaf 1 is h
                states = [(to_h(h), to_c(c)) for (to_c, to_h), (h, c)
                          in zip(self.bridge_dense, states)]
            else:
                states = [d[0](h) for d, h in zip(self.bridge_dense, states)]
        return states

    def forward(self, enc_seq, dec_seq):
        states = self._encode(enc_seq)
        y = dec_seq.float()
        for cell, state in zip(self.dec_cells, states):
            y = cell(y, state)[0]
        return self.generator(y) if self.generator is not None else y

    @torch.no_grad()
    def infer(self, enc_seq, dec_start, n_steps: int):
        """Greedy closed-loop decoding: each predicted step feeds back as
        the next decoder input (output_dim must equal the decoder's input
        width).  `dec_start`: the first decoder input [b, features].
        -> [b, n_steps, output_dim or hidden_size]."""
        states = self._encode(enc_seq)
        step_in = dec_start.float()
        outs = []
        for _ in range(n_steps):
            h = step_in[:, None]
            for i, cell in enumerate(self.dec_cells):
                h, states[i] = cell(h, states[i])
            y = h[:, 0]
            y = self.generator(y) if self.generator is not None else y
            outs.append(y)
            step_in = y
        return torch.stack(outs, dim=1)
