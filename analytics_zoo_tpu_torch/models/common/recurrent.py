"""Flax's recurrent cells in torch: the `nn.GRUCell` and
`nn.OptimizedLSTMCell` that the JAX models run under `nn.RNN`, shared by
SessionRecommender, TextClassifier, AnomalyDetector and Seq2Seq.

Each cell is a one-layer `nn.GRU` / `nn.LSTM(batch_first=True)` run over
every position of its input, padding included: flax's `nn.RNN` is given
no `seq_lengths`, so no sequence is ever packed.

* GRU: `n = tanh(W_in x + b_in + r * (W_hn h + b_hn))`, `h' = (1 - z) n +
  z h`, in both.  Flax's r and z gates have one bias, on the input side:
  torch's hidden-side biases of r and z (`bias_hh_l0[:2w]`) are zero, and
  a gradient hook keeps them there.
* LSTM (`OptimizedLSTMCell`): flax's input kernels ii/if/ig/io have no
  bias, its hidden kernels hi/hf/hg/ho have one; the gate order (i, f,
  g, o) is torch's too.  Flax's biases are torch's `bias_hh_l0`;
  `bias_ih_l0` is zero, held there by a gradient hook, so the optimizer
  moves one bias per gate as in flax (Adam would otherwise see two).
  Flax's carry is (c, h); torch's state is (h, c).
* Simple (`SimpleCell`): `h' = act(W_i x + b_i + W_h h)`, a one-layer
  `nn.RNN` of tanh or relu; flax's bias is the input side's, torch's
  `bias_hh_l0` is held at zero.

`lstm_cell` is the LSTM stepped by hand, one `nn.LSTMCell` call a step
(a decoder's closed loop).  All draw their weights as flax does:
lecun-normal input kernels, orthogonal recurrent kernels per gate, zero
biases.  `cell_from_flax` /
`cell_to_flax` convert one cell between its flax tree and the RNN's
weights.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

#: flax's gate names, in torch's order of the stacked weights
_GRU_GATES = "rzn"
_LSTM_GATES = "ifgo"


def _draw(rnn: nn.Module, fan_in: int, width: int, gates: int,
          suffix: str = "_l0") -> None:
    """flax's initializers on an RNN's weights (`suffix` "_l0") or an
    RNN cell's ("")."""
    std = fan_in ** -0.5
    w_hh = getattr(rnn, "weight_hh" + suffix)
    with torch.no_grad():
        nn.init.trunc_normal_(getattr(rnn, "weight_ih" + suffix), std=std,
                              a=-2 * std, b=2 * std)
        for g in range(gates):
            nn.init.orthogonal_(w_hh[g * width:(g + 1) * width])
        getattr(rnn, "bias_ih" + suffix).zero_()
        getattr(rnn, "bias_hh" + suffix).zero_()


def _hold_at_zero(bias: nn.Parameter, rows: slice) -> None:
    keep = torch.ones_like(bias)
    keep[rows] = 0.0
    bias.register_hook(lambda g: g * keep)


def gru(fan_in: int, width: int, device) -> nn.GRU:
    """flax's `GRUCell(width)` as a one-layer GRU, its r and z
    hidden-side biases held at zero."""
    cell = nn.GRU(fan_in, width, batch_first=True, device=device)
    _draw(cell, fan_in, width, 3)
    _hold_at_zero(cell.bias_hh_l0, slice(0, 2 * width))
    return cell


def lstm(fan_in: int, width: int, device) -> nn.LSTM:
    """flax's `OptimizedLSTMCell(width)` as a one-layer LSTM, its
    input-side biases held at zero."""
    cell = nn.LSTM(fan_in, width, batch_first=True, device=device)
    _draw(cell, fan_in, width, 4)
    _hold_at_zero(cell.bias_ih_l0, slice(None))
    return cell


def lstm_cell(fan_in: int, width: int, device) -> nn.LSTMCell:
    """flax's `OptimizedLSTMCell(width)` stepped once a call, as an
    `nn.LSTMCell` (weights `weight_ih`, `weight_hh`, `bias_ih`,
    `bias_hh`: `cell_from_flax`'s without "_l0"), its input-side bias
    held at zero."""
    cell = nn.LSTMCell(fan_in, width, device=device)
    _draw(cell, fan_in, width, 4, suffix="")
    _hold_at_zero(cell.bias_ih, slice(None))
    return cell


def simple(fan_in: int, width: int, device,
           nonlinearity: str = "tanh") -> nn.RNN:
    """flax's `SimpleCell(width)` (activation tanh, its default, or
    relu) as a one-layer RNN, its hidden-side bias held at zero."""
    cell = nn.RNN(fan_in, width, nonlinearity=nonlinearity,
                  batch_first=True, device=device)
    _draw(cell, fan_in, width, 1)
    _hold_at_zero(cell.bias_hh_l0, slice(None))
    return cell


def make(kind: str, fan_in: int, width: int, device) -> nn.RNNBase:
    """`lstm`, `gru` or `simple` (tanh) by name."""
    if kind == "lstm":
        return lstm(fan_in, width, device)
    if kind == "gru":
        return gru(fan_in, width, device)
    if kind == "simple":
        return simple(fan_in, width, device)
    raise ValueError(f"unknown cell type '{kind}'")


def is_cell(tree: Mapping) -> bool:
    """Whether a flax subtree is a GRUCell's or an OptimizedLSTMCell's."""
    return "ir" in tree or "ii" in tree


def cell_from_flax(tree: Mapping, name: str = "cell"
                   ) -> Dict[str, np.ndarray]:
    """A flax GRUCell's or OptimizedLSTMCell's tree (told apart by its
    entries) as its RNN's `weight_ih_l0`, `weight_hh_l0`, `bias_ih_l0`
    and `bias_hh_l0`; `name` (the cell's flax name) for the error of
    an entry missing or unknown."""
    if set(tree) == {"i", "h"}:
        if {k: set(v) for k, v in tree.items()} != {"i": {"kernel", "bias"},
                                                     "h": {"kernel"}}:
            raise ValueError(f"{name}: entries are not a flax SimpleCell")
        bias = np.asarray(tree["i"]["bias"])
        return {"weight_ih_l0": np.asarray(tree["i"]["kernel"]).T,
                "weight_hh_l0": np.asarray(tree["h"]["kernel"]).T,
                "bias_ih_l0": bias, "bias_hh_l0": np.zeros_like(bias)}
    is_lstm = "ii" in tree
    gates = _LSTM_GATES if is_lstm else _GRU_GATES
    # flax's entries: (gate Dense, has a bias)
    want = {f"i{g}": not is_lstm for g in gates}
    want.update({f"h{g}": is_lstm or g == "n" for g in gates})
    got = {k: set(v) for k, v in tree.items()}
    if got != {k: {"kernel", "bias"} if b else {"kernel"}
               for k, b in want.items()}:
        raise ValueError(f"{name}: entries {got} are not a flax "
                         f"{'OptimizedLSTMCell' if is_lstm else 'GRUCell'}")

    def stack(side, leaf):
        return np.concatenate([np.asarray(tree[f"{side}{g}"][leaf]).T
                               if leaf == "kernel"
                               else np.asarray(tree[f"{side}{g}"][leaf])
                               for g in gates])

    w_hh = stack("h", "kernel")
    width = w_hh.shape[1]
    zeros = np.zeros(width, np.float32)
    if is_lstm:
        b_ih, b_hh = np.zeros(4 * width, np.float32), stack("h", "bias")
    else:
        b_ih = stack("i", "bias")
        b_hh = np.concatenate([zeros, zeros, np.asarray(tree["hn"]["bias"])])
    return {"weight_ih_l0": stack("i", "kernel"), "weight_hh_l0": w_hh,
            "bias_ih_l0": b_ih, "bias_hh_l0": b_hh}


def cell_to_flax(weights: Mapping[str, np.ndarray]) -> Dict[str, Dict]:
    """The inverse of `cell_from_flax` (an LSTM's `weight_hh_l0` has 4
    gates of rows, a GRU's 3, a SimpleCell's 1): of the biases held at
    zero, none."""
    w_ih, w_hh = np.asarray(weights["weight_ih_l0"]), \
        np.asarray(weights["weight_hh_l0"])
    width = w_hh.shape[1]
    if w_hh.shape[0] == width:              # a SimpleCell
        return {"i": {"kernel": np.ascontiguousarray(w_ih.T),
                      "bias": np.asarray(weights["bias_ih_l0"])},
                "h": {"kernel": np.ascontiguousarray(w_hh.T)}}
    is_lstm = w_hh.shape[0] == 4 * width
    gates = _LSTM_GATES if is_lstm else _GRU_GATES
    parts = {side: np.split(w, len(gates)) for side, w in
             (("i", w_ih), ("h", w_hh))}
    b_ih = np.split(np.asarray(weights["bias_ih_l0"]), len(gates))
    b_hh = np.split(np.asarray(weights["bias_hh_l0"]), len(gates))
    tree = {}
    for j, g in enumerate(gates):
        for side in "ih":
            tree[f"{side}{g}"] = {
                "kernel": np.ascontiguousarray(parts[side][j].T)}
        if is_lstm:
            tree[f"h{g}"]["bias"] = b_hh[j]
        else:
            tree[f"i{g}"]["bias"] = b_ih[j]
    if not is_lstm:
        tree["hn"]["bias"] = b_hh[2]
    return tree
