"""autograd vocabulary and CustomLoss (counterpart of
analytics_zoo_tpu/keras/autograd.py).

A "variable expression" is a Python function over torch tensors, which
torch's autograd differentiates; the helpers below are the reference's
function vocabulary so loss expressions port one to one.
`CustomLoss(fn)` wraps `fn(y_true, y_pred)` (the reference's argument
order) into the engine's per-example loss contract.
"""

from __future__ import annotations

from typing import Callable

import torch


def _t(x, like=None):
    """x as a tensor (a Python number on `like`'s device and dtype)."""
    if torch.is_tensor(x):
        return x
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(x)


abs = torch.abs              # noqa: A001 - reference naming
exp = torch.exp
log = torch.log
sqrt = torch.sqrt
square = torch.square


def clip(x, a_min, a_max):
    return torch.clamp(x, a_min, a_max)


def maximum(a, b):
    like = a if torch.is_tensor(a) else b
    return torch.maximum(_t(a, like), _t(b, like))


def minimum(a, b):
    like = a if torch.is_tensor(a) else b
    return torch.minimum(_t(a, like), _t(b, like))


def pow(x, y):               # noqa: A001
    return torch.pow(x, y)


def mean(x, axis=0):
    return torch.mean(x, dim=axis)


def sum(x, axis=0):          # noqa: A001
    return torch.sum(x, dim=axis)


def epsilon() -> float:
    return 1e-7


def mm(a, b):
    return torch.matmul(a, b)


def dot(a, b, axes=None):
    return torch.tensordot(a, b, dims=1 if axes is None else axes)


def softsign(x):
    return x / (1 + torch.abs(x))


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def stack(xs, axis=1):
    return torch.stack(list(xs), dim=axis)


def expand_dims(x, axis):
    return torch.unsqueeze(x, axis)


def l2_normalize(x, axis=-1):
    return x / torch.sqrt(torch.clamp_min(
        (x * x).sum(dim=axis, keepdim=True), epsilon()))


class CustomLoss:
    """Wrap `fn(y_true, y_pred) -> per-example loss [batch, ...]` as an
    engine loss.  Trailing dims beyond the batch are averaged by the
    engine's masked mean; a scalar is rejected, since padded rows could
    then not be masked out."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, preds, labels):
        y_pred = preds[0] if isinstance(preds, (tuple, list)) else preds
        y_true = labels[0] if isinstance(labels, (tuple, list)) else labels
        out = self.fn(y_true, y_pred)
        if out.dim() == 0:
            raise ValueError(
                "CustomLoss expression must return a PER-EXAMPLE loss "
                "(leading batch dim); got a scalar — drop the outer "
                "mean(), the engine applies the masked batch mean")
        return out
