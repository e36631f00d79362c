"""Per-example loss functions (counterpart of
analytics_zoo_tpu/orca/learn/losses.py).

A loss maps (preds, labels) to per-example values with a leading batch
dim; the engine masked-means them over the real rows.  Each computes
its JAX counterpart's function, clamps and epsilons included (optax's
where JAX calls optax); a loss that declares `mask` (`rank_hinge`) is
given the batch's padding mask by the engine.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _first(t):
    return t[0] if isinstance(t, (tuple, list)) else t


def _flat_pair(preds, labels):
    """preds and labels as [batch, -1], the labels in the preds' dtype."""
    p, y = _first(preds), _first(labels)
    p = p.reshape(p.shape[0], -1)
    return p, y.reshape(y.shape[0], -1).to(p.dtype)


def sparse_categorical_crossentropy(preds, labels, from_logits=True):
    """Integer labels against logits (or probabilities with
    from_logits=False) over the last axis; trailing dims averaged per
    example (`optax.softmax_cross_entropy_with_integer_labels`)."""
    p, y = _first(preds), _first(labels).long()
    y = y.reshape(y.shape[0], *p.shape[1:-1])
    if from_logits:
        per = F.cross_entropy(p.reshape(-1, p.shape[-1]), y.reshape(-1),
                              reduction="none").reshape(y.shape)
    else:
        p = torch.clamp(p, 1e-7, 1.0)
        per = -torch.log(p).gather(-1, y[..., None])[..., 0]
    return per.reshape(per.shape[0], -1).mean(dim=-1)


def categorical_crossentropy(preds, labels, from_logits=True):
    """One-hot (or soft) labels against logits
    (`optax.softmax_cross_entropy`) or probabilities."""
    p, y = _first(preds), _first(labels)
    if from_logits:
        per = -(y * F.log_softmax(p, dim=-1)).sum(dim=-1)
    else:
        p = torch.clamp(p, 1e-7, 1.0)
        per = -(y * torch.log(p)).sum(dim=-1)
    return per.reshape(per.shape[0], -1).mean(dim=-1)


def binary_crossentropy(preds, labels, from_logits=True):
    """`optax.sigmoid_binary_cross_entropy` on logits, or the clamped
    log loss on probabilities."""
    p, y = _flat_pair(preds, labels)
    if from_logits:
        per = -y * F.logsigmoid(p) - (1.0 - y) * F.logsigmoid(-p)
    else:
        p = torch.clamp(p, 1e-7, 1 - 1e-7)
        per = -(y * torch.log(p) + (1 - y) * torch.log1p(-p))
    return per.mean(dim=-1)


def mean_squared_error(preds, labels):
    p, y = _first(preds), _first(labels)
    d = p.reshape(p.shape[0], -1) - y.reshape(y.shape[0], -1)
    return (d * d).mean(dim=-1)


def mean_absolute_error(preds, labels):
    p, y = _first(preds), _first(labels)
    return torch.abs(p.reshape(p.shape[0], -1)
                     - y.reshape(y.shape[0], -1)).mean(dim=-1)


def huber(preds, labels, delta: float = 1.0):
    """`optax.huber_loss`: quadratic within `delta`, linear past it."""
    p, y = _first(preds), _first(labels)
    abs_errors = torch.abs(p.reshape(p.shape[0], -1)
                           - y.reshape(y.shape[0], -1))
    quadratic = torch.clamp_max(abs_errors, delta)
    linear = abs_errors - quadratic
    return (0.5 * quadratic ** 2 + delta * linear).mean(dim=-1)


def _signed(y):
    """{0, 1} labels remapped to {-1, 1} when no label of the batch is
    negative; labels with negatives used as they are (no host read)."""
    return torch.where(y.min() >= 0, 2.0 * y - 1.0, y)


def hinge(preds, labels):
    p, y = _flat_pair(preds, labels)
    return torch.clamp_min(1.0 - _signed(y) * p, 0.0).mean(dim=-1)


def kld(preds, labels):
    p, y = _first(preds), _first(labels)
    y = torch.clamp(y, 1e-7, 1.0)
    p = torch.clamp(p, 1e-7, 1.0)
    per = (y * (torch.log(y) - torch.log(p))).sum(dim=-1)
    return per.reshape(per.shape[0], -1).mean(dim=-1)


def poisson(preds, labels):
    p, y = _first(preds), _first(labels)
    p = p.reshape(p.shape[0], -1)
    y = y.reshape(y.shape[0], -1)
    return (p - y * torch.log(p + 1e-7)).mean(dim=-1)


def squared_hinge(preds, labels):
    """hinge squared, with hinge's label handling."""
    p, y = _flat_pair(preds, labels)
    return (torch.clamp_min(1.0 - _signed(y) * p, 0.0) ** 2).mean(dim=-1)


def cosine_proximity(preds, labels):
    """Negative cosine similarity, each norm floored at 1e-8."""
    p, y = _flat_pair(preds, labels)
    pn = p / torch.clamp_min(
        torch.linalg.vector_norm(p, dim=-1, keepdim=True), 1e-8)
    yn = y / torch.clamp_min(
        torch.linalg.vector_norm(y, dim=-1, keepdim=True), 1e-8)
    return -(pn * yn).sum(dim=-1)


def mean_absolute_percentage_error(preds, labels):
    p, y = _flat_pair(preds, labels)
    return (100.0 * torch.abs(p - y)
            / torch.clamp_min(torch.abs(y), 1e-7)).mean(dim=-1)


def mean_squared_logarithmic_error(preds, labels):
    p, y = _flat_pair(preds, labels)
    return ((torch.log1p(torch.clamp_min(p, 0.0))
             - torch.log1p(torch.clamp_min(y, 0.0))) ** 2).mean(dim=-1)


def log_cosh(preds, labels):
    """log(cosh(d)) as d + softplus(-2d) - log 2, finite at any d
    (softplus as JAX's, log(exp(x) + 1))."""
    p, y = _flat_pair(preds, labels)
    d = p - y
    x = -2.0 * d
    return (d + torch.logaddexp(x, torch.zeros_like(x))
            - math.log(2.0)).mean(dim=-1)


def rank_hinge(preds, labels, margin: float = 1.0, mask=None):
    """Pairwise ranking hinge over consecutive (positive, negative) row
    pairs: one loss per pair, repeated on both rows so the engine's
    per-example weighting holds.  With `mask` (the engine passes the
    padding mask), a pair with a padded member contributes zero."""
    p = _first(preds)
    if p.shape[0] % 2:
        raise ValueError(
            f"rank_hinge needs an even batch of (pos, neg) row pairs, "
            f"got {p.shape[0]} rows; use an even batch_size and "
            "pairwise-ordered data")
    p = p.reshape(p.shape[0], -1)[:, 0]
    pair = torch.clamp_min(margin - p[0::2] + p[1::2], 0.0)
    if mask is not None:
        m = mask.reshape(mask.shape[0], -1)[:, 0] if mask.dim() > 1 else mask
        pair = pair * m[0::2] * m[1::2]
    return torch.repeat_interleave(pair, 2)


_REGISTRY = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "huber": huber,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "rank_hinge": rank_hinge,
    "cosine_proximity": cosine_proximity,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "logcosh": log_cosh,
    "log_cosh": log_cosh,
    "kld": kld,
    "kullback_leibler_divergence": kld,
    "poisson": poisson,
}


def resolve(loss):
    """A registry name, a callable, or None."""
    if loss is None:
        return None
    if isinstance(loss, str):
        key = loss.lower()
        if key not in _REGISTRY:
            raise ValueError(f"unknown loss {loss!r}; known: "
                             f"{sorted(_REGISTRY)}")
        return _REGISTRY[key]
    if callable(loss):
        return loss
    raise TypeError(f"cannot resolve loss from {loss!r}")
