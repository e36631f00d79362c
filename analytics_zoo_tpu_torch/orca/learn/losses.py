"""Per-example loss functions (counterpart of
analytics_zoo_tpu/orca/learn/losses.py).

A loss maps (preds, labels) to per-example values with a leading batch
dim; the engine masked-means them over the real rows.  Ported so far:
`sparse_categorical_crossentropy`, the BERT fine-tune's loss; any other
name of the JAX registry raises, naming it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _first(t):
    return t[0] if isinstance(t, (tuple, list)) else t


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


_REGISTRY = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
}
#: the JAX registry's other names, not ported yet
_NOT_PORTED = ("categorical_crossentropy", "binary_crossentropy", "mse",
               "mean_squared_error", "mae", "mean_absolute_error", "huber",
               "hinge", "squared_hinge", "rank_hinge", "cosine_proximity",
               "mape", "mean_absolute_percentage_error", "msle",
               "mean_squared_logarithmic_error", "logcosh", "log_cosh",
               "kld", "kullback_leibler_divergence", "poisson")


def resolve(loss):
    """A registry name, a callable, or None."""
    if loss is None:
        return None
    if isinstance(loss, str):
        key = loss.lower()
        if key in _NOT_PORTED:
            raise NotImplementedError(
                f"loss {loss!r} is not ported yet; ported: "
                f"{sorted(_REGISTRY)}, or pass a callable")
        if key not in _REGISTRY:
            raise ValueError(f"unknown loss {loss!r}; known: "
                             f"{sorted(_REGISTRY)}")
        return _REGISTRY[key]
    if callable(loss):
        return loss
    raise TypeError(f"cannot resolve loss from {loss!r}")
