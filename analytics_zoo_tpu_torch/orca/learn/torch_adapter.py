"""Torch criteria as the Estimator's losses (counterpart of
`resolve_torch_loss` in analytics_zoo_tpu/orca/learn/torch_adapter.py:650-725).

The JAX module also converts a torch module to flax through FX; the
port trains torch modules as they are, so only the criterion mapping
has a counterpart here.  A torch criterion computes a reduced loss over
whatever rows it is given, padding rows included, while the engine
masked-means per-example values over the real rows: so each mapped
criterion becomes the registry loss (or a per-example function) that
computes the same value per example, and a configuration the mapping
would drop (`weight`, `ignore_index`, `label_smoothing`, a reduction
other than mean) is refused with JAX's message.
"""

from __future__ import annotations

from functools import partial

import torch

from analytics_zoo_tpu_torch.orca.learn import losses as losses_mod

#: torch criterion classes -> registry loss names
_TORCH_LOSS_MAP = {
    "CrossEntropyLoss": "sparse_categorical_crossentropy",
    "MSELoss": "mse",
    "L1Loss": "mae",
    "BCEWithLogitsLoss": "binary_crossentropy",
    "SmoothL1Loss": "huber",
    "HuberLoss": "huber",
}


def _first(t):
    return t[0] if isinstance(t, (tuple, list)) else t


def _smooth_l1(preds, labels, beta: float = 1.0):
    p = _first(preds)
    y = _first(labels)
    p = p.reshape(p.shape[0], -1)
    y = y.reshape(y.shape[0], -1)
    d = torch.abs(p - y)
    per = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return per.mean(dim=-1)


def _nll(preds, labels):
    # the model outputs log-probabilities already
    p, y = _first(preds), _first(labels)
    if p.dim() > 2:
        # torch NLLLoss: classes at dim 1 for [N, C, d1, ...]
        p = torch.movedim(p, 1, -1)
    y = y.long().reshape(y.shape[0], *p.shape[1:-1])
    per = -torch.gather(p, -1, y[..., None])[..., 0]
    return per.reshape(per.shape[0], -1).mean(dim=-1)


def _bce(preds, labels):
    return losses_mod.binary_crossentropy(preds, labels, from_logits=False)


def resolve_torch_loss(loss):
    """Map a torch criterion instance to a registry loss name or a
    per-example loss; pass anything else (None, a name, a plain
    callable) through for `losses.resolve`."""
    if loss is None or isinstance(loss, str) or (
            callable(loss) and not isinstance(loss, torch.nn.Module)):
        return loss
    cls = type(loss).__name__
    if cls in _TORCH_LOSS_MAP:
        # reject configurations the name-level mapping would silently drop
        if getattr(loss, "weight", None) is not None:
            raise ValueError(
                f"from_torch: {cls}(weight=...) is not supported by the "
                "name-level loss mapping; pass a callable loss instead")
        if getattr(loss, "ignore_index", -100) != -100:
            raise ValueError(
                f"from_torch: {cls}(ignore_index=...) is not supported; "
                "pass a callable loss instead")
        if getattr(loss, "label_smoothing", 0.0):
            raise ValueError(
                f"from_torch: {cls}(label_smoothing=...) is not supported; "
                "pass a callable loss instead")
        if getattr(loss, "reduction", "mean") != "mean":
            raise ValueError(
                f"from_torch: {cls}(reduction=...) other than 'mean' is not "
                "supported — the engine always computes a masked global "
                "mean; pass a callable loss instead")
        if cls == "HuberLoss" and getattr(loss, "delta", 1.0) != 1.0:
            return partial(losses_mod.huber, delta=loss.delta)
        if cls == "SmoothL1Loss":
            return partial(_smooth_l1, beta=getattr(loss, "beta", 1.0))
        return _TORCH_LOSS_MAP[cls]
    if cls == "NLLLoss":
        return _nll
    if cls == "BCELoss":
        return _bce
    raise ValueError(
        f"from_torch: no mapping for torch loss {cls}; pass a framework "
        "loss name or a callable(preds, labels) -> per-example loss")
