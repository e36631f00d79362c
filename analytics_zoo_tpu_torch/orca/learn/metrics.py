"""Metrics (counterpart of analytics_zoo_tpu/orca/learn/metrics.py).

Each metric is a per-example function `fn(preds, labels) -> values
[batch, ...]`; the engine masked-means them over the real rows.  The
registry holds the JAX one's names; "top<k>accuracy" and
"top<k>_accuracy" resolve to `TopKCategoricalAccuracy(k)`.
"""

from __future__ import annotations

import re

import torch


def _first(t):
    return t[0] if isinstance(t, (tuple, list)) else t


class Metric:
    name = "metric"

    def __call__(self, preds, labels):
        raise NotImplementedError

    def get_name(self):
        return self.name


class Accuracy(Metric):
    """Classification accuracy: binary (one output, decision boundary at
    logit 0, or 0.5 with from_logits=False) or the argmax against
    integer or one-hot labels."""
    name = "accuracy"

    def __init__(self, from_logits: bool = True):
        self.from_logits = from_logits

    def __call__(self, preds, labels):
        p, y = _first(preds), _first(labels)
        if p.dim() == 1 or p.shape[-1] == 1:
            threshold = 0.0 if self.from_logits else 0.5
            yhat = (p.reshape(p.shape[0], -1)[:, 0] > threshold).long()
            return (yhat == y.reshape(y.shape[0], -1)[:, 0].long()).float()
        yhat = p.argmax(dim=-1)
        if y.dim() == p.dim():        # one-hot labels
            y = y.argmax(dim=-1)
        return (yhat == y.long()).float()


class SparseCategoricalAccuracy(Accuracy):
    name = "sparse_categorical_accuracy"


class CategoricalAccuracy(Accuracy):
    name = "categorical_accuracy"


class BinaryAccuracy(Metric):
    """`threshold` applies to probabilities; with `from_logits` (the
    default) the predictions pass a sigmoid first.  A row counts when
    every output of it is right."""
    name = "binary_accuracy"

    def __init__(self, threshold: float = 0.5, from_logits: bool = True):
        self.threshold = threshold
        self.from_logits = from_logits

    def __call__(self, preds, labels):
        p, y = _first(preds), _first(labels)
        p = p.reshape(p.shape[0], -1)
        if self.from_logits:
            p = torch.sigmoid(p)
        yhat = p > self.threshold
        y = y.reshape(y.shape[0], -1) > 0.5
        return (yhat == y).all(dim=-1).float()


class TopKCategoricalAccuracy(Metric):
    """A hit where the true class is among the `k` highest predictions
    (the last `k` of a stable ascending argsort, JAX's choice under
    ties)."""

    def __init__(self, k: int = 5):
        self.k = int(k)
        if self.k < 1:
            # k = 0 would take the whole class axis and report 1.0
            raise ValueError(f"top-k accuracy needs k >= 1, got {k}")
        self.name = f"top{self.k}_accuracy"

    def __call__(self, preds, labels):
        p, y = _first(preds), _first(labels)
        if y.dim() == p.dim():
            y = y.argmax(dim=-1)
        topk = torch.argsort(p, dim=-1, stable=True)[..., -self.k:]
        return (topk == y[..., None].long()).any(dim=-1).float()


class Top5Accuracy(TopKCategoricalAccuracy):
    def __init__(self):
        super().__init__(k=5)


class MAE(Metric):
    name = "mae"

    def __call__(self, preds, labels):
        p, y = _first(preds), _first(labels)
        return torch.abs(p.reshape(p.shape[0], -1)
                         - y.reshape(y.shape[0], -1)).mean(dim=-1)


class MSE(Metric):
    name = "mse"

    def __call__(self, preds, labels):
        p, y = _first(preds), _first(labels)
        d = p.reshape(p.shape[0], -1) - y.reshape(y.shape[0], -1)
        return (d * d).mean(dim=-1)


_REGISTRY = {
    "accuracy": Accuracy,
    "acc": Accuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "categorical_accuracy": CategoricalAccuracy,
    "binary_accuracy": BinaryAccuracy,
    "top5accuracy": Top5Accuracy,
    "top5_accuracy": Top5Accuracy,
    "mae": MAE,
    "mse": MSE,
}


def _topk_from_name(key: str):
    """`TopKCategoricalAccuracy(k)` for a "top<k>_accuracy" name."""
    m = re.fullmatch(r"top(\d+)_?accuracy", key)
    return TopKCategoricalAccuracy(int(m.group(1))) if m else None


class _FnMetric(Metric):
    def __init__(self, fn, name):
        self.fn = fn
        self.name = name

    def __call__(self, preds, labels):
        return self.fn(preds, labels)


def resolve(metric) -> Metric:
    """A Metric instance or class, a registry name, or a callable."""
    if isinstance(metric, Metric):
        return metric
    if isinstance(metric, type) and issubclass(metric, Metric):
        return metric()
    if isinstance(metric, str):
        key = metric.lower()
        if key not in _REGISTRY:
            topk = _topk_from_name(key)
            if topk is not None:
                return topk
            raise ValueError(f"unknown metric {metric!r}; known: "
                             f"{sorted(_REGISTRY)} or 'top<k>_accuracy'")
        return _REGISTRY[key]()
    if callable(metric):
        return _FnMetric(metric, getattr(metric, "__name__", "metric"))
    raise TypeError(f"cannot resolve metric from {metric!r}")


def resolve_all(metrics_arg) -> dict:
    """{name: Metric} from one metric, a list of them, or None."""
    if metrics_arg is None:
        return {}
    if not isinstance(metrics_arg, (list, tuple)):
        metrics_arg = [metrics_arg]
    out = {}
    for m in metrics_arg:
        r = resolve(m)
        out[r.get_name()] = r
    return out
