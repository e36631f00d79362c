"""Metrics (counterpart of analytics_zoo_tpu/orca/learn/metrics.py).

Each metric is a per-example function `fn(preds, labels) -> values
[batch, ...]`; the engine masked-means them over the real rows.  Ported
so far: `Accuracy` ("accuracy", "acc"); any other name of the JAX
registry raises, naming it.
"""

from __future__ import annotations

import re


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


_REGISTRY = {"accuracy": Accuracy, "acc": Accuracy}
_NOT_PORTED = ("sparse_categorical_accuracy", "categorical_accuracy",
               "binary_accuracy", "top5accuracy", "top5_accuracy", "mae",
               "mse")


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
        if key in _NOT_PORTED or re.fullmatch(r"top\d+_?accuracy", key):
            raise NotImplementedError(
                f"metric {metric!r} is not ported yet; ported: "
                f"{sorted(_REGISTRY)}, or pass a callable")
        if key not in _REGISTRY:
            raise ValueError(f"unknown metric {metric!r}; known: "
                             f"{sorted(_REGISTRY)}")
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
