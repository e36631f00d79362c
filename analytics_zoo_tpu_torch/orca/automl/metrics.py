"""Host-side evaluation-metric registry (counterpart of
analytics_zoo_tpu/orca/automl/metrics.py: the numpy metric vocabulary
shared by AutoML, Chronos evaluate and TSPipeline).

These run on full prediction arrays on the host (ratio metrics like
precision/AUC are not per-example decomposable, so they don't belong in
the on-device masked-mean metric path of `orca/learn/metrics.py`).
Implemented with numpy only; `multioutput` follows the reference:
"raw_values" returns one value per output column, "uniform_average"
averages them."""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np


def _standardize(y_true, y_pred):
    yt = np.asarray(y_true, np.float64)
    yp = np.asarray(y_pred, np.float64)
    if yt.shape != yp.shape:
        raise ValueError(
            f"y_true {yt.shape} and y_pred {yp.shape} shapes differ")
    if yt.ndim == 1:
        yt, yp = yt[:, None], yp[:, None]
    return yt.reshape(len(yt), -1), yp.reshape(len(yp), -1)


def _reduce(vals: np.ndarray, multioutput: str):
    if multioutput == "uniform_average":
        return float(vals.mean())
    if multioutput == "raw_values":
        return vals
    raise ValueError(
        "multioutput must be 'raw_values' or 'uniform_average'")


def _regression(fn):
    # extra kwargs (e.g. from_logits, meaningful only for the
    # classification metrics) are accepted and ignored so callers can
    # loop one kwargs dict over a mixed metric list
    def wrapped(y_true, y_pred, multioutput="raw_values", **_ignored):
        yt, yp = _standardize(y_true, y_pred)
        return _reduce(fn(yt, yp), multioutput)
    wrapped.__name__ = fn.__name__
    return wrapped


@_regression
def ME(yt, yp):
    return (yp - yt).mean(axis=0)


@_regression
def MAE(yt, yp):
    return np.abs(yp - yt).mean(axis=0)


@_regression
def MSE(yt, yp):
    return ((yp - yt) ** 2).mean(axis=0)


@_regression
def RMSE(yt, yp):
    return np.sqrt(((yp - yt) ** 2).mean(axis=0))


@_regression
def MSLE(yt, yp):
    return ((np.log1p(np.clip(yp, 0, None))
             - np.log1p(np.clip(yt, 0, None))) ** 2).mean(axis=0)


@_regression
def R2(yt, yp):
    ss_res = ((yt - yp) ** 2).sum(axis=0)
    ss_tot = ((yt - yt.mean(axis=0)) ** 2).sum(axis=0)
    return 1.0 - ss_res / np.where(ss_tot > 0, ss_tot, 1.0)


@_regression
def MAPE(yt, yp):
    return 100.0 * (np.abs(yp - yt)
                    / np.maximum(np.abs(yt), 1e-8)).mean(axis=0)


@_regression
def MPE(yt, yp):
    return 100.0 * ((yp - yt)
                    / np.where(np.abs(yt) > 1e-8, yt, 1e-8)).mean(axis=0)


@_regression
def sMAPE(yt, yp):
    return 100.0 * (np.abs(yp - yt)
                    / np.maximum((np.abs(yt) + np.abs(yp)) / 2, 1e-8)
                    ).mean(axis=0)


@_regression
def MDAPE(yt, yp):
    return 100.0 * np.median(
        np.abs(yp - yt) / np.maximum(np.abs(yt), 1e-8), axis=0)


@_regression
def sMDAPE(yt, yp):
    return 100.0 * np.median(
        np.abs(yp - yt) / np.maximum((np.abs(yt) + np.abs(yp)) / 2, 1e-8),
        axis=0)


@_regression
def MSPE(yt, yp):
    return 100.0 * (((yp - yt)
                     / np.where(np.abs(yt) > 1e-8, yt, 1e-8)) ** 2
                    ).mean(axis=0)


def _labels_from(y_true, y_pred, from_logits: bool):
    """Deterministic decision rule: multi-column scores -> argmax;
    single-column scores threshold at 0.5 (probabilities, the sklearn
    convention and this registry's default) or at 0.0 with
    `from_logits=True` — never inferred from batch contents, which
    would make the metric value depend on what else is in the batch."""
    yt = np.asarray(y_true)
    yp = np.asarray(y_pred)
    if yp.ndim > 1 and yp.shape[-1] > 1:      # per-class scores
        yhat = yp.argmax(axis=-1)
    else:
        yp = yp.reshape(len(yp), -1)[:, 0]
        yhat = (yp > (0.0 if from_logits else 0.5)).astype(np.int64)
    if yt.ndim > 1 and yt.shape[-1] > 1:      # one-hot
        yt = yt.argmax(axis=-1)
    return yt.reshape(-1).astype(np.int64), yhat.reshape(-1)


def Accuracy(y_true, y_pred, multioutput=None, from_logits=False):
    yt, yhat = _labels_from(y_true, y_pred, from_logits)
    return float((yt == yhat).mean())


def Precision(y_true, y_pred, multioutput=None, from_logits=False):
    yt, yhat = _labels_from(y_true, y_pred, from_logits)
    tp = float(((yhat == 1) & (yt == 1)).sum())
    fp = float(((yhat == 1) & (yt == 0)).sum())
    return tp / (tp + fp) if tp + fp else 0.0


def Recall(y_true, y_pred, multioutput=None, from_logits=False):
    yt, yhat = _labels_from(y_true, y_pred, from_logits)
    tp = float(((yhat == 1) & (yt == 1)).sum())
    fn = float(((yhat == 0) & (yt == 1)).sum())
    return tp / (tp + fn) if tp + fn else 0.0


def F1Score(y_true, y_pred, multioutput=None, from_logits=False):
    p = Precision(y_true, y_pred, from_logits=from_logits)
    r = Recall(y_true, y_pred, from_logits=from_logits)
    return 2 * p * r / (p + r) if p + r else 0.0


def AUC(y_true, y_pred, multioutput=None, from_logits=False):
    """Binary ROC-AUC via the rank statistic (Mann-Whitney U) —
    equivalent to the trapezoidal ROC integral, no sklearn needed.
    (`from_logits` is accepted for metric-list uniformity; AUC is
    rank-based, so monotone score transforms don't change it.)"""
    yt = np.asarray(y_true)
    if yt.ndim > 1 and yt.shape[-1] > 1:      # one-hot labels
        yt = yt.argmax(axis=-1)
    yt = yt.reshape(-1)
    yp = np.asarray(y_pred)
    if yp.ndim > 1 and yp.shape[-1] == 2:
        yp = yp[..., 1]                       # positive-class score
    elif yp.ndim > 1 and yp.shape[-1] > 2:
        raise ValueError(
            f"AUC is binary-only; got {yp.shape[-1]} score columns")
    yp = yp.reshape(-1).astype(np.float64)
    if len(yp) != len(yt):
        raise ValueError(
            f"AUC: {len(yt)} labels vs {len(yp)} scores")
    pos = yt == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    # tie-averaged ranks in O(n log n): for each tied group of size c
    # starting at sorted position s (1-based), every member gets rank
    # s + (c - 1) / 2
    _, inverse, counts = np.unique(yp, return_inverse=True,
                                   return_counts=True)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]) + 1.0
    ranks = (starts + (counts - 1) / 2.0)[inverse]
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2
    return float(u / (n_pos * n_neg))


_METRICS = {
    "me": ME, "mae": MAE, "mse": MSE, "rmse": RMSE, "msle": MSLE,
    "r2": R2, "mape": MAPE, "mpe": MPE, "smape": sMAPE,
    "mdape": MDAPE, "smdape": sMDAPE, "mspe": MSPE,
    "accuracy": Accuracy, "acc": Accuracy, "precision": Precision,
    "recall": Recall, "f1": F1Score, "f1score": F1Score, "auc": AUC,
}

#: metrics where bigger is better (reference Evaluator.get_metric_mode)
_MAX_MODE = {"r2", "accuracy", "acc", "precision", "recall", "f1",
             "f1score", "auc"}


class Evaluator:
    """Reference `Evaluator.evaluate/check_metric/get_metric_mode`
    (automl/metrics.py:437-470)."""

    @staticmethod
    def check_metric(metric: str) -> str:
        key = str(metric).lower()
        if key not in _METRICS:
            raise ValueError(f"unknown metric '{metric}'; known: "
                             f"{sorted(_METRICS)}")
        return key

    @staticmethod
    def evaluate(metric: str, y_true, y_pred,
                 multioutput: str = "raw_values", **kwargs
                 ) -> Union[float, np.ndarray, Sequence[float]]:
        """kwargs pass through to the metric (e.g. `from_logits=True`
        for accuracy/precision/recall/f1 on single-column logits)."""
        key = Evaluator.check_metric(metric)
        return _METRICS[key](y_true, y_pred, multioutput=multioutput,
                             **kwargs)

    @staticmethod
    def get_metric_mode(metric: str) -> str:
        key = Evaluator.check_metric(metric)
        return "max" if key in _MAX_MODE else "min"
