"""Inference-only estimator (counterpart of
analytics_zoo_tpu/orca/learn/inference_estimator.py; reference:
`pyzoo/zoo/orca/learn/openvino/estimator.py`, predict/evaluate over
XShards and DataFrames for a model that cannot train).

It wraps the serving `InferenceModel` (batch-shape bucketing,
thread-safe concurrency) behind the Estimator's data surface: the
batches of `HostDataset` with their padding mask, the padding rows
dropped from each batch's predictions.  `fit` raises, as the
reference's OpenvinoEstimator.fit does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.orca.learn import metrics as metrics_mod
from analytics_zoo_tpu_torch.orca.learn.utils import HostDataset
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel


class InferenceEstimator:
    """`from_saved_model(path)` loads a ZooModel save directory;
    `from_model` wraps a live InferenceModel."""

    def __init__(self, inference_model: InferenceModel):
        self.model = inference_model

    @staticmethod
    def from_saved_model(path: str, model_cls=None, concurrent_num: int = 4,
                         device=None) -> "InferenceEstimator":
        """The model a port `ZooModel.save_model` wrote under `path`, on
        `device` (None = the CUDA card)."""
        im = InferenceModel(supported_concurrent_num=concurrent_num)
        im.load_model(path, model_cls=model_cls, device=device)
        return InferenceEstimator(im)

    @staticmethod
    def from_model(inference_model: InferenceModel) -> "InferenceEstimator":
        return InferenceEstimator(inference_model)

    # -- estimator surface ----------------------------------------------

    def fit(self, *a, **kw):
        raise NotImplementedError(
            "inference-only estimator: fit is unsupported (reference "
            "OpenvinoEstimator.fit raises the same way)")

    def predict(self, data, batch_size: int = 32,
                feature_cols: Optional[Sequence[str]] = None):
        ds = HostDataset.from_data(data, feature_cols, None)
        outs = []
        for b in ds.batches(batch_size):
            n_real = int(b["mask"].sum())
            preds = self.model.predict(*b["features"])
            if isinstance(preds, tuple):
                outs.append(tuple(p[:n_real] for p in preds))
            else:
                outs.append(preds[:n_real])
        if not outs:
            return None
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate([o[i] for o in outs])
                         for i in range(len(outs[0])))
        return np.concatenate(outs)

    def evaluate(self, data, batch_size: int = 32,
                 feature_cols: Optional[Sequence[str]] = None,
                 label_cols: Optional[Sequence[str]] = None,
                 metrics: Sequence[str] = ("accuracy",)
                 ) -> Dict[str, float]:
        """The metrics' means over the real rows (each metric per
        example, on the host)."""
        ds = HostDataset.from_data(data, feature_cols, label_cols)
        if not ds.has_labels:
            raise ValueError("evaluate requires labels")
        metric_fns = metrics_mod.resolve_all(list(metrics))
        totals = {name: 0.0 for name in metric_fns}
        count = 0.0
        for b in ds.batches(batch_size):
            n_real = int(b["mask"].sum())
            if n_real == 0:
                continue
            preds = self.model.predict(*b["features"])
            preds_t = (tuple(torch.from_numpy(p[:n_real]) for p in preds)
                       if isinstance(preds, tuple)
                       else torch.from_numpy(preds[:n_real]))
            labels = tuple(torch.from_numpy(np.asarray(a[:n_real]))
                           for a in b["labels"])
            for name, fn in metric_fns.items():
                totals[name] += float(fn(preds_t, labels).sum())
            count += n_real
        return {k: v / max(count, 1.0) for k, v in totals.items()}
