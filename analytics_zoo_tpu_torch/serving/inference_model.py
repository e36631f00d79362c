"""InferenceModel — thread-safe concurrent inference over one loaded
module (counterpart of analytics_zoo_tpu/serving/inference_model.py).

One set of device-resident weights serves every caller; a semaphore of
`supported_concurrent_num` bounds the callers in flight, as the JAX
package's does.  `predict` keeps `load_flax`'s semantics: numpy in,
numpy out; inputs padded to power-of-two batch buckets up to
`max_batch_size` (the padded rows are dropped from the result); larger
requests chunked through the buckets; `records_served` counts the real
rows.  The module runs under `torch.inference_mode()` on the device its
parameters live on.

Loaders: `load_module` (a built module), `load_model` (a
`ZooModel.save_model` directory, JAX inference_model.py:154),
`load_estimator` (an Estimator's current module, :179) and `load_tf` (a
frozen TF1 GraphDef through `pipeline/tf_graph.py`, :139).  With
`quantize=True` the first two serve int8 weights (`quantize.py`): the
scales are computed on the module's flax-layout tree at load, on the
host, as JAX's `load_flax(quantize=True)` computes them (:59-97), the
int8 values stay resident on the module's device and each forward
dequantizes them to bf16 as it reaches them; `quantize_stats` holds
the byte counts JAX reports.
"""

from __future__ import annotations

import copy
import importlib
import os
import pickle
import threading
from typing import Optional

import numpy as np
import torch
from torch import nn


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max(n, max_batch)) if b > max_batch else b


def _pad_to(a: np.ndarray, target: int) -> np.ndarray:
    if len(a) == target:
        return a
    pad = [(0, target - len(a))] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def _to_numpy(out: torch.Tensor, n: int) -> np.ndarray:
    out = out[:n]
    if out.dtype == torch.bfloat16:     # numpy has no bfloat16
        out = out.float()
    return out.cpu().numpy()


class InferenceModel:
    """Loadable, thread-safe predictor."""

    def __init__(self, supported_concurrent_num: int = 4,
                 max_batch_size: int = 256):
        self._sem = threading.Semaphore(supported_concurrent_num)
        self.supported_concurrent_num = supported_concurrent_num
        self.max_batch_size = max_batch_size
        self._module: Optional[nn.Module] = None
        self._device: Optional[torch.device] = None
        self._lock = threading.Lock()
        self._n_predict = 0

    def load_module(self, module: nn.Module, quantize: bool = False):
        """Serve `module` (its weights already loaded, on its device).
        The counterpart of `load_flax`; `quantize=True` serves int8
        weights from a quantized copy of the module (the caller's module
        keeps its own) and sets `quantize_stats`."""
        if quantize:
            from analytics_zoo_tpu_torch.serving.quantize import (
                quantize_module,
            )
            module = copy.deepcopy(module)
            self.quantize_stats = quantize_module(module)
        return self._serve(module)

    def _serve(self, module: nn.Module):
        params = list(module.parameters())
        if not params:
            raise ValueError("load_module: the module has no parameters to "
                             "place it on a device")
        self._device = params[0].device
        self._module = module.eval()
        return self

    def load_model(self, path: str, model_cls=None, quantize: bool = False,
                   decrypt_key: str = None, device=None):
        """Serve the model a port `ZooModel.save_model` wrote under
        `path`, built on `device` (None = the CUDA card).  `model_cls`
        overrides the saved class name, which is otherwise resolved in
        the port's model namespaces.  `config.pkl` is unpickled: load
        only what this program saved.  `quantize=True` serves int8
        weights (the model is quantized as it is loaded); `decrypt_key`
        unlocks weights saved encrypted at rest."""
        from analytics_zoo_tpu_torch.models.common.zoo_model import (
            _CONFIG,
            read_state,
        )
        from analytics_zoo_tpu_torch.device import resolve_device
        with open(os.path.join(path, _CONFIG), "rb") as f:
            meta = pickle.load(f)
        if model_cls is None:
            model_cls = find_zoo_model_class(meta["class"])
        module = model_cls(**meta["config"], device=resolve_device(device))
        module.load_state_dict(read_state(path, decrypt_key, module.device_))
        if quantize:
            from analytics_zoo_tpu_torch.serving.quantize import (
                quantize_module,
            )
            self.quantize_stats = quantize_module(module)
        return self._serve(module)

    def load_tf(self, path_or_bytes, outputs=None, device=None):
        """Serve a frozen TF1 GraphDef (reference doLoadTF, JAX
        inference_model.py:139-152): the imported graph
        (`pipeline/tf_graph.py`) on `device` (None = the CUDA card)
        behind the same batch-bucketed, semaphore-bounded predict
        path."""
        from analytics_zoo_tpu_torch.pipeline.tf_graph import load_tf_graph
        net = load_tf_graph(path_or_bytes, outputs=outputs, device=device)
        self._device = net.device
        self._module = net._eval
        return self

    def load_estimator(self, estimator):
        """Serve an Estimator's current module (trained or still
        training) in eval mode, on its device."""
        return self.load_module(estimator.engine.model)

    def predict(self, *inputs: np.ndarray):
        """Batched prediction; thread-safe.  Each input is a [n, ...]
        ndarray; returns an ndarray (or a tuple of them) with leading
        dim n."""
        if self._module is None:
            raise RuntimeError("InferenceModel: no model loaded")
        inputs = tuple(np.asarray(a) for a in inputs)
        n = len(inputs[0])
        if n > self.max_batch_size:
            # chunk large requests through the buckets
            parts = [self.predict(*(a[s:s + self.max_batch_size]
                                    for a in inputs))
                     for s in range(0, n, self.max_batch_size)]
            if isinstance(parts[0], tuple):
                return tuple(np.concatenate([p[i] for p in parts])
                             for i in range(len(parts[0])))
            return np.concatenate(parts)
        target = _bucket(n, self.max_batch_size)
        padded = [_pad_to(a, target) for a in inputs]
        with self._sem:
            with torch.inference_mode():
                feats = [torch.from_numpy(np.ascontiguousarray(a)).to(
                    self._device) for a in padded]
                out = self._module(*feats)
                if isinstance(out, (tuple, list)):
                    result = tuple(_to_numpy(o, n) for o in out)
                else:
                    result = _to_numpy(out, n)
            with self._lock:
                self._n_predict += n
        return result

    @property
    def records_served(self) -> int:
        return self._n_predict


def find_zoo_model_class(name: str):
    """Resolve a saved ZooModel class name to its class in the port's
    model namespaces."""
    for mod in ("analytics_zoo_tpu_torch.models.recommendation",
                "analytics_zoo_tpu_torch.models.image.imageclassification",
                "analytics_zoo_tpu_torch.models.image.objectdetection",
                "analytics_zoo_tpu_torch.models.bert",
                "analytics_zoo_tpu_torch.models",
                "analytics_zoo_tpu_torch.models.textclassification",
                "analytics_zoo_tpu_torch.models.anomalydetection",
                "analytics_zoo_tpu_torch.models.seq2seq",
                "analytics_zoo_tpu_torch.models.textmatching"):
        m = importlib.import_module(mod)
        if hasattr(m, name):
            return getattr(m, name)
    raise ValueError(f"cannot resolve saved model class {name!r}; pass "
                     "model_cls explicitly")
