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
"""

from __future__ import annotations

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
        The counterpart of `load_flax`; `quantize=True` (int8 weights)
        waits for the port of serving/quantize.py and raises."""
        if quantize:
            raise NotImplementedError(
                "InferenceModel(quantize=True) needs serving/quantize.py, "
                "which is not ported yet (ROADMAP Queue 1)")
        params = list(module.parameters())
        if not params:
            raise ValueError("load_module: the module has no parameters to "
                             "place it on a device")
        self._device = params[0].device
        self._module = module.eval()
        return self

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
