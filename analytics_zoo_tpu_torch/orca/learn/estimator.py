"""Orca Estimator — fit/evaluate/predict over a torch module on one card
(counterpart of analytics_zoo_tpu/orca/learn/estimator.py).

`Estimator.from_torch(module, ...)` is the port's counterpart of the JAX
`from_flax` (estimator.py:109): the port's models are torch modules, so
they train as they are (the JAX `from_torch`, which imports a torch
module into flax, has no role here).  The module trains on the device
its parameters are on; the port's models are built on the card unless
given another device.  Loss and metrics default to the module's
`default_loss` / `default_metrics` where it names them.

Data: {"x": ndarray(s), "y": ndarray(s)} or (x, y) tuples of numpy
arrays, batched and padded by `HostDataset`.  With
`OrcaContext.train_data_store == "DEVICE"`, `fit` uploads the padded
dataset to the card once and trains from it there (estimator.py:252);
the upload is cached across `fit` calls on the same arrays.  Checkpoints,
the retry loop, triggers, validation data and observability are not
ported yet.
"""

from __future__ import annotations

import logging
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.orca.learn import losses as losses_mod
from analytics_zoo_tpu_torch.orca.learn import metrics as metrics_mod
from analytics_zoo_tpu_torch.orca.learn import optimizers as optim_mod
from analytics_zoo_tpu_torch.orca.learn.spmd import DeviceDataset, TrainEngine
from analytics_zoo_tpu_torch.orca.learn.utils import HostDataset

logger = logging.getLogger("analytics_zoo_tpu_torch")


class NaNLossError(RuntimeError):
    """Raised under nan_policy='raise' when a training epoch hit
    non-finite loss/gradients (the skipped steps are reported)."""


class Estimator:
    """sklearn-style fit/evaluate/predict over one `TrainEngine`."""

    def __init__(self, module, *, loss=None, optimizer=None, metrics=None,
                 learning_rate=None, clip_norm=None, clip_value=None,
                 seed: int = 0):
        if loss is None:
            loss = getattr(module, "default_loss", None)
        if metrics is None:
            metrics = list(getattr(module, "default_metrics", ()))
        self._seed = seed
        self._engine = TrainEngine(
            module, optim_mod.resolve(optimizer, learning_rate, clip_norm,
                                      clip_value),
            loss_fn=losses_mod.resolve(loss),
            metric_fns=metrics_mod.resolve_all(metrics), seed=seed)
        self._epoch = 0
        self.train_summary: List[Dict[str, Any]] = []
        #: the DEVICE store's uploads: key -> (DeviceDataset, source arrays)
        self._device_cache: Dict[Any, Any] = {}
        self.device_cache_hits = 0

    @classmethod
    def from_torch(cls, module, **kwargs) -> "Estimator":
        """Keywords: `loss`, `metrics`; `optimizer`, a name ("adam",
        "adamw", "sgd"), an `optimizers.Optimizer`, or None (adam);
        `learning_rate` its rate; `clip_norm` / `clip_value` the gradient
        clipping; `seed` the shuffling and the dropout generator."""
        return cls(module, **kwargs)

    @property
    def engine(self) -> TrainEngine:
        return self._engine

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            shuffle: bool = True, nan_policy: str = "warn") -> "Estimator":
        """Train for `epochs`, from host batches or, where
        `OrcaContext.train_data_store` is "DEVICE", from the dataset
        uploaded to the card.  Steps with non-finite loss or gradients
        are skipped on the device; `nan_policy` "warn" logs them, "raise"
        aborts with NaNLossError.  The last epoch's per-step stats are in
        `engine.last_steps`."""
        if nan_policy not in ("warn", "raise"):
            raise ValueError("nan_policy must be 'warn' or 'raise'")
        ds = HostDataset.from_data(data)
        if not ds.has_labels:
            raise ValueError("fit requires labels: pass {'x': ..., 'y': ...} "
                             "or an (x, y) tuple")
        eng = self._engine
        if eng.loss_fn is None:
            raise ValueError("fit needs a loss")
        dds = (self._device_dataset(ds, batch_size, shuffle)
               if OrcaContext.train_data_store == "DEVICE" else None)
        for _ in range(epochs):
            t0 = time.perf_counter()
            if dds is not None:
                stats = eng.run_epoch_device(dds, train=True, shuffle=shuffle,
                                             seed=self._seed,
                                             epoch=self._epoch)
            else:
                stats = eng.run_epoch(
                    ds.batches(batch_size, shuffle=shuffle, seed=self._seed,
                               epoch=self._epoch), train=True)
            self._epoch += 1
            wall = time.perf_counter() - t0
            stats.update(epoch=self._epoch, step=eng.host_step, wall_s=wall,
                         samples_per_s=ds.n / max(wall, 1e-9))
            self.train_summary.append(stats)
            if stats.get("nan_steps"):
                msg = (f"{int(stats['nan_steps'])} training step(s) in epoch "
                       f"{self._epoch} had non-finite loss/gradients and "
                       "were skipped")
                if nan_policy == "raise":
                    raise NaNLossError(msg)
                logger.warning(msg)
        return self

    @staticmethod
    def _content_fingerprint(arrays) -> tuple:
        """A sampled content hash (estimator.py:435): crc32 of the first
        4 KB of up to 8 rows spread over each array's leading axis.  It
        sees an in-place change to any sampled row; a change confined to
        unsampled rows goes unseen (do not mutate sources between
        fits)."""
        parts = []
        for a in arrays:
            a = np.asarray(a)
            if a.ndim == 0:
                parts.append(zlib.crc32(a.tobytes()))
                continue
            n = a.shape[0]
            crc = 0
            for i in sorted({0, n - 1, *((n * k) // 7 for k in range(1, 7))}):
                blk = np.ascontiguousarray(a[i:i + 1])
                crc = zlib.crc32(blk.tobytes()[:4096], crc)
            parts.append(crc)
        return tuple(parts)

    def _device_dataset(self, ds: HostDataset, batch_size: int,
                        shuffle: bool = False) -> Optional[DeviceDataset]:
        """The DEVICE store's upload of `ds` (estimator.py:462-524), or
        None (host streaming, with a warning) when its padded footprint,
        counted twice for a shuffled fit (the permutation makes a second
        copy), passes `OrcaContext.device_cache_bytes`.  Cached on the
        source arrays' ids, shapes and dtypes, the batch size and a
        sampled content fingerprint; the sources are held beside the
        upload, so an id stays theirs while the entry lives."""
        arrays = tuple(ds.features) + tuple(ds.labels)
        steps, b = self._engine.cached_layout(ds.n, batch_size)
        row_bytes = sum(a.dtype.itemsize * int(np.prod(a.shape[1:],
                                                       dtype=np.int64))
                        for a in arrays) + 4      # + the f32 mask
        # checked before the cache lookup: a dataset cached by an
        # unshuffled fit is held to twice its size by a shuffled one
        nbytes = steps * b * row_bytes * (2 if shuffle else 1)
        cap = OrcaContext.device_cache_bytes
        if nbytes > cap:
            logger.warning(
                "dataset needs %d device bytes (padded%s), over "
                "device_cache_bytes (%d); using host streaming", nbytes,
                ", x2 for shuffle" if shuffle else "", cap)
            return None
        key = (tuple((id(a), a.shape, str(a.dtype)) for a in arrays),
               int(batch_size), len(ds.features),
               self._content_fingerprint(arrays))
        hit = self._device_cache.get(key)
        if hit is not None:
            self.device_cache_hits += 1
            return hit[0]
        # a mutated source has a new fingerprint: its old upload is stale
        for stale in [k for k in self._device_cache
                      if k[:3] == key[:3] and k != key]:
            del self._device_cache[stale]
        held = sum(entry[0].nbytes for entry in self._device_cache.values())
        if held + nbytes > cap:
            self._device_cache.clear()
        dds = self._engine.cache_dataset(ds.features, ds.labels, batch_size)
        self._device_cache[key] = (dds, arrays)
        return dds

    def evaluate(self, data, batch_size: int = 32) -> Dict[str, float]:
        ds = HostDataset.from_data(data)
        if not ds.has_labels:
            raise ValueError("evaluate requires labels: pass {'x': ..., "
                             "'y': ...} or an (x, y) tuple")
        return self._engine.run_epoch(ds.batches(batch_size), train=False)

    def predict(self, data, batch_size: int = 32):
        """Stacked predictions (numpy, or a tuple of them), padding rows
        dropped, in the input's order."""
        ds = HostDataset.from_data(data)
        outs = self._engine.predict_all(ds.batches(batch_size))
        if not outs:
            return None
        if isinstance(outs[0], (tuple, list)):
            return type(outs[0])(np.concatenate([o[i] for o in outs])
                                 for i in range(len(outs[0])))
        return np.concatenate(outs)

    def get_model(self):
        """The trained torch module (its parameters are the engine's)."""
        return self._engine.model
