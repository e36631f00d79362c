"""Data lowering for the training engine (counterpart of
analytics_zoo_tpu/orca/learn/utils.py).

`HostDataset` holds (features, labels) as numpy arrays on the host and
yields batches of `batch_size` rows; the last, partial batch is padded to
the same static shape with a float `mask` marking the real rows, which
the loss and metrics consume, so counts stay exact.  Shuffling draws one
permutation per epoch from `seed + epoch`, as the JAX package does, so
both visit the rows in the same order.  XShards and DataFrame input are
not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np


def _as_tuple(x) -> Tuple:
    if x is None:
        return ()
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


def _np_tuple(x) -> Tuple[np.ndarray, ...]:
    return tuple(np.asarray(a) for a in _as_tuple(x))


class HostDataset:
    """The host-resident (features, labels) of one fit/evaluate/predict
    call."""

    def __init__(self, features: Tuple[np.ndarray, ...],
                 labels: Tuple[np.ndarray, ...]):
        self.features = features
        self.labels = labels
        self.n = len(features[0]) if features else 0

    @staticmethod
    def from_data(data: Any) -> "HostDataset":
        """Accepts a dict {"x": ndarray(s), "y": ndarray(s)}, an (x, y)
        tuple, bare ndarray(s) (no labels), or a zero-argument callable
        returning one of those."""
        if callable(data):
            data = data()
        if type(data).__name__ in ("XShards", "DataFrame"):
            raise NotImplementedError(
                f"{type(data).__name__} input is not ported yet (ROADMAP "
                "Queue 1); pass {'x': ..., 'y': ...} or (x, y) arrays")
        if isinstance(data, dict):
            if data.get("x") is None:
                raise ValueError('dict data must have an "x" key')
            return HostDataset(_np_tuple(data["x"]), _np_tuple(data.get("y")))
        if isinstance(data, tuple) and len(data) == 2:
            # a 2-tuple is always (x, y), the reference's convention
            return HostDataset(_np_tuple(data[0]), _np_tuple(data[1]))
        return HostDataset(_np_tuple(data), ())

    @property
    def has_labels(self) -> bool:
        return bool(self.labels)

    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        """Batches of `batch_size` rows, the last one padded to
        `batch_size` with a float `mask` marking real rows."""
        idx = np.arange(self.n)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(idx)
        for start in range(0, self.n, batch_size):
            take = idx[start:start + batch_size]
            yield pad_batch(tuple(a[take] for a in self.features),
                            tuple(a[take] for a in self.labels), batch_size)


def pad_batch(feats: Tuple[np.ndarray, ...], labels: Tuple[np.ndarray, ...],
              batch_size: int) -> Dict[str, Any]:
    """Zero-pad every array to `batch_size` rows; `mask` [rows] f32 is 1
    on the real rows."""
    n = len(feats[0]) if feats else 0
    mask = np.zeros(batch_size, np.float32)
    mask[:n] = 1.0

    def _pad(a):
        if len(a) == batch_size:
            return a
        return np.pad(a, [(0, batch_size - len(a))] + [(0, 0)] * (a.ndim - 1))

    return {"features": tuple(_pad(a) for a in feats),
            "labels": tuple(_pad(a) for a in labels), "mask": mask}
