"""Chainable Preprocessing transformers (a copy of
analytics_zoo_tpu/feature/common.py; reference
`pyzoo/zoo/feature/common.py:94-300`).

A Preprocessing is a plain Python callable over one record
(numpy-first); `ChainedPreprocessing` composes them; applying any
Preprocessing to an `XShards` maps it over every record of every shard
in parallel (`transform_shard`), to an `ImageSet` returns an ImageSet.
`TextSet` (feature/text/) is not ported yet: a TextSet raises.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np


class Preprocessing:
    """One data-transform step.  Subclasses implement `apply(record)`.

    Calling an instance on:
      * a single record         -> transformed record
      * an `XShards`            -> new `XShards`, records mapped in parallel
      * an `ImageSet`           -> an ImageSet of transformed records
    Chain with `ChainedPreprocessing([...])` or the `>>` operator.
    """

    def apply(self, record: Any) -> Any:
        raise NotImplementedError

    # -- application ----------------------------------------------------

    def __call__(self, data: Any) -> Any:
        from analytics_zoo_tpu_torch.feature.image.imageset import ImageSet
        from analytics_zoo_tpu_torch.orca.data.shard import XShards

        if type(data).__name__ == "TextSet":
            raise NotImplementedError(
                "TextSet needs feature/text/text_set.py, which is not ported "
                "yet (ROADMAP Queue 1 item 9)")
        # domain sets carry their own record containers
        if isinstance(data, ImageSet):
            return data.transform(self)
        if isinstance(data, XShards):
            return data.transform_shard(self._apply_shard)
        return self.apply(data)

    def _apply_shard(self, shard):
        if isinstance(shard, list):
            return [self.apply(r) for r in shard]
        return self.apply(shard)

    def __rshift__(self, other: "Preprocessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])


class ChainedPreprocessing(Preprocessing):
    """Composes transformers left to right (reference common.py:136)."""

    def __init__(self, transformers: Sequence[Preprocessing]):
        for t in transformers:
            if not isinstance(t, Preprocessing):
                raise TypeError(f"{t!r} is not a Preprocessing")
        self.transformers: List[Preprocessing] = list(transformers)

    def apply(self, record):
        for t in self.transformers:
            record = t.apply(record)
        return record

    def __rshift__(self, other: Preprocessing) -> "ChainedPreprocessing":
        return ChainedPreprocessing(self.transformers + [other])


class Lambda(Preprocessing):
    """Wrap an arbitrary record function as a Preprocessing."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def apply(self, record):
        return self.fn(record)


class ScalarToTensor(Preprocessing):
    """number -> 0-d float32 ndarray (reference common.py:150)."""

    def apply(self, record):
        return np.asarray(record, np.float32)


class SeqToTensor(Preprocessing):
    """sequence -> ndarray, optionally reshaped to `size`
    (reference common.py:158)."""

    def __init__(self, size: Optional[Sequence[int]] = None):
        self.size = tuple(size) if size else None

    def apply(self, record):
        arr = np.asarray(record)
        if arr.dtype == object:
            arr = np.asarray(list(record), np.float32)
        if self.size:
            arr = arr.reshape(self.size)
        return arr


class ArrayToTensor(SeqToTensor):
    """ndarray -> ndarray reshaped to `size` (reference common.py:176)."""

    def __init__(self, size: Sequence[int]):
        super().__init__(size)


class FeatureLabelPreprocessing(Preprocessing):
    """(feature, label) -> {"x": ..., "y": ...} sample; robust to a missing
    label (reference common.py:186: Sample derived from feature only)."""

    def __init__(self, feature_transformer: Preprocessing,
                 label_transformer: Optional[Preprocessing] = None):
        self.ft = feature_transformer
        self.lt = label_transformer

    def apply(self, record):
        if isinstance(record, tuple) and len(record) == 2:
            feature, label = record
        else:
            feature, label = record, None
        out = {"x": self.ft.apply(feature)}
        if label is not None:
            out["y"] = (self.lt.apply(label) if self.lt is not None
                        else np.asarray(label))
        return out


class TensorToSample(Preprocessing):
    """tensor -> {"x": tensor} sample (reference common.py:210)."""

    def apply(self, record):
        return {"x": np.asarray(record)}
