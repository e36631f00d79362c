"""Data lowering for the training engine (counterpart of
analytics_zoo_tpu/orca/learn/utils.py).

`HostDataset` holds (features, labels) as numpy arrays on the host and
yields batches of `batch_size` rows; the last, partial batch is padded to
the same static shape with a float `mask` marking the real rows, which
the loss and metrics consume, so counts stay exact.  Shuffling draws one
permutation per epoch from `seed + epoch`, as the JAX package does, so
both visit the rows in the same order.

XShards input streams (`_StreamingHostDataset`): shards are loaded one
ahead on a background IO thread, and their rows re-chunked into
batches of `batch_size`, leftover rows carried into the next batch, so
the dataset is never concatenated (under the DISK tier a couple of
shards are in memory at a time).  Its shuffle is two-level, the shard
order and then the rows within each shard, both from
`np.random.default_rng(seed + epoch)`: the JAX package's batches, bit
for bit.  DataFrames (and XShards of them) give their `feature_cols` /
`label_cols`; pandas is never imported here.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.orca.data.shard import XShards, _is_dataframe


def _as_tuple(x) -> Tuple:
    if x is None:
        return ()
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


def _np_tuple(x) -> Tuple[np.ndarray, ...]:
    return tuple(np.asarray(a) for a in _as_tuple(x))


def _stack_cols(df, cols: Sequence[str]) -> Tuple[np.ndarray, ...]:
    """One array per column; a column of arrays is stacked to [rows,
    ...]."""
    out = []
    for c in cols:
        v = df[c].to_numpy()
        if v.dtype == object:
            v = np.stack(v)
        out.append(v)
    return tuple(out)


class HostDataset:
    """The host-resident (features, labels) of one fit/evaluate/predict
    call.  `from_data` returns the streaming subclass for XShards."""

    def __init__(self, features: Tuple[np.ndarray, ...],
                 labels: Tuple[np.ndarray, ...]):
        self.features = features
        self.labels = labels
        self.n = len(features[0]) if features else 0

    @staticmethod
    def from_data(data: Any,
                  feature_cols: Optional[Sequence[str]] = None,
                  label_cols: Optional[Sequence[str]] = None
                  ) -> "HostDataset":
        """Accepts a dict {"x": ndarray(s), "y": ndarray(s)}, an (x, y)
        tuple, bare ndarray(s) (no labels), a pandas DataFrame with
        `feature_cols` (and `label_cols`), an XShards of any of those
        (streamed, never concatenated), or a zero-argument callable
        returning one of them."""
        if callable(data) and not isinstance(data, XShards) \
                and not _is_dataframe(data):
            data = data()
        if isinstance(data, XShards):
            if data.num_partitions() == 0:
                raise ValueError("empty XShards")
            return _StreamingHostDataset(data, feature_cols, label_cols)
        if _is_dataframe(data):
            if not feature_cols:
                raise ValueError("feature_cols required for DataFrame input")
            feats = _stack_cols(data, feature_cols)
            labels = (_stack_cols(data, _as_tuple(label_cols))
                      if label_cols else ())
            return HostDataset(feats, labels)
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

    def probe(self, batch_size: int) -> Dict[str, Any]:
        """A first batch (shapes and dtypes) from the head of the
        dataset."""
        return next(self.batches(min(batch_size, max(1, self.n))))

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

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, int(np.ceil(self.n / batch_size)))


class _StreamingHostDataset(HostDataset):
    """A HostDataset over XShards that never concatenates the dataset:
    shards stream through `batches()` one at a time, loaded one ahead on
    a background thread (DISK-tier unpickling overlaps the steps), and
    rows are re-chunked into batches with carry-over.  `n` is counted by
    a pass over the shards on first use, or set by the first full
    epoch."""

    def __init__(self, xshards: XShards,
                 feature_cols: Optional[Sequence[str]],
                 label_cols: Optional[Sequence[str]]):
        self._xs = xshards
        self._fc = feature_cols
        self._lc = label_cols
        self._n: Optional[int] = None
        self._first: Optional[Tuple[Tuple, Tuple]] = None

    @property
    def n(self) -> int:
        if self._n is None:
            total = 0
            for feats, _ in self._shard_iter(np.arange(self._num_shards())):
                total += len(feats[0]) if feats else 0
            self._n = total
        return self._n

    @property
    def has_labels(self) -> bool:
        return bool(self._head()[1])

    @property
    def features(self):
        """The head shard's features (shapes and dtypes only)."""
        return self._head()[0]

    @property
    def labels(self):
        return self._head()[1]

    def _head(self):
        if self._first is None:
            self._first = self._extract(self._xs._store.get(0))
        return self._first

    def probe(self, batch_size: int) -> Dict[str, Any]:
        feats, labels = self._head()
        k = min(batch_size, len(feats[0]))
        return pad_batch(tuple(a[:k] for a in feats),
                         tuple(a[:k] for a in labels), k)

    def _num_shards(self) -> int:
        return self._xs.num_partitions()

    def _extract(self, shard) -> Tuple[Tuple[np.ndarray, ...],
                                       Tuple[np.ndarray, ...]]:
        if _is_dataframe(shard):
            if not self._fc:
                raise ValueError("feature_cols required for DataFrame shards")
            feats = _stack_cols(shard, self._fc)
            labels = (_stack_cols(shard, _as_tuple(self._lc))
                      if self._lc else ())
            return feats, labels
        if isinstance(shard, dict):
            x = shard.get("x")
            if x is None:
                raise ValueError('dict shards must have an "x" key')
            return _np_tuple(x), _np_tuple(shard.get("y"))
        if isinstance(shard, tuple) and len(shard) == 2:
            return _np_tuple(shard[0]), _np_tuple(shard[1])
        return _np_tuple(shard), ()

    def _shard_iter(self, order: np.ndarray):
        """The extracted shards in `order`, loaded one ahead on a
        background thread (a queue of depth 2; pickle and pandas IO
        release the GIL; the copy to the card stays on the caller's
        thread, `TrainEngine`'s prefetcher).  A consumer that abandons
        the generator mid-epoch runs its `finally`, whose stop event
        ends the loader instead of leaving it blocked on a full queue
        holding shard memory."""
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        _END, _ERR = object(), object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def loader():
            try:
                for i in order:
                    if not put(self._extract(self._xs._store.get(int(i)))):
                        return
                put(_END)
            except BaseException as e:  # raised on the consumer's thread
                put((_ERR, e))

        t = threading.Thread(target=loader, daemon=True,
                             name="xshards-loader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if (isinstance(item, tuple) and len(item) == 2
                        and item[0] is _ERR):
                    raise item[1]
                yield item
        finally:
            stop.set()
            t.join()

    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        order = np.arange(self._num_shards())
        rng = np.random.default_rng(seed + epoch) if shuffle else None
        if rng is not None:
            rng.shuffle(order)

        # rows carried over: a list of (feats, labels) chunks
        chunks: List[Tuple[Tuple, Tuple]] = []
        buffered = 0
        total = 0

        def drain(target: int):
            """Pop exactly `target` rows off the front of the chunks."""
            nonlocal buffered
            feats_parts, label_parts, got = [], [], 0
            while got < target:
                f, lab = chunks[0]
                take = min(target - got, len(f[0]))
                feats_parts.append(tuple(a[:take] for a in f))
                label_parts.append(tuple(a[:take] for a in lab))
                if take == len(f[0]):
                    chunks.pop(0)
                else:
                    chunks[0] = (tuple(a[take:] for a in f),
                                 tuple(a[take:] for a in lab))
                got += take
            buffered -= target
            feats = tuple(np.concatenate([p[i] for p in feats_parts])
                          for i in range(len(feats_parts[0])))
            labels = tuple(np.concatenate([p[i] for p in label_parts])
                           for i in range(len(label_parts[0])))
            return feats, labels

        for feats, labels in self._shard_iter(order):
            nrows = len(feats[0]) if feats else 0
            if nrows == 0:
                continue
            if rng is not None:
                perm = rng.permutation(nrows)
                feats = tuple(a[perm] for a in feats)
                labels = tuple(a[perm] for a in labels)
            chunks.append((feats, labels))
            buffered += nrows
            total += nrows
            while buffered >= batch_size:
                yield pad_batch(*drain(batch_size), batch_size)
        if buffered:
            yield pad_batch(*drain(buffered), batch_size)
        self._n = total


def pad_batch(feats: Tuple[np.ndarray, ...], labels: Tuple[np.ndarray, ...],
              batch_size: int) -> Dict[str, Any]:
    """Zero-pad every array to `batch_size` rows; `mask` [rows] f32 is 1
    on the real rows (one card, so JAX's `pad_to_multiple_of` is 1)."""
    n = len(feats[0]) if feats else 0
    mask = np.zeros(batch_size, np.float32)
    mask[:n] = 1.0

    def _pad(a):
        if len(a) == batch_size:
            return a
        return np.pad(a, [(0, batch_size - len(a))] + [(0, 0)] * (a.ndim - 1))

    return {"features": tuple(_pad(a) for a in feats),
            "labels": tuple(_pad(a) for a in labels), "mask": mask}
