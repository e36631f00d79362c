"""XShards: a sharded host dataset (counterpart of
analytics_zoo_tpu/orca/data/shard.py).

A sharded collection of Python objects (dicts or tuples of numpy
arrays, pandas DataFrames, or any picklable) with per-shard transforms
on a bounded thread pool (numpy and pandas release the GIL).  Under the
DISK tier (`OrcaContext.train_data_store = "DISK_n"`) the shards are
pickled to a temp dir as they stream in and loaded one at a time; the
directory goes when the XShards is freed.  `from_sources` makes a lazy
XShards whose shard i is `loader(sources[i])`, computed on each access.

pandas is imported only by the operations on DataFrame shards
(`partition_by`, `unique`, `to_pandas`, `merged`, `repartition`), and
lazily: XShards of arrays work where pandas is not installed.

>>> import numpy as np
>>> from analytics_zoo_tpu_torch.orca.data import XShards
>>> shards = XShards.partition({"x": np.arange(10),
...                             "y": np.arange(10) % 2}, num_shards=3)
>>> shards.num_partitions()
3
>>> doubled = shards.transform_shard(
...     lambda s: {"x": s["x"] * 2, "y": s["y"]})
>>> sorted(np.concatenate([s["x"] for s in doubled.collect()]).tolist())
[0, 2, 4, 6, 8, 10, 12, 14, 16, 18]
"""

from __future__ import annotations

import math
import os
import pickle
import shutil
import sys
import tempfile
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.common.context import OrcaContext


def _pool_size() -> int:
    # a floor of 4: shard transforms and reads are often IO-bound
    return min(32, max(4, os.cpu_count() or 8))


def _is_dataframe(x) -> bool:
    """True for a pandas DataFrame; never imports pandas (a DataFrame
    exists only once pandas is imported)."""
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(x, pd.DataFrame)


class _LazySourceStore:
    """A store whose shards are computed on access from external sources
    (part files): one shard in memory at a time, and each epoch reads
    the files again."""

    def __init__(self, sources, loader: Callable[[Any], Any]):
        self._sources = list(sources)
        self._loader = loader

    def __len__(self):
        return len(self._sources)

    def get(self, i: int) -> Any:
        return self._loader(self._sources[i])

    def iter(self):
        for i in range(len(self)):
            yield self.get(i)

    def all(self) -> List[Any]:
        return [self.get(i) for i in range(len(self))]


class _ShardStore:
    """The shards of one XShards: a list (DRAM) or pickle files (DISK).

    Under the DISK tier each shard is written as it streams in (a chain
    of transforms never holds the whole dataset), `iter()` loads one
    at a time, and the spill directory is removed when the store is
    collected.  Merging operations (`all()`, `merged`, `repartition`)
    load everything."""

    def __init__(self, shards, tier: Optional[str] = None):
        tier = tier or OrcaContext.train_data_store
        self._disk = tier.upper().startswith("DISK")
        if self._disk:
            self._dir = tempfile.mkdtemp(prefix="xshards_")
            self._finalizer = weakref.finalize(
                self, shutil.rmtree, self._dir, True)
            self._paths = []
            for i, s in enumerate(shards):
                p = os.path.join(self._dir, f"shard_{i}.pkl")
                with open(p, "wb") as f:
                    pickle.dump(s, f, protocol=pickle.HIGHEST_PROTOCOL)
                self._paths.append(p)
        else:
            self._shards = list(shards)

    def __len__(self):
        return len(self._paths) if self._disk else len(self._shards)

    def get(self, i: int) -> Any:
        if self._disk:
            with open(self._paths[i], "rb") as f:
                return pickle.load(f)
        return self._shards[i]

    def iter(self):
        for i in range(len(self)):
            yield self.get(i)

    def all(self) -> List[Any]:
        return [self.get(i) for i in range(len(self))]


def _parallel_map(func: Callable, items: Iterable):
    """`func` over `items` on a thread pool, at most twice the pool's
    size in flight, in order."""
    with ThreadPoolExecutor(_pool_size()) as ex:
        pending = deque()
        for item in items:
            pending.append(ex.submit(func, item))
            if len(pending) >= _pool_size() * 2:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


class XShards:
    """A sharded dataset.  Made by `XShards.partition`, `from_records`,
    `from_sources`, `load_pickle` or the readers of
    `analytics_zoo_tpu_torch.orca.data.pandas`."""

    def __init__(self, shards: Iterable[Any], tier: Optional[str] = None):
        self._store = _ShardStore(shards, tier)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @staticmethod
    def partition(data: Any, num_shards: Optional[int] = None) -> "XShards":
        """Split numpy data into shards along axis 0 of every leaf: an
        ndarray, a (nested) list or tuple of them, or a dict of them.
        Without `num_shards`, `OrcaContext.shard_size` rows a shard, or
        one shard per pool thread."""
        flat, rebuild = _flatten(data)
        if not flat:
            raise ValueError("no arrays found in data")
        n_rows = len(flat[0])
        for a in flat:
            if len(a) != n_rows:
                raise ValueError(
                    f"all arrays must share dim 0: {len(a)} != {n_rows}")
        if num_shards is None:
            if OrcaContext.shard_size:
                num_shards = max(1, math.ceil(n_rows / OrcaContext.shard_size))
            else:
                num_shards = min(_pool_size(), max(1, n_rows))
        num_shards = min(num_shards, max(1, n_rows))
        bounds = np.linspace(0, n_rows, num_shards + 1).astype(int)
        shards = []
        for i in range(num_shards):
            lo, hi = bounds[i], bounds[i + 1]
            shards.append(rebuild([a[lo:hi] for a in flat]))
        return XShards(shards)

    @staticmethod
    def from_sources(sources, loader: Callable[[Any], Any]) -> "XShards":
        """A lazy XShards: shard i is `loader(sources[i])`, computed on
        every access, so a dataset on disk streams through training
        without ever being resident."""
        xs = XShards.__new__(XShards)
        xs._store = _LazySourceStore(sources, loader)
        return xs

    @staticmethod
    def load_pickle(path: str) -> "XShards":
        """The shards `save_pickle` wrote to `path`."""
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".pkl"))
        shards = []
        for fp in files:
            with open(fp, "rb") as f:
                shards.append(pickle.load(f))
        return XShards(shards)

    @staticmethod
    def from_records(records: List[Any],
                     num_shards: Optional[int] = None,
                     default_shards: int = 8) -> "XShards":
        """A list of records split into list shards, never an empty one."""
        n = num_shards or min(len(records), default_shards)
        n = max(1, min(n, len(records))) if records else 1
        bounds = np.linspace(0, len(records), n + 1).astype(int)
        return XShards([records[bounds[i]:bounds[i + 1]]
                        for i in range(n)])

    # ------------------------------------------------------------------
    # per-shard operations
    # ------------------------------------------------------------------

    def transform_shard(self, func: Callable, *args) -> "XShards":
        """`func(shard, *args)` on every shard, on the pool.  Under the
        DISK tier the shards stream through (at most twice the pool's
        size in flight) and the results spill as they finish.  On a lazy
        XShards the transform composes with the loader, and the result
        stays lazy."""
        if isinstance(self._store, _LazySourceStore):
            loader = self._store._loader
            return XShards.from_sources(
                self._store._sources,
                lambda src: func(loader(src), *args))
        mapped = _parallel_map(lambda s: func(s, *args), self._store.iter())
        return XShards(mapped)

    def transform_shard_with_index(self, func: Callable) -> "XShards":
        """`func(index, shard)` on every shard, for transforms that need
        a stable identity per shard (a random stream each).  A lazy
        XShards stays lazy."""
        if isinstance(self._store, _LazySourceStore):
            loader = self._store._loader
            indexed = list(enumerate(self._store._sources))
            return XShards.from_sources(
                indexed, lambda pair: func(pair[0], loader(pair[1])))
        mapped = _parallel_map(lambda t: func(t[0], t[1]),
                               enumerate(self._store.iter()))
        return XShards(mapped)

    def get_shard(self, i: int) -> Any:
        """One shard (loaded from its file under the DISK tier)."""
        return self._store.get(i)

    def collect(self) -> List[Any]:
        return self._store.all()

    def num_partitions(self) -> int:
        return len(self._store)

    def repartition(self, num_partitions: int) -> "XShards":
        """Split again into `num_partitions` shards: array and DataFrame
        shards by rows, any other shards regrouped whole."""
        shards = self._store.all()
        first = shards[0] if shards else None
        if _is_array_like(first):
            return XShards.partition(_concat_shards(shards), num_partitions)
        if _is_dataframe(first):
            import pandas as pd
            df = pd.concat(shards, ignore_index=True)
            bounds = np.linspace(0, len(df), num_partitions + 1).astype(int)
            return XShards([df.iloc[bounds[i]:bounds[i + 1]]
                            for i in range(num_partitions)])
        # any other shards: grouped round-robin
        groups: List[List[Any]] = [[] for _ in range(num_partitions)]
        for i, s in enumerate(shards):
            groups[i % num_partitions].append(s)
        return XShards([g for g in groups if g])

    def partition_by(self, cols: str, num_partitions: Optional[int] = None
                     ) -> "XShards":
        """Hash-partition DataFrame shards by a column: rows with equal
        keys land in the same shard."""
        import pandas as pd
        shards = self._store.all()
        if not shards or not isinstance(shards[0], pd.DataFrame):
            raise ValueError("partition_by requires pandas DataFrame shards")
        num_partitions = num_partitions or len(shards)
        df = pd.concat(shards, ignore_index=True)
        codes = pd.util.hash_array(df[cols].to_numpy()) % num_partitions
        # empty partitions are dropped: few distinct keys would leave
        # frames without rows that break later per-shard operations
        out = [part for i in range(num_partitions)
               if len(part := df[codes == i])]
        return XShards(out or [df])

    def unique(self, col: Optional[str] = None) -> np.ndarray:
        """The distinct values of a column (DataFrame shards) or of a
        key of dict shards, or of the shards themselves."""
        vals = []
        for s in self._store.iter():
            if _is_dataframe(s):
                vals.append(s[col].unique() if col else s.iloc[:, 0].unique())
            else:
                vals.append(np.unique(s[col] if col else s))
        return np.unique(np.concatenate(vals))

    def split(self) -> List["XShards"]:
        """Shards that are tuples or lists of N elements become N
        XShards."""
        shards = self._store.all()
        n = len(shards[0])
        for s in shards:
            if len(s) != n:
                raise ValueError("each shard must have the same length")
        return [XShards([s[i] for s in shards]) for i in range(n)]

    def zip(self, other: "XShards") -> "XShards":
        """Pairs of shards of two XShards with as many partitions."""
        if self.num_partitions() != other.num_partitions():
            raise ValueError("XShards.zip requires equal num_partitions")
        return XShards(list(zip(self._store.all(), other._store.all())))

    def sample(self, frac: float, seed: Optional[int] = None) -> "XShards":
        """`frac` of each shard's rows, in their order.  Each shard draws
        from a generator of its own (`SeedSequence.spawn`): the shard
        transforms run at once, and numpy generators are not
        thread-safe."""
        n_parts = self.num_partitions()
        child_seeds = np.random.SeedSequence(seed).spawn(n_parts)

        def _s(i, shard):
            rng = np.random.default_rng(child_seeds[i])
            if _is_array_like(shard):
                flat, rebuild = _flatten(shard)
                n = len(flat[0])
                idx = np.sort(rng.choice(n, size=int(n * frac), replace=False))
                return rebuild([a[idx] for a in flat])
            return shard.sample(frac=frac,
                                random_state=int(rng.integers(0, 2**31)))
        return self.transform_shard_with_index(_s)

    def __len__(self) -> int:
        total = 0
        for s in self._store.iter():
            if _is_array_like(s):
                flat, _ = _flatten(s)
                total += len(flat[0])
            else:
                total += len(s)
        return total

    def save_pickle(self, path: str) -> "XShards":
        os.makedirs(path, exist_ok=True)
        for i, s in enumerate(self._store.iter()):
            with open(os.path.join(path, f"part-{i:05d}.pkl"), "wb") as f:
                pickle.dump(s, f, protocol=pickle.HIGHEST_PROTOCOL)
        return self

    # ------------------------------------------------------------------
    # conversions
    # ------------------------------------------------------------------

    def to_pandas(self):
        import pandas as pd
        return pd.concat(self._store.all(), ignore_index=True)

    def merged(self) -> Any:
        """All shards concatenated into one object in host memory."""
        shards = self._store.all()
        if _is_array_like(shards[0]):
            return _concat_shards(shards)
        if _is_dataframe(shards[0]):
            import pandas as pd
            return pd.concat(shards, ignore_index=True)
        out = []
        for s in shards:
            out.extend(s if isinstance(s, list) else [s])
        return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _is_array_like(x) -> bool:
    if isinstance(x, np.ndarray):
        return True
    if isinstance(x, dict):
        return all(_is_array_like(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_is_array_like(v) for v in x)
    return False


def _flatten(data):
    """A nested dict / list / tuple of ndarrays as (leaves, rebuild)."""
    leaves: List[np.ndarray] = []

    def build_spec(d):
        if isinstance(d, np.ndarray):
            leaves.append(d)
            return ("leaf", len(leaves) - 1)
        if isinstance(d, dict):
            return ("dict", {k: build_spec(v) for k, v in d.items()})
        if isinstance(d, (list, tuple)):
            return (type(d).__name__, [build_spec(v) for v in d])
        arr = np.asarray(d)
        leaves.append(arr)
        return ("leaf", len(leaves) - 1)

    spec = build_spec(data)

    def rebuild(new_leaves):
        def go(s):
            kind, payload = s
            if kind == "leaf":
                return new_leaves[payload]
            if kind == "dict":
                return {k: go(v) for k, v in payload.items()}
            seq = [go(v) for v in payload]
            return tuple(seq) if kind == "tuple" else seq
        return go(spec)

    return leaves, rebuild


def _concat_shards(shards):
    flats = []
    rebuild = None
    for s in shards:
        f, rb = _flatten(s)
        flats.append(f)
        rebuild = rb
    merged = [np.concatenate([f[i] for f in flats])
              for i in range(len(flats[0]))]
    return rebuild(merged)
