"""XShardsTSDataset (counterpart of
analytics_zoo_tpu/chronos/data/experimental/xshards_tsdataset.py): a
TSDataset over XShards of pandas DataFrames, hash-partitioned by
`id_col` so that every series lives wholly in one shard.  Every
operation wraps the single-node `TSDataset` per shard (impute, scale,
roll run on the shard thread pool); `scale` reduces global statistics
over the shards' partial sums.  `to_xshards()` gives the {"x", "y"}
blocks that stream into `Estimator.fit` and the forecasters, shard by
shard.

The port's `orca.data.shard.XShards` holds the shards; `from_pandas`
splits a frame by row ranges with this module's copy of friesian's
`_shard_dataframe` (the JAX package's `friesian/table.py`).  pandas is
imported inside the functions that need it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from analytics_zoo_tpu_torch.chronos.data.tsdataset import (
    TSDataset,
    _as_list,
)
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.orca.data.shard import XShards, _pool_size


def _shard_dataframe(df: "pd.DataFrame", num_shards: Optional[int] = None
                     ) -> XShards:
    """Row-range split a DataFrame into XShards of DataFrames (not
    XShards.partition, which flattens to ndarray leaves): `num_shards`,
    else one shard per `OrcaContext.shard_size` rows, else the shard
    pool's size."""
    import math

    if num_shards is None:
        if OrcaContext.shard_size:
            num_shards = max(1, math.ceil(len(df) / OrcaContext.shard_size))
        else:
            num_shards = _pool_size()
    num_shards = max(1, min(num_shards, max(1, len(df))))
    bounds = np.linspace(0, len(df), num_shards + 1).astype(int)
    return XShards([df.iloc[bounds[i]:bounds[i + 1]].reset_index(drop=True)
                    for i in range(num_shards)])


class XShardsTSDataset:
    def __init__(self, shards: XShards, dt_col: str,
                 target_col: List[str], id_col: Optional[str],
                 feature_col: List[str], lookback=None, horizon=None):
        self.shards = shards
        self.dt_col = dt_col
        self.target_col = list(target_col)
        self.id_col = id_col
        self.feature_col = list(feature_col)
        self.lookback = lookback
        self.horizon = horizon

    # -- construction ---------------------------------------------------

    @staticmethod
    def from_xshards(shards: XShards, dt_col: str,
                     target_col: Union[str, Sequence[str]],
                     id_col: Optional[str] = None,
                     extra_feature_col: Union[str, Sequence[str],
                                              None] = None
                     ) -> "XShardsTSDataset":
        """`shards` holds pandas DataFrames.  With an `id_col` the data is
        re-partitioned so each id's rows are co-resident."""
        target = _as_list(target_col)
        feats = _as_list(extra_feature_col)
        if id_col is not None:
            shards = shards.partition_by(id_col,
                                         shards.num_partitions())
        return XShardsTSDataset(shards, dt_col, target, id_col, feats)

    @staticmethod
    def from_pandas(df, dt_col, target_col, id_col=None,
                    extra_feature_col=None, num_shards: int = 4
                    ) -> "XShardsTSDataset":
        shards = _shard_dataframe(df, num_shards)
        return XShardsTSDataset.from_xshards(
            shards, dt_col, target_col, id_col, extra_feature_col)

    # -- per-shard TSDataset ops ---------------------------------------

    def _wrap(self, df) -> TSDataset:
        import pandas as pd
        df = df.copy()
        # string datetimes would sort lexically and break .dt accessors
        df[self.dt_col] = pd.to_datetime(df[self.dt_col])
        return TSDataset(df.sort_values(
            [self.id_col, self.dt_col] if self.id_col else [self.dt_col])
            .reset_index(drop=True),
            self.dt_col, self.target_col, self.id_col, self.feature_col)

    def _per_shard(self, fn) -> "XShardsTSDataset":
        out = XShardsTSDataset(
            self.shards.transform_shard(
                # hash partitioning can leave a shard empty; pass through
                lambda df: df if len(df) == 0 else fn(self._wrap(df)).df),
            self.dt_col, self.target_col, self.id_col, self.feature_col,
            self.lookback, self.horizon)
        return out

    def impute(self, mode: str = "last", const_num: float = 0.0
               ) -> "XShardsTSDataset":
        return self._per_shard(lambda ts: ts.impute(mode, const_num))

    def deduplicate(self) -> "XShardsTSDataset":
        return self._per_shard(lambda ts: ts.deduplicate())

    def gen_dt_feature(self, features=None) -> "XShardsTSDataset":
        # column names are fully determined by the argument — no need to
        # probe (and transform) a shard just to learn them
        names = list(features) if features else [
            "HOUR", "DAY", "WEEKDAY", "MONTH", "IS_WEEKEND"]
        out = self._per_shard(lambda ts: ts.gen_dt_feature(names))
        out.feature_col = self.feature_col + [
            f for f in names if f not in self.feature_col]
        return out

    def scale(self, scalers: Optional[Dict] = None,
              fit: Optional[bool] = None) -> "XShardsTSDataset":
        """Standard-scale target+features with GLOBAL statistics (mean/std
        reduced over shard partials — per-shard stats would make the same
        value scale differently in different shards).  `fit=True`
        recomputes from this data; `fit=False` requires `scalers` (the
        val/test `scale(train_scaler, fit=False)` pattern); default: fit
        iff no scalers were passed."""
        cols = self.target_col + self.feature_col
        if fit is None:
            fit = scalers is None
        if not fit and scalers is None:
            raise ValueError("fit=False requires scalers from a prior "
                             "fit pass")
        if fit:
            # NaN-aware: per-column non-NaN counts, not len(df) — scale()
            # before impute() must not bias the statistics; reindex keeps
            # empty hash partitions (no columns yet) harmless
            def stats(df):
                sub = df.reindex(columns=cols)
                return sub.sum(), (sub ** 2).sum(), sub.count()
            partials = self.shards.transform_shard(stats).collect()
            count = sum(p[2] for p in partials)
            mean = sum(p[0] for p in partials) / count
            sq = sum(p[1] for p in partials) / count
            std = np.sqrt(np.maximum(sq - mean ** 2, 1e-12))
            scalers = {"mean": mean, "std": std}
        self._scalers = scalers

        def f(df):
            if len(df) == 0:
                return df
            df = df.copy()
            df[cols] = (df[cols] - scalers["mean"]) / scalers["std"]
            return df
        out = XShardsTSDataset(self.shards.transform_shard(f),
                               self.dt_col, self.target_col, self.id_col,
                               self.feature_col, self.lookback,
                               self.horizon)
        out._scalers = scalers
        return out

    def unscale_numpy(self, data: np.ndarray) -> np.ndarray:
        """Undo target scaling on forecaster output [b, horizon, n_tgt]."""
        mean = np.asarray(self._scalers["mean"][self.target_col],
                          np.float32)
        std = np.asarray(self._scalers["std"][self.target_col],
                         np.float32)
        return data * std + mean

    def roll(self, lookback: int, horizon: Union[int, Sequence[int]]
             ) -> "XShardsTSDataset":
        self.lookback = lookback
        self.horizon = horizon
        return self

    def to_xshards(self) -> XShards:
        """Roll every shard into {"x": [n, lookback, F], "y": [n, h, T]}
        blocks — streams straight into forecaster/Estimator fit."""
        if self.lookback is None:
            raise ValueError("call roll(lookback, horizon) first")
        lookback, horizon = self.lookback, self.horizon
        n_feat = len(self.target_col) + len(self.feature_col)
        n_tgt = len(self.target_col)
        h = (len(horizon) if isinstance(horizon, (list, tuple))
             else horizon)

        needed = lookback + (max(horizon)
                             if isinstance(horizon, (list, tuple))
                             else horizon)

        def f(df):
            empty = {"x": np.zeros((0, lookback, n_feat), np.float32)}
            if h:  # horizon-0 (predict-time) rolls carry no y anywhere
                empty["y"] = np.zeros((0, h, n_tgt), np.float32)
            if len(df) == 0:  # empty hash partition: empty block
                return empty
            if self.id_col is not None:
                # drop ids too short to yield a single window — one short
                # series in a shard must not abort the distributed roll
                df = df.groupby(self.id_col, sort=False).filter(
                    lambda g: len(g) >= needed)
            elif len(df) < needed:
                df = df.iloc[:0]
            if len(df) == 0:
                return empty
            ts = self._wrap(df)
            ts.roll(lookback, horizon)
            x, y = ts.to_numpy()
            return {"x": x, "y": y} if y is not None else {"x": x}
        return self.shards.transform_shard(f)
