"""Feature utilities of the recommenders (the port's own copy of
analytics_zoo_tpu/models/recommendation/utils.py; the records
`UserItemFeature` / `UserItemPrediction`, the reference's
`recommender.py:29,53`).

The same functions and results as the JAX module.  pandas is imported
only inside the functions that take a DataFrame or a Series, so the
package imports, and ranks from `UserItemFeature` lists, where pandas
is not installed.  `hash_bucket` hashes with crc32, stable across
processes.
"""

from __future__ import annotations

import math
import warnings
import zlib
from typing import List, Optional, Sequence

import numpy as np


class UserItemFeature:
    """A (user_id, item_id, features[, label]) record
    (reference recommender.py:29)."""

    def __init__(self, user_id: int, item_id: int, sample, label=None):
        self.user_id = int(user_id)
        self.item_id = int(item_id)
        self.sample = sample
        self.label = label

    def __repr__(self):
        return (f"UserItemFeature(user_id={self.user_id}, "
                f"item_id={self.item_id})")


class UserItemPrediction:
    """Prediction for one user-item pair (reference recommender.py:53)."""

    def __init__(self, user_id: int, item_id: int, prediction: int,
                 probability: float):
        self.user_id = int(user_id)
        self.item_id = int(item_id)
        self.prediction = int(prediction)
        self.probability = float(probability)

    def __repr__(self):
        return (f"UserItemPrediction(user_id={self.user_id}, "
                f"item_id={self.item_id}, prediction={self.prediction}, "
                f"probability={self.probability:.4f})")


def _is_series(x) -> bool:
    return type(x).__name__ == "Series" and hasattr(x, "to_numpy")


def _is_vector(x) -> bool:
    return isinstance(x, (np.ndarray, list, tuple)) or _is_series(x)


def hash_bucket(content, bucket_size: int = 1000, start: int = 0):
    """Stable string-hash bucketing of a scalar, or of each element of a
    sequence, array or Series."""
    if _is_vector(content):
        h = np.asarray([zlib.crc32(str(v).encode("utf-8"))
                        for v in content], np.int64)
        return (h % bucket_size + start).astype(np.int64)
    h = zlib.crc32(str(content).encode("utf-8"))
    return h % bucket_size + start


def categorical_from_vocab_list(sth, vocab_list: Sequence,
                                default: int = -1, start: int = 0):
    """Index of `sth` in the vocab (a scalar, or each element of a
    sequence); unknown values map to `default`."""
    lookup = {v: i for i, v in enumerate(vocab_list)}
    if _is_vector(sth):
        return np.asarray([lookup.get(v, default) + start for v in sth],
                          np.int64)
    return lookup.get(sth, default) + start


def _to_float(v) -> float:
    """pandas' to_numeric(errors="coerce") of one value: a number, or
    NaN for what does not parse ('?', None, text)."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return math.nan


def get_boundaries(target, boundaries: Sequence[float],
                   default: int = -1, start: int = 0):
    """Bucketize `target` by sorted `boundaries` ('?'/NaN/non-numeric ->
    default), a scalar or each element of a sequence, through one path
    so that missing values are handled alike."""
    bnds = np.asarray(boundaries, np.float64)
    scalar = not _is_vector(target)
    vals = np.asarray([_to_float(v) for v in ([target] if scalar
                                               else target)], np.float64)
    idx = np.searchsorted(bnds, vals, side="right")
    idx = np.where(np.isnan(vals), default, idx).astype(np.int64) + start
    return int(idx[0]) if scalar else idx


def get_negative_samples(indexed, user_col: str = "userId",
                         item_col: str = "itemId",
                         label_col: str = "label",
                         neg_num: int = 1,
                         item_count: Optional[int] = None,
                         seed: int = 0):
    """`neg_num` negative (user, random item, label=1) rows per row of the
    DataFrame `indexed`, avoiding each user's positive items (reference
    getNegativeSamples: 1 = negative, >= 2 = positive ratings).  Draws
    in bulk and redraws only the slots that hit a positive; a slot still
    hitting one after 100 rounds is dropped, with a warning."""
    import pandas as pd
    rng = np.random.default_rng(seed)
    users = indexed[user_col].to_numpy(np.int64)
    items = indexed[item_col].to_numpy(np.int64)
    max_item = int(item_count if item_count is not None else items.max())
    # (user, item) pairs as sortable int keys: a collision check is one
    # searchsorted, and a round re-checks only the redrawn slots
    pos_keys = np.unique(users * (max_item + 1) + items)

    def collides(u, d):
        if pos_keys.size == 0:
            return np.zeros(len(u), bool)
        k = u * (max_item + 1) + d
        j = np.minimum(np.searchsorted(pos_keys, k), len(pos_keys) - 1)
        return pos_keys[j] == k

    rep_users = np.repeat(users, neg_num)
    draws = rng.integers(1, max_item + 1, rep_users.shape[0])
    pending = np.flatnonzero(collides(rep_users, draws))
    for _ in range(100):
        if pending.size == 0:
            break
        draws[pending] = rng.integers(1, max_item + 1, pending.size)
        pending = pending[collides(rep_users[pending], draws[pending])]
    if pending.size:
        warnings.warn(
            f"get_negative_samples: dropped {int(pending.size)} draws that "
            "still collided with positives after 100 rounds (user rated "
            "nearly the whole catalog?)")
        keep = np.ones(rep_users.shape[0], bool)
        keep[pending] = False
        rep_users, draws = rep_users[keep], draws[keep]
    return pd.DataFrame({user_col: rep_users, item_col: draws,
                         label_col: np.ones(rep_users.shape[0], np.int64)})


def _frame(df):
    """(a DataFrame, whether `df` was one row as a Series)."""
    if _is_series(df):
        return df.to_frame().T, True
    return df, False


def get_wide_indices(df, column_info) -> np.ndarray:
    """Cumulative-offset indices of the active wide features, the ones
    the reference packs into its sparse one-hot (utils.py:51-75):
    [n, n_wide_cols] int, or one row's for a Series."""
    frame, one_row = _frame(df)
    cols = column_info.wide_base_cols + column_info.wide_cross_cols
    dims = column_info.wide_base_dims + column_info.wide_cross_dims
    offsets = np.concatenate([[0], np.cumsum(dims[:-1])]) if dims else \
        np.zeros(0)
    out = np.stack(
        [frame[c].to_numpy(np.int64) + int(o)
         for c, o in zip(cols, offsets)], axis=1) if cols else \
        np.zeros((len(frame), 0), np.int64)
    return out[0] if one_row else out


def get_deep_tensors(df, column_info) -> List[np.ndarray]:
    """Deep-tower inputs: [multi-hot indicators, embed ids, continuous]
    (reference utils.py:78-131), each [n, ...], empty groups left out."""
    frame, one_row = _frame(df)
    ci = column_info
    parts: List[np.ndarray] = []
    if ci.indicator_cols:
        ind = np.zeros((len(frame), sum(ci.indicator_dims)), np.float32)
        acc = 0
        rows = np.arange(len(frame))
        for c, d in zip(ci.indicator_cols, ci.indicator_dims):
            ids = np.clip(frame[c].to_numpy(np.int64), 0, d - 1)
            ind[rows, acc + ids] = 1.0
            acc += d
        parts.append(ind)
    if ci.embed_cols:
        emb = []
        for c in ci.embed_cols:
            v = frame[c].to_numpy()
            if v.size and np.abs(v.astype(np.float64)).max() >= 2 ** 24:
                raise ValueError(
                    f"embed column '{c}' has ids >= 2**24, not exactly "
                    "representable in float32; remap ids first")
            emb.append(v.astype(np.float32))
        parts.append(np.stack(emb, axis=1))
    if ci.continuous_cols:
        parts.append(np.stack(
            [frame[c].to_numpy(np.float32) for c in ci.continuous_cols],
            axis=1))
    if not parts:
        raise TypeError("Empty deep tensors")
    return [p[0] for p in parts] if one_row else parts


def rows_to_features(df, column_info,
                     model_type: str = "wide_n_deep") -> np.ndarray:
    """DataFrame -> the [n, n_features] f32 matrix `WideAndDeep` takes,
    columns in `column_info.feature_cols` order."""
    import pandas as pd
    ci = column_info
    model_type = model_type.lower()
    if model_type not in ("wide", "deep", "wide_n_deep"):
        raise TypeError(f"Unsupported model_type: {model_type}")
    n_cat = len(ci.feature_cols) - len(ci.continuous_cols)
    cols = []
    for j, c in enumerate(ci.feature_cols):
        v = pd.to_numeric(df[c]).to_numpy()
        if j < n_cat and v.size and np.abs(v).max() >= 2 ** 24:
            # an id past 2^24 collapses onto a neighbour in f32 and
            # gathers the wrong embedding row
            raise ValueError(
                f"column '{c}' has ids >= 2**24, not exactly "
                "representable in the float32 feature matrix; remap ids "
                "(e.g. hash_bucket) first")
        cols.append(v.astype(np.float32))
    return np.stack(cols, axis=1)


def row_to_sample(row, column_info, model_type: str = "wide_n_deep"):
    """One row (a Series) -> (features, label), the label shifted to
    0-based (the reference's BigDL labels are 1-based)."""
    feats = rows_to_features(row.to_frame().T, column_info, model_type)[0]
    label = int(row[column_info.label]) - 1
    return feats, label


def to_user_item_feature(row, column_info,
                         model_type: str = "wide_n_deep") -> UserItemFeature:
    """One row (a Series) -> UserItemFeature (reference utils.py:158)."""
    feats, label = row_to_sample(row, column_info, model_type)
    return UserItemFeature(row["userId"], row["itemId"], feats, label=label)
