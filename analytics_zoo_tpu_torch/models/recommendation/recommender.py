"""The recommenders' ranking surface (counterpart of
analytics_zoo_tpu/models/recommendation/recommender.py:24-101; reference
`pyzoo/zoo/models/recommendation/recommender.py:81`):
`predict_user_item_pair`, `recommend_for_user`, `recommend_for_item`.

One batched forward over all pairs, then a vectorized rank: a stable
`np.lexsort` by predicted rating, then probability, both descending,
and the first k rows of each user (or item) in that order, the rows of
the JAX module's pandas sort and `groupby(...).head(k)` in the same
order.  Pairs come as a `UserItemFeature` list or, where pandas is
installed, a DataFrame with "userId", "itemId" and optionally "sample"
columns; nothing here imports pandas.
"""

from __future__ import annotations

from typing import List

import numpy as np

from analytics_zoo_tpu_torch.models.recommendation.utils import (
    UserItemPrediction,
)


def _is_frame(pairs) -> bool:
    return hasattr(pairs, "columns") and hasattr(pairs, "to_numpy")


def _rank_in_group(keys: np.ndarray) -> np.ndarray:
    """Each row's 0-based position among the rows of its key, in row
    order."""
    idx = np.argsort(keys, kind="stable")
    grouped = keys[idx]
    pos = np.arange(len(keys))
    starts = np.r_[True, grouped[1:] != grouped[:-1]]
    first = np.maximum.accumulate(np.where(starts, pos, 0))
    rank = np.empty(len(keys), np.int64)
    rank[idx] = pos - first
    return rank


class Recommender:
    """Mixin for the recommender models (NeuralCF, WideAndDeep).

    Subclasses may override `_pair_features(users, items, feats)`, which
    maps the stacked pairs to the model's inputs; the default is the
    (user, item) id arrays NeuralCF takes."""

    def _stack_pairs(self, pairs):
        if _is_frame(pairs):
            users = pairs["userId"].to_numpy(np.int64)
            items = pairs["itemId"].to_numpy(np.int64)
            feats = None
            if "sample" in pairs.columns:
                feats = np.stack(pairs["sample"].to_list())
            return users, items, feats
        users = np.asarray([p.user_id for p in pairs], np.int64)
        items = np.asarray([p.item_id for p in pairs], np.int64)
        feats = None
        if pairs and getattr(pairs[0], "sample", None) is not None:
            feats = np.stack([np.asarray(p.sample) for p in pairs])
        return users, items, feats

    def _pair_features(self, users, items, feats):
        return [users.astype(np.int32), items.astype(np.int32)]

    def _pair_probs(self, pairs, batch_size: int = 256):
        """(users, items, predicted class, its probability) per pair."""
        if len(pairs) == 0:
            z = np.zeros(0)
            return z.astype(np.int64), z.astype(np.int64), \
                z.astype(np.int64), z
        users, items, feats = self._stack_pairs(pairs)
        x = self._pair_features(users, items, feats)
        logits = np.asarray(self.predict({"x": x}, batch_size=batch_size))
        z = logits - logits.max(axis=-1, keepdims=True)
        ez = np.exp(z)
        probs = ez / ez.sum(axis=-1, keepdims=True)
        cls = probs.argmax(axis=-1)
        return users, items, cls, probs[np.arange(len(cls)), cls]

    def predict_user_item_pair(self, pairs, batch_size: int = 256
                               ) -> List[UserItemPrediction]:
        """Per-pair (prediction, probability); predictions are 1-based
        ratings, the reference's BigDL label convention."""
        users, items, cls, prob = self._pair_probs(pairs, batch_size)
        return [UserItemPrediction(u, i, int(c) + 1, float(p))
                for u, i, c, p in zip(users, items, cls, prob)]

    def _rank(self, pairs, by: str, k: int,
              batch_size: int) -> List[UserItemPrediction]:
        users, items, cls, prob = self._pair_probs(pairs, batch_size)
        pred = cls + 1
        # predicted rating first, then confidence (reference
        # Recommender.scala), not bare confidence, which would float
        # confidently negative pairs to the top
        order = np.lexsort((-prob, -pred))
        keys = (users if by == "userId" else items)[order]
        order = order[_rank_in_group(keys) < k]
        return [UserItemPrediction(users[j], items[j], pred[j], prob[j])
                for j in order]

    def recommend_for_user(self, pairs, max_items: int,
                           batch_size: int = 256) -> List[UserItemPrediction]:
        """Top `max_items` items per user by (rating, probability)."""
        return self._rank(pairs, "userId", max_items, batch_size)

    def recommend_for_item(self, pairs, max_users: int,
                           batch_size: int = 256) -> List[UserItemPrediction]:
        """Top `max_users` users per item by (rating, probability)."""
        return self._rank(pairs, "itemId", max_users, batch_size)
