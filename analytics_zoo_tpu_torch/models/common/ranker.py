"""Listwise ranking evaluation, NDCG@k and MAP (counterpart of
analytics_zoo_tpu/models/common/ranker.py; reference
`zoo/src/main/scala/.../models/common/Ranker.scala`: `evaluateNDCG`,
`evaluateMAP` over a TextSet of grouped relation lists), mixed into
KNRM.

Operates on grouped blocks {"x": [n_query, n_cand, q_len + d_len],
"y": [n_query, n_cand]}, label -1 marking padded candidate rows, or an
`XShards` of them.  Scoring sends every candidate of every query through
one `Estimator.predict` (flattened), then reduces per query on the host.
numpy, as in JAX.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _collect_grouped(dataset) -> Tuple[np.ndarray, np.ndarray]:
    from analytics_zoo_tpu_torch.orca.data.shard import XShards

    if isinstance(dataset, XShards):
        blocks = dataset.collect()
    else:
        blocks = [dataset]
    n_cand = max(b["x"].shape[1] for b in blocks)

    def pad(b):
        extra = n_cand - b["x"].shape[1]
        if extra == 0:
            return b["x"], b["y"]
        x = np.pad(b["x"], ((0, 0), (0, extra), (0, 0)))
        y = np.pad(b["y"], ((0, 0), (0, extra)), constant_values=-1)
        return x, y

    xs, ys = zip(*[pad(b) for b in blocks])
    return np.concatenate(xs), np.concatenate(ys)


def _score_grouped(model, dataset, q_len: int,
                   batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    x, y = _collect_grouped(dataset)
    nq, nc, total = x.shape
    d_len = getattr(model, "text2_length", None)
    if d_len is not None and total != q_len + int(d_len):
        raise ValueError(
            f"grouped rows are {total} tokens but the model expects "
            f"text1_length + text2_length = {q_len} + {d_len}; "
            "re-shape the corpora to match")
    flat = x.reshape(nq * nc, total)
    est = model._require_estimator()
    scores = est.predict({"x": [flat[:, :q_len], flat[:, q_len:]]},
                         batch_size=batch_size)
    scores = np.asarray(scores).reshape(nq, nc)
    return scores, y


def ndcg_at_k(scores: np.ndarray, labels: np.ndarray, k: int) -> float:
    """Mean NDCG@k over queries; label -1 rows are padding, labels are
    graded relevance (0/1 in the binary case)."""
    out: List[float] = []
    for s, l in zip(scores, labels):
        valid = l >= 0
        s, l = s[valid], l[valid].astype(np.float64)
        if l.sum() <= 0 or len(l) == 0:
            continue  # reference skips queries without positives
        order = np.argsort(-s)[:k]
        gains = (2.0 ** l[order] - 1) / np.log2(
            np.arange(2, len(order) + 2))
        ideal_order = np.argsort(-l)[:k]
        ideal = (2.0 ** l[ideal_order] - 1) / np.log2(
            np.arange(2, len(ideal_order) + 2))
        out.append(float(gains.sum() / ideal.sum()))
    return float(np.mean(out)) if out else 0.0


def mean_average_precision(scores: np.ndarray,
                           labels: np.ndarray,
                           threshold: float = 0.0) -> float:
    """MAP over queries (binary relevance: label > threshold)."""
    out: List[float] = []
    for s, l in zip(scores, labels):
        valid = l >= 0
        s, rel = s[valid], (l[valid] > threshold)
        if rel.sum() == 0:
            continue
        order = np.argsort(-s)
        hits = rel[order]
        precisions = np.cumsum(hits) / np.arange(1, len(hits) + 1)
        out.append(float((precisions * hits).sum() / rel.sum()))
    return float(np.mean(out)) if out else 0.0


class Ranker:
    """Mixin for text-matching models (reference Ranker.scala): score a
    grouped relation dataset and reduce to NDCG@k / MAP.  `q_len` is the
    query token length the model splits inputs on (KNRM.text1_length)."""

    def _q_len(self) -> int:
        q = getattr(self, "text1_length", None)
        if q is None:
            raise AttributeError(
                "Ranker needs text1_length to split query/doc tokens")
        return int(q)

    def score_relations(self, grouped_dataset, batch_size: int = 256
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """One predict pass -> (scores [nq, nc], labels [nq, nc]); feed
        the pair to ndcg_at_k/mean_average_precision to compute several
        metrics without re-scoring the corpus."""
        return _score_grouped(self, grouped_dataset, self._q_len(),
                              batch_size)

    def evaluate_ndcg(self, grouped_dataset, k: int,
                      batch_size: int = 256) -> float:
        scores, labels = self.score_relations(grouped_dataset,
                                              batch_size)
        return ndcg_at_k(scores, labels, k)

    def evaluate_map(self, grouped_dataset, threshold: float = 0.0,
                     batch_size: int = 256) -> float:
        scores, labels = self.score_relations(grouped_dataset,
                                              batch_size)
        return mean_average_precision(scores, labels, threshold)
