"""Native histogram gradient-boosted trees (counterpart of
analytics_zoo_tpu/orca/automl/gbdt.py), the backend behind AutoXGBoost
when the xgboost package is missing: second-order (Newton) boosting on
quantile-binned histograms, xgboost's `hist` method.  The API is the
subset the wrappers use (`fit(x, y, xgb_model=...)` warm-start
continuation, `predict`, `predict_proba`, `get_booster`), so
`xgboost_backend()` returns whichever of the two exists.

Trees grow depth-wise, vectorized in numpy: each level's gradient and
hessian histograms come from one `np.bincount` over `node * bins +
bin`; the split gain is 0.5 [G_L^2/(H_L+l) + G_R^2/(H_R+l) - G^2/(H+l)]
- gamma, a leaf is -G/(H+l).  Trees are branchy, data-dependent control
flow, so they run on the host, in JAX as here: the same code on the
same float64 data.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class _Tree:
    """Flat-array binary tree over binned features."""

    __slots__ = ("feature", "threshold_bin", "left", "right", "value")

    def __init__(self):
        self.feature: List[int] = []
        self.threshold_bin: List[int] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.value: List[float] = []

    def _new_node(self):
        self.feature.append(-1)
        self.threshold_bin.append(0)
        self.left.append(-1)
        self.right.append(-1)
        self.value.append(0.0)
        return len(self.feature) - 1

    def predict_binned(self, xb: np.ndarray) -> np.ndarray:
        node = np.zeros(len(xb), np.int64)
        feature = np.asarray(self.feature)
        thr = np.asarray(self.threshold_bin)
        left = np.asarray(self.left)
        right = np.asarray(self.right)
        value = np.asarray(self.value)
        active = feature[node] >= 0
        while active.any():
            idx = np.nonzero(active)[0]
            f = feature[node[idx]]
            go_left = xb[idx, f] <= thr[node[idx]]
            node[idx] = np.where(go_left, left[node[idx]],
                                 right[node[idx]])
            active = feature[node] >= 0
        return value[node]


def _grow_tree(xb: np.ndarray, g: np.ndarray, h: np.ndarray,
               n_bins: int, max_depth: int, reg_lambda: float,
               gamma: float, min_child_weight: float,
               learning_rate: float) -> _Tree:
    n, d = xb.shape
    tree = _Tree()
    root = tree._new_node()
    node_of = np.zeros(n, np.int64)
    frontier = [root]
    for _level in range(max_depth):
        if not frontier:
            break
        remap = {nid: i for i, nid in enumerate(frontier)}
        k = len(frontier)
        rows = np.nonzero(np.isin(node_of, frontier))[0]
        node_c = np.asarray([remap[nid] for nid in node_of[rows]])
        # per (node, feature, bin) G/H histograms in one bincount pass
        flat = ((node_c[:, None] * d + np.arange(d)[None, :]) * n_bins
                + xb[rows]).ravel()
        GL = np.bincount(flat, weights=np.repeat(g[rows], d),
                         minlength=k * d * n_bins) \
            .reshape(k, d, n_bins).cumsum(axis=2)
        HL = np.bincount(flat, weights=np.repeat(h[rows], d),
                         minlength=k * d * n_bins) \
            .reshape(k, d, n_bins).cumsum(axis=2)
        G = GL[:, 0, -1][:, None, None]   # node totals
        H = HL[:, 0, -1][:, None, None]
        GR, HR = G - GL, H - HL
        ok = (HL >= min_child_weight) & (HR >= min_child_weight)
        gain = 0.5 * (GL ** 2 / (HL + reg_lambda)
                      + GR ** 2 / (HR + reg_lambda)
                      - G ** 2 / (H + reg_lambda)) - gamma
        gain = np.where(ok, gain, -np.inf)
        # exclude the last bin (split keeps right side non-empty)
        gain[:, :, -1] = -np.inf
        next_frontier = []
        for nid in frontier:
            i = remap[nid]
            best = np.unravel_index(np.argmax(gain[i]), gain[i].shape)
            if not np.isfinite(gain[i][best]) or gain[i][best] <= 0:
                tree.value[nid] = float(
                    -learning_rate * G[i, 0, 0]
                    / (H[i, 0, 0] + reg_lambda))
                continue
            f, b = int(best[0]), int(best[1])
            lid, rid = tree._new_node(), tree._new_node()
            tree.feature[nid] = f
            tree.threshold_bin[nid] = b
            tree.left[nid] = lid
            tree.right[nid] = rid
            mine = node_of == nid
            goes_left = mine & (xb[:, f] <= b)
            node_of[goes_left] = lid
            node_of[mine & ~goes_left] = rid
            next_frontier.extend([lid, rid])
        frontier = next_frontier
    # nodes still open after the depth budget become leaves
    for nid in frontier:
        mine = node_of == nid
        Gs, Hs = g[mine].sum(), h[mine].sum()
        tree.value[nid] = float(-learning_rate * Gs / (Hs + reg_lambda))
    return tree


class _GBDTBase:
    _is_classifier = False

    def __init__(self, n_estimators: int = 100, max_depth: int = 6,
                 learning_rate: float = 0.3, reg_lambda: float = 1.0,
                 gamma: float = 0.0, min_child_weight: float = 1.0,
                 n_bins: int = 64, random_state: int = 0, **_ignored):
        self.n_estimators = int(n_estimators)
        self.max_depth = int(max_depth)
        self.learning_rate = float(learning_rate)
        self.reg_lambda = float(reg_lambda)
        self.gamma = float(gamma)
        self.min_child_weight = float(min_child_weight)
        self.n_bins = int(n_bins)
        self.random_state = random_state
        self._trees: List[List[_Tree]] = []   # [round][output]
        self._bin_edges: Optional[List[np.ndarray]] = None
        self._n_out = 1
        self._classes: Optional[np.ndarray] = None

    # -- binning -------------------------------------------------------

    def _fit_bins(self, x: np.ndarray):
        self._bin_edges = []
        qs = np.linspace(0, 1, self.n_bins)[1:-1]
        for j in range(x.shape[1]):
            edges = np.unique(np.quantile(x[:, j], qs))
            self._bin_edges.append(edges)

    def _bin(self, x: np.ndarray) -> np.ndarray:
        xb = np.empty(x.shape, np.int64)
        for j, edges in enumerate(self._bin_edges):
            xb[:, j] = np.searchsorted(edges, x[:, j], side="left")
        return np.minimum(xb, self.n_bins - 1)

    # -- boosting ------------------------------------------------------

    def _raw(self, xb: np.ndarray) -> np.ndarray:
        out = np.zeros((len(xb), self._n_out), np.float64)
        for round_trees in self._trees:
            for k, t in enumerate(round_trees):
                out[:, k] += t.predict_binned(xb)
        return out

    def _grad_hess(self, raw: np.ndarray, y: np.ndarray):
        raise NotImplementedError

    def fit(self, x, y, xgb_model: Optional["_GBDTBase"] = None):
        x = np.asarray(x, np.float64)
        y = np.asarray(y)
        if xgb_model is not None:
            # warm-start continuation (xgboost fit(xgb_model=...)):
            # keep the prior trees/binning, add n_estimators new rounds
            self._bin_edges = xgb_model._bin_edges
            self._trees = list(xgb_model._trees)
            self._n_out = xgb_model._n_out
            self._classes = xgb_model._classes
        else:
            self._fit_bins(x)
            self._trees = []
            if self._is_classifier:
                self._classes = np.unique(y)
                self._n_out = (1 if len(self._classes) <= 2
                               else len(self._classes))
            else:
                self._n_out = 1
        if self._is_classifier:
            yi = np.searchsorted(self._classes, y)
        else:
            yi = y.astype(np.float64)
        xb = self._bin(x)
        raw = self._raw(xb)
        for _ in range(self.n_estimators):
            gs, hs = self._grad_hess(raw, yi)
            round_trees = []
            for k in range(self._n_out):
                t = _grow_tree(xb, gs[:, k], hs[:, k], self.n_bins,
                               self.max_depth, self.reg_lambda,
                               self.gamma, self.min_child_weight,
                               self.learning_rate)
                raw[:, k] += t.predict_binned(xb)
                round_trees.append(t)
            self._trees.append(round_trees)
        return self

    def get_booster(self):
        """xgboost-API compatibility: the 'booster' IS the model here
        (warm-start passes it back via fit(xgb_model=...))."""
        return self

    @property
    def n_trees(self) -> int:
        return len(self._trees)


class GBDTRegressor(_GBDTBase):
    """Squared-error objective: g = pred − y, h = 1."""

    def _grad_hess(self, raw, y):
        g = (raw[:, 0] - y)[:, None]
        return g, np.ones_like(g)

    def predict(self, x):
        xb = self._bin(np.asarray(x, np.float64))
        return self._raw(xb)[:, 0]


class GBDTClassifier(_GBDTBase):
    """Logistic (binary) / softmax (multiclass) objective."""

    _is_classifier = True

    def _grad_hess(self, raw, yi):
        if self._n_out == 1:
            p = 1.0 / (1.0 + np.exp(-raw[:, 0]))
            g = (p - yi)[:, None]
            h = (p * (1 - p))[:, None]
            return g, np.maximum(h, 1e-16)
        z = raw - raw.max(axis=1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=1, keepdims=True)
        onehot = np.zeros_like(p)
        onehot[np.arange(len(yi)), yi.astype(int)] = 1.0
        return p - onehot, np.maximum(p * (1 - p), 1e-16)

    def predict_proba(self, x):
        xb = self._bin(np.asarray(x, np.float64))
        raw = self._raw(xb)
        if self._n_out == 1:
            p1 = 1.0 / (1.0 + np.exp(-raw[:, 0]))
            return np.stack([1 - p1, p1], axis=1)
        z = raw - raw.max(axis=1, keepdims=True)
        p = np.exp(z)
        return p / p.sum(axis=1, keepdims=True)

    def predict(self, x):
        p = self.predict_proba(x)
        return self._classes[np.argmax(p, axis=1)]


#: xgboost-named aliases so `xgboost_backend()` is a drop-in namespace
XGBRegressor = GBDTRegressor
XGBClassifier = GBDTClassifier


def xgboost_backend():
    """The xgboost package if installed, else this native module — the
    wrappers (nnframes XGBClassifier/XGBRegressor, AutoXGBoost) call
    whichever comes back through the identical API subset."""
    try:
        import xgboost
        return xgboost
    except ImportError:
        import analytics_zoo_tpu_torch.orca.automl.gbdt as gbdt
        return gbdt
