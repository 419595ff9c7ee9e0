"""Random-forest trainer: a frozen copy of the port's histogram CART
(``repro_torch/trees/cart.py``, Gini criterion only) and bagging
(``repro_torch/trees/random_forest.py``).  The same configuration and
seed grow the same trees.

Trees are grown leaf-wise (best first) so ``max_leaves`` holds exactly;
leaves carry class-probability vectors scaled by 1/M, so the forest's
vote is a plain sum."""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Binner:
    """Per-feature quantile bins; bin ``b`` of feature ``f`` holds
    ``edges[f][b-1] < x <= edges[f][b]``."""
    edges: list

    @staticmethod
    def fit(X: np.ndarray, n_bins: int) -> "Binner":
        qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
        return Binner([np.unique(np.quantile(X[:, f], qs)).astype(np.float64)
                       for f in range(X.shape[1])])

    def transform(self, X: np.ndarray) -> np.ndarray:
        out = np.empty(X.shape, dtype=np.int16)
        for f, e in enumerate(self.edges):
            out[:, f] = np.searchsorted(e, X[:, f], side="left")
        return out


@dataclass
class Node:
    feature: int = -1
    threshold: float = 0.0
    left: Optional["Node"] = None
    right: Optional["Node"] = None
    value: Optional[np.ndarray] = None   # (C,) at a leaf

    @property
    def is_leaf(self) -> bool:
        return self.left is None


def _class_hist(Xb, y, idx, feats, n_bins, n_classes):
    sub = Xb[np.ix_(idx, feats)].astype(np.int64)
    codes = (np.arange(len(feats))[None, :] * n_bins + sub) * n_classes \
        + y[idx][:, None]
    h = np.bincount(codes.ravel(), minlength=len(feats) * n_bins * n_classes)
    return h.reshape(len(feats), n_bins, n_classes).astype(np.float64)


def _best_split_gini(hist, min_leaf):
    total = hist.sum(axis=1)
    n = total.sum(axis=1)
    left = np.cumsum(hist, axis=1)[:, :-1, :]
    nl = left.sum(axis=2)
    nr = n[:, None] - nl
    right = total[:, None, :] - left
    with np.errstate(divide="ignore", invalid="ignore"):
        gini_l = 1.0 - (left ** 2).sum(2) / np.maximum(nl, 1) ** 2
        gini_r = 1.0 - (right ** 2).sum(2) / np.maximum(nr, 1) ** 2
        gini_p = 1.0 - (total ** 2).sum(1) / np.maximum(n, 1) ** 2
    impurity = (nl * gini_l + nr * gini_r) / np.maximum(n[:, None], 1)
    gain = gini_p[:, None] - impurity
    gain[(nl < min_leaf) | (nr < min_leaf)] = -np.inf
    f, b = np.unravel_index(np.argmax(gain), gain.shape)
    g = gain[f, b]
    if not np.isfinite(g) or g <= 1e-12:
        return None
    return float(g), int(f), int(b)


def grow_tree(Xb, y, binner: Binner, rng, *, n_classes: int,
              max_leaves: int, max_depth: int, min_samples_leaf: int,
              n_bins: int, max_features: float) -> Node:
    n, d = Xb.shape
    n_bins = n_bins + 1            # searchsorted can emit bin == n_edges
    n_feats = max(1, int(round(max_features * d)))

    def leaf_value(idx):
        cnt = np.bincount(y[idx], minlength=n_classes).astype(np.float64)
        return cnt / max(cnt.sum(), 1.0)

    def find_split(idx):
        feats = (rng.choice(d, size=n_feats, replace=False)
                 if n_feats < d else np.arange(d))
        res = _best_split_gini(
            _class_hist(Xb, y, idx, feats, n_bins, n_classes),
            min_samples_leaf)
        if res is None:
            return None
        gain, f_local, b = res
        f = int(feats[f_local])
        if b >= len(binner.edges[f]):
            return None
        return gain, f, b

    root = Node(value=leaf_value(np.arange(n)))
    heap, tiebreak, depth_of = [], itertools.count(1), {id(root): 0}

    def push(node, idx):
        if len(idx) < 2 * min_samples_leaf or depth_of[id(node)] >= max_depth:
            return
        s = find_split(idx)
        if s is not None:
            gain, f, b = s
            heapq.heappush(heap, (-gain, next(tiebreak), node, idx, f, b))

    push(root, np.arange(n))
    n_leaves = 1
    while heap and n_leaves < max_leaves:
        _, _, node, idx, f, b = heapq.heappop(heap)
        go_left = Xb[idx, f] <= b
        li, ri = idx[go_left], idx[~go_left]
        if len(li) == 0 or len(ri) == 0:
            continue
        node.feature, node.threshold = f, float(binner.edges[f][b])
        node.left, node.right = Node(value=leaf_value(li)), \
            Node(value=leaf_value(ri))
        node.value = None
        depth_of[id(node.left)] = depth_of[id(node.right)] = \
            depth_of[id(node)] + 1
        n_leaves += 1
        push(node.left, li)
        push(node.right, ri)
    return root


def random_forest(X, y, *, n_trees: int, max_leaves: int, seed: int,
                  max_depth: int = 24, min_samples_leaf: int = 1,
                  n_bins: int = 64) -> tuple[list, int]:
    """Bagged Gini trees, as ``RandomForest(RandomForestConfig(...)).fit``
    grows them (``max_features``: all for d <= 32, else sqrt(d)/d).
    Returns (roots, n_classes)."""
    n, d = X.shape
    n_classes = int(y.max()) + 1
    binner = Binner.fit(X, n_bins)
    Xb = binner.transform(X)
    max_features = min(1.0, np.sqrt(d) / d) if d > 32 else 1.0
    rng = np.random.default_rng(seed)
    roots = []
    for _ in range(n_trees):
        idx = rng.integers(0, n, size=n)
        root = grow_tree(Xb[idx], y[idx], binner, rng, n_classes=n_classes,
                         max_leaves=max_leaves, max_depth=max_depth,
                         min_samples_leaf=min_samples_leaf, n_bins=n_bins,
                         max_features=max_features)
        _scale_leaves(root, 1.0 / n_trees)
        roots.append(root)
    return roots, n_classes


def _scale_leaves(node: Node, s: float) -> None:
    if node.is_leaf:
        node.value = node.value * s
    else:
        _scale_leaves(node.left, s)
        _scale_leaves(node.right, s)
