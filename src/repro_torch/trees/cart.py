"""Histogram-based CART decision-tree trainer (numpy).

The port's own copy of ``repro.trees.cart``: the same config and seed grow
the same trees in both packages. The framework builds its own training
substrate rather than depending on sklearn/xgboost. Trees are grown *leaf-wise* (best-first,
LightGBM style) so ``max_leaves`` — the paper's controlling knob {32, 64} —
is respected exactly.

Two split criteria:
  * ``"gini"``  — multiclass Gini impurity over class-count histograms
                  (Random Forests, paper §6.2/§6.3).
  * ``"mse"``   — variance reduction over gradient/hessian histograms
                  (gradient boosting, paper §6.1 ranking experiment).

Features are pre-binned into ``n_bins`` quantile bins once per dataset
(`Binner`); split search scans cumulative histograms, exactly like
LightGBM/XGBoost-hist.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


# --------------------------------------------------------------------------- #
# Binning
# --------------------------------------------------------------------------- #
@dataclass
class Binner:
    """Per-feature quantile binning. ``edges[f][b]`` is the upper threshold of
    bin ``b``; a sample falls in bin ``b`` iff ``x <= edges[f][b]`` and
    ``x > edges[f][b-1]``."""

    edges: list  # list of (n_edges_f,) float arrays, ascending

    @staticmethod
    def fit(X: np.ndarray, n_bins: int = 64) -> "Binner":
        edges = []
        qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
        for f in range(X.shape[1]):
            e = np.unique(np.quantile(X[:, f], qs))
            edges.append(e.astype(np.float64))
        return Binner(edges)

    def transform(self, X: np.ndarray) -> np.ndarray:
        out = np.empty(X.shape, dtype=np.int16)
        for f, e in enumerate(self.edges):
            out[:, f] = np.searchsorted(e, X[:, f], side="left")
        return out

    def threshold(self, f: int, b: int) -> float:
        """Float threshold realising a split 'bin <= b' as 'x <= t'."""
        return float(self.edges[f][b])

    def n_bins(self, f: int) -> int:
        return len(self.edges[f]) + 1


# --------------------------------------------------------------------------- #
# Tree structure (training form; converted to Forest IR by core.forest)
# --------------------------------------------------------------------------- #
@dataclass
class TreeNode:
    feature: int = -1
    threshold: float = 0.0
    left: Optional["TreeNode"] = None
    right: Optional["TreeNode"] = None
    value: Optional[np.ndarray] = None  # (C,) leaf payload

    @property
    def is_leaf(self) -> bool:
        return self.left is None


@dataclass
class FlatTree:
    """Array form for vectorized traversal. Leaves have feature == -1 and
    left == right == self-index (traversal is a fixed-point after depth
    steps)."""
    feature: np.ndarray    # (n_nodes,) int32
    threshold: np.ndarray  # (n_nodes,) float64
    left: np.ndarray       # (n_nodes,) int32
    right: np.ndarray      # (n_nodes,) int32
    value: np.ndarray      # (n_nodes, C) float64 (zeros at internal nodes)
    depth: int

    def predict(self, X: np.ndarray) -> np.ndarray:
        node = np.zeros(X.shape[0], dtype=np.int32)
        for _ in range(self.depth):
            f = self.feature[node]
            go_left = X[np.arange(X.shape[0]), np.maximum(f, 0)] \
                <= self.threshold[node]
            node = np.where(f < 0, node,
                            np.where(go_left, self.left[node], self.right[node]))
        return self.value[node]


@dataclass
class Tree:
    root: TreeNode
    n_leaves: int
    max_depth_seen: int
    _flat: Optional[FlatTree] = None

    def flat(self) -> FlatTree:
        if self._flat is None:
            self._flat = flatten_tree(self)
        return self._flat

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Ground-truth traversal (vectorized; split rule: left iff x <= t)."""
        return self.flat().predict(X)

    def predict_slow(self, X: np.ndarray) -> np.ndarray:
        """Per-sample pointer-chasing oracle (used by tests to cross-check
        the vectorized path)."""
        out = np.empty((X.shape[0], len(_first_leaf(self.root).value)))
        for i, x in enumerate(X):
            node = self.root
            while not node.is_leaf:
                node = node.left if x[node.feature] <= node.threshold else node.right
            out[i] = node.value
        return out


def flatten_tree(tree: "Tree") -> FlatTree:
    nodes: list[TreeNode] = []

    def collect(nd: TreeNode):
        nodes.append(nd)
        if not nd.is_leaf:
            collect(nd.left)
            collect(nd.right)

    collect(tree.root)
    index = {id(nd): i for i, nd in enumerate(nodes)}
    n = len(nodes)
    C = len(_first_leaf(tree.root).value)
    feature = np.full(n, -1, dtype=np.int32)
    threshold = np.zeros(n)
    left = np.arange(n, dtype=np.int32)
    right = np.arange(n, dtype=np.int32)
    value = np.zeros((n, C))
    for i, nd in enumerate(nodes):
        if nd.is_leaf:
            value[i] = nd.value
        else:
            feature[i] = nd.feature
            threshold[i] = nd.threshold
            left[i] = index[id(nd.left)]
            right[i] = index[id(nd.right)]
    return FlatTree(feature, threshold, left, right, value,
                    depth=max(tree.max_depth_seen, 1))


def _first_leaf(node: TreeNode) -> TreeNode:
    while not node.is_leaf:
        node = node.left
    return node


# --------------------------------------------------------------------------- #
# Histogram accumulation
# --------------------------------------------------------------------------- #
def _class_hist(Xb: np.ndarray, y: np.ndarray, idx: np.ndarray, feats: np.ndarray,
                n_bins: int, n_classes: int) -> np.ndarray:
    """Class-count histogram (len(feats), n_bins, C) for samples ``idx``."""
    sub = Xb[np.ix_(idx, feats)].astype(np.int64)               # (n, F)
    codes = (np.arange(len(feats))[None, :] * n_bins + sub) * n_classes \
        + y[idx][:, None]
    h = np.bincount(codes.ravel(), minlength=len(feats) * n_bins * n_classes)
    return h.reshape(len(feats), n_bins, n_classes).astype(np.float64)


def _grad_hist(Xb: np.ndarray, g: np.ndarray, h: np.ndarray, idx: np.ndarray,
               feats: np.ndarray, n_bins: int) -> np.ndarray:
    """Gradient/hessian/count histogram (len(feats), n_bins, 3)."""
    sub = Xb[np.ix_(idx, feats)].astype(np.int64)
    codes = np.arange(len(feats))[None, :] * n_bins + sub
    flat = codes.ravel()
    size = len(feats) * n_bins
    gs = np.bincount(flat, weights=np.repeat(g[idx], len(feats)), minlength=size)
    hs = np.bincount(flat, weights=np.repeat(h[idx], len(feats)), minlength=size)
    cs = np.bincount(flat, minlength=size)
    return np.stack([gs, hs, cs], axis=-1).reshape(len(feats), n_bins, 3)


# --------------------------------------------------------------------------- #
# Split search
# --------------------------------------------------------------------------- #
def _best_split_gini(hist: np.ndarray, min_leaf: int):
    """hist: (F, B, C) class counts. Returns (gain, f_local, bin) or None."""
    total = hist.sum(axis=1)                                    # (F, C)
    n = total.sum(axis=1)                                       # (F,)
    left = np.cumsum(hist, axis=1)[:, :-1, :]                   # (F, B-1, C)
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


def _best_split_mse(hist: np.ndarray, min_leaf: int, lam: float = 1.0):
    """hist: (F, B, 3) [grad, hess, count]. XGBoost-style gain."""
    gl = np.cumsum(hist[..., 0], axis=1)[:, :-1]
    hl = np.cumsum(hist[..., 1], axis=1)[:, :-1]
    cl = np.cumsum(hist[..., 2], axis=1)[:, :-1]
    gt, ht, ct = hist[..., 0].sum(1), hist[..., 1].sum(1), hist[..., 2].sum(1)
    gr, hr, cr = gt[:, None] - gl, ht[:, None] - hl, ct[:, None] - cl
    gain = gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam) \
        - (gt ** 2 / (ht + lam))[:, None]
    gain[(cl < min_leaf) | (cr < min_leaf)] = -np.inf
    f, b = np.unravel_index(np.argmax(gain), gain.shape)
    g = gain[f, b]
    if not np.isfinite(g) or g <= 1e-12:
        return None
    return float(g), int(f), int(b)


# --------------------------------------------------------------------------- #
# Leaf-wise tree growth
# --------------------------------------------------------------------------- #
@dataclass
class CartConfig:
    max_leaves: int = 32
    max_depth: int = 24
    min_samples_leaf: int = 1
    n_bins: int = 64
    max_features: Optional[float] = None   # fraction; None = all
    criterion: str = "gini"                # "gini" | "mse"
    reg_lambda: float = 1.0
    leaf_lr: float = 1.0                   # shrinkage applied to mse leaves


def grow_tree(Xb: np.ndarray, binner: Binner, cfg: CartConfig,
              rng: np.random.Generator,
              y: Optional[np.ndarray] = None,        # int labels (gini)
              n_classes: int = 2,
              grad: Optional[np.ndarray] = None,     # (n,) or (n, C) (mse)
              hess: Optional[np.ndarray] = None) -> Tree:
    n, d = Xb.shape
    n_bins = cfg.n_bins + 1  # searchsorted can emit bin == n_edges
    if cfg.max_features is None:
        n_feats = d
    else:
        n_feats = max(1, int(round(cfg.max_features * d)))

    multi_grad = grad is not None and grad.ndim == 2
    if grad is not None and hess is None:
        hess = np.ones(n)

    def leaf_value(idx: np.ndarray) -> np.ndarray:
        if cfg.criterion == "gini":
            cnt = np.bincount(y[idx], minlength=n_classes).astype(np.float64)
            return cnt / max(cnt.sum(), 1.0)
        if multi_grad:
            gs = grad[idx].sum(0)
            hs = hess[idx].sum() + cfg.reg_lambda
            return cfg.leaf_lr * (-gs / hs)
        gs, hs = grad[idx].sum(), hess[idx].sum() + cfg.reg_lambda
        return np.array([cfg.leaf_lr * (-gs / hs)])

    def find_split(idx: np.ndarray):
        feats = (rng.choice(d, size=n_feats, replace=False)
                 if n_feats < d else np.arange(d))
        if cfg.criterion == "gini":
            hist = _class_hist(Xb, y, idx, feats, n_bins, n_classes)
            res = _best_split_gini(hist, cfg.min_samples_leaf)
        else:
            g1 = grad.sum(axis=1) if multi_grad else grad
            hist = _grad_hist(Xb, g1, hess, idx, feats, n_bins)
            res = _best_split_mse(hist, cfg.min_samples_leaf, cfg.reg_lambda)
        if res is None:
            return None
        gain, f_local, b = res
        f = int(feats[f_local])
        if b >= len(binner.edges[f]):   # split beyond last edge → useless
            return None
        return gain, f, b

    root = TreeNode(value=leaf_value(np.arange(n)))
    heap = []
    tiebreak = itertools.count(1)   # FIFO among equal gains
    depth_of = {id(root): 0}

    def push(node: TreeNode, idx: np.ndarray):
        if len(idx) < 2 * cfg.min_samples_leaf or depth_of[id(node)] >= cfg.max_depth:
            return
        s = find_split(idx)
        if s is None:
            return
        gain, f, b = s
        heapq.heappush(heap, (-gain, next(tiebreak), node, idx, f, b))

    push(root, np.arange(n))
    n_leaves, max_depth_seen = 1, 0
    while heap and n_leaves < cfg.max_leaves:
        _, _, node, idx, f, b = heapq.heappop(heap)
        go_left = Xb[idx, f] <= b
        li, ri = idx[go_left], idx[~go_left]
        if len(li) == 0 or len(ri) == 0:
            continue
        node.feature, node.threshold = f, binner.threshold(f, b)
        node.left = TreeNode(value=leaf_value(li))
        node.right = TreeNode(value=leaf_value(ri))
        node.value = None
        dep = depth_of[id(node)] + 1
        depth_of[id(node.left)] = depth_of[id(node.right)] = dep
        max_depth_seen = max(max_depth_seen, dep)
        n_leaves += 1
        push(node.left, li)
        push(node.right, ri)
    return Tree(root, n_leaves, max_depth_seen)
