"""Random Forest trainer (paper §6.2/§6.3: 1024 trees, {32, 64} leaves).

Bagging + feature subsampling over histogram CART trees. Leaf payloads are
class-probability vectors already scaled by ``w_i = 1/M`` (paper §2: weights
are folded into the leaves during preprocessing so the ensemble vote is a
plain sum).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from .cart import Binner, CartConfig, Tree, grow_tree


@dataclass
class RandomForestConfig:
    n_trees: int = 128
    max_leaves: int = 32
    max_depth: int = 24
    min_samples_leaf: int = 1
    n_bins: int = 64
    max_features: Optional[float] = None   # None → sqrt(d)/d heuristic
    max_samples: Optional[int] = None      # bootstrap subsample cap
    seed: int = 0


class RandomForest:
    def __init__(self, cfg: RandomForestConfig):
        self.cfg = cfg
        self.trees: list[Tree] = []
        self.binner: Optional[Binner] = None
        self.n_classes = 0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForest":
        cfg = self.cfg
        n, d = X.shape
        self.n_classes = int(y.max()) + 1
        self.binner = Binner.fit(X, cfg.n_bins)
        Xb = self.binner.transform(X)
        max_features = cfg.max_features
        if max_features is None:
            max_features = min(1.0, np.sqrt(d) / d) if d > 32 else 1.0
        tree_cfg = CartConfig(
            max_leaves=cfg.max_leaves, max_depth=cfg.max_depth,
            min_samples_leaf=cfg.min_samples_leaf, n_bins=cfg.n_bins,
            max_features=max_features, criterion="gini")
        rng = np.random.default_rng(cfg.seed)
        n_boot = min(n, cfg.max_samples) if cfg.max_samples else n
        self.trees = []
        for _ in range(cfg.n_trees):
            idx = rng.integers(0, n, size=n_boot)
            t = grow_tree(Xb[idx], self.binner, tree_cfg, rng,
                          y=y[idx], n_classes=self.n_classes)
            # fold 1/M into the leaves (paper §2)
            _scale_leaves(t.root, 1.0 / cfg.n_trees)
            self.trees.append(t)
        return self

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        out = np.zeros((X.shape[0], self.n_classes))
        for t in self.trees:
            out += t.predict(X)
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.predict_proba(X).argmax(axis=1)


def _scale_leaves(node, s: float) -> None:
    if node.is_leaf:
        node.value = node.value * s
    else:
        _scale_leaves(node.left, s)
        _scale_leaves(node.right, s)
