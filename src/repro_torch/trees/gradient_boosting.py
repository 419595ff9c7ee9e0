"""Gradient-boosted trees (paper §6.1: XGBoost GBTs on the MSN ranking set).

Second-order boosting on histogram CART trees:
  * ``objective="l2"``       — squared error (ranking-by-regression, as the
                               paper's throughput experiment requires: it
                               measures traversal speed, not NDCG).
  * ``objective="logistic"`` — binary log-loss.
  * ``objective="softmax"``  — multiclass: one scalar tree per class per
                               round, embedded as C-dim leaves downstream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .cart import Binner, CartConfig, Tree, grow_tree


@dataclass
class GradientBoostingConfig:
    n_trees: int = 100                 # total trees (softmax: rounds = n/C)
    max_leaves: int = 32
    max_depth: int = 24
    min_samples_leaf: int = 1
    n_bins: int = 64
    learning_rate: float = 0.1
    objective: str = "l2"
    reg_lambda: float = 1.0
    subsample: Optional[int] = None
    seed: int = 0


class GradientBoosting:
    def __init__(self, cfg: GradientBoostingConfig):
        self.cfg = cfg
        self.trees: list[Tree] = []
        self.tree_class: list[int] = []    # which class each tree scores (-1 = scalar)
        self.binner: Optional[Binner] = None
        self.n_classes = 1
        self.base_score = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GradientBoosting":
        cfg = self.cfg
        n = X.shape[0]
        self.binner = Binner.fit(X, cfg.n_bins)
        Xb = self.binner.transform(X)
        rng = np.random.default_rng(cfg.seed)
        tree_cfg = CartConfig(
            max_leaves=cfg.max_leaves, max_depth=cfg.max_depth,
            min_samples_leaf=cfg.min_samples_leaf, n_bins=cfg.n_bins,
            criterion="mse", reg_lambda=cfg.reg_lambda,
            leaf_lr=cfg.learning_rate)

        if cfg.objective == "softmax":
            self.n_classes = int(y.max()) + 1
            F = np.zeros((n, self.n_classes))
            rounds = max(1, cfg.n_trees // self.n_classes)
            for _ in range(rounds):
                p = _softmax(F)
                for c in range(self.n_classes):
                    g = p[:, c] - (y == c)
                    h = np.maximum(p[:, c] * (1 - p[:, c]), 1e-6)
                    t = self._fit_one(Xb, tree_cfg, rng, g, h)
                    self.trees.append(t)
                    self.tree_class.append(c)
                    F[:, c] += t.predict(self._raw(Xb))[:, 0]
            return self

        y = y.astype(np.float64)
        if cfg.objective == "logistic":
            self.base_score = 0.0
            F = np.zeros(n)
            for _ in range(cfg.n_trees):
                p = 1.0 / (1.0 + np.exp(-F))
                g, h = p - y, np.maximum(p * (1 - p), 1e-6)
                t = self._fit_one(Xb, tree_cfg, rng, g, h)
                self.trees.append(t)
                self.tree_class.append(-1)
                F += t.predict(self._raw(Xb))[:, 0]
        else:  # l2
            self.base_score = float(y.mean())
            F = np.full(n, self.base_score)
            for _ in range(cfg.n_trees):
                g = F - y
                t = self._fit_one(Xb, tree_cfg, rng, g, np.ones(n))
                self.trees.append(t)
                self.tree_class.append(-1)
                F += t.predict(self._raw(Xb))[:, 0]
        return self

    def _fit_one(self, Xb, tree_cfg, rng, g, h) -> Tree:
        n = Xb.shape[0]
        if self.cfg.subsample and self.cfg.subsample < n:
            idx = rng.choice(n, size=self.cfg.subsample, replace=False)
            return grow_tree(Xb[idx], self.binner, tree_cfg, rng,
                             grad=g[idx], hess=h[idx])
        return grow_tree(Xb, self.binner, tree_cfg, rng, grad=g, hess=h)

    def _raw(self, Xb: np.ndarray) -> np.ndarray:
        """Trees store float thresholds; re-inflate binned X to floats that
        land on the same side of every edge (use the edge value itself)."""
        out = np.empty(Xb.shape)
        for f, e in enumerate(self.binner.edges):
            ext = np.concatenate([e, [e[-1] + 1.0 if len(e) else 1.0]])
            out[:, f] = ext[np.minimum(Xb[:, f], len(ext) - 1)]
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.cfg.objective == "softmax":
            out = np.zeros((X.shape[0], self.n_classes))
            for t, c in zip(self.trees, self.tree_class):
                out[:, c] += t.predict(X)[:, 0]
            return out
        out = np.full(X.shape[0], self.base_score)
        for t in self.trees:
            out += t.predict(X)[:, 0]
        return out


def _softmax(F: np.ndarray) -> np.ndarray:
    z = F - F.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)
