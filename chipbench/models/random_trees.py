"""Forests of full binary trees with random splits and leaves — the
distribution of ``random_forest_ir(..., full=True)`` in the port's
``core/forest.py`` (features uniform over the columns, thresholds and
leaves standard normal, a node of n leaves splitting n // 2 left), drawn
in bulk: every tree shares one shape, so only the draws differ."""
from __future__ import annotations

import numpy as np

from . import canonical
from ..trainer import Node


def _full_tree(n_leaves: int) -> Node:
    if n_leaves == 1:
        return Node(value=np.zeros(1))
    nl = n_leaves // 2
    return Node(feature=0, left=_full_tree(nl),
                right=_full_tree(n_leaves - nl))


def make(cfg: dict) -> dict:
    T, L = cfg["n_trees"], cfg["n_leaves"]
    d, C = cfg["n_features"], cfg["n_classes"]
    shape = canonical([_full_tree(L)], d, 1)
    rng = np.random.default_rng(cfg["seed"])
    N = L - 1
    model = {k: np.repeat(v, T, axis=0) for k, v in shape.items()
             if isinstance(v, np.ndarray) and v.ndim >= 1}
    model.update(max_depth=shape["max_depth"], n_features=np.int64(d),
                 n_classes=np.int64(C))
    model["feature"] = rng.integers(0, d, size=(T, N)).astype(np.int32)
    model["threshold"] = rng.standard_normal((T, N)).astype(np.float32)
    model["leaf_value"] = rng.standard_normal((T, L, C)).astype(np.float32)
    return model
