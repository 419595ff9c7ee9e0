"""Forest IR analysis shared by RapidScorer and the optimizer — the
port's copy of ``repro.optim.analysis`` (numpy only).

``unique_splits`` is RapidScorer's equivalent-node merging (Ye et al.
2018) in general form: the ensemble-wide table of unique
(feature, threshold) pairs plus the node → unique-id inverse map.
``core/rapidscorer.merge_nodes`` delegates here.

This module imports nothing from ``repro_torch.core``: ``core``'s package
init imports ``rapidscorer``, which resolves ``unique_splits`` from here,
so an import in the other direction would cycle.  Forests are duck-typed
(only ``feature`` / ``threshold`` / ``n_nodes`` are read).
"""
from __future__ import annotations

import numpy as np


def unique_splits(forest):
    """Unique (feature, threshold) table + inverse map over the ensemble.

    Returns ``(u_feat (U,) int32, u_thr (U,), inv (T, N) int32,
    n_unique)``.  Padding nodes map to unique id 0 but are masked out by
    ``valid`` downstream; the key is bit-exact (float thresholds compared
    by bit pattern, so ``-0.0`` and ``+0.0`` count as distinct)."""
    T, N = forest.feature.shape
    valid = (forest.feature >= 0).ravel()
    feat = np.maximum(forest.feature, 0).ravel()
    thr = forest.threshold.ravel()
    key = np.stack([feat.astype(np.int64),
                    thr.astype(np.float64).view(np.int64)], axis=1)
    key[~valid] = np.array([-1, 0])
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    n_pad = int((uniq[:, 0] == -1).any())
    u_feat = np.maximum(uniq[:, 0], 0).astype(np.int32)
    u_thr = uniq[:, 1].view(np.float64).astype(forest.threshold.dtype)
    return u_feat, u_thr, inv.reshape(T, N).astype(np.int32), len(uniq) - n_pad


def n_unique_splits(forest) -> int:
    """Just the unique-(feature, threshold) count."""
    *_, n = unique_splits(forest)
    return n


def unique_fraction(forest) -> float:
    """Fraction of unique nodes kept after merging (paper Table 4)."""
    total = int(forest.n_nodes.sum())
    return n_unique_splits(forest) / max(total, 1)
