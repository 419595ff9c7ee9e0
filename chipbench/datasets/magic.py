"""The MAGIC gamma-telescope stand-in: 10 features, 2 classes.

A frozen copy of ``make_magic`` of ``repro_torch/data/datasets.py`` (the
same seed gives the same arrays).  ``draw`` makes fresh rows of the same
distribution: the cluster means, column order and column scales are the
ones ``make_magic()`` drew, replayed from its seed."""
from __future__ import annotations

import functools

import numpy as np

D, C, D_INFORMATIVE, SEP = 10, 2, 8, 1.6


def _rows(rng, n, means, perm=None):
    y = rng.integers(0, C, size=n)
    cl = rng.integers(0, means.shape[1], size=n)
    Xi = means[y, cl] + rng.normal(0, 1.0, size=(n, D_INFORMATIVE))
    Xn = rng.normal(0, 1.0, size=(n, D - D_INFORMATIVE))
    X = np.concatenate([Xi, Xn], axis=1)
    if perm is None:
        perm = rng.permutation(D)
    return X[:, perm], y, perm


def make_magic(n=6000, seed=101):
    """(X_train, y_train, X_test, y_test, (means, perm, scale)): the
    arrays of ``make_magic`` and the distribution they were drawn from."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, SEP, size=(C, 2, D_INFORMATIVE))
    X, y, perm = _rows(rng, n, means)
    scale = rng.uniform(0.5, 50.0, size=(1, D))
    X = X * scale
    idx = rng.permutation(n)
    nt = int(n * 0.2)
    te, tr = idx[:nt], idx[nt:]
    return X[tr], y[tr], X[te], y[te], (means, perm, scale)


@functools.lru_cache(maxsize=1)
def _distribution():
    return make_magic()[4]


def train_rows():
    X, y, _, _, _ = make_magic()
    return X, y


def draw(n: int, rng: np.random.Generator):
    means, perm, scale = _distribution()
    X, y, _ = _rows(rng, n, means, perm)
    return (X * scale).astype(np.float32), y
