"""The MSN learning-to-rank stand-in: 136 standard normal features.

A frozen copy of ``make_msn`` of ``repro_torch/data/datasets.py`` (the
same seed gives the same arrays); traffic rows are fresh draws of the
same distribution."""
from __future__ import annotations

import numpy as np

D = 136


def make_msn(n=8000, seed=106):
    """(X_train, y_train, X_test, y_test), as ``make_msn`` splits them."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, size=(n, D))
    w = rng.normal(0, 1, size=D) * (rng.uniform(size=D) < 0.3)
    score = X @ w + 0.5 * np.sin(X[:, 0] * 2) * X[:, 1]
    qs = np.quantile(score, [0.5, 0.75, 0.9, 0.97])
    y = np.digitize(score, qs).astype(np.float64)
    nt = int(n * 0.2)
    return X[nt:], y[nt:], X[:nt], y[:nt]


def train_rows():
    X, y, _, _ = make_msn()
    return X, y


def draw(n: int, rng: np.random.Generator):
    return rng.standard_normal((n, D), dtype=np.float32), None
