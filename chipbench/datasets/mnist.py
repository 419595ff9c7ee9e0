"""The MNIST stand-in: 28 × 28 8-bit pixels (784 features), 10 classes.

A frozen copy of ``make_mnist`` of ``repro_torch/data/datasets.py`` (the
same seed gives the same arrays), its pixels in [0, 1] stored as a
scanner or a form reader hands them on: ``uint8``, ``round(255 x)``.
``draw`` makes fresh rows of the same distribution: the class templates
are the ones ``make_mnist()`` drew, replayed from its seed."""
from __future__ import annotations

import functools

import numpy as np

SIDE, C = 28, 10
D = SIDE * SIDE
BLOCK = 8192                    # rows drawn at a time: bounds the float64 work


def _templates(rng) -> np.ndarray:
    """(C, D) class templates in [0, 1]: six Gaussian blobs a class."""
    templates = np.zeros((C, SIDE, SIDE))
    for c in range(C):
        for _ in range(6):
            cx, cy = rng.uniform(4, SIDE - 4, size=2)
            sx, sy = rng.uniform(1.5, 4.0, size=2)
            gx = np.exp(-((np.arange(SIDE) - cx) ** 2) / (2 * sx ** 2))
            gy = np.exp(-((np.arange(SIDE) - cy) ** 2) / (2 * sy ** 2))
            templates[c] += np.outer(gy, gx)
    templates = templates.reshape(C, D)
    templates /= templates.max(axis=1, keepdims=True) + 1e-9
    return templates


def pixels(X: np.ndarray) -> np.ndarray:
    """Values in [0, 1] → 8-bit pixels."""
    return np.round(255.0 * X).astype(np.uint8)


def make_mnist(n=8000, seed=104):
    """(X_train, y_train, X_test, y_test, templates): the float arrays of
    ``make_mnist`` and the templates they were drawn from."""
    rng = np.random.default_rng(seed)
    templates = _templates(rng)
    y = rng.integers(0, C, size=n)
    X = templates[y] * rng.uniform(0.6, 1.0, size=(n, 1)) \
        + rng.normal(0, 0.18, size=(n, D))
    X = np.clip(X, 0.0, 1.0)
    nt = int(n * 0.2)
    return X[nt:], y[nt:], X[:nt], y[:nt], templates


@functools.lru_cache(maxsize=1)
def _distribution() -> np.ndarray:
    return _templates(np.random.default_rng(104))


def train_rows():
    X, y, _, _, _ = make_mnist()
    return pixels(X), y


def draw(n: int, rng: np.random.Generator):
    """n fresh rows as uint8 pixels, and their labels."""
    templates = _distribution()
    y = rng.integers(0, C, size=n)
    amp = rng.uniform(0.6, 1.0, size=(n, 1))
    X = np.empty((n, D), dtype=np.uint8)
    for a in range(0, n, BLOCK):
        b = min(n, a + BLOCK)
        noise = rng.normal(0, 0.18, size=(b - a, D))
        X[a:b] = pixels(np.clip(templates[y[a:b]] * amp[a:b] + noise,
                                0.0, 1.0))
    return X, y
