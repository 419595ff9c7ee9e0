"""Synthetic stand-ins for the paper's datasets (the port's copy of
``repro.data.datasets``: the same seed gives the same arrays).

Nothing is downloaded: Magic/Adult/EEG/MNIST/Fashion/MSN are generated
in-repo. Each generator is deterministic and matches its dataset's
*signature* — (n_features, n_classes, scale, feature character) — so that the
paper's measured quantities (traversal throughput, which depends only on
forest/feature shapes, and quantization *deltas*, which depend on threshold
geometry) are reproducible:

  * ``adult``   — predominantly one-hot/binary features (108 dims), like the
                  categorical-encoded census set → extreme node-merging rates
                  (paper Table 4: 6% unique nodes).
  * ``eeg``     — 14 continuous channels with heavy-tailed outliers: min-max
                  scaling compresses the bulk of thresholds into a narrow
                  band, reproducing the paper's EEG quantization collapse
                  (Table 4: unique nodes halve; Table 3: accuracy drops).
  * ``magic``   — 10 smooth continuous features.
  * ``mnist``/``fashion`` — 784 bounded pixel-like dims, class templates.
  * ``msn``     — 136-dim learning-to-rank regression targets (0..4).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Dataset:
    name: str
    X_train: np.ndarray
    y_train: np.ndarray
    X_test: np.ndarray
    y_test: np.ndarray
    n_classes: int          # 1 → regression/ranking

    @property
    def n_features(self) -> int:
        return self.X_train.shape[1]


def _cluster_classify(rng, n, d, n_classes, d_informative, sep=2.0,
                      clusters_per_class=2):
    means = rng.normal(0, sep, size=(n_classes, clusters_per_class, d_informative))
    y = rng.integers(0, n_classes, size=n)
    cl = rng.integers(0, clusters_per_class, size=n)
    Xi = means[y, cl] + rng.normal(0, 1.0, size=(n, d_informative))
    if d > d_informative:
        Xn = rng.normal(0, 1.0, size=(n, d - d_informative))
        X = np.concatenate([Xi, Xn], axis=1)
    else:
        X = Xi
    perm = rng.permutation(d)
    return X[:, perm], y


def _split(X, y, test_frac, rng):
    n = X.shape[0]
    idx = rng.permutation(n)
    nt = int(n * test_frac)
    te, tr = idx[:nt], idx[nt:]
    return X[tr], y[tr], X[te], y[te]


def make_magic(n=6000, seed=101) -> Dataset:
    rng = np.random.default_rng(seed)
    X, y = _cluster_classify(rng, n, d=10, n_classes=2, d_informative=8, sep=1.6)
    X = X * rng.uniform(0.5, 50.0, size=(1, 10))      # heterogeneous scales
    return Dataset("magic", *_split(X, y, 0.2, rng), 2)


def make_adult(n=6000, seed=102) -> Dataset:
    rng = np.random.default_rng(seed)
    d_cont, d_bin = 8, 100
    Xc, y = _cluster_classify(rng, n, d=d_cont, n_classes=2, d_informative=6, sep=1.4)
    # one-hot style binary block, weakly class-correlated
    logits = rng.normal(0, 1.0, size=(2, d_bin))
    p = 1 / (1 + np.exp(-logits[y]))
    Xb = (rng.uniform(size=(n, d_bin)) < p).astype(np.float64)
    X = np.concatenate([Xc, Xb], axis=1)
    return Dataset("adult", *_split(X, y, 0.2, rng), 2)


def make_eeg(n=6000, seed=103) -> Dataset:
    rng = np.random.default_rng(seed)
    X, y = _cluster_classify(rng, n, d=14, n_classes=2, d_informative=10, sep=1.2)
    X = X * 0.02 + 4.3                                # tight physiological band
    out = rng.uniform(size=X.shape) < 0.002           # rare huge artifacts
    # artifact magnitude tuned so min-max scaling leaves the physiological
    # bulk ~20 fixed-point levels — the paper's EEG regime: split
    # quantization costs points (Table 3) and collapses unique thresholds
    # (Table 4) while leaf quantization stays free
    X = np.where(out, X * rng.uniform(30, 90, size=X.shape), X)
    return Dataset("eeg", *_split(X, y, 0.2, rng), 2)


def _make_image_like(name, n, seed, n_classes=10, d=784) -> Dataset:
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(d))
    templates = np.zeros((n_classes, side, side))
    for c in range(n_classes):
        for _ in range(6):                            # blobs per class
            cx, cy = rng.uniform(4, side - 4, size=2)
            sx, sy = rng.uniform(1.5, 4.0, size=2)
            gx = np.exp(-((np.arange(side) - cx) ** 2) / (2 * sx ** 2))
            gy = np.exp(-((np.arange(side) - cy) ** 2) / (2 * sy ** 2))
            templates[c] += np.outer(gy, gx)
    templates = templates.reshape(n_classes, d)
    templates /= templates.max(axis=1, keepdims=True) + 1e-9
    y = rng.integers(0, n_classes, size=n)
    X = templates[y] * rng.uniform(0.6, 1.0, size=(n, 1)) \
        + rng.normal(0, 0.18, size=(n, d))
    X = np.clip(X, 0.0, 1.0)
    nt = int(n * 0.2)
    return Dataset(name, X[nt:], y[nt:], X[:nt], y[:nt], n_classes)


def make_mnist(n=8000, seed=104) -> Dataset:
    return _make_image_like("mnist", n, seed)


def make_fashion(n=8000, seed=105) -> Dataset:
    return _make_image_like("fashion", n, seed, n_classes=10)


def make_msn(n=8000, seed=106) -> Dataset:
    """Learning-to-rank stand-in: 136 features, graded relevance 0..4,
    regression target (the paper's Table 2 measures traversal runtime)."""
    rng = np.random.default_rng(seed)
    d = 136
    X = rng.normal(0, 1, size=(n, d))
    w = rng.normal(0, 1, size=d) * (rng.uniform(size=d) < 0.3)
    score = X @ w + 0.5 * np.sin(X[:, 0] * 2) * X[:, 1]
    qs = np.quantile(score, [0.5, 0.75, 0.9, 0.97])
    y = np.digitize(score, qs).astype(np.float64)
    nt = int(n * 0.2)
    return Dataset("msn", X[nt:], y[nt:], X[:nt], y[:nt], 1)


REGISTRY = {
    "magic": make_magic,
    "adult": make_adult,
    "eeg": make_eeg,
    "mnist": make_mnist,
    "fashion": make_fashion,
    "msn": make_msn,
}

_CACHE: dict = {}


def load(name: str, **kw) -> Dataset:
    key = (name, tuple(sorted(kw.items())))
    if key not in _CACHE:
        _CACHE[key] = REGISTRY[name](**kw)
    return _CACHE[key]
