"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see the real
single-CPU device (the 512-device trick is dryrun.py-only)."""
import numpy as np
import pytest

from repro import core
from repro.data import datasets


@pytest.fixture(scope="session")
def small_forest():
    """8 trees × 16 leaves × 6 features, scalar output."""
    return core.random_forest_ir(n_trees=8, n_leaves=16, n_features=6,
                                 n_classes=1, seed=0)


@pytest.fixture(scope="session")
def class_forest():
    """Multiclass forest (C=3), unbalanced trees."""
    return core.random_forest_ir(n_trees=12, n_leaves=32, n_features=10,
                                 n_classes=3, seed=1, full=False)


@pytest.fixture(scope="session")
def big_leaf_forest():
    """L=64 → 2 leafidx words (exercises multi-word exit-leaf search)."""
    return core.random_forest_ir(n_trees=6, n_leaves=64, n_features=8,
                                 n_classes=2, seed=2, full=False)


@pytest.fixture(scope="session")
def magic_ds():
    return datasets.load("magic", n=2000)


@pytest.fixture(scope="session")
def trained_rf(magic_ds):
    from repro.trees.random_forest import RandomForest, RandomForestConfig
    return RandomForest(RandomForestConfig(n_trees=32, max_leaves=16,
                                           seed=0)).fit(
        magic_ds.X_train, magic_ds.y_train)


def rand_X(forest, B=64, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1.2, size=(B, forest.n_features))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit; the "
        "test skips without them (run with `-m cuda` on the card)")
