"""The MNIST cell's own pieces on the CPU: the frozen stand-in against the
program's ``make_mnist`` at 8 bits, its fresh draws, and the planted
faults and the control of ``test_chipbench_run`` on its 10 classes."""
import numpy as np
import pytest

from repro_torch.data import datasets as program_datasets

from chipbench import datasets
from chipbench.tests.test_chipbench_run import (
    FAULTS, test_control_at_fewer_bits_is_not_correct as control_fails,
    test_planted_fault_is_not_correct as planted_fault_fails)

CELL = "mnist_rf_512x64_cascade.bulk"
mnist = datasets.load("mnist")


def test_frozen_mnist_is_the_programs_at_8_bits():
    ours = mnist.make_mnist()
    theirs = program_datasets.make_mnist()
    for a, b in zip(ours[:4], (theirs.X_train, theirs.y_train, theirs.X_test,
                               theirs.y_test)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[4], mnist._distribution())
    X, y = mnist.train_rows()
    assert X.dtype == np.uint8 and X.shape == (6400, 784)
    np.testing.assert_array_equal(
        X, np.round(255.0 * theirs.X_train).astype(np.uint8))
    np.testing.assert_array_equal(y, theirs.y_train)


def test_mnist_draws_keep_the_class_means():
    """Fresh rows come from make_mnist's own templates: each class's mean
    pixel is the training rows' within the draws' noise, and every row
    lies nearest its own class's mean."""
    X, y = mnist.draw(5000, np.random.default_rng(7))
    assert X.dtype == np.uint8 and X.shape == (5000, 784)
    assert set(np.unique(y)) == set(range(10))
    train, labels = mnist.train_rows()
    means = np.stack([train[labels == c].mean(0) for c in range(10)])
    drawn = np.stack([X[y == c].mean(0) for c in range(10)])
    assert np.abs(means - drawn).mean() < 3.0      # of 255
    assert np.abs(means - drawn).max() < 16.0
    dist = ((X[:, None, :] - means[None].astype(np.float32)) ** 2).sum(-1)
    assert (dist.argmin(1) == y).mean() > 0.99
    again, _ = mnist.draw(5000, np.random.default_rng(7))
    np.testing.assert_array_equal(again, X)


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["exit_altered"])
def test_planted_fault_is_not_correct_on_10_classes(tiny, monkeypatch,
                                                    fault):
    planted_fault_fails(tiny, monkeypatch, CELL, fault)


def test_control_at_fewer_bits_is_not_correct_on_10_classes(tiny):
    control_fails(tiny, CELL)
