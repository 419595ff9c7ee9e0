"""A tiny 10-class fused cascade over 784 8-bit pixels, as the mnist cell
runs it, on the CPU: the card path's glue (``InputGrid`` with the plain
versions) against the benchmark's plain reference (``chipbench/
reference``: NumPy float64 quantization, a plain torch walk, its own
margin gate), against the host's ``quantize_inputs`` and against the
host path of the same predictor."""
import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.kernels import ops

from chipbench import datasets, program, reference
from chipbench.models import random_forest

CPU = torch.device("cpu")
CFG = {"model": "random_forest", "dataset": "mnist", "n_trees": 16,
       "max_leaves": 16, "n_bins": 64, "n_features": 784, "n_classes": 10,
       "seed": 0, "quant": {"bits": 16, "int_accum": True},
       "engine": "bitvector", "backend": "cuda",
       "cascade": {"stages": [4, 8, 16], "gate": "margin",
                   "thresholds": [0.5, 0.7, 0.9], "floor_pp": 0.5,
                   "calibration_rows": 1000, "calibration_seed": 8}}


@pytest.fixture(scope="module")
def cascade():
    """(model file, uint8 training rows, fused predictor on the card
    path's glue, the same on the host path)."""
    model = random_forest.make(CFG)
    train, _ = datasets.load("mnist").train_rows()
    card, _ = program.build(model, CFG, train, "cpu")
    card._grid = ops.InputGrid(card.forest, CPU)
    host, _ = program.build(model, CFG, train, "cpu")
    assert host._grid is None and card._use_kernel
    return model, train, card, host


@pytest.mark.parametrize("n", [1, 300, 1025])
def test_pixel_rows_match_the_plain_reference(cascade, n):
    model, train, card, host = cascade
    X, _ = datasets.load("mnist").draw(n, np.random.default_rng(n))
    assert X.dtype == np.uint8
    q = reference.quantize_model(model, train, 16)
    sums, exit_stage, _ = reference.cascade(
        q, q.rows(X), CFG["cascade"]["stages"], float(model["gate_threshold"]))
    got = card.predict(X)
    np.testing.assert_array_equal(got, q.descale(sums))
    np.testing.assert_array_equal(card.last_exit_counts,
                                  np.bincount(exit_stage, minlength=3))
    np.testing.assert_array_equal(host.predict(X), got)
    np.testing.assert_array_equal(host.last_exit_counts,
                                  card.last_exit_counts)


def test_the_gate_splits_pixel_rows(cascade):
    """The calibrated gate lets some rows out early and keeps others to
    the last stage, so both sides of it are checked above."""
    model, train, card, _ = cascade
    assert np.isfinite(model["gate_threshold"])
    X, _ = datasets.load("mnist").draw(1025, np.random.default_rng(1025))
    card.predict(X)
    counts = card.last_exit_counts
    assert 0 < counts[:-1].sum() and counts[-1] > 0


@pytest.mark.parametrize("layout", ["rows", "column-slice"])
def test_pixel_feed_is_the_hosts_quantize_inputs(cascade, layout):
    """The bucket the grid writes from uint8 rows is ``quantize_inputs``
    as f32 bit for bit, zero past the rows, and the reference's grid."""
    model, train, card, _ = cascade
    X, _ = datasets.load("mnist").draw(700, np.random.default_rng(3))
    X[0], X[1] = 0, 255
    if layout == "column-slice":
        X = np.asfortranarray(np.concatenate([X, X[:5]]))[:700]
    feed = card._grid.feed(X, 1024)
    assert feed.n == 700
    want = np.zeros((1024, 784), dtype=np.float32)
    want[:700] = core.quantize_inputs(card.forest, X).astype(np.float32)
    np.testing.assert_array_equal(feed.x.numpy().view(np.uint32),
                                  want.view(np.uint32))
    q = reference.quantize_model(model, train, 16)
    np.testing.assert_array_equal(want[:700], q.rows(X).astype(np.float32))
