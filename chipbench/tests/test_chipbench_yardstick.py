"""The yardstick's counts, checked by hand on a 2-tree forest and a
2-stage cascade."""
import numpy as np
import pytest

from chipbench import models, reference, yardstick
from chipbench.trainer import Node

CALIB = np.array([[-1.0, -1.0], [1.0, 1.0]])


def _leaf(*v):
    return Node(value=np.array(v, dtype=np.float64))


def _forest(leaves0, leaves1):
    """tree 0: x0 <= 0.5 ? leaf : leaf; tree 1: x1 <= 0 ? (x0 <= 0.2 ?
    leaf : leaf) : leaf."""
    t0 = Node(feature=0, threshold=0.5, left=_leaf(*leaves0[0]),
              right=_leaf(*leaves0[1]))
    t1 = Node(feature=1, threshold=0.0,
              left=Node(feature=0, threshold=0.2, left=_leaf(*leaves1[0]),
                        right=_leaf(*leaves1[1])),
              right=_leaf(*leaves1[2]))
    return models.canonical([t0, t1], 2, len(leaves0[0]))


ROWS = np.array([[0.0, -0.5],      # tree 0 left (1 compare), tree 1 node 1 (2)
                 [0.9, 0.5]])      # tree 0 right (1), tree 1 right (1)


def test_two_tree_forest_by_hand():
    model = _forest([(1.0,), (2.0,)], [(0.25,), (0.5,), (0.75,)])
    assert model["n_nodes"].tolist() == [1, 2]
    assert model["n_leaves"].tolist() == [2, 3]
    q = reference.quantize_model(model, CALIB, 16)
    sums, compares = reference.traverse(q, q.rows(ROWS))
    assert compares.tolist() == [3, 2]
    np.testing.assert_array_equal(q.descale(sums), [[1.25], [2.75]])
    # 3 internal nodes of 4 + 2 bytes, 5 leaves of 4 bytes
    model_bytes = yardstick.forest_bytes(3, 5, 1, 2, 4)
    assert model_bytes == 38
    ops, nbytes = yardstick.call_work(2, 2, 1, int(compares.sum()), 4,
                                      model_bytes)
    assert ops == 5 + 4                       # compares + one add per pair
    assert nbytes == 2 * 2 * 4 + 38 + 2 * 4   # rows in, trees, scores out
    assert yardstick.least_seconds(ops, nbytes) == nbytes / 3.35e12


def test_two_stage_cascade_by_hand():
    """Row 0 reaches tree 0's decided leaf (margin 1) and exits after the
    first stage; row 1 gets a tie (margin 0) and walks both trees."""
    model = _forest([(0.5, 0.0), (0.25, 0.25)],
                    [(0.5, 0.0), (0.0, 0.5), (0.25, 0.25)])
    q = reference.quantize_model(model, CALIB, 16)
    sums, exit_stage, compares = reference.cascade(q, q.rows(ROWS), [1, 2],
                                                   0.5)
    assert exit_stage.tolist() == [0, 1]
    assert compares.tolist() == [1, 2]
    np.testing.assert_array_equal(q.descale(sums), [[0.5, 0.0], [0.5, 0.5]])
    walked = np.asarray([1, 2])[exit_stage]
    ops, _ = yardstick.call_work(2, 2, 2, int(compares.sum()),
                                 int(walked.sum()), 0)
    assert ops == 3 + 3 * 2                   # 3 (row, tree) pairs, 2 classes


@pytest.mark.parametrize("bits, scale", [(16, 8192.0), (8, 32.0)])
def test_leaf_scale_is_the_largest_power_of_two_in_range(bits, scale):
    """The largest leaf, 2.0, must stay within 2^(bits-1) - 1."""
    model = _forest([(1.0,), (2.0,)], [(0.25,), (0.5,), (0.75,)])
    q = reference.quantize_model(model, CALIB, bits)
    assert q.leaf_scale == scale
    assert q.leaf[0, :2, 0].tolist() == [scale, 2 * scale]


def test_peaks_are_the_h100_datasheets():
    assert yardstick.OPS_PER_S == 67e12
    assert yardstick.BYTES_PER_S == 3.35e12
    assert yardstick.least_seconds(67e12, 1.0) == 1.0
