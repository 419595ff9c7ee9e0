"""IR ↔ tree rewriting for structural optimizer passes — the port's copy
of ``repro.optim.rewrite`` (numpy only), on the port's ``core.forest``.

The SoA Forest IR is ideal for evaluation but awkward for structural
surgery (collapsing dominated splits, merging equal-leaf subtrees): those
passes want a pointer tree.  This module round-trips one tree at a time:

  * ``extract_tree`` — IR tree ``t`` → a lightweight ``Node`` tree
    (leaf values keep the IR's dtype; thresholds keep their numpy scalar
    type, so a quantized forest survives the round trip bit-exactly);
  * ``rebuild_forest`` — a list of ``Node`` roots → a fresh Forest with
    the *same* dtypes and quantization metadata as the source forest
    (``core.forest.from_trees`` always emits float32, which would wreck
    an int16-threshold quantized forest).

Rebuilding re-derives the canonical invariants (preorder nodes, in-order
leaves, interval spans, real ``max_depth``) — so any pass that rebuilds
automatically drops nodes unreachable from the root.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.forest import Forest


class Node:
    """One tree node: a leaf (``value`` set) or a split (children set)."""
    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self, feature=-1, threshold=None, left=None, right=None,
                 value=None):
        self.feature = feature
        self.threshold = threshold
        self.left = left
        self.right = right
        self.value = value

    @property
    def is_leaf(self) -> bool:
        return self.value is not None


def leaf(value: np.ndarray) -> Node:
    return Node(value=np.asarray(value))


def split(feature: int, threshold, left: Node, right: Node) -> Node:
    return Node(feature=feature, threshold=threshold, left=left, right=right)


def extract_tree(forest: Forest, t: int) -> Node:
    """IR tree ``t`` → ``Node`` tree (root is IR node 0; single-leaf
    trees come back as a bare leaf)."""
    if int(forest.n_nodes[t]) == 0:
        return leaf(forest.leaf_value[t, 0].copy())

    def walk(code: int) -> Node:
        if code < 0:
            return leaf(forest.leaf_value[t, -code - 1].copy())
        return split(int(forest.feature[t, code]),
                     forest.threshold[t, code],
                     walk(int(forest.left[t, code])),
                     walk(int(forest.right[t, code])))

    return walk(0)


def count_leaves(root: Node) -> int:
    return 1 if root.is_leaf else (count_leaves(root.left)
                                   + count_leaves(root.right))


def rebuild_forest(forest: Forest, roots: list[Node],
                   n_leaves: Optional[int] = None) -> Forest:
    """Canonicalise ``roots`` into a Forest with ``forest``'s dtypes and
    metadata.  ``n_leaves=None`` keeps the source padding width (so a
    single pass's effect stays observable); pass the real maximum (or
    anything >= it) to shrink — ``compact`` does."""
    T = len(roots)
    L = forest.n_leaves if n_leaves is None else max(int(n_leaves), 2)
    C = forest.n_classes
    feature = np.full((T, L - 1), -1, dtype=forest.feature.dtype)
    threshold = np.zeros((T, L - 1), dtype=forest.threshold.dtype)
    left = np.zeros((T, L - 1), dtype=forest.left.dtype)
    right = np.zeros((T, L - 1), dtype=forest.right.dtype)
    leaf_lo = np.zeros((T, L - 1), dtype=forest.leaf_lo.dtype)
    leaf_mid = np.zeros((T, L - 1), dtype=forest.leaf_mid.dtype)
    leaf_hi = np.zeros((T, L - 1), dtype=forest.leaf_hi.dtype)
    leaf_value = np.zeros((T, L, C), dtype=forest.leaf_value.dtype)
    n_nodes = np.zeros(T, dtype=forest.n_nodes.dtype)
    n_leaves_per_tree = np.zeros(T, dtype=forest.n_leaves_per_tree.dtype)
    max_depth = 1

    for t, root in enumerate(roots):
        nodes: list[Node] = []
        spans: dict[int, tuple[int, int, int]] = {}
        leaf_ctr = 0

        def walk(nd: Node, depth: int) -> tuple[int, int]:
            nonlocal leaf_ctr, max_depth
            max_depth = max(max_depth, depth)
            if nd.is_leaf:
                j = leaf_ctr
                leaf_ctr += 1
                leaf_value[t, j, :] = nd.value
                return j, j + 1
            nodes.append(nd)
            lo, mid = walk(nd.left, depth + 1)
            _, hi = walk(nd.right, depth + 1)
            spans[id(nd)] = (lo, mid, hi)
            return lo, hi

        walk(root, 1)
        index = {id(nd): i for i, nd in enumerate(nodes)}
        leaf_ctr2 = 0

        def walk2(nd: Node) -> int:
            nonlocal leaf_ctr2
            if nd.is_leaf:
                j = leaf_ctr2
                leaf_ctr2 += 1
                return -(j + 1)
            i = index[id(nd)]
            lcode = walk2(nd.left)
            rcode = walk2(nd.right)
            feature[t, i] = nd.feature
            threshold[t, i] = nd.threshold
            left[t, i] = lcode
            right[t, i] = rcode
            leaf_lo[t, i], leaf_mid[t, i], leaf_hi[t, i] = spans[id(nd)]
            return i

        walk2(root)
        n_nodes[t] = len(nodes)
        n_leaves_per_tree[t] = leaf_ctr

    return Forest(
        n_trees=T, n_leaves=L, n_classes=C, n_features=forest.n_features,
        feature=feature, threshold=threshold, left=left, right=right,
        leaf_lo=leaf_lo, leaf_mid=leaf_mid, leaf_hi=leaf_hi,
        leaf_value=leaf_value, n_nodes=n_nodes,
        n_leaves_per_tree=n_leaves_per_tree, max_depth=max_depth,
        quant_scale=forest.quant_scale, quant_bits=forest.quant_bits,
        leaf_scale=forest.leaf_scale, feat_lo=forest.feat_lo,
        feat_hi=forest.feat_hi, feat_map=forest.feat_map,
        n_features_src=forest.n_features_src)
