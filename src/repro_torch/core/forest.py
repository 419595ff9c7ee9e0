"""Forest IR — canonical structure-of-arrays form of a tree ensemble.

The port's copy of ``repro.core.forest`` (numpy only): the same trainer
trees give array-equal fields in both packages, and
``core.convert.forest_from_reference`` carries a reference IR across.
Every engine and the CUDA QuickScorer kernel compile from this IR. Canonicalisation guarantees:

  * leaves are numbered left-to-right (in-order), so every subtree covers a
    contiguous leaf range [lo, hi) — QuickScorer bitmasks become interval
    masks;
  * internal nodes are numbered in preorder, node 0 is the root;
  * every tree is padded to the ensemble-wide ``n_leaves_max`` (L) /
    ``n_nodes_max`` (L-1) so arrays are rectangular.

Bit convention (differs from the paper, see docs/DESIGN.md §2.2): leaf ``j``
of a tree owns bit ``j % 32`` of word ``j // 32`` (LSB-first). The paper's
"leftmost set bit" becomes "lowest set bit across words", computed with
``popcount((w & -w) - 1)``.

Canonicalisation is the ``canonicalize`` pass of the compile pipeline
(``core/pipeline.py``); ``from_trees`` below is its workhorse.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..trees.cart import Tree, TreeNode

WORD = 32  # leafidx word width


@dataclass
class Forest:
    """Padded SoA ensemble. ``feature[t, n] < 0`` marks a padding node."""
    n_trees: int
    n_leaves: int                 # L (max per tree, padded)
    n_classes: int                # C (1 for ranking/regression)
    n_features: int

    feature: np.ndarray           # (T, L-1) int32, -1 = padding
    threshold: np.ndarray         # (T, L-1) float32
    left: np.ndarray              # (T, L-1) int32; >=0 node id, <0 → leaf -(x+1)
    right: np.ndarray             # (T, L-1) int32
    # QuickScorer interval data: node n removes leaves [lo, mid) when its
    # predicate x > t fires (the left subtree becomes unreachable).
    leaf_lo: np.ndarray           # (T, L-1) int32
    leaf_mid: np.ndarray          # (T, L-1) int32
    leaf_hi: np.ndarray           # (T, L-1) int32
    leaf_value: np.ndarray        # (T, L, C) float32
    n_nodes: np.ndarray           # (T,) int32  real internal-node counts
    n_leaves_per_tree: np.ndarray  # (T,) int32
    max_depth: int = 0

    # quantization metadata (None → float32 forest)
    quant_scale: Optional[float] = None
    quant_bits: Optional[int] = None
    leaf_scale: float = 1.0                # descale factor for int leaves
    feat_lo: Optional[np.ndarray] = None   # per-feature affine normalisation
    feat_hi: Optional[np.ndarray] = None
    # optimizer column remap (repro.optim drop_unused_features): IR column
    # j reads the caller's column feat_map[j]; None → identity.  Applied
    # by quantize_inputs, so callers keep passing full-width rows.
    # n_features_src records the caller-side width at remap time — the
    # map alone can only bound it below (trailing unused columns vanish
    # from max(feat_map)+1).
    feat_map: Optional[np.ndarray] = None
    n_features_src: Optional[int] = None
    # integer end-to-end extensions (docs/QUANT.md)
    int_accum: bool = False               # engines accumulate leaves as ints
    flint: bool = False                   # thresholds are FLInt int32 keys
    leaf_err_bound: Optional[float] = None  # worst-case leaf-sum quant error

    @property
    def n_features_in(self) -> int:
        """Width of the rows callers pass (== n_features unless the
        optimizer dropped unused columns behind a feat_map)."""
        if self.feat_map is None:
            return self.n_features
        if self.n_features_src is not None:
            return int(self.n_features_src)
        # remap of unknown provenance: the tightest provable lower bound
        return int(np.max(self.feat_map, initial=-1)) + 1

    @property
    def n_words(self) -> int:
        return (self.n_leaves + WORD - 1) // WORD

    @property
    def nodes_per_tree(self) -> int:
        return self.n_leaves - 1

    # ---------------------------------------------------------------- oracle
    def predict_oracle(self, X: np.ndarray) -> np.ndarray:
        """Vectorized numpy root-to-leaf traversal — ground truth for every
        engine. Returns (B, C) summed scores."""
        B = X.shape[0]
        out = np.zeros((B, self.n_classes), dtype=np.float64)
        for t in range(self.n_trees):
            node = np.zeros(B, dtype=np.int32)
            done = np.zeros(B, dtype=bool)
            leaf = np.zeros(B, dtype=np.int32)
            if self.n_nodes[t] == 0:      # single-leaf tree
                out += self.leaf_value[t, 0]
                continue
            for _ in range(self.max_depth + 1):
                f = self.feature[t, node]
                go_left = X[np.arange(B), np.maximum(f, 0)] <= self.threshold[t, node]
                nxt = np.where(go_left, self.left[t, node], self.right[t, node])
                is_leaf = nxt < 0
                leaf = np.where(~done & is_leaf, -nxt - 1, leaf)
                done |= is_leaf
                node = np.where(is_leaf, node, nxt)
                if done.all():
                    break
            out += self.leaf_value[t, leaf]
        return out

    def init_leafidx(self) -> np.ndarray:
        """(T, W) uint32 — bits set only for real leaves of each tree."""
        T, L, W = self.n_trees, self.n_leaves, self.n_words
        idx = np.zeros((T, W), dtype=np.uint32)
        for t in range(T):
            idx[t] = _interval_bits(0, int(self.n_leaves_per_tree[t]), W)
        return idx

    def node_masks(self) -> np.ndarray:
        """(T, L-1, W) uint32 QuickScorer bitmasks: ones everywhere except
        the left-subtree leaf interval [lo, mid). Padding nodes → all-ones."""
        T, N, W = self.n_trees, self.nodes_per_tree, self.n_words
        masks = np.full((T, N, W), 0xFFFFFFFF, dtype=np.uint32)
        for t in range(T):
            for n in range(int(self.n_nodes[t])):
                masks[t, n] = ~_interval_bits(
                    int(self.leaf_lo[t, n]), int(self.leaf_mid[t, n]), W)
        return masks


def _interval_bits(lo: int, hi: int, n_words: int) -> np.ndarray:
    """uint32[n_words] with bits [lo, hi) set (LSB-first within words)."""
    out = np.zeros(n_words, dtype=np.uint32)
    for w in range(n_words):
        a, b = max(lo - w * WORD, 0), min(hi - w * WORD, WORD)
        if a < b:
            bits = (np.uint64(1) << np.uint64(b)) - np.uint64(1)
            bits ^= (np.uint64(1) << np.uint64(a)) - np.uint64(1)
            out[w] = np.uint32(bits & np.uint64(0xFFFFFFFF))
    return out


# --------------------------------------------------------------------------- #
# Construction: trainer trees → Forest IR
# --------------------------------------------------------------------------- #
def from_trees(trees: list[Tree], n_features: int, n_classes: int,
               tree_class: Optional[list[int]] = None,
               base_score: float = 0.0) -> Forest:
    """Canonicalise a list of trainer trees. ``tree_class`` embeds scalar
    GBT trees into C-dim leaf vectors (softmax boosting)."""
    T = len(trees)
    L = max(max(t.n_leaves for t in trees), 2)
    C = n_classes
    feature = np.full((T, L - 1), -1, dtype=np.int32)
    threshold = np.zeros((T, L - 1), dtype=np.float32)
    left = np.zeros((T, L - 1), dtype=np.int32)
    right = np.zeros((T, L - 1), dtype=np.int32)
    leaf_lo = np.zeros((T, L - 1), dtype=np.int32)
    leaf_mid = np.zeros((T, L - 1), dtype=np.int32)
    leaf_hi = np.zeros((T, L - 1), dtype=np.int32)
    leaf_value = np.zeros((T, L, C), dtype=np.float32)
    n_nodes = np.zeros(T, dtype=np.int32)
    n_leaves_per_tree = np.zeros(T, dtype=np.int32)
    max_depth = 1

    for t, tree in enumerate(trees):
        nodes: list[TreeNode] = []
        spans: dict[int, tuple[int, int, int]] = {}   # id -> (lo, mid, hi)
        leaf_ctr = 0

        def walk(nd: TreeNode, depth: int) -> tuple[int, int]:
            nonlocal leaf_ctr, max_depth
            max_depth = max(max_depth, depth)
            if nd.is_leaf:
                j = leaf_ctr
                leaf_ctr += 1
                val = nd.value
                if tree_class is not None and tree_class[t] >= 0:
                    v = np.zeros(C)
                    v[tree_class[t]] = val[0]
                    val = v
                leaf_value[t, j, :] = val
                return j, j + 1
            nodes.append(nd)
            lo, mid = walk(nd.left, depth + 1)
            _, hi = walk(nd.right, depth + 1)
            spans[id(nd)] = (lo, mid, hi)
            return lo, hi

        # preorder internal numbering happens via `nodes` append order
        walk(tree.root, 1)
        index = {id(nd): i for i, nd in enumerate(nodes)}

        # second pass fills arrays (leaf ids re-derived in the same order)
        leaf_ctr2 = 0

        def walk2(nd: TreeNode) -> int:
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
            lo, mid, hi = spans[id(nd)]
            leaf_lo[t, i], leaf_mid[t, i], leaf_hi[t, i] = lo, mid, hi
            return i

        walk2(tree.root)
        n_nodes[t] = len(nodes)
        n_leaves_per_tree[t] = leaf_ctr
        if base_score and C == 1:
            leaf_value[t] += base_score / T

    return Forest(T, L, C, n_features, feature, threshold, left, right,
                  leaf_lo, leaf_mid, leaf_hi, leaf_value,
                  n_nodes, n_leaves_per_tree, max_depth=max_depth)


def from_random_forest(rf) -> Forest:
    return from_trees(rf.trees, rf.binner and len(rf.binner.edges) or 0,
                      rf.n_classes)


def from_gradient_boosting(gb) -> Forest:
    n_features = len(gb.binner.edges)
    if gb.cfg.objective == "softmax":
        return from_trees(gb.trees, n_features, gb.n_classes,
                          tree_class=gb.tree_class)
    return from_trees(gb.trees, n_features, 1, base_score=gb.base_score)


# --------------------------------------------------------------------------- #
# Random forests for throughput benchmarking (runtime is independent of the
# learned values; the paper's Table 2 sweeps up to 20k trees, which would be
# wasteful to *train* in CI).
# --------------------------------------------------------------------------- #
def random_forest_ir(n_trees: int, n_leaves: int, n_features: int,
                     n_classes: int = 1, seed: int = 0,
                     full: bool = True) -> Forest:
    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(n_trees):
        trees.append(_random_tree(rng, n_leaves, n_features, n_classes, full))
    return from_trees(trees, n_features, n_classes)


def _random_tree(rng, n_leaves, n_features, n_classes, full) -> Tree:
    from ..trees.cart import Tree as TTree

    def build(n_leaf: int, depth: int):
        if n_leaf == 1:
            return TreeNode(value=rng.normal(0, 1, size=n_classes)), depth
        if full:
            nl = n_leaf // 2
        else:
            nl = int(rng.integers(1, n_leaf))
        l, dl = build(nl, depth + 1)
        r, dr = build(n_leaf - nl, depth + 1)
        nd = TreeNode(feature=int(rng.integers(0, n_features)),
                      threshold=float(rng.normal(0, 1)), left=l, right=r)
        return nd, max(dl, dr)

    root, depth = build(n_leaves, 1)
    return TTree(root, n_leaves, depth)
