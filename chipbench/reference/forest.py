"""Plain fixed-point forest evaluation (the paper's §5 scheme).

Quantization, in float64 NumPy: each feature is min-max normalised over
the calibration rows to [0, 1] and put on the grid ``floor(s * x)`` with
``s = 2^(bits-1)``, clipped to the signed ``bits``-wide range; thresholds
go through the same map, so ``x <= t`` becomes an integer compare.
Leaves are scaled by the largest power of two ``s_leaf <= s`` that keeps
every leaf within range and floored; sums are exact integers, descaled
by ``s_leaf`` in float32.

Traversal, in plain torch on any device: every (row, tree) pair walks
from the root, left iff ``x <= t``, to its leaf; the walk counts the
compares on each row's paths, which the yardstick prices.

The cascade: after each stage but the last, a row whose vote margin
(top class share minus the runner-up's, float32, classes summed left to
right) reaches the gate's threshold exits with the sum of the stages it
walked.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# rows × trees of one traversal block: bounds the walk's working set
BLOCK_ELEMENTS = 1 << 24


def fit_ranges(X: np.ndarray):
    """Per-feature (lo, hi) of the calibration rows; a constant feature
    gets hi = lo + 1."""
    X = np.asarray(X, dtype=np.float64)
    lo, hi = X.min(axis=0), X.max(axis=0)
    return lo, np.where(hi - lo <= 0, lo + 1.0, hi)


def _grid(Xn: np.ndarray, bits: int) -> np.ndarray:
    imax = 2 ** (bits - 1) - 1
    return np.clip(np.floor(2.0 ** (bits - 1) * Xn), -imax - 1,
                   imax).astype(np.int32)


def quantize_rows(X: np.ndarray, lo, hi, bits: int) -> np.ndarray:
    """Raw rows → (B, d) int32 grid values."""
    Xn = np.clip((np.asarray(X, dtype=np.float64) - lo) / (hi - lo), 0.0, 1.0)
    return _grid(Xn, bits)


@dataclass
class Quantized:
    """A model file on the grid: int32 thresholds, int64 leaves and the
    leaf scale; ``lo``/``hi`` map raw rows onto the same grid."""
    feature: np.ndarray        # (T, N) int64, -1 = padding node
    threshold: np.ndarray      # (T, N) int32
    left: np.ndarray           # (T, N) int64: >= 0 node, < 0 leaf -(x+1)
    right: np.ndarray
    leaf: np.ndarray           # (T, L, C) int64
    n_nodes: np.ndarray        # (T,)
    leaf_scale: float
    lo: np.ndarray
    hi: np.ndarray
    bits: int

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    def rows(self, X: np.ndarray) -> np.ndarray:
        return quantize_rows(X, self.lo, self.hi, self.bits)

    def descale(self, sums: np.ndarray) -> np.ndarray:
        """Integer sums → float32 scores (the scale is a power of two)."""
        return np.asarray(sums).astype(np.float32) / np.float32(
            self.leaf_scale)


def quantize_model(model: dict, calib_rows: np.ndarray,
                   bits: int = 16) -> Quantized:
    """Put the model file's thresholds and leaves on the ``bits`` grid
    fitted to ``calib_rows``."""
    lo, hi = fit_ranges(calib_rows)
    feature = np.asarray(model["feature"], dtype=np.int64)
    f = np.maximum(feature, 0)
    tn = np.clip((np.asarray(model["threshold"], dtype=np.float64) - lo[f])
                 / (hi[f] - lo[f]), 0.0, 1.0)
    leaf = np.asarray(model["leaf_value"], dtype=np.float64)
    imax = 2 ** (bits - 1) - 1
    max_abs = float(np.abs(leaf).max()) or 1.0
    s_leaf = 2.0 ** (bits - 1)
    while s_leaf * max_abs > imax:
        s_leaf /= 2.0
    qleaf = np.clip(np.floor(s_leaf * leaf), -imax - 1, imax).astype(np.int64)
    return Quantized(feature, _grid(tn, bits),
                     np.asarray(model["left"], dtype=np.int64),
                     np.asarray(model["right"], dtype=np.int64), qleaf,
                     np.asarray(model["n_nodes"]), s_leaf, lo, hi, bits)


def traverse(q: Quantized, xq: np.ndarray, trees: slice = slice(None),
             device="cpu"):
    """Sum the leaves that grid rows ``xq`` reach in ``q``'s trees
    ``trees``.  Returns (sums (B, C) int64, compares (B,) int64), both
    numpy: the compares are the internal nodes on each row's paths."""
    feature = torch.as_tensor(q.feature[trees], device=device)
    T = feature.shape[0]
    B = xq.shape[0]
    C = q.leaf.shape[-1]
    sums = torch.zeros((B, C), dtype=torch.int64, device=device)
    compares = torch.zeros(B, dtype=torch.int64, device=device)
    if T == 0 or B == 0:
        return sums.cpu().numpy(), compares.cpu().numpy()
    thr = torch.as_tensor(q.threshold[trees], device=device)
    left = torch.as_tensor(q.left[trees], device=device)
    right = torch.as_tensor(q.right[trees], device=device)
    leaf = torch.as_tensor(q.leaf[trees], device=device)
    stump = torch.as_tensor(q.n_nodes[trees] == 0, device=device)
    x_all = torch.as_tensor(xq, device=device)
    tb = max(1, min(T, BLOCK_ELEMENTS // max(B, 1)))
    rb = max(1, min(B, BLOCK_ELEMENTS // tb))
    for r0 in range(0, B, rb):
        x = x_all[r0:r0 + rb]
        n = x.shape[0]
        for t0 in range(0, T, tb):
            t1 = min(T, t0 + tb)
            featT, thrT = feature[t0:t1].T, thr[t0:t1].T      # (N, tb)
            leftT, rightT = left[t0:t1].T, right[t0:t1].T
            node = torch.zeros((n, t1 - t0), dtype=torch.int64, device=device)
            at = torch.zeros_like(node)
            done = stump[t0:t1][None, :].expand(n, -1).clone()
            while not bool(done.all()):
                f = featT.gather(0, node)
                go_left = x.gather(1, f) <= thrT.gather(0, node)
                nxt = torch.where(go_left, leftT.gather(0, node),
                                  rightT.gather(0, node))
                walking = ~done
                compares[r0:r0 + n] += walking.sum(dim=1)
                reached = walking & (nxt < 0)
                at = torch.where(reached, -nxt - 1, at)
                done |= reached
                node = torch.where(done, node, nxt)
            trees_idx = torch.arange(t0, t1, device=device)[None, :]
            sums[r0:r0 + n] += leaf[trees_idx, at].sum(dim=1)
    return sums.cpu().numpy(), compares.cpu().numpy()


def margin_exits(scores: np.ndarray, threshold: float) -> np.ndarray:
    """(B, C) float32 running vote scores → whether each row's margin
    (top share minus the runner-up's) reaches ``threshold``."""
    s = np.asarray(scores, dtype=np.float32)
    B, C = s.shape
    if C < 2 or not np.isfinite(threshold):
        return np.zeros(B, dtype=bool)
    v = np.maximum(s, np.float32(0))
    tot = v[:, 0].copy()
    for c in range(1, C):
        tot = tot + v[:, c]
    safe = np.where(tot > 0, tot, np.float32(1))
    p = np.where(tot[:, None] > 0, v / safe[:, None], np.float32(1.0 / C))
    top = p.argmax(axis=1)
    top_p = p[np.arange(B), top]
    others = p.copy()
    others[np.arange(B), top] = -np.inf
    return (top_p - others.max(axis=1)) >= np.float32(threshold)


def cascade(q: Quantized, xq: np.ndarray, stages, threshold: float,
            device="cpu"):
    """The gated cascade over tree-prefix ``stages`` (cumulative tree
    counts).  Returns (sums (B, C) int64 at each row's exit, exit stage
    (B,), compares (B,) on the trees each row walked)."""
    if (q.leaf < 0).any():
        raise ValueError("the margin gate's reference takes vote forests "
                         "(leaves >= 0) only")
    B, C, K = xq.shape[0], q.leaf.shape[-1], len(stages)
    sums = np.zeros((B, C), dtype=np.int64)
    compares = np.zeros(B, dtype=np.int64)
    exit_stage = np.full(B, K - 1, dtype=np.int64)
    active = np.ones(B, dtype=bool)
    start = 0
    for k, stop in enumerate(stages):
        idx = np.nonzero(active)[0]
        s, c = traverse(q, xq[idx], slice(start, stop), device)
        sums[idx] += s
        compares[idx] += c
        start = stop
        if k < K - 1:
            ex = margin_exits(q.descale(sums[idx]), threshold)
            exit_stage[idx[ex]] = k
            active[idx[ex]] = False
    return sums, exit_stage, compares
