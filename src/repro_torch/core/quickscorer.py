"""QuickScorer bitvector engine in plain torch — the port's counterpart of
``repro.core.quickscorer`` (bitvector half; the bit-matmul half comes with
the ``qs_bitmm_forward`` slice).

``CompiledQS`` holds the flat QuickScorer arrays as registered buffers.
``eval_batch`` is the engine of ``backend="torch"`` and the arithmetic the
CUDA kernel's plain version (``kernels.quickscorer_kernel``) repeats.

Semantics (paper Algorithm 1, as in the reference):

  * every node carries a bitmask that clears its *left-subtree* leaves;
  * the mask is applied iff ``x[feat] > thr`` (gather semantics: a NaN
    feature compares false and goes left);
  * the exit leaf is the lowest surviving set bit (LSB-first);
  * the prediction is a leaf-table lookup summed over trees.

Torch has no usable uint32 arithmetic on the CPU and no popcount, so masks
travel as int32 bit patterns, the node-axis AND is a halving reduction,
and ``ctz32`` tests the isolated low bit against five constant masks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .forest import WORD, Forest
from .quantize import accum_bits, leaf_scale, quantize_inputs
from .registry import BasePredictor, register_engine, resolve_device

# budget for the (B, Tc, N, W) int32 select tensor of one tree chunk
_CHUNK_BYTES = 64 << 20


def forest_acc_bits(forest: Forest) -> int:
    """Accumulator width an engine should compile for: 32 unless the
    forest opted into integer accumulation and its worst-case leaf sum
    provably fits int16 (``accum_bits``)."""
    return accum_bits(forest) if forest.int_accum else 32


def acc_dtype_for(leaf_dtype: torch.dtype, acc_bits: int) -> torch.dtype:
    """Leaf dtype + accumulator width → torch accumulator dtype.  Float
    leaves accumulate float32; integer leaves int32, narrowed to int16
    only when the compile-time bound allows."""
    if leaf_dtype.is_floating_point:
        return torch.float32
    return torch.int16 if acc_bits == 16 else torch.int32


def as_bit_pattern(words: np.ndarray) -> torch.Tensor:
    """uint32 words → int32 tensor with the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))


class CompiledQS(nn.Module):
    """Flattened QuickScorer arrays, registered as buffers on ``device``."""

    def __init__(self, forest: Forest, device: torch.device):
        super().__init__()
        self.device = device
        self.forest = forest                # host IR (input quantization)
        self.n_leaves = forest.n_leaves
        self.n_classes = forest.n_classes
        self.n_features = forest.n_features
        self.leaf_scale = leaf_scale(forest)
        self.acc_bits = forest_acc_bits(forest)
        bufs = {
            "feat": torch.from_numpy(
                np.maximum(forest.feature, 0).astype(np.int64)),  # (T, N)
            "thr": torch.from_numpy(np.asarray(forest.threshold)),  # (T, N)
            "valid": torch.from_numpy(forest.feature >= 0),         # (T, N)
            "masks": as_bit_pattern(forest.node_masks()),           # (T, N, W)
            "init_idx": as_bit_pattern(forest.init_leafidx()),      # (T, W)
            "leaf_val": torch.from_numpy(
                np.asarray(forest.leaf_value)),                     # (T, L, C)
        }
        for name, t in bufs.items():
            self.register_buffer(name, t.to(device))

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]

    @property
    def n_words(self) -> int:
        return self.masks.shape[-1]

    def transform_inputs(self, X: np.ndarray) -> np.ndarray:
        return quantize_inputs(self.forest, X)


def compile_qs(forest: Forest, device=None) -> CompiledQS:
    return CompiledQS(forest, resolve_device(device))


# --------------------------------------------------------------------------- #
# Bit helpers
# --------------------------------------------------------------------------- #
_CTZ_MASKS = (0xAAAAAAAA, 0xCCCCCCCC, 0xF0F0F0F0, 0xFF00FF00, 0xFFFF0000)


def ctz32(w: torch.Tensor) -> torch.Tensor:
    """Count-trailing-zeros of 32-bit words held as int64 in [0, 2^32).
    ``w & -w`` isolates the lowest set bit; its index has bit k set iff
    the isolated bit lies in ``_CTZ_MASKS[k]``.  Returns 0 for w == 0
    (the reference's popcount form gives 32); callers only read it for
    a nonzero word or a tree whose leaf row is zero."""
    lsb = w & -w
    out = torch.zeros_like(w)
    for k, m in enumerate(_CTZ_MASKS):
        out += ((lsb & m) != 0).to(w.dtype) << k
    return out


def exit_leaf(leafidx: torch.Tensor) -> torch.Tensor:
    """leafidx (..., W) int32 bit patterns → lowest set bit index (...,)
    int64; all-zero words give leaf 0."""
    leaf = torch.zeros(leafidx.shape[:-1], dtype=torch.int64,
                       device=leafidx.device)
    found = torch.zeros(leafidx.shape[:-1], dtype=torch.bool,
                        device=leafidx.device)
    for w in range(leafidx.shape[-1]):
        word = leafidx[..., w].to(torch.int64) & 0xFFFFFFFF
        hit = (word != 0) & ~found
        leaf = torch.where(hit, w * WORD + ctz32(word), leaf)
        found |= hit
    return leaf


def mask_reduce(cond: torch.Tensor, masks: torch.Tensor,
                init_idx: torch.Tensor) -> torch.Tensor:
    """cond (B, T, N) bool × masks (T, N, W) → leafidx (B, T, W).

    AND-reduction over the node axis with predication: nodes whose
    predicate is false contribute the identity mask (all ones).  Torch
    has no bitwise-AND reduction, so the node axis is padded to a power
    of two with all-ones and halved log2(N) times."""
    sel = torch.where(cond[..., None], masks[None], -1)      # (B, T, N, W)
    n = sel.shape[2]
    p2 = 1 << max(n - 1, 0).bit_length()
    if p2 != n:
        pad = sel.new_full(sel.shape[:2] + (p2 - n,) + sel.shape[3:], -1)
        sel = torch.cat([sel, pad], dim=2)
    while sel.shape[2] > 1:
        h = sel.shape[2] // 2
        sel = sel[:, :, :h] & sel[:, :, h:]
    return sel[:, :, 0] & init_idx[None]


def qs_scores(X: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
              masks: torch.Tensor, init_idx: torch.Tensor,
              leaf_val: torch.Tensor, acc_dtype: torch.dtype,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw leaf sums (B, C) in ``acc_dtype``: ``eval_batch``'s arithmetic,
    taken over tree chunks so the (B, Tc, N, W) select tensor stays
    within ``_CHUNK_BYTES``.  ``valid=None`` means every node is real or
    carries a threshold no input exceeds (the kernel's padded arrays)."""
    B = X.shape[0]
    T, N = feat.shape
    W = masks.shape[-1]
    C = leaf_val.shape[-1]
    p2 = 1 << max(N - 1, 0).bit_length()
    chunk = max(1, _CHUNK_BYTES // max(B * p2 * W * 4, 1))
    score = torch.zeros((B, C), dtype=acc_dtype, device=X.device)
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        cond = X[:, feat[t0:t1].long()] > thr[t0:t1][None]     # (B, Tc, N)
        if valid is not None:
            cond &= valid[t0:t1][None]
        leafidx = mask_reduce(cond, masks[t0:t1], init_idx[t0:t1])
        leaf = exit_leaf(leafidx)                               # (B, Tc)
        trees = torch.arange(t0, t1, device=X.device)
        vals = leaf_val[trees[None, :], leaf]                   # (B, Tc, C)
        score += vals.to(acc_dtype).sum(dim=1, dtype=acc_dtype)
    return score


def eval_batch(qs: CompiledQS, X: torch.Tensor) -> torch.Tensor:
    """Full-batch QuickScorer: X (B, d) → scores (B, C) float32."""
    acc_dtype = acc_dtype_for(qs.leaf_val.dtype, qs.acc_bits)
    score = qs_scores(X, qs.feat, qs.thr, qs.masks, qs.init_idx,
                      qs.leaf_val, acc_dtype, valid=qs.valid)
    return score.to(torch.float32) / qs.leaf_scale


class QSPredictor(BasePredictor):
    """Bitvector-engine wrapper on the shared base."""

    def __init__(self, qs: CompiledQS, eval_fn=None):
        super().__init__(qs, eval_fn or eval_batch)
        self.qs = qs


# --------------------------------------------------------------------------- #
# Faithful scalar QuickScorer (paper Algorithm 1, with the sorted-threshold
# early exit) — numpy, for oracle cross-checks.
# --------------------------------------------------------------------------- #
def build_feature_major(forest: Forest):
    """Feature-major node stream: for each feature, nodes sorted ascending by
    threshold — the order Algorithm 1 requires for its ``break``."""
    T, N = forest.feature.shape
    recs = []
    for t in range(T):
        for n in range(int(forest.n_nodes[t])):
            recs.append((int(forest.feature[t, n]),
                         float(forest.threshold[t, n]), t, n))
    recs.sort()
    feat = np.array([r[0] for r in recs], dtype=np.int32)
    thr = np.array([r[1] for r in recs], dtype=np.float64)
    tree = np.array([r[2] for r in recs], dtype=np.int32)
    node = np.array([r[3] for r in recs], dtype=np.int32)
    # feature segment boundaries
    starts = np.searchsorted(feat, np.arange(forest.n_features))
    ends = np.searchsorted(feat, np.arange(forest.n_features), side="right")
    return feat, thr, tree, node, starts, ends


def eval_scalar_numpy(forest: Forest, X: np.ndarray) -> np.ndarray:
    """Algorithm 1 verbatim (per instance, early break per feature)."""
    feat, thr, tree, node, starts, ends = build_feature_major(forest)
    masks = forest.node_masks()
    init = forest.init_leafidx()
    W = forest.n_words
    out = np.zeros((X.shape[0], forest.n_classes))
    lv = forest.leaf_value.astype(np.float64)
    for i, x in enumerate(X):
        leafidx = init.copy()
        for f in range(forest.n_features):
            for j in range(starts[f], ends[f]):
                if x[f] > thr[j]:
                    leafidx[tree[j]] &= masks[tree[j], node[j]]
                else:
                    break                      # thresholds ascending
        # exit leaf: lowest set bit
        for t in range(forest.n_trees):
            leaf = 0
            for w in range(W):
                v = int(leafidx[t, w])
                if v:
                    leaf = w * WORD + (v & -v).bit_length() - 1
                    break
            out[i] += lv[t, leaf]
    return out / leaf_scale(forest)


register_engine(
    "bitvector", backend="torch", tune_name="qs", compile=compile_qs,
    evaluate=eval_batch, predictor_cls=QSPredictor,
    doc="QuickScorer: predicated interval-mask AND-reduction over nodes")
