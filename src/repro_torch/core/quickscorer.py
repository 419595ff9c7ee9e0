"""QuickScorer engines in plain torch — the port's counterpart of
``repro.core.quickscorer``: the bitvector engine and the bit-matmul one.

``CompiledQS`` holds the flat QuickScorer arrays as registered buffers.
``eval_batch`` is the engine of ``backend="torch"`` and the arithmetic the
CUDA kernel's plain version (``kernels.quickscorer_kernel``) repeats.
``CompiledBitMM`` / ``eval_batch_bitmm`` replace the node-axis
AND-reduction with one contraction against packed clear-count words, and
recover the exit leaf with the lowest-zero-field borrow trick.

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

from .forest import WORD, Forest
from .quantize import accum_bits, leaf_scale, quantize_inputs
from .registry import (BasePredictor, CompiledModule, register_engine,
                       resolve_device)

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


class CompiledQS(CompiledModule):
    """Flattened QuickScorer arrays, registered as buffers on ``device``."""

    SCALARS = ("n_leaves", "n_classes", "n_features", "leaf_scale",
               "acc_bits")
    INDEX = ("feat",)
    BITS = ("masks", "init_idx")

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
# Bit-matmul QuickScorer — the node-axis AND-reduction as one contraction
# --------------------------------------------------------------------------- #
class CompiledBitMM(CompiledModule):
    """Packed clear-count arrays for the bit-matmul engine, as buffers.

    Layout: leaf ``l`` owns a ``bits``-wide field of packed word
    ``l // npack`` (field ``l % npack``, LSB-first).  ``packed[t, n, g]``
    holds node ``n``'s contribution to group ``g``: ``2^(bits*(l%npack))``
    summed over the leaves ``l`` of its clear interval ``[lo, mid)``.
    ``cond @ packed`` therefore accumulates, per leaf field, the number of
    firing ancestors that clear that leaf; every packed word stays below
    2^24.  ``bias`` marks padding leaves (``l >= n_leaves_per_tree``) as
    permanently cleared.  The tree axis is padded to a multiple of
    ``tree_chunk`` with inert trees."""

    SCALARS = ("bits", "npack", "n_leaves", "n_classes", "n_features",
               "n_trees", "tree_chunk", "leaf_scale", "acc_bits")
    INDEX = ("feat",)

    def __init__(self, forest: Forest, tree_chunk: Optional[int],
                 device: torch.device):
        super().__init__()
        T, N = forest.n_trees, forest.nodes_per_tree
        packed, bias, bits, npack = bitmm_pack_arrays(forest)
        G = packed.shape[-1]
        if tree_chunk is None:
            tree_chunk = bitmm_auto_chunk(T, N)
        tree_chunk = max(1, min(tree_chunk, T))
        # rebalance so the last tile is nearly full (pad < n_chunks trees)
        n_chunks = -(-T // tree_chunk)
        tree_chunk = -(-T // n_chunks)
        pad = n_chunks * tree_chunk - T

        feat = np.maximum(forest.feature, 0).astype(np.int64)
        valid = forest.feature >= 0
        thr = forest.threshold
        leaf_val = forest.leaf_value
        if pad:
            # padding trees: no valid nodes, every leaf field biased
            # "cleared" → no survivor → leaf 0 → all-zero leaf row
            feat = np.concatenate([feat, np.zeros((pad, N), np.int64)])
            thr = np.concatenate([thr, np.zeros((pad, N), thr.dtype)])
            valid = np.concatenate([valid, np.zeros((pad, N), bool)])
            packed = np.concatenate([packed,
                                     np.zeros((pad, N, G), np.float32)])
            full = np.float32(bitmm_full_word(bits, npack))
            bias = np.concatenate([bias, np.full((pad, G), full, np.float32)])
            leaf_val = np.concatenate(
                [leaf_val, np.zeros((pad,) + leaf_val.shape[1:],
                                    leaf_val.dtype)])
        self.device = device
        self.forest = forest
        self.bits, self.npack = bits, npack
        self.n_leaves = forest.n_leaves
        self.n_classes = forest.n_classes
        self.n_features = forest.n_features
        self.n_trees = T                  # real tree count (buffers padded)
        self.tree_chunk = tree_chunk
        self.leaf_scale = leaf_scale(forest)
        self.acc_bits = forest_acc_bits(forest)
        for name, a in (("feat", feat), ("thr", thr), ("valid", valid),
                        ("packed", packed), ("bias", bias),
                        ("leaf_val", leaf_val)):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(a)).to(device))

    @property
    def n_groups(self) -> int:
        return self.packed.shape[-1]

    def transform_inputs(self, X: np.ndarray) -> np.ndarray:
        return quantize_inputs(self.forest, X)


def bitmm_full_word(bits: int, npack: int) -> int:
    """Packed word with every field set to 1 — 'all leaves cleared'.  The
    padding-tree bias row, and the borrow trick's low mask."""
    return sum(1 << (bits * i) for i in range(npack))


def bitmm_field_layout(forest: Forest) -> tuple[int, int]:
    """Leaf-packing layout for the bit-matmul engine: (bits, npack).

    ``bits`` is sized from the forest's maximum per-leaf clear count (how
    many ancestors can clear one leaf), ``npack = 24 // bits`` leaves
    share one word.  The layout pass records the decision."""
    T, L, N = forest.n_trees, forest.n_leaves, forest.nodes_per_tree
    valid = forest.feature >= 0
    lo = np.where(valid, forest.leaf_lo, 0)
    mid = np.where(valid, forest.leaf_mid, 0)
    # per-leaf clear counts via a difference array → field width
    diff = np.zeros((T, L + 1), dtype=np.int64)
    t_idx = np.repeat(np.arange(T), N)[valid.ravel()]
    np.add.at(diff, (t_idx, lo.ravel()[valid.ravel()]), 1)
    np.add.at(diff, (t_idx, mid.ravel()[valid.ravel()]), -1)
    counts = np.cumsum(diff[:, :L], axis=1)
    field_max = max(int(counts.max(initial=0)), 1)   # bias fields hold 1
    bits = max(int(np.ceil(np.log2(field_max + 1))), 1)
    npack = max(24 // bits, 1)
    return bits, npack


def bitmm_auto_chunk(n_trees: int, nodes_per_tree: int) -> int:
    """Default tree-tile size: ~16k nodes per tile."""
    return min(n_trees, max(1, 16384 // max(nodes_per_tree, 1)))


def bitmm_pack_arrays(forest: Forest):
    """Host-side packed clearbits: returns (packed (T,N,G) f32,
    bias (T,G) f32, bits, npack).  Shared by the torch engine and the
    CUDA kernel's host glue."""
    T, L, N = forest.n_trees, forest.n_leaves, forest.nodes_per_tree
    valid = forest.feature >= 0
    lo = np.where(valid, forest.leaf_lo, 0)
    mid = np.where(valid, forest.leaf_mid, 0)
    bits, npack = bitmm_field_layout(forest)
    G = (L + npack - 1) // npack
    Lp = G * npack

    # packed interval weights via cumulative per-group weight table:
    # CW[l, g] = sum of 2^(bits*(l'%npack)) over l' < l with l'//npack == g,
    # so a node's row is CW[mid] - CW[lo].
    w = np.power(2.0, bits * (np.arange(Lp) % npack))
    gid = np.arange(Lp) // npack
    CW = np.zeros((Lp + 1, G))
    np.add.at(CW, (np.arange(Lp) + 1, gid), w)
    CW = np.cumsum(CW, axis=0)
    packed = (CW[mid] - CW[lo]) * valid[..., None]            # (T, N, G)
    bias = CW[Lp][None] - CW[forest.n_leaves_per_tree]        # (T, G)
    return packed.astype(np.float32), bias.astype(np.float32), bits, npack


def compile_qs_bitmm(forest: Forest, tree_chunk: Optional[int] = None,
                     device=None) -> CompiledBitMM:
    """Compile the bit-matmul engine.  ``tree_chunk`` bounds peak memory:
    evaluation loops over tiles of that many trees (auto: ~16k nodes per
    tile)."""
    return CompiledBitMM(forest, tree_chunk, resolve_device(device))


def bitmm_exit_leaf(words: torch.Tensor, *, bits: int, npack: int,
                    n_leaves: int) -> torch.Tensor:
    """Packed clear-count words (..., G), exact integers below 2^24 held
    as int64 → exit leaf (...,) int64.

    Lowest-zero-field borrow trick: ``(v - lo) & ~v & hi`` flags the high
    bit of every zero field; borrows only corrupt flags *above* the lowest
    genuine zero, so the least-significant set bit is always the true
    first surviving leaf of the word.  The reference subtracts in uint32;
    ``hi`` has no bit at or above 2^24, so the int64 difference gives the
    same flags.  Rows with no survivor (padding trees) map to 0."""
    G = words.shape[-1]
    lo_mask = bitmm_full_word(bits, npack)
    hi_mask = lo_mask << (bits - 1)
    v = words
    t = (v - lo_mask) & ~v & hi_mask
    fidx = ctz32(t) // bits
    big = G * npack + 1
    gidx = torch.arange(G, device=words.device)
    cand = torch.where(t != 0, gidx * npack + fidx, big)
    leaf = cand.min(dim=-1).values
    return torch.where(leaf < n_leaves, leaf, 0)


def bitmm_scores(X: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                 packed: torch.Tensor, bias: torch.Tensor,
                 leaf_val: torch.Tensor, acc_dtype: torch.dtype, *,
                 bits: int, npack: int, n_leaves: int,
                 tree_chunk: Optional[int] = None,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw leaf sums (B, C) in ``acc_dtype``: ``eval_batch_bitmm``'s
    arithmetic over tiles of ``tree_chunk`` trees (``None``: as many as
    keep a tile's float64 intermediates within ``_CHUNK_BYTES``).

    The contraction runs in float64: the 0/1 conditions times the packed
    integer words (below 2^24, as float32 or int32) are exact there in
    any summation order and whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says (TF32 would round the
    words to 11 significant bits).  ``valid=None`` means padding nodes
    carry zero packed rows (the kernel's padded arrays)."""
    B = X.shape[0]
    T, N = feat.shape
    G = packed.shape[-1]
    if tree_chunk is None:
        tree_chunk = max(1, _CHUNK_BYTES // max(B * 8 * (N + 2 * G), 1))
    score = torch.zeros((B, leaf_val.shape[-1]), dtype=acc_dtype,
                        device=X.device)
    for t0 in range(0, T, tree_chunk):
        t1 = min(t0 + tree_chunk, T)
        cond = X[:, feat[t0:t1].long()] > thr[t0:t1][None]      # (B, Tc, N)
        if valid is not None:
            cond &= valid[t0:t1][None]
        cleared = torch.bmm(cond.transpose(0, 1).to(torch.float64),
                            packed[t0:t1].to(torch.float64))    # (Tc, B, G)
        words = cleared.to(torch.int64) \
            + bias[t0:t1].to(torch.int64)[:, None, :]
        leaf = bitmm_exit_leaf(words, bits=bits, npack=npack,
                               n_leaves=n_leaves).T             # (B, Tc)
        trees = torch.arange(t0, t1, device=X.device)
        vals = leaf_val[trees[None, :], leaf]                   # (B, Tc, C)
        score += vals.to(acc_dtype).sum(dim=1, dtype=acc_dtype)
    return score


def eval_batch_bitmm(bm: CompiledBitMM, X: torch.Tensor) -> torch.Tensor:
    """Bit-matmul QuickScorer: X (B, d) → scores (B, C) float32.  A loop
    over tiles of ``bm.tree_chunk`` trees keeps peak memory at
    O(B × tree_chunk × max(N, G))."""
    acc_dtype = acc_dtype_for(bm.leaf_val.dtype, bm.acc_bits)
    score = bitmm_scores(X, bm.feat, bm.thr, bm.packed, bm.bias,
                         bm.leaf_val, acc_dtype, bits=bm.bits,
                         npack=bm.npack, n_leaves=bm.n_leaves,
                         tree_chunk=bm.tree_chunk, valid=bm.valid)
    return score.to(torch.float32) / bm.leaf_scale


class BitMMPredictor(BasePredictor):
    """Bit-matmul engine wrapper on the shared base."""

    def __init__(self, bm: CompiledBitMM, eval_fn=None):
        super().__init__(bm, eval_fn or eval_batch_bitmm)
        self.bm = bm


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


# --------------------------------------------------------------------------- #
# Registry entries
# --------------------------------------------------------------------------- #
def _bitmm_layout(forest: Forest, plan) -> str:
    """Pipeline layout hook: pick the leaf packing + tree tiling."""
    bits, npack = bitmm_field_layout(forest)
    if plan.n_devices > 1:
        # the tile size must divide the per-shard tree count: that is
        # _bitmm_shard_kw's call, made after the forest is device-padded
        return f"leaf-pack {bits}b×{npack}, tree_chunk=per-shard"
    plan.engine_kw.setdefault(
        "tree_chunk", bitmm_auto_chunk(forest.n_trees,
                                       forest.nodes_per_tree))
    return (f"leaf-pack {bits}b×{npack}, "
            f"tree_chunk={plan.engine_kw['tree_chunk']}")


def bitmm_cuda_layout(forest: Forest, plan) -> str:
    """Layout hook for the CUDA bitmm backend (the kernel picks its own
    shared-memory tree chunks)."""
    bits, npack = bitmm_field_layout(forest)
    return f"leaf-pack {bits}b×{npack}, shared-memory tree chunks"


def _bitmm_shard_kw(forest: Forest, n_shards: int) -> dict:
    """Tree-sharded bitmm takes a ``tree_chunk`` that divides the
    per-shard tree count, so the global compile pads no tree and every
    shard tiles its slice the same way (the forest is already padded to a
    multiple of ``n_shards``)."""
    local = forest.n_trees // n_shards
    target = max(1, min(local, bitmm_auto_chunk(forest.n_trees,
                                                forest.nodes_per_tree)))
    chunk = max(d for d in range(1, target + 1) if local % d == 0)
    return {"tree_chunk": chunk}


register_engine(
    "bitvector", backend="torch", tune_name="qs", compile=compile_qs,
    evaluate=eval_batch, predictor_cls=QSPredictor, shardable=True,
    serial_arrays=("feat", "thr", "valid", "masks", "init_idx", "leaf_val"),
    restore=CompiledQS.restore,
    doc="QuickScorer: predicated interval-mask AND-reduction over nodes")
register_engine(
    "bitmm", backend="torch", tune_name="qs-bitmm", compile=compile_qs_bitmm,
    evaluate=eval_batch_bitmm, predictor_cls=BitMMPredictor,
    shardable=True, shard_kw=_bitmm_shard_kw, layout=_bitmm_layout,
    serial_arrays=("feat", "thr", "valid", "packed", "bias", "leaf_val"),
    restore=CompiledBitMM.restore,
    doc="bit-matmul QuickScorer: packed clear-count contraction")
