"""CUDA kernels: QuickScorer bitvector and bit-matmul traversal, hand-written
for Hopper.

``qs_forward`` and ``qs_bitmm_forward`` replace the Pallas TPU kernels of
the same names (``repro/kernels/quickscorer_kernel.py:130`` and ``:240``).
For a CUDA tensor each launches its source in ``csrc/`` (built by
``kernels/build.py``) on the current stream, or raises; for a CPU tensor
it runs its ``*_reference``, the same function in plain torch.  Nothing
falls back from one to the other.

Each wrapper's ``.launches`` counts its kernel's launches, so a run can
show that its main path went through the kernel; ``.source`` and
``.replaces`` name the CUDA source and the TPU kernel.  ``qs_forward``
has two routes, chosen by ``qs_layout`` from the row width alone and
counted in ``qs_forward.launches_by_route``: ``"smem_x"`` stages each
block's 32 rows of x in shared memory, ``"global_x"`` (rows too wide for
that) gathers x from global memory.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.quickscorer import bitmm_scores, qs_scores
from .launch import (MAX_CLASSES, MAX_NODES, MAX_SHARED_BYTES,
                     check_out_dtype, check_tensors, launch, library, on_card,
                     trees_per_block)

MAX_WORDS = 8            # leafidx words a thread keeps in registers (L <= 256)


def tree_chunk(n_trees: int, n_nodes: int, n_words: int) -> int:
    """Trees per block of the bitmm kernel: feat, thr and ``n_words``
    packed words per node plus ``n_words`` bias words per tree, 4 bytes
    each.  (``qs_forward`` has its own layout, ``qs_layout``.)"""
    return trees_per_block(n_trees, 4 * (n_nodes * (2 + n_words) + n_words))


# --------------------------------------------------------------------------- #
# qs_forward — QuickScorer bitvector traversal
# --------------------------------------------------------------------------- #
# csrc/qs_forward.cu: a block is QS_ROWS rows (lane = row) x QS_WARPS warps
# (warp = tree slice); x_s keeps QS_X_STRIDE words per feature
QS_ROWS, QS_WARPS, QS_X_STRIDE = 32, 8, 33
QS_MAX_CHUNK = 16        # trees a block stages per ring stage
SM_SHARED_BYTES = 233472           # shared memory of one SM (228 KB)
BLOCK_RESERVED_BYTES = 1024        # of it reserved per resident block
MAX_THREADS_PER_SM = 2048
H100_SMS = 132
# The tree groups are sized for a batch of this many rows (ForestServer's
# largest bucket) whatever the batch, so a row's float sum keeps one order
QS_GROUP_ROWS = 1024


def record_words(n_words: int) -> int:
    """32-bit words of one node record (feat, thr, ``n_words`` mask words)
    in 16-byte units: 4 for W <= 2, 8 for W <= 4, 12 for W <= 8."""
    return 4 if n_words <= 2 else 8 if n_words <= 4 else 12


@dataclasses.dataclass(frozen=True)
class QsLayout:
    """How ``qs_forward`` cuts its work: ``row_blocks`` x ``n_groups``
    blocks, each walking ``group_trees`` trees, ``chunk`` at a time through
    its shared-memory ring, in ``shared_bytes`` of shared memory."""
    route: str               # "smem_x" or "global_x"
    chunk: int
    group_trees: int
    n_groups: int
    row_blocks: int
    shared_bytes: int
    blocks_per_sm: int


def qs_shared_bytes(n_nodes: int, n_words: int, n_classes: int,
                    n_features: int, chunk: int, smem_x: bool) -> int:
    """A block's shared bytes, as ``shared_bytes`` in qs_forward.cu: the
    two-stage ring of node records (reused for the 8 warps' partial sums),
    plus the feature-major x tile on the ``smem_x`` route."""
    ring = 2 * chunk * n_nodes * record_words(n_words)
    part = QS_WARPS * QS_ROWS * n_classes
    return 4 * (max(ring, part) + (QS_X_STRIDE * n_features if smem_x else 0))


def qs_layout(B: int, d: int, T: int, N: int, W: int, C: int,
              n_sm: int = H100_SMS) -> QsLayout:
    """The route, ring chunk and tree groups of ``qs_forward`` for B rows
    of width d over T trees of N nodes (W leafidx words, C classes) on a
    card of ``n_sm`` SMs.

    x is staged in shared memory when 32 rows of it fit beside a ring of
    one tree.  The ring then takes as many trees as fit, up to
    ``QS_MAX_CHUNK``.  The tree groups are as many as one wave of
    resident blocks can hold at ``QS_GROUP_ROWS`` rows (blocks per SM from
    the shared bytes), rounded so every group but the last holds the same
    whole chunks.  Only ``row_blocks`` depends on B: a row's trees are
    summed in the same order in every batch, so float scores do not
    change with the batch a row lands in."""
    smem_x = qs_shared_bytes(N, W, C, d, 1, True) <= MAX_SHARED_BYTES
    x_bytes = 4 * QS_X_STRIDE * d if smem_x else 0
    per_tree = 2 * 4 * N * record_words(W)
    chunk = max(1, min(QS_MAX_CHUNK, T,
                       (MAX_SHARED_BYTES - x_bytes) // max(per_tree, 1)))
    shared = qs_shared_bytes(N, W, C, d, chunk, smem_x)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"one tree's node records ({N} nodes x {W} words) "
                         f"exceed the {MAX_SHARED_BYTES} bytes of shared "
                         "memory a block may hold")
    blocks_per_sm = max(1, min(MAX_THREADS_PER_SM // (QS_ROWS * QS_WARPS),
                               SM_SHARED_BYTES
                               // (shared + BLOCK_RESERVED_BYTES)))
    n_chunks = -(-T // chunk)
    groups = max(1, min(n_chunks,
                        blocks_per_sm * n_sm * QS_ROWS // QS_GROUP_ROWS))
    group_trees = max(1, -(-n_chunks // groups)) * chunk
    return QsLayout(route="smem_x" if smem_x else "global_x", chunk=chunk,
                    group_trees=group_trees, n_groups=-(-T // group_trees),
                    row_blocks=-(-B // QS_ROWS), shared_bytes=shared,
                    blocks_per_sm=blocks_per_sm)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def qs_forward_reference(x, feat, thr, masks, init_idx, leaf_val, *,
                         out_dtype=torch.float32) -> torch.Tensor:
    """The plain torch version: ``eval_batch``'s arithmetic on the padded
    kernel arrays (padding nodes carry thresholds no input exceeds;
    padding trees have init_idx 0 and zero leaf rows), taken over tree
    chunks.  Raw leaf sums (B, C) in ``out_dtype``."""
    return qs_scores(x, feat, thr, masks, init_idx, leaf_val, out_dtype)


def _check(x, feat, thr, masks, init_idx, leaf_val, out_dtype):
    check_tensors(
        x, dict(x=x, feat=feat, thr=thr, masks=masks, init_idx=init_idx,
                leaf_val=leaf_val),
        dict(x=torch.float32, feat=torch.int32, thr=torch.float32,
             masks=torch.int32, init_idx=torch.int32,
             leaf_val=torch.float32),
        dict(x=2, feat=2, thr=2, masks=3, init_idx=2, leaf_val=3))
    T, N = feat.shape
    W = masks.shape[-1]
    L, C = leaf_val.shape[1:]
    if thr.shape != (T, N) or masks.shape[:2] != (T, N) or \
            init_idx.shape != (T, W) or leaf_val.shape[0] != T:
        raise ValueError(
            f"inconsistent shapes: feat {tuple(feat.shape)}, thr "
            f"{tuple(thr.shape)}, masks {tuple(masks.shape)}, init_idx "
            f"{tuple(init_idx.shape)}, leaf_val {tuple(leaf_val.shape)}")
    if L > 32 * W:
        raise ValueError(f"{L} leaves need more than {W} leafidx words")
    check_out_dtype(out_dtype)


def qs_forward(x, feat, thr, masks, init_idx, leaf_val, *,
               out_dtype=torch.float32) -> torch.Tensor:
    """Padded kernel arrays → raw leaf sums (B, C) in ``out_dtype``.

    x (B, d) f32; feat (T, N) i32; thr (T, N) f32; masks (T, N, W) and
    init_idx (T, W) int32 bit patterns of uint32 words; leaf_val
    (T, L, C) f32 (exact integers for int-accum forests, which use
    ``out_dtype=torch.int32``).  Every ``feat`` entry must be < d: the
    kernel gathers without a bounds check (``ops.cuda_qs_predictor``
    checks it on the host)."""
    _check(x, feat, thr, masks, init_idx, leaf_val, out_dtype)
    if not on_card(x, "qs_forward"):
        return qs_forward_reference(x, feat, thr, masks, init_idx, leaf_val,
                                    out_dtype=out_dtype)
    B, d = x.shape
    T, N = feat.shape
    W = masks.shape[-1]
    L, C = leaf_val.shape[1:]
    if W > MAX_WORDS or C > MAX_CLASSES:
        raise ValueError(f"the kernel takes at most {MAX_WORDS} leafidx "
                         f"words (L <= {32 * MAX_WORDS}) and {MAX_CLASSES} "
                         f"classes; got W={W}, C={C}")
    out = torch.empty((B, C), dtype=out_dtype, device=x.device)
    if B == 0:
        return out
    lay = qs_layout(B, d, T, N, W, C, _sm_count(x.device.index or 0))
    partial = torch.empty((lay.n_groups, B, C), dtype=out_dtype,
                          device=x.device)
    lib = library("qs_forward", "qs_forward_launch", "qs_error_string", 8, 12)
    launch(lib.qs_forward_launch, lib.qs_error_string, "qs_forward",
           x.device, x.data_ptr(), feat.data_ptr(), thr.data_ptr(),
           masks.data_ptr(), init_idx.data_ptr(), leaf_val.data_ptr(),
           partial.data_ptr(), out.data_ptr(), B, d, T, N, W, L, C,
           lay.chunk, lay.group_trees, int(lay.route == "smem_x"),
           lay.shared_bytes, int(out_dtype == torch.int32))
    qs_forward.launches += 1
    qs_forward.launches_by_route[lay.route] += 1
    return out


qs_forward.launches = 0
qs_forward.launches_by_route = {"smem_x": 0, "global_x": 0}
qs_forward.source = "src/repro_torch/kernels/csrc/qs_forward.cu"
qs_forward.replaces = "src/repro/kernels/quickscorer_kernel.py:130"


# --------------------------------------------------------------------------- #
# qs_bitmm_forward — bit-matmul QuickScorer
# --------------------------------------------------------------------------- #
def qs_bitmm_forward_reference(x, feat, thr, packed, bias, leaf_val, *,
                               bits: int, npack: int, n_leaves: int,
                               out_dtype=torch.float32) -> torch.Tensor:
    """The plain torch version: ``eval_batch_bitmm``'s arithmetic on the
    padded kernel arrays (padding nodes carry +inf thresholds and zero
    packed rows; padding trees a full bias word and zero leaf rows),
    taken over tree chunks.  Raw leaf sums (B, C) in ``out_dtype``."""
    return bitmm_scores(x, feat, thr, packed, bias, leaf_val, out_dtype,
                        bits=bits, npack=npack, n_leaves=n_leaves)


def _check_bitmm(x, feat, thr, packed, bias, leaf_val, bits, npack,
                 n_leaves, out_dtype):
    check_tensors(
        x, dict(x=x, feat=feat, thr=thr, packed=packed, bias=bias,
                leaf_val=leaf_val),
        dict(x=torch.float32, feat=torch.int32, thr=torch.float32,
             packed=torch.int32, bias=torch.int32, leaf_val=torch.float32),
        dict(x=2, feat=2, thr=2, packed=3, bias=2, leaf_val=3))
    T, N = feat.shape
    G = packed.shape[-1]
    L = leaf_val.shape[1]
    if thr.shape != (T, N) or packed.shape[:2] != (T, N) or \
            bias.shape != (T, G) or leaf_val.shape[0] != T:
        raise ValueError(
            f"inconsistent shapes: feat {tuple(feat.shape)}, thr "
            f"{tuple(thr.shape)}, packed {tuple(packed.shape)}, bias "
            f"{tuple(bias.shape)}, leaf_val {tuple(leaf_val.shape)}")
    if not (1 <= bits and 1 <= npack and bits * npack <= 24):
        raise ValueError(f"bits={bits}, npack={npack}: fields must fit the "
                         "24 bits of a packed word")
    if not 1 <= n_leaves <= min(L, G * npack):
        raise ValueError(f"n_leaves={n_leaves} outside 1..{min(L, G * npack)}"
                         f" (L={L}, {G} groups of {npack})")
    check_out_dtype(out_dtype)


def qs_bitmm_forward(x, feat, thr, packed, bias, leaf_val, *, bits: int,
                     npack: int, n_leaves: int,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Padded kernel arrays → raw leaf sums (B, C) in ``out_dtype``.

    x (B, d) f32; feat (T, N) i32; thr (T, N) f32; packed (T, N, G) and
    bias (T, G) int32 holding the packed clear-count words (integers below
    2^24, the uint32 words of ``bitmm_pack_arrays``); leaf_val (T, L, C)
    f32 (exact integers for int-accum forests, which use
    ``out_dtype=torch.int32``).  Leaf ``l`` is field ``l % npack`` of
    group ``l // npack``, ``bits`` wide.  Every ``feat`` entry must be
    < d: the kernel gathers without a bounds check."""
    _check_bitmm(x, feat, thr, packed, bias, leaf_val, bits, npack,
                 n_leaves, out_dtype)
    if not on_card(x, "qs_bitmm_forward"):
        return qs_bitmm_forward_reference(
            x, feat, thr, packed, bias, leaf_val, bits=bits, npack=npack,
            n_leaves=n_leaves, out_dtype=out_dtype)
    B, d = x.shape
    T, N = feat.shape
    G = packed.shape[-1]
    L, C = leaf_val.shape[1:]
    if N > MAX_NODES or C > MAX_CLASSES:
        raise ValueError(f"the kernel takes at most {MAX_NODES} nodes per "
                         f"tree (L <= {MAX_NODES + 1}) and {MAX_CLASSES} "
                         f"classes; got N={N}, C={C}")
    tc = tree_chunk(T, N, G)
    if 4 * tc * (N * (2 + G) + G) > MAX_SHARED_BYTES:
        raise ValueError(f"one tree's packed words ({N} nodes x {G} groups)"
                         f" exceed the {MAX_SHARED_BYTES} bytes of shared "
                         "memory a block may hold")
    out = torch.empty((B, C), dtype=out_dtype, device=x.device)
    if B == 0:
        return out
    partial = torch.empty((-(-T // tc), B, C), dtype=out_dtype,
                          device=x.device)
    lib = library("qs_bitmm_forward", "qs_bitmm_forward_launch",
                  "qs_bitmm_error_string", 8, 12)
    launch(lib.qs_bitmm_forward_launch, lib.qs_bitmm_error_string,
           "qs_bitmm_forward", x.device, x.data_ptr(), feat.data_ptr(),
           thr.data_ptr(), packed.data_ptr(), bias.data_ptr(),
           leaf_val.data_ptr(), partial.data_ptr(), out.data_ptr(), B, d, T,
           N, G, L, C, n_leaves, bits, npack, tc,
           int(out_dtype == torch.int32))
    qs_bitmm_forward.launches += 1
    return out


qs_bitmm_forward.launches = 0
qs_bitmm_forward.source = "src/repro_torch/kernels/csrc/qs_bitmm_forward.cu"
qs_bitmm_forward.replaces = "src/repro/kernels/quickscorer_kernel.py:240"
