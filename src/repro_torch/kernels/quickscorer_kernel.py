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
``.replaces`` name the CUDA source and the TPU kernel.  Each kernel has
two routes, chosen by its layout (``qs_layout``, ``bitmm_layout``) from
the row width alone and counted in ``.launches_by_route``: ``"smem_x"``
stages each block's 32 rows of x in shared memory, ``"global_x"`` (rows
too wide for that) gathers x from global memory.

``qs_bitmm_forward`` runs its contraction on the int8 tensor cores, so it
takes the packed words as three byte planes, K-major per tree
(``byte_planes``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.quickscorer import bitmm_scores, qs_scores
from .launch import (H100_SMS, TileLayout, check_out_dtype, check_tensors,
                     kernel_limits, launch, library, node_pad, on_card,
                     round_up, sm_count, tile_layout, tile_shared_bytes,
                     tile_tree_bytes)


# --------------------------------------------------------------------------- #
# qs_forward — QuickScorer bitvector traversal
# --------------------------------------------------------------------------- #
QS_MAX_CHUNK = 16        # trees a block stages per ring stage
QS_NODE_MULTIPLE = 8     # a tree's records in a ring (tile_common.cuh)


def record_words(n_words: int) -> int:
    """32-bit words of one node record (feat, thr, ``n_words`` mask words)
    in 16-byte units: 4 for W <= 2, 8 for W <= 4, 12 for W <= 8."""
    return 4 if n_words <= 2 else 8 if n_words <= 4 else 12


def qs_tree_bytes(n_nodes: int, n_words: int) -> int:
    """Bytes of one tree's node records in the ring of ``qs_forward`` and
    ``cascade_qs_forward``: its nodes rounded up to ``QS_NODE_MULTIPLE``
    (``qs_node_pad`` in tile_common.cuh), one record each."""
    return 4 * round_up(n_nodes, QS_NODE_MULTIPLE) * record_words(n_words)


def qs_shared_bytes(n_nodes: int, n_words: int, n_classes: int,
                    n_features: int, chunk: int, smem_x: bool) -> int:
    """A block's shared bytes, as ``shared_bytes`` in qs_forward.cu: the
    two-stage ring of node records (reused for the 8 warps' partial sums),
    plus the feature-major x tile on the ``smem_x`` route."""
    return tile_shared_bytes(qs_tree_bytes(n_nodes, n_words), n_classes,
                             n_features, chunk, smem_x)


def qs_layout(B: int, d: int, T: int, N: int, W: int, C: int,
              n_sm: int = H100_SMS) -> TileLayout:
    """The route, ring chunk and tree groups of ``qs_forward`` for B rows
    of width d over T trees of N nodes (W leafidx words, C classes) on a
    card of ``n_sm`` SMs (``launch.tile_layout``, trees of one node record
    per node, up to ``QS_MAX_CHUNK`` a stage)."""
    return tile_layout(B, d, T, C, qs_tree_bytes(N, W), QS_MAX_CHUNK,
                       f"one tree's node records ({N} nodes x {W} words)",
                       n_sm)


def qs_forward_limits(feat, thr, masks, init_idx, leaf_val) -> None:
    """Raise ``ValueError``, naming ``backend="torch"``, unless the kernel
    takes these operands (numpy or torch; only their shapes are read): at
    most ``MAX_WORDS`` leafidx words and ``MAX_CLASSES`` classes."""
    kernel_limits("qs_forward", feat.shape[1], leaf_val.shape[-1],
                  n_words=masks.shape[-1])


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
    qs_forward_limits(feat, thr, masks, init_idx, leaf_val)
    out = torch.empty((B, C), dtype=out_dtype, device=x.device)
    if B == 0:
        return out
    lay = qs_layout(B, d, T, N, W, C, sm_count(x.device.index or 0))
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
# qs_bitmm_forward — bit-matmul QuickScorer on the int8 tensor cores
# --------------------------------------------------------------------------- #
BITMM_MAX_CHUNK = 8      # trees a block stages per ring stage: one a warp


def byte_planes(packed) -> np.ndarray:
    """Packed words (T, N, G), integers below 2^24 → the kernel's byte
    planes (T, 3, G, Npad) uint8, K-major per tree: byte p of word
    [t, n, g] at [t, p, g, n], zero past N (Npad = ``node_pad(N)``)."""
    w = np.asarray(packed).astype(np.int64)
    if w.size and (w.min() < 0 or w.max() >= 1 << 24):
        raise ValueError("packed words must lie in [0, 2^24)")
    T, N, G = w.shape
    planes = np.zeros((T, 3, G, node_pad(N)), dtype=np.uint8)
    for p in range(3):
        planes[:, p, :, :N] = ((w >> (8 * p)) & 0xFF).transpose(0, 2, 1)
    return planes


def packed_words(planes: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """The inverse of ``byte_planes``: (T, N, G) int32 words."""
    p = planes.to(torch.int32)
    w = p[:, 0] | (p[:, 1] << 8) | (p[:, 2] << 16)          # (T, G, Npad)
    return w[..., :n_nodes].transpose(1, 2).contiguous()


def bitmm_layout(B: int, d: int, T: int, N: int, G: int, C: int,
                 n_sm: int = H100_SMS) -> TileLayout:
    """The route, ring chunk and tree groups of ``qs_bitmm_forward``
    (``launch.tile_layout``; a tree is its node records, 3 planes of G
    rows rounded up to 8, and G bias words rounded up to 8)."""
    tree_bytes = tile_tree_bytes(N, 3 * round_up(G, 8), G)
    return tile_layout(B, d, T, C, tree_bytes, BITMM_MAX_CHUNK,
                       f"one tree's packed words ({N} nodes x {G} groups)",
                       n_sm)


def qs_bitmm_forward_limits(feat, thr, planes, bias, leaf_val) -> None:
    """Raise ``ValueError``, naming ``backend="torch"``, unless the kernel
    takes these operands (numpy or torch; only their shapes are read): at
    most ``MAX_NODES`` nodes per tree and ``MAX_CLASSES`` classes."""
    kernel_limits("qs_bitmm_forward", feat.shape[1], leaf_val.shape[-1])


def qs_bitmm_forward_reference(x, feat, thr, planes, bias, leaf_val, *,
                               bits: int, npack: int, n_leaves: int,
                               out_dtype=torch.float32) -> torch.Tensor:
    """The plain torch version: ``eval_batch_bitmm``'s arithmetic on the
    padded kernel arrays (padding nodes carry +inf thresholds and zero
    packed rows; padding trees a full bias word and zero leaf rows), the
    words put back together from their byte planes, taken over tree
    chunks.  Raw leaf sums (B, C) in ``out_dtype``."""
    packed = packed_words(planes, feat.shape[1])
    return bitmm_scores(x, feat, thr, packed, bias, leaf_val, out_dtype,
                        bits=bits, npack=npack, n_leaves=n_leaves)


def _check_bitmm(x, feat, thr, planes, bias, leaf_val, bits, npack,
                 n_leaves, out_dtype):
    check_tensors(
        x, dict(x=x, feat=feat, thr=thr, planes=planes, bias=bias,
                leaf_val=leaf_val),
        dict(x=torch.float32, feat=torch.int32, thr=torch.float32,
             planes=torch.uint8, bias=torch.int32, leaf_val=torch.float32),
        dict(x=2, feat=2, thr=2, planes=4, bias=2, leaf_val=3))
    T, N = feat.shape
    G = bias.shape[-1]
    L = leaf_val.shape[1]
    p_shape = (T, 3, G, node_pad(N))
    if thr.shape != (T, N) or planes.shape != p_shape or \
            bias.shape[0] != T or leaf_val.shape[0] != T:
        raise ValueError(
            f"inconsistent shapes: feat {tuple(feat.shape)}, thr "
            f"{tuple(thr.shape)}, planes {tuple(planes.shape)} (expected "
            f"{p_shape}), bias {tuple(bias.shape)}, leaf_val "
            f"{tuple(leaf_val.shape)}")
    if not (1 <= bits and 1 <= npack and bits * npack <= 24):
        raise ValueError(f"bits={bits}, npack={npack}: fields must fit the "
                         "24 bits of a packed word")
    if not 1 <= n_leaves <= min(L, G * npack):
        raise ValueError(f"n_leaves={n_leaves} outside 1..{min(L, G * npack)}"
                         f" (L={L}, {G} groups of {npack})")
    check_out_dtype(out_dtype)


def qs_bitmm_forward(x, feat, thr, planes, bias, leaf_val, *, bits: int,
                     npack: int, n_leaves: int,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Padded kernel arrays → raw leaf sums (B, C) in ``out_dtype``.

    x (B, d) f32; feat (T, N) i32; thr (T, N) f32; planes (T, 3, G, Npad)
    uint8, the ``byte_planes`` of the packed clear-count words (integers
    below 2^24, the words of ``bitmm_pack_arrays``); bias (T, G) int32;
    leaf_val (T, L, C) f32 (exact integers for int-accum forests, which
    use ``out_dtype=torch.int32``).  Leaf ``l`` is field ``l % npack`` of
    group ``l // npack``, ``bits`` wide.  Every ``feat`` entry must be
    < d: the kernel gathers without a bounds check."""
    _check_bitmm(x, feat, thr, planes, bias, leaf_val, bits, npack,
                 n_leaves, out_dtype)
    if not on_card(x, "qs_bitmm_forward"):
        return qs_bitmm_forward_reference(
            x, feat, thr, planes, bias, leaf_val, bits=bits, npack=npack,
            n_leaves=n_leaves, out_dtype=out_dtype)
    B, d = x.shape
    T, N = feat.shape
    G = bias.shape[-1]
    L, C = leaf_val.shape[1:]
    qs_bitmm_forward_limits(feat, thr, planes, bias, leaf_val)
    out = torch.empty((B, C), dtype=out_dtype, device=x.device)
    if B == 0:
        return out
    lay = bitmm_layout(B, d, T, N, G, C, sm_count(x.device.index or 0))
    partial = torch.empty((lay.n_groups, B, C), dtype=out_dtype,
                          device=x.device)
    lib = library("qs_bitmm_forward", "qs_bitmm_forward_launch",
                  "qs_bitmm_error_string", 8, 15)
    launch(lib.qs_bitmm_forward_launch, lib.qs_bitmm_error_string,
           "qs_bitmm_forward", x.device, x.data_ptr(), feat.data_ptr(),
           thr.data_ptr(), planes.data_ptr(), bias.data_ptr(),
           leaf_val.data_ptr(), partial.data_ptr(), out.data_ptr(), B, d, T,
           N, G, L, C, n_leaves, bits, npack, lay.chunk, lay.group_trees,
           int(lay.route == "smem_x"), lay.shared_bytes,
           int(out_dtype == torch.int32))
    qs_bitmm_forward.launches += 1
    qs_bitmm_forward.launches_by_route[lay.route] += 1
    return out


qs_bitmm_forward.launches = 0
qs_bitmm_forward.launches_by_route = {"smem_x": 0, "global_x": 0}
qs_bitmm_forward.source = "src/repro_torch/kernels/csrc/qs_bitmm_forward.cu"
qs_bitmm_forward.replaces = "src/repro/kernels/quickscorer_kernel.py:240"
