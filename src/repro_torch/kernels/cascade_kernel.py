"""CUDA kernel: the fused confidence-gated cascade over QuickScorer
bitvector stages, hand-written for Hopper.

``cascade_qs_forward`` replaces the Pallas TPU kernel of the same name
(``repro/kernels/cascade_kernel.py:88``): every stage's tree traversal,
the gate between stages and the survivor mask in one launch.  For a CUDA
tensor it launches ``csrc/cascade_qs_forward.cu`` (built by
``kernels/build.py``) on the current stream, as thread-block clusters of
``cascade_layout(...).cluster`` blocks sharing each 32-row tile, or
raises; for a CPU tensor it runs ``cascade_qs_forward_reference``, the
same function in plain torch.  Nothing falls back from one to the other.

The kernel takes the gate in its device form (``GatePolicy.kernel_gate``:
only the built-in gates have one); the plain version runs the policy's
torch ``decide``, so on the card each holds the other to account.  Its
constants and the stage offsets reach the card once per forest, so a
launch allocates nothing but its outputs and can be captured in a CUDA
graph.

``.launches`` counts the kernel's launches and ``.launches_by_route``
them by x-tile route (``"smem_x"``, or ``"global_x"`` for rows too wide
to stage); ``.source`` and ``.replaces`` name the CUDA source and the TPU
kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..cascade.policy import GATE_SCORE_BOUND
from ..core.quickscorer import qs_scores
from .launch import (BLOCK_RESERVED_BYTES, GROUP_ROWS, H100_SMS,
                     MAX_SHARED_BYTES, MAX_THREADS_PER_SM, SM_SHARED_BYTES,
                     TILE_ROWS, TILE_WARPS, X_STRIDE, check_out_dtype,
                     check_tensors, kernel_limits, launch, library, on_card,
                     sm_count)
from .quickscorer_kernel import qs_tree_bytes

CASCADE_MAX_CHUNK = 16   # trees a block stages per ring stage
MAX_CLUSTER = 8          # blocks of a cluster (the portable limit)


@functools.lru_cache(maxsize=64)
def _device_bounds(stage_bounds: tuple, device: torch.device) -> torch.Tensor:
    """The stage offsets as an int32 tensor on ``device``, made once."""
    return torch.tensor(stage_bounds, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class CascadeLayout:
    """How ``cascade_qs_forward`` cuts its work: clusters of ``cluster``
    blocks share each 32-row tile, every block staging ``chunk`` trees at a
    time through its ring, in ``shared_bytes`` of shared memory."""
    route: str               # "smem_x" or "global_x"
    chunk: int
    cluster: int
    shared_bytes: int
    blocks_per_sm: int


def cascade_shared_bytes(n_nodes: int, n_words: int, n_classes: int,
                         n_features: int, chunk: int, smem_x: bool) -> int:
    """A block's shared bytes, as ``shared_bytes`` in
    cascade_qs_forward.cu: the two-stage ring of node records
    (``qs_tree_bytes`` a tree); the 8
    warps' per-row sums, the block's stage partials (two, by stage
    parity) and the running scores, each 32 rows x C; the active flags,
    exit stages and the tile's flag, padded to 16 bytes; and the
    feature-major x tile on the ``smem_x`` route."""
    ring = 2 * chunk * qs_tree_bytes(n_nodes, n_words)
    words = (TILE_WARPS + 3) * TILE_ROWS * n_classes + 2 * TILE_ROWS + 1
    sums = 4 * -(-words // 4) * 4
    return ring + sums + (4 * X_STRIDE * n_features if smem_x else 0)


def cascade_layout(d: int, N: int, W: int, C: int, n_sm: int = H100_SMS,
                   resident=None) -> CascadeLayout:
    """The route, ring chunk and cluster size of ``cascade_qs_forward``
    for rows of width d over trees of N nodes (W leafidx words, C classes)
    on a card of ``n_sm`` SMs.  No batch size enters: a row's trees are
    split over the cluster and summed in one order in every batch.

    x is staged in shared memory when 32 rows of it fit beside a ring of
    one tree.  The ring then takes as many trees as fit, up to
    ``CASCADE_MAX_CHUNK``.  The cluster is the largest of 1 ..
    ``MAX_CLUSTER`` blocks whose clusters for a batch of ``GROUP_ROWS``
    rows (one a 32-row tile) the card holds at once: ``resident(layout)``
    says how many clusters of a layout it holds (the wrapper asks the card;
    without one, ``blocks_per_sm * n_sm // cluster`` estimates it, which
    overcounts where clusters cannot span the card's GPCs).  Raises if one
    tree's records do not fit, or if the card holds no cluster of the
    layout."""
    fits = cascade_shared_bytes(N, W, C, d, 1, True) <= MAX_SHARED_BYTES
    fixed = cascade_shared_bytes(N, W, C, d, 0, fits)
    tree = 2 * qs_tree_bytes(N, W)
    chunk = max(1, min(CASCADE_MAX_CHUNK,
                       (MAX_SHARED_BYTES - fixed) // max(tree, 1)))
    shared = cascade_shared_bytes(N, W, C, d, chunk, fits)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"one tree's node records ({N} nodes x {W} words) "
                         f"exceed the {MAX_SHARED_BYTES} bytes of shared "
                         "memory a block may hold")
    blocks_per_sm = max(1, min(MAX_THREADS_PER_SM // (TILE_ROWS * TILE_WARPS),
                               SM_SHARED_BYTES
                               // (shared + BLOCK_RESERVED_BYTES)))
    layouts = [CascadeLayout(route="smem_x" if fits else "global_x",
                             chunk=chunk, cluster=g, shared_bytes=shared,
                             blocks_per_sm=blocks_per_sm)
               for g in range(1, MAX_CLUSTER + 1)]
    if resident is None:
        def resident(lay):
            return blocks_per_sm * n_sm // lay.cluster
    tiles = GROUP_ROWS // TILE_ROWS
    lay = next((lay for lay in layouts[::-1] if resident(lay) >= tiles),
               layouts[0])
    if resident(lay) < 1:
        raise RuntimeError(f"cascade_qs_forward: the card holds no cluster "
                           f"of {lay.cluster} blocks of {shared} shared "
                           "bytes")
    return lay


def cascade_qs_forward_limits(feat, thr, masks, init_idx, leaf_val) -> None:
    """Raise ``ValueError``, naming ``backend="torch"``, unless the kernel
    takes these operands (numpy or torch; only their shapes are read): at
    most ``MAX_WORDS`` leafidx words and ``MAX_CLASSES`` classes."""
    kernel_limits("cascade_qs_forward", feat.shape[1], leaf_val.shape[-1],
                  n_words=masks.shape[-1])


def cascade_qs_forward_reference(x, valid, feat, thr, masks, init_idx,
                                 leaf_val, *, stage_bounds, policy,
                                 inv_scale: float,
                                 out_dtype=torch.float32):
    """The plain torch version: per stage, ``qs_scores`` over the stage's
    slice of the concatenated arrays for the rows still active, then
    ``policy.decide`` on the running scores times ``inv_scale``.
    Returns ``(scores (B, C) raw leaf units, exit_stage (B,) int32)``."""
    B = x.shape[0]
    K = len(stage_bounds) - 1
    C = leaf_val.shape[-1]
    out = torch.zeros((B, C), dtype=out_dtype, device=x.device)
    exit_stage = torch.full((B,), K - 1, dtype=torch.int32, device=x.device)
    active = valid.clone()
    inv = torch.tensor(inv_scale, dtype=torch.float32, device=x.device)
    for k in range(K):
        idx = torch.nonzero(active).flatten()
        if idx.numel() == 0:
            break
        a, b = stage_bounds[k], stage_bounds[k + 1]
        out[idx] += qs_scores(x[idx], feat[a:b], thr[a:b], masks[a:b],
                              init_idx[a:b], leaf_val[a:b], out_dtype)
        if k == K - 1:
            break
        ex = policy.decide(out.to(torch.float32) * inv, k) & active
        exit_stage[ex] = k
        active &= ~ex
    return out, exit_stage


def _check(x, valid, feat, thr, masks, init_idx, leaf_val, stage_bounds,
           out_dtype):
    check_tensors(
        x, dict(x=x, valid=valid, feat=feat, thr=thr, masks=masks,
                init_idx=init_idx, leaf_val=leaf_val),
        dict(x=torch.float32, valid=torch.bool, feat=torch.int32,
             thr=torch.float32, masks=torch.int32, init_idx=torch.int32,
             leaf_val=torch.float32),
        dict(x=2, valid=1, feat=2, thr=2, masks=3, init_idx=2, leaf_val=3))
    T, N = feat.shape
    W = masks.shape[-1]
    L = leaf_val.shape[1]
    if valid.shape != x.shape[:1] or thr.shape != (T, N) or \
            masks.shape[:2] != (T, N) or init_idx.shape != (T, W) or \
            leaf_val.shape[0] != T:
        raise ValueError(
            f"inconsistent shapes: x {tuple(x.shape)}, valid "
            f"{tuple(valid.shape)}, feat {tuple(feat.shape)}, thr "
            f"{tuple(thr.shape)}, masks {tuple(masks.shape)}, init_idx "
            f"{tuple(init_idx.shape)}, leaf_val {tuple(leaf_val.shape)}")
    if L > 32 * W:
        raise ValueError(f"{L} leaves need more than {W} leafidx words")
    sb = list(stage_bounds)
    if len(sb) < 2 or sb[0] != 0 or sb[-1] != T or \
            any(b < a for a, b in zip(sb, sb[1:])):
        raise ValueError(f"stage_bounds {tuple(sb)} must rise from 0 to "
                         f"the {T} trees")
    check_out_dtype(out_dtype)


def cascade_qs_forward(x, valid, feat, thr, masks, init_idx, leaf_val, *,
                       stage_bounds, policy, inv_scale: float,
                       out_dtype=torch.float32):
    """Stage-concatenated kernel arrays → ``(scores (B, C) raw leaf units
    in out_dtype, exit_stage (B,) int32)``; ``exit_stage`` is K-1 for rows
    that never exit and for rows with ``valid`` False (whose scores are
    0).

    x (B, d) f32; valid (B,) bool; feat (T, N) i32; thr (T, N) f32; masks
    (T, N, W) and init_idx (T, W) int32 bit patterns; leaf_val (T, L, C)
    f32 (exact integers for int-accum forests, which use
    ``out_dtype=torch.int32``); ``stage_bounds`` the K+1 tree offsets of
    the stages; ``policy`` a prepared ``GatePolicy``, whose ``decide``
    sees the running scores times ``inv_scale``.  Every ``feat`` entry
    must be < d: the kernel gathers without a bounds check."""
    _check(x, valid, feat, thr, masks, init_idx, leaf_val, stage_bounds,
           out_dtype)
    if not on_card(x, "cascade_qs_forward"):
        return cascade_qs_forward_reference(
            x, valid, feat, thr, masks, init_idx, leaf_val,
            stage_bounds=stage_bounds, policy=policy, inv_scale=inv_scale,
            out_dtype=out_dtype)
    B, d = x.shape
    N = feat.shape[1]
    W = masks.shape[-1]
    L, C = leaf_val.shape[1:]
    K = len(stage_bounds) - 1
    cascade_qs_forward_limits(feat, thr, masks, init_idx, leaf_val)
    gate = policy.kernel_gate(K)
    consts = gate.operands(inv_scale, x.device)
    want = 5 + (2 * (K - 1) * C if gate.kind == GATE_SCORE_BOUND else 0)
    if gate.consts.shape != (want,):
        raise ValueError(f"gate constants of shape {gate.consts.shape} for "
                         f"{K} stages and {C} classes; expected ({want},)")
    bounds = _device_bounds(tuple(stage_bounds), x.device)
    out = torch.empty((B, C), dtype=out_dtype, device=x.device)
    exit_stage = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return out, exit_stage
    int_accum = int(out_dtype == torch.int32)
    lay = _card_layout(x.device.index or 0, d, N, W, L, C, int_accum)
    lib = library("cascade_qs_forward", "cascade_qs_forward_launch",
                  "cascade_error_string", 11, 14)
    launch(lib.cascade_qs_forward_launch, lib.cascade_error_string,
           "cascade_qs_forward", x.device, x.data_ptr(), valid.data_ptr(),
           feat.data_ptr(), thr.data_ptr(), masks.data_ptr(),
           init_idx.data_ptr(), leaf_val.data_ptr(), bounds.data_ptr(),
           consts.data_ptr(), out.data_ptr(), exit_stage.data_ptr(), B, d,
           N, W, L, C, K, lay.chunk, lay.cluster,
           int(lay.route == "smem_x"), lay.shared_bytes, gate.kind,
           int(gate.votes), int_accum)
    cascade_qs_forward.launches += 1
    cascade_qs_forward.launches_by_route[lay.route] += 1
    return out, exit_stage


def resident_clusters(lay: CascadeLayout, d: int, N: int, W: int, L: int,
                      C: int, int_accum: int, index: int = 0) -> int:
    """How many clusters of ``lay`` card ``index`` holds at once, by
    ``cudaOccupancyMaxActiveClusters`` for the kernel instance these
    operands launch (0: such a launch could never run)."""
    lib = library("cascade_qs_forward", "cascade_qs_forward_launch",
                  "cascade_error_string", 11, 14)
    fn = lib.cascade_max_active_clusters
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(d, N, W, L, C, lay.chunk, lay.cluster,
                 int(lay.route == "smem_x"), lay.shared_bytes, int_accum,
                 ctypes.byref(n))
    if err != 0:
        raise RuntimeError("cascade_qs_forward cluster occupancy query "
                           "failed: " + lib.cascade_error_string(err).decode())
    return n.value


@functools.lru_cache(maxsize=None)
def _card_layout(index: int, d: int, N: int, W: int, L: int, C: int,
                 int_accum: int) -> CascadeLayout:
    """``cascade_layout`` on card ``index``, its clusters counted by
    ``resident_clusters``; made once per forest shape, so a launch after
    the first calls nothing but the kernel."""
    return cascade_layout(
        d, N, W, C, sm_count(index),
        lambda lay: resident_clusters(lay, d, N, W, L, C, int_accum, index))


cascade_qs_forward.launches = 0
cascade_qs_forward.launches_by_route = {"smem_x": 0, "global_x": 0}
cascade_qs_forward.source = "src/repro_torch/kernels/csrc/cascade_qs_forward.cu"
cascade_qs_forward.replaces = "src/repro/kernels/cascade_kernel.py:88"
