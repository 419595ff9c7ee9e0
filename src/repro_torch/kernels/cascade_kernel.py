"""CUDA kernel: the fused confidence-gated cascade over QuickScorer
bitvector stages, hand-written for Hopper.

``cascade_qs_forward`` replaces the Pallas TPU kernel of the same name
(``repro/kernels/cascade_kernel.py:88``): every stage's tree traversal,
the gate between stages and the survivor mask in one launch.  For a CUDA
tensor it launches ``csrc/cascade_qs_forward.cu`` (built by
``kernels/build.py``) on the current stream, or raises; for a CPU tensor
it runs ``cascade_qs_forward_reference``, the same function in plain
torch.  Nothing falls back from one to the other.

The kernel takes the gate in its device form (``GatePolicy.kernel_gate``:
only the built-in gates have one); the plain version runs the policy's
torch ``decide``, so on the card each holds the other to account.

``.launches`` counts the kernel's launches; ``.source`` and ``.replaces``
name the CUDA source and the TPU kernel.
"""
from __future__ import annotations

import functools

import torch

from ..cascade.policy import GATE_SCORE_BOUND
from ..core.quickscorer import qs_scores
from .launch import (SHARED_BYTES, check_out_dtype, check_tensors,
                     kernel_limits, launch, library, on_card)

ROWS_PER_BLOCK = 8       # rows of one block (cascade_qs_forward.cu kRows)
TREE_SLICES = 32         # tree slices of one block (kSlices)
MAX_CHUNK = 64           # trees a block stages in shared memory at once


@functools.lru_cache(maxsize=64)
def _device_bounds(stage_bounds: tuple, device: torch.device) -> torch.Tensor:
    """The stage offsets as an int32 tensor on ``device``, made once."""
    return torch.tensor(stage_bounds, dtype=torch.int32, device=device)


def tree_chunk(n_nodes: int, n_words: int, n_classes: int) -> int:
    """Trees per shared-memory chunk: what fits beside the per-slice
    partial sums in ``SHARED_BYTES``, at most ``MAX_CHUNK``, rounded down
    to a multiple of ``TREE_SLICES`` when there is room for one.  At the
    kernel's limits (W <= 8 words, C <= 16 classes) three trees fit."""
    fixed = 4 * (TREE_SLICES * ROWS_PER_BLOCK * n_classes
                 + ROWS_PER_BLOCK * n_classes + ROWS_PER_BLOCK)
    per_tree = 4 * (n_nodes * (2 + n_words) + n_words)
    tc = min(MAX_CHUNK, (SHARED_BYTES - fixed) // per_tree)
    return tc - tc % TREE_SLICES if tc >= TREE_SLICES else tc


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
    tc = tree_chunk(N, W, C)
    out = torch.empty((B, C), dtype=out_dtype, device=x.device)
    exit_stage = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return out, exit_stage
    lib = library("cascade_qs_forward", "cascade_qs_forward_launch",
                  "cascade_error_string", 11, 11)
    launch(lib.cascade_qs_forward_launch, lib.cascade_error_string,
           "cascade_qs_forward", x.device, x.data_ptr(), valid.data_ptr(),
           feat.data_ptr(), thr.data_ptr(), masks.data_ptr(),
           init_idx.data_ptr(), leaf_val.data_ptr(), bounds.data_ptr(),
           consts.data_ptr(), out.data_ptr(), exit_stage.data_ptr(), B, d,
           N, W, L, C, K, tc, gate.kind, int(gate.votes),
           int(out_dtype == torch.int32))
    cascade_qs_forward.launches += 1
    return out, exit_stage


cascade_qs_forward.launches = 0
cascade_qs_forward.source = "src/repro_torch/kernels/csrc/cascade_qs_forward.cu"
cascade_qs_forward.replaces = "src/repro/kernels/cascade_kernel.py:88"
