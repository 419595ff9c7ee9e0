"""CUDA kernel: GEMM (Hummingbird-style) forest traversal, hand-written for
Hopper.

``gemm_forward`` replaces the Pallas TPU kernel of the same name
(``repro/kernels/gemm_forest_kernel.py:58``).  For a CUDA tensor it
launches ``csrc/gemm_forward.cu`` (built by ``kernels/build.py``) on the
current stream, or raises; for a CPU tensor it runs
``gemm_forward_reference``, the same function in plain torch.  Nothing
falls back from one to the other.  ``gemm_forward.launches`` counts the
kernel's launches and ``.launches_by_route`` its routes, chosen by
``gemm_layout`` from the row width alone: ``"smem_x"`` stages each
block's 32 rows of x in shared memory, ``"global_x"`` (rows too wide for
that) gathers x from global memory.

The kernel runs R = S.A on the int8 tensor cores, so it takes the
traversal matrix A (T, N, L), whose entries are -1, 0 and +1, as int8,
leaf-major and K-major per tree, built once on the host
(``leaf_major``): A[t, l, n] for leaf l and node n.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.baselines import gemm_scores
from .launch import (H100_SMS, TileLayout, check_out_dtype, check_tensors,
                     kernel_limits, launch, library, node_pad, on_card,
                     round_up, sm_count, tile_layout, tile_tree_bytes)

GEMM_MAX_CHUNK = 8       # trees a block stages per ring stage: one a warp


def leaf_major(A) -> np.ndarray:
    """A (T, N, L) holding -1, 0, +1 → the kernel's operand (T, L, Npad)
    int8, K-major per tree: A[t, n, l] at [t, l, n], zero past N (Npad =
    ``node_pad(N)``)."""
    A = np.asarray(A)
    T, N, L = A.shape
    out = np.zeros((T, L, node_pad(N)), dtype=np.int8)
    out[..., :N] = A.transpose(0, 2, 1)
    return out


def node_matrix(A8: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """The inverse of ``leaf_major``: A (T, N, L) float32 in {-1, 0, +1}."""
    return A8[..., :n_nodes].transpose(1, 2).to(torch.float32)


def gemm_layout(B: int, d: int, T: int, N: int, L: int, C: int,
                n_sm: int = H100_SMS) -> TileLayout:
    """The route, ring chunk and tree groups of ``gemm_forward``
    (``launch.tile_layout``; a tree is its node records, L rows of A and L
    Bvec words, both rounded up to 8)."""
    return tile_layout(B, d, T, C, tile_tree_bytes(N, round_up(L, 8), L),
                       GEMM_MAX_CHUNK, f"one tree ({N} nodes, {L} leaves)",
                       n_sm)


def gemm_forward_limits(feat, thr, A, Bvec, leaf_val) -> None:
    """Raise ``ValueError``, naming ``backend="torch"``, unless the kernel
    takes these operands (numpy or torch; only their shapes are read): at
    most ``MAX_NODES`` nodes per tree and ``MAX_CLASSES`` classes."""
    kernel_limits("gemm_forward", feat.shape[1], leaf_val.shape[-1])


def gemm_forward_reference(x, feat, thr, A, Bvec, leaf_val, *,
                           out_dtype=torch.float32) -> torch.Tensor:
    """The plain torch version: ``eval_gemm``'s arithmetic on the padded
    kernel arrays (padding nodes carry -inf thresholds and zero columns of
    A; padding trees and leaves Bvec = L + 1), taken over tree chunks,
    with the leaf values of every hit summed, as the kernel does.  Raw
    leaf sums (B, C) in ``out_dtype``."""
    A = node_matrix(A, feat.shape[1])
    return gemm_scores(x, feat, thr, A, Bvec, leaf_val, out_dtype,
                       sum_hits=True)


def _check(x, feat, thr, A, Bvec, leaf_val, out_dtype):
    check_tensors(
        x, dict(x=x, feat=feat, thr=thr, A=A, Bvec=Bvec, leaf_val=leaf_val),
        dict(x=torch.float32, feat=torch.int32, thr=torch.float32,
             A=torch.int8, Bvec=torch.int32, leaf_val=torch.float32),
        dict(x=2, feat=2, thr=2, A=3, Bvec=2, leaf_val=3))
    T, N = feat.shape
    L = leaf_val.shape[1]
    a_shape = (T, L, node_pad(N))
    if thr.shape != (T, N) or A.shape != a_shape or Bvec.shape != (T, L) \
            or leaf_val.shape[0] != T:
        raise ValueError(
            f"inconsistent shapes: feat {tuple(feat.shape)}, thr "
            f"{tuple(thr.shape)}, A {tuple(A.shape)} (expected {a_shape}), "
            f"Bvec {tuple(Bvec.shape)}, leaf_val {tuple(leaf_val.shape)}")
    check_out_dtype(out_dtype)


def gemm_forward(x, feat, thr, A, Bvec, leaf_val, *,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Padded kernel arrays → raw leaf sums (B, C) in ``out_dtype``.

    x (B, d) f32; feat (T, N) i32; thr (T, N) f32; A (T, L, Npad) int8,
    the ``leaf_major`` form of the traversal matrix; Bvec (T, L) int32;
    leaf_val (T, L, C) f32 (exact integers for int-accum forests, which
    use ``out_dtype=torch.int32``).  Every ``feat`` entry must be < d: the
    kernel gathers without a bounds check."""
    _check(x, feat, thr, A, Bvec, leaf_val, out_dtype)
    if not on_card(x, "gemm_forward"):
        return gemm_forward_reference(x, feat, thr, A, Bvec, leaf_val,
                                      out_dtype=out_dtype)
    B, d = x.shape
    T, N = feat.shape
    L, C = leaf_val.shape[1:]
    gemm_forward_limits(feat, thr, A, Bvec, leaf_val)
    out = torch.empty((B, C), dtype=out_dtype, device=x.device)
    if B == 0:
        return out
    lay = gemm_layout(B, d, T, N, L, C, sm_count(x.device.index or 0))
    partial = torch.empty((lay.n_groups, B, C), dtype=out_dtype,
                          device=x.device)
    lib = library("gemm_forward", "gemm_forward_launch", "gemm_error_string",
                  8, 11)
    launch(lib.gemm_forward_launch, lib.gemm_error_string, "gemm_forward",
           x.device, x.data_ptr(), feat.data_ptr(), thr.data_ptr(),
           A.data_ptr(), Bvec.data_ptr(), leaf_val.data_ptr(),
           partial.data_ptr(), out.data_ptr(), B, d, T, N, L, C, lay.chunk,
           lay.group_trees, int(lay.route == "smem_x"), lay.shared_bytes,
           int(out_dtype == torch.int32))
    gemm_forward.launches += 1
    gemm_forward.launches_by_route[lay.route] += 1
    return out


gemm_forward.launches = 0
gemm_forward.launches_by_route = {"smem_x": 0, "global_x": 0}
gemm_forward.source = "src/repro_torch/kernels/csrc/gemm_forward.cu"
gemm_forward.replaces = "src/repro/kernels/gemm_forest_kernel.py:58"
