"""CUDA kernel: GEMM (Hummingbird-style) forest traversal, hand-written for
Hopper.

``gemm_forward`` replaces the Pallas TPU kernel of the same name
(``repro/kernels/gemm_forest_kernel.py:58``).  For a CUDA tensor it
launches ``csrc/gemm_forward.cu`` (built by ``kernels/build.py``) on the
current stream, or raises; for a CPU tensor it runs
``gemm_forward_reference``, the same function in plain torch.  Nothing
falls back from one to the other.  ``gemm_forward.launches`` counts the
kernel's launches.

The kernel takes the traversal matrix A (T, N, L), whose entries are -1, 0
and +1, as two bit masks per leaf built once on the host
(``node_masks``): the nodes where A is +1 and where it is -1.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.baselines import gemm_scores
from .launch import (MAX_CLASSES, MAX_NODES, SHARED_BYTES, check_out_dtype,
                     check_tensors, launch, library, on_card, trees_per_block)


def fire_words(n_nodes: int) -> int:
    """32-bit words that hold one condition bit per node, rounded up to a
    power of two: the kernel's instantiations are 1, 2, 4 and 8 words
    (``MAX_NODES``); wider trees run only the plain version."""
    return 1 << max(0, -(-n_nodes // 32) - 1).bit_length()


def gemm_tree_chunk(n_trees: int, n_nodes: int, n_leaves: int) -> int:
    """Trees per block: feat and thr per node, and per leaf two masks of
    ``fire_words`` words and Bvec, 4 bytes each."""
    fw = fire_words(n_nodes)
    return trees_per_block(n_trees,
                           4 * (2 * n_nodes + n_leaves * (2 * fw + 1)))


def node_masks(A: np.ndarray):
    """A (T, N, L) holding -1, 0, +1 → (plus, minus), each (T, L, FW) int32
    bit patterns with FW = ``fire_words(N)``: bit j of word k of leaf l is
    set where A[t, 32k + j, l] is +1 (plus) or -1 (minus)."""
    T, N, L = A.shape
    fw = fire_words(N)

    def pack(bits):
        b = np.zeros((T, L, 32 * fw), dtype=bool)
        b[:, :, :N] = bits.transpose(0, 2, 1)
        return np.packbits(b, axis=-1, bitorder="little").view("<i4")
    return pack(A > 0), pack(A < 0)


def node_matrix(plus: torch.Tensor, minus: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """The inverse of ``node_masks``: A (T, N, L) float32 in {-1, 0, +1}."""
    j = torch.arange(32, dtype=torch.int32, device=plus.device)

    def unpack(m):
        bits = (m[..., None] >> j) & 1                        # (T, L, FW, 32)
        return bits.reshape(*m.shape[:2], -1)[..., :n_nodes].transpose(1, 2)
    return (unpack(plus) - unpack(minus)).to(torch.float32)


def gemm_forward_reference(x, feat, thr, plus, minus, Bvec, leaf_val, *,
                           out_dtype=torch.float32) -> torch.Tensor:
    """The plain torch version: ``eval_gemm``'s arithmetic on the padded
    kernel arrays (padding nodes carry -inf thresholds and no mask bits;
    padding trees and leaves Bvec = L + 1), taken over tree chunks, with
    the leaf values of every hit summed, as the kernel does.  Raw leaf
    sums (B, C) in ``out_dtype``."""
    A = node_matrix(plus, minus, feat.shape[1])
    return gemm_scores(x, feat, thr, A, Bvec, leaf_val, out_dtype,
                       sum_hits=True)


def _check(x, feat, thr, plus, minus, Bvec, leaf_val, out_dtype):
    check_tensors(
        x, dict(x=x, feat=feat, thr=thr, plus=plus, minus=minus, Bvec=Bvec,
                leaf_val=leaf_val),
        dict(x=torch.float32, feat=torch.int32, thr=torch.float32,
             plus=torch.int32, minus=torch.int32, Bvec=torch.int32,
             leaf_val=torch.float32),
        dict(x=2, feat=2, thr=2, plus=3, minus=3, Bvec=2, leaf_val=3))
    T, N = feat.shape
    L = leaf_val.shape[1]
    masks = (T, L, fire_words(N))
    if thr.shape != (T, N) or plus.shape != masks or \
            minus.shape != masks or Bvec.shape != (T, L) or \
            leaf_val.shape[0] != T:
        raise ValueError(
            f"inconsistent shapes: feat {tuple(feat.shape)}, thr "
            f"{tuple(thr.shape)}, plus {tuple(plus.shape)}, minus "
            f"{tuple(minus.shape)} (expected {masks}), Bvec "
            f"{tuple(Bvec.shape)}, leaf_val {tuple(leaf_val.shape)}")
    check_out_dtype(out_dtype)


def gemm_forward(x, feat, thr, plus, minus, Bvec, leaf_val, *,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Padded kernel arrays → raw leaf sums (B, C) in ``out_dtype``.

    x (B, d) f32; feat (T, N) i32; thr (T, N) f32; plus and minus
    (T, L, fire_words(N)) int32, the ``node_masks`` of A; Bvec (T, L)
    int32; leaf_val (T, L, C) f32 (exact integers for int-accum forests,
    which use ``out_dtype=torch.int32``).  Every ``feat`` entry must be
    < d: the kernel gathers without a bounds check."""
    _check(x, feat, thr, plus, minus, Bvec, leaf_val, out_dtype)
    if not on_card(x, "gemm_forward"):
        return gemm_forward_reference(x, feat, thr, plus, minus, Bvec,
                                      leaf_val, out_dtype=out_dtype)
    B, d = x.shape
    T, N = feat.shape
    L, C = leaf_val.shape[1:]
    if N > MAX_NODES or C > MAX_CLASSES:
        raise ValueError(f"the kernel takes at most {MAX_NODES} nodes per "
                         f"tree and {MAX_CLASSES} classes; got N={N}, C={C}")
    fw = fire_words(N)
    tc = gemm_tree_chunk(T, N, L)
    if 4 * tc * (2 * N + L * (2 * fw + 1)) > SHARED_BYTES:
        raise ValueError(f"one tree ({N} nodes, {L} leaves) exceeds the "
                         f"{SHARED_BYTES} bytes of shared memory a block "
                         "uses")
    out = torch.empty((B, C), dtype=out_dtype, device=x.device)
    if B == 0:
        return out
    partial = torch.empty((-(-T // tc), B, C), dtype=out_dtype,
                          device=x.device)
    lib = library("gemm_forward", "gemm_forward_launch", "gemm_error_string",
                  9, 9)
    launch(lib.gemm_forward_launch, lib.gemm_error_string, "gemm_forward",
           x.device, x.data_ptr(), feat.data_ptr(), thr.data_ptr(),
           plus.data_ptr(), minus.data_ptr(), Bvec.data_ptr(),
           leaf_val.data_ptr(), partial.data_ptr(), out.data_ptr(), B, d, T,
           N, L, C, fw, tc, int(out_dtype == torch.int32))
    gemm_forward.launches += 1
    return out


gemm_forward.launches = 0
gemm_forward.source = "src/repro_torch/kernels/csrc/gemm_forward.cu"
gemm_forward.replaces = "src/repro/kernels/gemm_forest_kernel.py:58"
