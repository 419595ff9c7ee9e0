"""Baseline ensemble-traversal engines in plain torch — the port's
counterpart of ``repro.core.baselines``.

* ``native``   — per-level pointer-chasing traversal over child arrays (the
  paper's NATIVE/PRED baseline, Asadi et al. 2014): a loop over tree depth
  with gathered node state.
* ``unrolled`` — the reference's IF-ELSE analogue, the depth loop unrolled
  into straight-line HLO.  PyTorch runs eagerly, so a Python loop is
  already unrolled: both names run the same code here, and ``unrolled``
  stays registered so every reference engine has its counterpart.
* ``gemm``     — Hummingbird-style tensor traversal (Nakandala et al.
  2020): S = 1{x[feat] <= thr}, R = S @ A, hit = (R == Bvec), scores =
  leaf values of the hits.

``gemm_scores`` is the gemm arithmetic, taken over tree chunks; the CUDA
kernel's plain version (``kernels.gemm_forest_kernel``) repeats it on the
padded kernel arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .forest import Forest
from .quantize import leaf_scale, quantize_inputs
from .quickscorer import acc_dtype_for, forest_acc_bits
from .registry import (BasePredictor, CompiledModule, register_engine,
                       resolve_device)

# budget for one tree chunk's (B, Tc, ·) intermediates in gemm_scores
_CHUNK_BYTES = 64 << 20


# --------------------------------------------------------------------------- #
# NATIVE / IF-ELSE: per-level traversal
# --------------------------------------------------------------------------- #
class CompiledNative(CompiledModule):
    """Child-array traversal tables, registered as buffers on ``device``."""

    SCALARS = ("max_depth", "leaf_scale", "acc_bits")
    INDEX = ("feat", "left", "right")

    def __init__(self, forest: Forest, device: torch.device):
        super().__init__()
        self.device = device
        self.forest = forest
        self.max_depth = int(forest.max_depth)
        self.leaf_scale = leaf_scale(forest)
        self.acc_bits = forest_acc_bits(forest)
        bufs = {
            "feat": np.maximum(forest.feature, 0).astype(np.int64),  # (T, N)
            "thr": np.asarray(forest.threshold),                     # (T, N)
            "left": forest.left.astype(np.int64),    # (T, N) <0 → leaf -(x+1)
            "right": forest.right.astype(np.int64),                  # (T, N)
            "leaf_val": np.asarray(forest.leaf_value),               # (T, L, C)
            "single_leaf": forest.n_nodes == 0,      # (T,) single-leaf trees
        }
        for name, a in bufs.items():
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(a)).to(device))

    def transform_inputs(self, X: np.ndarray) -> np.ndarray:
        return quantize_inputs(self.forest, X)


def compile_native(forest: Forest, device=None) -> CompiledNative:
    return CompiledNative(forest, resolve_device(device))


def eval_native(nat: CompiledNative, X: torch.Tensor) -> torch.Tensor:
    """X (B, d) → (B, C) float32.  State: current node per (instance,
    tree); negative codes are reached leaves (absorbing)."""
    B = X.shape[0]
    T = nat.feat.shape[0]
    trees = torch.arange(T, device=X.device)[None, :]           # (1, T)
    node = torch.zeros((B, T), dtype=torch.int64, device=X.device)
    for _ in range(nat.max_depth):
        live = node >= 0
        idx = node.clamp(min=0)
        x = torch.gather(X, 1, nat.feat[trees, idx])              # (B, T)
        nxt = torch.where(x <= nat.thr[trees, idx], nat.left[trees, idx],
                          nat.right[trees, idx])
        node = torch.where(live, nxt, node)
    leaf = torch.where(nat.single_leaf[None], 0, -node - 1).clamp(min=0)
    vals = nat.leaf_val[trees, leaf]                             # (B, T, C)
    acc = acc_dtype_for(nat.leaf_val.dtype, nat.acc_bits)
    score = vals.to(acc).sum(dim=1, dtype=acc)
    return score.to(torch.float32) / nat.leaf_scale


def eval_unrolled(nat: CompiledNative, X: torch.Tensor) -> torch.Tensor:
    """``native`` under the reference's IF-ELSE name: the same loop."""
    return eval_native(nat, X)


# --------------------------------------------------------------------------- #
# GEMM (Hummingbird) engine
# --------------------------------------------------------------------------- #
def gemm_arrays(forest: Forest):
    """Host-side traversal matrices: A (T, N, L) f32, +1 where leaf l lies
    in node n's left subtree and -1 in its right one; Bvec (T, L) f32, the
    left-edge count of each real leaf (padding leaves: L + 1, which no
    row matches).  Shared by the torch engine and the CUDA kernel's host
    glue."""
    T, N = forest.feature.shape
    L = forest.n_leaves
    A = np.zeros((T, N, L), dtype=np.float32)
    Bvec = np.full((T, L), np.float32(L + 1))
    for t in range(T):
        for n in range(int(forest.n_nodes[t])):
            lo, mid, hi = (int(forest.leaf_lo[t, n]),
                           int(forest.leaf_mid[t, n]),
                           int(forest.leaf_hi[t, n]))
            A[t, n, lo:mid] += 1.0
            A[t, n, mid:hi] -= 1.0
        nl = int(forest.n_leaves_per_tree[t])
        Bvec[t, :nl] = A[t, :, :nl].clip(min=0).sum(axis=0)
    return A, Bvec


class CompiledGEMM(CompiledModule):
    """Dense traversal matrices, registered as buffers on ``device``."""

    SCALARS = ("leaf_scale", "compute_dtype", "acc_bits")
    INDEX = ("feat",)

    def __init__(self, forest: Forest, compute_dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        A, Bvec = gemm_arrays(forest)
        self.device = device
        self.forest = forest
        self.compute_dtype = compute_dtype
        self.leaf_scale = leaf_scale(forest)
        self.acc_bits = forest_acc_bits(forest)
        lv = np.asarray(forest.leaf_value)
        bufs = {
            "feat": torch.from_numpy(
                np.maximum(forest.feature, 0).astype(np.int64)),
            "thr": torch.from_numpy(np.asarray(forest.threshold)),
            "valid": torch.from_numpy(forest.feature >= 0),
            "A": torch.from_numpy(A).to(compute_dtype),
            "Bvec": torch.from_numpy(Bvec).to(compute_dtype),
            # integer leaves keep their dtype: gemm_scores gathers them
            # into the integer accumulator, exact at any magnitude
            "leaf_val": torch.from_numpy(
                lv if np.issubdtype(lv.dtype, np.integer)
                else lv.astype(np.float32)),
        }
        for name, t in bufs.items():
            self.register_buffer(name, t.to(device))

    def transform_inputs(self, X: np.ndarray) -> np.ndarray:
        return quantize_inputs(self.forest, X)


def compile_gemm(forest: Forest, compute_dtype=torch.float32,
                 device=None) -> CompiledGEMM:
    return CompiledGEMM(forest, compute_dtype, resolve_device(device))


def gemm_scores(X: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                A: torch.Tensor, Bvec: torch.Tensor, leaf_val: torch.Tensor,
                acc_dtype: torch.dtype,
                valid: Optional[torch.Tensor] = None,
                sum_hits: bool = False) -> torch.Tensor:
    """Raw leaf sums (B, C) in ``acc_dtype``: ``eval_gemm``'s arithmetic,
    taken over tree chunks so a chunk's (B, Tc, ·) intermediates stay
    within ``_CHUNK_BYTES``.

    S = 1{x[feat] <= thr} (a NaN feature goes right, as the reference's
    gemm engine sends it); R = S @ A in ``A``'s float dtype (float32 for
    an integer ``A``): S and A hold 0 and ±1 and |R| <= N, so R is exact
    in any float type.  A float accumulator sums the leaf values of every
    hit; an integer one gathers the first hit's leaf (leaf 0 when none
    matches) and sums in the integer type, as the reference's integer-leaf
    path does, unless ``sum_hits`` asks for the sum of every hit in the
    integer type, as the CUDA kernel computes it.  A real tree has exactly
    one hit, where the two agree.  ``valid=None`` means padding nodes
    carry zero rows of A (the kernel's padded arrays)."""
    B = X.shape[0]
    T, N = feat.shape
    L = A.shape[-1]
    C = leaf_val.shape[-1]
    ct = A.dtype if A.dtype.is_floating_point else torch.float32
    chunk = max(1, _CHUNK_BYTES // max(B * 4 * (N + L * (1 + C)), 1))
    score = torch.zeros((B, C), dtype=acc_dtype, device=X.device)
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        S = X[:, feat[t0:t1]] <= thr[t0:t1][None]               # (B, Tc, N)
        if valid is not None:
            S &= valid[t0:t1][None]
        R = torch.einsum("btn,tnl->btl", S.to(ct), A[t0:t1].to(ct))
        hit = R == Bvec[t0:t1][None]                            # (B, Tc, L)
        if acc_dtype.is_floating_point or sum_hits:
            vals = torch.where(hit[..., None], leaf_val[t0:t1][None],
                               0).to(acc_dtype).sum(dim=2)      # (B, Tc, C)
        else:
            leaf = hit.to(torch.uint8).argmax(dim=2)            # (B, Tc)
            trees = torch.arange(t0, t1, device=X.device)
            vals = leaf_val[trees[None, :], leaf]               # (B, Tc, C)
        score += vals.to(acc_dtype).sum(dim=1, dtype=acc_dtype)
    return score


def eval_gemm(g: CompiledGEMM, X: torch.Tensor) -> torch.Tensor:
    """GEMM traversal: X (B, d) → scores (B, C) float32."""
    acc = acc_dtype_for(g.leaf_val.dtype, g.acc_bits)
    score = gemm_scores(X, g.feat, g.thr, g.A, g.Bvec, g.leaf_val, acc,
                        valid=g.valid)
    return score.to(torch.float32) / g.leaf_scale


class BaselinePredictor(BasePredictor):
    """Wrapper for the baseline engines on the shared base."""


def native_predictor(forest: Forest, unroll=False,
                     device=None) -> BaselinePredictor:
    nat = compile_native(forest, device=device)
    return BaselinePredictor(nat, eval_unrolled if unroll else eval_native)


def gemm_predictor(forest: Forest, compute_dtype=torch.float32,
                   device=None) -> BaselinePredictor:
    return BaselinePredictor(compile_gemm(forest, compute_dtype, device),
                             eval_gemm)


def _gemm_layout(forest: Forest, plan) -> str:
    dt = plan.engine_kw.get("compute_dtype")
    return (f"dense (T,N,L) traversal matrices, "
            f"dtype={getattr(dt, '__name__', dt) or 'f32'}")


_NATIVE_ARRAYS = ("feat", "thr", "left", "right", "leaf_val", "single_leaf")
register_engine(
    "native", backend="torch", tune_name="native", compile=compile_native,
    evaluate=eval_native, predictor_cls=BaselinePredictor, shardable=True,
    serial_arrays=_NATIVE_ARRAYS, restore=CompiledNative.restore,
    doc="per-level pointer-chasing traversal (loop over depth)")
register_engine(
    "unrolled", backend="torch", tune_name="unrolled",
    compile=compile_native, evaluate=eval_unrolled,
    predictor_cls=BaselinePredictor, shardable=True,
    serial_arrays=_NATIVE_ARRAYS, restore=CompiledNative.restore,
    doc="native under the IF-ELSE name (eager torch: the same loop)")
register_engine(
    "gemm", backend="torch", tune_name="gemm", compile=compile_gemm,
    evaluate=eval_gemm, predictor_cls=BaselinePredictor, shardable=True,
    layout=_gemm_layout,
    serial_arrays=("feat", "thr", "valid", "A", "Bvec", "leaf_val"),
    restore=CompiledGEMM.restore,
    doc="Hummingbird tensor traversal (two matmuls per tree block)")
