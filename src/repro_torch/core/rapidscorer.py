"""RapidScorer (Ye et al. 2018) node merging in plain torch — the port's
counterpart of ``repro.core.rapidscorer``.

Identical (feature, threshold) pairs across the whole ensemble are
deduplicated: one comparison per *unique* node, scattered to every
occurrence by a gather, then the QuickScorer mask reduction.  The merging
statistics (paper Table 4) come from ``merge_stats``.
"""
from __future__ import annotations

import numpy as np
import torch

from .forest import Forest
from .quickscorer import (_CHUNK_BYTES, CompiledQS, acc_dtype_for,
                          exit_leaf, mask_reduce)
from .registry import (BasePredictor, CompiledModule, register_engine,
                       resolve_device)


class CompiledRS(CompiledModule):
    """The QuickScorer arrays (``qs``) plus the unique-node table and the
    node → unique-id map, as buffers on ``device``.  The host IR lives on
    ``qs``, as in the reference."""

    SCALARS = ("n_unique",)
    INDEX = ("u_feat", "inv")

    def __init__(self, forest: Forest, device: torch.device):
        super().__init__()
        self.device = device
        self.forest = None
        self.qs = CompiledQS(forest, device)
        u_feat, u_thr, inv, n_unique = merge_nodes(forest)
        self.n_unique = n_unique
        for name, a in (("u_feat", u_feat.astype(np.int64)),   # (U,)
                        ("u_thr", u_thr),                      # (U,)
                        ("inv", inv.astype(np.int64))):        # (T, N)
            self.register_buffer(name, torch.from_numpy(a).to(device))

    def transform_inputs(self, X: np.ndarray) -> np.ndarray:
        return self.qs.transform_inputs(X)

    @classmethod
    def restore(cls, arrays: dict, scalars: dict, forest,
                device: torch.device) -> "CompiledRS":
        """The nested ``qs`` module from its ``qs.``-prefixed arrays and
        ``scalars["qs"]``, then this module's own buffers around it."""
        qs = CompiledQS.restore(
            {k[3:]: v for k, v in arrays.items() if k.startswith("qs.")},
            {"": scalars.get("qs", {})}, forest, device)
        rs = super().restore(
            {k: v for k, v in arrays.items() if "." not in k},
            scalars, None, device)
        rs.qs = qs
        return rs


def merge_nodes(forest: Forest):
    """Unique (feature, threshold) table + inverse map (padding nodes map
    to unique id 0 and are masked out by ``valid`` downstream):
    ``repro_torch.optim.analysis.unique_splits``, imported lazily so the
    two package inits never cycle."""
    from ..optim.analysis import unique_splits
    return unique_splits(forest)


def merge_stats(forest: Forest) -> float:
    """Fraction of unique nodes kept after merging (paper Table 4)."""
    from ..optim.analysis import unique_fraction
    return unique_fraction(forest)


def compile_rs(forest: Forest, device=None) -> CompiledRS:
    return CompiledRS(forest, resolve_device(device))


def eval_batch(rs: CompiledRS, X: torch.Tensor) -> torch.Tensor:
    """X (B, d) → scores (B, C) float32: one comparison per unique node,
    then the QuickScorer reduction over tree chunks that keep the
    (B, Tc, N, W) select tensor within ``_CHUNK_BYTES``."""
    qs = rs.qs
    B = X.shape[0]
    T, N = qs.feat.shape
    W = qs.masks.shape[-1]
    acc_dtype = acc_dtype_for(qs.leaf_val.dtype, qs.acc_bits)
    cond_u = X[:, rs.u_feat] > rs.u_thr[None]                   # (B, U)
    p2 = 1 << max(N - 1, 0).bit_length()
    chunk = max(1, _CHUNK_BYTES // max(B * p2 * W * 4, 1))
    score = torch.zeros((B, qs.n_classes), dtype=acc_dtype, device=X.device)
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        cond = cond_u[:, rs.inv[t0:t1]] & qs.valid[t0:t1][None]  # (B, Tc, N)
        leaf = exit_leaf(mask_reduce(cond, qs.masks[t0:t1],
                                     qs.init_idx[t0:t1]))       # (B, Tc)
        trees = torch.arange(t0, t1, device=X.device)
        vals = qs.leaf_val[trees[None, :], leaf]                # (B, Tc, C)
        score += vals.to(acc_dtype).sum(dim=1, dtype=acc_dtype)
    return score.to(torch.float32) / qs.leaf_scale


class RSPredictor(BasePredictor):
    """Node-merged engine wrapper on the shared base."""

    def __init__(self, rs: CompiledRS, eval_fn=None):
        super().__init__(rs, eval_fn or eval_batch)
        self.rs = rs


# The unique-node table (u_feat/u_thr) is ensemble-global: tree-sharding
# splits only the per-tree inverse map, every shard keeps the full table.
register_engine(
    "rapidscorer", backend="torch", tune_name="rapidscorer",
    compile=compile_rs, evaluate=eval_batch, predictor_cls=RSPredictor,
    shardable=True, replicated=("u_feat", "u_thr"),
    serial_arrays=("u_feat", "u_thr", "inv", "qs.feat", "qs.thr",
                   "qs.valid", "qs.masks", "qs.init_idx", "qs.leaf_val"),
    restore=CompiledRS.restore,
    doc="RapidScorer: node-merged QuickScorer (shared thresholds collapse)")
