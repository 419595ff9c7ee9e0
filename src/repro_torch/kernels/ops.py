"""Host glue around the CUDA QuickScorer kernel: padding, dtype prep and
the kernel-backed predictor — the QS half of ``repro.kernels.ops``."""
from __future__ import annotations

import numpy as np
import torch

from ..core.engine_select import bucket_batch
from ..core.forest import Forest
from ..core.quantize import leaf_scale, quantize_inputs
from ..core.quickscorer import as_bit_pattern
from ..core.registry import BasePredictor, ensure_feature_column, \
    resolve_device
from .quickscorer_kernel import qs_forward


def _pad_to(x: np.ndarray, axis: int, mult: int, fill=0) -> np.ndarray:
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def _thr_pad_value(forest: Forest):
    if np.issubdtype(forest.threshold.dtype, np.integer):
        return np.iinfo(forest.threshold.dtype).max
    return np.float32(np.inf)


def bucket_rows(n: int, block_b: int) -> int:
    """Padded batch size: ``block_b × 2^k`` — power-of-two buckets, the
    same policy as ``engine_select.bucket_batch`` in units of blocks, so
    a stream of batch sizes gives O(log B_max) distinct kernel shapes."""
    return block_b * bucket_batch(-(-n // block_b))


def _out_dtype(forest: Forest, block_t: int) -> torch.dtype:
    """Kernel output dtype: int32 accumulation for int-accum forests.

    The CUDA kernel sums int32 directly, but the reference's Pallas tile
    sums in f32 and needs ``block_t × max|leaf| < 2^24``; the same check
    here keeps both packages accepting the same forests."""
    if not forest.int_accum:
        return torch.float32
    lv = forest.leaf_value
    max_abs = int(np.abs(lv.astype(np.int64)).max()) if lv.size else 0
    if block_t * max_abs >= 2 ** 24:
        raise ValueError(
            f"int accumulation needs block_t*max|leaf| < 2^24, got "
            f"{block_t}*{max_abs}; lower block_t or quantize to fewer bits")
    return torch.int32


class _KernelPredictor(BasePredictor):
    """Kernel-backed predictor on the shared base: overrides the predict
    path for batch bucketing/padding, inherits predict_class/proba."""

    def __init__(self, forest: Forest, arrays: tuple, out_dtype,
                 block_b: int, device: torch.device):
        if forest.flint:
            raise ValueError(
                "FLInt forests are unsupported on the cuda backend: the "
                "kernel takes f32 rows, which cannot represent int32 FLInt "
                "keys (use backend='torch')")
        # no BasePredictor.__init__: the "compiled" state is the host
        # forest + the padded kernel arrays on the device
        self.forest = forest
        self.device = device
        self.arrays = tuple(torch.from_numpy(a).to(device) for a in arrays)
        self.out_dtype = out_dtype
        self.block_b = block_b
        self.leaf_scale = leaf_scale(forest)
        # the kernel gathers x[row, feat] unchecked: rows must be this wide
        self.min_width = int(arrays[0].max(initial=0)) + 1

    def transform_inputs(self, X: np.ndarray) -> np.ndarray:
        return quantize_inputs(self.forest,
                               np.asarray(X)).astype(np.float32)

    def predict_transformed(self, Xq: np.ndarray) -> np.ndarray:
        Xq = ensure_feature_column(np.asarray(Xq, dtype=np.float32))
        if Xq.ndim != 2 or Xq.shape[1] < self.min_width:
            raise ValueError(f"rows of width >= {self.min_width} expected, "
                             f"got shape {Xq.shape}")
        B = Xq.shape[0]
        Xp = _pad_to(Xq, 0, bucket_rows(B, self.block_b))
        x = torch.from_numpy(np.ascontiguousarray(Xp)).to(self.device)
        out = qs_forward(x, *self.arrays, out_dtype=self.out_dtype)
        # int-accum kernels return int32 totals; the f32 cast + pow2
        # descale matches the torch engine's rounding bit-for-bit
        return out[:B].cpu().numpy().astype(np.float32) / self.leaf_scale


def _qs_arrays(forest: Forest, block_t: int):
    """QuickScorer kernel arrays (feat, thr, masks, init_idx, leaf_val),
    tree axis padded to ``block_t`` with inert trees (+inf thresholds →
    no predicate fires, init 0 → leaf 0 → all-zero leaf row).  Padding
    nodes take ``_thr_pad_value``: iinfo.max for quantized forests (no
    quantized input exceeds it), +inf for float ones.  Masks travel as
    int32 bit patterns."""
    thr_pad = _thr_pad_value(forest)
    feat = _pad_to(np.maximum(forest.feature, 0).astype(np.int32), 0, block_t)
    thr = forest.threshold.astype(np.float32).copy()
    thr[forest.feature < 0] = np.float32(thr_pad)
    thr = _pad_to(thr, 0, block_t, fill=np.float32(np.inf))
    masks = _pad_to(forest.node_masks(), 0, block_t, fill=0xFFFFFFFF)
    init_idx = _pad_to(forest.init_leafidx(), 0, block_t)           # pad: 0
    leaf_val = _pad_to(forest.leaf_value.astype(np.float32), 0, block_t)
    return (feat, thr, as_bit_pattern(masks).numpy(),
            as_bit_pattern(init_idx).numpy(), leaf_val)


def cuda_qs_predictor(forest: Forest, block_b: int = 128, block_t: int = 8,
                      device=None) -> _KernelPredictor:
    """QuickScorer bitvector engine, CUDA backend (the counterpart of
    ``repro.kernels.ops.pallas_qs_predictor``).  ``device=None`` means
    the card; on ``device="cpu"`` the kernel's plain version runs."""
    device = resolve_device(device)
    return _KernelPredictor(forest, _qs_arrays(forest, block_t),
                            _out_dtype(forest, block_t), block_b, device)
