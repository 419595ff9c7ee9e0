"""Fixed-point quantization of tree ensembles (paper §5) + the integer
end-to-end extensions (docs/QUANT.md).

``q(x) = floor(s * x)`` with scaling constant ``s`` (paper default 2^15),
applied to split thresholds and/or leaf values, stored in ``bits``-wide
integers. Inputs are quantized with the same ``s`` at inference time, so the
split predicate ``x <= t`` becomes ``floor(s x) <= floor(s t)``.

Because raw features have arbitrary ranges (the paper's datasets do too), a
per-feature order-preserving min-max normalisation to [0, 1) is applied
*before* quantization; it changes no float prediction (monotone per feature)
but makes the fixed-point grid meaningful. Heavy-tailed features (EEG) get
their threshold mass compressed by this — exactly the failure mode the paper
observes in Tables 3/4.

Two integer paths extend the paper's scheme (docs/QUANT.md):

  * ``QuantSpec(int_accum=True)`` — InTreeger-style (arXiv 2505.15391)
    integer end-to-end: quantized leaves carry a tracked worst-case error
    bound (``Forest.leaf_err_bound``) and engines accumulate in the
    narrowest integer dtype that provably cannot overflow
    (``accum_bits`` — asserted at compile time, not checked at runtime).
  * ``flint_forest`` — FLInt-style (arXiv 2209.04181) reinterpretation of
    ordered f32 thresholds/inputs as monotone int32 keys, so *float*
    forests traverse with integer compares and zero quantization error.

In the compile pipeline this is the ``quantize`` pass
(``core/pipeline.py``): pass ``quant=QuantSpec(...)`` to
``core.compile_plan`` instead of mutating the forest by hand (the FLInt
path is the ``flint`` pass).  This module is the port's copy of
``repro.core.quantize`` (numpy only); both give array-equal forests.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from .forest import Forest


@dataclass(frozen=True)
class QuantSpec:
    bits: int = 16                 # 16 (paper) or 8 (beyond-paper)
    scale: Optional[float] = None  # None → 2^(bits-1) for splits
    quantize_splits: bool = True
    quantize_leaves: bool = True
    int_accum: bool = False        # engines accumulate leaves as integers

    @property
    def default_scale(self) -> float:
        return float(2 ** (self.bits - 1))

    @property
    def int_max(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def dtype(self):
        return np.int16 if self.bits == 16 else np.int8


def feature_ranges(forest: Forest, X: Optional[np.ndarray] = None):
    """Per-feature (lo, hi) for min-max normalisation: from data if given,
    else from the forest's own thresholds.

    Non-finite calibration entries (NaN/±inf sensor rows) are masked out
    per column rather than poisoning the range: a single NaN row would
    otherwise propagate through ``min``/``max`` into ``feat_lo``/``feat_hi``
    and make every normalized input NaN with no error raised."""
    d = forest.n_features
    if X is not None:
        Xf = np.asarray(X, dtype=np.float64)
        finite = np.isfinite(Xf)
        if finite.all():
            lo, hi = Xf.min(axis=0), Xf.max(axis=0)
        else:
            lo = np.where(finite, Xf, np.inf).min(axis=0)
            hi = np.where(finite, Xf, -np.inf).max(axis=0)
            # columns with no finite calibration value at all
            lo[~np.isfinite(lo)] = 0.0
            hi[~np.isfinite(hi)] = 1.0
    else:
        lo = np.full(d, np.inf)
        hi = np.full(d, -np.inf)
        valid = forest.feature >= 0
        for t in range(forest.n_trees):
            for n in np.nonzero(valid[t])[0]:
                f = forest.feature[t, n]
                v = forest.threshold[t, n]
                lo[f] = min(lo[f], v)
                hi[f] = max(hi[f], v)
        lo[~np.isfinite(lo)] = 0.0
        hi[~np.isfinite(hi)] = 1.0
    span = hi - lo
    hi = np.where(span <= 0, lo + 1.0, hi)
    return lo, hi


def normalize_features(X: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return np.clip((X - lo) / (hi - lo), 0.0, 1.0)


def quantize_forest(forest: Forest, X: Optional[np.ndarray] = None,
                    spec: QuantSpec = QuantSpec()) -> Forest:
    """Return a new Forest with int thresholds / leaves per ``spec``.

    The returned forest's ``predict_oracle``/engines require inputs passed
    through ``quantize_inputs`` — engine wrappers do this automatically via
    the stored ``feat_lo``/``feat_hi``/``quant_scale``."""
    if forest.quant_scale is not None:
        raise ValueError("forest already quantized")
    if forest.flint:
        raise ValueError("FLInt forests carry no quantization grid")
    if spec.int_accum and not spec.quantize_leaves:
        raise ValueError("QuantSpec(int_accum=True) requires quantized "
                         "leaves (quantize_leaves=True)")
    if X is not None and forest.feat_map is not None:
        # optimized forest (repro.optim drop_unused_features): calibration
        # rows are full-width; the per-feature ranges must align with the
        # IR's remapped columns
        X = np.asarray(X)[:, np.asarray(forest.feat_map, dtype=np.int64)]
    lo, hi = feature_ranges(forest, X)
    s = spec.scale if spec.scale is not None else spec.default_scale
    out = replace(forest)

    if spec.quantize_splits:
        tn = normalize_features(forest.threshold.astype(np.float64),
                                lo[np.maximum(forest.feature, 0)],
                                hi[np.maximum(forest.feature, 0)])
        q = np.clip(np.floor(s * tn), -spec.int_max - 1, spec.int_max)
        out.threshold = q.astype(spec.dtype)

    if spec.quantize_leaves:
        if not np.isfinite(forest.leaf_value).all():
            # NaN would silently skip the shrink loop (NaN > x is False)
            # and floor to garbage — reject loudly instead
            raise ValueError("leaf values contain NaN/inf — cannot "
                             "quantize leaves")
        max_abs = float(np.abs(forest.leaf_value).max()) or 1.0
        # paper: s in [M, 2^B]; auto-shrink for GBT leaves that exceed 1.0.
        # Keep shrinking until every quantized leaf fits ±int_max — the old
        # "stop at s_leaf <= 2" floor let floor(s*leaf) wrap on astype for
        # large leaves, silently corrupting predictions.
        s_leaf = s
        while s_leaf * max_abs > spec.int_max:
            s_leaf /= 2.0
        q = np.clip(np.floor(s_leaf * forest.leaf_value),
                    -spec.int_max - 1, spec.int_max)
        out.leaf_value = q.astype(np.int32 if spec.bits == 16 else np.int16)
        out.leaf_scale = s_leaf
        # worst-case |float leaf sum − descaled int sum| under identical
        # traversal: per-tree floor error is in [0, 1/s_leaf)
        out.leaf_err_bound = forest.n_trees / s_leaf

    out.int_accum = bool(spec.int_accum)
    out.quant_scale = s
    out.quant_bits = spec.bits
    out.feat_lo = lo
    out.feat_hi = hi
    return out


def accum_bits(forest: Forest) -> int:
    """Narrowest accumulator width (16 or 32) that provably cannot
    overflow when summing this forest's quantized leaves.

    The bound is structural — Σ_t max|leaf_t| per class — so the check
    runs once at compile time; there is no runtime overflow path by
    construction.  Raises ``ValueError`` if even int32 cannot hold the
    worst case (> 65 k trees at full 16-bit leaf magnitude — the caller
    must fall back to float accumulation)."""
    lv = forest.leaf_value
    if not np.issubdtype(lv.dtype, np.integer):
        raise ValueError("accum_bits needs integer leaves — quantize with "
                         "QuantSpec(quantize_leaves=True) first")
    worst = int(np.abs(lv.astype(np.int64)).max(axis=(1, 2)).sum()) \
        if lv.size else 0
    if worst <= np.iinfo(np.int16).max:
        return 16
    if worst <= np.iinfo(np.int32).max:
        return 32
    raise ValueError(
        f"worst-case leaf sum {worst} overflows int32 — integer "
        "accumulation is unsound for this forest (use float leaves or a "
        "smaller leaf scale)")


# --------------------------------------------------------------------------- #
# FLInt: ordered-float → int32 key reinterpretation (arXiv 2209.04181)
# --------------------------------------------------------------------------- #
def flint_key(x: np.ndarray) -> np.ndarray:
    """Map f32 values to int32 keys preserving total order, so the split
    predicate ``x <= t`` holds on keys iff it holds on floats.

    The map is the standard sign-flip on the raw bit pattern
    (``b ^ ((b >> 31) & 0x7fffffff)``): non-negative floats keep their
    (already ordered) bits, negative floats get their magnitude bits
    inverted so more-negative sorts lower; -0.0 lands just below +0.0.
    NaN canonicalizes to INT32_MAX — above every threshold key (+inf
    keys at 0x7f800000), so NaN inputs always traverse right, matching
    float semantics (``NaN <= t`` is False)."""
    xf = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
    b = xf.view(np.int32)
    key = b ^ ((b >> 31) & np.int32(0x7FFFFFFF))
    return np.where(np.isnan(xf), np.int32(np.iinfo(np.int32).max), key)


def flint_forest(forest: Forest) -> Forest:
    """Return a new Forest whose f32 thresholds are replaced by their
    FLInt int32 keys (``Forest.flint`` set); ``quantize_inputs`` then
    keys raw inputs the same way, and every engine's ``x <= t`` compare
    runs on integers with **zero** quantization error — traversal
    decisions are bit-identical to the float forest's."""
    if forest.quant_scale is not None:
        raise ValueError("FLInt applies to float forests (quantized "
                         "thresholds are already integers)")
    if forest.flint:
        raise ValueError("forest already FLInt-keyed")
    out = replace(forest)
    out.threshold = flint_key(forest.threshold)
    out.flint = True
    return out


def quantize_inputs(forest: Forest, X: np.ndarray) -> np.ndarray:
    """Apply the forest's stored input transform to raw full-width rows:
    the optimizer's column remap (``feat_map``, if the
    ``drop_unused_features`` pass ran) followed by normalisation +
    fixed-point grid (quantized forests) or the FLInt key map (flint
    forests).  No-op for float forests without a remap."""
    if forest.feat_map is not None:
        X = np.asarray(X)[:, np.asarray(forest.feat_map, dtype=np.int64)]
    if forest.flint:
        return flint_key(X)
    if forest.quant_scale is None:
        return X
    if not np.issubdtype(forest.threshold.dtype, np.integer):
        # leaves-only quantization: splits still float → inputs stay raw
        return X
    Xn = normalize_features(X, forest.feat_lo, forest.feat_hi)
    q = np.floor(forest.quant_scale * Xn)
    imax = 2 ** (forest.quant_bits - 1) - 1
    return np.clip(q, -imax - 1, imax).astype(forest.threshold.dtype)


def leaf_scale(forest: Forest) -> float:
    """Descaling factor for quantized leaf accumulations (1.0 if float)."""
    return float(getattr(forest, "leaf_scale", 1.0)
                 if np.issubdtype(forest.leaf_value.dtype, np.integer) else 1.0)
