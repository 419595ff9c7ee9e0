"""Host glue around the CUDA forest kernels: padding, dtype prep and the
kernel-backed predictors — the port's ``repro.kernels.ops``."""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.baselines import gemm_arrays
from ..core.engine_select import bucket_batch
from ..core.forest import Forest
from ..core.quantize import leaf_scale, quantize_inputs
from ..core.quickscorer import (as_bit_pattern, bitmm_full_word,
                                bitmm_pack_arrays)
from ..core.registry import BasePredictor, ensure_feature_column, \
    resolve_device
from ..obs import trace
from .gemm_forest_kernel import (gemm_forward, gemm_forward_limits,
                                 leaf_major)
from .quantize_kernel import quantize_rows
from .quickscorer_kernel import (byte_planes, qs_bitmm_forward,
                                 qs_bitmm_forward_limits, qs_forward,
                                 qs_forward_limits)


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


class CardFeed(NamedTuple):
    """A call's rows as the card's input transform hands them on: ``x``
    the (bucket, d) f32 feed on the card, zero from row ``n`` on, and
    ``n`` the caller's row count."""
    x: torch.Tensor
    n: int


class InputGrid:
    """A quantized forest's input grid on the card.  ``feed(X, rows)``
    copies the caller's raw rows to the card once and quantizes them
    there into a bucket of ``rows`` zero-padded rows (``quantize_rows``):
    bit for bit ``quantize_inputs(forest, X).astype(np.float32)``,
    padded.  f32 and f64 rows in either layout go as they are; others
    are first copied on the host (the ``repro_torch.host_copy`` span):
    widened to float64, or made contiguous."""

    def __init__(self, forest: Forest, device: torch.device):
        lo = np.asarray(forest.feat_lo, dtype=np.float64)
        # hi - lo exactly as normalize_features computes it
        span = np.asarray(forest.feat_hi - forest.feat_lo, dtype=np.float64)
        fm = forest.feat_map
        self.lo = torch.from_numpy(lo).to(device)
        self.span = torch.from_numpy(span).to(device)
        self.cols = None if fm is None else torch.from_numpy(
            np.asarray(fm, dtype=np.int32)).to(device)
        # the gather reads these columns unchecked
        self.width = len(lo) if fm is None else int(np.max(fm)) + 1
        self.scale = float(forest.quant_scale)
        self.bits = int(forest.quant_bits)
        with np.errstate(invalid="ignore"):
            # what the host's int cast gives NaN (0 on x86-64)
            self.nan_value = float(np.array([np.nan]).astype(
                forest.threshold.dtype)[0])
        self.device = device

    def feed(self, X, rows: int) -> CardFeed:
        X = np.asarray(X)
        if X.ndim != 2 or (X.shape[1] < self.width if self.cols is not None
                           else X.shape[1] != self.width):
            raise ValueError(f"rows of width {self.width} expected, got "
                             f"shape {X.shape}")
        # f32 and f64 rows in either order go to the card as they are
        t = None if X.dtype in (np.float32, np.float64) and (
            X.flags.c_contiguous or X.flags.f_contiguous) else \
            trace.begin("repro_torch.host_copy")
        if X.dtype != np.float32:
            # every dtype but f32 (f64, ints, 8-bit pixels, ...) is widened
            # to float64 on the host and quantized from float64, as the
            # host's quantize_inputs does
            X = X.astype(np.float64, copy=False)
        if not (X.flags.c_contiguous or X.flags.f_contiguous):
            # one block to copy; rows kept column by column (a frame's
            # values, a slice of them) copy fastest as whole columns, and
            # the kernel reads either layout
            X = np.asfortranarray(X) if X.strides[0] < X.strides[1] \
                else np.ascontiguousarray(X)
        trace.end(t, rows=len(X), nbytes=X.nbytes)
        t = trace.begin("repro_torch.h2d")
        x = torch.from_numpy(X).to(self.device)
        trace.end(t, rows=len(X), padded_rows=rows, nbytes=X.nbytes)
        return CardFeed(quantize_rows(
            x, self.lo, self.span, self.cols, scale=self.scale,
            bits=self.bits, nan_value=self.nan_value, rows=rows), len(X))


def input_grid(forest: Forest,
               device: torch.device) -> Optional[InputGrid]:
    """The forest's ``InputGrid`` where the card quantizes the rows: on a
    CUDA device, for a forest with integer thresholds over at least one
    feature.  None elsewhere: on the CPU, and for float, leaves-only and
    FLInt forests, the host's transform stays."""
    if device.type != "cuda" or forest.quant_scale is None or \
            not np.issubdtype(forest.threshold.dtype, np.integer) or \
            not len(forest.feat_lo):
        return None
    return InputGrid(forest, device)


def _out_dtype(forest: Forest, block_t: int) -> torch.dtype:
    """Kernel output dtype: int32 accumulation for int-accum forests.

    The CUDA kernels sum int32 directly, but the reference's Pallas tiles
    sum in f32 and need ``block_t × max|leaf| < 2^24``; the same check
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
    path for batch bucketing/padding, inherits predict_class/proba.
    ``launch(x, *arrays, out_dtype=)`` is the kernel wrapper; ``arrays``
    its padded operands, ``feat`` first; ``limits(*arrays)`` the kernel
    module's limits function, which on a CUDA device must pass before any
    array is moved there (the plain version on the CPU takes any
    forest).

    On the card, a forest with integer thresholds has its rows quantized
    there (``grid``, an ``InputGrid``): ``predict`` copies the raw rows
    once, launches ``quantize_rows`` into a bucket, the forest kernel and
    one read back.  Elsewhere the host transforms and pads the rows."""

    def __init__(self, forest: Forest, launch, arrays: tuple, out_dtype,
                 block_b: int, device: torch.device, limits=None):
        if forest.flint:
            raise ValueError(
                "FLInt forests are unsupported on the cuda backend: the "
                "kernel takes f32 rows, which cannot represent int32 FLInt "
                "keys (use backend='torch')")
        if limits is not None and device.type == "cuda":
            limits(*arrays)
        # no BasePredictor.__init__: the "compiled" state is the host
        # forest + the padded kernel arrays on the device
        self.forest = forest
        self.device = device
        self.launch = launch
        self.arrays = tuple(torch.from_numpy(a).to(device) for a in arrays)
        self.out_dtype = out_dtype
        self.block_b = block_b
        self.leaf_scale = leaf_scale(forest)
        # the kernel gathers x[row, feat] unchecked: rows must be this wide
        self.min_width = int(arrays[0].max(initial=0)) + 1
        self._shapes: set = set()        # padded shapes launched

    @functools.cached_property
    def grid(self) -> Optional[InputGrid]:
        """Made on the first transform, so a cascade's stage predictors,
        fed host rows, never make one."""
        return input_grid(self.forest, self.device)

    def transform_inputs(self, X: np.ndarray):
        """Raw rows → the kernel's feed: on the card with a ``grid``, a
        ``CardFeed`` (the bucket on the card and the row count); else the
        host's ``quantize_inputs`` as f32 rows."""
        if self.grid is None:
            return quantize_inputs(self.forest,
                                   np.asarray(X)).astype(np.float32)
        X = np.asarray(X)
        return self.grid.feed(X, bucket_rows(len(X), self.block_b))

    def predict_transformed(self, Xq) -> np.ndarray:
        """Scores for rows that went through the input transform: host
        rows (the host's, from any caller), or this predictor's
        ``CardFeed``, which is launched as it is."""
        if isinstance(Xq, CardFeed):
            x, B = Xq
        else:
            x, B = self._host_feed(Xq)
        self._shapes.add((tuple(x.shape), "<f4"))
        t = trace.begin("repro_torch.launch")
        out = self.launch(x, *self.arrays, out_dtype=self.out_dtype)
        trace.end(t)
        t = trace.begin("repro_torch.d2h")
        host = out[:B].cpu().numpy()
        trace.end(t, nbytes=host.nbytes)
        # int-accum kernels return int32 totals; the f32 cast + pow2
        # descale matches the torch engine's rounding bit-for-bit
        t = trace.begin("repro_torch.descale")
        scores = host.astype(np.float32) / self.leaf_scale
        trace.end(t)
        return scores

    def _host_feed(self, Xq: np.ndarray):
        """Host rows → (the padded bucket on the device, the row count)."""
        t = trace.begin("repro_torch.pad")
        Xq = ensure_feature_column(np.asarray(Xq, dtype=np.float32))
        if Xq.ndim != 2 or Xq.shape[1] < self.min_width:
            trace.end(t)
            raise ValueError(f"rows of width >= {self.min_width} expected, "
                             f"got shape {Xq.shape}")
        B = Xq.shape[0]
        Xp = np.ascontiguousarray(
            _pad_to(Xq, 0, bucket_rows(B, self.block_b)))
        trace.end(t, rows=B, padded_rows=Xp.shape[0])
        t = trace.begin("repro_torch.h2d")
        x = torch.from_numpy(Xp).to(self.device)
        trace.end(t, nbytes=Xp.nbytes)
        return x, B


def _node_arrays(forest: Forest, block_t: int, node_thr, tree_thr):
    """feat (T, N) i32, thr (T, N) f32 and leaf_val (T, L, C) f32, the tree
    axis padded to ``block_t``: padding nodes take threshold ``node_thr``,
    padding trees feature 0, threshold ``tree_thr`` and zero leaf rows."""
    feat = _pad_to(np.maximum(forest.feature, 0).astype(np.int32), 0, block_t)
    thr = forest.threshold.astype(np.float32).copy()
    thr[forest.feature < 0] = np.float32(node_thr)
    thr = _pad_to(thr, 0, block_t, fill=np.float32(tree_thr))
    leaf_val = _pad_to(forest.leaf_value.astype(np.float32), 0, block_t)
    return feat, thr, leaf_val


def _qs_arrays(forest: Forest, block_t: int):
    """QuickScorer kernel arrays (feat, thr, masks, init_idx, leaf_val),
    tree axis padded to ``block_t`` with inert trees (+inf thresholds →
    no predicate fires, init 0 → leaf 0 → all-zero leaf row).  Padding
    nodes take ``_thr_pad_value``: iinfo.max for quantized forests (no
    quantized input exceeds it), +inf for float ones.  Masks travel as
    int32 bit patterns."""
    feat, thr, leaf_val = _node_arrays(forest, block_t,
                                       _thr_pad_value(forest), np.inf)
    masks = _pad_to(forest.node_masks(), 0, block_t, fill=0xFFFFFFFF)
    init_idx = _pad_to(forest.init_leafidx(), 0, block_t)           # pad: 0
    return (feat, thr, as_bit_pattern(masks).numpy(),
            as_bit_pattern(init_idx).numpy(), leaf_val)


def cuda_qs_predictor(forest: Forest, block_b: int = 128, block_t: int = 8,
                      device=None) -> _KernelPredictor:
    """QuickScorer bitvector engine, CUDA backend (the counterpart of
    ``repro.kernels.ops.pallas_qs_predictor``).  ``device=None`` means
    the card; on ``device="cpu"`` the kernel's plain version runs."""
    device = resolve_device(device)
    with trace.span("repro_torch.compile_arrays"):
        arrays = _qs_arrays(forest, block_t)
    return _KernelPredictor(forest, qs_forward, arrays,
                            _out_dtype(forest, block_t), block_b, device,
                            limits=qs_forward_limits)


def _bitmm_arrays(forest: Forest, block_t: int):
    """Bit-matmul kernel arrays (feat, thr, planes, bias, leaf_val) and the
    field layout (bits, npack), tree axis padded to ``block_t``.  Padding
    nodes and trees get +inf thresholds (no predicate fires) and zero
    packed rows; padding trees a bias of ``bitmm_full_word`` (every leaf
    cleared → leaf 0) and zero leaf rows.  The packed words are integers
    below 2^24, so they split exactly into the three u8 byte planes the
    int8 tensor cores read (``byte_planes``: (T, 3, G, Npad), K-major per
    tree), and the bias converts exactly to int32."""
    packed, bias, bits, npack = bitmm_pack_arrays(forest)
    feat, thr, leaf_val = _node_arrays(forest, block_t, np.inf, np.inf)
    planes = byte_planes(_pad_to(packed, 0, block_t))             # pad: 0
    bias = _pad_to(bias.astype(np.int32), 0, block_t,
                   fill=bitmm_full_word(bits, npack))
    return (feat, thr, planes, bias, leaf_val), bits, npack


def cuda_bitmm_predictor(forest: Forest, block_b: int = 128,
                         block_t: int = 8, device=None) -> _KernelPredictor:
    """Bit-matmul QuickScorer engine, CUDA backend (the counterpart of
    ``repro.kernels.ops.pallas_bitmm_predictor``).  ``device=None`` means
    the card; on ``device="cpu"`` the kernel's plain version runs."""
    device = resolve_device(device)
    with trace.span("repro_torch.compile_arrays"):
        arrays, bits, npack = _bitmm_arrays(forest, block_t)
    fn = functools.partial(qs_bitmm_forward, bits=bits, npack=npack,
                           n_leaves=forest.n_leaves)
    return _KernelPredictor(forest, fn, arrays, _out_dtype(forest, block_t),
                            block_b, device, limits=qs_bitmm_forward_limits)


def _gemm_arrays(forest: Forest, block_t: int):
    """GEMM kernel arrays (feat, thr, A, Bvec, leaf_val), tree axis padded
    to ``block_t``.  Padding nodes take thresholds -inf (their rows of A
    are zero, so S is irrelevant; -inf makes it 0 for finite rows);
    padding trees zero rows of A and Bvec = L + 1 (no leaf matches), as
    padding leaves already have.  A travels as int8 in the layout the
    int8 tensor cores read (``leaf_major``: (T, L, Npad), K-major per
    tree) and Bvec as int32, both exact."""
    A, Bvec = gemm_arrays(forest)
    feat, thr, leaf_val = _node_arrays(forest, block_t, -np.inf, -np.inf)
    A = leaf_major(_pad_to(A, 0, block_t))
    Bvec = _pad_to(Bvec.astype(np.int32), 0, block_t,
                   fill=forest.n_leaves + 1)
    return feat, thr, A, Bvec, leaf_val


def cuda_gemm_predictor(forest: Forest, block_b: int = 128, block_t: int = 8,
                        device=None) -> _KernelPredictor:
    """GEMM (Hummingbird) engine, CUDA backend (the counterpart of
    ``repro.kernels.ops.pallas_gemm_predictor``).  ``device=None`` means
    the card; on ``device="cpu"`` the kernel's plain version runs."""
    device = resolve_device(device)
    with trace.span("repro_torch.compile_arrays"):
        arrays = _gemm_arrays(forest, block_t)
    return _KernelPredictor(forest, gemm_forward, arrays,
                            _out_dtype(forest, block_t), block_b, device,
                            limits=gemm_forward_limits)


def cuda_fused_cascade_qs(forest: Forest, stages, policy, block_b: int = 128,
                          block_t: int = 8, device=None):
    """Single-kernel cascade for the bitvector engine: all stages and the
    gate in one ``cascade_qs_forward`` launch (the counterpart of
    ``repro.kernels.ops.pallas_fused_cascade_qs``).  Returns
    ``(Xp (B, d) f32, valid (B,) bool) -> (scores (B, C) descaled f32,
    exit_stage (B,) int32)`` on ``device`` (``None`` → the card; on
    ``device="cpu"`` the kernel's plain version runs).

    Each stage slice is padded to ``block_t`` trees on its own, as the
    staged per-stage predictors pad it, and the stages are concatenated.
    ``block_b`` is accepted so one ``engine_kw`` serves the stage
    predictors and this function: the kernel tiles rows itself, and
    ``FusedCascadePredictor`` pads batches to ``block_b`` multiples."""
    from ..cascade.predictor import tree_slice
    from .cascade_kernel import cascade_qs_forward, cascade_qs_forward_limits

    if forest.flint:
        raise ValueError(
            "FLInt forests are unsupported on the cuda backend: the fused "
            "cascade kernel takes f32 rows, which cannot represent int32 "
            "FLInt keys (use backend='torch')")
    device = resolve_device(device)
    bounds = (0,) + tuple(stages)
    with trace.span("repro_torch.compile_arrays"):
        parts = [_qs_arrays(tree_slice(forest, bounds[k], bounds[k + 1]),
                            block_t) for k in range(len(stages))]
        host = [np.concatenate([p[i] for p in parts]) for i in range(5)]
    if device.type == "cuda":
        cascade_qs_forward_limits(*parts[0])
    arrays = tuple(torch.from_numpy(a).to(device) for a in host)
    stage_bounds = (0,) + tuple(
        np.cumsum([p[0].shape[0] for p in parts]).tolist())
    out_dtype = _out_dtype(forest, block_t)
    inv_scale = 1.0 / leaf_scale(forest)
    inv = torch.tensor(inv_scale, dtype=torch.float32, device=device)

    def fn(Xp: torch.Tensor, valid: torch.Tensor):
        scores, exit_stage = cascade_qs_forward(
            Xp, valid, *arrays, stage_bounds=stage_bounds, policy=policy,
            inv_scale=inv_scale, out_dtype=out_dtype)
        # power-of-two scale: the multiply is exact on quantized forests
        return scores.to(torch.float32) * inv, exit_stage

    fn.stage_bounds = stage_bounds
    fn.arrays = arrays
    fn.out_dtype = out_dtype
    return fn
