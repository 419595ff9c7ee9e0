"""CUDA kernel: the forest kernels' input transform on the card.

``quantize_rows`` replaces no TPU kernel: the JAX package quantizes a
call's rows in NumPy on the host (``repro/core/quantize.py``
``quantize_inputs``), which in a bulk call took more time than the forest
kernel while the card sat idle.  It turns the caller's raw rows, copied to
the card as they are, into the forest kernels' zero-padded f32 feed in one
launch, bit for bit what ``quantize_inputs(...).astype(np.float32)`` gives.
It is bound by bytes (``csrc/quantize_rows.cu``).

For a CUDA tensor the wrapper launches ``csrc/quantize_rows.cu`` (built by
``kernels/build.py``) on the current stream, or raises; for a CPU tensor it
runs ``quantize_rows_reference``, the same function in plain torch.
Nothing falls back from one to the other.  ``quantize_rows.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import torch

from .launch import check_tensors, launch, library, on_card


def quantize_rows_reference(x, lo, span, cols, *, scale: float, bits: int,
                            nan_value: float, rows: int) -> torch.Tensor:
    """The plain torch version: ``quantize_inputs``'s float64 arithmetic in
    its order (``normalize_features``, ``floor``, the int grid's clip),
    NaN as ``nan_value``, the int cast's +0.0 for -0.0; rows ``n`` to
    ``rows`` zero."""
    imax = 2 ** (bits - 1) - 1
    v = x.to(torch.float64)
    if cols is not None:
        v = v[:, cols.long()]
    v = ((v - lo) / span).clamp(0.0, 1.0)
    v = torch.floor(scale * v).clamp(-imax - 1, imax)
    out = torch.zeros((rows, lo.shape[0]), dtype=torch.float32,
                      device=x.device)
    out[:x.shape[0]] = torch.where(v.isnan(), nan_value, v).to(torch.int32)
    return out


def _check(x, lo, span, cols, bits, rows):
    named = dict(lo=lo, span=span)
    dtypes = dict(lo=torch.float64, span=torch.float64, cols=torch.int32)
    if cols is not None:
        named["cols"] = cols
    check_tensors(x, named, dtypes, dict(lo=1, span=1, cols=1))
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x: dtype {x.dtype}, expected float32 or float64")
    if x.dim() != 2 or not (x.is_contiguous() or x.t().is_contiguous()):
        raise ValueError("x must be 2-D, row-major or column-major")
    d = lo.shape[0]
    if span.shape != (d,) or (cols is not None and cols.shape != (d,)):
        raise ValueError(
            f"inconsistent shapes: lo {tuple(lo.shape)}, span "
            f"{tuple(span.shape)}, cols "
            f"{None if cols is None else tuple(cols.shape)}")
    if d < 1:
        raise ValueError("the grid needs at least one feature")
    if cols is None and x.shape[1] != d:
        raise ValueError(f"rows of width {d} expected, got shape "
                         f"{tuple(x.shape)}")
    if not 1 < bits <= 16:
        raise ValueError(f"bits={bits}: the grid is 2 to 16 bits wide")
    if rows < x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows do not fit a bucket of {rows}")


def quantize_rows(x, lo, span, cols, *, scale: float, bits: int,
                  nan_value: float, rows: int) -> torch.Tensor:
    """Raw rows → the forest kernels' feed (rows, d) f32, zero past row n.

    x (n, d_in) f32 or f64, row-major or column-major (a transposed
    contiguous tensor), read in its own dtype; lo and span (d,) f64,
    span being ``hi - lo`` as NumPy computes it; cols (d,) int32 (the
    forest's ``feat_map``) or None for the identity, which needs d_in = d;
    ``scale`` the forest's ``quant_scale``; ``bits`` its ``quant_bits``;
    ``nan_value`` what the host's int cast gives NaN; ``rows`` >= n the
    bucket.  Every ``cols`` entry must be < d_in: the kernel gathers
    without a bounds check (``ops.InputGrid`` checks it on the host)."""
    _check(x, lo, span, cols, bits, rows)
    if not on_card(x, "quantize_rows"):
        return quantize_rows_reference(x, lo, span, cols, scale=scale,
                                       bits=bits, nan_value=nan_value,
                                       rows=rows)
    n, d_in = x.shape
    d = lo.shape[0]
    imax = 2 ** (bits - 1) - 1
    out = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    # the strides of a size-1 axis are arbitrary: take them from the layout
    strides = (d_in, 1) if x.is_contiguous() else (1, n)
    lib = library("quantize_rows", "quantize_rows_launch",
                  "quantize_rows_error_string", 5, 6, n_doubles=4)
    launch(lib.quantize_rows_launch, lib.quantize_rows_error_string,
           "quantize_rows", x.device, x.data_ptr() if n else None,
           lo.data_ptr(), span.data_ptr(),
           None if cols is None else cols.data_ptr(), out.data_ptr(), n,
           rows, d, *strides, int(x.dtype == torch.float64), float(scale),
           float(-imax - 1), float(imax), float(nan_value))
    quantize_rows.launches += 1
    return out


quantize_rows.launches = 0
quantize_rows.source = "src/repro_torch/kernels/csrc/quantize_rows.cu"
quantize_rows.replaces = None
