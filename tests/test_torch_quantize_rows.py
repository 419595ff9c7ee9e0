"""The card's input transform (``kernels/quantize_kernel.py``) on the CPU.

``quantize_rows``'s plain torch version, reached through
``ops.InputGrid.feed`` as the card path reaches the kernel, against the
reference package's ``quantize_inputs(...).astype(np.float32)`` bit for
bit, bucket padding included; the card path's glue through every kernel
predictor and both fused cascade tiers against the host path, with the
plain versions; and which forests and devices take it.
``tests/test_torch_cuda.py`` holds the kernel itself to the same."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.cascade import (CascadeSpec,  # noqa: E402
                                 FusedCascadePredictor, MarginGate)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.quantize_kernel import (  # noqa: E402
    quantize_rows, quantize_rows_reference)
from repro_torch.obs import trace  # noqa: E402

CPU = torch.device("cpu")
D, D_SRC = 7, 11                  # features, and the caller's width under a map
FEAT_MAP = np.array([9, 0, 4, 10, 2, 7, 5], dtype=np.int64)


def grid_forest(bits, feat_map, seed=0):
    """(reference forest, port forest) quantized at ``bits`` on rows of
    D features; with ``feat_map`` the features read the caller's columns
    FEAT_MAP of D_SRC."""
    f = rcore.random_forest_ir(6, 16, D, seed=seed, full=True)
    X = np.random.default_rng(seed).normal(0, 1.3, size=(200, D))
    rf = rcore.quantize_forest(f, X, rcore.QuantSpec(bits, int_accum=True))
    if feat_map:
        rf = dataclasses.replace(rf, feat_map=FEAT_MAP, n_features_src=D_SRC)
    return rf, tcore.forest_from_reference(vars(rf))


def awkward_rows(rf, n, dtype, seed=1):
    """n rows in ``dtype``: normal draws, and in the first 64 rows every
    feature's column cycles through NaN, ±inf, ±0.0, lo and hi and one ulp
    beyond them, a grid edge and one ulp either side, and the dtype's
    largest values."""
    mapped = rf.feat_map is not None
    cols = FEAT_MAP if mapped else np.arange(D)
    X = np.random.default_rng(seed).normal(
        0, 1.3, size=(n, D_SRC if mapped else D)).astype(dtype)
    big = np.finfo(dtype).max
    lo, hi = rf.feat_lo, rf.feat_hi
    for j, c in enumerate(cols):
        k = 2 ** (rf.quant_bits - 2) + 3 * j           # a grid edge
        edge = dtype(lo[j] + k * (hi[j] - lo[j]) / rf.quant_scale)
        lo_j, hi_j = dtype(lo[j]), dtype(hi[j])
        kinds = [np.nan, np.inf, -np.inf, -0.0, 0.0, lo_j, hi_j,
                 np.nextafter(lo_j, dtype(-np.inf)),
                 np.nextafter(hi_j, dtype(np.inf)), edge,
                 np.nextafter(edge, dtype(-np.inf)),
                 np.nextafter(edge, dtype(np.inf)), big, -big]
        for r in range(min(n, 64)):
            X[r, c] = kinds[(r + j) % len(kinds)]
    return X


def laid_out(X, layout):
    """X as a caller may hold it: row-major, column-major, or a block of
    rows of a column-major array (a data frame's values, sliced)."""
    if layout == "rows":
        return X
    if layout == "columns":
        return np.asfortranarray(X)
    whole = np.asfortranarray(np.concatenate([X, np.zeros_like(X[:5])]))
    return whole[:len(X)]


@pytest.mark.parametrize("layout", ["rows", "columns", "column-slice"])
@pytest.mark.parametrize("n", [1, 8, 100, 8192])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("feat_map", [False, True], ids=["cols", "map"])
@pytest.mark.parametrize("bits", [16, 8])
def test_feed_matches_host_transform_bit_for_bit(bits, feat_map, dtype, n,
                                                 layout):
    rf, tf = grid_forest(bits, feat_map)
    X = laid_out(awkward_rows(rf, n, dtype), layout)
    rows = ops.bucket_rows(n, 128)
    feed = ops.InputGrid(tf, CPU).feed(X, rows)
    assert feed.n == n and feed.x.dtype == torch.float32
    want = np.zeros((rows, D), dtype=np.float32)
    with np.errstate(invalid="ignore"):               # NaN's int cast
        want[:n] = rcore.quantize_inputs(rf, X).astype(np.float32)
    got = feed.x.numpy()
    # the bits: -0.0 and +0.0 differ here, and the padding rows are +0.0
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_reference_keeps_nan_and_signed_zero_apart():
    """NaN takes ``nan_value`` (the host cast's answer, whatever it is),
    -0.0 the int cast's +0.0, ±inf the ends of the grid."""
    x = torch.tensor([[np.nan, -0.0, np.inf, -np.inf]], dtype=torch.float64)
    lo = torch.zeros(4, dtype=torch.float64)
    span = torch.ones(4, dtype=torch.float64)
    out = quantize_rows(x, lo, span, None, scale=128.0, bits=8,
                        nan_value=-5.0, rows=2)
    assert out[0].tolist() == [-5.0, 0.0, 127.0, 0.0]
    assert not torch.signbit(out[0, 1:]).any()
    assert out[1].tolist() == [0.0] * 4
    assert torch.equal(out, quantize_rows_reference(
        x, lo, span, None, scale=128.0, bits=8, nan_value=-5.0, rows=2))


PREDICTORS = {
    "qs": ops.cuda_qs_predictor,
    "bitmm": ops.cuda_bitmm_predictor,
    "gemm": ops.cuda_gemm_predictor,
}


@pytest.mark.parametrize("engine", sorted(PREDICTORS))
@pytest.mark.parametrize("feat_map", [False, True], ids=["cols", "map"])
def test_card_path_glue_matches_host_path(engine, feat_map):
    """A kernel predictor given an ``InputGrid`` on the CPU runs the card
    path's glue (one copy, ``quantize_rows``' plain version into the
    bucket, the forest kernel's plain version, one read) and gives the
    host path's bits; its spans nest the copy inside ``transform`` and
    have no ``pad``."""
    _, tf = grid_forest(16, feat_map, seed=3)
    host = PREDICTORS[engine](tf, device="cpu")
    assert host.grid is None              # the CPU keeps the host path
    card = PREDICTORS[engine](tf, device="cpu")
    card.grid = ops.InputGrid(tf, CPU)
    for n, layout in ((1, "rows"), (77, "columns"), (300, "column-slice")):
        X = laid_out(awkward_rows(tf, n, np.float32, seed=n), layout)
        with np.errstate(invalid="ignore"):
            want = host.predict(X)
        trace.enable(True)
        trace.drain()
        try:
            got = card.predict(X)
        finally:
            trace.enable(False)
        np.testing.assert_array_equal(got, want)
        spans = trace.drain()
        by = {s["name"]: s for s in spans}
        assert "repro_torch.pad" not in by
        assert by["repro_torch.h2d"]["parent"] == \
            by["repro_torch.transform"]["id"]
        assert by["repro_torch.h2d"]["padded_rows"] == \
            ops.bucket_rows(n, card.block_b)
        assert by["repro_torch.h2d"]["nbytes"] == X.nbytes
    assert card.trace_cache_size() == host.trace_cache_size()


@pytest.mark.parametrize("engine", ["bitvector", "bitmm"],
                         ids=["kernel-tier", "generic-tier"])
def test_fused_cascade_card_path_matches_host_path(engine):
    """Both fused tiers with an ``InputGrid`` on the CPU: the bucket the
    grid writes gives the host path's scores and exit counts."""
    _, tf = grid_forest(16, False, seed=4)
    spec = CascadeSpec((2, 4, 6), MarginGate(0.2), fused=True)
    host = FusedCascadePredictor(tf, spec, engine=engine, backend="cuda",
                                 device="cpu")
    assert host._grid is None
    card = FusedCascadePredictor(tf, spec, engine=engine, backend="cuda",
                                 device="cpu")
    card._grid = ops.InputGrid(tf, CPU)
    for n, layout in ((5, "rows"), (130, "columns"), (513, "column-slice")):
        X = laid_out(awkward_rows(tf, n, np.float64, seed=n), layout)
        with np.errstate(invalid="ignore"):
            want = host.predict(X)
        np.testing.assert_array_equal(card.predict(X), want)
        np.testing.assert_array_equal(card.last_exit_counts,
                                      host.last_exit_counts)
    assert card.trace_cache_size() == host.trace_cache_size()
    # the stage predictors are fed rows and never make a grid of their own
    assert not any("grid" in vars(p) for p in card.stage_predictors)
    # calibration input stays on the host's transform
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(card.cumulative_scores(X[:40]),
                                      host.cumulative_scores(X[:40]))


def _float_forest():
    return tcore.random_forest_ir(4, 8, D, seed=5, full=True)


def _quantized(**kw):
    f = _float_forest()
    X = np.random.default_rng(5).normal(size=(50, D))
    return tcore.quantize_forest(f, X, tcore.QuantSpec(16, **kw))


@pytest.mark.parametrize("forest", [
    _float_forest, lambda: _quantized(quantize_splits=False),
    lambda: tcore.flint_forest(_float_forest())],
    ids=["float", "leaves-only", "flint"])
def test_input_grid_only_for_integer_thresholds(forest):
    """Float, leaves-only and FLInt forests keep the host's transform on
    any device; a quantized forest takes the grid only on the card (no
    card is touched: None is decided first)."""
    assert ops.input_grid(forest(), torch.device("cuda")) is None
    assert ops.input_grid(_quantized(), CPU) is None


@pytest.mark.parametrize("feat_map", [False, True], ids=["cols", "map"])
def test_feed_refuses_rows_it_cannot_read(feat_map):
    _, tf = grid_forest(16, feat_map)
    grid = ops.InputGrid(tf, CPU)
    width = D_SRC if feat_map else D
    with pytest.raises(ValueError, match="rows of width"):
        grid.feed(np.zeros((4, width - 1), np.float32), 128)
    with pytest.raises(ValueError, match="rows of width"):
        grid.feed(np.zeros(width, np.float32), 128)
    # a wider caller is fine under a map, which reads its own columns
    if feat_map:
        assert grid.feed(np.zeros((4, width + 3)), 128).n == 4
