"""The CUDA QuickScorer kernel module against the reference Pallas kernel.

Here, without a card, ``cuda_qs_predictor(..., device="cpu")`` runs the
kernel's plain torch version through the same host glue (padding,
bucketing, int accumulation, descale); it is held against
``repro.kernels.ops.pallas_qs_predictor`` in interpret mode, as
tests/test_kernels.py runs it.  ``test_torch_cuda.py`` holds the kernel
itself against its plain version on the card."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.kernels.ops import pallas_qs_predictor  # noqa: E402
from repro.kernels.ref import ref_oracle, ref_qs  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from test_kernels import SHAPE_SWEEP  # noqa: E402
from repro_torch.kernels import ops, quickscorer_kernel  # noqa: E402
from repro_torch.kernels.quickscorer_kernel import (  # noqa: E402
    qs_forward, qs_forward_reference)



def port_pred(ref_forest, **kw):
    forest = tcore.forest_from_reference(vars(ref_forest))
    return ops.cuda_qs_predictor(forest, device="cpu", **kw)


def sweep_forest(T, L, d, C):
    return rcore.random_forest_ir(T, L, d, n_classes=C, seed=T,
                                  full=(T % 2 == 0))


@pytest.mark.parametrize("T,L,d,C,B", SHAPE_SWEEP)
def test_cuda_qs_matches_pallas(T, L, d, C, B):
    forest = sweep_forest(T, L, d, C)
    X = np.random.default_rng(B).normal(0, 1.3, size=(B, d))
    got = port_pred(forest, block_b=32, block_t=4).predict(X)
    want = pallas_qs_predictor(forest, block_b=32, block_t=4).predict(X)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref_oracle(forest, X), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("T,L,d,C,B", SHAPE_SWEEP)
def test_cuda_qs_int_accum_sweep_bit_exact(T, L, d, C, B):
    forest = sweep_forest(T, L, d, C)
    X = np.random.default_rng(B).normal(0, 1.3, size=(B, d))
    qf = rcore.quantize_forest(forest, X, rcore.QuantSpec(16,
                                                          int_accum=True))
    pred = port_pred(qf, block_b=32, block_t=4)
    assert pred.out_dtype == torch.int32
    np.testing.assert_array_equal(
        pred.predict(X),
        pallas_qs_predictor(qf, block_b=32, block_t=4).predict(X))


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("int_accum", [True, False])
def test_cuda_qs_quantized(bits, int_accum, trained_rf, magic_ds):
    """Quantized leaves are integers below 2^24, so every summation
    order is exact: bit-exact with and without int accumulation."""
    forest = rcore.from_random_forest(trained_rf)
    qf = rcore.quantize_forest(forest, magic_ds.X_train, rcore.QuantSpec(
        bits=bits, int_accum=int_accum))
    X = magic_ds.X_test[:64]
    got = port_pred(qf, block_b=32, block_t=8).predict(X)
    np.testing.assert_array_equal(
        got, pallas_qs_predictor(qf, block_b=32, block_t=8).predict(X))
    np.testing.assert_allclose(got, ref_oracle(qf, X), rtol=1e-5, atol=1e-6)


def test_cuda_qs_block_shape_independence(small_forest):
    """Result must not depend on the row bucket or tree padding."""
    X = np.random.default_rng(7).normal(size=(70, small_forest.n_features))
    ref = ref_qs(small_forest, X)
    outs = [port_pred(small_forest, block_b=bb, block_t=bt).predict(X)
            for bb, bt in [(8, 2), (32, 4), (128, 8)]]
    for got in outs:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got, outs[0])


def test_cuda_qs_padding_batch_edge(small_forest):
    """Batch not a multiple of block_b: padded rows must not leak."""
    X = np.random.default_rng(8).normal(size=(5, small_forest.n_features))
    got = port_pred(small_forest, block_b=64).predict(X)
    assert got.shape == (5, 1)
    np.testing.assert_allclose(
        got, pallas_qs_predictor(small_forest, block_b=64).predict(X),
        rtol=1e-5, atol=1e-6)


def test_cuda_qs_tree_padding(class_forest):
    """12 trees padded to 16: inert padding trees contribute nothing."""
    X = np.random.default_rng(9).normal(size=(16, class_forest.n_features))
    got = port_pred(class_forest, block_b=16, block_t=8).predict(X)
    np.testing.assert_allclose(
        got, pallas_qs_predictor(class_forest, block_b=16,
                                 block_t=8).predict(X), rtol=1e-5, atol=1e-6)
    feat, thr, masks, init_idx, leaf_val = ops._qs_arrays(
        tcore.forest_from_reference(vars(class_forest)), 8)
    assert feat.shape[0] == 16 and np.isinf(thr[12:]).all()
    assert (init_idx[12:] == 0).all() and (leaf_val[12:] == 0).all()
    assert (masks[12:] == -1).all()


def test_qs_arrays_quantized_padding_nodes(class_forest):
    """Quantized padding nodes take iinfo.max; float ones +inf."""
    X = np.random.default_rng(10).normal(size=(50, class_forest.n_features))
    qf = tcore.forest_from_reference(vars(rcore.quantize_forest(
        class_forest, X, rcore.QuantSpec(bits=8))))
    qf.feature[0, -3:] = -1          # make the last nodes of tree 0 padding
    _, thr, _, _, _ = ops._qs_arrays(qf, 8)
    assert (thr[0, -3:] == 127).all() and np.isinf(thr[12:]).all()
    _, thr, _, _, _ = ops._qs_arrays(tcore.forest_from_reference(
        vars(class_forest)), 8)
    assert np.isinf(thr[12:]).all()


def test_out_dtype_rejects_what_the_reference_rejects(small_forest):
    qf = tcore.forest_from_reference(vars(rcore.quantize_forest(
        small_forest, None, rcore.QuantSpec(16, int_accum=True))))
    big = qf.leaf_value.copy()
    big[0, 0, 0] = 2 ** 22
    qf.leaf_value = big
    with pytest.raises(ValueError, match="2\\^24"):
        ops.cuda_qs_predictor(qf, block_t=8, device="cpu")


def test_bucket_rows_matches_reference():
    from repro.kernels.ops import bucket_rows as rbucket
    for n in (1, 5, 64, 65, 128, 129, 1000, 1025):
        assert ops.bucket_rows(n, 32) == rbucket(n, 32)


def test_flint_forest_rejected(small_forest):
    forest = tcore.flint_forest(tcore.forest_from_reference(
        vars(small_forest)))
    with pytest.raises(ValueError, match="FLInt"):
        ops.cuda_qs_predictor(forest, device="cpu")


def _kernel_args(forest, B=9, seed=0):
    arrays = [torch.from_numpy(a) for a in ops._qs_arrays(forest, 4)]
    X = np.random.default_rng(seed).normal(size=(B, forest.n_features))
    return [torch.from_numpy(X.astype(np.float32))] + arrays


def test_qs_forward_cpu_is_plain_version_and_not_counted(small_forest):
    args = _kernel_args(tcore.forest_from_reference(vars(small_forest)))
    before = qs_forward.launches
    np.testing.assert_array_equal(qs_forward(*args).numpy(),
                                  qs_forward_reference(*args).numpy())
    assert qs_forward.launches == before


def test_qs_forward_checks_its_inputs(small_forest):
    args = _kernel_args(tcore.forest_from_reference(vars(small_forest)))
    bad_dtype = list(args)
    bad_dtype[0] = args[0].double()
    with pytest.raises(TypeError, match="x: dtype"):
        qs_forward(*bad_dtype)
    strided = list(args)
    strided[1] = args[1].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        qs_forward(*strided)
    short = list(args)
    short[2] = args[2][:, :-1].contiguous()
    with pytest.raises(ValueError, match="inconsistent shapes"):
        qs_forward(*short)
    with pytest.raises(TypeError, match="out_dtype"):
        qs_forward(*args, out_dtype=torch.float64)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        qs_forward(*meta)


def test_predictor_rejects_narrow_rows(small_forest):
    pred = port_pred(small_forest)
    with pytest.raises(ValueError, match="width"):
        pred.predict_transformed(np.zeros((3, 1), dtype=np.float32))


def test_tree_chunk_fits_shared_memory():
    for T, N, W in [(1024, 63, 2), (3, 15, 1), (100, 255, 8)]:
        tc = quickscorer_kernel.tree_chunk(T, N, W)
        assert 1 <= tc <= min(T, quickscorer_kernel.MAX_TREE_CHUNK)
        assert 4 * tc * (N * (2 + W) + W) <= quickscorer_kernel.SHARED_BYTES

