"""The port's torch bitvector engine (``backend="torch"``) against the
reference XLA engine ``repro.core.eval_batch``: the same forests and rows
through both.  Quantized forests must be bit-exact; float forests within
rtol 1e-5 / atol 1e-6, the reference's own tolerance for a sum taken in
another order (tests/test_kernels.py:34)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.core import quickscorer as rqs  # noqa: E402
from repro.kernels.ref import ref_qs  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from test_kernels import SHAPE_SWEEP  # noqa: E402
from repro_torch.core import quickscorer as tqs  # noqa: E402
from repro_torch.core import registry  # noqa: E402

FIXTURES = ["small_forest", "class_forest", "big_leaf_forest"]


def torch_predict(ref_forest, X):
    forest = tcore.forest_from_reference(vars(ref_forest))
    return tcore.compile_forest(forest, backend="torch",
                                device="cpu").predict(X)


def sweep_forest(T, L, d, C):
    return rcore.random_forest_ir(T, L, d, n_classes=C, seed=T,
                                  full=(T % 2 == 0))


def rows(B, d, seed):
    return np.random.default_rng(seed).normal(0, 1.3, size=(B, d))


@pytest.mark.parametrize("name", FIXTURES)
def test_eval_batch_float_fixtures(request, name):
    forest = request.getfixturevalue(name)
    X = rows(64, forest.n_features, 3)
    np.testing.assert_allclose(torch_predict(forest, X), ref_qs(forest, X),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("bits,int_accum", [(16, True), (8, True),
                                            (16, False)])
def test_eval_batch_quantized_fixtures(request, name, bits, int_accum):
    forest = request.getfixturevalue(name)
    X = rows(64, forest.n_features, 4)
    qf = rcore.quantize_forest(forest, X, rcore.QuantSpec(
        bits=bits, int_accum=int_accum))
    np.testing.assert_array_equal(torch_predict(qf, X), ref_qs(qf, X))


@pytest.mark.parametrize("T,L,d,C,B", SHAPE_SWEEP)
def test_eval_batch_shape_sweep(T, L, d, C, B):
    forest = sweep_forest(T, L, d, C)
    X = rows(B, d, B)
    np.testing.assert_allclose(torch_predict(forest, X), ref_qs(forest, X),
                               rtol=1e-5, atol=1e-6)
    qf = rcore.quantize_forest(forest, X, rcore.QuantSpec(16,
                                                          int_accum=True))
    np.testing.assert_array_equal(torch_predict(qf, X), ref_qs(qf, X))


def test_eval_batch_trained_forest(trained_rf, magic_ds):
    forest = rcore.from_random_forest(trained_rf)
    X = magic_ds.X_test[:128]
    np.testing.assert_allclose(torch_predict(forest, X), ref_qs(forest, X),
                               rtol=1e-5, atol=1e-6)
    qf = rcore.quantize_forest(forest, magic_ds.X_train,
                               rcore.QuantSpec(16, int_accum=True))
    np.testing.assert_array_equal(torch_predict(qf, X), ref_qs(qf, X))


def test_eval_batch_chunked_over_trees(monkeypatch, class_forest):
    """The tree-chunked sum gives the unchunked result (bit-exact when
    quantized)."""
    X = rows(40, class_forest.n_features, 5)
    qf = rcore.quantize_forest(class_forest, X, rcore.QuantSpec(
        16, int_accum=True))
    whole = torch_predict(qf, X)
    monkeypatch.setattr(tqs, "_CHUNK_BYTES", 1)      # one tree per chunk
    np.testing.assert_array_equal(torch_predict(qf, X), whole)
    np.testing.assert_allclose(torch_predict(class_forest, X),
                               ref_qs(class_forest, X), rtol=1e-5, atol=1e-6)


def test_flint_torch_backend_matches_reference(small_forest):
    X = rows(64, small_forest.n_features, 6)
    ref = rcore.compile_forest(small_forest, backend="jax")
    forest = tcore.forest_from_reference(vars(small_forest))
    port = tcore.compile_plan(forest, backend="torch", device="cpu",
                              flint=True)
    assert "flint[f32 thresholds" in port.plan.describe()
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="cuda backend"):
        tcore.compile_plan(forest, backend="cuda", device="cpu", flint=True)


def test_ctz_and_exit_leaf_match_numpy():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, size=(50, 3), dtype=np.uint64)
    words[::7] = 0
    words[3] = [0, 0, 1 << 31]
    words[5] = [0x80000000, 0, 0]
    got = tqs.exit_leaf(tqs.as_bit_pattern(words.astype(np.uint32)))
    want = []
    for row in words:
        nz = [w for w in range(3) if row[w]]
        want.append(nz[0] * 32 + (int(row[nz[0]]) & -int(row[nz[0]]))
                    .bit_length() - 1 if nz else 0)
    np.testing.assert_array_equal(got.numpy(), want)
    w = torch.tensor([1, 2, 3, 1 << 31, 0xFFFFFFFF, 1 << 16], dtype=torch.int64)
    np.testing.assert_array_equal(tqs.ctz32(w).numpy(), [0, 1, 0, 31, 0, 16])


def test_mask_reduce_matches_reference(big_leaf_forest):
    """The halving AND-reduction equals the reference's lax.reduce."""
    rqsc = rqs.compile_qs(big_leaf_forest)
    tqsc = tqs.compile_qs(tcore.forest_from_reference(vars(big_leaf_forest)),
                          device="cpu")
    cond = np.random.default_rng(1).random(
        (5,) + big_leaf_forest.feature.shape) < 0.4
    ref = np.asarray(rqs.mask_reduce(cond, rqsc.masks, rqsc.init_idx))
    got = tqs.mask_reduce(torch.from_numpy(cond), tqsc.masks, tqsc.init_idx)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


def test_compiled_qs_buffers_and_dtypes(class_forest):
    qs = tqs.compile_qs(tcore.forest_from_reference(vars(class_forest)),
                        device="cpu")
    names = {n for n, _ in qs.named_buffers()}
    assert names == {"feat", "thr", "valid", "masks", "init_idx", "leaf_val"}
    assert qs.masks.dtype == torch.int32 and qs.thr.dtype == torch.float32
    assert qs.n_trees == class_forest.n_trees
    assert qs.n_words == class_forest.n_words


def test_eval_scalar_numpy_matches_reference(class_forest):
    X = rows(12, class_forest.n_features, 7)
    port = tcore.forest_from_reference(vars(class_forest))
    np.testing.assert_array_equal(tcore.eval_scalar_numpy(port, X),
                                  rcore.eval_scalar_numpy(class_forest, X))


def test_predict_proba_and_class_match_reference(class_forest):
    X = rows(32, class_forest.n_features, 8)
    ref = rcore.compile_forest(class_forest, backend="jax")
    port = tcore.compile_forest(
        tcore.forest_from_reference(vars(class_forest)), backend="torch",
        device="cpu")
    np.testing.assert_allclose(port.predict_proba(X), ref.predict_proba(X),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port.predict_class(X),
                                  ref.predict_class(X))


def test_float64_rows_compare_as_float32():
    """A float64 row just above an f32 threshold must compare as its f32
    rounding does, as the reference's x64-off engines do."""
    forest = rcore.random_forest_ir(1, 2, 1, seed=0)
    t = float(forest.threshold[0, 0])
    X = np.array([[np.nextafter(t, np.inf)]], dtype=np.float64)
    assert np.float32(X[0, 0]) == np.float32(t)       # rounds onto t
    np.testing.assert_array_equal(torch_predict(forest, X),
                                  ref_qs(forest, X))


def test_registry_and_device_resolution():
    assert ("bitvector", "torch") in {(s.name, s.backend)
                                      for s in registry.specs()}
    assert "bitvector" in registry.engines("cuda")
    with pytest.raises(ValueError, match="unknown engine"):
        registry.get("nope", "torch")
    assert registry.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            registry.resolve_device(None)


def test_non_finite_rows_follow_the_gather_engine(class_forest):
    """Rows with +inf, -inf or NaN features score as the reference's
    gather engine scores them (x > t: NaN goes left), in both of the
    port's backends."""
    from repro_torch.kernels.ops import cuda_qs_predictor
    X = rows(6, class_forest.n_features, 11)
    X[0, :3] = np.inf
    X[1, 2:5] = -np.inf
    X[2, ::2] = np.nan
    X[3, :] = np.nan
    want = ref_qs(class_forest, X)
    np.testing.assert_allclose(torch_predict(class_forest, X), want,
                               rtol=1e-5, atol=1e-6)
    port = tcore.forest_from_reference(vars(class_forest))
    np.testing.assert_allclose(
        cuda_qs_predictor(port, device="cpu").predict(X), want, rtol=1e-5,
        atol=1e-6)
