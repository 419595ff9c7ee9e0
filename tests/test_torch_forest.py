"""The port's numpy foundation against the reference: trainers, datasets,
Forest IR, masks, quantization and the reference-forest converter give
array-equal results, fields and dtypes alike."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.data import datasets as rdatasets  # noqa: E402
from repro.trees.gradient_boosting import (  # noqa: E402
    GradientBoosting as RGB, GradientBoostingConfig as RGBConfig)
from repro.trees.random_forest import (  # noqa: E402
    RandomForest as RRF, RandomForestConfig as RRFConfig)
from repro_torch import core as tcore  # noqa: E402
from repro_torch.data import datasets as tdatasets  # noqa: E402
from repro_torch.trees.gradient_boosting import (  # noqa: E402
    GradientBoosting as TGB, GradientBoostingConfig as TGBConfig)
from repro_torch.trees.random_forest import (  # noqa: E402
    RandomForest as TRF, RandomForestConfig as TRFConfig)

IR_CASES = [
    # (n_trees, n_leaves, n_features, n_classes, seed, full)
    (8, 16, 6, 1, 0, True),
    (12, 32, 10, 3, 1, False),
    (6, 64, 8, 2, 2, False),
    (5, 2, 3, 1, 4, True),
]


def assert_same(a, b, what=""):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype, f"{what}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert type(a) is type(b) or a is None or b is None, what
        assert a == b, f"{what}: {a!r} != {b!r}"


def assert_forest_equal(ref, port):
    rf, pf = vars(ref), vars(port)
    assert rf.keys() == pf.keys()
    for k in rf:
        assert_same(rf[k], pf[k], k)


def both_ir(T, L, d, C, seed, full):
    return (rcore.random_forest_ir(T, L, d, n_classes=C, seed=seed,
                                   full=full),
            tcore.random_forest_ir(T, L, d, n_classes=C, seed=seed,
                                   full=full))


@pytest.mark.parametrize("T,L,d,C,seed,full", IR_CASES)
def test_random_forest_ir_equal(T, L, d, C, seed, full):
    ref, port = both_ir(T, L, d, C, seed, full)
    assert_forest_equal(ref, port)
    assert_same(ref.node_masks(), port.node_masks(), "node_masks")
    assert_same(ref.init_leafidx(), port.init_leafidx(), "init_leafidx")
    assert port.n_words == ref.n_words


@pytest.mark.parametrize("T,L,d,C,seed,full", IR_CASES)
def test_predict_oracle_equal(T, L, d, C, seed, full):
    ref, port = both_ir(T, L, d, C, seed, full)
    X = np.random.default_rng(seed).normal(0, 1.3, size=(40, d))
    assert_same(ref.predict_oracle(X), port.predict_oracle(X))


@pytest.mark.parametrize("name", sorted(rdatasets.REGISTRY))
def test_datasets_equal(name):
    ref = rdatasets.REGISTRY[name](n=300)
    port = tdatasets.REGISTRY[name](n=300)
    for k in ("X_train", "y_train", "X_test", "y_test"):
        assert_same(getattr(ref, k), getattr(port, k), f"{name}.{k}")
    assert ref.n_classes == port.n_classes


@pytest.mark.parametrize("max_leaves,max_features", [(16, None), (8, 0.5)])
def test_random_forest_trainer_equal(magic_ds, max_leaves, max_features):
    kw = dict(n_trees=12, max_leaves=max_leaves, max_features=max_features,
              seed=3)
    ref = RRF(RRFConfig(**kw)).fit(magic_ds.X_train, magic_ds.y_train)
    port = TRF(TRFConfig(**kw)).fit(magic_ds.X_train, magic_ds.y_train)
    assert_forest_equal(rcore.from_random_forest(ref),
                        tcore.from_random_forest(port))
    assert_same(ref.predict_proba(magic_ds.X_test),
                port.predict_proba(magic_ds.X_test))


@pytest.mark.parametrize("objective", ["l2", "logistic", "softmax"])
def test_gradient_boosting_trainer_equal(objective):
    ds = rdatasets.make_magic(n=600) if objective != "l2" \
        else rdatasets.make_msn(n=600)
    X, y = ds.X_train[:, :12], ds.y_train
    kw = dict(n_trees=6, max_leaves=8, objective=objective, subsample=300,
              seed=5)
    ref = RGB(RGBConfig(**kw)).fit(X, y)
    port = TGB(TGBConfig(**kw)).fit(X, y)
    assert_forest_equal(rcore.from_gradient_boosting(ref),
                        tcore.from_gradient_boosting(port))
    assert_same(ref.predict(X), port.predict(X))


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("int_accum", [False, True])
def test_quantize_forest_equal(bits, int_accum):
    ref, port = both_ir(12, 32, 10, 3, 1, False)
    X = np.random.default_rng(bits).normal(0, 1.2, size=(200, 10))
    X[3, 2] = np.nan                       # non-finite calibration rows
    X[5, 7] = np.inf
    spec_r = rcore.QuantSpec(bits=bits, int_accum=int_accum)
    spec_p = tcore.QuantSpec(bits=bits, int_accum=int_accum)
    qr = rcore.quantize_forest(ref, X, spec_r)
    qp = tcore.quantize_forest(port, X, spec_p)
    assert_forest_equal(qr, qp)
    assert rcore.accum_bits(qr) == tcore.accum_bits(qp)
    assert rcore.leaf_scale(qr) == tcore.leaf_scale(qp)
    Xin = np.random.default_rng(bits + 1).normal(0, 2.0, size=(64, 10))
    assert_same(rcore.quantize_inputs(qr, Xin), tcore.quantize_inputs(qp, Xin))


def test_quantize_from_thresholds_and_big_leaves():
    """No calibration data, and leaves far above int_max (auto-shrink)."""
    ref, port = both_ir(8, 16, 6, 1, 0, True)
    ref.leaf_value = ref.leaf_value * 1e4
    port.leaf_value = port.leaf_value * 1e4
    spec = dict(bits=16, int_accum=True)
    qr = rcore.quantize_forest(ref, None, rcore.QuantSpec(**spec))
    qp = tcore.quantize_forest(port, None, tcore.QuantSpec(**spec))
    assert_forest_equal(qr, qp)


def test_flint_key_and_forest_equal():
    x = np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, np.nan, 1e-45,
                  -1e-45, 3.4e38, -3.4e38], dtype=np.float32)
    assert_same(rcore.flint_key(x), tcore.flint_key(x))
    ref, port = both_ir(8, 16, 6, 1, 0, True)
    assert_forest_equal(rcore.flint_forest(ref), tcore.flint_forest(port))


@pytest.mark.parametrize("quantized", [False, True])
def test_forest_from_reference_round_trip(class_forest, quantized):
    ref = class_forest
    if quantized:
        X = np.random.default_rng(0).normal(size=(100, ref.n_features))
        ref = rcore.quantize_forest(ref, X, rcore.QuantSpec(16,
                                                            int_accum=True))
    port = tcore.forest_from_reference(vars(ref))
    assert isinstance(port, tcore.Forest)
    assert_forest_equal(ref, port)
    assert_forest_equal(port, tcore.forest_from_reference(vars(port)))
    # a copy, not a view of the reference's arrays
    assert not np.shares_memory(port.feature, ref.feature)


def test_forest_from_reference_checks_fields(small_forest):
    fields = dict(vars(small_forest))
    with pytest.raises(TypeError, match="threshold"):
        tcore.forest_from_reference(
            {**fields, "threshold": fields["threshold"].astype(np.float64)})
    with pytest.raises(ValueError, match="leaf_value"):
        tcore.forest_from_reference(
            {**fields, "leaf_value": fields["leaf_value"][:, :-1]})
    with pytest.raises(ValueError, match="unknown"):
        tcore.forest_from_reference({**fields, "bogus": 1})
    del fields["feature"]
    with pytest.raises(ValueError, match="missing"):
        tcore.forest_from_reference(fields)
