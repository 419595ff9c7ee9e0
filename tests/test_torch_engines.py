"""The port's remaining torch engines (``bitmm``, ``gemm``, ``native``,
``unrolled``, ``rapidscorer`` on ``backend="torch"``) against the same
engines of the reference on ``backend="jax"``: the same numpy-made forests
and rows through both packages.

Tolerances: float forests rtol 1e-5 / atol 1e-6 against the reference
engine (a sum taken in another order, tests/test_kernels.py:34) and
1e-4 / 1e-5 against the float64 numpy oracle; quantized and int-accum
forests are bit-exact (``assert_array_equal``).  The adversarial catalog
of tests/test_conformance.py runs through every port engine and backend.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.core import baselines as rbase  # noqa: E402
from repro.core import quickscorer as rqs  # noqa: E402
from repro.optim import analysis as ranalysis  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import quickscorer as tqs  # noqa: E402
from repro_torch.core import rapidscorer as trs  # noqa: E402
from repro_torch.optim import analysis as tanalysis  # noqa: E402
from test_bitmm import FOREST_SWEEP  # noqa: E402
from test_conformance import ADVERSARIAL, QUANTIZABLE, _X  # noqa: E402
from test_kernels import SHAPE_SWEEP  # noqa: E402

ENGINES = ["bitmm", "gemm", "native", "unrolled", "rapidscorer"]
# ``unrolled`` runs ``native``'s loop in the port; it meets the reference's
# unrolled engine on the trained forest and the adversarial catalog, and
# ``native`` on the fixtures (test_unrolled_runs_the_native_loop)
FIXTURE_ENGINES = [e for e in ENGINES if e != "unrolled"]
FIXTURES = ["small_forest", "class_forest", "big_leaf_forest"]
QUANT = [(16, True), (8, True), (16, False)]
# every port (engine, backend) of this slice and the last, and the
# reference engine it answers to
PORT_COMBOS = [(e, "torch") for e in ["bitvector"] + ENGINES] + \
    [(e, "cuda") for e in ("bitvector", "bitmm", "gemm")]


def port(ref_forest):
    return tcore.forest_from_reference(vars(ref_forest))


def port_predict(ref_forest, X, engine, backend="torch", **kw):
    return tcore.compile_forest(port(ref_forest), engine=engine,
                                backend=backend, device="cpu",
                                **kw).predict(X)


def ref_predict(ref_forest, X, engine):
    return rcore.compile_forest(ref_forest, engine=engine,
                                backend="jax").predict(X)


def oracle(forest, X):
    Xq = rcore.quantize_inputs(forest, X)
    return forest.predict_oracle(Xq) / rcore.leaf_scale(forest)


def rows(B, d, seed):
    return np.random.default_rng(seed).normal(0, 1.3, size=(B, d))


def sweep_forest(T, L, d, C, full, seed):
    return rcore.random_forest_ir(T, L, d, n_classes=C, seed=seed, full=full)


def assert_fields_equal(got, want, names):
    for name in names:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, w, err_msg=name)


# --------------------------------------------------------------------------- #
# host arrays: the same numbers in both packages
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("T,L,d,C,full,seed", FOREST_SWEEP)
def test_bitmm_pack_arrays_match_reference(T, L, d, C, full, seed):
    forest = sweep_forest(T, L, d, C, full, seed)
    got = tqs.bitmm_pack_arrays(port(forest))
    want = rqs.bitmm_pack_arrays(forest)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == want[0].dtype == np.float32
    bits, npack = got[2:]
    assert tqs.bitmm_full_word(bits, npack) == \
        rqs.bitmm_full_word(bits, npack)
    assert tqs.bitmm_auto_chunk(T, L - 1) == rqs.bitmm_auto_chunk(T, L - 1)


@pytest.mark.parametrize("tree_chunk", [None, 3, 5])
def test_compiled_bitmm_matches_reference(class_forest, tree_chunk):
    """Tree-chunk rebalancing and padding trees: the same buffers."""
    got = tqs.compile_qs_bitmm(port(class_forest), tree_chunk=tree_chunk,
                               device="cpu")
    want = rqs.compile_qs_bitmm(class_forest, tree_chunk=tree_chunk)
    assert_fields_equal(got, want, ("feat", "thr", "valid", "packed",
                                    "bias", "leaf_val"))
    for name in ("bits", "npack", "tree_chunk", "n_trees", "n_leaves",
                 "acc_bits", "n_groups"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("name", FIXTURES)
def test_gemm_arrays_match_reference(request, name):
    forest = request.getfixturevalue(name)
    got = tbase.compile_gemm(port(forest), device="cpu")
    want = rbase.compile_gemm(forest)
    assert_fields_equal(got, want, ("feat", "thr", "valid", "A", "Bvec",
                                    "leaf_val"))
    assert got.A.dtype == torch.float32


@pytest.mark.parametrize("name", FIXTURES)
def test_unique_splits_match_reference(request, name):
    forest = request.getfixturevalue(name)
    qf = rcore.quantize_forest(forest, rows(64, forest.n_features, 1),
                               rcore.QuantSpec(8))
    for f in (forest, qf):
        got = tanalysis.unique_splits(port(f))
        want = ranalysis.unique_splits(f)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3] == tanalysis.n_unique_splits(port(f))
        assert trs.merge_stats(port(f)) == rcore.merge_stats(f)
        assert trs.merge_nodes(port(f))[3] == want[3]


def test_bitmm_exit_leaf_matches_reference():
    """The int64 borrow trick gives the reference's uint32 answer."""
    rng = np.random.default_rng(0)
    for bits, npack, G, n_leaves in [(3, 8, 3, 20), (1, 24, 2, 40),
                                     (4, 6, 4, 24), (8, 3, 2, 5)]:
        fields = rng.integers(0, 1 << bits, size=(200, G, npack))
        fields[rng.random(fields.shape) < 0.5] = 0
        fields[::9] = 1                                 # no survivor
        words = (fields << (bits * np.arange(npack))).sum(-1)
        want = np.asarray(rqs.bitmm_exit_leaf(
            words.astype(np.float32), bits=bits, npack=npack,
            n_leaves=n_leaves))
        got = tqs.bitmm_exit_leaf(torch.from_numpy(words), bits=bits,
                                  npack=npack, n_leaves=n_leaves)
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------- #
# every engine against the reference engine of the same name
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("engine", FIXTURE_ENGINES)
@pytest.mark.parametrize("name", FIXTURES)
def test_engine_float_fixtures(request, name, engine):
    forest = request.getfixturevalue(name)
    X = rows(48, forest.n_features, 3)
    got = port_predict(forest, X, engine)
    np.testing.assert_allclose(got, ref_predict(forest, X, engine),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle(forest, X), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("engine", FIXTURE_ENGINES)
@pytest.mark.parametrize("bits,int_accum", QUANT)
def test_engine_quantized_bit_exact(class_forest, engine, bits, int_accum):
    X = rows(48, class_forest.n_features, 4)
    qf = rcore.quantize_forest(class_forest, X, rcore.QuantSpec(
        bits=bits, int_accum=int_accum))
    np.testing.assert_array_equal(port_predict(qf, X, engine),
                                  ref_predict(qf, X, engine))


@pytest.mark.parametrize("name", FIXTURES)
def test_unrolled_runs_the_native_loop(request, name):
    forest = request.getfixturevalue(name)
    X = rows(48, forest.n_features, 3)
    qf = rcore.quantize_forest(forest, X, rcore.QuantSpec(16,
                                                          int_accum=True))
    for f in (forest, qf):
        np.testing.assert_array_equal(port_predict(f, X, "unrolled"),
                                      port_predict(f, X, "native"))


@pytest.mark.parametrize("engine", ["bitmm", "gemm"])
@pytest.mark.parametrize("T,L,d,C,full,seed", FOREST_SWEEP)
def test_engine_forest_sweep(engine, T, L, d, C, full, seed):
    """Deep unbalanced trees (wide count fields), stumps, multiclass and
    multi-group leaf packing; float and int16 int-accum."""
    forest = sweep_forest(T, L, d, C, full, seed)
    X = rows(40, d, seed + 100)
    np.testing.assert_allclose(port_predict(forest, X, engine),
                               ref_predict(forest, X, engine),
                               rtol=1e-5, atol=1e-6)
    qf = rcore.quantize_forest(forest, X, rcore.QuantSpec(16,
                                                          int_accum=True))
    np.testing.assert_array_equal(port_predict(qf, X, engine),
                                  ref_predict(qf, X, engine))


@pytest.mark.parametrize("T,L,d,C,B", SHAPE_SWEEP)
def test_baselines_shape_sweep(T, L, d, C, B):
    forest = rcore.random_forest_ir(T, L, d, n_classes=C, seed=T,
                                    full=(T % 2 == 0))
    X = rows(B, d, B)
    for engine in ("native", "rapidscorer"):
        np.testing.assert_allclose(port_predict(forest, X, engine),
                                   ref_predict(forest, X, engine),
                                   rtol=1e-5, atol=1e-6, err_msg=engine)


def test_trained_forest_all_engines(trained_rf, magic_ds):
    forest = rcore.from_random_forest(trained_rf)
    qf = rcore.quantize_forest(forest, magic_ds.X_train,
                               rcore.QuantSpec(16, int_accum=True))
    X = magic_ds.X_test[:96]
    for engine in ENGINES:
        np.testing.assert_allclose(port_predict(forest, X, engine),
                                   ref_predict(forest, X, engine),
                                   rtol=1e-5, atol=1e-6, err_msg=engine)
        np.testing.assert_array_equal(port_predict(qf, X, engine),
                                      ref_predict(qf, X, engine),
                                      err_msg=engine)


# --------------------------------------------------------------------------- #
# chunking, boundaries, NaN and the plan
# --------------------------------------------------------------------------- #
def test_chunked_evaluation_is_exact(monkeypatch, class_forest):
    """One tree per chunk gives the unchunked result (bit-exact when
    quantized) in the gemm, rapidscorer and bitmm engines."""
    X = rows(40, class_forest.n_features, 5)
    qf = rcore.quantize_forest(class_forest, X, rcore.QuantSpec(
        16, int_accum=True))
    engines = ("gemm", "rapidscorer", "bitmm")
    whole = {e: port_predict(qf, X, e) for e in engines}
    monkeypatch.setattr(tbase, "_CHUNK_BYTES", 1)
    monkeypatch.setattr(tqs, "_CHUNK_BYTES", 1)
    monkeypatch.setattr(trs, "_CHUNK_BYTES", 1)
    for e in engines:
        kw = {"tree_chunk": 1} if e == "bitmm" else {}
        np.testing.assert_array_equal(port_predict(qf, X, e, **kw),
                                      whole[e], err_msg=e)


def test_threshold_boundary_rows(class_forest):
    """Rows sitting exactly on thresholds (x == t goes left everywhere)."""
    X = rows(32, class_forest.n_features, 6)
    thr = class_forest.threshold[class_forest.feature >= 0]
    feat = class_forest.feature[class_forest.feature >= 0]
    for i in range(32):
        X[i, feat[i]] = thr[i]
    want = oracle(class_forest, X)
    for engine, backend in PORT_COMBOS:
        got = port_predict(class_forest, X, engine, backend)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{engine}/{backend}")


def test_nan_rows_follow_each_reference_engine(class_forest):
    """The gemm engine tests x <= t, so a NaN feature goes right; the
    QuickScorer engines test x > t, so it goes left.  Each port engine
    follows its reference engine (ROADMAP Queue C)."""
    X = rows(6, class_forest.n_features, 11)
    X[2, ::2] = np.nan
    X[3, :] = np.nan
    for engine in ("bitmm", "gemm", "native"):
        want = ref_predict(class_forest, X, engine)
        for backend in ("torch", "cuda"):
            if (engine, backend) not in PORT_COMBOS:
                continue
            np.testing.assert_allclose(
                port_predict(class_forest, X, engine, backend), want,
                rtol=1e-5, atol=1e-6, err_msg=f"{engine}/{backend}")
    assert not np.allclose(ref_predict(class_forest, X, "gemm")[3],
                           ref_predict(class_forest, X, "bitmm")[3])


def test_describe_records_the_layout(class_forest):
    forest = port(class_forest)
    for engine in ("bitmm", "gemm"):
        got = tcore.compile_forest(forest, engine=engine, backend="torch",
                                   device="cpu").plan.records
        want = rcore.compile_forest(class_forest, engine=engine).plan.records
        assert [(r.name, r.detail) for r in got if r.name == "layout"] == \
            [(r.name, r.detail) for r in want if r.name == "layout"]
    plan = tcore.compile_forest(forest, engine="bitmm", backend="torch",
                                device="cpu", tree_chunk=5).plan
    assert "layout[leaf-pack 3b×8, tree_chunk=5]" in plan.describe()
    plan = tcore.compile_forest(forest, engine="bitmm", backend="cuda",
                                device="cpu").plan
    assert "layout[leaf-pack 3b×8, shared-memory tree chunks]" in \
        plan.describe()
    assert "lower[cuda-bitmm (bitmm/cuda)]" in plan.describe()


def test_registry_mirrors_the_reference():
    assert tcore.registry.engines("torch") == rcore.registry.engines("jax")
    assert tcore.registry.engines("cuda") == rcore.registry.engines("pallas")
    for engine in ("bitmm", "gemm", "native", "unrolled", "rapidscorer"):
        assert tcore.registry.get(engine, "torch").tune_name == \
            rcore.registry.get(engine, "jax").tune_name


def test_engines_run_on_the_card_by_default(class_forest):
    if torch.cuda.is_available():
        pytest.skip("this container check needs a host without CUDA")
    for engine, backend in PORT_COMBOS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcore.compile_forest(port(class_forest), engine=engine,
                                 backend=backend)


def test_compiled_modules_hold_buffers(class_forest):
    forest = port(class_forest)
    bm = tqs.compile_qs_bitmm(forest, device="cpu")
    assert {n for n, _ in bm.named_buffers()} == {
        "feat", "thr", "valid", "packed", "bias", "leaf_val"}
    g = tbase.compile_gemm(forest, device="cpu")
    assert {n for n, _ in g.named_buffers()} == {
        "feat", "thr", "valid", "A", "Bvec", "leaf_val"}
    nat = tbase.compile_native(forest, device="cpu")
    assert nat.max_depth == class_forest.max_depth
    rs = trs.compile_rs(forest, device="cpu")
    assert rs.n_unique == rcore.compile_rs(class_forest).n_unique
    assert {n for n, _ in rs.named_buffers()} >= {"u_feat", "u_thr", "inv",
                                                   "qs.masks"}


# --------------------------------------------------------------------------- #
# the adversarial catalog × every port engine and backend
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def reference_scores():
    """(case, engine) → the reference jax engine's scores on the quantized
    catalog's rows, computed once per module."""
    cache = {}

    def get(case, engine):
        if (case, engine) not in cache:
            qf, X = _catalog(case, True)
            cache[case, engine] = ref_predict(qf, X, engine)
        return cache[case, engine]
    return get


def _catalog(case, quantized):
    forest = ADVERSARIAL[case]()
    if not quantized:
        return forest, _X(forest)
    X = _X(forest, B=12, seed=1)
    return rcore.quantize_forest(forest, X), X


@pytest.mark.parametrize("engine,backend", PORT_COMBOS,
                         ids=[f"{e}/{b}" for e, b in PORT_COMBOS])
@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_adversarial_float_matches_reference(case, engine, backend):
    forest, X = _catalog(case, False)
    got = port_predict(forest, X, engine, backend)
    np.testing.assert_allclose(got, forest.predict_oracle(X), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("engine,backend", PORT_COMBOS,
                         ids=[f"{e}/{b}" for e, b in PORT_COMBOS])
@pytest.mark.parametrize("case", QUANTIZABLE)
def test_adversarial_quantized_bit_exact(case, engine, backend,
                                         reference_scores):
    qf, X = _catalog(case, True)
    got = port_predict(qf, X, engine, backend)
    np.testing.assert_array_equal(got, reference_scores(case, engine))
    want = (qf.predict_oracle(rcore.quantize_inputs(qf, X))
            / rcore.leaf_scale(qf)).astype(np.float32)
    np.testing.assert_array_equal(got, want)
