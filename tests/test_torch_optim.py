"""The port's optimizer middle-end (``repro_torch.optim`` and the pipeline's
``optimize`` pass) against the reference's ``repro.optim``: the same
numpy-made forests through both packages.

Every pass and every ``-O`` level must give array-equal IR (every
``Forest`` field, ``feat_map`` included, with its dtype), the same
per-pass ``PassStats`` and the same plan records.  Compiled ``-O2``
predictors are held bit-exact (``assert_array_equal``) against the
reference's ``-O2`` on quantized forests and within rtol 1e-5 / atol 1e-6
on float ones.  The port runs on ``device="cpu"``: ``backend="torch"`` is
the reference's ``"jax"``, and ``backend="cuda"`` runs the CUDA kernels'
plain versions.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import cascade as rc  # noqa: E402
from repro import core as rcore  # noqa: E402
from repro import optim as roptim  # noqa: E402
from repro_torch import cascade as tc  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from test_conformance import ADVERSARIAL, _X  # noqa: E402

PASSES = list(roptim.OPT_LEVELS[2])
QUANT = dict(bits=16, int_accum=True)


def _bitten(seed=0, bits=8):
    """A forest every pass changes: in every other tree the root's left
    child repeats the root's feature at a higher threshold, a split the
    root already decides (dedup; the trees turn ragged), two trees with
    all-zero leaves fold to constants that ``compact`` drops, every tree's
    two rightmost leaves agree (merge; ``L`` shrinks), 8 trees of 7 nodes
    read few of 40 columns (drop), and leaf spreads differ (reorder)."""
    f = rcore.random_forest_ir(8, 8, 40, n_classes=2, seed=seed)
    feature, threshold = f.feature.copy(), f.threshold.copy()
    feature[::2, 1] = feature[::2, 0]
    threshold[::2, 1] = threshold[::2, 0] + 1.0
    lv = f.leaf_value.copy()
    lv[:, -1] = lv[:, -2]
    lv[[2, 5]] = 0.0
    lv *= np.linspace(0.2, 3.0, f.n_trees)[:, None, None].astype(np.float32)
    f = dataclasses.replace(f, feature=feature, threshold=threshold,
                            leaf_value=lv)
    X = np.random.default_rng(seed).normal(0, 1.0, size=(96, 40))
    return rcore.quantize_forest(f, X, rcore.QuantSpec(bits, int_accum=True)
                                 ), X


def _case(name):
    """(reference forest, rows in the caller's coordinates)."""
    if name == "bitten":
        return _bitten()
    if name == "random_float":
        f = rcore.random_forest_ir(24, 16, 10, n_classes=2, seed=1,
                                   full=False)
        return f, _X(f, B=48, seed=1)
    if name == "random_int16":
        f = rcore.random_forest_ir(24, 16, 10, n_classes=2, seed=1,
                                   full=False)
        X = _X(f, B=48, seed=1)
        return rcore.quantize_forest(f, X, rcore.QuantSpec(**QUANT)), X
    if name == "remapped":
        # an IR that already carries a feat_map: drop composes with it
        f, X = _bitten(seed=3)
        return roptim.optimize(f, ("drop_unused_features",)).forest, X
    f = ADVERSARIAL[name]()
    return f, _X(f, B=16)


CASES = ["bitten", "random_float", "random_int16", "remapped"] + sorted(
    ADVERSARIAL)


def port(ref_forest):
    return tcore.forest_from_reference(vars(ref_forest))


def assert_same_ir(got, want, tag=""):
    """Every field of two forests equal, arrays with their dtypes."""
    g, w = vars(got), vars(want)
    assert g.keys() == w.keys(), tag
    for k, v in w.items():
        if isinstance(v, np.ndarray):
            assert isinstance(g[k], np.ndarray), (tag, k)
            assert g[k].dtype == v.dtype, (tag, k, g[k].dtype, v.dtype)
            np.testing.assert_array_equal(g[k], v, err_msg=f"{tag} {k}")
        else:
            assert g[k] == v, (tag, k, g[k], v)


def assert_same_result(got, want, tag=""):
    assert_same_ir(got.forest, want.forest, tag)
    assert [dataclasses.astuple(s) for s in got.stats] == \
        [dataclasses.astuple(s) for s in want.stats], tag
    assert [s.detail() for s in got.stats] == \
        [s.detail() for s in want.stats], tag
    assert (got.tag, got.verified, got.describe()) == \
        (want.tag, want.verified, want.describe()), tag


# --------------------------------------------------------------------------- #
# the passes and levels: array-equal IR, the same stats
# --------------------------------------------------------------------------- #
def test_registry_and_levels_match_the_reference():
    assert toptim.opt_passes() == roptim.opt_passes()
    assert toptim.OPT_LEVELS == roptim.OPT_LEVELS
    assert {n: p.doc for n, p in toptim.OPT_PASSES.items()} == \
        {n: p.doc for n, p in roptim.OPT_PASSES.items()}


@pytest.mark.parametrize("name", PASSES)
@pytest.mark.parametrize("case", CASES)
def test_each_pass_gives_the_reference_ir(case, name):
    f, X = _case(case)
    ctx = {"X_calib": X}
    want = roptim.optimize(f, (name,), ctx=ctx)
    got = toptim.optimize(port(f), (name,), ctx=ctx)
    assert_same_result(got, want, f"{case}/{name}")


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("case", CASES)
def test_each_level_gives_the_reference_ir(case, level):
    f, X = _case(case)
    want = roptim.optimize(f, level, ctx={"X_calib": X})
    got = toptim.optimize(port(f), level, ctx={"X_calib": X})
    assert_same_result(got, want, f"{case}/O{level}")
    # without rows, reorder_trees falls back to the leaf-value spread
    assert_same_result(toptim.optimize(port(f), level),
                       roptim.optimize(f, level), f"{case}/O{level}/no-X")


def test_the_bitten_forest_is_changed_by_every_pass():
    f, X = _case("bitten")
    res = toptim.optimize(port(f), 2, ctx={"X_calib": X})
    by = {s.name: (s.before, s.after) for s in res.stats}
    b, a = by["dedup_thresholds"]
    assert a.n_nodes < b.n_nodes
    b, a = by["merge_equivalent_leaves"]
    assert a.n_nodes < b.n_nodes
    b, a = by["compact"]
    assert a.n_trees < b.n_trees and a.n_leaves < b.n_leaves
    b, a = by["drop_unused_features"]
    assert a.n_features < b.n_features
    assert not np.array_equal(res.forest.n_nodes,
                              np.sort(res.forest.n_nodes))   # reordered
    assert (res.forest.n_nodes < res.forest.n_leaves - 1).any()  # ragged


@pytest.mark.parametrize("opt", [None, 0, 1, 2, "O2", "-O1", "o0", "2",
                                 np.int64(1), ("compact",),
                                 ["dedup_thresholds", "reorder_trees"],
                                 "O9", 7, ("nonesuch",), "fast", "-Ox"])
def test_resolve_opt_accepts_and_refuses_what_the_reference_does(opt):
    try:
        want = roptim.resolve_opt(opt)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            toptim.resolve_opt(opt)
        assert str(got.value) == str(e)
    else:
        assert toptim.resolve_opt(opt) == want


@pytest.mark.parametrize("case", ["random_float", "random_int16"])
def test_a_broken_pass_raises_optimization_error(case):
    @toptim.register_pass("_broken", doc="flips a leaf (test only)")
    def _broken(forest, ctx):
        lv = forest.leaf_value.copy()
        lv[0, 0] += np.ones_like(lv[0, 0])      # int- and float-safe
        return dataclasses.replace(forest, leaf_value=lv)

    f, _ = _case(case)
    try:
        match = "bit-exact" if case == "random_int16" else "diverges"
        with pytest.raises(toptim.OptimizationError, match=match):
            toptim.optimize(port(f), ("_broken",))
        with pytest.raises(toptim.OptimizationError):
            tcore.compile_forest(port(f), opt=("_broken",), backend="torch",
                                 device="cpu")
    finally:
        del toptim.OPT_PASSES["_broken"]


@pytest.mark.parametrize("case", ["bitten", "random_float"])
def test_per_tree_scores_and_check_rows_match_the_reference(case):
    f, X = _case(case)
    from repro.optim import passes as rpasses
    from repro_torch.optim import passes as tpasses
    np.testing.assert_array_equal(
        tpasses._check_inputs(port(f), 64, 0),
        rpasses._check_inputs(f, 64, 0))
    Xq = rcore.quantize_inputs(f, X)
    np.testing.assert_array_equal(toptim.per_tree_scores(port(f), Xq),
                                  roptim.per_tree_scores(f, Xq))


# --------------------------------------------------------------------------- #
# the pipeline: records, the shared-IR cache, compiled predictors
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("level", [None, 1, 2, ("compact", "reorder_trees")])
def test_plan_records_match_the_reference(level):
    f, X = _case("bitten")
    ref = rcore.compile_plan(f, engine="bitvector", opt=level, X_calib=X)
    got = tcore.compile_plan(port(f), engine="bitvector", backend="torch",
                             device="cpu", opt=level, X_calib=X)
    want = [(r.name, r.detail) for r in ref.plan.records
            if r.name.startswith("opt") or r.name in ("canonicalize",
                                                      "quantize")]
    assert [(r.name, r.detail) for r in got.plan.records
            if r.name.startswith("opt") or r.name in ("canonicalize",
                                                      "quantize")] == want
    np.testing.assert_array_equal(got.predict(X), ref.predict(X))


def test_opt_cache_shares_one_optimizer_run():
    f, X = _case("bitten")
    tf = port(f)
    cache = {}
    a = tcore.compile_plan(tf, engine="bitvector", backend="torch",
                           device="cpu", opt=2, X_calib=X, opt_cache=cache)
    b = tcore.compile_plan(tf, engine="gemm", backend="torch", device="cpu",
                           opt="O2", X_calib=X, opt_cache=cache)
    assert list(cache) == [(id(tf), "O2")]
    assert a.compiled.forest is b.compiled.forest
    from repro_torch.core.pipeline import optimized_forest
    assert optimized_forest(tf, 2, cache) is a.compiled.forest
    assert optimized_forest(tf, 0, cache) is tf
    assert [r.detail for r in a.plan.records if r.name.startswith("opt")] \
        == [r.detail for r in b.plan.records if r.name.startswith("opt")]


ENGINES = [(n, "torch") for n in ("bitvector", "bitmm", "gemm", "native",
                                  "unrolled", "rapidscorer")] + \
    [(n, "cuda") for n in ("bitvector", "bitmm", "gemm")]


@pytest.mark.parametrize("quantized", [True, False], ids=["int16", "float"])
@pytest.mark.parametrize("engine,backend", ENGINES,
                         ids=[f"{n}-{b}" for n, b in ENGINES])
def test_O2_predictor_matches_the_reference(engine, backend, quantized):
    f = rcore.random_forest_ir(24, 16, 10, n_classes=2, seed=5, full=False)
    X = _X(f, B=40, seed=5)
    if quantized:
        f = rcore.quantize_forest(f, X, rcore.QuantSpec(**QUANT))
    ref = rcore.compile_forest(f, engine=engine, opt=2)
    got = tcore.compile_forest(port(f), engine=engine, backend=backend,
                               device="cpu", opt=2)
    want = ref.predict(X)
    if quantized:
        np.testing.assert_array_equal(got.predict(X), want)
        # and -O2 changes nothing against -O0 on integer leaves
        np.testing.assert_array_equal(
            got.predict(X), tcore.compile_forest(
                port(f), engine=engine, backend=backend,
                device="cpu").predict(X))
    else:
        np.testing.assert_allclose(got.predict(X), want, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("fused,backend", [(True, "cuda"), (False, "torch"),
                                           (True, "torch")])
def test_O2_cascade_matches_the_reference_O2_cascade(fused, backend):
    """Cascades at -O2 split the reordered forest: held against the
    reference's -O2 staged cascade, scores and exit counts."""
    f, X = _case("bitten")
    stages = (2, 4, 8)
    ref = rcore.compile_plan(f, engine="bitvector", opt=2, X_calib=X,
                             cascade=rc.CascadeSpec(stages,
                                                    rc.MarginGate(0.5)))
    got = tcore.compile_plan(port(f), engine="bitvector", backend=backend,
                             device="cpu", opt=2, X_calib=X,
                             cascade=tc.CascadeSpec(stages,
                                                    tc.MarginGate(0.5),
                                                    fused=fused))
    assert got.stages == ref.stages          # clamped to the compacted T
    np.testing.assert_array_equal(got.predict(X), ref.predict(X))
    np.testing.assert_array_equal(got.last_exit_counts,
                                  ref.last_exit_counts)
    assert 0 < ref.last_exit_counts[0] < len(X)
