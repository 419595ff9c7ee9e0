"""The port's ingestion and packed format (``repro_torch.io``, the
pipeline's ``deserialize`` pass, ``ForestServer.save``/``load``) against
the reference's ``repro.io``: the same files through both packages.

Importers must give array-equal IR (or raise the same error), forest
artifacts must cross-load both ways with array-equal IR, and predictor
and cascade artifacts the reference writes must load in the port with
exactly the buffers a fresh compile gives and predict bit-identically on
quantized forests.  The port runs on ``device="cpu"``.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import cascade as rc  # noqa: E402
from repro import core as rcore  # noqa: E402
from repro import io as rio  # noqa: E402
from repro import optim as roptim  # noqa: E402
from repro.inference.server import ForestServer as RServer  # noqa: E402
from repro_torch import cascade as tc  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import io as tio  # noqa: E402
from repro_torch.inference import ForestServer as TServer  # noqa: E402
from test_conformance import _X  # noqa: E402
from test_torch_optim import _bitten, assert_same_ir, port  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
with open(os.path.join(FIXTURES, "expected.json")) as f:
    EXPECTED = json.load(f)
QUANT = dict(bits=16, int_accum=True)
TORCH_ENGINES = ("bitvector", "bitmm", "gemm", "native", "unrolled",
                 "rapidscorer")


def fixture(name):
    with open(os.path.join(FIXTURES, name + ".json")) as f:
        return json.load(f)


def same_outcome(run, tag=""):
    """``run(io)`` through both packages: the same error (type and text) or
    array-equal forests."""
    try:
        want = run(rio)
    except Exception as e:                       # noqa: BLE001
        with pytest.raises(type(e)) as got:
            run(tio)
        assert str(got.value) == str(e), tag
        return None
    got = run(tio)
    assert_same_ir(got, want, tag)
    return got


# --------------------------------------------------------------------------- #
# importers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_golden_fixture_imports_to_the_reference_ir(name):
    exp = EXPECTED[name]
    path = os.path.join(FIXTURES, name + ".json")
    forest = same_outcome(lambda io: io.load_model(path, **exp["kw"]), name)
    shape = exp["shape"]
    assert (forest.n_trees, forest.n_classes, forest.n_features) == \
        (shape["n_trees"], shape["n_classes"], shape["n_features"])
    X, want = np.asarray(exp["X"]), np.asarray(exp["predict"])
    np.testing.assert_allclose(forest.predict_oracle(X), want, rtol=1e-6,
                               atol=1e-7)
    engines = [(e, "torch") for e in TORCH_ENGINES] + \
        [(e, "cuda") for e in ("bitvector", "bitmm", "gemm")]
    for engine, backend in engines:
        got = tcore.compile_plan(path, engine=engine, backend=backend,
                                 device="cpu", load_kw=exp["kw"]).predict(X)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name}/{engine}/{backend}")


def _xgb_stump(split="f0", cond=0.5, **extra):
    return [{"nodeid": 0, "split": split, "split_condition": cond,
             "yes": 1, "no": 2, "children": [
                 {"nodeid": 1, "leaf": 1.0}, {"nodeid": 2, "leaf": 2.0}]}
            | extra]


_NAMED = [{"nodeid": 0, "split": "age", "split_condition": 10.0,
           "yes": 1, "no": 2, "children": [
               {"nodeid": 1, "split": "income", "split_condition": 3.0,
                "yes": 3, "no": 4, "children": [
                    {"nodeid": 3, "leaf": 1.0}, {"nodeid": 4, "leaf": 2.0}]},
               {"nodeid": 2, "leaf": 5.0}]}]


def _lgbm_stump(feature=0, threshold=0.0, dt="<="):
    return {"tree_info": [{"tree_structure": {
        "split_feature": feature, "threshold": threshold,
        "decision_type": dt, "left_child": {"leaf_value": 1.0},
        "right_child": {"leaf_value": 2.0}}}]}


def _gbr(**changes):
    d = fixture("sklearn_gbr")
    d.update(changes)
    return d


def _shim(io, d, **kw):
    return io.import_sklearn(io.sklearn_shim_from_json(d), **kw)


def _no_init_constant(io):
    shim = io.sklearn_shim_from_json(fixture("sklearn_gbr"))
    shim.init_ = object()
    return io.import_sklearn(shim)


def _rf_regressor():
    d = fixture("sklearn_rf_classifier")
    del d["n_classes"]
    return d


IMPORTER_CASES = {
    "xgb_nan_threshold": lambda io: io.import_xgboost_json(
        _xgb_stump(cond=float("nan"))),
    "xgb_inf_threshold": lambda io: io.import_xgboost_json(
        _xgb_stump(cond=float("inf"))),
    "xgb_subnormal_boundary": lambda io: io.import_xgboost_json(
        _xgb_stump(cond=1e-40) + _xgb_stump(cond=-1e-45)
        + _xgb_stump(cond=1.2e-38)),
    "xgb_named_first_appearance": lambda io: io.import_xgboost_json(_NAMED),
    "xgb_feature_names": lambda io: io.import_xgboost_json(
        _xgb_stump("income", 3.0), feature_names=["age", "income"]),
    "xgb_feature_names_missing": lambda io: io.import_xgboost_json(
        _xgb_stump("income", 3.0), feature_names=["age"]),
    "xgb_pinned_fN": lambda io: io.import_xgboost_json(
        _xgb_stump("f1", 0.0), feature_names=["f1", "f0"]),
    "xgb_pinned_fN_unknown": lambda io: io.import_xgboost_json(
        _xgb_stump("f1", 0.0), feature_names=["colA", "colB"]),
    "xgb_n_features_too_small": lambda io: io.import_xgboost_json(
        _xgb_stump("f5"), n_features=3),
    "xgb_n_features_hint": lambda io: io.import_xgboost_json(
        _xgb_stump("f1"), n_features=6),
    "xgb_multiclass_base_score": lambda io: io.import_xgboost_json(
        fixture("xgb_multiclass"), n_classes=3, base_score=0.5),
    "xgb_base_score_class_without_trees": lambda io: io.import_xgboost_json(
        fixture("xgb_multiclass"), n_classes=4, base_score=0.5),
    "xgb_regression_base_score": lambda io: io.import_xgboost_json(
        fixture("xgb_regression"), base_score=0.25),
    "xgb_json_string": lambda io: io.import_xgboost_json(
        json.dumps(fixture("xgb_regression"))),
    "xgb_per_tree_strings": lambda io: io.import_xgboost_json(
        [json.dumps(t) for t in fixture("xgb_regression")]),
    "xgb_empty": lambda io: io.import_xgboost_json([]),
    "lgbm_categorical": lambda io: io.import_lightgbm_json(
        _lgbm_stump(dt="==")),
    "lgbm_nan_threshold": lambda io: io.import_lightgbm_json(
        _lgbm_stump(threshold=float("nan"))),
    "lgbm_n_features_too_small": lambda io: io.import_lightgbm_json(
        _lgbm_stump(4), n_features=2),
    "lgbm_no_max_feature_idx": lambda io: io.import_lightgbm_json(
        _lgbm_stump(3)),
    "lgbm_json_string": lambda io: io.import_lightgbm_json(
        json.dumps(fixture("lgbm_multiclass"))),
    "lgbm_no_tree_info": lambda io: io.import_lightgbm_json({}),
    "sklearn_boosting_classifier_2": lambda io: _shim(io, _gbr(n_classes=2)),
    "sklearn_boosting_classifier_3": lambda io: _shim(io, _gbr(n_classes=3)),
    "sklearn_init_without_constant": _no_init_constant,
    "sklearn_n_features_too_small": lambda io: _shim(
        io, fixture("sklearn_rf_classifier"), n_features=0),
    "sklearn_rf_regressor": lambda io: _shim(io, _rf_regressor()),
    "sklearn_no_estimators": lambda io: _shim(
        io, dict(fixture("sklearn_rf_classifier"), estimators=[])),
}


@pytest.mark.parametrize("case", sorted(IMPORTER_CASES))
def test_importer_case_matches_the_reference(case):
    same_outcome(IMPORTER_CASES[case], case)


def _write(tmp_path, name, obj):
    p = tmp_path / name
    p.write_text(obj if isinstance(obj, str) else json.dumps(obj))
    return str(p)


LOAD_CASES = {
    "unknown_json": ("m.json", {"weights": [1, 2, 3]}, {}),
    "json_scalar": ("m.json", "42", {}),
    "not_json": ("m.json", "this is not json", {}),
    "xgb_with_hints": ("x.json", fixture("xgb_multiclass"),
                       {"n_classes": 3, "feature_names": None,
                        "bogus_hint": 1}),
    "lgbm_ignores_n_classes": ("l.json", fixture("lgbm_regression"),
                               {"n_classes": 3}),
    "shim_ignores_n_classes": ("s.json", fixture("sklearn_gbr"),
                               {"n_classes": 3, "n_features": 4}),
    "missing_file": (None, None, {}),
}


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
def test_load_model_sniffs_and_refuses_as_the_reference_does(case,
                                                             tmp_path):
    name, obj, kw = LOAD_CASES[case]
    path = str(tmp_path / "absent.json") if name is None \
        else _write(tmp_path, name, obj)
    same_outcome(lambda io: io.load_model(path, **kw), case)


def test_load_model_reads_a_packed_forest_and_ignores_hints(tmp_path):
    f, _ = _bitten()
    p = str(tmp_path / "f.repro.npz")
    rio.save_forest(f, p)
    assert_same_ir(tio.load_model(p, n_classes=3), f)
    pred = tcore.compile_plan(p, engine="bitvector", backend="torch",
                              device="cpu", load_kw={"n_classes": 3})
    assert pred.plan.records[0].detail == f"loaded {p}"


# --------------------------------------------------------------------------- #
# forest artifacts cross both ways
# --------------------------------------------------------------------------- #
def _forest_kind(kind):
    f = rcore.random_forest_ir(12, 16, 9, n_classes=3, seed=4, full=False)
    X = _X(f, B=32, seed=4)
    if kind == "float":
        return f
    if kind == "int16":
        return rcore.quantize_forest(f, X, rcore.QuantSpec(16))
    if kind == "int_accum":
        return rcore.quantize_forest(f, X, rcore.QuantSpec(**QUANT))
    if kind == "int8_leaves_only":
        return rcore.quantize_forest(f, X, rcore.QuantSpec(
            8, quantize_splits=False))
    if kind == "flint":
        return rcore.flint_forest(f)
    bitten, Xb = _bitten()
    return roptim.optimize(bitten, 2, ctx={"X_calib": Xb}).forest


FOREST_KINDS = ["float", "int16", "int_accum", "int8_leaves_only", "flint",
                "optimized"]


@pytest.mark.parametrize("kind", FOREST_KINDS)
def test_reference_forest_artifact_loads_in_the_port(kind, tmp_path):
    f = _forest_kind(kind)
    p = str(tmp_path / "ref.repro.npz")
    rio.save_forest(f, p)
    got = tio.load_forest(p)
    assert_same_ir(got, rio.load_forest(p), kind)
    assert tio.peek(p) == rio.peek(p)


@pytest.mark.parametrize("kind", FOREST_KINDS)
def test_port_forest_artifact_loads_in_the_reference(kind, tmp_path):
    f = _forest_kind(kind)
    p_port, p_ref = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    tio.save_forest(port(f), p_port)
    rio.save_forest(f, p_ref)
    assert_same_ir(rio.load_forest(p_port), rio.load_forest(p_ref), kind)
    assert rio.peek(p_port) == rio.peek(p_ref)
    a, b = np.load(p_port), np.load(p_ref)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------------------------- #
# predictor and cascade artifacts the reference writes
# --------------------------------------------------------------------------- #
def _quantized(seed=6):
    f = rcore.random_forest_ir(16, 16, 10, n_classes=2, seed=seed,
                               full=False)
    X = _X(f, B=40, seed=seed)
    return rcore.quantize_forest(f, X, rcore.QuantSpec(**QUANT)), X


def assert_same_buffers(got, want):
    """Every buffer (nested ones too) with its dtype, device and values,
    and the scalar config."""
    g, w = dict(got.named_buffers()), dict(want.named_buffers())
    assert g.keys() == w.keys()
    for k in w:
        assert (g[k].dtype, g[k].device) == (w[k].dtype, w[k].device), k
        assert torch.equal(g[k], w[k]), k
    for mod_g, mod_w in zip(got.modules(), want.modules()):
        assert mod_g.scalar_config() == mod_w.scalar_config()


@pytest.mark.parametrize("variant", ["int16-O2", "float"])
@pytest.mark.parametrize("engine", TORCH_ENGINES)
def test_reference_predictor_artifact_loads_in_the_port(engine, variant,
                                                        tmp_path):
    f, X = _quantized()
    opt = 2 if variant == "int16-O2" else None
    if variant == "float":
        f = rcore.random_forest_ir(16, 16, 10, n_classes=2, seed=6)
    ref = rcore.compile_plan(f, engine=engine, opt=opt, X_calib=X)
    p = str(tmp_path / "pred.npz")
    rio.save_predictor(ref, p)
    got = tio.load_predictor(p, device="cpu")
    assert got.plan.records[-1].detail == f"loaded from {p}"
    assert [r.detail for r in got.plan.records[:-1]] == \
        [r.detail for r in ref.plan.records]
    embedded = got.host_forest() or got.compiled.qs.forest
    assert_same_ir(embedded, rio.load_predictor(p).host_forest()
                   or rio.load_predictor(p).compiled.qs.forest)
    fresh = tcore.compile_forest(embedded, engine=engine, backend="torch",
                                 device="cpu")
    assert_same_buffers(got.compiled, fresh.compiled)
    if variant == "float":
        np.testing.assert_allclose(got.predict(X), ref.predict(X),
                                   rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.predict(X), ref.predict(X))


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
@pytest.mark.parametrize("engine", ["bitvector", "bitmm"])
def test_reference_cascade_artifact_loads_in_the_port(engine, fused,
                                                      tmp_path):
    f, X = _quantized()
    ref = rcore.compile_forest(f, engine=engine, cascade=rc.CascadeSpec(
        (4, 8, 16), rc.MarginGate(0.3), fused=fused))
    p = str(tmp_path / "casc.npz")
    RServer(ref, max_batch=32).save(p)
    srv = TServer.load(p, device="cpu")
    got = srv.predictor
    assert srv.batcher.max_batch == 32
    assert type(got) is (tc.FusedCascadePredictor if fused
                         else tc.CascadePredictor)
    assert (got.stages, got.policy.tag(), got.backend) == \
        (ref.stages, ref.policy.tag(), "torch")
    np.testing.assert_array_equal(got.predict(X), ref.predict(X))
    np.testing.assert_array_equal(got.last_exit_counts, ref.last_exit_counts)
    assert 0 < ref.last_exit_counts[0] < len(X)
    for sp, k in zip(got.stage_predictors, range(len(got.stages))):
        lo = ([0] + list(got.stages))[k]
        fresh = tcore.compile_forest(
            tc.tree_slice(got.forest, lo, got.stages[k]), engine=engine,
            backend="torch", device="cpu", **got.engine_kw)
        assert_same_buffers(sp.compiled, fresh.compiled)


# --------------------------------------------------------------------------- #
# the port's own artifacts, the server, and what cannot be saved
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("engine", TORCH_ENGINES)
def test_port_predictor_round_trip(engine, tmp_path):
    f, X = _quantized(seed=7)
    pred = tcore.compile_plan(port(f), engine=engine, backend="torch",
                              device="cpu", opt=2, X_calib=X)
    p = str(tmp_path / "pred.npz")
    tio.save_predictor(pred, p)
    got = tio.load_predictor(p, device="cpu")
    assert tio.peek(p)["backend"] == "torch"
    assert_same_buffers(got.compiled, pred.compiled)
    np.testing.assert_array_equal(got.predict(X), pred.predict(X))


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_port_cascade_round_trip(fused, tmp_path):
    f, X = _quantized(seed=8)
    pred = tcore.compile_plan(port(f), engine="gemm", backend="torch",
                              device="cpu", opt=2, X_calib=X,
                              cascade=tc.CascadeSpec((4, 8), tc.ProbaGate(
                                  0.6), fused=fused))
    p = str(tmp_path / "casc.npz")
    tio.save_predictor(pred, p)
    got = tio.load_predictor(p, device="cpu")
    np.testing.assert_array_equal(got.predict(X), pred.predict(X))
    np.testing.assert_array_equal(got.last_exit_counts,
                                  pred.last_exit_counts)
    assert got.fused == fused and got.policy.tag() == pred.policy.tag()


def test_forest_server_save_load_round_trip(tmp_path):
    f, X = _quantized(seed=9)
    pred = tcore.compile_forest(port(f), engine="native", backend="torch",
                                device="cpu")
    srv = TServer(pred, max_batch=16, max_wait_ms=3.5)
    srv.engine_choice = "native"
    p1, p2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    srv.save(p1)
    srv2 = TServer.load(p1, device="cpu")
    assert (srv2.batcher.max_batch, srv2.batcher.max_wait_ms) == (16, 3.5)
    np.testing.assert_array_equal(srv2.predictor.predict(X), pred.predict(X))
    srv2.save(p2)
    assert TServer.load(p2, device="cpu").engine_choice == "native"
    # a server the reference saved loads in the port's server
    p3 = str(tmp_path / "ref.npz")
    ref = rcore.compile_forest(f, engine="native")
    RServer(ref, max_batch=8).save(p3)
    srv3 = TServer.load(p3, device="cpu")
    assert srv3.batcher.max_batch == 8 and srv3.engine_choice is None
    np.testing.assert_array_equal(srv3.predictor.predict(X), ref.predict(X))


CUDA_SAVES = ["bitvector", "bitmm", "gemm", "cascade-fused",
              "cascade-staged"]


@pytest.mark.parametrize("what", CUDA_SAVES)
def test_saving_a_cuda_predictor_raises(what, tmp_path):
    f, _ = _quantized(seed=10)
    if what.startswith("cascade"):
        pred = tcore.compile_forest(
            port(f), engine="bitvector", backend="cuda", device="cpu",
            cascade=tc.CascadeSpec((4, 16), fused=what.endswith("fused")))
    else:
        pred = tcore.compile_forest(port(f), engine=what, backend="cuda",
                                    device="cpu")
    p = tmp_path / "never.npz"
    with pytest.raises(ValueError, match="save the forest"):
        tio.save_predictor(pred, str(p))
    with pytest.raises(ValueError, match="save the forest"):
        TServer(pred).save(str(p))
    assert not p.exists()


def _newer(path):
    npz = dict(np.load(path, allow_pickle=False))
    hdr = json.loads(str(npz["header"]))
    hdr["version"] += 1
    npz["header"] = np.asarray(json.dumps(hdr))
    np.savez(path, **npz)


CONTAINER_CASES = ["garbage", "no_header", "newer_version", "wrong_format",
                   "forest_as_predictor", "predictor_as_forest"]


@pytest.mark.parametrize("case", CONTAINER_CASES)
def test_container_errors_match_the_reference(case, tmp_path):
    p = str(tmp_path / "x.npz")
    f, _ = _quantized(seed=11)
    if case == "garbage":
        (tmp_path / "x.npz").write_bytes(b"not an npz archive")
    elif case == "no_header":
        np.savez(p, x=np.zeros(3))
    elif case == "predictor_as_forest":
        rio.save_predictor(rcore.compile_forest(f, engine="native"), p)
    else:
        rio.save_forest(f, p)
        if case == "newer_version":
            _newer(p)
        elif case == "wrong_format":
            npz = dict(np.load(p))
            npz["header"] = np.asarray(json.dumps({"format": "other"}))
            np.savez(p, **npz)
    load = "load_predictor" if case == "forest_as_predictor" \
        else "load_forest"
    with pytest.raises(ValueError) as want:
        getattr(rio, load)(p)
    kw = {"device": "cpu"} if load == "load_predictor" else {}
    with pytest.raises(ValueError) as got:
        getattr(tio, load)(p, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["manifest", "cost_model"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_manifest_and_cost_model_cross_and_refuse_newer(kind, writer,
                                                        tmp_path):
    w, r = (tio, rio) if writer == "port" else (rio, tio)
    if kind == "manifest":
        (tmp_path / "m").mkdir()
        p = str(tmp_path / "m" / "manifest.json")
        tenants = {"a": {"artifact": "a.npz", "max_batch": 8},
                   "b": {"artifact": "/abs/b.npz", "slo": 2.5}}
        w.save_manifest(p, tenants)
        got = r.load_manifest(str(tmp_path / "m"))
        assert got == rio.load_manifest(p)
        assert got["a"]["artifact"] == str(tmp_path / "m" / "a.npz")
        with pytest.raises(ValueError, match="must be a dict"):
            w.save_manifest(p, {"c": "bare.npz"})
        load, bump = r.load_manifest, json.load(open(p))
    else:
        p = str(tmp_path / "cm" / "model.json")
        payload = {"weights": [0.5, -1.0], "features": ["T", "L"]}
        assert w.save_cost_model(p, payload) == p
        got = r.load_cost_model(p)
        assert got == rio.load_cost_model(p)
        assert got["weights"] == [0.5, -1.0]
        load, bump = r.load_cost_model, json.load(open(p))
    bump["version"] += 1
    with open(p, "w") as f:
        json.dump(bump, f)
    with pytest.raises(ValueError, match="newer than this reader"):
        load(p)
    with open(p, "w") as f:
        f.write("{}")
    with pytest.raises(ValueError, match="unknown"):
        load(p)


def test_unknown_header_backend_is_refused(tmp_path):
    f, _ = _quantized(seed=12)
    p = str(tmp_path / "pred.npz")
    rio.save_predictor(rcore.compile_forest(f, engine="native"), p)
    npz = dict(np.load(p))
    hdr = json.loads(str(npz["header"]))
    npz["header"] = np.asarray(json.dumps(dict(hdr, backend="pallas")))
    np.savez(p, **npz)
    with pytest.raises(ValueError, match="no serializable engines"):
        tio.load_predictor(p, device="cpu")
    del npz["c.thr"]
    npz["header"] = np.asarray(json.dumps(hdr))
    np.savez(p, **npz)
    with pytest.raises(ValueError, match="lacks"):
        tio.load_predictor(p, device="cpu")
