"""The port's cost model (``repro_torch.tune``) and zero-shot autotuning
(``choose(mode="predict")``) against the reference's ``repro.tune``.

On the same rows both packages parse the same candidates, extract the
same training rows and fit coefficients equal to rtol 1e-12, with the
same ``assess`` ranking; a model either package saved loads in the other.
The rest are the reference's own ``tests/test_tune.py`` cases (schema v2,
the fingerprint, the extractor, the artifact, predict / fallback /
feedback, shared-IR sweeps and pruning) run on the port on
``device="cpu"``.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import tune as rtune  # noqa: E402
from repro_torch import core, optim, tune  # noqa: E402
from repro_torch.core import engine_select, registry  # noqa: E402
from repro_torch.io import packed  # noqa: E402

CPU = "cpu"
CHEAP = ("qs", "qs-bitmm", "native")
TRAIN_SHAPES = [(8, 16, 6, 1), (16, 16, 8, 1), (8, 32, 6, 3),
                (24, 16, 10, 1)]
CANDIDATES = ["qs", "qs-bitmm@q8i@O2", "native@flint",
              "qs-bitmm@tree_chunk=32", "cuda-qs@q16@O1",
              "qs@q16@dedup_thresholds+compact@cascade-fused=16/48:margin",
              "cuda-gemm@cascade=4/8:margin0.5", "unrolled@q8-nosplits"]


@pytest.fixture(autouse=True)
def _fresh_cache():
    engine_select.clear_cache()
    yield
    engine_select.clear_cache()


def choose(forest, batch, **kw):
    kw.setdefault("repeats", 1)
    return engine_select.choose(forest, batch, device=CPU, **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A populated schema-v2 cache + a cost model trained from it."""
    td = tmp_path_factory.mktemp("tune")
    cache = str(td / "cache.json")
    engine_select.clear_cache()
    for i, (T, L, d, C) in enumerate(TRAIN_SHAPES):
        f = core.random_forest_ir(T, L, d, n_classes=C, seed=i)
        choose(f, 64, engines=CHEAP, cache_path=cache)
    model_path = str(td / "model.json")
    model = tune.train_from_cache(cache, save_to=model_path)
    engine_select.clear_cache()
    return {"dir": td, "cache": cache, "model": model,
            "model_path": model_path}


def _held_out(seed=99):
    return core.random_forest_ir(12, 16, 7, n_classes=1, seed=seed)


def _entries(seed=0):
    """Schema-v2 cache entries made from a seed (no timing): the port's
    and the reference's feature views of a few shapes, every candidate
    of ``CANDIDATES`` labelled, plus a v1 entry and garbage labels the
    extractor must skip."""
    rng = np.random.default_rng(seed)
    out = {"v1": {"engine": "qs", "timings": {"qs": 0.001}}}
    for i, (T, L, d, C) in enumerate(TRAIN_SHAPES * 2):
        backend = ("torch-cpu", "cpu")[i % 2]
        meta = {"n_trees": T, "n_leaves": L, "n_classes": C,
                "n_features": d, "max_depth": int(np.log2(L)) + i % 3,
                "dtype": ("float32", "int16")[i % 2],
                "batch": 2 ** (5 + i % 4), "n_devices": 1,
                "backend": backend, "device_kind": "cpu",
                "machine": "x86_64", "fingerprint": f"fp{i % 2}"}
        us = {c: float(rng.lognormal(1.0, 0.7)) for c in CANDIDATES}
        us["broken"] = -1.0
        out[f"k{i}"] = {"engine": "qs", "timings": {c: u * 1e-3 for c, u
                                                    in us.items()},
                        "bench_us": us,
                        "compile_s": {c: 0.1 for c in CANDIDATES},
                        "meta": meta, "v": 2}
    return out


# --------------------------------------------------------------------------- #
# the port against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", CANDIDATES)
def test_parse_candidate_is_the_reference(name):
    assert tune.parse_candidate(name) == rtune.parse_candidate(name)


def test_rows_and_features_are_the_reference():
    entries = _entries()
    rows, rrows = (tune.rows_from_entries(entries),
                   rtune.rows_from_entries(entries))
    assert rows == rrows and len(rows) == 8 * len(CANDIDATES)
    vocab = {g: sorted({tune.model._cat(r["meta"], r["axes"], g)
                        for r in rows}) for g in tune.GROUPS}
    for r in rows[::5]:
        x, known = tune.featurize(vocab, r["meta"], r["axes"])
        rx, rknown = rtune.featurize(vocab, r["meta"], r["axes"])
        np.testing.assert_array_equal(x, rx)
        assert known == rknown


@pytest.mark.parametrize("l2", [1e-3, 1.0])
def test_fit_gives_the_reference_coefficients_and_ranking(l2):
    entries = _entries(1)
    model = tune.fit_cost_model(tune.rows_from_entries(entries), l2=l2)
    ref = rtune.fit_cost_model(rtune.rows_from_entries(entries), l2=l2)
    for a in ("weights", "mu", "sd"):
        np.testing.assert_allclose(getattr(model, a), getattr(ref, a),
                                   rtol=1e-12, err_msg=a)
    assert model.resid_sigma == pytest.approx(ref.resid_sigma, rel=1e-12)
    assert model.vocab == ref.vocab and model.info == ref.info
    for key in ("k0", "k5"):
        meta = entries[key]["meta"]
        a, ra = model.assess(meta, CANDIDATES), ref.assess(meta, CANDIDATES)
        assert list(a["order"]) == list(ra["order"])
        np.testing.assert_allclose(a["us"], ra["us"], rtol=1e-12)
        assert a["confidence"] == pytest.approx(ra["confidence"],
                                                rel=1e-12)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_model_artifacts_load_across(tmp_path, writer):
    entries = _entries(2)
    path = str(tmp_path / "model.json")
    models = {"port": tune.fit_cost_model(tune.rows_from_entries(entries)),
              "reference": rtune.fit_cost_model(
                  rtune.rows_from_entries(entries))}
    models[writer].save(path)
    loaded = {"port": tune.CostModel.load(path),
              "reference": rtune.CostModel.load(path)}
    meta = entries["k1"]["meta"]
    want = models[writer].assess(meta, CANDIDATES)
    for who, m in loaded.items():
        got = m.assess(meta, CANDIDATES)
        assert list(got["order"]) == list(want["order"]), who
        np.testing.assert_array_equal(got["us"], want["us"])


# --------------------------------------------------------------------------- #
# the reference's own cases (tests/test_tune.py), on the port
# --------------------------------------------------------------------------- #
def test_shape_key_carries_device_fingerprint():
    f = _held_out()
    key = engine_select.shape_key(f, 64, device=CPU)
    fp = engine_select.fingerprint_hash(
        engine_select.device_fingerprint(CPU))
    assert key.startswith("torch-cpu_") and key.endswith(f"_fp{fp}")


def test_foreign_machine_cache_entry_key_misses(tmp_path, monkeypatch):
    cache = str(tmp_path / "engines.json")
    f = _held_out()
    c1 = choose(f, 64, engines=CHEAP, cache_path=cache)
    with open(cache) as fh:
        data = json.load(fh)
    foreign_key = c1.key.rsplit("_fp", 1)[0] + "_fpdeadbeef"
    with open(cache, "w") as fh:
        json.dump({foreign_key: data[c1.key]}, fh)
    engine_select.clear_cache()
    assert not choose(f, 64, engines=CHEAP, cache_path=cache).from_cache
    engine_select.clear_cache()
    monkeypatch.setattr(engine_select, "fingerprint_hash",
                        lambda fp=None: "deadbeef")
    c3 = choose(f, 64, engines=CHEAP, cache_path=cache)
    assert c3.from_cache and c3.key == foreign_key


def test_meta_exposes_fingerprint_as_feature(tmp_path):
    cache = str(tmp_path / "engines.json")
    f = _held_out()
    c = choose(f, 64, engines=("qs",), cache_path=cache)
    with open(cache) as fh:
        meta = json.load(fh)[c.key]["meta"]
    assert meta["fingerprint"] == engine_select.fingerprint_hash(
        engine_select.device_fingerprint(CPU))
    assert meta["backend"] == "torch-cpu" and meta["device_kind"] == "cpu"
    assert meta["n_trees"] == f.n_trees and meta["batch"] == 64


def test_entry_separates_compile_from_bench(tmp_path):
    cache = str(tmp_path / "engines.json")
    c = choose(_held_out(), 64, engines=CHEAP, cache_path=cache)
    with open(cache) as fh:
        entry = json.load(fh)[c.key]
    assert entry["v"] == engine_select.SCHEMA_VERSION
    assert set(entry["compile_s"]) == set(entry["bench_us"]) \
        == set(entry["timings"]) == set(CHEAP)
    for cand in CHEAP:
        assert entry["compile_s"][cand] > 0
        assert entry["bench_us"][cand] == pytest.approx(
            entry["timings"][cand] / 64 * 1e6)
    assert c.compile_s and all(v > 0 for v in c.compile_s.values())


def test_merge_unions_v2_side_tables(tmp_path):
    cache = str(tmp_path / "engines.json")
    f = _held_out()
    full = choose(f, 64, engines=CHEAP, cache_path=cache)
    choose(f, 64, engines=("qs",), cache_path=cache, force=True)
    with open(cache) as fh:
        entry = json.load(fh)[full.key]
    assert set(entry["compile_s"]) == set(entry["bench_us"]) == set(CHEAP)
    assert entry["v"] == engine_select.SCHEMA_VERSION


def test_v1_entry_parses_but_cannot_be_hit(tmp_path):
    cache = str(tmp_path / "engines.json")
    f = _held_out()
    v1_key = engine_select.shape_key(f, 64, device=CPU).rsplit("_fp", 1)[0]
    with open(cache, "w") as fh:
        json.dump({v1_key: {"engine": "qs",
                            "timings": {e: 0.001 for e in CHEAP}}}, fh)
    assert v1_key in engine_select._load_disk(cache)
    c = choose(f, 64, engines=CHEAP, cache_path=cache)
    assert not c.from_cache
    with open(cache) as fh:
        data = json.load(fh)
    assert v1_key in data and c.key in data


def test_extract_rows_feature_label_contract(trained):
    rows = tune.extract_rows(trained["cache"])
    assert len(rows) == len(TRAIN_SHAPES) * len(CHEAP)
    for r in rows:
        assert r["us"] > 0 and r["compile_s"] > 0
        assert r["axes"]["engine"] in CHEAP
        assert r["meta"]["backend"] == "torch-cpu"


def test_extract_skips_v1_entries():
    rows = tune.rows_from_entries({
        "old": {"engine": "qs", "timings": {"qs": 0.001}},
        "new": {"engine": "qs", "timings": {"qs": 0.001},
                "bench_us": {"qs": 15.6}, "compile_s": {"qs": 0.2},
                "meta": {"n_trees": 8}},
    })
    assert [r["key"] for r in rows] == ["new"]


def test_model_artifact_roundtrip(trained):
    m1 = trained["model"]
    m2 = tune.CostModel.load(trained["model_path"])
    meta = engine_select.shape_meta(_held_out(), 64, device=CPU)
    a1, a2 = m1.assess(meta, CHEAP), m2.assess(meta, CHEAP)
    assert np.allclose(a1["us"], a2["us"])
    assert a1["confidence"] == pytest.approx(a2["confidence"])
    assert list(a1["order"]) == list(a2["order"])


@pytest.mark.parametrize("corrupt", ["newer", "garbage"])
def test_model_artifact_rejects_bad_files(tmp_path, trained, corrupt):
    path = str(tmp_path / "model.json")
    if corrupt == "newer":
        trained["model"].save(path)
        with open(path) as f:
            doc = json.load(f)
        doc["version"] = packed.COSTMODEL_VERSION + 1
        with open(path, "w") as f:
            json.dump(doc, f)
    else:
        with open(path, "w") as f:
            f.write("{not json")
    with pytest.raises(ValueError, match="newer" if corrupt == "newer"
                       else "readable"):
        tune.CostModel.load(path)


def test_unknown_candidate_kills_confidence(trained):
    meta = engine_select.shape_meta(_held_out(), 64, device=CPU)
    a = trained["model"].assess(meta, ("rapidscorer",))
    assert not a["known"][0] and a["confidence"] == -1.0
    a = trained["model"].assess(meta, ("rapidscorer", "qs"))
    assert list(a["order"])[0] == 1


def test_confidence_is_probability_when_known(trained):
    meta = engine_select.shape_meta(_held_out(), 64, device=CPU)
    a = trained["model"].assess(meta, CHEAP)
    assert all(a["known"])
    assert 0.5 <= a["confidence"] <= 1.0


def test_fit_needs_rows():
    with pytest.raises(ValueError, match="training rows"):
        tune.fit_cost_model([])


def test_predict_zero_shot_builds_one_plan(trained, tmp_path):
    cache = str(tmp_path / "serve_cache.json")
    f = _held_out()
    c = choose(f, 64, engines=CHEAP, cache_path=cache, mode="predict",
               cost_model=trained["model_path"], confidence_threshold=0.0)
    assert c.predicted and not c.from_cache
    assert c.engine in CHEAP and c.confidence >= 0.5
    assert c.predictor.plan is not None
    with open(cache) as fh:
        entry = json.load(fh)[c.key]
    assert set(entry["timings"]) == {c.engine}
    assert entry["meta"]["n_trees"] == f.n_trees
    rows = tune.extract_rows(cache)
    assert len(rows) == 1 and rows[0]["candidate"] == c.engine


def test_predict_os_alias_and_mode_validation(trained):
    f = _held_out()
    c = choose(f, 64, engines=CHEAP, cache_path=None, mode="-Os",
               cost_model=trained["model_path"], confidence_threshold=0.0,
               feedback=False)
    assert c.predicted and not c.timings
    with pytest.raises(ValueError, match="mode"):
        choose(f, 64, engines=CHEAP, cache_path=None, mode="banana")


def test_cache_hit_beats_the_model(trained, tmp_path):
    cache = str(tmp_path / "cache.json")
    f = _held_out()
    full = choose(f, 64, engines=CHEAP, cache_path=cache)
    c = choose(f, 64, engines=CHEAP, cache_path=cache, mode="predict",
               cost_model=trained["model_path"])
    assert c.from_cache and not c.predicted
    assert c.engine == full.engine


def test_low_confidence_falls_back_to_topk_sweep(trained, tmp_path):
    cache = str(tmp_path / "cache.json")
    f = _held_out()
    fb = choose(f, 64, engines=CHEAP, cache_path=cache, mode="predict",
                cost_model=trained["model_path"],
                confidence_threshold=1.01, top_k=2)
    assert not fb.predicted and not fb.from_cache
    assert len(fb.timings) == 2
    assert fb.confidence is not None and fb.confidence < 1.01
    full = choose(f, 64, engines=CHEAP, cache_path=cache)
    restricted = {c: full.timings[c] for c in fb.timings}
    assert fb.engine == min(restricted, key=restricted.get)


@pytest.mark.parametrize("model_file", ["missing", "corrupt"])
def test_default_model_problems_fall_back_to_full_sweep(tmp_path,
                                                        monkeypatch,
                                                        model_file):
    path = tmp_path / "model.json"
    if model_file == "corrupt":
        path.write_text("{definitely not a model")
    monkeypatch.setenv("REPRO_COST_MODEL", str(path))
    c = choose(_held_out(), 64, engines=CHEAP, cache_path=None,
               mode="predict")
    assert not c.predicted and set(c.timings) == set(CHEAP)


def test_explicit_missing_model_path_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        choose(_held_out(), 64, engines=CHEAP, cache_path=None,
               mode="predict", cost_model=str(tmp_path / "nope.json"))


def test_predict_observability_counters(trained):
    from repro_torch.obs.metrics import MetricsRegistry, set_default_registry
    mine = MetricsRegistry()
    old = set_default_registry(mine)
    try:
        f = _held_out()
        choose(f, 64, engines=CHEAP, cache_path=None, mode="predict",
               cost_model=trained["model_path"], confidence_threshold=0.0)
        snap = mine.snapshot()
        assert snap["repro_autotune_predict_hits_total"][
            "samples"][0]["value"] == 1
        assert snap["repro_autotune_feedback_writes_total"][
            "samples"][0]["value"] == 1
        assert snap["repro_autotune_predict_rel_error"][
            "samples"][0]["count"] == 1
        (g,) = snap["repro_autotune_predict_last_rel_error"]["samples"]
        assert g["value"] >= 0.0
        engine_select.clear_cache()
        choose(f, 64, engines=CHEAP, cache_path=None, mode="predict",
               cost_model=trained["model_path"], confidence_threshold=1.01,
               top_k=2)
        snap = mine.snapshot()
        reasons = {s["labels"]["reason"]: s["value"] for s in
                   snap["repro_autotune_fallback_sweeps_total"]["samples"]}
        assert reasons.get("low_confidence") == 1
    finally:
        set_default_registry(old)


def test_no_model_fallback_counter(monkeypatch, tmp_path):
    from repro_torch.obs.metrics import MetricsRegistry, set_default_registry
    monkeypatch.setenv("REPRO_COST_MODEL", str(tmp_path / "none.json"))
    mine = MetricsRegistry()
    old = set_default_registry(mine)
    try:
        choose(_held_out(), 64, engines=("qs",), cache_path=None,
               mode="predict")
        snap = mine.snapshot()
        reasons = {s["labels"]["reason"]: s["value"] for s in
                   snap["repro_autotune_fallback_sweeps_total"]["samples"]}
        assert reasons.get("no_model") == 1
    finally:
        set_default_registry(old)


def _count_optimize(monkeypatch):
    calls = {"n": 0}
    real = optim.optimize

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(optim, "optimize", counting)
    return calls


@pytest.mark.parametrize("share_ir,n_optimize", [(True, 2),
                                                 (False, 2 * len(CHEAP))])
def test_shared_ir_one_optimize_per_quant_opt_point(monkeypatch, share_ir,
                                                    n_optimize):
    calls = _count_optimize(monkeypatch)
    choose(_held_out(), 64, engines=CHEAP, opt_levels=(1, 2),
           cache_path=None, share_ir=share_ir)
    assert calls["n"] == n_optimize


def test_pruning_aliases_provably_identical_candidates(tmp_path):
    o1_spelled = ("dedup_thresholds", "merge_equivalent_leaves", "compact")
    cache = str(tmp_path / "cache.json")
    c = choose(_held_out(), 64, engines=("qs", "native"),
               opt_levels=(1, o1_spelled), cache_path=cache, share_ir=True)
    assert len(c.pruned) == 2
    for name in c.pruned:
        rep = f"{name.split('@')[0]}@O1"
        assert c.timings[name] == c.timings[rep]
        assert c.compile_s[name] == c.compile_s[rep]
    with open(cache) as fh:
        assert set(json.load(fh)[c.key]["timings"]) == set(c.timings)


def test_pruning_never_aliases_distinct_candidates():
    f = core.random_forest_ir(8, 16, 6, n_classes=1, seed=0)
    c = choose(f, 64, engines=CHEAP, opt_levels=(1,), cache_path=None,
               share_ir=True)
    assert c.pruned == ()


def test_compile_forest_tune_predict(trained, tmp_path):
    f = _held_out()
    pred = core.compile_forest(f, tune="predict", tune_batch=64,
                               engines=CHEAP,
                               cost_model=trained["model_path"],
                               confidence_threshold=0.0,
                               cache_path=str(tmp_path / "c.json"),
                               repeats=1, device=CPU)
    X = np.random.default_rng(0).normal(size=(16, f.n_features))
    assert pred.predict(X).shape == (16, 1)
    assert pred.plan is not None


@pytest.mark.parametrize("T,L,d,seed",
                         [(2, 8, 3, 0), (12, 16, 9, 7), (5, 16, 6, 42)])
def test_predict_plan_registered_compilable_bitexact(trained, T, L, d,
                                                     seed):
    """mode="predict" returns a registered, compilable plan bit-exact to
    compiling the same plan directly."""
    f = core.random_forest_ir(T, L, d, n_classes=1, seed=seed)
    c = choose(f, 32, engines=CHEAP, cache_path=None, mode="predict",
               cost_model=trained["model"], confidence_threshold=0.0,
               feedback=False)
    assert c.predicted
    assert c.engine.split("@")[0] in registry.tune_table()
    facs = engine_select._candidate_factories(f, CHEAP, None, None, 1,
                                              device=CPU)
    X = np.random.default_rng(seed).normal(size=(32, f.n_features))
    np.testing.assert_array_equal(c.predictor.predict(X),
                                  facs[c.engine]().predict(X))


@pytest.mark.parametrize("seed,k", [(0, 1), (3, 2), (11, 3)])
def test_fallback_winner_equals_restricted_full_sweep(trained, tmp_path,
                                                      seed, k):
    cache = str(tmp_path / "fb.json")
    f = core.random_forest_ir(6 + seed % 7, 16, 6, n_classes=1, seed=seed)
    fb = choose(f, 32, engines=CHEAP, cache_path=cache, mode="predict",
                cost_model=trained["model"], confidence_threshold=1.01,
                top_k=k)
    assert not fb.predicted
    assert len(fb.timings) == min(k, len(CHEAP))
    full = choose(f, 32, engines=CHEAP, cache_path=cache)
    restricted = {c: full.timings[c] for c in fb.timings}
    assert fb.engine == min(restricted, key=restricted.get)
