"""The port's autotuner (``repro_torch.core.engine_select``) against the
reference's ``repro.core.engine_select``, on the same numpy-made forests
(carried across with ``core.forest_from_reference``), on ``device="cpu"``.

With the timer replaced by the same fixed table of seconds per tune name
in both packages, both ``choose`` calls pick the same winner and write
entries with the same candidate names (``pallas-*`` read as ``cuda-*``) and
the same ``meta`` apart from the device fields; the winner predicts as the
reference's winner does (bit-exact on int-accum forests, rtol 1e-5 / atol
1e-6 on float ones).  Names, buckets, tags and ``_ir_hash`` classes are
the reference's; a cache file holds both packages' entries and each
key-misses the other's.  The rest are the reference's own
``tests/test_engine_select.py`` cases run on the port.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import optim as roptim  # noqa: E402
from repro.cascade import CascadeSpec as RSpec, MarginGate as RGate  # noqa
from repro.core import engine_select as res  # noqa: E402
from repro.core import registry as rreg  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.cascade import (CascadePredictor, CascadeSpec,  # noqa: E402
                                 MarginGate)
from repro_torch.core import engine_select  # noqa: E402
from repro_torch.core import registry as treg  # noqa: E402
from repro_torch.inference import ForestServer  # noqa: E402

CPU = "cpu"
CHEAP = ("qs", "qs-bitmm", "native")
RTOL, ATOL = 1e-5, 1e-6        # tests/test_kernels.py:34-36
# milliseconds per batch by tune name: the same table in both packages
TABLE_MS = {"qs": 3.0, "qs-bitmm": 2.0, "rapidscorer": 4.0, "native": 5.0,
            "unrolled": 6.0, "gemm": 2.5, "cuda-qs": 1.0,
            "cuda-bitmm": 1.5, "cuda-gemm": 1.2}


@pytest.fixture(autouse=True)
def _fresh_cache():
    engine_select.clear_cache()
    res.clear_cache()
    yield
    engine_select.clear_cache()
    res.clear_cache()


def port(ref_forest):
    return tcore.forest_from_reference(vars(ref_forest))


def _kernel_name(name: str) -> str:
    return name.replace("pallas-", "cuda-")


def _fixed_timer(registry, table=TABLE_MS):
    """``_bench_once`` replaced by the table: seconds from the plan's tune
    name, 0.9x at an opt level, 0.8x staged and 0.6x fused cascades."""
    def bench(pred, X, repeats, *_):
        plan = pred.plan
        name = _kernel_name(registry.get(plan.engine, plan.backend)
                            .tune_name)
        s = table[name] * 1e-3
        if plan.opt is not None:
            s *= 0.9
        if plan.cascade is not None:
            s *= 0.6 if plan.cascade.fused else 0.8
        return s
    return bench


def _int_forest(seed=0, C=2):
    f = rcore.random_forest_ir(8, 16, 6, n_classes=C, seed=seed)
    X = np.random.default_rng(seed).normal(size=(128, 6))
    return rcore.quantize_forest(f, X, rcore.QuantSpec(16, int_accum=True))


# (reference forest, engines (reference names), choose kwargs for the
# reference, for the port, winner)
CASES = {
    "int_accum_kernel": (lambda: _int_forest(),
                         ("qs", "gemm", "pallas-qs"), {}, {}, "cuda-qs"),
    "float": (lambda: rcore.random_forest_ir(8, 16, 6, n_classes=1, seed=1),
              ("qs", "qs-bitmm", "native", "unrolled"), {}, {},
              "qs-bitmm"),
    "opt": (lambda: _int_forest(2), ("qs", "native"),
            {"opt_levels": (2,)}, {"opt_levels": (2,)}, "qs@O2"),
    "cascade": (lambda: _int_forest(3, C=3), ("qs",),
                {"cascade_specs": (RSpec((4, 8), RGate(0.5)),
                                   RSpec((4, 8), RGate(0.5), fused=True))},
                {"cascade_specs": (CascadeSpec((4, 8), MarginGate(0.5)),
                                   CascadeSpec((4, 8), MarginGate(0.5),
                                               fused=True))},
                "qs@cascade-fused=4/8:margin0.5"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_same_timings_give_the_reference_winner_and_entry(case, tmp_path,
                                                          monkeypatch):
    make, engines, rkw, tkw, winner = CASES[case]
    ref_forest = make()
    monkeypatch.setattr(res, "_bench_once", _fixed_timer(rreg))
    monkeypatch.setattr(engine_select, "_bench_once", _fixed_timer(treg))
    rcache, tcache = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    rc = res.choose(ref_forest, 64, engines=engines, cache_path=rcache,
                    **rkw)
    tc = engine_select.choose(port(ref_forest), 64,
                              engines=tuple(map(_kernel_name, engines)),
                              cache_path=tcache, device=CPU, **tkw)
    assert _kernel_name(rc.engine) == tc.engine == winner
    assert {_kernel_name(k): v for k, v in rc.timings.items()} == tc.timings
    assert tc.pruned == tuple(map(_kernel_name, rc.pruned))
    (rentry,), (tentry,) = (json.load(open(p)).values()
                            for p in (rcache, tcache))
    for fld in ("timings", "bench_us"):
        assert {_kernel_name(k): v for k, v in rentry[fld].items()} == \
            tentry[fld]
    assert set(map(_kernel_name, rentry["compile_s"])) == \
        set(tentry["compile_s"])
    device_fields = {"backend", "device_kind", "fingerprint"}
    assert {k: v for k, v in rentry["meta"].items()
            if k not in device_fields} == \
        {k: v for k, v in tentry["meta"].items() if k not in device_fields}
    assert tentry["meta"]["backend"] == "torch-cpu"
    assert rentry["v"] == tentry["v"] == engine_select.SCHEMA_VERSION
    X = np.random.default_rng(7).normal(size=(64, ref_forest.n_features))
    got, want = tc.predict(X), np.asarray(rc.predict(X))
    if ref_forest.int_accum:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_names_buckets_and_tags_are_the_reference():
    assert [engine_select.bucket_batch(b) for b in range(0, 1100)] == \
        [res.bucket_batch(b) for b in range(0, 1100)]
    for top in (1, 2, 3, 33, 256, 1000):
        assert engine_select.bucket_ladder(top) == res.bucket_ladder(top)
    specs = [dict(), dict(bits=8), dict(bits=16, int_accum=True),
             dict(bits=8, scale=100.0), dict(quantize_splits=False),
             dict(quantize_leaves=False, int_accum=True)]
    assert [engine_select._quant_tag(tcore.QuantSpec(**s)) for s in specs] \
        == [res._quant_tag(rcore.QuantSpec(**s)) for s in specs]
    for kw in ({}, {"tree_chunk": 32}, {"b": 2, "a": "x"}):
        assert engine_select._layout_tag(kw) == res._layout_tag(kw)
    assert {k: tuple(map(_kernel_name, v)) for k, v in (
        ("torch", res.xla_engines()),
        ("kernels", res.pallas_engines()))} == {
        "torch": engine_select.torch_engines(),
        "kernels": engine_select.kernel_engines()}
    assert dict(engine_select.ENGINE_SPECS) == {
        _kernel_name(k): (e, {"jax": "torch", "pallas": "cuda"}[b])
        for k, (e, b) in res.ENGINE_SPECS.items()}


def test_candidate_names_and_axes_across_every_axis(small_forest):
    engines = ("qs", "qs-bitmm", "pallas-qs")
    quant = (dict(bits=8), dict(bits=16, int_accum=True))
    o1 = ("dedup_thresholds", "compact")
    rfac = res._candidate_factories(
        small_forest, engines, tuple(rcore.QuantSpec(**q) for q in quant),
        {"qs-bitmm": ({"tree_chunk": 4},)}, 1,
        (RSpec((2, 8), RGate(0.5)), RSpec((2, 8), RGate(0.5), fused=True)),
        (1, o1), flint=True)
    tfac = engine_select._candidate_factories(
        port(small_forest), tuple(map(_kernel_name, engines)),
        tuple(tcore.QuantSpec(**q) for q in quant),
        {"qs-bitmm": ({"tree_chunk": 4},)}, 1,
        (CascadeSpec((2, 8), MarginGate(0.5)),
         CascadeSpec((2, 8), MarginGate(0.5), fused=True)),
        (1, o1), flint=True, device=CPU)
    assert list(tfac) == [_kernel_name(n) for n in rfac]
    for (rn, rf), tf in zip(rfac.items(), tfac.values()):
        assert tf.axes == {**rf.axes, "engine": _kernel_name(
            rf.axes["engine"])}, rn
    # flint on the float variants of the torch engines: (qs, qs-bitmm ×
    # 2 layouts) × 3 opt points × 3 cascade points
    assert sum("@flint" in n for n in tfac) == 3 * 3 * 3
    assert len(tfac) == len(rfac) == 135


def test_ir_hash_classes_are_the_reference(small_forest):
    """Forests the reference hashes alike hash alike in the port, and
    forests it tells apart stay apart."""
    X = np.random.default_rng(0).normal(size=(64, 6))
    ref = [small_forest, rcore.random_forest_ir(8, 16, 6, seed=0),
           rcore.random_forest_ir(8, 16, 6, seed=1),
           roptim.optimize(small_forest, 1).forest,
           roptim.optimize(small_forest, ("dedup_thresholds",
                                          "merge_equivalent_leaves",
                                          "compact")).forest,
           rcore.quantize_forest(small_forest, X),
           rcore.quantize_forest(small_forest, X,
                                 rcore.QuantSpec(16, int_accum=True))]
    rh = [res._ir_hash(f) for f in ref]
    th = [engine_select._ir_hash(port(f)) for f in ref]
    assert [[a == b for b in rh] for a in rh] == \
        [[a == b for b in th] for a in th]
    assert len(set(th)) == 5


@pytest.mark.parametrize("first", ["reference", "port"])
def test_cache_file_holds_both_packages_and_each_misses_the_other(
        small_forest, tmp_path, first):
    cache = str(tmp_path / "shared.json")
    calls = {
        "reference": lambda: res.choose(small_forest, 64, engines=CHEAP,
                                        cache_path=cache, repeats=1),
        "port": lambda: engine_select.choose(
            port(small_forest), 64, engines=CHEAP, cache_path=cache,
            repeats=1, device=CPU)}
    order = [first, *(k for k in calls if k != first)]
    keys = {}
    for who in order:
        c = calls[who]()
        assert not c.from_cache and set(c.timings) == set(CHEAP), who
        keys[who] = c.key
        with open(cache) as f:
            assert set(json.load(f)) == set(keys.values())
    assert keys["port"].startswith("torch-cpu_")
    assert keys["port"] != keys["reference"]
    assert keys["port"].split("_fp")[0].split("_", 1)[1] == \
        keys["reference"].split("_fp")[0].split("_", 1)[1]
    engine_select.clear_cache()
    res.clear_cache()
    for who in order:
        assert calls[who]().from_cache, who


def test_autotune_counters_read_as_the_reference(tmp_path, monkeypatch):
    """The same hit/miss/sweep sequence moves the same counters, by the
    same names and labels (tests/test_obs.py:603).  Timings come from one
    table in which qs wins every sweep, so the winner gauge holds one
    label set (with measured timings the widened sweep's winner, and with
    it the gauge's labels, depended on the host's load)."""
    from repro.obs.metrics import (MetricsRegistry as RReg,
                                   set_default_registry as rset)
    from repro_torch.obs.metrics import (MetricsRegistry as TReg,
                                         set_default_registry as tset)
    table = {"qs": 1.0, "native": 5.0, "qs-bitmm": 2.0}
    monkeypatch.setattr(res, "_bench_once", _fixed_timer(rreg, table))
    monkeypatch.setattr(engine_select, "_bench_once",
                        _fixed_timer(treg, table))
    qf = rcore.quantize_forest(
        rcore.random_forest_ir(8, 8, 6, n_classes=3, seed=7),
        np.random.default_rng(7).normal(size=(128, 6)))
    snaps = {}
    for who, es, reg_cls, setter, kw, forest in (
            ("reference", res, RReg, rset, {}, qf),
            ("port", engine_select, TReg, tset, {"device": CPU}, port(qf))):
        mine = reg_cls()
        old = setter(mine)
        try:
            for engines in (("qs", "native"), ("qs", "native"),
                            ("qs", "native", "qs-bitmm")):
                es.choose(forest, 8, engines=engines, cache_path=None,
                          repeats=1, **kw)
        finally:
            setter(old)
        snap = mine.snapshot()
        for fam in snap.values():
            for s in fam["samples"]:
                s["labels"].pop("key", None)
                if "sum" in s:
                    s.update(sum=None, p50=None, p90=None, p99=None)
        winners = snap.pop("repro_autotune_winner_info")
        assert [s["value"] for s in winners["samples"]] == [1.0]
        snaps[who] = snap
    assert snaps["port"] == snaps["reference"]
    assert snaps["port"]["repro_autotune_sweeps_total"]["samples"][0][
        "value"] == 2


# --------------------------------------------------------------------------- #
# the port's own entry points and departures
# --------------------------------------------------------------------------- #
def test_default_engines_add_the_kernels_on_the_card_only():
    torch_names = ("qs", "qs-bitmm", "rapidscorer", "native", "unrolled",
                   "gemm")
    kernels = ("cuda-qs", "cuda-bitmm", "cuda-gemm")
    assert engine_select.default_engines(device=CPU) == torch_names
    assert engine_select.default_engines(True, CPU) == torch_names + kernels
    assert engine_select.default_engines(False, "cuda") == torch_names
    assert engine_select.device_fingerprint(CPU)["backend"] == "torch-cpu"
    f = port(_int_forest(5))
    X = np.random.default_rng(5).normal(size=(16, f.n_features))
    want = tcore.compile_forest(f, backend="torch", device=CPU).predict(X)
    for name in torch_names + kernels:
        got = engine_select.ENGINE_FACTORIES[name](f, device=CPU).predict(X)
        np.testing.assert_array_equal(got, want, err_msg=name)
    fp = engine_select.device_fingerprint(CPU)
    assert fp["device_kind"] == "cpu"
    assert engine_select.fingerprint_hash(fp) != res.fingerprint_hash(
        res.device_fingerprint())


def test_explicit_kernel_engines_run_their_plain_versions_on_the_cpu(
        small_forest):
    qf = port(_int_forest(4))
    kernels = ("cuda-qs", "cuda-bitmm", "cuda-gemm")
    c = engine_select.choose(qf, 32, engines=kernels, cache_path=None,
                             repeats=1, device=CPU)
    assert set(c.timings) == set(kernels)
    assert c.predictor.plan.backend == "cuda"
    X = np.random.default_rng(1).normal(size=(32, qf.n_features))
    np.testing.assert_array_equal(
        c.predict(X), tcore.compile_forest(qf, backend="torch",
                                           device=CPU).predict(X))


def test_multi_device_tunes_the_tree_sharded_wrapper(small_forest):
    """The sharding slice is in: ``n_devices=2`` tunes the tree-sharded
    wrapper over two CPU replicas, keyed on the device count, and its
    winner predicts as the reference's single-device engine."""
    f = port(small_forest)
    c = engine_select.choose(f, 16, engines=("qs", "qs-bitmm"), n_devices=2,
                             cache_path=None, repeats=1, device=CPU)
    assert c.predictor.n_devices == 2 and "_dev2_fp" in c.key
    X = np.random.default_rng(1).normal(size=(16, f.n_features))
    ref = {"qs": "bitvector", "qs-bitmm": "bitmm"}[c.engine]
    np.testing.assert_allclose(
        c.predict(X), rcore.compile_forest(small_forest, engine=ref)
        .predict(X), rtol=RTOL, atol=ATOL)
    # cascade + sharding still raises the reference's ValueError
    with pytest.raises(ValueError, match="cascade"):
        engine_select.choose(f, 16, engines=("qs",), n_devices=2,
                             cascade_specs=(_cascade_spec(),),
                             cache_path=None, device=CPU)


def test_flint_variants_only_for_torch_engines(small_forest):
    c = engine_select.choose(port(small_forest), 16,
                             engines=("qs", "cuda-qs"), flint=True,
                             cache_path=None, repeats=1, device=CPU)
    assert set(c.timings) == {"qs", "qs@flint", "cuda-qs"}


def test_compile_forest_tune_and_server_save_the_engine(small_forest,
                                                        tmp_path):
    f = port(small_forest)
    cache = str(tmp_path / "c.json")
    pred = tcore.compile_forest(f, tune="measure", tune_batch=16,
                                engines=CHEAP, cache_path=cache,
                                repeats=1, device=CPU)
    srv = ForestServer.from_forest(f, max_batch=16, engines=CHEAP,
                                   cache_path=cache, device=CPU)
    assert srv.engine_choice.from_cache
    assert srv.engine_choice.engine == \
        treg.get(pred.plan.engine, pred.plan.backend).tune_name
    with pytest.raises(ValueError, match="tune="):
        tcore.compile_forest(f, engine="native", tune="predict",
                             device=CPU)
    path = str(tmp_path / "srv.npz")
    srv.save(path)
    loaded = ForestServer.load(path, device=CPU)
    assert loaded.engine_choice == srv.engine_choice.engine
    X = np.random.default_rng(2).normal(size=(16, f.n_features))
    np.testing.assert_array_equal(loaded.predictor.predict(X),
                                  pred.predict(X))


# --------------------------------------------------------------------------- #
# the reference's own cases (tests/test_engine_select.py), on the port
# --------------------------------------------------------------------------- #
@pytest.fixture
def small(small_forest):
    return port(small_forest)


def choose(forest, batch, **kw):
    kw.setdefault("repeats", 1)
    return engine_select.choose(forest, batch, device=CPU, **kw)


def test_choose_benchmarks_and_caches(small, tmp_path):
    cache = str(tmp_path / "engines.json")
    c1 = choose(small, 64, engines=CHEAP, cache_path=cache)
    assert c1.engine in CHEAP and not c1.from_cache
    assert set(c1.timings) == set(CHEAP)
    assert all(t > 0 for t in c1.timings.values())
    assert c1.engine == min(c1.timings, key=c1.timings.get)
    c2 = choose(small, 64, engines=CHEAP, cache_path=cache)
    assert c2.from_cache and c2.engine == c1.engine
    engine_select.clear_cache()
    with open(cache) as f:
        assert c1.key in json.load(f)
    c3 = choose(small, 64, engines=CHEAP, cache_path=cache)
    assert c3.from_cache and c3.engine == c1.engine


def test_subset_sweep_never_answers_for_full_matrix(small, tmp_path):
    cache = str(tmp_path / "engines.json")
    narrow = choose(small, 64, engines=("qs",), cache_path=cache)
    assert narrow.engine == "qs" and not narrow.from_cache
    full = choose(small, 64, engines=CHEAP, cache_path=cache)
    assert not full.from_cache and set(full.timings) == set(CHEAP)
    again = choose(small, 64, engines=("qs", "native"), cache_path=cache)
    assert again.from_cache
    assert again.engine == min(("qs", "native"), key=full.timings.get)


@pytest.mark.parametrize("via_memory", [False, True],
                         ids=["disk", "memory-layer"])
def test_narrow_resweep_keeps_richer_cache_entry(small, tmp_path,
                                                 via_memory):
    """A forced narrow re-benchmark must not clobber the wide entry, not
    even through a narrow entry cached only in memory."""
    cache = str(tmp_path / "engines.json")
    full = choose(small, 64, engines=CHEAP, cache_path=cache)
    if via_memory:
        engine_select.clear_cache()
        choose(small, 64, engines=("qs",), cache_path=None)
    choose(small, 64, engines=("qs",), cache_path=cache, force=True)
    with open(cache) as f:
        assert set(json.load(f)[full.key]["timings"]) == set(CHEAP)
    assert choose(small, 64, engines=CHEAP, cache_path=cache).from_cache


def test_partial_miss_benches_only_missing_engines(small, tmp_path):
    cache = str(tmp_path / "engines.json")
    narrow = choose(small, 64, engines=("qs",), cache_path=cache)
    wider = choose(small, 64, engines=CHEAP, cache_path=cache)
    assert not wider.from_cache and set(wider.timings) == set(CHEAP)
    assert wider.timings["qs"] == narrow.timings["qs"]


@pytest.mark.parametrize("second_engines", [CHEAP, ("qs", "native",
                                                     "gemm")],
                         ids=["memory-hit", "partial-miss"])
def test_memory_only_coverage_reaches_disk(small, tmp_path,
                                           second_engines):
    cache = str(tmp_path / "engines.json")
    c1 = choose(small, 64, engines=CHEAP, cache_path=None)
    c2 = choose(small, 64, engines=second_engines, cache_path=cache)
    assert c2.from_cache == (second_engines == CHEAP)
    with open(cache) as f:
        assert set(json.load(f)[c1.key]["timings"]) == \
            set(CHEAP) | set(second_engines)


def test_overlapping_sweeps_merge_coverage(small, tmp_path):
    cache = str(tmp_path / "engines.json")
    choose(small, 64, engines=("qs", "native"), cache_path=cache)
    c2 = choose(small, 64, engines=("qs-bitmm",), cache_path=cache)
    assert not c2.from_cache
    c3 = choose(small, 64, engines=CHEAP, cache_path=cache)
    assert c3.from_cache and set(c3.timings) == set(CHEAP)


def test_env_cache_path_resolved_per_call(small, tmp_path, monkeypatch):
    cache = tmp_path / "env_cache.json"
    monkeypatch.setenv("REPRO_ENGINE_CACHE", str(cache))
    c = choose(small, 64, engines=("qs",))
    assert cache.exists() and c.key in json.loads(cache.read_text())


def test_disk_hit_warms_memory_layer(small, tmp_path):
    cache = str(tmp_path / "engines.json")
    c1 = choose(small, 64, engines=CHEAP, cache_path=cache)
    engine_select.clear_cache()
    c2 = choose(small, 64, engines=CHEAP, cache_path=cache)
    assert c2.from_cache
    assert engine_select._MEM_CACHE[c1.key]["timings"] == c2.timings


def test_choose_batch_bucketing(small, tmp_path):
    cache = str(tmp_path / "engines.json")
    c1 = choose(small, 33, engines=CHEAP, cache_path=cache)
    c2 = choose(small, 64, engines=CHEAP, cache_path=cache)
    assert c1.key == c2.key and c2.from_cache


def test_choice_predictor_correct(small):
    from conftest import rand_X
    c = choose(small, 32, engines=CHEAP, cache_path=None)
    X = rand_X(small, B=32)
    np.testing.assert_allclose(c.predict(X), small.predict_oracle(X),
                               rtol=1e-4, atol=1e-5)


def test_forest_server_uses_autotuned_winner(small, tmp_path):
    cache = str(tmp_path / "engines.json")
    choice = choose(small, 16, engines=CHEAP, cache_path=cache)
    srv = ForestServer.from_forest(small, max_batch=16, engines=CHEAP,
                                   cache_path=cache, device=CPU)
    assert srv.engine_choice.from_cache
    assert srv.engine_choice.engine == choice.engine
    assert srv.predictor is srv.engine_choice.predictor
    feats = np.random.default_rng(1).normal(size=(16, small.n_features))
    for i in range(16):
        srv.submit(feats[i], arrival_s=float(i) * 1e-4)
    done = srv.poll(now_s=1.0)
    assert len(done) == 16
    np.testing.assert_allclose(np.stack([r.result for r in done]),
                               choice.predict(feats), rtol=RTOL, atol=ATOL)


def _cascade_spec(threshold=0.9):
    return CascadeSpec(stages=(4, 8), policy=MarginGate(threshold))


def test_cascade_candidates_swept_and_usable(small):
    from conftest import rand_X
    spec = _cascade_spec()
    c = choose(small, 16, engines=("qs",), cascade_specs=(spec,),
               cache_path=None)
    assert set(c.timings) == {"qs", f"qs@{spec.tag()}"}
    assert "cascade=4/8:margin0.9" in spec.tag()
    X = rand_X(small, B=16)
    np.testing.assert_allclose(c.predict(X), small.predict_oracle(X),
                               rtol=1e-4, atol=1e-5)
    if "cascade" in c.engine:
        assert isinstance(c.predictor, CascadePredictor)


def test_old_cache_entries_keymiss_cascade_sweeps(small, tmp_path):
    cache = str(tmp_path / "engines.json")
    plain = choose(small, 16, engines=("qs", "native"), cache_path=cache)
    engine_select.clear_cache()
    spec = _cascade_spec()
    c = choose(small, 16, engines=("qs", "native"), cascade_specs=(spec,),
               cache_path=cache)
    assert not c.from_cache
    assert c.timings["qs"] == plain.timings["qs"]
    assert set(c.timings) == {"qs", "native", f"qs@{spec.tag()}",
                              f"native@{spec.tag()}"}
    assert choose(small, 16, engines=("qs", "native"),
                  cascade_specs=(spec,), cache_path=cache).from_cache
    assert choose(small, 16, engines=("qs", "native"),
                  cache_path=cache).from_cache


@pytest.mark.parametrize("other", [
    CascadeSpec((4, 8), MarginGate(0.5)),
    CascadeSpec((2, 8), MarginGate(0.9)),
    CascadeSpec((4, 8), MarginGate(0.9), fused=True)],
    ids=["threshold", "stages", "fused"])
def test_distinct_cascade_specs_never_alias(small, tmp_path, other):
    cache = str(tmp_path / "engines.json")
    choose(small, 16, engines=("qs",), cascade_specs=(_cascade_spec(0.9),),
           cache_path=cache)
    assert not choose(small, 16, engines=("qs",), cascade_specs=(other,),
                      cache_path=cache).from_cache


def test_forest_server_serves_cascade_winner(small, tmp_path):
    spec = CascadeSpec(stages=(2, 8), policy=MarginGate(0.0))
    srv = ForestServer.from_forest(small, max_batch=8, engines=("qs",),
                                   cascade_specs=(spec,),
                                   cache_path=str(tmp_path / "c.json"),
                                   repeats=1, device=CPU)
    assert srv.engine_choice.engine in {"qs", f"qs@{spec.tag()}"}
    rng = np.random.default_rng(0)
    for i in range(8):
        srv.submit(rng.normal(size=small.n_features),
                   arrival_s=float(i) * 1e-4)
    srv.flush(now_s=1.0)
    s = srv.stats.summary()
    assert s["n_requests"] == 8
    if isinstance(srv.predictor, CascadePredictor):
        assert "exit_fractions" in s


@pytest.mark.parametrize("garbage", [
    '{"truncated": {"timings": {"qs": 0.0',
    "not json at all",
    "[1, 2, 3]",
    '"just a string"',
    '{"key": "entry is not a dict"}',
    '{"key": {"engine": "qs"}}',
    '{"key": {"timings": {"qs": "fast"}}}',
    '{"key": {"timings": {}}}',
    "",
], ids=["truncated", "not-json", "list", "string", "str-entry",
        "no-timings", "str-timing", "empty-timings", "empty-file"])
def test_garbage_cache_file_triggers_clean_resweep(small, tmp_path,
                                                   garbage):
    cache = str(tmp_path / "engines.json")
    with open(cache, "w") as f:
        f.write(garbage)
    c = choose(small, 64, engines=("qs", "native"), cache_path=cache)
    assert not c.from_cache and set(c.timings) == {"qs", "native"}
    with open(cache) as f:
        assert set(json.load(f)[c.key]["timings"]) == {"qs", "native"}
    engine_select.clear_cache()
    c2 = choose(small, 64, engines=("qs", "native"), cache_path=cache)
    assert c2.from_cache and c2.engine == c.engine


def test_garbage_entries_dropped_but_valid_entries_kept(small, class_forest,
                                                        tmp_path):
    cache = str(tmp_path / "engines.json")
    good = choose(small, 64, engines=("qs",), cache_path=cache)
    with open(cache) as f:
        data = json.load(f)
    data["corrupt_key"] = {"timings": "nope"}
    with open(cache, "w") as f:
        json.dump(data, f)
    engine_select.clear_cache()
    hit = choose(small, 64, engines=("qs",), cache_path=cache)
    assert hit.from_cache and hit.engine == good.engine
    choose(port(class_forest), 64, engines=("qs",), cache_path=cache)
    with open(cache) as f:
        rewritten = json.load(f)
    assert "corrupt_key" not in rewritten
    assert good.key in rewritten
