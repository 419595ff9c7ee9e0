"""The port's tree-sharded execution (``repro_torch.core.shard``) against
the reference's ``repro.core.shard``, on the same numpy-made forests
(carried across with ``core.forest_from_reference``), on CPU replicas.

The reference runs genuinely multi-device only in a subprocess with a
forced host device count, and that test is red under this JAX; so the
port's D = 1..4 shards are held against the reference's *single-device*
predictor and its ``tree_sharded(n_devices=1)``, both of which run here.
Quantized (int-accum) forests: ``assert_array_equal``, as the partial sums
are exact.  Float forests: the reference's rtol 1e-5 / atol 1e-6.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.core import registry as rreg  # noqa: E402
from repro.core import shard as rshard  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.cascade import CascadeSpec  # noqa: E402
from repro_torch.core import engine_select, registry, shard  # noqa: E402
from repro_torch.inference import ForestServer  # noqa: E402

CPU = "cpu"
ENGINES = ("bitvector", "bitmm", "rapidscorer", "native", "unrolled", "gemm")
DEVICES = (1, 2, 3, 4)
RTOL, ATOL = 1e-5, 1e-6        # tests/test_kernels.py:34-36
QUANT = rcore.QuantSpec(bits=16, int_accum=True)


def port(ref_forest):
    return tcore.forest_from_reference(vars(ref_forest))


@pytest.fixture(autouse=True)
def _fresh_cache():
    engine_select.clear_cache()
    yield
    engine_select.clear_cache()


@pytest.fixture(scope="module")
def forests():
    """T = 10 (not a multiple of 3 or 4, so D = 3 and 4 pad), C = 2, and
    its int16 int-accum quantization; the rows; and the reference's
    single-device predictions per (engine, quantized) — computed once."""
    f = rcore.random_forest_ir(10, 16, 6, n_classes=2, seed=0, full=False)
    X = np.random.default_rng(3).normal(0, 1.2, size=(32, 6))
    qf = rcore.quantize_forest(f, X, QUANT)
    want = {}
    for engine in ENGINES:
        for quant, forest in ((False, f), (True, qf)):
            want[engine, quant] = rcore.compile_forest(
                forest, engine=engine, backend="jax").predict(X)
    return {"float": f, "quant": qf, "X": X, "want": want}


# --------------------------------------------------------------- padding
@pytest.mark.parametrize("mult", [3, 4, 5, 8])
def test_pad_forest_trees_matches_reference(forests, mult):
    for kind in ("float", "quant"):
        ref = rshard.pad_forest_trees(forests[kind], mult)
        got = shard.pad_forest_trees(port(forests[kind]), mult)
        assert got.n_trees == ref.n_trees and got.n_trees % mult == 0
        for f in dataclasses.fields(ref):
            a, b = getattr(ref, f.name), getattr(got, f.name)
            if isinstance(a, np.ndarray):
                assert b.dtype == a.dtype, f.name
                np.testing.assert_array_equal(b, a, err_msg=f.name)
            else:
                assert b == a, f.name


def test_pad_is_noop_on_exact_multiple(forests):
    f = port(forests["float"])
    assert shard.pad_forest_trees(f, 5) is f


def test_pad_keeps_quantization_metadata_and_scores(forests):
    qf = port(forests["quant"])
    padded = shard.pad_forest_trees(qf, 4)
    assert padded.quant_scale == qf.quant_scale
    assert padded.leaf_scale == qf.leaf_scale
    assert padded.threshold.dtype == qf.threshold.dtype
    np.testing.assert_array_equal(padded.feat_lo, qf.feat_lo)
    assert int(padded.n_nodes[-1]) == 0            # a single-leaf tree
    X = forests["X"]
    np.testing.assert_array_equal(padded.predict_oracle(X),
                                  qf.predict_oracle(X))


# ------------------------------------------------------------ partition
@pytest.mark.parametrize("engine", ENGINES)
def test_partition_split_matches_reference(forests, engine):
    """The same buffer names are tree-sharded and replicated as the
    reference's dataclass fields (dotted for rapidscorer's nested qs)."""
    rf = rshard.pad_forest_trees(forests["quant"], 4)
    rspec = rreg.get(engine, "jax")
    kw = rspec.shard_kw(rf, 4) if rspec.shard_kw else {}
    r_sh, r_rp, _ = rshard._partition(rspec.compile(rf, **kw), rf.n_trees,
                                      rspec.replicated)
    tf = shard.pad_forest_trees(port(forests["quant"]), 4)
    spec = registry.get(engine, "torch")
    assert spec.replicated == rspec.replicated
    kw = spec.shard_kw(tf, 4) if spec.shard_kw else {}
    assert kw == (rspec.shard_kw(rf, 4) if rspec.shard_kw else {})
    t_sh, t_rp, rebuild = shard._partition(spec.compile(tf, device=CPU,
                                                        **kw),
                                           tf.n_trees, spec.replicated)
    assert set(t_sh) == set(r_sh)
    assert set(t_rp) == set(r_rp)
    for k, v in t_sh.items():
        assert tuple(v.shape) == tuple(r_sh[k].shape), k
    # a shard's module: its tree slice, the replicated buffers and config
    local = {k: v[:1] for k, v in t_sh.items()}
    mod = rebuild(local, t_rp, torch.device(CPU))
    assert type(mod) is type(spec.compile(tf, device=CPU, **kw))
    for k in t_sh:
        assert mod.get_buffer(k).shape[0] == 1


def test_every_torch_engine_is_shardable_and_no_kernel_is():
    assert all(s.shardable for s in registry.specs("torch"))
    assert not any(s.shardable for s in registry.specs("cuda"))
    assert {s.name for s in registry.specs("torch") if s.shardable} == \
        {s.name for s in rreg.specs("jax") if s.shardable}


# ----------------------------------------------------------- predictions
@pytest.mark.parametrize("D", DEVICES)
@pytest.mark.parametrize("engine", ENGINES)
def test_tree_sharded_matches_reference_single_device(forests, engine, D):
    X = forests["X"]
    got = shard.tree_sharded(port(forests["quant"]), engine, n_devices=D,
                             device=CPU)
    assert got.n_devices == D and len(got.shards) == D
    np.testing.assert_array_equal(got.predict(X),
                                  forests["want"][engine, True])
    got = shard.tree_sharded(port(forests["float"]), engine, n_devices=D,
                             devices=[CPU] * D)
    np.testing.assert_allclose(got.predict(X), forests["want"][engine, False],
                               rtol=RTOL, atol=ATOL)


# the reference's own sharded native engine fails under this JAX (the
# fori_loop carry at repro/core/baselines.py:87 is not marked varying over
# the mesh axis); its single-device predictor holds native above
MESH_ENGINES = tuple(e for e in ENGINES if e != "native")


@pytest.mark.parametrize("engine", MESH_ENGINES)
def test_tree_sharded_matches_reference_one_device_mesh(forests, engine):
    X = forests["X"]
    want = rshard.tree_sharded(forests["quant"], engine,
                               n_devices=1).predict(X)
    for D in (1, 4):
        np.testing.assert_array_equal(
            shard.tree_sharded(port(forests["quant"]), engine, n_devices=D,
                               device=CPU).predict(X), want)


def test_eight_way_shard_two_trees_each(forests):
    """The reference script's maximum padding pressure: 8 shards of 2."""
    X = forests["X"]
    got = shard.tree_sharded(port(forests["quant"]), "bitvector",
                             n_devices=8, device=CPU)
    assert [m.feat.shape[0] for m in got.shards] == [2] * 8
    np.testing.assert_array_equal(got.predict(X),
                                  forests["want"]["bitvector", True])
    assert got.predict_class(X).shape == (len(X),)
    np.testing.assert_allclose(got.predict_proba(X).sum(axis=1), 1.0)


def test_shards_share_the_replicated_table(forests):
    got = shard.tree_sharded(port(forests["quant"]), "rapidscorer",
                             n_devices=3, device=CPU)
    u = [m.u_feat for m in got.shards]
    assert all(t.data_ptr() == u[0].data_ptr() for t in u)
    assert sum(m.inv.shape[0] for m in got.shards) == 12
    assert got.trace_cache_size() == 0
    got.predict(forests["X"])
    assert got.trace_cache_size() == 1


# ------------------------------------------------- pipeline and autotuner
def test_compile_plan_lowers_to_the_sharded_wrapper(forests):
    f, X = port(forests["float"]), forests["X"]
    pred = tcore.compile_plan(f, engine="bitmm", backend="torch",
                              device=CPU, n_devices=4)
    assert isinstance(pred, shard.ShardedPredictor) and pred.n_devices == 4
    assert any(r.name == "lower" and "tree-sharded" in r.detail
               for r in pred.plan.records)
    assert any(r.name == "layout" and "per-shard" in r.detail
               for r in pred.plan.records)
    np.testing.assert_allclose(pred.predict(X),
                               forests["want"]["bitmm", False], rtol=RTOL,
                               atol=ATOL)
    one = tcore.compile_plan(f, engine="bitmm", backend="torch", device=CPU,
                             n_devices=1)
    assert not isinstance(one, shard.ShardedPredictor)
    assert not any("tree-sharded" in r.detail for r in one.plan.records)


def test_choose_keys_on_device_count_and_serves_sharded(forests):
    f, X = port(forests["float"]), forests["X"]
    choice = engine_select.choose(f, 32, engines=("qs", "qs-bitmm"),
                                  n_devices=4, cache_path=None, repeats=1,
                                  device=CPU)
    assert "_dev4_fp" in choice.key, choice.key
    assert choice.predictor.n_devices == 4
    ref = {"qs": "bitvector", "qs-bitmm": "bitmm"}[choice.engine]
    np.testing.assert_allclose(choice.predict(X),
                               forests["want"][ref, False], rtol=RTOL,
                               atol=ATOL)
    one = engine_select.choose(f, 32, engines=("qs", "qs-bitmm"),
                               cache_path=None, repeats=1, device=CPU)
    assert one.key != choice.key and "_dev1_fp" in one.key
    assert engine_select.shape_key(f, 32, 4, CPU) == choice.key


def test_choose_default_engines_narrow_to_shardable(forests):
    choice = engine_select.choose(port(forests["quant"]), 32, n_devices=2,
                                  cache_path=None, repeats=1, device=CPU)
    assert set(choice.timings) == set(engine_select.torch_engines())
    np.testing.assert_array_equal(
        choice.predict(forests["X"]),
        forests["want"][registry.by_tune_name(choice.engine).name, True])


def test_forest_server_serves_sharded(forests):
    f, X = port(forests["float"]), forests["X"]
    srv = ForestServer.from_forest(f, max_batch=8, engines=("qs",),
                                   n_devices=4, cache_path=None, repeats=1,
                                   device=CPU)
    assert srv.engine_choice.predictor.n_devices == 4
    for i in range(8):
        srv.submit(X[i], arrival_s=float(i) * 1e-4)
    done = srv.poll(now_s=1.0)
    assert len(done) == 8
    np.testing.assert_allclose(np.stack([r.result for r in done]),
                               forests["want"]["bitvector", False][:8],
                               rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------- errors
def test_too_many_devices_raises(forests):
    f = port(forests["float"])
    with pytest.raises(ValueError, match="n_devices=3 but only 2"):
        shard.tree_sharded(f, "bitvector", n_devices=3, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="n_devices=0"):
        shard.tree_sharded(f, "bitvector", n_devices=0, devices=[CPU])


def test_non_shardable_engines_raise(forests):
    f = port(forests["float"])
    with pytest.raises(ValueError, match="cannot run tree-sharded"):
        engine_select.choose(f, 16, engines=("qs", "cuda-qs"), n_devices=2,
                             cache_path=None, device=CPU)
    spec = registry.register_engine(
        "_unshardable", backend="torch", tune_name="_unshardable",
        compile=tcore.compile_qs, evaluate=tcore.eval_batch)
    try:
        assert not spec.shardable
        with pytest.raises(ValueError, match="not shardable"):
            shard.tree_sharded(f, "_unshardable", n_devices=2, device=CPU)
    finally:
        registry._REGISTRY.pop(("_unshardable", "torch"))


def test_cuda_backend_and_cascade_refuse_sharding(forests):
    f = port(forests["float"])
    with pytest.raises(ValueError, match="torch backend only"):
        tcore.compile_plan(f, engine="bitvector", backend="cuda",
                           device=CPU, n_devices=2)
    with pytest.raises(ValueError, match="cascade"):
        tcore.compile_plan(f, backend="torch", device=CPU, n_devices=2,
                           cascade=CascadeSpec((4,)))
    with pytest.raises(ValueError, match="cascade"):
        engine_select.choose(f, 16, engines=("qs",), n_devices=2,
                             cascade_specs=(CascadeSpec((4,)),),
                             cache_path=None, device=CPU)


def test_forced_tree_chunk_that_does_not_divide_hits_the_guard(forests):
    """T = 10 over 2 shards: a forced tree_chunk of 4 re-pads the compile
    to 12 trees, so no buffer has the 10-tree axis; replicating them would
    count each tree twice."""
    qf = port(forests["quant"])
    with pytest.raises(ValueError, match="refusing to shard"):
        shard.tree_sharded(qf, "bitmm", n_devices=2, device=CPU,
                           tree_chunk=4)
    with pytest.raises(ValueError, match="refusing to shard"):
        rshard.tree_sharded(forests["quant"], "bitmm", n_devices=1,
                            tree_chunk=4)
    # a chunk that divides the 5 trees of a shard is fine
    got = shard.tree_sharded(qf, "bitmm", n_devices=2, device=CPU,
                             tree_chunk=5)
    np.testing.assert_array_equal(got.predict(forests["X"]),
                                  forests["want"]["bitmm", True])


def test_sharded_predictor_is_not_serialized(forests, tmp_path):
    from repro_torch import io
    pred = shard.tree_sharded(port(forests["quant"]), "bitvector",
                              n_devices=2, device=CPU)
    with pytest.raises(ValueError, match="tree-sharded"):
        io.save_predictor(pred, tmp_path / "p.repro.npz")


def test_no_card_means_no_default_device(forests):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shard.tree_sharded(port(forests["float"]), "bitvector", n_devices=1)
