"""The first slice of the port as a whole: a trained ``magic`` random
forest, quantized int16 with int accumulation, compiled through both
packages' ``compile_forest`` and served by both ``ForestServer``s on the
same virtual clock.  Predictions, batching decisions and the plan's pass
names must be identical."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.inference import ForestServer as RServer  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.data import datasets as tdatasets  # noqa: E402
from repro_torch.inference import ForestServer as TServer  # noqa: E402
from repro_torch.trees.random_forest import (  # noqa: E402
    RandomForest as TRF, RandomForestConfig as TRFConfig)

BACKENDS = [("pallas", "cuda"), ("jax", "torch")]


@pytest.fixture(scope="module")
def port_rf():
    ds = tdatasets.load("magic", n=2000)
    return TRF(TRFConfig(n_trees=32, max_leaves=16, seed=0)).fit(
        ds.X_train, ds.y_train)


@pytest.fixture(scope="module")
def forests(trained_rf, port_rf, magic_ds):
    spec = dict(bits=16, int_accum=True)
    ref = rcore.quantize_forest(rcore.from_random_forest(trained_rf),
                                magic_ds.X_train, rcore.QuantSpec(**spec))
    port = tcore.quantize_forest(tcore.from_random_forest(port_rf),
                                 magic_ds.X_train, tcore.QuantSpec(**spec))
    return ref, port


def serve(server, rows, arrivals):
    reqs = []
    for row, t in zip(rows, arrivals):
        reqs.append(server.submit(row, arrival_s=float(t)))
        server.poll(now_s=float(t))
    server.flush(now_s=float(arrivals[-1]) + 1e-3)
    assert all(r.result is not None for r in reqs)
    return np.stack([r.result for r in reqs])


def test_port_trainer_gives_the_reference_forest(forests):
    ref, port = forests
    for k, v in vars(ref).items():
        w = vars(port)[k]
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype, k
            np.testing.assert_array_equal(v, w, err_msg=k)
        else:
            assert v == w, k


@pytest.mark.parametrize("ref_backend,port_backend", BACKENDS)
def test_served_slice_matches_reference(forests, magic_ds, ref_backend,
                                        port_backend):
    ref_forest, port_forest = forests
    ref_pred = rcore.compile_forest(ref_forest, engine="bitvector",
                                    backend=ref_backend)
    port_pred = tcore.compile_forest(port_forest, engine="bitvector",
                                     backend=port_backend, device="cpu")
    rows = magic_ds.X_test[:300]
    arrivals = np.cumsum(np.random.default_rng(0).exponential(
        1 / 20_000, size=len(rows)))
    ref_srv = RServer(ref_pred, max_batch=64, max_wait_ms=2.0)
    port_srv = TServer(port_pred, max_batch=64, max_wait_ms=2.0)
    ref_out = serve(ref_srv, rows, arrivals)
    port_out = serve(port_srv, rows, arrivals)

    np.testing.assert_array_equal(port_out, ref_out)
    np.testing.assert_array_equal(port_out, port_pred.predict(rows))
    assert port_srv.stats.n_batches == ref_srv.stats.n_batches > 1
    assert list(port_srv.stats.batch_sizes) == list(ref_srv.stats.batch_sizes)
    assert port_srv.stats.n_requests == ref_srv.stats.n_requests
    assert [r.name for r in port_pred.plan.records] == \
        [r.name for r in ref_pred.plan.records]
    np.testing.assert_array_equal(port_srv.predict_proba(rows[:20]),
                                  ref_srv.predict_proba(rows[:20]))
    acc = (port_out.argmax(axis=1) == magic_ds.y_test[:300]).mean()
    assert acc > 0.9


def test_compile_plan_quantizes_as_the_reference(trained_rf, port_rf,
                                                  magic_ds):
    """Quantization as a pipeline pass: same IR, same record detail."""
    spec = dict(bits=16, int_accum=True)
    ref = rcore.compile_plan(trained_rf, engine="bitvector", backend="jax",
                             quant=rcore.QuantSpec(**spec),
                             X_calib=magic_ds.X_train)
    port = tcore.compile_plan(port_rf, engine="bitvector", backend="torch",
                              device="cpu", quant=tcore.QuantSpec(**spec),
                              X_calib=magic_ds.X_train)
    X = magic_ds.X_test[:50]
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    for name in ("canonicalize", "quantize"):
        assert [r.detail for r in port.plan.records if r.name == name] == \
            [r.detail for r in ref.plan.records if r.name == name]


def test_unported_parts_raise(forests, magic_ds, tmp_path, monkeypatch):
    _, port_forest = forests
    # the autotuner is ported: tune= (here with no cost model, so a
    # sweep) builds the predictor the plain compile gives, and
    # from_forest serves
    monkeypatch.setenv("REPRO_COST_MODEL", str(tmp_path / "none.json"))
    X = magic_ds.X_test[:64]
    tuned = tcore.compile_forest(port_forest, tune="-Os", device="cpu",
                                 engines=("qs",), cache_path=None,
                                 repeats=1)
    np.testing.assert_array_equal(
        tuned.predict(X), tcore.compile_forest(port_forest, backend="torch",
                                               device="cpu").predict(X))
    srv = TServer.from_forest(port_forest, max_batch=64, device="cpu",
                              engines=("qs",), cache_path=None, repeats=1)
    for row in X:
        srv.submit(row, arrival_s=0.0)
    done = srv.flush(now_s=1.0)
    np.testing.assert_array_equal(np.stack([r.result for r in done]),
                                  tuned.predict(X))
    # the serving runtime and obs are ported: the cascade counts its
    # first uses, and an instrumented server feeds its registry
    from repro_torch.cascade import CascadeSpec
    from repro_torch.obs import MetricsRegistry
    casc = tcore.compile_forest(port_forest, device="cpu",
                                cascade=CascadeSpec((2,)))
    assert casc.trace_cache_size() == 0
    casc.predict(X)
    assert casc.trace_cache_size() == 1
    # tree-sharded execution over two CPU replicas predicts as one device
    sharded = tcore.compile_plan(port_forest, backend="torch", device="cpu",
                                 n_devices=2)
    assert sharded.n_devices == 2
    np.testing.assert_array_equal(
        sharded.predict(X),
        tcore.compile_forest(port_forest, backend="torch",
                             device="cpu").predict(X))
    pred = tcore.compile_forest(port_forest, opt="O0", device="cpu")
    reg = MetricsRegistry()
    srv = TServer(pred, obs=reg)
    for row in X:
        srv.submit(row, arrival_s=0.0)
    srv.flush(now_s=1.0)
    assert reg.get("repro_requests_total").labels(
        tenant="forest").value == len(X)
