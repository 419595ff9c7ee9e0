"""The serving half of the port's observability layer (``repro_torch.obs``:
trace, retrace, serving, expo, and the instrumented runtime and
``ForestServer``) against the reference's ``repro.obs``, and the
reference's own ``tests/test_obs.py`` serving cases on the port.

Differential cases: the metric catalog has the same names, kinds and
labels; ``Span.to_dict()`` and ``TraceBuffer.to_json()`` give the same
JSON; ``CompileWatch`` gives the same polls on the same count sequence;
the same virtual-clock traffic leaves the same counters in both
registries.  Every test builds its own ``MetricsRegistry``; threaded and
HTTP cases carry timeouts.
"""
import functools
import json
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import obs as robs  # noqa: E402
from repro.inference import ServingRuntime as RRuntime  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.inference import ForestServer, ServingRuntime  # noqa: E402
from repro_torch.obs import (METRIC_CATALOG, PHASES,  # noqa: E402
                             CompileWatch, MetricsRegistry, MetricsServer,
                             ServingMetrics, Span, TraceBuffer,
                             fn_cache_size, jit_cache_size, json_snapshot)
from test_torch_optim import port  # noqa: E402

CPU = "cpu"


def _forests(seed=0, trees=8, features=6):
    """A quantized forest in both packages (reference, port)."""
    f = rcore.random_forest_ir(n_trees=trees, n_leaves=8,
                               n_features=features, n_classes=3, seed=seed)
    rng = np.random.default_rng(seed)
    ref = rcore.quantize_forest(f, rng.normal(size=(128, features)))
    return ref, port(ref)


def _forest(seed=0, trees=8, features=6):
    return _forests(seed, trees, features)[1]


def _compile(forest, **kw):
    kw.setdefault("backend", "torch")
    return tcore.compile_forest(forest, device=CPU, **kw)


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


# --------------------------------------------------------------------------- #
# the catalog and the trace format, against the reference
# --------------------------------------------------------------------------- #
def test_metric_catalog_is_the_reference():
    """Same 13 names, in order, with the same kinds and label schemas."""
    assert list(METRIC_CATALOG) == list(robs.METRIC_CATALOG)
    assert len(METRIC_CATALOG) == 13
    for name, (kind, labels, help_) in METRIC_CATALOG.items():
        rkind, rlabels, _ = robs.METRIC_CATALOG[name]
        assert (kind, labels) == (rkind, rlabels), name
        assert help_
    # what the port counts as a compile event is said in its help text
    assert "XLA" not in METRIC_CATALOG["repro_compile_events_total"][2]


def test_materialized_catalog_matches_the_reference_registry():
    port_reg, ref_reg = MetricsRegistry(), robs.MetricsRegistry()
    ServingMetrics(port_reg)
    robs.ServingMetrics(ref_reg)
    assert port_reg.names() == ref_reg.names()
    strip = re.compile(r"^# HELP .*$", re.M)
    assert strip.sub("", port_reg.prometheus()) == \
        strip.sub("", ref_reg.prometheus())


@pytest.mark.parametrize("span_kw", [
    dict(rid=3, tenant="m", arrival_s=1.0, batch_size=4, bucket=8,
         phases={"queue_ms": 1.0, "compute_ms": 0.25}, total_ms=2.5),
    dict(rid=7, tenant="casc", arrival_s=0.5, exit_stage=2),
    dict(rid=1, tenant="m", arrival_s=0.0, batch_size=1, bucket=1,
         phases={"queue_ms": 0.0}, total_ms=None, ok=False,
         error="RuntimeError('qs_forward kernel launch failed')"),
], ids=["ok", "exit-stage", "error"])
def test_span_and_trace_json_are_the_reference(span_kw):
    d = Span(**span_kw).to_dict()
    assert d == robs.Span(**span_kw).to_dict()
    assert json.loads(json.dumps(d)) == d
    port_tb, ref_tb = TraceBuffer(cap=2), robs.TraceBuffer(cap=2)
    for i in range(3):
        kw = dict(span_kw, rid=span_kw["rid"] + i)
        port_tb.add(Span(**kw))
        ref_tb.add(robs.Span(**kw))
    assert port_tb.to_json() == ref_tb.to_json()
    assert port_tb.to_json(1) == ref_tb.to_json(1)
    assert PHASES == robs.PHASES


def test_trace_buffer_ring_bound_and_order():
    tb = TraceBuffer(cap=4)
    for i in range(10):
        tb.add(Span(rid=i, tenant="m", arrival_s=float(i)))
    assert len(tb) == 4
    assert tb.n_added == 10
    recent = tb.recent()
    assert [s["rid"] for s in recent] == [6, 7, 8, 9]
    assert [s["rid"] for s in tb.recent(2)] == [8, 9]
    assert json.loads(tb.to_json()) == recent
    tb.clear()
    assert len(tb) == 0
    with pytest.raises(ValueError):
        TraceBuffer(cap=0)


def test_span_to_dict_shape():
    s = Span(rid=3, tenant="m", arrival_s=1.0, batch_size=4, bucket=8,
             phases={"queue_ms": 1.0}, total_ms=2.5)
    d = s.to_dict()
    assert d["rid"] == 3 and d["bucket"] == 8 and d["ok"] is True
    assert "error" not in d
    assert json.loads(json.dumps(d)) == d


# --------------------------------------------------------------------------- #
# first-use detection
# --------------------------------------------------------------------------- #
class _FakePred:
    def __init__(self):
        self.size = 0

    def trace_cache_size(self):
        return self.size


def test_compile_watch_counts_growth_and_anomalies():
    p = _FakePred()
    w = CompileWatch(p)
    assert w.observable
    assert w.poll() == (0, 0)
    p.size = 2
    assert w.poll() == (2, 0)
    assert w.compiles_total == 2 and w.anomalies_total == 0
    w.mark_warm()
    p.size = 3
    assert w.poll() == (1, 1)
    assert w.anomalies_total == 1
    p.size = 0                         # deliberate reset
    assert w.poll() == (0, 0)
    p.size = 1
    assert w.poll() == (1, 1)


def test_compile_watch_polls_are_the_reference():
    """The same sequence of counts, marks and refreshes → the same polls
    and totals in both packages."""
    seq = [0, 2, "warm", 3, 3, 0, 1, "refresh", 4, 9, 2, 5]
    results = []
    for W in (CompileWatch, robs.CompileWatch):
        p = _FakePred()
        w = W(p)
        out = []
        for v in seq:
            if v == "warm":
                w.mark_warm()
            elif v == "refresh":
                w.refresh()
            else:
                p.size = v
                out.append(w.poll())
        results.append((out, w.compiles_total, w.anomalies_total))
    assert results[0] == results[1]


def test_compile_watch_unobservable_predictor_is_noop():
    w = CompileWatch(object())
    assert not w.observable
    assert w.poll() == (0, 0)
    assert fn_cache_size(lambda x: x) is None


def test_fn_cache_size_reads_cache_size_and_lru_caches():
    @functools.lru_cache(maxsize=None)
    def layout(n):
        return n * 2

    assert fn_cache_size(layout) == 0
    layout(1)
    layout(2)
    layout(1)
    assert fn_cache_size(layout) == 2

    class Jitted:
        def _cache_size(self):
            return 4

    class Broken:
        def _cache_size(self):
            raise RuntimeError("internal")

    assert fn_cache_size(Jitted()) == 4
    assert fn_cache_size(Broken()) is None

    class Scanned:                    # no method: _fn / _jit_cache scanned
        _fn = layout
        _jit_cache = {"a": Jitted(), "b": object()}

    assert jit_cache_size(Scanned()) == 6


@pytest.mark.parametrize("engine,backend", [
    ("bitvector", "torch"), ("rapidscorer", "torch"), ("bitvector", "cuda"),
    ("gemm", "cuda")])
def test_real_predictor_trace_cache_observed(engine, backend):
    """A new input shape is a first use: counted before warmup, an
    anomaly after ``mark_warm``; a shape seen before is neither."""
    qf = _forest()
    pred = _compile(qf, engine=engine, backend=backend)
    w = CompileWatch(pred)
    assert w.observable and pred.trace_cache_size() == 0
    pred.predict(np.zeros((4, qf.n_features_in)))
    compiles, anomalies = w.poll()
    assert compiles == 1 and anomalies == 0
    w.mark_warm()
    pred.predict(np.ones((4, qf.n_features_in)))      # same shape
    assert w.poll() == (0, 0)
    # a brand-new padded shape after mark_warm is an anomaly (kernel
    # predictors pad to block_b = 128 rows, so 4 and 100 rows are one)
    pred.predict(np.zeros((300, qf.n_features_in)))
    compiles, anomalies = w.poll()
    assert compiles == 1 and anomalies == 1


def test_cascade_trace_cache_size_sums_stages():
    from repro_torch.cascade import CascadeSpec, MarginGate
    qf = _forest(trees=8)
    spec = CascadeSpec(stages=(4, 8), policy=MarginGate(0.5))
    casc = _compile(qf, engine="bitvector", cascade=spec)
    before = casc.trace_cache_size()
    assert before == 0
    casc.predict(np.zeros((8, qf.n_features_in)))
    assert casc.trace_cache_size() > before
    assert casc.trace_cache_size() == sum(
        p.trace_cache_size() for p in casc.stage_predictors)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fused_cascade_count_shrinks_on_set_policy(backend):
    """The fused cascade counts the buckets its program ran; set_policy
    drops the program, the count shrinks, and ``CompileWatch``
    re-baselines instead of counting negative."""
    from repro_torch.cascade import CascadeSpec, MarginGate
    qf = _forest(trees=8)
    fspec = CascadeSpec(stages=(4, 8), policy=MarginGate(0.5), fused=True)
    fused = _compile(qf, engine="bitvector", backend=backend, cascade=fspec)
    w = CompileWatch(fused)
    fused.predict(np.zeros((8, qf.n_features_in)))
    fused.predict(np.zeros((300, qf.n_features_in)))
    grown = fused.trace_cache_size()
    assert grown == 2 and w.poll() == (2, 0)
    w.mark_warm()
    fused.set_policy(MarginGate(0.25))     # drops the fused program
    assert fused.trace_cache_size() < grown
    assert w.poll() == (0, 0)              # shrink re-baselines, no count
    fused.predict(np.zeros((8, qf.n_features_in)))
    assert w.poll() == (1, 1)              # growth from the new baseline


# --------------------------------------------------------------------------- #
# HTTP exposition
# --------------------------------------------------------------------------- #
def test_metrics_server_endpoints():
    reg = MetricsRegistry()
    reg.counter("repro_e_total", "h").inc(4)
    tb = TraceBuffer(cap=8)
    tb.add(Span(rid=1, tenant="m", arrival_s=0.0))
    with MetricsServer(reg, traces=tb,
                       extra=lambda: {"up": True}) as srv:
        assert srv.url.startswith("http://127.0.0.1:")
        status, text = _get(srv.url + "/metrics")
        assert status == 200 and "repro_e_total 4" in text
        for path in ("/metrics.json", "/snapshot"):
            _, body = _get(srv.url + path)
            snap = json.loads(body)
            assert snap["metrics"]["repro_e_total"]["samples"][0][
                "value"] == 4
            assert snap["stats"] == {"up": True}
        assert snap == json_snapshot(reg, lambda: {"up": True})
        _, body = _get(srv.url + "/traces?n=5")
        assert [s["rid"] for s in json.loads(body)] == [1]
        assert _get(srv.url + "/healthz") == (200, "ok")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url + "/nope")
        assert ei.value.code == 404
    srv.close()                       # idempotent
    MetricsServer(reg).close()        # closing a server never started


def test_metrics_server_without_traces_serves_an_empty_ring():
    with MetricsServer(MetricsRegistry()) as srv:
        assert _get(srv.url + "/traces") == (200, "[]")
        assert json.loads(_get(srv.url + "/metrics.json")[1]) == \
            {"metrics": {}}


# --------------------------------------------------------------------------- #
# serving integration
# --------------------------------------------------------------------------- #
def test_serving_metrics_catalog_materialized():
    reg = MetricsRegistry()
    sm = ServingMetrics(reg)
    assert set(reg.names()) == set(METRIC_CATALOG)
    assert sm.enabled and sm.requests_total is reg.get(
        "repro_requests_total")
    text = reg.prometheus()
    for name in METRIC_CATALOG:
        assert f"# TYPE {name} " in text


def test_runtime_spans_stats_and_metrics_manual_clock():
    qf = _forest(seed=1)
    pred = _compile(qf, engine="bitvector")
    reg = MetricsRegistry()
    rt = ServingRuntime(obs=reg)
    rt.add_model("m", pred, max_batch=8, max_wait_ms=1.0)
    rt.warmup()
    X = np.random.default_rng(0).normal(size=(6, qf.n_features_in))
    reqs = [rt.submit("m", X[i], arrival_s=0.001 * i) for i in range(6)]
    rt.flush(now_s=1.0)
    for r in reqs:
        assert r.span is not None
        assert r.span.batch_size == 6 and r.span.bucket == 8
        assert set(r.span.phases) == set(PHASES)
        assert r.span.total_ms == pytest.approx(r.latency_ms)
    assert rt.obs.traces.n_added == 6
    snap = reg.snapshot()

    def value(name):
        return snap[name]["samples"][0]["value"]

    assert value("repro_requests_total") == 6
    assert value("repro_batches_total") == 1
    assert snap["repro_latency_ms"]["samples"][0]["count"] == 6
    qsamples = {tuple(sorted(s["labels"].items())): s
                for s in snap["repro_phase_ms"]["samples"]}
    assert qsamples[(("phase", "queue_ms"), ("tenant", "m"))]["count"] == 6
    assert qsamples[(("phase", "compute_ms"), ("tenant", "m"))]["count"] == 1
    st = rt.stats("m")
    assert st["queue_depth"] == 0
    assert st["retrace_anomalies"] == 0
    assert st["compile_events"] == 0
    assert st["trace_cache_observable"]
    rt.close()


def test_runtime_retrace_anomaly_surfaces():
    qf = _forest(seed=2)
    pred = _compile(qf, engine="bitvector")
    reg = MetricsRegistry()
    rt = ServingRuntime(obs=reg)
    rt.add_model("m", pred, max_batch=4, max_wait_ms=1.0)
    rt.warmup()
    pred.predict(np.zeros((64, qf.n_features_in)))   # the leak
    rt.submit("m", np.zeros(qf.n_features_in), arrival_s=0.0)
    rt.flush(now_s=1.0)                # poll happens on the next batch
    st = rt.stats("m")
    assert st["retrace_anomalies"] == 1 and st["compile_events"] == 1
    (sample,) = reg.snapshot()["repro_retrace_anomalies_total"]["samples"]
    assert sample["value"] == 1
    rt.close()


def test_runtime_controller_decisions_exported():
    from repro_torch.inference import SLOConfig
    qf = _forest(seed=3)
    pred = _compile(qf, engine="bitvector")
    reg = MetricsRegistry()
    rt = ServingRuntime(obs=reg)
    rt.add_model("m", pred, max_batch=8, max_wait_ms=4.0,
                 slo=SLOConfig(target_p99_ms=1e9, window=4,
                               max_batch=8, max_wait_ms=4.0))
    rt.warmup()
    X = np.zeros((8, qf.n_features_in))
    for i in range(8):
        rt.submit("m", X[i], arrival_s=0.0)
    rt.flush(now_s=1.0)
    st = rt.stats("m")
    assert st["controller"]["n_decisions"] == 2
    assert st["controller"]["actions"]["grow"] == 2
    assert len(st["decisions"]) == 2
    assert st["decisions"][-1] == st["controller"]["last_decision"]
    snap = reg.snapshot()
    (d,) = snap["repro_controller_decisions_total"]["samples"]
    assert d["labels"] == {"tenant": "m", "action": "grow"}
    assert d["value"] == 2
    gauges = {s["labels"]["tenant"]: s["value"]
              for s in snap["repro_effective_max_batch"]["samples"]}
    assert gauges["m"] == st["effective_max_batch"]
    rt.close()


def test_runtime_error_path_counts_and_spans():
    """A failed launch resolves the batch with the error and counts it:
    nothing is sent through a plain version."""
    class Boom:
        def predict(self, X):
            raise RuntimeError("gemm_forward kernel launch failed: boom")

        def host_forest(self):
            return None

    reg = MetricsRegistry()
    rt = ServingRuntime(obs=reg)
    rt.add_model("m", Boom(), max_batch=4, max_wait_ms=1.0)
    r = rt.submit("m", np.zeros(3), arrival_s=0.0)
    rt.flush(now_s=1.0)
    with pytest.raises(RuntimeError, match="launch failed"):
        r.wait(timeout=5)
    assert r.span is not None and r.span.ok is False
    assert "boom" in r.span.error and r.result is None
    snap = reg.snapshot()
    assert snap["repro_request_errors_total"]["samples"][0]["value"] == 1
    assert snap["repro_requests_total"]["samples"][0]["value"] == 1
    rt.close()


def test_threaded_runtime_with_concurrent_scrape():
    qf = _forest(seed=4)
    pred = _compile(qf, engine="bitvector")
    reg = MetricsRegistry()
    rt = ServingRuntime(obs=reg)
    rt.add_model("m", pred, max_batch=16, max_wait_ms=0.5)
    rt.warmup()
    X = np.random.default_rng(1).normal(size=(32, qf.n_features_in))
    n_req = 200
    with rt:
        url = rt.serve_metrics().url
        assert rt.serve_metrics().url == url          # idempotent
        stop = threading.Event()
        errors, scrapes = [], []

        def scraper():
            while not stop.is_set():
                try:
                    scrapes.append(_get(url + "/metrics")[0])
                    _get(url + "/metrics.json")
                    _get(url + "/traces?n=4")
                except Exception as e:          # noqa: BLE001
                    errors.append(e)
                # a scraper that retakes the registry lock at once can
                # starve the worker's writers on a small machine
                time.sleep(1e-3)

        th = threading.Thread(target=scraper)
        th.start()
        reqs = [rt.submit("m", X[i % len(X)]) for i in range(n_req)]
        for r in reqs:
            r.wait(timeout=120)
        stop.set()
        th.join(timeout=30)
        assert not th.is_alive()
        status, text = _get(url + "/metrics")
    assert not errors and scrapes
    assert status == 200
    assert reg.get("repro_requests_total").labels(tenant="m").value == n_req
    assert rt.stats("m")["retrace_anomalies"] == 0
    with pytest.raises(Exception):
        _get(url + "/healthz", timeout=2)


def test_runtime_obs_disabled_has_no_instrumentation():
    qf = _forest(seed=5)
    pred = _compile(qf, engine="bitvector")
    rt = ServingRuntime(obs=False)
    rt.add_model("m", pred, max_batch=4, max_wait_ms=1.0)
    rt.warmup()
    r = rt.submit("m", np.zeros(qf.n_features_in), arrival_s=0.0)
    rt.flush(now_s=1.0)
    assert rt.obs is None
    assert r.span is None
    assert rt.tenant("m").watch is None
    with pytest.raises(RuntimeError):
        rt.serve_metrics()
    st = rt.stats("m")
    assert st["queue_depth"] == 0 and "retrace_anomalies" not in st
    rt.close()


@pytest.mark.parametrize("obs", ["registry", "serving_metrics", "default"])
def test_forest_server_phase_stats_and_obs(obs):
    from repro_torch.obs import get_registry, set_default_registry
    qf = _forest(seed=6)
    pred = _compile(qf, engine="bitvector")
    reg = MetricsRegistry()
    arg = {"registry": reg, "serving_metrics": ServingMetrics(reg),
           "default": True}[obs]
    old = set_default_registry(reg)
    try:
        srv = ForestServer(pred, max_batch=4, max_wait_ms=1.0, obs=arg,
                           obs_label="sync")
        X = np.random.default_rng(2).normal(size=(4, qf.n_features_in))
        for i in range(4):
            srv.submit(X[i], arrival_s=0.0)
        srv.flush(now_s=1.0)
        assert get_registry() is reg
    finally:
        set_default_registry(old)
    s = srv.stats.summary()
    assert s["compute_p50_ms"] >= 0.0 and s["sync_p50_ms"] >= 0.0
    snap = reg.snapshot()
    (c,) = snap["repro_requests_total"]["samples"]
    assert c["labels"] == {"tenant": "sync"} and c["value"] == 4
    (b,) = snap["repro_batches_total"]["samples"]
    assert b["value"] == 1


def test_forest_server_cascade_exits_counted():
    from repro_torch.cascade import CascadeSpec, MarginGate
    qf = _forest(seed=6)
    casc = _compile(qf, engine="bitvector", cascade=CascadeSpec(
        (4, 8), MarginGate(0.5)))
    reg = MetricsRegistry()
    srv = ForestServer(casc, max_batch=16, obs=reg)
    X = np.random.default_rng(3).normal(size=(16, qf.n_features_in))
    for x in X:
        srv.submit(x, arrival_s=0.0)
    srv.flush(now_s=1.0)
    samples = reg.snapshot()["repro_cascade_stage_exits_total"]["samples"]
    assert sum(s["value"] for s in samples) == 16
    assert {s["labels"]["stage"] for s in samples} <= {"0", "1"}


def _counters(reg) -> dict:
    """The registry's request/batch/decision/exit counters by label set,
    and each histogram's sample count — what does not depend on the
    host clock."""
    out = {}
    for name, fam in reg.snapshot().items():
        for s in fam["samples"]:
            key = (name, tuple(sorted(s["labels"].items())))
            if fam["type"] == "counter" and "compile" not in name \
                    and "retrace" not in name:
                out[key] = s["value"]
            elif fam["type"] == "histogram" and name != "repro_latency_ms":
                out[key] = s["count"]
    return out


def test_virtual_clock_traffic_leaves_the_reference_counters():
    """The same virtual-clock traffic on a plain tenant and a staged
    cascade tenant leaves the same counters (requests, batches, batch
    sizes, phase sample counts, cascade exits) in both registries."""
    from repro import cascade as rc
    from repro_torch.cascade import CascadeSpec, MarginGate
    ref_f, port_f = _forests(seed=7)
    regs = []
    for RT, reg, plain, casc in (
            (ServingRuntime, MetricsRegistry(), _compile(port_f),
             _compile(port_f, cascade=CascadeSpec((4, 8), MarginGate(0.5)))),
            (RRuntime, robs.MetricsRegistry(),
             rcore.compile_forest(ref_f),
             rcore.compile_forest(ref_f, cascade=rc.CascadeSpec(
                 (4, 8), rc.MarginGate(0.5))))):
        rt = RT(obs=reg)
        rt.add_model("m", plain, max_batch=5, max_wait_ms=1.0)
        rt.add_model("casc", casc, max_batch=7, max_wait_ms=2.0)
        X = np.random.default_rng(5).normal(size=(30, 6))
        for i, x in enumerate(X):
            rt.submit("m" if i % 3 else "casc", x, arrival_s=i * 4e-4)
            rt.pump(now_s=i * 4e-4)
        rt.flush(now_s=1.0)
        regs.append(reg)
    got, want = _counters(regs[0]), _counters(regs[1])
    assert got == want
    assert got[("repro_requests_total", (("tenant", "m"),))] == 20
