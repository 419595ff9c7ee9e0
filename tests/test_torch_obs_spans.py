"""In-program spans (``repro_torch.obs.trace`` ``begin``/``end``/``span``):
off they keep nothing and never reach the profiler; on, one ``predict``
of the kernel predictor and of both fused-cascade tiers gives one root
span and its children, nested under one call id, with one ``d2h`` span
per host sync; a running profiler carries each span on the same clock;
the buffer counts what it drops.  All on the CPU (the kernels' plain
versions)."""
import importlib.util
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.cascade import CascadeSpec, MarginGate
from repro_torch.obs import trace

ROOT = Path(__file__).resolve().parents[1]
CHILDREN = {"repro_torch.transform", "repro_torch.pad", "repro_torch.h2d",
            "repro_torch.launch", "repro_torch.d2h", "repro_torch.descale"}


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off and an empty buffer."""
    trace.enable(False)
    trace.drain()
    yield
    trace.enable(False)
    trace.drain()


@pytest.fixture(scope="module")
def qforest():
    """A small quantized two-class forest and rows for it."""
    rng = np.random.default_rng(0)
    forest = core.random_forest_ir(24, 16, 8, n_classes=2, seed=3)
    X = rng.normal(size=(200, 8)).astype(np.float32)
    return core.quantize_forest(forest, X, core.QuantSpec(
        bits=16, int_accum=True)), X


def _kernel(qf, engine="bitvector"):
    return core.compile_forest(qf, engine=engine, backend="cuda",
                               device="cpu")


def _fused(qf, backend):
    return core.compile_forest(qf, engine="bitvector", backend=backend,
                               device="cpu", cascade=CascadeSpec(
                                   (6, 12, 24), MarginGate(float("inf")),
                                   fused=True))


def _one_call(spans):
    """(root, children) of the spans of one call, checked to nest."""
    roots = [s for s in spans if s["parent"] is None]
    assert len(roots) == 1
    root = roots[0]
    assert root["name"] == "repro_torch.predict"
    assert {s["call"] for s in spans} == {root["id"]}
    children = [s for s in spans if s is not root]
    assert all(s["parent"] == root["id"] for s in children)
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
    for s in children:
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= root["end_ns"]
    return root, children


class _CountingRecordFunction:
    """Stands in for ``torch.profiler.record_function``: counts entries."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1

    def __exit__(self, *exc):
        return None


def test_off_keeps_nothing_and_never_enters_the_profiler(qforest,
                                                         monkeypatch):
    qf, X = qforest
    monkeypatch.setattr(_CountingRecordFunction, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function",
                        _CountingRecordFunction)
    preds = [_kernel(qf), _fused(qf, "torch"), _fused(qf, "cuda")]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for pred in preds:
            pred.predict(X[:50])
    assert not trace.enabled()
    assert trace.begin("repro_torch.predict") is None
    assert trace.drain() == []
    assert _CountingRecordFunction.entered == 0


@pytest.mark.parametrize("engine", ["bitvector", "bitmm", "gemm"])
def test_kernel_predictor_call_is_one_root_and_six_children(qforest,
                                                            engine):
    qf, X = qforest
    pred = _kernel(qf, engine)
    want = pred.predict(X[:50])
    trace.enable()
    np.testing.assert_array_equal(pred.predict(X[:50]), want)
    root, children = _one_call(trace.drain())
    assert [s["name"] for s in children] == [
        "repro_torch.transform", "repro_torch.pad", "repro_torch.h2d",
        "repro_torch.launch", "repro_torch.d2h", "repro_torch.descale"]
    by = {s["name"]: s for s in children}
    assert root["rows"] == 50
    assert by["repro_torch.pad"]["rows"] == 50
    assert by["repro_torch.pad"]["padded_rows"] == pred.block_b
    assert by["repro_torch.h2d"]["nbytes"] == pred.block_b * 8 * 4
    assert by["repro_torch.d2h"]["nbytes"] == 50 * 2 * 4


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fused_cascade_call_nests_and_counts_its_host_syncs(qforest,
                                                            backend):
    qf, X = qforest
    pred = _fused(qf, backend)
    assert pred._use_kernel == (backend == "cuda")
    want = pred.predict(X[:50])
    trace.enable()
    np.testing.assert_array_equal(pred.predict(X[:50]), want)
    root, children = _one_call(trace.drain())
    names = [s["name"] for s in children]
    assert set(names) <= CHILDREN
    assert names[:3] == ["repro_torch.transform", "repro_torch.pad",
                         "repro_torch.h2d"]
    assert names.count("repro_torch.d2h") == pred.host_syncs
    assert names[-1] == "repro_torch.d2h"
    # the tier that reads every gate launches once a stage
    assert names.count("repro_torch.launch") == pred.host_syncs
    by = {s["name"]: s for s in children}
    assert by["repro_torch.pad"]["rows"] == 50
    assert by["repro_torch.pad"]["padded_rows"] >= 50


def test_kernel_tier_reads_scores_and_counts_in_one_copy(qforest):
    qf, X = qforest
    pred = core.compile_forest(qf, engine="bitvector", backend="cuda",
                               device="cpu", cascade=CascadeSpec(
                                   (6, 12, 24), MarginGate(0.3), fused=True))
    staged = core.compile_forest(qf, engine="bitvector", backend="torch",
                                 device="cpu", cascade=CascadeSpec(
                                     (6, 12, 24), MarginGate(0.3)))
    trace.enable()
    out = pred.predict(X)
    spans = trace.drain()
    np.testing.assert_array_equal(out, staged.predict(X))
    np.testing.assert_array_equal(pred.last_exit_counts,
                                  staged.last_exit_counts)
    assert 0 < pred.last_exit_counts[0] < len(X)
    d2h = [s for s in spans if s["name"] == "repro_torch.d2h"]
    assert pred.host_syncs == 1 and len(d2h) == 1
    assert d2h[0]["nbytes"] == (len(X) * 2 + 3) * 4


def test_compile_arrays_spans_each_host_build(qforest):
    qf, X = qforest
    trace.enable()
    for engine in ("bitvector", "bitmm", "gemm"):
        _kernel(qf, engine)
    built = trace.drain()
    assert [s["name"] for s in built] == ["repro_torch.compile_arrays"] * 3
    pred = _fused(qf, "cuda")
    # one build per stage predictor, then the fused kernel's own build on
    # the first predict, inside that call
    assert [s["name"] for s in trace.drain()] == \
        ["repro_torch.compile_arrays"] * 3
    pred.predict(X[:10])
    first = trace.drain()
    lazy = [s for s in first if s["name"] == "repro_torch.compile_arrays"]
    assert len(lazy) == 1
    _one_call(first)
    pred.predict(X[:10])
    assert "repro_torch.compile_arrays" not in {
        s["name"] for s in trace.drain()}


def test_profiler_carries_each_span_on_the_same_clock(qforest):
    qf, X = qforest
    pred = _kernel(qf)
    pred.predict(X[:50])
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            pred.predict(X[:50])
    spans = trace.drain()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    assert len(spans) == 14
    assert all(len(events[s["name"]]) == 2 for s in spans)
    last = max(s["call"] for s in spans)       # the warm second call
    for s in (s for s in spans if s["call"] == last):
        # the span's own event: the same name, the nearest start
        a, b = min(events[s["name"]],
                   key=lambda ab: abs(ab[0] - s["start_ns"]))
        # the record covers the profiler's event, within 1 ms each side
        assert 0 <= a - s["start_ns"] < 1_000_000
        assert 0 <= s["end_ns"] - b < 1_000_000


def test_buffer_bound_counts_drops(monkeypatch):
    monkeypatch.setattr(trace, "_CAPACITY", 3)
    trace.enable()
    before = trace.dropped()
    for _ in range(5):
        trace.end(trace.begin("repro_torch.launch"))
    assert len(trace.drain()) == 3
    assert trace.dropped() - before == 2
    trace.end(trace.begin("repro_torch.launch"))
    assert len(trace.drain()) == 1


def test_a_raise_leaves_no_span_open(qforest):
    qf, X = qforest
    pred = _kernel(qf)
    trace.enable()
    # a raise inside a child: the root closes it, and it is not recorded
    with pytest.raises(ValueError):
        pred.predict(X[:5, :2])
    assert [s["name"] for s in trace.drain()] == ["repro_torch.predict"]
    # the width check raises outside any root and closes its own span
    with pytest.raises(ValueError, match="width"):
        pred.predict_transformed(np.zeros((5, 2), dtype=np.float32))
    assert [s["name"] for s in trace.drain()] == ["repro_torch.pad"]
    pred.predict(X[:5])
    _one_call(trace.drain())


def test_spans_nest_per_thread(qforest):
    qf, X = qforest
    preds = [_kernel(qf), _fused(qf, "cuda")]
    for p in preds:
        p.predict(X[:20])
    trace.enable()
    errors = []

    def work(pred):
        try:
            for _ in range(20):
                pred.predict(X[:20])
        except Exception as exc:          # reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(p,)) for p in preds]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    spans = trace.drain()
    calls = {}
    for s in spans:
        calls.setdefault(s["call"], []).append(s)
    assert len(calls) == 40
    for group in calls.values():
        _one_call(group)


def _report_script():
    spec = importlib.util.spec_from_file_location(
        "torch_span_report", ROOT / "scripts" / "torch_span_report.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_idle_in_spans_intersects_intervals():
    rep = _report_script()
    # the card busy over [10, 30] and [50, 60] of a window [0, 100]; the
    # call thread (1) in transform over [0, 40], in pad over [40, 55];
    # another thread's transform does not count
    events = [(10, 30, "k", True, 9), (50, 60, "k", True, 9),
              (0, 40, "repro_torch.transform", False, 1),
              (40, 55, "repro_torch.pad", False, 1),
              (60, 90, "repro_torch.transform", False, 2)]
    assert rep.idle_in_spans(events, (0, 100), 1) == {
        "pad": 10.0, "transform": 20.0}


def test_per_call_reads_a_childs_children():
    """The card path's copy nests inside ``transform``: the report keeps it
    out of the glue and the coverage, and reads it as ``transform.h2d``."""
    rep = _report_script()

    def span(i, name, a, b, parent):
        return {"id": i, "name": "repro_torch." + name, "start_ns": a,
                "end_ns": b, "parent": parent, "call": 1, "rows": 8}
    spans = [span(1, "predict", 0, 10_000_000, None),
             span(2, "transform", 0, 4_000_000, 1),
             span(3, "h2d", 1_000_000, 3_000_000, 2),
             span(4, "launch", 4_000_000, 5_000_000, 1),
             span(5, "d2h", 5_000_000, 10_000_000, 1)]
    r = rep.per_call(spans)
    assert r["ms_per_call"]["transform.h2d"] == 2.0
    assert "h2d" not in r["ms_per_call"]
    assert r["glue_ms_per_call"] == 1.0 and r["coverage"] == 1.0


def test_span_report_runs_a_tiny_cell(tmp_path):
    from chipbench.tests.tiny import tiny_root
    rep = _report_script()
    root, manifest = tiny_root(tmp_path)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    r = rep.report("magic_rf_512x64_cascade.bulk", 2 ** 31 + 7, 0.2, 0.1,
                   "cpu", 1, root=root)
    assert r["host_syncs_per_call"] == 1.0 and r["dropped"] == 0
    assert r["calls"] > 0 and 0.5 < r["coverage"] <= 1.0
    assert r["compile_arrays_s"]["build"] > 0
    assert r["compile_arrays_s"]["warmup"] > 0     # the fused kernel's own
    assert {"transform", "pad", "h2d", "launch", "d2h", "predict"} <= set(
        r["ms_per_call"])
    assert set(r["calls_per_s"]) == {"off", "on", "profiled_off",
                                     "profiled"}
    assert r["profiled"]["ms_per_call"]["transform"] > 0
    assert r["profiled"]["summary"]["window_s"] > 0


def test_spans_under_thread_contention_lose_no_record(monkeypatch):
    """More threads than cores and a short switch interval: every span is
    kept or counted as dropped, and every kept child names its own
    thread's root."""
    monkeypatch.setattr(trace, "_CAPACITY", 1000)
    n_threads, n_calls = 12, 200
    trace.enable()
    before = trace.dropped()

    def work(k):
        for _ in range(n_calls):
            r = trace.begin("repro_torch.predict")
            trace.end(trace.begin("repro_torch.launch"), rows=k)
            trace.end(r, rows=k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = trace.drain()
    assert len(spans) == 1000
    assert len(spans) + trace.dropped() - before == n_threads * n_calls * 2
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["parent"] is not None:
            assert s["call"] == s["parent"]
            root = by_id.get(s["parent"])
            assert root is None or root["rows"] == s["rows"]


@pytest.mark.parametrize("rows, copied", [
    ("uint8", True), ("column-slice", True), ("f32", False),
    ("columns", False), ("f64", False)])
@pytest.mark.parametrize("kind", ["kernel", "fused"])
def test_host_copy_spans_the_card_paths_host_copies(qforest, kind, rows,
                                                    copied):
    """On the card path (an ``InputGrid``; plain versions on the CPU), a
    ``host_copy`` span inside ``transform`` and before ``h2d`` times the
    host's widening of 8-bit rows to float64 and its copy of a block of
    a column-major array; rows the card reads as they are get none."""
    from repro_torch.kernels import ops
    qf, X = qforest
    pred = _kernel(qf) if kind == "kernel" else _fused(qf, "cuda")
    grid = ops.InputGrid(pred.forest, torch.device("cpu"))
    if kind == "kernel":
        pred.grid = grid
    else:
        pred._grid = grid
    n = 50
    X = {"uint8": np.random.default_rng(1).integers(
             0, 256, size=(n, 8)).astype(np.uint8),
         "column-slice": np.asfortranarray(X[:n + 5])[:n],
         "f32": X[:n], "columns": np.asfortranarray(X[:n]),
         "f64": X[:n].astype(np.float64)}[rows]
    trace.enable()
    pred.predict(X)
    spans = trace.drain()
    by = {s["name"]: s for s in spans}
    assert "repro_torch.pad" not in by
    if not copied:
        assert "repro_torch.host_copy" not in by
        return
    copy, h2d = by["repro_torch.host_copy"], by["repro_torch.h2d"]
    assert [s["name"] for s in spans].count("repro_torch.host_copy") == 1
    assert copy["parent"] == h2d["parent"] == by["repro_torch.transform"]["id"]
    assert copy["end_ns"] <= h2d["start_ns"]
    assert copy["rows"] == n
    # widened: 8 bytes a value; a column-major block keeps its f32
    assert copy["nbytes"] == n * 8 * (8 if rows == "uint8" else 4)
