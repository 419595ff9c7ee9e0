"""The port's concurrent serving runtime (``repro_torch.inference.runtime``)
against the reference's ``repro.inference.runtime``, and the reference's
own ``tests/test_runtime.py`` cases on the port.

Differential cases send the same forests, rows and arrival times through
both packages: the same latency trace gives the same controller
decisions, the same virtual-clock arrivals under ``pump``/``flush`` give
the same batches (request ids) and effective knobs, served scores on
int-accum forests are array-equal, and a fleet the reference saved loads
in the port and serves the same scores.  The port runs on
``device="cpu"`` (the ``cuda`` backend there runs each kernel's plain
version).  Threaded cases wait with timeouts, so none can hang the suite.
"""
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.inference import ServingRuntime as RRuntime  # noqa: E402
from repro.inference import SLOConfig as RSLO  # noqa: E402
from repro.inference.runtime import (  # noqa: E402
    AdaptiveBatchController as RController)
from repro_torch import core as tcore  # noqa: E402
from repro_torch.inference import (AdaptiveBatchController,  # noqa: E402
                                   ForestServer, Reservoir, ServingRuntime,
                                   SLOConfig)
from repro_torch.inference.server import ServerStats  # noqa: E402
from test_torch_optim import port  # noqa: E402

CPU = "cpu"
INT_ACCUM = dict(bits=16, int_accum=True)
# (engine, backend) of the port, each against the reference's jax engine
PORT_ENGINES = [("bitvector", "torch"), ("bitmm", "torch"),
                ("native", "torch"), ("gemm", "torch"),
                ("rapidscorer", "torch"), ("bitvector", "cuda"),
                ("bitmm", "cuda"), ("gemm", "cuda")]


def _ids(e):
    return "-".join(e)


@pytest.fixture(scope="module")
def qpred_pair():
    """Two quantized forests (distinct shapes so tenant routing mistakes
    can't alias), as the reference's fixture, with port predictors."""
    rng = np.random.default_rng(0)
    fa = rcore.random_forest_ir(n_trees=8, n_leaves=16, n_features=6,
                                n_classes=2, seed=0)
    fb = rcore.random_forest_ir(n_trees=12, n_leaves=16, n_features=6,
                                n_classes=3, seed=1)
    qa = port(rcore.quantize_forest(fa, rng.normal(size=(64, 6))))
    qb = port(rcore.quantize_forest(fb, rng.normal(size=(64, 6))))
    return (qa, tcore.compile_forest(qa, engine="bitvector",
                                     backend="torch", device=CPU),
            qb, tcore.compile_forest(qb, engine="bitmm", backend="torch",
                                     device=CPU))


@pytest.fixture(scope="module")
def int_pair():
    """One int-accum forest in both packages (reference, port)."""
    f = rcore.random_forest_ir(n_trees=10, n_leaves=16, n_features=6,
                               n_classes=3, seed=2)
    X = np.random.default_rng(2).normal(size=(128, 6))
    ref = rcore.quantize_forest(f, X, rcore.QuantSpec(**INT_ACCUM))
    return ref, port(ref)


def compile_port(forest, engine="bitvector", backend="torch", **kw):
    return tcore.compile_forest(forest, engine=engine, backend=backend,
                                device=CPU, **kw)


# --------------------------------------------------------------------------- #
# Reservoir (bounded ServerStats)
# --------------------------------------------------------------------------- #
def test_reservoir_exact_below_cap():
    r = Reservoir(cap=100)
    r.extend(float(i) for i in range(50))
    assert len(r) == 50 and r.n == 50
    assert list(r) == [float(i) for i in range(50)]
    assert r.mean() == pytest.approx(24.5)
    assert r.percentile(50) == pytest.approx(24.5)


def test_reservoir_bounded_memory_many_records():
    """A long run must not hold every float — retained storage is capped
    while count/sum stay exact."""
    r = Reservoir(cap=512)
    n = 200_000
    for _ in range(n):
        r.append(1.0)
    assert r.n == n
    assert len(r) == 512 and len(r._sample) == 512
    assert r.mean() == pytest.approx(1.0)
    assert r.percentile(99) == pytest.approx(1.0)


def test_reservoir_sample_matches_the_reference():
    """Seeded Algorithm R keeps the same sample as the reference's."""
    from repro.inference.server import Reservoir as RReservoir
    vals = list(np.linspace(0.0, 100.0, 10_000))
    a, b = Reservoir(cap=64, seed=3), RReservoir(cap=64, seed=3)
    a.extend(vals)
    b.extend(vals)
    assert list(a) == list(b)
    assert 20.0 < a.percentile(50) < 80.0


def test_reservoir_list_equality_and_empty():
    r = Reservoir()
    assert r == [] and not r
    assert ServerStats().batch_sizes == []
    r.append(2.0)
    assert r == [2.0] and bool(r)
    assert np.asarray(r).tolist() == [2.0]
    with pytest.raises(ValueError):
        Reservoir(cap=0)


def test_server_stats_summary_uses_exact_mean():
    st = ServerStats()
    for _ in range(st.batch_sizes.cap + 100):      # overflow the reservoir
        st.batch_sizes.append(4.0)
    assert st.summary()["mean_batch"] == pytest.approx(4.0)


def test_submit_default_clock_is_monotonic_not_wall(qpred_pair):
    _, pa, *_ = qpred_pair
    srv = ForestServer(pa, max_batch=8, max_wait_ms=1.0)
    req = srv.submit(np.zeros(6))
    assert abs(req.arrival_s - time.perf_counter()) < 5.0
    assert abs(req.arrival_s - time.time()) > 1e6


class _TensorPredictor:
    """Hands back a torch tensor, as a predictor on the card could."""

    def __init__(self, inner):
        self.inner = inner

    def predict(self, X):
        return torch.from_numpy(self.inner.predict(X))

    def host_forest(self):
        return self.inner.host_forest()


def test_runtime_brings_tensor_scores_to_the_host(qpred_pair):
    qa, pa, *_ = qpred_pair
    X = np.random.default_rng(8).normal(size=(5, qa.n_features))
    rt = ServingRuntime(obs=False)
    rt.add_model("m", _TensorPredictor(pa), max_batch=4, max_wait_ms=1.0)
    reqs = [rt.submit("m", x, arrival_s=0.0) for x in X]
    rt.flush(now_s=1.0)
    assert all(isinstance(r.result, np.ndarray) for r in reqs)
    np.testing.assert_array_equal(np.stack([r.result for r in reqs]),
                                  pa.predict(X))


# --------------------------------------------------------------------------- #
# Adaptive batching controller
# --------------------------------------------------------------------------- #
def test_controller_shrinks_on_violation_grows_on_headroom():
    slo = SLOConfig(target_p99_ms=10.0, window=8, min_batch=2,
                    max_batch=64, min_wait_ms=0.5, max_wait_ms=8.0)
    c = AdaptiveBatchController(slo, batch=64, wait_ms=8.0)
    for _ in range(8):
        c.observe(50.0)                            # way over budget
    assert c.decisions[-1]["action"] == "shrink"
    assert c.max_batch == 32 and c.max_wait_ms == 4.0
    for _ in range(5):                             # shrink to the floor
        for _ in range(8):
            c.observe(50.0)
    assert c.max_batch == 2 and c.max_wait_ms == 0.5
    for _ in range(8):
        c.observe(1.0)                             # far under budget
    assert c.decisions[-1]["action"] == "grow"
    assert c.max_batch == 3 and c.max_wait_ms == pytest.approx(0.625)
    for _ in range(40):                            # grow to the ceiling
        for _ in range(8):
            c.observe(1.0)
    assert c.max_batch == 64 and c.max_wait_ms == 8.0


def test_controller_holds_inside_band_and_is_deterministic():
    slo = SLOConfig(target_p99_ms=10.0, window=4, headroom=0.7,
                    max_batch=32, max_wait_ms=4.0)
    runs = []
    for _ in range(2):
        c = AdaptiveBatchController(slo, batch=16, wait_ms=2.0)
        trace = [8.0] * 4 + [20.0] * 4 + [1.0] * 4 + [9.0] * 4
        for v in trace:
            c.observe(v)
        runs.append([d["action"] for d in c.decisions])
    assert runs[0] == runs[1]
    assert runs[0] == ["hold", "shrink", "grow", "hold"]


def test_controller_partial_window_no_decision_and_none_ignored():
    c = AdaptiveBatchController(SLOConfig(target_p99_ms=5.0, window=16),
                                batch=8, wait_ms=2.0)
    for _ in range(15):
        assert c.observe(3.0) is None
    assert c.observe(None) is None
    assert c.observe(3.0) is not None


def test_controller_rejects_empty_bounds():
    with pytest.raises(ValueError, match="batch bounds"):
        AdaptiveBatchController(
            SLOConfig(target_p99_ms=5.0, min_batch=16, max_batch=8),
            batch=8, wait_ms=1.0)
    with pytest.raises(ValueError, match="wait bounds"):
        AdaptiveBatchController(
            SLOConfig(target_p99_ms=5.0, min_wait_ms=4.0, max_wait_ms=1.0),
            batch=8, wait_ms=1.0)


_STREAMS = {
    "over": lambda rng: np.full(96, 1e6),
    "under": lambda rng: np.full(96, 0.0),
    "exponential": lambda rng: rng.exponential(5.0, size=400),
    "oscillating": lambda rng: np.tile([0.0, 1e6], 200),
    "lognormal": lambda rng: rng.lognormal(1.5, 0.8, size=400),
}


@pytest.mark.parametrize("stream", sorted(_STREAMS))
@pytest.mark.parametrize("slo_kw", [
    dict(target_p99_ms=5.0, window=4, min_batch=2, max_batch=128,
         min_wait_ms=0.25, max_wait_ms=16.0),
    dict(target_p99_ms=8.0, window=16, headroom=0.5, grow=1.5,
         shrink=0.75, max_wait_ms=0.0),
], ids=["bounded", "zero-wait"])
def test_controller_decisions_match_the_reference(stream, slo_kw):
    """The same latency trace gives the same decision records (action,
    p99, knobs) in both packages, and the knobs never leave the bounds."""
    rng = np.random.default_rng(len(stream))
    trace = [float(v) for v in _STREAMS[stream](rng)] + [None]
    port_c = AdaptiveBatchController(SLOConfig(**slo_kw), batch=64,
                                     wait_ms=8.0 if slo_kw.get(
                                         "max_wait_ms") else 0.0)
    ref_c = RController(RSLO(**slo_kw), batch=64,
                        wait_ms=8.0 if slo_kw.get("max_wait_ms") else 0.0)
    for v in trace:
        assert port_c.observe(v) == ref_c.observe(v)
        assert port_c.min_batch <= port_c.max_batch <= port_c.max_batch_bound
        assert port_c.min_wait_ms <= port_c.max_wait_ms \
            <= port_c.max_wait_ms_bound
    assert port_c.decisions == ref_c.decisions and port_c.decisions


class _SteppedTime:
    """A runtime module's ``time`` whose ``perf_counter`` advances a fixed
    step a call, so a batch's compute time (``t_sync - t0``, three calls
    apart in both packages) is virtual and the same in both; the rest is
    the real module."""

    def __init__(self, step_s: float):
        self.now, self.step = 0.0, step_s

    def perf_counter(self) -> float:
        self.now += self.step
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def virtual_compute(monkeypatch):
    """Both runtimes' batches take a virtual 0.3 ms (three 0.1 ms steps):
    with the host's real compute time in the latencies, a loaded machine
    moved the controller's knobs in one package and not the other."""
    from repro.inference import runtime as ref_runtime
    from repro_torch.inference import runtime as port_runtime
    for mod in (ref_runtime, port_runtime):
        monkeypatch.setattr(mod, "time", _SteppedTime(1e-4))


def _virtual_run(pkg_rt, slo, pred, X, arrivals, pump_delay):
    """Submit X at ``arrivals`` (virtual seconds), pump ``pump_delay``
    after each; returns ([rids per batch], [knobs after each pump],
    served rows)."""
    rt = pkg_rt(clock=lambda: 0.0)
    rt.add_model("m", pred, max_batch=4, max_wait_ms=2.0, slo=slo)
    rt.warmup()              # no first-use time in a latency (jit compile)
    batches, knobs, reqs = [], [], []
    for i, at in enumerate(arrivals):
        reqs.append(rt.submit("m", X[i], arrival_s=float(at)))
        done = rt.pump(now_s=float(at) + pump_delay)
        batches.extend(_batches_of(done))
        b = rt.tenant("m").batcher
        knobs.append((b.max_batch, b.max_wait_ms))
    batches.extend(_batches_of(rt.flush(now_s=1e3)))
    return batches, knobs, np.stack([r.result for r in reqs])


def _batches_of(done):
    """Completed requests → rid lists per batch (a batch shares done_s)."""
    out = {}
    for r in done:
        out.setdefault(r.done_s, []).append(r.rid)
    return sorted(out.values())


@pytest.mark.parametrize("scenario", [
    # every request waits 60 virtual ms: far over the budget → shrink
    dict(target=0.5, gap=0.01, delay=0.06, burst=1),
    # bursts of 5, far under a huge budget → grow (bigger batches)
    dict(target=1e6, gap=0.0005, delay=0.0, burst=5),
    # 30 virtual ms each, inside [0.7, 1] of a 40 ms budget → hold
    dict(target=40.0, gap=0.01, delay=0.03, burst=1),
    # bursts of 3 pumped 30 ms late against a 2 ms budget → shrink
    dict(target=2.0, gap=0.004, delay=0.03, burst=3),
], ids=["shrink", "grow", "hold", "bursts"])
def test_virtual_clock_batches_and_knobs_match_the_reference(
        int_pair, scenario, virtual_compute):
    """The same virtual arrivals under ``pump``/``flush`` give the same
    batches (request ids), the same effective knobs after every pump and
    array-equal scores in both packages; each batch's compute time is
    virtual too (``virtual_compute``)."""
    ref_f, port_f = int_pair
    n = 40
    X = np.random.default_rng(9).normal(size=(n, 6))
    arrivals = np.repeat(np.arange(n // scenario["burst"] + 1)
                         * scenario["gap"] * scenario["burst"],
                         scenario["burst"])[:n]
    kw = dict(target_p99_ms=scenario["target"], window=4, min_batch=1,
              max_batch=32, min_wait_ms=0.1, max_wait_ms=50.0)
    got = _virtual_run(ServingRuntime, SLOConfig(**kw),
                       compile_port(port_f), X, arrivals, scenario["delay"])
    want = _virtual_run(RRuntime, RSLO(**kw),
                        rcore.compile_forest(ref_f, engine="bitvector"), X,
                        arrivals, scenario["delay"])
    assert got[0] == want[0]
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    # the knobs moved (or, holding, stayed) as the scenario intends
    moved = {k for k in got[1]} != {(4, 2.0)}
    assert moved == (scenario["target"] != 40.0)


def test_adaptive_runtime_virtual_clock_deterministic(qpred_pair):
    qa, pa, *_ = qpred_pair
    slo = SLOConfig(target_p99_ms=0.5, window=4, min_batch=1,
                    max_batch=8, min_wait_ms=0.1, max_wait_ms=50.0)

    def run_once():
        rt = ServingRuntime(clock=lambda: 0.0)
        rt.add_model("m", pa, max_batch=8, max_wait_ms=50.0, slo=slo)
        X = np.zeros((32, qa.n_features))
        eff = []
        for i in range(32):
            rt.submit("m", X[i], arrival_s=i * 0.01)
            rt.pump(now_s=i * 0.01 + 0.06)
            eff.append((rt.tenant("m").batcher.max_wait_ms,
                        rt.tenant("m").batcher.max_batch))
        rt.flush(now_s=10.0)
        return eff

    a, b = run_once(), run_once()
    assert a == b
    waits = [w for w, _ in a]
    assert waits[-1] < waits[0]
    assert all(0.1 <= w <= 50.0 for w in waits)
    assert all(1 <= mb <= 8 for _, mb in a)


# --------------------------------------------------------------------------- #
# Warmup
# --------------------------------------------------------------------------- #
def test_warmup_covers_ladder_and_freezes_trace_count(qpred_pair):
    qa, _, *_ = qpred_pair
    pred = compile_port(qa)                    # fresh shape set
    rt = ServingRuntime()
    rt.add_model("m", pred, max_batch=13, max_wait_ms=1.0)
    assert rt.warmup() == {"m": [1, 2, 4, 8, 16]}
    assert pred.trace_cache_size() == 5
    X = np.random.default_rng(0).normal(size=(40, qa.n_features))
    for i in range(40):
        rt.submit("m", X[i], arrival_s=i * 1e-4)
        rt.pump(now_s=i * 1e-4)
    rt.flush(now_s=1.0)
    assert pred.trace_cache_size() == 5
    assert rt.summary("m")["n_requests"] == 40


def _tenant(kind, forest):
    from repro_torch.cascade import CascadeSpec, MarginGate
    if kind.startswith("fused"):
        backend = kind.split("-")[1]
        return compile_port(forest, backend=backend, cascade=CascadeSpec(
            (4, 10), MarginGate(0.5), fused=True))
    engine, backend = kind.split("-")
    return compile_port(forest, engine=engine, backend=backend)


@pytest.mark.parametrize("kind", [
    "bitvector-torch", "gemm-torch", "rapidscorer-torch", "bitvector-cuda",
    "bitmm-cuda", "fused-torch", "fused-cuda"])
def test_warmup_freezes_trace_count_over_every_batch_size(int_pair, kind):
    """After warmup, live batches of every size 1..max_batch meet only
    warmed shapes: ``trace_cache_size()`` stays put and the watch counts
    no anomaly."""
    from repro_torch.obs import MetricsRegistry
    _, forest = int_pair
    pred = _tenant(kind, forest)
    rt = ServingRuntime(obs=MetricsRegistry())
    rt.add_model("m", pred, max_batch=12, max_wait_ms=1e3)
    rt.warmup()
    warm = pred.trace_cache_size()
    assert warm >= 1
    X = np.random.default_rng(3).normal(size=(12, 6))
    for b in range(1, 13):
        for x in X[:b]:
            rt.submit("m", x, arrival_s=0.0)
        assert len(rt.flush(now_s=1.0)) == b
    assert pred.trace_cache_size() == warm
    st = rt.stats("m")
    assert st["n_batches"] == 12
    assert st["compile_events"] == 0 and st["retrace_anomalies"] == 0


def test_warmup_predictions_bit_identical(qpred_pair):
    qa, _, *_ = qpred_pair
    pred = compile_port(qa, engine="rapidscorer")
    X = np.random.default_rng(1).normal(size=(9, qa.n_features))
    before = pred.predict(X)
    rt = ServingRuntime()
    rt.add_model("m", pred, max_batch=16)
    rt.warmup("m")
    np.testing.assert_array_equal(pred.predict(X), before)


def test_warmup_fused_cascade_resets_exit_stats(qpred_pair):
    from repro_torch.cascade import CascadeSpec, MarginGate
    qa, *_ = qpred_pair
    fused = compile_port(qa, cascade=CascadeSpec(
        stages=(4, 8), policy=MarginGate(0.5), fused=True))
    rt = ServingRuntime()
    rt.add_model("casc", fused, max_batch=16)
    rt.warmup()
    assert fused.exit_counts.sum() == 0
    n_traces = fused.trace_cache_size()
    assert n_traces >= 1
    X = np.random.default_rng(2).normal(size=(11, qa.n_features))
    for i in range(11):
        rt.submit("casc", X[i], arrival_s=i * 1e-4)
    rt.flush(now_s=1.0)
    assert fused.trace_cache_size() == n_traces
    assert fused.exit_counts.sum() == 11


def test_warmup_respects_adaptive_upper_bound(qpred_pair):
    qa, pa, *_ = qpred_pair
    rt = ServingRuntime()
    rt.add_model("m", pa, max_batch=4, max_wait_ms=1.0,
                 slo=SLOConfig(target_p99_ms=5.0, max_batch=32))
    assert rt.warmup() == {"m": [1, 2, 4, 8, 16, 32]}


def test_warmup_needs_a_host_forest():
    class Opaque:
        def predict(self, X):
            return np.zeros((len(X), 1))

    rt = ServingRuntime()
    rt.add_model("m", Opaque())
    with pytest.raises(ValueError, match="host_forest"):
        rt.warmup()


# --------------------------------------------------------------------------- #
# Conformance: serving == synchronous predict, and == the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("engine", PORT_ENGINES, ids=_ids)
def test_served_scores_bit_identical_to_predict(qpred_pair, engine):
    """The padded/bucketed dispatch path is bit-identical to the
    synchronous ``predict`` on quantized forests — including the odd
    batch tails that exercise the zero-padding."""
    qa, *_ = qpred_pair
    pred = compile_port(qa, engine=engine[0], backend=engine[1])
    X = np.random.default_rng(3).normal(size=(23, qa.n_features))
    direct = pred.predict(X)
    rt = ServingRuntime()
    rt.add_model("m", pred, max_batch=5, max_wait_ms=1.0)
    reqs = [rt.submit("m", X[i], arrival_s=i * 1e-4) for i in range(23)]
    rt.flush(now_s=1.0)
    np.testing.assert_array_equal(np.stack([r.result for r in reqs]),
                                  direct)
    # kernel predictors bucket internally: the runtime never pads them
    assert rt.tenant("m").pad_buckets == (engine[1] == "torch")


@pytest.mark.parametrize("engine", PORT_ENGINES, ids=_ids)
def test_served_int_accum_scores_equal_the_reference_runtime(int_pair,
                                                              engine):
    """The same rows at the same virtual times through both runtimes:
    array-equal served scores and the same batches."""
    ref_f, port_f = int_pair
    X = np.random.default_rng(4).normal(size=(29, 6))
    out = []
    for rt, pred in ((ServingRuntime(), compile_port(
            port_f, engine=engine[0], backend=engine[1])),
            (RRuntime(), rcore.compile_forest(ref_f, engine=engine[0]))):
        rt.add_model("m", pred, max_batch=6, max_wait_ms=1.0)
        reqs = [rt.submit("m", x, arrival_s=i * 3e-4)
                for i, x in enumerate(X)]
        done = []
        for i in range(len(X)):
            done.extend(rt.pump(now_s=i * 3e-4))
        done.extend(rt.flush(now_s=1.0))
        out.append((np.stack([r.result for r in reqs]), _batches_of(done)))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_served_cascade_exit_accounting_matches_the_reference(int_pair,
                                                              fused):
    """Cascade tenants: served scores and per-stage exit counts equal the
    synchronous path and the reference runtime's."""
    from repro import cascade as rc
    from repro_torch.cascade import CascadePredictor, CascadeSpec, MarginGate
    ref_f, port_f = int_pair
    spec = CascadeSpec(stages=(4, 10), policy=MarginGate(0.5), fused=fused)
    ref_pred = rcore.compile_forest(ref_f, cascade=rc.CascadeSpec(
        (4, 10), rc.MarginGate(0.5), fused=fused))
    served = compile_port(port_f, cascade=spec)
    direct = CascadePredictor(port_f, CascadeSpec((4, 10), MarginGate(0.5)),
                              device=CPU, backend="torch")
    X = np.random.default_rng(4).normal(size=(17, 6))
    want = direct.predict(X)
    results = []
    for rt, pred in ((ServingRuntime(), served), (RRuntime(), ref_pred)):
        rt.add_model("casc", pred, max_batch=17, max_wait_ms=1.0)
        reqs = [rt.submit("casc", x, arrival_s=0.0) for x in X]
        rt.flush(now_s=1.0)
        results.append((np.stack([r.result for r in reqs]),
                        rt.summary("casc")))
    np.testing.assert_array_equal(results[0][0], want)
    np.testing.assert_array_equal(results[0][0], results[1][0])
    assert served.exit_counts.sum() == 17
    np.testing.assert_array_equal(served.exit_counts, direct.exit_counts)
    np.testing.assert_array_equal(served.exit_counts, ref_pred.exit_counts)
    s = results[0][1]
    assert s["exit_fractions"] == results[1][1]["exit_fractions"]
    assert sum(s["exit_fractions"]) == pytest.approx(1.0)


# --------------------------------------------------------------------------- #
# Concurrency: threaded loop, tenancy, shutdown
# --------------------------------------------------------------------------- #
def _hammer(rt, model_id, X, n_threads, per_thread):
    """n_threads × per_thread concurrent submissions; returns requests."""
    all_reqs, errs = [], []
    lock = threading.Lock()

    def worker(seed):
        rng = np.random.default_rng(seed)
        mine = []
        try:
            for _ in range(per_thread):
                i = int(rng.integers(0, len(X)))
                mine.append((i, rt.submit(model_id, X[i])))
        except Exception as e:                        # pragma: no cover
            errs.append(e)
        with lock:
            all_reqs.extend(mine)

    ts = [threading.Thread(target=worker, args=(s,))
          for s in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs
    return all_reqs


def test_threaded_exactly_once_single_tenant(qpred_pair):
    qa, pa, *_ = qpred_pair
    X = np.random.default_rng(5).normal(size=(32, qa.n_features))
    direct = pa.predict(X)
    rt = ServingRuntime()
    rt.add_model("m", pa, max_batch=16, max_wait_ms=0.5)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # more thread switches: races show
    try:
        with rt:
            reqs = _hammer(rt, "m", X, n_threads=8, per_thread=40)
            for _, r in reqs:
                r.wait(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert len(reqs) == 320
    assert len({r.rid for _, r in reqs}) == 320
    for i, r in reqs:
        np.testing.assert_array_equal(r.result, direct[i])
        assert r.done_s is not None and r.latency_ms >= 0.0
    assert rt.summary("m")["n_requests"] == 320
    assert rt.tenant("m").stats.batch_sizes.total == 320


def test_threaded_multi_tenant_routing(qpred_pair):
    qa, pa, qb, pb = qpred_pair
    X = np.random.default_rng(6).normal(size=(16, qa.n_features))
    da, db = pa.predict(X), pb.predict(X)
    assert da.shape[1] != db.shape[1]
    rt = ServingRuntime()
    rt.add_model("a", pa, max_batch=8, max_wait_ms=0.5)
    rt.add_model("b", pb, max_batch=8, max_wait_ms=0.5)
    rt.warmup()
    with rt:
        ra = _hammer(rt, "a", X, n_threads=4, per_thread=25)
        rb = _hammer(rt, "b", X, n_threads=4, per_thread=25)
        for _, r in ra + rb:
            r.wait(timeout=30)
    for i, r in ra:
        np.testing.assert_array_equal(r.result, da[i])
    for i, r in rb:
        np.testing.assert_array_equal(r.result, db[i])
    assert rt.summary("a")["n_requests"] == 100
    assert rt.summary("b")["n_requests"] == 100


def test_close_flushes_queued_requests_no_deadlock(qpred_pair):
    qa, pa, *_ = qpred_pair
    X = np.zeros((4, qa.n_features))
    rt = ServingRuntime()
    rt.add_model("m", pa, max_batch=64, max_wait_ms=60_000.0)
    rt.start()
    reqs = [rt.submit("m", X[i]) for i in range(4)]
    rt.close(timeout=30)
    for r in reqs:
        assert r.future.done() and r.result is not None
    assert rt.summary("m")["n_requests"] == 4
    with pytest.raises(RuntimeError, match="closed"):
        rt.submit("m", X[0])
    with pytest.raises(RuntimeError, match="closed"):
        rt.start()
    rt.close()                                  # idempotent


def test_manual_close_flushes_without_thread(qpred_pair):
    qa, pa, *_ = qpred_pair
    rt = ServingRuntime(clock=lambda: 0.0)
    rt.add_model("m", pa, max_batch=64, max_wait_ms=60_000.0)
    r = rt.submit("m", np.zeros(qa.n_features))
    rt.close()
    assert r.future.done() and r.result is not None


def test_batch_exception_resolves_futures_and_worker_survives(qpred_pair):
    """A batch that raises (as a failed kernel launch does) resolves its
    futures with the error; the next batch is served by the same engine,
    not by any plain fallback."""
    qa, pa, *_ = qpred_pair

    class Flaky:
        def __init__(self, inner):
            self.inner = inner
            self.fail_next = True
            self.calls = 0

        def predict(self, X):
            self.calls += 1
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("qs_forward kernel launch failed: boom")
            return self.inner.predict(X)

        def host_forest(self):
            return self.inner.host_forest()

    flaky = Flaky(pa)
    rt = ServingRuntime()
    rt.add_model("m", flaky, max_batch=1, max_wait_ms=0.0)
    with rt:
        bad = rt.submit("m", np.zeros(qa.n_features))
        with pytest.raises(RuntimeError, match="launch failed"):
            bad.wait(timeout=30)
        good = rt.submit("m", np.zeros(qa.n_features))
        assert good.wait(timeout=30) is not None
    assert flaky.calls == 2 and bad.result is None


def test_pump_and_flush_reject_while_threaded(qpred_pair):
    qa, pa, *_ = qpred_pair
    rt = ServingRuntime()
    rt.add_model("m", pa)
    with rt:
        with pytest.raises(RuntimeError, match="manual"):
            rt.pump()
        with pytest.raises(RuntimeError, match="manual"):
            rt.flush()


def test_unknown_tenant_and_duplicate_and_bad_id(qpred_pair):
    qa, pa, *_ = qpred_pair
    rt = ServingRuntime()
    rt.add_model("m", pa)
    with pytest.raises(ValueError, match="unknown model id"):
        rt.submit("nope", np.zeros(qa.n_features))
    with pytest.raises(ValueError, match="already serving"):
        rt.add_model("m", pa)
    with pytest.raises(ValueError, match="model id"):
        rt.add_model("bad/id", pa)


# --------------------------------------------------------------------------- #
# Manifest cold start
# --------------------------------------------------------------------------- #
def test_save_load_manifest_cold_start_bit_identical(qpred_pair, tmp_path):
    qa, _, qb, _ = qpred_pair
    rt = ServingRuntime()
    rt.add_model("alpha", compile_port(qa), max_batch=16, max_wait_ms=3.0,
                 slo=SLOConfig(target_p99_ms=8.0, max_batch=64))
    rt.add_model("beta", compile_port(qb, engine="bitmm"), max_batch=8,
                 max_wait_ms=1.5)
    X = np.random.default_rng(7).normal(size=(10, qa.n_features))
    da = rt.tenant("alpha").predictor.predict(X)
    db = rt.tenant("beta").predictor.predict(X)

    manifest = rt.save(tmp_path / "fleet")
    rt2 = ServingRuntime.load(manifest, device=CPU)
    assert set(rt2.model_ids) == {"alpha", "beta"}
    np.testing.assert_array_equal(rt2.tenant("alpha").predictor.predict(X),
                                  da)
    np.testing.assert_array_equal(rt2.tenant("beta").predictor.predict(X),
                                  db)
    ta, tb = rt2.tenant("alpha"), rt2.tenant("beta")
    assert ta.cfg_max_batch == 16 and ta.cfg_max_wait_ms == 3.0
    assert ta.controller.slo == SLOConfig(target_p99_ms=8.0, max_batch=64)
    assert tb.controller is None
    assert tb.cfg_max_batch == 8 and tb.cfg_max_wait_ms == 1.5
    reqs = [rt2.submit("alpha", X[i], arrival_s=0.0) for i in range(10)]
    rt2.flush(now_s=1.0)
    np.testing.assert_array_equal(np.stack([r.result for r in reqs]), da)
    rt3 = ServingRuntime.load(tmp_path / "fleet", device=CPU)
    assert set(rt3.model_ids) == {"alpha", "beta"}


def test_reference_saved_fleet_loads_and_serves_the_same(int_pair,
                                                         tmp_path):
    """A fleet the reference saved (jax engines, a staged cascade, an SLO)
    cold-starts in the port and serves the reference's scores."""
    from repro import cascade as rc
    ref_f, _ = int_pair
    ref = RRuntime(obs=False)
    ref.add_model("qs", rcore.compile_forest(ref_f, engine="bitvector"),
                  max_batch=8, max_wait_ms=2.0,
                  slo=RSLO(target_p99_ms=4.0, max_batch=16))
    ref.add_model("bm", rcore.compile_forest(ref_f, engine="bitmm"),
                  max_batch=4, max_wait_ms=1.0)
    ref.add_model("casc", rcore.compile_forest(
        ref_f, engine="bitvector",
        cascade=rc.CascadeSpec((4, 10), rc.MarginGate(0.5))), max_batch=8)
    manifest = ref.save(tmp_path / "fleet")
    rt = ServingRuntime.load(manifest, device=CPU)
    assert rt.model_ids == ref.model_ids
    assert rt.tenant("qs").controller.slo == SLOConfig(target_p99_ms=4.0,
                                                       max_batch=16)
    assert rt.tenant("bm").cfg_max_batch == 4
    X = np.random.default_rng(11).normal(size=(13, 6))
    for tid in rt.model_ids:
        want = ref.tenant(tid).predictor.predict(X)
        reqs = [rt.submit(tid, x, arrival_s=0.0) for x in X]
        rt.flush(now_s=1.0)
        np.testing.assert_array_equal(np.stack([r.result for r in reqs]),
                                      want)


def test_save_of_a_cuda_tenant_raises(qpred_pair, tmp_path):
    qa, *_ = qpred_pair
    rt = ServingRuntime()
    rt.add_model("k", compile_port(qa, backend="cuda"))
    with pytest.raises(ValueError, match="cuda"):
        rt.save(tmp_path / "fleet")


def test_load_puts_tenants_on_the_card_unless_asked(qpred_pair, tmp_path):
    qa, pa, *_ = qpred_pair
    rt = ServingRuntime()
    rt.add_model("m", pa)
    manifest = rt.save(tmp_path / "fleet")
    assert ServingRuntime.load(manifest, device=CPU).tenant(
        "m").predictor.device.type == "cpu"
    if torch.cuda.is_available():
        dev = ServingRuntime.load(manifest).tenant("m").predictor.device
        assert dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingRuntime.load(manifest)


def test_load_manifest_rejects_garbage(tmp_path):
    from repro_torch.io import packed
    p = tmp_path / "manifest.json"
    p.write_text("not json {")
    with pytest.raises(ValueError, match="not a readable manifest"):
        packed.load_manifest(str(p))
    p.write_text('{"format": "something.else", "tenants": {}}')
    with pytest.raises(ValueError, match="unknown manifest format"):
        packed.load_manifest(str(p))
    p.write_text('{"format": "repro.tenants", "version": 99, '
                 '"tenants": {"m": {"artifact": "x.npz"}}}')
    with pytest.raises(ValueError, match="newer"):
        packed.load_manifest(str(p))
    p.write_text('{"format": "repro.tenants", "version": 1, '
                 '"tenants": {}}')
    with pytest.raises(ValueError, match="no tenants"):
        packed.load_manifest(str(p))
    with pytest.raises(ValueError, match="artifact"):
        packed.save_manifest(str(p), {"m": {"no_artifact": True}})


def test_from_forests_shares_autotune_cache(qpred_pair, tmp_path,
                                            monkeypatch):
    """N same-shaped tenants pay for ONE sweep: the second choose() is a
    cache hit (the runtime shares the process-wide autotune cache)."""
    from repro_torch.core import engine_select
    qa, *_ = qpred_pair
    monkeypatch.setenv("REPRO_ENGINE_CACHE", str(tmp_path / "cache.json"))
    engine_select.clear_cache()
    try:
        rt = ServingRuntime.from_forests(
            {"a": qa, "b": qa}, max_batch=8, device=CPU,
            engines=("qs", "native"), repeats=1)
        assert rt.tenant("a").engine_choice.from_cache is False
        assert rt.tenant("b").engine_choice.from_cache is True
        assert rt.tenant("a").engine_choice.engine == \
            rt.tenant("b").engine_choice.engine
        assert rt.tenant("a").predictor.device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                ServingRuntime.from_forests({"a": qa}, max_batch=8,
                                            engines=("qs",), repeats=1)
    finally:
        engine_select.clear_cache()


# --------------------------------------------------------------------------- #
# The launcher
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("argv", [
    ["--mode", "forest", "--backend", "cuda", "--quantize", "--n-trees",
     "8", "--n-requests", "60"],
    ["--mode", "runtime", "--backend", "torch", "--tenants", "2",
     "--quantize", "--n-trees", "8", "--n-requests", "80", "--rate",
     "4000", "--slo-p99-ms", "50", "--metrics-port", "0"],
    ["--mode", "lm", "--backend", "cuda", "--reduced", "--batch", "2",
     "--prompt-len", "8", "--n-new", "3"],
], ids=["forest", "runtime", "lm"])
def test_serve_launcher_modes_on_the_cpu(argv, capsys):
    from repro_torch.launch import serve
    out = serve.main(argv + ["--device", "cpu"])
    assert "{" in capsys.readouterr().out
    if argv[1] == "lm":
        assert out["out_shape"] == [2, 11]
    else:
        assert out["n_requests"] == int(argv[argv.index("--n-requests")
                                             + 1])
        assert out["accuracy"] > 0.5
    if argv[1] == "runtime":
        assert all(s["retrace_anomalies"] == 0
                   for s in out["tenants"].values())


def test_serve_launcher_fleet_round_trip(tmp_path, capsys):
    from repro_torch.launch import serve
    base = ["--mode", "runtime", "--backend", "torch", "--device", "cpu",
            "--n-requests", "40", "--rate", "4000"]
    saved = serve.main(base + ["--tenants", "2", "--quantize", "--n-trees",
                               "8", "--save-fleet", str(tmp_path / "f")])
    loaded = serve.main(base + ["--load-fleet", str(tmp_path / "f")])
    capsys.readouterr()
    assert set(saved["tenants"]) == set(loaded["tenants"]) == {"t0", "t1"}
    assert loaded["accuracy"] > 0.5
