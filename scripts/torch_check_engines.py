"""Dev sanity check of the port: every engine vs the traversal oracle.

    PYTHONPATH=src python scripts/torch_check_engines.py            # matrix
    PYTHONPATH=src python scripts/torch_check_engines.py --serving  # runtime
    PYTHONPATH=src python scripts/torch_check_engines.py --obs      # metrics
    PYTHONPATH=src python scripts/torch_check_engines.py --cascade  # cascade
    PYTHONPATH=src python scripts/torch_check_engines.py --cascade-fused
    PYTHONPATH=src python scripts/torch_check_engines.py --optimize # -O2
    PYTHONPATH=src python scripts/torch_check_engines.py --int      # int/FLInt
    PYTHONPATH=src python scripts/torch_check_engines.py --os       # -Os

The port's counterpart of ``scripts/check_engines.py``, on the card unless
``--device cpu`` asks for the CPU (where the ``cuda`` backend runs each
kernel's plain version).  The engine list comes from
``repro_torch.core.registry``: every ``torch`` engine and every ``cuda``
kernel engine.  ``--serving`` checks the concurrent runtime: shape warmup
leaves predictions bit-identical, served scores equal the synchronous
``predictor.predict`` for every engine and for a cascade tenant (exit
accounting intact), and the adaptive controller never leaves its
configured bounds under adversarial latency streams.  ``--obs`` checks
the observability layer: served scores stay bit-exact with full
instrumentation on (plain + fused-cascade tenants, threaded runtime,
live loopback scrape), the Prometheus scrape exposes every catalog metric
as well-formed text, ``/metrics.json`` parses and carries the runtime
stats, and the warmed fleet serves with **zero** retrace anomalies.
``--cascade`` exercises the staged cascade end to end (gate-off
bit-exactness, a calibrated gate under the accuracy floor, the
exit-fraction accounting); ``--cascade-fused`` checks fused execution
against the staged loop (bit-exact scores and per-stage exit counts on
the quantized forest, every engine, and the single-kernel tier);
``--optimize`` checks every engine at ``-O2`` against ``-O0``; ``--int``
the integer paths (int-accum bit-exact vs the quantized oracle, FLInt ==
float, the exact-integer cascade gate); ``--os`` zero-shot compilation
(a cost model trained from measured sweeps, its low-confidence
fallback, and an ``-Os`` fleet surviving a manifest round trip).

Exit status is non-zero on any FAIL line, so CI can gate on it.
"""
import argparse
import os
import sys

import numpy as np

from repro_torch import core
from repro_torch.core import registry
from repro_torch.data import load
from repro_torch.trees import RandomForest, RandomForestConfig

FAILED = []


def _check(label: str, err: float, tol: float) -> None:
    ok = err < tol
    print(f"{label:24s} max_err={err:.2e} {'OK' if ok else 'FAIL'}")
    if not ok:
        FAILED.append(label)


def _specs():
    """Every registered engine: the torch engines, then the kernels."""
    return registry.specs("torch") + registry.specs("cuda")


def _compile(forest, spec, device, **kw):
    return core.compile_forest(forest, engine=spec.name,
                               backend=spec.backend, device=device, **kw)


def check_engines(ds, forest, qf, X, device):
    oracle = forest.predict_oracle(X)
    for spec in _specs():
        pred = _compile(forest, spec, device)
        _check(spec.tune_name, np.abs(pred.predict(X) - oracle).max(), 1e-5)

    # scalar faithful QS (Algorithm 1 with early break)
    sc = core.eval_scalar_numpy(forest, X[:8])
    _check("scalar-QS", np.abs(sc - oracle[:8]).max(), 1e-5)

    # quantized
    oq = qf.predict_oracle(core.quantize_inputs(qf, X)) / core.leaf_scale(qf)
    for spec in _specs():
        pred = _compile(qf, spec, device)
        _check(f"q-{spec.tune_name}", np.abs(pred.predict(X) - oq).max(),
               1e-4)

    acc_f = (core.compile_forest(forest, device=device)
             .predict_class(ds.X_test) == ds.y_test).mean()
    acc_q = (core.compile_forest(qf, device=device)
             .predict_class(ds.X_test) == ds.y_test).mean()
    print(f"accuracy float={acc_f:.4f} quant={acc_q:.4f}")


def check_cascade(ds, qf, X, device, engine="bitvector"):
    """Cascade smoke: one engine end-to-end through the staged path."""
    from repro_torch.cascade import calibrate, CascadeSpec, MarginGate
    base = core.compile_forest(qf, engine=engine, device=device)
    stages = (max(qf.n_trees // 4, 1), qf.n_trees)

    # gate disabled → bit-exact with the base engine on the quantized IR
    off = core.compile_forest(qf, engine=engine, device=device,
                              cascade=CascadeSpec(
                                  stages=stages, policy=MarginGate(np.inf)))
    err = float(np.abs(off.predict(X) - base.predict(X)).max())
    _check(f"cascade-off-{engine}", err, 1e-12)

    # calibrated gate: accuracy within the floor, some rows exit early
    casc = core.compile_forest(qf, engine=engine, device=device,
                               cascade=CascadeSpec(stages=stages))
    n_cal = len(ds.X_test) // 2
    cal = calibrate(casc, ds.X_test[:n_cal], ds.y_test[:n_cal],
                    floor_pp=0.5)
    casc.set_policy(cal.policy)
    casc.reset_exit_stats()
    acc_full = (base.predict_class(ds.X_test[n_cal:])
                == ds.y_test[n_cal:]).mean()
    acc_casc = (casc.predict_class(ds.X_test[n_cal:])
                == ds.y_test[n_cal:]).mean()
    fr = casc.exit_fractions
    print(f"cascade {engine} plan: {casc.plan.describe()}")
    print(f"cascade policy={casc.policy.tag()} "
          f"exit_fractions={np.round(fr, 3).tolist()} "
          f"mean_trees={casc.mean_trees_evaluated:.1f}/{qf.n_trees}")
    print(f"cascade accuracy full={acc_full:.4f} gated={acc_casc:.4f}")
    drop_pp = (acc_full - acc_casc) * 100.0
    _check(f"cascade-acc-{engine}", max(drop_pp, 0.0), 1.0)
    if abs(float(fr.sum()) - 1.0) > 1e-9:
        print(f"cascade-exit-accounting FAIL: fractions sum to {fr.sum()}")
        FAILED.append("cascade-exit-accounting")


def check_cascade_fused(ds, qf, X, device):
    """Fused-execution smoke: fused must be bit-exact with the staged
    loop (scores AND per-stage exit counts) on the quantized forest —
    every engine (the generic tier), plus the single-kernel tier."""
    from repro_torch.cascade import (CascadePredictor, CascadeSpec,
                                     FusedCascadePredictor, MarginGate)
    spec = CascadeSpec(stages=(max(qf.n_trees // 4, 1), qf.n_trees),
                       policy=MarginGate(0.5))
    fspec = CascadeSpec(stages=spec.stages, policy=spec.policy,
                        fused=True)
    for s in _specs():
        staged = CascadePredictor(qf, spec, engine=s.name,
                                  backend=s.backend, device=device)
        fused = _compile(qf, s, device, cascade=fspec)
        if not isinstance(fused, FusedCascadePredictor):
            raise TypeError(f"{s.tune_name}: {type(fused).__name__}")
        err = float(np.abs(fused.predict(X) - staged.predict(X)).max())
        if not np.array_equal(fused.last_exit_counts,
                              staged.last_exit_counts):
            err = np.inf         # exit-count drift is a hard FAIL too
        _check(f"fused-{s.tune_name}", err, 1e-12)
    staged = CascadePredictor(qf, spec, engine="bitvector", device=device)
    fused = FusedCascadePredictor(qf, fspec, engine="bitvector",
                                  backend="cuda", device=device)
    err = float(np.abs(fused.predict(X) - staged.predict(X)).max())
    if not np.array_equal(fused.last_exit_counts, staged.last_exit_counts):
        err = np.inf
    _check("fused-cuda-kernel", err, 1e-12)
    print(f"fused host_syncs={fused.host_syncs} "
          f"(staged: {staged.host_syncs})")


def check_optimize(forest, qf, X, device):
    """Optimizer smoke: every registered engine × -O2 agrees with -O0."""
    from repro_torch import optim
    res = optim.optimize(qf, 2)
    print(f"optimizer -O2 on quantized forest: {res.describe()}")
    for spec in _specs():
        o0 = _compile(forest, spec, device)
        o2 = _compile(forest, spec, device, opt=2)
        _check(f"O2-float-{spec.tune_name}",
               float(np.abs(o2.predict(X) - o0.predict(X)).max()), 1e-4)
        q0 = _compile(qf, spec, device)
        q2 = _compile(qf, spec, device, opt=2)
        _check(f"O2-quant-{spec.tune_name}",      # bit-exact: integer sums
               float(np.abs(q2.predict(X) - q0.predict(X)).max()), 1e-12)


def check_int(ds, forest, X, device):
    """Integer end-to-end smoke: int-accum bit-exactness vs the quantized
    oracle, FLInt == float engines, int-gate cascade class-exact."""
    from repro_torch.cascade import CascadeSpec, ScoreBoundGate
    from repro_torch.core.pipeline import CompilePlan, compile_plan
    from repro_torch.core.quantize import QuantSpec, accum_bits

    qi = core.quantize_forest(forest, ds.X_train,
                              spec=QuantSpec(int_accum=True))
    print(f"int-accum: acc_bits={accum_bits(qi)} "
          f"err_bound={qi.leaf_err_bound:g}")
    oracle = (qi.predict_oracle(core.quantize_inputs(qi, X))
              / core.leaf_scale(qi)).astype(np.float32)
    for spec in _specs():
        pred = _compile(qi, spec, device)
        err = 0.0 if np.array_equal(pred.predict(X), oracle) else np.inf
        _check(f"int-{spec.tune_name}", err, 1e-12)

    # FLInt: integer compares must reproduce the float engines exactly
    # (the torch engines only: the kernels take f32 rows)
    for spec in registry.specs("torch"):
        ref = _compile(forest, spec, device).predict(X)
        fl = compile_plan(forest, CompilePlan(
            engine=spec.name, backend="torch", device=device, flint=True))
        err = 0.0 if np.array_equal(fl.predict(X), ref) else np.inf
        _check(f"flint-{spec.tune_name}", err, 1e-12)

    # int-gate cascade: exact integer suffix bounds, class-exact at slack 0
    base = core.compile_forest(qi, engine="bitvector", device=device)
    casc = core.compile_forest(qi, engine="bitvector", device=device,
                               cascade=CascadeSpec(
                                   stages=(max(qi.n_trees // 4, 1),
                                           qi.n_trees),
                                   policy=ScoreBoundGate()))
    same = np.array_equal(casc.predict_class(ds.X_test),
                          base.predict_class(ds.X_test))
    _check("int-cascade-gate", 0.0 if same else np.inf, 1e-12)


def check_serving(ds, qf, X, device):
    """Serving-runtime smoke: warmup bit-identity, served == synchronous
    predict per engine and for a cascade tenant, controller bounds under
    adversarial input."""
    from repro_torch.cascade import CascadePredictor, CascadeSpec, MarginGate
    from repro_torch.inference import (AdaptiveBatchController,
                                       ServingRuntime, SLOConfig)

    # 1. warmup leaves predictions bit-identical (zeros never leak)
    for spec in _specs():
        pred = _compile(qf, spec, device)
        before = pred.predict(X)
        rt = ServingRuntime()
        rt.add_model("m", pred, max_batch=32)
        rt.warmup()
        err = float(np.abs(pred.predict(X) - before).max())
        _check(f"serve-warm-{spec.tune_name}", err, 1e-12)

    # 2. served scores == synchronous predict (odd batches → padding)
    for spec in _specs():
        pred = _compile(qf, spec, device)
        direct = pred.predict(X)
        rt = ServingRuntime()
        rt.add_model("m", pred, max_batch=7, max_wait_ms=1.0)
        rt.warmup()
        reqs = [rt.submit("m", X[i], arrival_s=i * 1e-4)
                for i in range(len(X))]
        rt.flush(now_s=1.0)
        got = np.stack([r.result for r in reqs])
        _check(f"serve-{spec.tune_name}", float(np.abs(got - direct).max()),
               1e-12)

    # 3. cascade tenant: scores + exit accounting intact through serving
    spec = CascadeSpec(stages=(max(qf.n_trees // 4, 1), qf.n_trees),
                       policy=MarginGate(0.5))
    ref = CascadePredictor(qf, spec, engine="bitvector", device=device)
    served = CascadePredictor(qf, spec, engine="bitvector", device=device)
    direct = ref.predict(X)
    rt = ServingRuntime()
    rt.add_model("casc", served, max_batch=len(X), max_wait_ms=1.0)
    rt.warmup()
    reqs = [rt.submit("casc", X[i], arrival_s=0.0) for i in range(len(X))]
    rt.flush(now_s=1.0)
    got = np.stack([r.result for r in reqs])
    err = float(np.abs(got - direct).max())
    if served.exit_counts.sum() != len(X) or \
            not np.array_equal(served.exit_counts, ref.exit_counts):
        err = np.inf             # accounting drift is a hard FAIL too
    _check("serve-cascade-exits", err, 1e-12)

    # 4. controller bounds under adversarial latency streams
    slo = SLOConfig(target_p99_ms=5.0, window=4, min_batch=2,
                    max_batch=128, min_wait_ms=0.25, max_wait_ms=16.0)
    c = AdaptiveBatchController(slo, batch=64, wait_ms=8.0)
    rng = np.random.default_rng(0)
    streams = [np.full(400, 1e6), np.full(400, 0.0),
               rng.exponential(5.0, size=400),
               np.tile([0.0, 1e6], 200)]           # oscillation attack
    worst = 0.0
    for s in streams:
        for v in s:
            c.observe(float(v))
            worst = max(worst,
                        slo.min_batch - c.max_batch,
                        c.max_batch - slo.max_batch,
                        slo.min_wait_ms - c.max_wait_ms,
                        c.max_wait_ms - slo.max_wait_ms)
    _check("serve-slo-bounds", worst, 1e-12)


def check_obs(ds, qf, X, device):
    """Observability smoke: bit-exact serving with full instrumentation
    on, a live loopback scrape covering the whole metric catalog,
    parseable JSON, zero retrace anomalies."""
    import json
    import re
    import urllib.request

    from repro_torch.cascade import CascadePredictor, CascadeSpec, MarginGate
    from repro_torch.inference import ServingRuntime
    from repro_torch.obs import METRIC_CATALOG, MetricsRegistry

    pred = core.compile_forest(qf, engine="bitvector", device=device)
    direct = pred.predict(X)
    spec = CascadeSpec(stages=(max(qf.n_trees // 4, 1), qf.n_trees),
                       policy=MarginGate(0.5), fused=True)
    casc = core.compile_forest(qf, engine="bitvector", device=device,
                               cascade=spec)
    casc_direct = CascadePredictor(
        qf, CascadeSpec(stages=spec.stages, policy=spec.policy),
        engine="bitvector", device=device).predict(X)

    rt = ServingRuntime(obs=MetricsRegistry())   # isolated registry
    rt.add_model("m", pred, max_batch=7, max_wait_ms=0.5)
    rt.add_model("casc", casc, max_batch=len(X), max_wait_ms=0.5)
    rt.warmup()
    with rt:
        url = rt.serve_metrics().url
        reqs = [rt.submit("m", X[i]) for i in range(len(X))]
        creqs = [rt.submit("casc", X[i]) for i in range(len(X))]
        for r in reqs + creqs:
            r.wait(timeout=120)
        got = np.stack([r.result for r in reqs])
        cgot = np.stack([r.result for r in creqs])
        with urllib.request.urlopen(url + "/metrics", timeout=10) as resp:
            text = resp.read().decode()
        with urllib.request.urlopen(url + "/metrics.json",
                                    timeout=10) as resp:
            snap = json.loads(resp.read().decode())
        with urllib.request.urlopen(url + "/traces?n=8",
                                    timeout=10) as resp:
            traces = json.loads(resp.read().decode())

    # served == synchronous, bit-exact, with everything instrumented
    _check("obs-serve-bitexact", float(np.abs(got - direct).max()), 1e-12)
    _check("obs-serve-cascade", float(np.abs(cgot - casc_direct).max()),
           1e-12)

    # the scrape must expose every catalog metric, every line well-formed
    missing = [n for n in METRIC_CATALOG if f"# TYPE {n} " not in text]
    _check("obs-scrape-catalog", float(len(missing)), 1)
    line_re = re.compile(
        r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.einfa+-]+$")
    bad = [ln for ln in text.splitlines()
           if ln and not ln.startswith("#") and not line_re.match(ln)]
    _check("obs-scrape-wellformed", float(len(bad)), 1)

    stats = snap.get("stats", {})
    ok_json = "metrics" in snap and "m" in stats and "casc" in stats
    _check("obs-json-snapshot", 0.0 if ok_json else np.inf, 1e-12)

    # the warmup contract, live: no post-warmup first use on either tenant
    anomalies = sum(s.get("retrace_anomalies", 0) for s in stats.values())
    _check("obs-zero-retrace", float(anomalies), 1e-12)
    ok_traces = len(traces) == 8 and all("phases" in t for t in traces)
    _check("obs-traces", 0.0 if ok_traces else np.inf, 1e-12)
    compiles = {tid: s.get("compile_events") for tid, s in stats.items()}
    n_series = sum(1 for ln in text.splitlines()
                   if ln and not ln.startswith("#"))
    print(f"obs: {len(METRIC_CATALOG)} catalog metrics / {n_series} "
          f"series scraped, compile_events={compiles}, "
          f"retrace_anomalies={anomalies}")


def check_os(ds, qf, X, device):
    """Zero-shot compilation smoke: train a cost model from a few
    measured sweeps, then (1) the predict path returns a plan bit-exact
    with compiling that plan directly, (2) the low-confidence fallback's
    narrow sweep agrees with the full sweep restricted to its top-k set,
    (3) a fleet cold-starts under ``-Os`` and survives a manifest
    save/load round trip bit-identically."""
    import tempfile

    from repro_torch import tune
    from repro_torch.core import engine_select
    from repro_torch.inference import ServingRuntime

    engines = ("qs", "qs-bitmm", "native")
    with tempfile.TemporaryDirectory() as td:
        cache = os.path.join(td, "cache.json")
        engine_select.clear_cache()
        shapes = [(8, 16, 6), (16, 16, 8), (24, 32, 10), (12, 8, 6)]
        for i, (T, L, d) in enumerate(shapes):
            f = core.random_forest_ir(T, L, d, n_classes=1, seed=i)
            engine_select.choose(f, 64, engines=engines, device=device,
                                 cache_path=cache, repeats=1)
        model_path = os.path.join(td, "model.json")
        model = tune.train_from_cache(cache, save_to=model_path)
        print(f"-Os cost model: {model.n_rows} rows, "
              f"sigma={model.resid_sigma:.3f}")
        engine_select.clear_cache()

        # 1. predict path: zero-shot plan, bit-exact vs direct compile
        held = core.random_forest_ir(10, 16, 7, n_classes=1, seed=99)
        Xh = np.random.default_rng(0).normal(size=(64, held.n_features))
        c = engine_select.choose(held, 64, engines=engines, device=device,
                                 cache_path=cache, mode="predict",
                                 cost_model=model_path,
                                 confidence_threshold=0.0, repeats=1)
        direct = engine_select._candidate_factories(
            held, engines, None, None, 1, device=device)[c.engine]()
        err = float(np.abs(c.predictor.predict(Xh)
                           - direct.predict(Xh)).max())
        if not c.predicted:
            err = np.inf
        print(f"-Os predict: winner={c.engine} "
              f"confidence={c.confidence:.3f}")
        _check("os-predict-bitexact", err, 1e-12)

        # 2. fallback path: narrow top-k sweep == restricted full sweep
        engine_select.clear_cache()
        fb_cache = os.path.join(td, "fb.json")
        fb = engine_select.choose(held, 64, engines=engines, device=device,
                                  cache_path=fb_cache, mode="predict",
                                  cost_model=model_path,
                                  confidence_threshold=1.01, top_k=2,
                                  repeats=1)
        full = engine_select.choose(held, 64, engines=engines, device=device,
                                    cache_path=fb_cache, repeats=1)
        restricted = {n: full.timings[n] for n in fb.timings}
        ok = (not fb.predicted and len(fb.timings) == 2
              and fb.engine == min(restricted, key=restricted.get))
        print(f"-Os fallback: swept {sorted(fb.timings)} → {fb.engine}")
        _check("os-fallback-topk", 0.0 if ok else np.inf, 1e-12)

        # 3. fleet cold-start under -Os + manifest round trip
        engine_select.clear_cache()
        # shapes disjoint from the training sweeps: a cache hit would
        # (correctly) bypass the model, which isn't what we're checking
        forests = {f"t{i}": core.random_forest_ir(
            9 + 2 * i, 16, 6 + i % 3, n_classes=1, seed=50 + i)
            for i in range(4)}
        rt = ServingRuntime.from_forests(
            forests, max_batch=64, tune="predict", engines=engines,
            cost_model=model_path, confidence_threshold=0.0,
            cache_path=cache, repeats=1, device=device)
        n_pred = sum(1 for tid in forests
                     if rt.tenant(tid).engine_choice.predicted)
        print(f"-Os fleet: {n_pred}/{len(forests)} tenants zero-shot")
        _check("os-fleet-zeroshot", float(len(forests) - n_pred), 1e-12)
        manifest = rt.save(os.path.join(td, "fleet"))
        rt2 = ServingRuntime.load(manifest, device=device)
        worst = 0.0
        for tid, f in forests.items():
            Xt = np.random.default_rng(7).normal(size=(16, f.n_features))
            a = rt.tenant(tid).predictor.predict(Xt)
            b = rt2.tenant(tid).predictor.predict(Xt)
            worst = max(worst, float(np.abs(a - b).max()))
        _check("os-manifest-roundtrip", worst, 1e-12)
        engine_select.clear_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--serving", action="store_true",
                    help="also check the concurrent serving runtime")
    ap.add_argument("--obs", action="store_true",
                    help="also check the observability layer (bit-exact "
                         "instrumented serving, live scrape, zero "
                         "retrace anomalies)")
    ap.add_argument("--cascade", action="store_true",
                    help="also smoke the cascade subsystem end-to-end")
    ap.add_argument("--cascade-fused", action="store_true",
                    help="also check fused execution against the "
                         "staged loop (scores + exit counts)")
    ap.add_argument("--optimize", action="store_true",
                    help="also check every engine × -O2 against -O0")
    ap.add_argument("--int", action="store_true", dest="int_paths",
                    help="also check int-accum / FLInt bit-exactness "
                         "and the exact-integer cascade gate")
    ap.add_argument("--os", action="store_true", dest="os_mode",
                    help="also check zero-shot compilation: cost-model "
                         "predict path, low-confidence fallback, and "
                         "-Os fleet cold-start + manifest round trip")
    args = ap.parse_args(argv)
    device = core.resolve_device(args.device)

    ds = load("magic", n=2000)
    rf = RandomForest(RandomForestConfig(
        n_trees=24, max_leaves=32, max_samples=512)).fit(ds.X_train,
                                                         ds.y_train)
    forest = core.from_random_forest(rf)
    qf = core.quantize_forest(forest, ds.X_train)
    X = ds.X_test[:64]

    check_engines(ds, forest, qf, X, device)
    if args.serving:
        check_serving(ds, qf, X, device)
    if args.obs:
        check_obs(ds, qf, X, device)
    if args.cascade:
        check_cascade(ds, qf, X, device)
    if args.cascade_fused:
        check_cascade_fused(ds, qf, X, device)
    if args.optimize:
        check_optimize(forest, qf, X, device)
    if args.int_paths:
        check_int(ds, forest, X, device)
    if args.os_mode:
        check_os(ds, qf, X, device)
    if FAILED:
        print(f"\nFAILED: {FAILED}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
