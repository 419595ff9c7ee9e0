"""Serving launcher: tree-ensemble scoring or LM generation, on the port.

    # forest serving (the paper's workload), on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --mode forest \
        --engine bitmm --quantize --n-requests 2000

    # concurrent multi-tenant runtime (threaded, adaptive batching)
    PYTHONPATH=src python -m repro_torch.launch.serve --mode runtime \
        --tenants 2 --quantize --slo-p99-ms 10 --n-requests 2000

    # LM generation (reduced config)
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch smollm_360m --reduced --n-new 16

Every mode runs on the card unless ``--device cpu`` asks for the CPU
(with ``--backend cuda`` the kernels' plain versions run there).
``--backend`` is ``cuda`` (the hand-written kernels; the default) or
``torch`` (the plain engines).

``--mode runtime`` drives ``repro_torch.inference.runtime.ServingRuntime``:
N tenants hot in one process, shape-warmed, served by the worker thread
under open-loop Poisson arrivals; ``--slo-p99-ms`` attaches the adaptive
batching controller, ``--save-fleet``/``--load-fleet`` round-trip the
whole fleet through packed artifacts (``torch``-engine tenants only: a
``cuda`` predictor is never saved), and ``--metrics-port`` serves the
scrape endpoint on loopback.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import core
from ..configs import get_config
from ..data import datasets
from ..inference.server import ForestServer, LMServer
from ..models import Model
from ..obs.log import get_logger
from ..trees.random_forest import RandomForest, RandomForestConfig

log = get_logger("serve")


def _cascade_spec(args):
    """--cascade "16,64" [--cascade-policy margin|proba|bound
    --cascade-threshold t] → CascadeSpec (None when --cascade unset)."""
    if not args.cascade:
        return None
    from ..cascade import CascadeSpec, MarginGate, ProbaGate, ScoreBoundGate
    stages = tuple(int(s) for s in args.cascade.split(","))
    t = args.cascade_threshold
    policy = {"margin": lambda: MarginGate(t if t is not None else 0.9),
              "proba": lambda: ProbaGate(t if t is not None else 0.95),
              "bound": lambda: ScoreBoundGate(t if t is not None else 0.0),
              }[args.cascade_policy]()
    return CascadeSpec(stages=stages, policy=policy)


def _trained_forest(args, ds, seed: int):
    rf = RandomForest(RandomForestConfig(
        n_trees=args.n_trees, max_leaves=args.n_leaves,
        seed=seed)).fit(ds.X_train, ds.y_train)
    forest = core.from_random_forest(rf)
    if args.quantize:
        forest = core.quantize_forest(forest, ds.X_train)
    return forest


def serve_forest(args) -> dict:
    ds = datasets.load(args.dataset)
    forest = _trained_forest(args, ds, args.seed)
    pred = core.compile_forest(forest, engine=args.engine,
                               backend=args.backend,
                               cascade=_cascade_spec(args),
                               device=args.device)

    mserver = None
    if args.metrics_port is not None:
        from ..obs.expo import MetricsServer
        from ..obs.metrics import get_registry
        server = ForestServer(pred, max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms, obs=True)
        mserver = MetricsServer(get_registry(),
                                extra=server.stats.summary,
                                port=args.metrics_port).start()
        log.info("metrics_endpoint", url=mserver.url)
    else:
        server = ForestServer(pred, max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms)
    rng = np.random.default_rng(args.seed)
    rows = rng.integers(0, ds.X_test.shape[0], size=args.n_requests)

    # Poisson arrivals; virtual clock so results are deterministic
    inter = rng.exponential(1.0 / args.rate, size=args.n_requests)
    arrivals = np.cumsum(inter)
    t_start = time.time()
    done = 0
    correct = 0
    for row, at in zip(rows, arrivals):
        req = server.submit(ds.X_test[row], arrival_s=t_start + at)
        req.label = ds.y_test[row]
        for r in server.poll(now_s=t_start + at):
            done += 1
            if int(np.argmax(r.result)) == int(r.label):
                correct += 1
    for r in server.flush():
        done += 1
        if int(np.argmax(r.result)) == int(r.label):
            correct += 1
    out = server.stats.summary()
    out.update({"engine": args.engine, "backend": args.backend,
                "device": str(pred.device),
                "quantized": bool(args.quantize),
                "accuracy": correct / max(done, 1),
                "wall_s": round(time.time() - t_start, 2)})
    if mserver is not None:
        out["metrics_url"] = mserver.url
        mserver.close()
    if args.cascade:
        out["cascade"] = pred.describe()
        out["mean_trees_evaluated"] = pred.mean_trees_evaluated
    return out


def serve_runtime(args) -> dict:
    """Concurrent multi-tenant serving: threaded runtime, real clock."""
    from ..inference import ServingRuntime, SLOConfig

    slo = SLOConfig(target_p99_ms=args.slo_p99_ms) \
        if args.slo_p99_ms is not None else None
    ds = datasets.load(args.dataset)
    if args.load_fleet:
        rt = ServingRuntime.load(args.load_fleet, device=args.device)
    else:
        rt = ServingRuntime()
        for i in range(args.tenants):
            forest = _trained_forest(args, ds, args.seed + i)
            rt.add_model(f"t{i}", core.compile_forest(
                forest, engine=args.engine, backend=args.backend,
                cascade=_cascade_spec(args), device=args.device),
                max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                slo=slo)
        if args.save_fleet:
            log.info("fleet_saved", manifest=rt.save(args.save_fleet))
    metrics_url = None
    if args.metrics_port is not None:
        metrics_url = rt.serve_metrics(port=args.metrics_port).url
    warmed = rt.warmup() if args.warmup else {}

    rng = np.random.default_rng(args.seed)
    rows = rng.integers(0, ds.X_test.shape[0], size=args.n_requests)
    tids = rng.choice(list(rt.model_ids), size=args.n_requests)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate,
                                         size=args.n_requests))
    t_wall = time.time()
    base = time.perf_counter() + 0.005
    reqs = []
    with rt:
        for row, tid, at in zip(rows, tids, arrivals):
            target = base + at
            while time.perf_counter() < target:
                time.sleep(min(max(target - time.perf_counter(), 0.0),
                               5e-4))
            reqs.append(rt.submit(tid, ds.X_test[row], arrival_s=target))
        for r in reqs:
            r.wait(timeout=120)
    lats = np.array([r.latency_ms for r in reqs])
    correct = sum(int(np.argmax(r.result)) == int(ds.y_test[row])
                  for row, r in zip(rows, reqs))
    return {
        "tenants": {tid: rt.stats(tid) for tid in rt.model_ids},
        "warmed": warmed,
        "metrics_url": metrics_url,
        "adaptive": slo is not None,
        "n_requests": len(reqs),
        "rate": args.rate,
        "p50_ms": float(np.percentile(lats, 50)),
        "p99_ms": float(np.percentile(lats, 99)),
        "accuracy": correct / max(len(reqs), 1),
        "wall_s": round(time.time() - t_wall, 2),
    }


def serve_lm(args) -> dict:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, torch.float32, q_chunk=64, backend=args.backend,
                  device=args.device)
    params = model.init_params(args.seed)
    B, S = args.batch, args.prompt_len
    server = LMServer(model, params, batch=B, max_len=S + args.n_new + 1)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    t0 = time.time()
    out = server.generate(prompts, args.n_new)
    dt = time.time() - t0
    return {"arch": cfg.name, "backend": args.backend,
            "device": str(model.device), "batch": B, "prompt_len": S,
            "n_new": args.n_new, "out_shape": list(out.shape),
            "tokens_per_s": round(B * args.n_new / dt, 2),
            "wall_s": round(dt, 2)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="forest",
                    choices=["forest", "runtime", "lm"])
    ap.add_argument("--backend", default="cuda", choices=["torch", "cuda"],
                    help="cuda: the hand-written kernels; torch: the plain "
                         "engines")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    # forest args
    ap.add_argument("--dataset", default="magic")
    ap.add_argument("--engine", default="bitvector",
                    choices=list(core.registry.engines()))
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--cascade", type=str, default=None,
                    help="comma-separated stage boundaries (tree prefixes),"
                         " e.g. '16,64' — serve a confidence-gated cascade")
    ap.add_argument("--cascade-policy", default="margin",
                    choices=["margin", "proba", "bound"])
    ap.add_argument("--cascade-threshold", type=float, default=None,
                    help="gate threshold (margin/proba) or slack (bound); "
                         "default per policy")
    ap.add_argument("--n-trees", type=int, default=128)
    ap.add_argument("--n-leaves", type=int, default=32)
    ap.add_argument("--n-requests", type=int, default=1000)
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="arrival rate (req/s; a virtual clock in forest "
                         "mode, the real one in runtime mode)")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    # runtime args
    ap.add_argument("--tenants", type=int, default=2,
                    help="runtime mode: number of hot models")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="attach the adaptive batching controller with "
                         "this p99 latency budget")
    ap.add_argument("--no-warmup", dest="warmup", action="store_false",
                    help="skip shape warmup (first requests pay first-use "
                         "costs)")
    ap.add_argument("--save-fleet", type=str, default=None,
                    help="persist the fleet as packed artifacts + manifest")
    ap.add_argument("--load-fleet", type=str, default=None,
                    help="cold-start the fleet from a saved manifest")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the scrape endpoint (/metrics Prometheus "
                         "text, /metrics.json, /traces) on this loopback "
                         "port; 0 picks an ephemeral port")
    # lm args
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--n-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run one mode; prints its JSON summary and returns it."""
    args = parse_args(argv)
    out = {"forest": serve_forest, "runtime": serve_runtime,
           "lm": serve_lm}[args.mode](args)
    print(json.dumps(out, indent=2, default=str))
    return out


if __name__ == "__main__":
    main()
