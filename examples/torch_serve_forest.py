"""Batched tree-ensemble serving on the PyTorch/CUDA port: a Poisson
request stream through the micro-batcher into the autotuned fastest
engine for this forest — ``examples/serve_forest.py`` step for step over
``repro_torch``.

    PYTHONPATH=src python examples/torch_serve_forest.py
    PYTHONPATH=src python examples/torch_serve_forest.py --device cpu

The first runs on the card (and raises without one), the second on the
CPU.

On the card the autotuner sweeps nine candidates, the six torch engines
and the three hand-written CUDA kernels (``cuda-qs``, ``cuda-bitmm``,
``cuda-gemm``); on the CPU the six torch engines.  The decision is cached
(``$REPRO_ENGINE_CACHE``, else ``~/.cache/repro/engine_cache.json``), so a
second run answers from the cache.  ``--engines`` narrows the sweep.
Arrivals are on a virtual clock: the batches follow from the arrival
times alone, the latencies add each batch's real compute time.
"""
import argparse

import numpy as np

from repro_torch import core
from repro_torch.data import datasets
from repro_torch.inference.server import ForestServer
from repro_torch.trees.random_forest import RandomForest, RandomForestConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=3000, help="mnist rows")
    ap.add_argument("--n-trees", type=int, default=128)
    ap.add_argument("--max-leaves", type=int, default=64)
    ap.add_argument("--n-requests", type=int, default=2000)
    ap.add_argument("--rate", type=float, default=5000.0,
                    help="offered requests per second")
    ap.add_argument("--engines", default=None,
                    help="comma-separated autotuner names to sweep "
                         "(default: every engine the device runs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = core.resolve_device(args.device)
    ds = datasets.load("mnist", n=args.n)
    rf = RandomForest(RandomForestConfig(
        n_trees=args.n_trees, max_leaves=args.max_leaves,
        seed=0)).fit(ds.X_train, ds.y_train)
    forest = core.quantize_forest(core.from_random_forest(rf), ds.X_train)

    # autotune: microbenchmark the engine matrix at the dispatch batch
    # size, cache the winner (JSON on disk — restarts skip the sweep)
    engines = tuple(args.engines.split(",")) if args.engines else None
    server = ForestServer.from_forest(forest, max_batch=128, max_wait_ms=2.0,
                                      device=device, engines=engines)
    choice = server.engine_choice
    print(f"autotuned engine: {choice.engine} (cached: {choice.from_cache}) "
          f"of {sorted(choice.timings)} on {device}")
    pred = server.predictor

    # warm the predictor for the batch shapes the server will see, so
    # latency percentiles measure serving, not first calls
    for b in (1, 128):
        pred.predict(ds.X_test[:b])
    rng = np.random.default_rng(0)
    n_requests = args.n_requests
    arrivals = np.cumsum(rng.exponential(1 / args.rate, size=n_requests))
    rows = rng.integers(0, ds.X_test.shape[0], size=n_requests)

    correct = total = 0
    for at, row in zip(arrivals, rows):
        req = server.submit(ds.X_test[row], arrival_s=at)
        req.label = int(ds.y_test[row])
        for done in server.poll(now_s=at):
            total += 1
            correct += int(np.argmax(done.result)) == done.label
    for done in server.flush(now_s=float(arrivals[-1])):
        total += 1
        correct += int(np.argmax(done.result)) == done.label

    s = server.stats.summary()
    print(f"served {s['n_requests']} requests in {s['n_batches']} batches "
          f"(mean batch {s['mean_batch']:.1f})")
    print(f"latency p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms")
    print(f"accuracy {correct / total:.4f}")
    return {"device": str(device), "engine": choice.engine,
            "from_cache": choice.from_cache,
            "candidates": sorted(choice.timings),
            "n_requests": s["n_requests"], "n_batches": s["n_batches"],
            "mean_batch": s["mean_batch"], "p50_ms": s["p50_ms"],
            "p99_ms": s["p99_ms"], "served": total,
            "accuracy": correct / total}


if __name__ == "__main__":
    main()
