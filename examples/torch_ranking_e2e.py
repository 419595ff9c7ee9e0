"""Learning-to-rank pipeline (paper §6.1) on the PyTorch/CUDA port:
gradient-boosted trees on the MSN-shaped ranking data, scored with every
traversal engine — ``examples/ranking_e2e.py`` step for step over
``repro_torch``.

    PYTHONPATH=src python examples/torch_ranking_e2e.py
    PYTHONPATH=src python examples/torch_ranking_e2e.py --device cpu

The first runs on the card (and raises without one), the second on the
CPU.

Every torch engine must rank the test queries as the trainer's own
``predict`` does (NDCG@10 within 1e-6); the int16-quantized rapidscorer
shows what quantization costs.
"""
import argparse
import time

import numpy as np

from repro_torch import core
from repro_torch.core import registry
from repro_torch.data import datasets
from repro_torch.trees.gradient_boosting import (GradientBoosting,
                                                 GradientBoostingConfig)


def ndcg_at_k(scores, labels, k=10, n_queries=50):
    """Group the test set into synthetic queries, compute mean NDCG@k."""
    n = len(scores) // n_queries
    total = 0.0
    for q in range(n_queries):
        s = scores[q * n:(q + 1) * n]
        l = labels[q * n:(q + 1) * n]
        order = np.argsort(-s)[:k]
        dcg = np.sum((2 ** l[order] - 1) / np.log2(np.arange(2, k + 2)))
        ideal = np.sort(l)[::-1][:k]
        idcg = np.sum((2 ** ideal - 1) / np.log2(np.arange(2, k + 2)))
        total += dcg / max(idcg, 1e-9)
    return total / n_queries


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=6000, help="msn rows")
    ap.add_argument("--n-trees", type=int, default=300)
    ap.add_argument("--max-leaves", type=int, default=32)
    ap.add_argument("--learning-rate", type=float, default=0.15)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = core.resolve_device(args.device)
    ds = datasets.load("msn", n=args.n)
    gb = GradientBoosting(GradientBoostingConfig(
        n_trees=args.n_trees, max_leaves=args.max_leaves, objective="l2",
        learning_rate=args.learning_rate, seed=0))
    t0 = time.time()
    gb.fit(ds.X_train, ds.y_train)
    train_s = time.time() - t0
    print(f"trained GBT: {len(gb.trees)} trees in {train_s:.1f}s")

    forest = core.from_gradient_boosting(gb)
    base = float(ndcg_at_k(gb.predict(ds.X_test), ds.y_test))
    print(f"NDCG@10 = {base:.4f} (direct trainer predict)")

    X = ds.X_test
    ndcg, us_per_inst = {}, {}
    for engine in registry.engines("torch"):
        pred = core.compile_forest(forest, engine=engine, backend="torch",
                                   device=device)
        pred.predict(X[:8])
        t0 = time.perf_counter()
        scores = np.asarray(pred.predict(X))[:, 0]
        us = (time.perf_counter() - t0) / len(X) * 1e6
        nd = float(ndcg_at_k(scores, ds.y_test))
        ndcg[engine], us_per_inst[engine] = nd, us
        print(f"  {engine:12s} NDCG@10={nd:.4f} ({us:6.2f} µs/inst)")
        assert abs(nd - base) < 1e-6, "engine changed ranking order!"

    qforest = core.quantize_forest(forest, ds.X_train)
    qpred = core.compile_forest(qforest, engine="rapidscorer",
                                backend="torch", device=device)
    quant = float(ndcg_at_k(np.asarray(qpred.predict(X))[:, 0], ds.y_test))
    print(f"  int16-quantized rapidscorer NDCG@10={quant:.4f} "
          f"(Δ={quant - base:+.4f}) on {device}")
    return {"device": str(device), "train_s": train_s,
            "n_trees": len(gb.trees), "ndcg_trainer": base, "ndcg": ndcg,
            "us_per_inst": us_per_inst, "ndcg_int16_rapidscorer": quant}


if __name__ == "__main__":
    main()
