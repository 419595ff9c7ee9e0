"""Quickstart on the PyTorch/CUDA port: train a Random Forest, convert to
the QuickScorer IR, quantize (paper §5), compile for every engine, and
compare — ``examples/quickstart.py`` step for step over ``repro_torch``.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The first runs on the card (and raises without one), the second on the
CPU.

Step 5 runs the hand-written CUDA kernel (``qs_forward``: the
``bitvector`` engine on ``backend="cuda"``) on the quantized forest and
holds its scores to the torch engine's; both sum the same integer-valued
leaves exactly, so they must agree to the bit.  On the CPU the kernel's
plain version runs in its place.
"""
import argparse
import time

import numpy as np

from repro_torch import core
from repro_torch.core import registry
from repro_torch.data import datasets
from repro_torch.trees.random_forest import RandomForest, RandomForestConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4000, help="magic rows")
    ap.add_argument("--n-trees", type=int, default=128)
    ap.add_argument("--max-leaves", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = core.resolve_device(args.device)
    # 1. data + training (self-contained substrate: histogram CART)
    ds = datasets.load("magic", n=args.n)
    rf = RandomForest(RandomForestConfig(n_trees=args.n_trees,
                                         max_leaves=args.max_leaves, seed=0))
    rf.fit(ds.X_train, ds.y_train)
    trained_acc = float((rf.predict(ds.X_test) == ds.y_test).mean())
    print(f"trained RF: {len(rf.trees)} trees, acc={trained_acc:.4f}")

    # 2. canonical Forest IR (the paper's bitvector form)
    forest = core.from_random_forest(rf)
    print(f"forest IR: T={forest.n_trees} L={forest.n_leaves} "
          f"C={forest.n_classes} words={forest.n_words}")

    # 3. fixed-point quantization (paper §5: s = 2^15, int16)
    qforest = core.quantize_forest(forest, ds.X_train)
    print(f"quantized: splits {qforest.threshold.dtype}, "
          f"leaves {qforest.leaf_value.dtype}, scale {qforest.quant_scale}")

    # 4. every engine, float + quantized, on the torch backend
    X = ds.X_test
    accuracy, us_per_inst = {}, {}
    for f, tag in ((forest, " "), (qforest, "q")):
        for engine in registry.engines("torch"):
            pred = core.compile_forest(f, engine=engine, backend="torch",
                                       device=device)
            pred.predict(X[:8])                       # first call
            t0 = time.perf_counter()
            out = np.asarray(pred.predict(X))
            dt = (time.perf_counter() - t0) / len(X) * 1e6
            acc = float((out.argmax(1) == ds.y_test).mean())
            name = tag.strip() + engine
            accuracy[name], us_per_inst[name] = acc, dt
            print(f"  {tag}{engine:12s} acc={acc:.4f} {dt:7.2f} µs/inst")

    # 5. the CUDA kernel (its plain version on the CPU)
    pk = core.compile_forest(qforest, engine="bitvector", backend="cuda",
                             device=device)
    out = np.asarray(pk.predict(X[:256]))
    ref = np.asarray(core.compile_forest(
        qforest, engine="bitvector", backend="torch",
        device=device).predict(X[:256]))
    diff = float(np.abs(out - ref).max())
    print(f"cuda kernel max|Δ| vs torch engine: {diff:.2e} on {device}")
    assert diff == 0, "the kernel's quantized scores differ from the engine's"
    return {"device": str(device), "trained_acc": trained_acc,
            "forest": {"n_trees": forest.n_trees,
                       "n_leaves": forest.n_leaves,
                       "n_classes": forest.n_classes,
                       "n_words": forest.n_words},
            "accuracy": accuracy, "us_per_inst": us_per_inst,
            "kernel_max_abs_diff": diff}


if __name__ == "__main__":
    main()
