"""A random forest trained by the frozen trainer on the dataset's
training rows; with a ``cascade`` key, also the margin gate's threshold,
calibrated on fresh rows of the same distribution.

Calibration runs the plain reference on the quantized forest: among the
configured thresholds, the one that walks the fewest trees per row while
its accuracy stays within ``floor_pp`` points of the full forest's wins
(ties go to the more accurate); none qualifying leaves the gate shut
(threshold inf).  The port and the reference both get the value."""
from __future__ import annotations

import numpy as np

from . import canonical
from .. import datasets, reference, trainer


def make(cfg: dict) -> dict:
    ds = datasets.load(cfg["dataset"])
    X, y = ds.train_rows()
    roots, n_classes = trainer.random_forest(
        X, y.astype(np.int64), n_trees=cfg["n_trees"],
        max_leaves=cfg["max_leaves"], seed=cfg["seed"],
        n_bins=cfg["n_bins"])
    model = canonical(roots, X.shape[1], n_classes)
    if "cascade" in cfg:
        model["gate_threshold"] = np.float64(
            calibrate(model, cfg["cascade"], cfg["quant"]["bits"], X, ds))
    return model


def calibrate(model: dict, spec: dict, bits: int, train_rows, ds) -> float:
    X, y = ds.draw(spec["calibration_rows"],
                   np.random.default_rng(spec["calibration_seed"]))
    q = reference.quantize_model(model, train_rows, bits)
    xq = q.rows(X)
    stages = spec["stages"]
    cum, start = [], 0
    total = np.zeros((len(y), q.leaf.shape[-1]), dtype=np.int64)
    for stop in stages:
        total = total + reference.traverse(q, xq, slice(start, stop))[0]
        cum.append(total)
        start = stop
    full_acc = float((cum[-1].argmax(axis=1) == y).mean())
    best = (float(stages[-1]), full_acc, float("inf"))
    for thr in spec["thresholds"]:
        exit_stage = np.full(len(y), len(stages) - 1)
        active = np.ones(len(y), dtype=bool)
        for k in range(len(stages) - 1):
            ex = active & reference.margin_exits(q.descale(cum[k]),
                                                        thr)
            exit_stage[ex] = k
            active &= ~ex
        final = np.stack(cum)[exit_stage, np.arange(len(y))]
        acc = float((final.argmax(axis=1) == y).mean())
        trees = float(np.asarray(stages, dtype=np.float64)[exit_stage].mean())
        if acc >= full_acc - spec["floor_pp"] / 100.0 and \
                (trees, -acc) < (best[0], -best[1]):
            best = (trees, acc, float(thr))
    return best[2]
